"""The device-trace reduction: the busy union, the idle gaps, the time by
operation and K1's launches by form, on a hand-made trace."""

import types

import pytest

from portbench import devtrace


class _Ev:
    def __init__(self, name, start, dur, cuda=True, annotation=False):
        from torch.autograd import DeviceType
        self._v = (name, start, dur,
                   DeviceType.CUDA if cuda else DeviceType.CPU, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


@pytest.mark.parametrize("name,form", [
    ("k1_mul_v1", "mul"), ("k1_reduce", "reduce"),
    ("(anonymous namespace)::k1_bind_v2(Launch)", "bind"),
    ("void (anonymous namespace)::k1_evals_v1(Launch)", "evals"),
    ("k3_add", None), ("round_kernel", None), ("xk1_mul_v1", None)])
def test_k1_names(name, form):
    assert devtrace.k1_form(name) == form


def test_reduce_unions_and_gaps():
    ev = [_Ev("k1_mul_v1", 100, 50), _Ev("Memcpy DtoH", 120, 60),
          _Ev("k3_add", 400, 100), _Ev("cpu op", 0, 1000, cuda=False),
          _Ev("[prove] s1", 0, 1000, annotation=True),
          _Ev("k1_mul_v2", 950, 100)]
    t = devtrace.reduce(_prof(ev), 0, 1000)
    # busy: [100, 180) + [400, 500) + [950, 1000) = 80 + 100 + 50 ns
    assert t.busy_s == pytest.approx(230e-9)
    assert t.window_s == pytest.approx(1000e-9)
    assert t.gaps == [(0, 100), (180, 400), (500, 950)]
    assert t.k1_s == {"mul": [50e-9, 100e-9]}
    assert set(t.ops_s) == {"k1_mul_v1", "Memcpy DtoH", "k3_add", "k1_mul_v2"}


def test_idle_split_among_open_spans():
    from types import SimpleNamespace as S

    from portbench.harness import _attribute, _op_name
    inner = S(name="c", start=2.0, wall_s=1.0, children=[])
    roots = [S(name="a", start=0.0, wall_s=5.0, children=[inner]),
             S(name="b", start=5.0, wall_s=5.0, children=[])]
    out = {}
    assert _attribute(roots, 1.0, 6.0, "", out) == 5.0
    assert out == {"a/c": 1.0, "a": 3.0, "b": 1.0}
    assert _op_name("void (anonymous namespace)::k3_bucket_sum<true>("
                    "(anonymous namespace)::BucketLaunch)") == "k3_bucket_sum"
    assert _op_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"
