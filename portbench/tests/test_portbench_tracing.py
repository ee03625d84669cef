"""The readers of the program's spans, counters and K2-K4 launch records
(`sumcheck_setup_s`, `host_rounds_s`, `d2h_fetches`, `h2d_mib`,
`k3_roofline_pct`) and the frozen K3 bound, on a synthetic window; and
that K1's roofline, the launch count and the breakdown read the same
whether or not K2-K4 records are in the window.  The trees come from the
program's profiler (`Profiler.proves`), as in a traced run."""

import types

import pytest

from jolt_tpu_torch.utils import profiling
from jolt_tpu_torch.utils.profiling import Profiler, Span
from portbench import bounds_k3, devtrace, spec
from portbench.harness import Window, _breakdown
from portbench.metrics._common import SUMCHECK_STAGES

# (form, key, ms): the port's `workload.k3_bound_ms` at commit d1e1e0b on
# the same sizes (scalar_mul with half of each lane's bits set)
PINNED = [
    ("add", (1 << 20,), 0.2728159167431895),
    ("double", (1 << 20,), 0.11935696357514539),
    ("normalize", (1 << 20,), 6.240664095500459),
    ("scalar_mul", (1 << 15, 254, 8), 2.0301340679522495),
    ("bucket_sum", (1 << 16, 6029312, 17915, 17920), 1.0752709280303032),
    ("bucket_reduce", (17, 15), 0.28989865319865316),
]


@pytest.mark.parametrize("form,key,ms", PINNED)
def test_k3_bound_pinned(form, key, ms):
    got, which = bounds_k3.k3_bound_ms(form, key)
    assert got == pytest.approx(ms, rel=1e-12)
    assert which == "operations"


def test_k3_bound_later_level_and_unknown_form():
    assert bounds_k3.k3_bound_ms("bucket_sum", None) == (0.0, "none")
    with pytest.raises(ValueError):
        bounds_k3.k3_bound_ms("add", None)
    with pytest.raises(ValueError):
        bounds_k3.k3_bound_ms("mul", (4,))


def _stage(name, start, setup_s, rounds, rounds_s, d2h, h2d_bytes):
    """A stage root of `rounds` ("engine.rounds" or "fused.rounds") after
    a `stage.setup`, with the counts on its children."""
    setup = Span("stage.setup", start, setup_s,
                 counts={"h2d": 1, "h2d_bytes": h2d_bytes})
    loop = Span(rounds, start + setup_s, rounds_s,
                counts={"d2h": d2h, "d2h_bytes": 64 * d2h})
    return Span(name, start, setup_s + rounds_s + 0.5, children=[setup, loop])


def _prove(t0, scale):
    """One prove's roots: witness, stage 0, the ten sumcheck stages (s5i on
    the host engine), the opening."""
    roots = [Span("witness-extraction", t0, 1.0,
                  counts={"h2d": 2, "h2d_bytes": 1 << 20}),
             Span("stage0-commit", t0 + 1, 2.0)]
    t = t0 + 3
    for name in SUMCHECK_STAGES:
        host = name == "stage5i-instr-lookups"
        roots.append(_stage(name, t, 0.25 * scale,
                            "engine.rounds" if host else "fused.rounds",
                            3.0 if host else 0.1, 128 if host else 1,
                            1 << 19))
        t += roots[-1].wall_s
    roots.append(Span("stage8-openings", t, 2.0, counts={"d2h": 4}))
    return roots


K1_RECORDS = [("mul", ((8, 1024), (8, 1024)))] * 3 + [
    ("bind", ((8, 131072), (8, 131072), "int"))] * 2
K234_RECORDS = [("k2", (3, "message_bind", 1024, 8)),
                ("k4", ((2, 3), (True, False), 2)),
                ("k3_scalar_mul", (1 << 15, 254, 8)),
                ("k3_bucket_sum", (1 << 16, 6029312, 17915, 17920)),
                ("k3_bucket_sum", None),
                ("k3_bucket_reduce", (17, 15))]


def _device(with_k3=True):
    ops = {"k1_mul_v1": 3e-4, "k1_bind_v1": 1e-3,
           "Memcpy HtoD (Pageable -> Device)": 0.5}
    if with_k3:
        ops.update({"void (anonymous namespace)::k3_scalar_mul("
                    "(anonymous namespace)::G1Launch)": 6.0e-3,
                    "k3_bucket_sum": 4.0e-3, "k3_bucket_reduce": 2.9e-3,
                    "k3_normalize": 1.0e-3})
    return devtrace.DeviceTrace(
        busy_s=1.0, window_s=40.0, ops_s=ops, gaps=[(0, int(5e9))],
        k1_s={"mul": [1e-4] * 3, "bind": [5e-4] * 2}, n_events=20)


@pytest.fixture
def window(monkeypatch):
    """Two proves on the program's profiler and the window the harness
    makes of them, K2-K4 records among K1's."""
    prof = Profiler(track_memory=False)
    prof.proves = [_prove(0.0, 1.0), _prove(100.0, 2.0)]
    monkeypatch.setattr(profiling, "PROFILER", prof)
    spans = [{s.name: s.wall_s for s in roots} for roots in prof.proves]
    launches = [{s: {"k1": 1, "k2": 2, "k4": 3} for s in SUMCHECK_STAGES}
                for _ in spans]
    return Window(spans, launches, K1_RECORDS + K234_RECORDS, _device())


def _read(name, win):
    return spec.load_reader(name).read(win)


def test_setup_and_host_rounds(window):
    # 10 stages x 0.25 s, then 10 x 0.5 s; s5i's engine loop 3 s a prove
    assert _read("sumcheck_setup_s", window) == pytest.approx(3.75)
    assert _read("host_rounds_s", window) == pytest.approx(3.0)


def test_copy_counters(window):
    # d2h: nine device-tier stages' one fetch, s5i's 128, the opening's 4
    assert _read("d2h_fetches", window) == pytest.approx(141.0)
    # h2d: witness 1 MiB, ten set-ups of 1/2 MiB
    assert _read("h2d_mib", window) == pytest.approx(6.0)


def test_k3_roofline(window):
    least = sum(bounds_k3.k3_bound_ms(f[3:], k)[0]
                for f, k in K234_RECORDS if f.startswith("k3_")) / 1e3
    # normalize was traced with no records: out of both sums
    assert _read("k3_roofline_pct", window) == pytest.approx(
        100 * least / (6.0e-3 + 4.0e-3 + 2.9e-3))
    assert 0 < _read("k3_roofline_pct", window) < 100


def test_k1_launches_and_breakdown_ignore_k234_records(window):
    plain = Window(window.spans, window.stage_launches, K1_RECORDS,
                   window.device)
    for name in ("k1_roofline_pct", "sumcheck_launches", "sumcheck_s",
                 "device_idle_pct"):
        assert _read(name, window) == _read(name, plain) is not None
    roots = profiling.PROFILER.proves
    assert (_breakdown(window.device, roots, 0.0, 0)
            == _breakdown(plain.device, roots, 0.0, 0))
    # the stage roots' idle splits among their children
    gaps = dict(_breakdown(window.device, roots, 0.0, 0)["idle_gaps"])
    assert gaps["stage0-commit"] == pytest.approx(2.0)
    assert gaps["witness-extraction"] == pytest.approx(1.0)


def test_readers_find_nothing_on_a_program_without_them(window,
                                                        monkeypatch):
    """The parent program: no `proves` on its profiler, K1's records
    only; a window its calls do not match."""
    parent = Window(window.spans, window.stage_launches, K1_RECORDS,
                    _device(with_k3=False))
    monkeypatch.setattr(profiling, "PROFILER",
                        types.SimpleNamespace(enabled=True, roots=[]))
    for name in ("sumcheck_setup_s", "host_rounds_s", "d2h_fetches",
                 "h2d_mib", "k3_roofline_pct"):
        assert _read(name, parent) is None
    prof = Profiler(track_memory=False)
    prof.proves = [_prove(0.0, 1.0)]
    monkeypatch.setattr(profiling, "PROFILER", prof)
    assert _read("d2h_fetches", window) is None      # two proves, one call


def test_a_failed_call_is_skipped(window):
    prof = profiling.PROFILER
    prof.proves.insert(1, prof.proves[0][:3])          # a prove that raised
    assert _read("d2h_fetches", window) == pytest.approx(141.0)


NEW_READERS = ("sumcheck_setup_s", "host_rounds_s", "d2h_fetches",
               "h2d_mib", "k3_roofline_pct")


def test_traced_small_run_reads_the_new_spans_and_counters(tmp_path):
    """A traced run of the small CPU cell through the harness: the span
    and counter readers read the program's trees (on the CPU every stage
    takes the host engine, each round one `d2h`); K3's roofline needs the
    card's trace and reports nothing."""
    import torch

    from portbench.harness import run_cell
    from portbench.tests._small import small_cell
    torch.set_num_threads(2)
    cell = small_cell(per_layer=True)
    for name in NEW_READERS:
        cell.readers[name] = spec.load_reader(name)
    out = run_cell(cell, 7, 0.0, True, device="cpu", log=print,
                   cache_dir=str(tmp_path.parent / "portbench-cache"))
    assert out["correct"], out
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert 0 < m["sumcheck_setup_s"] < m["sumcheck_s"]
    assert 0 < m["host_rounds_s"] < m["sumcheck_s"]
    assert m["d2h_fetches"] >= 8 and m["h2d_mib"] > 0
    assert "k3_roofline_pct" not in m
