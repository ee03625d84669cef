"""The frozen K1 bound arithmetic gives the values the port's
`workload.k1_bound_ms` gave on these launch records (computed once from
the port at commit e0c4691 and pinned here)."""

import pytest

from portbench import bounds

PINNED = [
    ("mul", ((8, 1024), (8, 1024)), 2.9344477611940298e-05),
    ("mul", ((8, 4, 1), "int"), 7.641791044776118e-08),
    ("add", ((8, 262144), (8, 1, 262144)), 0.007512186268656716),
    ("bind", ((8, 131072), (8, 131072), "int"), 0.003756093134328358),
    ("bind", ((8, 3, 65536), (8, 3, 65536), (8, 1)), 0.005634149253731343),
    ("evals", ((8, 65536), 3, None), 0.0031300776119402986),
    ("reduce", ((8, 16), None), 4.5850746268656716e-07),
    ("reduce", ((8, 5, 7), (8, 1)), 1.012537313432836e-06),
]


@pytest.mark.parametrize("form,key,ms", PINNED)
def test_k1_bound_pinned(form, key, ms):
    got, which = bounds.k1_bound_ms(form, key)
    assert got == pytest.approx(ms, rel=1e-12)
    assert which == "bytes"


def test_unknown_form_raises():
    with pytest.raises(ValueError):
        bounds.k1_bound_ms("nope", ())
