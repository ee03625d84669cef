"""The port's dense Twist provers against the JAX package's dense classes
(slow tier: the JAX package compiles each round's kernels at each shape,
about a minute of CPU for the seven classes).

`relations/registers_rw.py` (read-write, Val evaluation, raf) and
`relations/ram.py` (read-write, raf, Val evaluation, output check) on the
tiny trace of tests/test_naive_oracle.py (T = 64), each package's witness
extraction from its own tracer, one stage a module: the JAX package's
round polynomials, challenges, openings and transcript state.  The fast
tier holds the same provers to the JAX package's naive interpreter
(tests/test_torch_dense_tiers.py).
"""

import pytest
import torch

from jolt_tpu.relations import ram as jram
from jolt_tpu.relations import registers_rw as jreg
from jolt_tpu.tracer import trace_program as j_trace_program
from jolt_tpu.witness.ram import extract_ram_witness as j_ram_witness
from jolt_tpu.witness.registers import \
    extract_register_witness as j_reg_witness

from jolt_tpu_torch.relations import ram as tram
from jolt_tpu_torch.relations import registers_rw as treg
from jolt_tpu_torch.tracer import trace_program as t_trace_program
from jolt_tpu_torch.witness.ram import extract_ram_witness as t_ram_witness
from jolt_tpu_torch.witness.registers import \
    extract_register_witness as t_reg_witness
from test_naive_oracle import GUEST
from test_naive_oracle import L as J_LAYOUT
from test_torch_dense_tiers import CPU, T_LAYOUT, _prove
from test_torch_stage1 import _rand_vals

pytestmark = pytest.mark.slow

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    jtr = j_trace_program(GUEST, layout=J_LAYOUT, min_padded=32)
    ttr = t_trace_program(GUEST, layout=T_LAYOUT, min_padded=32)
    assert jtr.padded_length == ttr.padded_length
    return jtr, ttr


def _registers(pkg, tr):
    mod, wit = ((jreg, j_reg_witness(tr)) if pkg == "jax"
                else (treg, t_reg_witness(tr)))
    kw = {} if pkg == "jax" else {"device": CPU}
    r_cycle = _rand_vals(tr.log_T, 200)
    r_addr = _rand_vals(7, 201)
    gamma, c_val, c_raf, *claims = _rand_vals(6, 202)
    return [mod.RegistersReadWriteChecking(wit, gamma, r_cycle, claims, **kw),
            mod.RegistersValEvaluation(wit, r_addr, r_cycle, c_val, **kw),
            mod.RegistersRaf(wit.wa, None, r_cycle, c_raf, "rd", **kw)]


def _ram(pkg, tr):
    mod, wit = ((jram, j_ram_witness(tr)) if pkg == "jax"
                else (tram, t_ram_witness(tr)))
    kw = {} if pkg == "jax" else {"device": CPU}
    r_cycle = _rand_vals(tr.log_T, 210)
    r_addr = _rand_vals(wit.log_K, 211)
    gamma, rv, wv, c_addr, c_val, z = _rand_vals(6, 212)
    return [mod.RamReadWriteChecking(wit, gamma, r_cycle, rv, wv, **kw),
            mod.RamRafEvaluation(wit, r_cycle, c_addr, **kw),
            mod.RamValEvaluation(wit, r_addr, r_cycle, c_val, **kw),
            mod.RamOutputCheck(wit, tr.memory_layout, z,
                               bytes(tr.device.outputs), **kw)]


@pytest.mark.parametrize("build", [_registers, _ram],
                         ids=["registers", "ram"])
def test_dense_twist_provers_match_jax(tiny, build):
    jtr, ttr = tiny
    want = _prove("jax", build("jax", jtr))
    insts = build("torch", ttr)
    got = _prove("torch", insts, "host")
    assert got[:4] == want[:4]
    # the tables broadcast in place: a cycle column stays (8, T, 1)
    assert all(X.shape[2] == 1 for n, X in insts[0].tables.items()
               if n in ("e", "inc"))


def test_dense_twist_bytes_do_not_depend_on_the_column_layout(tiny):
    """A table held as the JAX package's K*T broadcast gives the same
    stage as the in-place (8, T, 1) column."""
    _, ttr = tiny
    insts = _ram("torch", ttr)
    want = _prove("torch", insts, "host")
    insts = _ram("torch", ttr)
    for inst in insts:
        K = inst.K
        inst.tables = {n: X.expand(X.shape[0], inst.T, K).contiguous()
                       for n, X in inst.tables.items()}
    assert _prove("torch", insts, "host")[:4] == want[:4]
