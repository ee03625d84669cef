"""Twist RAM relations: read/write checking, raf evaluation, Val evaluation,
output check -- the dense provers, their verifier twins and the public
host helpers.

Torch counterpart of the JAX package's `relations/ram.py`.  The main path
takes the sparse Twist tier (`ram_sparse.py`), which imports the verifier
twins and the closed-form evaluations of the public polynomials here (host
work on Python ints).  The dense K x T provers are the JAX package's
round-1 tier, kept as its oracle; they run on `registers_rw._DenseTwist`,
whose tables broadcast the cycle and address columns in place (the JAX
package's `_broadcast_cycle` / `_broadcast_addr` copies), cycle-major
(index j*K + k), HighToLow: cycle phase, then address phase.

Relations (reference `zkvm/ram/{read_write_checking,raf_evaluation,
val_check,output_check}.rs`):

  * RW checking:
      sum_{k,j} eq(r_cycle,j) * ra(k,j) * [ Val(k,j)
          + gamma*(Val(k,j) + inc(j)) ]  =  rv_claim + gamma*wv_claim
  * raf evaluation:
      sum_{k,j} eq(r_cycle,j) * ra(k,j) * A(k) = ram_address_claim,
    where A(k) = witness_base + 8(k-1) for k>=1, A(0)=0 -- a PUBLIC affine
    MLE the verifier evaluates in closed form:
      A(r) = 8*sum_i 2^i r_i + (wb-8)*(1 - prod_i (1-r_i)).
  * Val evaluation:
      Val(r) - Val_init(r_addr) = sum_{k,j} eq(r_addr,k) * LT(j,r_cyc)
                                     * ra(k,j) * inc(j),
    with Val_init evaluated by the verifier from the PUBLIC sparse initial
    image (inputs + program-image cells).
  * output check: for a transcript challenge z and W(k) = z^i at the i-th
    output-region cell (else 0),
      sum_i z^i*out_i - sum_k W(k)*Val_init(k) = sum_{k,j} W(k) ra(k,j) inc(j).

These twins take the cycle point first and big-endian (the dense tier's
order); the sparse tier's twins normalize their raw challenges first.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..field import FR, ops
from ..poly import eq, lt
from ..sumcheck.engine import OpeningAccumulator
from ..witness.ram import RamWitness, address_of_index, remap_address
from .registers_rw import (_DenseTwist, _Verifier, addr_column, cycle_column,
                           matrix)

P = FR.modulus


def addr_mle_eval(r_addr: Sequence[int], witness_base: int) -> int:
    """Closed-form A(r): 8*lin(r) + (wb-8)*(1 - prod(1-r_i))."""
    n = len(r_addr)
    lin = 0
    prod = 1
    for i, rb in enumerate(r_addr):
        lin = (lin + (1 << (n - 1 - i)) * rb) % P  # big-endian: r[0] = MSB
        prod = prod * ((1 - rb) % P) % P
    return (8 * lin + (witness_base - 8) * ((1 - prod) % P)) % P


def init_mle_eval(init_vals: Dict[int, int], r_addr: Sequence[int]) -> int:
    """Sparse public Val_init MLE evaluation: sum_k v_k * eq(k, r_addr)."""
    n = len(r_addr)
    acc = 0
    for k, v in init_vals.items():
        term = v % P
        for i, rb in enumerate(r_addr):
            bit = (k >> (n - 1 - i)) & 1
            term = term * ((rb if bit else (1 - rb)) % P) % P
        acc = (acc + term) % P
    return acc


def output_region_cells(layout, witness_base: int, K: int):
    """Witness cell indices of the output region (ordered)."""
    cells = []
    a = layout.output_start
    while a < layout.output_end:
        k = remap_address(a, witness_base)
        if k < K:
            cells.append(k)
        a += 8
    return cells


def outputs_as_words(outputs: bytes, layout) -> Dict[int, int]:
    """Public outputs -> {cell index: dword value} (zero-padded region)."""
    out = {}
    wb = getattr(layout, "witness_base", layout.input_start)
    for off in range(0, layout.output_end - layout.output_start, 8):
        word = int.from_bytes(outputs[off:off + 8].ljust(8, b"\x00"), "little") \
            if off < len(outputs) else 0
        k = remap_address(layout.output_start + off, wb)
        out[k] = word
    return out


class RamReadWriteChecking(_DenseTwist):
    opened = ("ra", "val", "inc")

    def __init__(self, wit: RamWitness, gamma: int, r_cycle: Sequence[int],
                 rv_claim: int, wv_claim: int, device="cuda"):
        self.wit = wit
        self.T, self.K = wit.T, wit.K
        self.gamma = gamma % P
        self.r_cycle = list(r_cycle)
        self.rv_claim, self.wv_claim = rv_claim, wv_claim
        device = torch.device(device)
        self._start({"e": cycle_column(eq.evals(self.r_cycle, device),
                                       device),
                     "ra": matrix(wit.ra, self.K, device),
                     "val": matrix(wit.val, self.K, device),
                     "inc": cycle_column(wit.inc, device)},
                    self.T.bit_length() - 1, wit.log_K)

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return (self.rv_claim + self.gamma * self.wv_claim) % P

    def _summand(self, v):
        """E*RA*((1+g)*VAL + g*INC)."""
        term = ops.add(ops.mont_mul(v["val"], (1 + self.gamma) % P),
                       ops.mont_mul(v["inc"], self.gamma))
        return ops.mont_mul(v["e"], ops.mont_mul(v["ra"], term))

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        r_cyc = list(r_slice[:self.log_T])
        for name in ("ra", "val"):
            accumulator.insert(("ram", name), list(r_slice),
                               self.final_openings[name])
        accumulator.insert(("ram", "inc"), r_cyc, self.final_openings["inc"])


class RamReadWriteCheckingVerifier(_Verifier):
    def __init__(self, log_T: int, log_K: int, gamma: int,
                 r_cycle: Sequence[int], rv_claim: int, wv_claim: int,
                 openings: dict):
        self.log_T, self.log_K = log_T, log_K
        self.gamma = gamma
        self.r_cycle = list(r_cycle)
        self.rv_claim, self.wv_claim = rv_claim, wv_claim
        self.openings = openings

    @property
    def num_rounds(self) -> int:
        return self.log_T + self.log_K

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return (self.rv_claim + self.gamma * self.wv_claim) % P

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_cyc = list(r[:self.log_T])
        o = self.openings
        g = self.gamma
        term = ((1 + g) * o["val"] + g * o["inc"]) % P
        return eq.eq_int(self.r_cycle, r_cyc) * o["ra"] % P * term % P


class RamRafEvaluation(_DenseTwist):
    """Proves the RamAddress opening: address = <ra, A> per cycle."""

    opened = ("ra",)

    def __init__(self, wit: RamWitness, r_cycle: Sequence[int],
                 addr_claim: int, device="cuda"):
        self.wit = wit
        self.T, self.K = wit.T, wit.K
        self.r_cycle = list(r_cycle)
        self.addr_claim = addr_claim
        device = torch.device(device)
        addrs = [address_of_index(k, wit.witness_base) for k in range(self.K)]
        self._start({"e": cycle_column(eq.evals(self.r_cycle, device),
                                       device),
                     "ra": matrix(wit.ra, self.K, device),
                     "a": addr_column(addrs, device)},
                    self.T.bit_length() - 1, wit.log_K)

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self.addr_claim % P

    def _summand(self, v):
        return ops.mont_mul(v["e"], ops.mont_mul(v["ra"], v["a"]))

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        accumulator.insert(("ram_raf", "ra"), list(r_slice),
                           self.final_openings["ra"])


class RamRafEvaluationVerifier(_Verifier):
    def __init__(self, log_T: int, log_K: int, r_cycle: Sequence[int],
                 addr_claim: int, witness_base: int, openings: dict):
        self.log_T, self.log_K = log_T, log_K
        self.r_cycle = list(r_cycle)
        self.addr_claim = addr_claim
        self.witness_base = witness_base
        self.openings = openings

    @property
    def num_rounds(self) -> int:
        return self.log_T + self.log_K

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self.addr_claim % P

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_cyc = list(r[:self.log_T])
        r_addr = list(r[self.log_T:])
        a_eval = addr_mle_eval(r_addr, self.witness_base)
        return (eq.eq_int(self.r_cycle, r_cyc) * self.openings["ra"] % P
                * a_eval % P)


class RamValEvaluation(_DenseTwist):
    """Proves Val(r) - Val_init(r_addr) = prefix-sum of increments."""

    opened = ("ra", "inc")

    def __init__(self, wit: RamWitness, r_addr: Sequence[int],
                 r_cyc: Sequence[int], val_claim: int, device="cuda"):
        self.wit = wit
        self.T, self.K = wit.T, wit.K
        init_eval = init_mle_eval(wit.init_vals, r_addr)
        self._input_claim = (val_claim - init_eval) % P
        device = torch.device(device)
        # LT(j, r_cyc) * eq(r_addr, k): two factors, cycle and address
        self._start({"lt": cycle_column(lt.evals(list(r_cyc), device),
                                        device),
                     "eq": addr_column(eq.evals(list(r_addr), device),
                                       device),
                     "ra": matrix(wit.ra, self.K, device),
                     "inc": cycle_column(wit.inc, device)},
                    self.T.bit_length() - 1, wit.log_K)

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self._input_claim

    def _summand(self, v):
        return ops.mont_mul(ops.mont_mul(v["lt"], v["eq"]),
                            ops.mont_mul(v["ra"], v["inc"]))

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        r_cyc = list(r_slice[:self.log_T])
        accumulator.insert(("ram_val_eval", "ra"), list(r_slice),
                           self.final_openings["ra"])
        accumulator.insert(("ram_val_eval", "inc"), r_cyc,
                           self.final_openings["inc"])


class RamValEvaluationVerifier(_Verifier):
    def __init__(self, log_T: int, log_K: int, r_addr: Sequence[int],
                 r_cyc: Sequence[int], val_claim: int,
                 init_vals: Dict[int, int], openings: dict,
                 extra_init: int = 0):
        # extra_init: selector-scaled advice-opening contributions to
        # Init(r_addr) (zkvm/ram/mod.rs reconstruct_full_eval)
        self.log_T, self.log_K = log_T, log_K
        self.r_addr = list(r_addr)
        self.r_cyc = list(r_cyc)
        self._input_claim = (val_claim - init_mle_eval(init_vals, r_addr)
                             - extra_init) % P
        self.openings = openings

    @property
    def num_rounds(self) -> int:
        return self.log_T + self.log_K

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self._input_claim

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_cyc_new = list(r[:self.log_T])
        r_addr_new = list(r[self.log_T:])
        o = self.openings
        lt_eval = lt.lt_point_int(r_cyc_new, self.r_cyc)
        eq_addr = eq.eq_int(self.r_addr, r_addr_new)
        return lt_eval * eq_addr % P * o["ra"] % P * o["inc"] % P


class RamOutputCheck(_DenseTwist):
    """Proves the public outputs equal the final RAM state in the output
    region (`zkvm/ram/output_check.rs` analog).

    For a transcript challenge z, with W(k) = z^i for the i-th output-region
    cell (else 0) -- a sparse PUBLIC polynomial:

        sum_i z^i*out_i - sum_k W(k)*Val_init(k)
            = sum_{k,j} W(k) * ra(k,j) * inc(j)

    (final value = initial value + all increments; contracting with W
    isolates the output region).  Degree-3; batches with RamValEvaluation.
    """

    opened = ("ra", "inc")

    def __init__(self, wit: RamWitness, layout, z: int, outputs: bytes,
                 device="cuda"):
        self.wit = wit
        self.T, self.K = wit.T, wit.K
        self.z = z
        self.out_cells = output_region_cells(layout, wit.witness_base, wit.K)
        out_words = outputs_as_words(outputs, layout)
        lhs = 0
        zp = 1
        init_term = 0
        W = [0] * self.K
        for k in self.out_cells:
            W[k] = zp
            lhs = (lhs + zp * out_words.get(k, 0)) % P
            init_term = (init_term + zp * wit.init_vals.get(k, 0)) % P
            zp = zp * self.z % P
        self._input_claim = (lhs - init_term) % P
        device = torch.device(device)
        self._start({"w": addr_column(W, device),
                     "ra": matrix(wit.ra, self.K, device),
                     "inc": cycle_column(wit.inc, device)},
                    self.T.bit_length() - 1, wit.log_K)

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self._input_claim

    def _summand(self, v):
        return ops.mont_mul(v["w"], ops.mont_mul(v["ra"], v["inc"]))

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        accumulator.insert(("ram_output", "ra"), list(r_slice),
                           self.final_openings["ra"])
        accumulator.insert(("ram_output", "inc"),
                           list(r_slice[:self.log_T]),
                           self.final_openings["inc"])


class RamOutputCheckVerifier(_Verifier):
    def __init__(self, log_T: int, log_K: int, z: int, outputs: bytes,
                 layout, witness_base: int, init_vals: Dict[int, int],
                 openings: dict):
        self.log_T, self.log_K = log_T, log_K
        self.z = z
        K = 1 << log_K
        self.out_cells = output_region_cells(layout, witness_base, K)
        out_words = outputs_as_words(outputs, layout)
        lhs, init_term, zp = 0, 0, 1
        self.w_sparse = {}
        for k in self.out_cells:
            self.w_sparse[k] = zp
            lhs = (lhs + zp * out_words.get(k, 0)) % P
            init_term = (init_term + zp * init_vals.get(k, 0)) % P
            zp = zp * z % P
        self._input_claim = (lhs - init_term) % P
        self.openings = openings

    @property
    def num_rounds(self) -> int:
        return self.log_T + self.log_K

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self._input_claim

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_addr = list(r[self.log_T:])
        w_eval = init_mle_eval(self.w_sparse, r_addr)  # sparse public MLE
        o = self.openings
        return w_eval * o["ra"] % P * o["inc"] % P
