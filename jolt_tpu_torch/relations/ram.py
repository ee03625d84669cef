"""Twist RAM relations: the verifier twins and the public host helpers.

Torch-package counterpart of the part of the JAX package's
`relations/ram.py` that the sparse Twist tier (`ram_sparse.py`) imports:
the verifier instances and the closed-form evaluations of the public
polynomials.  All of it is host work on Python ints.  The dense K x T
provers of that file are not ported (the sparse tier replaces them on the
main path).

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

from ..field import FR
from ..poly import eq, lt
from ..sumcheck.engine import OpeningAccumulator, SumcheckInstance
from ..witness.ram import remap_address

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


class _Verifier(SumcheckInstance):
    """Verifier instances run no rounds: only the terminal check."""

    def message_evals_dev(self, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def ingest_challenge(self, r, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")


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
