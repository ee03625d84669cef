"""Booleanity + Hamming-weight sumchecks for one-hot access matrices,
in O(T + K) space per matrix (no dense K x T materialization).

Torch counterpart of the JAX package's `relations/booleanity.py`
(reference: `subprotocols/booleanity.rs` (address phase + cycle phase),
`zkvm/ram/hamming_booleanity.rs`, HammingWeight claim reductions).

For each access matrix M over (address k, cycle j) two relations together
prove every column of M is EXACTLY one-hot:

  * booleanity:  0 = sum_{k,j} eq(r_addr,k)*eq(r_cyc,j) * (M(k,j)^2 - M(k,j))
  * hamming weight: 1 = sum_{k,j} eq(r_h, j) * M(k,j)

The witness is the per-cycle index stream c_j with M(k,j) = [k == c_j].
Binding the ADDRESS variables first (MSB first), the partially bound
matrix stays rank-one per cycle:

    M(rho_{<b} || X || k_rest, j) = u_j * chi(X, bit_b(c_j)) * [k_rest == rest(c_j)]

with u_j = prod_{i<b} chi(rho_i, bit_i(c_j)) kept as one (8, T) tensor:
one select-multiply a round (`_select_mul`, K1's product of U and the
challenge's (r, 1 - r) picked by the round's bit mask).  The eq(r_addr, .)
factor splits the same way: its suffix products over the bits below b are
premultiplied into the cycle weights (`WS[b]`), and its prefix
prod_{i<b} chi(r_addr_i, rho_i) is the running product A, an (8, 1)
device tensor times chi(r_addr_b, r) a round (K1's bind of the point's
ends (1 - r_addr_b, r_addr_b) at the challenge).  Address rounds are
degree 3 (booleanity) / degree 2 (hamming) messages over the (8, T)
tensors; the log T cycle rounds run on the dense u vector: booleanity's
(V^2 - V) on K1, the degree-2 kinds' products of two factors on K2
(`ProductRounds`).

Every message and bind reads the challenge where it lies -- an int on the
host engine, the device scalar on the device tier -- and nothing waits
for the card, so both classes (and `opening_reduction.SparseOneHotOpening`,
which shares `_OneHotRounds`) are `FusedInstance`s: the counterpart of the
JAX package's `fused_*` / `scan_*` hooks.  Their finals are the bound u
vector's one value, the matrix's opening.

Opening points are normalized to the cycle-major order (r_cycle ++ r_addr)
used by the committed polynomial layout.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..field import FR, ops
from ..poly import dense, eq
from ..sumcheck.engine import OpeningAccumulator, SumcheckInstance
from ..sumcheck.fused import FusedInstance
from ..sumcheck.product import ProductRounds

P = FR.modulus


def _bit_masks(indices, log_K: int, device) -> torch.Tensor:
    """(log_K, T) bool: bit b of each cycle's index (b = 0 the MSB)."""
    idx = ops.upload(np.asarray(indices, dtype=np.int64), device)
    shifts = torch.arange(log_K - 1, -1, -1, device=idx.device)
    return ((idx[None, :] >> shifts[:, None]) & 1).bool()


def _select_mul(U: torch.Tensor, mask: torch.Tensor, on: torch.Tensor,
                off: torch.Tensor) -> torch.Tensor:
    """U * (mask ? on : off) over the cycles: on / off are Montgomery
    scalars (8, ..., 1) that broadcast against U's (8, ..., T)."""
    return ops.mont_mul(U, torch.where(mask, on, off))


class _OneHotRounds(FusedInstance):
    """The rounds the three one-hot relations share (module notes): log_K
    address rounds over the index stream, then log_T cycle rounds.

    indices:  the per-cycle index stream (length T)
    K:        the address space, a power of two
    q_addr:   the address point (len log_K) whose eq factor rides along,
              or None (the Hamming weight)
    q_cyc:    the cycle point of the eq weights (len log_T)
    """

    degree: int
    booleanity = False

    def _setup(self, indices, K: int, q_addr, q_cyc, device) -> None:
        self.device = torch.device(device)
        self.K = K
        self.log_K = K.bit_length() - 1
        self.T = len(indices)
        self.log_T = self.T.bit_length() - 1
        assert 1 << self.log_K == K and 1 << self.log_T == self.T
        assert len(q_cyc) == self.log_T
        assert q_addr is None or len(q_addr) == self.log_K
        self.masks = _bit_masks(indices, self.log_K, self.device)
        npts = self.degree
        # one upload of the challenge-free constants: chi(X, bit) at the
        # message points for bit 1 / bit 0, the ends of (1 - r, r), the
        # field one, then per address variable b the static message factor
        # chi(q_b, X) and the ends (1 - q_b, q_b) of chi(q_b, r)
        vals = [0, 2, 3][:npts] + [1, -1, -2][:npts] + [1, 0, 0, 1, 1]
        for qb in q_addr or []:
            vals += [(1 - qb) % P, (3 * qb - 1) % P, (5 * qb - 2) % P][:npts]
            vals += [(1 - qb) % P, qb % P]
        c = ops.pack_ints_host(vals, self.device)
        self._on = c[:, :npts, None]                     # (8, npts, 1)
        self._off = c[:, npts:2 * npts, None]
        at = 2 * npts
        self._unit = c[:, at:at + 4].view(-1, 2, 2)      # lo, hi of (1-r, r)
        self.A = c[:, at + 4:at + 5]                     # (8, 1)
        at += 5
        self._chiX, self._ends = [], []
        for _ in q_addr or []:
            self._chiX.append(c[:, at:at + npts, None])
            self._ends.append(c[:, at + npts:at + npts + 2])
            at += npts + 2

        W = eq.evals(list(q_cyc), self.device)          # (8, T)
        # WS[b] = W * prod_{i>b} chi(q_addr_i, bit_i(c_j))
        self.WS: List[torch.Tensor] = [W] * self.log_K
        if q_addr is not None:
            acc = W
            for b in range(self.log_K - 1, -1, -1):
                self.WS[b] = acc
                if b > 0:
                    e = self._ends[b]
                    acc = _select_mul(acc, self.masks[b], e[:, 1:2],
                                      e[:, 0:1])
        self._has_point = q_addr is not None
        self.U = ops.ones((self.T,), self.device)
        self.E = W                       # the cycle phase's eq table
        self.V: Optional[torch.Tensor] = None
        self._rounds: Optional[ProductRounds] = None
        self.final_openings: Optional[dict] = None

    @property
    def num_rounds(self) -> int:
        return self.log_K + self.log_T

    def _scaled(self, msg: torch.Tensor, b: Optional[int]) -> torch.Tensor:
        """msg (8, npts, 1) times A and, in address round b, chi(q_b, X)."""
        if not self._has_point:
            return msg
        f = self.A[:, None, :]
        if b is not None:
            f = ops.mont_mul(self._chiX[b], f)
        return ops.mont_mul(msg, f)

    def message_evals_dev(self, round: int) -> torch.Tensor:
        if round < self.log_K:
            sel = torch.where(self.masks[round], self._on, self._off)
            t = ops.mont_mul(self.U[:, None, :], sel)    # (8, npts, T)
            if self.booleanity:
                t = ops.sub(ops.mont_mul(t, t), t)
            msg = ops.sum_mod(ops.mont_mul(self.WS[round][:, None, :], t))
            return self._scaled(msg, round)
        if self._rounds is not None:
            return self._rounds.message()                # (8, 2, 1)
        e = dense.sumcheck_eval_points_high(self.E, 3)
        v = dense.sumcheck_eval_points_high(self.V, 3)
        msg = ops.sum_mod(ops.mont_mul(e, ops.sub(ops.mont_mul(v, v), v)))
        return self._scaled(msg, None)

    def ingest_challenge(self, r, round: int) -> None:
        if round >= self.log_K:
            if self._rounds is not None:
                self._rounds.bind(r)
            else:
                self.E = dense.bind_high(self.E, r)
                self.V = dense.bind_high(self.V, r)
            return
        cr = ops.bind(self._unit[:, 0], self._unit[:, 1], r)   # (1-r, r)
        self.U = _select_mul(self.U, self.masks[round], cr[:, 1:2],
                             cr[:, 0:1])
        if self._has_point:
            e = self._ends[round]
            self.A = ops.mont_mul(self.A, ops.bind(e[:, 0:1], e[:, 1:2], r))
        if round + 1 == self.log_K:
            self._start_cycle_phase()

    def _start_cycle_phase(self) -> None:
        """E = the eq weights, V = U; the degree-2 kinds' product of A E and
        V runs on K2."""
        self.WS = None
        if self.booleanity:
            self.V = self.U
        else:
            E = ops.mont_mul(self.E, self.A) if self._has_point else self.E
            self._rounds = ProductRounds([E, self.U])
            self.E = None
        self.U = None

    def fused_finals(self) -> List[torch.Tensor]:
        V = self.V if self._rounds is None else self._rounds.flush()[1]
        return [V[:, :1]]

    def fused_store(self, values: List[int]) -> None:
        self.final_openings = {self._final_name: values[0]}
        self.E = self.V = self._rounds = None

    _final_name = "m"

    def expected_output_claim(self, accumulator, r):  # pragma: no cover
        raise NotImplementedError("prover instance")


class Booleanity(_OneHotRounds):
    """0 = sum eq(r_addr,k)*eq(r_cyc,j)*(M^2 - M); M given as the per-cycle
    one-hot index stream.  Rounds: log_K address vars then log_T cycle vars."""

    degree = 3
    booleanity = True

    def __init__(self, indices: Sequence[int], K: int, r_addr: Sequence[int],
                 r_cyc: Sequence[int], label: str, device="cuda"):
        self.r_addr = [r % P for r in r_addr]
        self.r_cyc = [r % P for r in r_cyc]
        self.label = label
        self._setup(indices, K, self.r_addr, self.r_cyc, device)

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return 0

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        # normalize to the cycle-major committed layout: (r_cycle, r_addr)
        pt = list(r_slice[self.log_K:]) + list(r_slice[:self.log_K])
        accumulator.insert(("booleanity", self.label), pt,
                           self.final_openings["m"])


class BooleanityVerifier(SumcheckInstance):
    degree = 3

    def __init__(self, log_K: int, log_T: int, r_addr: Sequence[int],
                 r_cyc: Sequence[int], m_opening: int):
        self.log_K, self.log_T = log_K, log_T
        self.r_addr = [r % P for r in r_addr]
        self.r_cyc = [r % P for r in r_cyc]
        self.m_opening = m_opening % P

    @property
    def num_rounds(self) -> int:
        return self.log_K + self.log_T

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return 0

    def message_evals_dev(self, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def ingest_challenge(self, r, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        rho = list(r[:self.log_K])
        r_cyc2 = list(r[self.log_K:])
        m = self.m_opening
        return (eq.eq_int(self.r_addr, rho) * eq.eq_int(self.r_cyc, r_cyc2)
                % P * ((m * m - m) % P) % P)


class HammingWeight(_OneHotRounds):
    """1 = sum_{k,j} eq(r_h, j) * M(k,j), M from the index stream."""

    degree = 2

    def __init__(self, indices: Sequence[int], K: int, r_cycle: Sequence[int],
                 label: str, device="cuda"):
        self.r_cycle = [r % P for r in r_cycle]
        self.label = label
        self._setup(indices, K, None, self.r_cycle, device)

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return 1

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        pt = list(r_slice[self.log_K:]) + list(r_slice[:self.log_K])
        accumulator.insert(("hamming", self.label), pt,
                           self.final_openings["m"])


class HammingWeightVerifier(SumcheckInstance):
    degree = 2

    def __init__(self, log_K: int, log_T: int, r_cycle: Sequence[int],
                 m_opening: int):
        self.log_K, self.log_T = log_K, log_T
        self.r_cycle = [r % P for r in r_cycle]
        self.m_opening = m_opening % P

    @property
    def num_rounds(self) -> int:
        return self.log_K + self.log_T

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return 1

    def message_evals_dev(self, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def ingest_challenge(self, r, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_cyc2 = list(r[self.log_K:])
        return eq.eq_int(self.r_cycle, r_cyc2) * self.m_opening % P
