"""Grouped one-hot sumcheck relations: many matrices / claims, ONE instance.

Torch counterpart of the JAX package's `relations/grouped_onehot.py`
(reference: `subprotocols/booleanity.rs`, `zkvm/ram/hamming_booleanity.rs`,
`poly/opening_proof.rs`).  Stages 7 (booleanity + Hamming weight over every
one-hot access matrix) and 8 (opening reduction of every committed-poly
claim) group m matrices of one (K, T) into one instance by a gamma-RLC
drawn after all points and claims are fixed:

    combined_claim = sum_q gamma^q claim_q
    message(X)     = sum_q gamma^q message_q(X)

Per matrix q, with index stream c_q (M_q(k, j) = [c_q(j) = k]), cycle
table w (every member shares one: stage 7's eq tables per kind, stage 8's
per (K, point) group) and address point q_addr (or none, for the Hamming
weight):

    value:       claim_q = sum_{k,j} eq(q_addr, k) w(j) M_q(k, j)
    booleanity:  0       = sum_{k,j} eq(q_addr, k) w(j) (M_q^2 - M_q)

over log_K address rounds (MSB first) then log_T cycle rounds (HighToLow).

The JAX package works each address round over (L, M, T) arrays: per cycle
j the running products U(c_j) = prod_{i<b} chi(rho_i, bit_i(c_j)) and
suffix weights S(c_j) = prod_{i>b} chi(q_i, bit_i(c_j)), a select and
4-7 field ops per message point.  Every per-cycle factor there depends on
j only through c_j, so the port folds the cycles into the K addresses
once, H_q(k) = sum_{j: c_q(j) = k} w(j) (one integer scatter-add and one
K1 reduce), and runs the address rounds over (L, M, K):

    value:       msg_b(X) = A_q chiX_q(X) sum_k H_q S_q U chi(X, bit_b(k))
    booleanity:  msg_b(X) = A_q chiX_q(X) sum_k H_q S_q (t^2 - t),
                                               t = U chi(X, bit_b(k))

The port keeps the products G = H S U (and H S U^2 for booleanity) over
(L, M, K) and multiplies them a round by chi(rho_b, bit_b(k)) (squared
for U^2) over chi(q_{b+1}, bit_{b+1}(k)): U takes the new challenge and S
is divided as the JAX package divides it (no point coordinate in {0, 1}).
What does not depend on the challenges is made once, before the first
round, and uploaded in one copy, as the JAX package's scan hooks do: per
round the static part of the message coefficient, chiX_q(X) = chi(q_b, X)
times chi(X, bit), per (point, kind, member, bit b of k); the inverses
of chi(q_{b+1}, 0/1); and the affine chi_q(r) = c0 + c1 r of each
member's address factor (as its two ends chi(q_b, 0), chi(q_b, 1)).  What
does depend on them runs on the device from the challenge, an int by
value or the device tier's device scalar: (1 - r, r) (one K1 bind), its
square, A_q *= chi_q(r) (a bind and a product over the M members), the
coefficients A_q times their static part, and G's update.  An address
round's message is 3 K1 launches on (L, M, K), K <= 256, for the same
field values as the JAX package's.  U itself is needed once, at the end
of the address phase: eq(rho, k) over the K addresses (`eq.evals` of the
address challenges).

After the last address round the cycle phase starts from E = w and
V_q(j) = U(c_q(j)) (one gather, (L, M, T)).  The value kind's message is
linear in V, so it runs as a 2-factor product on K2 (`ProductRounds`):
of A_0 w and V_0 for one member, else of w and V_c = sum_q A_q V_q with
the V stack bound on K1 for the members' openings.  Booleanity's message
(V^2 - V) runs on the V stack through K1 (evals, products, one reduce
with the A_q as its scale).

Nothing in a round waits for the card, so `GroupedOneHot` is a
`FusedInstance` and its stages (7 and 8) run on the device tier
(`sumcheck/fused.py`), the counterpart of the JAX package's scan hooks;
its finals are the bound V_q, the members' openings.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..field import FR, kernels, ops
from ..poly import dense, eq
from ..sumcheck.engine import OpeningAccumulator, SumcheckInstance
from ..sumcheck.fused import FusedInstance
from ..sumcheck.product import ProductRounds

P = FR.modulus


def _index_tensor(streams, device) -> torch.Tensor:
    """The m index streams as one int64 (M, T) tensor on `device` (a
    tensor passes through)."""
    if isinstance(streams, torch.Tensor):
        return ops.upload(streams, device, torch.int64)
    return ops.upload(np.stack(
        [np.asarray(s, dtype=np.int64) for s in streams]), device)


class GroupedOneHot(FusedInstance):
    """m one-hot matrices over a shared (K, T) as one instance (see the
    module notes); num_rounds = log_K + log_T.

    streams:   m per-cycle index streams (each of length T), or an int64
               (M, T) tensor of them
    w_table:   the members' shared cycle-weight table (L, T) on the device
    q_addrs:   m address points (len log_K) or None (no address factor)
    claims:    m input claims (ints)
    labels:    m labels for cache_openings
    """

    def __init__(self, streams, K: int, w_table: torch.Tensor, q_addrs,
                 claims, gamma: int, labels, booleanity: bool = False,
                 opening_kind: Optional[str] = None):
        self.device = w_table.device
        self.idx = _index_tensor(streams, self.device)
        self.M, self.T = self.idx.shape
        assert self.M == len(q_addrs) == len(claims) == len(labels)
        assert w_table.shape == (kernels.N_LIMBS, self.T)
        self.K = K
        self.log_K = K.bit_length() - 1
        assert 1 << self.log_K == K and 2 <= K <= 256, \
            "one-hot chunks are committed at 2 <= K <= 256"
        self.log_T = self.T.bit_length() - 1
        self.booleanity = booleanity
        self.degree = 3 if booleanity else 2
        self.npts = self.degree
        self.gamma = gamma % P
        self.labels = list(labels)
        self.opening_kind = opening_kind
        self.q_addrs = [None if q is None else [x % P for x in q]
                        for q in q_addrs]
        self._claims = [c % P for c in claims]
        self.W = w_table

        # per-round host chi data (value side of each address variable)
        self._chi_on = []    # chi(q_b, 1) per matrix (1 when no point)
        self._chi_off = []   # chi(q_b, 0)
        for b in range(self.log_K):
            on, off = [], []
            for q in self.q_addrs:
                if q is None:
                    on.append(1)
                    off.append(1)
                else:
                    cb = q[b]
                    if cb % P in (0, 1):
                        raise ValueError(
                            "grouped one-hot: point coordinate in {0,1} "
                            "(probability ~2^-124 for FS challenges)")
                    on.append(cb)
                    off.append((1 - cb) % P)
            self._chi_on.append(on)
            self._chi_off.append(off)
        self._has_points = any(q is not None for q in self.q_addrs)

        # H_q(k) = sum_{j: c_q(j) = k} w(j): exact int64 limb sums of
        # < 2^32 words over at most 2^31 cycles, then one K1 reduce
        L = kernels.N_LIMBS
        cols = ops.scatter_add_planes(
            kernels.u64_words(w_table)[:, None, :].expand(L, self.M,
                                                           self.T),
            2, self.idx[None].expand(L, self.M, self.T), K)
        HS = ops.reduce_cols(cols)                           # (L, M, K)
        # times the initial suffix weights S_0 = prod_{i>0} chi(q_i, bit_i)
        if self._has_points:
            for b in range(self.log_K - 1, 0, -1):
                c = ops.pack_ints_host(
                    [v for pair in zip(self._chi_off[b], self._chi_on[b])
                     for v in pair], self.device).view(L, self.M, 1, 2, 1)
                n = self.log_K - 1 - b
                HS = ops.mont_mul(HS.view(L, self.M, 1 << b, 2, 1 << n),
                                  c).view(L, self.M, K)
        # G = [HS U^2, HS U] (booleanity) or [HS U] (value): (L, kinds M, K)
        self.kinds = 2 if booleanity else 1
        self.G = HS.repeat(1, self.kinds, 1) if booleanity else HS
        self.rho: list = []                        # address challenges
        self._upload_round_consts()
        self.V: Optional[torch.Tensor] = None      # (L, M, T) cycle phase
        self.E: Optional[torch.Tensor] = None      # (L, T), booleanity
        self._rounds: Optional[ProductRounds] = None   # value kind: E, V_c
        self._A_dev: Optional[torch.Tensor] = None
        self.final_openings: Optional[List[int]] = None

    # ---- engine interface ------------------------------------------------

    @property
    def num_rounds(self) -> int:
        return self.log_K + self.log_T

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        acc, gam = 0, 1
        for c in self._claims:
            acc = (acc + gam * c) % P
            gam = gam * self.gamma % P
        return acc

    def _upload_round_consts(self) -> None:
        """The address rounds' challenge-free constants, in one upload:
        per round b the message coefficients' static part `_coef[b]`
        (L, npts, kinds, M, 2) -- chiX_q(X) times chi(X, bit)^2 (HS U^2)
        and -chi(X, bit) (HS U) in booleanity, chi(X, bit) in the value
        kind --, the ends (chi(q_b, 0), chi(q_b, 1)) of each member's
        affine address factor `_ends[b]` (L, 2, M), and the inverses of
        chi(q_{b+1}, 0/1) `_dinv[b]` (L, M, 2); then A_q = gamma^q
        (L, M) and the ends of (1 - r, r) `_unit` (L, 2, 2)."""
        M, npts = self.M, self.npts
        vals = []
        for b in range(self.log_K):
            on, off = self._chi_on[b], self._chi_off[b]
            for X in [0, 2, 3][:npts]:
                for kind in range(self.kinds):
                    for q in range(M):
                        w = (off[q] + (on[q] - off[q]) * X) % P
                        for cx in (1 - X, X):
                            vals.append(
                                w * cx * cx if kind < self.kinds - 1
                                else -w * cx if self.booleanity
                                else w * cx)
            vals += off + on
            if b + 1 < self.log_K:
                for q in range(M):
                    vals += [pow(self._chi_off[b + 1][q], -1, P),
                             pow(self._chi_on[b + 1][q], -1, P)]
        vals += [pow(self.gamma, q, P) for q in range(M)] + [1, 0, 0, 1]
        c = ops.pack_ints_host(vals, self.device)
        L = kernels.N_LIMBS
        n_coef, at = npts * self.kinds * M * 2, 0
        self._coef, self._ends, self._dinv = [], [], []
        for b in range(self.log_K):
            self._coef.append(c[:, at:at + n_coef].view(
                L, npts, self.kinds, M, 2))
            at += n_coef
            self._ends.append(c[:, at:at + 2 * M].view(L, 2, M))
            at += 2 * M
            if b + 1 < self.log_K:
                self._dinv.append(c[:, at:at + 2 * M].view(L, M, 2))
                at += 2 * M
        self.A = c[:, at:at + M]                   # (L, M)
        self._unit = c[:, at + M:].view(L, 2, 2)

    def _address_message(self, b: int) -> torch.Tensor:
        L, kM, K = self.G.shape
        n = self.log_K - 1 - b                 # address bits below bit b
        # coefficient per (point, kind, member, bit b of k): A_q times its
        # static part
        coef = ops.mont_mul(self._coef[b], self.A.view(L, 1, 1, self.M, 1))
        t = ops.mont_mul(self.G.view(L, 1, kM, 1 << b, 2, 1 << n),
                         coef.view(L, self.npts, kM, 1, 2, 1))
        return ops.sum_mod(t.reshape(L, self.npts, -1))     # (L, npts, 1)

    def message_evals_dev(self, round: int) -> torch.Tensor:
        if round < self.log_K:
            return self._address_message(round)
        if self._rounds is not None:
            return self._rounds.message()                    # (L, 2, 1)
        e = dense.sumcheck_eval_points_high(self.E, 3)      # (L, 3, T/2)
        v = dense.sumcheck_eval_points_high(self.V, 3)      # (L, 3, M, T/2)
        t = ops.mont_mul(ops.sub(ops.mont_mul(v, v), v), e[:, :, None, :])
        cols = kernels.u64_words(t).sum(dim=-1)             # (L, 3, M)
        return ops.sum_mod(ops.reduce_cols(cols, self._A_dev))

    def ingest_challenge(self, r, round: int) -> None:
        if round >= self.log_K:
            if self._rounds is not None:
                self._rounds.bind(r)
            else:
                self.E = dense.bind_high(self.E, r)
            if self.V is not None:
                self.V = dense.bind_high(self.V, r)
            return
        b = round
        self.rho.append(r)
        L = kernels.N_LIMBS
        if b + 1 < self.log_K:
            # G *= chi(rho_b, bit_b(k))^e / chi(q_{b+1}, bit_{b+1}(k)), e = 2
            # for HS U^2 and 1 for HS U: U takes bit b, S drops bit b + 1
            cr = ops.bind(self._unit[:, 0], self._unit[:, 1], r)  # 1 - r, r
            if self.kinds == 2:
                cr = torch.stack([ops.mont_mul(cr, cr), cr], dim=1)
            f = ops.mont_mul(cr.view(L, self.kinds, 1, 2, 1),
                             self._dinv[b].view(L, 1, self.M, 1, 2))
            _, kM, K = self.G.shape
            n = self.log_K - 1 - b
            self.G = ops.mont_mul(
                self.G.view(L, kM, 1 << b, 2, 2, 1 << (n - 1)),
                f.view(L, kM, 1, 2, 2, 1)).view(L, kM, K)
        # A_q *= chi_q(r) = off + (on - off) r
        self.A = ops.mont_mul(self.A, ops.bind(self._ends[b][:, 0],
                                               self._ends[b][:, 1], r))
        if b + 1 == self.log_K:
            self._start_cycle_phase()

    def _start_cycle_phase(self) -> None:
        """V_q(j) = U(c_q(j)) = eq(rho, c_q(j)); E = w."""
        L = kernels.N_LIMBS
        U = eq.evals(self.rho, self.device)    # (L, K), rho[0] the MSB
        self.V = U[:, self.idx]                                    # (L,M,T)
        A = self.A                                           # (L, M)
        if self.booleanity:
            self.E = self.W
            self._A_dev = A.view(L, 1, self.M)
        elif self.M == 1:
            # one member: the product A_0 w times V_0, whose bound factor
            # is the member's opening
            self._rounds = ProductRounds([ops.mont_mul(self.W, A),
                                          self.V[:, 0]])
            self.V = None
        else:
            Vc = ops.reduce_cols(kernels.u64_words(
                ops.mont_mul(self.V, A[:, :, None])).sum(dim=1))   # (L, T)
            self._rounds = ProductRounds([self.W, Vc])
        self.G = None

    def fused_finals(self) -> List[torch.Tensor]:
        V = self.V if self.V is not None else self._rounds.flush()[1][:, None]
        return [V[:, :, 0]]                                      # (L, M)

    def fused_store(self, values: List[int]) -> None:
        self.final_openings = list(values)                       # M ints
        self.V = self.E = self._rounds = None

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        if self.opening_kind is None:
            return
        # cycle-major committed layout: (r_cycle ++ r_addr)
        pt = list(r_slice[self.log_K:]) + list(r_slice[:self.log_K])
        for label, v in zip(self.labels, self.final_openings):
            accumulator.insert((self.opening_kind, label), pt, v)

    def expected_output_claim(self, accumulator, r):  # pragma: no cover
        raise NotImplementedError("prover instance")


# ---------------------------------------------------------------------------
# verifier twin
# ---------------------------------------------------------------------------

class GroupedOneHotVerifier(SumcheckInstance):
    """Verifier twin: expected = sum_q gamma^q expected_q with the
    per-matrix openings m_q taken from the proof."""

    def __init__(self, M: int, log_K: int, log_T: int, w_evals, q_addrs,
                 claims, gamma: int, m_openings, booleanity: bool = False):
        """w_evals: per-matrix CALLABLE r_cyc -> eq-table evaluation at the
        bound cycle point (host int), or a precomputed host int table
        closure; q_addrs as in the prover (None = no address factor)."""
        self.M = M
        self.log_K, self.log_T = log_K, log_T
        self.degree = 3 if booleanity else 2
        self.booleanity = booleanity
        self.w_evals = w_evals
        self.q_addrs = q_addrs
        self._claims = [c % P for c in claims]
        self.gamma = gamma % P
        self.m_openings = [m % P for m in m_openings]

    @property
    def num_rounds(self) -> int:
        return self.log_K + self.log_T

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        acc, gam = 0, 1
        for c in self._claims:
            acc = (acc + gam * c) % P
            gam = gam * self.gamma % P
        return acc

    def message_evals_dev(self, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def ingest_challenge(self, r, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_addr = [x % P for x in r[:self.log_K]]
        r_cyc = [x % P for x in r[self.log_K:]]
        total, gam = 0, 1
        for q, wf, m in zip(self.q_addrs, self.w_evals, self.m_openings):
            a = 1
            if q is not None:
                for qi, ri in zip(q, r_addr):
                    a = a * ((qi * ri + (1 - qi) * (1 - ri)) % P) % P
            w = wf(r_cyc)
            inner = (m * m - m) % P if self.booleanity else m
            total = (total + gam * a % P * w % P * inner) % P
            gam = gam * self.gamma % P
        return total
