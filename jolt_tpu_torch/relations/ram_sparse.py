"""Sparse Twist RAM and register relations: O(T + K) memory, no dense
K x T arrays.

Torch counterpart of the host-engine tier of the JAX package's
`relations/ram_sparse.py` (reference: the sorted sparse read/write matrices
of `subprotocols/read_write_matrix/mod.rs`, `ram.rs` RamCycleMajorEntry, and
the phase structure of `zkvm/ram/read_write_checking.rs`):

  * cycle phase (first log T rounds, LSB-first binding): the K x T matrices
    ra(k,j) / Val(k,j) are represented by one entry per ACCESS (here: one
    per cycle, since idle cycles access the dummy cell k=0).  Binding the
    cycle LSB pairs entries in the same column at adjacent rows; a missing
    partner's implicit coefficients are ra = 0 and Val = the value CARRIED
    between accesses (Val is constant within a column between accesses), so
    each entry tracks the u64 `prev`/`next` carried values exactly as the
    reference's `prev_val`/`next_val`.  Entry count never exceeds T.
  * address phase (last log K rounds, MSB-first binding on dense O(K)
    tensors): after all cycle variables bind, at most one entry per column
    survives; ra / Val materialize as K-length vectors (untouched columns
    keep ra = 0, Val = Init(k)) and the remaining rounds run dense.

The pairing pattern over all rounds depends only on the access positions,
NOT on the challenges, so the whole merge schedule precomputes on the host
with numpy (`RamPairSchedule`, logic unchanged) and uploads its index
tensors and implicit-Val fills to the device once, when it is built;
per-round device work is gathers + field ops over at most T lanes, and
every Fr op goes through K1 (gamma powers by value; the challenge by
value on the host engine, as a device scalar on the device tier).

Every relation here is a `FusedInstance` (the counterpart of the JAX
package's scan hooks): nothing in a round's message or bind reads a
value back or copies to or from the host -- the address phase's tables
and the public per-column constants are made before the first round --
so a stage of them runs on the device tier (`sumcheck/fused.py`), its
finals (`final_tensors`) fetched with the stage's one copy.

Relations (all degree <= 3):
  registers rw:  sum eq(r_cyc,j) [wa (inc + Val) + (g ra1 + g^2 ra2) Val]
  registers val: sum LT(j,r_cyc) inc(j) wa(k,j) eqA(r_addr,k)
  RAM rw:        sum eq(r_cyc,j) ra(k,j) ((1+g) Val(k,j) + g inc(j))
  RAM raf:       sum eq(r_cyc,j) ra(k,j) A(k)          (A public affine)
  RAM val eval:  sum LT(j,r_cyc) inc(j) ra(k,j) eqA(r_addr,k)
  output check:  sum inc(j) ra(k,j) W(k)               (W public sparse)
  one-hot table: sum eq(r_cyc,j) M(k,j) TAB(k)         (TAB public dense:
                 the register rafs and the bytecode read-raf of stage 6)

In the address phase every relation's remaining sum carries one fully bound
cycle factor (EQ[:, :1], LT*INC or INC[:, :1]).  The JAX host engine scales
the host evals by it (a `post` hook); here the message's mod-p finish (K1's
reduce form) multiplies it in on the device.  Both are exact mod p, so the
proof bytes are the same.

Opening points are normalized to the canonical big-endian cycle-major
order (r_cycle ++ r_addr): cycle challenges arrive LSB-first and reverse;
address challenges arrive MSB-first and keep their order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..field import FR, ops
from ..parallel.mesh import maybe_shard
from ..poly import dense, eq, lt
from ..sumcheck.engine import OpeningAccumulator, SumcheckInstance
from ..sumcheck.fused import FusedInstance
from ..witness.registers import LOG_K as REG_LOG_K
from .ram import (RamOutputCheckVerifier, RamRafEvaluationVerifier,
                  RamReadWriteCheckingVerifier, RamValEvaluationVerifier,
                  addr_mle_eval, init_mle_eval, output_region_cells,
                  outputs_as_words)
from .registers_rw import index_mle_eval

P = FR.modulus
_M32 = np.uint64(0xFFFFFFFF)


def _u64_field(a: np.ndarray, device) -> torch.Tensor:
    """Host uint64 values -> Montgomery limbs (8, n) on `device`."""
    a = np.asarray(a, dtype=np.uint64)
    lo = (a & _M32).astype(np.uint32).view(np.int32)
    hi = (a >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return ops.from_u64(ops.upload(lo, device), ops.upload(hi, device))


# ---------------------------------------------------------------------------
# host-side pair schedule
# ---------------------------------------------------------------------------

def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


class _Round:
    """One cycle-phase merge round.  Index tensors and the implicit-Val
    fills (field form) live on the device; the columns stay on the host."""

    __slots__ = ("even_src", "odd_src", "has_e", "has_o", "imp_e", "imp_o",
                 "rows", "cols", "n_real")

    def __init__(self, even_src, odd_src, has_e, has_o, imp_e, imp_o, rows,
                 cols, n_real):
        self.even_src = even_src    # (Epad,) int64 into previous entries
        self.odd_src = odd_src
        self.has_e = has_e          # (Epad,) bool
        self.has_o = has_o
        self.imp_e = imp_e          # (L, Epad) field: the implicit Val fills
        self.imp_o = imp_o
        self.rows = rows            # (Epad,) int64 merged row index g
        self.cols = cols            # (Epad,) int64 column, host (K = pad)
        self.n_real = n_real


class RamPairSchedule:
    """Precomputed cycle-phase merge schedule for one access stream.

    cols/pre/post: per-cycle accessed column + u64 value before/after
    (k = 0 dummy cell for idle cycles, pre = post = 0).  The schedule is
    numpy on the host; its index tensors upload to `device`.
    """

    def __init__(self, cols: np.ndarray, pre: np.ndarray, post: np.ndarray,
                 K: int, rows: Optional[np.ndarray] = None,
                 T: Optional[int] = None, device="cuda"):
        T = T if T is not None else len(cols)
        self.T = T
        self.log_T = T.bit_length() - 1
        self.K = K
        self.device = torch.device(device)
        self.rounds: List[_Round] = []

        def dev(a, dtype):
            return ops.upload(np.ascontiguousarray(a), self.device, dtype)

        col = np.asarray(cols, dtype=np.int64)
        row = (np.arange(T, dtype=np.int64) if rows is None
               else np.asarray(rows, dtype=np.int64))
        prev = np.asarray(pre, dtype=np.uint64)
        nxt = np.asarray(post, dtype=np.uint64)

        for _ in range(self.log_T):
            E = len(col)
            order = np.lexsort((row, col))
            col_s, row_s = col[order], row[order]
            prev_s, nxt_s = prev[order], nxt[order]
            g_s = row_s >> 1
            new = np.ones(E, dtype=bool)
            new[1:] = (col_s[1:] != col_s[:-1]) | (g_s[1:] != g_s[:-1])
            gid = np.cumsum(new) - 1
            n_pairs = int(gid[-1]) + 1 if E else 0
            Epad = _next_pow2(max(n_pairs, 1))

            even_m = (row_s & 1) == 0
            even_src = np.full(Epad, -1, dtype=np.int64)
            odd_src = np.full(Epad, -1, dtype=np.int64)
            even_src[gid[even_m]] = order[even_m]
            odd_src[gid[~even_m]] = order[~even_m]
            # per-pair carried values from whichever side is present
            e_prev = np.zeros(Epad, dtype=np.uint64)
            e_next = np.zeros(Epad, dtype=np.uint64)
            o_prev = np.zeros(Epad, dtype=np.uint64)
            o_next = np.zeros(Epad, dtype=np.uint64)
            e_prev[gid[even_m]] = prev_s[even_m]
            e_next[gid[even_m]] = nxt_s[even_m]
            o_prev[gid[~even_m]] = prev_s[~even_m]
            o_next[gid[~even_m]] = nxt_s[~even_m]
            has_e = even_src >= 0
            has_o = odd_src >= 0
            imp_e_u64 = np.where(~has_e, o_prev, 0).astype(np.uint64)
            imp_o_u64 = np.where(~has_o, e_next, 0).astype(np.uint64)
            imp = _u64_field(np.concatenate([imp_e_u64, imp_o_u64]),
                             self.device)

            rows_pair = np.zeros(Epad, dtype=np.int64)
            rows_pair[gid] = g_s
            cols_pair = np.full(Epad, self.K, dtype=np.int64)
            cols_pair[gid] = col_s

            self.rounds.append(_Round(
                even_src=dev(np.maximum(even_src, 0), torch.int64),
                odd_src=dev(np.maximum(odd_src, 0), torch.int64),
                has_e=dev(has_e, torch.bool),
                has_o=dev(has_o, torch.bool),
                imp_e=imp[:, :Epad],
                imp_o=imp[:, Epad:],
                rows=dev(rows_pair, torch.int64),
                cols=cols_pair,
                n_real=n_pairs,
            ))

            # next round's entries = this round's pairs
            col = cols_pair[:n_pairs].copy()
            row = rows_pair[:n_pairs].copy()
            prev = np.where(has_e[:n_pairs], e_prev[:n_pairs],
                            o_prev[:n_pairs]).astype(np.uint64)
            nxt = np.where(has_o[:n_pairs], o_next[:n_pairs],
                           e_next[:n_pairs]).astype(np.uint64)

        self.final_cols = col           # (n_final,) distinct columns
        self.final_cols_dev = dev(col, torch.int64)
        self.initial_pre = np.asarray(pre, dtype=np.uint64)
        self.n_entries0 = len(cols)

    def initial_val(self) -> torch.Tensor:
        return _u64_field(self.initial_pre, self.device)


# ---------------------------------------------------------------------------
# device round work
# ---------------------------------------------------------------------------

def _evals3(e: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Univariate evals at X in {0,2,3}: (L,E) pairs -> (L,3,E)."""
    return ops.evals(e, o, 3)


def _gather_pairs(X, src_e, src_o, has_e, has_o, fill_e, fill_o):
    """Pairwise gather with implicit fills: (L,E'),(L,E') even/odd lanes.
    A fill is an (L, E') tensor or the field zero 0.  Under a cycle mesh
    X is gathered first (`ops.unsharded`): a schedule's pairs cross the
    ranks' blocks; each rank then keeps its block of the lanes
    (`maybe_shard`)."""
    X = ops.unsharded(X)
    xe = torch.where(has_e[None, :], X[:, src_e], fill_e)
    xo = torch.where(has_o[None, :], X[:, src_o], fill_o)
    return maybe_shard(xe), maybe_shard(xo)


def _cycle_pairs(X: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Evals at {0,2,3} of a dense cycle tensor at the merged rows (X
    gathered first under a cycle mesh, as in `_gather_pairs`)."""
    X = ops.unsharded(X)
    return _evals3(maybe_shard(X[:, 2 * rows]),
                   maybe_shard(X[:, 2 * rows + 1]))


def _rw_cycle_message(RA, VAL, EQ, INC, src_e, src_o, has_e, has_o,
                      imp_e, imp_o, rows, one_pg, g):
    rae, rao = _gather_pairs(RA, src_e, src_o, has_e, has_o, 0, 0)
    vale, valo = _gather_pairs(VAL, src_e, src_o, has_e, has_o, imp_e, imp_o)
    eq3 = _cycle_pairs(EQ, rows)
    inc3 = _cycle_pairs(INC, rows)
    ra3 = _evals3(rae, rao)
    val3 = _evals3(vale, valo)
    term = ops.add(ops.mont_mul(val3, one_pg), ops.mont_mul(inc3, g))
    return ops.sum_mod(ops.mont_mul(eq3, ops.mont_mul(ra3, term)))


def _prod_cycle_message(RA, CYC: Sequence[torch.Tensor], AC, src_e, src_o,
                        has_e, has_o, rows):
    """sum_pairs AC_pair * ra(X) * prod_f CYC[f](X); CYC: (L, T_t) each."""
    rae, rao = _gather_pairs(RA, src_e, src_o, has_e, has_o, 0, 0)
    acc = _evals3(rae, rao)
    for C in CYC:
        acc = ops.mont_mul(acc, _cycle_pairs(C, rows))
    return ops.sum_mod(ops.mont_mul(AC[:, None, :], acc))


def _bind_pairs(X, src_e, src_o, has_e, has_o, fill_e, fill_o, r):
    xe, xo = _gather_pairs(X, src_e, src_o, has_e, has_o, fill_e, fill_o)
    return ops.bind(xe, xo, r)


def _rw_addr_message(RA_K, VAL_K, one_pg, ginc, scale):
    """evals at {0,2,3} of sum_k ra(X) * ((1+g) val(X) + g*inc_c), times
    the bound cycle factor `scale`."""
    ra3 = dense.sumcheck_eval_points_high(RA_K, 3)
    val3 = dense.sumcheck_eval_points_high(VAL_K, 3)
    term = ops.add(ops.mont_mul(val3, one_pg), ginc[:, None, :])
    return ops.sum_mod(ops.mont_mul(ra3, term), scale)


def _prod_addr_message(RA_K, TAB_K, scale):
    ra3 = dense.sumcheck_eval_points_high(RA_K, 3)
    t3 = dense.sumcheck_eval_points_high(TAB_K, 3)
    return ops.sum_mod(ops.mont_mul(ra3, t3), scale)


def _materialize(vals: torch.Tensor, cols: torch.Tensor,
                 base: torch.Tensor) -> torch.Tensor:
    """Scatter (L,E) entry values into a copy of the (L,K) base table."""
    return ops.index_copy(base, 1, cols, vals)


def _reg_rw_cycle_message(WA, RA1, RA2, VAL, EQ, INC, src_e, src_o, has_e,
                          has_o, imp_e, imp_o, rows, g1, g2):
    wae, wao = _gather_pairs(WA, src_e, src_o, has_e, has_o, 0, 0)
    r1e, r1o = _gather_pairs(RA1, src_e, src_o, has_e, has_o, 0, 0)
    r2e, r2o = _gather_pairs(RA2, src_e, src_o, has_e, has_o, 0, 0)
    vle, vlo = _gather_pairs(VAL, src_e, src_o, has_e, has_o, imp_e, imp_o)
    eq3 = _cycle_pairs(EQ, rows)
    inc3 = _cycle_pairs(INC, rows)
    wa3 = _evals3(wae, wao)
    ra13 = _evals3(r1e, r1o)
    ra23 = _evals3(r2e, r2o)
    val3 = _evals3(vle, vlo)
    reads = ops.add(ops.mont_mul(ra13, g1), ops.mont_mul(ra23, g2))
    summand = ops.add(ops.mont_mul(wa3, ops.add(inc3, val3)),
                      ops.mont_mul(reads, val3))
    return ops.sum_mod(ops.mont_mul(eq3, summand))


def _reg_rw_addr_message(WA_K, RA1_K, RA2_K, VAL_K, incc, g1, g2, scale):
    wa3 = dense.sumcheck_eval_points_high(WA_K, 3)
    ra13 = dense.sumcheck_eval_points_high(RA1_K, 3)
    ra23 = dense.sumcheck_eval_points_high(RA2_K, 3)
    val3 = dense.sumcheck_eval_points_high(VAL_K, 3)
    reads = ops.add(ops.mont_mul(ra13, g1), ops.mont_mul(ra23, g2))
    summand = ops.add(ops.mont_mul(wa3, ops.add(incc[:, None, :], val3)),
                      ops.mont_mul(reads, val3))
    return ops.sum_mod(summand, scale)


# ---------------------------------------------------------------------------
# shared prover base
# ---------------------------------------------------------------------------

class _SparseRamBase(FusedInstance):
    """Cycle phase on the pair schedule, address phase on dense K tensors.
    Its finals are `final_tensors()`: name -> fully bound tensor, whose
    values become `final_openings` by name."""

    degree = 3

    def __init__(self, sched: RamPairSchedule, log_K: int):
        self.sched = sched
        self.device = sched.device
        self.log_T = sched.log_T
        self.log_K = log_K
        self.K = 1 << log_K
        self.RA = ops.ones((sched.n_entries0,), self.device)
        self.final_openings: Optional[dict] = None
        self.RA_K: Optional[torch.Tensor] = None
        self._scale: Optional[torch.Tensor] = None

    @property
    def num_rounds(self) -> int:
        return self.log_T + self.log_K

    # -- hooks ----------------------------------------------------------
    def _cycle_message(self, t: int, rnd: _Round) -> torch.Tensor: ...
    def _cycle_bind(self, rnd: _Round, r: int) -> None: ...

    def _enter_addr_phase(self) -> None:
        """Materialize the relation's own K-length tables (none by
        default)."""

    def _addr_message(self, scale: torch.Tensor) -> torch.Tensor:
        """The address-phase message, its finish scaled by `scale`."""

    def _addr_bind(self, r: int) -> None: ...

    def _addr_scale(self) -> torch.Tensor:
        """The fully bound cycle factor (8, 1) that scales every
        address-phase message."""
        raise NotImplementedError

    def message_evals_dev(self, round: int) -> torch.Tensor:
        if round < self.log_T:
            return self._cycle_message(round, self.sched.rounds[round])
        if self._scale is None:       # bound for the rest of the sumcheck
            self._scale = self._addr_scale()[:, None, :]
        return self._addr_message(self._scale)

    def ingest_challenge(self, r: int, round: int) -> None:
        if round < self.log_T:
            rnd = self.sched.rounds[round]
            self.RA = _bind_pairs(self.RA, rnd.even_src, rnd.odd_src,
                                  rnd.has_e, rnd.has_o, 0, 0, r)
            self._cycle_bind(rnd, r)
            if round + 1 == self.log_T:
                n = len(self.sched.final_cols)
                self.RA_K = _materialize(self.RA[:, :n],
                                         self.sched.final_cols_dev,
                                         ops.zeros((self.K,), self.device))
                self._enter_addr_phase()
        else:
            self.RA_K = dense.bind_high(self.RA_K, r)
            self._addr_bind(r)

    def final_tensors(self) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def fused_finals(self) -> List[torch.Tensor]:
        return [t[:, :1] for t in self.final_tensors().values()]

    def fused_store(self, values: List[int]) -> None:
        self.final_openings = dict(zip(self.final_tensors(), values))

    def _col_consts(self, TAB_K: torch.Tensor) -> List[torch.Tensor]:
        """Per cycle round, the public table's value at each pair's column
        (0 at padding pairs); the table gathered first under a cycle
        mesh, each rank keeping its block of the pairs."""
        TAB_K = ops.unsharded(TAB_K)
        out = []
        for rnd in self.sched.rounds:
            cols = ops.upload(np.minimum(rnd.cols, self.K - 1), self.device)
            live = ops.upload(rnd.cols < self.K, self.device)
            out.append(maybe_shard(torch.where(live[None, :],
                                               TAB_K[:, cols], 0)))
        return out

    def normalize_opening_point(self, r: Sequence[int]) -> List[int]:
        r_cyc = list(reversed(r[:self.log_T]))
        return r_cyc + list(r[self.log_T:])

    def expected_output_claim(self, accumulator, r):  # pragma: no cover
        raise NotImplementedError("prover instance")


def _norm_split(r: Sequence[int], log_T: int):
    """Raw LSB-first cycle + MSB-first address challenges -> big-endian."""
    return list(reversed(r[:log_T])), list(r[log_T:])


# ---------------------------------------------------------------------------
# the four RAM relations
# ---------------------------------------------------------------------------

class SparseRamReadWriteChecking(_SparseRamBase):
    """rv + g*wv = sum eq(r_cyc,j) ra(k,j) ((1+g) Val(k,j) + g inc(j)).

    Mirrors `zkvm/ram/read_write_checking.rs` with the sparse matrices of
    `read_write_matrix/ram.rs`."""

    def __init__(self, sched: RamPairSchedule, log_K: int,
                 init_vals: Dict[int, int], inc: Sequence[int], gamma: int,
                 r_cycle: Sequence[int], rv_claim: int, wv_claim: int):
        super().__init__(sched, log_K)
        dev = self.device
        self.gamma = gamma % P
        self.r_cycle = [x % P for x in r_cycle]
        self.rv_claim, self.wv_claim = rv_claim % P, wv_claim % P
        self.VAL = sched.initial_val()
        self.EQ = eq.evals(self.r_cycle, dev)
        self.INC = ops.pack_ints(inc, dev)
        self.one_pg = (1 + self.gamma) % P
        # untouched columns: Val(k, *) == Init(k) (constant in j, so its
        # cycle binding is itself)
        base = np.zeros(self.K, dtype=np.uint64)
        for k, v in init_vals.items():
            if k < self.K:
                base[k] = v
        self._init_K = _u64_field(base, dev)
        self.VAL_K: Optional[torch.Tensor] = None
        self.ginc: Optional[torch.Tensor] = None

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return (self.rv_claim + self.gamma * self.wv_claim) % P

    def _cycle_message(self, t: int, rnd: _Round) -> torch.Tensor:
        return _rw_cycle_message(self.RA, self.VAL, self.EQ, self.INC,
                                 rnd.even_src, rnd.odd_src, rnd.has_e,
                                 rnd.has_o, rnd.imp_e, rnd.imp_o, rnd.rows,
                                 self.one_pg, self.gamma)

    def _cycle_bind(self, rnd: _Round, r: int) -> None:
        self.VAL = _bind_pairs(self.VAL, rnd.even_src, rnd.odd_src,
                               rnd.has_e, rnd.has_o, rnd.imp_e, rnd.imp_o, r)
        self.EQ = dense.bind_low(self.EQ, r)
        self.INC = dense.bind_low(self.INC, r)

    def _enter_addr_phase(self) -> None:
        n = len(self.sched.final_cols)
        self.VAL_K = _materialize(self.VAL[:, :n], self.sched.final_cols_dev,
                                  self._init_K)
        self.ginc = ops.mont_mul(self.INC[:, :1], self.gamma)   # (L, 1)

    def _addr_message(self, scale) -> torch.Tensor:
        return _rw_addr_message(self.RA_K, self.VAL_K, self.one_pg, self.ginc,
                                scale)

    def _addr_bind(self, r: int) -> None:
        self.VAL_K = dense.bind_high(self.VAL_K, r)

    def _addr_scale(self) -> torch.Tensor:
        return self.EQ[:, :1]                  # fully bound eq factor

    def final_tensors(self) -> Dict[str, torch.Tensor]:
        return {"ra": self.RA_K, "val": self.VAL_K, "inc": self.INC}

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        r_cyc, r_addr = _norm_split(r_slice, self.log_T)
        full = r_cyc + r_addr
        accumulator.insert(("ram", "ra"), full, self.final_openings["ra"])
        accumulator.insert(("ram", "val"), full, self.final_openings["val"])
        accumulator.insert(("ram", "inc"), r_cyc, self.final_openings["inc"])


class SparseRamRafEvaluation(_SparseRamBase):
    """address_claim = sum eq(r_cyc,j) ra(k,j) A(k); A public affine."""

    def __init__(self, sched: RamPairSchedule, log_K: int, witness_base: int,
                 r_cycle: Sequence[int], addr_claim: int):
        super().__init__(sched, log_K)
        self.addr_claim = addr_claim % P
        self.EQ = eq.evals([x % P for x in r_cycle], self.device)
        addrs = np.arange(self.K, dtype=np.uint64)
        a_u64 = np.where(addrs == 0, 0, witness_base + 8 * (addrs - 1))
        self.A_K = _u64_field(a_u64, self.device)
        self._percol = self._col_consts(self.A_K)

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self.addr_claim

    def _cycle_message(self, t: int, rnd: _Round) -> torch.Tensor:
        return _prod_cycle_message(self.RA, [self.EQ], self._percol[t],
                                   rnd.even_src, rnd.odd_src, rnd.has_e,
                                   rnd.has_o, rnd.rows)

    def _cycle_bind(self, rnd: _Round, r: int) -> None:
        self.EQ = dense.bind_low(self.EQ, r)

    def _addr_message(self, scale) -> torch.Tensor:
        return _prod_addr_message(self.RA_K, self.A_K, scale)

    def _addr_bind(self, r: int) -> None:
        self.A_K = dense.bind_high(self.A_K, r)

    def _addr_scale(self) -> torch.Tensor:
        return self.EQ[:, :1]

    def final_tensors(self) -> Dict[str, torch.Tensor]:
        return {"ra": self.RA_K}

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        r_cyc, r_addr = _norm_split(r_slice, self.log_T)
        accumulator.insert(("ram_raf", "ra"), r_cyc + r_addr,
                           self.final_openings["ra"])


class SparseRamValEvaluation(_SparseRamBase):
    """Val(r) - Init(r_addr) = sum LT(j,r_cyc) inc(j) ra(k,j) eq(r_addr,k)."""

    def __init__(self, sched: RamPairSchedule, log_K: int,
                 init_vals: Dict[int, int], inc: Sequence[int],
                 r_addr: Sequence[int], r_cyc: Sequence[int],
                 val_claim: int):
        super().__init__(sched, log_K)
        init_eval = init_mle_eval(init_vals, r_addr)
        self._input_claim = (val_claim - init_eval) % P
        self.LT = lt.evals([x % P for x in r_cyc], self.device)
        self.INC = ops.pack_ints(inc, self.device)
        self.EA_K = eq.evals([x % P for x in r_addr], self.device)
        self._percol = self._col_consts(self.EA_K)

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self._input_claim

    def _cycle_message(self, t: int, rnd: _Round) -> torch.Tensor:
        return _prod_cycle_message(self.RA, [self.LT, self.INC],
                                   self._percol[t], rnd.even_src,
                                   rnd.odd_src, rnd.has_e, rnd.has_o,
                                   rnd.rows)

    def _cycle_bind(self, rnd: _Round, r: int) -> None:
        self.LT = dense.bind_low(self.LT, r)
        self.INC = dense.bind_low(self.INC, r)

    def _addr_message(self, scale) -> torch.Tensor:
        return _prod_addr_message(self.RA_K, self.EA_K, scale)

    def _addr_bind(self, r: int) -> None:
        self.EA_K = dense.bind_high(self.EA_K, r)

    def _addr_scale(self) -> torch.Tensor:
        return ops.mont_mul(self.LT[:, :1], self.INC[:, :1])

    def final_tensors(self) -> Dict[str, torch.Tensor]:
        return {"ra": self.RA_K, "inc": self.INC}

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        r_cyc, r_addr = _norm_split(r_slice, self.log_T)
        accumulator.insert(("ram_val_eval", "ra"), r_cyc + r_addr,
                           self.final_openings["ra"])
        accumulator.insert(("ram_val_eval", "inc"), r_cyc,
                           self.final_openings["inc"])


class SparseRamOutputCheck(_SparseRamBase):
    """outputs - W.Init = sum inc(j) ra(k,j) W(k); W sparse public."""

    def __init__(self, sched: RamPairSchedule, log_K: int,
                 init_vals: Dict[int, int], inc: Sequence[int], layout,
                 witness_base: int, z: int, outputs: bytes):
        super().__init__(sched, log_K)
        out_cells = output_region_cells(layout, witness_base, self.K)
        out_words = outputs_as_words(outputs, layout)
        lhs, init_term, zp = 0, 0, 1
        w_sparse: Dict[int, int] = {}
        for k in out_cells:
            w_sparse[k] = zp
            lhs = (lhs + zp * out_words.get(k, 0)) % P
            init_term = (init_term + zp * init_vals.get(k, 0)) % P
            zp = zp * z % P
        self._input_claim = (lhs - init_term) % P
        self.INC = ops.pack_ints(inc, self.device)
        W_K = ops.zeros((self.K,), self.device)
        if w_sparse:
            cells = ops.upload(sorted(w_sparse), self.device)
            W_K[:, cells] = ops.whole(ops.pack_ints(
                [w_sparse[k] for k in sorted(w_sparse)], self.device))
        self.W_K = W_K
        self._percol = self._col_consts(self.W_K)

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self._input_claim

    def _cycle_message(self, t: int, rnd: _Round) -> torch.Tensor:
        return _prod_cycle_message(self.RA, [self.INC], self._percol[t],
                                   rnd.even_src, rnd.odd_src, rnd.has_e,
                                   rnd.has_o, rnd.rows)

    def _cycle_bind(self, rnd: _Round, r: int) -> None:
        self.INC = dense.bind_low(self.INC, r)

    def _addr_message(self, scale) -> torch.Tensor:
        return _prod_addr_message(self.RA_K, self.W_K, scale)

    def _addr_bind(self, r: int) -> None:
        self.W_K = dense.bind_high(self.W_K, r)

    def _addr_scale(self) -> torch.Tensor:
        return self.INC[:, :1]

    def final_tensors(self) -> Dict[str, torch.Tensor]:
        return {"ra": self.RA_K, "inc": self.INC}

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        r_cyc, r_addr = _norm_split(r_slice, self.log_T)
        accumulator.insert(("ram_output", "ra"), r_cyc + r_addr,
                           self.final_openings["ra"])
        accumulator.insert(("ram_output", "inc"), r_cyc,
                           self.final_openings["inc"])


# ---------------------------------------------------------------------------
# generic one-hot x public-table relation (registers raf, bytecode read-raf)
# ---------------------------------------------------------------------------

class SparseOneHotTableEval(_SparseRamBase):
    """claim = sum_{k,j} eq(r_cycle,j) * M(k,j) * TAB(k) for a one-hot M
    given by its per-cycle index stream and a PUBLIC dense table TAB.

    Covers the register raf instances (TAB(k) = k) and the bytecode
    read-raf Shout (TAB = gamma-combined decoded-program columns,
    `zkvm/bytecode/read_raf_checking.rs`).  TAB_K lives on the schedule's
    device."""

    def __init__(self, sched: RamPairSchedule, log_K: int,
                 TAB_K: torch.Tensor, r_cycle: Sequence[int], claim: int,
                 opening_id, opening_key: str = "ra"):
        super().__init__(sched, log_K)
        self.claim = claim % P
        self.EQ = eq.evals([x % P for x in r_cycle], self.device)
        self.TAB_K = TAB_K
        self.opening_id = opening_id
        self.opening_key = opening_key
        self._percol = self._col_consts(TAB_K)

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self.claim

    def _cycle_message(self, t: int, rnd: _Round) -> torch.Tensor:
        return _prod_cycle_message(self.RA, [self.EQ], self._percol[t],
                                   rnd.even_src, rnd.odd_src, rnd.has_e,
                                   rnd.has_o, rnd.rows)

    def _cycle_bind(self, rnd: _Round, r: int) -> None:
        self.EQ = dense.bind_low(self.EQ, r)

    def _addr_message(self, scale) -> torch.Tensor:
        return _prod_addr_message(self.RA_K, self.TAB_K, scale)

    def _addr_bind(self, r: int) -> None:
        self.TAB_K = dense.bind_high(self.TAB_K, r)

    def _addr_scale(self) -> torch.Tensor:
        return self.EQ[:, :1]

    def final_tensors(self) -> Dict[str, torch.Tensor]:
        return {self.opening_key: self.RA_K}

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        r_cyc, r_addr = _norm_split(r_slice, self.log_T)
        accumulator.insert(self.opening_id, r_cyc + r_addr,
                           self.final_openings[self.opening_key])


def index_table(K: int, device="cuda") -> torch.Tensor:
    """TAB(k) = k, a device field tensor (registers raf)."""
    return _u64_field(np.arange(K, dtype=np.uint64), device)


def combined_table_dev(table, entry: int, K: int, gamma: int,
                       columns=None, device="cuda") -> torch.Tensor:
    """Device table for the bytecode read-raf (bytecode.py combined_table)."""
    from .bytecode import combined_table
    return ops.pack_ints(combined_table(table, entry, K, gamma, columns),
                         device)


# ---------------------------------------------------------------------------
# registers: read/write checking (3 ports) + Val evaluation
# ---------------------------------------------------------------------------

class SparseRegistersReadWriteChecking(_SparseRamBase):
    """rd_wv + g*rs1_rv + g^2*rs2_rv = sum_{k,j} eq(r_cyc,j) *
    [wa(k,j)(inc(j)+Val(k,j)) + (g*ra1 + g^2*ra2)(k,j) * Val(k,j)].

    Entries: <=3 per cycle (the registers touched by rd/rs1/rs2, merged
    when ports coincide), sharing one Val carried-value chain per register.
    Mirrors `zkvm/registers/read_write_checking.rs` with the sparse
    matrices of `read_write_matrix/registers.rs`."""

    def __init__(self, log, gamma: int, r_cycle: Sequence[int],
                 claims: Sequence[int], device="cuda"):
        sched = RamPairSchedule(log.cols, log.prev, log.post, 1 << REG_LOG_K,
                                rows=log.rows, T=log.T, device=device)
        super().__init__(sched, REG_LOG_K)
        dev = self.device
        self.gamma = gamma % P
        self.g2i = self.gamma * self.gamma % P
        self.r_cycle = [x % P for x in r_cycle]
        self.claims = list(claims)
        self.WA = _u64_field(log.wa_flag, dev)
        self.RA1 = _u64_field(log.ra1_flag, dev)
        self.RA2 = _u64_field(log.ra2_flag, dev)
        self.VAL = sched.initial_val()
        self.EQ = eq.evals(self.r_cycle, dev)
        self.INC = ops.pack_ints(log.inc, dev)
        self.WA_K = self.RA1_K = self.RA2_K = self.VAL_K = None
        self.incc = None

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        rd, rs1, rs2 = self.claims
        return (rd + self.gamma * rs1 + self.g2i * rs2) % P

    def _cycle_message(self, t: int, rnd: _Round) -> torch.Tensor:
        return _reg_rw_cycle_message(
            self.WA, self.RA1, self.RA2, self.VAL, self.EQ, self.INC,
            rnd.even_src, rnd.odd_src, rnd.has_e, rnd.has_o, rnd.imp_e,
            rnd.imp_o, rnd.rows, self.gamma, self.g2i)

    def ingest_challenge(self, r: int, round: int) -> None:
        if round < self.log_T:
            rnd = self.sched.rounds[round]

            def bind(X, fe, fo):
                return _bind_pairs(X, rnd.even_src, rnd.odd_src, rnd.has_e,
                                   rnd.has_o, fe, fo, r)
            self.WA = bind(self.WA, 0, 0)
            self.RA1 = bind(self.RA1, 0, 0)
            self.RA2 = bind(self.RA2, 0, 0)
            self.VAL = bind(self.VAL, rnd.imp_e, rnd.imp_o)
            self.EQ = dense.bind_low(self.EQ, r)
            self.INC = dense.bind_low(self.INC, r)
            if round + 1 == self.log_T:
                n = len(self.sched.final_cols)
                cols = self.sched.final_cols_dev
                zK = ops.zeros((self.K,), self.device)
                self.WA_K = _materialize(self.WA[:, :n], cols, zK)
                self.RA1_K = _materialize(self.RA1[:, :n], cols, zK)
                self.RA2_K = _materialize(self.RA2[:, :n], cols, zK)
                # registers start at 0: untouched columns keep Val = 0
                self.VAL_K = _materialize(self.VAL[:, :n], cols, zK)
                self.incc = self.INC[:, :1]
        else:
            self.WA_K = dense.bind_high(self.WA_K, r)
            self.RA1_K = dense.bind_high(self.RA1_K, r)
            self.RA2_K = dense.bind_high(self.RA2_K, r)
            self.VAL_K = dense.bind_high(self.VAL_K, r)

    def _addr_message(self, scale) -> torch.Tensor:
        return _reg_rw_addr_message(self.WA_K, self.RA1_K, self.RA2_K,
                                    self.VAL_K, self.incc, self.gamma,
                                    self.g2i, scale)

    def _addr_scale(self) -> torch.Tensor:
        return self.EQ[:, :1]

    def final_tensors(self) -> Dict[str, torch.Tensor]:
        return {"wa": self.WA_K, "ra1": self.RA1_K, "ra2": self.RA2_K,
                "val": self.VAL_K, "inc": self.INC}

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        r_cyc, r_addr = _norm_split(r_slice, self.log_T)
        full = r_cyc + r_addr
        for name in ("wa", "ra1", "ra2", "val"):
            accumulator.insert(("registers", name), full,
                               self.final_openings[name])
        accumulator.insert(("registers", "inc"), r_cyc,
                           self.final_openings["inc"])


class SparseRegistersValEvaluation(SparseRamValEvaluation):
    """Registers Val-evaluation: same prefix-sum identity over the WRITE
    port only (wa entries), zero initial register file."""

    def __init__(self, log, r_addr: Sequence[int], r_cyc: Sequence[int],
                 val_claim: int, device="cuda"):
        wa_cols = np.asarray(log.rd_eff, dtype=np.int64)
        sched = RamPairSchedule(wa_cols, log.wa_pre, log.wa_post,
                                1 << REG_LOG_K, device=device)
        super().__init__(sched, REG_LOG_K, {}, log.inc, r_addr, r_cyc,
                         val_claim)

    def final_tensors(self) -> Dict[str, torch.Tensor]:
        return {"wa": self.RA_K, "inc": self.INC}

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        r_cyc, r_addr = _norm_split(r_slice, self.log_T)
        accumulator.insert(("registers_val_eval", "wa"), r_cyc + r_addr,
                           self.final_openings["wa"])
        accumulator.insert(("registers_val_eval", "inc"), r_cyc,
                           self.final_openings["inc"])


# ---------------------------------------------------------------------------
# verifier twins: the dense twins' algebra, LSB-first cycle order
# ---------------------------------------------------------------------------

class _SparseNorm:
    def _split(self, r: Sequence[int]):
        return _norm_split(r, self.log_T)


class SparseRamReadWriteCheckingVerifier(_SparseNorm,
                                         RamReadWriteCheckingVerifier):
    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_cyc, _ = self._split(r)
        o = self.openings
        g = self.gamma
        term = ((1 + g) * o["val"] + g * o["inc"]) % P
        return eq.eq_int(self.r_cycle, r_cyc) * o["ra"] % P * term % P


class SparseRamRafEvaluationVerifier(_SparseNorm, RamRafEvaluationVerifier):
    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_cyc, r_addr = self._split(r)
        a_eval = addr_mle_eval(r_addr, self.witness_base)
        return (eq.eq_int(self.r_cycle, r_cyc) * self.openings["ra"] % P
                * a_eval % P)


class SparseRamValEvaluationVerifier(_SparseNorm, RamValEvaluationVerifier):
    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_cyc_new, r_addr_new = self._split(r)
        o = self.openings
        lt_eval = lt.lt_point_int(r_cyc_new, self.r_cyc)
        eq_addr = eq.eq_int(self.r_addr, r_addr_new)
        return lt_eval * eq_addr % P * o["ra"] % P * o["inc"] % P


class SparseRamOutputCheckVerifier(_SparseNorm, RamOutputCheckVerifier):
    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        _, r_addr = self._split(r)
        w_eval = init_mle_eval(self.w_sparse, r_addr)
        o = self.openings
        return w_eval * o["ra"] % P * o["inc"] % P


class _SparseVerifier(_SparseNorm, SumcheckInstance):
    degree = 3

    @property
    def num_rounds(self) -> int:
        return self.log_T + self.log_K

    def message_evals_dev(self, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def ingest_challenge(self, r, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")


class SparseRegistersReadWriteCheckingVerifier(_SparseVerifier):
    def __init__(self, log_T: int, gamma: int, r_cycle: Sequence[int],
                 claims: Sequence[int], openings: dict):
        self.log_T = log_T
        self.log_K = REG_LOG_K
        self.gamma = gamma
        self.r_cycle = list(r_cycle)
        self.claims = list(claims)
        self.openings = openings

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        rd, rs1, rs2 = self.claims
        return (rd + self.gamma * rs1 + self.gamma * self.gamma % P * rs2) % P

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_cyc, _ = self._split(r)
        o = self.openings
        g, g2 = self.gamma, self.gamma * self.gamma % P
        inner = (o["wa"] * ((o["inc"] + o["val"]) % P)
                 + g * o["ra1"] % P * o["val"]
                 + g2 * o["ra2"] % P * o["val"]) % P
        return eq.eq_int(self.r_cycle, r_cyc) * inner % P


class SparseRegistersValEvaluationVerifier(_SparseVerifier):
    def __init__(self, log_T: int, r_addr: Sequence[int],
                 r_cyc: Sequence[int], val_claim: int, openings: dict):
        self.log_T = log_T
        self.log_K = REG_LOG_K
        self.r_addr = list(r_addr)
        self.r_cyc = list(r_cyc)
        self.val_claim = val_claim
        self.openings = openings

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self.val_claim % P

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_cyc_new, r_addr_new = self._split(r)
        o = self.openings
        lt_eval = lt.lt_point_int(r_cyc_new, self.r_cyc)
        eq_addr = eq.eq_int(self.r_addr, r_addr_new)
        return lt_eval * eq_addr % P * o["wa"] % P * o["inc"] % P


class SparseRegistersRafVerifier(_SparseVerifier):
    def __init__(self, log_T: int, r_cycle, index_claim: int,
                 m_opening: int):
        self.log_T = log_T
        self.log_K = REG_LOG_K
        self.r_cycle = list(r_cycle)
        self.index_claim = index_claim
        self.m_opening = m_opening

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self.index_claim % P

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_cyc, r_addr = self._split(r)
        return (eq.eq_int(self.r_cycle, r_cyc) * self.m_opening % P
                * index_mle_eval(r_addr) % P)


class SparseBytecodeReadRafVerifier(_SparseVerifier):
    def __init__(self, log_T: int, log_K: int, gamma: int,
                 r_cycle: Sequence[int], claims: Sequence[int],
                 program, openings: dict, columns=None):
        self.log_T, self.log_K = log_T, log_K
        self.gamma = gamma
        self.r_cycle = list(r_cycle)
        self.claims = list(claims)
        self.program = program
        self.openings = openings
        self.columns = columns

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        acc, g = 0, 1
        for c in self.claims:
            acc = (acc + g * c) % P
            g = g * self.gamma % P
        return acc

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        from .bytecode import combined_table_eval
        r_cyc, r_addr = self._split(r)
        tab_eval = combined_table_eval(self.program, 1 << self.log_K,
                                       self.gamma, r_addr, self.columns)
        return (eq.eq_int(self.r_cycle, r_cyc) * self.openings["ra"] % P
                * tab_eval % P)
