"""Instruction-execution Shout: the read + raf batched sumcheck over the
2^128 lookup-index space (stage 5i).

Torch counterpart of the JAX package's `relations/instruction_read_raf.py`
(reference: `zkvm/instruction_lookups/read_raf_checking.rs:68-133` and
`poly/prefix_suffix.rs`).  Statement proved, for the stage-1 opening point
r_cycle and gamma drawn at stage start:

  rv + g*left_op + g^2*right_op
    = sum_{j, k} eq(j; r_cycle) * ra(k, j) * (Val_j(k) + g*RafVal_j(k))

where k ranges over 2^128, ra(k,j) = prod_i ra_i(k_i, j) factors into D=16
committed one-hot 8-bit chunk selectors, Val_j(k) is the lookup-table MLE
selected by cycle j's instruction (0 if none), and

  RafVal_j(k) = (1-raf_j) * (Left(k) + g*Right(k)) + raf_j * g * Identity(k)

ties the one-hot index to the R1CS lookup-operand columns (raf_j = 1 on the
non-interleaved add/sub/mul path).

Prover structure:
  * the first LOG_K = 128 address rounds are host algebra, copied
    unchanged: per round the message and bind of ~13 aggregated prefix
    tables of <= 256 entries, and the incremental prefix checkpoints.  The
    engine takes their round polynomials from `compute_message`.
  * the 16 phase rebuilds are O(T) device work (`_suffix_tables`): the u64
    suffix closed forms are evaluated on the host (vectorized numpy,
    `lookups/suffix_vec.py`, on a thread pool), uploaded as raw words, and
    weighted, segment-summed by chunk value and aggregated per prefix family
    by K1 (`ops.mont_mul`, `ops.segment_sum_mod`, `ops.sum_mod`).
  * the last log_T cycle rounds: one stacked device tensor (L, 18, T)
    holding [eq, combined_val, ra_0..ra_15]; a round's message is
    `sumcheck.product.stack_message` of degree 18, its bind one
    `dense.bind_high` of the stack (one K1 launch).

The three parts are spans (`utils/profiling.py`), one or two a round:
`s5i.address` (an address round's message, then its binds),
`s5i.rebuild` (a phase rebuild, the last of them building the cycle
rounds' stack) and `s5i.cycle` (a cycle round's message launches, then
its bind).

Output claims: InstructionRa(i) openings (committed chunk polys),
LookupTableFlag(t) and raf-flag virtual openings at the cycle point
(proven against the public bytecode by the stage-6 flags instance).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..field import FR, ops
from ..field.kernels import R_MOD_P
from ..lookups import tables as LT
from ..lookups.suffix_vec import eval_suffix
from ..parallel.mesh import maybe_shard
from ..poly import dense, eq
from ..poly.univariate import UniPoly
from ..sumcheck.engine import OpeningAccumulator, SumcheckInstance
from ..sumcheck.product import stack_message
from ..utils import profiling
from ..witness.instruction_lookups import D, LOG_M, M, InstructionLookupWitness

P = FR.modulus
LOG_K = LT.LOG_K  # 128
_U64 = np.uint64
_M32 = _U64(0xFFFFFFFF)

# every prefix family the table set + raf paths use
_ALL_PREFIXES = sorted(set(
    [p for t in LT.TABLES.values() for _, p, _ in t["terms"]]
    + ["left", "right", "id", "one"]))


def host_eq_evals(point: Sequence[int]) -> List[int]:
    """eq table over 2^n as host ints (doubling; O(2^n) mults)."""
    tab = [1]
    for r in point:
        r = r % P
        nxt = []
        for w in tab:
            wr = w * r % P
            nxt.append((w - wr) % P)
            nxt.append(wr)
        tab = nxt
    return tab


def _suffix_tables(u: torch.Tensor, v_tab: Optional[torch.Tensor],
                   chunk_prev: Optional[torch.Tensor], u_idx: torch.Tensor,
                   sv: torch.Tensor, seg_ids: torch.Tensor, n_streams: int,
                   coef: torch.Tensor, coef_stream: torch.Tensor,
                   coef_prefix: torch.Tensor, n_pre: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One phase's suffix-table build (the JAX package's
    `_suffix_tables_kernel`):

      1. fold the previous phase's expanding table into the running weight
         column, u *= v_tab[chunk_prev] (a gather and a K1 product; phase 0
         has no table to fold: v_tab is None);
      2. weight each entry's raw suffix value by its cycle's u and
         segment-sum by (stream, chunk);
      3. aggregate per prefix family: a product by each nonzero entry of
         the (prefix, stream) coefficient matrix and a segment-sum over
         the streams of each prefix.

    COMPACT entry layout: entry e is (cycle u_idx[e], suffix value sv[:, e],
    target segment seg_ids[e] = stream*M + chunk); only in-bucket cycles
    appear, so device work is O(sum of bucket sizes), not O(S*T).

    sv holds the raw (not Montgomery) 128-bit values as words 0-3 of the
    8 x 32-bit layout, words 4-7 zero.  mont_mul(Montgomery u, raw sv) =
    u*sv in CANONICAL form, so the segment sums run without lifting sv.
    The coefficients are packed as c * R (`coef`, Montgomery), so their
    product with a canonical sum is c * sum in Montgomery form: the JAX
    package's final product by R^2, folded in.  Both are exact, so Q is the
    same field elements.

    Returns (u_new, Q) with Q: (L, n_pre, M):
    Q[p][c] = sum_s coef[p,s] * sum_{j: chunk_j=c, j in bucket_s} u_j*sv_{s,j}."""
    if v_tab is not None:
        u = ops.mont_mul(u, v_tab[:, chunk_prev])
    w = ops.mont_mul(u[:, u_idx], sv)                      # canonical
    seg = ops.segment_sum_mod(w, seg_ids, n_streams * M)
    seg = seg.reshape(-1, n_streams, M)
    prod = ops.mont_mul(coef[:, :, None], seg[:, coef_stream])   # (L, E, M)
    q = ops.segment_sum_mod(prod.transpose(1, 2), coef_prefix, n_pre)
    return u, q.transpose(1, 2)                           # (L, n_pre, M)


def _flag_claims(e2: torch.Tensor, table_ids1: torch.Tensor,
                 inter01: torch.Tensor) -> torch.Tensor:
    """Table-flag claims at the bound cycle point: segment-sums of the eq
    column by table id (bucket 0 = no-table) and by interleave class,
    (L, NUM_TABLES + 1 + 2) (`_flag_claims_kernel`)."""
    flags = ops.segment_sum_mod(e2, table_ids1, LT.NUM_TABLES + 1)
    raf = ops.segment_sum_mod(e2, inter01, 2)
    return torch.cat([flags, raf], dim=1)


class InstructionReadRaf(SumcheckInstance):
    degree = D + 2

    def __init__(self, wit: InstructionLookupWitness, gamma: int,
                 r_cycle: Sequence[int], rv_claim: int, left_claim: int,
                 right_claim: int, device="cuda"):
        self.wit = wit
        self.device = torch.device(device)
        self.T = wit.T
        self.log_T = self.T.bit_length() - 1
        self.gamma = gamma % P
        self.g2 = gamma * gamma % P
        self.r_cycle = [r % P for r in r_cycle]
        self.claims = (rv_claim % P, left_claim % P, right_claim % P)

        # per-cycle data: numpy views from the witness, the chunk streams
        # on the device, and the running u_evals column on the device (u_j
        # = eq(j; r_cycle) * prod of finished-phase expanding tables at j's
        # chunks)
        self.u_dev = eq.evals(self.r_cycle, self.device)
        self._chunks = ops.upload(wit.chunks.astype(np.int64), self.device)
        tid = wit.table_ids_np
        inter = wit.inter_np
        self.table_masks = {int(t): tid == t for t in np.unique(tid)
                            if t >= 0}

        # raf pseudo-tables: (terms, bucket mask)
        g, g2 = self.gamma, self.g2
        self.raf_groups = {
            "raf_il": ([(g, "left", "one"), (g, "one", "left"),
                        (g2, "right", "one"), (g2, "one", "right")],
                       inter),
            "raf_id": ([(g2, "id", "one"), (g2, "one", "id")],
                       ~inter),
        }

        # phase-invariant stream plan: one (bucket, suffix) stream per
        # entry, a compact concatenated cycle-index layout, and the
        # prefix-aggregation coefficient matrix
        self._streams: List[Tuple[np.ndarray, str]] = []  # (bucket_js, suf)
        coef_entries: List[Tuple[int, int, int]] = []   # (pre_idx, s, coef)
        pre_used: List[str] = []
        pre_index: Dict[str, int] = {}
        for key, terms, mask in self._groups():
            js = np.nonzero(mask)[0].astype(np.int32)
            if js.size == 0:
                continue
            sufs = sorted({s for _, _, s in terms})
            s_idx = {}
            for s in sufs:
                s_idx[s] = len(self._streams)
                self._streams.append((js, s))
            for coef, pre, suf in terms:
                pi = pre_index.get(pre)
                if pi is None:
                    pi = pre_index[pre] = len(pre_used)
                    pre_used.append(pre)
                coef_entries.append((pi, s_idx[suf], coef % P))
        self._pre_used = pre_used
        n_pre, S = len(pre_used), len(self._streams)
        cmat = [[0] * S for _ in range(n_pre)]
        for pi, si, c in coef_entries:
            cmat[pi][si] = (cmat[pi][si] + c) % P
        # the nonzero coefficients, packed as c * R (`_suffix_tables`)
        nz = [(pi, si, c) for pi, row in enumerate(cmat)
              for si, c in enumerate(row) if c]
        self._coef = ops.pack_ints([c * R_MOD_P % P for _, _, c in nz],
                                   self.device)
        self._coef_prefix = ops.upload([pi for pi, _, _ in nz], self.device)
        self._coef_stream = ops.upload([si for _, si, _ in nz], self.device)
        self._u_idx_np = np.concatenate([js for js, _ in self._streams])
        stream_of = np.concatenate(
            [np.full(js.size, si, np.int64)
             for si, (js, _) in enumerate(self._streams)])
        self._u_idx = ops.upload(self._u_idx_np.astype(np.int64),
                                 self.device)
        self._seg_base = ops.upload(stream_of * M, self.device)

        # prefix checkpoint states (completed pairs folded in)
        self.pstates = {n: LT.PREFIXES[n].init() for n in _ALL_PREFIXES}
        self.r_hist: List[int] = []

        self.v_done: List[List[int]] = []   # finished phase tables
        self.cur_v: List[int] = [1]
        self.QP: Dict[str, List[int]] = {}
        with profiling.active().span("s5i.rebuild"):
            self._init_phase(0)

        # cycle-round state
        self.S: Optional[torch.Tensor] = None
        self.final_openings: Optional[dict] = None
        self.flag_claims: Optional[List[int]] = None
        self.raf_flag_claim: Optional[int] = None

    # ---- phase machinery ------------------------------------------------

    def _groups(self):
        """Active (group_key, terms, bucket_mask) triples."""
        out = []
        for t, mask in self.table_masks.items():
            name = LT.TABLE_NAMES[t]
            out.append((name, LT.TABLES[name]["terms"], mask))
        for key, (terms, mask) in self.raf_groups.items():
            out.append((key, terms, mask))
        return out

    def _init_phase(self, phase: int) -> None:
        """Build this phase's per-prefix suffix tables Q on the device.

        The round message only ever consumes sum_{key,suf->pre} coef * Q,
        and suffix binding commutes with that linear combination, so the
        per-round b-loop runs over ~13 prefix tables instead of ~45
        (group, term) pairs.  All O(T) work -- the u_evals fold, the
        weighting of the suffix streams, and the chunk segment-sums --
        runs on the device; the host only evaluates the u64 suffix closed
        forms (vectorized numpy) and unpacks the (n_pre, M) result."""
        wit = self.wit
        v_tab = chunk_prev = None
        if phase > 0:
            v_tab = ops.pack_ints(self.v_done[phase - 1], self.device)
            chunk_prev = self._chunks[phase - 1]
        L = LOG_K - LOG_M * (phase + 1)      # suffix bit length
        half = L // 2
        mask_h = _U64(((1 << half) - 1) & ((1 << 64) - 1))
        if L >= 64:
            s_lo = wit.idx_lo
            s_hi = (wit.idx_hi & _U64((1 << (L - 64)) - 1) if L > 64
                    else np.zeros_like(wit.idx_hi))
        else:
            s_lo = wit.idx_lo & _U64((1 << L) - 1)
            s_hi = np.zeros_like(wit.idx_hi)
        xs_all = wit.x64 & mask_h
        ys_all = wit.y64 & mask_h

        # numpy releases the GIL inside the u64 vector ops, so the
        # per-stream closed-form evaluations thread cleanly
        def _one(arg):
            js, suf = arg
            return eval_suffix(suf, xs_all[js], ys_all[js], s_lo[js],
                               s_hi[js], L)
        if len(self._streams) > 3:
            with ThreadPoolExecutor(max_workers=4) as _tp:
                parts = list(_tp.map(_one, self._streams))
        else:
            parts = [_one(a) for a in self._streams]
        lo = np.concatenate([p[0] for p in parts])
        hi = np.concatenate([p[1] for p in parts])
        # raw 128-bit values: words 0-3 of the 8 x 32-bit layout
        words = np.stack([lo & _M32, lo >> _U64(32), hi & _M32,
                          hi >> _U64(32)]).astype(np.uint32).view(np.int32)
        sv = ops.zeros((len(lo),), self.device)
        sv[:4] = ops.upload(words, self.device)
        seg_ids = self._seg_base + self._chunks[phase][self._u_idx]
        self.u_dev, q = _suffix_tables(
            self.u_dev, v_tab, chunk_prev, self._u_idx, sv, seg_ids,
            len(self._streams), self._coef, self._coef_stream,
            self._coef_prefix, len(self._pre_used))
        q_ints = ops.unpack_ints(q.reshape(q.shape[0], -1))  # (n_pre, M)
        self.QP = {}
        for pi, pre in enumerate(self._pre_used):
            row = q_ints[pi * M:(pi + 1) * M]
            if any(row):
                self.QP[pre] = row
        self.cur_v = [1]

    # ---- engine interface -----------------------------------------------

    @property
    def num_rounds(self) -> int:
        return LOG_K + self.log_T

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        rv, lo, ro = self.claims
        return (rv + self.gamma * lo + self.g2 * ro) % P

    def _prefix_eval(self, X: int, b: int, nb: int, rnd: int) -> Dict[str, int]:
        """All prefix family values over the prefix domain ending at the
        current phase boundary, at current var = X and in-phase bits b."""
        tail = [X] + [(b >> (nb - 1 - i)) & 1 for i in range(nb)]
        if rnd % 2 == 1:
            tail = [self.r_hist[-1]] + tail
        pair_t = 63 - (rnd // 2)
        states = LT.fold_prefixes(tail, _ALL_PREFIXES, states=self.pstates,
                                  t_start=pair_t)
        return {n: LT.PREFIXES[n].value(s) for n, s in states.items()}

    def message_evals_dev(self, round: int) -> Optional[torch.Tensor]:
        # cycle rounds run on the device; the 128 address rounds are
        # host-side prefix-suffix algebra (tiny) and use compute_message
        if round >= LOG_K:
            with profiling.active().span("s5i.cycle"):
                return stack_message(self.S, self.degree)
        return None

    def compute_message(self, round: int, previous_claim: int) -> UniPoly:
        # an address round (the cycle rounds' messages are device work)
        with profiling.active().span("s5i.address"):
            return self._address_message(round, previous_claim)

    def _address_message(self, round: int, previous_claim: int) -> UniPoly:
        rip = round % LOG_M
        length = M >> rip
        half = length // 2
        nb = (LOG_M - 1 - rip)  # in-phase bits below the current var
        s0 = 0
        s2l = 0
        s2r = 0
        items = list(self.QP.items())
        for b in range(half):
            p0 = None
            for pre, q in items:
                qb, qh = q[b], q[b + half]
                if qb == 0 and qh == 0:
                    continue
                if p0 is None:
                    p0 = self._prefix_eval(0, b, nb, round)
                    p2 = self._prefix_eval(2, b, nb, round)
                s0 += p0[pre] * qb
                p2v = p2[pre]
                s2l += p2v * qb
                s2r += p2v * qh
        s0 %= P
        s2 = (2 * s2r - s2l) % P
        return UniPoly.from_evals_and_hint(previous_claim, [s0, s2], P)

    def ingest_challenge(self, r: int, round: int) -> None:
        prof = profiling.active()
        if round >= LOG_K:
            with prof.span("s5i.cycle"):
                self.S = dense.bind_high(self.S, r)
            return
        with prof.span("s5i.address"):
            self._bind_address(r, round)
        # phase boundary
        if round % LOG_M == LOG_M - 1:
            self.v_done.append(self.cur_v)
            phase = round // LOG_M
            with prof.span("s5i.rebuild"):
                if phase + 1 < D:
                    self._init_phase(phase + 1)
                else:
                    self._init_cycle_rounds()

    def _bind_address(self, r: int, round: int) -> None:
        """An address round's binds at r: the suffix tables, the expanding
        table and, every two rounds, the prefix checkpoints."""
        r = r % P
        self.r_hist.append(r)
        rip = round % LOG_M
        length = M >> rip
        half = length // 2
        # bind the aggregated suffix polys (host, tiny)
        for k in self.QP:
            q = self.QP[k]
            self.QP[k] = [(q[i] + r * (q[i + half] - q[i])) % P
                          for i in range(half)]
        # expanding table: append the new bound bit at the LSB end
        rm = (1 - r) % P
        self.cur_v = [w * m % P
                      for w in self.cur_v for m in (rm, r)]
        # checkpoints: fold the completed pair every two rounds
        if round % 2 == 1:
            rx, ry = self.r_hist[-2], self.r_hist[-1]
            pair_t = 63 - (round // 2)
            for n in _ALL_PREFIXES:
                self.pstates[n] = LT.PREFIXES[n].update(
                    self.pstates[n], rx, ry, pair_t)

    def _init_cycle_rounds(self) -> None:
        pvals = {n: LT.PREFIXES[n].value(s) for n, s in self.pstates.items()}
        empty = LT.suffix_values(0, 0)
        tval = [LT.table_value_from_parts(name, pvals, empty)
                for name in LT.TABLE_NAMES]
        raf_il = (self.gamma * pvals["left"] + self.g2 * pvals["right"]) % P
        raf_id = self.g2 * pvals["id"] % P

        # val column: per-cycle table value + raf term.  It takes at most
        # 2 (NUM_TABLES + 1) values, so those are packed once and gathered
        # by (table, interleave class) on the device: the same field
        # elements as the per-cycle column of the JAX package.
        tval_arr = tval + [0]
        raf_arr = [raf_id, raf_il]
        val_tab = ops.pack_ints([(tv + rv) % P for tv in tval_arr
                                 for rv in raf_arr], self.device)
        tid = self.wit.table_ids_np.astype(np.int64)
        code = (np.where(tid >= 0, tid, LT.NUM_TABLES) * 2
                + self.wit.inter_np.astype(np.int64))
        code_dev = ops.upload(code, self.device)
        # one plain buffer: under a cycle mesh the eq column and the small
        # tables are gathered whole first (`ops.whole`), and each rank
        # keeps its block of the cycles (`maybe_shard`)
        S = torch.empty((val_tab.shape[0], D + 2, self.T), dtype=torch.int32,
                        device=self.device)
        S[:, 0] = ops.whole(eq.evals(self.r_cycle, self.device))
        S[:, 1] = ops.whole(val_tab)[:, code_dev]
        # ra_i columns: device gathers from the 256-entry expanding tables
        for i in range(D):
            v_tab = ops.pack_ints(self.v_done[i], self.device)
            S[:, 2 + i] = ops.whole(v_tab)[:, self._chunks[i]]
        self.S = maybe_shard(S)                      # (L, D+2, T)
        self.u_dev = None

    def finalize(self) -> None:
        vals = ops.unpack_ints(self.S.reshape(self.S.shape[0], -1))
        self.final_openings = {"eq": vals[0], "val": vals[1]}
        for i in range(D):
            self.final_openings[f"ra{i}"] = vals[2 + i]

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        r_addr = list(r_slice[:LOG_K])
        r_cyc2 = list(r_slice[LOG_K:])
        # flag claims at the new cycle point (verified by the stage-6
        # bytecode flags instance): device segment-sums of the eq column
        e2 = eq.evals(r_cyc2, self.device)
        tid1 = ops.upload((self.wit.table_ids_np + 1).astype(np.int64),
                          self.device)
        inter01 = ops.upload(self.wit.inter_np.astype(np.int64), self.device)
        claims = ops.unpack_ints(_flag_claims(e2, tid1, inter01))
        self.flag_claims = [claims[t + 1] for t in range(LT.NUM_TABLES)]
        self.raf_flag_claim = claims[LT.NUM_TABLES + 1]
        for t, name in enumerate(LT.TABLE_NAMES):
            accumulator.insert(("instr_flag", name), r_cyc2,
                               self.flag_claims[t])
        accumulator.insert(("instr_flag", "raf"), r_cyc2, self.raf_flag_claim)
        for i in range(D):
            # committed chunk layout is cycle-major: point = (cycle, addr_i)
            pt = r_cyc2 + r_addr[LOG_M * i: LOG_M * (i + 1)]
            accumulator.insert(("instr_ra", i), pt,
                               self.final_openings[f"ra{i}"])

    def expected_output_claim(self, accumulator, r):  # pragma: no cover
        raise NotImplementedError


class InstructionReadRafVerifier(SumcheckInstance):
    degree = D + 2

    def __init__(self, log_T: int, gamma: int, r_cycle: Sequence[int],
                 rv_claim: int, left_claim: int, right_claim: int,
                 openings: dict):
        """openings: ra0..ra{D-1}, flag_<TableName> per table, raf_flag."""
        self.log_T = log_T
        self.gamma = gamma % P
        self.g2 = gamma * gamma % P
        self.r_cycle = [x % P for x in r_cycle]
        self.claims = (rv_claim % P, left_claim % P, right_claim % P)
        self.openings = openings

    @property
    def num_rounds(self) -> int:
        return LOG_K + self.log_T

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        rv, lo, ro = self.claims
        return (rv + self.gamma * lo + self.g2 * ro) % P

    def message_evals_dev(self, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def ingest_challenge(self, r, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_addr = [x % P for x in r[:LOG_K]]
        r_cyc2 = [x % P for x in r[LOG_K:]]
        o = self.openings
        states = LT.fold_prefixes(r_addr, _ALL_PREFIXES)
        pvals = {n: LT.PREFIXES[n].value(s) for n, s in states.items()}
        empty = LT.suffix_values(0, 0)
        val = 0
        for name in LT.TABLE_NAMES:
            val = (val + o[f"flag_{name}"]
                   * LT.table_value_from_parts(name, pvals, empty)) % P
        raf = o["raf_flag"] % P
        il = (1 - raf) % P
        val = (val
               + il * ((self.gamma * pvals["left"]
                        + self.g2 * pvals["right"]) % P)
               + raf * (self.g2 * pvals["id"] % P)) % P
        ra_prod = 1
        for i in range(D):
            ra_prod = ra_prod * (o[f"ra{i}"] % P) % P
        return (eq.eq_int(self.r_cycle, r_cyc2) * ra_prod % P * val % P)
