"""Twist registers read/write checking + Val-evaluation sumchecks: the dense
tier.

Torch counterpart of the JAX package's `relations/registers_rw.py`.
Reference relations:
  * `zkvm/registers/read_write_checking.rs:51-68`:
      sum_{k,j} eq(r_cycle, j) * [ wa(k,j)*(inc(j)+Val(k,j))
          + gamma*ra1(k,j)*Val(k,j) + gamma^2*ra2(k,j)*Val(k,j) ]
      = rd_wv_claim + gamma*rs1_rv_claim + gamma^2*rs2_rv_claim
  * `zkvm/registers/val_evaluation.rs`:
      Val(r_addr, r_cyc) = sum_{k,j} eq(r_addr, k) * LT(j, r_cyc)
                              * wa(k,j) * inc(j)
    (a register's value is the sum of all earlier increments -- Twist's
    prefix-sum identity).

Cycle-major layout (index = j*K + k): HighToLow binding runs the cycle
phase first, then the LOG_K address rounds, matching the reference's
ReadWriteConfig phase split.  The main path takes the sparse tier
(`ram_sparse.py`); this dense K*T tier is the JAX package's round-1 tier,
kept as its oracle.

`_DenseTwist` carries every dense Twist relation here and in `ram.py`.
The JAX package broadcasts each cycle-only column (eq, inc, LT) and each
address-only column (the index or address MLE, the output weights) to a
K*T array; here each table is an (8, Tc, Kc) tensor, (8, T, 1) for a
cycle column, (8, 1, K) for an address column and (8, T, K) for a
matrix, and the rounds broadcast them in place: a cycle round halves
axis 1 of the tables that depend on the cycle (K1's bind of the halves),
an address round axis 2, and a round's message takes the tables' values
at X = 0, 2, 3 (K1's evals form) where the round's variable is theirs and
the table itself, broadcast by K1's products, where it is not.  The
eq(r_addr) x LT(r_cyc) table of the Val evaluations stays two factors,
whose product has the same message (one of them is constant in every
round).  The messages reach the host engine as device evals
(`message_evals_dev`), the JAX package's `compute_message` with the
engine's interpolation.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..field import FR, ops
from ..poly import eq, lt
from ..sumcheck.engine import OpeningAccumulator, SumcheckInstance
from ..witness.registers import K, LOG_K, RegisterWitness

P = FR.modulus


def cycle_column(vals, device) -> torch.Tensor:
    """A per-cycle column (ints, or limbs (8, T)) as the table (8, T, 1)."""
    t = vals if isinstance(vals, torch.Tensor) else ops.pack_ints(vals, device)
    return t.reshape(t.shape[0], -1, 1)


def addr_column(vals, device) -> torch.Tensor:
    """A per-address column (ints, or limbs (8, K)) as the table (8, 1, K)."""
    t = vals if isinstance(vals, torch.Tensor) else ops.pack_ints(vals, device)
    return t.reshape(t.shape[0], 1, -1)


def matrix(vals, K_: int, device) -> torch.Tensor:
    """A cycle-major K*T column (index j*K + k) as the table (8, T, K)."""
    return ops.pack_ints(vals, device).reshape(ops.N_LIMBS, -1, K_)


def _bind_axis(X: torch.Tensor, r, axis: int) -> torch.Tensor:
    """Bind the MSB variable of `axis` at r (HighToLow on that axis)."""
    return ops.bind(*ops.pair_halves(X, axis), r)


class _DenseTwist(SumcheckInstance):
    """A degree-3 dense Twist relation over log_T cycle rounds then log_K
    address rounds (module notes): `tables` name its (8, Tc, Kc) tables,
    `_summand(v)` the product of their values (8, 3, ...) at X = 0, 2, 3,
    and `opened` the tables whose bound values are its openings."""

    degree = 3
    opened: Sequence[str] = ()

    def _start(self, tables: Dict[str, torch.Tensor], log_T: int,
               log_K: int) -> None:
        self.tables = tables
        self.log_T, self.log_K = log_T, log_K
        self.device = next(iter(tables.values())).device
        self.final_openings: Optional[dict] = None

    @property
    def num_rounds(self) -> int:
        return self.log_T + self.log_K

    def _axis(self, round: int) -> int:
        return 1 if round < self.log_T else 2

    def message_evals_dev(self, round: int) -> torch.Tensor:
        axis = self._axis(round)
        v = {}
        for name, X in self.tables.items():
            if X.shape[axis] == 1:                   # not the round's variable
                v[name] = X[:, None]
            else:
                v[name] = ops.evals(*ops.pair_halves(X, axis), 3)
        s = self._summand(v)
        return ops.sum_mod(s.reshape(s.shape[0], 3, -1))    # (8, 3, 1)

    def ingest_challenge(self, r, round: int) -> None:
        axis = self._axis(round)
        self.tables = {name: X if X.shape[axis] == 1 else
                       _bind_axis(X, r, axis)
                       for name, X in self.tables.items()}

    def finalize(self) -> None:
        vals = ops.unpack_ints(torch.cat(
            [self.tables[n].reshape(ops.N_LIMBS, 1) for n in self.opened],
            dim=1))
        self.final_openings = dict(zip(self.opened, vals))

    def expected_output_claim(self, accumulator, r):  # pragma: no cover
        raise NotImplementedError("prover instance")


class _Verifier(SumcheckInstance):
    """Verifier instances run no rounds: only the terminal check."""

    def message_evals_dev(self, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def ingest_challenge(self, r, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")


class RegistersReadWriteChecking(_DenseTwist):
    """Prover instance.  gamma drawn by the stage driver; r_cycle and the
    three input claims come from the accumulator (stage-1 openings)."""

    opened = ("wa", "ra1", "ra2", "val", "inc")

    def __init__(self, wit: RegisterWitness, gamma: int,
                 r_cycle: Sequence[int], claims: Sequence[int],
                 device="cuda"):
        self.T = wit.T
        self.gamma = gamma % P
        self.g2 = self.gamma * self.gamma % P
        self.r_cycle = list(r_cycle)
        self.claims = list(claims)  # [rd_wv, rs1_rv, rs2_rv]
        device = torch.device(device)
        self._start({"wa": matrix(wit.wa, K, device),
                     "ra1": matrix(wit.ra1, K, device),
                     "ra2": matrix(wit.ra2, K, device),
                     "val": matrix(wit.val, K, device),
                     "inc": cycle_column(wit.inc, device),
                     "e": cycle_column(eq.evals(self.r_cycle, device),
                                       device)},
                    self.T.bit_length() - 1, LOG_K)

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        rd, rs1, rs2 = self.claims
        return (rd + self.gamma * rs1 + self.g2 * rs2) % P

    def _summand(self, v):
        reads = ops.add(ops.mont_mul(v["ra1"], self.gamma),
                        ops.mont_mul(v["ra2"], self.g2))
        s = ops.add(ops.mont_mul(v["wa"], ops.add(v["inc"], v["val"])),
                    ops.mont_mul(reads, v["val"]))
        return ops.mont_mul(v["e"], s)

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        r_cyc = list(r_slice[:self.log_T])
        r_addr = list(r_slice[self.log_T:])
        for name in ("wa", "ra1", "ra2", "val"):
            accumulator.insert(("registers", name), r_cyc + r_addr,
                               self.final_openings[name])
        accumulator.insert(("registers", "inc"), r_cyc,
                           self.final_openings["inc"])


class RegistersReadWriteCheckingVerifier(_Verifier):
    def __init__(self, log_T: int, gamma: int, r_cycle: Sequence[int],
                 claims: Sequence[int], openings: dict):
        self.log_T = log_T
        self.gamma = gamma
        self.r_cycle = list(r_cycle)
        self.claims = list(claims)
        self.openings = openings

    @property
    def num_rounds(self) -> int:
        return self.log_T + LOG_K

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        rd, rs1, rs2 = self.claims
        return (rd + self.gamma * rs1 + self.gamma * self.gamma % P * rs2) % P

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_cyc = list(r[:self.log_T])
        o = self.openings
        g, g2 = self.gamma, self.gamma * self.gamma % P
        eq_c = eq.eq_int(self.r_cycle, r_cyc)
        inner = (o["wa"] * ((o["inc"] + o["val"]) % P)
                 + g * o["ra1"] % P * o["val"]
                 + g2 * o["ra2"] % P * o["val"]) % P
        return eq_c * inner % P


class RegistersValEvaluation(_DenseTwist):
    """Proves the Val opening from RW checking via the LT prefix identity."""

    opened = ("wa", "inc")

    def __init__(self, wit: RegisterWitness, r_addr: Sequence[int],
                 r_cyc: Sequence[int], val_claim: int, device="cuda"):
        self.T = wit.T
        self.val_claim = val_claim
        device = torch.device(device)
        # LT(j, r_cyc) * eq(r_addr, k): two factors, cycle and address
        self._start({"lt": cycle_column(lt.evals(list(r_cyc), device),
                                        device),
                     "eq": addr_column(eq.evals(list(r_addr), device),
                                       device),
                     "wa": matrix(wit.wa, K, device),
                     "inc": cycle_column(wit.inc, device)},
                    self.T.bit_length() - 1, LOG_K)

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self.val_claim

    def _summand(self, v):
        return ops.mont_mul(ops.mont_mul(v["lt"], v["eq"]),
                            ops.mont_mul(v["wa"], v["inc"]))

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        r_cyc = list(r_slice[:self.log_T])
        accumulator.insert(("registers_val_eval", "wa"), list(r_slice),
                           self.final_openings["wa"])
        accumulator.insert(("registers_val_eval", "inc"), r_cyc,
                           self.final_openings["inc"])


class RegistersValEvaluationVerifier(_Verifier):
    def __init__(self, log_T: int, r_addr: Sequence[int],
                 r_cyc: Sequence[int], val_claim: int, openings: dict):
        self.log_T = log_T
        self.r_addr = list(r_addr)
        self.r_cyc = list(r_cyc)
        self.val_claim = val_claim
        self.openings = openings

    @property
    def num_rounds(self) -> int:
        return self.log_T + LOG_K

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self.val_claim

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_cyc_new = list(r[:self.log_T])
        r_addr_new = list(r[self.log_T:])
        o = self.openings
        lt_eval = lt.lt_point_int(r_cyc_new, self.r_cyc)
        eq_addr = eq.eq_int(self.r_addr, r_addr_new)
        return lt_eval * eq_addr % P * o["wa"] % P * o["inc"] % P


def index_mle_eval(r_addr) -> int:
    """B(r) for B(k) = k over the register space (big-endian)."""
    n = len(r_addr)
    acc = 0
    for i, rb in enumerate(r_addr):
        acc = (acc + (1 << (n - 1 - i)) * rb) % P
    return acc


class RegistersRaf(_DenseTwist):
    """Ties a register one-hot matrix to its per-cycle index stream:
    sum_{k,j} eq(r_cycle,j) * M(k,j) * k = index_claim, where the same
    index_claim is proven against the PUBLIC bytecode rd/rs1/rs2 column by
    the bytecode read-raf instance batched alongside (cross-checked claims).
    """

    opened = ("m",)

    def __init__(self, onehot, gamma_unused, r_cycle, index_claim, label,
                 device="cuda"):
        self.T = len(onehot) // K
        self.r_cycle = list(r_cycle)
        self.index_claim = index_claim
        self.label = label
        device = torch.device(device)
        self._start({"e": cycle_column(eq.evals(self.r_cycle, device),
                                       device),
                     "m": matrix(onehot, K, device),
                     "b": addr_column(list(range(K)), device)},
                    self.T.bit_length() - 1, LOG_K)

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self.index_claim % P

    def _summand(self, v):
        return ops.mont_mul(v["e"], ops.mont_mul(v["m"], v["b"]))

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice) -> None:
        accumulator.insert(("registers_raf", self.label), list(r_slice),
                           self.final_openings["m"])


class RegistersRafVerifier(_Verifier):
    def __init__(self, log_T: int, r_cycle, index_claim: int, m_opening: int):
        self.log_T = log_T
        self.r_cycle = list(r_cycle)
        self.index_claim = index_claim
        self.m_opening = m_opening

    @property
    def num_rounds(self) -> int:
        return self.log_T + LOG_K

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self.index_claim % P

    def expected_output_claim(self, accumulator: OpeningAccumulator, r) -> int:
        r_cyc = list(r[:self.log_T])
        r_addr = list(r[self.log_T:])
        return (eq.eq_int(self.r_cycle, r_cyc) * self.m_opening % P
                * index_mle_eval(r_addr) % P)
