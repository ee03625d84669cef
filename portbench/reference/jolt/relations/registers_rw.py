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


from ..field import FR
from ..sumcheck.engine import SumcheckInstance

P = FR.modulus


class _Verifier(SumcheckInstance):
    """Verifier instances run no rounds: only the terminal check."""


def index_mle_eval(r_addr) -> int:
    """B(r) for B(k) = k over the register space (big-endian)."""
    n = len(r_addr)
    acc = 0
    for i, rb in enumerate(r_addr):
        acc = (acc + (1 << (n - 1 - i)) * rb) % P
    return acc
