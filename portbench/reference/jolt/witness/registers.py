"""Register-file witness for the Twist read/write-checking argument.

Copied from the JAX package's `witness/registers.py` (host code, logic
unchanged): the sparse access log that the sparse Twist tier reads
(`RegisterLog`, `extract_register_log`) and the dense K x T witness of
the dense tier (`relations/registers_rw.py`).

Builds the (K x T) one-hot access matrices and value table from the trace
(reference: `crates/jolt-witness/src/witnesses/{one_hot,registers,increments}.rs`,
relation spec in `zkvm/registers/read_write_checking.rs:51-68`):

  * wa(k,j)  = 1 iff register k is written at cycle j (rd == k); rows with
    no destination write the x0 sink (k=0, increment 0) so every wa row is
    exactly one-hot (Hamming weight 1 -- required by the booleanity stage)
  * ra1(k,j) = 1 iff rs1 == k;  ra2(k,j) = 1 iff rs2 == k; NOOP rows read
    the x0 sink for the same reason
  * Val(k,j) = value of register k *before* cycle j  (Val(k,0) = 0)
  * inc(j)   = RdWriteValue(j) - Val(rd,j) if a write occurs else 0

Layout: cycle-major, flat index = j*K + k (cycle bits are the index MSBs),
so HighToLow sumcheck binding does the cycle phase first, matching the
reference's phase order (`ReadWriteConfig`, zkvm/config.rs:95-115).
"""

from __future__ import annotations


LOG_K = 7
