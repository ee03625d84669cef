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

import dataclasses
from typing import List

from ..field.params import FR
from ..riscv import isa
from ..tracer.trace import Trace

P = FR.modulus
K = 128          # REGISTER_COUNT (common/src/constants.rs:2-5)
LOG_K = 7
M64 = (1 << 64) - 1


@dataclasses.dataclass
class RegisterWitness:
    wa: List[int]     # [K*T] 0/1
    ra1: List[int]
    ra2: List[int]
    val: List[int]    # [K*T] u64 register values
    inc: List[int]    # [T] field ints (rd_post - rd_pre mod p)
    rd_write: List[int]   # [T] RdWriteValue(j) (u64)
    rs1_read: List[int]   # [T]
    rs2_read: List[int]   # [T]
    T: int


@dataclasses.dataclass
class RegisterLog:
    """Sparse register access log: O(T) (up to 3 port entries per cycle,
    merged when ports coincide).  Feeds the sparse Twist tier."""
    rows: "np.ndarray"      # (E,) int64 cycle index per entry
    cols: "np.ndarray"      # (E,) int64 register index
    wa_flag: "np.ndarray"   # (E,) bool: rd writes this register
    ra1_flag: "np.ndarray"
    ra2_flag: "np.ndarray"
    prev: "np.ndarray"      # (E,) u64 register value before the cycle
    post: "np.ndarray"      # (E,) u64 value after (rd write applied)
    inc: List[int]          # (T,) field ints
    rd_eff: List[int]       # (T,) per-cycle write-port index (x0 sink)
    rs1_eff: List[int]
    rs2_eff: List[int]
    wa_pre: "np.ndarray"    # (T,) u64 rd-register value before
    wa_post: "np.ndarray"   # (T,) u64 after
    T: int


def extract_register_log(trace: Trace) -> RegisterLog:
    import numpy as np
    T = trace.padded_length
    kinds = trace.col("kind").tolist()
    rd = trace.col("rd").tolist()
    rs1 = trace.col("rs1").tolist()
    rs2 = trace.col("rs2").tolist()

    def u64(name):
        lo, hi = trace.u64_col(name)
        return (lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))).tolist()

    rs1_val = u64("rs1_val")
    rs2_val = u64("rs2_val")
    rd_pre = u64("rd_pre")
    rd_post = u64("rd_post")

    noop = isa.KIND_ID["NOOP"]
    rows, cols = [], []
    waf, r1f, r2f = [], [], []
    prev, post = [], []
    inc = [0] * T
    rd_eff = [0] * T
    rs1_eff = [0] * T
    rs2_eff = [0] * T
    wa_pre = np.zeros(T, dtype=np.uint64)
    wa_post = np.zeros(T, dtype=np.uint64)
    regs = [0] * K
    for j in range(T):
        is_op = kinds[j] != noop
        k1 = rs1[j] if is_op else 0
        k2 = rs2[j] if is_op else 0
        kw = rd[j] if rd[j] != 255 else 0
        rd_eff[j], rs1_eff[j], rs2_eff[j] = kw, k1, k2
        ports = {}
        for k, port in ((kw, "wa"), (k1, "ra1"), (k2, "ra2")):
            ports.setdefault(k, set()).add(port)
        for k, ps in sorted(ports.items()):
            rows.append(j)
            cols.append(k)
            waf.append("wa" in ps)
            r1f.append("ra1" in ps)
            r2f.append("ra2" in ps)
            pre_v = regs[k]
            prev.append(pre_v)
            if "wa" in ps and rd[j] != 255:
                assert pre_v == rd_pre[j], f"rd_pre mismatch at {j}"
                post.append(rd_post[j])
            else:
                post.append(pre_v)
            if "ra1" in ps and is_op:
                assert pre_v == rs1_val[j], f"rs1 mismatch at {j}"
            if "ra2" in ps and is_op:
                assert pre_v == rs2_val[j], f"rs2 mismatch at {j}"
        if rd[j] != 255:
            wa_pre[j] = regs[rd[j]]
            wa_post[j] = rd_post[j]
            inc[j] = (rd_post[j] - rd_pre[j]) % P
            regs[rd[j]] = rd_post[j]

    return RegisterLog(
        rows=np.asarray(rows, dtype=np.int64),
        cols=np.asarray(cols, dtype=np.int64),
        wa_flag=np.asarray(waf, dtype=bool),
        ra1_flag=np.asarray(r1f, dtype=bool),
        ra2_flag=np.asarray(r2f, dtype=bool),
        prev=np.asarray(prev, dtype=np.uint64),
        post=np.asarray(post, dtype=np.uint64),
        inc=inc, rd_eff=rd_eff, rs1_eff=rs1_eff, rs2_eff=rs2_eff,
        wa_pre=wa_pre, wa_post=wa_post, T=T)


def extract_register_witness(trace: Trace) -> RegisterWitness:
    T = trace.padded_length
    kinds = trace.col("kind").tolist()
    rd = trace.col("rd").tolist()
    rs1 = trace.col("rs1").tolist()
    rs2 = trace.col("rs2").tolist()

    def u64(name):
        import numpy as np
        lo, hi = trace.u64_col(name)
        return (lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))).tolist()

    rs1_val = u64("rs1_val")
    rs2_val = u64("rs2_val")
    rd_pre = u64("rd_pre")
    rd_post = u64("rd_post")

    wa = [0] * (K * T)
    ra1 = [0] * (K * T)
    ra2 = [0] * (K * T)
    val = [0] * (K * T)
    inc = [0] * T

    regs = [0] * K
    noop = isa.KIND_ID["NOOP"]
    for j in range(T):
        base = j * K
        for k in range(K):
            val[base + k] = regs[k]
        if kinds[j] != noop:
            ra1[base + rs1[j]] = 1
            ra2[base + rs2[j]] = 1
            assert regs[rs1[j]] == rs1_val[j], f"rs1 mismatch at {j}"
            assert regs[rs2[j]] == rs2_val[j], f"rs2 mismatch at {j}"
        else:
            ra1[base] = 1  # x0 sink: reads 0
            ra2[base] = 1
        if rd[j] != 255:
            k = rd[j]
            wa[base + k] = 1
            assert regs[k] == rd_pre[j], f"rd_pre mismatch at {j}"
            inc[j] = (rd_post[j] - rd_pre[j]) % P
            regs[k] = rd_post[j]
        else:
            wa[base] = 1  # x0 sink: writes increment 0

    rd_write = [rd_post[j] if rd[j] != 255 else 0 for j in range(T)]
    rs1_read = [rs1_val[j] if kinds[j] != noop else 0 for j in range(T)]
    rs2_read = [rs2_val[j] if kinds[j] != noop else 0 for j in range(T)]
    return RegisterWitness(wa=wa, ra1=ra1, ra2=ra2, val=val, inc=inc,
                           rd_write=rd_write, rs1_read=rs1_read,
                           rs2_read=rs2_read, T=T)
