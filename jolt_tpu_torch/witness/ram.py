"""RAM witness for the Twist memory-checking argument.

Reference: `zkvm/ram/*` + `crates/jolt-witness/src/witnesses/ram.rs`.

Address space: witness index k = (dword_address - witness_base)/8 + 1, with
k = 0 the dummy cell used by non-memory cycles (RamAddress == 0 constraint);
witness_base = memory_layout.input_start, so the I/O region is part of the
RAM witness (the layout comment in `common/src/constants.rs:34-40`).

Per cycle: ra(k,j) one-hot at the accessed dword (k=0 if none);
Val(k,j) = dword value before cycle j; inc(j) = post - pre (stores only).
Val(:,0) = the initial memory image (inputs region; program image if the
guest reads code -- cells are checked against first-access ram_pre).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from ..field.params import FR
from ..tracer.trace import Trace

P = FR.modulus


@dataclasses.dataclass
class RamWitness:
    ra: List[int]        # [K*T] 0/1, cycle-major (j*K + k)
    val: List[int]       # [K*T]
    inc: List[int]       # [T]
    addr_idx: List[int]  # [T] per-cycle accessed cell index k (0 = none)
    init_vals: Dict[int, int]   # sparse k -> initial dword value (public)
    K: int
    log_K: int
    T: int
    witness_base: int


def remap_address(addr: int, witness_base: int) -> int:
    if addr == 0:
        return 0
    assert addr >= witness_base and addr % 8 == 0, f"bad ram addr {addr:#x}"
    return (addr - witness_base) // 8 + 1


def address_of_index(k: int, witness_base: int) -> int:
    return 0 if k == 0 else witness_base + 8 * (k - 1)


def input_init_vals(inputs: bytes, layout) -> Dict[int, int]:
    """Public initial-image cells implied by the inputs region (shared by
    prover witness-gen and verifier)."""
    wb = getattr(layout, "witness_base", layout.input_start)
    out: Dict[int, int] = {}
    for off in range(0, len(inputs), 8):
        word = int.from_bytes(inputs[off:off + 8].ljust(8, b"\x00"), "little")
        if word:
            out[remap_address(layout.input_start + off, wb)] = word
    return out


def advice_init_vals(layout, trusted_advice: bytes,
                     untrusted_advice: bytes) -> Dict[int, int]:
    """PROVER-side initial cells for the advice regions.  NOT public: the
    verifier replaces these with selector-scaled openings of the committed
    advice polynomials (zkvm/ram/mod.rs compute_advice_init_contributions)."""
    wb = getattr(layout, "witness_base", layout.input_start)
    out: Dict[int, int] = {}
    for start, data in ((layout.trusted_advice_start, trusted_advice),
                        (layout.untrusted_advice_start, untrusted_advice)):
        for off in range(0, len(data), 8):
            word = int.from_bytes(data[off:off + 8].ljust(8, b"\x00"),
                                  "little")
            if word:
                out[remap_address(start + off, wb)] = word
    return out


def advice_poly_coeffs(layout, kind: str, data: bytes):
    """The committed advice polynomial: one coefficient per dword of the
    full advice region (length = region size / 8, a power of two)."""
    _, size = layout.advice_region(kind)
    n = size // 8
    return [int.from_bytes(data[8 * i:8 * i + 8].ljust(8, b"\x00"),
                           "little") for i in range(n)]


def advice_subcube(layout, kind: str, log_K: int):
    """(num_vars a, high-bit prefix) of an advice region in the remapped
    address space: the region occupies k in [k0, k0 + 2^a) with k0 a
    multiple of 2^a (guaranteed by MemoryLayout.witness_base), so its
    selector is eq(r_addr[:log_K - a], bits(k0 >> a))."""
    start, size = layout.advice_region(kind)
    if size == 0:
        return None
    a = (size // 8).bit_length() - 1
    wb = layout.witness_base
    k0 = remap_address(start, wb)
    assert k0 % (1 << a) == 0, "advice region not subcube-aligned"
    assert k0 + (1 << a) <= (1 << log_K), "advice region outside ram K"
    return a, k0 >> a


def initial_memory_vals(inputs: bytes, layout, code: bytes = b"",
                        base: int = 0, K: int = None) -> Dict[int, int]:
    """The full public initial memory image: inputs region + the program
    image loaded at `base` (so guests may read their own .text/.rodata/.data
    through the RAM argument; the reference folds the image into the
    preprocessing digest, jolt-program/src/image/).  With K set, cells
    outside the proof's 2^log_K address space are dropped identically on
    both sides (they are unreachable by any in-range access)."""
    out = input_init_vals(inputs, layout)
    wb = getattr(layout, "witness_base", layout.input_start)
    assert base % 8 == 0
    for off in range(0, len(code), 8):
        dword = int.from_bytes(code[off:off + 8].ljust(8, b"\x00"), "little")
        if dword:
            out[remap_address(base + off, wb)] = dword
    if K is not None:
        out = {k: v for k, v in out.items() if k < K}
    return out


@dataclasses.dataclass
class RamLog:
    """Sparse per-cycle access log: the O(T) witness interface for the
    sparse Twist tier (no K x T arrays)."""
    cols: "np.ndarray"   # (T,) int64 accessed cell (0 = dummy)
    pre: "np.ndarray"    # (T,) u64 value before the access (0 for k=0)
    post: "np.ndarray"   # (T,) u64 value after
    inc: List[int]       # (T,) field ints: post - pre mod p
    init_vals: Dict[int, int]
    K: int
    log_K: int
    T: int
    witness_base: int


def extract_ram_log(trace: Trace) -> RamLog:
    """O(T) sparse RAM witness (replay without materializing K x T)."""
    import numpy as np
    T = trace.padded_length
    layout = trace.memory_layout
    wb = getattr(layout, "witness_base", layout.input_start)

    def u64(name):
        lo, hi = trace.u64_col(name)
        return (lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32)))

    ram_addr = u64("ram_addr").tolist()
    ram_pre = u64("ram_pre")
    ram_post = u64("ram_post")

    ks = [remap_address(a, wb) for a in ram_addr]
    max_k = max(ks) if ks else 0
    # advice regions must lie fully inside the address space (the verifier
    # reconstructs their init contribution as whole-subcube selectors)
    for kind in ("trusted", "untrusted"):
        start, size = layout.advice_region(kind)
        if size:
            max_k = max(max_k, remap_address(start, wb) + size // 8 - 1)
    K = 1
    while K < max_k + 1:
        K *= 2
    K = max(K, 2)

    init_vals = initial_memory_vals(bytes(trace.device.inputs),
                                    layout, trace.code, trace.entry)
    init_vals.update(advice_init_vals(
        layout, bytes(getattr(trace.device, "trusted_advice", b"")),
        bytes(getattr(trace.device, "untrusted_advice", b""))))

    cols = np.asarray(ks, dtype=np.int64)
    pre = np.zeros(T, dtype=np.uint64)
    post = np.zeros(T, dtype=np.uint64)
    inc = [0] * T
    mem: Dict[int, int] = dict(init_vals)
    for j in range(T):
        k = ks[j]
        if k == 0:
            continue
        cur = mem.get(k)
        if cur is None:
            expected = init_vals.get(k, 0)
            if int(ram_pre[j]) != expected:
                raise ValueError(
                    f"cycle {j}: first access of cell {k} reads "
                    f"{int(ram_pre[j]):#x} not implied by the public "
                    f"initial image (inputs + program image)")
            cur = expected
        assert cur == int(ram_pre[j]), f"ram pre mismatch cycle {j}"
        pre[j] = cur
        post[j] = int(ram_post[j])
        if post[j] != pre[j]:
            inc[j] = (int(post[j]) - int(pre[j])) % P
            mem[k] = int(post[j])

    return RamLog(cols=cols, pre=pre, post=post, inc=inc,
                  init_vals={k: v for k, v in init_vals.items() if k < K},
                  K=K, log_K=K.bit_length() - 1, T=T,
                  witness_base=wb)


def extract_ram_witness(trace: Trace) -> RamWitness:
    T = trace.padded_length
    wb = getattr(trace.memory_layout, "witness_base",
                 trace.memory_layout.input_start)

    import numpy as np
    def u64(name):
        lo, hi = trace.u64_col(name)
        return (lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))).tolist()

    ram_addr = u64("ram_addr")
    ram_pre = u64("ram_pre")
    ram_post = u64("ram_post")

    ks = [remap_address(a, wb) for a in ram_addr]
    max_k = max(ks) if ks else 0
    K = 1
    while K < max_k + 1:
        K *= 2
    K = max(K, 2)
    log_K = K.bit_length() - 1

    # initial memory image over accessed cells (inputs region; program-image
    # cells get discovered below and are rejected until the program-image
    # claim reduction lands)
    init_vals = input_init_vals(bytes(trace.device.inputs), trace.memory_layout)

    # phase 1: discover the full public initial image over accessed cells
    # (a first access whose pre-value isn't implied by the inputs reveals a
    # program-image/static-data cell, which is public).
    seen: set = set()
    for j in range(T):
        k = ks[j]
        if k == 0:
            continue
        if k not in seen:
            seen.add(k)
            expected = init_vals.get(k, 0)
            if ram_pre[j] != expected:
                raise ValueError(
                    f"cycle {j}: first access of cell {k} reads "
                    f"{ram_pre[j]:#x} not implied by inputs -- program-image "
                    f"reads need the ProgramImageInit claim reduction "
                    f"(future round)")

    # phase 2: forward replay building ra / Val / inc exactly
    ra = [0] * (K * T)
    val = [0] * (K * T)
    inc = [0] * T
    mem: Dict[int, int] = dict(init_vals)
    for j in range(T):
        base = j * K
        for kk, v in mem.items():
            if v:
                val[base + kk] = v
        k = ks[j]
        ra[base + k] = 1
        if k != 0:
            assert mem.get(k, 0) == ram_pre[j], f"ram pre mismatch cycle {j}"
            if ram_post[j] != ram_pre[j]:
                inc[j] = (ram_post[j] - ram_pre[j]) % P
                mem[k] = ram_post[j]

    return RamWitness(ra=ra, val=val, inc=inc, addr_idx=ks,
                      init_vals=init_vals, K=K, log_K=log_K, T=T,
                      witness_base=wb)
