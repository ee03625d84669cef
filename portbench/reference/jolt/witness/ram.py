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

from typing import Dict


def remap_address(addr: int, witness_base: int) -> int:
    if addr == 0:
        return 0
    assert addr >= witness_base and addr % 8 == 0, f"bad ram addr {addr:#x}"
    return (addr - witness_base) // 8 + 1


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
