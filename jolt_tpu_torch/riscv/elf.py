"""RV64 ELF loader: executable image -> (memory image, base, entry).

Host-side analog of the reference's ELF decode
(`reference crates/jolt-program/src/image/elf.rs:29` decode: iterate
PT_LOAD program headers, copy file bytes to vaddr, zero-fill .bss, record
e_entry).  Only static little-endian RV64 executables are supported -- the
same constraint as the reference guest toolchain.

The loaded segments are flattened into ONE contiguous image starting at the
lowest PT_LOAD vaddr (gaps zero-filled): the proving pipeline treats the
whole image as the public program -- every 4-byte word expands to bytecode
rows (data words decode as NOOP rows and are never executed), and the image
doubles as the public initial RAM (`witness/ram.py initial_memory_vals`).

A minimal ELF *writer* is also provided so tests and the CLI can wrap raw
assembler output into a loadable executable without a cross toolchain.
"""

from __future__ import annotations

import dataclasses
import struct

ELF_MAGIC = b"\x7fELF"
EM_RISCV = 243
PT_LOAD = 1


class ElfError(ValueError):
    pass


@dataclasses.dataclass
class LoadedElf:
    image: bytes    # contiguous memory image (base..base+len)
    base: int       # lowest PT_LOAD vaddr, 8-aligned
    entry: int      # e_entry (initial pc)


def is_elf(data: bytes) -> bool:
    return data[:4] == ELF_MAGIC


def load_elf(data: bytes) -> LoadedElf:
    """Parse an ELF64 RISC-V little-endian executable."""
    if not is_elf(data):
        raise ElfError("not an ELF file")
    if data[4] != 2:
        raise ElfError("not ELF64")
    if data[5] != 1:
        raise ElfError("not little-endian")
    (e_type, e_machine, _ver, e_entry, e_phoff, _shoff, _flags, _ehsize,
     e_phentsize, e_phnum) = struct.unpack_from("<HHIQQQIHHH", data, 16)
    if e_machine != EM_RISCV:
        raise ElfError(f"not RISC-V (e_machine={e_machine})")
    if e_phnum == 0:
        raise ElfError("no program headers")

    segs = []
    for i in range(e_phnum):
        off = e_phoff + i * e_phentsize
        (p_type, _p_flags, p_offset, p_vaddr, _p_paddr, p_filesz,
         p_memsz, _p_align) = struct.unpack_from("<IIQQQQQQ", data, off)
        if p_type != PT_LOAD or p_memsz == 0:
            continue
        segs.append((p_vaddr, data[p_offset:p_offset + p_filesz], p_memsz))
    if not segs:
        raise ElfError("no PT_LOAD segments")

    base = min(v for v, _, _ in segs) & ~7
    end = max(v + memsz for v, _, memsz in segs)
    end = (end + 7) & ~7
    image = bytearray(end - base)
    for vaddr, filebytes, _memsz in segs:
        image[vaddr - base:vaddr - base + len(filebytes)] = filebytes
    return LoadedElf(image=bytes(image), base=base, entry=e_entry)


def write_elf(code: bytes, base: int, entry: int = None) -> bytes:
    """Minimal static ELF64 RISC-V executable wrapping `code` at `base`."""
    entry = base if entry is None else entry
    ehsize, phentsize = 64, 56
    p_offset = ehsize + phentsize
    eh = ELF_MAGIC + bytes([2, 1, 1, 0]) + b"\x00" * 8
    eh += struct.pack("<HHIQQQIHHHHHH",
                      2,            # ET_EXEC
                      EM_RISCV, 1, entry,
                      ehsize,       # e_phoff
                      0, 0, ehsize, phentsize, 1,  # one program header
                      0, 0, 0)      # no sections
    ph = struct.pack("<IIQQQQQQ", PT_LOAD, 0x7,  # RWX
                     p_offset, base, base, len(code), len(code), 8)
    return eh + ph + code
