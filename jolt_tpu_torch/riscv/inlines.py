"""Inline (custom-opcode) expansion: accelerated guest crypto.

TPU-stack analog of the reference's `jolt-inlines/*` crates: a guest
executes one INLINE instruction (custom-0 opcode 0x0B with a
funct3/funct7 selector) and the bytecode expander statically replaces it
with a registered virtual-instruction sequence over the 96 virtual
registers.  SHA-256 compression here follows
`jolt-inlines/sha2/src/sequence_builder.rs` (one compression in ~2.3k
final rows vs ~12k for the software guest -- the reference reports 5.9x
guest-cycle reduction, `book/src/how/optimizations/inlines.md:132-140`).

The expansion is a pure function of the decoded instruction (operand
REGISTER NUMBERS only -- never runtime state), so prover and verifier
derive the same public bytecode table.  Sequences use the dedicated
rotate/andn lookup tables (lookups/tables.py: Andn, VirtualROTRW, ...).

Builder value discipline mirrors the reference `InlineExpansionBuilder`
(`crates/jolt-program/src/expand/inline.rs:330-460`): operands are
Reg/Imm values, binary ops constant-fold Imm pairs and swap commutative
(Imm, Reg) operands so early SHA rounds burn no rows on known constants.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

M64 = (1 << 64) - 1
M32 = (1 << 32) - 1

INLINE_OPCODE = 0x0B
# (opcode, funct3, funct7) selectors (jolt-inlines/sha2/src/lib.rs)
SHA256_SEL = (INLINE_OPCODE, 0x00, 0x00)        # custom IV at (rs1)
SHA256_INIT_SEL = (INLINE_OPCODE, 0x01, 0x00)   # standard H0 constants

# SHA-256 initial hash values / round constants (FIPS 180-4)
SHA256_H0 = [
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
]
SHA256_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]


def encode_inline(sel: Tuple[int, int, int], rd: int, rs1: int,
                  rs2: int) -> int:
    """R-format encoding of an INLINE instruction word."""
    opcode, funct3, funct7 = sel
    return (opcode | (rd << 7) | (funct3 << 12) | (rs1 << 15)
            | (rs2 << 20) | (funct7 << 25))


def selector_from_imm(imm: int) -> Tuple[int, int, int]:
    """Inverse of the isa.py INLINE imm packing."""
    return (imm >> 10) & 0x7F, imm & 0x7, (imm >> 3) & 0x7F


# ---------------------------------------------------------------------------
# value-level assembler over the expansion _Builder
# ---------------------------------------------------------------------------

REG, IMM = 0, 1


def Reg(r: int):
    return (REG, r)


def Imm(v: int):
    return (IMM, v & M64)


class InlineAsm:
    """Reg/Imm-valued op layer over riscv/program.py's row builder,
    mirroring `InlineExpansionBuilder` (expand/inline.rs)."""

    def __init__(self, b):
        self.b = b   # riscv.program._Builder

    def tmp(self) -> int:
        return self.b.tmp()

    def _bin(self, rkind: str, ikind: str, rs1, rs2, rd: int, fold):
        """Binary op: fold Imm pairs, swap commutative (Imm, Reg)."""
        k1, v1 = rs1
        k2, v2 = rs2
        if k1 == REG and k2 == REG:
            self.b.emit(rkind, rd=rd, rs1=v1, rs2=v2)
            return Reg(rd)
        if k1 == REG and k2 == IMM:
            self.b.emit(ikind, rd=rd, rs1=v1, imm=v2)
            return Reg(rd)
        if k1 == IMM and k2 == REG:
            return self._bin(rkind, ikind, rs2, rs1, rd, fold)
        return Imm(fold(v1, v2))

    def add(self, rs1, rs2, rd: int):
        return self._bin("ADD", "ADDI", rs1, rs2, rd,
                         lambda x, y: (x + y) & M64)

    def xor(self, rs1, rs2, rd: int):
        return self._bin("XOR", "XORI", rs1, rs2, rd, lambda x, y: x ^ y)

    def and_(self, rs1, rs2, rd: int):
        return self._bin("AND", "ANDI", rs1, rs2, rd, lambda x, y: x & y)

    def andn(self, rs1, rs2, rd: int):
        """rd = rs1 & ~rs2 (Zbb ANDN; both operands must be registers --
        the SHA builder falls back to xor/and on Imm operands)."""
        assert rs1[0] == REG and rs2[0] == REG
        self.b.emit("ANDN", rd=rd, rs1=rs1[1], rs2=rs2[1])
        return Reg(rd)

    def srli32(self, rs1, shamt: int, rd: int):
        """32-bit logical right shift with CLEAN (zero) upper bits:
        embed the low word in the high half, then SRLI back down
        (the expand/shifts srliw recipe minus the sign extension,
        which SHA-256's 32-bit arithmetic never needs)."""
        if shamt == 0:
            return self.xor(rs1, Imm(0), rd)
        if rs1[0] == IMM:
            return Imm((rs1[1] & M32) >> shamt)
        assert rs1[1] != rd, "srli32 uses rd as scratch"
        self.b.emit("VirtualMULI", rd=rd, rs1=rs1[1], imm=1 << 32)
        self.b.emit("SRLI", rd=rd, rs1=rd, imm=32 + (shamt & 0x1F))
        return Reg(rd)

    def rotri32(self, rs1, shamt: int, rd: int):
        """32-bit rotate right, zero-extended (VirtualROTRIW row with the
        bitmask immediate; expand/inline.rs rotri32)."""
        assert shamt <= 32
        if shamt == 0 or shamt == 32:
            return self.xor(rs1, Imm(0), rd)
        if rs1[0] == IMM:
            v = rs1[1] & M32
            return Imm(((v >> shamt) | (v << (32 - shamt))) & M32)
        mask = (((1 << (32 - shamt)) - 1) << shamt) & M64
        self.b.emit("VirtualROTRIW", rd=rd, rs1=rs1[1], imm=mask)
        return Reg(rd)

    def rotri64(self, rs1, shamt: int, rd: int):
        """64-bit rotate right (VirtualROTRI with bitmask immediate)."""
        assert shamt <= 64
        if shamt % 64 == 0:
            return self.xor(rs1, Imm(0), rd)
        if rs1[0] == IMM:
            v = rs1[1]
            return Imm(((v >> shamt) | (v << (64 - shamt))) & M64)
        mask = (((1 << (64 - shamt)) - 1) << shamt) & M64
        self.b.emit("VirtualROTRI", rd=rd, rs1=rs1[1], imm=mask)
        return Reg(rd)

    def rotri_xor_rotri32(self, rs1, i1: int, i2: int, rd: int, scratch: int):
        r1 = self.rotri32(rs1, i1, scratch)
        r2 = self.rotri32(rs1, i2, rd)
        return self.xor(r1, r2, rd)

    def load_paired_u32_dirty(self, base: int, offset: int,
                              vr_lo: int, vr_hi: int) -> None:
        """Two packed u32 from (base+offset): vr_lo keeps the raw dword
        (dirty upper bits -- safe under 32-bit SHA arithmetic), vr_hi the
        high word (sdk host.rs load_paired_u32_dirty)."""
        self.b.emit("LD", rd=vr_lo, rs1=base, imm=offset)
        self.b.emit("SRLI", rd=vr_hi, rs1=vr_lo, imm=32)

    def store_paired_u32(self, base: int, offset: int,
                         vr_lo: int, vr_hi: int) -> None:
        """Pack two u32 into one SD; clobbers vr_lo and vr_hi."""
        self.b.emit("VirtualZeroExtendWord", rd=vr_lo, rs1=vr_lo)
        self.b.emit("SLLI", rd=vr_hi, rs1=vr_hi, imm=32)
        self.b.emit("OR", rd=vr_lo, rs1=vr_lo, rs2=vr_hi)
        self.b.emit("SD", rs1=base, rs2=vr_lo, imm=offset)


# ---------------------------------------------------------------------------
# SHA-256 compression sequence (jolt-inlines/sha2/src/sequence_builder.rs)
# ---------------------------------------------------------------------------

class _Sha256Builder:
    """One SHA-256 compression: state A..H at (rs1..rs1+32), sixteen
    message words at (rs2..rs2+64); output overwrites (rs1..rs1+32).
    initial=True uses the H0 constants instead of loading (rs1)."""

    def __init__(self, asm: InlineAsm, rs1: int, rs2: int, initial: bool):
        self.asm = asm
        self.rs1 = rs1
        self.rs2 = rs2
        self.initial = initial
        self.round = 0
        self.state = [asm.tmp() for _ in range(8)]
        self.message = [asm.tmp() for _ in range(16)]
        self.iv = [] if initial else [asm.tmp() for _ in range(8)]

    def build(self) -> None:
        asm = self.asm
        if not self.initial:
            for i in range(4):
                asm.load_paired_u32_dirty(self.rs1, 8 * i,
                                          self.iv[2 * i], self.iv[2 * i + 1])
        for i in range(8):
            asm.load_paired_u32_dirty(self.rs2, 8 * i,
                                      self.message[2 * i],
                                      self.message[2 * i + 1])
        t1, t2, ss, ss2 = (asm.tmp(), asm.tmp(), asm.tmp(), asm.tmp())
        for _ in range(64):
            self._round(t1, t2, ss, ss2)
        self._final_add_iv()
        outs = ["A", "B", "C", "D", "E", "F", "G", "H"]
        for i in range(4):
            asm.store_paired_u32(self.rs1, 8 * i,
                                 self.vr(outs[2 * i]), self.vr(outs[2 * i + 1]))

    def _final_add_iv(self) -> None:
        asm = self.asm
        for i, c in enumerate("ABCDEFGH"):
            src = Reg(self.iv[i]) if not self.initial else Imm(SHA256_H0[i])
            asm.add(self.vri(c), src, self.vr(c))

    def _round(self, t1: int, t2: int, ss: int, ss2: int) -> None:
        assert self.round < 64
        t1_val = self._compute_t1(t1, ss, ss2)
        t2_val = self._compute_t2(t2, ss, ss2)
        old_d = self.vri("D")
        self.round += 1
        # after the round increment the rotation has happened: vr('A') is
        # the slot for the new A, vr('E') for the new E
        self.asm.add(t1_val, t2_val, self.vr("A"))
        self.asm.add(t1_val, old_d, self.vr("E"))

    def _compute_t1(self, t1: int, ss: int, ss2: int):
        asm = self.asm
        h_add_k = asm.add(Imm(SHA256_K[self.round]), self.vri("H"), t1)
        sigma_1 = self._sha_sigma_1(self.vri("E"), ss, ss2)
        acc = asm.add(h_add_k, sigma_1, t1)
        ch = self._sha_ch(self.vri("E"), self.vri("F"), self.vri("G"),
                          ss, ss2)
        acc = asm.add(acc, ch, t1)
        self._update_w(ss, ss2)
        return asm.add(acc, Reg(self.w(0)), t1)

    def _compute_t2(self, t2: int, ss: int, ss2: int):
        asm = self.asm
        sigma_0 = self._sha_sigma_0(self.vri("A"), t2, ss)
        maj = self._sha_maj(self.vri("A"), self.vri("B"), self.vri("C"),
                            ss, ss2)
        return asm.add(sigma_0, maj, t2)

    def vri(self, c: str):
        """Reg or Imm view of working variable c (early rounds read
        constants before the rotation has produced the value)."""
        if self.initial and self._uncomputed(c):
            shift = ord(c) - ord("A")
            return Imm(SHA256_H0[(shift - self.round) % 8])
        return Reg(self.vr(c))

    def _uncomputed(self, c: str) -> bool:
        r = self.round
        return (r == 0
                or (r == 1 and c not in "AE")
                or (r == 2 and c not in "ABEF")
                or (r == 3 and c not in "ABCEFG"))

    def vr(self, c: str) -> int:
        assert "A" <= c <= "H"
        if not self.initial and self._uncomputed(c):
            return self.iv[(ord(c) - ord("A") - self.round) % 8]
        shift = ord(c) - ord("A")
        return self.state[(-self.round + shift) % 8]

    def w(self, shift: int) -> int:
        return self.message[(self.round + shift) % 16]

    def _update_w(self, ss: int, ss2: int) -> None:
        """W[t] = sigma1(W[t-2]) + W[t-7] + sigma0(W[t-15]) + W[t-16]."""
        if self.round < 16:
            return
        asm = self.asm
        self._sha_word_sigma(self.w(-15), ss, ss2, 7, 18, 3)
        asm.add(Reg(self.w(-16)), Reg(ss), self.w(-16))
        asm.add(Reg(self.w(-7)), Reg(self.w(-16)), self.w(-16))
        self._sha_word_sigma(self.w(-2), ss, ss2, 17, 19, 10)
        asm.add(Reg(self.w(-16)), Reg(ss), self.w(-16))

    def _sha_ch(self, e, f, g, rd: int, ss: int):
        """Ch(E,F,G) = (E & F) ^ (~E & G) -- ANDN collapses the second
        term to one row when E, G are registers."""
        asm = self.asm
        e_and_f = asm.and_(e, f, ss)
        if e[0] == REG and g[0] == REG:
            neg_e_and_g = asm.andn(g, e, rd)
            return asm.xor(e_and_f, neg_e_and_g, rd)
        neg_e = asm.xor(e, Imm(M32), rd)
        neg_e_and_g = asm.and_(neg_e, g, rd)
        return asm.xor(e_and_f, neg_e_and_g, rd)

    def _sha_maj(self, a, b, c, rd: int, ss: int):
        asm = self.asm
        b_and_c = asm.and_(b, c, ss)
        b_xor_c = asm.xor(b, c, rd)
        a_and = asm.and_(a, b_xor_c, rd)
        return asm.xor(b_and_c, a_and, rd)

    def _sha_sigma_0(self, x, rd: int, ss: int):
        asm = self.asm
        rx = asm.rotri_xor_rotri32(x, 2, 13, rd, ss)
        r22 = asm.rotri32(x, 22, ss)
        return asm.xor(rx, r22, rd)

    def _sha_sigma_1(self, x, rd: int, ss: int):
        asm = self.asm
        rx = asm.rotri_xor_rotri32(x, 6, 11, rd, ss)
        r25 = asm.rotri32(x, 25, ss)
        return asm.xor(rx, r25, rd)

    def _sha_word_sigma(self, w: int, rd: int, ss: int,
                        r1: int, r2: int, sh: int) -> None:
        """sigma(x) = ROTR^r1 ^ ROTR^r2 ^ SHR^sh into rd."""
        asm = self.asm
        asm.rotri_xor_rotri32(Reg(w), r1, r2, rd, ss)
        asm.srli32(Reg(w), sh, ss)
        asm.xor(Reg(rd), Reg(ss), rd)


def _expand_sha256(b, d, initial: bool) -> None:
    asm = InlineAsm(b)
    _Sha256Builder(asm, d.rs1, d.rs2, initial).build()


# ---------------------------------------------------------------------------
# Keccak-f[1600] permutation (jolt-inlines/keccak256/src/sequence_builder.rs)
# ---------------------------------------------------------------------------

KECCAK256_SEL = (INLINE_OPCODE, 0x00, 0x01)

KECCAK_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808a,
    0x8000000080008000, 0x000000000000808b, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008a,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000a,
    0x000000008000808b, 0x800000000000008b, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800a, 0x800000008000000a, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# ROTATION_OFFSETS[x][y] of the rho step
KECCAK_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


class _KeccakBuilder:
    """One Keccak-f[1600] permutation of the 25-lane state at (rs1):
    theta -> rho+pi -> chi -> iota x24, in-register (66 virtual regs)."""

    def __init__(self, asm: InlineAsm, rs1: int):
        self.asm = asm
        self.rs1 = rs1
        self.vr = [asm.tmp() for _ in range(66)]

    def lane(self, x: int, y: int) -> int:
        return self.vr[5 * y + x]

    def build(self) -> None:
        asm = self.asm
        for i in range(25):
            asm.b.emit("LD", rd=self.vr[i], rs1=self.rs1, imm=8 * i)
        for rnd in range(24):
            self._theta()
            self._rho_pi()
            self._chi()
            asm.xor(Reg(self.lane(0, 0)), Imm(KECCAK_RC[rnd]),
                    self.lane(0, 0))
        for i in range(25):
            asm.b.emit("SD", rs1=self.rs1, rs2=self.vr[i], imm=8 * i)

    def _rotl64(self, src, amount: int, rd: int):
        return self.asm.rotri64(src, (64 - amount) % 64, rd)

    def _theta(self) -> None:
        asm = self.asm
        C = self.vr[50:55]
        D = self.vr[55:60]
        scratch = self.vr[65]
        for x in range(5):
            asm.xor(Reg(self.lane(x, 0)), Reg(self.lane(x, 1)), C[x])
            for y in range(2, 5):
                asm.xor(Reg(C[x]), Reg(self.lane(x, y)), C[x])
        for x in range(5):
            self._rotl64(Reg(C[(x + 1) % 5]), 1, scratch)
            asm.xor(Reg(C[(x + 4) % 5]), Reg(scratch), D[x])
        for x in range(5):
            for y in range(5):
                a = self.lane(x, y)
                asm.xor(Reg(a), Reg(D[x]), a)

    def _rho_pi(self) -> None:
        # B[y, 2x+3y] = ROTL(A[x,y], offset); B lives in vr[25..50]
        for x in range(5):
            for y in range(5):
                nx, ny = y, (2 * x + 3 * y) % 5
                dest = self.vr[25 + 5 * ny + nx]
                self._rotl64(Reg(self.lane(x, y)), KECCAK_ROT[x][y], dest)

    def _chi(self) -> None:
        # A[x,y] = B[x,y] ^ (~B[x+1,y] & B[x+2,y])
        asm = self.asm
        scratch = self.vr[65]
        for y in range(5):
            for x in range(5):
                cur = 25 + 5 * y + x
                nxt = 25 + 5 * y + (x + 1) % 5
                nxt2 = 25 + 5 * y + (x + 2) % 5
                asm.andn(Reg(self.vr[nxt2]), Reg(self.vr[nxt]), scratch)
                asm.xor(Reg(self.vr[cur]), Reg(scratch), self.lane(x, y))


def _expand_keccak(b, d) -> None:
    _KeccakBuilder(InlineAsm(b), d.rs1).build()


# ---------------------------------------------------------------------------
# Blake2b compression F (jolt-inlines/blake2/src/sequence_builder.rs)
# ---------------------------------------------------------------------------

BLAKE2B_SEL = (INLINE_OPCODE, 0x00, 0x02)   # jolt-inlines/blake2/src/lib.rs

# RFC 7693 IV / sigma schedule
BLAKE2B_IV = [
    0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b,
    0xa54ff53a5f1d36f1, 0x510e527fade682d1, 0x9b05688c2b3e6c1f,
    0x1f83d9abfb41bd6b, 0x5be0cd19137e2179,
]
BLAKE2B_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
]


class _Blake2bBuilder:
    """One Blake2b compression F(h, m, t, f).

    Memory ABI (jolt-inlines/blake2: `execute_blake2b_compression` over
    `message_words[18]`): state h = 8 u64 at (rs1), message block at
    (rs2): m[0..15], then the byte counter t at +128 and the final-block
    flag f IN {0, 1} at +136.  Output h' overwrites (rs1).

    The working vector v[8..15] starts as the RFC 7693 IV constants --
    Imm values under the builder's fold discipline, so the first G
    applications burn no rows materializing them."""

    def __init__(self, asm: InlineAsm, rs1: int, rs2: int):
        self.asm = asm
        self.rs1 = rs1
        self.rs2 = rs2

    def _g(self, v, vreg, a, b, c, d, mx, my) -> None:
        asm = self.asm
        v[a] = asm.add(asm.add(v[a], v[b], vreg[a]), Reg(mx), vreg[a])
        v[d] = asm.rotri64(asm.xor(v[d], v[a], vreg[d]), 32, vreg[d])
        v[c] = asm.add(v[c], v[d], vreg[c])
        v[b] = asm.rotri64(asm.xor(v[b], v[c], vreg[b]), 24, vreg[b])
        v[a] = asm.add(asm.add(v[a], v[b], vreg[a]), Reg(my), vreg[a])
        v[d] = asm.rotri64(asm.xor(v[d], v[a], vreg[d]), 16, vreg[d])
        v[c] = asm.add(v[c], v[d], vreg[c])
        v[b] = asm.rotri64(asm.xor(v[b], v[c], vreg[b]), 63, vreg[b])

    def build(self) -> None:
        asm = self.asm
        h = [asm.tmp() for _ in range(8)]
        m = [asm.tmp() for _ in range(16)]
        vreg = [asm.tmp() for _ in range(16)]
        s1, s2 = asm.tmp(), asm.tmp()
        for i in range(8):
            asm.b.emit("LD", rd=h[i], rs1=self.rs1, imm=8 * i)
        for i in range(16):
            asm.b.emit("LD", rd=m[i], rs1=self.rs2, imm=8 * i)
        t = asm.tmp()
        f = asm.tmp()
        asm.b.emit("LD", rd=t, rs1=self.rs2, imm=128)
        asm.b.emit("LD", rd=f, rs1=self.rs2, imm=136)
        v = ([Reg(h[i]) for i in range(8)]
             + [Imm(BLAKE2B_IV[i]) for i in range(8)])
        v[12] = asm.xor(v[12], Reg(t), vreg[12])
        # f in {0,1}: mask = 0 - f (all-ones when final); v14 ^= mask
        asm.b.emit("SUB", rd=s1, rs1=0, rs2=f)
        v[14] = asm.xor(v[14], Reg(s1), vreg[14])
        for rnd in range(12):
            s = BLAKE2B_SIGMA[rnd]
            self._g(v, vreg, 0, 4, 8, 12, m[s[0]], m[s[1]])
            self._g(v, vreg, 1, 5, 9, 13, m[s[2]], m[s[3]])
            self._g(v, vreg, 2, 6, 10, 14, m[s[4]], m[s[5]])
            self._g(v, vreg, 3, 7, 11, 15, m[s[6]], m[s[7]])
            self._g(v, vreg, 0, 5, 10, 15, m[s[8]], m[s[9]])
            self._g(v, vreg, 1, 6, 11, 12, m[s[10]], m[s[11]])
            self._g(v, vreg, 2, 7, 8, 13, m[s[12]], m[s[13]])
            self._g(v, vreg, 3, 4, 9, 14, m[s[14]], m[s[15]])
        for i in range(8):
            x = asm.xor(v[i], v[i + 8], s1)
            out = asm.xor(Reg(h[i]), x, s2)
            asm.b.emit("SD", rs1=self.rs1, rs2=out[1], imm=8 * i)


def _expand_blake2b(b, d) -> None:
    _Blake2bBuilder(InlineAsm(b), d.rs1, d.rs2).build()


# registry: (opcode, funct3, funct7) -> expansion fn(builder, decoded)
INLINE_REGISTRY: Dict[Tuple[int, int, int], object] = {
    SHA256_SEL: lambda b, d: _expand_sha256(b, d, initial=False),
    SHA256_INIT_SEL: lambda b, d: _expand_sha256(b, d, initial=True),
    KECCAK256_SEL: lambda b, d: _expand_keccak(b, d),
    BLAKE2B_SEL: lambda b, d: _expand_blake2b(b, d),
}


def expand_inline(b, d) -> None:
    """Expand one decoded INLINE instruction into b (program.py hook)."""
    sel = selector_from_imm(d.imm)
    fn = INLINE_REGISTRY.get(sel)
    if fn is None:
        raise ValueError(
            f"unregistered inline opcode={sel[0]:#x} funct3={sel[1]} "
            f"funct7={sel[2]}")
    fn(b, d)
