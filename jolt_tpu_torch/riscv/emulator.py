"""RV64IM emulator producing the Jolt execution trace.

Host-side analog of the reference tracer
(`reference tracer/src/emulator/cpu.rs` fetch-decode-execute loop,
`tracer/src/instruction/mod.rs:424-445` RISCVCycle capture): each executed
instruction records pre/post register state and the RAM access into a
structure-of-arrays trace (see `tracer/trace.py`).

Memory-mapped I/O follows `common/src/jolt_device.rs`: the region below
RAM_START_ADDRESS holds advice/input/output/panic/termination words; writing
a nonzero byte to the termination address halts execution; writing to the
panic address sets the panic output bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from . import isa
from .isa import KIND_ID

RAM_START_ADDRESS = 0x80000000
DEFAULT_MAX_INPUT = 4096
DEFAULT_MAX_OUTPUT = 4096
DEFAULT_STACK = 4096
DEFAULT_HEAP = 1024 * 1024 * 32

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1


def _tz64(v: int) -> int:
    """Trailing zeros of a u64 (u64::trailing_zeros: 64 for v == 0)."""
    return (v & -v).bit_length() - 1 if v else 64


def _s64(x: int) -> int:
    x &= _M64
    return x - (1 << 64) if x >> 63 else x


def _s32(x: int) -> int:
    x &= _M32
    return x - (1 << 32) if x >> 31 else x


def _sext32(x: int) -> int:
    return _s32(x) & _M64


@dataclasses.dataclass
class MemoryLayout:
    """Mirror of `common/src/jolt_device.rs:230` MemoryLayout::new.

    Advice regions (trusted/untrusted, `jolt_device.rs:354-388`): placed
    immediately below the input region, larger region first, each a
    power-of-two byte size.  `witness_base` is chosen so each advice
    region occupies a SIZE-ALIGNED subcube of the remapped RAM address
    space k = (addr - witness_base)/8 + 1 (our k=0 is the no-access
    dummy, so the base backs off by 2^a_max - 1 dead dwords); the
    RamValCheck init then splits as public + selector * advice-MLE
    openings (`zkvm/ram/mod.rs compute_advice_selector`)."""
    max_input_size: int = DEFAULT_MAX_INPUT
    max_output_size: int = DEFAULT_MAX_OUTPUT
    stack_size: int = DEFAULT_STACK
    heap_size: int = DEFAULT_HEAP
    max_trusted_advice_size: int = 0
    max_untrusted_advice_size: int = 0

    def __post_init__(self):
        def align8(v):
            return (v + 7) // 8 * 8
        for sz in (self.max_trusted_advice_size,
                   self.max_untrusted_advice_size):
            assert sz == 0 or (sz >= 8 and sz & (sz - 1) == 0), \
                f"advice size must be 0 or a power of two >= 8: {sz}"
        inp = align8(self.max_input_size)
        out = align8(self.max_output_size)
        io_bytes = inp + out + 16
        io_words = 1
        while io_words < (io_bytes + 7) // 8:
            io_words *= 2
        io_bytes = io_words * 8
        self.input_start = RAM_START_ADDRESS - io_bytes
        self.input_end = self.input_start + inp
        self.output_start = self.input_end
        self.output_end = self.output_start + out
        self.panic = self.output_end
        self.termination = self.panic + 8
        self.io_end = self.termination + 8
        # advice regions below the input region, larger first
        ta, ua = self.max_trusted_advice_size, self.max_untrusted_advice_size
        adv_lo = self.input_start - ta - ua
        if ta >= ua:
            self.trusted_advice_start = adv_lo
            self.trusted_advice_end = adv_lo + ta
            self.untrusted_advice_start = self.trusted_advice_end
            self.untrusted_advice_end = self.untrusted_advice_start + ua
        else:
            self.untrusted_advice_start = adv_lo
            self.untrusted_advice_end = adv_lo + ua
            self.trusted_advice_start = self.untrusted_advice_end
            self.trusted_advice_end = self.trusted_advice_start + ta
        if ta or ua:
            a_max = max(ta, ua) // 8      # dwords, power of two
            self.witness_base = adv_lo - 8 * (a_max - 1)
        else:
            self.witness_base = self.input_start

    def advice_region(self, kind: str):
        """(start_addr, size_bytes) of an advice region ('trusted' /
        'untrusted'); size 0 when absent."""
        if kind == "trusted":
            return self.trusted_advice_start, self.max_trusted_advice_size
        if kind == "untrusted":
            return (self.untrusted_advice_start,
                    self.max_untrusted_advice_size)
        raise ValueError(kind)


class JoltDevice:
    """Inputs/outputs/panic/termination as a memory-mapped peripheral
    (`common/src/jolt_device.rs:49-56`).  The contents are the public
    statement of the proof."""

    def __init__(self, layout: MemoryLayout, inputs: bytes = b"",
                 trusted_advice: bytes = b"", untrusted_advice: bytes = b""):
        assert len(inputs) <= layout.max_input_size
        assert len(trusted_advice) <= layout.max_trusted_advice_size
        assert len(untrusted_advice) <= layout.max_untrusted_advice_size
        self.layout = layout
        self.inputs = inputs
        self.trusted_advice = trusted_advice
        self.untrusted_advice = untrusted_advice
        self.outputs = bytearray()
        self.panic = False
        self.terminated = False
        # guest intrinsics (VirtualHostIO): print output + cycle-tracking
        # marker events (label, event 1=start/2=end, cycle index)
        self.console = bytearray()
        self.cycle_markers: List[tuple] = []

    def cycle_spans(self) -> Dict[str, dict]:
        """Aggregate start/end cycle-tracking markers into per-label span
        stats (`jolt-platform/src/cycle_tracking.rs` semantics: nested /
        repeated spans sum)."""
        open_at: Dict[str, List[int]] = {}
        spans: Dict[str, dict] = {}
        for label, event, cycle in self.cycle_markers:
            if event == 1:
                open_at.setdefault(label, []).append(cycle)
            elif event == 2 and open_at.get(label):
                start = open_at[label].pop()
                s = spans.setdefault(label, {"cycles": 0, "count": 0})
                s["cycles"] += cycle - start
                s["count"] += 1
        return spans

    def load(self, addr: int) -> int:
        l = self.layout
        if addr == l.panic:
            return 1 if self.panic else 0
        if l.panic <= addr < l.termination:
            return 0
        if addr == l.termination or (l.termination <= addr < l.io_end):
            return 0
        if l.input_start <= addr < l.input_end:
            off = addr - l.input_start
            return self.inputs[off] if off < len(self.inputs) else 0
        if l.output_start <= addr < l.output_end:
            off = addr - l.output_start
            return self.outputs[off] if off < len(self.outputs) else 0
        if l.trusted_advice_start <= addr < l.trusted_advice_end:
            off = addr - l.trusted_advice_start
            return (self.trusted_advice[off]
                    if off < len(self.trusted_advice) else 0)
        if l.untrusted_advice_start <= addr < l.untrusted_advice_end:
            off = addr - l.untrusted_advice_start
            return (self.untrusted_advice[off]
                    if off < len(self.untrusted_advice) else 0)
        return 0

    def store(self, addr: int, value: int) -> None:
        l = self.layout
        if addr == l.panic:
            self.panic = True
            return
        if addr == l.termination:
            self.terminated = True
            return
        if l.output_start <= addr < l.output_end:
            off = addr - l.output_start
            if len(self.outputs) <= off:
                self.outputs.extend(b"\x00" * (off + 1 - len(self.outputs)))
            self.outputs[off] = value & 0xFF


class Emulator:
    """Single-hart RV64IM machine with Jolt trace capture."""

    # 32 architectural + 96 virtual registers (common/src/constants.rs:2-5);
    # virtual regs are used by virtual sequences and by the rd=x0 jump rewrite.
    NUM_REGS = 128

    def __init__(self, device: JoltDevice, entry: int = RAM_START_ADDRESS):
        self.pc = entry
        self.regs: List[int] = [0] * self.NUM_REGS
        self.pages: Dict[int, bytearray] = {}
        self.device = device
        self.decode_cache: Dict[int, isa.Decoded] = {}
        self.trace: Optional[List] = None  # rows appended by step()
        self.instret = 0

    # ---- memory --------------------------------------------------------

    def _page(self, addr: int) -> bytearray:
        pg = addr >> 12
        page = self.pages.get(pg)
        if page is None:
            page = bytearray(4096)
            self.pages[pg] = page
        return page

    def load_bytes(self, addr: int, data: bytes) -> None:
        for i, b in enumerate(data):
            a = addr + i
            self._page(a)[a & 0xFFF] = b

    def read_u8(self, addr: int) -> int:
        if addr < RAM_START_ADDRESS:
            return self.device.load(addr)
        return self._page(addr)[addr & 0xFFF]

    def write_u8(self, addr: int, value: int) -> None:
        if addr < RAM_START_ADDRESS:
            self.device.store(addr, value)
            return
        self._page(addr)[addr & 0xFFF] = value & 0xFF

    def read_mem(self, addr: int, size: int) -> int:
        out = 0
        for i in range(size):
            out |= self.read_u8(addr + i) << (8 * i)
        return out

    def write_mem(self, addr: int, value: int, size: int) -> None:
        for i in range(size):
            self.write_u8(addr + i, (value >> (8 * i)) & 0xFF)

    # ---- aligned-dword RAM view (the witness address space) -------------

    def read_dword(self, addr8: int) -> int:
        """Read an aligned 8-byte word -- the RAM value as the Twist memory
        argument sees it (one witness cell per 8-byte word)."""
        return self.read_mem(addr8, 8)

    # ---- guest intrinsics (VirtualHostIO) -------------------------------

    JOLT_PRINT_CALL_ID = 0x505249        # "PRI" (jolt-platform print.rs)
    JOLT_CYCLE_TRACK_CALL_ID = 0xC7C1E   # "CYCLE" (cycle_tracking.rs)

    def _hostio(self) -> None:
        """VirtualHostIO dispatch (virtual_host_io.rs exec): call id in
        x10, buffer ptr/len in x11/x12, event in x13.  Pure host-side side
        effects -- the trace row is a no-op."""
        call = self.regs[10] & _M32
        ptr = self.regs[11]
        # guest-controlled length: cap per-call payloads (matches the
        # native tracer) so a hostile guest can't force 4 GiB of host work
        ln = min(self.regs[12] & _M32, 65536)
        event = self.regs[13] & _M32
        if call == self.JOLT_PRINT_CALL_ID:
            data = bytes(self.read_u8(ptr + i) for i in range(ln))
            self.device.console += data
            if event == 2:                       # JOLT_PRINT_LINE
                self.device.console += b"\n"
        elif call == self.JOLT_CYCLE_TRACK_CALL_ID:
            label = bytes(self.read_u8(ptr + i)
                          for i in range(ln)).decode("utf-8", "replace")
            self.device.cycle_markers.append(
                (label, int(event), self.instret))

    # ---- execution -----------------------------------------------------

    def fetch(self) -> isa.Decoded:
        lo = self.read_mem(self.pc, 2)
        hi = self.read_mem(self.pc + 2, 2) if lo & 3 == 3 else 0
        word = lo | (hi << 16)
        dec = self.decode_cache.get(word)
        if dec is None:
            dec = isa.decode_any(lo, hi)
            self.decode_cache[word] = dec
        return dec

    def step(self) -> None:
        pc = self.pc
        dec = self.fetch()
        kind = dec.kind
        regs = self.regs
        rs1_val = regs[dec.rs1]
        rs2_val = regs[dec.rs2]
        imm = dec.imm
        rd = dec.rd
        # Jumps writing x0 are remapped to a virtual register so the R1CS
        # constraint RdWriteValue == UnexpandedPC + 4 stays satisfiable
        # (reference: trace rewriting, zkvm/r1cs/constraints.rs:332-335).
        if rd == 0 and kind in ("JAL", "JALR"):
            rd = 32
        rd_pre = regs[rd]
        next_pc = pc + dec.length
        rd_post = rd_pre
        ram_addr = 0
        ram_pre = 0
        ram_post = 0

        if kind == "LUI":
            rd_post = imm & _M64
        elif kind == "AUIPC":
            rd_post = (pc + imm) & _M64
        elif kind == "JAL":
            rd_post = next_pc
            next_pc = (pc + imm) & _M64
            if next_pc == pc:
                self.device.terminated = True  # jump-to-self halt heuristic
        elif kind == "JALR":
            rd_post = next_pc
            next_pc = (rs1_val + imm) & _M64 & ~1
            if next_pc == pc:
                self.device.terminated = True
        elif kind in ("BEQ", "BNE", "BLT", "BGE", "BLTU", "BGEU"):
            a, b = rs1_val, rs2_val
            sa, sb = _s64(a), _s64(b)
            taken = {
                "BEQ": a == b, "BNE": a != b, "BLT": sa < sb,
                "BGE": sa >= sb, "BLTU": a < b, "BGEU": a >= b,
            }[kind]
            if taken:
                next_pc = (pc + imm) & _M64
        elif kind in ("LB", "LH", "LW", "LD", "LBU", "LHU", "LWU"):
            size = {"LB": 1, "LBU": 1, "LH": 2, "LHU": 2,
                    "LW": 4, "LWU": 4, "LD": 8}[kind]
            addr = (rs1_val + imm) & _M64
            raw = self.read_mem(addr, size)
            if kind in ("LB", "LH", "LW"):
                raw = {1: lambda v: v - (1 << 8) if v >> 7 else v,
                       2: lambda v: v - (1 << 16) if v >> 15 else v,
                       4: lambda v: v - (1 << 32) if v >> 31 else v}[size](raw) & _M64
            rd_post = raw
            ram_addr = addr & ~7
            ram_pre = ram_post = self.read_dword(ram_addr)
        elif kind in ("SB", "SH", "SW", "SD"):
            size = {"SB": 1, "SH": 2, "SW": 4, "SD": 8}[kind]
            addr = (rs1_val + imm) & _M64
            ram_addr = addr & ~7
            ram_pre = self.read_dword(ram_addr)
            # The witness records the WRITE view (pre-dword with the stored
            # bytes patched in), which for MMIO stores (outputs/termination)
            # can differ from a device read-back.
            off = addr - ram_addr
            mask = ((1 << (8 * size)) - 1) << (8 * off)
            ram_post = (ram_pre & ~mask) | ((rs2_val << (8 * off)) & mask)
            self.write_mem(addr, rs2_val, size)
        elif kind in ("ADDI", "SLTI", "SLTIU", "XORI", "ORI", "ANDI",
                      "SLLI", "SRLI", "SRAI", "ADDIW", "SLLIW", "SRLIW", "SRAIW"):
            rd_post = self._alu_imm(kind, rs1_val, imm)
        elif kind in ("ADD", "SUB", "SLL", "SLT", "SLTU", "XOR", "SRL", "SRA",
                      "OR", "AND", "ANDN",
                      "ADDW", "SUBW", "SLLW", "SRLW", "SRAW",
                      "MUL", "MULH", "MULHSU", "MULHU", "DIV", "DIVU", "REM",
                      "REMU", "MULW", "DIVW", "DIVUW", "REMW", "REMUW"):
            rd_post = self._alu_reg(kind, rs1_val, rs2_val)
        elif kind == "HOSTIO":
            self._hostio()   # trace-time intrinsics; architectural no-op
        elif kind in ("FENCE", "ECALL", "EBREAK"):
            pass  # no-ops at the architectural level used here
        elif kind in ("LRW", "LRD"):
            size = 4 if kind[-1] == "W" else 8
            addr = rs1_val
            if addr % size:
                raise RuntimeError(f"misaligned {kind} {addr:#x}")
            raw = self.read_mem(addr, size)
            rd_post = _sext32(raw) if size == 4 else raw
            self.reservation = addr
            ram_addr = addr & ~7
            ram_pre = ram_post = self.read_dword(ram_addr)
        elif kind in ("SCW", "SCD"):
            size = 4 if kind[-1] == "W" else 8
            addr = rs1_val
            if addr % size:
                raise RuntimeError(f"misaligned {kind} {addr:#x}")
            success = getattr(self, "reservation", None) == addr
            self.reservation = None
            ram_addr = addr & ~7
            ram_pre = self.read_dword(ram_addr)
            if success:
                off = addr - ram_addr
                mask = ((1 << (8 * size)) - 1) << (8 * off)
                ram_post = (ram_pre & ~mask) | ((rs2_val << (8 * off)) & mask)
                self.write_mem(addr, rs2_val, size)
            else:
                ram_post = ram_pre
            rd_post = 0 if success else 1
        elif kind.startswith("AMO"):
            size = 4 if kind[-1] == "W" else 8
            op = kind[3:-1]
            addr = rs1_val
            if addr % size:
                raise RuntimeError(f"misaligned {kind} {addr:#x}")
            raw = self.read_mem(addr, size)
            old = _sext32(raw) if size == 4 else raw
            b = rs2_val
            if op == "SWAP":
                new = b
            elif op == "ADD":
                new = old + b
            elif op == "XOR":
                new = old ^ b
            elif op == "AND":
                new = old & b
            elif op == "OR":
                new = old | b
            else:   # MIN/MAX/MINU/MAXU on width-extended values
                if size == 4:
                    bo = b & _M32 if "U" in op else _sext32(b)
                    ao = raw & _M32 if "U" in op else old
                else:
                    ao, bo = old, b
                if "U" in op:
                    take_a = ao < bo if op.startswith("MIN") else ao > bo
                else:
                    take_a = (_s64(ao) < _s64(bo) if op.startswith("MIN")
                              else _s64(ao) > _s64(bo))
                new = ao if take_a else bo
            ram_addr = addr & ~7
            ram_pre = self.read_dword(ram_addr)
            off = addr - ram_addr
            mask = ((1 << (8 * size)) - 1) << (8 * off)
            ram_post = (ram_pre & ~mask) | (((new & _M64) << (8 * off)) & mask)
            self.write_mem(addr, new & _M64, size)
            rd_post = old
        else:  # pragma: no cover
            raise isa.DecodeError(f"unhandled kind {kind}")

        has_rd = kind not in ("SB", "SH", "SW", "SD", "BEQ", "BNE", "BLT",
                              "BGE", "BLTU", "BGEU", "FENCE", "ECALL",
                              "EBREAK", "HOSTIO")
        if has_rd and rd != 0:
            regs[rd] = rd_post & _M64
        if rd == 0:
            rd_post = 0
            rd_pre = 0

        if self.trace is not None:
            self.trace.append((
                dec.kind_id, pc, rd if has_rd else 255, dec.rs1, dec.rs2,
                rs1_val, rs2_val, rd_pre, regs[rd] if (has_rd and rd != 0) else 0,
                ram_addr, ram_pre, ram_post, imm, next_pc,
            ))
        self.pc = next_pc
        self.instret += 1

    @staticmethod
    def _alu_imm(kind: str, a: int, imm: int) -> int:
        if kind == "ADDI":
            return (a + imm) & _M64
        if kind == "SLTI":
            return 1 if _s64(a) < imm else 0
        if kind == "SLTIU":
            return 1 if a < (imm & _M64) else 0
        if kind == "XORI":
            return a ^ (imm & _M64)
        if kind == "ORI":
            return a | (imm & _M64)
        if kind == "ANDI":
            return a & (imm & _M64)
        if kind == "SLLI":
            return (a << imm) & _M64
        if kind == "SRLI":
            return a >> imm
        if kind == "SRAI":
            return (_s64(a) >> imm) & _M64
        if kind == "ADDIW":
            return _sext32(a + imm)
        if kind == "SLLIW":
            return _sext32(a << imm)
        if kind == "SRLIW":
            return _sext32((a & _M32) >> imm)
        if kind == "SRAIW":
            return _sext32(_s32(a) >> imm)
        raise AssertionError(kind)

    @staticmethod
    def _alu_reg(kind: str, a: int, b: int) -> int:
        sh6, sh5 = b & 0x3F, b & 0x1F
        if kind == "ADD":
            return (a + b) & _M64
        if kind == "ANDN":   # Zbb: rd = rs1 & ~rs2 (instructions/i/andn.rs)
            return a & (b ^ _M64)
        if kind == "SUB":
            return (a - b) & _M64
        if kind == "SLL":
            return (a << sh6) & _M64
        if kind == "SLT":
            return 1 if _s64(a) < _s64(b) else 0
        if kind == "SLTU":
            return 1 if a < b else 0
        if kind == "XOR":
            return a ^ b
        if kind == "SRL":
            return a >> sh6
        if kind == "SRA":
            return (_s64(a) >> sh6) & _M64
        if kind == "OR":
            return a | b
        if kind == "AND":
            return a & b
        if kind == "ADDW":
            return _sext32(a + b)
        if kind == "SUBW":
            return _sext32(a - b)
        if kind == "SLLW":
            return _sext32(a << sh5)
        if kind == "SRLW":
            return _sext32((a & _M32) >> sh5)
        if kind == "SRAW":
            return _sext32(_s32(a) >> sh5)
        if kind == "MUL":
            return (a * b) & _M64
        if kind == "MULH":
            return (_s64(a) * _s64(b) >> 64) & _M64
        if kind == "MULHSU":
            return (_s64(a) * b >> 64) & _M64
        if kind == "MULHU":
            return (a * b >> 64) & _M64
        if kind == "MULW":
            return _sext32(a * b)
        if kind in ("DIV", "DIVW", "REM", "REMW"):
            w = kind.endswith("W")
            sa = _s32(a) if w else _s64(a)
            sb = _s32(b) if w else _s64(b)
            bits = 32 if w else 64
            if sb == 0:
                q, r = -1, sa
            elif sa == -(1 << (bits - 1)) and sb == -1:
                q, r = sa, 0
            else:
                q = abs(sa) // abs(sb)
                if (sa < 0) != (sb < 0):
                    q = -q
                r = sa - q * sb
            out = q if kind.startswith("DIV") else r
            return _sext32(out) if w else out & _M64
        if kind in ("DIVU", "DIVUW", "REMU", "REMUW"):
            w = kind.endswith("W")
            ua = a & _M32 if w else a
            ub = b & _M32 if w else b
            if ub == 0:
                q = (1 << (32 if w else 64)) - 1
                r = ua
            else:
                q, r = ua // ub, ua % ub
            out = q if kind.startswith("DIVU") else r
            return _sext32(out) if w else out & _M64
        raise AssertionError(kind)

    # ---- run loop ------------------------------------------------------

    def run(self, max_cycles: int = 1 << 24, record_trace: bool = True):
        if record_trace:
            self.trace = []
        while not self.device.terminated:
            if self.instret >= max_cycles:
                raise RuntimeError(f"exceeded max_cycles={max_cycles}")
            self.step()
        return self.trace


class AssertionFailure(RuntimeError):
    """A virtual assert row evaluated to 0 -- the trace is unprovable
    (honest execution never raises; indicates an expansion/advice bug)."""


class RowEmulator(Emulator):
    """Row-stepping machine over the EXPANDED program (riscv/program.py).

    This is the proving tracer: the proving PC is the expanded row index,
    the source byte address is the unexpanded PC, and every executed row is
    a FINAL instruction with a direct lookup table.  Mirrors the reference
    tracer's per-row execution of cached inline sequences
    (`tracer/src/emulator/cpu.rs` + `instruction/mod.rs:174`)."""

    def __init__(self, device: JoltDevice, program):
        super().__init__(device, entry=program.start)
        self.program = program
        self.row_idx = program.addr2row[program.start]
        self.load_bytes(program.entry, program.code)

    def _exec_virtual(self, kind: str, row, rs1_val: int, rs2_val: int) -> int:
        """rd value of a virtual (non-assert) row."""
        from ..lookups.tables import _rsh_fold  # table-exact shift fold
        if kind == "VirtualAdvice":
            op, a, b2 = row.advice
            return advice_value_fn(op, self.regs[a], self.regs[b2])
        if kind == "VirtualMovsign":
            return _M64 if rs1_val >> 63 else 0
        if kind == "VirtualPow2":
            return (1 << (rs1_val & 63)) & _M64
        if kind == "VirtualPow2W":
            return (1 << (rs1_val & 31)) & _M64
        if kind == "VirtualShiftRightBitmask":
            return ((1 << 64) - (1 << (rs1_val & 63))) & _M64
        if kind == "VirtualSignExtendWord":
            return _sext32(rs1_val)
        if kind == "VirtualZeroExtendWord":
            return rs1_val & _M32
        if kind == "VirtualChangeDivisor":
            return (1 if (rs1_val == 1 << 63 and rs2_val == _M64)
                    else rs2_val)
        if kind == "VirtualChangeDivisorW":
            return (1 if (rs1_val == 0xFFFFFFFF80000000 and rs2_val == _M64)
                    else rs2_val)
        if kind == "VirtualSRL":
            return _rsh_fold(rs1_val, rs2_val, 64)
        if kind == "VirtualSRA":
            ext = sum((1 << (63 - p)) for p in range(63)
                      if not (rs2_val >> p) & 1) if rs1_val >> 63 else 0
            return (_rsh_fold(rs1_val, rs2_val, 64) + ext) & _M64
        if kind == "VirtualMULI":
            return (rs1_val * (row.imm & _M64)) & _M64
        # inline-extension rotates (tracer virtual_rotri{,w}.rs,
        # virtual_xor_rot{,w}.rs, virtual_rev8w.rs)
        if kind == "VirtualROTRI":
            sh = _tz64(row.imm & _M64)
            return ((rs1_val >> sh) | (rs1_val << (64 - sh))) & _M64 \
                if sh % 64 else rs1_val
        if kind == "VirtualROTRIW":
            sh = min(_tz64(row.imm & _M64), 32)
            v = rs1_val & _M32
            return ((v >> sh) | (v << (32 - sh))) & _M32 \
                if sh % 32 else v
        if kind == "VirtualRev8W":
            lo = int.from_bytes((rs1_val & _M32).to_bytes(4, "little"), "big")
            hi = int.from_bytes((rs1_val >> 32).to_bytes(4, "little"), "big")
            return lo | (hi << 32)
        if kind.startswith("VirtualXORROTW"):
            r = int(kind[len("VirtualXORROTW"):])
            v = (rs1_val ^ rs2_val) & _M32
            return ((v >> r) | (v << (32 - r))) & _M32
        if kind.startswith("VirtualXORROT"):
            r = int(kind[len("VirtualXORROT"):])
            v = rs1_val ^ rs2_val
            return ((v >> r) | (v << (64 - r))) & _M64
        raise AssertionError(kind)

    @staticmethod
    def _assert_output(kind: str, rs1_val: int, rs2_val: int, imm: int) -> int:
        if kind == "VirtualAssertEQ":
            return int(rs1_val == rs2_val)
        if kind == "VirtualAssertLTE":
            return int(rs1_val <= rs2_val)
        if kind == "VirtualAssertValidDiv0":
            return 1 if rs1_val else int(rs2_val == _M64)
        if kind == "VirtualAssertValidUnsignedRemainder":
            return int(rs2_val == 0 or rs1_val < rs2_val)
        if kind == "VirtualAssertMulUNoOverflow":
            return int(rs1_val * rs2_val <= _M64)
        if kind == "VirtualAssertHalfwordAlignment":
            return int((rs1_val + imm) & 1 == 0)
        if kind == "VirtualAssertWordAlignment":
            return int((rs1_val + imm) & 3 == 0)
        raise AssertionError(kind)

    def step(self) -> None:
        row = self.program.rows[self.row_idx]
        kind = row.kind
        pc = row.address
        regs = self.regs
        rs1_val = regs[row.rs1]
        rs2_val = regs[row.rs2]
        imm = row.imm
        rd = row.rd
        if rd == 0 and kind in ("JAL", "JALR"):
            rd = 32  # x0-jump rewrite (see Emulator.step)
        rd_pre = regs[rd]
        rd_post = rd_pre
        ram_addr = 0
        ram_pre = 0
        ram_post = 0
        # default next: within-sequence rows hold the unexpanded pc
        next_row = self.row_idx + 1
        ilen = row.length                    # 2 for compressed source rows
        next_pc = pc + ilen if row.advances_pc else pc
        taken_target = None

        if kind in ("NOOP", "FENCE", "ECALL", "EBREAK"):
            pass
        elif kind == "HOSTIO":
            self._hostio()   # host-side intrinsics; provable no-op row
        elif kind == "LUI":
            rd_post = imm & _M64
        elif kind == "AUIPC":
            rd_post = (pc + imm) & _M64
        elif kind == "JAL":
            rd_post = (pc + ilen) & _M64
            taken_target = (pc + imm) & _M64
        elif kind == "JALR":
            rd_post = (pc + ilen) & _M64
            taken_target = (rs1_val + imm) & _M64 & ~1
        elif kind in ("BEQ", "BNE", "BLT", "BGE", "BLTU", "BGEU"):
            a, b = rs1_val, rs2_val
            sa, sb = _s64(a), _s64(b)
            taken = {
                "BEQ": a == b, "BNE": a != b, "BLT": sa < sb,
                "BGE": sa >= sb, "BLTU": a < b, "BGEU": a >= b,
            }[kind]
            if taken:
                taken_target = (pc + imm) & _M64
        elif kind == "LD":
            addr = (rs1_val + imm) & _M64
            if addr & 7:
                raise RuntimeError(f"misaligned LD {addr:#x} at pc {pc:#x}")
            rd_post = self.read_mem(addr, 8)
            ram_addr = addr
            ram_pre = ram_post = self.read_dword(ram_addr)
        elif kind == "SD":
            addr = (rs1_val + imm) & _M64
            if addr & 7:
                raise RuntimeError(f"misaligned SD {addr:#x} at pc {pc:#x}")
            ram_addr = addr
            ram_pre = self.read_dword(ram_addr)
            ram_post = rs2_val
            self.write_mem(addr, rs2_val, 8)
        elif kind in ("ADDI", "SLTI", "SLTIU", "XORI", "ORI", "ANDI",
                      "SLLI", "SRLI", "SRAI"):
            rd_post = self._alu_imm(kind, rs1_val, imm)
        elif kind in ("ADD", "SUB", "SLT", "SLTU", "XOR", "OR", "AND",
                      "ANDN", "MUL", "MULHU"):
            rd_post = self._alu_reg(kind, rs1_val, rs2_val)
        elif kind.startswith("VirtualAssert"):
            if self._assert_output(kind, rs1_val, rs2_val, imm) != 1:
                raise AssertionFailure(
                    f"{kind} failed at pc {pc:#x} row {self.row_idx} "
                    f"(rs1={rs1_val:#x} rs2={rs2_val:#x})")
        elif kind.startswith("Virtual"):
            rd_post = self._exec_virtual(kind, row, rs1_val, rs2_val)
        else:  # pragma: no cover
            raise isa.DecodeError(f"unhandled final kind {kind}")

        if taken_target is not None:
            next_pc = taken_target
            next_row = self.program.addr2row.get(taken_target)
            if next_row is None:
                raise RuntimeError(
                    f"jump/branch to unmapped address {taken_target:#x}")
            # reference termination heuristic (tracer/src/lib.rs:331): a
            # jump-to-self ends the trace (its row is the final cycle,
            # whose Jump flag disables the next-pc constraints)
            if kind in ("JAL", "JALR") and taken_target == pc:
                self.device.terminated = True

        has_rd = (kind not in ("SD", "BEQ", "BNE", "BLT", "BGE", "BLTU",
                               "BGEU", "FENCE", "ECALL", "EBREAK", "NOOP",
                               "HOSTIO")
                  and not kind.startswith("VirtualAssert"))
        if has_rd and rd != 0:
            regs[rd] = rd_post & _M64
        if rd == 0:
            rd_post = 0
            rd_pre = 0

        if self.trace is not None:
            self.trace.append((
                isa.KIND_ID[kind], pc, rd if has_rd else 255, row.rs1,
                row.rs2, rs1_val, rs2_val, rd_pre,
                regs[rd] if (has_rd and rd != 0) else 0,
                ram_addr, ram_pre, ram_post, imm & _M64, next_pc,
                self.row_idx, next_row,
            ))
        self.row_idx = next_row
        self.pc = next_pc
        self.instret += 1


# late import seam so program.py can be imported standalone
from .program import advice_value as advice_value_fn  # noqa: E402
