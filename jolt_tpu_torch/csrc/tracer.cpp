// Native row tracer: the production witness producer.
//
// C++ twin of jolt_tpu_torch/riscv/emulator.py:RowEmulator (same architectural
// semantics, same SoA trace row schema), playing the role of the
// reference's Rust tracer (reference tracer/) as the host-side
// execution layer.  Python performs the static bytecode expansion
// (riscv/program.py) and hands the FINAL row table to this tracer; both
// sides therefore execute the identical expanded program.  Mode-equivalence
// gate: traces must be bit-identical to the Python row emulator
// (tests/test_native_tracer.py), mirroring the reference's
// parallel-vs-serial tracer paranoia checks (tracer/src/parallel.rs).
//
// Build: g++ -O3 -shared -fPIC -o libjolt_tracer.so tracer.cpp

#include <cstdint>
#include <cstring>
#include <atomic>
#include <thread>
#include <unordered_map>
#include <vector>
#include <memory>

typedef uint64_t u64;
typedef int64_t i64;
typedef uint32_t u32;
typedef int32_t i32;
typedef uint16_t u16;
typedef uint8_t u8;
typedef int8_t i8;

namespace {

constexpr u64 RAM_START = 0x80000000ull;

// Instruction kinds -- MUST match jolt_tpu_torch/riscv/isa.py KINDS order.
enum Kind : u16 {
  NOOP = 0,
  LUI, AUIPC, JAL, JALR,
  BEQ, BNE, BLT, BGE, BLTU, BGEU,
  LB, LH, LW, LD_, LBU, LHU, LWU,
  SB, SH, SW, SD_,
  ADDI, SLTI, SLTIU, XORI, ORI, ANDI, SLLI, SRLI, SRAI,
  ADD, SUB, SLL, SLT, SLTU, XOR_, SRL, SRA, OR_, AND_,
  ADDIW, SLLIW, SRLIW, SRAIW,
  ADDW, SUBW, SLLW, SRLW, SRAW,
  FENCE, ECALL, EBREAK,
  MUL, MULH, MULHSU, MULHU, DIV, DIVU, REM, REMU,
  MULW, DIVW, DIVUW, REMW, REMUW,
  // virtual (final) instructions -- isa.py order continues here
  V_ADVICE, V_MOVSIGN, V_POW2, V_POW2W,
  V_SHIFT_BITMASK, V_SEXT_W, V_ZEXT_W, V_CHANGE_DIV, V_CHANGE_DIVW,
  V_SRL, V_SRA, V_MULI,
  VA_EQ, VA_LTE, VA_VALID_DIV0, VA_VALID_UREM, VA_MULU_NO_OVF,
  VA_HALF_ALIGN, VA_WORD_ALIGN,
  // RV64A source-only kinds (always expanded; never reach a final row --
  // present only to keep numeric ids aligned with isa.py)
  LRW_, LRD_, SCW_, SCD_,
  AMOSWAPW_, AMOSWAPD_, AMOADDW_, AMOADDD_, AMOXORW_, AMOXORD_,
  AMOANDW_, AMOANDD_, AMOORW_, AMOORD_,
  AMOMINW_, AMOMIND_, AMOMAXW_, AMOMAXD_,
  AMOMINUW_, AMOMINUD_, AMOMAXUW_, AMOMAXUD_,
  // inline-extension kinds (jolt-inlines; final provable rows)
  ANDN_, V_ROTRI, V_ROTRIW, V_REV8W,
  V_XORROT16, V_XORROT24, V_XORROT32, V_XORROT63,
  V_XORROTW7, V_XORROTW8, V_XORROTW12, V_XORROTW16,
  INLINE_,  // source-only custom opcode
  // VirtualHostIO (print / cycle-tracking intrinsics; provable no-op row)
  HOSTIO_,
  KIND_COUNT
};

// advice ops -- MUST match jolt_tpu_torch/riscv/program.py ADVICE_OPS order.
enum AdviceOp : i8 {
  ADV_NONE = -1,
  ADV_DIVU_Q = 0, ADV_DIV_Q, ADV_DIV_R_ABS,
  ADV_DIVUW_Q, ADV_DIVW_Q, ADV_DIVW_R_ABS,
};

#pragma pack(push, 1)
// one expanded bytecode row, serialized by jolt_tpu_torch/tracer/native.py
struct ProgRow {
  u16 kind;
  u8 rd, rs1, rs2;
  u8 flags;        // 1 = virtual, 2 = first, 4 = last
  i8 advice_op;    // -1 = none
  u8 advice_rs1, advice_rs2;
  u8 _pad[3];
  i64 imm;
  u64 address;     // unexpanded source pc
};

struct TraceRow {
  u16 kind;
  u8 rd, rs1, rs2;      // rd = 255 when no destination
  u8 _pad[3];
  u64 pc;
  u64 rs1_val, rs2_val, rd_pre, rd_post;
  u64 ram_addr, ram_pre, ram_post;
  i64 imm;
  u64 next_pc;
  u64 pc_idx, next_pc_idx;
};
#pragma pack(pop)

static inline i64 sext(u64 v, int bits) {
  return (i64)(v << (64 - bits)) >> (64 - bits);
}

struct Layout {
  u64 input_start, input_end, output_start, output_end, panic, termination, io_end;
  u64 tadv_start, tadv_end, uadv_start, uadv_end;
};

struct Machine {
  u64 regs[128];
  std::unordered_map<u64, std::unique_ptr<u8[]>> pages;
  Layout lay;
  const u8* inputs;
  u64 inputs_len;
  const u8* tadv = nullptr;
  u64 tadv_len = 0;
  const u8* uadv = nullptr;
  u64 uadv_len = 0;
  std::vector<u8> outputs;
  bool panic_flag = false, terminated = false;
  // guest intrinsics (VirtualHostIO): print bytes + cycle-marker records
  // ([u32 event][u64 cycle][u32 len][label bytes] each)
  std::vector<u8> console;
  std::vector<u8> markers;
  u64 cycle = 0;

  u8* page(u64 addr) {
    u64 pg = addr >> 12;
    auto it = pages.find(pg);
    if (it == pages.end()) {
      auto p = std::make_unique<u8[]>(4096);
      std::memset(p.get(), 0, 4096);
      it = pages.emplace(pg, std::move(p)).first;
    }
    return it->second.get();
  }

  u8 dev_load(u64 a) {
    if (a == lay.panic) return panic_flag ? 1 : 0;
    if (a >= lay.panic && a < lay.io_end) return 0;
    if (a >= lay.input_start && a < lay.input_end) {
      u64 off = a - lay.input_start;
      return off < inputs_len ? inputs[off] : 0;
    }
    if (a >= lay.output_start && a < lay.output_end) {
      u64 off = a - lay.output_start;
      return off < outputs.size() ? outputs[off] : 0;
    }
    if (a >= lay.tadv_start && a < lay.tadv_end) {
      u64 off = a - lay.tadv_start;
      return off < tadv_len ? tadv[off] : 0;
    }
    if (a >= lay.uadv_start && a < lay.uadv_end) {
      u64 off = a - lay.uadv_start;
      return off < uadv_len ? uadv[off] : 0;
    }
    return 0;
  }

  void dev_store(u64 a, u8 v) {
    if (a == lay.panic) { panic_flag = true; return; }
    if (a == lay.termination) { terminated = true; return; }
    if (a >= lay.output_start && a < lay.output_end) {
      u64 off = a - lay.output_start;
      if (outputs.size() <= off) outputs.resize(off + 1, 0);
      outputs[off] = v;
    }
  }

  u8 rd8(u64 a) { return a < RAM_START ? dev_load(a) : page(a)[a & 0xFFF]; }
  void wr8(u64 a, u8 v) { if (a < RAM_START) dev_store(a, v); else page(a)[a & 0xFFF] = v; }

  u64 rd(u64 a, int size) {
    u64 out = 0;
    for (int i = 0; i < size; i++) out |= (u64)rd8(a + i) << (8 * i);
    return out;
  }
  void wr(u64 a, u64 v, int size) {
    for (int i = 0; i < size; i++) wr8(a + i, (v >> (8 * i)) & 0xFF);
  }
};

static inline u64 alu_imm(u16 k, u64 a, i64 imm) {
  switch (k) {
    case ADDI: return a + (u64)imm;
    case SLTI: return (i64)a < imm ? 1 : 0;
    case SLTIU: return a < (u64)imm ? 1 : 0;
    case XORI: return a ^ (u64)imm;
    case ORI: return a | (u64)imm;
    case ANDI: return a & (u64)imm;
    case SLLI: return a << imm;
    case SRLI: return a >> imm;
    case SRAI: return (u64)((i64)a >> imm);
  }
  return 0;
}

static inline u64 alu_reg(u16 k, u64 a, u64 b) {
  switch (k) {
    case ADD: return a + b;
    case SUB: return a - b;
    case SLT: return (i64)a < (i64)b ? 1 : 0;
    case SLTU: return a < b ? 1 : 0;
    case XOR_: return a ^ b;
    case OR_: return a | b;
    case AND_: return a & b;
    case MUL: return a * b;
    case MULHU: return (u64)(((unsigned __int128)a * (unsigned __int128)b) >> 64);
  }
  return 0;
}

// table-exact shift fold (lookups/tables.py _rsh_fold, virtual_srl.rs)
static inline u64 rsh_fold(u64 x, u64 y) {
  u64 e = 0;
  for (int p = 63; p >= 0; p--) {
    u64 yb = (y >> p) & 1;
    e = e * (1 + yb) + ((x >> p) & 1) * yb;
  }
  return e;
}

static inline u64 advice_value(i8 op, u64 a, u64 b) {
  switch (op) {
    case ADV_DIVU_Q: return b == 0 ? ~0ull : a / b;
    case ADV_DIVUW_Q: {
      u32 ua = (u32)a, ub = (u32)b;
      return ub == 0 ? ~0ull : (u64)(ua / ub);
    }
    case ADV_DIV_Q: case ADV_DIV_R_ABS: {
      i64 sa = (i64)a, sb = (i64)b;
      i64 q, r;
      if (sb == 0) { q = -1; r = sa; }
      else if (sa == INT64_MIN && sb == -1) { q = sa; r = 0; }
      else { q = sa / sb; r = sa % sb; }
      return op == ADV_DIV_Q ? (u64)q : (u64)(r < 0 ? -(u64)r : (u64)r);
    }
    case ADV_DIVW_Q: case ADV_DIVW_R_ABS: {
      i32 sa = (i32)a, sb = (i32)b;
      i64 q, r;
      if (sb == 0) { q = -1; r = sa; }
      else if (sa == INT32_MIN && sb == -1) { q = sa; r = 0; }
      else { q = (i64)(sa / sb); r = (i64)(sa % sb); }
      return op == ADV_DIVW_Q ? (u64)q : (u64)(r < 0 ? -(u64)r : (u64)r);
    }
  }
  return 0;
}


// One row step: advances row_idx, optionally records the trace row.
// Returns 0 ok, 1 unmapped jump / assert failure / misalignment.
// Shared by the serial tracer and the two-pass parallel tracer
// (tracer/src/parallel.rs analog) -- bit-identical by construction.
static int step_row(Machine* m, const ProgRow* prog,
                    const std::unordered_map<u64, u64>& addr2row,
                    u64& row_idx, TraceRow* out) {
  int status = 0;
    const ProgRow& pr = prog[row_idx];
    u16 k = pr.kind;
    u64 pc = pr.address;
    u8 rd = pr.rd;
    if (rd == 0 && (k == JAL || k == JALR)) rd = 32;
    u64 rs1v = m->regs[pr.rs1];
    u64 rs2v = m->regs[pr.rs2];
    i64 imm = pr.imm;
    bool advances = !(pr.flags & 1) || (pr.flags & 4);  // !virtual || last
    u64 ilen = (pr.flags & 8) ? 2 : 4;   // RVC source instruction
    u64 next_row = row_idx + 1;
    u64 next_pc = advances ? pc + ilen : pc;
    u64 rd_pre = m->regs[rd];
    u64 rd_post = rd_pre;
    u64 ram_addr = 0, ram_pre = 0, ram_post = 0;
    bool has_rd = true;
    bool has_target = false;
    u64 target = 0;

    switch (k) {
      case NOOP: case FENCE: case ECALL: case EBREAK:
        has_rd = false;
        break;
      case HOSTIO_: {
        // virtual_host_io.rs exec: call id x10, ptr x11, len x12, event x13
        has_rd = false;
        u32 call = (u32)m->regs[10];
        u64 ptr = m->regs[11];
        u32 len = (u32)m->regs[12];
        // x12 is guest-controlled: cap per-call payloads so a hostile
        // guest can't drive 4 GiB of per-byte host work per instruction
        if (len > 65536u) len = 65536u;
        u32 event = (u32)m->regs[13];
        if (call == 0x505249u) {                 // JOLT_PRINT_CALL_ID
          for (u32 i = 0; i < len; i++) m->console.push_back(m->rd8(ptr + i));
          if (event == 2) m->console.push_back('\n');
        } else if (call == 0xC7C1Eu) {           // JOLT_CYCLE_TRACK_CALL_ID
          auto put32 = [&](u32 v) {
            for (int b = 0; b < 4; b++) m->markers.push_back((v >> (8 * b)) & 0xFF);
          };
          put32(event);
          for (int b = 0; b < 8; b++) m->markers.push_back((m->cycle >> (8 * b)) & 0xFF);
          put32(len);
          for (u32 i = 0; i < len; i++) m->markers.push_back(m->rd8(ptr + i));
        }
        break;
      }
      case LUI: rd_post = (u64)imm; break;
      case AUIPC: rd_post = pc + (u64)imm; break;
      case JAL: rd_post = pc + ilen; target = pc + (u64)imm; has_target = true; break;
      case JALR: rd_post = pc + ilen; target = (rs1v + (u64)imm) & ~1ull; has_target = true; break;
      case BEQ: case BNE: case BLT: case BGE: case BLTU: case BGEU: {
        bool taken = false;
        switch (k) {
          case BEQ: taken = rs1v == rs2v; break;
          case BNE: taken = rs1v != rs2v; break;
          case BLT: taken = (i64)rs1v < (i64)rs2v; break;
          case BGE: taken = (i64)rs1v >= (i64)rs2v; break;
          case BLTU: taken = rs1v < rs2v; break;
          case BGEU: taken = rs1v >= rs2v; break;
        }
        if (taken) { target = pc + (u64)imm; has_target = true; }
        has_rd = false;
        break;
      }
      case LD_: {
        u64 addr = rs1v + (u64)imm;
        if (addr & 7) { status = 1; m->terminated = true; break; }
        rd_post = m->rd(addr, 8);
        ram_addr = addr;
        ram_pre = ram_post = rd_post;
        break;
      }
      case SD_: {
        u64 addr = rs1v + (u64)imm;
        if (addr & 7) { status = 1; m->terminated = true; break; }
        ram_addr = addr;
        ram_pre = m->rd(addr, 8);
        ram_post = rs2v;
        m->wr(addr, rs2v, 8);
        has_rd = false;
        break;
      }
      case ADDI: case SLTI: case SLTIU: case XORI: case ORI: case ANDI:
      case SLLI: case SRLI: case SRAI:
        rd_post = alu_imm(k, rs1v, imm);
        break;
      case ADD: case SUB: case SLT: case SLTU: case XOR_: case OR_:
      case AND_: case MUL: case MULHU:
        rd_post = alu_reg(k, rs1v, rs2v);
        break;
      case V_ADVICE:
        rd_post = advice_value(pr.advice_op, m->regs[pr.advice_rs1],
                               m->regs[pr.advice_rs2]);
        break;
      case V_MOVSIGN: rd_post = (rs1v >> 63) ? ~0ull : 0; break;
      case V_POW2: rd_post = 1ull << (rs1v & 63); break;
      case V_POW2W: rd_post = 1ull << (rs1v & 31); break;
      case V_SHIFT_BITMASK: rd_post = ~0ull - (1ull << (rs1v & 63)) + 1; break;
      case V_SEXT_W: rd_post = (u64)(i64)(i32)rs1v; break;
      case V_ZEXT_W: rd_post = (u64)(u32)rs1v; break;
      case V_CHANGE_DIV:
        rd_post = (rs1v == (1ull << 63) && rs2v == ~0ull) ? 1 : rs2v;
        break;
      case V_CHANGE_DIVW:
        rd_post = (rs1v == 0xFFFFFFFF80000000ull && rs2v == ~0ull) ? 1 : rs2v;
        break;
      case V_SRL: rd_post = rsh_fold(rs1v, rs2v); break;
      case V_SRA: {
        u64 ext = 0;
        if (rs1v >> 63)
          for (int p = 0; p < 63; p++)
            if (!((rs2v >> p) & 1)) ext += 1ull << (63 - p);
        rd_post = rsh_fold(rs1v, rs2v) + ext;
        break;
      }
      case V_MULI: rd_post = rs1v * (u64)imm; break;
      case ANDN_: rd_post = rs1v & ~rs2v; break;
      case V_ROTRI: {
        u32 sh = imm ? (u32)__builtin_ctzll((u64)imm) : 64;
        rd_post = (sh % 64) ? (rs1v >> (sh % 64)) | (rs1v << (64 - sh % 64))
                            : rs1v;
        break;
      }
      case V_ROTRIW: {
        u32 sh = imm ? (u32)__builtin_ctzll((u64)imm) : 64;
        if (sh > 32) sh = 32;
        u32 v = (u32)rs1v;
        rd_post = (u64)((sh % 32) ? (v >> (sh % 32)) | (v << (32 - sh % 32))
                                  : v);
        break;
      }
      case V_REV8W: {
        u32 lo = __builtin_bswap32((u32)rs1v);
        u32 hi = __builtin_bswap32((u32)(rs1v >> 32));
        rd_post = (u64)lo | ((u64)hi << 32);
        break;
      }
      case V_XORROT16: case V_XORROT24: case V_XORROT32: case V_XORROT63: {
        u32 r = k == V_XORROT16 ? 16 : k == V_XORROT24 ? 24
              : k == V_XORROT32 ? 32 : 63;
        u64 v = rs1v ^ rs2v;
        rd_post = (v >> r) | (v << (64 - r));
        break;
      }
      case V_XORROTW7: case V_XORROTW8: case V_XORROTW12: case V_XORROTW16: {
        u32 r = k == V_XORROTW7 ? 7 : k == V_XORROTW8 ? 8
              : k == V_XORROTW12 ? 12 : 16;
        u32 v = (u32)(rs1v ^ rs2v);
        rd_post = (u64)((v >> r) | (v << (32 - r)));
        break;
      }
      case VA_EQ: case VA_LTE: case VA_VALID_DIV0: case VA_VALID_UREM:
      case VA_MULU_NO_OVF: case VA_HALF_ALIGN: case VA_WORD_ALIGN: {
        bool ok = false;
        switch (k) {
          case VA_EQ: ok = rs1v == rs2v; break;
          case VA_LTE: ok = rs1v <= rs2v; break;
          case VA_VALID_DIV0: ok = rs1v != 0 || rs2v == ~0ull; break;
          case VA_VALID_UREM: ok = rs2v == 0 || rs1v < rs2v; break;
          case VA_MULU_NO_OVF:
            ok = ((unsigned __int128)rs1v * (unsigned __int128)rs2v) >> 64 == 0;
            break;
          case VA_HALF_ALIGN: ok = ((rs1v + (u64)imm) & 1) == 0; break;
          case VA_WORD_ALIGN: ok = ((rs1v + (u64)imm) & 3) == 0; break;
        }
        if (!ok) { status = 1; m->terminated = true; }
        has_rd = false;
        break;
      }
      default:
        status = 1;
        m->terminated = true;
        break;
    }
    if (status) return status;

    if (has_target) {
      next_pc = target;
      auto it = addr2row.find(target);
      if (it == addr2row.end()) { return 1; }
      next_row = it->second;
      // jump-to-self terminates the trace (tracer/src/lib.rs:331 heuristic)
      if ((k == JAL || k == JALR) && target == pc) m->terminated = true;
    }

    if (has_rd && rd != 0) m->regs[rd] = rd_post;
    if (rd == 0) { rd_post = 0; rd_pre = 0; }

    TraceRow row{};
    row.kind = k;
    row.rd = has_rd ? rd : 255;
    row.rs1 = pr.rs1;
    row.rs2 = pr.rs2;
    row.pc = pc;
    row.rs1_val = rs1v;
    row.rs2_val = rs2v;
    row.rd_pre = rd_pre;
    row.rd_post = (has_rd && rd != 0) ? m->regs[rd] : 0;
    row.ram_addr = ram_addr;
    row.ram_pre = ram_pre;
    row.ram_post = ram_post;
    row.imm = imm;
    row.next_pc = next_pc;
    row.pc_idx = row_idx;
    row.next_pc_idx = next_row;
    if (out) {
      *out = row;
    }
    row_idx = next_row;
    m->cycle++;
    return 0;
}

}  // namespace

extern "C" {

struct TraceResult {
  TraceRow* rows;
  u64 count;
  u8* outputs;
  u64 outputs_len;
  i32 panic_flag;
  i32 status;  // 0 ok, 1 unmapped jump/assert failure, 2 max cycles exceeded
  void* rows_owner;     // std::vector<TraceRow>*
  void* machine_owner;  // Machine*
  // guest intrinsics: console bytes + cycle-marker records
  u8* console;
  u64 console_len;
  u8* markers;
  u64 markers_len;
};

// Execute the expanded program (prog[0..n_prog)) from the entry row.
TraceResult* jolt_trace_rows(const ProgRow* prog, u64 n_prog,
                             const u8* code, u64 code_len, u64 entry,
                             u64 start,
                             const u8* inputs, u64 inputs_len,
                             u64 input_start, u64 input_end,
                             u64 output_start, u64 output_end,
                             u64 panic_addr, u64 termination, u64 io_end,
                             const u8* tadv, u64 tadv_len,
                             u64 tadv_start, u64 tadv_end,
                             const u8* uadv, u64 uadv_len,
                             u64 uadv_start, u64 uadv_end,
                             u64 max_cycles) {
  auto* m = new Machine();
  std::memset(m->regs, 0, sizeof(m->regs));
  m->lay = {input_start, input_end, output_start, output_end,
            panic_addr, termination, io_end,
            tadv_start, tadv_end, uadv_start, uadv_end};
  m->inputs = inputs;
  m->inputs_len = inputs_len;
  m->tadv = tadv; m->tadv_len = tadv_len;
  m->uadv = uadv; m->uadv_len = uadv_len;
  for (u64 i = 0; i < code_len; i++) m->wr8(entry + i, code[i]);

  // source address -> first row index (riscv/program.py addr2row)
  std::unordered_map<u64, u64> addr2row;
  addr2row.reserve(n_prog + 1);
  for (u64 i = 0; i < n_prog; i++) {
    if (addr2row.find(prog[i].address) == addr2row.end())
      addr2row.emplace(prog[i].address, i);
  }
  addr2row.emplace(entry + code_len, n_prog);  // halt row

  auto* res = new TraceResult();
  auto* rows = new std::vector<TraceRow>();
  rows->reserve(1 << 16);
  res->status = 0;

  u64 row_idx = addr2row[start];
  while (!m->terminated) {
    if (rows->size() >= max_cycles) { res->status = 2; break; }
    TraceRow row;
    int st = step_row(m, prog, addr2row, row_idx, &row);
    if (st) { res->status = st; break; }
    rows->push_back(row);
  }

  res->rows = rows->data();
  res->count = rows->size();
  res->outputs = m->outputs.data();
  res->outputs_len = m->outputs.size();
  res->panic_flag = m->panic_flag ? 1 : 0;
  res->rows_owner = rows;
  res->machine_owner = m;
  res->console = m->console.data();
  res->console_len = m->console.size();
  res->markers = m->markers.data();
  res->markers_len = m->markers.size();
  return res;
}

// Fill caller-allocated SoA column buffers (length >= count) from the AoS
// rows.  u64 columns are split into (lo, hi) u32 words; imm uses its two's
// complement bit pattern.  Doing the transpose here avoids pathologically
// slow strided structured-array copies in numpy on some hosts.
void jolt_trace_fill_columns(
    TraceResult* res,
    u16* kind, u8* rd, u8* rs1, u8* rs2,
    u32* pc_lo, u32* pc_hi,
    u32* rs1_val_lo, u32* rs1_val_hi,
    u32* rs2_val_lo, u32* rs2_val_hi,
    u32* rd_pre_lo, u32* rd_pre_hi,
    u32* rd_post_lo, u32* rd_post_hi,
    u32* ram_addr_lo, u32* ram_addr_hi,
    u32* ram_pre_lo, u32* ram_pre_hi,
    u32* ram_post_lo, u32* ram_post_hi,
    u32* imm_lo, u32* imm_hi,
    u32* next_pc_lo, u32* next_pc_hi,
    u32* pc_idx_lo, u32* pc_idx_hi,
    u32* next_pc_idx_lo, u32* next_pc_idx_hi) {
  const TraceRow* rows = res->rows;
  const u64 n = res->count;
  for (u64 i = 0; i < n; i++) {
    const TraceRow& r = rows[i];
    kind[i] = r.kind; rd[i] = r.rd; rs1[i] = r.rs1; rs2[i] = r.rs2;
    auto split = [](u64 v, u32* lo, u32* hi, u64 i) {
      lo[i] = (u32)v; hi[i] = (u32)(v >> 32);
    };
    split(r.pc, pc_lo, pc_hi, i);
    split(r.rs1_val, rs1_val_lo, rs1_val_hi, i);
    split(r.rs2_val, rs2_val_lo, rs2_val_hi, i);
    split(r.rd_pre, rd_pre_lo, rd_pre_hi, i);
    split(r.rd_post, rd_post_lo, rd_post_hi, i);
    split(r.ram_addr, ram_addr_lo, ram_addr_hi, i);
    split(r.ram_pre, ram_pre_lo, ram_pre_hi, i);
    split(r.ram_post, ram_post_lo, ram_post_hi, i);
    split((u64)r.imm, imm_lo, imm_hi, i);
    split(r.next_pc, next_pc_lo, next_pc_hi, i);
    split(r.pc_idx, pc_idx_lo, pc_idx_hi, i);
    split(r.next_pc_idx, next_pc_idx_lo, next_pc_idx_hi, i);
  }
}


// Two-pass parallel tracing (the reference's tracer/src/parallel.rs):
// pass 1 executes WITHOUT recording rows, cutting full machine snapshots
// every chunk_rows; pass 2 re-executes every chunk from its snapshot in
// parallel, writing rows into the final array at fixed offsets.  Output is
// bit-identical to the serial tracer (each chunk replays the exact same
// deterministic machine), mirroring the reference's paranoia contract.
TraceResult* jolt_trace_rows_parallel(
    const ProgRow* prog, u64 n_prog,
    const u8* code, u64 code_len, u64 entry, u64 start,
    const u8* inputs, u64 inputs_len,
    u64 input_start, u64 input_end,
    u64 output_start, u64 output_end,
    u64 panic_addr, u64 termination, u64 io_end,
    const u8* tadv, u64 tadv_len, u64 tadv_start, u64 tadv_end,
    const u8* uadv, u64 uadv_len, u64 uadv_start, u64 uadv_end,
    u64 max_cycles, u64 chunk_rows, u64 n_threads) {
  auto* m = new Machine();
  std::memset(m->regs, 0, sizeof(m->regs));
  m->lay = {input_start, input_end, output_start, output_end,
            panic_addr, termination, io_end,
            tadv_start, tadv_end, uadv_start, uadv_end};
  m->inputs = inputs;
  m->inputs_len = inputs_len;
  m->tadv = tadv; m->tadv_len = tadv_len;
  m->uadv = uadv; m->uadv_len = uadv_len;
  for (u64 i = 0; i < code_len; i++) m->wr8(entry + i, code[i]);

  std::unordered_map<u64, u64> addr2row;
  addr2row.reserve(n_prog + 1);
  for (u64 i = 0; i < n_prog; i++) {
    if (addr2row.find(prog[i].address) == addr2row.end())
      addr2row.emplace(prog[i].address, i);
  }
  addr2row.emplace(entry + code_len, n_prog);  // halt row

  auto clone = [](const Machine* src) {
    auto* c = new Machine();
    std::memcpy(c->regs, src->regs, sizeof(src->regs));
    for (const auto& kv : src->pages) {
      auto pg = std::make_unique<u8[]>(4096);
      std::memcpy(pg.get(), kv.second.get(), 4096);
      c->pages.emplace(kv.first, std::move(pg));
    }
    c->lay = src->lay;
    c->inputs = src->inputs;
    c->inputs_len = src->inputs_len;
    c->tadv = src->tadv; c->tadv_len = src->tadv_len;
    c->uadv = src->uadv; c->uadv_len = src->uadv_len;
    c->outputs = src->outputs;
    c->panic_flag = src->panic_flag;
    c->terminated = src->terminated;
    c->console = src->console;
    c->markers = src->markers;
    c->cycle = src->cycle;
    return c;
  };

  auto* res = new TraceResult();
  res->status = 0;
  if (chunk_rows == 0) chunk_rows = 1 << 16;

  // ---- pass 1: execute-only + checkpoints (ChunkCheckpoint analog) ----
  std::vector<Machine*> snaps;
  std::vector<u64> snap_idx;
  u64 row_idx = addr2row[start];
  u64 count = 0;
  snaps.push_back(clone(m));
  snap_idx.push_back(row_idx);
  while (!m->terminated) {
    if (count >= max_cycles) { res->status = 2; break; }
    int st = step_row(m, prog, addr2row, row_idx, nullptr);
    if (st) { res->status = st; break; }
    count++;
    if (count % chunk_rows == 0 && !m->terminated) {
      snaps.push_back(clone(m));
      snap_idx.push_back(row_idx);
    }
  }

  // ---- pass 2: per-chunk re-trace into the final array ----------------
  auto* rows = new std::vector<TraceRow>(count);
  u64 n_chunks = (count + chunk_rows - 1) / chunk_rows;
  if (n_chunks > snaps.size()) n_chunks = snaps.size();
  if (n_threads == 0) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? hw : 1;
  }
  auto work = [&](u64 c) {
    Machine* mc = snaps[c];
    u64 ri = snap_idx[c];
    u64 lo = c * chunk_rows;
    u64 hi = lo + chunk_rows > count ? count : lo + chunk_rows;
    for (u64 i = lo; i < hi; i++) {
      if (step_row(mc, prog, addr2row, ri, &(*rows)[i])) break;
    }
  };
  if (n_threads <= 1 || n_chunks <= 1) {
    for (u64 c = 0; c < n_chunks; c++) work(c);
  } else {
    std::vector<std::thread> ts;
    std::atomic<u64> next{0};
    for (u64 t = 0; t < n_threads && t < n_chunks; t++) {
      ts.emplace_back([&]() {
        for (u64 c = next.fetch_add(1); c < n_chunks;
             c = next.fetch_add(1))
          work(c);
      });
    }
    for (auto& th : ts) th.join();
  }
  for (auto* sm : snaps) delete sm;

  res->rows = rows->data();
  res->count = rows->size();
  res->outputs = m->outputs.data();
  res->outputs_len = m->outputs.size();
  res->panic_flag = m->panic_flag ? 1 : 0;
  res->rows_owner = rows;
  res->machine_owner = m;
  res->console = m->console.data();
  res->console_len = m->console.size();
  res->markers = m->markers.data();
  res->markers_len = m->markers.size();
  return res;
}

void jolt_trace_free(TraceResult* res) {
  delete static_cast<std::vector<TraceRow>*>(res->rows_owner);
  delete static_cast<Machine*>(res->machine_owner);
  delete res;
}

}  // extern "C"
