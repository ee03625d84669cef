"""Randomized invariant checking: the eval/fuzz layer.

Analog of the reference's `jolt-eval` invariant + fuzzing framework
(SURVEY §L21, §5.2): generate random-but-terminating RV64IM guests,
then check layered invariants --

  1. **differential tracing**: the Python emulator and the C++ tracer
     must produce bit-identical SoA columns (when the native library is
     available);
  2. **R1CS satisfaction**: every uniform constraint holds on the real
     witness (r1cs/constraints.py check_satisfied);
  3. **prove/verify round trip**: the proof verifies, and a random
     single-field tamper is rejected (run_fuzz_case(tamper=True)).

`python -m jolt_tpu_torch.eval.fuzz N [seed [device]]` runs N cases
standalone; the JAX package's test suite pins a few seeds
(tests/test_fuzz.py).

Torch counterpart of the JAX package's `eval/fuzz.py`: the same guests
and invariants, the round trip proved on `device` (the card unless the
caller asks for the CPU).
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple

from ..riscv.emulator import MemoryLayout

# register pool: avoid x0 (sink semantics tested elsewhere deliberately),
# sp/gp/tp, and the two scratch registers the harness reserves (s0, s1)
_REGS = ["a0", "a1", "a2", "a3", "a4", "a5", "t0", "t1", "t2", "t3",
         "s2", "s3", "s4"]

_ALU_RRR = ["add", "sub", "and", "or", "xor", "sll", "srl", "sra",
            "slt", "sltu", "addw", "subw", "sllw", "srlw", "sraw",
            "mul", "mulh", "mulhu", "mulhsu", "mulw",
            "div", "divu", "rem", "remu", "divw", "divuw", "remw",
            "remuw"]
_ALU_RRI = ["addi", "andi", "ori", "xori", "slti", "sltiu", "addiw"]
_SHIFT_RI = ["slli", "srli", "srai", "slliw", "srliw", "sraiw"]
_STORES = [("sd", 8), ("sw", 4), ("sh", 2), ("sb", 1)]
_LOADS = [("ld", 8), ("lw", 4), ("lwu", 4), ("lh", 2), ("lhu", 2),
          ("lb", 1), ("lbu", 1)]

SCRATCH_BASE = 0x80004000
SCRATCH_SIZE = 256


def gen_program(rng: random.Random, n_instr: int = 40,
                layout: Optional[MemoryLayout] = None) -> str:
    """A random, always-terminating guest: straight-line ALU/mul/div ops,
    loads/stores confined to a scratch window, occasional forward
    branches (never backward, so no loops), then output + termination."""
    layout = layout or MemoryLayout()
    lines = [f"    li   s0, {SCRATCH_BASE}"]
    for r in _REGS:
        lines.append(f"    li   {r}, {rng.randrange(1 << 32)}")
    label_n = 0
    pending_label: Optional[str] = None
    budget = n_instr
    while budget > 0:
        budget -= 1
        kind = rng.random()
        rd = rng.choice(_REGS)
        r1 = rng.choice(_REGS)
        r2 = rng.choice(_REGS)
        if kind < 0.45:
            lines.append(f"    {rng.choice(_ALU_RRR)} {rd}, {r1}, {r2}")
        elif kind < 0.6:
            imm = rng.randrange(-2048, 2048)
            lines.append(f"    {rng.choice(_ALU_RRI)} {rd}, {r1}, {imm}")
        elif kind < 0.7:
            sh = rng.randrange(0, 32)
            lines.append(f"    {rng.choice(_SHIFT_RI)} {rd}, {r1}, {sh}")
        elif kind < 0.8:
            op, w = rng.choice(_STORES)
            off = rng.randrange(0, SCRATCH_SIZE // w) * w
            lines.append(f"    {op} {r1}, {off}(s0)")
        elif kind < 0.9:
            op, w = rng.choice(_LOADS)
            off = rng.randrange(0, SCRATCH_SIZE // w) * w
            lines.append(f"    {op} {rd}, {off}(s0)")
        elif pending_label is None and budget > 2:
            # forward branch over the next instruction (taken or not
            # depending on runtime data -- both paths stay in-program)
            label_n += 1
            pending_label = f"l{label_n}"
            cond = rng.choice(["beq", "bne", "blt", "bge", "bltu", "bgeu"])
            lines.append(f"    {cond} {r1}, {r2}, {pending_label}")
            continue
        if pending_label is not None and rng.random() < 0.5:
            lines.append(f"{pending_label}:")
            pending_label = None
    if pending_label is not None:
        lines.append(f"{pending_label}:")
    out = rng.choice(_REGS)
    lines += [
        f"    li   s1, {layout.output_start}",
        f"    sd   {out}, 0(s1)",
        f"    li   s1, {layout.termination}",
        "    li   s2, 1",
        "    sd   s2, 0(s1)",
    ]
    return "\n".join(lines)


def run_differential(seed: int, n_instr: int = 40) -> None:
    """Python emulator vs C++ tracer: bit-identical columns or raise."""
    import numpy as np

    from ..tracer import trace_program
    from ..tracer.native import trace_program_native

    rng = random.Random(seed)
    layout = MemoryLayout(max_input_size=64, max_output_size=64)
    guest = gen_program(rng, n_instr, layout)
    py = trace_program(guest, layout=layout)
    try:
        nat = trace_program_native(guest, layout=layout)
    except (OSError, RuntimeError):
        return   # no C++ toolchain / library in this environment
    assert py.length == nat.length, (py.length, nat.length)
    for k in py.columns:
        if not np.array_equal(py.columns[k], nat.columns[k]):
            j = int(np.argmax(py.columns[k] != nat.columns[k]))
            raise AssertionError(
                f"seed {seed}: column {k} diverges at cycle {j}: "
                f"py={py.columns[k][j]} native={nat.columns[k][j]}")
    assert bytes(py.device.outputs) == bytes(nat.device.outputs)
    assert py.device.panic == nat.device.panic


def check_invariants(trace) -> List[Tuple[str, int]]:
    """Structural invariants on a trace's witness: R1CS satisfaction plus
    one-hot index-stream bounds.  Returns [] or a list of violations."""
    import numpy as np

    from ..r1cs import check_satisfied
    from ..witness.r1cs_inputs import extract_r1cs_inputs
    from ..witness.registers import extract_register_log

    bad = list(check_satisfied(extract_r1cs_inputs(trace)))
    reg = extract_register_log(trace)
    for name, stream in (("rd", reg.rd_eff), ("rs1", reg.rs1_eff),
                         ("rs2", reg.rs2_eff)):
        arr = np.asarray(stream)
        if arr.size and (arr.min() < 0 or arr.max() >= 128):
            bad.append((f"register index stream {name} out of range",
                        int(arr.argmax())))
    return bad


def run_fuzz_case(seed: int, n_instr: int = 30, tamper: bool = False,
                  prove_roundtrip: bool = True, device="cuda") -> None:
    """One full fuzz case: trace, invariants, prove on `device`, verify
    (+ optional random single-field tamper which must be REJECTED)."""
    from ..tracer import trace_program

    rng = random.Random(seed)
    layout = MemoryLayout(max_input_size=64, max_output_size=64)
    guest = gen_program(rng, n_instr, layout)
    tr = trace_program(guest, layout=layout, min_padded=16)
    bad = check_invariants(tr)
    assert not bad, f"seed {seed}: invariant violations: {bad[:4]}"
    if not prove_roundtrip:
        return

    from ..proof_io import deserialize_proof, serialize_proof
    from ..prover import prove
    from ..verifier import VerificationError, verify
    from ..verifier.verifier import PublicIO

    proof = prove(tr, device=device)
    io = PublicIO.from_trace(tr)
    assert verify(proof, io), f"seed {seed}: honest proof rejected"

    if tamper:
        blob = serialize_proof(proof, {
            "trace_length": tr.length, "padded_length": tr.padded_length,
            "outputs": bytes(tr.device.outputs), "panic": tr.device.panic})
        p2, _ = deserialize_proof(blob)
        stage = rng.choice([p2.stage1_polys, p2.stage4_polys,
                            p2.stage7_polys, p2.stage8_polys])
        rnd = rng.randrange(len(stage))
        j = rng.randrange(len(stage[rnd]))
        stage[rnd][j] = (stage[rnd][j] + 1 + rng.randrange(1 << 60)) % \
            (1 << 251)
        try:
            ok = verify(p2, io)
        except VerificationError:
            ok = False
        assert not ok, f"seed {seed}: tampered proof accepted"


def main(argv=None) -> int:
    import sys
    args = argv if argv is not None else sys.argv[1:]
    n = int(args[0]) if args else 5
    seed0 = int(args[1]) if len(args) > 1 else 0
    device = args[2] if len(args) > 2 else "cuda"
    for i in range(n):
        seed = seed0 + i
        run_differential(seed)
        run_fuzz_case(seed, tamper=(i % 2 == 0), device=device)
        print(f"fuzz case {seed}: ok", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
