"""The `jolt_tpu_torch` command-line interface.

Analog of the reference's `jolt` binary (`src/main.rs:31-50`: new/build/run)
plus prove/verify, adapted to the assembler-based guest workflow:

    python -m jolt_tpu_torch.cli new DIR                     # scaffold a guest
    python -m jolt_tpu_torch.cli build GUEST.s -o guest.elf  # assemble -> ELF
    python -m jolt_tpu_torch.cli run GUEST.s [--input HEX] [--native]
    python -m jolt_tpu_torch.cli trace GUEST.s [--input HEX] # cycle stats
    python -m jolt_tpu_torch.cli prove GUEST.s -o proof.bin [--input HEX] \
        [--pcs dory] [--device cuda|cpu]
    python -m jolt_tpu_torch.cli verify GUEST.s proof.bin [--input HEX] \
        [--pcs dory]

Torch counterpart of the JAX package's `cli.py`.  Its `--platform
{default,cpu}` (a JAX backend switch) becomes `--device {cuda,cpu}`, the
device `prove` runs on: the card by default; with no card, `cuda` raises
and nothing falls back to the CPU.  Proof files are the JAX package's
bytes (`proof_io.py`), so either package's `verify` reads the other's.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time


def _read_guest(path: str):
    """Guest file -> assembly source (str) or ELF bytes."""
    from .riscv.elf import is_elf
    raw = open(path, "rb").read()
    if is_elf(raw):
        return raw
    return raw.decode()


def _trace(args):
    from .riscv.emulator import MemoryLayout
    ta = bytes.fromhex(getattr(args, "trusted_advice", "") or "")
    ua = bytes.fromhex(getattr(args, "untrusted_advice", "") or "")
    def _pow2(n):
        k = 8
        while k < n:
            k *= 2
        return k
    layout = MemoryLayout(
        max_input_size=args.io_size, max_output_size=args.io_size,
        max_trusted_advice_size=_pow2(len(ta)) if ta else 0,
        max_untrusted_advice_size=_pow2(len(ua)) if ua else 0)
    src = _read_guest(args.guest)
    inputs = bytes.fromhex(args.input) if args.input else b""
    t0 = time.time()
    if args.native:
        from .tracer.native import trace_program_native as tp
    else:
        from .tracer import trace_program as tp
    tr = tp(src, inputs=inputs, layout=layout,
            trusted_advice=ta, untrusted_advice=ua)
    dt = time.time() - t0
    return tr, dt


_GUEST_TEMPLATE = """\
# {name}: jolt_tpu_torch guest template (`jolt new` analog, src/main.rs:31-40).
#
# Convention: read inputs from the memory-mapped input region, write
# outputs to the output region, then store 1 to the termination address
# (addresses below are for the default 64-byte IO layout; regenerate with
# `python -m jolt_tpu_torch.cli new --io-size N` for other layouts).

    li   t0, {input_start}     # input region base
    ld   a0, 0(t0)             # first input dword
    # ---- your computation here (result in a1) ----
    addi a1, a0, 1
    # ----------------------------------------------
    li   t0, {output_start}    # output region base
    sd   a1, 0(t0)
    li   t1, {termination}     # termination flag
    li   t2, 1
    sd   t2, 0(t1)
"""


def cmd_new(args):
    """Scaffold a guest directory with a template .s (the reference's
    `jolt new` cargo scaffold, adapted to the assembler workflow)."""
    from .riscv.emulator import MemoryLayout
    layout = MemoryLayout(max_input_size=args.io_size,
                          max_output_size=args.io_size)
    import os
    os.makedirs(args.dir, exist_ok=True)
    name = os.path.basename(os.path.abspath(args.dir))
    path = os.path.join(args.dir, "guest.s")
    if os.path.exists(path) and not args.force:
        print(f"{path} exists (use --force to overwrite)")
        return 1
    with open(path, "w") as f:
        f.write(_GUEST_TEMPLATE.format(name=name,
                                       input_start=layout.input_start,
                                       output_start=layout.output_start,
                                       termination=layout.termination))
    print(f"guest template -> {path}")
    print(f"  run:   python -m jolt_tpu_torch.cli run {path} "
          "--input 2a00000000000000")
    print(f"  prove: python -m jolt_tpu_torch.cli prove {path} "
          "--input 2a00000000000000")
    return 0


def cmd_build(args):
    """Assemble a guest to a RISC-V ELF (the `jolt build` analog: guest
    source -> ELF via the linker-script/zeroos path in the reference)."""
    from .riscv.assembler import assemble
    from .riscv.elf import is_elf, write_elf
    raw = open(args.guest, "rb").read()
    if is_elf(raw):
        code = raw
    else:
        base = 0x80000000
        code = write_elf(assemble(raw.decode(), base=base), base)
    out = args.output or (args.guest.rsplit(".", 1)[0] + ".elf")
    with open(out, "wb") as f:
        f.write(code)
    print(f"ELF -> {out} ({len(code)} bytes)")
    return 0


def cmd_run(args):
    tr, dt = _trace(args)
    rate = tr.length / dt / 1e6 if dt else 0
    print(f"executed {tr.length} cycles in {dt:.3f}s ({rate:.2f} MHz)")
    if tr.device.console:
        sys.stdout.write(tr.device.console.decode("utf-8", "replace"))
        if not tr.device.console.endswith(b"\n"):
            print()
    print(f"outputs: {bytes(tr.device.outputs).hex() or '(empty)'}")
    print(f"panic: {tr.device.panic}")
    spans = tr.device.cycle_spans()
    for label, s in spans.items():
        print(f"cycles[{label}]: {s['cycles']} over {s['count']} span(s)")
    return 0


def cmd_trace(args):
    from .riscv import isa
    tr, dt = _trace(args)
    if getattr(args, "output", None):
        from .tracer.trace_io import save_trace
        save_trace(tr, args.output)
        print(f"trace -> {args.output}")
    counts = collections.Counter(isa.KINDS[k] for k in tr.col("kind")[:tr.length])
    print(f"{tr.length} cycles (padded {tr.padded_length}); per-instruction:")
    for kind, n in counts.most_common():
        print(f"  {kind:8s} {n}")
    return 0


def cmd_prove(args):
    from .prover import prove
    from .prover.prover import resolve_device
    device = resolve_device(args.device)
    prof = None
    if getattr(args, "profile", False):
        from .utils.profiling import enable
        prof = enable()
    if getattr(args, "trace_file", None):
        from .tracer.trace_io import load_trace
        tr = load_trace(args.trace_file)
    else:
        tr, _ = _trace(args)
    t0 = time.time()
    proof = prove(tr, setup=(None if args.pcs == "none" else args.pcs),
                  device=device, zk=getattr(args, "zk", False),
                  committed_image=getattr(args, "committed_image", False))
    dt = time.time() - t0
    khz = tr.length / dt / 1e3
    print(f"proved {tr.length} cycles in {dt:.1f}s ({khz:.2f} kHz)")
    if prof is not None:
        print(prof.report())
        ppath = args.output + ".profile.json"
        prof.dump(ppath)
        print(f"profile -> {ppath}")
    # the claimed public statement travels WITH the proof so verification
    # never re-executes the guest (succinct verify); canonical bytes, no
    # pickle on the wire (proof_io.py)
    from .proof_io import serialize_proof
    statement = {"trace_length": tr.length,
                 "padded_length": tr.padded_length,
                 "outputs": bytes(tr.device.outputs),
                 "panic": tr.device.panic}
    blob = serialize_proof(proof, statement)
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"proof -> {args.output} ({len(blob)} bytes)")
    return 0


def cmd_verify(args):
    """Succinct verification: assemble the program (no execution), build the
    statement from the proof file's claimed outputs + the verifier's own
    inputs, and run the O(log) verifier."""
    from .riscv.assembler import assemble
    from .riscv.elf import is_elf, load_elf
    from .riscv.emulator import MemoryLayout
    from .verifier import VerificationError, verify
    from .verifier.verifier import PublicIO
    ta = bytes.fromhex(getattr(args, "trusted_advice", "") or "")
    ua = bytes.fromhex(getattr(args, "untrusted_advice", "") or "")
    def _pow2(n):
        k = 8
        while k < n:
            k *= 2
        return k
    layout = MemoryLayout(
        max_input_size=args.io_size, max_output_size=args.io_size,
        max_trusted_advice_size=_pow2(len(ta)) if ta else 0,
        max_untrusted_advice_size=_pow2(len(ua)) if ua else 0)
    guest = _read_guest(args.guest)
    entry = start = 0x80000000
    if isinstance(guest, bytes):
        loaded = load_elf(guest)
        code, entry, start = loaded.image, loaded.base, loaded.entry
    else:
        code = assemble(guest)
    from .proof_io import ProofDecodeError, deserialize_proof
    inputs = bytes.fromhex(args.input) if args.input else b""
    try:
        proof, st = deserialize_proof(open(args.proof, "rb").read())
    except (ProofDecodeError, Exception) as e:
        print(f"REJECTED: malformed proof file: {e}")
        return 1
    io = PublicIO(st["trace_length"], st["padded_length"], inputs,
                  st["outputs"], st["panic"], layout, code, entry, start)
    setup = None
    if args.pcs != "none":
        from .prover.prover import required_num_vars
        if args.pcs == "dory":
            from .pcs.dory import DorySetup
            setup = DorySetup.generate(required_num_vars(
                st["padded_length"], proof.ram_log_K, proof.bytecode_log_K))
        else:
            from .pcs.hyperkzg import KZGSetup
            setup = KZGSetup.generate(1 << required_num_vars(
                st["padded_length"], proof.ram_log_K, proof.bytecode_log_K),
                device=args.device)
    t0 = time.time()
    try:
        ok = verify(proof, io, setup=setup)
    except VerificationError as e:
        print(f"REJECTED: {e}")
        return 1
    print(f"verified in {time.time() - t0:.2f}s: {ok}")
    print(f"claimed outputs: {st['outputs'].hex() or '(empty)'}"
          f"  panic: {st['panic']}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="jolt_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp_new = sub.add_parser("new", help="scaffold a guest directory")
    sp_new.add_argument("dir")
    sp_new.add_argument("--io-size", type=int, default=64)
    sp_new.add_argument("--force", action="store_true")
    sp_new.set_defaults(fn=cmd_new)
    sp_build = sub.add_parser("build", help="assemble a guest to an ELF")
    sp_build.add_argument("guest")
    sp_build.add_argument("-o", "--output", default=None)
    sp_build.set_defaults(fn=cmd_build)
    for name, fn in (("run", cmd_run), ("trace", cmd_trace),
                     ("prove", cmd_prove), ("verify", cmd_verify)):
        sp = sub.add_parser(name)
        sp.add_argument("guest", help="guest assembly or ELF file")
        sp.add_argument("--input", default="", help="input bytes as hex")
        sp.add_argument("--trusted-advice", dest="trusted_advice",
                        default="", help="trusted advice bytes as hex "
                        "(region sized to the next power of two)")
        sp.add_argument("--untrusted-advice", dest="untrusted_advice",
                        default="", help="untrusted advice bytes as hex")
        sp.add_argument("--io-size", type=int, default=64,
                        help="max input/output region size")
        sp.add_argument("--native", action="store_true",
                        help="use the C++ tracer")
        sp.add_argument("--pcs", choices=("none", "dory", "hyperkzg"),
                        default="none",
                        help="commitment scheme for prove/verify (none = "
                        "sumcheck-only proof; dory = production transparent "
                        "scheme)")
        sp.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda",
                        help="the device prove runs on (cuda = the card, "
                        "which must exist; cpu = the plain versions on "
                        "the host)")
        if name == "prove":
            sp.add_argument("-o", "--output", default="proof.bin")
            sp.add_argument("--zk", action="store_true",
                            help="zero-knowledge mode: BlindFold-committed "
                            "round polynomials (prove(zk=True))")
            sp.add_argument("--profile", action="store_true",
                            help="record per-stage spans + HBM watermarks; "
                            "writes <output>.profile.json")
            sp.add_argument("--trace-file", dest="trace_file",
                            help="prove a checkpointed trace (.npz from "
                            "`trace -o`) instead of re-executing the guest")
            sp.add_argument("--committed-image", dest="committed_image",
                            action="store_true",
                            help="committed-bytecode mode: the program "
                            "image's Val_init contribution is proven "
                            "against a committed image polynomial "
                            "(O(log K) verifier image work)")
        if name == "trace":
            sp.add_argument("-o", "--output", default=None,
                            help="checkpoint the trace to a .npz for "
                            "later `prove --trace-file`")
        if name == "verify":
            sp.add_argument("proof", help="canonical proof bytes from `prove`")
        sp.set_defaults(fn=fn)
    sp_sweep = sub.add_parser(
        "sweep", help="benchmark sweep: workload x size grid with "
        "run-dir JSON artifacts (profile.rs:199-330 analog)")
    sp_sweep.add_argument("--workloads", default="fib",
                          help="comma list: fib,sha2-chain,keccak-chain")
    sp_sweep.add_argument("--min-log2", type=int, default=12)
    sp_sweep.add_argument("--max-log2", type=int, default=16)
    sp_sweep.add_argument("--pcs", choices=("none", "dory", "hyperkzg"),
                          default="none")
    sp_sweep.add_argument("--out", default="runs")
    sp_sweep.add_argument("--warm", action="store_true",
                          help="one warm-up prove per point (steady state)")
    sp_sweep.add_argument("--device", choices=("cuda", "cpu"),
                          default="cuda")

    def cmd_sweep(args):
        from .eval.sweep import run_sweep
        summary = run_sweep(
            [w.strip() for w in args.workloads.split(",") if w.strip()],
            args.min_log2, args.max_log2,
            pcs=None if args.pcs == "none" else args.pcs,
            out_dir=args.out, warm=args.warm, device=args.device)
        print(json.dumps(summary))
        return 0

    sp_sweep.set_defaults(fn=cmd_sweep)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
