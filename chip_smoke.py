"""Smoke run of the torch port on one NVIDIA GPU (H100): builds the port's
CUDA kernels from this checkout, holds each against its plain PyTorch
version, drives the port's main path once at full size, and checks it.

    python3 chip_smoke.py

Phases:
  1. the card (nvidia-smi name and power limit);
  2. build K1 (`jolt_tpu_torch/csrc/mont_mul.cu`) and K2
     (`jolt_tpu_torch/csrc/product_round.cu`), one nvcc for sm_90a each, both
     at once; ptxas's registers and spills;
  3. K1 vs `mont_mul_plain` on the card, bit for bit: seeded random inputs
     at N = 2^20, the values 0, 1 and r-1, a sample against Python ints;
  4. K2 vs `product_round_plain` on the card, bit for bit, for 2 and 3
     factors in each pass order (message then bind, message alone, bind
     then message, bind alone): seeded inputs at T = 2^14 and 2^18, the
     values 0, 1 and r-1 (factors and challenge), and T = 8 against Python
     ints; then per order at 2^18 the kernel-only times (torch.profiler) of
     the pass kernel and of the on-card finish of the message, the time of
     the wrapper that launches both (CUDA events, host cost included), and
     that of the plain version, with the bound;
  5. the round-step path (`sumcheck.product.round_step`, the counterpart of
     the JAX package's round-step entry point): 18 chained rounds from
     T = 2^18 down to 2 with seeded challenges, K2's launch count read
     around them, every round held against the plain version; then a
     chained `ProductSumcheck` of three factors at 2^18 through the batched
     engine (K2's live-round orders), every message and the final claims
     held against the plain chain;
  6. the main path: the sha2-chain guest (chain=114, ~2^18 cycles) traced
     by the port's native tracer, `prove_prefix(trace, device="cuda")`
     (stages 1-5) with K1's and K2's launch counts read around it (K2
     carries the shift sumcheck, stage 1s: log2 T + 1 calls), then
     `verify_prefix`; then K1 vs plain again at the largest launch shape of
     that run and at the shape with the most work (launches x elements),
     with times and bounds;
  7. card vs CPU: `prove_prefix` on the small fib trace gives identical
     proofs on "cuda" and on "cpu";
  8. one JSON line with every ported kernel, the card line, and the final
     `{"ok": true, "device": ...}` line.

Any failure raises and exits nonzero; with no CUDA device it exits 2
before printing any result.
"""

import collections
import dataclasses
import json
import pathlib
import re
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 1234

K2_LOG_T = 18                # K2's full size: the main path's 2^18
K2_SMALL_LOG_T = 14          # the round-step entry point's own size
PREFIX_STAGES = {"witness-extraction", "stage1-spartan", "stage1s-shift",
                 "stage2-reg-rw", "stage3-reg-val", "stage4-5-ram"}

FIB_LAYOUT = dict(max_input_size=64, max_output_size=64)
FIB = """
    li   a0, 20
    li   a1, 0
    li   a2, 1
loop:
    beq  a0, zero, done
    add  a3, a1, a2
    mv   a1, a2
    mv   a2, a3
    addi a0, a0, -1
    j    loop
done:
    li   t0, {output_start}
    sd   a1, 0(t0)
    li   t1, {termination}
    li   t2, 1
    sd   t2, 0(t1)
"""


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def rand_field(shape, gen, device):
    """Seeded random canonical-range limb tensor (8, *batch) (< p)."""
    w = torch.randint(0, 1 << 32, (8,) + tuple(shape[1:]), generator=gen,
                      device=device, dtype=torch.int64)
    w[7] %= 0x30644E72                      # top limb of p: value < p
    return (w - ((w >> 31) << 32)).to(torch.int32)


def ints_to_words(vals, device):
    """Python ints (< 2^256) -> (8, n) int32 words, little-endian."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in vals)
    w = np.frombuffer(raw, dtype="<u4").reshape(-1, 8).T
    return torch.from_numpy(np.array(w, dtype=np.uint32).view(np.int32)).to(device)


def words_to_ints(t: torch.Tensor):
    arr = t.reshape(8, -1).cpu().numpy().astype(np.uint32).T
    raw = np.ascontiguousarray(arr).astype("<u4").tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little")
            for i in range(arr.shape[0])]


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_k1(kernels, a, b):
    """K1 vs plain on the card; returns max |difference| over the words."""
    got = kernels.mont_mul(a, b)
    want = kernels.mont_mul_plain(a, b)
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"K1 shape {got.shape} vs {want.shape}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(err == 0 and torch.equal(got, want),
          f"K1 disagrees with mont_mul_plain at {tuple(a.shape)} x "
          f"{tuple(b.shape)}")
    return err


def time_k1(kernels, a, b, reps=20):
    """K1 in ms: kernel-only, with the wrapper (CUDA events over
    back-to-back calls), the plain version; the bound."""
    from jolt_tpu_torch.workload import k1_bound_ms
    ms = kernel_ms(lambda: kernels.mont_mul(a, b), ("mont_mul_kernel",),
                   reps)["mont_mul_kernel"]
    events_ms = cuda_ms(lambda: kernels.mont_mul(a, b), reps)
    plain_ms = cuda_ms(lambda: kernels.mont_mul_plain(a, b), 3)
    bound, by = k1_bound_ms(tuple(a.shape), tuple(b.shape))
    return ms, events_ms, plain_ms, bound, by


def k2_error(got, want, where):
    """Max |difference| over the words of K2's outputs (msg, bound) vs the
    plain version's; fails unless they are identical."""
    (msg, bound), (want_msg, want_bound) = got, want
    pairs = [(msg, want_msg)] if want_msg is not None else []
    check((msg is None) == (want_msg is None)
          and (bound is None) == (want_bound is None),
          f"K2 outputs {where}")
    pairs += list(zip(bound or (), want_bound or ()))
    err = 0
    for g, w in pairs:
        check(g.shape == w.shape, f"K2 shape {g.shape} vs {w.shape} {where}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max()))
        check(torch.equal(g, w), f"K2 disagrees with plain {where}")
    return err


def k2_python_ints(kernels, ops, polys, r, order):
    """K2's function on Python ints: (message evals, bound factors)."""
    P = kernels.P
    vals = [ops.unpack_ints(p) for p in polys]
    rv = ops.unpack_ints(r)[0]
    nf = len(polys)

    def bind(v):
        h = len(v) // 2
        return [(v[i] + rv * (v[i + h] - v[i])) % P for i in range(h)]

    def message(vs):
        h = len(vs[0]) // 2
        out = []
        for x in [0] + list(range(2, nf + 1)):
            total = 0
            for i in range(h):
                prod = 1
                for v in vs:
                    prod = prod * (v[i] + x * (v[i + h] - v[i])) % P
                total += prod
            out.append(total % P)
        return out

    bound = [bind(v) for v in vals] if order != "message" else None
    if order == "bind":
        return None, bound
    return message(bound if order == "bind_message" else vals), bound


def kernel_ms(fn, names, reps=20, tries=3):
    """Mean device time of each kernel whose name holds one of `names`
    (each launched once a call), kernel-only: torch.profiler over `reps`
    calls after a warm-up, so the host's cost of the calls is not in it.
    The mean is over the launches the trace holds (it may miss one of a
    run of long kernels); a trace with fewer than half is taken again."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = {name: [] for name in names}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                for name in names:
                    if name in e.name:
                        seen[name].append(e.time_range.elapsed_us())
        if all(2 * len(us) >= reps for us in seen.values()):
            return {name: sum(us) / len(us) / 1e3
                    for name, us in seen.items()}
    raise SmokeFailure(f"the profiler lost launches of {names}: "
                       f"{ {n: len(us) for n, us in seen.items()} }")


def time_k2(kernels, ops, polys, r, order):
    """K2 in ms: its pass kernel and its finish kernel alone (kernel-only
    device time), the wrapper with both as a live round calls it
    (CUDA events over back-to-back calls with r a Python int, so the
    wrapper's host cost counts), and the plain version; with the bound."""
    from jolt_tpu_torch.workload import k2_bound_ms
    r_int = ops.unpack_ints(r)[0]
    names = ("round_kernel",) + (("finish_kernel",) if order != "bind"
                                 else ())
    dev_ms = kernel_ms(lambda: kernels.product_round(polys, r_int, order),
                       names)
    wrapper = cuda_ms(lambda: kernels.product_round(polys, r_int, order), 20)
    plain = cuda_ms(lambda: kernels.product_round_plain(polys, r, order), 3)
    partial, _ = kernels.launch_product_round(polys, r_int, order,
                                              finish=False)
    blocks = 0 if partial is None else partial.shape[1]
    bound, by = k2_bound_ms(len(polys), order, polys[0].shape[-1], blocks)
    pass_ms, finish_ms = dev_ms["round_kernel"], dev_ms.get("finish_kernel",
                                                            0.0)
    return {"ms": pass_ms + finish_ms, "pass_ms": pass_ms,
            "finish_ms": finish_ms, "wrapper_ms": wrapper,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "blocks": blocks}


def spill_bytes(report):
    """Sum of ptxas's spill stores and loads over a build report."""
    return sum(int(n) for n in re.findall(r"(\d+) bytes spill", report))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    from jolt_tpu_torch import PublicIO, prove_prefix, verify_prefix
    from jolt_tpu_torch.field import kernels, ops
    from jolt_tpu_torch.riscv.emulator import MemoryLayout
    from jolt_tpu_torch.sumcheck.engine import (BatchedSumcheck,
                                                OpeningAccumulator)
    from jolt_tpu_torch.sumcheck.product import (ProductSumcheck,
                                                 VerifierProductSumcheck,
                                                 round_step)
    from jolt_tpu_torch.tracer import trace_program
    from jolt_tpu_torch.transcript import Blake2bTranscript
    from jolt_tpu_torch.workload import (SHA2_CHAIN, card_line,
                                         sha2_chain_trace, timed_stages)

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # ---- 1. the card ----------------------------------------------------
    card = card_line()
    print(f"[card] {card}  torch {torch.__version__} cuda {torch.version.cuda}"
          f"  {torch.cuda.get_device_name(0)}", flush=True)

    # ---- 2. build K1 and K2 ---------------------------------------------
    t0 = time.perf_counter()
    reports = kernels.build()
    print(f"[build] K1 and K2 built in {time.perf_counter() - t0:.2f}s",
          flush=True)
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    k2_spills = spill_bytes(reports["K2"])
    print(f"[build] K2 spill bytes (stores + loads, all kernels): "
          f"{k2_spills}", flush=True)

    # ---- 3. K1 vs plain at N = 2^20, edge values, Python ints ------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    n = 1 << 20
    a = rand_field((8, n), gen, dev)
    b = rand_field((8, n), gen, dev)
    max_err = compare_k1(kernels, a, b)
    ms, events_ms, plain_ms, bound, by = time_k1(kernels, a, b)
    print(f"[kernel] mont_mul N=2^20: {ms:.4f} ms (with the wrapper "
          f"{events_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by})", flush=True)
    P = kernels.P
    edge = [0, 1, P - 1]
    ea = [x for x in edge for _ in edge]
    eb = [y for _ in edge for y in edge]
    ew_a, ew_b = ints_to_words(ea, dev), ints_to_words(eb, dev)
    max_err = max(max_err, compare_k1(kernels, ew_a, ew_b))
    r_inv = pow(1 << 256, -1, P)
    got = words_to_ints(kernels.mont_mul(ew_a, ew_b))
    want = [x * y * r_inv % P for x, y in zip(ea, eb)]
    check(got == want, "K1 wrong on 0, 1, r-1")
    idx = torch.randint(0, n, (512,), generator=gen, device=dev)
    sa, sb = a[:, idx], b[:, idx]
    got = words_to_ints(kernels.mont_mul(sa, sb))
    want = [x * y * r_inv % P
            for x, y in zip(words_to_ints(sa), words_to_ints(sb))]
    check(got == want, "K1 disagrees with Python ints")
    print("[kernel] K1 == mont_mul_plain bit for bit (N=2^20, 0/1/r-1); "
          "sample == Python ints", flush=True)
    del a, b

    # ---- 4. K2 vs plain: 2 and 3 factors, every order --------------------
    k2_err = 0
    k2_times = {}
    for nf in (2, 3):
        for order in kernels.ORDERS:
            tag = f"nf={nf} {order}"
            for log_t in (K2_SMALL_LOG_T, K2_LOG_T):
                polys = tuple(rand_field((8, 1 << log_t), gen, dev)
                              for _ in range(nf))
                r = rand_field((8, 1), gen, dev)
                k2_err = max(k2_err, k2_error(
                    kernels.product_round(polys, r, order),
                    kernels.product_round_plain(polys, r, order),
                    f"({tag}, T = 2^{log_t})"))
            # pass alone, pass + finish, plain at 2^18 (the last inputs)
            k2_times[(nf, order)] = t = time_k2(kernels, ops, polys, r, order)
            print(f"[kernel] product_round {tag} T=2^{K2_LOG_T}: pass "
                  f"{t['pass_ms']:.4f} ms + finish {t['finish_ms']:.4f} ms "
                  f"(kernel-only), wrapper {t['wrapper_ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']}), {t['blocks']} blocks", flush=True)
            del polys
            # 0, 1 and r-1 in every factor and as the challenge
            vals = torch.randint(0, 3, (nf, 1 << 10), generator=gen,
                                 device=dev)
            polys = tuple(ints_to_words([edge[int(v)] for v in row], dev)
                          for row in vals.tolist())
            for x in edge:
                r = ints_to_words([x], dev)
                k2_err = max(k2_err, k2_error(
                    kernels.product_round(polys, r, order),
                    kernels.product_round_plain(polys, r, order),
                    f"({tag}, 0/1/r-1, r = {x % 1000})"))
            small = tuple(rand_field((8, 8), gen, dev) for _ in range(nf))
            r = rand_field((8, 1), gen, dev)
            msg, bound = kernels.product_round(small, r, order)
            want_msg, want_bound = k2_python_ints(kernels, ops, small, r,
                                                  order)
            check((msg is None and want_msg is None)
                  or ops.unpack_ints(msg.reshape(8, -1)) == want_msg,
                  f"K2 message disagrees with Python ints ({tag})")
            check((bound is None and want_bound is None)
                  or [ops.unpack_ints(b) for b in bound] == want_bound,
                  f"K2 binds disagree with Python ints ({tag})")
    # the round-step entry point's size, where launch latency rules
    polys = tuple(rand_field((8, 1 << K2_SMALL_LOG_T), gen, dev)
                  for _ in range(3))
    r = rand_field((8, 1), gen, dev)
    k2_small = time_k2(kernels, ops, polys, r, "message_bind")
    print(f"[kernel] product_round nf=3 message_bind T=2^{K2_SMALL_LOG_T}: "
          f"pass {k2_small['pass_ms']:.4f} ms + finish "
          f"{k2_small['finish_ms']:.4f} ms (kernel-only), wrapper "
          f"{k2_small['wrapper_ms']:.4f} ms, plain "
          f"{k2_small['plain_ms']:.4f} ms, bound {k2_small['bound_ms']:.4f} "
          f"ms, {k2_small['blocks']} blocks", flush=True)
    print(f"[kernel] K2 == product_round_plain bit for bit (2 and 3 factors, "
          f"every order, T=2^{K2_SMALL_LOG_T} and 2^{K2_LOG_T}, 0/1/r-1); "
          "T=8 == Python ints", flush=True)

    # ---- 5. round-step path and a chained ProductSumcheck ----------------
    T = 1 << K2_LOG_T
    chain = [tuple(rand_field((8, T), gen, dev) for _ in range(3))]
    rs = [rand_field((8, 1), gen, dev) for _ in range(K2_LOG_T)]
    msgs = []
    torch.cuda.synchronize()
    kernels.mont_mul.launches = 0
    kernels.product_round.launches = 0
    t0 = time.perf_counter()
    for r in rs:
        msg, bound = round_step(chain[-1], r)
        msgs.append(msg)
        chain.append(bound)
    torch.cuda.synchronize()
    t_chain = time.perf_counter() - t0
    k2_round_launches = kernels.product_round.launches
    k1_round_launches = kernels.mont_mul.launches
    check(k2_round_launches == K2_LOG_T,
          f"round_step launched K2 {k2_round_launches} times in "
          f"{K2_LOG_T} rounds")
    check(chain[-1][0].shape == (8, 1), "chained run did not end at T = 1")
    for i, r in enumerate(rs):
        want = kernels.product_round_plain(chain[i], r, "message_bind")
        k2_err = max(k2_err, k2_error((msgs[i], chain[i + 1]), want,
                                      f"in chained round {i}"))
    print(f"[path] round_step 2^{K2_LOG_T} -> 2: {K2_LOG_T} rounds in "
          f"{t_chain:.4f}s, K2 launches {k2_round_launches}, K1 launches "
          f"{k1_round_launches}; every round == product_round_plain bit for "
          "bit", flush=True)
    del chain, msgs

    factors = [rand_field((8, T), gen, dev) for _ in range(3)]
    inst = ProductSumcheck(factors)
    card_msgs = []
    live_message = inst.message_evals_dev
    inst.message_evals_dev = lambda rnd: card_msgs.append(
        live_message(rnd)) or card_msgs[-1]
    torch.cuda.synchronize()
    kernels.product_round.launches = 0
    t0 = time.perf_counter()
    proof, r_sc = BatchedSumcheck.prove([inst], OpeningAccumulator(),
                                        Blake2bTranscript(b"chip_smoke"))
    t_sumcheck = time.perf_counter() - t0
    k2_sumcheck_launches = kernels.product_round.launches
    check(k2_sumcheck_launches == K2_LOG_T + 1,
          f"ProductSumcheck launched K2 {k2_sumcheck_launches} times in "
          f"{K2_LOG_T} rounds (want {K2_LOG_T + 1})")
    polys, plain_msgs = tuple(factors), []
    for j, rj in enumerate([None] + r_sc):
        order = ("message" if j == 0 else "bind" if j == K2_LOG_T
                 else "bind_message")
        msg, bound = kernels.product_round_plain(polys, rj, order)
        polys = bound or polys
        if msg is not None:
            plain_msgs.append(msg)
    check(len(card_msgs) == len(plain_msgs) == K2_LOG_T
          and all(torch.equal(c, w) for c, w in zip(card_msgs, plain_msgs)),
          "chained ProductSumcheck messages differ from the plain chain")
    check(inst.final_claims == [ops.unpack_ints(p)[0] for p in polys],
          "chained ProductSumcheck final claims differ from the plain chain")
    check(BatchedSumcheck.verify(
        proof, [VerifierProductSumcheck(K2_LOG_T, inst.input_claim(None),
                                        inst.final_claims)],
        OpeningAccumulator(), Blake2bTranscript(b"chip_smoke")) == r_sc,
        "the chained ProductSumcheck did not verify")
    print(f"[path] ProductSumcheck 3 x 2^{K2_LOG_T}: {K2_LOG_T} rounds in "
          f"{t_sumcheck:.4f}s, K2 launches {k2_sumcheck_launches}; every "
          "message and the final claims == the plain chain; verified",
          flush=True)
    del factors, inst, card_msgs, plain_msgs, polys

    # ---- 6. main path: sha2-chain through prove_prefix on the card -------
    t0 = time.perf_counter()
    tr = sha2_chain_trace()          # raises if the chain's output is wrong
    t_trace = time.perf_counter() - t0
    print(f"[path] sha2-chain chain={SHA2_CHAIN}: {tr.length} cycles, "
          f"padded {tr.padded_length}, traced in {t_trace:.2f}s", flush=True)

    # record the shape of every Montgomery product of the path: all of the
    # port's code multiplies through ops.mont_mul, which calls K1's wrapper
    shapes = collections.Counter()
    field_mul = ops.mont_mul

    def recording(a, b):
        shapes[(tuple(a.shape), tuple(b.shape))] += 1
        return field_mul(a, b)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.mont_mul = recording
    kernels.mont_mul.launches = 0
    kernels.product_round.launches = 0
    try:
        t0 = time.perf_counter()
        proof, stage_s, stage_lines = timed_stages(
            lambda: prove_prefix(tr, device="cuda"))
        t_prove = time.perf_counter() - t0
    finally:
        launches = kernels.mont_mul.launches
        k2_launches = kernels.product_round.launches
        ops.mont_mul = field_mul
    peak = torch.cuda.max_memory_allocated(dev)
    print(stage_lines, end="")
    log_t = tr.padded_length.bit_length() - 1
    check(launches > 0, "K1 was not launched on the main path")
    # stage 1s: the first message, log T - 1 bind + message passes, the
    # last bind
    check(k2_launches == log_t + 1,
          f"K2 launched {k2_launches} times on the prefix path (want "
          f"{log_t + 1}: the shift sumcheck's {log_t} rounds)")
    check(set(stage_s) == PREFIX_STAGES, f"stage lines: {stage_s}")
    check([e["stage"] for e in proof.fs_tape]
          == [k for k in stage_s if k != "witness-extraction"],
          f"FS tape: {proof.fs_tape}")
    t0 = time.perf_counter()
    ok = verify_prefix(proof, PublicIO.from_trace(tr))
    t_verify = time.perf_counter() - t0
    check(ok is True, "verify_prefix did not accept")
    print(f"[path] prove_prefix {t_prove:.3f}s ("
          + ", ".join(f"{k} {v:.3f}s" for k, v in stage_s.items())
          + f"), peak allocated {peak / 2**30:.3f} GiB, K1 launches "
          f"{launches}, {len(shapes)} launch shapes, K2 launches "
          f"{k2_launches} (stage 1s, {log_t} rounds); verify_prefix "
          f"accepted in {t_verify:.3f}s", flush=True)

    # K1 vs plain at the main path's largest shape and its heaviest one
    def numel(sh):
        return int(np.prod(torch.broadcast_shapes(*sh)[1:]))
    largest = max(shapes, key=numel)
    heaviest = max(shapes, key=lambda s: shapes[s] * numel(s))
    main_times = {}
    for tag, (sa_shape, sb_shape) in (("largest", largest),
                                      ("most work", heaviest)):
        if (sa_shape, sb_shape) in main_times:
            continue
        a = rand_field(sa_shape, gen, dev)
        b = rand_field(sb_shape, gen, dev)
        max_err = max(max_err, compare_k1(kernels, a, b))
        times = time_k1(kernels, a, b)
        main_times[(sa_shape, sb_shape)] = times
        print(f"[kernel] mont_mul {tag} path shape {sa_shape} x {sb_shape} "
              f"({shapes[(sa_shape, sb_shape)]} launches): {times[0]:.4f} ms "
              f"(with the wrapper {times[1]:.4f} ms), plain {times[2]:.4f} "
              f"ms, bound {times[3]:.4f} ms ({times[4]})", flush=True)
        del a, b
    ms, events_ms, plain_ms, bound, by = main_times[largest]

    # ---- 7. card vs CPU on the fib trace ---------------------------------
    fib_layout = MemoryLayout(**FIB_LAYOUT)
    fib = trace_program(FIB.format(output_start=fib_layout.output_start,
                                   termination=fib_layout.termination),
                        layout=fib_layout)
    on_card = prove_prefix(fib, device="cuda")
    on_cpu = prove_prefix(fib, device="cpu")
    check(dataclasses.asdict(on_card) == dataclasses.asdict(on_cpu),
          "prove_prefix differs between cuda and cpu on the fib trace")
    check(verify_prefix(on_card, PublicIO.from_trace(fib)) is True,
          "verify_prefix rejected the fib proof")
    print(f"[card-vs-cpu] fib ({fib.length} cycles): identical PrefixProof; "
          f"states {[e['state'][:16] for e in on_card.fs_tape]}", flush=True)

    # ---- 8. results -------------------------------------------------------
    print(f"[total] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(card)
    # K2's headline: the main path's round (stage 1s: two factors, bind then
    # message) at 2^18; "ms" is its two kernels' device time
    k2 = k2_times[(2, "bind_message")]
    print(json.dumps({"kernels": [{
        "name": "mont_mul", "route": "cuda",
        "source": "jolt_tpu_torch/csrc/mont_mul.cu",
        "replaces": "jolt_tpu/field/pallas_ops.py:44",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "wrapper_ms": events_ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "shape": [list(largest[0]), list(largest[1])]}, {
        "name": "product_round", "route": "cuda",
        "source": "jolt_tpu_torch/csrc/product_round.cu",
        "replaces": "jolt_tpu/field/pallas_ops.py:97",
        "launches": k2_launches, "max_abs_err": k2_err,
        "ms": k2["ms"], "wrapper_ms": k2["wrapper_ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None, "shape": [[8, T]] * 2 + [[8, 1]],
        "order": "bind_message", "spill_bytes": k2_spills,
        "modes": [{"nf": nf, "order": order, **t}
                  for (nf, order), t in k2_times.items()],
        "message_bind_small": k2_small,
        "round_step_launches": k2_round_launches,
        "product_sumcheck_launches": k2_sumcheck_launches}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
