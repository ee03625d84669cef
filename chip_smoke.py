"""Smoke run of the torch port on one NVIDIA GPU (H100): builds the port's
CUDA kernels from this checkout, holds each against its plain PyTorch
version, drives the port's main path once at full size, and checks it.

    python3 chip_smoke.py

Phases:
  1. the card (nvidia-smi name and power limit);
  2. build K1 (`jolt_tpu_torch/csrc/mont_mul.cu`) and K2
     (`jolt_tpu_torch/csrc/product_round.cu`), one nvcc for sm_90a each, both
     at once;
  3. K1 vs `mont_mul_plain` on the card, bit for bit: seeded random inputs
     at N = 2^20, the values 0, 1 and r-1, a sample against Python ints;
  4. the round-step path (`sumcheck.product.round_step`, the counterpart of
     the JAX package's round-step entry point): 18 chained rounds from
     T = 2^18 down to 2 with seeded challenges, K2's launch count read
     around them; then every round held against `product_round_deg3_plain`
     bit for bit, K2 vs plain at T = 2^14 (the entry point's size) and
     2^18, one small case against Python ints, and K2's times and bound;
  5. the main path: the sha2-chain guest (chain=114, ~2^18 cycles) traced
     by the port's native tracer, `prove_prefix(trace, device="cuda")`
     (stages 1-5) with K1's launch count read around it, then
     `verify_prefix`; then K1 vs plain again at the largest launch shape of
     that run and at the shape with the most work (launches x elements),
     with times and bounds;
  6. card vs CPU: `prove_prefix` on the small fib trace gives identical
     proofs on "cuda" and on "cpu";
  7. one JSON line with every ported kernel, the card line, and the final
     `{"ok": true, "device": ...}` line.

Any failure raises and exits nonzero; with no CUDA device it exits 2
before printing any result.
"""

import collections
import dataclasses
import json
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 1234

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 3.35 TB/s;
# 32-bit integer multiply-adds on the CUDA cores: 132 SMs x 64 per clock x
# 1.98 GHz = 16.7 T/s (half of the 67 TFLOP/s float32 rate's FMA count)
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 132 * 64 * 1.98e9
# K1 per element: 136 32x32->64 multiplies = 272 32-bit multiply-adds
K1_MADS_PER_ELEM = 272
# K2 per pair: 3 binds + 6 products = 9 Montgomery products
K2_MADS_PER_PAIR = 9 * K1_MADS_PER_ELEM
K2_CHAIN_LOG_T = 18          # the chained round-step run: 2^18 down to 2
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


def k1_bound_ms(a_shape, b_shape):
    """Least time for one K1 call: each input read once, the output written
    once (32 B per element each), vs 272 int32 multiply-adds per element."""
    full = torch.broadcast_shapes(a_shape, b_shape)
    n = int(np.prod(full[1:]))
    n_a = int(np.prod(a_shape[1:]))
    n_b = int(np.prod(b_shape[1:]))
    bytes_ = 32 * (n_a + n_b + n)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = n * K1_MADS_PER_ELEM / INT32_MAD_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


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
    ms = cuda_ms(lambda: kernels.mont_mul(a, b), reps)
    plain_ms = cuda_ms(lambda: kernels.mont_mul_plain(a, b), 3)
    bound, by = k1_bound_ms(tuple(a.shape), tuple(b.shape))
    return ms, plain_ms, bound, by


def k2_bound_ms(T, blocks):
    """Least time for one K2 launch at T entries per factor: the three
    factors and r read once, the three bound factors (T/2 each) and the
    (blocks, 8, 3) uint64 partial sums written once, vs 9 Montgomery
    products (272 int32 multiply-adds each) per pair."""
    pairs = T // 2
    bytes_ = 32 * (3 * T + 1 + 3 * pairs) + 8 * 24 * blocks
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = pairs * K2_MADS_PER_PAIR / INT32_MAD_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def k2_error(got, want, where):
    """Max |difference| over the words of K2's four outputs vs plain; fails
    unless they are identical."""
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"K2 shape {g.shape} vs {w.shape} {where}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max()))
        check(torch.equal(g, w), f"K2 disagrees with plain {where}")
    return err


def time_k2(kernels, polys, r, reps=20):
    """K2's launch alone, the wrapper (launch + the mod-p finish of the
    block sums) and the plain version, in ms; with the bound."""
    ms = cuda_ms(lambda: kernels.launch_product_round(*polys, r), reps)
    wrapper_ms = cuda_ms(lambda: kernels.product_round_deg3(*polys, r), reps)
    plain_ms = cuda_ms(lambda: kernels.product_round_deg3_plain(*polys, r), 3)
    blocks = kernels.launch_product_round(*polys, r)[0].shape[0]
    bound, by = k2_bound_ms(polys[0].shape[-1], blocks)
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    from jolt_tpu_torch import PublicIO, prove_prefix, verify_prefix
    from jolt_tpu_torch.field import kernels, ops
    from jolt_tpu_torch.riscv.emulator import MemoryLayout
    from jolt_tpu_torch.sumcheck.product import round_step
    from jolt_tpu_torch.tracer import trace_program
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

    # ---- 3. K1 vs plain at N = 2^20, edge values, Python ints ------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    n = 1 << 20
    a = rand_field((8, n), gen, dev)
    b = rand_field((8, n), gen, dev)
    max_err = compare_k1(kernels, a, b)
    ms, plain_ms, bound, by = time_k1(kernels, a, b)
    print(f"[kernel] mont_mul N=2^20: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound:.4f} ms ({by})", flush=True)
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

    # ---- 4. round-step path: 18 chained rounds through K2 ----------------
    T = 1 << K2_CHAIN_LOG_T
    chain = [tuple(rand_field((8, T), gen, dev) for _ in range(3))]
    rs = [rand_field((8, 1), gen, dev) for _ in range(K2_CHAIN_LOG_T)]
    msgs = []
    torch.cuda.synchronize()
    kernels.mont_mul.launches = 0
    kernels.product_round_deg3.launches = 0
    t0 = time.perf_counter()
    for r in rs:
        msg, bound = round_step(chain[-1], r)
        msgs.append(msg)
        chain.append(bound)
    torch.cuda.synchronize()
    t_chain = time.perf_counter() - t0
    k2_launches = kernels.product_round_deg3.launches
    k1_round_launches = kernels.mont_mul.launches
    check(k2_launches == K2_CHAIN_LOG_T,
          f"round_step launched K2 {k2_launches} times in "
          f"{K2_CHAIN_LOG_T} rounds")
    check(chain[-1][0].shape == (8, 1), "chained run did not end at T = 1")
    k2_err = 0
    for i, r in enumerate(rs):
        want = kernels.product_round_deg3_plain(*chain[i], r)
        k2_err = max(k2_err, k2_error((msgs[i], *chain[i + 1]), want,
                                      f"in chained round {i}"))
    print(f"[path] round_step 2^{K2_CHAIN_LOG_T} -> 2: {K2_CHAIN_LOG_T} "
          f"rounds in {t_chain:.4f}s, K2 launches {k2_launches}, K1 "
          f"launches {k1_round_launches} (the mod-p finish of the sums); "
          "every round == product_round_deg3_plain bit for bit", flush=True)
    del chain, msgs
    k2_times = {}
    for log_t in (14, K2_CHAIN_LOG_T):
        polys = tuple(rand_field((8, 1 << log_t), gen, dev)
                      for _ in range(3))
        r = rand_field((8, 1), gen, dev)
        k2_err = max(k2_err, k2_error(kernels.product_round_deg3(*polys, r),
                                      kernels.product_round_deg3_plain(
                                          *polys, r), f"at T = 2^{log_t}"))
        k2_times[log_t] = t = time_k2(kernels, polys, r)
        print(f"[kernel] product_round_deg3 T=2^{log_t}: {t['ms']:.4f} ms "
              f"(wrapper {t['wrapper_ms']:.4f} ms), plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})", flush=True)
        del polys
    small = tuple(rand_field((8, 8), gen, dev) for _ in range(3))
    r = rand_field((8, 1), gen, dev)
    msg, *bound = kernels.product_round_deg3(*small, r)
    vals = [ops.unpack_ints(p) for p in small]
    rv = ops.unpack_ints(r)[0]
    def ev(v, i, x):                 # factor v's eval at X = x, pair i
        return (v[i] + x * (v[i + 4] - v[i])) % P
    want = [sum(ev(vals[0], i, x) * ev(vals[1], i, x) % P * ev(vals[2], i, x)
                for i in range(4)) % P for x in (0, 2, 3)]
    check(ops.unpack_ints(msg.reshape(8, -1)) == want,
          "K2 message disagrees with Python ints")
    check([ops.unpack_ints(b) for b in bound]
          == [[(v[i] + rv * (v[i + 4] - v[i])) % P for i in range(4)]
              for v in vals], "K2 binds disagree with Python ints")
    print("[kernel] K2 == product_round_deg3_plain bit for bit (T=2^14, "
          f"2^{K2_CHAIN_LOG_T}, every chained round); T=8 == Python ints",
          flush=True)

    # ---- 5. main path: sha2-chain through prove_prefix on the card -------
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
    kernels.product_round_deg3.launches = 0
    try:
        t0 = time.perf_counter()
        proof, stage_s, stage_lines = timed_stages(
            lambda: prove_prefix(tr, device="cuda"))
        t_prove = time.perf_counter() - t0
    finally:
        launches = kernels.mont_mul.launches
        ops.mont_mul = field_mul
    peak = torch.cuda.max_memory_allocated(dev)
    print(stage_lines, end="")
    check(launches > 0, "K1 was not launched on the main path")
    check(kernels.product_round_deg3.launches == 0,
          "K2 launched on the prefix path (it serves no live round)")
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
          f"{launches}, {len(shapes)} launch shapes; verify_prefix accepted "
          f"in {t_verify:.3f}s", flush=True)

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
              f"({shapes[(sa_shape, sb_shape)]} launches): {times[0]:.4f} ms,"
              f" plain {times[1]:.4f} ms, bound {times[2]:.4f} ms "
              f"({times[3]})", flush=True)
        del a, b
    ms, plain_ms, bound, by = main_times[largest]

    # ---- 6. card vs CPU on the fib trace ---------------------------------
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

    # ---- 7. results -------------------------------------------------------
    print(f"[total] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(card)
    k2 = k2_times[K2_CHAIN_LOG_T]
    print(json.dumps({"kernels": [{
        "name": "mont_mul", "route": "cuda",
        "source": "jolt_tpu_torch/csrc/mont_mul.cu",
        "replaces": "jolt_tpu/field/pallas_ops.py:44",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": by, "library_ms": None,
        "shape": [list(largest[0]), list(largest[1])]}, {
        "name": "product_round_deg3", "route": "cuda",
        "source": "jolt_tpu_torch/csrc/product_round.cu",
        "replaces": "jolt_tpu/field/pallas_ops.py:97",
        "launches": k2_launches, "max_abs_err": k2_err,
        **k2, "library_ms": None,
        "shape": [[8, T]] * 3 + [[8, 1]],
        "at_t14": k2_times[14]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
