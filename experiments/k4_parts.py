"""K4 (the round tail, `jolt_tpu_torch/csrc/transcript.cu`) on the card, by
part: where a launch's time goes, the dependent-chain floor, and the
one-warp K4 (commit c3a2d92, its design before this one) against this
tree's at the round shapes of the device tier.  On a machine with one
NVIDIA GPU:

    mkdir -p _checkout/parent
    git archive c3a2d92 jolt_tpu_torch/csrc | tar -x -C _checkout/parent
    python3 experiments/k4_parts.py --old _checkout/parent \\
        --out k4_parts.json

`--old TREE` names an unpacked tree of the one-warp K4 (its layout is
`OldTail` here); without it only this tree's kernel is measured.  What is
measured, each in CUDA cycles (clock64) or ms:

  * the parts of one launch, from clock64 stamps (`k4_parts.cu`): this
    tree's kernel through its `K4_STAMP` hooks, the one-warp K4 through a
    stamped copy of its body -- the global reads, the field work, each
    compression, the canonical conversions, the challenge and the claims;
  * the launch's own cost: an empty kernel that takes the launch record,
    kernel-only (torch.profiler) and back to back (CUDA events);
  * micro-kernels on one warp: a dependent ALU chain (cycles an
    instruction), a chain of Montgomery products (cycles a product) and of
    transcript compressions -- unrolled on one lane, on four lanes with
    the rounds a loop, and this tree's `compress` (four lanes, unrolled)
    or the one-warp K4's `step` -- each cycles a compression with its code warm,
    held equal to each other;
  * K4 kernel-only and through its wrapper at the shapes of `SHAPES`,
    the one-warp K4 (built from TREE, launched by a copy of its wrapper)
    and this tree's in turns: old, new, new, old;
  * the dependent-chain floor of each shape (`chain_floor`).

It prints one line a measurement and writes all of it as JSON to FILE.
`chip_smoke.py` (phase 4b) calls `compare`, `by_part` and `chain_floor`.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from jolt_tpu_torch.field import kernels  # noqa: E402
from jolt_tpu_torch.transcript import device as dt  # noqa: E402

HARNESS = ROOT / "experiments" / "k4_parts.cu"
BUILD = ROOT / "jolt_tpu_torch" / "_build" / "k4_parts"
SLOTS = 64

# (name, degrees of the instances, all active): stage 1's round (one
# instance of degree 3), stage 1s's (degree 2), and the batched stages the
# device tier takes next -- s4 and s5 (2 of degree 3), s7 (8 of degrees
# 2-3), s8 (33 of degree 2) -- and K4's limit (64 of degree 3)
SHAPES = (("s1", (3,)), ("s1s", (2,)), ("2x3", (3, 3)),
          ("8x2-3", (2, 3) * 4), ("33x2", (2,) * 33), ("64x3", (3,) * 64))

# K4's stamp slots (the `K4_STAMP` hooks of transcript.cu): slots < 32 are
# stamped by the transcript warp, >= 32 by warp 0 (instance 0's lane)
NEW_SLOTS = {
    0: "entry", 1: "state loaded", 2: "label absorbed",
    3: "coefficients ready", 4: "coefficients absorbed", 5: "squeezed",
    6: "challenge written",
    32: "entry", 33: "evals loaded", 34: "scaled", 35: "summed",
    36: "challenge read", 37: "claims written"}


class OldTail(ctypes.Structure):
    """The one-warp K4's launch record (its `Tail`)."""
    _fields_ = [("evals", ctypes.c_uint64 * 64),
                ("degree", ctypes.c_int32 * 64),
                ("n_inst", ctypes.c_int32), ("n_c", ctypes.c_int32),
                ("width", ctypes.c_int32), ("round", ctypes.c_int32),
                ("state", ctypes.c_uint64), ("claims", ctypes.c_uint64),
                ("coeffs", ctypes.c_uint64), ("comp", ctypes.c_uint64),
                ("r", ctypes.c_uint64),
                ("label", ctypes.c_uint32 * 8),
                ("inv2", ctypes.c_uint32 * 8),
                ("inv6", ctypes.c_uint32 * 8)]


def build(source: pathlib.Path, old: bool, kernel_only: bool = False):
    """Compile `k4_parts.cu` around `source` (or, with `kernel_only`, the
    kernel's source alone: the one-warp K4 as it shipped) into _build/;
    returns (the library, ptxas's report)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    tag = ("old" if old else "new") + ("_k4" if kernel_only else "")
    so = BUILD / f"libk4_{tag}.so"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    if kernel_only:
        cmd = [kernels._nvcc()] + flags + ["-o", str(so), str(source)]
    else:
        cmd = ([kernels._nvcc()] + flags
               + [f'-DK4_SOURCE="{source.resolve()}"']
               + (["-DK4_OLD"] if old else [])
               + ["-o", str(so), str(HARNESS)])
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    P = ctypes.c_void_p
    lib.jolt_k4.argtypes = [P, P]
    lib.jolt_k4.restype = ctypes.c_int
    if not kernel_only:
        for fn, args in (("k4p_empty", [P, P]),
                         ("k4p_micro", [ctypes.c_int, ctypes.c_int, P, P, P]),
                         ("k4p_stamps", [P])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        if old:
            lib.k4p_old_stamped.argtypes = [P, P]
            lib.k4p_old_stamped.restype = ctypes.c_int
    return lib, res.stderr


def _rc(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


# ---------------------------------------------------------------------------
# the one-warp K4's record and wrapper
# ---------------------------------------------------------------------------

def old_record(evals, degrees, bufs, rnd, n_c) -> OldTail:
    """The one-warp K4's record, filled as its wrapper filled it every
    round."""
    tail = OldTail()
    for i, (e, d) in enumerate(zip(evals, degrees)):
        tail.degree[i] = d
        if e is not None:
            tail.evals[i] = e.contiguous().data_ptr()
    tail.n_inst, tail.n_c, tail.width, tail.round = (
        len(evals), n_c, bufs.comp.shape[1], rnd)
    tail.state, tail.claims, tail.coeffs, tail.comp, tail.r = (
        t.data_ptr() for t in (bufs.state, bufs.claims, bufs.coeffs,
                               bufs.comp, bufs.r))
    tail.label = (ctypes.c_uint32 * 8)(*dt.label_payload_words(
        dt.SUMCHECK_POLY, n_c).reshape(8).tolist())
    tail.inv2 = kernels._mont_words(dt.INV2)
    tail.inv6 = kernels._mont_words(dt.INV6)
    return tail


def old_round_tail(lib):
    """A round_tail(evals, degrees, bufs, rnd, n_c) that launches the
    one-warp K4 in `lib` as its wrapper did (the checks, a fresh record, the
    launch on the current stream under the card's device guard)."""
    def tail(evals, degrees, bufs, rnd, n_c):
        dt._check_round(evals, degrees, bufs, rnd, n_c)
        rec = old_record(evals, degrees, bufs, rnd, n_c)
        with torch.cuda.device(bufs.device):
            _rc(lib.jolt_k4(ctypes.byref(rec), _stream(bufs.device)),
                "one-warp K4")
    return tail


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def kernel_only_ms(fn, name, reps=30, tries=4):
    """Mean device time of the kernels named `name` over `reps` calls of
    fn() (torch.profiler, after a warm-up).  A trace that holds fewer than
    half of the launches is taken again; after `tries` the mean is over the
    launches all the traces held, if they hold at least 3, and else
    `queued_ms` times the calls (fn launches that one kernel and nothing
    else); each way is said in a line."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pooled = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and name in e.name]
        if 2 * len(us) >= reps:
            return sum(us) / len(us) / 1e3
        pooled += us
    if len(pooled) >= 3:
        print(f"[timing] the profiler kept {len(pooled)} of {tries * reps} "
              f"launches of {name} in {tries} traces; the mean is over "
              "those", flush=True)
        return sum(pooled) / len(pooled) / 1e3
    ms = queued_ms(fn, reps)
    print(f"[timing] the profiler kept {len(pooled)} of {tries * reps} "
          f"launches of {name} in {tries} traces; timed instead by CUDA "
          f"events over {reps} calls queued behind a sleep kernel",
          flush=True)
    return ms


def queued_ms(fn, reps=30):
    """Mean device ms a call of fn() over `reps` calls queued behind a
    sleep kernel (CUDA events, after a warm-up): the host enqueues every
    call while the card sleeps, so the calls run back to back and the
    host's cost of a call is not in the time.  The sleep doubles until the
    last call is enqueued before it ends; fn must not wait for the card."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 1 << 24
    for _ in range(8):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 2
    raise RuntimeError(f"{reps} calls outlasted a sleep of {cycles // 2} "
                       "cycles")


def events_ms(fn, reps=100):
    """Mean ms a call over `reps` back-to-back calls (CUDA events, after a
    warm-up): the host's cost of a call counts when it exceeds the
    kernel's."""
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


# ---------------------------------------------------------------------------
# a shape's round
# ---------------------------------------------------------------------------

def shape_case(degrees, dev, seed=0, rounds=256):
    """Seeded inputs of one round at `degrees` (every instance active):
    (evals, degrees, a factory of fresh stage buffers, n_c)."""
    rng = np.random.default_rng(seed)
    n = len(degrees)

    def ints(k):
        w = rng.integers(0, 1 << 63, size=(k, 4), dtype=np.uint64)
        return [int(sum(int(x) << (64 * i) for i, x in enumerate(row)))
                % kernels.P for row in w]
    from jolt_tpu_torch.field import ops
    evals = [ops.pack_ints_host(ints(d), dev).reshape(8, d, 1).contiguous()
             for d in degrees]
    claims, coeffs = ints(n), ints(n)
    state = bytes(rng.integers(0, 256, 32, dtype=np.uint8))

    def fresh():
        return dt.stage_buffers(dev, state, 7, claims, coeffs, rounds,
                                max(degrees))
    return evals, list(degrees), fresh, dt.compressed_len([True] * n,
                                                          list(degrees))


def time_shape(tail, degrees, dev, rounds=256):
    """`tail` (a round_tail) at `degrees`: kernel-only ms a launch
    (`kernel_only_ms`), ms a launch queued behind a sleep kernel
    (`queued_ms`, a check on the first that needs no profiler) and the
    wrapper's ms a launch back to back."""
    evals, degs, fresh, n_c = shape_case(degrees, dev, rounds=rounds)
    bufs, step = fresh(), itertools.count()

    def one():
        tail(evals, degs, bufs, next(step) % rounds, n_c)
    return {"ms": kernel_only_ms(one, "k4_round_tail"),
            "queued_ms": queued_ms(one), "wrapper_ms": events_ms(one)}


def compare(old_lib, dev, shapes=SHAPES):
    """The one-warp K4 (`old_lib`, through its wrapper's copy) and this
    tree's (`dt.round_tail`) at each shape, in turns old, new, new, old:
    {name: {"old": [t, t], "new": [t, t]}} with t as `time_shape`."""
    out = {}
    old = old_round_tail(old_lib)
    for name, degrees in shapes:
        row = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            row[who].append(time_shape(old if who == "old"
                                       else dt.round_tail, degrees, dev))
        out[name] = row
    return out


# ---------------------------------------------------------------------------
# by part
# ---------------------------------------------------------------------------

def _stamps(lib):
    host = (ctypes.c_longlong * SLOTS)()
    _rc(lib.k4p_stamps(host), "stamps")
    return list(host)


def clock_mhz(lib, dev):
    """The SM clock under a spin of dependent ALU steps (globaltimer ns
    against clock64 cycles)."""
    out = torch.zeros(4, dtype=torch.int64, device=dev)
    _rc(lib.k4p_micro(12, 1 << 22, None, ctypes.c_void_p(out.data_ptr()),
                      _stream(dev)), "clock spin")
    ns, cyc = out[:2].tolist()
    return cyc / ns * 1e3


def micro(lib, dev, old: bool):
    """Cycles a dependent ALU instruction, a Montgomery product and a
    transcript compression (one lane, four lanes with the rounds a loop,
    K4's own `compress` or the one-warp K4's `step`), each
    from a chain; the compressions' final states must agree."""
    s = _stream(dev)
    rng = np.random.default_rng(3)
    res = {}
    # 64-bit words: state, payload, n_rounds
    seed = rng.integers(0, 1 << 62, 9, dtype=np.int64)
    seed[8] = 5
    inp = torch.from_numpy(seed).to(dev)
    finals = {}
    n = 64
    for which, key in ((1, "compress_1lane"), (3, "compress_4lanes_rolled"),
                       (0, "compress_pr13_step"), (2, "compress_k4")):
        if (which == 0) != old and which in (0, 2):
            continue
        out = torch.zeros(8, dtype=torch.int64, device=dev)
        for _ in range(2):                   # the second run is warm
            _rc(lib.k4p_micro(which, n, ctypes.c_void_p(inp.data_ptr()),
                              ctypes.c_void_p(out.data_ptr()), s), key)
        torch.cuda.synchronize()
        vals = out.tolist()
        finals[key] = vals[:4]
        res[key] = vals[4] / n
    res["agree"] = len({tuple(v) for v in finals.values()}) == 1
    words = torch.from_numpy(rng.integers(0, 1 << 31, 16, dtype=np.int64)
                             .astype(np.int32)).to(dev)
    words[7] = 0x1000
    words[15] = 0x1000
    for which, key, n in ((10, "mont_mul8", 256), (11, "alu_op", 1 << 14)):
        out = torch.zeros(10, dtype=torch.int32, device=dev)
        for _ in range(2):
            _rc(lib.k4p_micro(which, n, ctypes.c_void_p(words.data_ptr()),
                              ctypes.c_void_p(out.data_ptr()), s), key)
        torch.cuda.synchronize()
        lo, hi = (int(x) & 0xFFFFFFFF for x in out[8:10].tolist())
        res[key] = ((hi << 32) | lo) / (n * (2 if which == 11 else 1))
    return res


def launch_cost(lib, dev, record_type):
    """An empty kernel that takes K4's launch record (`record_type`):
    kernel-only ms and ms a launch back to back."""
    rec = record_type()

    def one():
        _rc(lib.k4p_empty(ctypes.byref(rec), _stream(dev)), "empty")
    return {"ms": kernel_only_ms(one, "mb_empty"), "per_launch_ms":
            events_ms(one, 500)}


def by_part_old(lib, dev, degrees):
    """The one-warp K4's stamped copy on one round at `degrees`: cycles
    of each part on lane 0 (instance 0's and the transcript's)."""
    evals, degs, fresh, n_c = shape_case(degrees, dev)
    bufs = fresh()
    rec = old_record(evals, degs, bufs, 0, n_c)
    for _ in range(2):                        # the second launch is warm
        _stamps(lib)
        _rc(lib.k4p_old_stamped(ctypes.byref(rec), _stream(dev)), "stamped")
        torch.cuda.synchronize()
    st = _stamps(lib)
    c = [st[k] - st[0] for k in range(16)]
    compress = (c[5] - c[4]) + sum(c[7 + 2 * k] - c[6 + 2 * k]
                                   for k in range(n_c)) \
        + (c[12] - c[7 + 2 * (n_c - 1)])
    canon = sum(c[6 + 2 * k] - (c[5] if k == 0 else c[5 + 2 * k])
                for k in range(n_c))
    parts = {"global reads (claim, evals)": c[1],
             "recovery": c[2] - c[1], "scaling": c[3] - c[2],
             "lane 0's second instance": c[15] - c[3],
             "batched sum (lane 0, serial)": c[4] - c[15],
             "compressions": compress, "canonical conversions": canon,
             "challenge + writes": c[13] - c[12],
             "Horner + claim writes": c[14] - c[13]}
    return {"cycles": c[14], "ns": st[SLOTS - 3] - st[SLOTS - 2],
            "n_c": n_c, "parts": parts}


def by_part(lib, dev, degrees, record):
    """This tree's kernel (stamped) on one round at `degrees`: cycles from
    entry at each `NEW_SLOTS` stamp.  `record(evals, degrees, bufs, rnd,
    n_c)` fills the kernel's launch record."""
    evals, degs, fresh, n_c = shape_case(degrees, dev)
    bufs = fresh()
    rec = record(evals, degs, bufs, 0, n_c)
    for _ in range(2):
        _stamps(lib)
        _rc(lib.jolt_k4(ctypes.byref(rec), _stream(dev)), "stamped")
        torch.cuda.synchronize()
    st = _stamps(lib)
    t0 = min(st[0], st[32])
    return {"n_c": n_c, "cycles": {f"{k} {name}": st[k] - t0
                                   for k, name in NEW_SLOTS.items()}}


def chain_floor(degrees, n_c, lat, launch_ms, mhz):
    """The dependent-chain floor of one round at `degrees`, in ms, from the
    code: the transcript's 2 + n_c compressions at 12 rounds x 2
    half-rounds x 15 dependent instructions (a G function on 32-bit
    halves: a 3-input add with carry 2 deep, then xor + rotation 2 deep,
    four times) at the measured ALU latency, the quad's shuffles not
    counted; the Fr products left on the chain at the measured product
    latency: none before the label absorb ends (the field work runs
    beside it), after the squeeze two (r, r^2, r^3 to Montgomery form on
    four lanes at once, then each lane's term of its claim); and one
    launch (an empty kernel's kernel-only time).  `warm_ms` counts each
    compression at the measured cycles of K4's own `compress` with its
    code warm instead."""
    compress = (2 + n_c) * 12 * 2 * 15 * lat["alu_op"]
    after = 2 * lat["mont_mul8"]
    warm = (2 + n_c) * (lat["compress_k4"] if "compress_k4" in lat
                        else lat["compress_pr13_step"])
    return {"degrees": list(degrees), "compress_cycles": compress,
            "product_cycles": after, "launch_ms": launch_ms,
            "ms": (compress + after) / mhz / 1e3 + launch_ms,
            "warm_ms": (warm + after) / mhz / 1e3 + launch_ms}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=pathlib.Path, default=None,
                    help="an unpacked tree of the one-warp K4")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_parts: no CUDA device", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda", 0)
    from jolt_tpu_torch.workload import card_line
    res = {"card": card_line(), "device": torch.cuda.get_device_name(0)}
    print(f"[card] {res['card']}", flush=True)
    src = ROOT / "jolt_tpu_torch" / "csrc" / "transcript.cu"
    old_src = None if args.old is None else (
        args.old / "jolt_tpu_torch" / "csrc" / "transcript.cu")
    # the harness around the one-warp K4 (stamped copy, its `step`)
    if old_src is not None:
        old_h, rep = build(old_src, old=True)
        old_k4, rep_k4 = build(old_src, old=True, kernel_only=True)
        res["old_ptxas"] = [ln.strip() for ln in rep_k4.splitlines()
                            if "registers" in ln or "stack" in ln]
        print("[old] ptxas: " + " | ".join(res["old_ptxas"]), flush=True)
        res["mhz"] = clock_mhz(old_h, dev)
        res["old_micro"] = micro(old_h, dev, old=True)
        print(f"[micro] SM clock {res['mhz']:.0f} MHz; cycles: "
              + ", ".join(f"{k} {v:.1f}" for k, v in
                          res["old_micro"].items() if k != "agree"), flush=True)
        res["old_launch"] = launch_cost(old_h, dev, OldTail)
        print(f"[launch] empty kernel with the one-warp K4's record: "
              f"{res['old_launch']['ms']:.5f} ms kernel-only, "
              f"{res['old_launch']['per_launch_ms']:.5f} ms a launch back "
              "to back", flush=True)
        res["old_parts"] = {}
        for name, degrees in SHAPES:
            part = by_part_old(old_h, dev, degrees)
            res["old_parts"][name] = part
            print(f"[parts] one-warp K4 at {name} (n_c {part['n_c']}): "
                  f"{part['cycles']} cycles, {part['ns']} ns (globaltimer): "
                  + ", ".join(f"{k} {v}" for k, v in part["parts"].items()),
                  flush=True)
    if src.read_bytes() != (old_src.read_bytes() if old_src else b""):
        new_h, rep = build(src, old=False)
        res["mhz"] = clock_mhz(new_h, dev)
        res["new_micro"] = micro(new_h, dev, old=False)
        res["new_launch"] = launch_cost(new_h, dev, kernels.RoundTail)
        print(f"[micro] SM clock {res['mhz']:.0f} MHz; cycles: "
              + ", ".join(f"{k} {v:.1f}" for k, v in
                          res["new_micro"].items() if k != "agree")
              + f"; empty launch {res['new_launch']['ms']:.5f} ms "
              f"kernel-only, {res['new_launch']['per_launch_ms']:.5f} ms "
              "back to back", flush=True)
        res["new_parts"] = {}
        for name, degrees in SHAPES:
            part = by_part(new_h, dev, degrees, dt.tail_record)
            res["new_parts"][name] = part
            print(f"[parts] K4 at {name} (n_c {part['n_c']}), cycles from "
                  "entry: " + ", ".join(f"{k} {v}" for k, v in
                                        part["cycles"].items()), flush=True)
    if old_src is not None:
        res["times"] = compare(old_k4, dev) if "new_parts" in res else {
            name: {"old": [time_shape(old_round_tail(old_k4), d, dev)
                           for _ in range(2)]}
            for name, d in SHAPES}
        for name, row in res["times"].items():
            print(f"[times] {name}: " + "; ".join(
                f"{who} " + ", ".join(f"{t['ms']:.5f} ms kernel-only / "
                                      f"{t['wrapper_ms']:.5f} wrapper"
                                      for t in ts)
                for who, ts in row.items()), flush=True)
    lat = res.get("new_micro") or res.get("old_micro")
    launch = (res.get("new_launch") or res.get("old_launch"))["ms"]
    res["floor"] = {}
    for name, degrees in SHAPES:
        n_c = dt.compressed_len([True] * len(degrees), list(degrees))
        res["floor"][name] = chain_floor(degrees, n_c, lat, launch,
                                         res["mhz"])
    print("[floor] dependent-chain floor (ms; with warm compressions): "
          + ", ".join(f"{k} {v['ms']:.5f} ({v['warm_ms']:.5f})"
                      for k, v in res["floor"].items()), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    agree = all(res[k]["agree"] for k in ("old_micro", "new_micro")
                if k in res)
    if not agree:
        print("k4_parts: the compressions disagree", file=sys.stderr)
    print(json.dumps({"ok": agree}))
    sys.exit(0 if agree else 1)


if __name__ == "__main__":
    main()
