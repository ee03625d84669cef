"""Smoke run of the torch port on one NVIDIA GPU (H100): builds the port's
CUDA kernels from this checkout, holds each against its plain PyTorch
version, drives the port's main path once at full size, and checks it.

    python3 chip_smoke.py

Phases:
  1. the card (nvidia-smi name and power limit) and the host (CPU model,
     nproc: Dory's stages are host work);
  2. build K1 (`jolt_tpu_torch/csrc/mont_mul.cu`), K2
     (`jolt_tpu_torch/csrc/product_round.cu`) and K3
     (`jolt_tpu_torch/csrc/g1.cu`), one nvcc for sm_90a each, and
     the Dory pairing library (`jolt_tpu_torch/csrc/pairing.cpp`, g++), all
     at once; ptxas's registers and spills; then the Dory setup of the main
     path (2^26: nu = 10, sigma = 16), generated or loaded from the port's
     cache, with its seconds;
  3. K1 (`mont_mul.cu`, the elementwise Fr kernel) vs its plain version on
     the card, bit for bit, in each of its six forms (mul, add, sub, bind
     of halves and of pairs, evals, reduce with and without a scale):
     seeded inputs at N = 2^20, the values 0, 1 and r-1, and a 512-element
     sample against Python ints; each form's kernel-only time at 2^20
     (torch.profiler, on inputs that come from HBM: `cold_copies`) with
     the columns a thread chosen by size and forced to 1 and to 2, beside
     its bound and its plain version's time; the same at a product by a
     scalar and a bind of 2^17-2^19 outputs;
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
     by the port's native tracer, `prove(trace, setup=setup,
     device="cuda")` (the stage-0 Dory commits on the host, stages 1-8 on
     the card, the stage-8 Dory opening on the host; its end-to-end
     cycles/s and Dory's spans) with K1's launch count per form and
     K2's read around it, and per stage (K2 carries the shift sumcheck,
     stage 1s, every ra-virtualization instance of stage 6v -- log2 T + 1
     calls each -- the cycle rounds of stage 7's Hamming-weight instances
     and stage 8's one-hot groups, and stage 8's dense openings), every
     K1 launch's shapes recorded (`kernels.record`) and no call of the
     plain versions' limb arithmetic, then `verify(..., setup=setup)`; a
     second `prove`, at `setup=None` so its per-stage device numbers
     compare with the runs before Dory, under torch.profiler gives each
     stage's device time and busy share
     and counts the device kernels that are neither K1 nor K2; then each
     K1 form vs plain again at the largest launch shape of that run and at
     the one with the most work (launches x bound), with kernel-only times
     and bounds;
  6b. the zk and committed-image paths at full width: the same trace and
     setup through `prove(..., zk=True, zk_rng=random.Random(SEED))` and
     `prove(..., committed_image=True)`, each with its launch counts set to
     0 just before and read just after; every one of the 11 batched
     stages carries round commitments and no clear polynomial, and the zk
     run launches K1 (per form, per stage) and K2 exactly as the plain
     run did; the image run launches K2 as the plain run plus the image's
     two instances (its stage-7 reduction and its stage-8 dense opening,
     log2(image words) + 1 calls each) and K1 as the plain run outside
     stages 7 and 8; each path's cycles/s, stage seconds beside the plain
     run's, BlindFold's seconds, the round commitments' seconds (the
     `zk.commit` span), and `verify`'s seconds (the image's with and
     without its cached trusted commitment);
  7. card vs CPU: `prove` on the small fib trace gives the same
     `proof_io.serialize_proof` bytes on "cuda" and on "cpu" (stages 1-8;
     fib's RAM and bytecode spaces fit one chunk, so it has no stage-6v
     instance), and one `RaVirtual` instance (d = 2) on seeded chunks
     gives identical round polynomials, openings and transcripts on both;
     fib with `zk=True, zk_rng=random.Random(42)` and the image guest
     (a guest that reads its own code, so its RAM space holds the image)
     with `committed_image=True` give the same bytes on both and verify;
     `zk=True` with `committed_image=True` raises on the card too;
  8. card vs CPU: one seeded booleanity and one Hamming-weight
     `GroupedOneHot` of 18 members at K = 256 and T = 2^14 (stage 7's
     largest group) give identical round polynomials, openings and
     transcripts on both; the whole proof of a small guest with a Dory
     setup (13 variables) has the same bytes and FS tape on both, and
     verifies, and so do the guest with zk and the image guest with the
     committed image at the same setup;
  8b. K3, the G1 kernel (`[g1]` and `[kzg]` lines): add and double at
     2^20 lanes (with P + P, P + (-P), infinity and same-point lanes) and
     a 254-bit scalar_mul at 2^12 lanes bit for bit against the plain
     versions, each form's kernel-only time beside its bound; the 2^20 KZG
     setup on the card (its seconds; 128 powers == [tau^i] G1); the KZG
     `prove` of the sha2-chain at chain=1 (2^20 SRS) with K3's counts set
     to 0 just before it and read just after, its stage seconds, K3
     launches per form and stage, the HyperKZG spans and peak memory, and
     `verify`; one dense commitment against the host MSM; one full-width
     2^20 commit's seconds and peak memory; card == CPU proof bytes with
     a 2^13 KZG setup on the PCS guest; and Dory's device one-hot tier
     (the segmented scan) on the main path's 23 matrices against the
     native segment sums, tier 1 only;
  9. one JSON line with every ported kernel, the card line, and the final
     `{"ok": true, "device": ...}` line.

Any failure raises and exits nonzero; with no CUDA device it exits 2
before printing any result.  Nothing runs on the Python pairing tier:
with JOLT_TPU_NO_NATIVE_PAIRING set the script fails.
"""

import collections
import json
import math
import pathlib
import random
import re
import sys
import threading
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 1234

K2_LOG_T = 18                # K2's full size: the main path's 2^18
K2_SMALL_LOG_T = 14          # the round-step entry point's own size
# the stages of `prove` at setup=None (the profiled run), and with Dory (the
# main path): stage 0's commits and the joint opening after stage 8
STAGES = ["witness-extraction", "stage1-spartan", "stage1s-shift",
          "stage2-reg-rw", "stage3-reg-val", "stage4-5-ram",
          "stage5i-instr-lookups", "stage6-bytecode", "stage6v-ra-virtual",
          "stage7-booleanity", "stage8-reduction"]
DORY_STAGES = (STAGES[:1] + ["stage0-commit"] + STAGES[1:]
               + ["stage8-openings"])
# the spans of the Dory commits (`prover/prover.py` stage 0, and each
# commitment's tier 2 in `pcs/dory.py`) and of the opening (`pcs/dory.py`,
# `pcs/scheme.py`)
DORY_SPANS = ["commit.onehot", "commit.dense", "commit.tier2",
              "open.rlc_rows", "open.e1", "open.A.v2init", "open.A.pair",
              "open.A.g1fold", "open.A.g2fold", "open.B.row", "open.B.msm",
              "open.B.g1fold"]
# the small guest proven with Dory card against CPU (phase 8): the JAX
# package's Dory pipeline guest, 2^13 variables (256 x 32)
DORY_SMALL_VARS = 13
DORY_SMALL = """
    li   a1, 21
    li   a2, 34
    add  a3, a1, a2
    xor  a4, a1, a2
    and  a5, a3, a4
    add  a3, a3, a5
    li   t0, {output_start}
    sd   a3, 0(t0)
    li   t1, {termination}
    li   t2, 1
    sd   t2, 0(t1)
"""
# a guest that loads two words of its own code through RAM, so its RAM
# address space holds the program image (the committed-image card vs CPU
# runs of phases 7 and 8; the JAX package's tests/test_program_image.py)
IMAGE_GUEST = """
    li   t0, 0x80000000
    ld   a1, 0(t0)
    ld   a2, 8(t0)
    add  a3, a1, a2
    li   t1, {output_start}
    sd   a3, 0(t1)
    li   t2, {termination}
    li   t3, 1
    sd   t3, 0(t2)
"""
# the batched stages' labels (zk round commitments), in `prove`'s order
ZK_LABELS = ["s1", "s1s", "s2", "s3", "s4", "s5", "s5i", "s6", "s6v", "s7",
             "s8"]
CLEAR_POLYS = ["stage1_polys", "shift_polys", "stage2_polys", "stage3_polys",
               "stage4_polys", "stage5_polys", "stage5i_polys",
               "stage6_polys", "stage6v_polys", "stage7_polys",
               "stage8_polys"]
# the d = 2 ra-virtualization instance held card against CPU (phase 7)
RA_VIRTUAL_LOG_T = 14
RA_VIRTUAL_LOG_K = 13
# the grouped one-hot instances held card against CPU (phase 8): stage 7's
# largest group on the main path (16 instruction chunks and the 8-bit RAM
# and bytecode chunks at K = 256)
ONEHOT_LOG_T = 14
ONEHOT_M = 18
ONEHOT_K = 256
# K3 held against its plain version (phase 8b): add and double at 2^20
# lanes with G1_EDGE lanes of each edge case, scalar_mul at 2^12 lanes;
# the KZG setup of the sha2-chain at chain=1 (2^12 cycles x 2^8)
G1_LOG_N = 20
G1_EDGE = 64
G1_SCALAR_LOG_N = 12
KZG_LOG_N = 20

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


def rand_sums(shape, gen, device):
    """Seeded int64 limb-plane sums (8, *batch) in the range the column sums
    of the path reach (each plane < 2^62, the top one < 2^61, so the carry
    out above 2^256 stays below 2^32)."""
    w = torch.randint(0, 1 << 62, tuple(shape), generator=gen, device=device,
                      dtype=torch.int64)
    w[7] >>= 1
    return w


def k1_args(form, key, draw, draw_int, draw_sums):
    """Operands for K1's `form` as a launch record's key describes them
    (`kernels.record`): shapes, "int" for a value passed by value, and
    bind's and evals' layout of (lo, hi) -- the "high" and "low" halves of
    one tensor, or "split"."""
    def pair(shape, layout):
        *batch, h = shape
        if layout == "split":
            return draw(shape), draw(shape)
        P = draw(tuple(batch) + (2 * h,))
        if layout == "high":
            return P[..., :h], P[..., h:]
        return P[..., 0::2], P[..., 1::2]
    if form in ("mul", "add", "sub"):
        return tuple(draw_int() if s == "int" else draw(s) for s in key)
    if form == "bind":
        lo_shape, layout, r = key
        return (*pair(lo_shape, layout), draw_int() if r == "int" else draw(r))
    if form == "evals":
        lo_shape, degree, layout = key
        return (*pair(lo_shape, layout), degree)
    cols, scale = key
    return (draw_sums(cols), None if scale is None
            else draw_int() if scale == "int" else draw(scale))


def k1_call(kernels, form, args):
    return {"mul": kernels.mont_mul, "add": kernels.add, "sub": kernels.sub,
            "bind": kernels.bind, "evals": kernels.evals,
            "reduce": kernels.reduce}[form](*args)


def k1_plain(kernels, form, args):
    """The plain version of `form` on the same operands (an int operand as
    its Montgomery limbs)."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    nb = max(a.dim() for a in args if isinstance(a, torch.Tensor)) - 1

    def t(x):
        return kernels._plain_operand(x, dev, nb)
    if form in ("mul", "add", "sub"):
        plain = {"mul": kernels.mont_mul_plain, "add": kernels.add_plain,
                 "sub": kernels.sub_plain}[form]
        return plain(t(args[0]), t(args[1]))
    if form == "bind":
        return kernels.bind_plain(args[0], args[1], t(args[2]))
    if form == "evals":
        return kernels.evals_plain(*args)
    return kernels.reduce_plain(args[0],
                                None if args[1] is None else t(args[1]))


def k1_python(kernels, form, args, shape):
    """K1's function on Python ints over the raw Montgomery words: the
    output's words as ints, in the output's (8, ...) order."""
    P, r_inv = kernels.P, pow(1 << 256, -1, kernels.P)

    def vals(x):
        if not isinstance(x, torch.Tensor):
            return [x % P * (1 << 256) % P] * math.prod(shape[1:])
        return words_to_ints(x.expand(shape).contiguous())
    if form == "reduce":
        cols, scale = args
        raw = cols.reshape(8, -1).cpu().tolist()
        S = [sum(raw[l][j] << (32 * l) for l in range(8)) % P
             for j in range(len(raw[0]))]
        if scale is None:
            return S
        return [s * c * r_inv % P for s, c in zip(S, vals(scale))]
    a, b = vals(args[0]), vals(args[1])
    if form == "mul":
        return [x * y * r_inv % P for x, y in zip(a, b)]
    if form == "add":
        return [(x + y) % P for x, y in zip(a, b)]
    if form == "sub":
        return [(x - y) % P for x, y in zip(a, b)]
    if form == "bind":
        return [(x + (y - x) * r * r_inv) % P
                for x, y, r in zip(a, b, vals(args[2]))]
    return [v for k in range(args[2]) for v in
            ([x for x in a] if k == 0 else
             [(y + k * (y - x)) % P for x, y in zip(a, b)])]


def compare_k1(kernels, form, args, where):
    """K1 vs its plain version on the card; returns max |difference| over
    the words (0, or the check fails)."""
    got = k1_call(kernels, form, args)
    want = k1_plain(kernels, form, args)
    torch.cuda.synchronize()
    check(got.shape == want.shape,
          f"K1 {form} shape {tuple(got.shape)} vs {tuple(want.shape)} {where}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(err == 0 and torch.equal(got, want),
          f"K1 {form} disagrees with its plain version {where}")
    return err


def time_k1(kernels, form, args, key):
    """K1's `form` in ms: kernel-only (torch.profiler) with the columns a
    thread chosen by size as on the main path, and with one and two forced
    (`force_k1_columns`; bit-equal checked); the plain version (CUDA
    events); and the bound of the launch `key`."""
    from jolt_tpu_torch.workload import k1_bound_ms
    sets = cold_copies(args)
    name = f"k1_{form}"
    t = {}
    for v in (0, 1, 2) if form != "reduce" else (0,):
        kernels.force_k1_columns(v)
        try:
            if v:
                compare_k1(kernels, form, args, f"at {key}, V = {v}")
            t[f"ms_v{v}" if v else "ms"] = kernel_ms(
                lambda *a: k1_call(kernels, form, a), sets, (name,))[name]
        finally:
            kernels.force_k1_columns(0)
    del sets
    bound, by = k1_bound_ms(form, key)
    return {**t, "plain_ms": cuda_ms(lambda: k1_plain(kernels, form, args), 3),
            "bound_ms": bound, "bound_by": by}


def k1_line(form, key, t, tag=""):
    """One printed line of a K1 timing (`time_k1`)."""
    alt = "".join(f", V = {k[-1]}: {t[k]:.5f}" for k in ("ms_v1", "ms_v2")
                  if k in t)
    return (f"[kernel] K1 {form} {tag}{key}: {t['ms']:.5f} ms kernel-only "
            f"(V by size{alt}), plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.5f} ms ({t['bound_by']}), "
            f"{t['bound_ms'] / t['ms']:.0%} of the bound")


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


L2_BYTES = 50 << 20          # the H100's L2


def cold_copies(args):
    """`args` and enough copies of its tensors that cycling through them
    reads three times the L2 before one comes round again, so each call
    finds its inputs in HBM (as the main path mostly does) and, in the
    steady state, pays for the last call's writes leaving the L2.  Views of
    one tensor stay views of one copy (bind's halves and pairs keep their
    layout)."""
    storages = {}
    for a in args:
        if isinstance(a, torch.Tensor):
            storages[a.untyped_storage().data_ptr()] = a.untyped_storage()
    size = sum(st.nbytes() for st in storages.values())
    sets = [tuple(args)]
    for _ in range(1, math.ceil(3 * L2_BYTES / max(size, 1))):
        new = {k: st.clone() for k, st in storages.items()}
        sets.append(tuple(
            torch.empty(0, dtype=a.dtype, device=a.device).set_(
                new[a.untyped_storage().data_ptr()], a.storage_offset(),
                a.shape, a.stride())
            if isinstance(a, torch.Tensor) else a for a in args))
    return sets


def kernel_ms(fn, arg_sets, names, reps=20, tries=3):
    """Mean device time of each kernel whose name holds one of `names`
    (each launched once a call), kernel-only: torch.profiler over `reps`
    calls fn(*args), cycling through `arg_sets` (`cold_copies`), after a
    warm-up, so neither the host's cost of the calls nor cached inputs are
    in it.  The mean is over the launches the trace holds (it may miss one
    of a run of long kernels); a trace with fewer than half is taken
    again."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(*arg_sets[i % len(arg_sets)])
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


def events_ms(fn, arg_sets, reps):
    """Mean device time of fn(*args) in ms by CUDA events over `reps`
    back-to-back calls cycling through `arg_sets`, after a warm-up: for
    kernels of a millisecond and more, whose wrapper's host cost hides
    behind the kernel before it."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_k2(kernels, ops, polys, r, order):
    """K2 in ms: its pass kernel and its finish kernel alone (kernel-only
    device time), the wrapper with both as a live round calls it
    (CUDA events over back-to-back calls with r a Python int, so the
    wrapper's host cost counts), and the plain version; with the bound."""
    from jolt_tpu_torch.workload import k2_bound_ms
    r_int = ops.unpack_ints(r)[0]
    names = ("round_kernel",) + (("finish_kernel",) if order != "bind"
                                 else ())
    dev_ms = kernel_ms(lambda *ps: kernels.product_round(ps, r_int, order),
                       cold_copies(polys), names)
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


def g1_kzg_phase(dev, gen, dory_setup, pcs_guest, onehot_positions,
                 card_vs_cpu):
    """Phase 8b: (a) K3 against its plain version, bit for bit, and its
    kernel-only times beside the bounds; (b) the 2^20 KZG setup on the
    card; (c) the KZG `prove` of the sha2-chain at chain=1 (this slice's
    path: K3's counts set to 0 just before it and read just after) and
    `verify`; (d) card == CPU with a 2^13 KZG setup on the PCS guest; (e)
    Dory's device one-hot tier at the main path's 2^18 trace against the
    native segment sums.  Returns the kernel line's "g1" entry."""
    import tempfile

    from jolt_tpu_torch import PublicIO, prove, verify
    from jolt_tpu_torch.curve import bn254_host as host
    from jolt_tpu_torch.curve import g1
    from jolt_tpu_torch.field import fq, kernels
    from jolt_tpu_torch.pcs import scheme as scheme_mod
    from jolt_tpu_torch.pcs.dory import Dory
    from jolt_tpu_torch.pcs.hyperkzg import DEFAULT_TAU, KZGSetup
    from jolt_tpu_torch.prover.prover import required_num_vars
    from jolt_tpu_torch.utils import profiling
    from jolt_tpu_torch.workload import (k3_bound_ms, sha2_chain_trace,
                                         timed_stages)
    t_phase = time.perf_counter()
    R = host.R

    # (a) K3 vs plain at 2^20 lanes: random points of general Z (a 64-bit
    # scalar multiple of G per lane), against a second batch with edge lanes
    n = 1 << G1_LOG_N
    base = g1.pack_points([host.G1_GEN], dev)

    def rand_words(w, top_bits=32):
        x = torch.randint(0, 1 << 32, (w, n), generator=gen, device=dev,
                          dtype=torch.int64)
        x[-1] &= (1 << top_bits) - 1
        return (x - ((x >> 31) << 32)).to(torch.int32)
    P = g1.batch_scalar_mul(tuple(c.expand(-1, n) for c in base),
                            rand_words(2), 64)
    Q = [c.clone() for c in g1.jacobian_double(
        tuple(c.roll(1, 1) for c in P))]
    e = G1_EDGE
    for c, pc in zip(Q, P):                       # P + P
        c[:, :e] = pc[:, :e]
    Q[0][:, e:2 * e] = P[0][:, e:2 * e]           # P + (-P)
    Q[1][:, e:2 * e] = fq.sub_plain(torch.zeros_like(P[1][:, e:2 * e]),
                                    P[1][:, e:2 * e])
    Q[2][:, e:2 * e] = P[2][:, e:2 * e]
    P[2][:, 2 * e:3 * e] = 0                      # P at infinity, X, Y kept
    Q[2][:, 3 * e:4 * e] = 0                      # Q at infinity
    P[2][:, 4 * e:5 * e] = 0                      # both
    Q[2][:, 4 * e:5 * e] = 0
    # the same point as P in other coordinates: (l^2 X, l^3 Y, l Z)
    lam = fq.pack_ints([0x1234567], dev)
    lam2 = fq.mont_mul_plain(lam, lam)
    sl = slice(5 * e, 6 * e)
    Q[0][:, sl] = fq.mont_mul_plain(P[0][:, sl], lam2)
    Q[1][:, sl] = fq.mont_mul_plain(P[1][:, sl],
                                    fq.mont_mul_plain(lam2, lam))
    Q[2][:, sl] = fq.mont_mul_plain(P[2][:, sl], lam)
    Q = tuple(Q)
    generic = n - 6 * e

    def max_err(got, want):
        return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                   for a, b in zip(got, want))
    kernels.reset_launches()
    S = g1.jacobian_add(P, Q)
    err = max_err(S, g1.jacobian_add_plain(P, Q))
    D = g1.jacobian_double(S)
    err = max(err, max_err(D, g1.jacobian_double_plain(S)))
    m = 1 << G1_SCALAR_LOG_N
    sub = tuple(c[:, :m].contiguous() for c in S)
    ks = rand_words(8, 30)[:, :m].contiguous()       # < 2^254
    M = g1.batch_scalar_mul(sub, ks, 254)
    err = max(err, max_err(M, g1.batch_scalar_mul_plain(sub, ks, 254)))
    torch.cuda.synchronize()
    check(err == 0, f"K3 differs from its plain version: {err}")
    check(kernels.k3_launches() == {"add": 1, "double": 1, "scalar_mul": 1},
          f"K3 launches {kernels.k3_launches()}")
    # affine spot checks against the host
    idx = [0, e, 2 * e, 3 * e, 4 * e, 5 * e, 6 * e, n - 1]
    aff = g1.unpack_points(tuple(c[:, idx] for c in S))
    pa = g1.unpack_points(tuple(c[:, idx] for c in P))
    qa = g1.unpack_points(tuple(c[:, idx] for c in Q))
    check(aff == [host.g1_add(a, b) for a, b in zip(pa, qa)],
          "K3 add differs from the host on the edge lanes")
    ki = words_to_ints(ks[:, :8])
    check(g1.unpack_points(tuple(c[:, :8] for c in M))
          == [host.g1_mul(p, k) for p, k in
              zip(g1.unpack_points(tuple(c[:, :8] for c in sub)), ki)],
          "K3 scalar_mul differs from the host")
    print(f"[g1] K3 == its plain version bit for bit: add and double at "
          f"2^{G1_LOG_N} lanes ({6 * e} edge lanes: P + P, P + (-P), "
          f"infinities, equal points in other coordinates), scalar_mul of "
          f"254 bits at 2^{G1_SCALAR_LOG_N} lanes; host spot checks "
          "agree", flush=True)
    forms = {}
    t_add = events_ms(lambda *a: g1.jacobian_add(a[:3], a[3:]),
                      cold_copies((*P, *Q)), 20)
    t_dbl = events_ms(lambda *a: g1.jacobian_double(a), cold_copies(S), 20)
    p_add = cuda_ms(lambda: g1.jacobian_add_plain(P, Q), 1)
    p_dbl = cuda_ms(lambda: g1.jacobian_double_plain(S), 1)
    p_smul = cuda_ms(lambda: g1.batch_scalar_mul_plain(sub, ks, 254), 1)
    t_smul_m = events_ms(lambda *a: g1.batch_scalar_mul(a[:3], a[3], 254),
                         [(*sub, ks)], 5)
    set_m = int(sum(int(x).bit_count() for x in words_to_ints(ks)))
    for form, t, plain_t, lanes, b in (
            ("add", t_add, p_add, n, k3_bound_ms("add", n, generic)),
            ("double", t_dbl, p_dbl, n, k3_bound_ms("double", n)),
            ("scalar_mul", t_smul_m, p_smul, m,
             k3_bound_ms("scalar_mul", m, bits=254, set_bits=set_m))):
        forms[form] = {"ms": t, "plain_ms": plain_t, "lanes": lanes,
                       "bound_ms": b[0], "bound_by": b[1]}
        print(f"[g1] {form} at {lanes} lanes: {t:.4f} ms (CUDA events) "
              f"(bound {b[0]:.4f} ms, {b[1]}; {b[0] / t:.1%} of it), "
              f"plain {plain_t:.2f} ms", flush=True)
    del Q, D, M

    # (b) the 2^20 KZG setup on the card: one scalar_mul launch
    srs_dir = tempfile.mkdtemp(prefix="kzg_srs_")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kzg = KZGSetup.generate(1 << KZG_LOG_N, device=dev, cache_dir=srs_dir)
    torch.cuda.synchronize()
    t_kzg = time.perf_counter() - t0
    rng = random.Random(SEED)
    picks = list(range(64)) + sorted(rng.sample(range(64, 1 << KZG_LOG_N),
                                                64))
    got = g1.unpack_points(tuple(c[:, picks] for c in kzg.g1_powers_dev))
    check(got == [host.g1_mul(host.G1_GEN, pow(DEFAULT_TAU, i, R))
                  for i in picks], "a KZG power differs from [tau^i] G1")
    tau_words = [pow(DEFAULT_TAU, i, R) for i in range(1 << KZG_LOG_N)]
    raw = b"".join(k.to_bytes(32, "little") for k in tau_words)
    tw = torch.from_numpy(np.frombuffer(raw, dtype="<u4").reshape(-1, 8).T
                          .copy().view(np.int32)).to(dev)
    kn = 1 << KZG_LOG_N
    gens = tuple(c.expand(-1, kn) for c in base)
    t_smul = events_ms(lambda *a: g1.batch_scalar_mul(a[:3], a[3], 254),
                       [(*gens, tw)], 3)
    set_n = sum(k.bit_count() for k in tau_words)
    b_smul = k3_bound_ms("scalar_mul", kn, bits=254, set_bits=set_n)
    forms["scalar_mul"].update(setup_ms=t_smul, setup_lanes=kn,
                               setup_bound_ms=b_smul[0])
    del tw, tau_words, raw
    print(f"[kzg] KZGSetup.generate(2^{KZG_LOG_N}, device=cuda) "
          f"{t_kzg:.3f}s (tau powers on the host, one K3 scalar_mul of "
          f"{t_smul:.2f} ms by CUDA events, bound {b_smul[0]:.2f} ms, "
          f"{b_smul[0] / t_smul:.1%} of it, the cache written); 64 first and "
          "64 seeded powers == [tau^i] G1", flush=True)

    # (c) the KZG prove of the sha2-chain at chain=1 (2^20 SRS) and verify
    kt = sha2_chain_trace(1)
    check(required_num_vars(kt.padded_length, 0, 0) == KZG_LOG_N,
          f"the chain=1 trace ({kt.padded_length}) does not fit 2^20")
    dense = []
    commit = scheme_mod.HyperKZGScheme.commit

    def record(self, name, coeffs, bits=254):
        out = commit(self, name, coeffs, bits)
        dense.append((name, list(coeffs), out))
        return out
    scheme_mod.HyperKZGScheme.commit = record
    kprof = profiling.PROFILER = profiling.Profiler()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    try:
        t0 = time.perf_counter()
        kproof, ks_s, _, kl = timed_stages(
            lambda: prove(kt, setup=kzg, device=dev))
        t_kprove = time.perf_counter() - t0
    finally:
        k3 = kernels.k3_launches()
        k1 = sum(kernels.k1_launches().values())
        k2 = kernels.product_round.launches
        scheme_mod.HyperKZGScheme.commit = commit
        profiling.PROFILER = profiling.Profiler(enabled=False)
    kpeak = torch.cuda.max_memory_allocated(dev)
    check(all(k3.values()) and k1 and k2,
          f"the KZG prove launched K1 {k1}, K2 {k2}, K3 {k3}")
    check(type(kproof.opening_proofs["joint"]).__name__ == "HyperKZGProof",
          "the KZG proof carries no HyperKZG opening")
    t0 = time.perf_counter()
    check(verify(kproof, PublicIO.from_trace(kt), setup=kzg) is True,
          "verify rejected the KZG proof")
    t_kverify = time.perf_counter() - t0
    name, coeffs, com = dense[0]
    hp = g1.unpack_points(tuple(c[:, :len(coeffs)]
                                for c in kzg.g1_powers_dev))
    check(com == host.g1_msm_pippenger(hp, coeffs),
          f"the dense commitment {name} differs from the host MSM")
    spans = {k: kprof.total(k) for k in ("kzg.commit", "kzg.open.folds",
                                         "kzg.open.evals",
                                         "kzg.open.quotients")}
    by_stage = {k: v["k3"] for k, v in kl.items() if any(v["k3"].values())}
    print(f"[kzg] prove(sha2-chain chain=1: {kt.length} cycles, padded "
          f"{kt.padded_length}; setup 2^{KZG_LOG_N}) {t_kprove:.3f}s: "
          + ", ".join(f"{k} {v:.3f}s" for k, v in ks_s.items())
          + f"; peak allocated {kpeak / 2**30:.3f} GiB; K1 {k1}, K2 {k2}, "
          f"K3 {k3}; verify(setup) {t_kverify:.3f}s; dense commitment "
          f"{name} ({len(coeffs)} coefficients) == the host MSM",
          flush=True)
    print(f"[kzg] K3 launches by stage: {by_stage}; spans (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()), flush=True)
    # one full-width 2^20 commit, timed, and its peak memory
    rng = random.Random(SEED + 1)
    full = [rng.randrange(R) for _ in range(1 << KZG_LOG_N)]
    from jolt_tpu_torch.pcs.hyperkzg import HyperKZG
    hk = HyperKZG(kzg)
    hk.commit_ints(full[:1024])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    c_full = hk.commit_ints(full)
    t_commit = time.perf_counter() - t0
    cpeak = torch.cuda.max_memory_allocated(dev)
    c_launch = kernels.k3_launches()
    check(c_full is not None and host.g1_is_on_curve(c_full),
          "the full-width commitment is not a curve point")
    print(f"[kzg] one full-width 2^{KZG_LOG_N} commit {t_commit:.3f}s "
          f"(digits on the host, Pippenger on the card: K3 {c_launch}), "
          f"peak allocated {cpeak / 2**30:.3f} GiB", flush=True)
    del kproof, hp, full

    # (d) card == CPU with a 2^13 KZG setup on the PCS guest
    kzg13 = KZGSetup.generate(1 << 13, device=dev, cache_dir=srs_dir)
    n_pcs = card_vs_cpu(pcs_guest, "the PCS guest with a 2^13 KZG setup",
                        setup=kzg13)
    print(f"[kzg] card == CPU: the PCS guest ({pcs_guest.length} cycles) "
          f"with a 2^13 KZG setup: identical proof bytes ({n_pcs} B) and FS "
          "tape; verified", flush=True)

    # (e) Dory's device one-hot tier at the main path's size (tier 1)
    dory = Dory(dory_setup, dev)
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    dev_rows = dory.onehot_rows(onehot_positions, device_tier=True)
    t_scan = time.perf_counter() - t0
    speak = torch.cuda.max_memory_allocated(dev)
    s_launch = kernels.k3_launches()
    t0 = time.perf_counter()
    nat_rows = dory.onehot_rows(onehot_positions, device_tier=False)
    t_native = time.perf_counter() - t0
    lanes = sum(len(p) for p in onehot_positions)
    check(dev_rows == nat_rows,
          "the device one-hot tier differs from the native segment sums")
    n_rows = sum(r is not None for rows in dev_rows for r in rows)
    print(f"[g1] Dory's device one-hot tier at 2^18: "
          f"{len(onehot_positions)} matrices, {lanes} lanes, {n_rows} row "
          f"sums == native_pairing.g1_segment_sums point for point; device "
          f"tier {t_scan:.3f}s (gather, segmented scan, {s_launch['add']} K3 "
          f"adds, unpack; peak allocated {speak / 2**30:.3f} GiB), native "
          f"{t_native:.3f}s", flush=True)
    print(f"[g1] phase 8b {time.perf_counter() - t_phase:.1f}s", flush=True)
    entry = {
        "name": "g1", "route": "cuda",
        "source": "jolt_tpu_torch/csrc/g1.cu",
        "replaces": "jolt_tpu/curve/g1.py (jnp)",
        "launches": sum(k3.values()), "max_abs_err": err,
        "ms": forms["add"]["ms"], "plain_ms": forms["add"]["plain_ms"],
        "bound_ms": forms["add"]["bound_ms"],
        "bound_by": forms["add"]["bound_by"], "library_ms": None,
        "form": "add", "shape": [[8, n]] * 6, "forms": forms,
        "launches_by_form": k3, "launches_by_stage": by_stage,
        "kzg_setup_s": t_kzg, "kzg_prove_s": t_kprove,
        "kzg_stage_s": ks_s, "kzg_spans_s": spans,
        "kzg_peak_gib": kpeak / 2**30, "kzg_commit_s": t_commit,
        "kzg_commit_peak_gib": cpeak / 2**30, "onehot_device_s": t_scan,
        "onehot_native_s": t_native}
    return entry


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    from jolt_tpu_torch import PublicIO, prove, verify
    from jolt_tpu_torch.curve import native_pairing
    from jolt_tpu_torch.field import kernels, ops
    from jolt_tpu_torch.pcs import scheme as scheme_mod
    from jolt_tpu_torch.pcs.dory import SRS_CACHE_DIR, DorySetup
    from jolt_tpu_torch.prover.prover import required_num_vars
    from jolt_tpu_torch.poly import eq
    from jolt_tpu_torch.proof_io import serialize_proof
    from jolt_tpu_torch.prover.prover import (BC_RA_SOURCES, RAM_RA_SOURCES,
                                              committed_poly_names)
    from jolt_tpu_torch.relations.grouped_onehot import GroupedOneHot
    from jolt_tpu_torch.relations.program_image import image_words
    from jolt_tpu_torch.relations.ra_virtual import (RaVirtual, block_widths,
                                                     chunk_streams, d_chunks)
    from jolt_tpu_torch.riscv.emulator import MemoryLayout
    from jolt_tpu_torch.sumcheck.engine import (BatchedSumcheck,
                                                OpeningAccumulator)
    from jolt_tpu_torch.sumcheck.product import (ProductSumcheck,
                                                 VerifierProductSumcheck,
                                                 round_step)
    from jolt_tpu_torch.tracer import trace_program
    from jolt_tpu_torch.transcript import Blake2bTranscript
    from jolt_tpu_torch.utils import profiling
    from jolt_tpu_torch.verifier import verifier as verifier_mod
    from jolt_tpu_torch.workload import (SHA2_CHAIN, card_line, host_line,
                                         sha2_chain_trace, stage_device_s,
                                         timed_stages)

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # ---- 1. the card ----------------------------------------------------
    card = card_line()
    print(f"[card] {card}  torch {torch.__version__} cuda {torch.version.cuda}"
          f"  {torch.cuda.get_device_name(0)}", flush=True)
    print(f"[host] {host_line()}", flush=True)
    check(not native_pairing.python_tier(),
          "JOLT_TPU_NO_NATIVE_PAIRING is set: Dory would run its Python tier")

    # ---- 2. build K1, K2 and the pairing library; the Dory setup --------
    t0 = time.perf_counter()
    pairing_build = {}

    def build_pairing():
        try:
            pairing_build["path"] = native_pairing.build(force=True)
        except BaseException as e:           # re-raised after the join
            pairing_build["error"] = e
        pairing_build["s"] = time.perf_counter() - t0
    builder = threading.Thread(target=build_pairing)
    builder.start()
    reports = kernels.build()
    t_nvcc = time.perf_counter() - t0
    builder.join()
    if "error" in pairing_build:
        raise pairing_build["error"]
    check(native_pairing.available(), "the pairing library did not load")
    print(f"[build] K1, K2 and K3 built in {t_nvcc:.2f}s; the pairing "
          f"library ({pairing_build['path']}) in {pairing_build['s']:.2f}s, "
          "all at once", flush=True)
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    k1_spills = spill_bytes(reports["K1"])
    k2_spills = spill_bytes(reports["K2"])
    k3_spills = spill_bytes(reports["K3"])
    print(f"[build] spill bytes (stores + loads, all kernels): K1 "
          f"{k1_spills}, K2 {k2_spills}, K3 {k3_spills}", flush=True)
    # the main path's setup: 2^26 = 256 x 2^18, the largest committed
    # polynomial of the 2^18 trace
    t0 = time.perf_counter()
    cached = (pathlib.Path(SRS_CACHE_DIR) / "dory_torch_ate_10_16.pkl"
              ).exists()
    setup = DorySetup.generate(required_num_vars(1 << 18, 0, 0))
    t_setup = time.perf_counter() - t0
    check((setup.nu, setup.sigma) == (10, 16), "setup shape")
    print(f"[setup] Dory nu={setup.nu} sigma={setup.sigma}: {t_setup:.2f}s "
          f"({'loaded from the cache' if cached else 'generated'})",
          flush=True)

    # ---- 3. K1 vs plain in every form: 2^20, edge values, Python ints ----
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    P = kernels.P
    edge = [0, 1, P - 1]

    def draw(shape):
        return rand_field(shape, gen, dev)

    def draw_int():
        bits = torch.randint(0, 1 << 62, (5,), generator=gen,
                             device=dev).tolist()
        return sum(v << (62 * i) for i, v in enumerate(bits)) % P

    def draw_sums(shape):
        return rand_sums(shape, gen, dev)

    def draw_edge(shape):
        pick = torch.randint(0, 3, (math.prod(shape[1:]),), generator=gen,
                             device=dev).tolist()
        return ints_to_words([edge[v] for v in pick], dev).reshape(shape)

    def draw_edge_int():
        return edge[int(torch.randint(0, 3, (1,), generator=gen,
                                      device=dev))]

    def draw_edge_sums(shape):
        return kernels.u64_words(draw_edge(tuple(shape) + (64,))).sum(-1)

    n = 1 << 20
    # each form at 2^20 outputs, in the layouts of the main path
    k1_cases = {
        "mul": ((8, n), (8, n)), "add": ((8, n), (8, n)),
        "sub": ((8, n), "int"), "bind": ((8, n), "high", "int"),
        "evals": ((8, n), 3, "high"), "reduce": ((8, n), (8, 1)),
    }
    k1_err = {form: 0 for form in kernels.FORMS}
    k1_n20 = {}
    for form, key in k1_cases.items():
        args = k1_args(form, key, draw, draw_int, draw_sums)
        k1_err[form] = compare_k1(kernels, form, args, "at N = 2^20")
        k1_n20[form] = t = time_k1(kernels, form, args, key)
        print(k1_line(form, key, t), flush=True)
        del args
    # the shapes the one-column kernel was timed at (a product by a scalar
    # at 2^17 and 2^18 columns, a bind of 2^17 outputs) and their neighbours
    # up to 2^19
    k1_ref = {}
    for form, key in (("mul", ((8, 1 << 17), "int")),
                      ("mul", ((8, 1 << 18), "int")),
                      ("mul", ((8, 1 << 19), "int")),
                      ("bind", ((8, 1 << 17), "high", "int")),
                      ("bind", ((8, 1 << 18), "high", "int")),
                      ("bind", ((8, 1 << 17), "low", "int")),
                      ("bind", ((8, 1 << 18), "low", "int")),
                      ("bind", ((8, 1 << 19), "low", "int"))):
        args = k1_args(form, key, draw, draw_int, draw_sums)
        k1_err[form] = max(k1_err[form], compare_k1(kernels, form, args,
                                                    f"at {key}"))
        k1_ref[f"{form} {key}"] = t = time_k1(kernels, form, args, key)
        print(k1_line(form, key, t), flush=True)
    # the layouts at 2^20 not timed above: bind of pairs with a device r,
    # evals of split pairs, reduce without a scale
    for form, key in (("bind", ((8, n), "low", (8, 1))),
                      ("evals", ((8, n), 2, "split")),
                      ("reduce", ((8, n), None)),
                      ("mul", ((8, 4, 1), (8, 4, n // 4)))):
        args = k1_args(form, key, draw, draw_int, draw_sums)
        k1_err[form] = max(k1_err[form], compare_k1(kernels, form, args,
                                                    f"at {key}"))
    # 0, 1 and r-1 in every operand; a 512-element sample vs Python ints
    small = {
        "mul": [((8, 1024), (8, 1024)), ((8, 2, 512), "int")],
        "add": [((8, 1024), (8, 1024)), ((8, 1024), (8, 1))],
        "sub": [((8, 1024), (8, 1024)), ("int", (8, 1024))],
        "bind": [((8, 1024), "high", "int"), ((8, 1024), "low", (8, 1)),
                 ((8, 3, 512), "split", "int")],
        "evals": [((8, 1024), 3, "high"), ((8, 2, 512), 2, "split")],
        "reduce": [((8, 1024), None), ((8, 1024), "int"),
                   ((8, 2, 512), (8, 2, 1))],
    }
    samples = {"mul": ((8, 512), (8, 512)), "add": ((8, 512), (8, 1)),
               "sub": ("int", (8, 512)), "bind": ((8, 512), "low", "int"),
               "evals": ((8, 512), 3, "high"), "reduce": ((8, 512), (8, 1))}
    for form, keys in small.items():
        for key in keys:
            args = k1_args(form, key, draw_edge, draw_edge_int,
                           draw_edge_sums)
            k1_err[form] = max(k1_err[form], compare_k1(
                kernels, form, args, f"on 0/1/r-1 at {key}"))
        key = samples[form]
        args = k1_args(form, key, draw, draw_int, draw_sums)
        out = k1_call(kernels, form, args)
        shape = tuple(torch.broadcast_shapes(
            *(a.shape for a in args if isinstance(a, torch.Tensor))))
        check(words_to_ints(out.reshape(8, -1))
              == k1_python(kernels, form, args, shape),
              f"K1 {form} disagrees with Python ints at {key}")
    max_err = max(k1_err.values())
    print("[kernel] K1 == its plain version bit for bit in every form (N = "
          "2^20, 0/1/r-1); 512-element samples == Python ints", flush=True)

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
    kernels.reset_launches()
    t0 = time.perf_counter()
    for r in rs:
        msg, bound = round_step(chain[-1], r)
        msgs.append(msg)
        chain.append(bound)
    torch.cuda.synchronize()
    t_chain = time.perf_counter() - t0
    k2_round_launches = kernels.product_round.launches
    k1_round_launches = sum(kernels.k1_launches().values())
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

    # ---- 6. main path: sha2-chain through prove on the card --------------
    t0 = time.perf_counter()
    tr = sha2_chain_trace()          # raises if the chain's output is wrong
    t_trace = time.perf_counter() - t0
    print(f"[path] sha2-chain chain={SHA2_CHAIN}: {tr.length} cycles, "
          f"padded {tr.padded_length}, traced in {t_trace:.2f}s", flush=True)
    check(required_num_vars(tr.padded_length, 0, 0) == setup.num_vars,
          f"the setup does not fit the trace's {tr.padded_length} cycles")

    # K1's and K2's launches, per form, and every K1 launch's shapes: set to
    # 0 just before the main path and read just after
    # and the plain versions' torch limb arithmetic must not run there
    plain_calls = collections.Counter()
    plain = {n: getattr(kernels, n)
             for n in ("_carry", "_sub_p_select", "mont_mul_plain")}

    def counted(name, fn):
        def call(*args):
            plain_calls[name] += 1
            return fn(*args)
        return call
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    kernels.record = []
    for name, fn in plain.items():
        setattr(kernels, name, counted(name, fn))
    # Dory's spans (the span profiler that `open` and `open_rlc` report to)
    dory_prof = profiling.PROFILER = profiling.Profiler()
    # the one-hot matrices' positions, for phase 8b's device tier
    onehot_positions = []
    commit_many = scheme_mod.DoryScheme.commit_sparse_many

    def capture(self, named):
        onehot_positions.extend(p for _, p in named)
        return commit_many(self, named)
    scheme_mod.DoryScheme.commit_sparse_many = capture
    try:
        t0 = time.perf_counter()
        proof, stage_s, stage_lines, stage_launches = timed_stages(
            lambda: prove(tr, setup=setup, device="cuda"))
        t_prove = time.perf_counter() - t0
    finally:
        k1_counts = kernels.k1_launches()
        k2_launches = kernels.product_round.launches
        records, kernels.record = kernels.record, None
        for name, fn in plain.items():
            setattr(kernels, name, fn)
        profiling.PROFILER = profiling.Profiler(enabled=False)
        scheme_mod.DoryScheme.commit_sparse_many = commit_many
    launches = sum(k1_counts.values())
    peak = torch.cuda.max_memory_allocated(dev)
    print(stage_lines, end="")
    log_t = tr.padded_length.bit_length() - 1
    check(all(k1_counts.values()),
          f"a K1 form was not launched on the main path: {k1_counts}")
    check(len(records) == launches, "K1's launch record missed launches")
    check(not plain_calls, "torch limb arithmetic ran on the card's path: "
          f"{dict(plain_calls)}")
    # stage 1s and each ra-virtualization instance of stage 6v (one per
    # full-ra claim of a space wider than one chunk): the first message,
    # log T - 1 bind + message passes, the last bind
    n6v = sum(len(src) for log_k, src in ((proof.ram_log_K, RAM_RA_SOURCES),
                                          (proof.bytecode_log_K,
                                           BC_RA_SOURCES))
              if d_chunks(log_k) == 2)
    check(all(d_chunks(k) <= 2 for k in (proof.ram_log_K,
                                          proof.bytecode_log_K)),
          "a stage-6v instance has more than 3 factors: off K2")
    # stage 7: each K group's Hamming-weight instance runs its log T cycle
    # rounds on K2, plus the last bind for a one-member group
    widths = ([7] * 3 + block_widths(proof.ram_log_K)
              + block_widths(proof.bytecode_log_K) + [8] * 16)
    n7 = sum(log_t + (widths.count(w) == 1) for w in set(widths))
    check(stage_launches["stage1s-shift"]["k2"] == log_t + 1
          and stage_launches["stage6v-ra-virtual"]["k2"]
          == n6v * (log_t + 1)
          and stage_launches["stage7-booleanity"]["k2"] == n7
          and stage_launches["stage8-reduction"]["k2"] > 0,
          f"K2 per stage: {stage_launches}")
    check(k2_launches == sum(v["k2"] for v in stage_launches.values()),
          f"K2 launched {k2_launches} times on the main path, "
          f"{stage_launches} by stage")
    check(list(stage_s) == DORY_STAGES, f"stage lines: {stage_s}")
    check([e["stage"] for e in proof.fs_tape] == DORY_STAGES[1:],
          f"FS tape: {proof.fs_tape}")
    check(set(proof.commitments) == set(committed_poly_names(
        d_chunks(proof.ram_log_K), d_chunks(proof.bytecode_log_K)))
          and "joint" in proof.opening_proofs,
          f"commitments {sorted(proof.commitments)}, opening proofs "
          f"{sorted(proof.opening_proofs)}")
    check(all(stage_launches[s] == {"k1": {f: 0 for f in kernels.FORMS},
                                    "k2": 0,
                                    "k3": {f: 0 for f in kernels.K3_FORMS}}
              for s in ("stage0-commit", "stage8-openings")),
          "a Dory stage launched K1, K2 or K3")
    check(not any(kernels.k3_launches().values()),
          f"the Dory path launched K3: {kernels.k3_launches()}")
    t0 = time.perf_counter()
    ok = verify(proof, PublicIO.from_trace(tr), setup=setup)
    t_verify = time.perf_counter() - t0
    check(ok is True, "verify did not accept")
    cycles_per_s = tr.length / t_prove
    spans = {name: dory_prof.total(name) for name in DORY_SPANS}
    check(all(v > 0 for v in spans.values()), f"Dory spans: {spans}")
    # the setup's point encodings, made anew by each prove's Dory instance
    # (nested in commit.onehot, commit.tier2 and the opening's rounds)
    t_encode = dory_prof.total("encode.setup")
    shapes = collections.Counter(records)
    # the address-phase scale of s2-s5 is in the reduce form's finish
    check(shapes[("mul", ((8, 3, 1), (8, 1, 1)))] == 0,
          "the path still multiplies (8, 3, 1) messages by a scale")
    print(f"[path] prove(setup=nu {setup.nu}, sigma {setup.sigma}) "
          f"{t_prove:.3f}s = {cycles_per_s:.1f} cycles/s end to end ("
          + ", ".join(f"{k} {v:.3f}s" for k, v in stage_s.items())
          + f"), peak allocated {peak / 2**30:.3f} GiB, K1 launches "
          f"{launches} {k1_counts}, {len(shapes)} launch shapes, K2 launches "
          f"{k2_launches} (stage 1s and {n6v} stage-6v instances, {log_t} "
          f"rounds each; stage 7 {n7}, stage 8 "
          f"{stage_launches['stage8-reduction']['k2']}; RAM log K "
          f"{proof.ram_log_K}, bytecode log K {proof.bytecode_log_K}); "
          f"verify(setup) accepted in {t_verify:.3f}s", flush=True)
    t_dory = stage_s["stage0-commit"] + stage_s["stage8-openings"]
    print("[dory] spans (s, summed over calls): " + ", ".join(
        f"{n} {v:.4f}" for n, v in spans.items()) + f"; stage0-commit "
        f"{stage_s['stage0-commit']:.3f}s, stage8-openings "
        f"{stage_s['stage8-openings']:.3f}s of prove {t_prove:.3f}s "
        f"({t_dory / t_prove:.1%}); encode.setup {t_encode:.4f}s "
        f"({t_encode / t_prove:.1%} of prove)", flush=True)

    # a second run under the profiler, at setup=None so that the card's
    # stages compare with the runs before Dory: each stage's device time
    # and busy share, and the device kernels by name (those of neither
    # kernel)
    prove(tr, device="cuda")                  # warm, as the first run was
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_s, _, _ = timed_stages(lambda: prove(tr, device="cuda"))
        torch.cuda.synchronize()
    check(list(prof_s) == STAGES, f"profiled stage lines: {prof_s}")
    dev_s = stage_device_s(prof)
    for label in STAGES:
        n = stage_launches[label]
        print(f"[stage] {label}: {stage_s[label]:.4f}s timed; profiled "
              f"{prof_s[label]:.4f}s, device {dev_s.get(label, 0.0):.4f}s, "
              f"busy {dev_s.get(label, 0.0) / prof_s[label]:.1%}; K1 "
              f"{sum(n['k1'].values())} {n['k1']}, K2 {n['k2']}", flush=True)
    print(f"[stage] prove profiled {sum(prof_s.values()):.3f}s, busy "
          f"{sum(dev_s.values()) / sum(prof_s.values()):.1%}", flush=True)
    census = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            census[e.name] += 1
    own = ("k1_", "round_kernel", "finish_kernel")
    others = {k: c for k, c in census.items()
              if not any(o in k for o in own) and "Memcpy" not in k
              and "Memset" not in k}
    copies = {k: c for k, c in census.items() if "Memcpy" in k}
    n_other = sum(others.values())
    print(f"[path] device kernels on prove (profiled run): "
          f"{sum(c for k, c in census.items() if 'k1_' in k)} K1, "
          f"{sum(c for k, c in census.items() if any(o in k for o in own[1:]))}"
          f" K2, {n_other} others, copies {copies}; the most frequent "
          "others: " + "; ".join(
              f"{k[:70]} x{c}" for k, c in
              sorted(others.items(), key=lambda kv: -kv[1])[:6]), flush=True)

    # each form vs plain at the main path's largest shape and at the one
    # with the most work (launches x bound)
    from jolt_tpu_torch.workload import k1_bound_ms
    k1_forms = {}
    for form in kernels.FORMS:
        keys = {k: c for (f, k), c in shapes.items() if f == form}
        largest = max(keys, key=lambda k: k1_bound_ms(form, k)[0])
        heaviest = max(keys, key=lambda k: keys[k] * k1_bound_ms(form, k)[0])
        entry = {"form": form, "launches": k1_counts[form]}
        for tag, key in (("largest", largest), ("heaviest", heaviest)):
            args = k1_args(form, key, draw, draw_int, draw_sums)
            k1_err[form] = max(k1_err[form], compare_k1(
                kernels, form, args, f"at the path's {tag} shape {key}"))
            t = time_k1(kernels, form, args, key)
            entry[tag] = {"key": repr(key), "launches": keys[key], **t}
            print(k1_line(form, key, t, f"{tag} path shape ({keys[key]} "
                          "launches) "), flush=True)
            del args
        entry.update(max_abs_err=k1_err[form], n20=k1_n20[form],
                     **{k: entry["heaviest"][k] for k in
                        ("ms", "plain_ms", "bound_ms", "bound_by")})
        k1_forms[form] = entry
    max_err = max(k1_err.values())
    # K1's headline: the form whose heaviest path shape has the most work
    head = max(k1_forms.values(),
               key=lambda e: e["heaviest"]["launches"] * e["bound_ms"])

    # ---- 6b. the zk and committed-image paths at full width --------------
    # each path's launch counts set to 0 just before it and read just after
    def flag_path(**flags):
        kernels.reset_launches()
        prof = profiling.PROFILER = profiling.Profiler()
        try:
            t0 = time.perf_counter()
            out, s, _, launches_s = timed_stages(
                lambda: prove(tr, setup=setup, device="cuda", **flags))
            t = time.perf_counter() - t0
        finally:
            k1 = kernels.k1_launches()
            k2 = kernels.product_round.launches
            profiling.PROFILER = profiling.Profiler(enabled=False)
        return out, t, s, launches_s, k1, k2, prof

    def stage_cmp(s):
        return ", ".join(f"{k} {v:.3f}s (plain {stage_s[k]:.3f}s)"
                         if k in stage_s else f"{k} {v:.3f}s"
                         for k, v in s.items())

    io_main = PublicIO.from_trace(tr)
    zk_proof, t_zk, zk_s, zk_launches, zk_k1, zk_k2, zk_prof = flag_path(
        zk=True, zk_rng=random.Random(SEED))
    check(sorted(zk_proof.zk_commitments) == sorted(ZK_LABELS),
          f"zk round commitments for {sorted(zk_proof.zk_commitments)}")
    check(all(getattr(zk_proof, f) == [] for f in CLEAR_POLYS),
          "a zk proof carries clear round polynomials")
    check(zk_proof.zk_blindfold is not None, "the zk proof has no BlindFold")
    check(list(zk_s) == DORY_STAGES + ["blindfold"],
          f"zk stage lines: {zk_s}")
    check(zk_k1 == k1_counts and zk_k2 == k2_launches
          and all(zk_launches[k] == stage_launches[k] for k in stage_launches),
          f"zk launched K1 {zk_k1} and K2 {zk_k2} (plain {k1_counts}, "
          f"{k2_launches}); by stage {zk_launches}")
    n_comms = sum(len(v) for v in zk_proof.zk_commitments.values())
    t_commit = zk_prof.total("zk.commit")
    t0 = time.perf_counter()
    check(verify(zk_proof, io_main, setup=setup) is True,
          "verify rejected the zk proof")
    t_zk_verify = time.perf_counter() - t0
    print(f"[zk] prove(setup, zk=True) {t_zk:.3f}s = "
          f"{tr.length / t_zk:.1f} cycles/s (plain {t_prove:.3f}s = "
          f"{cycles_per_s:.1f}); {n_comms} round commitments "
          f"(zk.commit {t_commit:.4f}s), blindfold {zk_s['blindfold']:.3f}s; "
          f"K1 {sum(zk_k1.values())} and K2 {zk_k2} launches == plain; "
          f"verify(setup) {t_zk_verify:.3f}s (plain {t_verify:.3f}s); "
          f"{len(serialize_proof(zk_proof))} B (plain "
          f"{len(serialize_proof(proof))} B)", flush=True)
    print(f"[zk] stages: {stage_cmp(zk_s)}", flush=True)

    ci_proof, t_ci, ci_s, ci_launches, ci_k1, ci_k2, _ = flag_path(
        committed_image=True)
    pi_m = len(image_words(tr.code)).bit_length() - 1
    check("program_image_init" in ci_proof.stage7_openings
          and "program_image" in ci_proof.commitments
          and ci_proof.program_image_claim is not None,
          "the committed-image proof lacks its image claim or opening")
    check(list(ci_s) == DORY_STAGES, f"image stage lines: {ci_s}")
    image_k2 = {"stage7-booleanity": pi_m + 1, "stage8-reduction": pi_m + 1}
    check(all(ci_launches[k]["k2"] == v["k2"] + image_k2.get(k, 0)
              for k, v in stage_launches.items())
          and ci_k2 == k2_launches + 2 * (pi_m + 1),
          f"image run K2 {ci_k2} (plain {k2_launches} + 2 x {pi_m + 1}); "
          f"by stage {ci_launches}")
    check(all(ci_launches[k]["k1"] == v["k1"]
              for k, v in stage_launches.items() if k not in image_k2),
          f"image run K1 outside stages 7 and 8: {ci_launches}")
    k1_extra = {k: sum(ci_launches[k]["k1"].values())
                - sum(stage_launches[k]["k1"].values()) for k in image_k2}
    verifier_mod._PI_COMMIT_CACHE.clear()
    t0 = time.perf_counter()
    check(verify(ci_proof, io_main, setup=setup) is True,
          "verify rejected the committed-image proof")
    t_ci_verify = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(verify(ci_proof, io_main, setup=setup) is True,
          "verify rejected the committed-image proof (cached commitment)")
    t_ci_cached = time.perf_counter() - t0
    print(f"[image] prove(setup, committed_image=True) {t_ci:.3f}s = "
          f"{tr.length / t_ci:.1f} cycles/s (plain {t_prove:.3f}s); image "
          f"{len(image_words(tr.code))} words ({len(tr.code)} code bytes, "
          f"{pi_m} rounds); K2 {ci_k2} = plain {k2_launches} + 2 x "
          f"{pi_m + 1}; K1 {sum(ci_k1.values())} (plain {launches}; extra "
          f"in stages 7/8: {k1_extra}); verify(setup) {t_ci_verify:.3f}s "
          f"recomputing the image commitment, {t_ci_cached:.3f}s cached "
          f"(plain {t_verify:.3f}s)", flush=True)
    print(f"[image] stages: {stage_cmp(ci_s)}", flush=True)
    del zk_proof, ci_proof

    # ---- 7. card vs CPU on the fib trace ---------------------------------
    fib_layout = MemoryLayout(**FIB_LAYOUT)
    fib = trace_program(FIB.format(output_start=fib_layout.output_start,
                                   termination=fib_layout.termination),
                        layout=fib_layout)
    on_card = prove(fib, device="cuda")
    on_cpu = prove(fib, device="cpu")
    check(serialize_proof(on_card) == serialize_proof(on_cpu)
          and on_card.fs_tape == on_cpu.fs_tape,
          "prove differs between cuda and cpu on the fib trace")
    check(verify(on_card, PublicIO.from_trace(fib)) is True,
          "verify rejected the fib proof")
    print(f"[card-vs-cpu] fib ({fib.length} cycles): identical proof bytes "
          f"({len(serialize_proof(on_card))} B); states "
          f"{[e['state'][:16] for e in on_card.fs_tape]}", flush=True)

    def card_vs_cpu(trace, what, setup=None, **flags):
        """The proof's bytes and FS tape on the card and on the CPU (zk
        with the same seed), and verify; returns the proof's size."""
        runs = {}
        for where in ("cuda", "cpu"):
            kw = dict(flags)
            if flags.get("zk"):
                kw["zk_rng"] = random.Random(42)
            runs[where] = prove(trace, setup=setup, device=where, **kw)
        blob = serialize_proof(runs["cuda"])
        check(blob == serialize_proof(runs["cpu"])
              and runs["cuda"].fs_tape == runs["cpu"].fs_tape,
              f"prove differs between cuda and cpu: {what}")
        check(verify(runs["cuda"], PublicIO.from_trace(trace), setup=setup)
              is True, f"verify rejected {what}")
        return len(blob)

    n_zk = card_vs_cpu(fib, "fib with zk", zk=True)
    image_guest = trace_program(IMAGE_GUEST.format(
        output_start=fib_layout.output_start,
        termination=fib_layout.termination), layout=fib_layout,
        min_padded=32)
    n_ci = card_vs_cpu(image_guest, "the image guest with the committed "
                       "image", committed_image=True)
    try:
        prove(fib, device="cuda", zk=True, committed_image=True)
        refused = False
    except NotImplementedError:
        refused = True
    check(refused, "zk=True with committed_image=True was not refused")
    print(f"[card-vs-cpu] fib with zk (Random(42)): identical proof bytes "
          f"({n_zk} B); image guest ({image_guest.length} cycles) with the "
          f"committed image: identical ({n_ci} B); both verified; zk with "
          "the committed image refused on the card", flush=True)
    # stage 6v's instance (d = 2: three factors on K2) on seeded chunks; the
    # claim is any value, since only card == CPU is checked here
    rng = np.random.default_rng(SEED)
    n_v = 1 << RA_VIRTUAL_LOG_T
    idx = rng.integers(0, 1 << RA_VIRTUAL_LOG_K, n_v)
    r_cyc = [int(x) for x in rng.integers(0, 1 << 62, RA_VIRTUAL_LOG_T)]
    r_addr = [int(x) for x in rng.integers(0, 1 << 62, RA_VIRTUAL_LOG_K)]
    chunks = chunk_streams(idx, RA_VIRTUAL_LOG_K)
    check(len(chunks) == 2, "the seeded ra-virtualization is not d = 2")
    runs = {}
    for where in ("cuda", "cpu"):
        inst = RaVirtual(chunks, RA_VIRTUAL_LOG_K, r_cyc, r_addr, 12345,
                         ("ram_ra", 0), device=where)
        acc, transcript = OpeningAccumulator(), Blake2bTranscript(b"6v")
        kernels.product_round.launches = 0
        polys, _ = BatchedSumcheck.prove([inst], acc, transcript)
        runs[where] = (polys, inst.final_openings, acc.openings,
                       transcript.state, kernels.product_round.launches)
    check(runs["cuda"][:4] == runs["cpu"][:4],
          "RaVirtual differs between cuda and cpu")
    check(runs["cuda"][4] == RA_VIRTUAL_LOG_T + 1,
          f"RaVirtual launched K2 {runs['cuda'][4]} times in "
          f"{RA_VIRTUAL_LOG_T} rounds")
    print(f"[card-vs-cpu] RaVirtual d=2 (log K {RA_VIRTUAL_LOG_K}, T = "
          f"2^{RA_VIRTUAL_LOG_T}): identical round polys, openings and "
          f"transcript; K2 launches on the card {runs['cuda'][4]}",
          flush=True)

    # ---- 8. stage 7's largest group, card vs CPU --------------------------
    # booleanity (K1) and Hamming weight (K2 cycle rounds) on seeded
    # streams; the claims are any values, since only card == CPU is checked
    streams = rng.integers(0, ONEHOT_K, (ONEHOT_M, 1 << ONEHOT_LOG_T))
    log_k = ONEHOT_K.bit_length() - 1
    r_cyc = [int(x) for x in rng.integers(2, 1 << 62, ONEHOT_LOG_T)]
    r_addr = [int(x) for x in rng.integers(2, 1 << 62, log_k)]
    for booleanity in (True, False):
        runs = {}
        for where in ("cuda", "cpu"):
            inst = GroupedOneHot(
                streams, ONEHOT_K, eq.evals(r_cyc, where),
                [r_addr if booleanity else None] * ONEHOT_M,
                list(range(ONEHOT_M)), 777, [f"m{i}" for i in
                                             range(ONEHOT_M)],
                booleanity=booleanity, opening_kind="t")
            acc, transcript = OpeningAccumulator(), Blake2bTranscript(b"s7")
            polys, _ = BatchedSumcheck.prove([inst], acc, transcript)
            runs[where] = (polys, inst.final_openings, acc.openings,
                           transcript.state)
        check(runs["cuda"] == runs["cpu"],
              f"GroupedOneHot (booleanity={booleanity}) differs between "
              "cuda and cpu")
        print(f"[card-vs-cpu] GroupedOneHot {'booleanity' if booleanity else 'Hamming'} "
              f"M = {ONEHOT_M}, K = {ONEHOT_K}, T = 2^{ONEHOT_LOG_T}: "
              "identical round polys, openings and transcript", flush=True)
    # the whole proof with a Dory setup, on a guest small enough for the CPU
    small = trace_program(DORY_SMALL.format(
        output_start=fib_layout.output_start,
        termination=fib_layout.termination), layout=fib_layout,
        min_padded=32)
    small_setup = DorySetup.generate(DORY_SMALL_VARS)
    on_card = prove(small, setup=small_setup, device="cuda")
    on_cpu = prove(small, setup=small_setup, device="cpu")
    check(serialize_proof(on_card) == serialize_proof(on_cpu)
          and on_card.fs_tape == on_cpu.fs_tape
          and on_card.fs_tape[-1]["stage"] == "stage8-openings",
          "prove with a Dory setup differs between cuda and cpu")
    check(verify(on_card, PublicIO.from_trace(small), setup=small_setup)
          is True, "verify rejected the small Dory proof")
    print(f"[card-vs-cpu] Dory guest ({small.length} cycles, setup nu="
          f"{small_setup.nu} sigma={small_setup.sigma}): identical proof "
          f"bytes ({len(serialize_proof(on_card))} B) and FS tape "
          f"({len(on_card.fs_tape)} entries); verified", flush=True)
    n_zk = card_vs_cpu(small, "the Dory guest with zk", setup=small_setup,
                       zk=True)
    n_ci = card_vs_cpu(image_guest, "the image guest with Dory and the "
                       "committed image", setup=small_setup,
                       committed_image=True)
    print(f"[card-vs-cpu] with the 2^{DORY_SMALL_VARS} Dory setup: the Dory "
          f"guest with zk ({n_zk} B) and the image guest with the committed "
          f"image ({n_ci} B): identical bytes and FS tapes; verified",
          flush=True)

    # ---- 8b. K3, HyperKZG end to end, Dory's device one-hot tier ---------
    g1_entry = g1_kzg_phase(dev, gen, setup, small, onehot_positions,
                            card_vs_cpu)

    # ---- 9. results -------------------------------------------------------
    print(f"[total] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(card)
    # K2's headline: the main path's round (stage 1s: two factors, bind then
    # message) at 2^18; "ms" is its two kernels' device time
    k2 = k2_times[(2, "bind_message")]
    print(json.dumps({"kernels": [{
        "name": "mont_mul", "route": "cuda",
        "source": "jolt_tpu_torch/csrc/mont_mul.cu",
        "replaces": "jolt_tpu/field/pallas_ops.py:45",
        "launches": launches, "max_abs_err": max_err,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "form": head["form"],
        "shape": head["heaviest"]["key"],
        "forms": list(k1_forms.values()), "reference_shapes": k1_ref,
        "spill_bytes": k1_spills,
        "other_device_kernels": n_other}, {
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
        "product_sumcheck_launches": k2_sumcheck_launches,
        "stage6v_instances": n6v, "ram_log_K": proof.ram_log_K,
        "bytecode_log_K": proof.bytecode_log_K,
        "launches_by_stage": {k: v["k2"] for k, v in
                              stage_launches.items()}}, g1_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
