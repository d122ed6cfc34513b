"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

What it does, in order (any failure exits non-zero and prints no result):

  1. refuses to run without a CUDA device;
  2. builds every CUDA kernel from zprize_wasm_msm_tpu_torch/csrc/ with nvcc
     (all sources in parallel) into build/, prints ptxas's registers and
     spills per kernel and fails if a sweep kernel (K1, K7), a reduction
     kernel (K2's collapse and combine, K3's fold,
     K4's two) or a field kernel (K5, K6, the inversion) spills;
  3. holds the device functions (field and group ops of csrc/field.cuh and
     csrc/group.cuh, both product forms and the complete add on each, and
     the window fold's level-parallel doubling and addition of
     csrc/par.cuh with their product by 3b as additions, a product to a
     lane or shared by several (csrc/coop.cuh)) and the
     elementwise field kernels (Montgomery product, square, inversion) bit
     for bit against the plain PyTorch ops, on the toy field, BN254 Fq and
     BLS12-381 Fq (every field width the sources instantiate), edge values
     0, 1, q-1, (q+-1)/2 and words of all ones (long carry ripples)
     included; and the inversion kernel (a binary GCD of fixed length)
     against the Fermat ladder on the three fields: 0, 1, 2, q-1, (q+-1)/2,
     R mod q, R^-1 mod q, every power of two below R and 4 096 random
     elements, bit for bit, and x * x^-1 = 1;
  4. holds each kernel against its plain PyTorch version at small shapes on
     the toy curve, BN254 and BLS12-381 (zero digits, +-B digits, (0,0)
     points, repeated points that force the doubling case inside a bucket;
     for the sorted engine also single-entry runs, a run spanning several
     chunks, chunks that are all one bucket and an all-zero window), the
     collapse kernel at B = 512 and 4096 against bucket_reduce_grouped, and
     the two sweeps on the cases aimed at their schedules (k1_adversarial:
     one bucket on every step, two buckets alternating; k7_adversarial:
     runs crossing or ending on sub-chunk borders, a zero sub-chunk inside a
     run, steps not a multiple of 32), and the two reductions on theirs
     (k3_adversarial: identity buckets, equal buckets, only the top window,
     P and -P, a fold ending on Q + (-Q), W*B = 1024, B = 1;
     k4_adversarial: identity partials, equal partials, P, -P pairs, T not
     a multiple of the warp, lane counts that end buckets inside lanes, on
     lane ends and across warps; k2_adversarial: identity buckets, every
     bucket one point, only bucket 0, only the top bucket, P and -P in one
     window, at B = 1, 2, 64, 512, 4096 and W = 1, 15, 38);
  5. drives three paths of the public API on BLS12-381 G1 at N = 2^20
     distinct bases (build_bls12381().msm -> result_to_affine), each a few
     timed repetitions, with every kernel's launch count zeroed just before
     and read just after, and verifies each result against the host oracle
     as (sum k_i m_i mod r) G:
       full  msm(P, k, use_glv=False, max_bits=255): full 255-bit scalars,
             c = 7, bucket-sweep engine, collapse + window fold;
       A     msm(P, k): the default — GLV split to 2^21 points and 132-bit
             half-scalars, c = 6, bucket-sweep engine, one-block finish;
       B     msm(P, k, c=10): GLV split, then the sorted engine (sort, sweep,
             segmented scan, scatter), collapse at B = 512, window fold;
     and a batch phase (ctx.batch_mul / batch_square / batch_to_mont /
     batch_from_mont at N = 2^20) against the plain field ops;
  6. calls each kernel's wrapper at its path's shapes, compares it with its
     plain version on the same inputs (exact equality of affine coordinates
     or limbs: integers, tolerance 0) and times both; K1 and K7 also report
     registers, resident warps per SM, ns per add and their time over their
     bound; K3 its bound and its depth floor (c (W-1) doublings and W-1
     additions at the latency of one level-parallel doubling and addition,
     timed here) at all three paths' shapes; K2 its plan (buckets per run,
     groups, the wave), its depth floor (the links of its longest chain at
     the same latencies) and its time at every run length up to 64 (each
     held against the plain version), at the full path's and path B's
     shapes;
     the inversion at one element.

Output: one JSON object per line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Takes a few minutes on an H100, the build included.  Needs no network.

    python3 chip_smoke.py --profile

additionally runs one MSM of each path under torch.profiler and prints a
"profile" line (device time by kernel, device busy share of the profiled
wall time); with a directory argument, --profile DIR, it also writes the
Chrome traces there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

SEED = 123
LOG2N = 20
REPS = 3
PLAIN_LANES = 1024  # lanes of the plain sweep at the main path's shape
C_SORTED = 10  # window of path B: above the bucket kernel's cap, so the sorted engine

# NVIDIA H100 SXM peaks the bounds are computed against.  Memory: 3.35 TB/s
# (data sheet).  32-bit integer multiply-add outside the tensor cores: a
# Hopper SM has 64 INT32 lanes beside its 128 FP32 lanes, so the integer
# rate is half the data sheet's 67 TFLOP/s FP32 rate: 33.5e12 operations per
# second, a multiply-add counted as two operations.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 33.5e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def sync_ms(fn, reps: int = 1):
    """Run fn reps times between CUDA events; returns (last result, ms per
    run).  The caller warms up first where that matters."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = None
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def profile_msm(run_msm, trace_dir, name):
    """One MSM under torch.profiler: device time by kernel and the share of
    the profiled wall time the device was busy.  The profiler's own cost is
    in the wall time, so the busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_msm()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_msm()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    check(bool(rows), "torch.profiler recorded no device activity")
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    rows.sort(key=lambda e: -e.self_device_time_total)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"msm_trace_{name}.json"))
    return {
        "wall_ms_under_profiler": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_launches": sum(e.count for e in rows),
        "by_kernel": [
            {"name": e.key[:60], "count": e.count, "ms": e.self_device_time_total / 1e3}
            for e in rows[:8]
        ],
    }


def affine_err(curve, a, b) -> int:
    """max |difference| of the affine limbs of two point batches."""
    from zprize_wasm_msm_tpu_torch.ops.curve import group

    fa = group.to_affine(curve, tuple(x.reshape(x.shape[0], -1) for x in a))
    fb = group.to_affine(curve, tuple(x.reshape(x.shape[0], -1) for x in b))
    return int(max((u - v).abs().max().item() for u, v in zip(fa, fb)))


def _make_bases(ctx, log2n: int, rng, dev):
    """N = 2^log2n bases [m_i]G as subset sums, built on the device with
    the port's own group ops: seeds [m_0]G, [d_k]G by times_scalar, then
    log2n rounds S <- S u (S + [d_k]G) (one batched complete mixed add
    each) and ONE batched to_affine.  m_i = m_0 + sum_k bit_k(i) d_k."""
    from zprize_wasm_msm_tpu_torch.ops.curve import group

    curve = ctx.spec
    bound = min(1 << 62, curve.r)
    ms = [int(v) for v in rng.integers(1, bound, size=(log2n + 1,), dtype=np.uint64)]
    g = group.generator(curve, (log2n + 1,), dev)
    seeds = group.to_affine(curve, ctx.times_scalar(g, ctx._limbs(ms, 4)))
    S = group.from_affine(curve, (seeds[0][:, :1], seeds[1][:, :1]))
    for k in range(log2n):
        n = S[0].shape[1]
        dk = (seeds[0][:, k + 1 : k + 2].expand(-1, n), seeds[1][:, k + 1 : k + 2].expand(-1, n))
        more = group.add_mixed(curve, S, dk)
        S = tuple(torch.cat([a, b], dim=1) for a, b in zip(S, more))
    X, Y = group.to_affine(curve, S)
    return (X.contiguous(), Y.contiguous()), ms[0], ms[1:]


def k1_adversarial(curve, dev, rng, log2n=10, c=5, lanes=32):
    """K1 (+ K4) against its plain version on digit patterns aimed at the
    sweep's prefetch: every digit of a window in one bucket (the next
    step's prefetched bucket is always stale: forwarding on every step),
    one bucket with alternating signs, a lane alternating between two
    buckets (a bucket stored at step s is read again at step s+2), one
    bucket with zero digits between its hits, random digits with (0,0)
    points.  Returns {case: max |err|}."""
    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.ops.msm import pl_bucket

    ctx = Z.build_curve(curve, device=dev)
    (X, Y), _, _ = _make_bases(ctx, log2n, rng, dev)
    N, B = 1 << log2n, 1 << (c - 1)
    step = torch.arange(N, device=dev) // lanes  # lane t's step s holds point t + s*T
    rows = {
        "one bucket every step": torch.full((N,), 3, device=dev),
        "one bucket, alternating signs": torch.where(step % 2 == 0, B, -B),
        "alternating two buckets": torch.where(step % 2 == 0, 5, -7),
        "one bucket, zero digits between": torch.where(step % 2 == 0, 2, 0),
        "two buckets, runs of three": torch.where(step % 6 < 3, -1, 1 + (step % 2)),
        "random": torch.as_tensor(rng.integers(-B, B + 1, size=N), device=dev),
    }
    digits = torch.stack(list(rows.values())).to(torch.int32).contiguous()
    X, Y = X.clone(), Y.clone()
    X[:, 3 * lanes : 3 * lanes + 5], Y[:, 3 * lanes : 3 * lanes + 5] = 0, 0  # (0,0) points
    X[:, 5 * lanes + 1], Y[:, 5 * lanes + 1] = X[:, 1], Y[:, 1]  # lane 1 adds one point twice
    got = pl_bucket.bucket_accumulate(curve, (X, Y), digits, lanes=lanes, c=c)
    ref = pl_bucket.bucket_accumulate_plain(curve, (X, Y), digits, lanes=lanes, c=c)
    return {name: affine_err(curve, tuple(a[:, w] for a in got), tuple(a[:, w] for a in ref))
            for w, name in enumerate(rows)}


def k7_adversarial(curve, dev, rng, chunks=16, steps=37, n_points=96):
    """K7 against sweep_plain on streams aimed at the split schedule (S = 32
    lanes per chunk, lane k walking ceil(steps / S) positions): one run
    crossing every sub-chunk border, runs ending on the last position of a
    sub-chunk, runs ending on the first position of the next sub-chunk, a
    sub-chunk of zero digits between two halves of one run, singletons,
    and a sorted random window; steps need not be a multiple of 32.  The
    streams are built directly (perm, meta, slot), not by sorting, so every
    pattern lands where it is aimed.  Returns {case: max |err|}."""
    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.ops.msm import pl_sorted

    ctx = Z.build_curve(curve, device=dev)
    (X, Y), _, _ = _make_bases(ctx, 7, rng, dev)
    X, Y = X[:, :n_points].clone(), Y[:, :n_points].clone()
    X[:, 5], Y[:, 5] = 0, 0  # a (0,0) point
    N = chunks * steps
    sub = -(-steps // 32)
    c = max(10, N.bit_length() + 1)  # K = B + chunks slots hold every flush, singletons included
    pos = torch.arange(N, device=dev) % steps  # position inside its chunk
    zero_lane = (pos >= sub) & (pos < 2 * sub)
    keys = {
        "one run crossing every sub-chunk": torch.full((N,), 7, device=dev),
        "runs ending on a sub-chunk's last position": pos // sub,
        "runs ending on a sub-chunk's first position": (pos + sub - 1) // sub,
        "runs ending one before a sub-chunk's last": (pos + 1) // sub,
        "zero sub-chunk inside one run": torch.full((N,), 3, device=dev),
        "singletons": pos,
        "sorted random": torch.sort(torch.as_tensor(rng.integers(0, 40, size=N), device=dev))[0],
    }
    skey = torch.stack([k.to(torch.int32) for k in keys.values()])
    W = skey.shape[0]
    nxt = torch.cat([skey[:, 1:], torch.full_like(skey[:, :1], -1)], dim=1)
    boundary = (skey != nxt) | (pos == steps - 1)[None]
    zero = torch.zeros_like(boundary)
    zero[4] = zero_lane & (pos != steps - 1)  # the run's last position stays nonzero
    zero[6] = torch.as_tensor(rng.random(N) < 0.2, device=dev)
    neg = torch.as_tensor(rng.random((W, N)) < 0.5, device=dev)
    meta = (boundary.to(torch.int32) * pl_sorted.META_BOUNDARY + zero.to(torch.int32) * pl_sorted.META_ZERO
            + neg.to(torch.int32) * pl_sorted.META_NEG)
    perm = torch.as_tensor(rng.integers(0, n_points, size=(W, N)), device=dev).to(torch.int32)
    perm[:, 1::7] = perm[:, 0:-1:7]  # the same point twice in a row: the doubling case
    slot, seg = pl_sorted.compact_index(skey, meta, c, chunks)
    K = seg.shape[1]
    got = pl_sorted.sweep(curve, (X, Y), perm, meta, slot, K, chunks)
    ref = pl_sorted.sweep_plain(curve, (X, Y), perm, meta, slot, K, chunks)
    return {name: affine_err(curve, tuple(a[:, w] for a in got), tuple(a[:, w] for a in ref))
            for w, name in enumerate(keys)}


def k3_adversarial(curve, dev, rng):
    """K3 (both launches) against finish_plain, as affine points, on inputs
    aimed at its ladder, tree and fold: every bucket the identity; every
    bucket the same point (the weighting tree and the fold add equal
    points); only the top window nonzero; P and -P in one window; a fold
    that ends on Q + (-Q); W*B exactly FINISH_LANES; B = 1.  Returns
    {case: max |err|}."""
    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.ops.curve import group
    from zprize_wasm_msm_tpu_torch.ops.msm import pl_reduce

    ctx = Z.build_curve(curve, device=dev)
    (X, Y), _, _ = _make_bases(ctx, 10, rng, dev)
    P = group.from_affine(curve, (X, Y))
    n = X.shape[1]

    def take(W, B, idx=None):
        idx = torch.as_tensor(rng.integers(0, n, size=W * B), device=dev) if idx is None else idx
        return tuple(a[:, idx].reshape(a.shape[0], W, B).contiguous() for a in P)

    def ident(W, B):
        return tuple(z.contiguous() for z in group.zero(curve, (W, B), dev))

    cases = {}
    cases["all buckets the identity"] = (ident(5, 8), 4)
    cases["every bucket one point"] = (take(6, 16, torch.full((96,), 7, device=dev)), 5)
    cases["every bucket one point, B = 1"] = (take(9, 1, torch.full((9,), 7, device=dev)), 4)
    top = ident(7, 8)
    for i, a in enumerate(take(1, 8)):
        top[i][:, 6:] = a
    cases["only the top window nonzero"] = (top, 4)
    pm = take(4, 8)
    neg = group.neg(curve, tuple(a[:, 2, 0] for a in pm))
    for i in range(3):
        pm[i][:, 2, 1] = neg[i]  # bucket weights 1 and 2: P - 2P, and P, -P in one window
        pm[i][:, 3, 5] = neg[i]
        pm[i][:, 3, 4] = pm[i][:, 2, 0]
    cases["P and -P in one window"] = (pm, 4)
    c = 3
    p1 = tuple(a[:, 5] for a in P)
    q = p1
    for _ in range(c):
        q = group.double(curve, q)
    fold = tuple(torch.stack([x, y], dim=1)[:, :, None].contiguous()
                 for x, y in zip(group.neg(curve, q), p1))  # S_0 = -2^c P, S_1 = P
    cases["fold ending on Q + (-Q)"] = (fold, c)
    cases["W*B = 1024"] = (take(32, 32), 6)
    cases["B = 1, W = 38"] = (take(38, 1), 7)
    out = {}
    for name, (bk, cc) in cases.items():
        got = pl_reduce.finish(curve, bk, cc)
        ref = pl_reduce.finish_plain(curve, bk, cc)
        out[name] = affine_err(curve, tuple(x[:, None] for x in got), tuple(x[:, None] for x in ref))
    return out


def k4_adversarial(curve, dev, rng):
    """K4 (even split + combine) against lane_reduce_plain on inputs aimed
    at its schedule: identity partials; all T partials of a bucket equal;
    P, -P pairs; T not a multiple of the warp; lane counts that end
    buckets inside a lane, on a lane's end and across warps (a bucket over
    several warps), and lanes left empty.  Returns {case: max |err|}."""
    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.ops.curve import group
    from zprize_wasm_msm_tpu_torch.ops.msm import _launch, pl_reduce

    ctx = Z.build_curve(curve, device=dev)
    (X, Y), _, _ = _make_bases(ctx, 10, rng, dev)
    P = group.from_affine(curve, (X, Y))
    npts = X.shape[1]
    NW = curve.fq.n_words
    out = {}
    for W, B, T, lanes in ((3, 4, 37, (32, 64, 160, 448)), (2, 2, 100, (32, 64, 96)),
                           (2, 4, 64, (32, 256, 512)), (1, 1, 5, (32,))):
        idx = torch.as_tensor(rng.integers(0, npts, size=(B, W, T)), device=dev)
        base = tuple(a[:, idx].permute(1, 0, 2, 3).contiguous() for a in P)  # (B, L, W, T)
        zero = group.zero(curve, (B, W, T), dev)
        ident = tuple(z.permute(1, 0, 2, 3).contiguous() for z in zero)
        same = tuple(a[:, :, :, :1].expand(-1, -1, -1, T).contiguous() for a in base)
        pairs = tuple(a.clone() for a in base)
        neg = group.neg(curve, tuple(a[:, :, :, 0::2].permute(1, 0, 2, 3) for a in base))
        for i in range(3):
            pairs[i][:, :, :, 1::2] = neg[i].permute(1, 0, 2, 3)[:, :, :, : T // 2]
        mixed = tuple(a.clone() for a in base)
        for i in range(3):
            mixed[i][:, :, :, 3::4] = ident[i][:, :, :, 3::4]
        for case, lanes_in in (("identity partials", ident), ("all partials equal", same),
                               ("P, -P pairs", pairs), ("random, identities", mixed)):
            want = pl_reduce.lane_reduce_plain(curve, lanes_in)
            got = pl_reduce.lane_reduce(curve, lanes_in)
            out[f"{case}, W={W} B={B} T={T}"] = affine_err(curve, got, want)
            words = _launch.pack_point(tuple(b.permute(1, 2, 3, 0) for b in lanes_in))
            state = words.reshape(3 * NW, W, T, B).permute(1, 2, 3, 0).contiguous()
            for N in lanes:
                if N >= W * B:
                    got = pl_reduce._lane_reduce_state(curve, state, lanes=N)
                    out[f"{case}, W={W} B={B} T={T}, {N} lanes"] = affine_err(curve, got, want)
    return out


def k2_adversarial(curve, dev, rng):
    """K2 (collapse_kernel + combine_kernel) against collapse_plain, as
    affine points, at B in (1, 2, 64, 512, 4096) and W in (1, 15, 38): every
    bucket the identity, every bucket one point (the tree adds equal
    points), only bucket 0, only the top bucket, -P and P at weights 1 and 2
    (-P + 2P, and in the tree runs that cancel); at W = 15 and 38 the
    five cases are windows of one call beside random ones, at W = 1 each
    bucket count takes one of them.  Returns {case: max |err|}."""
    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.ops.curve import group
    from zprize_wasm_msm_tpu_torch.ops.msm import pl_reduce

    ctx = Z.build_curve(curve, device=dev)
    (X, Y), _, _ = _make_bases(ctx, 10, rng, dev)
    P = group.from_affine(curve, (X, Y))
    npts = X.shape[1]
    ident = tuple(z[:, None] for z in group.zero(curve, (), dev))
    p0 = tuple(a[:, 5:6] for a in P)
    neg = group.neg(curve, p0)

    def window(case, B):
        """(L, B) x3 buckets of one window."""
        idx = torch.as_tensor(rng.integers(0, npts, size=B), device=dev)
        w = [a[:, idx].clone() for a in P]
        for i in range(3):
            if case == "identity buckets":
                w[i][:] = ident[i]
            elif case == "every bucket one point":
                w[i][:] = p0[i]
            elif case in ("only bucket 0", "only the top bucket"):
                keep = 0 if case == "only bucket 0" else B - 1
                w[i][:] = ident[i]
                w[i][:, keep] = P[i][:, 7]
            elif case == "P and -P" and B >= 2:
                w[i][:, 0] = neg[i][:, 0]  # weight 1: -P
                w[i][:, 1] = p0[i][:, 0]  # weight 2: P (P and -P in one window)
        return w

    cases = ("identity buckets", "every bucket one point", "only bucket 0",
             "only the top bucket", "P and -P")
    out = {}
    for i, B in enumerate((1, 2, 64, 512, 4096)):
        # W = 1: one case a bucket count, each case at one of them
        calls = [(f"{cases[i]}, W=1", [cases[i]])]
        calls += [(f"the five cases and random windows, W={W}", list(cases) + ["random"] * (W - 5))
                  for W in (15, 38)]
        for name, kinds in calls:
            wins = [window(k, B) for k in kinds]
            bk = tuple(torch.stack([w[i] for w in wins], dim=1).contiguous() for i in range(3))
            got = pl_reduce.collapse(curve, bk)
            want = pl_reduce.collapse_plain(curve, bk)
            out[f"B={B}: {name}"] = affine_err(curve, got, want)
    return out


def inverse_check(fq, dev, rng):
    """field_inverse_kernel against inverse_plain (Fermat), limbs bit for
    bit, on the stored values 0, 1, 2, q-1, (q+-1)/2, R mod q, R^{-1} mod q,
    powers of two and 4 096 random values; and x * x^{-1} = 1 (x != 0).
    Returns the number of elements held."""
    from zprize_wasm_msm_tpu_torch.ops.field import kernels as field_kernels
    from zprize_wasm_msm_tpu_torch.ops.field import mont
    from zprize_wasm_msm_tpu_torch.utils.limbs import ints_to_limbs

    q, R = fq.q, 1 << (32 * fq.n_words)
    vals = [0, 1, 2, q - 1, (q - 1) // 2, (q + 1) // 2, R % q, pow(R, -1, q)]
    vals += [pow(2, k, q) for k in range(32 * fq.n_words)]
    vals += [int.from_bytes(rng.bytes(64), "little") % q for _ in range(4096)]
    x = torch.as_tensor(ints_to_limbs(vals, fq.n_limbs).astype(np.int64), device=dev)
    got = field_kernels.inverse(fq, x)
    want = field_kernels.inverse_plain(fq, x)
    torch.cuda.synchronize()
    check(bool((got == want).all()), f"{fq!r}: field inverse kernel != mont.inverse")
    one = mont.mont_mul(fq, x, got)
    ok = (one == mont.one_mont(fq, (len(vals),), dev)).all(0) | (x == 0).all(0)
    check(bool(ok.all()), f"{fq!r}: x * inverse(x) != 1")
    return len(vals)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", nargs="?", const="", default=None, metavar="DIR",
                        help="also profile one MSM; write the Chrome trace to DIR if given")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        sys.exit(2)

    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch import _build
    from zprize_wasm_msm_tpu_torch.models.curves import bls12_381, bn254, toy
    from zprize_wasm_msm_tpu_torch.ops.curve import device_check, group
    from zprize_wasm_msm_tpu_torch.ops.field import kernels as field_kernels
    from zprize_wasm_msm_tpu_torch.ops.field import mont
    from zprize_wasm_msm_tpu_torch.ops.msm import (
        _launch, glv, pippenger, pl_bucket, pl_reduce, pl_sorted, windows,
    )
    from zprize_wasm_msm_tpu_torch.oracle import Curve as OracleCurve
    from zprize_wasm_msm_tpu_torch.utils.convert import unpack_words

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc_version = subprocess.run(
        [_build._nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-2:]

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    for stem in _build.STEMS:
        _build.load(stem)
    ptxas, ptxas_by_kernel = [], {}
    for stem in _build.STEMS:
        # the log of the library that was loaded: its name carries the
        # sources' hash, as the library's does
        log_path = _build.log_path(stem)
        check(log_path.exists(), f"no compiler log {log_path.name} beside the loaded library")
        lines = log_path.read_text().splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line:
                used = next((l for l in lines[i + 1 : i + 6] if "Used" in l), "")
                spill = next((l for l in lines[i + 1 : i + 6] if "spill" in l), "")
                name = line.split("'")[1]
                ptxas.append(f"{stem}:{name[:48]}: {used.split(':')[-1].strip()} | {spill.strip()}")
                ptxas_by_kernel[name] = {"used": used.split(":")[-1].strip(), "spill": spill.strip()}
    emit({
        "env": {
            "torch": torch.__version__, "cuda": torch.version.cuda, "nvcc": nvcc_version,
            "python": sys.version.split()[0],
        },
        "build_seconds": round(build_s, 2),
        "built": sorted(logs),
        "ptxas": ptxas,
    })

    def kernel_resources(stem, kernel, entry, nw, threads, *args):
        """ptxas's registers, stack frame and spills of kernel<nw> and what
        the runtime says of it (registers, local bytes, blocks per SM;
        entry None: ptxas only); fails on a spill."""
        tag = f"{len(kernel)}{kernel}ILi{nw}E"  # as mangled: combine_kernel is not lane_combine_kernel
        found = [v for k, v in ptxas_by_kernel.items() if tag in k]
        check(len(found) == 1, f"no ptxas report for {tag}")
        spill = [int(w) for w in found[0]["spill"].split() if w.isdigit()]
        check(len(spill) == 3 and spill[1] == 0 and spill[2] == 0,
              f"{tag} spills: {found[0]['spill']}")
        info = _build.kernel_info(stem, entry, nw, *args) if entry else {}
        return {"ptxas": found[0], "stack_frame_bytes": spill[0], "spill_store_bytes": spill[1],
                "spill_load_bytes": spill[2], **info, "threads_per_block": threads,
                **({"resident_warps_per_sm": info["blocks_per_sm"] * threads // 32} if info else {})}

    sweep_res = {
        (name, nw): kernel_resources(stem, kernel, entry, nw, 64)
        for name, stem, kernel, entry in (
            ("bucket_sweep", "bucket", "bucket_sweep_kernel", "zp_bucket_sweep_info"),
            ("sorted_sweep", "sorted", "sorted_sweep_kernel", "zp_sorted_sweep_info"),
        )
        for nw in _build.SUPPORTED_WORDS
    }
    emit({"sweep_resources": {f"{k[0]} NW={k[1]}": v for k, v in sweep_res.items()}})
    reduce_res = {
        (name, nw): kernel_resources(stem, kernel, entry, nw, threads, *args)
        for name, stem, kernel, entry, threads, args in (
            ("finish (fold)", "reduce", "finish_kernel", "zp_finish_info", 32, ()),
            ("collapse", "reduce", "collapse_kernel", "zp_collapse_info", 128, (0,)),
            ("collapse (combine)", "reduce", "combine_kernel", "zp_collapse_info", 128, (1,)),
            ("lane_reduce", "bucket", "lane_reduce_kernel", "zp_lane_reduce_info", 128, ()),
            ("lane_reduce (combine)", "bucket", "lane_combine_kernel", None, 128, ()),
        )
        for nw in _build.SUPPORTED_WORDS
    }
    emit({"reduce_resources": {f"{k[0]} NW={k[1]}": v for k, v in reduce_res.items()}})
    field_res = {
        (kernel, nw): kernel_resources("field_kernels", kernel, "zp_field_info", nw, threads, which)
        for which, (kernel, threads) in enumerate(
            (("mont_mul_kernel", 128), ("mont_square_kernel", 128), ("field_inverse_kernel", 64)))
        for nw in _build.SUPPORTED_WORDS
    }
    emit({"field_resources": {f"{k[0]} NW={k[1]}": v for k, v in field_res.items()}})

    def oracle_of(curve):
        return OracleCurve(q=curve.q, a=0, b=curve.b, r=curve.r, gx=curve.gx, gy=curve.gy)

    def make_bases(ctx, log2n: int, rng):
        return _make_bases(ctx, log2n, rng, dev)

    def base_multiples(log2n, m0, ds, mod):
        idx = np.arange(1 << log2n)
        out = np.full(1 << log2n, m0, dtype=object)
        for k, d in enumerate(ds):
            out = out + ((idx >> k) & 1).astype(object) * d
        return out % mod

    rng = np.random.default_rng(SEED)

    # ---- 3. device functions, bit for bit -----------------------------------
    t0 = time.perf_counter()
    dev_fn_report = {}
    for curve in (toy, bn254, bls12_381):
        fq = curve.fq
        ctx = Z.build_curve(curve)
        q = fq.q
        edges = [0, 1, q - 1, q // 2, q // 2 + 1]
        A = [x for x in edges for _ in edges] + [int.from_bytes(rng.bytes(48), "little") % q for _ in range(999)]
        Bv = [y for _ in edges for y in edges] + [int.from_bytes(rng.bytes(48), "little") % q for _ in range(999)]
        a = ctx._limbs([fq.to_mont_int(v) for v in A], fq.n_limbs)
        b = ctx._limbs([fq.to_mont_int(v) for v in Bv], fq.n_limbs)
        # stored words that make long carry ripples: all ones below the top
        # word, q with a borrow through its low word, the top bit below q's
        nw = fq.n_words
        ripple = [v % q for v in ((1 << (32 * (nw - 1))) - 1, q - (1 << 32), 1 << (32 * nw - 2))]
        rw = ctx._limbs([x for x in ripple + edges for _ in ripple + edges], fq.n_limbs)
        rv = ctx._limbs([y for _ in ripple + edges for y in ripple + edges], fq.n_limbs)
        a, b = torch.cat([a, rw], dim=1), torch.cat([b, rv], dim=1)
        mul_ref = mont.mont_mul(fq, a, b)
        b3 = mont._int_const(fq, fq.to_mont_int(3 * curve.b), dev)[:, None].expand_as(a)
        for op, ref in (
            ("mul", mul_ref), ("mul_cc", mul_ref), ("add", mont.add(fq, a, b)),
            ("sub", mont.sub(fq, a, b)), ("neg", mont.neg(fq, a)),
            ("mul_b3", mont.mont_mul(fq, b3, a)), ("mul_coop", mul_ref),
        ):
            got = device_check.field_op(curve, op, a, b)
            torch.cuda.synchronize()
            check(bool((got == ref).all()), f"{curve.name}: device fe_{op} != mont")
        # the product and square kernels, bit for bit: every pair of edge
        # values, random values, and one constant operand for the batch
        for got, ref, what in (
            (field_kernels.mont_mul(fq, a, b), mont.mont_mul(fq, a, b), "mont_mul"),
            (field_kernels.mont_mul(fq, a, b[:, 30:31]), mont.mont_mul(fq, a, b[:, 30:31]),
             "mont_mul by one constant"),
            (field_kernels.mont_square(fq, a), mont.mont_square(fq, a), "mont_square"),
        ):
            torch.cuda.synchronize()
            check(bool((got == ref).all()), f"{curve.name}: {what} kernel != mont")
        # group ops: generic points, identity, P = Q, P = -Q, affine (0,0)
        (PX, PY), _, _ = make_bases(ctx, 6, rng)
        QX, QY = PX.roll(1, dims=1).clone(), PY.roll(1, dims=1).clone()
        QX[:, 0:4], QY[:, 0:4] = PX[:, 0:4], PY[:, 0:4]  # P = Q
        QY[:, 4:8] = mont.neg(fq, PY[:, 4:8])
        QX[:, 4:8] = PX[:, 4:8]  # P = -Q
        QX[:, 8:12], QY[:, 8:12] = 0, 0  # affine identity
        # the same points on a non-trivial projective representative:
        # (lambda X, lambda Y, lambda) with random lambda
        lam = a[:, 25 : 25 + PX.shape[1]]
        P = (mont.mont_mul(fq, PX, lam), mont.mont_mul(fq, PY, lam), lam.clone())
        for i, coord in enumerate(group.zero(curve, (4,), dev)):
            P[i][:, 12:16] = coord  # projective identity
        Q = group.from_affine(curve, (QX, QY))
        add_ref = group.add(curve, P, Q)
        for op, ref, qin in (
            ("add", add_ref, Q), ("add_cc", add_ref, Q),
            ("add_mixed", group.add_mixed(curve, P, (QX, QY)), (QX, QY, Q[2])),
            ("double", group.double(curve, P), Q),
            ("add_par", add_ref, Q), ("double_par", group.double(curve, P), Q),
            ("add_coop", add_ref, Q), ("double_coop", group.double(curve, P), Q),
        ):
            got = device_check.group_op(curve, op, P, qin)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                check(bool((g == r).all()), f"{curve.name}: device pt_{op} != group")
        # the fold's ops on coordinates that are any field values: the edge
        # and ripple operands above, three to a point
        m = a.shape[1] // 3
        Pr = tuple(a[:, i * m : (i + 1) * m].contiguous() for i in range(3))
        Qr = tuple(b[:, i * m : (i + 1) * m].contiguous() for i in range(3))
        add_r, dbl_r = group.add(curve, Pr, Qr), group.double(curve, Pr)
        for op, ref in (("add_par", add_r), ("double_par", dbl_r), ("add_coop", add_r),
                        ("double_coop", dbl_r), ("add", add_r), ("double", dbl_r)):
            got = device_check.group_op(curve, op, Pr, Qr)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                check(bool((g == r).all()), f"{curve.name}: device pt_{op} != group on edge coordinates")
        dev_fn_report[curve.name] = (
            "mul/mul_cc/mul_b3/mul_coop/add/sub/neg + mont_mul/mont_square kernels"
            " + add_mixed/add/add_cc/double/add_par/double_par/add_coop/double_coop bit-equal"
        )
    emit({"device_functions": dev_fn_report, "seconds": round(time.perf_counter() - t0, 2)})

    # the field inversion (a binary GCD of fixed length) against the Fermat
    # ladder on all three fields: edge values, powers of two, 4 096 random
    # values; a generator of its own, so the paths below get the same data
    t0 = time.perf_counter()
    inv_rng = np.random.default_rng(SEED + 3)
    inv_report = {c.name: inverse_check(c.fq, dev, inv_rng) for c in (toy, bn254, bls12_381)}
    emit({"field_inverse_check": {"elements_bit_equal": inv_report, "tolerance": 0,
                                  "seconds": round(time.perf_counter() - t0, 2)}})

    # ---- 4. kernels against their plain versions, small shapes ---------------
    def kernel_checks(curve, log2n, c, max_bits, lanes, tag):
        """Each kernel against its plain version; returns the errors (all
        must be 0)."""
        ctx = Z.build_curve(curve)
        (X, Y), _, _ = make_bases(ctx, log2n, rng)
        N = 1 << log2n
        B = 1 << (c - 1)
        W = windows.num_windows(max_bits, c)
        digits = torch.as_tensor(
            rng.integers(-B, B + 1, size=(W, N)).astype(np.int32), device=dev
        )
        digits[:, 0:8] = 0
        digits[:, 8:12] = B
        digits[:, 12:16] = -B
        X[:, 16:20], Y[:, 16:20] = 0, 0  # (0,0) points
        for src, dst in ((24, 25), (24, 24 + lanes), (40, 41), (40, 40 + lanes)):
            X[:, dst], Y[:, dst] = X[:, src], Y[:, src]
            digits[:, dst] = digits[:, src]  # same point twice into one bucket
        errs = {}
        got = pl_bucket.bucket_accumulate(curve, (X, Y), digits, lanes=lanes, c=c)
        ref = pl_bucket.bucket_accumulate_plain(curve, (X, Y), digits, lanes=lanes, c=c)
        torch.cuda.synchronize()
        errs["bucket_sweep+lane_reduce"] = affine_err(curve, got, ref)
        # lane_reduce on K4's contract layout (B, L, W, T): three lanes
        lanes3 = tuple(
            torch.stack([s, d, z], dim=-1).permute(2, 0, 1, 3).contiguous()
            for s, d, z in zip(ref, group.double(curve, ref), group.zero(curve, (W, B), dev))
        )
        errs["lane_reduce"] = affine_err(
            curve, pl_reduce.lane_reduce(curve, lanes3), pl_reduce.lane_reduce_plain(curve, lanes3)
        )
        errs["collapse"] = affine_err(
            curve, pl_reduce.collapse(curve, ref), pl_reduce.collapse_plain(curve, ref)
        )
        sums = pl_reduce.collapse_plain(curve, ref)
        fold_in = tuple(a[:, :, None] for a in sums)
        errs["finish(B=1)"] = affine_err(
            curve,
            tuple(x[:, None] for x in pl_reduce.finish(curve, fold_in, c)),
            tuple(x[:, None] for x in pl_reduce.finish_plain(curve, fold_in, c)),
        )
        if W * B <= pl_reduce.FINISH_LANES:
            errs[f"finish(B={B})"] = affine_err(
                curve,
                tuple(x[:, None] for x in pl_reduce.finish(curve, ref, c)),
                tuple(x[:, None] for x in pl_reduce.finish_plain(curve, ref, c)),
            )
        torch.cuda.synchronize()
        for name, e in errs.items():
            check(e == 0, f"{tag}: kernel {name} disagrees with its plain version (max |err| {e})")
        return errs

    def sorted_checks(curve, log2n, c, chunks, tag):
        """The sorted engine's kernels against their plain versions on one
        given sorted stream, and its dense buckets against the bucket
        engine's plain version."""
        ctx = Z.build_curve(curve)
        (X, Y), _, _ = make_bases(ctx, log2n, rng)
        N = 1 << log2n
        B = 1 << (c - 1)
        steps = N // chunks
        digits = torch.as_tensor(rng.integers(-B, B + 1, size=(5, N)).astype(np.int32), device=dev)
        digits[:, 0:8] = 0
        digits[:, 8:12] = B
        digits[:, 12:16] = -B
        X[:, 16:20], Y[:, 16:20] = 0, 0  # (0,0) points
        X[:, 25], Y[:, 25] = X[:, 24], Y[:, 24]
        digits[:, 25] = digits[:, 24]  # same point twice in one run: the doubling case
        digits[1, :] = 0  # an all-zero window
        digits[2, :] = 2  # every chunk is all one bucket: ONE run spanning all chunks
        digits[2, 5] = -1  # and a single-entry run before it
        digits[3, : 3 * steps + 1] = -3  # a run spanning several chunks, ending inside one
        digits[4, 1::2] = 0
        perm, skey, meta = pl_sorted.sort_runs(digits, c, chunks)
        slot, seg = pl_sorted.compact_index(skey, meta, c, chunks)
        K = seg.shape[1]
        pieces = pl_sorted.sweep(curve, (X, Y), perm, meta, slot, K, chunks)
        pieces_plain = pl_sorted.sweep_plain(curve, (X, Y), perm, meta, slot, K, chunks)
        errs = {"sorted_sweep": affine_err(curve, pieces, pieces_plain)}
        errs["segscan"] = affine_err(
            curve, pl_sorted.segscan(curve, pieces_plain, seg, chunks),
            pl_sorted.segscan_plain(curve, pieces_plain, seg, chunks),
        )
        dense = pl_sorted.bucket_accumulate_sorted(curve, (X, Y), digits, c, chunks)
        ref = pl_bucket.bucket_accumulate_plain(curve, (X, Y), digits, lanes=16, c=c)
        errs["sort+sweep+segscan+scatter"] = affine_err(curve, dense, ref)
        errs[f"collapse(B={B})"] = affine_err(
            curve, pl_reduce.collapse(curve, ref), pl_reduce.collapse_plain(curve, ref)
        )
        torch.cuda.synchronize()
        for name, e in errs.items():
            check(e == 0, f"{tag}: kernel {name} disagrees with its plain version (max |err| {e})")
        return errs

    def collapse_check(curve, B):
        """collapse_kernel above its former cap, against bucket_reduce_grouped."""
        ctx = Z.build_curve(curve)
        (X, Y), _, _ = make_bases(ctx, 12, rng)
        P = group.from_affine(curve, (X, Y))
        n = X.shape[1]
        # three windows of B buckets cut from the 4096 points, one holding an
        # empty (identity) bucket
        idx = (torch.arange(3 * B, device=dev) * 7) % n
        buckets = [a[:, idx].reshape(a.shape[0], 3, B).contiguous() for a in P]
        for i, coord in enumerate(group.zero(curve, (), dev)):
            buckets[i][:, 1, B - 1] = coord
        e = affine_err(curve, pl_reduce.collapse(curve, tuple(buckets)),
                       pl_reduce.collapse_plain(curve, tuple(buckets)))
        check(e == 0, f"collapse at B={B} disagrees with bucket_reduce_grouped (max |err| {e})")
        return e

    t0 = time.perf_counter()
    small = {
        "toy c=7 W=4 B=64": kernel_checks(toy, 12, 7, 16, 64, "toy c=7"),
        "toy c=4 W=5 B=8": kernel_checks(toy, 10, 4, 16, 16, "toy c=4"),
        "bn254 c=5 W=52 B=16": kernel_checks(bn254, 10, 5, 254, 32, "bn254 c=5"),
        "bls12_381 c=7 W=38 B=64": kernel_checks(bls12_381, 12, 7, 255, 64, "bls12_381 c=7"),
        "bls12_381 c=6 W=23 B=32": kernel_checks(bls12_381, 10, 6, 132, 32, "bls12_381 c=6"),
        "sorted toy c=4 T=16": sorted_checks(toy, 9, 4, 16, "sorted toy c=4"),
        "sorted toy c=10 T=64": sorted_checks(toy, 11, 10, 64, "sorted toy c=10"),
        "sorted bn254 c=8 T=32": sorted_checks(bn254, 9, 8, 32, "sorted bn254 c=8"),
        "sorted bls12_381 c=10 T=64": sorted_checks(bls12_381, 10, 10, 64, "sorted bls12_381 c=10"),
        "bls12_381 collapse B=512": collapse_check(bls12_381, 512),
        "bls12_381 collapse B=4096": collapse_check(bls12_381, 4096),
    }
    emit({"kernels_small_shapes_max_abs_err": small, "tolerance": 0,
          "seconds": round(time.perf_counter() - t0, 2)})

    # the sweeps' schedules on the cases aimed at them: K1's prefetch and its
    # same-bucket forwarding, K7's sub-chunk split and segmented combine
    t0 = time.perf_counter()
    adversarial = {}
    for c_curve in (toy, bn254, bls12_381):
        for case, e in k1_adversarial(c_curve, dev, rng).items():
            adversarial[f"K1 {c_curve.name} c=5 T=32: {case}"] = e
        for chunks, steps in ((16, 37), (4, 5), (8, 71), (4, 100), (2, 64)):
            for case, e in k7_adversarial(c_curve, dev, rng, chunks, steps).items():
                adversarial[f"K7 {c_curve.name} T={chunks} steps={steps}: {case}"] = e
    torch.cuda.synchronize()
    for case, e in adversarial.items():
        check(e == 0, f"{case}: kernel disagrees with its plain version (max |err| {e})")
    emit({"sweeps_adversarial_max_abs_err": adversarial, "tolerance": 0,
          "seconds": round(time.perf_counter() - t0, 2)})

    # the reductions' schedules on the cases aimed at them: K3's ladder, tree
    # and fold, K4's even split, warp scan and combine across warps.  Their
    # inputs come from a generator of their own, so the paths below get the
    # same bases and scalars as before these cases existed (K8's time, for
    # one, follows the longest segment that data makes)
    t0 = time.perf_counter()
    adversarial = {}
    red_rng = np.random.default_rng(SEED + 1)
    for c_curve in (toy, bn254, bls12_381):
        for case, e in k3_adversarial(c_curve, dev, red_rng).items():
            adversarial[f"K3 {c_curve.name}: {case}"] = e
        for case, e in k4_adversarial(c_curve, dev, red_rng).items():
            adversarial[f"K4 {c_curve.name}: {case}"] = e
    k2_rng = np.random.default_rng(SEED + 2)
    for c_curve in (toy, bn254, bls12_381):
        for case, e in k2_adversarial(c_curve, dev, k2_rng).items():
            adversarial[f"K2 {c_curve.name}: {case}"] = e
    torch.cuda.synchronize()
    for case, e in adversarial.items():
        check(e == 0, f"{case}: kernel disagrees with its plain version (max |err| {e})")
    emit({"reductions_adversarial_max_abs_err": adversarial, "tolerance": 0,
          "seconds": round(time.perf_counter() - t0, 2)})

    # ---- 5. the main path ---------------------------------------------------
    curve = bls12_381
    ctx = Z.build_bls12381()
    oc = oracle_of(curve)
    n = 1 << LOG2N
    t0 = time.perf_counter()
    (X, Y), m0, ds = make_bases(ctx, LOG2N, rng)
    torch.cuda.synchronize()
    bases_s = time.perf_counter() - t0
    ks = rng.integers(0, 1 << 62, size=(n,), dtype=np.uint64)
    mix = int.from_bytes(rng.bytes(24), "little")  # widen to full 255-bit scalars
    kints = [(int(k) * mix + int(k)) % curve.r for k in ks]
    scalars = ctx.scalars_to_device(kints)
    kobj = np.array(kints, dtype=object)
    total = int((kobj * base_multiples(LOG2N, m0, ds, curve.r)).sum() % curve.r)
    expected = oc.mul(oc.g, total)

    def read_counts():
        return {
            "bucket_sweep": pl_bucket.launches,
            "lane_reduce": pl_reduce.launches["lane_reduce"],
            "collapse": pl_reduce.launches["collapse"],
            "finish": pl_reduce.launches["finish"],
            "field_inverse": field_kernels.launches["inverse"],
            "mont_mul": field_kernels.launches["mont_mul"],
            "mont_square": field_kernels.launches["mont_square"],
            "sorted_sweep": pl_sorted.launches["sweep"],
            "segscan": pl_sorted.launches["segscan"],
        }

    def reset_counts():
        pl_bucket.launches = 0
        for counts in (pl_reduce.launches, field_kernels.launches, pl_sorted.launches):
            for k in counts:
                counts[k] = 0

    def staged(fn):
        """(result, host-clock ms) of a stage that ends in a synchronize."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def drive(name, run, required):
        """One path through the public API: counts zeroed just before, read
        just after one msm + result_to_affine; the result against the
        oracle; then REPS timed repetitions."""
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        res, first_ms = staged(run)
        got, to_affine_ms = staged(lambda: ctx.result_to_affine(res))
        counts = read_counts()
        for kernel in required:
            check(counts[kernel] > 0, f"path {name} never launched kernel {kernel}")
        check(all(bool(torch.isfinite(r.double()).all()) and r.shape == (24,) for r in res),
              f"path {name}: MSM result has the wrong shape")
        check(got == expected, f"path {name}: MSM result does not match the oracle (sum k_i m_i mod r) G")
        times = []
        for _ in range(REPS):
            r, ms = staged(run)
            times.append(ms / 1e3)
            check(ctx.result_to_affine(r) == expected, f"path {name}: a repetition's MSM result is wrong")
        # one more run with PyTorch reporting every call that makes the host
        # wait for the card (a warning each): the host synchronisations of
        # one warm msm
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return {
            "host_synchronisations_in_msm": len(caught),
            "verified_against_oracle": True, "first_call_s": first_ms / 1e3, "msm_s": times,
            "best_msm_s": min(times), "points_per_s": n / min(times),
            "result_to_affine_ms": to_affine_ms,
            "launches": {k: v for k, v in counts.items() if v},  # one msm + one result_to_affine
            "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
        }

    paths = {
        "full": lambda: ctx.msm((X, Y), scalars, use_glv=False, max_bits=255),
        "A": lambda: ctx.msm((X, Y), scalars),
        "B": lambda: ctx.msm((X, Y), scalars, c=C_SORTED),
    }

    # -- the full-scalar path: c = 7, bucket sweep, collapse + window fold
    impl, c, _ = pippenger.resolve_config(curve, n, 255, None, None, 2 << 30, "auto", device=dev)
    W, B = windows.num_windows(255, c), 1 << (c - 1)
    T = pippenger._kernel_lanes(curve, W, n, None, dev)  # the lanes ctx.msm runs
    check((impl, c, W, B) == ("kernel", 7, 38, 64), f"main path resolved to {(impl, c, W, B)}")
    full = drive("full", paths["full"], ("bucket_sweep", "lane_reduce", "collapse", "finish", "field_inverse"))
    main_launches = full["launches"]
    digits, digits_ms = staged(lambda: windows.signed_window_digits(scalars, c, 255))
    buckets, bucket_ms = staged(
        lambda: pl_bucket.bucket_accumulate(curve, (X, Y), digits, lanes=T, c=c)
    )
    _, finish_ms = staged(lambda: pl_reduce.finish_large(curve, buckets, c))
    emit({
        "main_path": {
            "curve": curve.name, "n": n, "scalar_bits": 255, "glv": False, "c": c, "W": W, "B": B,
            "lanes": T, **full,
            "stage_ms": {
                "digits": digits_ms, "bucket_accumulate(K1+K4)": bucket_ms,
                "finish_large(K2+K3)": finish_ms, "result_to_affine": full["result_to_affine_ms"],
            },
            "bases_built_on_card_s": bases_s,
        }
    })
    del buckets

    # -- path A: the default.  GLV split, c = 6, bucket sweep, one-block finish
    n2 = 2 * n
    impl, cA, _ = pippenger.resolve_config(curve, n2, glv.MAX_BITS, None, None, 2 << 30, "auto", device=dev)
    WA, BA = windows.num_windows(glv.MAX_BITS, cA), 1 << (cA - 1)
    TA = pippenger._kernel_lanes(curve, WA, n2, None, dev)
    check((impl, cA, WA, BA) == ("kernel", 6, 23, 32), f"path A resolved to {(impl, cA, WA, BA)}")
    path_a = drive("A", paths["A"], ("mont_mul", "bucket_sweep", "lane_reduce", "finish", "field_inverse"))
    check(path_a["launches"].get("collapse", 0) == 0, "path A should finish in one block")
    (k1, _, _, _), decompose_ms = staged(lambda: glv.decompose_scalars(curve, scalars))
    _, endo_ms = staged(lambda: glv.endomorphism(curve, (X, Y)))
    ((X2, Y2), k2), glv_ms = staged(lambda: glv.preprocess_endomorphism(curve, (X, Y), scalars))
    del k1
    digits_a, digits_ms = staged(lambda: windows.signed_window_digits(k2, cA, glv.MAX_BITS))
    buckets_a, bucket_ms = staged(
        lambda: pl_bucket.bucket_accumulate(curve, (X2, Y2), digits_a, lanes=TA, c=cA)
    )
    _, finish_ms = staged(lambda: pl_reduce.finish(curve, buckets_a, cA))
    emit({
        "path_A": {
            "curve": curve.name, "n": n, "glv": True, "points_after_split": n2,
            "scalar_bits": glv.MAX_BITS, "c": cA, "W": WA, "B": BA, "lanes": TA, **path_a,
            "stage_ms": {
                "glv_split": glv_ms, "glv_split.decompose": decompose_ms,
                "glv_split.endomorphism(K5)": endo_ms, "digits": digits_ms,
                "bucket_accumulate(K1+K4)": bucket_ms, "finish(K3)": finish_ms,
                "result_to_affine": path_a["result_to_affine_ms"],
            },
        }
    })
    del digits_a, buckets_a

    # -- path B: the large window.  GLV split, then the sorted engine
    impl, cB, _ = pippenger.resolve_config(curve, n2, glv.MAX_BITS, C_SORTED, None, 2 << 30, "auto", device=dev)
    WB, BB = windows.num_windows(glv.MAX_BITS, cB), 1 << (cB - 1)
    check((impl, cB, WB, BB) == ("kernel-sorted", 10, 15, 512), f"path B resolved to {(impl, cB, WB, BB)}")
    check(pippenger.resolve_config(curve, n2, glv.MAX_BITS, None, None, 2 << 30, "kernel-sorted")[1] == cB,
          "impl='kernel-sorted' with c unset should resolve to the same window")
    path_b = drive("B", paths["B"], ("mont_mul", "sorted_sweep", "segscan", "collapse", "finish", "field_inverse"))
    TB = pl_sorted.GRID
    digits_b, digits_ms = staged(lambda: windows.signed_window_digits(k2, cB, glv.MAX_BITS))
    (perm, skey, meta), sort_ms = staged(lambda: pl_sorted.sort_runs(digits_b, cB, TB))
    (slot, seg), compact_ms = staged(lambda: pl_sorted.compact_index(skey, meta, cB, TB))
    KB = seg.shape[1]
    pieces, sweep_ms = staged(lambda: pl_sorted.sweep(curve, (X2, Y2), perm, meta, slot, KB, TB))
    scanned, segscan_ms = staged(lambda: pl_sorted.segscan(curve, pieces, seg, TB))
    dense_b, scatter_ms = staged(lambda: pl_sorted.scatter_dense(curve, scanned, seg, cB))
    sums_b, collapse_ms = staged(lambda: pl_reduce.collapse(curve, dense_b))
    fold_b = tuple(a[:, :, None].contiguous() for a in sums_b)
    point_b, finish_ms = staged(lambda: pl_reduce.finish(curve, fold_b, cB))
    check(ctx.result_to_affine(point_b) == expected, "path B's stages, run one by one, miss the oracle")
    emit({
        "path_B": {
            "curve": curve.name, "n": n, "glv": True, "points_after_split": n2,
            "scalar_bits": glv.MAX_BITS, "c": cB, "W": WB, "B": BB, "chunks": TB, "K": KB, **path_b,
            "stage_ms": {
                "glv_split": glv_ms, "glv_split.decompose": decompose_ms,
                "glv_split.endomorphism(K5)": endo_ms, "digits": digits_ms, "sort": sort_ms,
                "compact": compact_ms, "sweep(K7)": sweep_ms, "segscan(K8)": segscan_ms,
                "scatter": scatter_ms, "collapse(K2)": collapse_ms, "finish(K3)": finish_ms,
                "result_to_affine": path_b["result_to_affine_ms"],
            },
        }
    })
    del skey, scanned, dense_b

    # -- the batch phase: the batched field surface through the context
    fq = curve.fq
    reset_counts()
    batch_report = {}
    for what, got_fn, ref_fn in (
        ("batch_mul", lambda: ctx.batch_mul(X, Y), lambda: mont.mont_mul(fq, X, Y)),
        ("batch_square", lambda: ctx.batch_square(X), lambda: mont.mont_square(fq, X)),
        ("batch_to_mont", lambda: ctx.batch_to_mont(X), lambda: mont.to_mont(fq, X)),
        ("batch_from_mont", lambda: ctx.batch_from_mont(X), lambda: mont.from_mont(fq, X)),
    ):
        got, ms = staged(got_fn)
        ref, plain_ms = staged(ref_fn)
        check(got.shape == X.shape and bool((got == ref).all()), f"ctx.{what} != its plain version at N = 2^{LOG2N}")
        batch_report[what] = {"ms": ms, "plain_ms": plain_ms}
        del got, ref
    batch_launches = read_counts()
    check(batch_launches["mont_mul"] == 3 and batch_launches["mont_square"] == 1,
          f"the batch phase launched {batch_launches}")
    emit({"batch_ops": {"n": n, "equal_to_plain": True, **batch_report,
                        "launches": {k: v for k, v in batch_launches.items() if v}}})

    if args.profile is not None:
        emit({"profile": {name: profile_msm(run, args.profile, name) for name, run in paths.items()}})

    # ---- 6. each kernel at the main path's shapes ---------------------------
    NW = curve.fq.n_words
    mul_ops = 2 * (2 * NW * NW + NW)  # a*b and m*q rows plus m, 2 ops per multiply-add
    ADD_MIXED, ADD, DOUBLE = 11 * mul_ops, 12 * mul_ops, 8 * mul_ops

    def bound(nbytes: float, nops: float):
        tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_INT32_OPS_PER_S * 1e3
        return max(tb, to), ("bytes" if tb >= to else "operations")

    kernels = []

    # K1 sweep: wrapper pl_bucket._sweep on packed words, at the lane count
    # ctx.msm runs
    words = _launch.pack_point((X, Y))
    pl_bucket._sweep(curve, words[0], words[1], digits, T, B)  # warm-up
    state, k1_ms = sync_ms(lambda: pl_bucket._sweep(curve, words[0], words[1], digits, T, B), 2)
    kernel_buckets, k4_ms = sync_ms(lambda: pl_reduce._lane_reduce_state(curve, state), 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_state = pippenger._bucket_sweep_plain(curve, (X, Y), digits, PLAIN_LANES, c)
    torch.cuda.synchronize()
    k1_plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain_buckets = pippenger._lane_tree_reduce(curve, plain_state)
    torch.cuda.synchronize()
    plain_tree_ms = (time.perf_counter() - t0) * 1e3
    del plain_state
    k1_err = affine_err(curve, kernel_buckets, plain_buckets)
    check(k1_err == 0, f"bucket sweep at the main path's shape disagrees with plain (max |err| {k1_err})")
    # only a nonzero digit on a point other than (0,0) costs an add
    nonzero = int(((digits != 0) & ~((X == 0).all(0) & (Y == 0).all(0))[None]).sum().item())
    b_ms, b_by = bound(W * n * 4 + 2 * NW * 4 * n + W * T * B * 3 * NW * 4, nonzero * ADD_MIXED)
    kernels.append({
        "name": "bucket_sweep", "route": "cuda",
        "source": "zprize_wasm_msm_tpu_torch/csrc/bucket.cu",
        "replaces": "zprize_wasm_msm_tpu/ops/msm/pl_bucket.py:240",
        "launches": main_launches["bucket_sweep"], "max_abs_err": k1_err, "ms": k1_ms,
        "plain_ms": k1_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"digits ({W},{n}) X,Y ({2 * NW},{n}) -> state ({W},{T},{B},3x{NW}w)",
        "compared": "after lane reduction, as affine points, against the plain sweep + tree",
        "x_bound": k1_ms / b_ms, "mixed_adds": nonzero, "ns_per_add": k1_ms * 1e6 / nonzero,
        **sweep_res[("bucket_sweep", NW)],
        "kernel_lanes": T, "threads": W * T,
    })

    # K4 lane reduce: the sweep's own state, on K4's contract layout for plain
    lanes_bl = unpack_words(state.permute(3, 0, 1, 2).contiguous())  # (3L, W, T, B)
    L = 2 * NW
    contract = tuple(lanes_bl[i * L : (i + 1) * L].permute(3, 0, 1, 2) for i in range(3))  # (B,L,W,T)
    del lanes_bl
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k4_plain = pl_reduce.lane_reduce_plain(curve, contract)
    torch.cuda.synchronize()
    k4_plain_ms = (time.perf_counter() - t0) * 1e3
    k4_err = affine_err(curve, kernel_buckets, k4_plain)
    check(k4_err == 0, f"lane_reduce at the main path's shape disagrees with plain (max |err| {k4_err})")
    del contract, k4_plain
    def k4_bound(W_, T_, B_):
        return bound(W_ * T_ * B_ * 3 * NW * 4 + W_ * B_ * 3 * NW * 4, W_ * B_ * (T_ - 1) * ADD)

    def k4_lane_sweep(state_, W_, T_, B_):
        """K4 (its wrapper) at the lane counts it did not choose: one full
        wave, one warp and two warps per bucket."""
        resident = pl_reduce._reduce_resident_threads(NW, 0)
        chosen = pl_reduce._reduce_lanes(W_ * B_, T_, resident)
        out = {}
        for name, N_ in (("one wave", -(-min(resident, W_ * B_ * T_) // 32) * 32),
                         ("1 warp per bucket", 32 * W_ * B_), ("2 warps per bucket", 64 * W_ * B_)):
            if N_ != chosen:
                pl_reduce._lane_reduce_state(curve, state_, lanes=N_)
                _, out[f"{N_} lanes ({name})"] = sync_ms(
                    lambda: pl_reduce._lane_reduce_state(curve, state_, lanes=N_), 2)
        return out

    b_ms, b_by = k4_bound(W, T, B)
    k4_lanes = pl_reduce._reduce_lanes(W * B, T, pl_reduce._reduce_resident_threads(NW, 0))
    k4_sweep = k4_lane_sweep(state, W, T, B)
    kernels.append({
        "name": "lane_reduce", "route": "cuda",
        "source": "zprize_wasm_msm_tpu_torch/csrc/bucket.cu",
        "replaces": "zprize_wasm_msm_tpu/ops/msm/pl_reduce.py:93",
        "launches": main_launches["lane_reduce"], "max_abs_err": k4_err, "ms": k4_ms,
        "plain_ms": k4_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "x_bound": k4_ms / b_ms, "lanes": k4_lanes, "partials_per_lane": W * B * T / k4_lanes,
        "ms_at_other_lane_counts": k4_sweep,
        **reduce_res[("lane_reduce", NW)],
        "combine_ptxas": reduce_res[("lane_reduce (combine)", NW)]["ptxas"],
        "shape": f"state ({W},{T},{B},3x{NW}w) -> ({L},{W},{B})x3; two launches (even split, "
                 "combine across warps); ms is _lane_reduce_state on the sweep's state",
        "compared": "as affine points against the plain lane tree on the same state",
    })
    del state

    # the links of the reductions' chains: one level-parallel doubling and
    # addition, each timed as a chain of 2 000 in one warp (csrc/check.cu
    # group_chain_kernel), with a product to a lane ("_par") and with
    # cooperative products ("_coop", what finish_kernel and the collapse run)
    pt1 = tuple(x[:, :1, 0].contiguous() for x in kernel_buckets)
    pt2 = tuple(x[:, 1:2, 0].contiguous() for x in kernel_buckets)
    link_us = {}
    for op in device_check.CHAIN_OPS:
        device_check.group_chain(curve, op, pt1, pt2, 10)
        _, ms = sync_ms(lambda: device_check.group_chain(curve, op, pt1, pt2, 2000), 2)
        link_us[op] = ms / 2000 * 1e3

    # K2 collapse: the wrapper, its plan (buckets per run, groups, the wave),
    # its depth floor (the longest chain's links at one warp's latency)
    wave = pl_reduce._collapse_wave_groups(NW, 0)

    def k2_floor(W_, B_):
        """(buckets a run, links, depth floor ms) of the collapse at (W_, B_)."""
        m = pl_reduce._collapse_run(W_, B_, wave)
        adds, dbls = pl_reduce._collapse_links(B_, m)
        return m, (adds, dbls), (adds * link_us["add_coop"] + dbls * link_us["double_coop"]) / 1e3

    def k2_entry(bk, W_, B_, ref):
        """K2's plan, depth floor, and its launches at every run length up
        to 64, each held against ``ref`` and timed over 3 calls; and the
        wrapper over 10 calls."""
        m, (adds, dbls), floor_ms = k2_floor(W_, B_)
        ms = {}
        for k in range(min(B_, 64).bit_length()):
            got = pl_reduce._collapse_launch(curve, bk, 1 << k)
            e = affine_err(curve, tuple(got), ref)
            check(e == 0, f"collapse at {1 << k} buckets a run disagrees with plain (max |err| {e})")
            _, ms[f"{1 << k} buckets a run"] = sync_ms(
                lambda: pl_reduce._collapse_launch(curve, bk, 1 << k), 3)
        return {
            "ms_10_calls": sync_ms(lambda: pl_reduce.collapse(curve, bk), 10)[1],
            "ms_by_run": ms, "buckets_per_run": m, "groups": W_ * B_ // m,
            "lanes_per_group": pl_reduce._collapse_lanes(NW), "wave_groups": wave,
            "depth_links": {"additions": adds, "doublings": dbls},
            "depth_floor_ms": floor_ms,
        }

    pl_reduce.collapse(curve, kernel_buckets)
    k2_out, k2_ms = sync_ms(lambda: pl_reduce.collapse(curve, kernel_buckets), 3)
    k2_ref, k2_plain_ms = staged(lambda: pl_reduce.collapse_plain(curve, kernel_buckets))
    k2_err = affine_err(curve, k2_out, k2_ref)
    check(k2_err == 0, f"collapse at the main path's shape disagrees with plain (max |err| {k2_err})")
    # cheapest known schedule of sum_b (b+1) S_b: the running-sum walk,
    # 2 (B - 1) adds per window
    b_ms, b_by = bound((W * B + W) * 3 * NW * 4, W * 2 * (B - 1) * ADD)
    kernels.append({
        "name": "collapse", "route": "cuda",
        "source": "zprize_wasm_msm_tpu_torch/csrc/reduce.cu",
        "replaces": "zprize_wasm_msm_tpu/ops/msm/pl_reduce.py:353",
        "launches": main_launches["collapse"], "max_abs_err": k2_err, "ms": k2_ms,
        "plain_ms": k2_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        **k2_entry(kernel_buckets, W, B, k2_ref),
        "collapse_resources": reduce_res[("collapse", NW)],
        "combine_resources": reduce_res[("collapse (combine)", NW)],
        "shape": f"({L},{W},{B})x3 -> ({L},{W})x3; ms is the pl_reduce.collapse wrapper (its "
                 "kernels read and write the limbs: no packing launches), 3 calls",
        "compared": "as affine points against bucket_reduce",
    })

    # K3 finish at B = 1
    fold_in = tuple(a[:, :, None].contiguous() for a in k2_out)
    pl_reduce.finish(curve, fold_in, c)
    k3_out, k3_ms = sync_ms(lambda: pl_reduce.finish(curve, fold_in, c), 3)
    k3_ref, k3_plain_ms = staged(lambda: pl_reduce.finish_plain(curve, fold_in, c))
    k3_err = affine_err(curve, tuple(x[:, None] for x in k3_out), tuple(x[:, None] for x in k3_ref))
    check(k3_err == 0, f"finish at the main path's shape disagrees with plain (max |err| {k3_err})")
    check(ctx.result_to_affine(k3_out) == expected, "finish's point is not the MSM result")
    # cheapest known schedule: the running-sum walk per window, 2 (B - 1)
    # adds (free at B = 1), then Horner over the windows, c (W - 1)
    # doublings and W - 1 adds
    def k3_bound(W_, B_, c_):
        return bound((W_ * B_ + 1) * 3 * NW * 4,
                     W_ * 2 * (B_ - 1) * ADD + c_ * (W_ - 1) * DOUBLE + (W_ - 1) * ADD)

    def k3_floor(W_, c_):
        """c (W-1) doublings and W-1 additions at the fold's links' measured latency."""
        return (c_ * (W_ - 1) * link_us["double_coop"] + (W_ - 1) * link_us["add_coop"]) / 1e3

    b_ms, b_by = k3_bound(W, 1, c)
    kernels.append({
        "name": "finish", "route": "cuda",
        "source": "zprize_wasm_msm_tpu_torch/csrc/reduce.cu",
        "replaces": "zprize_wasm_msm_tpu/ops/msm/pl_reduce.py:246",
        "launches": main_launches["finish"], "max_abs_err": k3_err, "ms": k3_ms,
        "plain_ms": k3_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "depth_floor_ms": k3_floor(W, c), "link_us": link_us,
        "fold_resources": reduce_res[("finish (fold)", NW)],
        # at B > 1 the window sums come from the collapse's kernels (path A)
        "weighting_resources": {"kernel": "collapse_kernel (+ combine_kernel)",
                                **reduce_res[("collapse", NW)]},
        "shape": f"({L},{W},1)x3, c={c} -> ({L},)x3; at B = 1 one launch (the fold), at B > 1 "
                 "the collapse's launches first; ms is the pl_reduce.finish wrapper",
        "compared": "as affine points against bucket_reduce + window_fold, and against the oracle",
    })

    # field inversion: the one element result_to_affine inverts (the Z of the
    # MSM's point), kernel against the plain Fermat ladder
    fq = curve.fq
    z_in = k3_out[2][:, None].contiguous()
    field_kernels.inverse(fq, z_in)
    inv_out, inv_ms = sync_ms(lambda: field_kernels.inverse(fq, z_in), 3)
    inv_ref, inv_plain_ms = staged(lambda: field_kernels.inverse_plain(fq, z_in))
    inv_err = int((inv_out - inv_ref).abs().max().item())
    check(inv_err == 0, f"field inverse disagrees with its plain version (max |err| {inv_err})")
    check(bool((mont.mont_mul(fq, inv_out, z_in) == mont.one_mont(fq, (1,), dev)).all()),
          "field inverse times its input is not 1")
    # cheapest known schedule: a binary extended GCD, ~2 bits(q) iterations of
    # a shift and a conditional subtract on two NW-word values and their two
    # cofactors (4 NW word operations), not the Fermat ladder's ~1.5 bits(q)
    # Montgomery products
    b_ms, b_by = bound(2 * NW * 4, 2 * fq.bits * 4 * NW)
    kernels.append({
        "name": "field_inverse", "route": "cuda",
        "source": "zprize_wasm_msm_tpu_torch/csrc/field_kernels.cu",
        "replaces": "zprize_wasm_msm_tpu/ops/field/mont.py:426",
        "launches": main_launches["field_inverse"], "max_abs_err": inv_err, "ms": inv_ms,
        "plain_ms": inv_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "gcd_steps": field_kernels.inverse_consts(fq)[0], "gcd_inner_iterations": field_kernels.GCD_INNER,
        **field_res[("field_inverse_kernel", NW)],
        "shape": f"({L}, 1) -> ({L}, 1); ms is the field_kernels.inverse wrapper at one element",
        "compared": "limbs bit for bit against mont.inverse (a^(q-2) by mont_mul)",
    })

    # K5 / K6 at the paths' shape (N = 2^20 elements of Fq): the launch on
    # packed words is timed (as K1's is), the public wrapper beside it; the
    # comparison is on two full (L, N) operands, limbs bit for bit
    ops_library = "no PyTorch call multiplies multi-word integers modulo q"
    for kname, replaces, launch, wrapper, plain, n_in, path_count in (
        ("mont_mul", "zprize_wasm_msm_tpu/ops/field/kernels.py:138",
         lambda: field_kernels._mul_words(fq, words[0], words[1]),
         lambda: field_kernels.mont_mul(fq, X, Y), lambda: field_kernels.mont_mul_plain(fq, X, Y),
         2, path_a["launches"]["mont_mul"]),
        ("mont_square", "zprize_wasm_msm_tpu/ops/field/kernels.py:160",
         lambda: field_kernels._square_words(fq, words[0]),
         lambda: field_kernels.mont_square(fq, X), lambda: field_kernels.mont_square_plain(fq, X),
         1, batch_launches["mont_square"]),
    ):
        launch()
        _, k_ms = sync_ms(launch, 10)
        got, wrapper_ms = sync_ms(wrapper, 3)
        ref, plain_ms = staged(plain)
        err = int((got - ref).abs().max().item())
        check(err == 0, f"{kname} at N = 2^{LOG2N} disagrees with its plain version (max |err| {err})")
        del got, ref
        b_ms, b_by = bound((n_in + 1) * 4 * NW * n, n * mul_ops)
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "zprize_wasm_msm_tpu_torch/csrc/field_kernels.cu", "replaces": replaces,
            "launches": path_count, "max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "wrapper_ms": wrapper_ms, "no_library_because": ops_library,
            "shape": f"({L},{n}) x{n_in} -> ({L},{n}); ms is the launch on ({NW},{n}) packed words, "
                     "wrapper_ms includes packing limbs to words and back",
            "compared": "limbs bit for bit against mont." + kname,
        })
    # the one-constant form path A and B use for beta * x
    beta_w = _launch.pack_point((mont._int_const(fq, fq.to_mont_int(curve.glv.beta), dev)[:, None],))[0]
    _, k5_const_ms = sync_ms(lambda: field_kernels._mul_words(fq, words[0], beta_w), 10)
    kernels[-2]["ms_one_constant_operand"] = k5_const_ms

    # K7 sorted sweep at path B's shape, all 15 windows, on the stream path B's
    # own stages made above: the public wrapper (CUDA events; packing and the
    # point-contiguous copy included), and the launch on words beside it
    pl_sorted.sweep(curve, (X2, Y2), perm, meta, slot, KB, TB)
    pieces, k7_ms = sync_ms(lambda: pl_sorted.sweep(curve, (X2, Y2), perm, meta, slot, KB, TB), 2)
    pts_b = _launch.point_words((X2, Y2))
    stream_b = (perm.contiguous(), meta.contiguous(), slot.contiguous())
    _, k7_launch_ms = sync_ms(lambda: pl_sorted._sweep_words(curve, pts_b, *stream_b, KB, TB), 3)
    del pts_b
    pieces_plain, k7_plain_ms = staged(
        lambda: pl_sorted.sweep_plain(curve, (X2, Y2), perm, meta, slot, KB, TB)
    )
    k7_err = affine_err(curve, pieces, pieces_plain)
    check(k7_err == 0, f"sorted sweep at path B's shape disagrees with plain (max |err| {k7_err})")
    infinity2 = (X2 == 0).all(0) & (Y2 == 0).all(0)
    k7_adds = int((((meta & pl_sorted.META_ZERO) == 0) & ~infinity2[perm.long()]).sum().item())
    b_ms, b_by = bound(2 * NW * 4 * n2 + 3 * 4 * WB * n2 + 3 * NW * 4 * WB * KB, k7_adds * ADD_MIXED)
    kernels.append({
        "name": "sorted_sweep", "route": "cuda",
        "source": "zprize_wasm_msm_tpu_torch/csrc/sorted.cu",
        "replaces": "zprize_wasm_msm_tpu/ops/msm/pl_sorted.py:127",
        "launches": path_b["launches"]["sorted_sweep"], "max_abs_err": k7_err, "ms": k7_ms,
        "plain_ms": k7_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "launch_ms": k7_launch_ms, "x_bound": k7_ms / b_ms, "mixed_adds": k7_adds,
        "ns_per_add": k7_ms * 1e6 / k7_adds, "threads": WB * TB * 32,
        **sweep_res[("sorted_sweep", NW)], "no_library_because": ops_library,
        "shape": f"X,Y ({L},{n2}), perm/meta/slot ({WB},{n2}), T={TB} -> ({L},{WB},{KB})x3; "
                 "ms is the wrapper, launch_ms the launch on point-contiguous words",
        "compared": f"all {WB} windows, every entry as an affine point, against sweep_plain on the same stream",
    })
    del pieces_plain

    # K8 segmented scan on the sweep's own entries
    pl_sorted.segscan(curve, pieces, seg, TB)
    k8_out, k8_ms = sync_ms(lambda: pl_sorted.segscan(curve, pieces, seg, TB), 3)
    k8_ref, k8_plain_ms = staged(lambda: pl_sorted.segscan_plain(curve, pieces, seg, TB))
    k8_err = affine_err(curve, k8_out, k8_ref)
    check(k8_err == 0, f"segscan at path B's shape disagrees with plain (max |err| {k8_err})")
    used = seg < BB
    heads = used & (seg != torch.cat([torch.full_like(seg[:, :1], -1), seg[:, :-1]], dim=1))
    k8_adds = int(used.sum().item() - heads.sum().item())  # one per piece beyond a segment's first
    longest = int(torch.stack([torch.bincount(row[row < BB], minlength=BB).max() for row in seg]).max().item())
    b_ms, b_by = bound(2 * 3 * NW * 4 * WB * KB + 4 * WB * KB, k8_adds * ADD)
    kernels.append({
        "name": "segscan", "route": "cuda",
        "source": "zprize_wasm_msm_tpu_torch/csrc/sorted.cu",
        "replaces": "zprize_wasm_msm_tpu/ops/msm/pl_sorted.py:238",
        "launches": path_b["launches"]["segscan"], "max_abs_err": k8_err, "ms": k8_ms,
        "plain_ms": k8_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "adds": k8_adds, "entries_in_use": int(used.sum().item()), "longest_segment": longest,
        "no_library_because": ops_library,
        "shape": f"({L},{WB},{KB})x3, seg ({WB},{KB}) -> ({L},{WB},{KB})x3; ms is the wrapper",
        "compared": "every entry as an affine point against segscan_plain (Hillis-Steele rounds)",
    })

    # K2 and K3 at path B's shapes and K1, K4, K3 at path A's: times only
    # (each is held against its plain version above at both small and full shapes)
    dense_b = pl_sorted.scatter_dense(curve, k8_out, seg, cB)
    sums_b, k2b_ms = sync_ms(lambda: pl_reduce.collapse(curve, dense_b), 3)
    k2b_ref, k2b_plain_ms = staged(lambda: pl_reduce.collapse_plain(curve, dense_b))
    k2b_err = affine_err(curve, sums_b, k2b_ref)
    check(k2b_err == 0, f"collapse at path B's shape disagrees with plain (max |err| {k2b_err})")
    pl_reduce.finish(curve, fold_b, cB)
    k3b_out, k3b_ms = sync_ms(lambda: pl_reduce.finish(curve, fold_b, cB), 3)
    k3b_ref, k3b_plain_ms = staged(lambda: pl_reduce.finish_plain(curve, fold_b, cB))
    k3b_err = affine_err(curve, tuple(x[:, None] for x in k3b_out), tuple(x[:, None] for x in k3b_ref))
    check(k3b_err == 0, f"finish at path B's shape disagrees with plain (max |err| {k3b_err})")
    digits_a = windows.signed_window_digits(k2, cA, glv.MAX_BITS)
    words2 = _launch.pack_point((X2, Y2))
    pl_bucket._sweep(curve, words2[0], words2[1], digits_a, TA, BA)
    state_a, k1a_ms = sync_ms(lambda: pl_bucket._sweep(curve, words2[0], words2[1], digits_a, TA, BA), 2)
    nonzero_a = int(((digits_a != 0) & ~infinity2[None]).sum().item())
    k1a_bound, k1a_by = bound(WA * n2 * 4 + 2 * NW * 4 * n2 + WA * TA * BA * 3 * NW * 4, nonzero_a * ADD_MIXED)
    buckets_a, k4a_ms = sync_ms(lambda: pl_reduce._lane_reduce_state(curve, state_a), 2)
    k4a_sweep = k4_lane_sweep(state_a, WA, TA, BA)
    pl_reduce.finish(curve, buckets_a, cA)
    k3a_out, k3a_ms = sync_ms(lambda: pl_reduce.finish(curve, buckets_a, cA), 3)
    k3a_ref, k3a_plain_ms = staged(lambda: pl_reduce.finish_plain(curve, buckets_a, cA))
    k3a_err = affine_err(curve, tuple(x[:, None] for x in k3a_out), tuple(x[:, None] for x in k3a_ref))
    check(k3a_err == 0, f"finish at path A's shape disagrees with plain (max |err| {k3a_err})")
    check(ctx.result_to_affine(k3a_out) == expected, "finish at path A's shape is not the MSM result")
    # the fold alone at path A's shape (B = 1 on the window sums): K3's time
    # less this is its weighting, the collapse's launches; and the two
    # public wrappers composed (collapse to limbs, then finish packs them)
    fold_a = tuple(a[:, :, None].contiguous() for a in pl_reduce.collapse(curve, buckets_a))
    pl_reduce.finish(curve, fold_a, cA)
    _, k3a_fold_ms = sync_ms(lambda: pl_reduce.finish(curve, fold_a, cA), 3)
    _, k3a_composed_ms = sync_ms(lambda: pl_reduce.finish(
        curve, tuple(a[:, :, None] for a in pl_reduce.collapse(curve, buckets_a)), cA), 3)
    del state_a, fold_a
    # the same sweep and lane reduction at KERNEL_LANES lanes, the count
    # path A ran before the engine raised it to one wave: K1 and K4 like
    # for like with earlier runs
    T0 = pippenger.KERNEL_LANES
    state_a0, k1a0_ms = sync_ms(lambda: pl_bucket._sweep(curve, words2[0], words2[1], digits_a, T0, BA), 2)
    buckets_a0, k4a0_ms = sync_ms(lambda: pl_reduce._lane_reduce_state(curve, state_a0), 2)
    k1a0_err = affine_err(curve, buckets_a0, buckets_a)
    check(k1a0_err == 0, f"path A's buckets at {T0} and {TA} lanes differ (max |err| {k1a0_err})")
    del words2, state_a0, buckets_a0
    other_shapes = {
        "bucket_sweep": {"path_A": {"shape": f"digits ({WA},{n2}), B={BA}, T={TA}", "ms": k1a_ms,
                                    "digit_slots": WA * n2, "mixed_adds": nonzero_a,
                                    "bound_ms": k1a_bound, "bound_by": k1a_by,
                                    "x_bound": k1a_ms / k1a_bound, "ns_per_add": k1a_ms * 1e6 / nonzero_a,
                                    "kernel_lanes": TA, "threads": WA * TA},
                         f"path_A_T{T0}": {"ms": k1a0_ms, "threads": WA * T0,
                                           "ns_per_add": k1a0_ms * 1e6 / nonzero_a,
                                           "k1_plus_k4_ms": k1a0_ms + k4a0_ms, "max_abs_err": k1a0_err}},
        "lane_reduce": {"path_A": {"shape": f"state ({WA},{TA},{BA})", "ms": k4a_ms,
                                   **dict(zip(("bound_ms", "bound_by"), k4_bound(WA, TA, BA))),
                                   "lanes": pl_reduce._reduce_lanes(WA * BA, TA, pl_reduce._reduce_resident_threads(NW, 0)),
                                   "ms_at_other_lane_counts": k4a_sweep,
                                   "k1_plus_k4_ms": k1a_ms + k4a_ms},
                        f"path_A_T{T0}": {"shape": f"state ({WA},{T0},{BA})", "ms": k4a0_ms,
                                          **dict(zip(("bound_ms", "bound_by"), k4_bound(WA, T0, BA)))}},
        "collapse": {"path_B": {"shape": f"({L},{WB},{BB})x3", "ms": k2b_ms, "plain_ms": k2b_plain_ms,
                                "max_abs_err": k2b_err, **k2_entry(dense_b, WB, BB, k2b_ref),
                                **dict(zip(("bound_ms", "bound_by"), bound((WB * BB + WB) * 3 * NW * 4,
                                                                           WB * 2 * (BB - 1) * ADD)))}},
        "finish": {"path_A": {"shape": f"({L},{WA},{BA})x3, c={cA}", "ms": k3a_ms,
                              "plain_ms": k3a_plain_ms, "max_abs_err": k3a_err,
                              **dict(zip(("bound_ms", "bound_by"), k3_bound(WA, BA, cA))),
                              "fold_alone_ms": k3a_fold_ms,
                              "collapse_then_finish_ms": k3a_composed_ms,
                              "weighting_buckets_per_run": k2_floor(WA, BA)[0],
                              "depth_floor_ms": k3_floor(WA, cA) + k2_floor(WA, BA)[2],
                              "depth_floor_ms_fold": k3_floor(WA, cA)},
                   "path_B": {"shape": f"({L},{WB},1)x3, c={cB}", "ms": k3b_ms,
                              "plain_ms": k3b_plain_ms, "max_abs_err": k3b_err,
                              **dict(zip(("bound_ms", "bound_by"), k3_bound(WB, 1, cB))),
                              "depth_floor_ms": k3_floor(WB, cB)}},
    }
    by_path = {"full": full["launches"], "A": path_a["launches"], "B": path_b["launches"],
               "batch": batch_launches}
    for entry in kernels:
        entry["launches_by_path"] = {p: counts.get(entry["name"], 0) for p, counts in by_path.items()}
        if entry["name"] in other_shapes:
            entry["other_shapes"] = other_shapes[entry["name"]]

    emit({
        "peaks": {"bytes_per_s": PEAK_BYTES_PER_S, "int32_ops_per_s": PEAK_INT32_OPS_PER_S},
        "plain_lane_tree_ms": plain_tree_ms, "plain_sweep_lanes": PLAIN_LANES,
        "nonzero_digit_adds": nonzero, "total_seconds": round(time.perf_counter() - t_start, 1),
    })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })


if __name__ == "__main__":
    main()
