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
     run, steps not a multiple of 32), and the reductions on theirs, on
     toy and BLS12-381
     (k3_adversarial: identity buckets, equal buckets, only the top window,
     P and -P, a fold ending on Q + (-Q), W*B = 1024, B = 1;
     k4_adversarial: identity partials, equal partials, P, -P pairs, T not
     a multiple of the warp, lane counts that end buckets inside lanes, on
     lane ends and across warps; k2_adversarial: identity buckets, every
     bucket one point, only bucket 0, only the top bucket, P and -P in one
     window, at B = 1, 2, 64, 512, 4096 and W = 1, 15, 38; and K8 on
     k8_adversarial's seg layouts, below, on toy and BLS12-381);
     Over Fq2 (G2): the Fq2 device functions (csrc/field2.cuh, the group
     ops of K1 and K4 in csrc/group2.cuh, the level-parallel ops of K2, the
     fold links of K3 in both forms (csrc/fold2.cuh), where 3b = k (1 + u)
     with 3b t by additions and by its level of products) bit for bit on
     toy_g2, BN254 G2 and BLS12-381 G2 (components 0, 1, q-1, (q+-1)/2,
     all-ones words); K1, K4, K2 and K3 over Fq2 at small
     shapes on toy_g2, toy_bn_g2, bn254_g2 and bls12_381_g2, and on the
     adversarial cases above (K1, K4, K3, K2 on toy_g2; K1, K4 on
     bls12_381_g2); K7 and K8 over Fq2 (the sorted engine on G2) at small
     shapes on the four G2 curves and on k7_adversarial's streams (toy_g2,
     bls12_381_g2), and K8 over Fq2 on k8_adversarial's seg layouts (every
     segment a singleton, one over all K, segments ending on or starting at
     the last entry of a tile or of a level-1 tile, the host's padding ids,
     K from one tile to three levels); every Fq2 instantiation under the
     same spill gate (and the out-of-line functions: group2.cuh's step
     loop, the collapse's links, the fold's links), and K4
     and K8 over Fq2 under their budget of 864 shared bytes a thread and 8
     warps a SM.  BLS12-377 G1: the
     kernels at small shapes and ctx.msm at 2^16 against the oracle, the
     default (GLV) and use_glv=False.  Engine agreement at 2^16 (the check
     of tools/engine_diff.py): on BLS12-381 G1 the default, use_glv=False
     c = 7, kernel-sorted, the plain engine and msm_legacy, on BLS12-381 G2
     kernel, kernel-sorted and msm_legacy (at 2^14), all one group element
     and the oracle's.  Serialization at 2^16 on G1 and G2: to bytes and
     back, compressed and uncompressed, exact, and ctx.msm over the
     decompressed G2 bases against the oracle;
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
     a batch phase (ctx.batch_mul / batch_square / batch_to_mont /
     batch_from_mont at N = 2^20) against the plain field ops; and
       G2    build_curve(bls12_381_g2).msm(P, k) at N = 2^20: full scalars
             (no GLV), c = 6, W = 44, B = 32, K1 -> K4 -> K2 -> K3 over Fq2,
             against (sum k_i m_i mod r) G2; and BN254 G2 at 2^16;
       G2-sorted  the same G2 bases and scalars through msm(P, k, c=10):
             W = 27, B = 512, T = 1024 chunks, sort -> K7 -> K8 -> scatter
             -> K2 -> K3 over Fq2, equal to path G2's point and the oracle's;
       G2 skewed  the same G2 bases with every scalar 1 through msm(P, k,
             c=10) (one bucket of window 0 over all 1 024 chunks: a segment
             of 1 024 for K8), equal to the oracle's (sum m_i mod r) G2 and
             to the bucket engine's point;
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
     the inversion at one element; K6 (the square) as its public call, one
     launch on the limbs, with its bound on the limb bytes and the bound of
     a launch on packed words beside it; K8 (the scan in tiles and levels) also on
     the skewed stream at path B's shape (every scalar 1), with its levels,
     the kernels a call launched (as its entry counts them, checked against
     its schedule), its depth (a model figure, pl_sorted.scan_depth) and a
     depth floor at the measured latency of one one-lane complete add;
  7. the same for the Fq2 forms of K1, K4, K2 and K3 at path G2's shape
     (K1's plain version on two of its 44 windows), with their bounds (an
     Fq2 product counted as three Fq products) and K2's and K3's depth
     floors at the Fq2 links' latency (K3's at its fold link, at the other
     form's and at par.cuh's link with its level of products by 3b, the
     fold's link before; the links timed on BLS12-381 G2 and BN254 G2); and
     for K7 and K8 over Fq2 at path
     G2-sorted's shape (K7's plain version on window 0 of 27), K8 also on
     the skewed stream, with K2 over Fq2 at B = 512 and K3 over Fq2 at
     W = 27 beside them.  K2 over Fq2 also at every run length up to 64 at
     both shapes, and the Fq2 links at 1, 2 and 4 warps a SM (its depth
     floor at both);
  8. the Groth16 stack, each phase with the kernel counts zeroed before it
     and read after it: ntt (ctx.fft / ctx.ifft on BLS12-381 Fr at 2^20:
     the round trip, the K5-routed NTT against impl="plain" bit for bit,
     2^10 against oracle.ntt, set-up apart from the warm calls, K5
     launches, peak memory, one K5 call at a stage's shape against plain);
     poly (the snarkjs FFT helpers, build_abc / join_abc, construct_lc
     above 2^10 terms an output and batch_apply_key_fr at 2^16,
     pedersen_hash on 256 messages, each against its formula on host
     ints; group_fft / group_ifft on 4 BLS12-381 G1 points: FFT(k_i G) =
     NTT(k) G and the round trip); pairing on BLS12-381 and BN254
     (miller_loop and final_exponentiation on four pairs, timed:
     bilinearity, non-degeneracy, e(O, Q) = 1; on BLS12-381 the fast final
     exponentiation against final_exponentiation_plain; device operations
     from short loops, pairing_ops); groth16 (verify on BLS12-381 and
     BN254 with two public inputs: True, and on BLS12-381 False on a
     corrupted C: its pairing_eq of four pairings true and false; the IC
     MSM on the kernel engine at N = 2); in_group (ctx.in_group_affine on
     G1 and G2 at 2^10 points, True on [m]G, False on curve points outside
     the subgroup);
  9. MNT6-753 (mnt6753 line): K5, K6 and the field inversion at NW = 24
     bit for bit against their plain versions on MNT6753's Fq and Fr (edge
     values, all-ones words, powers of two, x x^-1 = 1), and timed for the
     kernels line (K5, K6 at 2^20, K5 at an NTT stage's shape, the
     inversion at one element); then, the kernel counts zeroed, every
     MNT6753 entry point of CurveContext: the batched field ops, the group
     law on G1 and on G2 over Fq3 against the oracle, ctx.msm (the plain
     engine, as the reference routes general-a and cubic-extension curves)
     at 2^12 G1 and 2^10 G2 bases against the oracle, msm_legacy at 2^8,
     group_map on 2^10 elements (on the curve, four equal to the host
     SvdW), fft / ifft at 2^15 over Fr, the ate pairing on four pairs
     (bilinearity, non-degeneracy, e(O, Q) = 1) and groth16.verify on the
     (mnt6753, mnt6753_g2) pair; fails unless that path launched K5, K6 and
     the inversion.

Output: one JSON object per line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Takes a few minutes on an H100, the build included.  Needs no network.

    python3 chip_smoke.py --profile

additionally runs one MSM of each path (G2 included) under torch.profiler and prints a
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
PLAIN_LANES = 4096  # lanes of the plain sweep at the main path's shape (256 serial steps)
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


def k8_adversarial(curve, dev, rng):
    """K8 (the log-depth scan, its tiles, levels and fix-ups) against
    segscan_plain, every entry as an affine point, on seg layouts
    aimed at its schedule, one layout a row of one call: every segment a
    singleton; one segment over all K; segments ending on every tile border
    and on every border of a level-1 tile; segments starting on every
    tile's last entry and on the last entry of every level-1 tile; buckets
    of 1-150 pieces, then the host's padding ids; at K = 5, 33, 1 056 and
    2 100 (one tile; a level of one element; a second level with a ragged
    tile; three levels).  Returns {case: max |err|}."""
    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.ops.curve import group
    from zprize_wasm_msm_tpu_torch.ops.msm import pl_sorted

    ctx = Z.build_curve(curve, device=dev)
    (X, Y), _, _ = _make_bases(ctx, 9, rng, dev)
    P = group.double(curve, group.from_affine(curve, (X, Y)))  # Z != 1
    n = X.shape[1]
    names = ("singletons", "one segment over all K", "segments of a tile", "segments of a level-1 tile",
             "segments from a tile's last entry", "segments from a level-1 tile's last entry",
             "buckets, then padding ids")
    out = {}
    for K in (5, 33, 1056, 2100):
        k = torch.arange(K, device=dev)
        lengths = torch.as_tensor(rng.integers(1, 151, size=512), device=dev)
        host = torch.repeat_interleave(torch.arange(512, device=dev), lengths)[: 3 * K // 5]
        host = torch.cat([host, 512 + torch.arange(K - host.numel(), device=dev)])
        seg = torch.stack([k, torch.zeros_like(k), k // 32, k // 1024, (k + 1) // 32, (k + 1) // 1024,
                           host]).to(torch.int32).contiguous()
        W = seg.shape[0]
        idx = torch.as_tensor(rng.integers(0, n, size=W * K), device=dev)
        idx[::9] = 0
        pieces = tuple(a[:, idx].reshape(a.shape[0], W, K).contiguous() for a in P)
        for i, coord in enumerate(group.zero(curve, (), dev)):
            pieces[i][:, :, 7::13] = coord[:, None, None]  # identities among the pieces
        got = pl_sorted.segscan(curve, pieces, seg, K)
        want = pl_sorted.segscan_plain(curve, pieces, seg, K)
        for w, name in enumerate(names):
            out[f"K={K}: {name}"] = affine_err(curve, tuple(a[:, w] for a in got), tuple(a[:, w] for a in want))
    return out


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
    EW = curve.field.elem_len // 2  # words of an element
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
            state = words.reshape(3 * EW, W, T, B).permute(1, 2, 3, 0).contiguous()
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
        # the plain version sums each window alone, so one call over the
        # three calls' windows side by side gives each call's sums
        wins = [window(k, B) for _, kinds in calls for k in kinds]
        bk = tuple(torch.stack([w[i] for w in wins], dim=1).contiguous() for i in range(3))
        want = pl_reduce.collapse_plain(curve, bk)
        lo = 0
        for name, kinds in calls:
            part = tuple(a[:, lo : lo + len(kinds)].contiguous() for a in bk)
            got = pl_reduce.collapse(curve, part)
            out[f"B={B}: {name}"] = affine_err(curve, got, tuple(a[:, lo : lo + len(kinds)] for a in want))
            lo += len(kinds)
    return out


def kernel_checks(curve, dev, rng, log2n, c, max_bits, lanes, tag):
    """K1 (with K4), K4 on its contract layout, K2, and K3 at B = 1 and (where
    W*B fits one block) at B, each against its plain version on 2^log2n
    bases; zero digits, +-B digits, (0,0) points, a point twice into one
    bucket.  Returns the errors (all must be 0)."""
    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.ops.curve import group
    from zprize_wasm_msm_tpu_torch.ops.msm import pl_bucket, pl_reduce, windows

    ctx = Z.build_curve(curve, device=dev)
    (X, Y), _, _ = _make_bases(ctx, log2n, rng, dev)
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
    sums = pl_reduce.collapse_plain(curve, ref)
    errs["collapse"] = affine_err(curve, pl_reduce.collapse(curve, ref), sums)
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


def sorted_checks(curve, dev, rng, log2n, c, chunks, tag):
    """The sorted engine's kernels against their plain versions on one
    given sorted stream, and its dense buckets against the bucket
    engine's plain version."""
    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.ops.msm import pl_bucket, pl_reduce, pl_sorted

    ctx = Z.build_curve(curve, device=dev)
    (X, Y), _, _ = _make_bases(ctx, log2n, rng, dev)
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


def fold2_ops(add_ref, dbl_ref, q):
    """The window fold's Fq2 links (csrc/fold2.cuh) in both forms, as
    (group_op name, reference, q operand)."""
    return tuple((f"{op}_fold2_{form}", ref, q) for form in ("warps", "lane")
                 for op, ref in (("add", add_ref), ("double", dbl_ref)))


def fq2_device_check(curve, dev, rng, n_random=500):
    """The Fq2 device functions (csrc/field2.cuh; the group ops of K1 and K4
    in csrc/group2.cuh, the level-parallel doubling and addition of
    csrc/par.cuh over Fq2 that K2 runs and the fold's links of csrc/fold2.cuh
    that K3 runs, in both forms; where 3b = k (1 + u) with 3b t by additions
    and with its level of products) bit for bit against the plain tower.Fq2
    and group ops.  Components take the
    values 0, 1, q-1, (q-1)/2, (q+1)/2 and stored words of all ones below
    the top word, in every pair, beside random elements; points are generic,
    P = Q, P = -Q, the affine and the projective identity, on projective
    representatives scaled by a random Fq2 element.  Returns the number of
    field elements held."""
    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch import _build
    from zprize_wasm_msm_tpu_torch.ops.curve import device_check, group

    F, fq = curve.field, curve.fq
    q = fq.q
    ctx = Z.build_curve(curve, device=dev)
    comps = [0, 1, q - 1, q // 2, q // 2 + 1, ((1 << (32 * (fq.n_words - 1))) - 1) % q]
    pairs = [(x, y) for x in comps for y in comps]
    rand = lambda: int.from_bytes(rng.bytes(48), "little") % q
    A = [u for u in pairs for _ in pairs] + [(rand(), rand()) for _ in range(n_random)]
    Bv = [v for _ in pairs for v in pairs] + [(rand(), rand()) for _ in range(n_random)]
    a, b = ctx._coords(A), ctx._coords(Bv)
    b3 = F.const(curve.b3, (1,), dev).expand_as(a)
    mul_ref = F.mul(a, b)
    # where 3b = k (1 + u) the level-parallel ops take 3b t as additions; they
    # are also held with b3k = 0, their level of products by 3b
    small_b3 = bool(_build.fold_b3k(curve))
    for op, ref in (
        ("mul", mul_ref), ("mul_cc", mul_ref), ("mul_coop", mul_ref), ("add", F.add(a, b)),
        ("sub", F.sub(a, b)), ("neg", F.neg(a)), ("mul_b3", F.mul(b3, a)), ("square", F.square(a)),
    ) + ((("mul_b3k", F.mul(b3, a)),) if small_b3 else ()):
        got = device_check.field_op(curve, op, a, b)
        torch.cuda.synchronize()
        check(bool((got == ref).all()), f"{curve.name}: device Fq2 fe_{op} != tower.Fq2")
    # group ops on points: generic, P = Q, P = -Q, affine identity, projective identity
    (PX, PY), _, _ = _make_bases(ctx, 6, rng, dev)
    QX, QY = PX.roll(1, dims=1).clone(), PY.roll(1, dims=1).clone()
    QX[:, 0:4], QY[:, 0:4] = PX[:, 0:4], PY[:, 0:4]  # P = Q
    QX[:, 4:8], QY[:, 4:8] = PX[:, 4:8], F.neg(PY[:, 4:8])  # P = -Q
    QX[:, 8:12], QY[:, 8:12] = 0, 0  # affine identity
    lam = a[:, -PX.shape[1]:]
    lam = F.select(F.is_zero(lam), F.one(lam.shape[1:], dev), lam)
    P = (F.mul(PX, lam), F.mul(PY, lam), lam.clone())
    for i, coord in enumerate(group.zero(curve, (4,), dev)):
        P[i][:, 12:16] = coord  # projective identity
    Q = group.from_affine(curve, (QX, QY))
    add_ref, dbl_ref = group.add(curve, P, Q), group.double(curve, P)
    b3ks = (None, 0) if small_b3 else (None,)
    for op, ref, qin in (
        ("add_cc", add_ref, Q), ("add_coop", add_ref, Q),
        ("add_mixed", group.add_mixed(curve, P, (QX, QY)), (QX, QY, Q[2])),
        ("double_coop", dbl_ref, Q), *fold2_ops(add_ref, dbl_ref, Q),
    ):
        for b3k in b3ks if op.endswith(("_coop", "_warps", "_lane")) else (None,):
            got = device_check.group_op(curve, op, P, qin, b3k)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                check(bool((g == r).all()), f"{curve.name}: device Fq2 pt_{op} (b3k {b3k}) != group")
    # and on coordinates that are any field values, three to a point
    m = a.shape[1] // 3
    Pr = tuple(a[:, i * m : (i + 1) * m].contiguous() for i in range(3))
    Qr = tuple(b[:, i * m : (i + 1) * m].contiguous() for i in range(3))
    add_r, dbl_r = group.add(curve, Pr, Qr), group.double(curve, Pr)
    for op, ref, _ in (("add_cc", add_r, Qr), ("add_coop", add_r, Qr), ("double_coop", dbl_r, Qr),
                       *fold2_ops(add_r, dbl_r, Qr)):
        for b3k in b3ks if op != "add_cc" else (None,):
            got = device_check.group_op(curve, op, Pr, Qr, b3k)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                check(bool((g == r).all()),
                      f"{curve.name}: device Fq2 pt_{op} (b3k {b3k}) != group on edge coordinates")
    return a.shape[1]


def oracle_of(curve):
    """The host oracle of a curve: coordinates in Fq, Fq2 (ext 2) or Fq3
    (ext 3), any a."""
    from zprize_wasm_msm_tpu_torch.oracle import F2, F3, Curve as OracleCurve

    field = {1: None, 2: F2, 3: F3}[curve.ext]
    field = field and field(curve.q, curve.nr)
    return OracleCurve(q=curve.q, a=curve.a, b=curve.b, r=curve.r, gx=curve.gx, gy=curve.gy, field=field)


def bases_and_scalars(ctx, log2n, rng, dev, prefix=None, base_sum=False):
    """2^log2n distinct bases [m_i]G (_make_bases), full scalars below r,
    and the oracle's (sum k_i m_i mod r) G; with ``prefix``, also the
    oracle's sum over the first ``prefix`` points; with ``base_sum``, also
    (sum m_i mod r) G, the MSM with every scalar 1."""
    curve = ctx.spec
    (X, Y), m0, ds = _make_bases(ctx, log2n, rng, dev)
    n = 1 << log2n
    ks = rng.integers(0, 1 << 62, size=(n,), dtype=np.uint64)
    mix = int.from_bytes(rng.bytes(24), "little")  # widen to full scalars
    kints = [(int(k) * mix + int(k)) % curve.r for k in ks]
    idx = np.arange(n)
    mults = np.full(n, m0, dtype=object)
    for k, d in enumerate(ds):
        mults = mults + ((idx >> k) & 1).astype(object) * d
    terms = np.array(kints, dtype=object) * (mults % curve.r)
    oc = oracle_of(curve)
    out = (X, Y), ctx.scalars_to_device(kints), oc.mul(oc.g, int(terms.sum() % curve.r))
    if prefix is not None:
        out += (oc.mul(oc.g, int(terms[:prefix].sum() % curve.r)),)
    if base_sum:
        out += (oc.mul(oc.g, int(mults.sum() % curve.r)),)
    return out


def msm_oracle_check(curve, dev, rng, log2n, variants):
    """ctx.msm at 2^log2n under each of ``variants`` ({name: msm kwargs})
    against the oracle; returns {name: {ms, launches}} (the launches of
    one msm + result_to_affine, counts zeroed just before)."""
    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.ops.field import kernels as field_kernels
    from zprize_wasm_msm_tpu_torch.ops.msm import pl_bucket, pl_reduce

    ctx = Z.build_curve(curve, device=dev)
    P, k, expected = bases_and_scalars(ctx, log2n, rng, dev)
    out = {}
    for name, kw in variants.items():
        ctx.msm(P, k, **kw)  # warm
        pl_bucket.launches = 0
        for counts in (pl_reduce.launches, field_kernels.launches):
            for key in counts:
                counts[key] = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = ctx.result_to_affine(ctx.msm(P, k, **kw))
        ms = (time.perf_counter() - t) * 1e3
        check(got == expected, f"{curve.name} {name}: msm at 2^{log2n} does not match the oracle")
        launches = {"bucket_sweep": pl_bucket.launches, **pl_reduce.launches, **field_kernels.launches}
        out[name] = {"ms": ms, "launches": {a: b for a, b in launches.items() if b},
                     "verified_against_oracle": True}
    return out


def engine_agreement(dev, rng, log2n, log2n_legacy_g2):
    """The port's counterpart of tools/engine_diff.py: every engine on one
    input, all equal as group elements (the same affine point) and equal to
    the oracle.  BLS12-381 G1 at 2^log2n: the default (GLV split, bucket
    kernels), use_glv=False c = 7, kernel-sorted, the plain engine (c = 8,
    1 024 lanes: its own memory-budget rule picks c = 13 and 128 lanes, 1 024
    serial steps of PyTorch ops) and msm_legacy (a per-point ladder and a tree
    sum: no stage shared with the others).  BLS12-381 G2: kernel,
    kernel-sorted, and msm_legacy on the first 2^log2n_legacy_g2 of the same
    points (held against their own oracle sum).  Returns
    {curve: {engine: {ms, ...}}}; fails on any disagreement."""
    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.models.curves import bls12_381, bls12_381_g2

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    out = {}
    for curve, engines in (
        (bls12_381, {"default (GLV, kernel)": {}, "use_glv=False c=7": {"use_glv": False, "c": 7},
                     "kernel-sorted": {"impl": "kernel-sorted"},
                     "plain c=8 T=1024": {"impl": "plain", "c": 8, "lanes": 1024}}),
        (bls12_381_g2, {"kernel": {"impl": "kernel"}, "kernel-sorted": {"impl": "kernel-sorted"}}),
    ):
        ctx = Z.build_curve(curve, device=dev)
        n_leg = 1 << (log2n if curve.ext == 1 else log2n_legacy_g2)
        P, k, expected, want = bases_and_scalars(ctx, log2n, rng, dev, prefix=n_leg)
        res = {}
        points = []
        for name, kw in engines.items():
            if kw.get("impl") != "plain":  # the plain engine is timed cold: ~14 s a call
                ctx.msm(P, k, **kw)  # warm
            pt, ms = timed(lambda: ctx.msm(P, k, **kw))
            points.append(pt)
            res[name] = {"ms": ms, "n": 1 << log2n}
        # msm_legacy on all points, or on the first n_leg (their own oracle
        # sum, which the kernel engine must give on them too)
        sub, k_sub = tuple(a[:, :n_leg].contiguous() for a in P), k[:, :n_leg].contiguous()
        pt, ms = timed(lambda: ctx.msm_legacy(sub, k_sub))
        points.append(pt)
        if n_leg < 1 << log2n:
            check(ctx.result_to_affine(ctx.msm(sub, k_sub)) == want,
                  f"{curve.name}: msm at {n_leg} points disagrees with the oracle")
        res["msm_legacy"] = {"ms": ms, "n": n_leg}
        got = [ctx.result_to_affine(p) for p in points[:-1]]
        check(all(g == expected for g in got), f"{curve.name}: the engines disagree with the oracle at 2^{log2n}")
        check(ctx.result_to_affine(points[-1]) == want, f"{curve.name}: msm_legacy disagrees at {n_leg} points")
        # as group elements, projective to projective (the representatives differ)
        from zprize_wasm_msm_tpu_torch.ops.curve import group

        ref = tuple(c[:, None] for c in points[0])
        for p in points[1:-1]:
            check(bool(group.eq(curve, ref, tuple(c[:, None] for c in p)).all()),
                  f"{curve.name}: two engines' points are not the same group element")
        for name in res:
            res[name]["equal"] = True
        out[curve.name] = res
    return out


def serde_phase(dev, rng, log2n):
    """G1 and G2 points at 2^log2n to bytes and back on the card, compressed
    and uncompressed (the JAX package's wire formats), exact, and infinity
    (the 0x40 flag) in a batch of eight; then ctx.msm over the decompressed
    G2 bases against the oracle (a G2 prover's path).  Returns timings."""
    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.models.curves import bls12_381, bls12_381_g2

    out = {}
    for curve in (bls12_381, bls12_381_g2):
        ctx = Z.build_curve(curve, device=dev)
        (X, Y), k, expected = bases_and_scalars(ctx, log2n, rng, dev)
        rep = {"n": 1 << log2n}
        for fmt, enc, dec in (("uncompressed", ctx.to_uncompressed, ctx.from_uncompressed),
                              ("compressed", ctx.to_compressed, ctx.from_compressed)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            raw = enc(X, Y)
            t1 = time.perf_counter()
            X2, Y2 = dec(raw)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            check(X2.device == X.device and torch.equal(X2, X) and torch.equal(Y2, Y),
                  f"{curve.name}: {fmt} round trip is not exact")
            rep[f"to_{fmt}_ms"] = (t1 - t) * 1e3
            rep[f"from_{fmt}_ms"] = (t2 - t1) * 1e3
            rep[f"{fmt}_bytes_per_point"] = int(raw.shape[1])
            Xi, Yi = X[:, :8].clone(), Y[:, :8].clone()
            Xi[:, 3], Yi[:, 3] = 0, 0  # infinity
            raw_i = enc(Xi, Yi)
            Xj, Yj = dec(raw_i)
            check(raw_i[3, 0] == 0x40 and not raw_i[3, 1:].any() and torch.equal(Xj, Xi)
                  and torch.equal(Yj, Yi), f"{curve.name}: {fmt} infinity does not round-trip")
        if curve.ext == 2:
            # the G2 prover's path: compressed bases in, decompressed, msm
            check(ctx.result_to_affine(ctx.msm((X2, Y2), k)) == expected,
                  "msm over decompressed G2 bases does not match the oracle")
            rep["msm_over_decompressed_bases_verified_against_oracle"] = True
        out[curve.name] = rep
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


# ---- the Groth16 stack: NTT, poly, pairings, subgroup checks, verifier ------
# Plain PyTorch but for the NTT's products (the mont_mul kernel, K5), the
# field inversion of the pairing's one Fq2 inversion and of to_affine, and
# the MSM kernels of the verifier's IC sum; launch-bound on the host.


def device_ops(fn):
    """(result, device operations) of one call of fn: the kernels, copies
    and fills torch.profiler records on the card (CUDA activity only, so
    the host side runs as without it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA)
    check(n > 0, "torch.profiler recorded no device activity")
    return out, n


def host_timed(fn, reps: int = 1):
    """(last result, best host-clock seconds) of reps calls, each ending in
    a synchronize."""
    best, out = None, None
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        best = s if best is None else min(best, s)
    return out, best


def _fr_limbs(fr, n, rng, dev):
    """n random canonical Fr elements as (L, n) limbs on the card: random
    16-bit limbs under a top limb below q's (so every value is below q)."""
    L = fr.n_limbs
    top = int(fr.q_limbs[L - 1])
    limbs = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    limbs[L - 1] = rng.integers(0, top, size=n, dtype=np.int64)
    return torch.as_tensor(limbs, device=dev)


def _fr_ints(fr, t):
    """(L, n) Montgomery limbs on the card -> standard-domain ints."""
    from zprize_wasm_msm_tpu_torch.utils.limbs import limbs_to_ints

    return [fr.from_mont_int(v) for v in limbs_to_ints(t.cpu().numpy())]


def ntt_phase(dev, rng, log2n=20):
    """ctx.fft / ctx.ifft on BLS12-381 Fr at 2^log2n: the round trip, the
    K5-routed NTT against impl='plain' bit for bit, 2^10 against oracle.ntt;
    set-up (the host tables) apart from the warm calls (best of 3), K5
    launches a call, peak memory; one K5 call at a stage's shape."""
    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.ops.field import kernels as field_kernels
    from zprize_wasm_msm_tpu_torch.ops.poly import fft as fft_mod
    from zprize_wasm_msm_tpu_torch.oracle import ntt

    ctx = Z.build_bls12381()
    fr = ctx.fr
    n = 1 << log2n
    x = _fr_limbs(fr, n, rng, dev)
    out = {"n": n, "field": "bls12_381 Fr", "L": fr.n_limbs}
    for name, call in (("fft", lambda: ctx.fft(x)), ("ifft", lambda: ctx.ifft(x))):
        _, first_s = host_timed(call)
        _, warm_s = host_timed(call, 3)
        k5_before = field_kernels.launches["mont_mul"]
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, ops = device_ops(call)
        out[name] = {"first_call_s": first_s, "best_s": warm_s, "setup_s": first_s - warm_s,
                     "k5_launches": field_kernels.launches["mont_mul"] - k5_before, "device_ops": ops,
                     "peak_bytes_above_input": torch.cuda.max_memory_allocated() - base}
        check(out[name]["k5_launches"] == log2n + (name == "ifft"),
              f"{name} at 2^{log2n} launched K5 {out[name]['k5_launches']} times")
    y = ctx.fft(x)
    check(torch.equal(ctx.ifft(y), x), f"ifft(fft(x)) != x at 2^{log2n}")
    yp, plain_s = host_timed(lambda: ctx.fft(x, impl="plain"))
    check(torch.equal(y, yp), f"the K5-routed NTT differs from impl='plain' at 2^{log2n}")
    out["plain_fft_s"] = plain_s
    out["round_trip_exact"] = out["k5_equals_plain"] = True
    # one stage's product (2^(log2n-1) elements) through K5 against plain
    half = n // 2
    tw = fft_mod._twiddles_on(fr.q, fr.n_limbs, n, False, x.device)
    a = x[:, :half].contiguous()
    field_kernels.mont_mul(fr, a, tw)
    got, k5_ms = sync_ms(lambda: field_kernels.mont_mul(fr, a, tw), 5)
    ref, k5_plain_ms = sync_ms(lambda: field_kernels.mont_mul_plain(fr, a, tw))
    check(torch.equal(got, ref), "K5 at the NTT's stage shape differs from mont_mul")
    nw = fr.n_words
    b_bytes, b_ops = 3 * 4 * nw * half, half * (2 * nw * nw + nw) * 2
    out["k5_stage_call"] = {"shape": f"({fr.n_limbs},{half})", "ms": k5_ms, "plain_ms": k5_plain_ms,
                            "max_abs_err": 0,
                            "bound_ms": max(b_bytes / PEAK_BYTES_PER_S, b_ops / PEAK_INT32_OPS_PER_S) * 1e3,
                            "bound_by": "bytes" if b_bytes / PEAK_BYTES_PER_S >= b_ops / PEAK_INT32_OPS_PER_S
                            else "operations"}
    del y, yp, got, ref
    # 2^10 against the O(n^2) oracle
    m = 1 << 10
    xs = x[:, :m].contiguous()
    t0 = time.perf_counter()
    want = ntt(_fr_ints(fr, xs), fr.q, fft_mod._root_of_unity(fr.q, m))
    check(_fr_ints(fr, ctx.fft(xs)) == want, "fft at 2^10 differs from oracle.ntt")
    out["oracle_2^10"] = {"equal": True, "host_s": time.perf_counter() - t0}
    return out


def poly_phase(dev, rng, log2n=16, log2n_group=2):
    """The snarkjs FFT helpers, the QAP and applykey helpers at 2^log2n and
    pedersen_hash on a batch, each against the formula on host ints; then
    group_fft / group_ifft on BLS12-381 G1 at 2^log2n_group: FFT(k_i G) =
    NTT(k) G, and the round trip."""
    from zprize_wasm_msm_tpu_torch.models.curves import bls12_381
    from zprize_wasm_msm_tpu_torch.ops.curve import group
    from zprize_wasm_msm_tpu_torch.ops.field import kernels as field_kernels
    from zprize_wasm_msm_tpu_torch.ops.poly import applykey, fft as fft_mod, pedersen, pol, qap
    from zprize_wasm_msm_tpu_torch.oracle import ntt
    import zprize_wasm_msm_tpu_torch as Z

    ctx = Z.build_bls12381()
    fr = ctx.fr
    r = fr.q
    n = 1 << log2n
    out = {"n": n}
    k5_before = field_kernels.launches["mont_mul"]
    b1, b2 = _fr_limbs(fr, n, rng, dev), _fr_limbs(fr, n, rng, dev)
    fi = _fr_limbs(fr, 2, rng, dev)
    first, inc = fi[:, 0].contiguous(), fi[:, 1].contiguous()
    h1, h2 = _fr_ints(fr, b1), _fr_ints(fr, b2)
    f0, i0 = _fr_ints(fr, fi)
    w = [f0]
    for _ in range(n - 1):
        w.append(w[-1] * i0 % r)
    total_bits = log2n
    m_, s_ = fft_mod._shift_consts(r, total_bits)

    def helper(name, call, want):
        got, s = host_timed(call)
        got = got if isinstance(got, tuple) else (got,)
        check(all(_fr_ints(fr, g) == wv for g, wv in zip(got, want)), f"{name} differs from its formula")
        out[name] = {"s": s, "equal_to_formula": True}

    helper("fft_join", lambda: fft_mod.fft_join(fr, b1, b2, first, inc),
           ([(a + wi * b) % r for a, b, wi in zip(h1, h2, w)], [(a - wi * b) % r for a, b, wi in zip(h1, h2, w)]))
    exp = 4
    root = fft_mod._root_of_unity(r, 1 << exp)
    half = 1 << (exp - 1)
    mix_want = list(h1)
    for g in range(0, n, 1 << exp):
        for j in range(half):
            a, b = h1[g + j], h1[g + j + half] * pow(root, j, r) % r
            mix_want[g + j], mix_want[g + j + half] = (a + b) % r, (a - b) % r
    helper("fft_mix", lambda: fft_mod.fft_mix(fr, b1, exp), (mix_want,))
    helper("fft_final", lambda: fft_mod.fft_final(fr, b1, first), ([a * f0 % r for a in h1],))
    helper("fft_join_ext", lambda: fft_mod.fft_join_ext(fr, b1, b2, first, inc, total_bits),
           ([(a + b) % r for a, b in zip(h1, h2)], [(a + m_ * b) * wi % r for a, b, wi in zip(h1, h2, w)]))
    helper("fft_join_ext_inv", lambda: fft_mod.fft_join_ext_inv(fr, b1, b2, first, inc, total_bits),
           ([(b * wi - m_ * a) * s_ % r for a, b, wi in zip(h1, h2, w)],
            [(a - b * wi) * s_ % r for a, b, wi in zip(h1, h2, w)]))
    helper("prepare_lagrange_evaluation",
           lambda: fft_mod.prepare_lagrange_evaluation(fr, b1, b2, first, inc, total_bits),
           ([(b - m_ * a) * s_ % r for a, b in zip(h1, h2)], [(a - b) * wi % r for a, b, wi in zip(h1, h2, w)]))
    helper("batch_apply_key_fr", lambda: applykey.batch_apply_key_fr(fr, b1, first, inc),
           ([a * wi % r for a, wi in zip(h1, w)],))
    # QAP: n records (A and B) into n/16 constraints, then C = A*B and A*B - C
    nc = n // 16
    mat = torch.as_tensor(rng.integers(0, 2, n), device=dev)
    con = torch.as_tensor(rng.integers(0, nc, n), device=dev)
    (A, B), abc_s = host_timed(lambda: qap.build_abc(fr, mat, con, b1, b2, nc))
    wa, wb = [0] * nc, [0] * nc
    for mm, cc, co, wv in zip(mat.tolist(), con.tolist(), h1, h2):
        if mm == 0:
            wa[cc] = (wa[cc] + co * wv) % r
        else:
            wb[cc] = (wb[cc] + co * wv) % r
    check(_fr_ints(fr, A) == wa and _fr_ints(fr, B) == wb, "build_abc differs from its sums")
    C = qap.mul_ab(fr, A, B)
    check(_fr_ints(fr, C) == [a * b % r for a, b in zip(wa, wb)], "mul_ab differs")
    P_, join_s = host_timed(lambda: qap.join_abc(fr, A, B, B))
    check(_fr_ints(fr, P_) == [(a * b - b) % r for a, b in zip(wa, wb)], "join_abc differs")
    out["build_abc"] = {"s": abc_s, "records": n, "constraints": nc, "equal_to_formula": True}
    out["join_abc"] = {"s": join_s, "equal_to_formula": True}
    # construct_lc with 4 096 terms per output, above the JAX package's 2^10
    pos = torch.arange(n, device=dev) % 16
    lc, lc_s = host_timed(lambda: pol.construct_lc(fr, b1, pos, b2, 16))
    lc_want = [0] * 16
    for j, (co, sg) in enumerate(zip(h1, h2)):
        lc_want[j % 16] = (lc_want[j % 16] + co * sg) % r
    check(_fr_ints(fr, lc) == lc_want, "construct_lc above 2^10 terms an output differs from the oracle")
    out["construct_lc"] = {"s": lc_s, "terms_per_output": n // 16, "equal_to_oracle": True}
    out["k5_launches"] = field_kernels.launches["mont_mul"] - k5_before
    check(out["k5_launches"] > 0, "the poly helpers never launched K5")
    # pedersen_hash: 256 messages of 48 bits on BLS12-381 G1, a base every 8 windows
    oc = oracle_of(bls12_381)
    bases = [oc.mul(oc.g, int(k)) for k in rng.integers(2, 1 << 60, size=2)]
    table = pedersen.make_base_table(bls12_381, bases, dev)
    nb, nm, chunk = 48, 256, 8
    bits_np = rng.integers(0, 2, size=(nb, nm))
    hsh, ped_s = host_timed(lambda: pedersen.pedersen_hash(bls12_381, torch.as_tensor(bits_np, device=dev),
                                                           table, chunk_size=chunk))
    got = [None if p == (0, 0) else p  # (0, 0) encodes the identity
           for p in zip(*[bls12_381.field.to_host(c) for c in group.to_affine(bls12_381, hsh)])]
    for j in range(nm):
        acc = None
        for wd in range(nb // 3):
            b0, b1_, sg = bits_np[3 * wd : 3 * wd + 3, j]
            pt = oc.mul(bases[min(wd // chunk, len(bases) - 1)], 1 + int(b0) + 2 * int(b1_))
            acc = oc.add(acc, oc.neg(pt) if sg else pt)
        check(got[j] == acc, f"pedersen_hash message {j} differs from the oracle")
    out["pedersen_hash"] = {"s": ped_s, "messages": nm, "bits": nb, "equal_to_oracle": True}
    # group FFT over k_i G (host-made points) and back
    ng = 1 << log2n_group
    ks = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(ng)]
    pts = group.from_affine(bls12_381, ctx.points_to_device([oc.mul(oc.g, k) for k in ks]))
    G, gfft_s = host_timed(lambda: ctx.group_fft(pts))
    want = [oc.mul(oc.g, k) for k in ntt(ks, r, fft_mod._root_of_unity(r, ng))]
    ax, ay = group.to_affine(bls12_381, G)
    check(list(zip(bls12_381.field.to_host(ax), bls12_381.field.to_host(ay))) == want,
          "group_fft(k_i G) != NTT(k) G")
    back, gifft_s = host_timed(lambda: fft_mod.group_ifft(bls12_381, G))
    bx, by = group.to_affine(bls12_381, back)
    check(torch.equal(bx, pts[0]) and torch.equal(by, pts[1]), "group_ifft(group_fft(P)) != P")
    out["group_fft"] = {"n": ng, "curve": "bls12_381 G1", "fft_s": gfft_s, "ifft_s": gifft_s,
                        "equal_to_oracle": True, "round_trip_exact": True}
    return out


def pairing_ops(ps, cols, device, P=None, Q=None, count=None):
    """Device operations of final_exponentiation (and, given the pairs P, Q,
    of miller_loop) at ps's full exponent and loop count, for a batch of
    ``cols`` columns, from counted runs at short ones.  Every Miller step
    launches the same operations whatever its bit (the add step is computed
    and selected), and each exponentiation step a cyclotomic square and, on
    a nonzero digit, an Fq12 product: so a loop of n steps is its head and
    tail plus n steps, and the final exponentiation's chain of
    exponentiations by |x| (BLS12, five) or z (BN, three) is its fixed part
    plus their squares and products.  ``count`` (device_ops by default)
    counts one call, after a first call has filled the constant caches."""
    import dataclasses

    from zprize_wasm_msm_tpu_torch.ops.pairing import bls12

    counter = count or (lambda fn: device_ops(fn)[1])

    def count(fn):
        fn()
        return counter(fn)

    tw = ps.tower
    if isinstance(ps, bls12.PairingSpec):
        mod, exps, param, sign = bls12, 5, abs(ps.x), -1 if ps.x < 0 else 1
        short = lambda e: dataclasses.replace(ps, x=sign * e)  # noqa: E731
        steps = lambda e: e.bit_length() - 2  # noqa: E731
    else:
        from zprize_wasm_msm_tpu_torch.ops.pairing import bn as mod

        exps, param = 3, ps.z
        short = lambda e: dataclasses.replace(ps, z=e)  # noqa: E731
        steps = lambda e: (6 * e + 2).bit_length() - 1  # noqa: E731
    e_a, e_b = 3, 7  # one loop step apart on either family (BN: 6z+2 = 20, 44)
    out = {}
    if P is not None:
        Pc, Qc = (tuple(x[:, :1].expand(-1, cols).contiguous() for x in pt) for pt in (P, Q))
        ml_a = count(lambda: mod.miller_loop(short(e_a), Pc, Qc))
        ml_b = count(lambda: mod.miller_loop(short(e_b), Pc, Qc))
        out["miller_step"] = (ml_b - ml_a) // (steps(e_b) - steps(e_a))
        out["miller_loop"] = ml_a + (steps(param) - steps(e_a)) * out["miller_step"]
    f = tw.f12_one((cols,), device)
    fe_a = count(lambda: mod.final_exponentiation(short(e_a), f))
    sq = count(lambda: tw.f12_cyclotomic_square(f))
    mul = count(lambda: tw.f12_mul(f, f))

    def chain(e):  # cyclotomic squares and products of one exponentiation
        digits = bls12._naf_digits_msb(e)
        return (len(digits) - 1) * sq + sum(1 for d in digits[1:] if d) * mul

    out.update({"final_exponentiation": fe_a + exps * (chain(param) - chain(e_a)),
                "cyclotomic_square": sq, "f12_mul": mul})
    return out


def pairing_phase(curve_pair, dev, rng, plain_check=True):
    """One pairing family (BLS12-381 or BN254).  ctx.pairing is
    final_exponentiation(miller_loop(.)): the two calls on four pairs,
    timed one after the other, give bilinearity e(aP, bQ) = e(P, Q)^(ab) =
    e(abP, Q), non-degeneracy and e(O, Q) = 1; with ``plain_check``, the
    fast final exponentiation against final_exponentiation_plain on e(P,
    Q)'s Miller value (BLS12-381: the plain value cubed; BN254: to the
    power d = 2z(6z^2+3z+1), the fixed multiple the BN chain computes);
    device operations (torch.profiler) by pairing_ops: a Miller step's count
    times the steps.  pairing_eq is checked true on a product of four
    pairings that is 1 and false on a perturbed one by the groth16 phase:
    its verifies are exactly that."""
    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.ops.field import kernels as field_kernels
    from zprize_wasm_msm_tpu_torch.ops.pairing import bls12

    g1c, g2c = curve_pair
    c1, c2 = Z.build_curve(g1c), Z.build_curve(g2c)
    oc1, oc2 = oracle_of(g1c), oracle_of(g2c)
    _, ps = c1._pairing
    tw = ps.tower
    r = g1c.r
    P, Q = oc1.g, oc2.g
    a, b = (int(v) for v in rng.integers(2, 1 << 62, size=2))
    out = {"curve": g1c.name}
    P4 = c1.points_to_device([oc1.mul(P, a), P, oc1.mul(P, a * b % r), None])
    Q4 = c2.points_to_device([oc2.mul(Q, b), Q, Q, Q])
    inv_before = field_kernels.launches["inverse"]
    f, ml_s = host_timed(lambda: c1.miller_loop(P4, Q4))
    e, fe_s = host_timed(lambda: c1.final_exponentiation(f))
    inverses = field_kernels.launches["inverse"] - inv_before
    ops4 = pairing_ops(ps, 4, dev, P4, Q4)
    out["pairing_4_pairs"] = {"s": ml_s + fe_s, "miller_loop_s": ml_s, "final_exponentiation_s": fe_s,
                              "field_inverse_launches": inverses,
                              "device_ops": ops4["miller_loop"] + ops4["final_exponentiation"],
                              "device_ops_by_part": ops4}
    one = tw.f12_one((1,), dev)[:, 0]
    check(torch.equal(e[:, 0], e[:, 2]), f"{g1c.name}: e(aP, bQ) != e(abP, Q)")
    pow_ab = bls12._cyclotomic_exp(tw, e[:, 1:2], a * b, False)[:, 0]
    check(torch.equal(e[:, 0], pow_ab), f"{g1c.name}: e(aP, bQ) != e(P, Q)^(ab)")
    check(not torch.equal(e[:, 1], one), f"{g1c.name}: e(P, Q) = 1 (degenerate)")
    check(torch.equal(e[:, 3], one), f"{g1c.name}: e(O, Q) != 1")
    if plain_check:
        plain, plain_s = host_timed(lambda: bls12.final_exponentiation_plain(ps, f[:, 1:2]))
        power = 3 if isinstance(ps, bls12.PairingSpec) else 2 * ps.z * (6 * ps.z * ps.z + 3 * ps.z + 1)
        check(torch.equal(e[:, 1:2], bls12._cyclotomic_exp(tw, plain, power, False)),
              f"{g1c.name}: final_exponentiation != final_exponentiation_plain^{power}")
        out["final_exponentiation_plain"] = {"s": plain_s, "fast_equals_plain_to_the": power}
    else:
        out["final_exponentiation_plain"] = "not run on the card (the CPU tests hold the chain)"
    # pairing_eq on four pairs: the Miller loop on four pairs, the product
    # tree, one final exponentiation on one column and the comparison (its
    # true and false cases and its time: the groth16 phase's verifies)
    ops1 = pairing_ops(ps, 1, dev)
    _, tree_ops = device_ops(lambda: (bls12._f12_product_tree(ps, f) == tw.f12_one((1,), dev)).all())
    out["pairing_eq_4_pairs"] = {
        "device_ops": ops4["miller_loop"] + tree_ops + ops1["final_exponentiation"],
        "checked_and_timed_in": "groth16 (verify: true on the valid proof, false on a corrupted one)"}
    return out


def groth16_phase(dev, rng):
    """groth16.verify on an instance made as tests/test_groth16.py makes it
    (two public inputs), on BLS12-381 (G2 from bls12_381_g2) and BN254: the
    valid proof True, on BLS12-381 a corrupted C False (a corrupted public
    input: the CPU tests).  These are ctx.pairing_eq true on a product of four
    pairings that is 1 and false on a perturbed one.  The time of a
    verify, of its IC MSM alone, and the rest: its pairing_eq (with the
    vk_x fold and the copies)."""
    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.models import groth16
    from zprize_wasm_msm_tpu_torch.models.curves import bls12_381, bls12_381_g2, bn254, bn254_g2
    from zprize_wasm_msm_tpu_torch.ops.field import kernels as field_kernels
    from zprize_wasm_msm_tpu_torch.ops.msm import pl_bucket, pl_reduce

    import importlib.util

    # the instance maker of the port's tests (jax-free), by its path: another
    # package named "tests" may stand earlier on the path
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "_torch_groth16.py")
    spec = importlib.util.spec_from_file_location("_torch_groth16", path)
    helper = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helper)
    make_instance = helper.make_instance

    out = {}
    for g1c, g2c in ((bls12_381, bls12_381_g2), (bn254, bn254_g2)):
        c1, c2 = Z.build_curve(g1c), Z.build_curve(g2c)
        vk, proof, publics, oc1, c = make_instance(rng, 2, g1c, g2c)
        before = {"bucket_sweep": pl_bucket.launches, **pl_reduce.launches, **field_kernels.launches}
        ok, s = host_timed(lambda: groth16.verify(c1, c2, vk, proof, publics))
        after = {"bucket_sweep": pl_bucket.launches, **pl_reduce.launches, **field_kernels.launches}
        launches = {key: after[key] - before[key] for key in after}
        check(ok is True, f"groth16 on {g1c.name}: a valid proof is rejected")
        check(launches["bucket_sweep"] > 0, f"groth16 on {g1c.name}: the IC MSM launched no sweep")
        if g1c is bls12_381:  # one curve: a verify is one pairing_eq of ~17 s
            bad = groth16.Proof(a=proof.a, b=proof.b, c=oc1.mul(oc1.g, c + 1))
            check(groth16.verify(c1, c2, vk, bad, publics) is False,
                  f"groth16 on {g1c.name}: a corrupted C verifies")
        P = c1.points_to_device(vk.ic[1:])
        k = c1.scalars_to_device(publics)
        acc, msm_s = host_timed(lambda: c1.msm(P, k))
        check(c1.result_to_affine(acc) == oc1.msm(vk.ic[1:], publics), f"groth16 on {g1c.name}: IC MSM wrong")
        out[g1c.name] = {"verify_s": s, "msm_s": msm_s, "n_publics": 2,
                         "pairing_eq_4_pairs_s": s - msm_s, "pairing_eq_timed_as": "verify less its MSM",
                         "valid": True, "corrupted_c": False if g1c is bls12_381 else "not run",
                         "kernel_launches": {a: v for a, v in launches.items() if v}}
    return out


def in_group_phase(dev, rng, log2n=10):
    """ctx.in_group_affine on BLS12-381 G1 and G2 at 2^log2n points: True on
    [m]G, False on curve points outside the subgroup (G1: x from 5 up with
    y^2 = x^3 + 4 solvable; G2: x = (3 + i, 1), as the JAX tests make them)."""
    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.models.curves import bls12_381, bls12_381_g2
    from zprize_wasm_msm_tpu_torch.oracle import F as HostF, F2 as HostF2

    n = 1 << log2n
    out = {"n": n}
    q = bls12_381.q
    f = HostF(q)
    f2 = HostF2(q, -1)

    def sqrt_f2(a):
        c0, c1 = a
        sn = f.sqrt((c0 * c0 + c1 * c1) % q)
        if sn is None:
            return None
        for s in (sn, (-sn) % q):
            x0 = f.sqrt((c0 + s) * pow(2, q - 2, q) % q)
            if x0 is None or x0 == 0:
                continue
            cand = (x0, c1 * pow(2 * x0, q - 2, q) % q)
            if f2.sqr(cand) == f2.of(a):
                return cand
        return None

    for curve in (bls12_381, bls12_381_g2):
        ctx = Z.build_curve(curve)
        oc = oracle_of(curve)
        bad, x = [], 5
        while len(bad) < 8:  # curve points of random cosets: outside the order-r subgroup
            if curve.ext == 1:
                y = f.sqrt((x * x * x + 4) % q)
                pt = (x, y) if y else None
            else:
                xx = (3 + x, 1)
                y = sqrt_f2(f2.add(f2.mul(f2.mul(xx, xx), xx), f2.of((4, 4))))
                pt = (xx, y) if y else None
            if pt is not None and oc.is_on_curve(pt) and oc.mul(pt, curve.r) is not None:
                bad.append(pt)
            x += 1
        ms = [int(v) for v in rng.integers(1, 1 << 62, size=4)]
        seeds = [oc.mul(oc.g, m) for m in ms]
        pts = [seeds[i % 4] for i in range(n - len(bad))] + bad
        want = [True] * (n - len(bad)) + [False] * len(bad)
        Pd = ctx.points_to_device(pts)
        got, s = host_timed(lambda: ctx.in_group_affine(Pd))
        check(got.tolist() == want, f"in_group_affine on {curve.name} disagrees with membership")
        out[curve.name] = {"s": s, "in_group": n - len(bad), "outside": len(bad)}
    return out


# ---- MNT6-753: general a, Fq3 coordinates, the ate pairing, the SvdW map --
# The kernels at NW = 24 words (K5, K6, the field inversion), then the path:
# every MNT6753 entry point of CurveContext on the card, plain PyTorch but
# for those kernels (the reference routes a != 0 and ext-3 curves to its jnp
# MSM engine on every device: pippenger.resolve_config).


def _svdw_host(q, a, b, conic_c, proj_z, t):
    """The SvdW map on host ints (the JAX package's tests/test_groupmap.py
    _svdw_host, written out here): the first candidate x whose x^3 + a x + b
    is a square, and its non-negative root."""
    inv = lambda x: pow(x, -1, q)  # noqa: E731
    is_sq = lambda x: x == 0 or pow(x, (q - 1) // 2, q) == 1  # noqa: E731

    def sqrt_norm(x):
        if x == 0:
            return 0
        s_, t_ = 0, q - 1  # Tonelli-Shanks (MNT6753's q = 1 mod 4)
        while t_ % 2 == 0:
            s_, t_ = s_ + 1, t_ // 2
        z = 2
        while pow(z, (q - 1) // 2, q) != q - 1:
            z += 1
        c, r, w, m = pow(z, t_, q), pow(x, (t_ + 1) // 2, q), pow(x, t_, q), s_
        while w != 1:
            i, tmp = 0, w
            while tmp != 1:
                tmp = tmp * tmp % q
                i += 1
            bexp = pow(c, 1 << (m - i - 1), q)
            r, c = r * bexp % q, bexp * bexp % q
            w, m = w * c % q, i
        check(r * r % q == x % q, "host SvdW: no square root")
        return q - r if r > (q - 1) // 2 else r

    ct = conic_c * t % q
    s_ = 2 * (ct + proj_z) % q * inv((ct * t + 1) % q) % q
    y = (1 - s_ * t) % q
    v = ((proj_z - s_) * inv(y) - inv(2)) % q
    for x in (v, (-(1 + v)) % q, (1 + y * y) % q):
        rhs = (x * x % q * x + a * x + b) % q
        if is_sq(rhs):
            return x, sqrt_norm(rhs)
    fail("host SvdW: no candidate was square")


def _bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes / memory rate and
    operations / integer rate."""
    b, o = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_INT32_OPS_PER_S
    return max(b, o) * 1e3, "bytes" if b >= o else "operations"


def mnt6753_kernel_checks(dev, rng, field_res):
    """K5, K6 and the field inversion at NW = 24 on MNT6753's Fq and Fr, bit
    for bit against their plain versions: every ordered pair of the edge
    values 0, 1, q-1, (q+-1)/2, R mod q and words of all ones below the top
    word, 999 random pairs, one constant operand for the batch; the
    inversion as inverse_check (powers of two below R, x x^-1 = 1); then the
    kernels line's entries: K5 (its launch on packed words, the public call
    beside it) and K6 (the public call) at 2^20 elements, K5 at an MNT6753
    NTT stage's shape (Fr, 2^15 points: (48, 2^14)), the inversion at one
    element, each against its plain version, with bounds.  Its launches
    here are comparisons; the path's are counted by mnt6753_phase."""
    from zprize_wasm_msm_tpu_torch.models.curves import mnt6753
    from zprize_wasm_msm_tpu_torch.ops.field import kernels as field_kernels
    from zprize_wasm_msm_tpu_torch.ops.field import mont
    from zprize_wasm_msm_tpu_torch.ops.msm import _launch
    from zprize_wasm_msm_tpu_torch.ops.poly import fft as fft_mod
    from zprize_wasm_msm_tpu_torch.utils.limbs import ints_to_limbs

    out = {}
    for name, fq in (("Fq", mnt6753.fq), ("Fr", mnt6753.fr)):
        q, nw = fq.q, fq.n_words
        check(nw == 24, f"MNT6753 {name} is {nw} words")
        edges = [0, 1, q - 1, (q - 1) // 2, (q + 1) // 2, (1 << (32 * nw)) % q,
                 ((1 << (32 * (nw - 1))) - 1) % q]
        A = [x for x in edges for _ in edges] + [int.from_bytes(rng.bytes(96), "little") % q for _ in range(999)]
        B = [y for _ in edges for y in edges] + [int.from_bytes(rng.bytes(96), "little") % q for _ in range(999)]
        a = torch.as_tensor(ints_to_limbs(A, fq.n_limbs).astype(np.int64), device=dev)
        b = torch.as_tensor(ints_to_limbs(B, fq.n_limbs).astype(np.int64), device=dev)
        for what, got, want in (
            ("mont_mul", field_kernels.mont_mul(fq, a, b), field_kernels.mont_mul_plain(fq, a, b)),
            ("mont_mul by one constant", field_kernels.mont_mul(fq, a, b[:, 30:31]),
             field_kernels.mont_mul_plain(fq, a, b[:, 30:31])),
            ("mont_square", field_kernels.mont_square(fq, a), field_kernels.mont_square_plain(fq, a)),
        ):
            torch.cuda.synchronize()
            check(bool((got == want).all()), f"MNT6753 {name}: {what} kernel at NW = 24 != plain")
        out[name] = {"products_bit_equal": a.shape[1], "inverses_bit_equal": inverse_check(fq, dev, rng)}
    # the kernels line's entries, at NW = 24
    fq, fr = mnt6753.fq, mnt6753.fr
    NW, L = fq.n_words, fq.n_limbs
    mul_ops = 2 * (2 * NW * NW + NW)  # multiply-adds of a product, 2 operations each
    sqr_ops = 2 * (NW * (NW - 1) // 2 + NW + NW * NW + NW)
    n = 1 << 20
    X = torch.randint(0, 1 << 16, (L, n), device=dev)
    X[L - 1] = 0  # below 2^752 < q, r: canonical in both fields
    Y = X.roll(1, dims=1)
    words = _launch.pack_point((X, Y))  # (2, NW, n) int32
    entries = []
    # K5: the launch on packed words is timed and bound on the words it moves
    # (as K5's 12-word entry); the public call (packing limbs to words, the
    # launch, unpacking) beside it.  K6: the public call is its one launch on
    # the limbs, bound on the limb bytes; the words' bound beside it
    for kname, replaces, launch, wrapper, plain, n_in, ops in (
        ("mont_mul_nw24", "zprize_wasm_msm_tpu/ops/field/kernels.py:138",
         lambda: field_kernels._mul_words(fq, words[0], words[1]),
         lambda: field_kernels.mont_mul(fq, X, Y), lambda: field_kernels.mont_mul_plain(fq, X, Y), 2, mul_ops),
        ("mont_square_nw24", "zprize_wasm_msm_tpu/ops/field/kernels.py:160", None,
         lambda: field_kernels.mont_square(fq, X), lambda: field_kernels.mont_square_plain(fq, X), 1, sqr_ops),
    ):
        sync_ms(wrapper, 2)
        got, wrapper_ms = sync_ms(wrapper, 5)
        want, plain_ms = sync_ms(plain)
        err = int((got - want).abs().max().item())
        check(err == 0, f"{kname} at 2^20 disagrees with its plain version (max |err| {err})")
        del got, want
        words_b_ms, words_b_by = _bound((n_in + 1) * 4 * NW * n, n * ops)
        if launch:
            launch()
            _, ms = sync_ms(launch, 10)
            b_ms, b_by = words_b_ms, words_b_by
            extra = {"shape": f"({L},{n}) x{n_in} -> ({L},{n}); ms is the launch on ({NW},{n}) packed words, "
                              "10 calls, bound on the words; wrapper_ms is the public call (ctx.batch_mul), "
                              "packing limbs to words and back"}
        else:
            ms = wrapper_ms
            b_ms, b_by = _bound((n_in + 1) * L * 8 * n, n * ops)
            extra = {"words_form_bound_ms": words_b_ms, "words_form_bound_by": words_b_by,
                     "shape": f"({L},{n}) int64 limbs -> ({L},{n}); ms is the public call (ctx.batch_square), "
                              "one launch on the limbs, 5 calls; bound_ms on the limb bytes it moves, "
                              f"words_form_bound_ms on ({NW},{n}) packed words in and out"}
        entries.append({
            "name": kname, "route": "cuda", "source": "zprize_wasm_msm_tpu_torch/csrc/field_kernels.cu",
            "replaces": replaces, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "wrapper_ms": wrapper_ms,
            "no_library_because": "no PyTorch call multiplies multi-word integers modulo q", **extra,
            **field_res[(kname.replace("_nw24", "_kernel"), NW)],
        })
    del words
    # K5 at an NTT stage's shape: Fr, 2^15 points (Fr's 2-adicity), a stage's
    # 2^14 products by the twiddles; the launch on words, the public call beside it
    half = 1 << 14
    a = X[:, :half].contiguous()
    tw = fft_mod._twiddles_on(fr.q, fr.n_limbs, 2 * half, False, dev)
    field_kernels.mont_mul(fr, a, tw)
    got, wrapper_ms = sync_ms(lambda: field_kernels.mont_mul(fr, a, tw), 5)
    want, plain_ms = sync_ms(lambda: field_kernels.mont_mul_plain(fr, a, tw))
    check(torch.equal(got, want), "K5 at an MNT6753 NTT stage's shape differs from its plain version")
    aw, tww = _launch.pack_point((a, tw))
    field_kernels._mul_words(fr, aw, tww)
    _, ms = sync_ms(lambda: field_kernels._mul_words(fr, aw, tww), 10)
    b_ms, b_by = _bound(3 * 4 * NW * half, half * mul_ops)
    entries[0]["ntt_stage_call"] = {"shape": f"({L},{half}) x ({L},{half}) twiddles, MNT6753 Fr; ms the launch "
                                             f"on ({NW},{half}) words, bound on the words", "ms": ms,
                                    "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "max_abs_err": 0,
                                    "bound_ms": b_ms, "bound_by": b_by}
    del X, Y, got, want
    # the inversion at one element
    z = torch.as_tensor(ints_to_limbs([fq.to_mont_int(int.from_bytes(rng.bytes(96), "little") % fq.q)],
                                      L).astype(np.int64), device=dev)
    field_kernels.inverse(fq, z)
    got, ms = sync_ms(lambda: field_kernels.inverse(fq, z), 3)
    want, plain_ms = sync_ms(lambda: field_kernels.inverse_plain(fq, z))
    err = int((got - want).abs().max().item())
    check(err == 0, "the field inversion at NW = 24 disagrees with its plain version")
    check(bool((mont.mont_mul(fq, got, z) == mont.one_mont(fq, (1,), dev)).all()), "inverse(x) x != 1 at NW = 24")
    b_ms, b_by = _bound(2 * L * 8, 2 * fq.bits * 4 * NW)
    entries.append({
        "name": "field_inverse_nw24", "route": "cuda", "source": "zprize_wasm_msm_tpu_torch/csrc/field_kernels.cu",
        "replaces": "zprize_wasm_msm_tpu/ops/field/mont.py:426", "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "gcd_steps": field_kernels.inverse_consts(fq)[0],
        "shape": f"({L}, 1) -> ({L}, 1); ms is the field_kernels.inverse wrapper at one element",
        **field_res[("field_inverse_kernel", NW)],
    })
    return out, entries


def mnt6_pairing_ops(ps, cols, device, P, Q):
    """Device operations of the MNT6 miller_loop and final_exponentiation
    on ``cols`` columns, from counted runs at short loop counts: every
    Miller step launches the same operations whatever its bit (the add step
    is computed and selected), and the final exponentiation is a fixed part
    plus the NAF chain by w0 (a cyclotomic square a digit, an Fq6 product a
    nonzero digit); as pairing_ops for BLS12 and BN."""
    import dataclasses

    from zprize_wasm_msm_tpu_torch.ops.pairing import mnt6

    def count(fn):  # the constants are cached by the full pairing before
        return device_ops(fn)[1]

    short = lambda e: dataclasses.replace(ps, loop_count=e)  # noqa: E731
    e_a, e_b = 8, 16  # 3 and 4 Miller steps
    Pc, Qc = (tuple(x[:, :1].expand(-1, cols).contiguous() for x in pt) for pt in (P, Q))
    ml_a = count(lambda: mnt6.miller_loop(short(e_a), Pc, Qc))
    ml_b = count(lambda: mnt6.miller_loop(short(e_b), Pc, Qc))
    steps = lambda e: e.bit_length() - 1  # noqa: E731
    step = (ml_b - ml_a) // (steps(e_b) - steps(e_a))
    f = mnt6.f6_one(ps, (cols,), device)
    fe_a = count(lambda: mnt6.final_exponentiation(short(e_a), f))
    sq = count(lambda: mnt6.f6_cyclotomic_square(ps, f))
    mul = count(lambda: mnt6.f6_mul(ps, f, f))

    def chain(e):
        digits = mnt6._naf_digits_msb(e)
        return (len(digits) - 1) * sq + sum(1 for d in digits[1:] if d) * mul

    return {"miller_step": step, "miller_loop": ml_a + (steps(ps.loop_count) - steps(e_a)) * step,
            "final_exponentiation": fe_a + chain(ps.loop_count) - chain(e_a),
            "cyclotomic_square": sq, "f6_mul": mul}


def mnt6753_phase(dev, rng, reset_counts, read_counts, log2n_g1=12, log2n_g2=10, log2n_legacy=8,
                  log2n_map=10, log2n_fft=15):
    """Every MNT6753 entry point of CurveContext on the card, the kernel
    counts zeroed just before and read just after each call of the entry
    points and summed (``entry``: the comparisons, oracle readbacks and
    extra calls that check them are not counted):
      batch: ctx.batch_mul / batch_square / batch_to_mont / batch_from_mont /
             batch_inverse on 2^12 Fq elements against the plain field ops;
      group: add, double, mixed add, in_curve on 256 points of G1 and of G2
             (over Fq3) against the oracle;
      msm:   ctx.msm with its defaults (auto: the plain engine, the 2 GiB
             budget) at 2^log2n_g1 G1 bases and 2^log2n_g2 G2 bases,
             full-width scalars, against the oracle;
             msm_legacy at 2^log2n_legacy on both (64-bit scalars) against
             the oracle;
      group_map on 2^log2n_map field elements: every output on the curve,
             four equal to the host SvdW;
      fft / ifft at 2^log2n_fft on MNT6753 Fr: the round trip and equality
             with impl="plain";
      pairing: miller_loop on (aP, bQ), (P, Q), (abP, Q), (O, Q), one
             final_exponentiation: e(aP, bQ) = e(abP, Q) = e(P, Q)^(ab),
             e(P, Q) != 1, e(O, Q) = 1; device operations (mnt6_pairing_ops);
      groth16.verify on the (mnt6753, mnt6753_g2) pair: a valid proof True.
    Fails unless the path launched K5, K6 and the inversion."""
    import importlib.util

    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.models import groth16
    from zprize_wasm_msm_tpu_torch.models.curves import mnt6753, mnt6753_g2
    from zprize_wasm_msm_tpu_torch.ops.curve import group, groupmap
    from zprize_wasm_msm_tpu_torch.ops.field import mont
    from zprize_wasm_msm_tpu_torch.ops.msm import pippenger, windows
    from zprize_wasm_msm_tpu_torch.ops.pairing import mnt6
    from zprize_wasm_msm_tpu_torch.oracle import ntt
    from zprize_wasm_msm_tpu_torch.ops.poly import fft as fft_mod

    c1, c2 = Z.build_curve(mnt6753), Z.build_curve(mnt6753_g2)
    oc1, oc2 = oracle_of(mnt6753), oracle_of(mnt6753_g2)
    fq, fr, r = mnt6753.fq, mnt6753.fr, mnt6753.r
    out, secs = {}, {}

    def part(name, fn):
        t = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        secs[name] = round(time.perf_counter() - t, 2)

    path_counts = {}
    phase_peak = [0]  # the card's peak bytes before the MSMs' own peaks are taken

    def entry(fn):
        """fn's result, its kernel launches added to the path's: the counts
        are zeroed just before a call of the entry points and read just
        after, so the comparisons and readbacks around it count nothing."""
        reset_counts()
        res = fn()
        torch.cuda.synchronize()
        for k, v in read_counts().items():
            path_counts[k] = path_counts.get(k, 0) + v
        return res

    t_path = time.perf_counter()

    def batch():
        n = 1 << 12
        a = _fr_limbs(fq, n, rng, dev)
        b = a.roll(3, dims=1)
        for what, got, want in (
            ("batch_mul", entry(lambda: c1.batch_mul(a, b)), mont.mont_mul(fq, a, b)),
            ("batch_square", entry(lambda: c1.batch_square(a)), mont.mont_square(fq, a)),
            ("batch_to_mont", entry(lambda: c1.batch_to_mont(a)), mont.to_mont(fq, a)),
            ("batch_from_mont", entry(lambda: c1.batch_from_mont(a)), mont.from_mont(fq, a)),
        ):
            check(torch.equal(got, want), f"mnt6753 {what} differs from the plain field op")
        inv = entry(lambda: c1.batch_inverse(a))
        one = (mont.mont_mul(fq, a, inv) == mont.one_mont(fq, (n,), dev)).all(0) | (a == 0).all(0)
        check(bool(one.all()), "mnt6753 batch_inverse: x x^-1 != 1")
        return {"n": n, "equal_to_plain": True}

    def group_law():
        rep = {}
        for ctx, oc in ((c1, oc1), (c2, oc2)):
            curve = ctx.spec
            (X, Y), _, _ = _make_bases(ctx, 8, rng, dev)
            n = X.shape[1]
            P = group.from_affine(curve, (X, Y))
            QA = (X.roll(1, dims=1).contiguous(), Y.roll(1, dims=1).contiguous())
            QA[0][:, :4], QA[1][:, :4] = X[:, :4], Y[:, :4]  # P = Q
            QA[1][:, 4:8] = curve.field.neg(Y[:, 4:8])  # P = -Q
            QA[0][:, 4:8] = X[:, 4:8]
            sums = entry(lambda: {"add": group.add(curve, P, group.from_affine(curve, QA)),
                                  "add_mixed": group.add_mixed(curve, P, QA), "double": group.double(curve, P)})
            check(bool(entry(lambda: group.in_curve(curve, P)).all()), f"{curve.name}: in_curve false on curve points")
            for v in sums.values():
                check(bool(group.in_curve(curve, v).all()), f"{curve.name}: a sum is off the curve")
            # the oracle's sums of the same affine points, read back (one
            # host addition a point: a 753-bit scalar multiple a point would
            # take minutes over Fq3)
            zero = (0,) * curve.ext if curve.ext > 1 else 0

            def host(pt):
                xs, ys = (curve.field.to_host(c) for c in group.to_affine(curve, pt))
                return [None if p == (zero, zero) else p for p in zip(xs, ys)]

            ph, qh = host(P), host(group.from_affine(curve, QA))
            check(all(oc.is_on_curve(p) for p in ph), f"{curve.name}: a base is off the curve")
            want = {"add": [oc.add(p, q) for p, q in zip(ph, qh)], "double": [oc.double(p) for p in ph]}
            want["add_mixed"] = want["add"]
            for name in ("add", "add_mixed", "double"):
                check(host(sums[name]) == want[name], f"{curve.name}: {name} differs from the oracle")
            off = (X[:, :8], Y.roll(1, dims=1)[:, :8])
            check(not bool(group.in_curve(curve, group.from_affine(curve, off)).any()),
                  f"{curve.name}: in_curve true off the curve")
            rep[curve.name] = {"points": n, "ops": "add/add_mixed/double/in_curve", "equal_to_oracle": True}
        return rep

    def msm():
        rep = {}
        for ctx, log2n in ((c1, log2n_g1), (c2, log2n_g2)):
            curve = ctx.spec
            (X, Y), m0, ds = _make_bases(ctx, log2n, rng, dev)
            N = 1 << log2n
            mix = int.from_bytes(rng.bytes(96), "little")
            ks = rng.integers(0, 1 << 62, size=(N,), dtype=np.uint64)
            kints = [(int(k) * mix + int(k)) % r for k in ks]
            mults = np.full(N, m0, dtype=object)
            idx = np.arange(N)
            for k, d in enumerate(ds):
                mults = mults + ((idx >> k) & 1).astype(object) * d
            terms = np.array(kints, dtype=object) * (mults % r)
            oc = oracle_of(curve)
            k = ctx.scalars_to_device(kints)
            budget = 2 << 30  # ctx.msm's default
            impl, c, lanes = pippenger.resolve_config(curve, N, 16 * fr.n_limbs, None, None, budget, "auto",
                                                      device=dev)
            check(impl == "plain", f"{curve.name}: auto picked {impl}")
            phase_peak[0] = max(phase_peak[0], torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t = time.perf_counter()
            got = entry(lambda: ctx.result_to_affine(ctx.msm((X, Y), k)))  # the defaults a user gets
            s = time.perf_counter() - t
            peak_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
            check(got == oc.mul(oc.g, int(terms.sum() % r)), f"{curve.name}: msm at 2^{log2n} != oracle")
            W = windows.num_windows(16 * fr.n_limbs, c)
            B = 1 << (c - 1)
            # the lane tree's adds in parts of the bucket axis (pippenger._add_in_parts)
            fit = budget // (pippenger.ADD_TEMP_POINTS * 3 * curve.field.elem_len * 8)
            tree_adds = sum(-(-B // max(1, fit // (W * (lanes >> j)))) for j in range(1, int(lanes).bit_length()))
            rep[curve.name] = {"n": N, "s": s, "engine": impl, "mem_budget_bytes": budget, "c": c, "windows": W,
                               "buckets": B, "lanes": lanes, "peak_gib_above_inputs": peak_gib,
                               "sweep_steps": N // lanes, "lane_tree_levels": int(lanes).bit_length() - 1,
                               "lane_tree_adds": tree_adds,
                               "bucket_reduce_adds": 2 * B, "window_fold": {"doublings": (W - 1) * c, "adds": W - 1},
                               "verified_against_oracle": True}
            # msm_legacy at 2^log2n_legacy, 64-bit scalars, against the oracle
            n2 = 1 << log2n_legacy
            k64 = [int(v) for v in ks[:n2]]
            k2 = ctx.scalars_to_device(k64)
            P2 = (X[:, :n2].contiguous(), Y[:, :n2].contiguous())
            t = time.perf_counter()
            leg = entry(lambda: ctx.result_to_affine(ctx.msm_legacy(P2, k2, max_bits=64)))
            s_leg = time.perf_counter() - t
            w2 = oc.mul(oc.g, int((np.array(k64, dtype=object) * (mults[:n2] % r)).sum() % r))
            check(leg == w2, f"{curve.name}: msm_legacy and the oracle disagree at 2^{log2n_legacy}")
            rep[curve.name]["msm_legacy"] = {"n": n2, "scalar_bits": 64, "s": s_leg, "agrees": True}
        return rep

    def group_map():
        n = 1 << log2n_map
        ts = [1, 2, fq.q - 3] + [int.from_bytes(rng.bytes(96), "little") % fq.q for _ in range(n - 3)]
        T = c1._limbs([fq.to_mont_int(t) for t in ts], fq.n_limbs)
        t = time.perf_counter()
        G = entry(lambda: c1.group_map(T))
        s = time.perf_counter() - t
        check(bool(c1.in_curve(G).all()), "group_map: an output is off the curve")
        svdw = groupmap._SVDW[fq.q]
        F = c1.spec.field
        for t_, x, y in zip(ts[:4], F.to_host(G[0][:, :4]), F.to_host(G[1][:, :4])):
            check((x, y) == _svdw_host(fq.q, mnt6753.a, mnt6753.b, svdw.conic_c, svdw.proj_z, t_),
                  f"group_map({t_}) != the host SvdW")
        return {"n": n, "s": s, "on_curve": True, "equal_to_host_svdw": 4}

    def ntt_():
        n = 1 << log2n_fft
        x = _fr_limbs(fr, n, rng, dev)
        y, s_fft = entry(lambda: host_timed(lambda: c1.fft(x)))
        back, s_ifft = entry(lambda: host_timed(lambda: c1.ifft(y)))
        check(torch.equal(back, x), f"mnt6753 ifft(fft(x)) != x at 2^{log2n_fft}")
        check(torch.equal(y, c1.fft(x, impl="plain")), "mnt6753 fft differs from impl='plain'")
        m = 1 << 6
        xs = x[:, :m].contiguous()
        want = ntt(_fr_ints(fr, xs), fr.q, fft_mod._root_of_unity(fr.q, m))
        check(_fr_ints(fr, c1.fft(xs)) == want, "mnt6753 fft at 2^6 differs from oracle.ntt")
        return {"n": n, "fft_s": s_fft, "ifft_s": s_ifft, "round_trip_exact": True, "equals_plain": True,
                "oracle_2^6": True}

    def pairing():
        ps = c1._pairing[1]
        P, Q = oc1.g, oc2.g
        a, b = (int(v) for v in rng.integers(2, 1 << 31, size=2))
        P4 = c1.points_to_device([oc1.mul(P, a), P, oc1.mul(P, a * b % r), None])
        Q4 = c2.points_to_device([oc2.mul(Q, b), Q, Q, Q])
        f, ml_s = entry(lambda: host_timed(lambda: c1.miller_loop(P4, Q4)))
        e, fe_s = entry(lambda: host_timed(lambda: c1.final_exponentiation(f)))
        one = mnt6.f6_one(ps, (1,), dev)[:, 0]
        check(torch.equal(e[:, 0], e[:, 2]), "mnt6753: e(aP, bQ) != e(abP, Q)")
        check(torch.equal(e[:, 0], mnt6.f6_cyclotomic_exp(ps, e[:, 1:2], a * b)[:, 0]),
              "mnt6753: e(aP, bQ) != e(P, Q)^(ab)")
        check(not torch.equal(e[:, 1], one), "mnt6753: e(P, Q) = 1 (degenerate)")
        check(torch.equal(e[:, 3], one), "mnt6753: e(O, Q) != 1")
        ops = mnt6_pairing_ops(ps, 4, dev, P4, Q4)
        return {"pairs": 4, "miller_loop_s": ml_s, "final_exponentiation_s": fe_s, "s": ml_s + fe_s,
                "device_ops": ops["miller_loop"] + ops["final_exponentiation"], "device_ops_by_part": ops,
                "bilinear": True, "non_degenerate": True, "e_O_Q_is_1": True}

    def verify():
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "_torch_groth16.py")
        spec = importlib.util.spec_from_file_location("_torch_groth16", path)
        helper = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(helper)
        vk, proof, publics, _, _ = helper.make_instance(rng, 2, mnt6753, mnt6753_g2)
        ok, s = entry(lambda: host_timed(lambda: groth16.verify(c1, c2, vk, proof, publics)))
        check(ok is True, "groth16 on mnt6753: a valid proof is rejected")
        return {"verify_s": s, "n_publics": 2, "valid": True}

    for name, fn in (("batch", batch), ("group", group_law), ("msm", msm), ("group_map", group_map),
                     ("ntt", ntt_), ("pairing", pairing), ("groth16", verify)):
        part(name, fn)
    out["path_seconds"] = round(time.perf_counter() - t_path, 2)
    out["seconds_by_part"] = secs
    out["path_kernel_launches"] = {k: v for k, v in path_counts.items() if v}
    out["peak_bytes_before_resets"] = phase_peak[0]
    for k in ("mont_mul", "mont_square", "field_inverse"):
        check(path_counts.get(k, 0) > 0, f"the mnt6753 path never launched {k} at NW = 24")
    return out


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
    from zprize_wasm_msm_tpu_torch.models.curves import (
        bls12_377, bls12_381, bls12_381_g2, bn254, bn254_g2, toy, toy_bn_g2, toy_g2,
    )
    from zprize_wasm_msm_tpu_torch.ops.curve import device_check, group
    from zprize_wasm_msm_tpu_torch.ops.field import kernels as field_kernels
    from zprize_wasm_msm_tpu_torch.ops.field import mont
    from zprize_wasm_msm_tpu_torch.ops.msm import (
        _launch, glv, pippenger, pl_bucket, pl_reduce, pl_sorted, windows,
    )
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
        # the out-of-line Fq2 functions: the step loop every one-lane Fq2
        # group op calls (csrc/group2.cuh pt2_run), the collapse's links
        # (csrc/reduce.cu pt2_link_add, pt2_link_double) and the fold's
        # (csrc/fold2.cuh fold2_link_double, fold2_link_add): their own stack
        # and spills
        for i, line in enumerate(lines):
            if "Function properties for" in line and any(f in line for f in ("pt2_run", "pt2_link", "fold2_")):
                name = line.split("for ")[-1].strip()
                spill = lines[i + 1].strip()
                spills = [int(w) for w in spill.split() if w.isdigit()]
                check(len(spills) == 3 and spills[1] == 0 and spills[2] == 0,
                      f"{name} spills: {spill}")
                ptxas.append(f"{stem}:{name[:48]}: | {spill}")
    emit({
        "env": {
            "torch": torch.__version__, "cuda": torch.version.cuda, "nvcc": nvcc_version,
            "python": sys.version.split()[0],
        },
        "build_seconds": round(build_s, 2),
        "build_seconds_by_library": {k: round(v, 2) for k, v in _build.BUILD_SECONDS.items()},
        "built": sorted(logs),
        "ptxas": ptxas,
    })

    def kernel_resources(stem, kernel, entry, targs, threads, *args):
        """ptxas's registers, stack frame and spills of kernel<targs> and
        what the runtime says of it (registers, local bytes, blocks per SM;
        entry None: ptxas only); fails on a spill."""
        # as mangled: combine_kernel is not lane_combine_kernel, <12> not <12, 2>
        tag = f"{len(kernel)}{kernel}I" + "".join(f"Li{a}E" for a in targs) + "E"
        found = [v for k, v in ptxas_by_kernel.items() if tag in k]
        check(len(found) == 1, f"no ptxas report for {tag}")
        spill = [int(w) for w in found[0]["spill"].split() if w.isdigit()]
        check(len(spill) == 3 and spill[1] == 0 and spill[2] == 0,
              f"{tag} spills: {found[0]['spill']}")
        info = _build.kernel_info(stem, entry, targs[0], *args) if entry else {}
        return {"ptxas": found[0], "stack_frame_bytes": spill[0], "spill_store_bytes": spill[1],
                "spill_load_bytes": spill[2], **info, "threads_per_block": threads,
                **({"resident_warps_per_sm": info["blocks_per_sm"] * threads // 32,
                    "shared_bytes_per_thread": info["shared_bytes"] / threads} if info else {})}

    sweep_res = {
        (name, nw): kernel_resources(stem, kernel, entry, targs, threads, *args)
        for nw in _build.SUPPORTED_WORDS
        for name, stem, kernel, entry, targs, threads, args in (
            ("bucket_sweep", "bucket", "bucket_sweep_kernel", "zp_bucket_sweep_info", (nw,), 64, (1,)),
            ("sorted_sweep", "sorted", "sorted_sweep_kernel", "zp_sorted_sweep_info", (nw,), 64, (1,)),
            ("segscan", "sorted", "segscan_tile_kernel", "zp_segscan_info", (nw, 1), 32, (1, 0)),
            ("segscan (fix-up)", "sorted", "segscan_fix_kernel", "zp_segscan_info", (nw, 1), 32, (1, 1)),
        )
    }
    emit({"sweep_resources": {f"{k[0]} NW={k[1]}": v for k, v in sweep_res.items()}})
    reduce_res = {
        (name, nw): kernel_resources(stem, kernel, entry, targs, threads, *args)
        for nw in _build.SUPPORTED_WORDS
        for name, stem, kernel, entry, targs, threads, args in (
            ("finish (fold)", "reduce", "finish_kernel", "zp_finish_info", (nw,), 32, (1,)),
            ("collapse", "reduce", "collapse_kernel", "zp_collapse_info", (nw,), 128, (1, 0)),
            ("collapse (combine)", "reduce", "combine_kernel", "zp_collapse_info", (nw,), 128, (1, 1)),
            ("lane_reduce", "bucket", "lane_reduce_kernel", "zp_lane_reduce_info", (nw, 1, 2), 128, (1, 0)),
            ("lane_reduce (combine)", "bucket", "lane_combine_kernel", "zp_lane_reduce_info", (nw, 1),
             128, (1, 1)),
        )
    }
    emit({"reduce_resources": {f"{k[0]} NW={k[1]}": v for k, v in reduce_res.items()}})
    # the Fq2 (G2) forms of K1, K4, K2 and K3, under the same spill gate
    fq2_res = {
        (name, nw): kernel_resources(stem, kernel, entry, targs, threads, *args)
        for nw in _build.SUPPORTED_WORDS
        for name, stem, kernel, entry, targs, threads, args in (
            ("bucket_sweep", "bucket", "bucket_sweep2_kernel", "zp_bucket_sweep_info", (nw,), 32, (2,)),
            ("lane_reduce", "bucket", "lane_reduce_kernel", "zp_lane_reduce_info", (nw, 2, 1), 32, (2, 0)),
            ("lane_reduce (combine)", "bucket", "lane_combine_kernel", "zp_lane_reduce_info", (nw, 2),
             32, (2, 1)),
            ("collapse", "reduce", "collapse2_kernel", "zp_collapse_info", (nw,), 128, (2, 0)),
            ("collapse (combine)", "reduce", "combine2_kernel", "zp_collapse_info", (nw,), 128, (2, 1)),
            ("finish (fold)", "reduce", "finish2_kernel", "zp_finish_info", (nw,),
             pl_reduce.FOLD2_THREADS, (2,)),
            ("sorted_sweep", "sorted", "sorted_sweep2_kernel", "zp_sorted_sweep_info", (nw,), 32, (2,)),
            ("segscan", "sorted", "segscan_tile_kernel", "zp_segscan_info", (nw, 2), 32, (2, 0)),
            ("segscan (fix-up)", "sorted", "segscan_fix_kernel", "zp_segscan_info", (nw, 2), 32, (2, 1)),
        )
    }
    emit({"fq2_resources": {f"{k[0]} NW={k[1]}": v for k, v in fq2_res.items()}})
    # the Fq2 fold keeps its two points and its exchange in shared memory and
    # its state in registers: no stack either
    for nw in _build.SUPPORTED_WORDS:
        r = fq2_res[("finish (fold)", nw)]
        check(r["stack_frame_bytes"] == 0 and r["local_bytes"] == 0,
              f"finish2_kernel NW={nw} keeps {r['stack_frame_bytes']} stack bytes")
    # the budgets of the Fq2 reductions redesigned for 8 warps a SM: 864
    # shared bytes a thread at NW = 12 (a point, one more slot, the add's
    # three scratch elements) and 8 one-warp blocks resident
    for name in ("lane_reduce", "segscan", "segscan (fix-up)"):
        r = fq2_res[(name, 12)]
        check(r["shared_bytes_per_thread"] <= 864 and r["resident_warps_per_sm"] >= 8,
              f"{name} over Fq2 keeps {r['shared_bytes_per_thread']} shared bytes a thread and "
              f"{r['resident_warps_per_sm']} warps a SM; its budget is 864 and 8")
    # every width field_kernels.cu instantiates, MNT6753's 24 words among them
    field_res = {
        (kernel, nw): kernel_resources("field_kernels", kernel, "zp_field_info", (nw,), threads, which)
        for which, (kernel, threads) in enumerate(
            (("mont_mul_kernel", 128), ("mont_square_kernel", 128), ("field_inverse_kernel", 64)))
        for nw in _build.FIELD_KERNEL_WORDS
    }
    emit({"field_resources": {f"{k[0]} NW={k[1]}": v for k, v in field_res.items()}})

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
            ("square", mont.mont_square(fq, a)),
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
            "mul/mul_cc/mul_b3/mul_coop/add/sub/neg/square (fe_sqr) + mont_mul/mont_square kernels"
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

    # the Fq2 device functions (G2) on the three Fq2 widths, bit for bit; the
    # G2 phases draw from a generator of their own (the G1 paths keep their data)
    t0 = time.perf_counter()
    g2_rng = np.random.default_rng(SEED + 4)
    fq2_report = {c.name: fq2_device_check(c, dev, g2_rng) for c in (toy_g2, bn254_g2, bls12_381_g2)}
    emit({"device_functions_fq2": {
        "elements_bit_equal": fq2_report, "tolerance": 0,
        "ops": "mul/mul_cc/mul_coop/add/sub/neg/mul_b3/square (mul_b3k where 3b = k (1 + u)) + "
               "add_mixed, add_cc (K1's and K4's group ops), add_coop/double_coop (K2's), "
               "add/double_fold2_warps and _lane (K3's fold links, both forms); the level-parallel "
               "ops also with b3k = 0 where 3b = k (1 + u)",
        "seconds": round(time.perf_counter() - t0, 2)}})

    # ---- 4. kernels against their plain versions, small shapes ---------------
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
        "toy c=7 W=4 B=64": kernel_checks(toy, dev, rng, 12, 7, 16, 64, "toy c=7"),
        "toy c=4 W=5 B=8": kernel_checks(toy, dev, rng, 10, 4, 16, 16, "toy c=4"),
        "bn254 c=5 W=52 B=16": kernel_checks(bn254, dev, rng, 10, 5, 254, 32, "bn254 c=5"),
        "bls12_381 c=7 W=38 B=64": kernel_checks(bls12_381, dev, rng, 12, 7, 255, 64, "bls12_381 c=7"),
        "bls12_381 c=6 W=23 B=32": kernel_checks(bls12_381, dev, rng, 10, 6, 132, 32, "bls12_381 c=6"),
        "sorted toy c=4 T=16": sorted_checks(toy, dev, rng, 9, 4, 16, "sorted toy c=4"),
        "sorted toy c=10 T=64": sorted_checks(toy, dev, rng, 11, 10, 64, "sorted toy c=10"),
        "sorted bn254 c=8 T=32": sorted_checks(bn254, dev, rng, 9, 8, 32, "sorted bn254 c=8"),
        "sorted bls12_381 c=10 T=64": sorted_checks(bls12_381, dev, rng, 10, 10, 64, "sorted bls12_381 c=10"),
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
    # and fold, K4's even split, warp scan and combine across warps, K2's
    # runs and tree, K8's tiles, levels and fix-ups.  Their
    # inputs come from a generator of their own, so the paths below get the
    # same bases and scalars as before these cases existed (K8's time, for
    # one, follows the longest segment that data makes)
    t0 = time.perf_counter()
    adversarial = {}
    red_rng = np.random.default_rng(SEED + 1)
    # toy and BLS12-381 (the 2- and 12-word fields; BN254's 8 words keep
    # their small-shape and path checks): the script's time limit
    for c_curve in (toy, bls12_381):
        for case, e in k3_adversarial(c_curve, dev, red_rng).items():
            adversarial[f"K3 {c_curve.name}: {case}"] = e
        for case, e in k4_adversarial(c_curve, dev, red_rng).items():
            adversarial[f"K4 {c_curve.name}: {case}"] = e
    k2_rng = np.random.default_rng(SEED + 2)
    for c_curve in (toy, bls12_381):
        for case, e in k2_adversarial(c_curve, dev, k2_rng).items():
            adversarial[f"K2 {c_curve.name}: {case}"] = e
    k8_rng = np.random.default_rng(SEED + 9)
    for c_curve in (toy, bls12_381):
        for case, e in k8_adversarial(c_curve, dev, k8_rng).items():
            adversarial[f"K8 {c_curve.name} {case}"] = e
    torch.cuda.synchronize()
    for case, e in adversarial.items():
        check(e == 0, f"{case}: kernel disagrees with its plain version (max |err| {e})")
    emit({"reductions_adversarial_max_abs_err": adversarial, "tolerance": 0,
          "seconds": round(time.perf_counter() - t0, 2)})

    # K1, K4, K2 and K3 over Fq2 against their plain versions: small shapes on
    # the four G2 curves (BN254 G2's and both toy curves' 3b are full Fq2
    # elements; bls12_381_g2 at path G2's c = 6, W = 44, B = 32), then the
    # adversarial cases of K1, K4, K3 and K2 on toy_g2 and of the sweep and the
    # lane reduction on bls12_381_g2
    t0 = time.perf_counter()
    small_g2 = {
        "toy_g2 c=4 W=5 B=8": kernel_checks(toy_g2, dev, g2_rng, 10, 4, 16, 16, "toy_g2 c=4"),
        "toy_bn_g2 c=6 W=4 B=32": kernel_checks(toy_bn_g2, dev, g2_rng, 10, 6, 16, 16, "toy_bn_g2 c=6"),
        "bn254_g2 c=5 W=17 B=16": kernel_checks(bn254_g2, dev, g2_rng, 10, 5, 80, 32, "bn254_g2 c=5"),
        "bls12_381_g2 c=6 W=44 B=32": kernel_checks(bls12_381_g2, dev, g2_rng, 10, 6, 256, 64,
                                                    "bls12_381_g2 c=6"),
    }
    adversarial = {}
    for c_curve, cases in ((toy_g2, (k1_adversarial, k4_adversarial, k3_adversarial, k2_adversarial)),
                           (bls12_381_g2, (k1_adversarial, k4_adversarial))):
        for fn in cases:
            for case, e in fn(c_curve, dev, g2_rng).items():
                adversarial[f"{fn.__name__[:2].upper()} {c_curve.name}: {case}"] = e
    torch.cuda.synchronize()
    for case, e in adversarial.items():
        check(e == 0, f"{case}: kernel disagrees with its plain version (max |err| {e})")
    emit({"fq2_kernels_small_shapes_max_abs_err": small_g2,
          "fq2_adversarial_max_abs_err": adversarial, "tolerance": 0,
          "seconds": round(time.perf_counter() - t0, 2)})

    # K7 and K8 over Fq2 (the sorted engine on G2) against their plain
    # versions on given sorted streams: small shapes on the four G2 curves
    # (zero digits, digits at +-B, (0,0) points, a point twice in one run,
    # runs spanning chunks, an all-zero window), then k7_adversarial's
    # streams (runs crossing every lane, zero and negative digits) and
    # k8_adversarial's seg layouts (K8's tiles, levels and fix-ups) on
    # toy_g2 and bls12_381_g2.  A generator of its own: path G2 keeps its data
    t0 = time.perf_counter()
    g2s_rng = np.random.default_rng(SEED + 6)
    small_g2s = {
        "sorted toy_g2 c=4 T=16": sorted_checks(toy_g2, dev, g2s_rng, 9, 4, 16, "sorted toy_g2 c=4"),
        "sorted toy_bn_g2 c=5 T=16": sorted_checks(toy_bn_g2, dev, g2s_rng, 9, 5, 16, "sorted toy_bn_g2 c=5"),
        "sorted bn254_g2 c=8 T=32": sorted_checks(bn254_g2, dev, g2s_rng, 9, 8, 32, "sorted bn254_g2 c=8"),
        "sorted bls12_381_g2 c=10 T=64": sorted_checks(bls12_381_g2, dev, g2s_rng, 10, 10, 64,
                                                       "sorted bls12_381_g2 c=10"),
    }
    adversarial = {}
    for c_curve, shapes in ((toy_g2, ((16, 37), (4, 5), (8, 71), (4, 100), (2, 64))),
                            (bls12_381_g2, ((16, 37),))):
        for chunks, steps in shapes:
            for case, e in k7_adversarial(c_curve, dev, g2s_rng, chunks, steps).items():
                adversarial[f"K7 {c_curve.name} T={chunks} steps={steps}: {case}"] = e
        for case, e in k8_adversarial(c_curve, dev, g2s_rng).items():
            adversarial[f"K8 {c_curve.name} {case}"] = e
    torch.cuda.synchronize()
    for case, e in adversarial.items():
        check(e == 0, f"{case}: kernel disagrees with its plain version (max |err| {e})")
    emit({"fq2_sorted_small_shapes_max_abs_err": small_g2s,
          "fq2_sorted_adversarial_max_abs_err": adversarial, "tolerance": 0,
          "seconds": round(time.perf_counter() - t0, 2)})

    # BLS12-377 G1 (a 377-bit q, NW = 12 with a free top bit, 3b = 3, GLV):
    # the kernels at small shapes, then ctx.msm at 2^16 against the oracle,
    # the default (GLV split, K5) and use_glv=False
    t0 = time.perf_counter()
    rng_377 = np.random.default_rng(SEED + 5)
    bls377 = {
        "small shapes": {
            "c=7 W=38 B=64": kernel_checks(bls12_377, dev, rng_377, 11, 7, 253, 64, "bls12_377 c=7"),
            "c=6 W=23 B=32": kernel_checks(bls12_377, dev, rng_377, 10, 6, 132, 32, "bls12_377 c=6"),
        },
        "msm_2^16": msm_oracle_check(bls12_377, dev, rng_377, 16, {
            "default (GLV)": {}, "use_glv=False": {"use_glv": False}}),
    }
    emit({"bls12_377": bls377, "tolerance": 0, "seconds": round(time.perf_counter() - t0, 2)})

    # every engine on one input (tools/engine_diff.py's check), then the
    # wire formats and the G2 prover's decompress-then-msm; generators of
    # their own
    t0 = time.perf_counter()
    engines = engine_agreement(dev, np.random.default_rng(SEED + 7), 16, 14)
    emit({"engine_agreement": engines, "seconds": round(time.perf_counter() - t0, 2)})
    t0 = time.perf_counter()
    serde_report = serde_phase(dev, np.random.default_rng(SEED + 8), 16)
    emit({"serde": serde_report, "seconds": round(time.perf_counter() - t0, 2)})

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

    def drive(name, run, required, ctx=ctx, expected=expected, n=n):
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
        EL = ctx.spec.field.elem_len
        check(all(bool(torch.isfinite(r.double()).all()) and r.shape == (EL,) for r in res),
              f"path {name}: MSM result has the wrong shape")
        check(got == expected, f"path {name}: MSM result does not match the oracle (sum k_i m_i mod r) G")
        times, to_affine_runs = [], []
        for _ in range(REPS):
            r, ms = staged(run)
            times.append(ms / 1e3)
            got_r, ms = staged(lambda: ctx.result_to_affine(r))
            to_affine_runs.append(ms)
            check(got_r == expected, f"path {name}: a repetition's MSM result is wrong")
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
            "result_to_affine_ms": sorted(to_affine_runs)[len(to_affine_runs) // 2],
            "result_to_affine_first_ms": to_affine_ms, "result_to_affine_runs_ms": to_affine_runs,
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

    # -- path G2: the JAX package's default G2 MSM, build_curve(bls12_381_g2).msm:
    # no GLV, full scalars below r (256 bits), c = 6 (the Fq2 cap), W = 44,
    # B = 32: W B = 1408 > 1024, so digits -> K1 -> K4 -> K2 -> K3 over Fq2
    g2 = bls12_381_g2
    ctx_g2 = Z.build_curve(g2)
    t0 = time.perf_counter()
    (Xg, Yg), scalars_g, expected_g, ones_expected_g = bases_and_scalars(ctx_g2, LOG2N, g2_rng, dev,
                                                                       base_sum=True)
    torch.cuda.synchronize()
    bases_g_s = time.perf_counter() - t0
    impl, cg, _ = pippenger.resolve_config(g2, n, 256, None, None, 2 << 30, "auto", device=dev)
    Wg, Bg = windows.num_windows(256, cg), 1 << (cg - 1)
    Tg = pippenger._kernel_lanes(g2, Wg, n, None, dev)
    check((impl, cg, Wg, Bg) == ("kernel", 6, 44, 32), f"path G2 resolved to {(impl, cg, Wg, Bg)}")
    paths["G2"] = lambda: ctx_g2.msm((Xg, Yg), scalars_g)
    path_g2 = drive("G2", paths["G2"], ("bucket_sweep", "lane_reduce", "collapse", "finish", "field_inverse"),
                    ctx=ctx_g2, expected=expected_g)
    digits_g, digits_g_ms = staged(lambda: windows.signed_window_digits(scalars_g, cg, 256))
    buckets_g, bucket_g_ms = staged(lambda: pl_bucket.bucket_accumulate(g2, (Xg, Yg), digits_g, lanes=Tg, c=cg))
    _, finish_g_ms = staged(lambda: pl_reduce.finish_large(g2, buckets_g, cg))
    del buckets_g
    emit({
        "path_G2": {
            "curve": g2.name, "n": n, "scalar_bits": 256, "glv": False, "c": cg, "W": Wg, "B": Bg,
            "lanes": Tg, **path_g2,
            "stage_ms": {
                "digits": digits_g_ms, "bucket_accumulate(K1+K4)": bucket_g_ms,
                "finish_large(K2+K3)": finish_g_ms, "result_to_affine": path_g2["result_to_affine_ms"],
            },
            "bases_built_on_card_s": bases_g_s,
        }
    })
    # BN254 G2 (3b a full Fq2 element) at 2^16, through the same kernels
    ctx_bn = Z.build_curve(bn254_g2)
    (Xb, Yb), scalars_bn, expected_bn = bases_and_scalars(ctx_bn, 16, g2_rng, dev)
    impl, c_bn, _ = pippenger.resolve_config(bn254_g2, 1 << 16, 256, None, None, 2 << 30, "auto", device=dev)
    check((impl, c_bn) == ("kernel", 6), f"BN254 G2 resolved to {(impl, c_bn)}")
    paths["G2 bn254"] = lambda: ctx_bn.msm((Xb, Yb), scalars_bn)
    path_bn = drive("G2 bn254", paths["G2 bn254"],
                    ("bucket_sweep", "lane_reduce", "collapse", "finish", "field_inverse"),
                    ctx=ctx_bn, expected=expected_bn, n=1 << 16)
    emit({"path_G2_bn254": {"curve": bn254_g2.name, "n": 1 << 16, "scalar_bits": 256, "glv": False,
                            "c": c_bn, **path_bn}})

    # -- path G2-sorted: the same bases and scalars through the sorted engine,
    # ctx.msm(P, k, c=10): W = 27, B = 512, T = 1024 chunks, K = 1536; digits
    # -> sort -> compact -> K7 -> K8 -> scatter -> K2 at B = 512 -> K3 at B = 1,
    # all over Fq2.  It must give path G2's point and the oracle's.
    impl, cgs, _ = pippenger.resolve_config(g2, n, 256, C_SORTED, None, 2 << 30, "auto", device=dev)
    Wgs, Bgs = windows.num_windows(256, cgs), 1 << (cgs - 1)
    check((impl, cgs, Wgs, Bgs) == ("kernel-sorted", 10, 27, 512), f"path G2-sorted resolved to {(impl, cgs, Wgs, Bgs)}")
    check(pippenger.resolve_config(g2, n, 256, None, None, 2 << 30, "kernel-sorted")[1] == cgs,
          "impl='kernel-sorted' with c unset should resolve to the same window on G2")
    paths["G2 sorted"] = lambda: ctx_g2.msm((Xg, Yg), scalars_g, c=C_SORTED)
    path_g2s = drive("G2 sorted", paths["G2 sorted"],
                     ("sorted_sweep", "segscan", "collapse", "finish", "field_inverse"),
                     ctx=ctx_g2, expected=expected_g)
    check("bucket_sweep" not in path_g2s["launches"], "path G2-sorted ran the bucket sweep")
    point_g2 = ctx_g2.result_to_affine(paths["G2"]())
    point_g2s = ctx_g2.result_to_affine(paths["G2 sorted"]())
    check(point_g2s == point_g2 == expected_g, "paths G2 and G2-sorted give different points")
    TGs = pl_sorted.GRID
    digits_gs, digits_gs_ms = staged(lambda: windows.signed_window_digits(scalars_g, cgs, 256))
    (perm_gs, skey_gs, meta_gs), sort_gs_ms = staged(lambda: pl_sorted.sort_runs(digits_gs, cgs, TGs))
    (slot_gs, seg_gs), compact_gs_ms = staged(lambda: pl_sorted.compact_index(skey_gs, meta_gs, cgs, TGs))
    del skey_gs
    Kgs = seg_gs.shape[1]
    pieces_gs, sweep_gs_ms = staged(lambda: pl_sorted.sweep(g2, (Xg, Yg), perm_gs, meta_gs, slot_gs, Kgs, TGs))
    scanned_gs, segscan_gs_ms = staged(lambda: pl_sorted.segscan(g2, pieces_gs, seg_gs, TGs))
    dense_gs, scatter_gs_ms = staged(lambda: pl_sorted.scatter_dense(g2, scanned_gs, seg_gs, cgs))
    sums_gs, collapse_gs_ms = staged(lambda: pl_reduce.collapse(g2, dense_gs))
    fold_gs = tuple(a[:, :, None].contiguous() for a in sums_gs)
    point_gs, finish_gs_ms = staged(lambda: pl_reduce.finish(g2, fold_gs, cgs))
    check(ctx_g2.result_to_affine(point_gs) == expected_g, "path G2-sorted's stages, run one by one, miss the oracle")
    del scanned_gs
    emit({
        "path_G2_sorted": {
            "curve": g2.name, "n": n, "scalar_bits": 256, "glv": False, "c": cgs, "W": Wgs, "B": Bgs,
            "chunks": TGs, "K": Kgs, **path_g2s, "equal_to_path_G2": True,
            "stage_ms": {
                "digits": digits_gs_ms, "sort": sort_gs_ms, "compact": compact_gs_ms,
                "sweep(K7)": sweep_gs_ms, "segscan(K8)": segscan_gs_ms, "scatter": scatter_gs_ms,
                "collapse(K2)": collapse_gs_ms, "finish(K3)": finish_gs_ms,
                "result_to_affine": path_g2s["result_to_affine_ms"],
            },
        }
    })

    # -- the skewed stream: path G2's bases with every scalar 1 (a Groth16
    # witness is full of 0/1 scalars) through the sorted engine, msm(P, k,
    # c=10): window 0 has one bucket over every one of the 1 024 chunks, a
    # segment of 1 024 pieces for K8, and the other windows are all zero.
    # Equal to the oracle's (sum m_i mod r) G2 and to the bucket engine's point
    ones_g = torch.zeros_like(scalars_g)
    ones_g[0] = 1
    reset_counts()
    skew_pt, skew_first_ms = staged(lambda: ctx_g2.msm((Xg, Yg), ones_g, c=C_SORTED))
    skew_launches = {k: v for k, v in read_counts().items() if v}
    check(ctx_g2.result_to_affine(skew_pt) == ones_expected_g,
          "the skewed stream (every scalar 1) through the sorted engine misses the oracle")
    check(ctx_g2.result_to_affine(ctx_g2.msm((Xg, Yg), ones_g)) == ones_expected_g,
          "the skewed stream through the bucket engine misses the oracle")
    skew_ms = [staged(lambda: ctx_g2.msm((Xg, Yg), ones_g, c=C_SORTED))[1] for _ in range(REPS)]
    digits_sk = windows.signed_window_digits(ones_g, cgs, 256)
    perm_sk, skey_sk, meta_sk = pl_sorted.sort_runs(digits_sk, cgs, TGs)
    slot_sk, seg_sk = pl_sorted.compact_index(skey_sk, meta_sk, cgs, TGs)
    pieces_sk = pl_sorted.sweep(g2, (Xg, Yg), perm_sk, meta_sk, slot_sk, Kgs, TGs)
    del digits_sk, perm_sk, skey_sk, meta_sk, slot_sk
    emit({"path_G2_skewed": {
        "curve": g2.name, "n": n, "scalars": "every scalar 1", "c": cgs, "chunks": TGs, "K": Kgs,
        "verified_against_oracle": True, "equal_to_bucket_engine": True, "first_call_s": skew_first_ms / 1e3,
        "msm_s": [ms / 1e3 for ms in skew_ms], "best_msm_s": min(skew_ms) / 1e3, "launches": skew_launches,
    }})

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
        "compared": f"after lane reduction, as affine points, against the plain sweep + tree "
                    f"(plain_ms: the plain sweep at {PLAIN_LANES} lanes)",
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
        resident = pl_reduce._reduce_resident_threads(NW, 1, 0)
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
    k4_lanes = pl_reduce._reduce_lanes(W * B, T, pl_reduce._reduce_resident_threads(NW, 1, 0))
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
    for op in ("double_par", "add_par", "double_coop", "add_coop", "add_lane"):  # the Fq chains
        device_check.group_chain(curve, op, pt1, pt2, 10)
        _, ms = sync_ms(lambda: device_check.group_chain(curve, op, pt1, pt2, 2000), 2)
        link_us[op] = ms / 2000 * 1e3

    # K2 collapse: the wrapper, its plan (buckets per run, groups, the wave),
    # its depth floor (the longest chain's links at one warp's latency)
    def k2_floor(W_, B_, curve_=curve, links=None):
        """(buckets a run, links, depth floor ms) of the collapse at (W_, B_)
        (links: the level-parallel ops' latencies, by default the Fq ones)."""
        links = links or link_us
        m = pl_reduce._collapse_run(W_, B_, pl_reduce._collapse_wave_groups(curve_.fq.n_words, 0))
        adds, dbls = pl_reduce._collapse_links(B_, m)
        return m, (adds, dbls), (adds * links["add_coop"] + dbls * links["double_coop"]) / 1e3

    def k2_entry(bk, W_, B_, ref, curve_=curve, links=None):
        """K2's plan, depth floor, and its launches at every run length up
        to 64, each held against ``ref`` and timed over 3 calls; and the
        wrapper over 10 calls."""
        m, (adds, dbls), floor_ms = k2_floor(W_, B_, curve_, links)
        nw = curve_.fq.n_words
        ms = {}
        for k in range(min(B_, 64).bit_length()):
            got = pl_reduce._collapse_launch(curve_, bk, 1 << k)
            e = affine_err(curve_, tuple(got), ref)
            check(e == 0, f"collapse at {1 << k} buckets a run disagrees with plain (max |err| {e})")
            _, ms[f"{1 << k} buckets a run"] = sync_ms(
                lambda: pl_reduce._collapse_launch(curve_, bk, 1 << k), 3)
        return {
            "ms_10_calls": sync_ms(lambda: pl_reduce.collapse(curve_, bk), 10)[1],
            "ms_by_run": ms, "buckets_per_run": m, "groups": W_ * B_ // m,
            "lanes_per_group": pl_reduce._collapse_lanes(nw),
            "wave_groups": pl_reduce._collapse_wave_groups(nw, 0),
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

    # K5 / K6 at the paths' shape (N = 2^20 elements of Fq), compared on full
    # (L, N) operands, limbs bit for bit.  K5: the launch on packed words is
    # timed (as K1's is), the public wrapper beside it.  K6: the public call
    # is its one launch on the limbs, and its bound counts the limb bytes
    # that call moves; the bound of a launch on packed words beside it
    ops_library = "no PyTorch call multiplies multi-word integers modulo q"
    sqr_ops = 2 * (NW * (NW - 1) // 2 + NW + NW * NW + NW)  # field.cuh fe_sqr's multiply-adds
    for kname, replaces, launch, wrapper, plain, n_in, path_count in (
        ("mont_mul", "zprize_wasm_msm_tpu/ops/field/kernels.py:138",
         lambda: field_kernels._mul_words(fq, words[0], words[1]),
         lambda: field_kernels.mont_mul(fq, X, Y), lambda: field_kernels.mont_mul_plain(fq, X, Y),
         2, path_a["launches"]["mont_mul"]),
        ("mont_square", "zprize_wasm_msm_tpu/ops/field/kernels.py:160", None,
         lambda: field_kernels.mont_square(fq, X), lambda: field_kernels.mont_square_plain(fq, X),
         1, batch_launches["mont_square"]),
    ):
        sync_ms(wrapper, 2)  # the allocator's blocks for two results in turn
        got, wrapper_ms = sync_ms(wrapper, 3 if launch else 10)
        ref, plain_ms = staged(plain)
        err = int((got - ref).abs().max().item())
        check(err == 0, f"{kname} at N = 2^{LOG2N} disagrees with its plain version (max |err| {err})")
        del got, ref
        if launch:
            launch()
            _, k_ms = sync_ms(launch, 10)
            b_ms, b_by = bound((n_in + 1) * 4 * NW * n, n * mul_ops)
            extra = {"wrapper_ms": wrapper_ms,
                     "shape": f"({L},{n}) x{n_in} -> ({L},{n}); ms is the launch on ({NW},{n}) packed "
                              "words, wrapper_ms includes packing limbs to words and back"}
        else:
            k_ms = wrapper_ms
            b_ms, b_by = bound(2 * L * 8 * n, n * sqr_ops)
            words_b_ms, words_b_by = bound(2 * 4 * NW * n, n * sqr_ops)
            extra = {"wrapper_ms": wrapper_ms, "multiply_adds_per_element": sqr_ops // 2,
                     "words_form_bound_ms": words_b_ms, "words_form_bound_by": words_b_by,
                     "shape": f"({L},{n}) int64 limbs -> ({L},{n}); ms is the public call "
                              "(field_kernels.mont_square = ctx.batch_square), one launch on the limbs, "
                              "10 calls; bound_ms on the limb bytes it moves, words_form_bound_ms on "
                              f"({NW},{n}) packed words in and out"}
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "zprize_wasm_msm_tpu_torch/csrc/field_kernels.cu", "replaces": replaces,
            "launches": path_count, "max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "no_library_because": ops_library, **extra,
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

    # K8 segmented scan on the sweep's own entries, then (the same kernels)
    # on the skewed stream at path B's shape: every scalar 1, so after the
    # GLV split half the points hold digit 1 in window 0 and one bucket spans
    # half the chunks
    def k8_case(curve_, pieces_, seg_, T_, B_, link_us_):
        """K8 (its wrapper) on one stream: the sums against segscan_plain,
        the time over 3 calls after a warm-up, the kernels a call launched
        (as the entry counts them, checked against its schedule), and its
        depth: the schedule's dependent adds (pl_sorted.scan_depth, a model)
        at the measured latency of one one-lane complete add (link_us_)."""
        pl_sorted.segscan(curve_, pieces_, seg_, T_)
        pl_sorted.scan_kernels["segscan"] = 0
        out_, ms_ = sync_ms(lambda: pl_sorted.segscan(curve_, pieces_, seg_, T_), 3)
        K_ = seg_.shape[1]
        launched, model = pl_sorted.scan_kernels["segscan"], pl_sorted.scan_kernel_count(K_)
        check(launched == 3 * model,
              f"the scan launched {launched} kernels in 3 calls; its schedule has {model} a call")
        ref_, plain_ms_ = staged(lambda: pl_sorted.segscan_plain(curve_, pieces_, seg_, T_))
        used_ = seg_ < B_
        heads_ = used_ & (seg_ != torch.cat([torch.full_like(seg_[:, :1], -1), seg_[:, :-1]], dim=1))
        depth = pl_sorted.scan_depth(seg_)
        return out_, {
            "ms": ms_, "plain_ms": plain_ms_, "max_abs_err": affine_err(curve_, out_, ref_),
            "adds": int(used_.sum().item() - heads_.sum().item()), "entries_in_use": int(used_.sum().item()),
            "longest_segment": int(torch.stack([torch.bincount(row[row < B_], minlength=B_).max()
                                                for row in seg_]).max().item()),
            "levels": pl_sorted.scan_levels(K_), "kernels_per_call": launched // 3,
            # counted from seg by the schedule's model, not measured
            "depth_model": depth, "depth_floor_ms": depth * link_us_ / 1e3,
        }

    k8_out, k8 = k8_case(curve, pieces, seg, TB, BB, link_us["add_lane"])
    check(k8["max_abs_err"] == 0, f"segscan at path B's shape disagrees with plain (max |err| {k8['max_abs_err']})")
    ones = torch.zeros_like(scalars)
    ones[0] = 1
    (X2s, Y2s), k2s = glv.preprocess_endomorphism(curve, (X, Y), ones)
    perm_s, skey_s, meta_s = pl_sorted.sort_runs(windows.signed_window_digits(k2s, cB, glv.MAX_BITS), cB, TB)
    slot_s, seg_s = pl_sorted.compact_index(skey_s, meta_s, cB, TB)
    pieces_s = pl_sorted.sweep(curve, (X2s, Y2s), perm_s, meta_s, slot_s, KB, TB)
    del X2s, Y2s, k2s, perm_s, skey_s, meta_s, slot_s
    _, k8s = k8_case(curve, pieces_s, seg_s, TB, BB, link_us["add_lane"])
    check(k8s["max_abs_err"] == 0,
          f"segscan on the skewed stream at path B's shape disagrees with plain (max |err| {k8s['max_abs_err']})")
    k8s["scalars"] = "every scalar 1 (GLV half-scalars 1 and 0)"
    k8s["bound_ms"], k8s["bound_by"] = bound(2 * 3 * NW * 4 * WB * KB + 4 * WB * KB, k8s["adds"] * ADD)
    del pieces_s, seg_s, ones
    b_ms, b_by = bound(2 * 3 * NW * 4 * WB * KB + 4 * WB * KB, k8["adds"] * ADD)
    kernels.append({
        "name": "segscan", "route": "cuda",
        "source": "zprize_wasm_msm_tpu_torch/csrc/sorted.cu",
        "replaces": "zprize_wasm_msm_tpu/ops/msm/pl_sorted.py:238",
        "launches": path_b["launches"]["segscan"], "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        **k8, "x_bound": k8["ms"] / b_ms, "tile": pl_sorted.SCAN_TILE, "link_us": link_us["add_lane"],
        "skewed_stream": k8s, "no_library_because": ops_library,
        **sweep_res[("segscan", NW)], "fix_up_resources": sweep_res[("segscan (fix-up)", NW)],
        "shape": f"({L},{WB},{KB})x3, seg ({WB},{KB}) -> ({L},{WB},{KB})x3; ms is the wrapper; "
                 "skewed_stream: path B's bases with every scalar 1",
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
                                   "lanes": pl_reduce._reduce_lanes(WA * BA, TA, pl_reduce._reduce_resident_threads(NW, 1, 0)),
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
               "batch": batch_launches}  # the Fq kernels' paths (G2's below)
    for entry in kernels:
        entry["launches_by_path"] = {p: counts.get(entry["name"], 0) for p, counts in by_path.items()}
        if entry["name"] in other_shapes:
            entry["other_shapes"] = other_shapes[entry["name"]]

    # ---- 7. the Fq2 (G2) kernels at path G2's shape ---------------------------
    # Bounds as above with an Fq2 product counted as its three Fq products
    # (Karatsuba): a mixed add / add / double 11 / 12 / 8 Fq2 products.
    FQ2_MUL = 3 * mul_ops
    ADD_MIXED2, ADD2, DOUBLE2 = 11 * FQ2_MUL, 12 * FQ2_MUL, 8 * FQ2_MUL
    EW = 2 * NW
    LG = 2 * EW  # limbs of an Fq2 element
    # K1: the sweep on all 44 windows at the lanes ctx.msm runs; its plain
    # version on the first SUB_W windows only (the plain sweep's ~1 000
    # launches a step make all 44 windows a matter of minutes), at more
    # lanes (fewer steps), compared after both lane reductions
    SUB_W, PLAIN_LANES_G2 = 2, 16384
    words_g = _launch.pack_point((Xg, Yg))
    pl_bucket._sweep(g2, words_g[0], words_g[1], digits_g, Tg, Bg)  # warm-up
    k1g_runs = [sync_ms(lambda: pl_bucket._sweep(g2, words_g[0], words_g[1], digits_g, Tg, Bg))
                for _ in range(3)]
    state_g = k1g_runs[-1][0]
    k1g_runs = [ms for _, ms in k1g_runs]
    k1g_ms = sorted(k1g_runs)[1]  # the median of three
    # K4 over Fq2 on the sweep's state: a warm-up, then two timed launches
    pl_reduce._lane_reduce_state(g2, state_g)
    k4g_runs = []
    for _ in range(2):
        buckets_g, ms = sync_ms(lambda: pl_reduce._lane_reduce_state(g2, state_g))
        k4g_runs.append(ms)
    k4g_ms = sum(k4g_runs) / 2
    del words_g
    k1g_resident = pl_bucket.resident_threads(g2, dev)
    t0 = time.perf_counter()
    plain_g = pippenger._bucket_sweep_plain(g2, (Xg, Yg), digits_g[:SUB_W].contiguous(), PLAIN_LANES_G2, cg)
    torch.cuda.synchronize()
    k1g_plain_ms = (time.perf_counter() - t0) * 1e3
    plain_g = pippenger._lane_tree_reduce(g2, plain_g)
    k1g_err = affine_err(g2, tuple(a[:, :SUB_W] for a in buckets_g), plain_g)
    check(k1g_err == 0, f"bucket sweep over Fq2 at path G2's shape disagrees with plain (max |err| {k1g_err})")
    del plain_g
    zero_pts_g = (Xg == 0).all(0) & (Yg == 0).all(0)
    nonzero_g = int(((digits_g != 0) & ~zero_pts_g[None]).sum().item())
    b_ms, b_by = bound(Wg * n * 4 + 2 * EW * 4 * n + Wg * Tg * Bg * 3 * EW * 4, nonzero_g * ADD_MIXED2)
    fq2_entries = [{
        "name": "bucket_sweep_fq2", "route": "cuda",
        "source": "zprize_wasm_msm_tpu_torch/csrc/bucket.cu",
        "replaces": "zprize_wasm_msm_tpu/ops/msm/pl_bucket.py:240",
        "launches": path_g2["launches"]["bucket_sweep"], "max_abs_err": k1g_err, "ms": k1g_ms,
        "plain_ms": k1g_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"digits ({Wg},{n}) X,Y ({LG},{n}) -> state ({Wg},{Tg},{Bg},3x{EW}w)",
        "compared": f"after lane reduction, as affine points, against the plain sweep + tree on "
                    f"windows 0-{SUB_W - 1} of {Wg} (plain_ms: those windows at {PLAIN_LANES_G2} lanes)",
        "x_bound": k1g_ms / b_ms, "mixed_adds": nonzero_g, "ns_per_add": k1g_ms * 1e6 / nonzero_g,
        **fq2_res[("bucket_sweep", NW)], "kernel_lanes": Tg, "threads": Wg * Tg,
        "lanes": Tg, "waves": Wg * Tg / k1g_resident, "rounds": -(-Wg * Tg // k1g_resident),
        "steps": -(-n // Tg), "resident_threads": k1g_resident, "ms_runs": k1g_runs,
        "ms_is": "the median of ms_runs, three timed launches (CUDA events) after a warm-up",
    }]
    # K4 on the sweep's own state, against the plain lane tree on all of it
    lanes_g = unpack_words(state_g.permute(3, 0, 1, 2).contiguous())  # (3 LG, W, T, B)
    contract_g = tuple(lanes_g[i * LG : (i + 1) * LG].permute(3, 0, 1, 2) for i in range(3))
    del lanes_g, state_g
    k4g_plain, k4g_plain_ms = staged(lambda: pl_reduce.lane_reduce_plain(g2, contract_g))
    k4g_err = affine_err(g2, buckets_g, k4g_plain)
    check(k4g_err == 0, f"lane_reduce over Fq2 at path G2's shape disagrees with plain (max |err| {k4g_err})")
    del contract_g, k4g_plain
    b_ms, b_by = bound(Wg * Tg * Bg * 3 * EW * 4 + Wg * Bg * 3 * EW * 4, Wg * Bg * (Tg - 1) * ADD2)
    fq2_entries.append({
        "name": "lane_reduce_fq2", "route": "cuda",
        "source": "zprize_wasm_msm_tpu_torch/csrc/bucket.cu",
        "replaces": "zprize_wasm_msm_tpu/ops/msm/pl_reduce.py:93",
        "launches": path_g2["launches"]["lane_reduce"], "max_abs_err": k4g_err, "ms": k4g_ms,
        "plain_ms": k4g_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "x_bound": k4g_ms / b_ms,
        "lanes": pl_reduce._reduce_lanes(Wg * Bg, Tg, pl_reduce._reduce_resident_threads(NW, 2, 0)),
        "partials_per_lane": Wg * Bg * Tg / pl_reduce._reduce_lanes(
            Wg * Bg, Tg, pl_reduce._reduce_resident_threads(NW, 2, 0)),
        "ms_runs": k4g_runs, "ms_is": "the mean of ms_runs, two timed launches after a warm-up",
        **fq2_res[("lane_reduce", NW)], "combine_ptxas": fq2_res[("lane_reduce (combine)", NW)]["ptxas"],
        "shape": f"state ({Wg},{Tg},{Bg},3x{EW}w) -> ({LG},{Wg},{Bg})x3; ms is _lane_reduce_state",
        "compared": "as affine points against the plain lane tree on the same state",
    })
    # the links of the Fq2 reductions' chains, each a chain of 500: one
    # level-parallel doubling and addition over Fq2 on one warp (the fold's,
    # the collapse's), and on 2 and 4 warps of one SM side by side (the
    # collapse runs 4 a SM); one one-lane complete add (K8's)
    pg1 = tuple(x[:, :1, 0].contiguous() for x in buckets_g)
    pg2 = tuple(x[:, 1:2, 0].contiguous() for x in buckets_g)
    link2_us, link2_by_warps = {}, {}
    for op, warps in (("double_coop", 1), ("add_coop", 1), ("add_lane", 1), ("double_coop", 2),
                      ("add_coop", 2), ("double_coop", 4), ("add_coop", 4)):
        device_check.group_chain(g2, op, pg1, pg2, 10, warps)
        _, ms = sync_ms(lambda: device_check.group_chain(g2, op, pg1, pg2, 500, warps), 2)
        if warps == 1:
            link2_us[op] = ms / 500 * 1e3
        if op != "add_lane":
            link2_by_warps[f"{op}, {warps} warps a SM"] = ms / 500 * 1e3
    links2_at_4 = {op: link2_by_warps[f"{op}, 4 warps a SM"] for op in ("add_coop", "double_coop")}
    # the fold's links (csrc/fold2.cuh), chains of 500 on one block, in both
    # forms, on BLS12-381 G2 (3b = 12 (1 + u): 3b t by additions, and with
    # b3k = 0 by its level of products) and BN254 G2 (3b a full element); and
    # par.cuh's Fq2 link as the fold ran it before (double_coop / add_coop
    # with b3k = 0: three levels, each Fq2 product's Fq products in turn)
    pbn = group.from_affine(bn254_g2, (Xb[:, :2].contiguous(), Yb[:, :2].contiguous()))
    pb1, pb2 = (tuple(x[:, i : i + 1].contiguous() for x in pbn) for i in (0, 1))
    fold_us = {}
    for curve_, p1, p2 in ((g2, pg1, pg2), (bn254_g2, pb1, pb2)):
        for op in ("double_fold2_warps", "add_fold2_warps", "double_fold2_lane", "add_fold2_lane",
                   "double_coop", "add_coop"):
            for b3k in (None, 0) if _build.fold_b3k(curve_) else (None,):
                device_check.group_chain(curve_, op, p1, p2, 10, 1, b3k)
                _, ms = sync_ms(lambda: device_check.group_chain(curve_, op, p1, p2, 500, 1, b3k), 2)
                fold_us[f"{curve_.name} {op}" + (" b3k=0" if b3k == 0 else "")] = ms / 500 * 1e3
    fold_form = "warps" if pl_reduce.FOLD2_THREADS == 96 else "lane"
    other_form = {"warps": "lane", "lane": "warps"}[fold_form]

    def fold_links(form=fold_form, curve_=g2, suffix=""):
        return {op: fold_us[f"{curve_.name} {op}_fold2_{form}{suffix}"] for op in ("double", "add")}

    old_links = {op: fold_us[f"{g2.name} {op}_coop b3k=0"] for op in ("double", "add")}

    def k3g_floor(W_, c_, links):
        """c (W-1) doublings and W-1 additions at the given links' latency."""
        return (c_ * (W_ - 1) * links["double"] + (W_ - 1) * links["add"]) / 1e3

    def k3g_floors(W_, c_):
        return {
            "depth_floor_ms": k3g_floor(W_, c_, fold_links()),
            "depth_floor_ms_at_old_link": k3g_floor(W_, c_, old_links),
            "depth_floor_ms_at_other_form": k3g_floor(W_, c_, fold_links(other_form)),
        }
    # K2: the wrapper (3 calls), its plan and times at every run length, its
    # depth floor at the Fq2 links (of one warp alone, and of 4 warps a SM)
    pl_reduce.collapse(g2, buckets_g)
    sums_g, k2g_ms = sync_ms(lambda: pl_reduce.collapse(g2, buckets_g), 3)
    k2g_ref, k2g_plain_ms = staged(lambda: pl_reduce.collapse_plain(g2, buckets_g))
    k2g_err = affine_err(g2, sums_g, k2g_ref)
    check(k2g_err == 0, f"collapse over Fq2 at path G2's shape disagrees with plain (max |err| {k2g_err})")
    b_ms, b_by = bound((Wg * Bg + Wg) * 3 * EW * 4, Wg * 2 * (Bg - 1) * ADD2)
    fq2_entries.append({
        "name": "collapse_fq2", "route": "cuda",
        "source": "zprize_wasm_msm_tpu_torch/csrc/reduce.cu",
        "replaces": "zprize_wasm_msm_tpu/ops/msm/pl_reduce.py:353",
        "launches": path_g2["launches"]["collapse"], "max_abs_err": k2g_err, "ms": k2g_ms,
        "plain_ms": k2g_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        **k2_entry(buckets_g, Wg, Bg, k2g_ref, g2, link2_us),
        "depth_floor_ms_at_4_warps": k2_floor(Wg, Bg, g2, links2_at_4)[2],
        "link_us": link2_us, "link_us_by_warps_a_sm": link2_by_warps,
        "collapse_resources": fq2_res[("collapse", NW)],
        "combine_resources": fq2_res[("collapse (combine)", NW)],
        "shape": f"({LG},{Wg},{Bg})x3 -> ({LG},{Wg})x3; ms is the pl_reduce.collapse wrapper, 3 calls",
        "compared": "as affine points against bucket_reduce",
    })
    # K3 at B = 1: the fold of the window sums, and its point is the MSM's
    fold_g = tuple(a[:, :, None].contiguous() for a in sums_g)
    pl_reduce.finish(g2, fold_g, cg)
    k3g_out, k3g_ms = sync_ms(lambda: pl_reduce.finish(g2, fold_g, cg), 3)
    k3g_ref, k3g_plain_ms = staged(lambda: pl_reduce.finish_plain(g2, fold_g, cg))
    k3g_err = affine_err(g2, tuple(x[:, None] for x in k3g_out), tuple(x[:, None] for x in k3g_ref))
    check(k3g_err == 0, f"finish over Fq2 at path G2's shape disagrees with plain (max |err| {k3g_err})")
    check(ctx_g2.result_to_affine(k3g_out) == expected_g, "finish over Fq2: its point is not the MSM result")
    b_ms, b_by = bound((Wg + 1) * 3 * EW * 4, cg * (Wg - 1) * DOUBLE2 + (Wg - 1) * ADD2)
    fq2_entries.append({
        "name": "finish_fq2", "route": "cuda",
        "source": "zprize_wasm_msm_tpu_torch/csrc/reduce.cu",
        "replaces": "zprize_wasm_msm_tpu/ops/msm/pl_reduce.py:246",
        "launches": path_g2["launches"]["finish"], "max_abs_err": k3g_err, "ms": k3g_ms,
        "plain_ms": k3g_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        **k3g_floors(Wg, cg), "fold_form": f"{fold_form}: {pl_reduce.FOLD2_THREADS} threads",
        "link_us": fold_links(), "link_us_other_form": fold_links(other_form),
        "link_us_old": old_links, "link_us_bn254_g2": fold_links(curve_=bn254_g2),
        "link_us_b3_product_level": fold_links(suffix=" b3k=0"), "fold_links_us": fold_us,
        "fold_resources": fq2_res[("finish (fold)", NW)],
        "shape": f"({LG},{Wg},1)x3, c={cg} -> ({LG},)x3; ms is the pl_reduce.finish wrapper; "
                 "depth floors at this form's link, at par.cuh's Fq2 link with its level of "
                 "products by 3b (the fold's link before) and at the other form's",
        "compared": "as affine points against bucket_reduce + window_fold, and against the oracle",
    })
    # K7 over Fq2 at path G2-sorted's shape, all 27 windows, on the stream
    # its own stages made above: the wrapper and the launch on words; its
    # plain version on window 0 only (1 024 serial steps of the plain Fq2
    # mixed add take about a minute whatever the window count)
    SUB_WS = 1
    pl_sorted.sweep(g2, (Xg, Yg), perm_gs, meta_gs, slot_gs, Kgs, TGs)
    pieces_gs, k7g_ms = sync_ms(lambda: pl_sorted.sweep(g2, (Xg, Yg), perm_gs, meta_gs, slot_gs, Kgs, TGs), 2)
    pts_gs = _launch.point_words((Xg, Yg))
    stream_gs = (perm_gs.contiguous(), meta_gs.contiguous(), slot_gs.contiguous())
    _, k7g_launch_ms = sync_ms(lambda: pl_sorted._sweep_words(g2, pts_gs, *stream_gs, Kgs, TGs), 2)
    del pts_gs, stream_gs
    sub_stream = tuple(a[:SUB_WS].contiguous() for a in (perm_gs, meta_gs, slot_gs))
    k7g_plain, k7g_plain_ms = staged(lambda: pl_sorted.sweep_plain(g2, (Xg, Yg), *sub_stream, Kgs, TGs))
    k7g_err = affine_err(g2, tuple(a[:, :SUB_WS] for a in pieces_gs), k7g_plain)
    check(k7g_err == 0, f"sorted sweep over Fq2 at path G2-sorted's shape disagrees with plain (max |err| {k7g_err})")
    del k7g_plain, sub_stream
    k7g_adds = int((((meta_gs & pl_sorted.META_ZERO) == 0) & ~zero_pts_g[perm_gs.long()]).sum().item())
    b_ms, b_by = bound(2 * EW * 4 * n + 3 * 4 * Wgs * n + 3 * EW * 4 * Wgs * Kgs, k7g_adds * ADD_MIXED2)
    fq2_entries.append({
        "name": "sorted_sweep_fq2", "route": "cuda",
        "source": "zprize_wasm_msm_tpu_torch/csrc/sorted.cu",
        "replaces": "zprize_wasm_msm_tpu/ops/msm/pl_sorted.py:127",
        "launches": path_g2s["launches"]["sorted_sweep"], "max_abs_err": k7g_err, "ms": k7g_ms,
        "plain_ms": k7g_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "launch_ms": k7g_launch_ms, "x_bound": k7g_ms / b_ms, "mixed_adds": k7g_adds,
        "ns_per_add": k7g_ms * 1e6 / k7g_adds, "threads": Wgs * TGs * 32,
        **fq2_res[("sorted_sweep", NW)],
        "shape": f"X,Y ({LG},{n}), perm/meta/slot ({Wgs},{n}), T={TGs} -> ({LG},{Wgs},{Kgs})x3; "
                 "ms is the wrapper, launch_ms the launch on point-contiguous words",
        "compared": f"every entry as an affine point against sweep_plain on the same stream, windows "
                    f"0-{SUB_WS - 1} of {Wgs} (plain_ms: those windows)",
    })
    # K8 over Fq2 on the sweep's own entries and on the skewed stream's,
    # against its plain version (k8_case above)
    k8g_out, k8g = k8_case(g2, pieces_gs, seg_gs, TGs, Bgs, link2_us["add_lane"])
    check(k8g["max_abs_err"] == 0,
          f"segscan over Fq2 at path G2-sorted's shape disagrees with plain (max |err| {k8g['max_abs_err']})")
    _, k8g_skew = k8_case(g2, pieces_sk, seg_sk, TGs, Bgs, link2_us["add_lane"])
    check(k8g_skew["max_abs_err"] == 0,
          f"segscan over Fq2 on the skewed stream disagrees with plain (max |err| {k8g_skew['max_abs_err']})")
    check(k8g_skew["longest_segment"] == TGs, f"the skewed stream's longest segment is {k8g_skew['longest_segment']}")
    k8g_skew["bound_ms"], k8g_skew["bound_by"] = bound(2 * 3 * EW * 4 * Wgs * Kgs + 4 * Wgs * Kgs,
                                                       k8g_skew["adds"] * ADD2)
    del pieces_gs, pieces_sk
    b_ms, b_by = bound(2 * 3 * EW * 4 * Wgs * Kgs + 4 * Wgs * Kgs, k8g["adds"] * ADD2)
    fq2_entries.append({
        "name": "segscan_fq2", "route": "cuda",
        "source": "zprize_wasm_msm_tpu_torch/csrc/sorted.cu",
        "replaces": "zprize_wasm_msm_tpu/ops/msm/pl_sorted.py:238",
        "launches": path_g2s["launches"]["segscan"], "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        **k8g, "x_bound": k8g["ms"] / b_ms, "tile": pl_sorted.SCAN_TILE, "link_us": link2_us["add_lane"],
        "skewed_stream": k8g_skew,
        **fq2_res[("segscan", NW)], "fix_up_resources": fq2_res[("segscan (fix-up)", NW)],
        "shape": f"({LG},{Wgs},{Kgs})x3, seg ({Wgs},{Kgs}) -> ({LG},{Wgs},{Kgs})x3; ms is the wrapper; "
                 "skewed_stream: path G2's bases with every scalar 1",
        "compared": "every entry as an affine point against segscan_plain (Hillis-Steele rounds)",
    })
    # K2 over Fq2 at B = 512 and K3 over Fq2 at W = 27, B = 1: path
    # G2-sorted's shapes, new to the Fq2 forms
    dense_gs = pl_sorted.scatter_dense(g2, k8g_out, seg_gs, cgs)
    del k8g_out
    pl_reduce.collapse(g2, dense_gs)
    sums_gs, k2gs_ms = sync_ms(lambda: pl_reduce.collapse(g2, dense_gs), 3)
    k2gs_ref, k2gs_plain_ms = staged(lambda: pl_reduce.collapse_plain(g2, dense_gs))
    k2gs_err = affine_err(g2, sums_gs, k2gs_ref)
    check(k2gs_err == 0, f"collapse over Fq2 at B = {Bgs} disagrees with plain (max |err| {k2gs_err})")
    fold_gs = tuple(a[:, :, None].contiguous() for a in sums_gs)
    pl_reduce.finish(g2, fold_gs, cgs)
    k3gs_out, k3gs_ms = sync_ms(lambda: pl_reduce.finish(g2, fold_gs, cgs), 3)
    k3gs_ref, k3gs_plain_ms = staged(lambda: pl_reduce.finish_plain(g2, fold_gs, cgs))
    k3gs_err = affine_err(g2, tuple(x[:, None] for x in k3gs_out), tuple(x[:, None] for x in k3gs_ref))
    check(k3gs_err == 0, f"finish over Fq2 at W = {Wgs} disagrees with plain (max |err| {k3gs_err})")
    check(ctx_g2.result_to_affine(k3gs_out) == expected_g, "finish over Fq2 at path G2-sorted: not the MSM result")
    other_g2 = {
        "collapse_fq2": {"path_G2_sorted": {
            "shape": f"({LG},{Wgs},{Bgs})x3", "ms": k2gs_ms, "plain_ms": k2gs_plain_ms, "max_abs_err": k2gs_err,
            **dict(zip(("bound_ms", "bound_by"), bound((Wgs * Bgs + Wgs) * 3 * EW * 4,
                                                       Wgs * 2 * (Bgs - 1) * ADD2))),
            **k2_entry(dense_gs, Wgs, Bgs, k2gs_ref, g2, link2_us),
            "depth_floor_ms_at_4_warps": k2_floor(Wgs, Bgs, g2, links2_at_4)[2]}},
        "finish_fq2": {"path_G2_sorted": {
            "shape": f"({LG},{Wgs},1)x3, c={cgs}", "ms": k3gs_ms, "plain_ms": k3gs_plain_ms, "max_abs_err": k3gs_err,
            **dict(zip(("bound_ms", "bound_by"), bound((Wgs + 1) * 3 * EW * 4,
                                                       cgs * (Wgs - 1) * DOUBLE2 + (Wgs - 1) * ADD2))),
            **k3g_floors(Wgs, cgs)}},
    }
    del dense_gs, sums_gs, fold_gs
    for entry in fq2_entries:
        entry["launches_by_path"] = {p: counts.get(entry["name"][:-4], 0) for p, counts in (
            ("G2", path_g2["launches"]), ("G2 bn254", path_bn["launches"]), ("G2 sorted", path_g2s["launches"]))}
        entry["no_library_because"] = ops_library
        if entry["name"] in other_g2:
            entry["other_shapes"] = other_g2[entry["name"]]
    kernels += fq2_entries
    del buckets_g, sums_g, fold_g

    # ---- 8. the Groth16 stack: NTT, poly helpers, pairings, subgroup checks,
    # the verifier; each phase with the kernel counts zeroed before it
    groth_rng = np.random.default_rng(SEED + 10)
    torch.cuda.empty_cache()  # the 2^20 paths' cached blocks: these phases allocate small tensors
    stack, reports = {}, {}
    for name, phase in (
        ("ntt", lambda: ntt_phase(dev, groth_rng)),
        ("poly", lambda: poly_phase(dev, groth_rng)),
        ("pairing_bls12_381", lambda: pairing_phase((bls12_381, bls12_381_g2), dev, groth_rng)),
        ("pairing_bn254", lambda: pairing_phase((bn254, bn254_g2), dev, groth_rng, plain_check=False)),
        ("groth16", lambda: groth16_phase(dev, groth_rng)),
        ("in_group", lambda: in_group_phase(dev, groth_rng)),
    ):
        reset_counts()
        t0 = time.perf_counter()
        reports[name] = report = phase()
        counts = read_counts()
        stack[name] = {"kernel_launches": {k: v for k, v in counts.items() if v},
                       "seconds": round(time.perf_counter() - t0, 2)}
        emit({name: report, **stack[name]})
    check(stack["ntt"]["kernel_launches"].get("mont_mul", 0) > 0, "the NTT phase never launched K5")
    k5 = next(e for e in kernels if e["name"] == "mont_mul")
    k5["launches_by_path"] = {
        "A": k5["launches"], "ntt fft 2^20": reports["ntt"]["fft"]["k5_launches"],
        "ntt ifft 2^20": reports["ntt"]["ifft"]["k5_launches"],
        "poly helpers": reports["poly"]["k5_launches"],
        "groth16 verify (bls12_381)": reports["groth16"]["bls12_381"]["kernel_launches"].get("mont_mul", 0),
    }
    k5["ntt_stage_call"] = reports["ntt"]["k5_stage_call"]
    inv = next(e for e in kernels if e["name"] == "field_inverse")
    inv["launches_by_path"] = {"full": inv["launches"], **{
        f"{p} phase": stack[p]["kernel_launches"].get("field_inverse", 0)
        for p in ("pairing_bls12_381", "pairing_bn254", "groth16", "in_group")}}

    # ---- 9. MNT6-753: the kernels at NW = 24, then every entry point ----------
    t0 = time.perf_counter()
    mnt_rng = np.random.default_rng(SEED + 20)
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 2**30  # what the phases before keep
    torch.cuda.reset_peak_memory_stats()
    mnt_checks, mnt_entries = mnt6753_kernel_checks(dev, mnt_rng, field_res)
    mnt = mnt6753_phase(dev, mnt_rng, reset_counts, read_counts)
    mnt_launches = mnt["path_kernel_launches"]
    for entry in mnt_entries:
        entry["launches"] = mnt_launches.get(entry["name"].replace("_nw24", ""), 0)
    kernels += mnt_entries
    emit({"mnt6753": {"kernel_checks": mnt_checks, **mnt, "gib_held_before": held_gb,
                      "peak_gib": max(mnt["peak_bytes_before_resets"], torch.cuda.max_memory_allocated()) / 2**30},
          "kernel_launches": mnt_launches, "seconds": round(time.perf_counter() - t0, 2)})

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
