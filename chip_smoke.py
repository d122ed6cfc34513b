"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

What it does, in order (any failure exits non-zero and prints no result):

  1. refuses to run without a CUDA device;
  2. builds every CUDA kernel from zprize_wasm_msm_tpu_torch/csrc/ with nvcc
     (all sources in parallel) into build/;
  3. holds the device functions (field and group ops of csrc/field.cuh and
     csrc/group.cuh) and the field inversion kernel bit for bit against the
     plain PyTorch ops, on the toy field, BN254 Fq and BLS12-381 Fq (every
     field width the sources instantiate), edge values included;
  4. holds each kernel against its plain PyTorch version at small shapes on
     the toy curve, BN254 and BLS12-381 (zero digits, +-B digits, (0,0)
     points, repeated points that force the doubling case inside a bucket);
  5. drives the main path — BLS12-381 G1 MSM, N = 2^20 distinct bases,
     full 255-bit scalars, no GLV, c = 7 — through the public API
     (build_bls12381().msm -> result_to_affine), a few timed repetitions,
     with the kernels' launch counts zeroed just before and read just
     after, and verifies the result against the host oracle as
     (sum k_i m_i mod r) G;
  6. calls each kernel's wrapper at the main path's shapes, compares it
     with its plain version on the same inputs (exact equality of affine
     coordinates: integers, tolerance 0) and times both.

Output: one JSON object per line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Takes a few minutes on an H100, the build included.  Needs no network.

    python3 chip_smoke.py --profile

additionally runs one MSM of the main path under torch.profiler and prints a
"profile" line (device time by kernel, device busy share of the profiled
wall time); with a directory argument, --profile DIR, it also writes the
Chrome trace there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 123
LOG2N = 20
REPS = 3
PLAIN_LANES = 1024  # lanes of the plain sweep at the main path's shape

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


def profile_msm(run_msm, trace_dir):
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
        prof.export_chrome_trace(os.path.join(trace_dir, "msm_trace.json"))
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
    from zprize_wasm_msm_tpu_torch.ops.msm import _launch, pippenger, pl_bucket, pl_reduce, windows
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
    ptxas = []
    for stem, log in logs.items():
        (_build.BUILD_DIR / f"nvcc_{stem}.log").write_text(log)
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line:
                used = next((l for l in lines[i + 1 : i + 6] if "Used" in l), "")
                spill = next((l for l in lines[i + 1 : i + 6] if "spill" in l), "")
                name = line.split("'")[1]
                ptxas.append(f"{stem}:{name[:48]}: {used.split(':')[-1].strip()} | {spill.strip()}")
    emit({
        "env": {
            "torch": torch.__version__, "cuda": torch.version.cuda, "nvcc": nvcc_version,
            "python": sys.version.split()[0],
        },
        "build_seconds": round(build_s, 2),
        "built": sorted(logs),
        "ptxas": ptxas,
    })

    def oracle_of(curve):
        return OracleCurve(q=curve.q, a=0, b=curve.b, r=curve.r, gx=curve.gx, gy=curve.gy)

    def affine_err(curve, a, b) -> int:
        """max |difference| of the affine limbs of two point batches."""
        fa = group.to_affine(curve, tuple(x.reshape(x.shape[0], -1) for x in a))
        fb = group.to_affine(curve, tuple(x.reshape(x.shape[0], -1) for x in b))
        return int(max((u - v).abs().max().item() for u, v in zip(fa, fb)))

    def make_bases(ctx, log2n: int, rng):
        """N = 2^log2n bases [m_i]G as subset sums, built on the card with
        the port's own group ops: seeds [m_0]G, [d_k]G by times_scalar, then
        log2n rounds S <- S u (S + [d_k]G) (one batched complete mixed add
        each) and ONE batched to_affine.  m_i = m_0 + sum_k bit_k(i) d_k."""
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
        for op, ref in (
            ("mul", mont.mont_mul(fq, a, b)), ("add", mont.add(fq, a, b)),
            ("sub", mont.sub(fq, a, b)), ("neg", mont.neg(fq, a)),
        ):
            got = device_check.field_op(curve, op, a, b)
            torch.cuda.synchronize()
            check(bool((got == ref).all()), f"{curve.name}: device fe_{op} != mont.{op}")
        # the inversion kernel against the plain Fermat ladder: 0, 1, q-1, ...
        inv_in = torch.cat([a[:, 0:25:6], a[:, 25:28]], dim=1).contiguous()
        got = field_kernels.inverse(fq, inv_in)
        torch.cuda.synchronize()
        check(bool((got == field_kernels.inverse_plain(fq, inv_in)).all()),
              f"{curve.name}: inverse kernel != mont.inverse")
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
        for op, ref, qin in (
            ("add", group.add(curve, P, Q), Q),
            ("add_mixed", group.add_mixed(curve, P, (QX, QY)), (QX, QY, Q[2])),
            ("double", group.double(curve, P), Q),
        ):
            got = device_check.group_op(curve, op, P, qin)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                check(bool((g == r).all()), f"{curve.name}: device pt_{op} != group.{op}")
        dev_fn_report[curve.name] = "mul/add/sub/neg/inverse + add_mixed/add/double bit-equal"
    emit({"device_functions": dev_fn_report, "seconds": round(time.perf_counter() - t0, 2)})

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

    t0 = time.perf_counter()
    small = {
        "toy c=7 W=4 B=64": kernel_checks(toy, 12, 7, 16, 64, "toy c=7"),
        "toy c=4 W=5 B=8": kernel_checks(toy, 10, 4, 16, 16, "toy c=4"),
        "bn254 c=5 W=52 B=16": kernel_checks(bn254, 10, 5, 254, 32, "bn254 c=5"),
        "bls12_381 c=7 W=38 B=64": kernel_checks(bls12_381, 12, 7, 255, 64, "bls12_381 c=7"),
        "bls12_381 c=6 W=23 B=32": kernel_checks(bls12_381, 10, 6, 132, 32, "bls12_381 c=6"),
    }
    emit({"kernels_small_shapes_max_abs_err": small, "tolerance": 0,
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

    def run_msm():
        return ctx.msm((X, Y), scalars, use_glv=False, max_bits=255)

    impl, c, _ = pippenger.resolve_config(curve, n, 255, None, None, 2 << 30, "auto", device=dev)
    T = pippenger._kernel_lanes(n, None)
    W, B = windows.num_windows(255, c), 1 << (c - 1)
    check((impl, c, W, B) == ("kernel", 7, 38, 64), f"main path resolved to {(impl, c, W, B)}")

    pl_bucket.launches = 0
    for counts in (pl_reduce.launches, field_kernels.launches):
        for k in counts:
            counts[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_msm()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = ctx.result_to_affine(res)
    torch.cuda.synchronize()
    to_affine_s = time.perf_counter() - t0
    main_launches = {
        "bucket_sweep": pl_bucket.launches,
        "lane_reduce": pl_reduce.launches["lane_reduce"],
        "collapse": pl_reduce.launches["collapse"],
        "finish": pl_reduce.launches["finish"],
        "field_inverse": field_kernels.launches["inverse"],
    }
    for name, count in main_launches.items():
        check(count > 0, f"main path never launched kernel {name}")
    check(all(bool(torch.isfinite(r.double()).all()) and r.shape == (24,) for r in res),
          "MSM result has the wrong shape")
    check(got == expected, "MSM result does not match the oracle (sum k_i m_i mod r) G")

    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = run_msm()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(ctx.result_to_affine(r) == expected, "a repetition's MSM result is wrong")

    # per-stage host-clock times (each stage ends in a synchronize)
    def staged(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    digits, digits_ms = staged(lambda: windows.signed_window_digits(scalars, c, 255))
    buckets, bucket_ms = staged(
        lambda: pl_bucket.bucket_accumulate(curve, (X, Y), digits, lanes=T, c=c)
    )
    _, finish_ms = staged(lambda: pl_reduce.finish_large(curve, buckets, c))
    emit({
        "main_path": {
            "curve": curve.name, "n": n, "scalar_bits": 255, "glv": False, "c": c, "W": W, "B": B,
            "lanes": T, "verified_against_oracle": True,
            "first_call_s": first_s, "msm_s": times, "best_msm_s": min(times),
            "points_per_s": n / min(times),
            "stage_ms": {
                "digits": digits_ms, "bucket_accumulate(K1+K4)": bucket_ms,
                "finish_large(K2+K3)": finish_ms, "result_to_affine": to_affine_s * 1e3,
            },
            "bases_built_on_card_s": bases_s,
            "launches": main_launches,  # one msm + one result_to_affine
            "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
        }
    })

    if args.profile is not None:
        emit({"profile": profile_msm(run_msm, args.profile)})

    # ---- 6. each kernel at the main path's shapes ---------------------------
    NW = curve.fq.n_words
    mul_ops = 2 * (2 * NW * NW + NW)  # a*b and m*q rows plus m, 2 ops per multiply-add
    ADD_MIXED, ADD, DOUBLE = 11 * mul_ops, 12 * mul_ops, 8 * mul_ops

    def bound(nbytes: float, nops: float):
        tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_INT32_OPS_PER_S * 1e3
        return max(tb, to), ("bytes" if tb >= to else "operations")

    kernels = []

    # K1 sweep: wrapper pl_bucket._sweep on packed words
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
    b_ms, b_by = bound(W * T * B * 3 * NW * 4 + W * B * 3 * NW * 4, W * B * (T - 1) * ADD)
    kernels.append({
        "name": "lane_reduce", "route": "cuda",
        "source": "zprize_wasm_msm_tpu_torch/csrc/bucket.cu",
        "replaces": "zprize_wasm_msm_tpu/ops/msm/pl_reduce.py:93",
        "launches": main_launches["lane_reduce"], "max_abs_err": k4_err, "ms": k4_ms,
        "plain_ms": k4_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"state ({W},{T},{B},3x{NW}w) -> ({L},{W},{B})x3",
        "compared": "as affine points against the plain lane tree on the same state",
    })
    del state

    # K2 collapse
    pl_reduce.collapse(curve, kernel_buckets)
    k2_out, k2_ms = sync_ms(lambda: pl_reduce.collapse(curve, kernel_buckets), 3)
    k2_ref, k2_plain_ms = staged(lambda: pl_reduce.collapse_plain(curve, kernel_buckets))
    k2_err = affine_err(curve, k2_out, k2_ref)
    check(k2_err == 0, f"collapse at the main path's shape disagrees with plain (max |err| {k2_err})")
    # cheapest known schedule of sum_b (b+1) S_b: the running-sum walk,
    # 2 (B - 1) adds per window (not this kernel's ladder + tree)
    b_ms, b_by = bound((W * B + W) * 3 * NW * 4, W * 2 * (B - 1) * ADD)
    kernels.append({
        "name": "collapse", "route": "cuda",
        "source": "zprize_wasm_msm_tpu_torch/csrc/reduce.cu",
        "replaces": "zprize_wasm_msm_tpu/ops/msm/pl_reduce.py:353",
        "launches": main_launches["collapse"], "max_abs_err": k2_err, "ms": k2_ms,
        "plain_ms": k2_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"({L},{W},{B})x3 -> ({L},{W})x3",
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
    # cheapest known schedule at B = 1: Horner over the windows, c (W - 1)
    # doublings and W - 1 adds (the running-sum walk over B = 1 bucket is free)
    b_ms, b_by = bound((W + 1) * 3 * NW * 4, c * (W - 1) * DOUBLE + (W - 1) * ADD)
    kernels.append({
        "name": "finish", "route": "cuda",
        "source": "zprize_wasm_msm_tpu_torch/csrc/reduce.cu",
        "replaces": "zprize_wasm_msm_tpu/ops/msm/pl_reduce.py:246",
        "launches": main_launches["finish"], "max_abs_err": k3_err, "ms": k3_ms,
        "plain_ms": k3_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"({L},{W},1)x3, c={c} -> ({L},)x3",
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
        "shape": f"({L}, 1) -> ({L}, 1)",
        "compared": "limbs bit for bit against mont.inverse (a^(q-2) by mont_mul)",
    })

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
