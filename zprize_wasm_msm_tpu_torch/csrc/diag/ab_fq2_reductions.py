"""A/B of whole builds of the lane reduction (K4) and the segmented scan (K8)
on one card: K4 over Fq2 and over Fq, K8 over Fq2.

    python3 zprize_wasm_msm_tpu_torch/csrc/diag/ab_fq2_reductions.py \\
        --form old=OLD_CHECKOUT/zprize_wasm_msm_tpu_torch/csrc \\
        --form new=zprize_wasm_msm_tpu_torch/csrc [--reps 4]

Each ``--form NAME=CSRC`` names a directory of kernel sources (for instance
``csrc/`` of an unpacked ``git archive`` of another commit); its
``bucket.cu`` and ``sorted.cu`` are built with the package's nvcc flags (all
forms at once, ab_fq2_sweeps.build_forms) into ``build/ab/NAME/``.  The
inputs are made once by the current package: path G2's data (BLS12-381 G2,
2^20 bases and scalars from chip_smoke.py's seed) gives K1's state at c = 6
for K4 over Fq2 and, through the sorted engine's stages at c = 10, K8's
pieces; the same bases with every scalar 1 give the skewed stream's pieces
(one segment of 1 024); BLS12-381 G1 at 2^20 with full scalars gives the
full path's K1 state (c = 7) for K4 over Fq.  Each form launches K4 at the
lanes pl_reduce._reduce_lanes gives its own residency (zp_lane_reduce_info),
and K8 as its wrapper does: a form without ``zp_segscan_limbs`` packs the
pieces to words, launches zp_segscan and unpacks (a form whose
``zp_segscan_limbs`` reports its kernel count is given NULL for it).  The launches are timed
with CUDA events in turns (forms in order on even rounds, reversed on odd
ones); every form's result must equal the first form's as affine points.
Prints one JSON line per form (residencies, lanes, times) and the card's
name and power limit.  Needs a CUDA card and nvcc (CUDA_HOME, default
/usr/local/cuda).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from ab_fq2_sweeps import build_forms, event_ms  # noqa: E402
from zprize_wasm_msm_tpu_torch import _build  # noqa: E402


def lane_info(lib, ext):
    fn = lib.zp_lane_reduce_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = (ctypes.c_int * 4)()
    _build.check_launch(fn(12, ext, 0, ctypes.cast(out, ctypes.c_void_p)), "zp_lane_reduce_info")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "blocks_per_sm"), out))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--form", action="append", required=True, metavar="NAME=CSRC")
    parser.add_argument("--reps", type=int, default=4, help="rounds of turns (each form once a round)")
    args = parser.parse_args()
    chip_smoke.check(torch.cuda.is_available(), "no CUDA device")
    forms = []
    for spec in args.form:
        name, csrc = spec.split("=", 1)
        forms.append((name, str(Path(csrc).resolve()), ""))

    from zprize_wasm_msm_tpu_torch import build_bls12381, build_curve
    from zprize_wasm_msm_tpu_torch.models.curves import bls12_381, bls12_381_g2 as g2
    from zprize_wasm_msm_tpu_torch.ops.msm import _launch, pippenger, pl_bucket, pl_reduce, pl_sorted, windows

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs, _ = build_forms(forms)
    chip_smoke.emit({"built": {n: c for n, c, _ in forms}, "build_s": time.perf_counter() - t0})
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    # the inputs, made once by the current package
    ctx = build_curve(g2)
    rng = np.random.default_rng(chip_smoke.SEED + 4)  # chip_smoke.py's G2 data
    (X, Y), scalars, _ = chip_smoke.bases_and_scalars(ctx, chip_smoke.LOG2N, rng, dev)
    n = X.shape[1]
    digits = windows.signed_window_digits(scalars, 6, 256)
    T = pippenger._kernel_lanes(g2, digits.shape[0], n, None, dev)
    words = _launch.pack_point((X, Y))
    state_g2 = pl_bucket._sweep(g2, words[0], words[1], digits, T, 32)
    del words, digits

    def pieces_of(sc):
        d = windows.signed_window_digits(sc, 10, 256)
        perm, skey, meta = pl_sorted.sort_runs(d, 10, pl_sorted.GRID)
        slot, seg = pl_sorted.compact_index(skey, meta, 10, pl_sorted.GRID)
        return pl_sorted.sweep(g2, (X, Y), perm, meta, slot, seg.shape[1], pl_sorted.GRID), seg

    ones = torch.zeros_like(scalars)
    ones[0] = 1
    scan_cases = {"G2-sorted": pieces_of(scalars), "skewed": pieces_of(ones)}
    ctx1 = build_bls12381()
    (X1, Y1), scalars1, _ = chip_smoke.bases_and_scalars(ctx1, chip_smoke.LOG2N,
                                                         np.random.default_rng(chip_smoke.SEED), dev)
    digits1 = windows.signed_window_digits(scalars1, 7, 255)
    T1 = pippenger._kernel_lanes(bls12_381, digits1.shape[0], n, None, dev)
    words1 = _launch.pack_point((X1, Y1))
    state_g1 = pl_bucket._sweep(bls12_381, words1[0], words1[1], digits1, T1, 64)
    del words1, digits1, X1, Y1, scalars1
    chip_smoke.emit({"inputs_s": time.perf_counter() - t0})

    def k4(lib, curve, state):
        ext = curve.ext
        NW = curve.fq.n_words
        W, Tn, B, PW = state.shape
        lanes = pl_reduce._reduce_lanes(W * B, Tn, lane_info(lib, ext)["blocks_per_sm"]
                                        * pl_reduce.REDUCE_THREADS[ext] * sms)
        fn = lib.zp_lane_reduce
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        out = torch.empty((3, PW // 3, W * B), dtype=torch.int32, device=dev)
        pieces = torch.empty((2 * (lanes // 32) + lanes, PW), dtype=torch.int32, device=dev)
        consts = _build.curve_consts(curve).ctypes.data_as(ctypes.c_void_p)

        def run():
            err = fn(NW, ext, consts, _launch.ptr(state), _launch.ptr(out), _launch.ptr(pieces), W, Tn, B,
                     lanes, _launch.stream_ptr())
            _build.check_launch(err, "lane_reduce")
            return _launch.unpack_point(out, (W, B))

        return run, lanes

    def k8(lib, csrc, pieces, seg):
        W, K = seg.shape
        consts = _build.curve_consts(g2).ctypes.data_as(ctypes.c_void_p)
        segc = seg.contiguous()
        if hasattr(lib, "zp_segscan_limbs"):
            fn = lib.zp_segscan_limbs
            # a form whose entry reports its kernel count takes one pointer more
            count = [None] if "int* kernels" in (Path(csrc) / "sorted.cu").read_text() else []
            fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 \
                + [ctypes.c_void_p] * (1 + len(count))

            def run():
                out = torch.empty((3,) + tuple(pieces[0].shape), dtype=torch.int64, device=dev)
                err = fn(12, 2, consts, *(_launch.ptr(a) for a in pieces), _launch.ptr(segc), _launch.ptr(out),
                         W, K, *count, _launch.stream_ptr())
                _build.check_launch(err, "segscan_limbs")
                return tuple(out)
        else:
            fn = lib.zp_segscan
            fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]

            def run():
                P = _launch.pack_point(pieces)
                out = torch.empty_like(P)
                err = fn(12, 2, consts, _launch.ptr(P), _launch.ptr(segc), _launch.ptr(out), W, K,
                         _launch.stream_ptr())
                _build.check_launch(err, "segscan")
                return _launch.unpack_point(out, (W, K))
        fn.restype = ctypes.c_int
        return run

    runs, lanes = {}, {}
    for name, csrc, _ in forms:
        lib_b, lib_s = libs[csrc]["bucket"], libs[csrc]["sorted"]
        r4g2, lanes[(name, "k4_fq2")] = k4(lib_b, g2, state_g2)
        r4g1, lanes[(name, "k4_fq")] = k4(lib_b, bls12_381, state_g1)
        runs[name] = {"k4_fq2_ms": r4g2, "k4_fq_ms": r4g1,
                      **{f"k8_fq2_{case}_ms": k8(lib_s, csrc, *pieces_seg) for case, pieces_seg in scan_cases.items()}}
    curve_of = {"k4_fq2_ms": g2, "k4_fq_ms": bls12_381}
    ref = {}
    for name, _, _ in forms:  # warm-up and the cross-form check
        for key, run in runs[name].items():
            got = run()
            torch.cuda.synchronize()
            if key not in ref:
                ref[key] = got
            else:
                e = chip_smoke.affine_err(curve_of.get(key, g2), got, ref[key])
                chip_smoke.check(e == 0, f"{name}: {key[:-3]} differs from {forms[0][0]}'s (max |err| {e})")
    del ref
    times = {name: {key: [] for key in runs[name]} for name, _, _ in forms}
    for r in range(args.reps):
        for name, _, _ in (forms if r % 2 == 0 else forms[::-1]):
            for key, run in runs[name].items():
                times[name][key].append(event_ms(run)[1])
    for name, csrc, _ in forms:
        lib_b = libs[csrc]["bucket"]
        chip_smoke.emit({
            "form": name, "csrc": csrc,
            "k4_fq2": {**lane_info(lib_b, 2), "lanes": lanes[(name, "k4_fq2")]},
            "k4_fq": {**lane_info(lib_b, 1), "lanes": lanes[(name, "k4_fq")]},
            **times[name], **{k.replace("_ms", "_mean_ms"): sum(v) / len(v) for k, v in times[name].items()},
        })
    print(smi, flush=True)
    chip_smoke.emit({"ok": True, "device": torch.cuda.get_device_name(0), "equal_to": forms[0][0]})


if __name__ == "__main__":
    main()
