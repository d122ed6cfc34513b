"""A/B of whole builds of the MSM's reductions on one card: the lane
reduction (K4), the segmented scan (K8) and the collapse (K2), each over Fq2
and over Fq, the window fold over Fq2 (K3) and the batched Montgomery
square (K6).

    python3 zprize_wasm_msm_tpu_torch/csrc/diag/ab_fq2_reductions.py \\
        --form old=OLD_CHECKOUT/zprize_wasm_msm_tpu_torch/csrc \\
        --form new=zprize_wasm_msm_tpu_torch/csrc \\
        [--form NAME=CSRC:EDIT[,EDIT...]] [--reps 4]

Each ``--form NAME=CSRC[:EDITS]`` names a directory of kernel sources (for
instance ``csrc/`` of an unpacked ``git archive`` of another commit) and,
after a colon, edits from ``EDITS`` below: each turns one per-field design
choice of these sources off, so that a form measures what the choice is
worth; an edited form is a copy of CSRC under ``build/ab/NAME/csrc``.  Its
``bucket.cu``, ``sorted.cu``, ``reduce.cu`` and ``field_kernels.cu`` are
built with the package's nvcc flags (all forms at once,
ab_fq2_sweeps.build_forms) into ``build/ab/NAME/``; an edited form whose
CSRC is another form's builds only the sources its edits reach and takes
the others from that form.  The inputs are made once by the current package
from chip_smoke.py's seeds:
  * BLS12-381 G2, 2^20 bases and full scalars: K1's state at c = 6 (K4 over
    Fq2) and its bucket sums (K2 over Fq2 at path G2's W = 44, B = 32); the
    sorted engine's pieces at c = 10 (K8 over Fq2) and their dense buckets
    (K2 over Fq2 at path G2-sorted's W = 27, B = 512); the same bases with
    every scalar 1: the skewed stream's pieces (one segment of 1 024);
  * BLS12-381 G1, 2^20 bases and full scalars: the full path's K1 state at
    c = 7 (K4 over Fq) and its bucket sums (K2 over Fq, W = 38, B = 64);
    after the GLV split, the sorted engine's pieces at c = 10 (K8 over Fq at
    path B's shape) and their dense buckets (K2 over Fq at path B's W = 15,
    B = 512); every scalar 1: path B's skewed stream; the bases' X (K6 on
    2^20 elements of Fq);
  * the window sums of both G2 shapes (K3 over Fq2: W = 44, c = 6 and
    W = 27, c = 10), as packed words, the fold's input.
Each form launches K4 at the lanes pl_reduce._reduce_lanes gives its own
residency (zp_lane_reduce_info); K8 as its wrapper does, on the limbs
through ``zp_segscan_limbs`` (given NULL for the kernel count where its
entry takes one), or, where that entry refuses the field, on words through
``zp_segscan`` (the pieces packed before, the sums unpacked after); K2
through ``zp_collapse`` at the run length pl_reduce._collapse_run picks on
this card and, over Fq2, at every run length from 4 to 64 that fits B
(``by_run``); K3 over Fq2 through ``zp_finish``; K6 as each build's public
call made it: on the limbs through ``zp_mont_square`` where that entry
takes limbs, else the packing of the limbs to words, the launch on words
and the unpacking (the parent's ``kernels.mont_square``).  The instructions
of ``mont_square_kernel`` and ``mont_mul_kernel`` at NW = 12 in each
build's SASS (cuobjdump) are counted.
The launches are timed with CUDA events in turns (forms in order on even
rounds, reversed on odd ones); every form's result must equal the first
form's as affine points.  Prints one JSON line per form (residencies,
lanes, times) and the card's name and power limit.  Needs a CUDA card and
nvcc (CUDA_HOME, default /usr/local/cuda).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
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

STEMS = ("bucket", "sorted", "reduce", "field_kernels")
#: edits of a form's sources, each (file, text, replacement, the sources
#: whose code it changes), text and replacement a string or a tuple of them
#: in turn: a design choice turned off
EDITS = {
    # the Fq2 collapse's links inlined at every call site (reduce.cu)
    "inline_links": ("reduce.cu", "links_out_of_line() {\n  return EXT == 2;",
                     "links_out_of_line() {\n  return false;", ("reduce",)),
    # the Fq2 collapse's walk reading each bucket when it reaches it
    "no_prefetch": ("reduce.cu", "walk_prefetch() {\n  return EXT == 2;", "walk_prefetch() {\n  return false;",
                    ("reduce",)),
    # the Fq scan's adds on the carry-chain product instead of the 64-bit rows (sorted.cu)
    "scan_fq_carry_chains": ("sorted.cu", "scan_carry_chains() {\n  return EXT == 2;",
                             "scan_carry_chains() {\n  return true;", ("sorted",)),
    # the Fq2 level-parallel links' 3b t as a level of products where 3b =
    # k (1 + u) (K2's and K3's links over Fq2; par.cuh)
    "b3_product_level": ("par.cuh", "b3_as_additions() {\n  return true;",
                         "b3_as_additions() {\n  return false;", ("reduce",)),
    # the Fq2 fold's links inlined at its call sites (fold2.cuh)
    "fold_inline_links": ("fold2.cuh", ("__noinline__ void fold2_link_double", "__noinline__ void fold2_link_add"),
                          ("__forceinline__ void fold2_link_double", "__forceinline__ void fold2_link_add"),
                          ("reduce",)),
    # the Fq2 fold on one warp, a lane an Fq product (reduce.cu)
    "fold_lane_form": ("reduce.cu", "#define FOLD2_THREADS 96", "#define FOLD2_THREADS 32", ("reduce",)),
    # K6 as fe_mul(x, x) instead of fe_sqr (field_kernels.cu)
    "square_as_product": ("field_kernels.cu", "fe_sqr<NW>(x, x);", "fe_mul<NW>(x, x, x);", ("field_kernels",)),
}


def edited(name: str, csrc: str, edits: str) -> str:
    """A copy of csrc with the named edits applied (csrc itself if none)."""
    if not edits:
        return csrc
    out = ROOT / "build" / "ab" / name / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    for edit in edits.split(","):
        fname, texts, repls, _ = EDITS[edit]
        src = (out / fname).read_text()
        for text, repl in zip(*((x,) if isinstance(x, str) else x for x in (texts, repls))):
            chip_smoke.check(src.count(text) == 1, f"edit {edit}: its text is not once in {fname}")
            src = src.replace(text, repl)
        (out / fname).write_text(src)
    return str(out)


def sass_instructions(so: Path, names=("mont_square_kernel", "mont_mul_kernel")):
    """Instructions (and IMADs of every form) of each named kernel at
    NW = 12 in cuobjdump's SASS of one library."""
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    text = subprocess.run([f"{cuda}/bin/cuobjdump", "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = next((n for n in names if n in m.group(1) and "Li12E" in m.group(1)), None)
            if fn:
                counts[fn] = {"instructions": 0, "IMAD": 0}
            continue
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)", line)
        if m and fn:
            counts[fn]["instructions"] += 1
            counts[fn]["IMAD"] += m.group(2).startswith("IMAD")
    return counts


def lane_info(lib, ext):
    fn = lib.zp_lane_reduce_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = (ctypes.c_int * 4)()
    _build.check_launch(fn(12, ext, 0, ctypes.cast(out, ctypes.c_void_p)), "zp_lane_reduce_info")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "blocks_per_sm"), out))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--form", action="append", required=True, metavar="NAME=CSRC[:EDITS]")
    parser.add_argument("--reps", type=int, default=4, help="rounds of turns (each form once a round)")
    args = parser.parse_args()
    chip_smoke.check(torch.cuda.is_available(), "no CUDA device")
    forms, base_of = [], {}
    for spec in args.form:
        name, rest = spec.split("=", 1)
        csrc, _, edits = rest.partition(":")
        base = str(Path(csrc).resolve())
        forms.append((name, edited(name, base, edits), edits))
        if edits:
            base_of[forms[-1][1]] = base

    from zprize_wasm_msm_tpu_torch import build_bls12381, build_curve
    from zprize_wasm_msm_tpu_torch.models.curves import bls12_381, bls12_381_g2 as g2
    from zprize_wasm_msm_tpu_torch.ops.msm import _launch, glv, pippenger, pl_bucket, pl_reduce, pl_sorted, windows

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    plain = {c for _, c, e in forms if not e}
    only = {c: tuple({st for e in edits.split(",") for st in EDITS[e][3]})
            for _, c, edits in forms if edits and base_of[c] in plain}
    libs, _ = build_forms(forms, STEMS, only)
    for c, base in base_of.items():
        for stem in STEMS:
            libs[c].setdefault(stem, libs[base][stem])
    chip_smoke.emit({"built": {n: [c, e] for n, c, e in forms}, "build_s": time.perf_counter() - t0})
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def sorted_stages(curve, pts, sc, bits):
        d = windows.signed_window_digits(sc, 10, bits)
        perm, skey, meta = pl_sorted.sort_runs(d, 10, pl_sorted.GRID)
        slot, seg = pl_sorted.compact_index(skey, meta, 10, pl_sorted.GRID)
        pieces = pl_sorted.sweep(curve, pts, perm, meta, slot, seg.shape[1], pl_sorted.GRID)
        return pieces, seg

    def dense(curve, pieces, seg):
        return pl_sorted.scatter_dense(curve, pl_sorted.segscan(curve, pieces, seg, pl_sorted.GRID), seg, 10)

    # the inputs, made once by the current package
    ctx = build_curve(g2)
    rng = np.random.default_rng(chip_smoke.SEED + 4)  # chip_smoke.py's G2 data
    (X, Y), scalars, _ = chip_smoke.bases_and_scalars(ctx, chip_smoke.LOG2N, rng, dev)
    n = X.shape[1]
    digits = windows.signed_window_digits(scalars, 6, 256)
    T = pippenger._kernel_lanes(g2, digits.shape[0], n, None, dev)
    words = _launch.pack_point((X, Y))
    state_g2 = pl_bucket._sweep(g2, words[0], words[1], digits, T, 32)
    buckets_g2 = pl_reduce._lane_reduce_state(g2, state_g2)
    del words, digits
    ones = torch.zeros_like(scalars)
    ones[0] = 1
    scan_g2 = {"G2-sorted": sorted_stages(g2, (X, Y), scalars, 256), "skewed": sorted_stages(g2, (X, Y), ones, 256)}
    dense_g2s = dense(g2, *scan_g2["G2-sorted"])
    ctx1 = build_bls12381()
    (X1, Y1), scalars1, _ = chip_smoke.bases_and_scalars(ctx1, chip_smoke.LOG2N,
                                                         np.random.default_rng(chip_smoke.SEED), dev)
    digits1 = windows.signed_window_digits(scalars1, 7, 255)
    T1 = pippenger._kernel_lanes(bls12_381, digits1.shape[0], n, None, dev)
    words1 = _launch.pack_point((X1, Y1))
    state_g1 = pl_bucket._sweep(bls12_381, words1[0], words1[1], digits1, T1, 64)
    buckets_full = pl_reduce._lane_reduce_state(bls12_381, state_g1)
    del words1, digits1
    P2, k2 = glv.preprocess_endomorphism(bls12_381, (X1, Y1), scalars1)
    ones1 = torch.zeros_like(scalars1)
    ones1[0] = 1
    P2s, k2s = glv.preprocess_endomorphism(bls12_381, (X1, Y1), ones1)
    scan_g1 = {"B": sorted_stages(bls12_381, P2, k2, glv.MAX_BITS),
               "skewed": sorted_stages(bls12_381, P2s, k2s, glv.MAX_BITS)}
    dense_b = dense(bls12_381, *scan_g1["B"])
    sq_in = X1  # K6's operand: 2^20 elements of Fq
    del Y1, scalars1, P2, k2, P2s, k2s
    # K3 over Fq2's input: the window sums of both G2 shapes, as words
    sums_words = {case: _launch.pack_point(tuple(x[:, :, None].contiguous() for x in pl_reduce.collapse(g2, bk)))
                  for case, bk in (("G2", buckets_g2), ("G2-sorted", dense_g2s))}
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

    def k8(lib, csrc, curve, pieces, seg):
        W, K = seg.shape
        pieces = tuple(a.contiguous() for a in pieces)
        NW, ext = curve.fq.n_words, curve.ext
        consts = _build.curve_consts(curve).ctypes.data_as(ctypes.c_void_p)
        segc = seg.contiguous()
        fn = lib.zp_segscan_limbs
        fn.restype = ctypes.c_int
        # an entry that reports its kernel count takes one pointer more
        count = [None] if "int* kernels" in (Path(csrc) / "sorted.cu").read_text() else []
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p] * (1 + len(count))
        out = torch.empty((3,) + tuple(pieces[0].shape), dtype=torch.int64, device=dev)

        def limbs():
            return fn(NW, ext, consts, *(_launch.ptr(a) for a in pieces), _launch.ptr(segc), _launch.ptr(out),
                      W, K, *count, _launch.stream_ptr())

        err = limbs()
        if err == 0:
            def run():
                _build.check_launch(limbs(), "segscan_limbs")
                return tuple(out)
            return run
        chip_smoke.check(err == -1 and ext == 1, f"zp_segscan_limbs refused the scan over ext {ext} ({err})")
        wfn = lib.zp_segscan  # the word entry of a form whose limb entry is Fq2 only
        wfn.restype = ctypes.c_int
        wfn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]

        def run():
            P = _launch.pack_point(pieces)
            wout = torch.empty_like(P)
            err = wfn(NW, ext, consts, _launch.ptr(P), _launch.ptr(segc), _launch.ptr(wout), W, K,
                      _launch.stream_ptr())
            _build.check_launch(err, "segscan")
            return _launch.unpack_point(wout, (W, K))

        return run

    def k2(lib, curve, buckets, m=0):
        NW = curve.fq.n_words
        L, W, B = buckets[0].shape
        EW = L // 2
        m = m or pl_reduce._collapse_run(W, B, pl_reduce._collapse_wave_groups(NW, 0))
        bx, by, bz = (t.contiguous() for t in buckets)
        cap = max(1, W * B // m // (pl_reduce.COLLAPSE_THREADS // pl_reduce._collapse_lanes(NW)))
        scratch = torch.empty((3 * EW * W + 2 * 2 * 3 * EW * cap,), dtype=torch.int32, device=dev)
        out = torch.empty((3, L, W), dtype=torch.int64, device=dev)
        fn = lib.zp_collapse
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        consts = _build.curve_consts(curve).ctypes.data_as(ctypes.c_void_p)

        def run():
            err = fn(NW, curve.ext, consts, _build.fold_b3k(curve), _launch.ptr(bx), _launch.ptr(by),
                     _launch.ptr(bz), _launch.ptr(out), _launch.ptr(scratch), W, B, m, _launch.stream_ptr())
            _build.check_launch(err, "collapse")
            return tuple(out)

        return run

    def k3(lib, S, c):
        NW = g2.fq.n_words
        W = S.shape[2]
        out = torch.empty((3, 2 * NW, 1), dtype=torch.int32, device=dev)
        fn = lib.zp_finish
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32] + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        consts = _build.curve_consts(g2).ctypes.data_as(ctypes.c_void_p)

        def run():
            err = fn(NW, 2, consts, _build.fold_b3k(g2), _launch.ptr(S), _launch.ptr(out), W, c,
                     _launch.stream_ptr())
            _build.check_launch(err, "finish")
            return _launch.unpack_point(out, ())

        return run

    def k6(lib, csrc):
        fq = bls12_381.fq
        n1 = sq_in.shape[1]
        fn = lib.zp_mont_square
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
        # the constant block as that tree's field_kernels.cu lays it out
        wide = f"#define ZP_MAX_NW {_build.FIELD_KERNEL_MAX_WORDS}" in \
            (Path(csrc) / "field_kernels.cu").read_text()
        block = _build.field_kernel_consts(fq) if wide else _build.field_consts(fq)
        consts = block.ctypes.data_as(ctypes.c_void_p)
        if "zp_mont_square(int nw, const uint32_t* host_consts, const int64_t* a" in \
                (Path(csrc) / "field_kernels.cu").read_text():
            out = torch.empty_like(sq_in)

            def run():
                _build.check_launch(fn(fq.n_words, consts, _launch.ptr(sq_in), _launch.ptr(out), n1,
                                       _launch.stream_ptr()), "mont_square")
                return (out,)
        else:
            def run():  # the words entry inside its wrapper: pack, launch, unpack
                aw = _launch.pack_point((sq_in,))[0]
                ow = torch.empty_like(aw)
                _build.check_launch(fn(fq.n_words, consts, _launch.ptr(aw), _launch.ptr(ow), n1,
                                       _launch.stream_ptr()), "mont_square")
                return (_launch.unpack_point(ow[None], (n1,))[0],)
        return run

    runs, lanes = {}, {}
    for name, csrc, _ in forms:
        lib_b, lib_s, lib_r, lib_f = (libs[csrc][stem] for stem in STEMS)
        r4g2, lanes[(name, "k4_fq2")] = k4(lib_b, g2, state_g2)
        r4g1, lanes[(name, "k4_fq")] = k4(lib_b, bls12_381, state_g1)
        runs[name] = {
            "k4_fq2_ms": r4g2, "k4_fq_ms": r4g1,
            **{f"k8_fq2_{case}_ms": k8(lib_s, csrc, g2, *ps) for case, ps in scan_g2.items()},
            **{f"k8_fq_{case}_ms": k8(lib_s, csrc, bls12_381, *ps) for case, ps in scan_g1.items()},
            "k2_fq2_G2_ms": k2(lib_r, g2, buckets_g2), "k2_fq2_G2-sorted_ms": k2(lib_r, g2, dense_g2s),
            "k2_fq_full_ms": k2(lib_r, bls12_381, buckets_full), "k2_fq_B_ms": k2(lib_r, bls12_381, dense_b),
            **{f"k2_fq2_{case}_by_run_{m}_ms": k2(lib_r, g2, bk, m)
               for case, bk in (("G2", buckets_g2), ("G2-sorted", dense_g2s)) for m in (4, 8, 16, 32, 64)
               if m <= bk[0].shape[2]},
            "k3_fq2_G2_ms": k3(lib_r, sums_words["G2"], 6), "k3_fq2_G2-sorted_ms": k3(lib_r, sums_words["G2-sorted"], 10),
            "k6_ms": k6(lib_f, csrc),
        }
    ref = {}
    for name, _, _ in forms:  # warm-up and the cross-form check
        for key, run in runs[name].items():
            got = tuple(a.clone() for a in run())
            torch.cuda.synchronize()
            curve = g2 if "fq2" in key else bls12_381
            if key not in ref:
                ref[key] = got
            elif key == "k6_ms":  # limbs
                e = int((got[0] - ref[key][0]).abs().max().item())
                chip_smoke.check(e == 0, f"{name}: k6 differs from {forms[0][0]}'s (max |err| {e})")
            else:
                e = chip_smoke.affine_err(curve, got, ref[key])
                chip_smoke.check(e == 0, f"{name}: {key[:-3]} differs from {forms[0][0]}'s (max |err| {e})")
    del ref
    times = {name: {key: [] for key in runs[name]} for name, _, _ in forms}
    for r in range(args.reps):
        for name, _, _ in (forms if r % 2 == 0 else forms[::-1]):
            for key, run in runs[name].items():
                times[name][key].append(event_ms(run)[1])
    for name, csrc, edits in forms:
        lib_b = libs[csrc]["bucket"]
        chip_smoke.emit({
            "form": name, "csrc": csrc, "edits": edits,
            "k4_fq2": {**lane_info(lib_b, 2), "lanes": lanes[(name, "k4_fq2")]},
            "k4_fq": {**lane_info(lib_b, 1), "lanes": lanes[(name, "k4_fq")]},
            "k6_sass": sass_instructions(Path(libs[csrc]["field_kernels"]._name)),
            **{k.replace("_ms", "_mean_ms"): sum(v) / len(v) for k, v in times[name].items()},
            "runs_ms": times[name],
        })
    print(smi, flush=True)
    chip_smoke.emit({"ok": True, "device": torch.cuda.get_device_name(0), "equal_to": forms[0][0]})


if __name__ == "__main__":
    main()
