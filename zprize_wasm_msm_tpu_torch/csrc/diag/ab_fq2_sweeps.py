"""A/B of whole builds of the two Fq2 sweeps (K1 and K7 over Fq2) on one card.

    python3 zprize_wasm_msm_tpu_torch/csrc/diag/ab_fq2_sweeps.py \\
        --form old=OLD_CHECKOUT/zprize_wasm_msm_tpu_torch/csrc:1024 \\
        --form new=zprize_wasm_msm_tpu_torch/csrc:fit [--reps 4] [--sass]

Each ``--form NAME=CSRC[:LANES]`` names a directory of kernel sources (for
instance ``csrc/`` of an unpacked ``git archive`` of another commit) and the
lanes of its K1 launch: a number, or ``fit`` (pippenger.fit_lanes at that
build's own residency).  Every form's ``bucket.cu`` and ``sorted.cu`` are
built with the package's nvcc flags (all at once) into ``build/ab/NAME/``,
then, on path G2's data (BLS12-381 G2, 2^20 bases and scalars from the seed
of chip_smoke.py, c = 6 for K1, the sorted stream at c = 10 for K7), each
form's two launches are timed with CUDA events in turns: forms in order on
even rounds and in reverse order on odd ones (A B B A ...).  Every form's
result must equal the first form's: K7's entries bit for bit, K1's buckets
as affine points after the current tree's lane reduction (forms may run
other lane counts).  Prints one JSON line per form (registers, local bytes,
shared bytes a block, resident warps per SM, the times) and the card's name
and power limit; ``--sass`` also writes each library's SASS beside it and
prints, per Fq2 function at NW = 12, its instruction count and its CALL,
LDL and STL counts.  Needs a CUDA card, nvcc and cuobjdump (CUDA_HOME,
default /usr/local/cuda).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from zprize_wasm_msm_tpu_torch import _build  # noqa: E402

STEMS = ("bucket", "sorted")


def build_forms(forms, stems=STEMS, only=None):
    """nvcc every (form, stem) at once, with the package's flags for the
    stem (``only``: {csrc: stems} where a form needs fewer); returns
    {csrc: {stem: loaded lib}}."""
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    procs, libs = {}, {}
    for name, csrc, _ in forms:
        if csrc in libs:
            continue
        libs[csrc] = {}
        out = ROOT / "build" / "ab" / name
        out.mkdir(parents=True, exist_ok=True)
        for stem in (only or {}).get(csrc, stems):
            so = out / f"libzp_{stem}.so"
            log = open(out / f"nvcc_{stem}.log", "w")
            cmd = [f"{cuda}/bin/nvcc", *_build.NVCC_FLAGS, *_build.STEM_FLAGS.get(stem, ()), "-o", str(so),
                   str(Path(csrc) / f"{stem}.cu")]
            procs[(csrc, stem)] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), so, out)
    for (csrc, stem), (proc, so, out) in procs.items():
        chip_smoke.check(proc.wait() == 0, f"nvcc failed on {csrc}/{stem}.cu: see {out}/nvcc_{stem}.log")
        libs[csrc][stem] = ctypes.CDLL(str(so))
    return libs, {csrc: out for (csrc, _), (_, _, out) in procs.items()}


def sass_stats(so: Path, out: Path):
    """cuobjdump's SASS of one library into out, and for each Fq2 kernel at
    NW = 12 (mangled names carrying Li12E) its pieces: the kernel's own code,
    then each out-of-line function it calls (cuobjdump lists them after it;
    a piece starts at every CALL target), with instructions, CALL, LDL, STL,
    IMAD (all forms), IADD3 and the highest register named."""
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    text = subprocess.run([f"{cuda}/bin/cuobjdump", "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    (out / f"{so.stem}.sass").write_text(text)
    listing, fn = collections.defaultdict(list), None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.match(r"\s+/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*)", line)
        if m and fn and "Li12E" in fn and "2_kernel" in fn:
            listing[fn].append((int(m.group(1), 16), m.group(3).split(".")[0], m.group(4)))
    stats = {}
    for fn, ins in listing.items():
        starts = sorted({0} | {int(o.split()[0], 16) for _, op, o in ins if op == "CALL"})
        pieces = []
        for lo, hi in zip(starts, starts[1:] + [1 << 62]):
            h = collections.Counter(op for a, op, _ in ins if lo <= a < hi)
            regs = [int(r) for a, _, o in ins if lo <= a < hi for r in re.findall(r"\bR(\d+)\b", o)]
            pieces.append({"at": hex(lo), "instructions": sum(h.values()),
                           **{k: h[k] for k in ("CALL", "LDL", "STL", "IMAD", "IADD3")},
                           "max_register": max(regs, default=0)})
        stats[fn] = pieces
    return stats


def info(lib, entry):
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    out = (ctypes.c_int * 4)()
    _build.check_launch(fn(12, 2, ctypes.cast(out, ctypes.c_void_p)), entry)
    return dict(zip(("registers", "local_bytes", "shared_bytes", "blocks_per_sm"), out))


def event_ms(fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--form", action="append", required=True, metavar="NAME=CSRC[:LANES]")
    parser.add_argument("--reps", type=int, default=4, help="rounds of turns (each form once a round)")
    parser.add_argument("--sass", action="store_true", help="also dump and count each build's SASS")
    args = parser.parse_args()
    chip_smoke.check(torch.cuda.is_available(), "no CUDA device")
    forms = []
    for spec in args.form:
        name, rest = spec.split("=", 1)
        csrc, _, lanes = rest.partition(":")
        forms.append((name, str(Path(csrc).resolve()), lanes or "1024"))

    from zprize_wasm_msm_tpu_torch import build_curve
    from zprize_wasm_msm_tpu_torch.models.curves import bls12_381_g2 as g2
    from zprize_wasm_msm_tpu_torch.ops.curve import group
    from zprize_wasm_msm_tpu_torch.ops.msm import _launch, pippenger, pl_reduce, pl_sorted, windows

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs, outs = build_forms(forms)
    chip_smoke.emit({"built": {n: c for n, c, _ in forms}, "build_s": time.perf_counter() - t0})
    res = {}
    for name, csrc, _ in forms:
        res[name] = {"k1": info(libs[csrc]["bucket"], "zp_bucket_sweep_info"),
                     "k7": info(libs[csrc]["sorted"], "zp_sorted_sweep_info")}
        if args.sass:
            res[name]["sass"] = {stem: sass_stats(outs[csrc] / f"libzp_{stem}.so", outs[csrc]) for stem in STEMS}

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctx = build_curve(g2)
    rng = np.random.default_rng(chip_smoke.SEED + 4)  # chip_smoke.py's G2 data
    (X, Y), scalars, _ = chip_smoke.bases_and_scalars(ctx, chip_smoke.LOG2N, rng, dev)
    n = X.shape[1]
    consts = _build.curve_consts(g2).ctypes.data_as(ctypes.c_void_p)
    NW, EW = g2.fq.n_words, 2 * g2.fq.n_words

    # K1 at c = 6: W = 44, B = 32, each form at its own lanes
    c1 = 6
    digits = windows.signed_window_digits(scalars, c1, 256)
    W, B = digits.shape[0], 1 << (c1 - 1)
    words = _launch.pack_point((X, Y))
    lanes = {}
    for name, csrc, spec in forms:
        resident = res[name]["k1"]["blocks_per_sm"] * 32 * sms
        lanes[name] = pippenger.fit_lanes(W, n, resident) if spec == "fit" else int(spec)

    def k1(name, csrc):
        T = lanes[name]
        pad = (-n) % T
        d = torch.cat([digits, digits.new_zeros((W, pad))], 1).contiguous()
        xw = torch.cat([words[0], words[0].new_zeros((EW, pad))], 1).contiguous()
        yw = torch.cat([words[1], words[1].new_zeros((EW, pad))], 1).contiguous()
        state = torch.empty((W, T, B, 3 * EW), dtype=torch.int32, device=dev)
        fn = libs[csrc]["bucket"].zp_bucket_sweep
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

        def run():
            err = fn(NW, 2, consts, _launch.ptr(d), _launch.ptr(xw), _launch.ptr(yw), _launch.ptr(state),
                     W, T, n + pad, B, _launch.stream_ptr())
            _build.check_launch(err, f"{name} bucket_sweep")
            return state

        return run

    # K7 at c = 10 on the stream its stages make
    c7, chunks = 10, pl_sorted.GRID
    d7 = windows.signed_window_digits(scalars, c7, 256)
    perm, skey, meta = pl_sorted.sort_runs(d7, c7, chunks)
    slot, seg = pl_sorted.compact_index(skey, meta, c7, chunks)
    K = seg.shape[1]
    W7 = perm.shape[0]
    pts = _launch.point_words((X, Y))
    perm, meta, slot = perm.contiguous(), meta.contiguous(), slot.contiguous()

    def k7(name, csrc):
        out = _launch.pack_point(group.zero(g2, (W7 * K,), dev))
        fn = libs[csrc]["sorted"].zp_sorted_sweep
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

        def run():
            err = fn(NW, 2, consts, _launch.ptr(pts), _launch.ptr(perm), _launch.ptr(meta),
                     _launch.ptr(slot), _launch.ptr(out), W7, chunks, n // chunks, K, _launch.stream_ptr())
            _build.check_launch(err, f"{name} sorted_sweep")
            return out

        return run

    runs = {name: (k1(name, csrc), k7(name, csrc)) for name, csrc, _ in forms}
    times = {name: {"k1_ms": [], "k7_ms": []} for name, _, _ in forms}
    ref1 = ref7 = None
    for name, _, _ in forms:  # warm-up and the cross-form check
        state = runs[name][0]()
        buckets = pl_reduce._lane_reduce_state(g2, state)
        out7 = runs[name][1]().clone()
        torch.cuda.synchronize()
        if ref1 is None:
            ref1, ref7 = buckets, out7
        else:
            e1 = chip_smoke.affine_err(g2, buckets, ref1)
            chip_smoke.check(e1 == 0, f"{name}: K1 buckets differ from {forms[0][0]}'s (max |err| {e1})")
            chip_smoke.check(bool((out7 == ref7).all()), f"{name}: K7 entries differ from {forms[0][0]}'s")
        del state, buckets, out7
    for r in range(args.reps):
        for name, _, _ in (forms if r % 2 == 0 else forms[::-1]):
            for key, run in zip(("k1_ms", "k7_ms"), runs[name]):
                times[name][key].append(event_ms(run)[1])
    for name, csrc, _ in forms:
        resident = {k: res[name][k]["blocks_per_sm"] for k in ("k1", "k7")}
        T = lanes[name]
        rnd = -(-W * T // (resident["k1"] * 32 * sms))
        chip_smoke.emit({"form": name, "csrc": csrc, "k1_lanes": T, "k1_waves": W * T / (resident["k1"] * 32 * sms),
                         "k1_rounds": rnd, "k1_steps": -(-n // T), **res[name], **times[name],
                         "k1_best_ms": min(times[name]["k1_ms"]), "k7_best_ms": min(times[name]["k7_ms"])})
    print(smi, flush=True)
    chip_smoke.emit({"ok": True, "device": torch.cuda.get_device_name(0), "equal_to": forms[0][0]})


if __name__ == "__main__":
    main()
