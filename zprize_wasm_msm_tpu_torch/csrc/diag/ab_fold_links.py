"""A/B of the window fold's links over Fq2 on one card: builds of check.cu
timed in turns.

    python3 zprize_wasm_msm_tpu_torch/csrc/diag/ab_fold_links.py \\
        --form old=OLD_CHECKOUT/zprize_wasm_msm_tpu_torch/csrc \\
        --form new=zprize_wasm_msm_tpu_torch/csrc \\
        [--form NAME=CSRC:EDIT[,EDIT...]] [--reps 3]

Each ``--form`` is a directory of kernel sources, with edits of
ab_fq2_reductions.EDITS after a colon (an edited form is a copy under
``build/ab/NAME/csrc``); its ``check.cu`` is built with the package's nvcc
flags (all forms at once, ab_fq2_sweeps.build_forms).  On two points of
BLS12-381 G2 (3b = 12 (1 + u)) and of BN254 G2 (3b a full Fq2 element),
made by the current package, each form times chains of 500 links
(``zp_group_chain``, as device_check.group_chain): par.cuh's level-parallel
Fq2 doubling and addition on one warp (``double_coop``, ``add_coop``) and,
where the build has them, the fold's links of fold2.cuh in both forms
(``*_fold2_warps``, ``*_fold2_lane``), each with b3k = fold_b3k (3b t by
additions where 3b = k (1 + u)) and with b3k = 0 (the level of products by
3b, which every build took before).
Forms run in order on even rounds and reversed on odd ones; every chain's
point must equal the first form's.  Prints one JSON line a form (µs a
link, each round) and the card's name and power limit.  Needs a CUDA card
and nvcc (CUDA_HOME, default /usr/local/cuda).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from ab_fq2_reductions import edited  # noqa: E402
from ab_fq2_sweeps import build_forms  # noqa: E402
from zprize_wasm_msm_tpu_torch import _build  # noqa: E402

#: zp_group_chain's ops (check.cu), by name
OPS = {"double_coop": 2, "add_coop": 3, "double_fold2_warps": 5, "add_fold2_warps": 6,
       "double_fold2_lane": 7, "add_fold2_lane": 8}
REPS = 500


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--form", action="append", required=True, metavar="NAME=CSRC[:EDITS]")
    parser.add_argument("--reps", type=int, default=3, help="rounds of turns (each form once a round)")
    args = parser.parse_args()
    chip_smoke.check(torch.cuda.is_available(), "no CUDA device")
    forms = []
    for spec in args.form:
        name, rest = spec.split("=", 1)
        csrc, _, edits = rest.partition(":")
        forms.append((name, edited(name, str(Path(csrc).resolve()), edits), edits))

    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.models.curves import bls12_381_g2, bn254_g2
    from zprize_wasm_msm_tpu_torch.ops.curve import group
    from zprize_wasm_msm_tpu_torch.ops.msm import _launch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs, _ = build_forms(forms, ("check",))
    dev = torch.device("cuda")
    points = {}
    for curve in (bls12_381_g2, bn254_g2):
        (X, Y), _, _ = chip_smoke._make_bases(Z.build_curve(curve), 2, np.random.default_rng(1), dev)
        P = group.from_affine(curve, (X, Y))
        points[curve.name] = tuple(_launch.pack_point(tuple(x[:, i : i + 1].contiguous() for x in P))
                                   for i in (0, 1))
    argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int]
                + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

    def chains(csrc):
        """{key: run(reps) -> chain's point}: the links this build has."""
        fn = libs[csrc]["check"].zp_group_chain
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        has_fold = "fold2_op_kernel" in (Path(csrc) / "check.cu").read_text()
        out = {}
        for curve in (bls12_381_g2, bn254_g2):
            pw, qw = points[curve.name]
            consts = _build.curve_consts(curve).ctypes.data_as(ctypes.c_void_p)
            b3ks = (_build.fold_b3k(curve), 0) if _build.fold_b3k(curve) else (0,)
            for op, code in OPS.items():
                if "fold2" in op and not has_fold:
                    continue
                for b3k in b3ks:
                    res = torch.empty_like(pw)

                    def run(reps, curve=curve, consts=consts, code=code, b3k=b3k, pw=pw, qw=qw, res=res):
                        err = fn(curve.fq.n_words, 2, consts, b3k, code, _launch.ptr(pw), _launch.ptr(qw),
                                 _launch.ptr(res), reps, 1, _launch.stream_ptr())
                        _build.check_launch(err, "group_chain")
                        return res

                    out[f"{curve.name} {op} b3k={b3k}"] = run
        return out

    runs = {name: chains(csrc) for name, csrc, _ in forms}
    ref = {}
    for name, _, _ in forms:  # warm-up and the cross-form check
        for key, run in runs[name].items():
            got = run(REPS).clone()
            torch.cuda.synchronize()
            curve = bls12_381_g2 if key.startswith(bls12_381_g2.name) else bn254_g2
            point = _launch.unpack_point(got, (1,))
            ref.setdefault(key.split(" b3k")[0], point)
            e = chip_smoke.affine_err(curve, point, ref[key.split(" b3k")[0]])
            chip_smoke.check(e == 0, f"{name}: {key} differs (max |err| {e})")
    times = {name: {key: [] for key in runs[name]} for name, _, _ in forms}
    for r in range(args.reps):
        for name, _, _ in (forms if r % 2 == 0 else forms[::-1]):
            for key, run in runs[name].items():
                _, ms = chip_smoke.sync_ms(lambda: run(REPS))
                times[name][key].append(ms / REPS * 1e3)
    for name, csrc, edits in forms:
        chip_smoke.emit({"form": name, "csrc": csrc, "edits": edits,
                         "link_us_mean": {k: sum(v) / len(v) for k, v in times[name].items()},
                         "link_us_rounds": times[name]})
    print(smi, flush=True)
    chip_smoke.emit({"ok": True, "device": torch.cuda.get_device_name(0), "equal_to": forms[0][0]})


if __name__ == "__main__":
    main()
