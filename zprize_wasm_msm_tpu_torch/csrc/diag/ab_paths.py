"""A/B of whole checkouts on the MSM paths of chip_smoke.py, on one card.

    python3 zprize_wasm_msm_tpu_torch/csrc/diag/ab_paths.py \\
        --checkout old=OLD_CHECKOUT --checkout new=. [--rounds 2] [--reps 3]

Each ``--checkout NAME=DIR`` names the root of a checkout (for instance an
unpacked ``git archive`` of another commit).  Every round starts one child
process a checkout, in order on even rounds and reversed on odd ones (old,
new, new, old at two rounds).  A child imports the package from its
checkout (its kernels built into DIR/build at first use, so a checkout's
first child includes its build), makes its inputs with this checkout's
chip_smoke.py helpers from fixed seeds (BLS12-381 G1 and G2, 2^20 bases,
full scalars), runs each path once against the oracle, then times it
``--reps`` times: host clock around ``ctx.msm`` ending in a synchronize,
as chip_smoke.py's ``msm_s``, and around ``ctx.result_to_affine`` of each
result (its first call, after the path's first MSM, apart).  Paths: full (use_glv=False, max_bits=255),
A (the default), B (c=10), G2 (build_curve(bls12_381_g2).msm) and
G2-sorted (c=10).  Prints one JSON line a child, then one a checkout
(best and median of every path over its children) and the card's name and
power limit.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def child(checkout: str, reps: int) -> None:
    """One checkout's paths; prints {path: [seconds, ...]} as one JSON line."""
    sys.path.insert(0, checkout)
    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("smoke_helpers", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.models.curves import bls12_381_g2

    smoke.check(Path(Z.__file__).resolve().is_relative_to(Path(checkout).resolve()),
                f"imported {Z.__file__}, not the checkout's package")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    g1 = Z.build_bls12381()
    P1, k1, e1 = smoke.bases_and_scalars(g1, smoke.LOG2N, np.random.default_rng(smoke.SEED), dev)
    g2 = Z.build_curve(bls12_381_g2)
    P2, k2, e2 = smoke.bases_and_scalars(g2, smoke.LOG2N, np.random.default_rng(smoke.SEED + 4), dev)
    paths = {
        "full": (g1, e1, lambda: g1.msm(P1, k1, use_glv=False, max_bits=255)),
        "A": (g1, e1, lambda: g1.msm(P1, k1)),
        "B": (g1, e1, lambda: g1.msm(P1, k1, c=smoke.C_SORTED)),
        "G2": (g2, e2, lambda: g2.msm(P2, k2)),
        "G2-sorted": (g2, e2, lambda: g2.msm(P2, k2, c=smoke.C_SORTED)),
    }
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    out = {"checkout": checkout, "setup_s": None}
    for name, (ctx, expected, run) in paths.items():
        res = run()
        got, first_s = timed(lambda: ctx.result_to_affine(res))
        smoke.check(got == expected, f"{checkout}: path {name} misses the oracle")
        if out["setup_s"] is None:
            out["setup_s"] = time.perf_counter() - t0  # the build and the inputs
        times, to_affine = [], []
        for _ in range(reps):
            res, s = timed(run)
            times.append(s)
            to_affine.append(timed(lambda: ctx.result_to_affine(res))[1] * 1e3)
        out[name] = times
        out[name + ":result_to_affine_ms"] = {"first": first_s * 1e3, "runs": to_affine}
    print(json.dumps(out), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--checkout", action="append", metavar="NAME=DIR")
    parser.add_argument("--rounds", type=int, default=2, help="rounds of turns (each checkout once a round)")
    parser.add_argument("--reps", type=int, default=3, help="timed runs of each path in a child")
    parser.add_argument("--child", metavar="DIR", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        child(args.child, args.reps)
        return
    forms = [spec.split("=", 1) for spec in args.checkout]
    runs = {name: [] for name, _ in forms}
    for r in range(args.rounds):
        for name, path in (forms if r % 2 == 0 else forms[::-1]):
            proc = subprocess.run([sys.executable, __file__, "--child", str(Path(path).resolve()),
                                   "--reps", str(args.reps)], capture_output=True, text=True)
            if proc.returncode:
                sys.stderr.write(proc.stderr[-4000:])
                sys.exit(f"ab_paths: the child of {name} failed (exit {proc.returncode})")
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"round": r, "name": name, **line}), flush=True)
            runs[name].append(line)
    for name, lines in runs.items():
        summary = {}
        for path in ("full", "A", "B", "G2", "G2-sorted"):
            times = [t for line in lines for t in line[path]]
            rta = [t for line in lines for t in line[path + ":result_to_affine_ms"]["runs"]]
            summary[path] = {"best_s": min(times), "median_s": statistics.median(times), "runs": len(times),
                             "result_to_affine_ms": {
                                 "first": [line[path + ":result_to_affine_ms"]["first"] for line in lines],
                                 "median": statistics.median(rta), "best": min(rta)}}
        print(json.dumps({"checkout": name, **summary}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)


if __name__ == "__main__":
    main()
