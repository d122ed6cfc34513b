"""Device operations of the Groth16 stack's plain paths, on one card.

    python3 zprize_wasm_msm_tpu_torch/csrc/diag/count_launches.py

Counts what chip_smoke.py's ``poly``, ``groth16`` and ``in_group``
phases time but do not count: the device operations (kernels,
copies, fills: torch.profiler's CUDA activity, chip_smoke.device_ops) of
one call each of the poly helpers at 2^16, ``group_fft`` / ``group_ifft``
on 16 BLS12-381 G1 points, ``in_group_affine`` on 2^10 G1 and G2 points
and ``groth16.verify`` with two public inputs on BLS12-381 and BN254, on
the inputs those phases make (the same makers, fixed seeds), each checked
as there.  Each call is made once before it is counted, so the constant
caches are filled, and its host-clock seconds under the profiler are
printed beside the count (a profiled call takes about twice as long).
Prints one JSON line a call and the card's name and power limit.  Needs a
CUDA card and nvcc (the inversion and K5 kernels are built at first use).
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def main() -> None:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.models import groth16
    from zprize_wasm_msm_tpu_torch.models.curves import bls12_381, bls12_381_g2, bn254, bn254_g2
    from zprize_wasm_msm_tpu_torch.ops.curve import group
    from zprize_wasm_msm_tpu_torch.ops.poly import applykey, fft as fft_mod, pedersen, pol, qap

    if not torch.cuda.is_available():
        sys.exit("count_launches: no CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)

    def count(name, fn, **extra):
        fn()
        t = time.perf_counter()
        out, ops = cs.device_ops(fn)
        print(json.dumps({"call": name, "device_ops": ops,
                          "s_under_profiler": time.perf_counter() - t, **extra}), flush=True)
        return out

    ctx = Z.build_bls12381()
    fr = ctx.fr
    n = 1 << 16
    b1, b2 = cs._fr_limbs(fr, n, rng, dev), cs._fr_limbs(fr, n, rng, dev)
    fi = cs._fr_limbs(fr, 2, rng, dev)
    first, inc = fi[:, 0].contiguous(), fi[:, 1].contiguous()
    mat = torch.as_tensor(rng.integers(0, 2, n), device=dev)
    con = torch.as_tensor(rng.integers(0, n // 16, n), device=dev)
    pos = torch.arange(n, device=dev) % 16
    for name, fn in (
        ("fft_join", lambda: fft_mod.fft_join(fr, b1, b2, first, inc)),
        ("fft_mix", lambda: fft_mod.fft_mix(fr, b1, 4)),
        ("fft_final", lambda: fft_mod.fft_final(fr, b1, first)),
        ("fft_join_ext", lambda: fft_mod.fft_join_ext(fr, b1, b2, first, inc, 16)),
        ("fft_join_ext_inv", lambda: fft_mod.fft_join_ext_inv(fr, b1, b2, first, inc, 16)),
        ("prepare_lagrange_evaluation",
         lambda: fft_mod.prepare_lagrange_evaluation(fr, b1, b2, first, inc, 16)),
        ("batch_apply_key_fr", lambda: applykey.batch_apply_key_fr(fr, b1, first, inc)),
        ("build_abc", lambda: qap.build_abc(fr, mat, con, b1, b2, n // 16)),
        ("construct_lc", lambda: pol.construct_lc(fr, b1, pos, b2, 16)),
    ):
        count(name, fn, n=n)
    oc = cs.oracle_of(bls12_381)
    table = pedersen.make_base_table(bls12_381, [oc.mul(oc.g, 5), oc.mul(oc.g, 7)], dev)
    bits = torch.as_tensor(rng.integers(0, 2, size=(48, 256)), device=dev)
    count("pedersen_hash", lambda: pedersen.pedersen_hash(bls12_381, bits, table, chunk_size=8), messages=256)

    # the group FFT on 16 points k_i G and back
    ks = [int.from_bytes(rng.bytes(32), "little") % fr.q for _ in range(16)]
    pts = group.from_affine(bls12_381, ctx.points_to_device([oc.mul(oc.g, k) for k in ks]))
    G = count("group_fft", lambda: ctx.group_fft(pts), n=16)
    back = count("group_ifft", lambda: fft_mod.group_ifft(bls12_381, G), n=16)
    ax, ay = group.to_affine(bls12_381, back)
    if not (torch.equal(ax, pts[0]) and torch.equal(ay, pts[1])):
        sys.exit("count_launches: group_ifft(group_fft(P)) != P")

    # subgroup checks on 2^10 multiples of the generator
    for curve in (bls12_381, bls12_381_g2):
        c = Z.build_curve(curve)
        o = cs.oracle_of(curve)
        seeds = [o.mul(o.g, int(m)) for m in rng.integers(1, 1 << 62, size=4)]
        P = c.points_to_device([seeds[i % 4] for i in range(1 << 10)])
        ok = count(f"in_group_affine {curve.name}", lambda: c.in_group_affine(P), n=1 << 10)
        if not bool(ok.all()):
            sys.exit(f"count_launches: {curve.name}: a multiple of G outside the subgroup")

    # a verify, two public inputs
    spec = importlib.util.spec_from_file_location("_torch_groth16", ROOT / "tests" / "_torch_groth16.py")
    helper = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helper)
    for g1c, g2c in ((bls12_381, bls12_381_g2), (bn254, bn254_g2)):
        c1, c2 = Z.build_curve(g1c), Z.build_curve(g2c)
        vk, proof, publics, _, _ = helper.make_instance(rng, 2, g1c, g2c)
        ok = count(f"groth16.verify {g1c.name}", lambda: groth16.verify(c1, c2, vk, proof, publics))
        if ok is not True:
            sys.exit(f"count_launches: {g1c.name}: a valid proof is rejected")

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
