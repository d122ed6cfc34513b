"""The plain field core's two forms against each other, on one device.

    python3 zprize_wasm_msm_tpu_torch/csrc/diag/ab_plain_core.py [--device cuda|cpu] [--reps 5] [--max-n N]

ops/field/mont.py has a row form (L row updates, L reduction rounds, the
serial carry pass over limb pairs) and, from mont._WIDE_FROM limbs, a wide
form (one convolution, the reduction as two products by constants, the
parallel carry pass).  This script times, on the device named:
  carry:    mont._resolve_serial against mont._resolve_parallel on
            (K, n) limbs below 2^41, K = 24, 26 (the widest accumulators
            below the gate), 49, 97 (MNT6753's), n = 16, 1024, 65536;
  product:  mont.mont_mul in each form (mont._WIDE_FROM moved past or
            below the width) at L = 24 (BLS12-381) and 48 (MNT6753), the
            same n, the two forms' words compared;
  miller:   the MNT6 Miller loop on four columns at 3 and 7 steps in each
            form; a step's seconds (the difference over 4 steps) and the
            376-step loop they imply (device operations too on a card,
            torch.profiler's CUDA activity as chip_smoke.device_ops);
  add_temporaries: the peak bytes one group.add allocates on 256 points,
            over a point's bytes, on BLS12-381 G1 / G2 and MNT6753 G1 /
            G2, with mont's parts as they are and with the 753-bit
            products in parts of 64 elements (as a large batch's parts are
            a small share of it: pippenger.ADD_TEMP_POINTS); on the CPU by
            tracking every tensor the add's operations return, on a card
            by the allocator's peak.
Host-clock ms, each call ending in a synchronize on a card, best of
--reps.  Prints one JSON line a section, then on a card its name and power
limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--max-n", type=int, default=65536, help="the largest batch timed")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import zprize_wasm_msm_tpu_torch as Z
    from zprize_wasm_msm_tpu_torch.models import curves
    from zprize_wasm_msm_tpu_torch.ops.curve import group
    from zprize_wasm_msm_tpu_torch.ops.field import mont
    from zprize_wasm_msm_tpu_torch.ops.pairing import mnt6

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        sys.exit("ab_plain_core: no CUDA device (pass --device cpu)")
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def best_ms(fn, reps=args.reps):
        out, best = None, None
        for _ in range(reps):
            sync()
            t = time.perf_counter()
            out = fn()
            sync()
            ms = (time.perf_counter() - t) * 1e3
            best = ms if best is None else min(best, ms)
        return out, best

    def forms(wide):
        """mont._WIDE_FROM for the wide form (every width) or the row form."""
        return 0 if wide else 1 << 30

    gen = torch.Generator().manual_seed(3)
    sizes = [n for n in (16, 1024, 65536) if n <= args.max_n]
    carry = []
    for K in (24, 26, 49, 97):
        for n in sizes:
            x = torch.randint(-(1 << 41) + 1, 1 << 41, (K, n), generator=gen).to(dev)
            a, ms_s = best_ms(lambda: mont._resolve_serial(x.clone()))
            b, ms_p = best_ms(lambda: mont._resolve_parallel(x.clone(), 41))
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            carry.append({"K": K, "n": n, "serial_ms": ms_s, "parallel_ms": ms_p})
    print(json.dumps({"carry": carry}), flush=True)

    product = []
    saved, saved_parts = mont._WIDE_FROM, mont._PART_BYTES
    try:
        for name in ("bls12_381", "mnt6753"):
            fq = getattr(curves, name).fq
            for n in sizes:
                a = torch.randint(0, 1 << 16, (fq.n_limbs, n), generator=gen)
                a[-1] = 0  # below q
                a = a.to(dev)
                b = a.roll(1, dims=1)
                row = {"field": name, "L": fq.n_limbs, "n": n}
                words = []
                for form in ("rows", "wide"):
                    mont._WIDE_FROM = forms(form == "wide")
                    out, row[f"{form}_ms"] = best_ms(lambda: mont.mont_mul(fq, a, b))
                    words.append(out)
                assert torch.equal(words[0], words[1]), f"{name}: the forms' words differ"
                product.append(row)
    finally:
        mont._WIDE_FROM = saved
    print(json.dumps({"product": product}), flush=True)

    ctx1 = Z.build_curve(curves.mnt6753, device=dev)
    ctx2 = Z.build_curve(curves.mnt6753_g2, device=dev)
    ps = ctx1._pairing[1]
    g1 = (curves.mnt6753.gx, curves.mnt6753.gy)
    g2 = (curves.mnt6753_g2.gx, curves.mnt6753_g2.gy)
    P = ctx1.points_to_device([g1] * 4)
    Q = ctx2.points_to_device([g2] * 4)
    short = lambda e: dataclasses.replace(ps, loop_count=e)  # noqa: E731
    miller = {"columns": 4, "loop_steps": ps.loop_count.bit_length() - 1}
    try:
        for form in ("rows", "wide"):
            mont._WIDE_FROM = forms(form == "wide")
            mnt6.miller_loop(short(8), P, Q)  # the constants' caches
            fa, ms_a = best_ms(lambda: mnt6.miller_loop(short(8), P, Q), 2)
            fb, ms_b = best_ms(lambda: mnt6.miller_loop(short(128), P, Q), 2)
            step_s = (ms_b - ms_a) / 4 / 1e3
            rec = {"step_s": step_s, "loop_s_implied": ms_a / 1e3 + (miller["loop_steps"] - 3) * step_s}
            if on_card:
                import chip_smoke

                ops_a = chip_smoke.device_ops(lambda: mnt6.miller_loop(short(8), P, Q))[1]
                ops_b = chip_smoke.device_ops(lambda: mnt6.miller_loop(short(128), P, Q))[1]
                rec["step_device_ops"] = (ops_b - ops_a) // 4
            miller[form] = rec
            miller.setdefault("words", []).append(fb)
    finally:
        mont._WIDE_FROM = saved
    words = miller.pop("words")
    assert torch.equal(words[0], words[1]), "the Miller loop's words differ between the forms"
    print(json.dumps({"miller": miller}), flush=True)

    temps = {}
    n = 256
    small_parts = 8 * 48 * 97 * 64  # a 753-bit product's temporaries for 64 elements
    try:
        for parts in ("default", "64_elements"):
            mont._PART_BYTES = saved_parts if parts == "default" else small_parts
            for name in ("bls12_381", "bls12_381_g2", "mnt6753", "mnt6753_g2"):
                curve = getattr(curves, name)
                F = curve.field
                Pt = group.from_affine(curve, (F.const(curve.gx, (n,), dev), F.const(curve.gy, (n,), dev)))
                Qt = group.double(curve, Pt)
                point_bytes = 3 * F.elem_len * 8 * n
                if on_card:
                    sync()
                    held = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    r = group.add(curve, Pt, Qt)
                    sync()
                    peak = torch.cuda.max_memory_allocated() - held
                else:
                    with _PeakBytes() as tracker:
                        r = group.add(curve, Pt, Qt)
                    peak = tracker.peak
                del r
                temps.setdefault(parts, {})[name] = {"points": n, "peak_bytes": peak,
                                                     "point_bytes_times": peak / point_bytes}
    finally:
        mont._PART_BYTES = saved_parts
    print(json.dumps({"add_temporaries": temps, "device": str(dev), "products_in_parts_of_bytes": {
        "default": saved_parts, "64_elements": small_parts}}), flush=True)
    if on_card:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)


def _dispatch_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    return TorchDispatchMode


class _PeakBytes(_dispatch_mode()):
    """The peak of the bytes held by tensors that operations return while
    the mode is on: a storage counts from the first tensor on it that an
    operation returns until the last such tensor is freed (what the
    operations allocate and free inside themselves is not seen)."""

    def __init__(self):
        super().__init__()
        self.live, self.cur, self.peak = {}, 0, 0

    def _release(self, key):
        entry = self.live.get(key)
        if entry is not None:
            entry[1] -= 1
            if entry[1] == 0:
                self.cur -= entry[0]
                del self.live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        import torch
        from torch.utils._pytree import tree_flatten

        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr():
                storage = t.untyped_storage()
                key = storage.data_ptr()
                entry = self.live.get(key)
                if entry is None:
                    entry = self.live[key] = [storage.nbytes(), 0]
                    self.cur += entry[0]
                    self.peak = max(self.peak, self.cur)
                entry[1] += 1
                weakref.finalize(t, self._release, key)
        return out


if __name__ == "__main__":
    main()
