"""Naive MSM: per-point double-and-add + tree sum — the differential engine.

Counterpart of zprize_wasm_msm_tpu/ops/msm/naive.py, in the role of the
reference's legacy Pippenger (wasmcurves/src/build_multiexp.js
g1m_multiexpAffine_wasmcurve:251-371): an INDEPENDENT second engine the
optimized pipeline is cross-checked against on random inputs
(test/batchAffine.js:1258-1301).  It shares only the field and group ops
with the bucket engines — not the digit recoding, the bucket accumulation,
the bucket reduction or the window fold — so a fault in any of those
stages cannot cancel out of an engine-against-engine comparison.

Algorithm: k_i * P_i for every point at once by the branch-free
double-and-add ladder (group.times_scalar, a lane per point), then a
log2(N) pairwise tree over the point axis.  O(N * max_bits) group ops:
far more work than Pippenger, all of it batched.  Plain PyTorch on
whatever device the tensors lie on (the JAX package has no kernel here
either); field-generic, so G1 and G2 alike.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..curve import group
from ..curve.spec import CurveSpec


def msm_naive(
    curve: CurveSpec,
    points: Tuple[torch.Tensor, torch.Tensor],
    scalars: torch.Tensor,
    max_bits: Optional[int] = None,
):
    """points: affine (X, Y), each (L, N) Montgomery; scalars: (Ls, N) int64
    16-bit limbs, standard domain.  Returns one projective point (X, Y, Z),
    each (L,)."""
    if max_bits is None:
        max_bits = scalars.shape[0] * 16
    Ls = (max_bits + 15) // 16
    P = group.from_affine(curve, points)
    px, py, pz = group.times_scalar(curve, P, scalars[:Ls])
    # pairwise tree over the point axis: (L, N) -> (L,)
    n = px.shape[1]
    while n > 1:
        half = n // 2
        s = group.add(
            curve,
            (px[:, :half], py[:, :half], pz[:, :half]),
            (px[:, half : 2 * half], py[:, half : 2 * half], pz[:, half : 2 * half]),
        )
        if n % 2:
            px, py, pz = (torch.cat([a, b[:, -1:]], dim=1) for a, b in zip(s, (px, py, pz)))
            n = half + 1
        else:
            px, py, pz = s
            n = half
    return (px[:, 0], py[:, 0], pz[:, 0])
