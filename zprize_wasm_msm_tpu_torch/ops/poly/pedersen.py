"""Windowed Pedersen hash over precomputed base tables.

Port of zprize_wasm_msm_tpu/ops/poly/pedersen.py, the counterpart of
wasmcurves/src/build_pedersenhash.js (wired for MNT6753 in
tools/buildwasm_mnt6753.js; chunkSize = 188 there): the message is consumed
3 bits per window — (b0, b1) select base_j * (1 + b0 + 2*b1) from the
table, b2 negates — and all selected points are summed.

The reference's per-window pointer walk + accumulator slots become one
table gather (the table is tiny) and a log-depth group tree-sum; the
accumulator-slot layout is a WASM work-sharing detail with no effect on the
result.

Base tables: the reference precomputes [base_j * k for k in 1..4] offline
(tools/buildpedersentablebases_mnt6753.js); ``make_base_table`` does the
same host-side from affine generator points, with the port's own oracle.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..curve import group
from ..curve.spec import CurveSpec
from ...oracle import Curve as _OracleCurve
from ...utils.limbs import ints_to_limbs


def make_base_table(curve: CurveSpec, bases: Sequence[Tuple[int, int]], device=None):
    """[(x, y)...] affine bases -> table (X, Y) each (L, 4*n_bases) on
    ``device`` (None: the CPU) holding base_j * (k+1) for k = 0..3 (the
    reference's basesTable layout)."""
    oc = _OracleCurve(q=curve.q, a=curve.a, b=curve.b, r=curve.r, gx=curve.gx, gy=curve.gy)
    fq = curve.fq
    xs, ys = [], []
    for b in bases:
        for k in range(1, 5):
            p = oc.mul(b, k)
            xs.append(fq.to_mont_int(p[0]))
            ys.append(fq.to_mont_int(p[1]))
    return tuple(
        torch.as_tensor(ints_to_limbs(v, fq.n_limbs).astype(np.int64), device=device)
        for v in (xs, ys)
    )


def pedersen_hash(
    curve: CurveSpec,
    bits: torch.Tensor,
    table: Tuple[torch.Tensor, torch.Tensor],
    chunk_size: int = 188,
):
    """bits: (nbits, N) integer tensor in {0,1} (LSB-first messages, batched).

    Returns the hash point batch, projective (X, Y, Z) each (L, N).
    nbits is padded up to a multiple of 3 with zeros; windows beyond the
    message contribute base*(1) per the reference's bit() = 0 padding.
    chunk_size selects a new base every chunk_size windows (ref :116).
    """
    TX, TY = table
    L = TX.shape[0]
    nbits, N = bits.shape
    W = (nbits + 2) // 3
    bits = bits.to(device=TX.device, dtype=torch.int64)
    pad = W * 3 - nbits
    if pad:
        bits = torch.cat([bits, bits.new_zeros((pad, N))], dim=0)
    b = bits.reshape(W, 3, N)
    sel = b[:, 0] + 2 * b[:, 1]  # (W, N) in 0..3
    sign = b[:, 2]

    n_entries = TX.shape[1]
    # table index per window: base_idx*4 + sel, clamped to the last entry
    w_idx = torch.arange(W, device=TX.device)[:, None] // chunk_size
    idx = torch.clamp(w_idx * 4 + sel, max=n_entries - 1).reshape(W * N)
    px_flat = TX[:, idx]  # (L, W*N): one gather from the small table
    py_flat = TY[:, idx]

    F = curve.field
    py_flat = F.select((sign == 1).reshape(W * N), F.neg(py_flat), py_flat)

    # tree-sum over the window axis with complete adds
    P = group.from_affine(curve, (px_flat, py_flat))
    P = tuple(a.reshape(L, W, N) for a in P)
    w = W
    while w > 1:
        half = w // 2
        s = _flat_add3(curve, tuple(a[:, :half] for a in P), tuple(a[:, half : 2 * half] for a in P))
        if w % 2:
            P = tuple(torch.cat([x, a[:, -1:]], dim=1) for x, a in zip(s, P))
            w = half + 1
        else:
            P = s
            w = half
    return tuple(a[:, 0] for a in P)


def _flat_add3(curve, p1, p2):
    """group.add of two (L, w, N) point batches, as one flat (L, w*N) batch."""
    shp = p1[0].shape
    L = shp[0]
    s = group.add(
        curve,
        tuple(a.reshape(L, -1) for a in p1),
        tuple(a.reshape(L, -1) for a in p2),
    )
    return tuple(a.reshape(shp) for a in s)
