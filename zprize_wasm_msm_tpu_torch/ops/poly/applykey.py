"""batchApplyKey: multiply a vector by a geometric sequence of Fr factors.

Port of zprize_wasm_msm_tpu/ops/poly/applykey.py, the counterpart of
wasmcurves/src/build_applykey.js: out[i] = in[i] ⊗ (first * inc^i),
instantiated for Fr vectors and for G1/G2 point vectors
(build_bls12381.js:88-92).  The reference's serial multiply chain becomes
a log-depth doubling construction of the power table, then one action over
the batch.  Fr products go through ops.field.kernels.mont_mul (the kernel
on the card); the group action is the plain scalar multiplication.
"""

from __future__ import annotations

import torch

from ..curve import group
from ..curve.spec import CurveSpec
from ..field import kernels, mont
from ..field.spec import FieldSpec


def _power_table(spec: FieldSpec, first: torch.Tensor, inc: torch.Tensor, n: int):
    """(L, n) Montgomery table [first, first*inc, ..., first*inc^(n-1)].

    Log-depth: repeatedly concatenate p and p * inc^len(p) — log2(n)
    products over the batch instead of the reference's n serial ones.
    """
    p = first[:, None]  # (L, 1)
    step = inc  # inc^len(p)
    while p.shape[1] < n:
        scaled = kernels.mont_mul(spec, p, step[:, None])
        p = torch.cat([p, scaled], dim=1)
        step = kernels.mont_mul(spec, step, step)
    return p[:, :n]


def batch_apply_key_fr(
    spec: FieldSpec, vec: torch.Tensor, first: torch.Tensor, inc: torch.Tensor
) -> torch.Tensor:
    """Fr vector variant: out[i] = vec[i] * first * inc^i (all Montgomery)."""
    n = vec.shape[1]
    powers = _power_table(spec, first, inc, n)
    return kernels.mont_mul(spec, vec, powers)


def batch_apply_key_group(curve: CurveSpec, pts, first: torch.Tensor, inc: torch.Tensor):
    """Group variant: out[i] = (first * inc^i) · P_i (opGtimesF = scalar mul).

    pts: projective (X, Y, Z) each (EL, n); first/inc: (Ls,) Montgomery Fr.
    """
    fr = curve.fr
    n = pts[0].shape[1]
    powers_m = _power_table(fr, first, inc, n)
    powers_std = mont.from_mont(fr, powers_m)  # times_scalar takes standard
    return group.times_scalar(curve, pts, powers_std)
