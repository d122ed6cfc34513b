"""Point serialization: LEM <-> uncompressed / compressed wire formats.

Counterpart of zprize_wasm_msm_tpu/utils/serde.py, itself a re-design of the
reference's serializers (wasmcurves/src/build_curve_jacobian_a0.js —
LEMtoU:1207, LEMtoC:1168, UtoLEM:1239, CtoLEM:1265, batch* wrappers at
:1413-1416; field sign convention build_f1m.js sign:135).

Formats (per point, n8 = field byte size):
  LEM:  the in-framework layout — little-endian Montgomery affine (x, y)
        limb tensors, (EL, N) int64.
  U:    uncompressed wire — big-endian standard-domain x || y (2*n8 bytes);
        infinity encoded as zeros with byte0 = 0x40.
  C:    compressed wire — big-endian standard-domain x (n8 bytes);
        byte0 bit 0x80 = y is "greatest" (sign == -1), 0x40 = infinity.

The byte shuffles are numpy on the host; the field math (Montgomery
conversion, the square root of decompression, the sign) runs as batched
tensor ops on the device the points lie on (``from_*``: ``device``, where
None means the card).  The reference's per-point loops become one batched
op per batch (the batchLEMtoU / batchCtoLEM role).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.context import resolve_device
from ..ops.curve import group
from ..ops.curve.spec import CurveSpec
from ..ops.field import mont


def _to_be_bytes(std_limbs: np.ndarray) -> np.ndarray:
    """(EL, N) standard-domain 16-bit limbs -> (N, n8) big-endian bytes.

    An extension element is byte-reversed as ONE unit, as the reference's
    __reverseBytes over n8 = ext * f1n8 bytes (build_curve_jacobian_a0.js
    LEMtoU:1233-1236): the wire order of an Fq2 element is c1_be || c0_be."""
    le = np.ascontiguousarray(std_limbs.T.astype("<u2"))  # (N, EL) LE limbs
    raw = le.view(np.uint8).reshape(le.shape[0], -1)  # (N, n8) LE bytes
    return raw[:, ::-1]  # big-endian


def _from_be_bytes(be: np.ndarray, n_limbs: int) -> np.ndarray:
    """(N, n8) big-endian bytes -> (EL, N) int64 16-bit limbs."""
    le = np.ascontiguousarray(be[:, ::-1])
    limbs = le.view("<u2").astype(np.int64).reshape(-1, n_limbs)  # (N, EL)
    return np.ascontiguousarray(limbs.T)


def _componentwise(curve: CurveSpec, fn, A: torch.Tensor) -> torch.Tensor:
    """A base-field op on a flat (EL, N) coordinate, component by component
    over an extension (the f2m_fromMontgomery role)."""
    if curve.ext == 1:
        return fn(curve.fq, A)
    L = curve.fq.n_limbs
    a3 = A.reshape((curve.ext, L) + tuple(A.shape[1:])).movedim(0, 1)
    return fn(curve.fq, a3).movedim(1, 0).reshape(A.shape)


def _coord_sign(curve: CurveSpec, A: torch.Tensor) -> torch.Tensor:
    """Field sign: f1m sign:135 for the base field, f2m sign:411 for Fq2."""
    if curve.ext == 1:
        return mont.sign(curve.fq, A)
    return curve.field.sign(A)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _wire(curve: CurveSpec, raw, width: int) -> np.ndarray:
    return np.asarray(raw, dtype=np.uint8).reshape(-1, width * 2 * curve.field.elem_len)


def points_to_uncompressed(curve: CurveSpec, X, Y) -> np.ndarray:
    """LEM affine batch -> (N, 2*n8) uncompressed bytes (batchLEMtoU).

    n8 = ext * base-field bytes: G2 points serialize as x || y with each
    coordinate in the reference's whole-element big-endian order."""
    inf = _host(group.is_zero_affine(curve, (X, Y)))
    xs = _host(_componentwise(curve, mont.from_mont, X))
    ys = _host(_componentwise(curve, mont.from_mont, Y))
    out = np.concatenate([_to_be_bytes(xs), _to_be_bytes(ys)], axis=1)
    out[inf] = 0
    out[inf, 0] = 0x40
    return out


def points_from_uncompressed(curve: CurveSpec, raw, device=None):
    """(N, 2*n8) uncompressed bytes -> LEM affine batch on ``device``
    (batchUtoLEM)."""
    dev = resolve_device(device)
    EL = curve.field.elem_len
    n8 = 2 * EL
    raw = _wire(curve, raw, 2)
    inf = (raw[:, 0] & 0x40) != 0
    xb, yb = raw[:, :n8].copy(), raw[:, n8:].copy()
    xb[inf] = 0
    yb[inf] = 0
    X = _componentwise(curve, mont.to_mont, torch.as_tensor(_from_be_bytes(xb, EL), device=dev))
    Y = _componentwise(curve, mont.to_mont, torch.as_tensor(_from_be_bytes(yb, EL), device=dev))
    z = torch.as_tensor(inf, device=dev)
    return mont._select(z, torch.zeros_like(X), X), mont._select(z, torch.zeros_like(Y), Y)


def points_to_compressed(curve: CurveSpec, X, Y) -> np.ndarray:
    """LEM affine batch -> (N, n8) compressed bytes (batchLEMtoC)."""
    inf = _host(group.is_zero_affine(curve, (X, Y)))
    xs = _host(_componentwise(curve, mont.from_mont, X))
    neg = _host(_coord_sign(curve, Y)) == -1
    out = _to_be_bytes(xs).copy()
    out[neg, 0] |= 0x80
    out[inf] = 0
    out[inf, 0] = 0x40
    return out


def points_from_compressed(curve: CurveSpec, raw, device=None):
    """(N, n8) compressed bytes -> LEM affine batch on ``device``
    (batchCtoLEM).

    Recomputes y = sqrt(x^3 + [a x] + b) — one batched Tonelli-Shanks /
    q = 3 mod 4 exponentiation for G1, the reference's f2m sqrt
    (build_f2m.js:453, algorithm 9 (adjusted) of eprint 2012/685) for G2 —
    and picks the root whose sign matches the 0x80 flag, as CtoLEM:1265's
    selection table does.
    """
    dev = resolve_device(device)
    F = curve.field
    EL = F.elem_len
    raw = _wire(curve, raw, 1)
    inf = (raw[:, 0] & 0x40) != 0
    greatest = (raw[:, 0] & 0x80) != 0
    xb = raw.copy()
    xb[:, 0] &= 0x3F
    xb[inf] = 0
    X = _componentwise(curve, mont.to_mont, torch.as_tensor(_from_be_bytes(xb, EL), device=dev))
    n = X.shape[1]
    # y^2 = x^3 + a x + b
    rhs = F.add(F.mul(F.mul(X, X), X), F.const(curve.b, (n,), dev))
    if curve.a != 0:
        rhs = F.add(rhs, F.mul(F.const(curve.a, (n,), dev), X))
    y, _ = mont.sqrt(curve.fq, rhs) if curve.ext == 1 else F.sqrt(rhs)
    root_is_neg = _coord_sign(curve, y) == -1
    Y = F.select(root_is_neg == torch.as_tensor(greatest, device=dev), y, F.neg(y))
    z = torch.as_tensor(inf, device=dev)
    return mont._select(z, torch.zeros_like(X), X), mont._select(z, torch.zeros_like(Y), Y)


# the reference's names (the batch forms are the native API here)
batch_lem_to_u = points_to_uncompressed
batch_u_to_lem = points_from_uncompressed
batch_lem_to_c = points_to_compressed
batch_c_to_lem = points_from_compressed
