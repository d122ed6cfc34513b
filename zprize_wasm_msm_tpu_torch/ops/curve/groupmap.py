"""Shallue–van de Woestijne group map (hash-to-curve) for MNT6753 G1.

Port of zprize_wasm_msm_tpu/ops/curve/groupmap.py, the counterpart of the
reference's `g1m_groupMap` (wasmcurves/src/mnt6753/build_mnt6753.js
buildGroupMap:1362-1490): maps a field element t onto the curve by the
SvdW conic parametrization — three candidate x-values are derived from t,
and at least one of x^3 + a*x + b is guaranteed to be a quadratic residue.

The reference tries the candidates sequentially with early returns; here
all three rhs values and square roots are computed for every element and
the first valid candidate is chosen with masks (branch-free, identical work
per element).  The three candidates run as one stacked batch (one square
root, one Tonelli-Shanks loop), and the two inversions go through
ops.field.kernels.inverse (one launch of the field inversion kernel for a
tensor on the card, the Fermat ladder of the JAX package on the CPU): the
inverse is unique and 0 maps to 0, so the values are the JAX package's.

Curve constants (conic coefficient, projection point) are embedded per
curve exactly as the reference embeds them at codegen time
(build_mnt6753.js:1378-1386).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..field import kernels, mont
from ..field.tower import stack_elems
from .spec import CurveSpec


@dataclass(frozen=True)
class SvdWSpec:
    conic_c: int  # conic coefficient (ref _conicC, build_mnt6753.js:1383)
    proj_z: int  # z-coord of the conic projection point (ref _prjZ, :1385)
    # proj_y is 1 (ref uses pOne, :1386)


# keyed by curve prime q (constants are per-field, public parameters)
_SVDW: dict = {
    # MNT6753 (ref build_mnt6753.js:1383,1385)
    41898490967918953402344214791240637128170709919953949071783502921025352812571106773058893763790338921418070971888458477323173057491593855069696241854796396165721416325350064441470418137846398469611935719059908164220784476160001: SvdWSpec(
        conic_c=10474622741979738350586053697810159282042677479988487267945875730256338203142776693264723440947584730354517742972114619330793264372898463767424060463699099041430354081337516110367604534461599617402983929764977041055196119040012,
        proj_z=38365735639699746381939366704915555468563774296792699496721397906733830428037078183799997086205833647489050605889539959322880863358082391473031143521765387671570958090617625358358885062894615919620647426481572278916894388596945,
    ),
}


def group_map(curve: CurveSpec, T: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Map a batch of base-field elements onto the curve.

    T: (L, N) Montgomery-form field elements.
    Returns a projective point batch ((L,N), (L,N), (L,N)), Z = 1, exactly
    the reference's output layout (x, sqrt(rhs), one).
    """
    if curve.ext != 1:
        raise ValueError(f"{curve.name}: groupMap is a base-field (G1) construction")
    svdw = _SVDW.get(curve.q)
    if svdw is None:
        raise ValueError(f"no SvdW constants registered for {curve.name}")
    s = curve.fq
    batch, dev = T.shape[1:], T.device
    ones = (1,) * len(batch)

    def const(v):
        return mont.full_const(s, s.to_mont_int(v % s.q), ones, dev)

    one = mont.one_mont(s, batch, dev)
    conic_c, proj_z, u_over_2 = const(svdw.conic_c), const(svdw.proj_z), const(pow(2, -1, s.q))
    a_c, b_c = const(curve.a), const(curve.b)

    # ct = conicC * t ; S = 2 * (ct*projY + projZ) / (ct*t + 1), projY = 1
    ct = mont.mont_mul(s, conic_c, T)
    num = mont.add(s, ct, proj_z)
    den = mont.add(s, mont.mont_mul(s, ct, T), one)
    S = mont.mont_mul(s, num, kernels.inverse(s, den))
    S = mont.add(s, S, S)

    # Z = projZ - S ; Y = projY - S*t ; V = Z/Y - 1/2
    Z = mont.sub(s, proj_z, S)
    Y = mont.sub(s, one, mont.mont_mul(s, S, T))
    V = mont.sub(s, mont.mont_mul(s, Z, kernels.inverse(s, Y)), u_over_2)

    # candidates: x1 = V, x2 = -(1 + V), x3 = 1 + Y^2, as one (L, 3, *batch)
    # batch from here on
    x = stack_elems(V, mont.neg(s, mont.add(s, one, V)), mont.add(s, one, mont.mont_square(s, Y)))
    # x^3 + a*x + b
    rhs = mont.mont_mul(s, mont.mont_square(s, x), x)
    rhs = mont.add(s, mont.add(s, rhs, mont.mont_mul(s, a_c[:, None], x)), b_c[:, None])
    y, ok = mont.sqrt(s, rhs)
    # the reference's f1m_sqrt returns the non-negative root
    # (build_f1m.js:1209-1213); normalize to match
    y = mont._select(mont.sign(s, y) == -1, mont.neg(s, y), y)

    # first valid candidate wins (SvdW guarantees at least one)
    ok1, ok2 = ok[0], ok[1]
    X = mont._select(ok1, x[:, 0], mont._select(ok2, x[:, 1], x[:, 2]))
    Yc = mont._select(ok1, y[:, 0], mont._select(ok2, y[:, 1], y[:, 2]))
    return (X, Yc, one)
