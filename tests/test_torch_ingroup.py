"""PyTorch port: the BLS12-381 subgroup checks (ops/pairing/ingroup.py).

Fast tier: the host constants against the JAX package, and the port's
checks on a few points whose membership is known (the generator and
multiples of it, the identity, curve points outside the subgroup and their
cofactor-cleared multiples, an off-curve point), as tests/test_ingroup.py
builds them.  Slow tier: the masks against the JAX package's on the same
points (tests/test_ingroup.py is slow too)."""

import numpy as np
import pytest

from zprize_wasm_msm_tpu.models import curves as ref_curves
from zprize_wasm_msm_tpu.ops.curve import group as ref_group
from zprize_wasm_msm_tpu.ops.pairing import ingroup as ref_ingroup
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.models.context import build_curve
from zprize_wasm_msm_tpu_torch.ops.curve import group
from zprize_wasm_msm_tpu_torch.ops.pairing import bls12, ingroup
from zprize_wasm_msm_tpu_torch.oracle import F as HostF, F2 as HostF2

from tests._torch_helpers import jax_stages_eager, oracle_of, to_jax

Z = bls12.BLS12_381_X
#: BLS12-381 G1 cofactor (z - 1)^2 / 3, z negative
H1 = (abs(Z) + 1) ** 2 // 3


def test_host_constants_match_jax():
    c = port_curves.bls12_381
    args = (c.q, c.r, c.gx, c.gy, c.b, abs(Z))
    assert ingroup._cube_roots_for_g1_check(*args) == ref_ingroup._cube_roots_for_g1_check(*args)
    assert (ingroup._WINV, ingroup._FROB2X, ingroup._FROB3Y) == (
        ref_ingroup._WINV, ref_ingroup._FROB2X, ref_ingroup._FROB3Y)


def _g1_cases():
    """[G, 123456789 G, a curve point outside the subgroup, its cleared
    multiple, the identity] and the expected mask."""
    curve = port_curves.bls12_381
    oc = oracle_of(curve)
    f = HostF(curve.q)
    x = 5
    while (y := f.sqrt((x * x * x + 4) % curve.q)) in (None, 0):
        x += 1
    bad = (x, y)
    return [oc.g, oc.mul(oc.g, 123456789), bad, oc.mul(bad, H1), None], [True, True, False, True, True]


def _sqrt_f2(q, a):
    """A square root in Fq2 = Fq[u]/(u^2 + 1) through the norm, or None."""
    f, f2 = HostF(q), HostF2(q, -1)
    c0, c1 = a
    sn = f.sqrt((c0 * c0 + c1 * c1) % q)
    if sn is None:
        return None
    for s in (sn, (-sn) % q):
        x0 = f.sqrt((c0 + s) * pow(2, q - 2, q) % q)
        if x0:
            cand = (x0, c1 * pow(2 * x0, q - 2, q) % q)
            if f2.sqr(cand) == f2.of(a):
                return cand
    return None


def _g2_cases():
    """[G2, 987654321 G2, a twist point outside the subgroup, the identity]."""
    curve = port_curves.bls12_381_g2
    oc = oracle_of(curve)
    f2 = HostF2(curve.q, -1)
    x = (3, 1)
    while (y := _sqrt_f2(curve.q, f2.add(f2.mul(f2.mul(x, x), x), f2.of((4, 4))))) is None:
        x = (x[0] + 1, x[1])
    bad = (x, y)
    assert oc.is_on_curve(bad)
    return [oc.g, oc.mul(oc.g, 987654321), bad, None], [True, True, False, True]


@pytest.mark.parametrize("which", ["g1", "g2"])
def test_in_group_on_known_points(which):
    """ctx.in_group_affine (and in_group on the projective batch) on points
    of known membership; an off-curve point is rejected."""
    curve = port_curves.bls12_381 if which == "g1" else port_curves.bls12_381_g2
    pts, want = _g1_cases() if which == "g1" else _g2_cases()
    ctx = build_curve(curve, device="cpu")
    P = ctx.points_to_device(pts)
    assert ctx.in_group_affine(P).tolist() == want
    assert ctx.in_group(group.from_affine(curve, P)).tolist() == want
    gx, gy = pts[0]
    off = (gx, (gy + 1) % curve.q) if which == "g1" else (gx, ((gy[0] + 1) % curve.q, gy[1]))
    assert not oracle_of(curve).is_on_curve(off)
    assert ctx.in_group_affine(ctx.points_to_device([off])).tolist() == [False]


def test_in_group_needs_a_bls_parameter():
    with pytest.raises(ValueError):
        build_curve(port_curves.bn254, device="cpu").in_group_affine(None)


@pytest.mark.slow
@pytest.mark.parametrize("which", ["g1", "g2"])
def test_in_group_matches_jax(which):
    ref_curve = ref_curves.bls12_381 if which == "g1" else ref_curves.bls12_381_g2
    curve = port_curves.bls12_381 if which == "g1" else port_curves.bls12_381_g2
    pts, want = _g1_cases() if which == "g1" else _g2_cases()
    P = build_curve(curve, device="cpu").points_to_device(pts)
    jP = to_jax(tuple(t.numpy().astype(np.uint32) for t in P))
    fn, ref_fn = (ingroup.g1_in_group, ref_ingroup.g1_in_group) if which == "g1" else (
        ingroup.g2_in_group, ref_ingroup.g2_in_group)
    got = fn(curve, Z, P)
    with jax_stages_eager(ref_ingroup, functions=((ref_group, "times_scalar"),)):
        ref = np.asarray(getattr(ref_ingroup, ref_fn.__name__)(ref_curve, Z, jP))
    assert got.tolist() == ref.tolist() == want
