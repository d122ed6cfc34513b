"""PyTorch port, cubic extension: tower.Fq3, the general-a group ops over it
and the plain MSM on toy_g3 (MNT6753 G2's 14-bit analog: y^2 = x^3 + a x + b
over Fq3 = Fq[v]/(v^3 - 11), a = (1, 0, 0)) against the JAX package — the
same numpy inputs through both.

Field and group ops are compared bit for bit (canonical 16-bit limbs,
tolerance zero); MSM results as affine points, also against the host
oracle.  toy_g3 keeps the JAX side's compiles small; MNT6753 G2 itself runs
on the card (chip_smoke.py's mnt6753 phase).
"""

import numpy as np
import pytest
import torch

from zprize_wasm_msm_tpu.models import curves as ref_curves
from zprize_wasm_msm_tpu.ops.curve import group as ref_group

import zprize_wasm_msm_tpu_torch as ZT
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.oracle import F3, Curve as OracleCurve
from zprize_wasm_msm_tpu_torch.ops.curve import group
from zprize_wasm_msm_tpu_torch.ops.field.tower import Fq3
from zprize_wasm_msm_tpu_torch.utils.limbs import limbs_to_ints

from tests._torch_helpers import assert_same, mont_limbs, to_jax, to_torch, torch_np

REF, PORT = ref_curves.toy_g3, port_curves.toy_g3


def oracle_of(curve):
    return OracleCurve(q=curve.q, a=curve.a, b=curve.b, r=curve.r, gx=curve.gx, gy=curve.gy,
                       field=F3(curve.q, curve.nr))


def fq3_np(fq, triples):
    """(c0, c1, c2) standard-domain triples -> (3L, n) uint32 Montgomery limbs."""
    return np.concatenate([mont_limbs(fq, [t[k] for t in triples]) for k in range(3)])


def fq3_host(fq, limbs):
    a = np.asarray(limbs).reshape(3 * fq.n_limbs, -1)
    L = fq.n_limbs
    comps = [limbs_to_ints(a[k * L : (k + 1) * L]) for k in range(3)]
    return [tuple(fq.from_mont_int(c[i]) for c in comps) for i in range(a.shape[1])]


def operands(fq, n_random, seed):
    """Edge triples (components 0, 1, q-1, (q+-1)/2), then random ones."""
    q = fq.q
    comps = [0, 1, q - 1, q // 2, q // 2 + 1]
    edges = [(x, y, z) for x in comps for y in comps[:3] for z in comps[:3]]
    rng = np.random.default_rng(seed)
    rand = lambda: int(rng.integers(0, q))
    a = edges + [(rand(), rand(), rand()) for _ in range(n_random)]
    b = edges[::-1] + [(rand(), rand(), rand()) for _ in range(n_random)]
    return fq3_np(fq, a), fq3_np(fq, b), a, b


@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg", "square", "inverse", "batch_inverse"])
def test_fq3_op_matches_reference(op):
    F, RF = PORT.field, REF.field
    assert isinstance(F, Fq3) and F.elem_len == RF.elem_len == 3 * PORT.fq.n_limbs
    a, b, pa, pb = operands(PORT.fq, 16, seed=3)
    if op in ("add", "sub", "mul"):
        got = getattr(F, op)(to_torch(a), to_torch(b))
        want = getattr(RF, op)(to_jax(a), to_jax(b))
    else:
        got, want = getattr(F, op)(to_torch(a)), getattr(RF, op)(to_jax(a))
    assert_same(got, want, op)
    if op == "inverse":  # and against the host: 0 -> 0
        f3 = F3(PORT.q, PORT.nr)
        host = [(0, 0, 0) if f3.is_zero(t) else f3.inv(t) for t in pa]
        assert fq3_host(PORT.fq, torch_np(got)) == host


def test_fq3_surface_matches_reference():
    """mul_many, the predicates, select, sign, the constants, to_host, and
    sqrt refused as the JAX package refuses it (the reference's f3m has no
    square root); a batch of two axes."""
    F, RF = PORT.field, REF.field
    a, b, _, _ = operands(PORT.fq, 6, seed=4)
    ta, tb, ja, jb = to_torch(a), to_torch(b), to_jax(a), to_jax(b)
    for g, w in zip(F.mul_many([(ta, tb), (tb, ta), (ta, ta)]), RF.mul_many([(ja, jb), (jb, ja), (ja, ja)])):
        assert_same(g, w)
    assert_same(F.is_zero(ta), RF.is_zero(ja))
    assert_same(F.eq(ta, tb), RF.eq(ja, jb))
    assert_same(F.eq(ta, ta), RF.eq(ja, ja))
    mask = np.arange(a.shape[1]) % 3 == 0
    assert_same(F.select(torch.as_tensor(mask), ta, tb), RF.select(to_jax(mask), ja, jb))
    assert_same(F.sign(ta), RF.sign(ja))
    assert_same(F.one((3,)), RF.one((3,)))
    assert_same(F.zeros((2, 2)), RF.zeros((2, 2)))
    assert_same(F.const(PORT.gx, (2,)), RF.const(REF.gx, (2,)))
    assert_same(F.const(5, (2,)), RF.const(5, (2,)))
    assert F.to_host(ta) == RF.to_host(ja)
    a2 = ta[:, :24].reshape(ta.shape[0], 4, 6)
    assert torch.equal(F.mul(a2, a2).reshape(ta.shape[0], -1), F.mul(ta[:, :24], ta[:, :24]))
    with pytest.raises(NotImplementedError):
        F.sqrt(ta)
    with pytest.raises(NotImplementedError):
        RF.sqrt(ja)
    with pytest.raises(TypeError):
        F.const((1, 2))


def _cases():
    oc = oracle_of(PORT)
    rng = np.random.default_rng(21)
    base = [oc.mul(oc.g, int(rng.integers(1, PORT.r))) for _ in range(5)]
    pts = base + [None, base[0], base[1], None]
    qts = base[1:] + base[:1] + [base[3], base[0], oc.neg(base[1]), None]
    return oc, pts, qts


def affine_g3(pts):
    zero = (0, 0, 0)
    return (fq3_np(PORT.fq, [zero if p is None else p[0] for p in pts]),
            fq3_np(PORT.fq, [zero if p is None else p[1] for p in pts]))


def port_affine(res):
    flat = tuple(c.reshape(c.shape[0], -1) for c in res)
    x, y = torch_np(group.to_affine(PORT, flat))
    xs, ys = fq3_host(PORT.fq, x), fq3_host(PORT.fq, y)
    return [None if (u == (0, 0, 0) and v == (0, 0, 0)) else (u, v) for u, v in zip(xs, ys)]


@pytest.mark.parametrize("op", ["add", "add_mixed", "double", "in_curve"])
def test_g3_group_op_matches_reference(op):
    oc, pts, qts = _cases()
    PA, QA = affine_g3(pts), affine_g3(qts)
    # projective operands that are not lifted affine points
    tP = group.double(PORT, group.add(PORT, group.from_affine(PORT, to_torch(PA)),
                                      group.from_affine(PORT, to_torch(QA))))
    P = torch_np(tP)
    if op == "add":
        got = group.add(PORT, tP, group.from_affine(PORT, to_torch(QA)))
        want = ref_group.add(REF, to_jax(P), ref_group.from_affine(REF, to_jax(QA)))
    elif op == "add_mixed":
        got = group.add_mixed(PORT, tP, to_torch(QA))
        want = ref_group.add_mixed(REF, to_jax(P), to_jax(QA))
    elif op == "double":
        got, want = group.double(PORT, tP), ref_group.double(REF, to_jax(P))
    else:
        got, want = group.in_curve(PORT, tP), ref_group.in_curve(REF, to_jax(P))
        assert bool(got.all())
    assert_same(got, want, op)
    if op == "add_mixed":
        want_pts = [oc.add(oc.double(oc.add(p, q)), q) for p, q in zip(pts, qts)]
        assert port_affine(got) == want_pts


def test_g3_msm_and_context_match_reference_and_oracle():
    """ctx.msm (auto: the plain engine, as the reference routes ext 3) and
    msm_legacy against the oracle, and the context's Fq3 marshalling
    (points_to_device, result_to_affine) against the test's own.  (The JAX
    package's jnp MSM compiles for ~30 s a curve on the CPU: the one
    engine-against-engine MSM is toy_a's, tests/test_torch_general_a.py;
    the plain engine's stages are field-generic and its group ops are held
    against the JAX package's above.)"""
    oc, pts, _ = _cases()
    pts = [p for p in pts if p is not None][:6]
    rng = np.random.default_rng(22)
    ks = [int(rng.integers(0, PORT.r)) for _ in pts[:-1]] + [0]
    ctx = ZT.build_curve(PORT, device="cpu")
    P = ctx.points_to_device(pts)
    assert torch.equal(P[0], to_torch(affine_g3(pts)[0]))
    k = ctx.scalars_to_device(ks)
    want = oc.msm(pts, ks)
    assert ctx.result_to_affine(ctx.msm(P, k, c=4)) == want
    assert ctx.result_to_affine(ctx.msm_legacy(P, k)) == want
    assert ctx.result_to_affine(group.zero(PORT, (), "cpu")) is None
