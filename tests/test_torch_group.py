"""PyTorch port, curve layer: ops.curve.group against the JAX package's
ops.curve.group — complete formulas are deterministic, so projective
outputs are equal bit for bit, the identity, P = Q and P = -Q included."""

import numpy as np
import pytest
import torch

from zprize_wasm_msm_tpu.ops.curve import group as ref_group
from zprize_wasm_msm_tpu_torch.ops.curve import group

from tests._torch_helpers import (
    CURVE_PAIRS, affine_np, assert_same, host_points, oracle_of, random_points,
    to_jax, to_torch, torch_np,
)


def _cases(name):
    """Affine operand lists with every special case in the batch."""
    _, port = CURVE_PAIRS[name]
    oc = oracle_of(port)
    base = random_points(port, 6, seed=21)
    pts = base + [None, base[0], base[1], None, base[2]]
    qts = base[1:] + base[:1] + [base[3], base[0], oc.neg(base[1]), None, None]
    return port, oc, pts, qts


def _operands(name):
    ref, port = CURVE_PAIRS[name]
    _, oc, pts, qts = _cases(name)
    PA, QA = affine_np(port, pts), affine_np(port, qts)
    # projective operands that are not just lifted affine points: 2(P + Q) etc.
    tP = group.from_affine(port, to_torch(PA))
    tQ = group.from_affine(port, to_torch(QA))
    tP2 = group.double(port, group.add(port, tP, tQ))
    P2 = torch_np(tP2)
    return ref, port, oc, pts, qts, PA, QA, torch_np(tP), torch_np(tQ), P2


@pytest.mark.parametrize("name", ["toy", "bls12_381"])
@pytest.mark.parametrize("op", ["add", "add_mixed", "double", "neg", "from_affine"])
def test_group_op_matches_reference(name, op):
    ref, port, oc, pts, qts, PA, QA, P, Q, P2 = _operands(name)
    if op == "add":
        for lhs in (P, P2):
            assert_same(
                group.add(port, to_torch(lhs), to_torch(Q)),
                ref_group.add(ref, to_jax(lhs), to_jax(Q)),
            )
    elif op == "add_mixed":
        for lhs in (P, P2):
            assert_same(
                group.add_mixed(port, to_torch(lhs), to_torch(QA)),
                ref_group.add_mixed(ref, to_jax(lhs), to_jax(QA)),
            )
    elif op == "double":
        assert_same(group.double(port, to_torch(P2)), ref_group.double(ref, to_jax(P2)))
    elif op == "neg":
        assert_same(group.neg(port, to_torch(P2)), ref_group.neg(ref, to_jax(P2)))
        assert_same(group.neg_affine(port, to_torch(QA)), ref_group.neg_affine(ref, to_jax(QA)))
    else:
        assert_same(group.from_affine(port, to_torch(PA)), ref_group.from_affine(ref, to_jax(PA)))


@pytest.mark.parametrize("name", ["toy", "bls12_381"])
def test_group_law_against_oracle(name):
    """add / add_mixed / double / sub as group elements against the host
    oracle, through to_affine (batched inversion, infinity -> (0,0))."""
    _, port, oc, pts, qts, PA, QA, P, Q, _ = _operands(name)
    tP, tQ = to_torch(P), to_torch(Q)

    def aff(R):
        x, y = torch_np(group.to_affine(port, R))
        return host_points(port, x, y)

    assert aff(group.add(port, tP, tQ)) == [oc.add(p, s) for p, s in zip(pts, qts)]
    assert aff(group.add_mixed(port, tP, to_torch(QA))) == [oc.add(p, s) for p, s in zip(pts, qts)]
    assert aff(group.double(port, tP)) == [oc.add(p, p) for p in pts]
    assert aff(group.sub(port, tP, tQ)) == [oc.add(p, oc.neg(s)) for p, s in zip(pts, qts)]
    assert bool(group.in_curve(port, group.add(port, tP, tQ)).all())
    assert torch_np(group.is_zero(port, tP)).tolist() == [p is None for p in pts]


def test_predicates_select_constructors_match_reference_toy():
    ref, port, _, _, _, PA, QA, P, Q, P2 = _operands("toy")
    tP, tQ, tP2 = to_torch(P), to_torch(Q), to_torch(P2)
    jP, jQ, jP2 = to_jax(P), to_jax(Q), to_jax(P2)
    assert_same(group.eq(port, tP, tQ), ref_group.eq(ref, jP, jQ))
    assert_same(group.eq(port, tP2, tP2), ref_group.eq(ref, jP2, jP2))
    assert_same(group.in_curve(port, tP2), ref_group.in_curve(ref, jP2))
    assert_same(group.is_zero(port, tP), ref_group.is_zero(ref, jP))
    assert_same(group.is_zero_affine(port, to_torch(QA)), ref_group.is_zero_affine(ref, to_jax(QA)))
    mask = np.arange(P[0].shape[1]) % 2 == 0
    assert_same(
        group.select(torch.as_tensor(mask), tP, tQ), ref_group.select(to_jax(mask), jP, jQ)
    )
    assert_same(group.zero(port, (3,)), ref_group.zero(ref, (3,)))
    assert_same(group.generator(port, (2,)), ref_group.generator(ref, (2,)))
    # a corrupted point is off the curve for both
    bad = (P2[0], P2[1], P2[0])
    assert_same(group.in_curve(port, to_torch(bad)), ref_group.in_curve(ref, to_jax(bad)))


def test_to_affine_and_times_scalar_match_reference_toy():
    ref, port, _, _, _, _, _, P, _, P2 = _operands("toy")
    assert_same(group.to_affine(port, to_torch(P2)), ref_group.to_affine(ref, to_jax(P2)))
    n = P[0].shape[1]
    ks = np.random.default_rng(4).integers(0, 1 << 16, size=(1, n)).astype(np.uint32)
    ks[0, :3] = (0, 1, port.r)
    assert_same(
        group.times_scalar(port, to_torch(P), to_torch(ks)),
        ref_group.times_scalar(ref, to_jax(P), to_jax(ks)),
    )


def test_times_scalar_bls12_381_against_oracle():
    """Full width against the host oracle (the JAX compile of the scan costs
    more than this whole file): 32-bit scalars, 0 and the identity included."""
    _, port = CURVE_PAIRS["bls12_381"]
    oc = oracle_of(port)
    pts = random_points(port, 3, seed=8) + [None]
    ks = [0xDEADBEEF, 0, 1, 12345]
    from zprize_wasm_msm_tpu_torch.utils.limbs import ints_to_limbs

    P = group.from_affine(port, to_torch(affine_np(port, pts)))
    R = group.times_scalar(port, P, to_torch(ints_to_limbs(ks, 2)))
    x, y = torch_np(group.to_affine(port, R))
    assert host_points(port, x, y) == [oc.mul(p, k) if p else None for p, k in zip(pts, ks)]


def test_general_a_curves_are_refused_until_ported():
    """General-a curves are ported (RCB16 algorithm 1): toy_a's complete
    add on the identity and on P + (-P) gives the identity, where the a = 0
    formulas it once refused would not.  The full check against the JAX
    package is tests/test_torch_general_a.py."""
    from zprize_wasm_msm_tpu_torch.models.curves import toy_a

    O = group.zero(toy_a, (1,))
    assert bool(group.is_zero(toy_a, group.add(toy_a, O, O)).all())
    G = group.generator(toy_a, (1,))
    assert bool(group.is_zero(toy_a, group.add(toy_a, G, group.neg(toy_a, G))).all())
    assert bool(group.in_curve(toy_a, group.double(toy_a, G)).all())
