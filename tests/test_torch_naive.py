"""PyTorch port, the differential engine and the small host modules against
the JAX package — the same numpy inputs through both.

msm_legacy (ops/msm/naive.py, a per-point ladder and a tree sum that shares
no stage with the bucket engines) against the JAX package's msm_naive as an
affine point (the projective representatives of two tree orders need not
agree) and against the host oracle, on the toy curve and on toy_g2 (Fq2),
odd and even point counts, zero scalars and infinity included; f1 (the
standard-domain field ops) and utility (max, most significant bit, count of
non-zero entries) limb for limb and value for value.  CPU tensors.
"""

import numpy as np
import pytest
import torch

from zprize_wasm_msm_tpu.models import curves as ref_curves
from zprize_wasm_msm_tpu.ops.field import f1 as ref_f1
from zprize_wasm_msm_tpu.ops.msm import naive as ref_naive
from zprize_wasm_msm_tpu.ops.msm import utility as ref_utility

import zprize_wasm_msm_tpu_torch as ZT
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.oracle import F2, Curve as OracleCurve
from zprize_wasm_msm_tpu_torch.ops.field import f1
from zprize_wasm_msm_tpu_torch.ops.msm import naive, utility
from zprize_wasm_msm_tpu_torch.utils.limbs import ints_to_limbs

from tests._torch_helpers import assert_same, edge_values, to_jax, to_torch, torch_np


def oracle_of(curve):
    field = F2(curve.q, curve.nr) if curve.ext == 2 else None
    return OracleCurve(q=curve.q, a=curve.a, b=curve.b, r=curve.r, gx=curve.gx, gy=curve.gy, field=field)


def affine(curve, pt):
    """(X, Y, Z) each (EL,) -> python affine point, through the port."""
    ctx = ZT.build_curve(curve, device="cpu")
    return ctx.result_to_affine(tuple(torch.as_tensor(np.asarray(c, dtype=np.int64)) for c in pt))


@pytest.mark.parametrize("name,n,bits", [("toy", 13, 16), ("toy_g2", 9, 16)])
def test_msm_legacy_equals_reference_msm_naive_and_oracle(name, n, bits):
    ref, port = getattr(ref_curves, name), getattr(port_curves, name)
    oc = oracle_of(port)
    rng = np.random.default_rng(n)
    pts = [oc.mul(oc.g, int(rng.integers(1, port.r))) for _ in range(n)]
    pts[2] = None
    ks = [int(rng.integers(0, 1 << bits)) for _ in range(n)]
    ks[0], ks[1] = 0, (1 << bits) - 1
    ctx = ZT.build_curve(port, device="cpu")
    P = ctx.points_to_device(pts)
    k = ctx.scalars_to_device(ks)
    got = ctx.msm_legacy(P, k, max_bits=bits)
    assert all(c.shape == (port.field.elem_len,) for c in got)
    want = ref_naive.msm_naive(ref, to_jax(torch_np(P)), to_jax(torch_np(k)), max_bits=bits)
    expected = oc.msm(pts, [x % port.r for x in ks])
    assert ctx.result_to_affine(got) == expected
    assert affine(port, tuple(np.asarray(c) for c in want)) == expected
    # the default width: every limb of the scalars
    assert ctx.result_to_affine(naive.msm_naive(port, P, k)) == expected


@pytest.mark.parametrize("n", [1, 2, 16, 17])
def test_msm_legacy_tree_on_odd_and_even_counts(n):
    """The pairwise tree at counts that halve evenly and that carry an odd
    point up, against the oracle (the reference's tree is the same code)."""
    port = port_curves.toy
    oc = oracle_of(port)
    rng = np.random.default_rng(n + 20)
    pts = [oc.mul(oc.g, int(rng.integers(1, port.r))) for _ in range(n)]
    ks = [int(rng.integers(0, 1 << 14)) for _ in range(n)]
    ctx = ZT.build_curve(port, device="cpu")
    got = ctx.msm_legacy(ctx.points_to_device(pts), ctx.scalars_to_device(ks), max_bits=14)
    assert ctx.result_to_affine(got) == oc.msm(pts, ks)


def test_msm_legacy_agrees_with_the_bucket_engines():
    """The three engines of the port on the CPU, one input: the ladder and
    tree, the plain bucket engine, the plain sorted engine."""
    port = port_curves.toy
    oc = oracle_of(port)
    rng = np.random.default_rng(4)
    pts = [oc.mul(oc.g, int(rng.integers(1, port.r))) for _ in range(40)]
    ks = [int(rng.integers(0, port.r)) for _ in range(40)]
    ctx = ZT.build_curve(port, device="cpu")
    P, k = ctx.points_to_device(pts), ctx.scalars_to_device(ks)
    results = {ctx.result_to_affine(ctx.msm_legacy(P, k, max_bits=16)),
               ctx.result_to_affine(ctx.msm(P, k, max_bits=16, impl="plain")),
               ctx.result_to_affine(ctx.msm(P, k, c=9, max_bits=16, impl="plain-sorted"))}
    assert results == {oc.msm(pts, ks)}


@pytest.mark.parametrize("name", ["toy", "bls12_381"])
def test_f1_standard_domain_equals_reference(name):
    """Against python integers on both fields, and limb for limb against the
    JAX package's f1 on the toy field (its BLS12-381 graphs cost ~20 s of
    compile for the same code)."""
    ref, port = getattr(ref_curves, name).fq, getattr(port_curves, name).fq
    with_ref = name == "toy"
    q = port.q
    rng = np.random.default_rng(8)
    a = edge_values(q) + [int.from_bytes(rng.bytes(64), "little") % q for _ in range(7)]
    b = edge_values(q)[::-1] + [int.from_bytes(rng.bytes(64), "little") % q for _ in range(7)]
    A, B = ints_to_limbs(a, port.n_limbs), ints_to_limbs(b, port.n_limbs)
    for op, want in (("mul", [x * y % q for x, y in zip(a, b)]),
                     ("add", [(x + y) % q for x, y in zip(a, b)]),
                     ("sub", [(x - y) % q for x, y in zip(a, b)])):
        got = getattr(f1, op)(port, to_torch(A), to_torch(B))
        if with_ref:
            assert_same(got, getattr(ref_f1, op)(ref, to_jax(A), to_jax(B)))
        assert_same(got, ints_to_limbs(want, port.n_limbs))
    for op, want in (("square", [x * x % q for x in a]), ("inverse", [pow(x, q - 2, q) for x in a]),
                     ("neg", [-x % q for x in a])):
        got = getattr(f1, op)(port, to_torch(A))
        if with_ref:
            assert_same(got, getattr(ref_f1, op)(ref, to_jax(A)))
        assert_same(got, ints_to_limbs(want, port.n_limbs))
    assert f1.is_zero(port, to_torch(A))[0] and not f1.is_zero(port, to_torch(A))[1]
    assert f1.eq(port, to_torch(A), to_torch(A)).all()


def test_utility_helpers_equal_reference():
    vals = np.array([[0, 1, 2, 3, 5, 12, 255, 256, 1 << 20, (1 << 31) - 1, 1 << 31, (1 << 32) - 1]],
                    np.uint32)
    t = torch.as_tensor(vals.astype(np.int64))
    assert int(utility.max_array_value(t)) == int(ref_utility.max_array_value(to_jax(vals)))
    got = utility.get_msb(t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_utility.get_msb(to_jax(vals))))
    assert got.tolist() == [[0, 0, 1, 1, 2, 3, 7, 8, 20, 30, 31, 31]]
    digits = np.array([[0, 3, -2, 0], [1, 0, 0, -7]], np.int32)
    assert int(utility.count_non_zero(torch.as_tensor(digits))) == int(
        ref_utility.count_non_zero(to_jax(digits))) == 4
