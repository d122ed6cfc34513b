"""PyTorch port, GLV slice: scalar decomposition, endomorphism, the batched
field surface and the default ``ctx.msm`` against the JAX package on the same
numpy inputs.  Limbs and signs are compared bit for bit, MSM results as
affine points (integers throughout: tolerance 0).

On CPU tensors the port's mont_mul / mont_square wrappers run their plain
PyTorch versions; the CUDA kernels are held against those on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zprize_wasm_msm_tpu.models import curves as ref_curves
from zprize_wasm_msm_tpu.ops.field import batch as ref_batch
from zprize_wasm_msm_tpu.ops.msm import glv as ref_glv

import zprize_wasm_msm_tpu_torch as ZT
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.ops.field import batch
from zprize_wasm_msm_tpu_torch.ops.field import kernels as field_kernels
from zprize_wasm_msm_tpu_torch.ops.msm import glv
from zprize_wasm_msm_tpu_torch.utils.limbs import ints_to_limbs, limbs_to_ints

from tests._torch_helpers import (
    CURVE_PAIRS, affine_np, assert_same, field_operands, mont_limbs, oracle_of, random_points,
    to_jax, to_torch, torch_np,
)

GLV_PAIRS = {
    "bls12_381": CURVE_PAIRS["bls12_381"],
    "bls12_377": (ref_curves.bls12_377, port_curves.bls12_377),
}


def _scalars(r, seed, n_random=24):
    """Edge scalars, non-canonical ones (>= r, up to 2^256 - 1) among them."""
    rng = np.random.default_rng(seed)
    ks = [0, 1, 2, r - 1, r, r + 1, 2 * r, (1 << 256) - 1, 1 << 255, (1 << 128) - 1, 1 << 128]
    ks += [int.from_bytes(rng.bytes(32), "little") for _ in range(n_random)]
    return ks


def test_constants_equal_reference():
    assert glv.HALF_LIMBS == ref_glv.HALF_LIMBS == 9
    assert glv.MAX_BITS == ref_glv.MAX_BITS == 132


@pytest.mark.parametrize("name", sorted(GLV_PAIRS))
def test_decompose_scalars_equals_reference(name):
    ref, port = GLV_PAIRS[name]
    ks = _scalars(port.r, seed=len(name))
    sc = ints_to_limbs(ks, 16)
    got = glv.decompose_scalars(port, to_torch(sc))
    assert_same(got, ref_glv.decompose_scalars(ref, to_jax(sc)))
    k1, k2, k1_pos, k2_pos = got
    assert k1.shape == k2.shape == (glv.HALF_LIMBS, len(ks)) and k1_pos.dtype == torch.bool
    for k, a, b, pa, pb in zip(ks, limbs_to_ints(torch_np(k1)), limbs_to_ints(torch_np(k2)),
                               k1_pos.tolist(), k2_pos.tolist()):
        a, b = (a if pa else -a), (b if pb else -b)
        assert (a + b * port.glv.lam - k) % port.r == 0
        assert abs(a) < 1 << glv.MAX_BITS and abs(b) < 1 << glv.MAX_BITS


@pytest.mark.parametrize("name", sorted(GLV_PAIRS))
def test_endomorphism_and_preprocess_equal_reference(name):
    ref, port = GLV_PAIRS[name]
    oc = oracle_of(port)
    pts = random_points(port, 6, seed=5)
    pts[2] = None
    XY = affine_np(port, pts)
    got = glv.endomorphism(port, to_torch(XY))
    assert_same(got, ref_glv.endomorphism(ref, to_jax(XY)))
    # phi(P) = lambda * P
    host = [None if (x == 0 and y == 0) else (x, y)
            for x, y in zip(port.field.to_host(got[0]), port.field.to_host(got[1]))]
    assert host == [None if p is None else oc.mul(p, port.glv.lam) for p in pts]
    ks = _scalars(port.r, seed=9, n_random=0)[:6]
    sc = ints_to_limbs(ks, 16)
    (gX, gY), gk = glv.preprocess_endomorphism(port, to_torch(XY), to_torch(sc))
    (wX, wY), wk = ref_glv.preprocess_endomorphism(ref, to_jax(XY), to_jax(sc))
    assert gX.shape == (port.fq.n_limbs, 12) and gk.shape == (glv.HALF_LIMBS, 12)
    assert_same((gX, gY, gk), (wX, wY, wk))


@pytest.mark.parametrize("name", ["toy", "bls12_381"])
def test_batch_ops_equal_reference(name):
    ref, port = CURVE_PAIRS[name]
    rfq, fq = ref.fq, port.fq
    a, b = field_operands(fq.q, 20, seed=17)
    al, bl = mont_limbs(fq, a), mont_limbs(fq, b)
    ta, tb, ja, jb = to_torch(al), to_torch(bl), to_jax(al), to_jax(bl)
    for op in ("batch_mul", "batch_add", "batch_sub"):
        assert_same(getattr(batch, op)(fq, ta, tb), getattr(ref_batch, op)(rfq, ja, jb), op)
    for op in ("batch_square", "batch_neg", "batch_inverse", "batch_to_mont", "batch_from_mont"):
        assert_same(getattr(batch, op)(fq, ta), getattr(ref_batch, op)(rfq, ja), op)
    # and through the context, against python ints
    ctx = ZT.build_curve(port, device="cpu")
    assert port.field.to_host(ctx.batch_mul(ta, tb)) == [x * y % fq.q for x, y in zip(a, b)]
    assert port.field.to_host(ctx.batch_square(ta)) == [x * x % fq.q for x in a]
    assert port.field.to_host(ctx.batch_add(ta, tb)) == [(x + y) % fq.q for x, y in zip(a, b)]
    assert port.field.to_host(ctx.batch_sub(ta, tb)) == [(x - y) % fq.q for x, y in zip(a, b)]
    assert port.field.to_host(ctx.batch_neg(ta)) == [-x % fq.q for x in a]
    assert port.field.to_host(ctx.batch_inverse(ta)) == [pow(x, -1, fq.q) if x else 0 for x in a]
    std = to_torch(ints_to_limbs(a, fq.n_limbs))
    assert_same(ctx.batch_to_mont(std), al)
    assert_same(ctx.batch_from_mont(ta), ints_to_limbs(a, fq.n_limbs))


def test_mont_kernels_follow_the_tensor_and_refuse_cpu_tensors():
    """auto = plain on a CPU tensor; impl="kernel" on a CPU tensor raises and
    launches nothing; a constant operand broadcasts."""
    fq = CURVE_PAIRS["toy"][1].fq
    a, b = field_operands(fq.q, 5, seed=3)
    ta, tb = to_torch(mont_limbs(fq, a)), to_torch(mont_limbs(fq, b))
    before = dict(field_kernels.launches)
    assert torch.equal(field_kernels.mont_mul(fq, ta, tb), field_kernels.mont_mul_plain(fq, ta, tb))
    assert torch.equal(field_kernels.mont_square(fq, ta), field_kernels.mont_square_plain(fq, ta))
    assert torch.equal(field_kernels.mont_mul(fq, ta, tb[:, 3:4]),
                       field_kernels.mont_mul(fq, ta, tb[:, 3:4].expand(-1, ta.shape[1]).contiguous()))
    for call in (
        lambda: field_kernels.mont_mul(fq, ta, tb, impl="kernel"),
        lambda: field_kernels.mont_square(fq, ta, impl="kernel"),
        lambda: batch.batch_mul(fq, ta, tb, impl="kernel"),
        lambda: batch.batch_to_mont(fq, ta, impl="kernel"),
        lambda: glv.endomorphism(CURVE_PAIRS["bls12_381"][1], (ta, tb), impl="kernel"),
    ):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError):
        field_kernels.mont_mul(fq, ta, tb, impl="fast")
    assert field_kernels.launches == before


@pytest.mark.parametrize("name", sorted(GLV_PAIRS))
def test_msm_glv_default_equals_full_scalar_and_oracle(name):
    """ctx.msm with nothing else (GLV split, 132-bit digits) == use_glv=False
    == the host oracle, non-canonical scalars included."""
    _, port = GLV_PAIRS[name]
    ctx = ZT.build_curve(port, device="cpu")
    oc = oracle_of(port)
    pts = random_points(port, 7, seed=21)
    pts[3] = None
    ks = _scalars(port.r, seed=22, n_random=2)[3:10]
    want = oc.msm(pts, [k % port.r for k in ks])
    P, s = ctx.points_to_device(pts), ctx.scalars_to_device(ks)
    assert ctx.result_to_affine(ctx.msm(P, s)) == want
    assert ctx.result_to_affine(ctx.msm(P, s, use_glv=False, c=6, lanes=2)) == want
    assert ctx.msm_host(pts, ks, c=5, lanes=1) == want


def test_msm_glv_default_equals_reference_package():
    """The same inputs through both packages' ``CurveContext.msm`` defaults
    (GLV on, max_bits = 132), compared as affine points."""
    import zprize_wasm_msm_tpu as ZR

    ref, port = CURVE_PAIRS["bls12_381"]
    pts = random_points(port, 4, seed=33)
    ks = [5, port.r - 2, (1 << 256) - 1, 0x1234567890ABCDEF << 100]
    XY, sc = affine_np(port, pts), ints_to_limbs(ks, 16)
    kw = dict(c=6, lanes=2)
    want = ZR.build_curve(ref).result_to_affine(ZR.build_curve(ref).msm(to_jax(XY), jnp.asarray(sc), impl="xla", **kw))
    ctx = ZT.build_curve(port, device="cpu")
    got = ctx.result_to_affine(ctx.msm(to_torch(XY), to_torch(sc), **kw))
    assert got == want == oracle_of(port).msm(pts, [k % port.r for k in ks])
