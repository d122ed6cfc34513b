"""PyTorch port, field layer: ops.field.mont / tower.Fq against the JAX
package's ops.field.mont — the same numpy inputs through both, results equal
bit for bit (canonical 16-bit limbs; integers, tolerance zero)."""

import numpy as np
import pytest
import torch

from zprize_wasm_msm_tpu.ops.field import mont as ref_mont
from zprize_wasm_msm_tpu_torch import _build
from zprize_wasm_msm_tpu_torch.models.curves import CURVES
from zprize_wasm_msm_tpu_torch.ops.field import kernels, mont
from zprize_wasm_msm_tpu_torch.ops.field.tower import Fq

from tests._torch_helpers import (
    CURVE_PAIRS, assert_same, edge_values, field_operands, mont_limbs, to_jax, to_torch,
    torch_np,
)

BINARY = {
    "add": (ref_mont.add, mont.add),
    "sub": (ref_mont.sub, mont.sub),
    "mul": (ref_mont.mont_mul, mont.mont_mul),
}
UNARY = {
    "neg": (ref_mont.neg, mont.neg),
    "double": (ref_mont.double, mont.double),
    "square": (ref_mont.mont_square, mont.mont_square),
    "to_mont": (ref_mont.to_mont, mont.to_mont),
    "from_mont": (ref_mont.from_mont, mont.from_mont),
}


def _operands(name):
    ref, port = CURVE_PAIRS[name]
    a, b = field_operands(ref.q, 24, seed=11)
    return ref.fq, port.fq, mont_limbs(ref.fq, a), mont_limbs(ref.fq, b), a, b


@pytest.mark.parametrize("name", ["toy", "bls12_381"])
@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_field_op_matches_reference(name, op):
    rfq, pfq, a, b, _, _ = _operands(name)
    ref_fn, port_fn = BINARY[op]
    assert_same(port_fn(pfq, to_torch(a), to_torch(b)), ref_fn(rfq, to_jax(a), to_jax(b)), op)


@pytest.mark.parametrize("name", ["toy", "bls12_381"])
@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_field_op_matches_reference(name, op):
    rfq, pfq, a, _, _, _ = _operands(name)
    ref_fn, port_fn = UNARY[op]
    assert_same(port_fn(pfq, to_torch(a)), ref_fn(rfq, to_jax(a)), op)


@pytest.mark.parametrize("name", ["toy", "bls12_381"])
def test_predicates_select_and_constants_match_reference(name):
    rfq, pfq, a, b, _, _ = _operands(name)
    ta, tb, ja, jb = to_torch(a), to_torch(b), to_jax(a), to_jax(b)
    assert_same(mont.is_zero(pfq, ta), ref_mont.is_zero(rfq, ja))
    assert_same(mont.eq(pfq, ta, tb), ref_mont.eq(rfq, ja, jb))
    mask = np.arange(a.shape[1]) % 3 == 0
    assert_same(
        mont._select(torch.as_tensor(mask), ta, tb),
        ref_mont._select(to_jax(mask), ja, jb),
    )
    assert_same(mont.zeros(pfq, (3, 2)), ref_mont.zeros(rfq, (3, 2)))
    assert_same(mont.one_mont(pfq, (5,)), ref_mont.one_mont(rfq, (5,)))
    assert_same(mont.full_const(pfq, 12345 % pfq.q, (2, 2)), ref_mont.full_const(rfq, 12345 % rfq.q, (2, 2)))


def test_mul_broadcasts_like_reference():
    """(L, W, T) x (L, 1, 1) and (L, n) x (L, 1): the shapes group ops feed."""
    ref, port = CURVE_PAIRS["toy"]
    a, b = field_operands(ref.q, 5, seed=3)
    an = mont_limbs(ref.fq, a[:24]).reshape(4, 4, 6)
    bn = mont_limbs(ref.fq, b[:1]).reshape(4, 1, 1)
    assert_same(
        mont.mont_mul(port.fq, to_torch(an), to_torch(bn)),
        ref_mont.mont_mul(ref.fq, to_jax(an), to_jax(bn)),
    )


def test_inverse_exp_and_batch_inverse_match_reference_toy():
    ref, port = CURVE_PAIRS["toy"]
    a, _ = field_operands(ref.q, 40, seed=5)  # includes zeros
    an = mont_limbs(ref.fq, a)
    ta, ja = to_torch(an), to_jax(an)
    assert_same(mont.inverse(port.fq, ta), ref_mont.inverse(ref.fq, ja))
    assert_same(mont.exp_const(port.fq, ta, 0), ref_mont.exp_const(ref.fq, ja, 0))
    assert_same(mont.exp_const(port.fq, ta, 1234567), ref_mont.exp_const(ref.fq, ja, 1234567))
    assert_same(mont.batch_inverse(port.fq, ta), ref_mont.batch_inverse(ref.fq, ja))
    # a batch with more than one axis, as to_affine of (L, W, B) buckets has
    a3 = an[:, :60].reshape(4, 5, 12)
    assert_same(mont.batch_inverse(port.fq, to_torch(a3)), ref_mont.batch_inverse(ref.fq, to_jax(a3)))


def test_inverse_and_batch_inverse_bls12_381_against_host():
    """Full width: against python's pow (the JAX compile of the scans costs
    more than this whole file); zero maps to zero."""
    _, port = CURVE_PAIRS["bls12_381"]
    fq = port.fq
    vals = edge_values(fq.q) + field_operands(fq.q, 8, seed=9)[0][-8:]
    t = to_torch(mont_limbs(fq, vals))
    want = mont_limbs(fq, [pow(v, fq.q - 2, fq.q) for v in vals])
    np.testing.assert_array_equal(torch_np(mont.batch_inverse(fq, t)), want)
    np.testing.assert_array_equal(torch_np(mont.inverse(fq, t[:, :3])), want[:, :3])


def test_inverse_wrapper_matches_reference_and_refuses_cpu_kernel():
    """kernels.inverse on CPU tensors is the plain Fermat ladder (the value
    of the JAX package's mont.inverse, bit for bit); it never stands in for
    the kernel when the kernel is asked for."""
    ref, port = CURVE_PAIRS["toy"]
    a, _ = field_operands(ref.q, 12, seed=6)  # includes 0, 1, q-1
    an = mont_limbs(ref.fq, a)
    assert_same(kernels.inverse(port.fq, to_torch(an)), ref_mont.inverse(ref.fq, to_jax(an)))
    assert_same(kernels.inverse(port.fq, to_torch(an), impl="plain"), ref_mont.inverse(ref.fq, to_jax(an)))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.inverse(port.fq, to_torch(an), impl="kernel")
    assert kernels.launches["inverse"] == 0


@pytest.mark.parametrize("name", sorted(CURVES))
def test_kernel_constant_blocks(name):
    """The host blocks the CUDA entry points copy into constant memory: q,
    R mod q, 3b (Montgomery; over Fq2 its component 0) as 12-word slots, np32
    and (over Fq2) 3b's component 1, from a host recomputation."""
    port = CURVES[name]
    fq = port.fq
    nw = fq.n_words
    if nw not in _build.SUPPORTED_WORDS:  # wider than the sources instantiate
        with pytest.raises(NotImplementedError):
            _build.field_consts(fq)
        return

    def words(block, slot):
        return sum(int(w) << (32 * i) for i, w in enumerate(block[12 * slot : 12 * slot + 12]))

    def slot3(block):  # 3b's component 1, after np32
        return sum(int(w) << (32 * i) for i, w in enumerate(block[37:49]))

    fb = _build.field_consts(fq)
    assert fb.dtype == np.uint32 and fb.shape == (49,) and not fb.flags.writeable
    assert words(fb, 0) == fq.q and words(fb, 1) == (1 << (32 * nw)) % fq.q and words(fb, 2) == 0
    assert (int(fb[36]) * fq.q + 1) % (1 << 32) == 0 and slot3(fb) == 0
    if port.ext == 1 and port.a == 0:
        cb = _build.curve_consts(port)
        assert words(cb, 2) == fq.to_mont_int(3 * port.b) and (cb[:24] == fb[:24]).all() and cb[36] == fb[36]
        assert slot3(cb) == 0
    elif port.ext == 2 and port.a == 0:
        cb = _build.curve_consts(port)
        b3 = tuple(3 * c % fq.q for c in port.b)
        assert words(cb, 2) == fq.to_mont_int(b3[0]) and slot3(cb) == fq.to_mont_int(b3[1])
        assert (cb[:24] == fb[:24]).all() and cb[36] == fb[36]
    else:
        with pytest.raises(NotImplementedError):
            _build.curve_consts(port)


def test_tower_fq_surface():
    """tower.Fq delegates to mont: const/one/zeros, mul_many == mul, to_host."""
    ref, port = CURVE_PAIRS["toy"]
    F, RF = Fq(port.fq), ref.field
    assert F.elem_len == RF.elem_len == 4
    assert_same(F.const(77, (3,)), RF.const(77, (3,)))
    assert_same(F.one((2,)), RF.one((2,)))
    a, b = field_operands(ref.q, 6, seed=2)
    ta, tb = to_torch(mont_limbs(ref.fq, a)), to_torch(mont_limbs(ref.fq, b))
    many = F.mul_many([(ta, tb), (tb, tb), (ta, ta)])
    for got, (x, y) in zip(many, [(ta, tb), (tb, tb), (ta, ta)]):
        assert torch.equal(got, F.mul(x, y))
    assert F.to_host(ta) == [v % ref.q for v in a]
    assert F.to_host(F.square(ta)) == [v * v % ref.q for v in a]
    with pytest.raises(TypeError):
        F.const((1, 2))
