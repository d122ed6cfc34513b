"""PyTorch port, multi-limb integer layer: every ops.field.intops function
against the JAX package's on the same numpy inputs, limb for limb
(integers: tolerance 0), and against python ints."""

import numpy as np
import pytest

from zprize_wasm_msm_tpu.ops.field import intops as ref_intops
from zprize_wasm_msm_tpu_torch.ops.field import intops
from zprize_wasm_msm_tpu_torch.utils.limbs import ints_to_limbs, limbs_to_ints

from tests._torch_helpers import CURVE_PAIRS, assert_same, to_jax, to_torch, torch_np

R_381 = CURVE_PAIRS["bls12_381"][1].r


def _values(n_limbs, seed, n_random=20):
    rng = np.random.default_rng(seed)
    top = 1 << (16 * n_limbs)
    vals = [0, 1, 0xFFFF, 0x10000, top - 1, top >> 1, (top >> 1) - 1, R_381 % top, (R_381 - 1) % top]
    vals += [int.from_bytes(rng.bytes(2 * n_limbs), "little") for _ in range(n_random)]
    return vals


def _pair(n_limbs, seed):
    a = _values(n_limbs, seed)
    b = list(reversed(_values(n_limbs, seed + 1)))
    return a, b, ints_to_limbs(a, n_limbs), ints_to_limbs(b, n_limbs)


def _ints(t):
    return limbs_to_ints(torch_np(t))


@pytest.mark.parametrize("n_limbs", [4, 16, 24])
def test_int_add_sub_equal_reference(n_limbs):
    a, b, al, bl = _pair(n_limbs, seed=n_limbs)
    top = 1 << (16 * n_limbs)
    for name in ("int_add", "int_sub"):
        got = getattr(intops, name)(to_torch(al), to_torch(bl))
        want = getattr(ref_intops, name)(to_jax(al), to_jax(bl))
        assert_same(got, want, name)
    s, carry = intops.int_add(to_torch(al), to_torch(bl))
    d, borrow = intops.int_sub(to_torch(al), to_torch(bl))
    assert set(carry.tolist()) <= {0, 1} and set(borrow.tolist()) <= {0, 1}
    for x, y, si, ci, di, bi in zip(a, b, _ints(s), carry.tolist(), _ints(d), borrow.tolist()):
        assert si + (ci << (16 * n_limbs)) == x + y
        assert di == (x - y) % top and bi == int(x < y)


@pytest.mark.parametrize("la,lb,out_limbs", [(4, 4, None), (16, 8, None), (16, 9, 25), (24, 16, 24), (8, 8, 20)])
def test_int_mul_equals_reference(la, lb, out_limbs):
    a = _values(la, seed=la)
    b = _values(lb, seed=lb + 100)[: len(a)]
    al, bl = ints_to_limbs(a, la), ints_to_limbs(b, lb)
    got = intops.int_mul(to_torch(al), to_torch(bl), out_limbs)
    assert_same(got, ref_intops.int_mul(to_jax(al), to_jax(bl), out_limbs))
    width = 16 * (out_limbs if out_limbs is not None else la + lb)
    assert _ints(got) == [(x * y) % (1 << width) for x, y in zip(a, b)]


@pytest.mark.parametrize("n_limbs,const,out_limbs", [(16, R_381, None), (16, (1 << 127) + 12345, 25), (24, 3, 24), (4, 0xFFFF, None)])
def test_int_mul_const_equals_reference(n_limbs, const, out_limbs):
    a = _values(n_limbs, seed=n_limbs + 7)
    al = ints_to_limbs(a, n_limbs)
    got = intops.int_mul_const(to_torch(al), const, out_limbs)
    assert_same(got, ref_intops.int_mul_const(to_jax(al), const, out_limbs))
    if out_limbs is None:
        assert _ints(got) == [x * const for x in a]


@pytest.mark.parametrize("n_limbs,k,out_limbs", [(16, 0, 16), (16, 5, 16), (24, 16, 16), (8, 8, 3), (8, 12, 2), (8, 2, 4)])
def test_shift_pad_and_predicates_equal_reference(n_limbs, k, out_limbs):
    a, b, al, bl = _pair(n_limbs, seed=n_limbs + k)
    got = intops.int_shr_limbs(to_torch(al), k, out_limbs)
    assert_same(got, ref_intops.int_shr_limbs(to_jax(al), k, out_limbs))
    assert _ints(got) == [(x >> (16 * k)) % (1 << (16 * out_limbs)) for x in a]
    for width in (out_limbs, n_limbs, n_limbs + 5):
        assert_same(intops.pad_limbs(to_torch(al), width), ref_intops.pad_limbs(to_jax(al), width))
    bl[:, :3] = al[:, :3]  # equal operands: a >= b holds
    assert_same(intops.int_gte(to_torch(al), to_torch(bl)), ref_intops.int_gte(to_jax(al), to_jax(bl)))
    assert intops.int_gte(to_torch(al), to_torch(bl)).tolist()[:3] == [True] * 3
    assert_same(intops.int_is_zero(to_torch(al)), ref_intops.int_is_zero(to_jax(al)))
    assert intops.int_is_zero(to_torch(al)).tolist() == [x == 0 for x in a]


@pytest.mark.parametrize("n_limbs,divisor", [(16, R_381), (24, R_381), (16, (1 << 200) + 1), (4, 10007)])
def test_barrett_div_equals_reference(n_limbs, divisor):
    """floor(x / d), the two corrections included: multiples of d and their
    neighbours sit on the estimate's edge."""
    top = 1 << (16 * n_limbs)
    x = _values(n_limbs, seed=n_limbs + 11)
    x += [v % top for m in (1, 2, 7) for v in (m * divisor - 1, m * divisor, m * divisor + 1)]
    xl = ints_to_limbs(x, n_limbs)
    got = intops.barrett_div(to_torch(xl), divisor)
    assert_same(got, ref_intops.barrett_div(to_jax(xl), divisor))
    assert _ints(got) == [v // divisor for v in x]


def test_batch_axes_broadcast_as_in_reference():
    """(L, n, m) batches and (L, 1, 1) constants, as glv feeds them."""
    a = _values(8, seed=3)[:12]
    al = ints_to_limbs(a, 8).reshape(8, 3, 4)
    got = intops.barrett_div(to_torch(al), 10007)
    assert_same(got, ref_intops.barrett_div(to_jax(al), 10007))
    assert got.shape == (8, 3, 4)
