"""PyTorch port: the plain field core's carry passes (ops/field/mont.py
_resolve: the serial pass over pairs of 16-bit limbs as 32-bit digits, and
the parallel pass of the wide form, from mont._WIDE_FROM limbs) against a
limb-by-limb pass written out here, on signed redundant limbs at the bounds
its callers give it (sums and differences of canonical limbs, the
Montgomery product's accumulator) and on the long carry and borrow ripples;
the wide form of the Montgomery product (one convolution) against the row
form; and Fq2's componentwise ops, one base op on both components, against
the base ops on each."""

import numpy as np
import pytest
import torch

from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.ops.field import mont
from zprize_wasm_msm_tpu_torch.ops.field.tower import Fq2


def resolve_by_limbs(x):
    out = torch.empty_like(x)
    carry = torch.zeros_like(x[0])
    for k in range(x.shape[0]):
        s = x[k] + carry
        out[k] = s & 0xFFFF
        carry = s >> 16
    return out, carry


PASSES = {"serial": mont._resolve_serial, "parallel": mont._resolve_parallel}


@pytest.mark.parametrize("K", [1, 2, 3, 24, 25, 49])
@pytest.mark.parametrize("bits", [17, 41, 46])
def test_resolve_matches_limb_by_limb(K, bits):
    g = torch.Generator().manual_seed(K * 100 + bits)
    x = torch.randint(-(1 << bits) + 1, 1 << bits, (K, 3, 512), generator=g)
    got, carry = mont._resolve(x.clone())  # it overwrites its argument
    want, want_carry = resolve_by_limbs(x)
    assert torch.equal(got, want) and torch.equal(carry, want_carry)


@pytest.mark.parametrize("K", [1, 3, 49, 97])
@pytest.mark.parametrize("bits", [16, 18, 41, 46])
def test_parallel_resolve_matches_limb_by_limb(K, bits):
    """The parallel pass (the wide form's, from mont._WIDE_FROM limbs), told
    the bound of its limbs (its bias and its number of passes follow it)."""
    g = torch.Generator().manual_seed(K * 100 + bits + 7)
    x = torch.randint(-(1 << bits) + 1, 1 << bits, (K, 3, 256), generator=g)
    got, carry = mont._resolve_parallel(x.clone(), bits)
    want, want_carry = resolve_by_limbs(x)
    assert torch.equal(got, want) and torch.equal(carry, want_carry)


@pytest.mark.parametrize("K", [2, 5, 24, 25, 49, 97])
@pytest.mark.parametrize("form", sorted(PASSES))
def test_resolve_ripples(K, form):
    """A carry through limbs of all ones and a borrow through zero limbs,
    entering at every limb, and both signs of the top carry."""
    ones = torch.full((K, K), 0xFFFF, dtype=torch.int64)
    zeros = torch.zeros((K, K), dtype=torch.int64)
    for k in range(K):
        ones[k, k] += 1
        zeros[k, k] -= 1
    x = torch.cat([ones, zeros, ones - (1 << 30), zeros + (1 << 40)], dim=1)
    got, carry = PASSES[form](x.clone())  # it may overwrite its argument
    want, want_carry = resolve_by_limbs(x)
    assert torch.equal(got, want) and torch.equal(carry, want_carry)
    assert bool((carry[:K] == 1).all()) and bool((carry[K : 2 * K] == -1).all())


def test_wide_product_convolution_is_the_rows():
    """From mont._WIDE_FROM limbs a product is one convolution (mont._conv)
    and a reduction by constant products whose carries run in parallel: the
    same words as the row form (L row updates, L reduction rounds, serial
    carries), on MNT6753's Fq (edge values, all-ones words, random values;
    broadcast and multi-axis batches; in parts of the batch too)."""
    fq = port_curves.mnt6753.fq
    L, q = fq.n_limbs, fq.q
    assert L >= mont._WIDE_FROM
    rng = np.random.default_rng(5)
    vals = [0, 1, q - 1, q // 2, q // 2 + 1, ((1 << (16 * (L - 1))) - 1) % q]
    vals += [int.from_bytes(rng.bytes(100), "little") % q for _ in range(30)]
    a = torch.cat([mont.full_const(fq, v, (1,)) for v in vals], dim=1)
    b = torch.cat([a, a.roll(5, dims=1)], dim=1).reshape(L, 2, -1)
    a2 = torch.stack([a, a.flip(1)], dim=1)
    c = a[:, 7:8, None]  # one element for the whole batch

    saved = mont._WIDE_FROM, mont._PART_BYTES
    for x, y in ((a2, b), (a2, c)):
        try:
            mont._WIDE_FROM = 1 << 30  # the row form at every width
            want = mont.mont_mul(fq, x, y)
        finally:
            mont._WIDE_FROM = saved[0]
        assert torch.equal(mont.mont_mul(fq, x, y), want)
        try:
            # the product in parts of five elements, the carry passes of seven
            mont._PART_BYTES = 8 * L * (2 * L + 1) * 5
            assert torch.equal(mont.mont_mul(fq, x, y), want)
        finally:
            mont._PART_BYTES = saved[1]


@pytest.mark.parametrize("name", ["toy_g2", "bls12_381_g2"])
def test_fq2_componentwise_ops_are_the_base_ops(name):
    curve = getattr(port_curves, name)
    F, fq = curve.field, curve.fq
    assert isinstance(F, Fq2)
    rng = np.random.default_rng(3)
    q = fq.q
    vals = [0, 1, q - 1, q // 2] + [int.from_bytes(rng.bytes(48), "little") % q for _ in range(60)]
    pairs = [(x, y) for x in vals[:8] for y in vals[:8]] + list(zip(vals, vals[::-1]))
    a = torch.cat([F.const(p, (1,)) for p in pairs], dim=1)
    b = torch.cat([F.const(p, (1,)) for p in pairs[::-1]], dim=1)
    L = fq.n_limbs
    for op in ("add", "sub"):
        got = getattr(F, op)(a, b)
        base = getattr(mont, op)
        want = torch.cat([base(fq, a[:L], b[:L]), base(fq, a[L:], b[L:])])
        assert torch.equal(got, want)
    assert torch.equal(F.neg(a), torch.cat([mont.neg(fq, a[:L]), mont.neg(fq, a[L:])]))
    a3 = a.reshape(2 * L, 2, -1)  # more than one batch axis
    assert torch.equal(F.add(a3, a3).reshape(2 * L, -1), F.add(a, a))
