"""PyTorch port: the plain field core's carry pass (ops/field/mont.py
_resolve), which walks pairs of 16-bit limbs as 32-bit digits, against a
limb-by-limb pass written out here, on signed redundant limbs at the bounds
its callers give it (sums and differences of canonical limbs, the
Montgomery product's accumulator) and on the long carry and borrow
ripples; and Fq2's componentwise ops, one base op on both components,
against the base ops on each."""

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


@pytest.mark.parametrize("K", [1, 2, 3, 24, 25, 49])
@pytest.mark.parametrize("bits", [17, 41, 46])
def test_resolve_matches_limb_by_limb(K, bits):
    g = torch.Generator().manual_seed(K * 100 + bits)
    x = torch.randint(-(1 << bits) + 1, 1 << bits, (K, 3, 512), generator=g)
    got, carry = mont._resolve(x.clone())  # it overwrites its argument
    want, want_carry = resolve_by_limbs(x)
    assert torch.equal(got, want) and torch.equal(carry, want_carry)


@pytest.mark.parametrize("K", [2, 5, 24, 25])
def test_resolve_ripples(K):
    """A carry through limbs of all ones and a borrow through zero limbs,
    entering at every limb, and both signs of the top carry."""
    ones = torch.full((K, K), 0xFFFF, dtype=torch.int64)
    zeros = torch.zeros((K, K), dtype=torch.int64)
    for k in range(K):
        ones[k, k] += 1
        zeros[k, k] -= 1
    x = torch.cat([ones, zeros, ones - (1 << 30), zeros + (1 << 40)], dim=1)
    got, carry = mont._resolve(x.clone())  # it overwrites its argument
    want, want_carry = resolve_by_limbs(x)
    assert torch.equal(got, want) and torch.equal(carry, want_carry)
    assert bool((carry[:K] == 1).all()) and bool((carry[K : 2 * K] == -1).all())


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
