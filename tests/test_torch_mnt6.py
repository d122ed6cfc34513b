"""PyTorch port: the MNT6-753 ate pairing's pieces (ops/pairing/mnt6.py)
against the JAX package's ops/pairing/mnt6.py, the same numpy inputs through
both at two columns, limbs bit for bit (tolerance zero): the spec's
Frobenius coefficients and loop count, the Fq6 product, square, inverse,
Frobenius maps and cyclotomic square, and one doubling and one addition
step of the Miller loop with their line coefficients.

The whole pairing (376 Miller steps and the final exponentiation) is held
on the card: chip_smoke.py's mnt6753 phase checks bilinearity and
non-degeneracy and a Groth16 verify.  The JAX side runs op by op here
(tests/_torch_helpers.jax_stages_eager), as its pairing compiles for
minutes on the CPU.
"""

import numpy as np
import pytest
import torch

from zprize_wasm_msm_tpu.ops.pairing import mnt6 as ref_mnt6

from zprize_wasm_msm_tpu_torch.ops.pairing import mnt6

from tests._torch_helpers import assert_same, jax_stages_eager, mont_limbs, to_jax, to_torch


@pytest.fixture(scope="module")
def specs():
    return mnt6.get_mnt6753_spec(), ref_mnt6.get_mnt6753_spec()


def _elems(fq, k, seed):
    """(k L, 2) Montgomery limbs: k components of two random elements."""
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [mont_limbs(fq, [int.from_bytes(rng.bytes(100), "little") % fq.q for _ in range(2)]) for _ in range(k)]
    )


def test_spec_constants_match_reference(specs):
    ps, rps = specs
    assert ps.loop_count == rps.loop_count == mnt6.MNT6753_ATE_LOOP
    assert ps.loop_bits == rps.loop_bits
    assert ps.frob_gammas == rps.frob_gammas
    assert mnt6._naf_digits_msb(ps.loop_count) == ref_mnt6._naf_digits_msb(rps.loop_count)


@pytest.mark.parametrize("op", ["mul", "square", "inverse", "frobenius", "cyclotomic_square", "conjugate"])
def test_f6_op_matches_reference(specs, op):
    """The inverse is unique, so a a^{-1} = 1 pins its limbs: it is checked
    so (the JAX package's 753-bit Fermat ladder takes ~25 s here op by op;
    its Fq3 cofactor formula is held against the port's on toy_g3,
    tests/test_torch_g3.py)."""
    ps, rps = specs
    fq = ps.g1.fq
    a, b = _elems(fq, 6, 51), _elems(fq, 6, 52)
    if op == "inverse":
        ta = to_torch(a)
        one = mnt6.f6_one(ps, (2,))
        assert torch.equal(mnt6.f6_mul(ps, ta, mnt6.f6_inverse(ps, ta)), one)
        assert torch.equal(mnt6.f6_inverse(ps, one), one)
        return
    with jax_stages_eager(ref_mnt6):
        if op == "mul":
            pairs = [(mnt6.f6_mul(ps, to_torch(a), to_torch(b)), ref_mnt6.f6_mul(rps, to_jax(a), to_jax(b)))]
        elif op == "frobenius":
            pairs = [(mnt6.f6_frobenius(ps, to_torch(a), n), ref_mnt6.f6_frobenius(rps, to_jax(a), n))
                     for n in (1, 2, 3)]
        else:
            f, rf = getattr(mnt6, f"f6_{op}"), getattr(ref_mnt6, f"f6_{op}")
            pairs = [(f(ps, to_torch(a)), rf(rps, to_jax(a)))]
        for got, want in pairs:
            assert_same(got, want, op)


def test_miller_steps_match_reference(specs):
    """One doubling step and one addition step on a generic state
    (X, Y, Z, T over Fq3), with the line coefficients they return."""
    ps, rps = specs
    fq = ps.g1.fq
    R = tuple(_elems(fq, 3, 60 + i) for i in range(4))
    QX, QY = _elems(fq, 3, 70), _elems(fq, 3, 71)
    with jax_stages_eager(ref_mnt6):
        QY2 = ref_mnt6.Fq3(rps.g1.fq, 11).square(to_jax(QY))
        got = mnt6._dbl_step(ps, tuple(to_torch(c) for c in R))
        want = ref_mnt6._dbl_step(rps, tuple(to_jax(c) for c in R))
        assert_same(got[0] + got[1], want[0] + want[1], "dbl")
        got = mnt6._add_step(ps, tuple(to_torch(c) for c in R), to_torch(QX), to_torch(QY),
                             ps.f3.square(to_torch(QY)))
        want = ref_mnt6._add_step(rps, tuple(to_jax(c) for c in R), to_jax(QX), to_jax(QY), QY2)
        assert_same(got[0] + got[1], want[0] + want[1], "add")
