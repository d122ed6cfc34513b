"""PyTorch port: the Fr NTT and its snarkjs helpers (ops/poly/fft.py) bit for
bit against the JAX package, on toy_fft's Fr and BLS12-381's Fr; the group
FFT on toy_fft in affine."""

import numpy as np
import pytest
import torch

from zprize_wasm_msm_tpu.models import curves as ref_curves
from zprize_wasm_msm_tpu.ops.curve import group as ref_group
from zprize_wasm_msm_tpu.ops.poly import fft as ref_fft
from zprize_wasm_msm_tpu.oracle import ntt as ref_ntt
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.models.context import build_curve
from zprize_wasm_msm_tpu_torch.ops.curve import group
from zprize_wasm_msm_tpu_torch.ops.poly import fft
from zprize_wasm_msm_tpu_torch.oracle import ntt
from zprize_wasm_msm_tpu_torch.utils.limbs import ints_to_limbs, limbs_to_ints

from tests._torch_helpers import assert_same, mont_limbs, oracle_of, to_jax, to_torch, torch_np

FIELDS = {
    "toy_fft": (ref_curves.toy_fft.fr, port_curves.toy_fft.fr),
    "bls12_381": (ref_curves.bls12_381.fr, port_curves.bls12_381.fr),
}


def _fr_batch(spec, n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % spec.q for _ in range(n)]
    return vals, mont_limbs(spec, vals)


@pytest.mark.parametrize("field,n", [("toy_fft", 8), ("bls12_381", 1), ("bls12_381", 2),
                                     ("bls12_381", 8), ("bls12_381", 32)])
def test_fft_ifft_match_jax(field, n):
    """fft, its unscaled inverse and ifft: the JAX package's limbs, and the
    forward transform equals the O(n^2) oracle."""
    ref_spec, spec = FIELDS[field]
    vals, x = _fr_batch(spec, n, seed=n)
    got = fft.fft(spec, to_torch(x))
    assert_same(got, ref_fft.fft(ref_spec, to_jax(x)))
    assert_same(fft.fft(spec, to_torch(x), inverse=True), ref_fft.fft(ref_spec, to_jax(x), True))
    assert_same(fft.ifft(spec, got), ref_fft.ifft(ref_spec, to_jax(torch_np(got))))
    assert torch.equal(fft.ifft(spec, got), to_torch(x))
    if n > 1:
        want = ntt(vals, spec.q, fft._root_of_unity(spec.q, n))
        assert [spec.from_mont_int(v) for v in limbs_to_ints(torch_np(got))] == want


def test_fft_impls_agree_and_kernel_refuses_cpu():
    """impl='plain' and 'auto' give one result on the CPU; impl='kernel' on a
    CPU tensor raises (no silent stand-in), as every kernel wrapper does."""
    _, spec = FIELDS["bls12_381"]
    _, x = _fr_batch(spec, 16, seed=3)
    xt = to_torch(x)
    assert torch.equal(fft.fft(spec, xt, impl="plain"), fft.fft(spec, xt))
    ctx = build_curve(port_curves.bls12_381, device="cpu")
    assert torch.equal(ctx.ifft(ctx.fft(xt)), xt)
    with pytest.raises(ValueError):
        fft.fft(spec, xt, impl="kernel")


def test_host_tables_match_jax():
    ref_spec, spec = FIELDS["bls12_381"]
    for n in (2, 16, 1 << 10):
        assert fft._root_of_unity(spec.q, n) == ref_fft._root_of_unity(ref_spec.q, n)
        for inverse in (False, True):
            np.testing.assert_array_equal(
                fft._twiddle_table(spec.q, spec.n_limbs, n, inverse),
                ref_fft._twiddle_table(ref_spec.q, ref_spec.n_limbs, n, inverse),
            )
        np.testing.assert_array_equal(fft._bitrev_perm(n), ref_fft._bitrev_perm(n))
    for bits in (2, 3, 20):
        assert fft._shift_consts(spec.q, bits) == ref_fft._shift_consts(ref_spec.q, bits)


@pytest.mark.parametrize("field", ["toy_fft", "bls12_381"])
def test_snarkjs_helpers_match_jax(field):
    """fft_join, fft_mix, fft_final, fft_join_ext(_inv) and
    prepare_lagrange_evaluation on the same buffers."""
    ref_spec, spec = FIELDS[field]
    n, total_bits = 8, 3
    _, b1 = _fr_batch(spec, n, seed=11)
    _, b2 = _fr_batch(spec, n, seed=12)
    _, fi = _fr_batch(spec, 2, seed=13)
    first, inc = fi[:, 0], fi[:, 1]
    t, j = (to_torch(b1), to_torch(b2), to_torch(first), to_torch(inc)), \
        (to_jax(b1), to_jax(b2), to_jax(first), to_jax(inc))
    assert_same(fft.fft_join(spec, *t), ref_fft.fft_join(ref_spec, *j))
    for exp in (1, 2, 3):
        assert_same(fft.fft_mix(spec, t[0], exp), ref_fft.fft_mix(ref_spec, j[0], exp))
    assert_same(fft.fft_final(spec, t[0], t[2]), ref_fft.fft_final(ref_spec, j[0], j[2]))
    for name in ("fft_join_ext", "fft_join_ext_inv", "prepare_lagrange_evaluation"):
        assert_same(getattr(fft, name)(spec, *t, total_bits),
                    getattr(ref_fft, name)(ref_spec, *j, total_bits), name)


def test_group_fft_matches_jax_in_affine():
    """group_fft and group_ifft over toy_fft points k_i G: the JAX package's
    affine points, FFT(k_i G) = NTT(k) G, and the round trip."""
    ref_curve, curve = ref_curves.toy_fft, port_curves.toy_fft
    fr = curve.fr
    n = 8
    rng = np.random.default_rng(7)
    ks = [int(rng.integers(1, curve.r)) for _ in range(n)]
    sc = ints_to_limbs(ks, fr.n_limbs)
    pts = group.times_scalar(curve, group.generator(curve, (n,)), to_torch(sc))
    ref_pts = ref_group.times_scalar(ref_curve, ref_group.generator(ref_curve, (n,)), to_jax(sc))
    for inverse in (False, True):
        got = fft.group_fft(curve, pts, inverse)
        want = ref_fft.group_fft(ref_curve, ref_pts, inverse)
        assert_same(group.to_affine(curve, got), ref_group.to_affine(ref_curve, want))
    got = fft.group_fft(curve, pts)
    F = curve.field
    ax, ay = group.to_affine(curve, got)
    oc = oracle_of(curve)
    want_k = ntt(ks, fr.q, fft._root_of_unity(fr.q, n))
    assert list(zip(F.to_host(ax), F.to_host(ay))) == [oc.mul(oc.g, k) for k in want_k]
    back = fft.group_ifft(curve, got)
    assert_same(group.to_affine(curve, back), group.to_affine(curve, pts))
    assert_same(group.to_affine(curve, back),
                ref_group.to_affine(ref_curve, ref_fft.group_ifft(ref_curve, ref_fft.group_fft(ref_curve, ref_pts))))


def test_oracle_ntt_matches_jax_oracle():
    """The port's oracle.ntt (a table of the n powers) against the JAX
    package's (a pow a term), on BLS12-381 Fr at n = 16."""
    _, spec = FIELDS["bls12_381"]
    vals, _ = _fr_batch(spec, 16, seed=21)
    root = fft._root_of_unity(spec.q, 16)
    assert ntt(vals, spec.q, root) == ref_ntt(vals, spec.q, root)
