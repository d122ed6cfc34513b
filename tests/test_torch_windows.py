"""PyTorch port, scalar windowing: digits exactly equal to the JAX
package's, and the same resolved MSM configuration for the same inputs."""

import numpy as np
import pytest

from zprize_wasm_msm_tpu.ops.msm import pippenger as ref_pippenger
from zprize_wasm_msm_tpu.ops.msm import windows as ref_windows
from zprize_wasm_msm_tpu_torch.ops.msm import pippenger, windows
from zprize_wasm_msm_tpu_torch.utils.limbs import ints_to_limbs

from tests._torch_helpers import CURVE_PAIRS, assert_same, to_jax, to_torch, torch_np


def _scalars(n_limbs, seed):
    rng = np.random.default_rng(seed)
    bits = 16 * n_limbs
    ks = [0, 1, (1 << bits) - 1, 1 << (bits - 1), 0x842, 0xFFFF, 0x12345]
    ks += [int.from_bytes(rng.bytes(n_limbs * 2), "little") for _ in range(25)]
    return ks, ints_to_limbs(ks, n_limbs)


@pytest.mark.parametrize(
    "n_limbs,c,max_bits",
    [(4, 4, 16), (4, 7, 16), (4, 4, 64), (4, 8, 64), (4, 15, 64), (4, 13, 64),
     (16, 7, 255), (16, 6, 132), (16, 8, 256), (16, 16, 256), (16, 7, 300)],
)
def test_window_digits_equal_reference(n_limbs, c, max_bits):
    ks, sc = _scalars(n_limbs, seed=c * 1000 + max_bits)
    np.testing.assert_array_equal(
        windows.raw_window_digits(to_torch(sc), c, max_bits).numpy(),
        np.asarray(ref_windows.raw_window_digits(to_jax(sc), c, max_bits)).astype(np.int64),
    )
    got = windows.signed_window_digits(to_torch(sc), c, max_bits)
    want = ref_windows.signed_window_digits(to_jax(sc), c, max_bits)
    assert_same(got, want)
    d = torch_np(got).astype(object)
    assert d.shape[0] == windows.num_windows(max_bits, c)
    half = 1 << (c - 1)
    assert d.max() <= half and d.min() >= -half
    if max_bits >= 16 * n_limbs:  # every scalar bit is covered: exact recode
        for i, k in enumerate(ks):
            assert sum(int(d[w, i]) << (w * c) for w in range(d.shape[0])) == k


def test_window_size_rules_equal_reference():
    for n in (0, 1, 2, 100, 1 << 10, 1 << 16, 1 << 20, 1 << 26):
        for mb in (16, 132, 255, 256):
            assert windows.default_window_size(n, mb) == ref_windows.default_window_size(n, mb)
            assert windows.sorted_engine_window_size(n, mb) == ref_windows.sorted_engine_window_size(n, mb)
    for mb in (16, 132, 255, 256):
        for c in range(1, 17):
            assert windows.num_windows(mb, c) == ref_windows.num_windows(mb, c)


@pytest.mark.parametrize("name", ["toy", "bls12_381"])
def test_resolve_config_equals_reference(name):
    """Same (engine, c, lanes) as the reference for every input the tests
    feed both packages: kernel <-> pallas, plain <-> xla."""
    ref, port = CURVE_PAIRS[name]
    names = {"kernel": "pallas", "plain": "xla"}
    for impl in ("kernel", "plain"):
        for N in (1, 40, 1 << 12, 1 << 20):
            for mb in (16, 132, 255):
                for c in (None, 4, 7):
                    for lanes in (None, 8):
                        got = pippenger.resolve_config(port, N, mb, c, lanes, 2 << 30, impl)
                        want = ref_pippenger.resolve_config(ref, N, mb, c, lanes, 2 << 30, names[impl])
                        assert (names[got[0]], got[1], got[2]) == want, (impl, N, mb, c, lanes)
    # the headline configuration
    assert pippenger.resolve_config(port, 1 << 20, 255, None, None, 2 << 30, "kernel")[1] == 7
    assert windows.num_windows(255, 7) == 38
    # auto follows the tensors' device; a window above the bucket kernel's cap
    # routes to the sorted engine, as the reference's "pallas" does
    assert pippenger.resolve_config(port, 8, 16, 4, 2, 2 << 30, "auto", device="cpu")[0] == "plain"
    with pytest.raises(ValueError):
        pippenger.resolve_config(port, 8, 16, 4, 2, 2 << 30, "auto")
    with pytest.raises(ValueError):
        pippenger.resolve_config(port, 8, 16, 4, 2, 2 << 30, "pallas")
    assert pippenger.resolve_config(port, 1 << 10, 128, 12, None, 2 << 30, "kernel") == ("kernel-sorted", 12, None)
    assert ref_pippenger.resolve_config(ref, 1 << 10, 128, 12, None, 2 << 30, "pallas") == ("pallas-sorted", 12, None)
    assert pippenger.resolve_config(port, 1 << 10, 128, 7, None, 2 << 30, "kernel")[0] == "kernel"


def test_kernel_engine_refuses_curves_it_does_not_cover():
    """A general-a curve or a cubic extension field asked for on the kernel
    engine raises; it is never rewritten to the plain engine.  "auto" picks
    the plain engine for them on every device, as the reference's
    resolve_config sends them to its jnp engine
    (zprize_wasm_msm_tpu/ops/msm/pippenger.py:334-337).  (G2 curves over
    Fq2 take the bucket kernel engine: tests/test_torch_g2.py.)"""
    from zprize_wasm_msm_tpu_torch.models.curves import CURVES

    uncovered = [c for c in CURVES.values() if c.ext not in (1, 2) or c.a != 0]
    assert uncovered
    for curve in uncovered:
        for impl in ("kernel", "kernel-sorted"):
            with pytest.raises(NotImplementedError, match="jnp engine"):
                pippenger.resolve_config(curve, 64, 16, 4, 2, 2 << 30, impl)
        for device in ("cuda", "cpu"):
            assert pippenger.resolve_config(curve, 64, 16, None, None, 2 << 30, "auto", device=device)[0] == "plain"
        assert pippenger.resolve_config(curve, 64, 16, 4, 2, 2 << 30, "plain") == ("plain", 4, 2)
        assert pippenger.resolve_config(curve, 64, 16, 4, 2, 2 << 30, "auto", device="cpu")[0] == "plain"
