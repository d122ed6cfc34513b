"""PyTorch port, G2: the lanes of the Fq2 bucket sweep fitted to whole waves.

pippenger.fit_lanes picks the kernel engine's lanes per window over Fq2
from (W, N, resident threads) alone, so it is checked here as a pure
function at path G2's shape (W = 44, N = 2^20) over a range of residencies.
The lanes it picks need not divide N or be a power of two: the plain engine
at such a lane count (N padded with zero digits) is held against the JAX
package's bucket sums and MSM on toy_g2, as affine points.
"""

import numpy as np
import pytest

from zprize_wasm_msm_tpu.ops.msm import pippenger as ref_pippenger
from zprize_wasm_msm_tpu.ops.msm import windows as ref_windows

import zprize_wasm_msm_tpu_torch as ZT
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.ops.msm import pippenger, pl_bucket, windows

from tests._torch_helpers import to_jax, to_torch
from tests.test_torch_g2 import BITS, C, T, _msm_inputs, curves_of, oracle_of, port_affine, ref_affine

#: path G2: BLS12-381 G2, 2^20 points, 256-bit scalars at c = 6
W_G2, N_G2 = 44, 1 << 20
SMS = 132


def cost(W, N, R, lanes):
    """Rounds of waves times the steps of each thread's chain."""
    return -(-W * lanes // R) * -(-N // lanes)


@pytest.mark.parametrize("warps_per_sm", [4, 5, 6, 7, 8, 10, 12, 16])
def test_fit_lanes_minimises_rounds_times_steps_at_path_g2(warps_per_sm):
    R = warps_per_sm * 32 * SMS
    lanes = pippenger.fit_lanes(W_G2, N_G2, R)
    assert lanes % 32 == 0 and 32 <= lanes <= N_G2
    best = min(cost(W_G2, N_G2, R, t) for t in range(32, N_G2 + 1, 32))
    assert cost(W_G2, N_G2, R, lanes) == best
    # the smallest lane count of that cost: fewer partials for the lane reduction
    assert all(cost(W_G2, N_G2, R, t) > best for t in range(32, lanes, 32))
    # within one step a thread of the ideal W N / R, and at or below doubling from 1 024
    assert best <= -(-W_G2 * N_G2 // R) + -(-N_G2 // lanes)
    doubled = 1024
    while W_G2 * 2 * doubled <= R and 2 * doubled <= N_G2:
        doubled *= 2
    assert best <= cost(W_G2, N_G2, R, doubled)


def test_fit_lanes_known_values():
    """5 warps a SM (the Fq2 sweep before its shared slots were cut): 480
    lanes, one round of 2 185 steps, against 1 024 lanes' 3 rounds of 1 024;
    8 warps: 768 lanes, 1 366 steps."""
    assert pippenger.fit_lanes(W_G2, N_G2, 5 * 32 * SMS) == 480
    assert cost(W_G2, N_G2, 5 * 32 * SMS, 480) == 2185
    assert cost(W_G2, N_G2, 5 * 32 * SMS, 1024) == 3 * 1024
    assert pippenger.fit_lanes(W_G2, N_G2, 8 * 32 * SMS) == 768
    assert cost(W_G2, N_G2, 8 * 32 * SMS, 768) == 1366
    assert pippenger.fit_lanes(W_G2, 1 << 16, 8 * 32 * SMS) == 768  # BN254 G2 at 2^16
    assert pippenger.fit_lanes(W_G2, 10, 8 * 32 * SMS) == 32  # fewer points than a warp
    for bad in ((0, N_G2, 1), (W_G2, 0, 1), (W_G2, N_G2, 0)):
        with pytest.raises(ValueError):
            pippenger.fit_lanes(*bad)


def test_kernel_lanes_fit_waves_over_fq2_only(monkeypatch):
    """The kernel engine's lane choice: fit_lanes over Fq2, the doubling
    rule over Fq (unchanged), lanes named by the caller as given."""
    monkeypatch.setattr(pl_bucket, "resident_threads", lambda curve, device: 8 * 32 * SMS)
    g2, g1 = port_curves.bls12_381_g2, port_curves.bls12_381
    assert pippenger._kernel_lanes(g2, W_G2, N_G2, None, "cpu") == 768
    assert pippenger._kernel_lanes(g2, W_G2, N_G2, 1024, "cpu") == 1024
    monkeypatch.setattr(pl_bucket, "resident_threads", lambda curve, device: 50688)
    assert pippenger._kernel_lanes(g1, 38, N_G2, None, "cpu") == 1024
    assert pippenger._kernel_lanes(g1, 23, 1 << 21, None, "cpu") == 2048


@pytest.mark.parametrize("lanes", [5, 7])
def test_g2_window_sums_at_lanes_that_do_not_divide_n_match_reference(lanes):
    """The plain engine's bucket sums and window sums on toy_g2 at a lane
    count that leaves N = 12 points ragged (padded with zero digits), against
    the JAX package's at its own lane count (sums of the same points, so
    equal as group elements)."""
    ref, port = curves_of("toy_g2")
    pts, ks, XY, sc = _msm_inputs(port, seed=31)
    jdigits = ref_windows.signed_window_digits(to_jax(sc), C, BITS)
    jbuckets = ref_pippenger.bucket_accumulate_c(ref, to_jax(XY), jdigits, T, C)
    jsums = ref_pippenger.bucket_reduce(ref, jbuckets)
    digits = windows.signed_window_digits(to_torch(sc), C, BITS)
    assert digits.shape[1] % lanes != 0
    buckets = pl_bucket.bucket_accumulate(port, to_torch(XY), digits, lanes=lanes, c=C)
    assert port_affine(port, buckets) == ref_affine(port, tuple(np.asarray(b) for b in jbuckets))
    sums = pippenger.window_sums(port, to_torch(XY), digits, C, lanes=lanes, impl="plain")
    assert port_affine(port, sums) == ref_affine(port, tuple(np.asarray(s) for s in jsums))


def test_g2_msm_at_lanes_that_do_not_divide_n_matches_reference():
    """ctx.msm on toy_g2 (plain engine) at 5 lanes against the JAX package's
    MSM (impl="xla", its own lanes) and the oracle."""
    ref, port = curves_of("toy_g2")
    pts, ks, XY, sc = _msm_inputs(port, seed=31)
    jres = ref_pippenger.msm(ref, to_jax(XY), to_jax(sc), c=C, max_bits=BITS, lanes=T, impl="xla")
    want = ref_affine(port, tuple(np.asarray(x)[:, None] for x in jres))
    ctx = ZT.build_curve(port, device="cpu")
    got = ctx.msm(to_torch(XY), to_torch(sc), c=C, max_bits=BITS, lanes=5)
    assert port_affine(port, got) == want == [oracle_of(port).msm(pts, ks)]
