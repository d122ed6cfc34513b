"""PyTorch port, MSM layer: bucket accumulation, lane reduction, collapse,
finish and the whole msm against the JAX package — its Pallas kernels run as
tests/test_kernels.py runs them (TPU interpret mode on the CPU) and its jnp
engine (impl="xla") — on the toy curve.

Everything is compared as AFFINE points with tolerance zero: the values are
integers, and only the projective representative may differ between two
engines, because they add the same points in different orders.  On CPU
tensors the port's wrappers run their plain PyTorch versions; the CUDA
kernels themselves are held against those on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from zprize_wasm_msm_tpu.ops.curve import group as ref_group
from zprize_wasm_msm_tpu.ops.msm import pippenger as ref_pippenger
from zprize_wasm_msm_tpu.ops.msm import pl_bucket as ref_pl_bucket
from zprize_wasm_msm_tpu.ops.msm import pl_reduce as ref_pl_reduce
from zprize_wasm_msm_tpu.ops.msm import windows as ref_windows

import zprize_wasm_msm_tpu_torch as ZT
from zprize_wasm_msm_tpu_torch.ops.curve import device_check, group
from zprize_wasm_msm_tpu_torch.ops.msm import pippenger, pl_bucket, pl_reduce, windows
from zprize_wasm_msm_tpu_torch.utils.limbs import ints_to_limbs

from tests._torch_helpers import (
    CURVE_PAIRS, affine_np, host_points, jax_np, oracle_of, random_points, to_jax, to_torch,
    torch_np,
)

REF_TOY, TOY = CURVE_PAIRS["toy"]
# One small configuration for every comparison that runs a Pallas kernel in
# interpret mode: W = 3 windows of B = 4 buckets, 2 lanes.  Each such call
# costs 10-25 s on the CPU whatever its size (the finish kernel's grid is
# ~c (W - 1) + 15 interpreted steps), so they are few and share their shapes.
C, T, N, BITS = 3, 2, 12, 8


def ref_affine(res):
    """JAX projective batch (any batch shape) -> python affine points."""
    flat = tuple(np.asarray(c).reshape(np.asarray(c).shape[0], -1) for c in res)
    x, y = ref_group.to_affine(REF_TOY, to_jax(flat))
    return host_points(TOY, np.asarray(x), np.asarray(y))


def port_affine(res):
    flat = tuple(c.reshape(c.shape[0], -1) for c in res)
    x, y = torch_np(group.to_affine(TOY, flat))
    return host_points(TOY, x, y)


def _inputs(n, seed, bits=16):
    rng = np.random.default_rng(seed)
    pts = random_points(TOY, n, seed, bound=TOY.r)
    pts[2] = None  # the affine identity (0,0) in the batch
    pts[5] = pts[4]  # a repeated point: the doubling case inside a bucket
    ks = [int(rng.integers(0, min(TOY.r, 1 << bits))) for _ in range(n)]
    ks[0] = 0
    ks[5] = ks[4]
    XY = affine_np(TOY, pts)
    sc = ints_to_limbs(ks, TOY.fr.n_limbs)
    return pts, ks, XY, sc


@pytest.fixture(scope="module")
def shared():
    """One run of the JAX side, shared by the stage tests below."""
    pts, ks, XY, sc = _inputs(N, seed=31, bits=BITS)
    digits = ref_windows.signed_window_digits(sc, C, BITS)
    jXY = to_jax(XY)
    with pltpu.force_tpu_interpret_mode():
        raw = ref_pl_bucket.bucket_accumulate(REF_TOY, jXY, digits, lanes=T, c=C, raw=True)
        buckets = ref_pl_reduce.lane_reduce(REF_TOY, raw)  # (L, W, B)
        finish_pt = ref_pl_reduce.finish(REF_TOY, buckets, C)
        large_pt = ref_pl_reduce.finish_large(REF_TOY, buckets, C)
    xla_buckets = ref_pippenger._bucket_accumulate_impl(REF_TOY, jXY, digits, T, C)
    return dict(
        pts=pts, ks=ks, XY=XY, sc=sc, digits=np.asarray(digits), raw=jax_np(raw),
        buckets=jax_np(buckets), finish_pt=jax_np(finish_pt), large_pt=jax_np(large_pt),
        xla_buckets=jax_np(xla_buckets), expected=oracle_of(TOY).msm(pts, ks),
    )


def test_bucket_accumulate_matches_reference_kernel_and_jnp(shared):
    digits = windows.signed_window_digits(to_torch(shared["sc"]), C, BITS)
    np.testing.assert_array_equal(torch_np(digits), shared["digits"])
    got = pl_bucket.bucket_accumulate(TOY, to_torch(shared["XY"]), digits, lanes=T, c=C)
    assert got[0].shape == shared["buckets"][0].shape  # (L, W, B)
    got_aff = port_affine(got)
    assert got_aff == ref_affine(shared["buckets"])  # Pallas kernel, interpret mode
    assert got_aff == ref_affine(shared["xla_buckets"])  # jnp engine
    # and against the definition: bucket (w, b) = sum of +-P_i with digit +-(b+1)
    oc, d = oracle_of(TOY), shared["digits"]
    B = 1 << (C - 1)
    for w in (0, d.shape[0] - 2):
        for b in range(B):
            want = None
            for i, p in enumerate(shared["pts"]):
                if abs(int(d[w, i])) == b + 1:
                    want = oc.add(want, p if d[w, i] > 0 else oc.neg(p))
            assert got_aff[w * B + b] == want
    # ragged N: padding with (0,0) points and zero digits changes nothing
    ragged = pl_bucket.bucket_accumulate(TOY, to_torch(shared["XY"]), digits, lanes=5, c=C)  # 12 -> 15
    assert port_affine(ragged) == got_aff


def test_lane_reduce_matches_reference(shared):
    """K4's contract: (B, L, W, T) lane partials -> (L, W, B)."""
    got = pl_reduce.lane_reduce(TOY, to_torch(shared["raw"]))
    assert got[0].shape == shared["buckets"][0].shape
    assert port_affine(got) == ref_affine(shared["buckets"])


def test_finish_matches_reference(shared):
    got = pl_reduce.finish(TOY, to_torch(shared["buckets"]), C)
    assert got[0].shape == (TOY.fq.n_limbs,)
    want = ref_affine(tuple(c[:, None] for c in shared["finish_pt"]))
    assert port_affine(tuple(c[:, None] for c in got)) == want == [shared["expected"]]
    # B smaller than 2^(c-1): c only sets the window weight.  B = 1 is the
    # window fold of finish_large's second stage.
    jb = to_jax(shared["buckets"])
    sums = ref_pippenger.bucket_reduce(REF_TOY, jb)
    fold = pl_reduce.finish(TOY, tuple(to_torch(np.asarray(s))[:, :, None] for s in sums), C)
    assert port_affine(tuple(c[:, None] for c in fold)) == [shared["expected"]]
    two = tuple(b[:, :, :2] for b in to_torch(shared["buckets"]))
    want2 = ref_pippenger.window_fold(
        REF_TOY, ref_pippenger.bucket_reduce(REF_TOY, tuple(b[:, :, :2] for b in jb)), C
    )
    got2 = pl_reduce.finish(TOY, two, C)
    assert port_affine(tuple(c[:, None] for c in got2)) == ref_affine(tuple(np.asarray(c)[:, None] for c in want2))


def test_collapse_and_finish_large_match_reference(shared):
    tb = to_torch(shared["buckets"])
    sums = pl_reduce.collapse(TOY, tb)
    want_sums = ref_pippenger.bucket_reduce(REF_TOY, to_jax(shared["buckets"]))
    assert port_affine(sums) == ref_affine(want_sums)
    got = pl_reduce.finish_large(TOY, tb, C)
    want = ref_affine(tuple(c[:, None] for c in shared["large_pt"]))
    assert port_affine(tuple(c[:, None] for c in got)) == want == [shared["expected"]]


def test_msm_matches_reference_pallas_and_jnp_engines():
    pts, ks, XY, sc = _inputs(N, seed=32, bits=BITS)
    kw = dict(c=C, max_bits=BITS, lanes=T)
    with pltpu.force_tpu_interpret_mode():
        pallas = ref_pippenger.msm(REF_TOY, to_jax(XY), sc, impl="pallas", **kw)
    xla = ref_pippenger.msm(REF_TOY, to_jax(XY), sc, impl="xla", **kw)
    got = pippenger.msm(TOY, to_torch(XY), to_torch(sc), **kw)
    want = [oracle_of(TOY).msm(pts, ks)]
    assert port_affine(tuple(c[:, None] for c in got)) == want
    assert ref_affine(tuple(np.asarray(c)[:, None] for c in pallas)) == want
    assert ref_affine(tuple(np.asarray(c)[:, None] for c in xla)) == want


@pytest.mark.parametrize("c,lanes,max_bits", [(7, 8, 16), (None, None, None), (3, 1, 16), (7, 4, 128)])
def test_msm_plain_engine_against_oracle(c, lanes, max_bits):
    """Other configurations of the plain engine, the headline c = 7 among
    them (W*B > 1024 there at full width), against the host oracle."""
    oc = oracle_of(TOY)
    for n in (1, 33):
        pts, ks, XY, sc = _inputs(max(n, 6), seed=40 + n)
        got = pippenger.msm(TOY, to_torch(XY), to_torch(sc), c=c, max_bits=max_bits, lanes=lanes)
        assert port_affine(tuple(x[:, None] for x in got)) == [oc.msm(pts, ks)]


def test_msm_host_probes():
    ctx = ZT.build_curve(TOY, device="cpu")
    oc = oracle_of(TOY)
    pts = [oc.mul(oc.g, k) for k in (3, 5, 7)]
    kw = dict(c=4, max_bits=16, lanes=1, use_glv=False)
    assert ctx.msm_host(pts, [2, 4, 6], **kw) == oc.msm(pts, [2, 4, 6])
    assert ctx.msm_host(pts, [0, 0, 0], **kw) is None
    assert ctx.msm_host([pts[0], None, pts[2]], [9, 5, 1], **kw) == oc.msm([pts[0], None, pts[2]], [9, 5, 1])
    assert ctx.msm_host([pts[0], pts[0]], [TOY.r - 1, 1], **kw) is None
    assert ctx.msm_host([pts[1]], [1], **kw) == pts[1]
    assert ctx.msm_host(pts, [2, 4, 6]) == oc.msm(pts, [2, 4, 6])  # no GLV on toy: default runs
    assert ctx.result_to_affine(ctx.g1) == (TOY.gx, TOY.gy)
    assert ctx.fq is TOY.fq and ctx.fr is TOY.fr


def test_msm_reference_vector_bls12_381_c7():
    """The reference's embedded end-to-end vector (wasmcurves
    test/batchAffine.js:1177) at full width through the plain engine at the
    headline window size: c = 7, W = 38, B = 64."""
    from tests.test_msm import REF_EXPECTED, REF_POINTS, REF_SCALARS

    ctx = ZT.build_bls12381(device="cpu")
    got = ctx.msm_host(REF_POINTS, REF_SCALARS, c=7, max_bits=255, lanes=2, use_glv=False)
    assert got == REF_EXPECTED


def test_context_device_and_glv_default():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ZT.build_bls12381()
    ctx = ZT.build_bls12381(device="cpu")
    assert ctx.device == torch.device("cpu")
    P = ctx.points_to_device([(ctx.spec.gx, ctx.spec.gy)])
    s = ctx.scalars_to_device([5])
    assert P[0].device.type == "cpu" and P[0].dtype == torch.int64 and s.shape == (16, 1)
    # GLV is this curve's default: 5 * G through the split equals the oracle
    oc = oracle_of(ctx.spec)
    assert ctx.result_to_affine(ctx.msm(P, s)) == oc.mul(oc.g, 5)
    for absent in ("msm_legacy", "pairing", "fft", "to_compressed", "in_group"):
        assert not hasattr(ctx, absent)


def test_kernel_engine_refuses_cpu_tensors():
    """impl="kernel" never stands in the plain version for a CPU tensor."""
    pts, ks, XY, sc = _inputs(8, seed=50)
    tXY, tsc = to_torch(XY), to_torch(sc)
    digits = windows.signed_window_digits(tsc, C, 16)
    buckets = pl_bucket.bucket_accumulate(TOY, tXY, digits, lanes=2, c=C, impl="plain")
    raw = tuple(b[None].permute(3, 1, 2, 0).contiguous() for b in buckets)  # (B, L, W, 1)
    calls = [
        lambda: pl_bucket.bucket_accumulate(TOY, tXY, digits, lanes=2, c=C, impl="kernel"),
        lambda: pl_reduce.lane_reduce(TOY, raw, impl="kernel"),
        lambda: pl_reduce.collapse(TOY, buckets, impl="kernel"),
        lambda: pl_reduce.finish(TOY, buckets, C, impl="kernel"),
        lambda: pl_reduce.finish_large(TOY, buckets, C, impl="kernel"),
        lambda: pippenger.msm(TOY, tXY, tsc, c=C, max_bits=16, impl="kernel"),
        lambda: device_check.field_op(TOY, "mul", tXY[0], tXY[1]),
        lambda: device_check.group_op(TOY, "double", buckets, buckets),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert pl_bucket.launches == 0 and not any(pl_reduce.launches.values())
    with pytest.raises(ValueError):
        pl_reduce.finish(TOY, buckets, C, impl="fast")
    # lane_reduce of a single lane is the identity map on the bucket sums
    assert port_affine(pl_reduce.lane_reduce(TOY, raw)) == port_affine(buckets)


def test_wrapper_contracts_are_checked():
    c = 4  # B = 8, W = 5
    pts, ks, XY, sc = _inputs(8, seed=51)
    digits = windows.signed_window_digits(to_torch(sc), c, 16)
    buckets = pl_bucket.bucket_accumulate(TOY, to_torch(XY), digits, lanes=2, c=c)
    with pytest.raises(ValueError):  # B = 8 > 2^(c-1) for c = 3
        pl_reduce.finish(TOY, buckets, 3)
    with pytest.raises(ValueError):  # B not a power of two
        pl_reduce.finish(TOY, tuple(b[:, :, :3] for b in buckets), c)
    with pytest.raises(ValueError):  # W*B > 1024
        pl_reduce.finish(TOY, tuple(b.repeat(1, 30, 1) for b in buckets), c)
    with pytest.raises(ValueError):  # finish_large wants the full bucket row
        pl_reduce.finish_large(TOY, tuple(b[:, :, :4] for b in buckets), c)
    with pytest.raises(ValueError):  # wrong dtype
        pl_reduce.collapse(TOY, tuple(b.to(torch.int32) for b in buckets))


def test_kernel_lanes_fill_one_wave(monkeypatch):
    """The kernel engine's sweep runs the largest power-of-two multiple of
    KERNEL_LANES that is still one wave of resident threads and leaves every
    lane a point; lanes the caller names are run as given (the card's
    resident count stands in for the runtime's)."""
    monkeypatch.setattr(pl_bucket, "_resident_threads", lambda nw, index: 50688)
    bls = ZT.models.curves.bls12_381
    assert pippenger._kernel_lanes(bls, 38, 1 << 20, None, "cpu") == 1024  # full path
    assert pippenger._kernel_lanes(bls, 23, 1 << 21, None, "cpu") == 2048  # path A
    assert pippenger._kernel_lanes(bls, 4, 100, None, "cpu") == 64  # at least one point per lane
    assert pippenger._kernel_lanes(bls, 100, 1 << 20, None, "cpu") == 1024  # never fewer
    assert pippenger._kernel_lanes(bls, 23, 1 << 21, 16, "cpu") == 16  # named lanes as given
