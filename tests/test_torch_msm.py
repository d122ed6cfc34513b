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
from tests.test_torch_reduce_inverse import collapse_schedule

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
    for present in ("pairing", "pairing_eq", "fft", "ifft", "group_fft", "in_group"):  # the Groth16 slice
        assert hasattr(ctx, present)
    assert callable(ctx.group_map)  # the SvdW map (MNT6753's slice; BLS12-381 has no constants for it)
    with pytest.raises(ValueError, match="SvdW"):
        ctx.group_map(ctx.points_to_device([(ctx.spec.gx, ctx.spec.gy)])[0])
    for present in ("msm_legacy", "to_compressed", "from_compressed", "to_uncompressed",
                    "from_uncompressed", "field_exp"):
        assert callable(getattr(ctx, present))


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
    monkeypatch.setattr(pl_bucket, "_resident_threads", lambda nw, ext, index: 50688)
    bls = ZT.models.curves.bls12_381
    assert pippenger._kernel_lanes(bls, 38, 1 << 20, None, "cpu") == 1024  # full path
    assert pippenger._kernel_lanes(bls, 23, 1 << 21, None, "cpu") == 2048  # path A
    assert pippenger._kernel_lanes(bls, 4, 100, None, "cpu") == 64  # at least one point per lane
    assert pippenger._kernel_lanes(bls, 100, 1 << 20, None, "cpu") == 1024  # never fewer
    assert pippenger._kernel_lanes(bls, 23, 1 << 21, 16, "cpu") == 16  # named lanes as given


# ---------------------------------------------------------------------------
# The schedules of the two reduction kernels, on the port's plain group ops:
# csrc/reduce.cu the collapse's launches + finish_kernel (K3) and
# csrc/bucket.cu lane_reduce_kernel (K4).  They add in other orders than the
# plain versions, so results are compared as affine points.
# ---------------------------------------------------------------------------

def _take(points, idx):
    return tuple(a[..., idx] for a in points)


def _where(mask, a, b):
    return tuple(torch.where(mask, x, y) for x, y in zip(a, b))


def finish_schedule(curve, buckets, c):
    """K3: at B > 1 the collapse's launches give the window sums
    (collapse_schedule: runs of m buckets, the walk, the tree per window;
    one warp per scheduler of a 132-SM card), then the fold, Horner from
    the top window down."""
    L, W, B = buckets[0].shape
    if B == 1:
        sums = tuple(a[:, :, 0] for a in buckets)
    else:
        lanes = pl_reduce._collapse_lanes(curve.fq.n_words)
        sums = collapse_schedule(curve, buckets, 132 * 4 * 32 // lanes, lanes)
    return pippenger.window_fold(curve, sums, c)


def lane_reduce_schedule(curve, raw, N):
    """K4 over N lanes: (B, L, W, T) partials -> (L, W, B).  Lane g sums the
    partials [g F / N, (g+1) F / N) in bucket-major order, a head piece and,
    past its bucket's end, a tail piece (the head parked meanwhile), each
    from its first partial; a segmented inclusive scan of the lanes' last
    pieces over each warp of 32 (a segment starts at every piece that starts
    a bucket; each lane adds its neighbour's piece to its own); runs that
    start and end in one warp are written out, the others leave the warp's
    first and last pieces, which the combine adds across warps."""
    B, L, W, T = raw[0].shape
    nb, F = W * B, W * B * T
    P = tuple(a.permute(1, 2, 0, 3).reshape(L, F) for a in raw)  # bucket-major
    g = torch.arange(N)
    s, e = g * F // N, (g + 1) * F // N
    n = e - s
    hb = torch.where(s < F, s // T, nb - 1)
    split = (hb + 1) * T
    crossed, h_start, last_end = e > split, (n > 0) & (s % T == 0), (n > 0) & (e % T == 0)
    zero = group.zero(curve, (N,), "cpu")
    acc = _where(n > 0, _take(P, s.clamp(max=F - 1)), zero)
    park = zero
    for i in range(1, int(n.max())):
        f = s + i
        at_split = (i < n) & (f == split)
        park = _where(at_split, acc, park)
        acc = _where(at_split, zero, acc)
        acc = _where(i < n, group.add(curve, acc, _take(P, f.clamp(max=F - 1))), acc)
    flag = h_start | crossed
    lane = g % 32
    V, fl = acc, flag.clone()
    for d in (1, 2, 4, 8, 16):
        src = (g - d).clamp(min=0)
        o, fo, up = _take(V, src), fl[src], lane >= d
        V = _where(up & ~fl, group.add(curve, V, o), V)
        fl = torch.where(up, fl | fo, fl)
    o = _where(lane == 0, zero, _take(V, (g - 1).clamp(min=0)))
    warp_flags = flag.reshape(-1, 32).to(torch.int64)
    started_here = ((warp_flags.cumsum(1) - warp_flags) > 0).reshape(-1)
    hv = _where(crossed, _where(h_start | (lane == 0), park, group.add(curve, park, o)), V)
    out = {}
    slot = {}
    for k in range(N):
        if crossed[k] or last_end[k]:
            val = tuple(c[:, k] for c in hv)
            if h_start[k] or started_here[k]:
                out[int(hb[k])] = val
            else:
                slot[(k // 32, 0)] = val
        if crossed[k] and last_end[k]:
            out[int(hb[k]) + 1] = tuple(c[:, k] for c in V)
        if k % 32 == 31 and not last_end[k]:
            slot[(k // 32, 1)] = tuple(c[:, k] for c in V)

    def lane_of(x):
        return ((x + 1) * N - 1) // F

    for b in range(nb):
        i0, i1 = lane_of(b * T) // 32, lane_of((b + 1) * T - 1) // 32
        if i0 == i1:
            continue
        tot = slot[(i0, 1)]
        for i in range(i0 + 1, i1):
            tot = group.add(curve, tot, slot[(i, 1)])
        out[b] = group.add(curve, tot, slot[(i1, 0)])
    return tuple(torch.stack([out[b][c] for b in range(nb)], dim=1).reshape(L, W, B) for c in range(3))


def test_finish_schedule_matches_reference(shared):
    """K3's schedule against the JAX package's finish kernel (interpret
    mode) at B = 4, and at B = 1 (finish_large's fold); against finish_plain
    at B = 32 and B = 1."""
    tb = to_torch(shared["buckets"])
    got = finish_schedule(TOY, tb, C)
    assert port_affine(tuple(x[:, None] for x in got)) == ref_affine(
        tuple(c[:, None] for c in shared["finish_pt"])) == [shared["expected"]]
    sums = pl_reduce.collapse_plain(TOY, tb)
    got = finish_schedule(TOY, tuple(a[:, :, None] for a in sums), C)
    assert port_affine(tuple(x[:, None] for x in got)) == ref_affine(
        tuple(c[:, None] for c in shared["large_pt"]))
    pts = random_points(TOY, 64, seed=60)
    pts[5] = None
    XY = to_torch(affine_np(TOY, pts))
    P = group.from_affine(TOY, XY)
    for W, B, c in ((2, 32, 6), (5, 1, 4), (1, 1, 4)):
        bk = tuple(a[:, : W * B].reshape(a.shape[0], W, B) for a in P)
        want = pl_reduce.finish_plain(TOY, bk, c)
        got = finish_schedule(TOY, bk, c)
        assert port_affine(tuple(x[:, None] for x in got)) == port_affine(tuple(x[:, None] for x in want))


@pytest.mark.parametrize("N", [32, 64, 160])
def test_lane_reduce_schedule_matches_reference(shared, N):
    """K4's even split over N lanes against the JAX package's lane reduction
    (interpret mode; T = 2, 12 buckets: lanes left empty at N > 24), and
    against lane_reduce_plain at T = 37, 100, 200 (not multiples of the
    warp; buckets ending inside a lane, on a lane's end, across warps),
    with identity partials and P, -P pairs among them."""
    assert port_affine(lane_reduce_schedule(TOY, to_torch(shared["raw"]), N)) == ref_affine(
        shared["buckets"])
    oc = oracle_of(TOY)
    for T in (37, 100, 200):
        pts = random_points(TOY, 3 * 2 * T, seed=61 + T)
        for i in range(0, len(pts), 7):
            pts[i] = None
        pts[1] = oc.neg(pts[2])
        raw = tuple(a.reshape(a.shape[0], 3, 2, T).permute(2, 0, 1, 3)  # (B=2, L, W=3, T)
                    for a in group.from_affine(TOY, to_torch(affine_np(TOY, pts))))
        want = pl_reduce.lane_reduce_plain(TOY, raw)
        assert port_affine(lane_reduce_schedule(TOY, raw, N)) == port_affine(want)


def test_reduce_lanes_follow_the_shape():
    """Lanes of K4 from the shape (the card's resident count stands in for
    the runtime's): whole warps per bucket where they fill three quarters of
    a wave, else one wave of evenly loaded lanes; whole warps, at least a
    lane per bucket, no more lanes than partials where that leaves a warp."""
    assert pl_reduce._reduce_lanes(38 * 64, 1024, 50688) == 50688  # full: 49 partials a lane
    assert pl_reduce._reduce_lanes(23 * 32, 2048, 50688) == 47104  # path A: 2 warps a bucket
    assert pl_reduce._reduce_lanes(23 * 32, 2048, 33792) == 33792  # 1 warp a bucket: 70 %
    assert pl_reduce._reduce_lanes(3000, 4, 2000) == 3008  # a lane per bucket at least
    assert pl_reduce._reduce_lanes(12, 2, 50688) == 32  # 24 partials: one warp
    assert pl_reduce._reduce_lanes(6, 100, 50688) == 608
    assert pl_reduce._reduce_lanes(4, 4096, 50688) == 16384  # 4 warps a bucket: no more than T/32
