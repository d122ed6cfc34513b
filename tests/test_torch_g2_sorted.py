"""PyTorch port, the sorted-runs engine over Fq2 (G2) against the JAX package
on toy_g2: the sweep (K7) and the segmented scan (K8) on one given sorted
stream, a slot-for-slot model of the Fq2 sweep kernel's schedule, the whole
engine end to end, and its window rule on G2.

The JAX package's Pallas kernels (``_sweep``, ``_segscan``) run as its own
tests run them on the CPU, in TPU interpret mode, at one shared shape (they
are generic over the coordinate field, so they take Fq2 elements of 2L
limbs); ``_segscan_xla`` is its plain reference.  Both packages get the same
sorted stream (the order among equal keys is each sort's own) and are
compared as AFFINE points with tolerance zero.  On CPU tensors the port's
wrappers run their plain PyTorch versions; the CUDA kernels over Fq2 are held
against those on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from zprize_wasm_msm_tpu.models import curves as ref_curves
from zprize_wasm_msm_tpu.ops.curve import group as ref_group
from zprize_wasm_msm_tpu.ops.msm import pippenger as ref_pippenger
from zprize_wasm_msm_tpu.ops.msm import pl_sorted as ref_pl_sorted

import zprize_wasm_msm_tpu_torch as ZT
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.oracle import F2, Curve as OracleCurve
from zprize_wasm_msm_tpu_torch.ops.curve import group
from zprize_wasm_msm_tpu_torch.ops.msm import pippenger, pl_bucket, pl_sorted

from tests._torch_helpers import to_jax, torch_np

REF, G2 = ref_curves.toy_g2, port_curves.toy_g2
EL = G2.field.elem_len  # 2 L limbs an Fq2 element
# The one shape every interpret-mode call shares (that of
# tests/test_torch_sorted.py): c = 8 (B = 128), the JAX grid of T = 1024
# chunks, 2 steps a chunk; K = B + T = 1152, a multiple of 128.
C, T, STEPS = 8, 1024, 2
N = T * STEPS
B = 1 << (C - 1)


def oracle_of(curve):
    return OracleCurve(q=curve.q, a=0, b=curve.b, r=curve.r, gx=curve.gx, gy=curve.gy,
                       field=F2(curve.q, curve.nr))


def host_points(curve, x, y):
    F = curve.field
    xs, ys = F.to_host(torch.as_tensor(np.asarray(x, dtype=np.int64)).reshape(EL, -1)), F.to_host(
        torch.as_tensor(np.asarray(y, dtype=np.int64)).reshape(EL, -1))
    return [None if (a == (0, 0) and b == (0, 0)) else (a, b) for a, b in zip(xs, ys)]


def ref_affine(res):
    flat = tuple(np.asarray(c).reshape(EL, -1) for c in res)
    x, y = ref_group.to_affine(REF, to_jax(flat))
    return host_points(G2, np.asarray(x), np.asarray(y))


def port_affine(res, curve=G2):
    flat = tuple(c.reshape(c.shape[0], -1) for c in res)
    x, y = group.to_affine(curve, flat)
    return host_points(curve, x, y)


def _points(n, seed, curve=G2):
    """n G2 points: 96 distinct multiples of the generator, tiled, with a
    (0,0) point (the identity) and a repeated neighbour (the doubling case
    inside a run)."""
    oc = oracle_of(curve)
    rng = np.random.default_rng(seed)
    base = [oc.mul(oc.g, int(rng.integers(1, curve.r))) for _ in range(96)]
    base[7] = None
    pts = [base[i % 96] for i in range(n)]
    ctx = ZT.build_curve(curve, device="cpu")
    return pts, ctx.points_to_device(pts)


@pytest.fixture(scope="module")
def stream():
    """One sorted stream (two windows) from the port's host stages and its
    plain sweep, and the JAX package's kernels run on window 0 of it."""
    rng = np.random.default_rng(71)
    pts, XY = _points(N, seed=70)
    digits = rng.integers(-B, B + 1, size=(2, N)).astype(np.int32)
    digits[:, :40] = 0
    digits[0, 40:44], digits[0, 44:48] = B, -B
    digits[0, 100:130] = 5  # one run longer than many chunks
    digits[1, ::2] = 0
    td = torch.as_tensor(digits)
    perm, skey, meta = pl_sorted.sort_runs(td, C, T)
    slot, seg = pl_sorted.compact_index(skey, meta, C, T)
    K = seg.shape[1]
    pieces = pl_sorted.sweep(G2, XY, perm, meta, slot, K, T)
    # window 0 in the TPU kernel's layout: chunk t = grid slot t, y negated
    # for negative digits, meta bits 0 and 1 only
    p0, m0 = perm[0].numpy(), meta[0].numpy()
    xs, ys = torch_np(XY[0])[:, p0], torch_np(XY[1])[:, p0]
    neg_y = torch_np(G2.field.neg(XY[1]))[:, p0]
    ys = np.where((m0 & pl_sorted.META_NEG)[None] != 0, neg_y, ys)

    def to_grid(a):  # (EL, N) stream order -> (steps, EL, 8, 128)
        return np.moveaxis(a.reshape(EL, T, STEPS), 2, 0).reshape(STEPS, EL, 8, 128)

    meta_g = np.moveaxis((m0 & 3).reshape(T, STEPS), 1, 0).reshape(STEPS, 8, 128).astype(np.int32)
    w0 = to_jax(tuple(torch_np(p[:, :1]) for p in pieces))
    # rounds of the scans: enough for window 0's longest segment (log2 T
    # would do too, at twice the interpret-mode time)
    rounds = (int(np.bincount(seg[0].numpy()).max()) - 1).bit_length()
    with pltpu.force_tpu_interpret_mode():
        ox, oy, oz = ref_pl_sorted._sweep(REF, to_jax(to_grid(xs)), to_jax(to_grid(ys)), to_jax(meta_g), STEPS)
        ref_scan = ref_pl_sorted._segscan(REF, *w0, to_jax(seg[:1].numpy()), rounds)
    ref_scan_xla = ref_pl_sorted._segscan_xla(REF, *w0, to_jax(seg[:1].numpy()), rounds)

    def from_grid(o):  # (steps, EL, 8, 128) -> (EL, N) stream order
        return np.moveaxis(np.asarray(o).reshape(STEPS, EL, T), 0, 2).reshape(EL, N)

    return dict(pts=pts, XY=XY, digits=digits, perm=perm, meta=meta, slot=slot, seg=seg, K=K,
                pieces=pieces, ref_slots=tuple(from_grid(o) for o in (ox, oy, oz)),
                ref_scan=tuple(np.asarray(a) for a in ref_scan),
                ref_scan_xla=tuple(np.asarray(a) for a in ref_scan_xla))


def test_sweep_fq2_matches_reference_kernel_at_boundary_slots(stream):
    """Every flushed entry of window 0 equals the TPU kernel's slot at its
    flush position, and every entry no flush writes is the identity."""
    pieces, slot = stream["pieces"], stream["slot"]
    assert pieces[0].shape == (EL, 2, stream["K"])
    flush = slot[0].numpy() >= 0
    want = ref_affine(tuple(o[:, flush] for o in stream["ref_slots"]))
    got = port_affine(tuple(p[:, 0, : flush.sum()] for p in pieces))
    assert got == want and any(p is not None for p in got)
    for w in range(2):
        used = int((slot[w] >= 0).sum())
        assert port_affine(tuple(p[:, w, used:] for p in pieces)) == [None] * (stream["K"] - used)


def test_segscan_fq2_matches_reference_kernel_and_xla(stream):
    pieces, seg = stream["pieces"], stream["seg"]
    got = pl_sorted.segscan(G2, pieces, seg, T)
    got0 = port_affine(tuple(g[:, 0] for g in got))
    assert got0 == ref_affine(stream["ref_scan"])  # Pallas kernel, interpret mode
    assert got0 == ref_affine(stream["ref_scan_xla"])  # the JAX package's plain reference
    assert max(np.bincount(seg[0].numpy())) > 2  # a segment longer than one round


def split_walk2(curve, points, perm, meta, slot, K, chunks, S):
    """The Fq2 sweep kernel's schedule (csrc/sorted.cu sorted_sweep2_kernel)
    on the port's plain group ops, for tests: each chunk split across S
    lanes, lane k walking ceil(steps / S) consecutive positions; EVERY
    flush, a lane's first included, is stored to its slot; after a
    segmented Hillis-Steele scan of the carries over the S lanes (segments
    start at lanes holding a boundary), each lane but the first reads its
    first flush back from its slot, adds the scan of the lane before it and
    stores the sum there.  Every lane step is one batched add."""
    F = curve.field
    X, Y = points
    W, N = perm.shape
    steps = N // chunks
    sub = -(-steps // S)
    lanes = W * chunks * S
    lane = torch.arange(S).repeat(W * chunks)
    lo = torch.clamp(lane * sub, max=steps)
    n = torch.clamp(lo + sub, max=steps) - lo
    first = torch.arange(W * chunks).repeat_interleave(S) * steps + lo  # flat stream index
    row = torch.arange(W).repeat_interleave(chunks * S) * (K + 1)
    out = torch.stack(group.zero(curve, (W * (K + 1),)))
    identity = group.zero(curve, (lanes,))
    acc = identity
    has_b = torch.zeros(lanes, dtype=torch.bool)
    first_slot = torch.full((lanes,), -1, dtype=torch.int64)
    flat = lambda t: t.reshape(-1)
    for j in range(sub):
        live = j < n
        p = torch.where(live, first + j, 0)
        m = torch.where(live, flat(meta)[p], pl_sorted.META_ZERO)
        sl = flat(slot)[p].to(torch.int64)
        idx = flat(perm)[p].to(torch.int64)
        zero, neg = (m & pl_sorted.META_ZERO) != 0, (m & pl_sorted.META_NEG) != 0
        bnd = live & ((m & pl_sorted.META_BOUNDARY) != 0)
        px, py = X[:, idx], Y[:, idx]
        py = F.select(neg, F.neg(py), py)
        px = F.select(zero, torch.zeros_like(px), px)
        py = F.select(zero, torch.zeros_like(py), py)
        acc = group.add_mixed(curve, acc, (px, py))
        first_slot = torch.where(bnd & ~has_b, sl, first_slot)
        store = bnd & (sl >= 0)
        out[:, :, row + torch.where(store, sl, K)] = torch.stack(acc)
        has_b = has_b | bnd
        acc = group.select(bnd, identity, acc)
    v, f = acc, has_b.clone()
    d = 1
    while d < S:
        src = (torch.arange(lanes) - d).clamp(min=0)
        ok = lane >= d
        take = ok & ~f
        v = group.select(take, group.add(curve, v, tuple(a[:, src] for a in v)), v)
        f = torch.where(ok, f | f[src], f)
        d *= 2
    fix = has_b & (first_slot >= 0) & (lane > 0)
    tgt = row + torch.where(fix, first_slot, K)
    stored = tuple(o[:, tgt] for o in out)
    incoming = tuple(a[:, (torch.arange(lanes) - 1).clamp(min=0)] for a in v)
    out[:, :, tgt] = torch.stack(group.select(fix, group.add(curve, stored, incoming), stored))
    out = out.reshape(3, -1, W, K + 1)[..., :K]
    return (out[0], out[1], out[2])


def adversarial_stream(chunks, steps, S, seed):
    """Streams aimed at the split schedule, built directly (not sorted): one
    run crossing every sub-chunk border, runs ending on a sub-chunk's last
    position, on the next sub-chunk's first, one before a sub-chunk's last,
    a sub-chunk of zero digits inside one run, singletons, a sorted random
    window; negative digits everywhere; the same point twice in a row."""
    rng = np.random.default_rng(seed)
    n = chunks * steps
    sub = -(-steps // S)
    pos = np.arange(n) % steps
    keys = np.stack([
        np.full(n, 7), pos // sub, (pos + sub - 1) // sub, (pos + 1) // sub, np.full(n, 3), pos,
        np.sort(rng.integers(0, 40, size=n)),
    ]).astype(np.int32)
    W = keys.shape[0]
    nxt = np.concatenate([keys[:, 1:], np.full((W, 1), -1)], axis=1)
    boundary = (keys != nxt) | (pos == steps - 1)[None]
    zero = np.zeros((W, n), dtype=bool)
    zero[4] = (pos >= sub) & (pos < 2 * sub) & (pos != steps - 1)
    zero[6] = rng.random(n) < 0.2
    neg = rng.random((W, n)) < 0.5
    meta = (boundary * pl_sorted.META_BOUNDARY + zero * pl_sorted.META_ZERO + neg * pl_sorted.META_NEG).astype(np.int32)
    perm = rng.integers(0, 96, size=(W, n)).astype(np.int32)
    perm[:, 1::7] = perm[:, 0:-1:7]
    c = max(10, n.bit_length() + 1)  # K = B + chunks holds every flush
    skey, meta = torch.as_tensor(keys), torch.as_tensor(meta)
    slot, seg = pl_sorted.compact_index(skey, meta, c, chunks)
    return torch.as_tensor(perm), meta, slot, seg.shape[1]


@pytest.mark.parametrize("chunks,steps,S", [(4, 37, 4), (4, 37, 32), (8, 5, 32), (2, 71, 32), (4, 64, 32)])
def test_fq2_split_walk_matches_sweep_plain_on_adversarial_streams(chunks, steps, S):
    _, XY = _points(96, seed=chunks + steps)
    perm, meta, slot, K = adversarial_stream(chunks, steps, S, seed=S + steps)
    got = split_walk2(G2, XY, perm, meta, slot, K, chunks, S)
    want = pl_sorted.sweep_plain(G2, XY, perm, meta, slot, K, chunks)
    assert port_affine(got) == port_affine(want)


def test_fq2_split_walk_matches_reference_kernel(stream):
    """The Fq2 schedule at S = 32 on the stream the JAX package's sweep
    kernel ran: every flushed entry equals its slot there."""
    perm, meta, slot, K = (stream[k] for k in ("perm", "meta", "slot", "K"))
    got = split_walk2(G2, stream["XY"], perm, meta, slot, K, T, 32)
    flush = slot[0].numpy() >= 0
    assert port_affine(tuple(a[:, 0, : flush.sum()] for a in got)) == ref_affine(
        tuple(o[:, flush] for o in stream["ref_slots"]))
    assert port_affine(got) == port_affine(stream["pieces"])


def test_plain_sorted_fq2_msm_matches_reference_package():
    """Both packages' sorted engines end to end over Fq2 (the reference's
    sweep kernel in interpret mode), and the oracle.  8-bit scalars at
    c = 8 are two signed windows: the reference sweeps them in one call of
    one compiled graph (its window groups are 8, 4, 2, 1 wide)."""
    rng = np.random.default_rng(92)
    pts, XY = _points(40, seed=93)
    ks = [int(rng.integers(0, 1 << 8)) for _ in range(40)]
    ks[0], ks[1] = 0, (1 << 8) - 1
    ctx = ZT.build_curve(G2, device="cpu")
    sc = ctx.scalars_to_device(ks)
    assert ref_pippenger.windows.num_windows(8, C) == 2
    with pltpu.force_tpu_interpret_mode():
        want = ref_pippenger.msm(REF, to_jax(torch_np(XY)), to_jax(torch_np(sc)), c=C, max_bits=8,
                                 impl="pallas-sorted")
    got = pippenger.msm(G2, XY, sc, c=C, max_bits=8, impl="plain-sorted")
    expected = [oracle_of(G2).msm(pts, ks)]
    assert port_affine(tuple(x[:, None] for x in got)) == ref_affine(tuple(np.asarray(x)[:, None] for x in want))
    assert port_affine(tuple(x[:, None] for x in got)) == expected


@pytest.mark.parametrize("c,chunks", [(5, 4), (10, 16)])
def test_plain_sorted_fq2_msm_against_oracle_on_toy_bn_g2(c, chunks):
    """toy_bn_g2 (3b a full Fq2 element): the sorted engine's stages with a
    few chunks, and its dense buckets against the bucket engine's."""
    curve = port_curves.toy_bn_g2
    rng = np.random.default_rng(c)
    pts, XY = _points(40, seed=94 + c, curve=curve)
    ks = [int(rng.integers(0, curve.r)) for _ in range(40)]
    ks[0], ks[1] = 0, curve.r - 1
    ctx = ZT.build_curve(curve, device="cpu")
    sc = ctx.scalars_to_device(ks)
    got = pippenger.msm(curve, XY, sc, c=c, max_bits=16, impl="plain-sorted")
    assert ctx.result_to_affine(got) == oracle_of(curve).msm(pts, ks)
    from zprize_wasm_msm_tpu_torch.ops.msm import windows

    digits = windows.signed_window_digits(sc, c, 16)
    dense = pl_sorted.bucket_accumulate_sorted(curve, XY, digits, c, chunks)
    ref = pl_bucket.bucket_accumulate_plain(curve, XY, digits, lanes=4, c=c)
    assert port_affine(dense, curve) == port_affine(ref, curve)


@pytest.mark.parametrize("name", ["toy_g2", "bls12_381_g2"])
def test_resolve_config_g2_equals_reference(name):
    ref, port = getattr(ref_curves, name), getattr(port_curves, name)
    names = {"kernel": "pallas", "kernel-sorted": "pallas-sorted"}
    for impl in names:
        for n in (40, 1 << 16, 1 << 20):
            for mb in (16, 256):
                for c in (None, 6, 7, 10):
                    got = pippenger.resolve_config(port, n, mb, c, None, 2 << 30, impl)
                    want = ref_pippenger.resolve_config(ref, n, mb, c, None, 2 << 30, names[impl])
                    assert (names[got[0]], got[1], got[2]) == want, (impl, n, mb, c)
    # above the Fq2 cap of 6 the bucket engine routes to the sorted engine
    assert pippenger.resolve_config(port, 1 << 20, 256, 7, None, 2 << 30, "kernel")[0] == "kernel-sorted"
    assert pippenger.resolve_config(port, 1 << 20, 256, 10, None, 2 << 30, "auto", device="cuda")[:2] == (
        "kernel-sorted", 10)
