"""PyTorch port, sorted-runs engine: sweep, segmented scan, the whole bucket
accumulation, the grouped bucket reduction and the sorted MSM against the
JAX package on the toy curve.

The JAX package's Pallas kernels (``_sweep``, ``_segscan``) run as its own
tests run them on the CPU, in TPU interpret mode, and ``_segscan_xla`` is its
own plain reference.  Stage comparisons feed BOTH packages the same sorted
stream (the order among equal keys is the sort's own, so two sorts need not
agree slot for slot); everything is compared as AFFINE points with tolerance
zero.  On CPU tensors the port's wrappers run their plain PyTorch versions;
the CUDA kernels are held against those on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from zprize_wasm_msm_tpu.ops.curve import group as ref_group
from zprize_wasm_msm_tpu.ops.msm import pippenger as ref_pippenger
from zprize_wasm_msm_tpu.ops.msm import pl_sorted as ref_pl_sorted

from zprize_wasm_msm_tpu_torch.ops.curve import group
from zprize_wasm_msm_tpu_torch.ops.msm import pippenger, pl_bucket, pl_reduce, pl_sorted, windows
from zprize_wasm_msm_tpu_torch.utils.limbs import ints_to_limbs

from tests._torch_helpers import (
    CURVE_PAIRS, affine_np, host_points, oracle_of, random_points, to_jax, to_torch, torch_np,
)

REF_TOY, TOY = CURVE_PAIRS["toy"]
L = TOY.fq.n_limbs
# The one shape every interpret-mode call shares: c = 8 (B = 128 buckets),
# the JAX grid of T = 1024 chunks, 2 steps per chunk.  K = B + T = 1152 is a
# multiple of 128, as the TPU scan kernel needs.
C, T, STEPS = 8, 1024, 2
N = T * STEPS
B = 1 << (C - 1)


def ref_affine(res):
    flat = tuple(np.asarray(c).reshape(np.asarray(c).shape[0], -1) for c in res)
    x, y = ref_group.to_affine(REF_TOY, to_jax(flat))
    return host_points(TOY, np.asarray(x), np.asarray(y))


def port_affine(res):
    flat = tuple(c.reshape(c.shape[0], -1) for c in res)
    x, y = torch_np(group.to_affine(TOY, flat))
    return host_points(TOY, x, y)


def _points(n, seed):
    """n toy points: 96 distinct multiples of the generator, tiled, with a
    (0,0) point and a repeated neighbour (the doubling case inside a run)."""
    base = random_points(TOY, 96, seed, bound=TOY.r)
    base[7] = None
    pts = [base[i % 96] for i in range(n)]
    return pts, affine_np(TOY, pts)


def _bucket_definition(pts, digits_row, n_buckets):
    """Bucket b = sum of +-P_i over the points whose digit is +-(b+1)."""
    oc = oracle_of(TOY)
    want = [None] * n_buckets
    for p, d in zip(pts, digits_row):
        if d:
            want[abs(d) - 1] = oc.add(want[abs(d) - 1], p if d > 0 else oc.neg(p))
    return want


@pytest.fixture(scope="module")
def stream():
    """One sorted stream (two windows) from the port's own host stages, and
    the JAX package's kernels run on window 0 of it."""
    rng = np.random.default_rng(61)
    pts, XY = _points(N, seed=60)
    digits = rng.integers(-B, B + 1, size=(2, N)).astype(np.int32)
    digits[:, :40] = 0
    digits[0, 40:44], digits[0, 44:48] = B, -B
    digits[0, 100:130] = 5  # one run longer than many chunks
    digits[1, ::2] = 0
    digits[np.abs(digits) == 9] = 0  # bucket 8 stays empty
    tXY, td = to_torch(XY), torch.as_tensor(digits)
    perm, skey, meta = pl_sorted.sort_runs(td, C, T)
    slot, seg = pl_sorted.compact_index(skey, meta, C, T)
    K = seg.shape[1]
    pieces = pl_sorted.sweep(TOY, tXY, perm, meta, slot, K, T)
    # the same stream in the TPU kernel's layout: window 0, chunk t = grid slot
    # t, y pre-negated for negative digits, meta bits 0 and 1 only
    p0, m0 = perm[0].numpy(), meta[0].numpy()
    neg_y = torch_np(TOY.field.neg(tXY[1]))
    ys = np.where((m0 & pl_sorted.META_NEG)[None] != 0, neg_y[:, p0], XY[1][:, p0])
    xs = XY[0][:, p0]

    def to_grid(a):  # (L, N) stream order -> (steps, L, 8, 128)
        return np.moveaxis(a.reshape(L, T, STEPS), 2, 0).reshape(STEPS, L, 8, 128)

    meta_g = np.moveaxis((m0 & 3).reshape(T, STEPS), 1, 0).reshape(STEPS, 8, 128).astype(np.int32)
    seg0 = seg[:1]
    with pltpu.force_tpu_interpret_mode():
        ox, oy, oz = ref_pl_sorted._sweep(REF_TOY, to_jax(to_grid(xs)), to_jax(to_grid(ys)),
                                          to_jax(meta_g), STEPS)
        ref_scan = ref_pl_sorted._segscan(REF_TOY, *to_jax(tuple(torch_np(p[:, :1]) for p in pieces)),
                                          to_jax(seg0.numpy()), 10)
    ref_scan_xla = ref_pl_sorted._segscan_xla(REF_TOY, *to_jax(tuple(torch_np(p[:, :1]) for p in pieces)),
                                              to_jax(seg0.numpy()), 10)

    def from_grid(o):  # (steps, L, 8, 128) -> (L, N) stream order
        return np.moveaxis(np.asarray(o).reshape(STEPS, L, T), 0, 2).reshape(L, N)

    return dict(pts=pts, XY=XY, digits=digits, perm=perm, skey=skey, meta=meta, slot=slot, seg=seg,
                K=K, pieces=pieces, ref_slots=tuple(from_grid(o) for o in (ox, oy, oz)),
                ref_scan=tuple(np.asarray(a) for a in ref_scan),
                ref_scan_xla=tuple(np.asarray(a) for a in ref_scan_xla))


def test_sort_runs_and_compact_index_describe_the_stream(stream):
    d, perm, skey, meta, slot, seg = (stream[k] for k in ("digits", "perm", "skey", "meta", "slot", "seg"))
    assert perm.dtype == meta.dtype == slot.dtype == seg.dtype == torch.int32
    assert seg.shape == (2, B + T)
    for w in range(2):
        p, k, m, s = perm[w].numpy(), skey[w].numpy(), meta[w].numpy(), slot[w].numpy()
        assert sorted(p.tolist()) == list(range(N))
        dw = d[w][p]
        np.testing.assert_array_equal(k, np.where(dw == 0, B, np.abs(dw) - 1))
        assert (np.diff(k) >= 0).all()
        np.testing.assert_array_equal((m & pl_sorted.META_ZERO) != 0, dw == 0)
        np.testing.assert_array_equal((m & pl_sorted.META_NEG) != 0, dw < 0)
        nxt = np.append(k[1:], -1)
        chunk_end = (np.arange(N) % STEPS) == STEPS - 1
        np.testing.assert_array_equal((m & pl_sorted.META_BOUNDARY) != 0, (k != nxt) | chunk_end)
        flush = ((m & 1) != 0) & (dw != 0)
        assert (s[~flush] == -1).all()
        np.testing.assert_array_equal(s[flush], np.arange(flush.sum()))
        sg = seg[w].numpy()
        np.testing.assert_array_equal(sg[: flush.sum()], k[flush])
        assert (np.diff(sg) >= 0).all() and (sg[flush.sum():] >= B).all()
        assert len(set(sg[flush.sum():].tolist())) == B + T - flush.sum()


def test_sweep_matches_reference_kernel_at_boundary_slots(stream):
    """The partial sum at every flush position equals the TPU kernel's slot
    there (window 0), and every entry no flush writes is the identity."""
    pieces, slot, meta = stream["pieces"], stream["slot"], stream["meta"]
    assert pieces[0].shape == (L, 2, stream["K"])
    s0 = slot[0].numpy()
    flush = s0 >= 0
    want = ref_affine(tuple(o[:, flush] for o in stream["ref_slots"]))
    got = port_affine(tuple(p[:, 0, : flush.sum()] for p in pieces))
    assert got == want
    assert any(p is not None for p in got)
    for w in range(2):
        used = int((slot[w] >= 0).sum())
        assert port_affine(tuple(p[:, w, used:] for p in pieces)) == [None] * (stream["K"] - used)


def test_sweep_partial_sums_follow_the_definition(stream):
    """Each flushed entry = the signed sum of the points of its run piece."""
    oc = oracle_of(TOY)
    pts, d = stream["pts"], stream["digits"]
    got = port_affine(tuple(p[:, 1] for p in stream["pieces"]))
    p1, m1, s1 = stream["perm"][1].numpy(), stream["meta"][1].numpy(), stream["slot"][1].numpy()
    acc = None
    for pos in range(N):
        i = p1[pos]
        if d[1, i]:
            acc = oc.add(acc, pts[i] if d[1, i] > 0 else oc.neg(pts[i]))
        if m1[pos] & pl_sorted.META_BOUNDARY:
            if s1[pos] >= 0:
                assert got[s1[pos]] == acc
            acc = None


def test_segscan_matches_reference_kernel_and_xla(stream):
    pieces, seg = stream["pieces"], stream["seg"]
    got = pl_sorted.segscan(TOY, pieces, seg, T)
    assert got[0].shape == pieces[0].shape
    got0 = port_affine(tuple(g[:, 0] for g in got))
    assert got0 == ref_affine(stream["ref_scan"])  # Pallas kernel, interpret mode
    assert got0 == ref_affine(stream["ref_scan_xla"])  # the JAX package's plain reference
    # the contract: entry k = the sum of its segment's pieces up to k
    oc = oracle_of(TOY)
    for w in range(2):
        pc, sc, sg = port_affine(tuple(p[:, w] for p in pieces)), port_affine(tuple(g[:, w] for g in got)), seg[w].tolist()
        acc = None
        for k in range(len(sg)):
            acc = oc.add(acc, pc[k]) if k and sg[k] == sg[k - 1] else pc[k]
            assert sc[k] == acc
    assert max(np.bincount(seg[0].numpy())) > 2  # a segment longer than one round


def test_bucket_accumulate_sorted_matches_reference_and_plain_engine(stream):
    tXY, td = to_torch(stream["XY"]), torch.as_tensor(stream["digits"])
    got = pl_sorted.bucket_accumulate_sorted(TOY, tXY, td, C)
    assert got[0].shape == (L, 2, B)
    got_aff = port_affine(got)
    with pltpu.force_tpu_interpret_mode():
        ref = ref_pl_sorted.bucket_accumulate_sorted(REF_TOY, to_jax(stream["XY"]), to_jax(stream["digits"]), C)
    assert got_aff == ref_affine(ref)
    assert got_aff == port_affine(pl_bucket.bucket_accumulate_plain(TOY, tXY, td, lanes=4, c=C))
    for w in range(2):
        assert got_aff[w * B : (w + 1) * B] == _bucket_definition(stream["pts"], stream["digits"][w], B)
    # empty buckets are the identity (0, 1, 0), not all-zero limbs
    empty = [i for i, p in enumerate(got_aff) if p is None]
    assert empty
    one = torch.as_tensor(TOY.fq.one_mont_limbs.astype(np.int64))
    for i in empty[:5]:
        w, b = divmod(i, B)
        assert not got[0][:, w, b].any() and not got[2][:, w, b].any() and torch.equal(got[1][:, w, b], one)


@pytest.mark.parametrize("c,chunks,n", [(3, 8, 64), (4, 16, 50), (6, 4, 37), (9, 32, 200)])
def test_bucket_accumulate_sorted_edge_streams(c, chunks, n):
    """Small chunk counts: zero digits, +-B digits, single-entry runs, a run
    spanning several chunks, a chunk that is all one bucket, an all-zero
    window, (0,0) points, N not a multiple of the chunk count."""
    rng = np.random.default_rng(c * 100 + n)
    nb = 1 << (c - 1)
    pts, XY = _points(n, seed=70 + c)
    digits = rng.integers(-nb, nb + 1, size=(4, n)).astype(np.int32)
    digits[0, :3], digits[0, 3], digits[0, 4] = 0, nb, -nb
    digits[1, :] = 0  # an all-zero window
    digits[2, :] = 2  # every chunk is all one bucket; the run spans them all
    digits[2, 5] = -1  # and a single-entry run before it
    digits[3, 1::2] = 0
    got = pl_sorted.bucket_accumulate_sorted(TOY, to_torch(XY), torch.as_tensor(digits), c, chunks)
    assert got[0].shape == (L, 4, nb)
    got_aff = port_affine(got)
    for w in range(4):
        assert got_aff[w * nb : (w + 1) * nb] == _bucket_definition(pts, digits[w], nb)
    assert got_aff[nb : 2 * nb] == [None] * nb


@pytest.mark.parametrize("n_buckets", [128, 256])
def test_bucket_reduce_grouped_matches_bucket_reduce(n_buckets):
    pts, XY = _points(3 * n_buckets, seed=n_buckets)
    buckets = tuple(a.reshape(L, 3, n_buckets) for a in group.from_affine(TOY, to_torch(XY)))
    got = port_affine(pippenger.bucket_reduce_grouped(TOY, buckets))
    assert got == port_affine(pippenger.bucket_reduce(TOY, buckets))
    assert got == ref_affine(ref_pippenger.bucket_reduce_grouped(REF_TOY, to_jax(tuple(torch_np(b) for b in buckets))))
    assert got == port_affine(pl_reduce.collapse(TOY, buckets))  # the lifted cap: B > 128
    oc = oracle_of(TOY)
    for w in range(3):
        want = None
        for b in range(n_buckets):
            want = oc.add(want, oc.mul(pts[w * n_buckets + b], b + 1))
        assert got[w] == want


@pytest.mark.parametrize("c", [4, 9])
def test_msm_plain_sorted_against_oracle(c):
    oc = oracle_of(TOY)
    rng = np.random.default_rng(c)
    pts, XY = _points(70, seed=80 + c)
    ks = [int(rng.integers(0, TOY.r)) for _ in range(70)]
    ks[0], ks[1] = 0, TOY.r - 1
    sc = to_torch(ints_to_limbs(ks, TOY.fr.n_limbs))
    got = pippenger.msm(TOY, to_torch(XY), sc, c=c, max_bits=16, impl="plain-sorted")
    assert port_affine(tuple(x[:, None] for x in got)) == [oc.msm(pts, ks)]
    # c unset: the sorted engine's own window rule
    got = pippenger.msm(TOY, to_torch(XY), sc, max_bits=16, impl="plain-sorted")
    assert port_affine(tuple(x[:, None] for x in got)) == [oc.msm(pts, ks)]


def test_msm_sorted_matches_reference_package():
    """Both packages' sorted engines end to end on the same inputs."""
    rng = np.random.default_rng(90)
    pts, XY = _points(40, seed=91)
    ks = [int(rng.integers(0, TOY.r)) for _ in range(40)]
    sc = ints_to_limbs(ks, TOY.fr.n_limbs)
    with pltpu.force_tpu_interpret_mode():
        want = ref_pippenger.msm(REF_TOY, to_jax(XY), to_jax(sc), c=C, max_bits=16, impl="pallas-sorted")
    got = pippenger.msm(TOY, to_torch(XY), to_torch(sc), c=C, max_bits=16, impl="plain-sorted")
    assert port_affine(tuple(x[:, None] for x in got)) == ref_affine(tuple(np.asarray(x)[:, None] for x in want))
    assert port_affine(tuple(x[:, None] for x in got)) == [oracle_of(TOY).msm(pts, ks)]


@pytest.mark.parametrize("name", ["toy", "bls12_381"])
def test_resolve_config_sorted_equals_reference(name):
    ref, port = CURVE_PAIRS[name]
    names = {"kernel": "pallas", "kernel-sorted": "pallas-sorted", "plain": "xla"}
    for impl in names:
        for n in (40, 1 << 12, 1 << 20, 1 << 24):
            for mb in (132, 255):
                for c in (None, 6, 7, 8, 12):
                    got = pippenger.resolve_config(port, n, mb, c, None, 2 << 30, impl)
                    want = ref_pippenger.resolve_config(ref, n, mb, c, None, 2 << 30, names[impl])
                    assert (names[got[0]], got[1], got[2]) == want, (impl, n, mb, c)
    # an explicit window above the bucket kernel's cap routes to the sorted engine
    assert pippenger.resolve_config(port, 1 << 20, 132, 10, None, 2 << 30, "kernel")[0] == "kernel-sorted"
    assert pippenger.resolve_config(port, 1 << 20, 132, 10, None, 2 << 30, "auto", device="cuda")[:2] == ("kernel-sorted", 10)
    assert pippenger.resolve_config(port, 1 << 20, 132, None, None, 2 << 30, "kernel-sorted")[1] == 10
    # the plain-sorted engine has no counterpart: the sorted window rule, no lanes
    assert pippenger.resolve_config(port, 1 << 12, 132, None, None, 2 << 30, "plain-sorted") == (
        "plain-sorted", windows.sorted_engine_window_size(1 << 12, 132), None)
    assert pippenger.resolve_config(port, 8, 16, 9, None, 2 << 30, "auto", device="cpu")[0] == "plain"


def test_sorted_kernels_refuse_cpu_tensors_and_bad_streams(stream):
    tXY = to_torch(stream["XY"])
    perm, meta, slot, seg, pieces, K = (stream[k] for k in ("perm", "meta", "slot", "seg", "pieces", "K"))
    before = dict(pl_sorted.launches)
    sc = to_torch(ints_to_limbs([3] * N, TOY.fr.n_limbs))
    for call in (
        lambda: pl_sorted.sweep(TOY, tXY, perm, meta, slot, K, T, impl="kernel"),
        lambda: pl_sorted.segscan(TOY, pieces, seg, T, impl="kernel"),
        lambda: pl_sorted.bucket_accumulate_sorted(TOY, tXY, torch.as_tensor(stream["digits"]), C, impl="kernel"),
        lambda: pippenger.msm(TOY, tXY, sc, c=C, max_bits=16, impl="kernel-sorted"),
        lambda: pippenger.msm(TOY, tXY, sc, c=9, max_bits=16, impl="kernel"),
    ):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert pl_sorted.launches == before
    with pytest.raises(ValueError):  # int64 stream tensors
        pl_sorted.sweep(TOY, tXY, perm.long(), meta, slot, K, T)
    with pytest.raises(ValueError):  # N not a multiple of the chunk count
        pl_sorted.sweep(TOY, tXY, perm, meta, slot, K, 1000)
    with pytest.raises(ValueError):
        pl_sorted.sort_runs(torch.as_tensor(stream["digits"]).long(), C, T)
    with pytest.raises(ValueError):  # seg of another shape
        pl_sorted.segscan(TOY, pieces, seg[:, :-1], T)
    with pytest.raises(ValueError):
        pippenger.msm(TOY, tXY, sc, c=C, max_bits=16, impl="sorted")


# ---------------------------------------------------------------------------
# CPU rehearsal of the sweep kernel's split schedule (csrc/sorted.cu)
# ---------------------------------------------------------------------------


def split_walk(curve, points, perm, meta, slot, K, chunks, S):
    """The CUDA sweep's schedule on the port's plain group ops, for tests:
    each chunk split across S lanes, lane k walking ceil(steps / S)
    consecutive positions; a run inside a lane is flushed by it, a lane
    parks its head piece (up to its first boundary) and carries the rest;
    a segmented Hillis-Steele scan of the carries over the S lanes (segments
    start at lanes holding a boundary) gives each lane the incoming part of
    its head's run, and that lane makes the run's one flush.  Every lane
    step is one batched add over all (window, chunk, lane) triples."""
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
    acc, head = identity, identity
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
        is_head = bnd & ~has_b
        head = group.select(is_head, acc, head)
        first_slot = torch.where(is_head, sl, first_slot)
        inner = bnd & has_b & (sl >= 0)
        out[:, :, row + torch.where(inner, sl, K)] = torch.stack(acc)
        has_b = has_b | bnd
        acc = group.select(bnd, identity, acc)
    # segmented inclusive scan of the carries over each chunk's S lanes
    v, f = acc, has_b.clone()
    d = 1
    while d < S:
        src = torch.arange(lanes) - d
        ok = lane >= d
        o = tuple(a[:, src.clamp(min=0)] for a in v)
        fo = f[src.clamp(min=0)]
        take = ok & ~f
        v = group.select(take, group.add(curve, o, v), v)
        f = torch.where(ok, f | fo, f)
        d *= 2
    prev = torch.arange(lanes) - 1
    incoming = group.select(lane == 0, identity, tuple(a[:, prev.clamp(min=0)] for a in v))
    total = group.add(curve, incoming, head)
    flush = has_b & (first_slot >= 0)
    out[:, :, row + torch.where(flush, first_slot, K)] = torch.stack(total)
    out = out.reshape(3, -1, W, K + 1)[..., :K]
    return (out[0], out[1], out[2])


def adversarial_stream(chunks, steps, S, seed):
    """Streams aimed at the split schedule, built directly (not sorted):
    one run crossing every sub-chunk border, runs ending on a sub-chunk's
    last position, on the next sub-chunk's first position, one before a
    sub-chunk's last, a sub-chunk of zero digits between two halves of one
    run, singletons, and a sorted random window."""
    rng = np.random.default_rng(seed)
    N = chunks * steps
    sub = -(-steps // S)
    pos = np.arange(N) % steps
    keys = np.stack([
        np.full(N, 7), pos // sub, (pos + sub - 1) // sub, (pos + 1) // sub, np.full(N, 3), pos,
        np.sort(rng.integers(0, 40, size=N)),
    ]).astype(np.int32)
    W = keys.shape[0]
    nxt = np.concatenate([keys[:, 1:], np.full((W, 1), -1)], axis=1)
    boundary = (keys != nxt) | (pos == steps - 1)[None]
    zero = np.zeros((W, N), dtype=bool)
    zero[4] = (pos >= sub) & (pos < 2 * sub) & (pos != steps - 1)
    zero[6] = rng.random(N) < 0.2
    neg = rng.random((W, N)) < 0.5
    meta = (boundary * pl_sorted.META_BOUNDARY + zero * pl_sorted.META_ZERO + neg * pl_sorted.META_NEG).astype(np.int32)
    perm = rng.integers(0, 96, size=(W, N)).astype(np.int32)
    perm[:, 1::7] = perm[:, 0:-1:7]  # one point twice in a row: the doubling case
    c = max(10, N.bit_length() + 1)  # K = B + chunks holds every flush, singletons included
    skey, meta = torch.as_tensor(keys), torch.as_tensor(meta)
    slot, seg = pl_sorted.compact_index(skey, meta, c, chunks)
    return torch.as_tensor(perm), meta, slot, seg.shape[1]


@pytest.mark.parametrize("chunks,steps,S", [(16, 37, 4), (16, 37, 32), (64, 5, 4), (64, 5, 32), (16, 71, 32), (64, 64, 32)])
def test_split_walk_matches_sweep_plain_on_adversarial_streams(chunks, steps, S):
    _, XY = _points(96, seed=chunks + steps)
    tXY = to_torch(XY)
    perm, meta, slot, K = adversarial_stream(chunks, steps, S, seed=S + steps)
    got = split_walk(TOY, tXY, perm, meta, slot, K, chunks, S)
    want = pl_sorted.sweep_plain(TOY, tXY, perm, meta, slot, K, chunks)
    for w in range(perm.shape[0]):
        assert port_affine(tuple(a[:, w] for a in got)) == port_affine(tuple(a[:, w] for a in want)), w


@pytest.mark.parametrize("S", [4, 32])
def test_split_walk_matches_reference_kernel(stream, S):
    """The split schedule on the stream the JAX package's sweep kernel ran
    (interpret mode, window 0): every flushed entry equals its slot there."""
    tXY = to_torch(stream["XY"])
    perm, meta, slot, K = (stream[k] for k in ("perm", "meta", "slot", "K"))
    got = split_walk(TOY, tXY, perm, meta, slot, K, T, S)
    flush = slot[0].numpy() >= 0
    want = ref_affine(tuple(o[:, flush] for o in stream["ref_slots"]))
    assert port_affine(tuple(a[:, 0, : flush.sum()] for a in got)) == want
    assert port_affine(got) == port_affine(stream["pieces"])
