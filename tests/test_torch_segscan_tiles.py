"""PyTorch port, the redesigned reductions of the sorted and bucket
engines on toy_g2 (and the scan on toy), against the JAX package.

K8 (csrc/sorted.cu segscan_tile_kernel, segscan_fix_kernel, over Fq and
Fq2) is a segmented scan of log depth in tiles of 32 entries and levels;
``segscan_tiles`` below is its schedule slot for slot on the port's plain
group ops, held against ``pl_sorted.segscan_plain`` and the JAX package's
``_segscan_xla`` on seg layouts aimed at the tiles and levels, on toy_g2
and on the Fq curve toy (over Fq the kernel passes a round's values by
shuffles instead of shared slots: the same values).  K4 over Fq2
(csrc/bucket.cu lane_reduce_kernel<NW, 2>) runs one partial slot at 8 warps
a SM: its lanes at path G2's shape, and its even split at 32 partials a
lane (tests/test_torch_msm.py ``lane_reduce_schedule``) against the JAX
package's lane reduction.  Results are compared as AFFINE points with
tolerance zero; the CUDA kernels are held against the plain versions on the
card by chip_smoke.py.
"""

import math

import numpy as np
import pytest
import torch

from zprize_wasm_msm_tpu.ops.msm import pippenger as ref_pippenger
from zprize_wasm_msm_tpu.ops.msm import pl_sorted as ref_pl_sorted
from zprize_wasm_msm_tpu.ops.msm import windows as ref_windows

from zprize_wasm_msm_tpu_torch.ops.curve import group
from zprize_wasm_msm_tpu_torch.ops.msm import pippenger, pl_reduce, pl_sorted, windows

from zprize_wasm_msm_tpu_torch.utils.limbs import ints_to_limbs

from zprize_wasm_msm_tpu.ops.curve import group as ref_group

from tests._torch_helpers import CURVE_PAIRS, affine_np, host_points, random_points, to_jax, to_torch, torch_np
from tests.test_torch_g2_sorted import G2, REF, _points, port_affine, ref_affine
from tests.test_torch_msm import lane_reduce_schedule

TILE = pl_sorted.SCAN_TILE
#: the one shape the JAX reference compiles for: three levels, the second
#: of 65 elements (two whole tiles and a ragged one), the top of 2
K_JAX = 2100


def segscan_tiles(curve, pieces, seg):
    """The Fq2 scan's schedule (csrc/sorted.cu zp_segscan_limbs) on the
    port's plain group ops: (L, W, K) pieces -> (L, W, K) inclusive
    segmented sums.  Level by level (pl_sorted.scan_levels), each tile of 32
    elements: in round d = 1, 2, 4, ... every lane whose segment reaches
    back d elements inside the tile adds the exchange slot of lane - d (the
    values of the round before); a level above holds the last elements of
    the whole tiles below, scanned in place.  Then from the top level down,
    every tile whose first segment began in an earlier tile adds the element
    before it to its elements of that segment, a whole tile's last excepted.
    Every round is one batched add."""
    L = pieces[0].shape[0]
    W, K = seg.shape
    val = [a.clone() for a in pieces]
    levels = pl_sorted.scan_levels(K)

    def at(n, s):
        return (torch.arange(n) + 1) * s - 1

    def add(a, b, mask):
        n = mask.shape[-1]
        new = group.add(curve, tuple(x.reshape(L, -1) for x in a), tuple(x.reshape(L, -1) for x in b))
        return tuple(torch.where(mask[None], x.reshape(L, W, n), o) for x, o in zip(new, a))

    for l, (n, s) in enumerate(levels):
        if l and n < 2:
            continue  # one element: nothing to scan (no launch)
        idx = at(n, s)
        reach = pl_sorted.scan_reach(seg[:, idx])
        acc = tuple(v[:, :, idx] for v in val)
        d = 1
        while d <= int(reach.max()):
            src = (torch.arange(n) - d).clamp(min=0)
            acc = add(acc, tuple(a[:, :, src] for a in acc), reach >= d)
            d <<= 1
        for v, a in zip(val, acc):
            v[:, :, idx] = a
    for n, s in reversed(levels[:-1]):
        idx = at(n, s)
        ids = seg[:, idx]
        i = torch.arange(n)
        head = (i // TILE) * TILE
        prev = (head - 1).clamp(min=0)
        fix = (i >= TILE) & (i % TILE != TILE - 1) & (ids[:, head] == ids[:, prev]) & (ids == ids[:, prev])
        acc = add(tuple(v[:, :, idx] for v in val), tuple(v[:, :, idx[prev]] for v in val), fix)
        for v, a in zip(val, acc):
            v[:, :, idx] = a
    return tuple(val)


def seg_layouts(K, seed):
    """(W, K) int32 segment ids, one layout a row, each non-decreasing:
    every segment a singleton; one segment over all K; segments ending on
    every tile border, and on every border of a level-1 tile; segments
    starting on every tile's last entry, and on the last entry of every
    level-1 tile; the host's layout (buckets of 1-150 pieces, then the
    distinct padding ids B + k of the unused entries, compact_index); and
    sorted random ids."""
    rng = np.random.default_rng(seed)
    k = np.arange(K)
    B = 512
    lengths = rng.integers(1, 151, size=B)
    buckets = np.repeat(np.arange(B), lengths)[: (3 * K) // 5]
    host = np.concatenate([buckets, B + np.arange(K - len(buckets))])
    rows = [k, np.zeros(K), k // TILE, k // TILE**2, (k + 1) // TILE, (k + 1) // TILE**2, host,
            np.sort(rng.integers(0, 40, size=K))]
    return torch.as_tensor(np.stack(rows).astype(np.int32))


REF_FQ, FQ = CURVE_PAIRS["toy"]


def scan_pieces(W, K, seed, curve=G2):
    """(L, W, K) x3 projective pieces on toy_g2 (or the Fq curve toy):
    multiples of the generator, identities among them, on representatives
    with Z != 1."""
    if curve.ext == 2:
        _, (X, Y) = _points(W * K, seed=seed)
    else:
        base = random_points(curve, 96, seed, bound=curve.r)
        base[7] = None
        X, Y = to_torch(affine_np(curve, [base[i % 96] for i in range(W * K)]))
    P = group.from_affine(curve, (X, Y))
    P = group.double(curve, P)  # Z != 1; the identity stays the identity
    perm = torch.as_tensor(np.random.default_rng(seed + 1).permutation(W * K))
    return tuple(a[:, perm].reshape(a.shape[0], W, K).contiguous() for a in P)


@pytest.fixture(scope="module")
def jax_case():
    """The layouts at K_JAX, their pieces and the JAX package's plain scan
    (``_segscan_xla``, ceil(log2 K) rounds: every segment's length)."""
    seg = seg_layouts(K_JAX, seed=90)
    pieces = scan_pieces(seg.shape[0], K_JAX, seed=91)
    rounds = math.ceil(math.log2(K_JAX))
    ref = ref_pl_sorted._segscan_xla(REF, *to_jax(torch_np(pieces)), to_jax(seg.numpy()), rounds)
    return seg, pieces, tuple(np.asarray(a) for a in ref)


def test_tile_schedule_matches_reference_xla_and_plain(jax_case):
    """Every entry of every layout, W = 8 rows in one call, three levels."""
    seg, pieces, ref = jax_case
    assert [n for n, _ in pl_sorted.scan_levels(K_JAX)] == [2100, 65, 2]
    got = segscan_tiles(G2, pieces, seg)
    want = pl_sorted.segscan_plain(G2, pieces, seg, K_JAX)
    assert port_affine(got) == port_affine(want) == ref_affine(ref)
    assert any(p is not None for p in port_affine(tuple(a[:, 1, -1:] for a in got)))


@pytest.mark.parametrize("K", [5, 31, 32, 33, 64, 1056, 1536])
def test_tile_schedule_matches_plain_at_level_edges(K):
    """One tile, exactly one, one past it (a level of one element), whole
    tiles, a second level of 33 (its ragged tile fixed up), and path
    G2-sorted's K; every layout."""
    seg = seg_layouts(K, seed=92 + K)
    pieces = scan_pieces(seg.shape[0], K, seed=93)
    got = segscan_tiles(G2, pieces, seg)
    want = pl_sorted.segscan_plain(G2, pieces, seg, K)
    assert port_affine(got) == port_affine(want)


def fq_affine(res):
    """Port (L, ...) x3 points on toy -> python affine points."""
    x, y = group.to_affine(FQ, tuple(c.reshape(c.shape[0], -1) for c in res))
    return host_points(FQ, torch_np(x), torch_np(y))


def test_fq_tile_schedule_matches_reference_xla_and_plain():
    """Over Fq (toy): every entry of every layout at K_JAX (three levels),
    W = 8 rows in one call, against the JAX package's plain scan and
    segscan_plain."""
    seg = seg_layouts(K_JAX, seed=97)
    pieces = scan_pieces(seg.shape[0], K_JAX, seed=98, curve=FQ)
    ref = ref_pl_sorted._segscan_xla(REF_FQ, *to_jax(torch_np(pieces)), to_jax(seg.numpy()),
                                     math.ceil(math.log2(K_JAX)))
    x, y = ref_group.to_affine(REF_FQ, tuple(ref))
    got = segscan_tiles(FQ, pieces, seg)
    want = pl_sorted.segscan_plain(FQ, pieces, seg, K_JAX)
    assert fq_affine(got) == fq_affine(want) == host_points(FQ, np.asarray(x), np.asarray(y))
    assert any(p is not None for p in fq_affine(tuple(a[:, 1, -1:] for a in got)))


@pytest.mark.parametrize("K", [5, 33, 1056, 1536])
def test_fq_tile_schedule_matches_plain_at_level_edges(K):
    """Over Fq (toy): one tile, a level of one element, a second level of 33
    (its ragged tile fixed up), and path B's K; every layout."""
    seg = seg_layouts(K, seed=99 + K)
    pieces = scan_pieces(seg.shape[0], K, seed=100, curve=FQ)
    got = segscan_tiles(FQ, pieces, seg)
    want = pl_sorted.segscan_plain(FQ, pieces, seg, K)
    assert fq_affine(got) == fq_affine(want)


def test_scan_levels_and_depth():
    """The levels follow from K alone; the depth counts the rounds that add
    on the deepest tile of each level and one a fix-up that adds: at most 12
    at path G2-sorted's K = 1 536, whatever the segments' lengths."""
    assert pl_sorted.scan_levels(1536) == [(1536, 1), (48, 32), (1, 1024)]
    assert pl_sorted.scan_levels(32) == [(32, 1)]
    assert pl_sorted.scan_levels(33) == [(33, 1), (1, 32)]
    # a tile kernel a level of more than one element (level 0 always), a
    # fix-up a level below the top: what zp_segscan_limbs reports launching
    assert [pl_sorted.scan_kernel_count(K) for K in (32, 33, 1536, K_JAX)] == [1, 2, 4, 5]
    seg = seg_layouts(1536, seed=94)
    depths = [pl_sorted.scan_depth(seg[i : i + 1]) for i in range(seg.shape[0])]
    assert depths[0] == 0  # singletons: copies only
    assert depths[1] == 12  # one segment over all K: 5 + 1 + 5 + 1
    assert depths[2] == 5 + 0 + 0  # segments of one tile: no carry goes on
    assert max(depths) == pl_sorted.scan_depth(seg) == 12
    # the skewed stream's window 0 (all scalars 1: one bucket over every one
    # of 1 024 chunks, then padding ids): 32 whole tiles, one level-1 tile,
    # so no level-1 fix-up adds: 5 + 1 + 5
    skew = torch.cat([torch.zeros(1024), 512 + torch.arange(512)]).to(torch.int32)[None]
    assert pl_sorted.scan_depth(skew) == 11
    reach = pl_sorted.scan_reach(torch.tensor([[0, 0, 0, 1, 1] + [2] * 40]))
    assert reach[0, :5].tolist() == [0, 1, 2, 0, 1] and reach[0, 32].item() == 0


def test_lanes_at_eight_warps_a_sm():
    """K4 over Fq2 at path G2's shape (W = 44, B = 32, T = 768 partials a
    bucket): 8 one-warp blocks a SM on 132 SMs fill one wave of 33 792 lanes
    of 32 partials; the two-slot form's 6 took 25 344."""
    W, B, T = 44, 32, 768
    lanes = pl_reduce._reduce_lanes(W * B, T, 8 * 32 * 132)
    assert lanes == 33792 and W * B * T / lanes == 32
    assert pl_reduce._reduce_lanes(W * B, T, 6 * 32 * 132) == 25344


def test_lane_split_at_32_partials_matches_reference():
    """K4's even split at path G2's 32 partials a lane (three lanes a bucket
    here, so warps cross buckets) on toy_g2 sweep partials, against the JAX
    package's lane reduction (its jnp engine's bucket sums)."""
    C, BITS, LANES = 4, 12, 96
    W, B = windows.num_windows(BITS, C), 1 << (C - 1)
    pts, XY = _points(LANES * 3, seed=95)
    rng = np.random.default_rng(96)
    ks = [0 if i % 7 == 0 else int(rng.integers(1, 1 << BITS)) for i in range(len(pts))]
    sc = ints_to_limbs(ks, G2.fr.n_limbs)
    digits = windows.signed_window_digits(to_torch(sc), C, BITS)
    raw = pippenger._bucket_sweep_plain(G2, XY, digits, LANES, C)  # (L, W, T, B)
    partials = tuple(r.permute(3, 0, 1, 2) for r in raw)  # (B, L, W, T)
    N = W * B * LANES // 32
    assert N % 32 == 0 and W * B * LANES / N == 32
    got = lane_reduce_schedule(G2, partials, N)
    jXY = to_jax(torch_np(XY))
    ref_digits = ref_windows.signed_window_digits(to_jax(sc), C, BITS)
    want = ref_pippenger.bucket_accumulate_c(REF, jXY, ref_digits, LANES, C)
    assert port_affine(got) == ref_affine(tuple(np.asarray(a) for a in want))
    assert port_affine(got) == port_affine(pl_reduce.lane_reduce_plain(G2, partials))
