"""Sorted-runs bucket accumulation: the large-window (c > 7) engine.

Counterpart of zprize_wasm_msm_tpu/ops/msm/pl_sorted.py.  The bucket-sweep
kernel (pl_bucket) keeps a private row of 2^(c-1) buckets per (window,
lane), which caps c.  This engine has no bucket array — the re-architecture
of the reference's organizeBuckets counting sort + addition chains
(wasmcurves/src/build_multiexp_opt.js organizeBuckets:568,
constructAdditionChains:651, evaluateAdditionChains:810):

  1. SORT    (torch)   per window, sort the points' indices by signed-digit
                       bucket (``torch.sort`` on the key |d| - 1, zero
                       digits to a tail sentinel B).  Equal buckets become
                       contiguous RUNS.  ``sort_runs``.
  2. COMPACT (torch)   a run ends where the key changes or where one of the
                       T chunks of the stream ends; there are at most
                       K = B + T such flushes per window.  A cumulative sum
                       numbers them, which gives every flush its slot among
                       K entries and every entry its segment id (the
                       bucket).  ``compact_index``.  No data-dependent
                       shape, hence no host synchronisation.
  3. SWEEP   (kernel)  every (window, chunk) keeps ONE running accumulator
                       over its part of the sorted stream: acc <- acc +
                       point (complete mixed add, the point read through
                       the permutation, y negated for negative digits); at a
                       run boundary the partial sum goes to its slot and the
                       accumulator resets.  ``sweep`` / ``sweep_plain``.
  4. SEGSCAN (kernel)  pieces of a bucket split across chunks (<= T of
                       them, typically 1-3) are merged by an inclusive
                       segmented scan over the K entries.  ``segscan`` /
                       ``segscan_plain``; a schedule of log depth in
                       tiles of SCAN_TILE entries (``scan_levels``,
                       ``scan_depth``).
  5. SCATTER (torch)   the last entry of each segment lands in the dense
                       (L, W, B) bucket array that collapse / bucket_reduce
                       consume; empty buckets are the identity (0, 1, 0).
                       ``scatter_dense``.

The JAX package runs stage 2 after the sweep, on an (N,)-slot output per
window that the TPU kernel writes in full; here the slots are numbered
first and the sweep writes only the K entries.  All windows go through each
stage at once.

Over Fq2 (G2) the stages are the same, elements are (2L, ...) flat limbs
(tower.Fq2), and the sweep launches its Fq2 kernel (csrc/sorted.cu
sorted_sweep2_kernel); the scan's kernels (segscan_tile_kernel and
segscan_fix_kernel, whose levels ``scan_levels`` lists) serve both fields.

Digit semantics match windows.signed_window_digits; results equal the other
engines as group elements (the addition order differs).  The sort's order
among equal keys is not defined, so per-entry values may differ from run to
run and from the JAX package's; dense bucket sums do not.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ... import _build
from ..curve import group
from ..curve.spec import CurveSpec
from . import _launch

I32 = torch.int32
I64 = torch.int64

#: chunks per window (running accumulators per window) when the caller
#: names none: the JAX package's grid
GRID = 1024

#: meta bits of a stream position
META_BOUNDARY = 1  # a run or a chunk ends here: flush, then reset
META_ZERO = 2  # zero digit: the point contributes nothing
META_NEG = 4  # negative digit: add (x, -y)

#: times each kernel was launched (read by chip_smoke.py)
launches = {"sweep": 0, "segscan": 0}
#: device kernels the scan's calls launched, as its entry reports them
#: (zp_segscan_limbs: a tile kernel a level, a fix-up a level below the top)
scan_kernels = {"segscan": 0}


# ---------------------------------------------------------------------------
# stages 1 + 2: sort and flush numbering (plain tensor code on any device)
# ---------------------------------------------------------------------------


def sort_runs(digits: torch.Tensor, c: int, chunks: int = GRID):
    """(W, N) int32 signed digits -> the sorted stream of every window.

    Returns (perm, skey, meta), each (W, N) int32 in stream order: the index
    of the point at each position, its bucket key (|d| - 1, or B = 2^(c-1)
    for a zero digit) and its META_* bits.  N must be a multiple of
    ``chunks``; chunk t owns positions [t * N/chunks, (t + 1) * N/chunks).
    """
    W, N = digits.shape
    if digits.dtype != I32 or N % chunks:
        raise ValueError(
            f"sort_runs: need int32 digits with N a multiple of {chunks}, got "
            f"{digits.dtype} {tuple(digits.shape)}"
        )
    B = 1 << (c - 1)
    steps = N // chunks
    key = torch.where(digits == 0, B, digits.abs() - 1).to(I32)
    skey, perm = torch.sort(key, dim=1)
    neg = torch.gather(digits < 0, 1, perm)
    nxt = torch.cat([skey[:, 1:], torch.full_like(skey[:, :1], -1)], dim=1)
    pos = torch.arange(N, device=digits.device)
    chunk_end = (pos % steps) == (steps - 1)
    boundary = (skey != nxt) | chunk_end[None]
    meta = (
        boundary.to(I32) * META_BOUNDARY + (skey == B).to(I32) * META_ZERO + neg.to(I32) * META_NEG
    )
    return perm.to(I32), skey, meta


def compact_index(skey: torch.Tensor, meta: torch.Tensor, c: int, chunks: int = GRID):
    """Number the flushes of every window.

    A flush is a boundary position of a nonzero digit.  Returns (slot, seg):
    slot (W, N) int32, the entry index in [0, K) a flush writes to, -1
    elsewhere; seg (W, K) int32, the bucket of each entry, K = B + chunks.
    Unused entries get the distinct ids B + k: sorted, beyond every bucket,
    each a segment of its own.
    """
    W, N = skey.shape
    B = 1 << (c - 1)
    K = B + chunks
    flush = (meta & (META_BOUNDARY | META_ZERO)) == META_BOUNDARY
    index = flush.cumsum(dim=1) - 1  # int64
    slot = torch.where(flush, index, -1).to(I32)
    seg = (B + torch.arange(K + 1, device=skey.device, dtype=I32)).repeat(W, 1)
    # column K absorbs the positions that flush nothing
    seg.scatter_(1, torch.where(flush, index, K), skey)
    return slot, seg[:, :K].contiguous()


# ---------------------------------------------------------------------------
# stage 3: the streaming sweep
# ---------------------------------------------------------------------------


def _check_stream(points, perm, meta, slot, chunks):
    X, Y = points
    W, N = perm.shape
    if X.shape != Y.shape or X.ndim != 2:
        raise ValueError("sweep: points are (X, Y), each (L, n)")
    for name, t in (("perm", perm), ("meta", meta), ("slot", slot)):
        if t.dtype != I32 or tuple(t.shape) != (W, N) or t.device != X.device:
            raise ValueError(f"sweep: {name} must be an int32 (W, N) tensor beside the points")
    if N % chunks:
        raise ValueError(f"sweep: N = {N} is not a multiple of {chunks} chunks")
    return W, N


def sweep_plain(
    curve: CurveSpec,
    points: Tuple[torch.Tensor, torch.Tensor],
    perm: torch.Tensor,
    meta: torch.Tensor,
    slot: torch.Tensor,
    K: int,
    chunks: int = GRID,
):
    """Plain PyTorch version of ``sweep``: the same walk, every (window,
    chunk) batched into one mixed add per step."""
    F = curve.field
    X, Y = points
    W, N = _check_stream(points, perm, meta, slot, chunks)
    L = X.shape[0]
    dev = X.device
    steps = N // chunks
    permr = perm.reshape(W, chunks, steps).to(I64)
    metar = meta.reshape(W, chunks, steps)
    slotr = slot.reshape(W, chunks, steps).to(I64)
    # column K of each window's row absorbs the steps that flush nothing
    out = torch.stack(group.zero(curve, (W * (K + 1),), dev))
    row = torch.arange(W, device=dev)[:, None] * (K + 1)
    identity = group.zero(curve, (W * chunks,), dev)
    acc = identity
    for j in range(steps):
        idx = permr[:, :, j].reshape(-1)
        m = metar[:, :, j].reshape(-1)
        zero, neg, boundary = (m & META_ZERO) != 0, (m & META_NEG) != 0, (m & META_BOUNDARY) != 0
        px, py = X[:, idx], Y[:, idx]
        py = F.select(neg, F.neg(py), py)
        # (0, 0) is the affine identity: add_mixed passes the accumulator on
        px = F.select(zero, torch.zeros_like(px), px)
        py = F.select(zero, torch.zeros_like(py), py)
        acc = group.add_mixed(curve, acc, (px, py))
        s = slotr[:, :, j]
        tgt = row + torch.where(boundary.reshape(W, chunks) & (s >= 0), s, K)
        out[:, :, tgt.reshape(-1)] = torch.stack(acc)
        acc = tuple(F.select(boundary, i, a) for i, a in zip(identity, acc))
    out = out.reshape(3, L, W, K + 1)[..., :K]
    return (out[0], out[1], out[2])


def sweep(
    curve: CurveSpec,
    points: Tuple[torch.Tensor, torch.Tensor],
    perm: torch.Tensor,
    meta: torch.Tensor,
    slot: torch.Tensor,
    K: int,
    chunks: int = GRID,
    impl: str = "auto",
):
    """Running-sum sweep over the sorted stream of every window.

    points: affine (X, Y), each (L, n) int64 Montgomery, unsorted.
    perm, meta, slot: (W, N) int32 in stream order (``sort_runs``,
            ``compact_index``); perm indexes the points.
    Returns the K entries per window, (X, Y, Z) each (L, W, K): entry
    slot[w, p] holds the partial sum flushed at boundary position p, every
    entry no flush writes is the identity (0, 1, 0).

    CUDA tensors go through the kernel, CPU tensors through sweep_plain
    (impl="auto"); see _launch.use_kernel.
    """
    X, Y = points
    if not _launch.use_kernel(impl, X):
        return sweep_plain(curve, points, perm, meta, slot, K, chunks)
    W, N = _check_stream(points, perm, meta, slot, chunks)
    L = curve.field.elem_len
    _launch.check_limbs("points X", X, (L, X.shape[1]), X.device)
    _launch.check_limbs("points Y", Y, (L, X.shape[1]), X.device)
    # point-contiguous [n][x words, y words]: a permuted read fetches one
    # point as whole sectors
    pts = _launch.point_words((X, Y))
    out = _sweep_words(curve, pts, perm.contiguous(), meta.contiguous(), slot.contiguous(), K, chunks)
    return _launch.unpack_point(out, (W, K))


def _sweep_words(curve: CurveSpec, pts, perm, meta, slot, K: int, chunks: int) -> torch.Tensor:
    """Launch the sweep kernel on point-contiguous words pts (n, 2, EW) and
    contiguous (W, N) stream tensors (EW = ext * NW words an element: over
    Fq2 the Fq2 kernel); returns the (3, EW, W*K) int32 words of the K
    entries per window."""
    lib = _build.load("sorted")
    fn = lib.zp_sorted_sweep
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    W, N = perm.shape
    out = _launch.pack_point(group.zero(curve, (W * K,), pts.device))
    err = fn(
        curve.fq.n_words, curve.ext, _build.curve_consts(curve).ctypes.data_as(ctypes.c_void_p),
        _launch.ptr(pts), _launch.ptr(perm), _launch.ptr(meta), _launch.ptr(slot),
        _launch.ptr(out), W, chunks, N // chunks, K, _launch.stream_ptr(),
    )
    _build.check_launch(err, "sorted_sweep")
    launches["sweep"] += 1
    return out


# ---------------------------------------------------------------------------
# stage 4: segmented scan of the per-chunk pieces
# ---------------------------------------------------------------------------


def _check_pieces(curve, pieces, seg):
    px = pieces[0]
    L = curve.field.elem_len
    if px.ndim != 3 or px.shape[0] != L:
        raise ValueError(f"segscan: expected ({L}, W, K) tensors, got {tuple(px.shape)}")
    for name, t in zip("xyz", pieces):
        _launch.check_limbs(f"pieces {name}", t, px.shape, px.device)
    if seg.dtype != I32 or tuple(seg.shape) != tuple(px.shape[1:]) or seg.device != px.device:
        raise ValueError("segscan: seg must be an int32 (W, K) tensor beside the pieces")
    return px.shape[1], px.shape[2]


def segscan_plain(curve: CurveSpec, pieces, seg: torch.Tensor, max_len: int):
    """Plain PyTorch version of ``segscan``: ceil(log2(max_len))
    Hillis-Steele rounds, each one masked complete add over all entries
    (the JAX package's ``_segscan_xla``)."""
    W, K = _check_pieces(curve, pieces, seg)
    L = pieces[0].shape[0]
    kiota = torch.arange(K, device=seg.device)
    x, y, z = pieces
    for r in range(max(1, (max_len - 1).bit_length())):
        s = 1 << r
        rolled = tuple(torch.roll(a, s, dims=2).reshape(L, -1) for a in (x, y, z))
        # entries shifted in from the other end of the row match nothing
        rseg = torch.where(kiota < s, -1, torch.roll(seg, s, dims=1))
        same = (rseg == seg)[None]
        new = group.add(curve, rolled, tuple(a.reshape(L, -1) for a in (x, y, z)))
        x, y, z = (torch.where(same, n.reshape(L, W, K), a) for n, a in zip(new, (x, y, z)))
    return (x, y, z)


#: entries a one-warp block of the scan takes (csrc/sorted.cu SCAN_TILE)
SCAN_TILE = 32


def scan_levels(K: int):
    """The levels of the scan over K entries a row (csrc/sorted.cu
    scan_levels): [(n, s), ...], level l's n elements at entries
    (i + 1) s - 1; level l + 1 takes the last element of every whole tile
    of level l, until a level fits one tile.  A function of K alone."""
    levels = [(K, 1)]
    while levels[-1][0] > SCAN_TILE:
        n, s = levels[-1]
        levels.append((n // SCAN_TILE, s * SCAN_TILE))
    return levels


def scan_kernel_count(K: int) -> int:
    """The device kernels a call of the scan launches over K entries a
    row (csrc/sorted.cu zp_segscan_limbs): a tile kernel a level (none for
    a level above the first that holds one element) and a fix-up a level
    below the top."""
    levels = scan_levels(K)
    return sum(1 for l, (n, _) in enumerate(levels) if l == 0 or n > 1) + len(levels) - 1


def scan_reach(ids: torch.Tensor) -> torch.Tensor:
    """(..., n) segment ids of one level -> (..., n) how far each element's
    segment goes back inside its tile of SCAN_TILE (the rounds it adds in:
    those d = 1, 2, 4, ... up to its reach)."""
    n = ids.shape[-1]
    pos = torch.arange(n, device=ids.device)
    before = torch.cat([ids[..., :1], ids[..., :-1]], dim=-1)
    start = (pos % SCAN_TILE == 0) | (before != ids)
    first = torch.where(start, pos, torch.zeros_like(pos)).cummax(dim=-1).values
    return pos - first


def scan_depth(seg: torch.Tensor) -> int:
    """The dependent adds of the scan on seg (W, K): at each level the
    rounds of its deepest tile, plus one for each level's fix-up where some
    tile's first segment began in an earlier tile.  Every level and fix-up
    launches whatever the data; this counts the rounds that add."""
    W, K = seg.shape
    levels = scan_levels(K)
    depth = 0
    for l, (n, s) in enumerate(levels):
        ids = seg[:, (torch.arange(n, device=seg.device) + 1) * s - 1]
        depth += int(scan_reach(ids).max().item()).bit_length()
        if l + 1 < len(levels):
            heads = torch.arange(SCAN_TILE, n, SCAN_TILE, device=seg.device)
            depth += int(bool((ids[:, heads] == ids[:, heads - 1]).any().item()))
    return depth


def segscan(curve: CurveSpec, pieces, seg: torch.Tensor, max_len: int, impl: str = "auto"):
    """Inclusive segmented scan under the complete group add.

    pieces: projective (X, Y, Z), each (L, W, K) int64, sorted by segment.
    seg:    (W, K) int32 segment ids, non-negative, non-decreasing per row.
    max_len: a bound on the entries per segment (the chunk count).
    Returns (X, Y, Z) each (L, W, K): every entry holds the sum of its
    segment's entries up to and including itself, so the last entry of a
    segment holds the segment's sum — as group elements.

    The kernels scan in tiles and levels (``scan_levels``), at most 5 adds a
    level and one a fix-up in a row whatever the segments' lengths, and
    read and write the limbs themselves.  One call is one count in
    ``launches``; it launches a kernel a level and a fix-up a level below
    the top, which its entry counts into ``scan_kernels``.
    """
    if not _launch.use_kernel(impl, pieces[0]):
        return segscan_plain(curve, pieces, seg, max_len)
    W, K = _check_pieces(curve, pieces, seg)
    lib = _build.load("sorted")
    consts = _build.curve_consts(curve).ctypes.data_as(ctypes.c_void_p)
    seg = seg.contiguous()
    fn = lib.zp_segscan_limbs
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    P = tuple(a.contiguous() for a in pieces)
    out = torch.empty((3,) + tuple(P[0].shape), dtype=torch.int64, device=P[0].device)
    kernels = ctypes.c_int(0)
    err = fn(curve.fq.n_words, curve.ext, consts, *(_launch.ptr(a) for a in P), _launch.ptr(seg),
             _launch.ptr(out), W, K, ctypes.byref(kernels), _launch.stream_ptr())
    _build.check_launch(err, "segscan")
    launches["segscan"] += 1
    scan_kernels["segscan"] += kernels.value
    return (out[0], out[1], out[2])


# ---------------------------------------------------------------------------
# stage 5 and the whole engine
# ---------------------------------------------------------------------------


def scatter_dense(curve: CurveSpec, scanned, seg: torch.Tensor, c: int):
    """Last-of-segment scatter: (L, W, K) scanned entries -> dense bucket
    sums (X, Y, Z), each (L, W, B).  Buckets no entry belongs to are the
    identity (0, 1, 0)."""
    W, K = seg.shape
    L = scanned[0].shape[0]
    B = 1 << (c - 1)
    dev = seg.device
    nxt = torch.cat([seg[:, 1:], torch.full_like(seg[:, :1], -1)], dim=1)
    last = (seg != nxt) & (seg < B)
    # column B of each window's row absorbs everything else
    row = torch.arange(W, device=dev)[:, None] * (B + 1)
    tgt = row + torch.where(last, seg.to(I64), B)
    flat = torch.stack(group.zero(curve, (W * (B + 1),), dev))
    flat[:, :, tgt.reshape(-1)] = torch.stack([a.reshape(L, -1) for a in scanned])
    dense = flat.reshape(3, L, W, B + 1)[..., :B]
    return (dense[0], dense[1], dense[2])


def bucket_accumulate_sorted(
    curve: CurveSpec,
    points: Tuple[torch.Tensor, torch.Tensor],
    digits: torch.Tensor,
    c: int,
    chunks: int = GRID,
    impl: str = "auto",
):
    """Full-window bucket accumulation through the sorted-runs engine.

    points: affine (X, Y), each (L, N) int64 Montgomery.
    digits: (W, N) int32 signed digits (windows.signed_window_digits),
            values in [-2^(c-1), 2^(c-1)]; zero digits contribute nothing.
    chunks: T, running accumulators per window (N is padded to a multiple).
    Returns bucket sums (X, Y, Z), each (L, W, B), B = 2^(c-1) — the
    contract of pl_bucket.bucket_accumulate.

    CUDA tensors go through the kernels, CPU tensors through their plain
    versions (impl="auto"); see _launch.use_kernel.
    """
    X, Y = points
    _launch.use_kernel(impl, X)  # "kernel" on CPU tensors raises before any work
    W, N = digits.shape
    pad = (-N) % chunks
    if pad:  # zero digits: they sort to the tail and add nothing
        digits = torch.cat(
            [digits, torch.zeros((W, pad), dtype=digits.dtype, device=digits.device)], dim=1
        )
    perm, skey, meta = sort_runs(digits, c, chunks)
    if pad:  # padded positions carry META_ZERO, so their index is never read
        perm = perm.clamp(max=N - 1)
    slot, seg = compact_index(skey, meta, c, chunks)
    K = seg.shape[1]
    pieces = sweep(curve, (X, Y), perm, meta, slot, K, chunks, impl=impl)
    scanned = segscan(curve, pieces, seg, chunks, impl=impl)
    return scatter_dense(curve, scanned, seg, c)
