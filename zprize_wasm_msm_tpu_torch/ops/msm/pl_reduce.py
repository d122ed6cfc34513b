"""Reduction kernels of the MSM: lane reduction, collapse, finish — each as
a CUDA kernel and as plain PyTorch.

They replace the TPU kernels of zprize_wasm_msm_tpu/ops/msm/pl_reduce.py:

  lane_reduce   (``_lane_reduce_kernel``): (B, L, W, T) lane partials ->
                (L, W, B).  csrc/bucket.cu lane_reduce_kernel (the
                partials split evenly over one wave of lanes: _reduce_lanes)
                + lane_combine_kernel; also the second launch of
                pl_bucket.bucket_accumulate.
  finish_large  (``_collapse_kernel``): per window sum_b (b+1) S_{w,b}
                (csrc/reduce.cu collapse_kernel + combine_kernel: runs of
                m buckets over the whole card, a tree per window; any
                power-of-two B), then finish at B = 1.
  finish        (``_finish_kernel``): sum_w 2^(c w) sum_b (b+1) S_{w,b} ->
                ONE point (csrc/reduce.cu: the collapse's launches when
                B > 1; then finish_kernel, one warp, the window fold by
                Horner's rule; over Fq2 finish2_kernel, one block whose
                links run each Fq2 product's three Karatsuba products side
                by side, csrc/fold2.cuh).

Reference lineage: reduceBucketsToSinglePoint (running sum over buckets,
wasmcurves/src/build_multiexp_opt.js:1597-1706) + accumulateAcrossChunks
(Horner over windows, :1710-1746) — the same weighted sum, reassociated
(the group is abelian; the result is the same point, another projective
representative).

All three are bound by operations and, being a few thousand group ops with
a long serial tail, by latency; see the notes at the top of the sources.
Wrappers take and return the package's public layout ((L, ...) int64
16-bit limbs) and re-pack to 32-bit words around the launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ... import _build
from ..curve.spec import CurveSpec
from . import _launch, pippenger

#: lanes (W*B) the one-block finish takes; above it msm uses finish_large
FINISH_LANES = 1024
#: threads of the fold's block over Fq2 (csrc/reduce.cu FOLD2_THREADS)
FOLD2_THREADS = 96
#: times each kernel was launched (read by chip_smoke.py)
launches = {"lane_reduce": 0, "collapse": 0, "finish": 0}


def _check_buckets(curve, buckets):
    bx, by, bz = buckets
    L = curve.field.elem_len
    if bx.ndim != 3 or bx.shape[0] != L:
        raise ValueError(f"buckets: expected ({L}, W, B) tensors, got {tuple(bx.shape)}")
    for name, t in zip("xyz", buckets):
        _launch.check_limbs(f"buckets {name}", t, bx.shape, bx.device)
    return bx.shape[1], bx.shape[2]


# ---------------------------------------------------------------------------
# lane reduction
# ---------------------------------------------------------------------------


def lane_reduce_plain(curve: CurveSpec, buckets):
    """(bx, by, bz) each (B, L, W, T) -> (L, W, B): the plain lane tree."""
    return pippenger._lane_tree_reduce(
        curve, tuple(b.permute(1, 2, 3, 0) for b in buckets)
    )


#: threads per block of the lane-reduction kernels by extension degree
#: (csrc/bucket.cu reduce_threads<EXT>())
REDUCE_THREADS = {1: 128, 2: 32}


def _reduce_lanes(buckets: int, T: int, resident: int) -> int:
    """Lanes of the lane reduction for ``buckets`` buckets of T partials,
    from the shape and the ``resident`` threads of one wave.  Each lane's
    adds are one dependent chain (csrc/bucket.cu), so one wave of evenly
    loaded lanes gives the shortest longest chain.  Where whole warps per
    bucket (32 k lanes each) still fill three quarters of that wave, take
    them: no lane then crosses a bucket and no bucket more warps than it
    needs (path A: 2 warps a bucket, 47 104 lanes; measured faster there than
    the full wave by chip_smoke.py).  Else the full wave, whole warps, at
    least one lane per bucket so that a lane's share touches at most two
    buckets (the full path: 50 688 lanes of 49 partials; counts on a card
    that keeps 50 688 resident)."""
    k = min(resident // (32 * buckets), T // 32)
    if k >= 1 and 32 * k * buckets * 4 >= 3 * resident:
        return 32 * k * buckets
    n = max(buckets, min(resident, buckets * T))
    return -(-n // 32) * 32


@functools.lru_cache(maxsize=None)
def _reduce_resident_threads(nw: int, ext: int, device_index: int) -> int:
    blocks = _build.kernel_info("bucket", "zp_lane_reduce_info", nw, ext, 0)["blocks_per_sm"]
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return blocks * REDUCE_THREADS[ext] * sms


def _lane_reduce_state(curve: CurveSpec, state: torch.Tensor, lanes=None):
    """Launch the lane-reduction kernel on the sweep's native state,
    (W, T, B, 3*EW) int32 words (EW = ext NW words an element) -> (X, Y, Z)
    each (L, W, B) int64.  ``lanes`` (a multiple of 32, at least W*B) is
    _reduce_lanes' choice unless given."""
    lib = _build.load("bucket")
    fn = lib.zp_lane_reduce
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    NW, ext = curve.fq.n_words, curve.ext
    EW = ext * NW
    W, T, B, _ = state.shape
    N = lanes or _reduce_lanes(W * B, T, _reduce_resident_threads(NW, ext, state.device.index or 0))
    out = torch.empty((3, EW, W * B), dtype=torch.int32, device=state.device)
    # the warps' first and last pieces, then one parked head per lane
    pieces = torch.empty((2 * (N // 32) + N, 3 * EW), dtype=torch.int32, device=state.device)
    err = fn(
        NW, ext, _build.curve_consts(curve).ctypes.data_as(ctypes.c_void_p),
        _launch.ptr(state), _launch.ptr(out), _launch.ptr(pieces), W, T, B, N,
        _launch.stream_ptr(),
    )
    _build.check_launch(err, "lane_reduce")
    launches["lane_reduce"] += 1
    return _launch.unpack_point(out, (W, B))


def lane_reduce(curve: CurveSpec, buckets, impl: str = "auto"):
    """(bx, by, bz) each (B, L, W, T) lane partials -> (L, W, B) sums."""
    bx = buckets[0]
    if not _launch.use_kernel(impl, bx):
        return lane_reduce_plain(curve, buckets)
    B, L, W, T = bx.shape
    for name, t in zip("xyz", buckets):
        _launch.check_limbs(f"buckets {name}", t, bx.shape, bx.device)
    # (B, L, W, T) limbs -> the sweep's state layout (W, T, B, 3*NW) words
    words = torch.stack(
        [_launch.pack_point((b.permute(1, 2, 3, 0),))[0] for b in buckets]
    )  # (3, NW, W*T*B)
    state = words.reshape(3 * (L // 2), W, T, B).permute(1, 2, 3, 0).contiguous()
    return _lane_reduce_state(curve, state)


# ---------------------------------------------------------------------------
# finish: dense buckets -> one point
# ---------------------------------------------------------------------------


def finish_plain(curve: CurveSpec, buckets, c: int):
    """bucket_reduce + window_fold.  B may be smaller than 2^(c-1): c sets
    the window weight 2^(c w), B only the number of bucket weights."""
    return pippenger.window_fold(curve, pippenger.bucket_reduce(curve, buckets), c)


def finish(curve: CurveSpec, buckets, c: int, impl: str = "auto"):
    """(bx, by, bz) each (L, W, B) dense bucket sums -> ONE projective
    point (L,) x3: sum_w 2^(c*w) sum_b (b+1) S_{w,b}.

    B is a power of two <= 2^(c-1) and W*B <= FINISH_LANES.  B = 1 turns
    this into a pure window fold — the second stage of finish_large."""
    W, B = _check_buckets(curve, buckets)
    if B > 1 << (c - 1) or B & (B - 1) or W * B > FINISH_LANES:
        raise ValueError(
            f"finish: need B a power of two <= 2^(c-1) and W*B <= {FINISH_LANES}; "
            f"got W={W}, B={B}, c={c}"
        )
    if not _launch.use_kernel(impl, buckets[0]):
        return finish_plain(curve, buckets, c)
    lib = _build.load("reduce")
    fn = lib.zp_finish
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32] + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    NW, ext = curve.fq.n_words, curve.ext
    # the window sums as words: at B > 1 the collapse's launches leave them
    if B > 1:
        sums = _collapse_launch(curve, buckets, limbs_out=False)
    else:
        sums = _launch.pack_point(buckets)
    out = torch.empty((3, ext * NW, 1), dtype=torch.int32, device=buckets[0].device)
    err = fn(
        NW, ext, _build.curve_consts(curve).ctypes.data_as(ctypes.c_void_p), _build.fold_b3k(curve),
        _launch.ptr(sums), _launch.ptr(out), W, c, _launch.stream_ptr(),
    )
    _build.check_launch(err, "finish")
    launches["finish"] += 1
    return _launch.unpack_point(out, ())


# ---------------------------------------------------------------------------
# large-B finish: per-window weighted collapse, then the B=1 window fold
# ---------------------------------------------------------------------------


def collapse_plain(curve: CurveSpec, buckets):
    """Per window sum_b (b+1) S_{w,b}: pippenger.bucket_reduce_grouped (the
    running-sum walk of bucket_reduce, sqrt-split above 64 buckets)."""
    return pippenger.bucket_reduce_grouped(curve, buckets)


def finish_large_plain(curve: CurveSpec, buckets, c: int):
    """The same point as finish_large through plain PyTorch ops."""
    return pippenger.window_fold(curve, collapse_plain(curve, buckets), c)


#: threads per block of the collapse kernels (csrc/reduce.cu COLLAPSE_THREADS)
COLLAPSE_THREADS = 128
#: warp schedulers per SM (Hopper: four)
SCHEDULERS_PER_SM = 4


def _collapse_lanes(nw: int) -> int:
    """Lanes per point of the collapse's level-parallel group ops: 8 PL,
    PL the lanes of one cooperative product (csrc/coop.cuh coop_lanes<NW>())."""
    return 8 * (4 if nw % 4 == 0 else 2 if nw % 2 == 0 else 1)


def _collapse_run(W: int, B: int, wave_groups: int) -> int:
    """Buckets per run of the collapse (m): the smallest power of two for
    which the W B / m runs, a group of lanes each, number at most
    ``wave_groups``; B at most.  A run's walk is 2 (m - 1) dependent
    additions and log2 m doublings, and the tree over a window's runs 4
    links a level, so shorter runs make a shorter chain; but each link is
    a warp's instructions one after another, and a warp that shares its
    scheduler waits for the others: more groups than one warp per scheduler
    made every link slower than the shorter chain saved, and fewer made the
    walk longer (the collapse's time at every run length is in
    chip_smoke.py's kernels line)."""
    m = 1
    while m < B and W * B > m * wave_groups:
        m *= 2
    return m


def _collapse_links(B: int, m: int):
    """(additions, doublings) on the collapse's longest dependent chain: the
    walk of a run (2 (m - 1) additions), Rs = m R (log2 m doublings), then
    log2(B / m) tree levels of 3 additions and a doubling, the last level
    without its doubling and the addition into Rs."""
    levels = (B // m).bit_length() - 1
    last = 1 if levels else 0
    return 2 * (m - 1) + 3 * levels - last, (m.bit_length() - 1) + levels - last


@functools.lru_cache(maxsize=None)
def _collapse_wave_groups(nw: int, device_index: int) -> int:
    """Groups of lanes of one warp per scheduler of the card (over Fq2 too:
    a group there has the same lanes, each product being three cooperative
    Fq products in sequence)."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms * SCHEDULERS_PER_SM * 32 // _collapse_lanes(nw)


def _collapse_launch(curve: CurveSpec, buckets, m: int = 0, limbs_out: bool = True):
    """Launch the collapse on (L, W, B) limb tensors: the window sums as
    (3, L, W) limbs, or (limbs_out False) as (3, NW, W) words, the fold's
    input.  The kernels read the limbs, so no packing launch precedes them.
    m (buckets per run) is _collapse_run's choice where 0."""
    lib = _build.load("reduce")
    fn = lib.zp_collapse
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32] + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    NW = curve.fq.n_words
    L, W, B = buckets[0].shape
    EW = L // 2  # words an element: ext NW
    bx, by, bz = (t.contiguous() for t in buckets)
    m = m or _collapse_run(W, B, _collapse_wave_groups(NW, bx.device.index or 0))
    # the window sums as words, then two halves of the combine launches'
    # pairs (csrc/reduce.cu collapse_launches)
    cap = max(1, W * B // m // (COLLAPSE_THREADS // _collapse_lanes(NW)))
    scratch = torch.empty((3 * EW * W + 2 * 2 * 3 * EW * cap,), dtype=torch.int32,
                          device=bx.device)
    out = torch.empty((3, L, W), dtype=torch.int64, device=bx.device) if limbs_out else None
    err = fn(
        NW, curve.ext, _build.curve_consts(curve).ctypes.data_as(ctypes.c_void_p),
        _build.fold_b3k(curve),
        _launch.ptr(bx), _launch.ptr(by), _launch.ptr(bz),
        None if out is None else _launch.ptr(out), _launch.ptr(scratch), W, B, m,
        _launch.stream_ptr(),
    )
    _build.check_launch(err, "collapse")
    return out if limbs_out else scratch[: 3 * EW * W].view(3, EW, W)


def collapse(curve: CurveSpec, buckets, impl: str = "auto"):
    """(bx, by, bz) each (L, W, B) -> window sums (L, W) x3,
    sum_b (b+1) S_{w,b}: stage A of finish_large, and the per-window
    reduction of the sorted engine (any power-of-two B)."""
    W, B = _check_buckets(curve, buckets)
    if B & (B - 1):
        raise ValueError(f"collapse: need B a power of two, got {B}")
    if not _launch.use_kernel(impl, buckets[0]):
        return collapse_plain(curve, buckets)
    out = _collapse_launch(curve, buckets)
    launches["collapse"] += 1
    return out[0], out[1], out[2]


def finish_large(curve: CurveSpec, buckets, c: int, impl: str = "auto"):
    """(bx, by, bz) each (L, W, B) dense bucket sums -> ONE projective
    point, for configurations whose W * B exceeds the one-block finish
    (c = 7: 38 windows x 64 buckets).  Stage A: collapse every window's
    buckets with (b+1) weights.  Stage B: finish at B = 1 folds the W window
    sums with 2^(c*w) weights."""
    W, B = _check_buckets(curve, buckets)
    if B != 1 << (c - 1):
        raise ValueError(f"finish_large: need B = 2^(c-1), got B={B}, c={c}")
    sums = collapse(curve, buckets, impl=impl)
    return finish(curve, tuple(a[:, :, None] for a in sums), c, impl=impl)
