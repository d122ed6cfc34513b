"""Bucket accumulation: the MSM hot loop, as a CUDA kernel and as plain
PyTorch.

``bucket_accumulate`` replaces the TPU kernel behind
zprize_wasm_msm_tpu/ops/msm/pl_bucket.py ``bucket_accumulate`` (``_kernel``):
stream the point batch through the card once, and for every (window, lane)
add each point into its signed-digit bucket with ONE complete mixed
addition; then sum the lanes into dense (L, W, B) bucket sums.

On the card this is two launches from csrc/bucket.cu: the sweep (one thread
per (window, lane), a private bucket row per thread in device memory,
direct indexing, no atomics; over Fq2 bucket_sweep2_kernel, the same
schedule on points in shared memory) and the lane reduction (pl_reduce.lane_reduce's
kernel, one block per (window, bucket)).  The kernel engine of
pippenger.msm picks the lane count (pippenger._kernel_lanes: one wave of
``resident_threads``); this module runs the lanes it is given.  What bounds them and why the
state is laid out as it is stands at the top of csrc/bucket.cu.

Lane t of the kernel takes points t, t+T, t+2T, ... (interleaved, so a
warp reads neighbouring points); the plain version gives lane t the
contiguous chunk [t*N/T, (t+1)*N/T) as the reference's jnp engine does.
The two therefore add in different orders: results are equal as group
elements (compare after to_affine), not as projective limbs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ... import _build
from ..curve.spec import CurveSpec
from . import _launch, pippenger, pl_reduce

#: times the sweep kernel was launched (read by chip_smoke.py)
launches = 0


def _pad(curve, points, digits, lanes):
    """Pad N to a multiple of the lane count with (0,0) points and zero
    digits: identity adds, so every lane of the plain version takes a whole
    chunk."""
    X, Y = points
    W, N = digits.shape
    pad = (-N) % lanes
    if pad:
        zf = torch.zeros((X.shape[0], pad), dtype=X.dtype, device=X.device)
        X = torch.cat([X, zf], dim=1)
        Y = torch.cat([Y, zf], dim=1)
        digits = torch.cat(
            [digits, torch.zeros((W, pad), dtype=digits.dtype, device=digits.device)], dim=1
        )
    return X, Y, digits


def bucket_accumulate_plain(
    curve: CurveSpec,
    points: Tuple[torch.Tensor, torch.Tensor],
    digits: torch.Tensor,
    *,
    lanes: int = 128,
    c: int = 4,
    mem_budget_bytes: int = 2 << 30,
):
    """Plain PyTorch version: pippenger._bucket_accumulate_impl (gather,
    mixed add, index write per step) + _lane_tree_reduce (its adds in parts
    under mem_budget_bytes)."""
    X, Y, digits = _pad(curve, points, digits, lanes)
    return pippenger._bucket_accumulate_impl(curve, (X, Y), digits, lanes, c, mem_budget_bytes)


#: threads per block of the sweep kernel by extension degree (csrc/bucket.cu
#: SWEEP_THREADS over Fq, SWEEP2_THREADS over Fq2)
SWEEP_THREADS = {1: 64, 2: 32}


@functools.lru_cache(maxsize=None)
def _resident_threads(nw: int, ext: int, device_index: int) -> int:
    blocks = _build.kernel_info("bucket", "zp_bucket_sweep_info", nw, ext)["blocks_per_sm"]
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return blocks * SWEEP_THREADS[ext] * sms


def resident_threads(curve: CurveSpec, device) -> int:
    """Sweep threads the card keeps resident at once (all SMs), as the CUDA
    runtime reports the occupancy of the sweep kernel of this curve's field
    width and extension degree."""
    return _resident_threads(curve.fq.n_words, curve.ext, torch.device(device).index or 0)


def _sweep(curve: CurveSpec, Xw, Yw, digits, lanes: int, B: int) -> torch.Tensor:
    """Launch the sweep kernel on (EW, N) word arrays (EW = ext NW words an
    element); returns the lane-unreduced bucket state, (W, T, B, 3*EW)
    int32 words."""
    global launches
    lib = _build.load("bucket")
    fn = lib.zp_bucket_sweep
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    consts = _build.curve_consts(curve)
    NW = curve.fq.n_words
    W, N = digits.shape
    state = torch.empty((W, lanes, B, 3 * curve.ext * NW), dtype=torch.int32, device=digits.device)
    err = fn(
        NW, curve.ext, consts.ctypes.data_as(ctypes.c_void_p), _launch.ptr(digits),
        _launch.ptr(Xw), _launch.ptr(Yw), _launch.ptr(state), W, lanes, N, B,
        _launch.stream_ptr(),
    )
    _build.check_launch(err, "bucket_sweep")
    launches += 1
    return state


def bucket_accumulate(
    curve: CurveSpec,
    points: Tuple[torch.Tensor, torch.Tensor],
    digits: torch.Tensor,
    *,
    lanes: int = 128,
    c: int = 4,
    impl: str = "auto",
):
    """Scatter-accumulate points into signed buckets and sum the lanes.

    points: affine (X, Y), each (L, N) int64 Montgomery.
    digits: (W, N) int32 signed digits (windows.signed_window_digits),
            values in [-2^(c-1), 2^(c-1)].
    lanes:  T, lanes per window (any T; the plain version pads N to a
            multiple, the kernel's lanes past N take zero digits).
    Returns dense bucket sums (X, Y, Z), each (L, W, B), B = 2^(c-1).

    CUDA tensors go through the kernels, CPU tensors through
    bucket_accumulate_plain (impl="auto"); see _launch.use_kernel.
    """
    X, Y = points
    if not _launch.use_kernel(impl, X):
        return bucket_accumulate_plain(curve, points, digits, lanes=lanes, c=c)
    L = curve.field.elem_len
    W, N = digits.shape
    _launch.check_limbs("points X", X, (L, N), X.device)
    _launch.check_limbs("points Y", Y, (L, N), X.device)
    if digits.dtype != torch.int32 or digits.device != X.device:
        raise ValueError("digits: expected an int32 tensor beside the points")
    if lanes < 1 or not 1 <= c <= 8:
        raise ValueError(f"lanes={lanes}, c={c}: need lanes >= 1 and 1 <= c <= 8")
    B = 1 << (c - 1)
    # no padding: the kernel's lanes past N take zero digits
    words = _launch.pack_point((X, Y))
    state = _sweep(curve, words[0], words[1], digits.contiguous(), lanes, B)
    return pl_reduce._lane_reduce_state(curve, state)
