"""Pippenger MSM: the bucket method.

Counterpart of the reference's ZPrize MSM engine
(wasmcurves/src/build_multiexp_opt.js — multiExp:1987, computeSchedule:299,
organizeBuckets:568, evaluateAdditionChains:810, reduceBuckets:1336,
reduceBucketsToSinglePoint:1597, accumulateAcrossChunks:1710).

Pipeline (reference stage -> stage here):

  computeSchedule + getChunk      -> windows.signed_window_digits
  organizeBuckets + addition
  chains + reduceBuckets          -> bucket accumulation: every (window,
                                     lane) owns a private bucket row and
                                     runs one complete mixed add per point,
                                     then the lanes are summed
  reduceBucketsToSinglePoint      -> bucket_reduce (running sum over buckets)
  accumulateAcrossChunks          -> window_fold (Horner over windows)

Engines (``impl``), chosen by where the tensors lie when ``impl="auto"``:

  "kernel"         CUDA tensors: the hand-written kernels — pl_bucket's
                   sweep and lane reduction, then pl_reduce's finish (one
                   block) or finish_large (collapse + window fold).  A
                   private bucket row per (window, lane): c <= 7 over Fq,
                   c <= 6 over Fq2 (G2).
  "kernel-sorted"  CUDA tensors, any c: pl_sorted's sort / sweep / segmented
                   scan, then pl_reduce's collapse and the window fold
                   (finish at B = 1).  "kernel" with c above its cap routes
                   here, over Fq and Fq2 alike.
  "plain"          CPU tensors: the PyTorch-op functions in this module
                   (_bucket_sweep_plain, _lane_tree_reduce, bucket_reduce,
                   window_fold).  They are also the plain versions the
                   kernels are held against.
  "plain-sorted"   the sorted engine's stages with the plain sweep and scan,
                   then bucket_reduce_grouped + window_fold.

"auto" is "kernel" for CUDA tensors and "plain" for CPU tensors, and
"plain" for cubic-extension and general-a curves on every device (the
reference's routing, resolve_config).
Asking for a kernel engine on a CPU tensor raises; nothing falls back.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..curve import group
from ..curve.spec import CurveSpec
from . import windows

#: lanes per window of the kernel engine when the caller names none, before
#: _kernel_lanes raises them to fill one wave of the sweep's resident threads
KERNEL_LANES = 1024
#: the engines of msm (see the module docstring)
ENGINES = ("kernel", "kernel-sorted", "plain", "plain-sorted")


def _lane_count(n: int, c: int, n_windows: int, mem_budget_bytes: int, n_limbs: int) -> int:
    """Pick T (lanes per window) of the plain engine under the bucket-memory
    budget, exactly as the reference does (4 bytes per limb in its count:
    the port's int64 limbs hold twice that; the lane tree's adds keep their
    temporaries within the budget, _add_in_parts).

    More lanes -> fewer sequential steps (n / T of them) but more bucket
    memory and a deeper final tree reduction.
    """
    B = 1 << (c - 1)
    per_lane = n_windows * B * 3 * n_limbs * 4
    t = max(1, mem_budget_bytes // per_lane)
    t = min(t, max(1, n))
    return 1 << (int(t).bit_length() - 1)


def _bucket_sweep_plain(curve, points, digits, lanes, c):
    """Scatter-accumulate points into per-(window, lane) signed buckets.

    points: affine (X, Y), each (L, N) Montgomery.
    digits: (W, N) int32 signed digits from signed_window_digits.
    lanes:  T lanes per window (N % T == 0; callers pad).

    Each of the W*T (window, lane) pairs owns a private bucket row, so the
    gathered and scattered positions are distinct by construction; lane t
    handles points [t*steps, (t+1)*steps).  The state is updated in place
    (index_put on distinct positions): (3, L, W*T*B) int64, the only large
    allocation.  Returns the lane-unreduced state (X, Y, Z), each
    (L, W, T, B), B = 2^(c-1).
    """
    F = curve.field
    L = F.elem_len
    X, Y = points
    W, N = digits.shape
    T = lanes
    steps = N // T
    B = 1 << (c - 1)
    dev = X.device

    Xr = X.reshape(L, T, steps)
    Yr = Y.reshape(L, T, steps)
    Dr = digits.reshape(W, T, steps).to(torch.int64)

    state = torch.stack(group.zero(curve, (W * T * B,), dev))  # (3, L, W*T*B)
    row = torch.arange(W * T, device=dev).reshape(W, T) * B

    for j in range(steps):
        d = Dr[:, :, j]  # (W, T)
        px = Xr[:, None, :, j].expand(L, W, T)
        py = Yr[:, None, :, j].expand(L, W, T)
        is_zero = d == 0
        neg = d < 0
        idx = torch.where(is_zero, torch.zeros_like(d), d.abs() - 1)
        # effective affine point: negate y for negative digits; (0,0) for
        # zero digits -> add_mixed's identity passthrough skips them
        y_eff = F.select(neg, F.neg(py), py)
        x_eff = F.select(is_zero, torch.zeros_like(px), px)
        y_eff = F.select(is_zero, torch.zeros_like(py), y_eff)
        pos = (row + idx).reshape(-1)  # distinct: one per (w, t)
        cur = state[:, :, pos]  # (3, L, W*T)
        new = group.add_mixed(
            curve,
            (cur[0], cur[1], cur[2]),
            (x_eff.reshape(L, -1), y_eff.reshape(L, -1)),
        )
        state[:, :, pos] = torch.stack(new)

    return tuple(s.reshape(L, W, T, B) for s in state)


def _bucket_accumulate_impl(curve, points, digits, lanes, c, mem_budget_bytes=2 << 30):
    """Plain bucket accumulation: the sweep, then the lane tree.  Returns
    bucket sums (X, Y, Z), each (L, W, B)."""
    return _lane_tree_reduce(
        curve, _bucket_sweep_plain(curve, points, digits, lanes, c), mem_budget_bytes
    )


#: a complete add's temporaries, in bytes of points a point of its batch,
#: with the 753-bit products in mont's parts: at most 43 (MNT6753 G2 over
#: Fq3; 22 to 37 on BLS12-381 G1 / G2 and MNT6753 G1), as
#: csrc/diag/ab_plain_core.py measures them on the CPU and on the card
ADD_TEMP_POINTS = 48


def _add_in_parts(curve, p, q, mem_budget_bytes):
    """group.add on (L, W, T, B) operands in parts of the bucket axis, each
    of at most mem_budget_bytes / (ADD_TEMP_POINTS point bytes) points (at
    least one bucket a part): the adds' temporaries stay within the budget
    whatever the batch (the lane tree's first level adds half the state)."""
    L, W, T, B = p[0].shape
    fit = mem_budget_bytes // (ADD_TEMP_POINTS * 3 * curve.field.elem_len * 8)
    step = max(1, fit // (W * T))
    if step >= B:
        return group.add(curve, p, q)
    out = tuple(torch.empty((L, W, T, B), dtype=a.dtype, device=a.device) for a in p)
    for b in range(0, B, step):
        s = group.add(curve, tuple(a[..., b : b + step] for a in p), tuple(a[..., b : b + step] for a in q))
        for o, v in zip(out, s):
            o[..., b : b + step] = v
    return out


def _lane_tree_reduce(curve, buckets, mem_budget_bytes=2 << 30):
    """Tree-reduce the lane axis: (L, W, T, B) -> (L, W, B); a level's adds
    in parts under the memory budget (_add_in_parts)."""
    bx, by, bz = buckets
    t = bx.shape[2]
    while t > 1:
        half = t // 2
        s = _add_in_parts(
            curve,
            (bx[:, :, :half], by[:, :, :half], bz[:, :, :half]),
            (bx[:, :, half : 2 * half], by[:, :, half : 2 * half], bz[:, :, half : 2 * half]),
            mem_budget_bytes,
        )
        if t % 2:  # odd tail: carry the last lane through
            bx = torch.cat([s[0], bx[:, :, -1:]], dim=2)
            by = torch.cat([s[1], by[:, :, -1:]], dim=2)
            bz = torch.cat([s[2], bz[:, :, -1:]], dim=2)
            t = half + 1
        else:
            bx, by, bz = s
            t = half
    return (bx[:, :, 0], by[:, :, 0], bz[:, :, 0])  # (L, W, B)


def bucket_reduce(curve: CurveSpec, buckets):
    """Weighted bucket sum per window: sum_b (b+1) * S_b.

    Classic running-sum walk from the top bucket down
    (ref reduceBucketsToSinglePoint:1597-1706), vectorized across the W
    window axis; B sequential steps of W-wide adds.
    Input: (X,Y,Z) each (L, W, B).  Output: (X,Y,Z) each (L, W).
    """
    bx = buckets[0]
    _, W, B = bx.shape
    running = group.zero(curve, (W,), bx.device)
    acc = group.zero(curve, (W,), bx.device)
    for b in range(B - 1, -1, -1):
        running = group.add(curve, running, tuple(a[:, :, b] for a in buckets))
        acc = group.add(curve, acc, running)
    return acc


def bucket_reduce_grouped(curve: CurveSpec, buckets):
    """Weighted bucket sum for LARGE bucket counts: ~2*sqrt(B) serial steps
    instead of bucket_reduce's B.

    Split b = g*M + m (M ~ sqrt(B)):
      sum_b (b+1)*S_b = M * sum_g g*T_g + sum_g W_g
    with T_g = sum_m S_{g,m} (group totals) and W_g = sum_m (m+1)*S_{g,m}
    (within-group weighted sums).  The within-group pass runs all W*G lanes
    at once (M steps); the group pass is G-1 steps of W-wide adds; M*U is
    log2(M) doublings.  Input (L, W, B), B a power of two; output (L, W).
    """
    bx = buckets[0]
    L, W, B = bx.shape
    if B <= 64:
        return bucket_reduce(curve, buckets)
    M = 1 << (B.bit_length() // 2)
    G = B // M
    r4 = tuple(a.reshape(L, W, G, M) for a in buckets)
    running = group.zero(curve, (W, G), bx.device)
    Wg = group.zero(curve, (W, G), bx.device)
    for m in range(M - 1, -1, -1):
        running = group.add(curve, running, tuple(a[:, :, :, m] for a in r4))
        Wg = group.add(curve, Wg, running)
    Tg = running
    # U = sum_g g*T_g via a running sum from the top group down to g = 1
    r2 = group.zero(curve, (W,), bx.device)
    U = group.zero(curve, (W,), bx.device)
    for g in range(G - 1, 0, -1):
        r2 = group.add(curve, r2, tuple(a[:, :, g] for a in Tg))
        U = group.add(curve, U, r2)
    for _ in range(M.bit_length() - 1):
        U = group.double(curve, U)
    # sum_g W_g: the pairwise tree over the G axis
    total = _lane_tree_reduce(curve, tuple(a[:, :, :, None] for a in Wg))
    return group.add(curve, U, tuple(a[:, :, 0] for a in total))


def window_fold(curve: CurveSpec, window_sums, c: int):
    """Horner fold over windows, MSB -> LSB (ref accumulateAcrossChunks:1710).

    window_sums: (X,Y,Z) each (L, W); window w weights 2^(w*c).
    Returns a single projective point, batch shape ().
    """
    W = window_sums[0].shape[1]
    # first (top) window without the leading doublings
    acc = tuple(a[:, W - 1] for a in window_sums)
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = group.double(curve, acc)
        acc = group.add(curve, acc, tuple(a[:, w] for a in window_sums))
    return acc


def resolve_config(
    curve, N, max_bits, c, lanes, mem_budget_bytes, impl, device=None
) -> Tuple[str, int, Optional[int]]:
    """Resolve (impl, c, lanes) for an MSM of N points (host-side).

    The window-size rules are the reference's, unchanged: with the kernel
    engine the c <= 7 (Fq) / c <= 6 (Fq2) cap and the "fewest windows
    rounded up to 8" rule, with a sorted engine windows.sorted_engine_window_size, with the
    plain engine the Pippenger heuristic and the memory-budget lane count.
    (The kernel rules come from the TPU's sublanes and on-chip memory;
    choosing c for this card is a later change.)  An explicit c above the
    cap on the kernel engine routes to the sorted kernel engine, over Fq
    and Fq2 alike.  ``device`` decides "auto": kernel on CUDA, plain on the
    CPU (the reference's _default_impl picks its bucket kernel for G1 and
    G2), and plain on every device for cubic-extension and general-a curves
    (MNT6753 G1 and G2): the reference sends those to its jnp engine
    whatever the device (zprize_wasm_msm_tpu/ops/msm/pippenger.py:334-337),
    and no TPU kernel ever ran on them.  An explicit kernel engine on them
    raises.
    """
    kernel_curve = curve.ext in (1, 2) and curve.a == 0
    if impl == "auto":
        if device is None:
            raise ValueError("resolve_config: impl='auto' needs the tensors' device")
        on_card = torch.device(device).type == "cuda"
        impl = "kernel" if on_card and kernel_curve else "plain"
    if impl not in ENGINES:
        raise ValueError(f"impl must be 'auto' or one of {ENGINES}, got {impl!r}")
    if impl.startswith("kernel") and (
        not kernel_curve or (curve.ext == 2 and curve.nr % curve.q != curve.q - 1)
    ):
        raise NotImplementedError(
            f"{curve.name}: the CUDA kernels cover a=0 curves over Fq and over "
            "Fq2 = Fq[u]/(u^2 + 1); cubic extensions and general-a curves run the "
            "PyTorch-op engine, as the reference runs its jnp engine on them "
            "(impl='plain', which impl='auto' picks)"
        )
    c_cap = 7 if curve.ext == 1 else 6
    if impl == "kernel" and c is not None and c > c_cap:
        # explicit large window: the engine that has no bucket rows
        impl = "kernel-sorted"
    if c is None:
        if impl.endswith("sorted"):
            c = windows.sorted_engine_window_size(N, max_bits)
        elif impl == "kernel":

            def rows(cc):
                return -(-windows.num_windows(max_bits, cc) // 8) * 8

            c = min(range(3, c_cap + 1), key=lambda cc: (rows(cc), cc))
        else:
            c = windows.default_window_size(N, max_bits, mem_budget_bytes)
    if impl == "plain" and lanes is None:
        W = windows.num_windows(max_bits, c)
        lanes = _lane_count(N, c, W, mem_budget_bytes, curve.field.elem_len)
    return impl, c, lanes


@functools.lru_cache(maxsize=None)
def fit_lanes(W: int, N: int, resident: int) -> int:
    """Lanes per window T of the Fq2 sweep that fit W*T threads to whole
    waves of ``resident`` threads: the multiple of 32 (whole warps a window)
    that minimises ceil(W T / resident) * ceil(N / T), the rounds of waves
    times the steps of each thread's chain, the smaller T on a tie (fewer
    partials for the lane reduction).  T need not divide N or be a power of
    two: the sweep's lanes past N take zero digits, which add nothing.
    A pure function of its arguments (the CPU tests call it), cached: its
    search runs once a shape, not once an MSM."""
    if W < 1 or N < 1 or resident < 1:
        raise ValueError(f"fit_lanes: W={W}, N={N}, resident={resident} must be positive")
    best_cost, best_T = None, 32
    for T in range(32, -(-N // 32) * 32 + 1, 32):
        cost = -(-W * T // resident) * -(-N // T)
        if best_cost is None or cost < best_cost:
            best_cost, best_T = cost, T
    return best_T


def _kernel_lanes(curve, W: int, N: int, lanes: Optional[int], device) -> int:
    """Lanes per window of the bucket-sweep kernel for W windows of N
    digits: ``lanes`` if the caller names them.  Over Fq, KERNEL_LANES (a
    power of two, no more than the points) doubled while W times the lanes
    is still one wave of the sweep's resident threads on the card and every
    lane keeps a point.  Over Fq2, fit_lanes at the Fq2 sweep's residency:
    at path G2's shape doubling from 1 024 gave 2.13 waves, whose third
    round ran 13 % full.  A sweep thread's time is its own chain's latency
    (csrc/bucket.cu), so lanes beyond one wave only queue and lanes short of
    it leave the card idle; the lane reduction then sums the extra lanes."""
    if lanes is not None:
        return lanes
    from . import pl_bucket  # it imports this module

    resident = pl_bucket.resident_threads(curve, device)
    if curve.ext == 2:
        return fit_lanes(W, N, resident)
    T = min(KERNEL_LANES, 1 << max(0, N.bit_length() - 1))
    while W * 2 * T <= resident and 2 * T <= N:
        T *= 2
    return T


def window_sums(
    curve: CurveSpec,
    points: Tuple[torch.Tensor, torch.Tensor],
    digits: torch.Tensor,
    c: int,
    lanes: Optional[int] = None,
    impl: str = "plain",
    mem_budget_bytes: int = 2 << 30,
):
    """Bucket accumulation + per-window weighted reduction, (L, W) x3, of
    the plain engine and of the two sorted engines (the kernel engine's
    finish takes the dense buckets and has no such stage)."""
    from . import pl_bucket, pl_reduce, pl_sorted  # they import this module

    if impl == "kernel-sorted":
        buckets = pl_sorted.bucket_accumulate_sorted(curve, points, digits, c, impl="kernel")
        return pl_reduce.collapse(curve, buckets, impl="kernel")
    if impl == "plain-sorted":
        buckets = pl_sorted.bucket_accumulate_sorted(curve, points, digits, c, impl="plain")
        return bucket_reduce_grouped(curve, buckets)
    if impl != "plain":
        raise ValueError(f"window_sums: impl must be 'plain' or a sorted engine, got {impl!r}")
    W, N = digits.shape
    if lanes is None:
        lanes = _lane_count(N, c, W, mem_budget_bytes, curve.field.elem_len)
    buckets = pl_bucket.bucket_accumulate_plain(curve, points, digits, lanes=lanes, c=c,
                                                mem_budget_bytes=mem_budget_bytes)
    return bucket_reduce(curve, buckets)


def msm(
    curve: CurveSpec,
    points: Tuple[torch.Tensor, torch.Tensor],
    scalars: torch.Tensor,
    c: Optional[int] = None,
    max_bits: Optional[int] = None,
    lanes: Optional[int] = None,
    mem_budget_bytes: int = 2 << 30,
    impl: str = "auto",
):
    """Multi-scalar multiplication (the reference's g1m_multiexp_multiExp,
    build_multiexp_opt.js:1987-2110).

    points:  affine (X, Y), each (L, N) int64, Montgomery form.
    scalars: (Ls, N) int64 16-bit limbs, standard (non-Montgomery) domain.
    impl:    "kernel" (CUDA kernels, bucket rows; c <= 7, a larger c routes
             to "kernel-sorted"), "kernel-sorted" (CUDA kernels, sort by
             bucket + running sums; any c), "plain" / "plain-sorted" (the
             same two engines in PyTorch ops) or "auto" (kernel for CUDA
             tensors, plain for CPU tensors).  ``lanes`` is read by the
             "kernel" and "plain" engines only.
    Returns a projective point (X, Y, Z), each (L,), Montgomery form, on the
    device the inputs lie on.
    """
    X, Y = points
    N = X.shape[1]
    if max_bits is None:
        max_bits = scalars.shape[0] * 16
    impl, c, lanes = resolve_config(
        curve, N, max_bits, c, lanes, mem_budget_bytes, impl, device=X.device
    )
    digits = windows.signed_window_digits(scalars, c, max_bits)
    if impl == "kernel":
        from . import _launch, pl_bucket, pl_reduce

        _launch.use_kernel(impl, X)  # a CPU tensor raises here
        W = digits.shape[0]
        B = 1 << (c - 1)
        lanes = _kernel_lanes(curve, W, N, lanes, X.device)
        buckets = pl_bucket.bucket_accumulate(curve, (X, Y), digits, lanes=lanes, c=c, impl="kernel")
        if W <= pl_reduce.FINISH_LANES // B:
            return pl_reduce.finish(curve, buckets, c, impl="kernel")
        # W*B exceeds the one-block finish (c = 7 full-width scalars):
        # collapse the buckets per window on a wide grid, then fold
        return pl_reduce.finish_large(curve, buckets, c, impl="kernel")
    per_window = window_sums(curve, (X, Y), digits, c, lanes, impl, mem_budget_bytes)
    if impl == "kernel-sorted":
        from . import pl_reduce

        # the window fold on the card: finish at B = 1
        return pl_reduce.finish(curve, tuple(a[:, :, None] for a in per_window), c, impl="kernel")
    return window_fold(curve, per_window, c)
