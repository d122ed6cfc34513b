"""Scalar windowing: c-bit chunk extraction and signed-digit recoding.

Counterpart of the reference's schedule computation
(wasmcurves/src/build_multiexp_opt.js — getChunk:1251, window table
getOptimalBucketWidth:33-49, computeSchedule:299).  Instead of packing
64-bit (point, sign, bucket) schedule words, the pipeline materializes a
dense (n_windows, N) digit matrix.

Digits are *signed*, in [-2^(c-1), 2^(c-1)], which halves the bucket count
(the reference reserved a sign bit in its schedule encoding for exactly
this, build_multiexp_opt.js:285-293, but never set it; the final MSM result
is identical either way).
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32
I64 = torch.int64


def num_windows(max_bits: int, c: int) -> int:
    """Window count incl. the signed-carry overflow window."""
    return (max_bits + c - 1) // c + 1


def default_window_size(n: int, max_bits: int = 256, mem_budget_bytes: int = 2 << 30) -> int:
    """Heuristic window size by point count (role of the reference's
    clz-indexed table, build_multiexp_opt.js:39-44): per-lane private
    buckets cost W * T * 2^(c-1) * 3 coords, so c is capped.
    """
    if n <= 0:
        return 1
    log_n = max(1, n.bit_length() - 1)
    # classic Pippenger optimum ~ log2(n) - log2(log2(n))
    c = max(2, log_n - max(1, int(np.log2(max(log_n, 2)))))
    return int(min(c, 13))


def sorted_engine_window_size(n: int, max_bits: int = 132) -> int:
    """Window size of the sorted-runs engine (pl_sorted) when the caller
    names none: the reference's rule, log2(n) - 4 capped at 10, unchanged
    so that resolve_config answers as the reference does."""
    if n <= 0:
        return 1
    c = max(2, n.bit_length() - 1 - 4)
    return int(min(c, 10))


def raw_window_digits(scalars: torch.Tensor, c: int, max_bits: int) -> torch.Tensor:
    """Extract unsigned c-bit windows from 16-bit-limb scalars.

    scalars: (Ls, N) int64 little-endian 16-bit limbs.
    Returns (n_chunks, N) int64 raw digits, chunk w covering bits
    [w*c, (w+1)*c) — the vectorized analog of getChunk
    (build_multiexp_opt.js:1251-1322, an unaligned load + shift + mask).
    """
    Ls = scalars.shape[0]
    n_chunks = (max_bits + c - 1) // c
    mask = (1 << c) - 1
    out = torch.zeros((n_chunks,) + tuple(scalars.shape[1:]), dtype=I64, device=scalars.device)
    for w in range(n_chunks):
        bit0 = w * c
        limb0, shift = divmod(bit0, 16)
        if limb0 >= Ls:
            continue
        v = scalars[limb0] >> shift
        got = 16 - shift
        k = 1
        while got < c and limb0 + k < Ls:
            v = v | (scalars[limb0 + k] << got)
            got += 16
            k += 1
        out[w] = v & mask
    return out


def signed_window_digits(scalars: torch.Tensor, c: int, max_bits: int) -> torch.Tensor:
    """Signed-digit recode: digits in [-2^(c-1), 2^(c-1)], plus a final
    carry window; returns (num_windows(max_bits,c), N) int32.

    sum_w digit_w * 2^(w*c) == scalar  (exactly).
    """
    raw = raw_window_digits(scalars, c, max_bits)
    n_chunks = raw.shape[0]
    half = 1 << (c - 1)
    full = 1 << c
    digits = torch.empty((n_chunks + 1,) + tuple(raw.shape[1:]), dtype=I32, device=raw.device)
    carry = torch.zeros(raw.shape[1:], dtype=I64, device=raw.device)
    for w in range(n_chunks):
        d = raw[w] + carry
        hi = d > half  # strictly greater keeps digit == +half representable
        digits[w] = torch.where(hi, d - full, d)
        carry = hi.to(I64)
    digits[n_chunks] = carry
    return digits
