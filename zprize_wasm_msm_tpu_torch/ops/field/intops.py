"""Vectorized multi-limb unsigned integer arithmetic (non-modular).

Counterpart of the reference's generic bigint layer
(wasmcurves/src/build_int.js — add:186 returns carry, sub:232 returns
borrow, mul:281 product-scanning, div:706 long division, and the int512
instance wired for GLV at build_curve_jacobian_a0.js:1422).

Same limb convention as ops.field.mont: (L, *batch) int64 tensors of
little-endian 16-bit limbs, every limb in [0, 2^16).  The functions follow
the JAX package's ops/field/intops.py step for step (the same
``p & MASK`` / ``p >> 16`` split of the half-products, the same {0, 1}
borrow), so every result equals the reference's limb for limb.  Division is
Barrett reduction by a host-known constant divisor: the only division the
library needs at run time (GLV decomposition divides by the lattice
determinant r; build_glv.js:82-110).

Plain PyTorch ops on whatever device the tensors lie on; the GLV split runs
them once per MSM on (Ls, N) scalars.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ...utils.bigint import int_to_limbs
from .spec import LIMB_BITS, LIMB_MASK

I64 = torch.int64


@functools.lru_cache(maxsize=256)
def _const_limbs(value: int, n_limbs: int, device: torch.device) -> torch.Tensor:
    """(n_limbs,) int64 device limbs of a host constant (cached: a fresh
    host-to-device copy per call would stall the stream)."""
    return torch.as_tensor(int_to_limbs(value, n_limbs).astype(np.int64), device=device)


def const_limbs(value: int, like: torch.Tensor, n_limbs: Optional[int] = None) -> torch.Tensor:
    """A host constant as (n, 1, ..., 1) limbs broadcastable against
    ``like``; n defaults to the fewest limbs that hold the value."""
    if n_limbs is None:
        n_limbs = max(1, (int(value).bit_length() + LIMB_BITS - 1) // LIMB_BITS)
    limbs = _const_limbs(int(value), n_limbs, like.device)
    return limbs.reshape((n_limbs,) + (1,) * (like.ndim - 1))


def int_add(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Limbwise add with carry; returns (sum mod 2^(16L), carry_out)."""
    out = []
    carry = None
    for i in range(a.shape[0]):
        s = a[i] + b[i]
        if carry is not None:
            s = s + carry
        out.append(s & LIMB_MASK)
        carry = s >> LIMB_BITS
    return torch.stack(out), carry


def int_sub(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Limbwise subtract; returns (a-b mod 2^(16L), borrow_out in {0,1})."""
    out = []
    borrow = None
    for i in range(a.shape[0]):
        x = a[i] + (1 << LIMB_BITS) - b[i]
        if borrow is not None:
            x = x - borrow
        out.append(x & LIMB_MASK)
        borrow = 1 - (x >> LIMB_BITS)
    return torch.stack(out), borrow


def int_mul(a: torch.Tensor, b: torch.Tensor, out_limbs: Optional[int] = None) -> torch.Tensor:
    """Full product, (La+Lb) limbs (ref build_int.js mul:281).

    Redundant accumulation of 16x16 half-products, then one carry
    resolution pass.  out_limbs may truncate (mod 2^(16*out_limbs)).
    """
    La, Lb = a.shape[0], b.shape[0]
    total = La + Lb if out_limbs is None else min(La + Lb, out_limbs)
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    acc = torch.zeros((total + 1,) + tuple(batch), dtype=I64, device=a.device)
    for i in range(min(La, total)):
        hi_len = min(Lb, total - i)
        p = a[i][None] * b[:hi_len]
        acc[i : i + hi_len].add_(p & LIMB_MASK)
        acc[i + 1 : i + 1 + hi_len].add_(p >> LIMB_BITS)
    out = []
    carry = None
    for k in range(total):
        s = acc[k] if carry is None else acc[k] + carry
        out.append(s & LIMB_MASK)
        carry = s >> LIMB_BITS
    res = torch.stack(out)
    if out_limbs is not None and out_limbs > total:
        res = pad_limbs(res, out_limbs)
    return res


def int_mul_const(a: torch.Tensor, c: int, out_limbs: Optional[int] = None) -> torch.Tensor:
    """Product with a host constant."""
    return int_mul(a, const_limbs(c, a), out_limbs)


def int_shr_limbs(a: torch.Tensor, k: int, out_limbs: int) -> torch.Tensor:
    """Drop the k low limbs (i.e. >> 16k), keep out_limbs limbs."""
    return pad_limbs(a[k : k + out_limbs], out_limbs)


def int_gte(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b (ref build_int.js gte)."""
    _, borrow = int_sub(a, b)
    return borrow == 0


def int_is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=0)


def pad_limbs(a: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """Zero-extend (or cut) to out_limbs limbs."""
    L = a.shape[0]
    if L >= out_limbs:
        return a[:out_limbs]
    z = torch.zeros((out_limbs - L,) + tuple(a.shape[1:]), dtype=I64, device=a.device)
    return torch.cat([a, z], dim=0)


def barrett_div(x: torch.Tensor, d: int) -> torch.Tensor:
    """floor(x / d) for a host-known divisor d.

    Replaces the reference's data-dependent long division
    (build_int.js:706-920) with a fixed-structure Barrett estimate plus two
    branch-free corrections (q_est in [q-2, q]).
    Returns the quotient with the same limb count as x.
    """
    Lx = x.shape[0]
    B = LIMB_BITS * Lx
    mu = (1 << B) // d  # host constant
    xmu = int_mul_const(x, mu)  # Lx + Lmu limbs
    q_est = int_shr_limbs(xmu, Lx, Lx)
    # r = x - q_est * d  (fits in Lx limbs after correction)
    qd = int_mul_const(q_est, d, Lx)
    r, _ = int_sub(x, qd)
    dl = const_limbs(d % (1 << B), x, Lx)
    one = const_limbs(1, x, Lx)
    for _ in range(2):  # at most 2 corrections
        ge = int_gte(r, dl)
        r2, _ = int_sub(r, dl)
        q2, _ = int_add(q_est, one)
        r = torch.where(ge[None], r2, r)
        q_est = torch.where(ge[None], q2, q_est)
    return q_est
