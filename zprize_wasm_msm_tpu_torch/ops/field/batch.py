"""Batched field ops: the f1m_batch* surface.

Parity with the reference's batch wrappers (wasmcurves/src/build_f1m.js
:1351-1357 wires batchInverse / batchToMontgomery / batchFromMontgomery /
batchNeg / batchAdd / batchSub / batchMul over strided arrays via
build_batchconvertion.js / build_batchop.js).

The multiplicative ops go through ops.field.kernels: the CUDA kernels for
tensors on the card, the plain ``mont`` functions for CPU tensors
(``impl="auto"``, see ops.msm._launch.use_kernel).  Results are
bit-identical either way: both produce the canonical value.  The additive
ops are single passes of plain tensor code on either device.
"""

from __future__ import annotations

import torch

from . import kernels, mont
from .spec import FieldSpec


def batch_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Elementwise Montgomery product over an (L, N) batch."""
    return kernels.mont_mul(spec, a, b, impl=impl)


def batch_square(spec: FieldSpec, a: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    return kernels.mont_square(spec, a, impl=impl)


def batch_add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return mont.add(spec, a, b)


def batch_sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return mont.sub(spec, a, b)


def batch_neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont.neg(spec, a)


def batch_inverse(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont.batch_inverse(spec, a)


def batch_to_mont(spec: FieldSpec, a: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """batchToMontgomery: a -> a*R, one batch_mul by R^2."""
    r2 = mont._col(mont._limb_const(spec, "r2_limbs", a.device), a.ndim - 1)
    return batch_mul(spec, a, r2, impl=impl)


def batch_from_mont(spec: FieldSpec, a: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """batchFromMontgomery: a -> a*R^{-1}, one batch_mul by 1."""
    one = torch.zeros((spec.n_limbs,) + (1,) * (a.ndim - 1), dtype=mont.I64, device=a.device)
    one[0] = 1
    return batch_mul(spec, a, one, impl=impl)
