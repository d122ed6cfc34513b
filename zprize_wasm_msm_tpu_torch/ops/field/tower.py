"""Field tower backends: a uniform op surface over the coordinate field.

Counterpart of the reference's field-prefix parameterization: the curve
generator takes a field *prefix* ("f1m" or "f2m") and emits calls to that
field's exported ops (wasmcurves/src/build_curve_jacobian_a0.js:29
`prefixField` arg).  A frozen backend object carries the specialization so
ONE generic group/MSM layer serves every coordinate field.

Only the base field ``Fq`` is here so far; the quadratic and cubic
extensions (G2, MNT6753) arrive with the G2 slice of the port.

Element layout (Montgomery form): (L, *batch) int64 — as ops.field.mont.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np
import torch

from . import mont
from .spec import FieldSpec

IntLike = Union[int, Tuple[int, ...]]


@dataclass(frozen=True)
class Fq:
    """Base prime field backend (delegates to ops.field.mont)."""

    spec: FieldSpec

    #: leading element axes before the batch (limb axis only)
    elem_ndim = 1

    @property
    def elem_len(self) -> int:
        return self.spec.n_limbs

    def batch_shape(self, a):
        return a.shape[1:]

    def zeros(self, batch_shape=(), device=None):
        return mont.zeros(self.spec, batch_shape, device)

    def one(self, batch_shape=(), device=None):
        return mont.one_mont(self.spec, batch_shape, device)

    def const(self, value: IntLike, batch_shape=(), device=None):
        """Host int (standard domain) -> Montgomery element batch."""
        if not isinstance(value, int):
            raise TypeError(f"Fq.const takes an int, got {type(value).__name__}")
        return mont.full_const(
            self.spec, self.spec.to_mont_int(value), batch_shape, device
        )

    def add(self, a, b):
        return mont.add(self.spec, a, b)

    def sub(self, a, b):
        return mont.sub(self.spec, a, b)

    def neg(self, a):
        return mont.neg(self.spec, a)

    def mul(self, a, b):
        return mont.mont_mul(self.spec, a, b)

    def mul_many(self, pairs):
        """One stacked multiply for independent products: eager PyTorch pays
        per call, so k products in one call cost about what one does."""
        k = len(pairs)
        if k == 1:
            return [self.mul(*pairs[0])]
        shape = torch.broadcast_shapes(*(t.shape for p in pairs for t in p))
        a = torch.stack([p[0].expand(shape) for p in pairs], dim=1)
        b = torch.stack([p[1].expand(shape) for p in pairs], dim=1)
        r = mont.mont_mul(self.spec, a, b)
        return [r[:, i] for i in range(k)]

    def square(self, a):
        return mont.mont_square(self.spec, a)

    def inverse(self, a):
        return mont.inverse(self.spec, a)

    def batch_inverse(self, a):
        return mont.batch_inverse(self.spec, a)

    def is_zero(self, a):
        return mont.is_zero(self.spec, a)

    def eq(self, a, b):
        return mont.eq(self.spec, a, b)

    def select(self, mask, a, b):
        return torch.where(mask[None], a, b)

    # host-side marshalling ------------------------------------------------
    def to_host(self, a) -> list:
        from ...utils.limbs import limbs_to_ints

        vals = limbs_to_ints(a.detach().cpu().numpy().astype(np.uint32))
        return [self.spec.from_mont_int(v) for v in vals]
