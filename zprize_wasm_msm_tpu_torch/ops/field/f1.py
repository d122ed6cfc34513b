"""Standard-domain (non-Montgomery) field ops.

Counterpart of zprize_wasm_msm_tpu/ops/field/f1.py, the reference's f1
wrapper (wasmcurves/src/build_f1.js — ``fr``-prefixed ops that round-trip
through the Montgomery core, e.g. mul:43-55 converts both operands in,
multiplies, converts out).

Add/sub/neg are domain-agnostic (delegated directly); mul/square/inverse
round-trip exactly like the reference.  Batches are (L, *batch) int64
16-bit limbs holding canonical standard-domain values.
"""

from __future__ import annotations

import torch

from . import mont
from .spec import FieldSpec

add = mont.add
sub = mont.sub
neg = mont.neg
is_zero = mont.is_zero
eq = mont.eq


def mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod q in standard domain (ref build_f1.js mul:43)."""
    am = mont.to_mont(spec, a)
    bm = mont.to_mont(spec, b)
    return mont.from_mont(spec, mont.mont_mul(spec, am, bm))


def square(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont.from_mont(spec, mont.mont_square(spec, mont.to_mont(spec, a)))


def inverse(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont.from_mont(spec, mont.inverse(spec, mont.to_mont(spec, a)))
