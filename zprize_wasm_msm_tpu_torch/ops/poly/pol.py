"""Sparse polynomial linear combinations over Fr.

Port of zprize_wasm_msm_tpu/ops/poly/pol.py, the counterpart of the
reference's pol module (wasmcurves/src/build_pol.js — zero1/zero2,
constructLC:62): the pointer walk over per-signal coefficient lists becomes
a flat COO triple (positions, signals, coefficients), one product over the
batch, a raw-limb scatter-sum and one modular reduction per output slot.
"""

from __future__ import annotations

import torch

from ..field import kernels, mont
from ..field.spec import FieldSpec

#: extra limbs above L that hold the carries of a raw limb sum
_SUM_LIMBS = 2


def scatter_sum(spec: FieldSpec, values: torch.Tensor, index: torch.Tensor, n_out: int) -> torch.Tensor:
    """out[:, i] = sum of values[:, j] over index[j] == i, mod q.

    values: (L, nnz) canonical Montgomery limbs; index: (nnz,) integer
    positions in [0, n_out).  The 16-bit limbs are summed raw in int64,
    carried into L + 2 canonical limbs (mont._resolve takes limbs below
    2^46: up to 2^30 terms per output slot), and reduced once
    (mont.reduce_redundant).  The JAX package sums raw u32 limbs, exact up
    to 2^10 terms per output (zprize_wasm_msm_tpu/ops/poly/pol.py:41-43);
    the carry pass makes this sum exact above that count too.
    """
    L = spec.n_limbs
    acc = torch.zeros((L + _SUM_LIMBS, n_out), dtype=torch.int64, device=values.device)
    acc[:L].index_add_(1, index.to(device=values.device, dtype=torch.int64), values)
    acc, _ = mont._resolve(acc)  # acc is a temporary; the top limbs absorb the carry
    return mont.reduce_redundant(spec, acc)


def construct_lc(
    spec: FieldSpec,
    coefs: torch.Tensor,
    positions: torch.Tensor,
    signals: torch.Tensor,
    n_out: int,
) -> torch.Tensor:
    """res[positions[j]] += coefs[:, j] * signals[:, j] over Fr.

    coefs:     (L, nnz) Montgomery coefficients.
    positions: (nnz,) integer destination indices in [0, n_out).
    signals:   (L, nnz) Montgomery signal values, pre-gathered per entry
               (the reference walks (signal, [(pos, coef)...]) lists;
               flatten to COO with the signal value repeated per entry).
    Returns (L, n_out) Montgomery.  The products go through
    ops.field.kernels.mont_mul (the kernel on the card).
    """
    prod = kernels.mont_mul(spec, coefs, signals)  # (L, nnz)
    return scatter_sum(spec, prod, positions, n_out)
