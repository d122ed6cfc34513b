"""QAP (Groth16) witness evaluation over Fr.

Port of zprize_wasm_msm_tpu/ops/poly/qap.py, the counterpart of
wasmcurves/src/build_qap.js — buildABC:8 (sparse coefficient records
(m, c, s) scattered into per-constraint A/B sums), joinABC:217
(elementwise A*B - C) and batchAdd:278.

The record stream is a flat COO quadruple (matrix, constraint, signal,
coef); the evaluation is one product over the records, a raw-limb
scatter-sum and one modular reduction per output (pol.scatter_sum).
Products over a whole batch go through ops.field.kernels.mont_mul (the
kernel on the card).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..field import kernels, mont
from ..field.spec import FieldSpec
from .pol import scatter_sum


def build_abc(
    spec: FieldSpec,
    matrix: torch.Tensor,
    constraint: torch.Tensor,
    coefs: torch.Tensor,
    witness_vals: torch.Tensor,
    n_constraints: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate the A and B constraint polynomials at the witness.

    matrix:       (nnz,) integer — 0 for A records, 1 for B (the reference
                  skips m >= 2 records; filter host-side).
    constraint:   (nnz,) integer — destination constraint index.
    coefs:        (L, nnz) Montgomery coefficients.
    witness_vals: (L, nnz) Montgomery witness values, pre-gathered by the
                  record's signal index (the reference's i32_load + offset
                  walk, build_qap.js:~120).
    Returns (A, B), each (L, n_constraints) Montgomery.
    """
    prod = kernels.mont_mul(spec, coefs, witness_vals)  # (L, nnz)
    # A records land in slots [0, n), B records in [n, 2n): one scatter-sum
    dest = constraint.to(device=prod.device, dtype=torch.int64)
    dest = dest + (matrix.to(device=prod.device) != 0).to(torch.int64) * n_constraints
    acc = scatter_sum(spec, prod, dest, 2 * n_constraints)
    return acc[:, :n_constraints], acc[:, n_constraints:]


def mul_ab(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A * B elementwise (second loop of buildABC, build_qap.js:~200)."""
    return kernels.mont_mul(spec, a, b)


def join_abc(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """P = A*B - C elementwise (ref joinABC:217)."""
    return mont.sub(spec, kernels.mont_mul(spec, a, b), c)


def batch_add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """r = a + b elementwise (ref batchAdd:278)."""
    return mont.add(spec, a, b)
