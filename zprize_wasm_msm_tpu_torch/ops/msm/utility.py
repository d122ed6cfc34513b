"""Value helpers of the reference's runtime utility module.

Counterpart of zprize_wasm_msm_tpu/ops/msm/utility.py (wasmcurves/src/
build_utility.js).  Its pointer-machine load/store/copy helpers have no
counterpart here (tensors and PyTorch's allocator replace the bump
allocator); the value helpers the MSM driver uses are tensor ops:
  maxArrayValue:  max_array_value
  getMsb:         get_msb
  countNonZero:   count_non_zero
"""

from __future__ import annotations

import torch


def max_array_value(a: torch.Tensor) -> torch.Tensor:
    """Max over an integer tensor (ref build_utility.js maxArrayValue)."""
    return a.max()


def get_msb(a: torch.Tensor) -> torch.Tensor:
    """Index of the most significant set bit of each value read as a 32-bit
    unsigned word, elementwise; 0 for input 0 (ref getMsb:297-308).  int32."""
    v = a.to(torch.int64) & 0xFFFFFFFF
    # frexp is exact below 2^53: v = m 2^e with m in [0.5, 1)
    bits = torch.frexp(v.to(torch.float64))[1].to(torch.int32) - 1
    return torch.where(v == 0, 0, bits).to(torch.int32)


def count_non_zero(digits: torch.Tensor) -> torch.Tensor:
    """Number of non-zero entries (ref countNonZero:312-365), int32 — the
    reference's scheduler uses it; here a diagnostic for digit matrices."""
    return (digits != 0).sum().to(torch.int32)
