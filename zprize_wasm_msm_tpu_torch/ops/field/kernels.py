"""Elementwise field kernels: so far the field inversion.

``inverse`` is a^(q-2) per batch element (Fermat), the function of
zprize_wasm_msm_tpu/ops/field/mont.py ``inverse``.  On a CUDA tensor it is
ONE launch of csrc/field_kernels.cu ``field_pow_kernel`` (one thread per
element runs the whole square-and-multiply ladder); on a CPU tensor it is
the plain PyTorch ladder, ``mont.inverse``.  mont.batch_inverse inverts the
root of its product tree through this function, so a to_affine on the card
never leaves the card.

The elementwise Montgomery product and square kernels of the JAX package's
ops/field/kernels.py are not ported yet; they arrive with the GLV path.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import _build
from ...utils.bigint import int_to_limbs
from ..msm import _launch
from . import mont
from .spec import FieldSpec

#: times each kernel was launched (read by chip_smoke.py)
launches = {"inverse": 0}


def inverse_plain(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: mont.inverse (Fermat ladder of mont_mul)."""
    return mont.inverse(spec, a)


def inverse(spec: FieldSpec, a: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Elementwise a^{-1} in Montgomery form, (L, *batch) int64 -> same;
    0 maps to 0.  Canonical values, so kernel and plain agree bit for bit."""
    if not _launch.use_kernel(impl, a):
        return inverse_plain(spec, a)
    L = spec.n_limbs
    _launch.check_limbs("a", a, (L,) + tuple(a.shape[1:]), a.device)
    lib = _build.load("field_kernels")
    fn = lib.zp_field_pow
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 2
        + [ctypes.c_int, ctypes.c_void_p]
    )
    e = spec.q - 2
    exp_words = np.ascontiguousarray(int_to_limbs(e, _build.MAX_WORDS, 32), dtype=np.uint32)
    (aw,) = _launch.pack_point((a,))
    n = aw.shape[1]
    out = torch.empty_like(aw)
    err = fn(
        spec.n_words, _build.field_consts(spec).ctypes.data_as(ctypes.c_void_p),
        exp_words.ctypes.data_as(ctypes.c_void_p), e.bit_length(),
        _launch.ptr(aw), _launch.ptr(out), n, _launch.stream_ptr(),
    )
    _build.check_launch(err, "field inverse")
    launches["inverse"] += 1
    return _launch.unpack_point(out[None], tuple(a.shape[1:]))[0]
