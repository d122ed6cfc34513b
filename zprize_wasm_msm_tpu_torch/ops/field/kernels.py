"""Elementwise field kernels: Montgomery product, square and inversion.

``mont_mul`` / ``mont_square`` are the functions of
zprize_wasm_msm_tpu/ops/field/kernels.py ``mont_mul`` / ``mont_square``:
a * b * R^{-1} mod q (a^2 * R^{-1} mod q) per batch element, canonical
output.  On a CUDA tensor each is ONE launch of csrc/field_kernels.cu
``mont_mul_kernel`` / ``mont_square_kernel`` (one thread per element, any
batch size, no padding); on a CPU tensor the plain PyTorch ``mont.mont_mul``
/ ``mont.mont_square``.  ops.field.batch routes the batched field surface
(and with it the GLV endomorphism's beta * x) through them.

``inverse`` is a^{-1} per batch element (0 -> 0), the function of
zprize_wasm_msm_tpu/ops/field/mont.py ``inverse``.  On a CUDA tensor it is
ONE launch of csrc/field_kernels.cu ``field_inverse_kernel`` on the limbs
as they are (one thread per element runs a binary extended GCD of fixed
length, then one Montgomery product by the constant of
``inverse_consts``); on a CPU tensor it is the plain PyTorch Fermat
ladder, ``mont.inverse``.  mont.batch_inverse inverts the root of its
product tree through this function, so a to_affine on the card never
leaves the card.

Values are canonical on both routes, so kernel and plain agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import _build
from ..msm import _launch
from . import mont
from .spec import FieldSpec

#: times each kernel was launched (read by chip_smoke.py)
launches = {"mont_mul": 0, "mont_square": 0, "inverse": 0}


def _consts_ptr(spec: FieldSpec) -> ctypes.c_void_p:
    return _build.field_consts(spec).ctypes.data_as(ctypes.c_void_p)


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: mont.mont_mul."""
    return mont.mont_mul(spec, a, b)


def mont_square_plain(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: mont.mont_square."""
    return mont.mont_square(spec, a)


def _mul_words(spec: FieldSpec, aw: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """Launch mont_mul_kernel on packed words: aw (NW, n), bw (NW, n) or
    (NW, 1) (one operand for the whole batch) -> (NW, n) int32."""
    lib = _build.load("field_kernels")
    fn = lib.zp_mont_mul
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    )
    n = aw.shape[1]
    out = torch.empty_like(aw)
    err = fn(
        spec.n_words, _consts_ptr(spec), _launch.ptr(aw), _launch.ptr(bw), _launch.ptr(out),
        n, int(bw.shape[1] == 1 and n != 1), _launch.stream_ptr(),
    )
    _build.check_launch(err, "mont_mul")
    launches["mont_mul"] += 1
    return out


def _square_words(spec: FieldSpec, aw: torch.Tensor) -> torch.Tensor:
    """Launch mont_square_kernel on packed words, (NW, n) -> (NW, n) int32."""
    lib = _build.load("field_kernels")
    fn = lib.zp_mont_square
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    out = torch.empty_like(aw)
    err = fn(
        spec.n_words, _consts_ptr(spec), _launch.ptr(aw), _launch.ptr(out), aw.shape[1],
        _launch.stream_ptr(),
    )
    _build.check_launch(err, "mont_square")
    launches["mont_square"] += 1
    return out


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Elementwise Montgomery product, (L, *batch) int64 x2 -> same.

    ``b`` has ``a``'s shape, or is one element with every batch axis 1 (a
    constant operand such as beta or R^2): the kernel then reads that one
    element for the whole batch and no expanded copy is made."""
    if not _launch.use_kernel(impl, a):
        return mont_mul_plain(spec, a, b)
    L = spec.n_limbs
    batch = tuple(a.shape[1:])
    _launch.check_limbs("a", a, (L,) + batch, a.device)
    one_element = (L,) + (1,) * len(batch)
    _launch.check_limbs("b", b, one_element if tuple(b.shape) == one_element else a.shape, a.device)
    out = _mul_words(spec, _launch.pack_point((a,))[0], _launch.pack_point((b,))[0])
    return _launch.unpack_point(out[None], batch)[0]


def mont_square(spec: FieldSpec, a: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Elementwise Montgomery square, (L, *batch) int64 -> same."""
    if not _launch.use_kernel(impl, a):
        return mont_square_plain(spec, a)
    batch = tuple(a.shape[1:])
    _launch.check_limbs("a", a, (spec.n_limbs,) + batch, a.device)
    out = _square_words(spec, _launch.pack_point((a,))[0])
    return _launch.unpack_point(out[None], batch)[0]


def inverse_plain(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: mont.inverse (Fermat ladder of mont_mul)."""
    return mont.inverse(spec, a)


#: inner iterations of one outer step of the GCD (csrc/field_kernels.cu)
GCD_INNER = 31


@functools.lru_cache(maxsize=None)
def inverse_consts(spec: FieldSpec):
    """(steps, fix) of field_inverse_kernel: steps = ceil((2 bits(q) - 1) /
    31) outer steps of the binary GCD, after which v = x^{-1} 2^{-steps};
    fix = 2^steps R^3 mod q as MAX_WORDS words, so that one Montgomery
    product v * fix * R^{-1} is x^{-1} R^2, the inverse of x = aR in
    Montgomery form."""
    steps = -(-(2 * spec.q.bit_length() - 1) // GCD_INNER)
    R = 1 << (32 * spec.n_words)
    fix = pow(2, steps, spec.q) * pow(R, 3, spec.q) % spec.q
    words = np.array([(fix >> (32 * j)) & 0xFFFFFFFF for j in range(_build.MAX_WORDS)],
                     dtype=np.uint32)
    words.setflags(write=False)
    return steps, words


def inverse(spec: FieldSpec, a: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Elementwise a^{-1} in Montgomery form, (L, *batch) int64 -> same;
    0 maps to 0."""
    if not _launch.use_kernel(impl, a):
        return inverse_plain(spec, a)
    L = spec.n_limbs
    _launch.check_limbs("a", a, (L,) + tuple(a.shape[1:]), a.device)
    lib = _build.load("field_kernels")
    fn = lib.zp_field_inverse
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 2
        + [ctypes.c_int, ctypes.c_void_p]
    )
    steps, fix = inverse_consts(spec)
    flat = a.reshape(L, -1).contiguous()  # the kernel reads and writes limbs
    out = torch.empty_like(flat)
    err = fn(
        spec.n_words, _consts_ptr(spec), fix.ctypes.data_as(ctypes.c_void_p), steps,
        _launch.ptr(flat), _launch.ptr(out), flat.shape[1], _launch.stream_ptr(),
    )
    _build.check_launch(err, "field inverse")
    launches["inverse"] += 1
    return out.reshape(a.shape)
