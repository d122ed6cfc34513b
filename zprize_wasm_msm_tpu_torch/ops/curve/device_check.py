"""One-operation launches of the CUDA device functions (csrc/check.cu).

csrc/field.cuh and csrc/group.cuh hold the counterparts of the JAX
package's in-kernel cores (ops/field/kcore.py, ops/field/ktower.py KFq,
ops/curve/kgroup.py).  They are inlined into the MSM kernels and have no
launch of their own; these two functions run each of them once per batch
element so that they can be held bit for bit against ops.field.mont and
ops.curve.group on the card.  CUDA tensors only: there is nothing to run
on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ..msm import _launch
from .spec import CurveSpec

#: fe_mul / fe_add / fe_sub / fe_neg, and fe_mul_cc (the carry-chain product)
FIELD_OPS = {"mul": 0, "add": 1, "sub": 2, "neg": 3, "mul_cc": 4}
#: pt_add_mixed / pt_add / pt_double, and pt_add on the carry-chain product
GROUP_OPS = {"add_mixed": 0, "add": 1, "double": 2, "add_cc": 3}


def field_op(curve: CurveSpec, op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fe_mul / fe_add / fe_sub / fe_neg (of a) / fe_mul_cc on (L, n) int64
    batches."""
    _launch.use_kernel("kernel", a)
    lib = _build.load("check")
    fn = lib.zp_field_op
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_void_p]
    )
    L, n = a.shape
    _launch.check_limbs("a", a, (curve.fq.n_limbs, n), a.device)
    _launch.check_limbs("b", b, (L, n), a.device)
    aw, bw = _launch.pack_point((a, b))
    out = torch.empty_like(aw)
    err = fn(
        curve.fq.n_words, _build.curve_consts(curve).ctypes.data_as(ctypes.c_void_p),
        FIELD_OPS[op], _launch.ptr(aw), _launch.ptr(bw), _launch.ptr(out), n,
        _launch.stream_ptr(),
    )
    _build.check_launch(err, f"field_op {op}")
    return _launch.unpack_point(out[None], (n,))[0]


def group_op(curve: CurveSpec, op: str, p, q):
    """pt_add_mixed (q's X, Y as the affine operand) / pt_add / pt_double
    (of p) / pt_add<NW, true> on projective batches, each coordinate (L, n)
    int64."""
    _launch.use_kernel("kernel", p[0])
    lib = _build.load("check")
    fn = lib.zp_group_op
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_void_p]
    )
    L, n = p[0].shape
    for name, t in zip(("px", "py", "pz", "qx", "qy", "qz"), tuple(p) + tuple(q)):
        _launch.check_limbs(name, t, (curve.fq.n_limbs, n), p[0].device)
    pw, qw = _launch.pack_point(p), _launch.pack_point(q)
    out = torch.empty_like(pw)
    err = fn(
        curve.fq.n_words, _build.curve_consts(curve).ctypes.data_as(ctypes.c_void_p),
        GROUP_OPS[op], _launch.ptr(pw), _launch.ptr(qw), _launch.ptr(out), n,
        _launch.stream_ptr(),
    )
    _build.check_launch(err, f"group_op {op}")
    return _launch.unpack_point(out, (n,))
