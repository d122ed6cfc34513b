"""One-operation launches of the CUDA device functions (csrc/check.cu).

csrc/field.cuh, csrc/field2.cuh, csrc/group.cuh and csrc/group2.cuh hold the
counterparts of the JAX package's in-kernel cores (ops/field/kcore.py,
ops/field/ktower.py KFq and KFq2, ops/curve/kgroup.py), over Fq and Fq2.
They are inlined into the MSM kernels and have no launch of their own; these two functions run each of them once per batch
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

#: fe_mul / fe_add / fe_sub / fe_neg, fe_mul_cc (the carry-chain product),
#: the product by 3b (over Fq fe_mul_small, by additions, as par.cuh's group
#: ops take it; over Fq2 a product by the constant), fe_mul_coop (one
#: product shared by several lanes, coop.cuh; over Fq2 three of them), the
#: square (over Fq2 the complex squaring of field2.cuh) and, over Fq2 where
#: 3b = k (1 + u), 3b a by additions (par.cuh fe_mul_b3k)
FIELD_OPS = {
    "mul": 0, "add": 1, "sub": 2, "neg": 3, "mul_cc": 4, "mul_b3": 5, "mul_coop": 6, "square": 7,
    "mul_b3k": 8,
}
#: pt_add_mixed / pt_add / pt_double, pt_add on the carry-chain product, and
#: the level-parallel doubling and addition of par.cuh with a product to a
#: lane ("_par", Fq only) and with cooperative products ("_coop").  Over Fq2
#: add_mixed and add_cc are the forms K1 and K4 run (group2.cuh, points in
#: shared memory); add and double are built over Fq only.  Over Fq2 only,
#: the window fold's links (fold2.cuh) in its two forms: "_fold2_warps" a
#: block of three warps, each Fq product on coop_lanes lanes, "_fold2_lane"
#: one warp, a lane a product.
GROUP_OPS = {
    "add_mixed": 0, "add": 1, "double": 2, "add_cc": 3,
    "double_par": 4, "add_par": 5, "double_coop": 6, "add_coop": 7,
    "double_fold2_warps": 8, "add_fold2_warps": 9, "double_fold2_lane": 10, "add_fold2_lane": 11,
}
#: the dependent chains zp_group_chain times: the level-parallel ops above,
#: one-lane complete additions (group.cuh / group2.cuh pt_add_acc, as the
#: segmented scan runs it), and over Fq2 the fold's links in both forms
CHAIN_OPS = {
    "double_par": 0, "add_par": 1, "double_coop": 2, "add_coop": 3, "add_lane": 4,
    "double_fold2_warps": 5, "add_fold2_warps": 6, "double_fold2_lane": 7, "add_fold2_lane": 8,
}

_ARGTYPES = (
    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int]
    + [ctypes.c_void_p] * 3
    + [ctypes.c_int, ctypes.c_void_p]
)


def _entry(name):
    fn = getattr(_build.load("check"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES
    return fn


def field_op(curve: CurveSpec, op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fe_mul / fe_add / fe_sub / fe_neg (of a) / fe_mul_cc / the product by
    3b (of a) / fe_mul_coop / the square (of a) / 3b a by additions on (EL,
    n) int64 batches of the curve's coordinate field (EL = L over Fq, 2L
    over Fq2)."""
    _launch.use_kernel("kernel", a)
    fn = _entry("zp_field_op")
    L, n = a.shape
    _launch.check_limbs("a", a, (curve.field.elem_len, n), a.device)
    _launch.check_limbs("b", b, (L, n), a.device)
    aw, bw = _launch.pack_point((a, b))
    out = torch.empty_like(aw)
    err = fn(
        curve.fq.n_words, curve.ext, _build.curve_consts(curve).ctypes.data_as(ctypes.c_void_p),
        _build.fold_b3k(curve), FIELD_OPS[op], _launch.ptr(aw), _launch.ptr(bw),
        _launch.ptr(out), n, _launch.stream_ptr(),
    )
    _build.check_launch(err, f"field_op {op}")
    return _launch.unpack_point(out[None], (n,))[0]


def group_op(curve: CurveSpec, op: str, p, q, b3k=None):
    """pt_add_mixed (q's X, Y as the affine operand) / pt_add / pt_double
    (of p) / pt_add<NW, true> / pt_double_par (of p) / pt_add_par, the last
    two with a product to a lane or cooperative products, or the fold's Fq2
    doubling (of p) and addition in either form, on projective batches,
    each coordinate (L, n) int64.  ``b3k``: the entry's curve constant
    argument (default _build.fold_b3k; over Fq2 0 takes the level of
    products by 3b where the curve would take additions)."""
    _launch.use_kernel("kernel", p[0])
    fn = _entry("zp_group_op")
    L, n = p[0].shape
    for name, t in zip(("px", "py", "pz", "qx", "qy", "qz"), tuple(p) + tuple(q)):
        _launch.check_limbs(name, t, (curve.field.elem_len, n), p[0].device)
    pw, qw = _launch.pack_point(p), _launch.pack_point(q)
    out = torch.empty_like(pw)
    err = fn(
        curve.fq.n_words, curve.ext, _build.curve_consts(curve).ctypes.data_as(ctypes.c_void_p),
        _build.fold_b3k(curve) if b3k is None else b3k, GROUP_OPS[op], _launch.ptr(pw), _launch.ptr(qw),
        _launch.ptr(out), n, _launch.stream_ptr(),
    )
    _build.check_launch(err, f"group_op {op}")
    return _launch.unpack_point(out, (n,))


def group_chain(curve: CurveSpec, op: str, p, q, reps: int, warps: int = 1, b3k=None):
    """``reps`` dependent pt_double_par (of p) or pt_add_par (q into p) on
    one point a warp, a product to a lane or cooperative products, on
    ``warps`` warps of one block (one SM: 1, 2 or 4); or ("add_lane") one-lane
    complete adds of q into p on one warp; or the fold's Fq2 links in either
    form on one block: the links of the reductions' chains, for timing
    (``b3k`` as group_op's).
    p, q: projective points, each coordinate (L, 1) int64."""
    _launch.use_kernel("kernel", p[0])
    fn = getattr(_build.load("check"), "zp_group_chain")
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]
    pw, qw = _launch.pack_point(p), _launch.pack_point(q)
    out = torch.empty_like(pw)
    err = fn(
        curve.fq.n_words, curve.ext, _build.curve_consts(curve).ctypes.data_as(ctypes.c_void_p),
        _build.fold_b3k(curve) if b3k is None else b3k, CHAIN_OPS[op], _launch.ptr(pw), _launch.ptr(qw),
        _launch.ptr(out), reps, warps, _launch.stream_ptr(),
    )
    _build.check_launch(err, f"group_chain {op}")
    return _launch.unpack_point(out, (1,))
