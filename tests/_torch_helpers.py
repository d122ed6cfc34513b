"""Shared helpers of the tests/test_torch_*.py files: the same inputs, made
from a seed with numpy, go to the JAX package (as jnp arrays) and to the
PyTorch port (as CPU tensors); results come back as numpy for comparison."""

import contextlib

import jax.numpy as jnp
import numpy as np
import torch

from zprize_wasm_msm_tpu.models import curves as ref_curves
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.oracle import Curve as OracleCurve
from zprize_wasm_msm_tpu_torch.utils.convert import from_reference, to_reference
from zprize_wasm_msm_tpu_torch.utils.limbs import ints_to_limbs, limbs_to_ints

# six xdist workers share eight cores: one intra-op thread per worker
torch.set_num_threads(1)

#: (reference CurveSpec, port CurveSpec) by name
CURVE_PAIRS = {
    "toy": (ref_curves.toy, port_curves.toy),
    "bls12_381": (ref_curves.bls12_381, port_curves.bls12_381),
}


def edge_values(q):
    return [0, 1, q - 1, q // 2, q // 2 + 1]


def field_operands(q, n_random, seed):
    """Two value lists: every ordered pair of edge values, then random."""
    rng = np.random.default_rng(seed)
    edges = edge_values(q)
    rand = lambda: int.from_bytes(rng.bytes(100), "little") % q
    a = [x for x in edges for _ in edges] + [rand() for _ in range(n_random)]
    b = [y for _ in edges for y in edges] + [rand() for _ in range(n_random)]
    return a, b


def mont_limbs(fq, values):
    """Standard-domain ints -> (L, N) uint32 numpy limbs, Montgomery form."""
    return ints_to_limbs([fq.to_mont_int(v) for v in values], fq.n_limbs)


def to_jax(x):
    if isinstance(x, tuple):
        return tuple(to_jax(v) for v in x)
    return jnp.asarray(x)


def to_torch(x):
    return from_reference(x, "cpu")


def jax_np(x):
    if isinstance(x, tuple):
        return tuple(jax_np(v) for v in x)
    return np.asarray(x)


def torch_np(x):
    if isinstance(x, (tuple, list)):
        return tuple(torch_np(v) for v in x)
    if x.dtype == torch.bool:
        return x.numpy()
    return to_reference(x)


def assert_same(got_torch, want_jax, msg=""):
    """Bit-for-bit equality of a port result and a reference result (arrays
    or tuples of arrays): same shape, same dtype after conversion, same values."""
    g, w = torch_np(got_torch), jax_np(want_jax)
    if isinstance(g, tuple):
        assert len(g) == len(w), msg
        for gi, wi in zip(g, w):
            np.testing.assert_array_equal(gi, wi, err_msg=msg)
    else:
        np.testing.assert_array_equal(g, w, err_msg=msg)


def oracle_of(curve):
    """The host oracle of a curve: coordinates in Fq, or in Fq2 for ext 2."""
    from zprize_wasm_msm_tpu_torch.oracle import F2

    field = F2(curve.q, curve.nr) if curve.ext == 2 else None
    return OracleCurve(q=curve.q, a=curve.a, b=curve.b, r=curve.r, gx=curve.gx, gy=curve.gy, field=field)


def affine_np(curve, pts):
    """Python affine points (None = infinity) -> (X, Y) numpy Montgomery limbs."""
    fq = curve.fq
    xs = [0 if p is None else p[0] for p in pts]
    ys = [0 if p is None else p[1] for p in pts]
    return mont_limbs(fq, xs), mont_limbs(fq, ys)


def host_points(curve, x_np, y_np):
    """(X, Y) numpy Montgomery limb batches -> python affine points."""
    fq = curve.fq
    xs = [fq.from_mont_int(v) for v in limbs_to_ints(np.asarray(x_np).reshape(fq.n_limbs, -1))]
    ys = [fq.from_mont_int(v) for v in limbs_to_ints(np.asarray(y_np).reshape(fq.n_limbs, -1))]
    return [None if (x == 0 and y == 0) else (x, y) for x, y in zip(xs, ys)]


def random_points(curve, n, seed, bound=None):
    """n affine multiples of the generator (host oracle), small multiples so
    that full-width curves stay cheap."""
    rng = np.random.default_rng(seed)
    oc = oracle_of(curve)
    hi = min(curve.r, bound or (1 << 30))
    return [oc.mul(oc.g, int(rng.integers(1, hi))) for _ in range(n)]


@contextlib.contextmanager
def jax_stages_eager(*modules, functions=()):
    """Run the JAX package's pairing code op by op: ``jax.lax.scan`` and
    ``jax.lax.fori_loop`` as Python loops, and every jitted function of
    ``modules`` (and each (module, name) of ``functions``) as its unjitted
    body, so each field op is one call of its own small jit.  XLA:CPU
    compiles the fused toy-BN Miller loop in about a minute and its final
    exponentiation in several (a full-width inversion's loop runs out of
    memory); op by op the whole pairing takes seconds, and computes the
    same values.  Restored on exit."""
    import jax

    def scan(f, init, xs=None, length=None, reverse=False, **kw):
        n = length if xs is None else len(jax.tree_util.tree_leaves(xs)[0])
        carry, ys = init, []
        for i in range(n - 1, -1, -1) if reverse else range(n):
            carry, y = f(carry, None if xs is None else jax.tree_util.tree_map(lambda a: a[i], xs))
            ys.append(y)
        if reverse:
            ys.reverse()
        if not ys or jax.tree_util.tree_leaves(ys[0]) == []:
            return carry, None
        return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)

    def fori_loop(lower, upper, body, init, **kw):
        val = init
        for i in range(lower, upper):
            val = body(i, val)
        return val

    saved = [(jax.lax, "scan", jax.lax.scan), (jax.lax, "fori_loop", jax.lax.fori_loop)]
    for mod in modules:
        for name in dir(mod):
            obj = getattr(mod, name)
            if callable(obj) and hasattr(obj, "__wrapped__") and hasattr(obj, "lower"):
                saved.append((mod, name, obj))
    saved += [(mod, name, getattr(mod, name)) for mod, name in functions]
    try:
        jax.lax.scan, jax.lax.fori_loop = scan, fori_loop
        for mod, name, obj in saved[2:]:
            setattr(mod, name, obj.__wrapped__)
        yield
    finally:
        for mod, name, obj in saved:
            setattr(mod, name, obj)
