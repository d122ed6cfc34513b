"""PyTorch port, point serialization and the field ops it rests on, against
the JAX package — the same numpy inputs through both.

Field results are compared limb for limb (canonical 16-bit limbs, tolerance
zero): mont.exp / sign / is_negative / reduce_redundant / sqrt (Tonelli-
Shanks on the toy field, q = 10009 = 1 mod 4; one exponentiation on
BLS12-381), tower.Fq.sqrt and tower.Fq2.sign / exp_const / sqrt, with edge
values and non-residues (whose roots are the loops' leftovers, equal in
both packages).  Wire bytes are compared byte for byte, decoded points limb
for limb, on toy, BLS12-381 G1 and BLS12-381 G2, infinity and both sign
flags included.  Everything runs on CPU tensors (device="cpu").
"""

import numpy as np
import pytest
import torch

from zprize_wasm_msm_tpu.models import curves as ref_curves
from zprize_wasm_msm_tpu.ops.field import mont as ref_mont
from zprize_wasm_msm_tpu.utils import serde as ref_serde

import zprize_wasm_msm_tpu_torch as ZT
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.oracle import F2, Curve as OracleCurve
from zprize_wasm_msm_tpu_torch.ops.field import mont
from zprize_wasm_msm_tpu_torch.utils import serde
from zprize_wasm_msm_tpu_torch.utils.limbs import ints_to_limbs

from tests._torch_helpers import assert_same, edge_values, mont_limbs, to_jax, to_torch, torch_np

FIELDS = ("toy", "bls12_381")


def specs(name):
    return getattr(ref_curves, name).fq, getattr(port_curves, name).fq


def field_values(q, n_random, seed):
    """Edge values, squares, non-residues and random values of Fq."""
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(64), "little") % q for _ in range(n_random)]
    squares = [v * v % q for v in rand[:4]]
    nqr = [v for v in range(2, 200) if pow(v, (q - 1) // 2, q) == q - 1][:3]
    return edge_values(q) + squares + nqr + rand


@pytest.mark.parametrize("name", FIELDS)
def test_sign_and_is_negative_equal_reference(name):
    ref, port = specs(name)
    vals = field_values(port.q, 20, 1)
    a = mont_limbs(port, vals)
    got = mont.sign(port, to_torch(a))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_mont.sign(ref, to_jax(a))))
    np.testing.assert_array_equal(mont.is_negative(port, to_torch(a)).numpy(),
                                  np.asarray(ref_mont.is_negative(ref, to_jax(a))))
    assert got[:5].tolist() == [0, 1, -1, 1, -1]  # 0, 1, q-1, (q-1)/2, (q+1)/2


@pytest.mark.parametrize("name", FIELDS)
def test_exp_with_exponents_on_the_device_equals_reference(name):
    ref, port = specs(name)
    q = port.q
    vals = field_values(q, 6, 2)
    rng = np.random.default_rng(3)
    exps = [0, 1, 2, q - 1, q - 2, (q - 1) // 2] + [int.from_bytes(rng.bytes(48), "little") % q
                                                     for _ in range(len(vals) - 6)]
    a, e = mont_limbs(port, vals), ints_to_limbs(exps, port.n_limbs)
    got = mont.exp(port, to_torch(a), to_torch(e))
    assert_same(got, ref_mont.exp(ref, to_jax(a), to_jax(e)))
    want = [port.to_mont_int(pow(v, k, q)) for v, k in zip(vals, exps)]
    assert_same(got, ints_to_limbs(want, port.n_limbs))
    ctx = ZT.build_curve(getattr(port_curves, name), device="cpu")
    assert torch.equal(ctx.field_exp(to_torch(a), to_torch(e)), got)


@pytest.mark.parametrize("name", FIELDS)
def test_sqrt_equals_reference_on_residues_and_non_residues(name):
    ref, port = specs(name)
    q = port.q
    vals = field_values(q, 8, 4)
    a = mont_limbs(port, vals)
    r, ok = mont.sqrt(port, to_torch(a))
    rr, rok = ref_mont.sqrt(ref, to_jax(a))
    assert_same(r, rr)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    for v, okv in zip(vals, ok.tolist()):
        assert okv == (v == 0 or pow(v, (q - 1) // 2, q) == 1)
    # tower.Fq.sqrt is mont.sqrt
    r2, ok2 = getattr(port_curves, name).field.sqrt(to_torch(a))
    assert torch.equal(r2, r) and torch.equal(ok2, ok)


@pytest.mark.parametrize("name", FIELDS)
def test_reduce_redundant_equals_reference(name):
    """Raw limb sums of up to 2^10 canonical elements (limbs up to ~2^26),
    L and 2L limbs wide, back to canonical elements."""
    ref, port = specs(name)
    L, q = port.n_limbs, port.q
    rng = np.random.default_rng(5)
    terms = [[int.from_bytes(rng.bytes(64), "little") % q for _ in range(n)] for n in (1, 7, 1024)]
    terms.append([q - 1] * 1024)
    acc = np.stack([ints_to_limbs(t, L).astype(np.int64).sum(axis=1) for t in terms], axis=1)
    wide = np.concatenate([acc, acc[:, ::-1]], axis=0)  # 2L limbs
    for x in (acc, wide):
        got = mont.reduce_redundant(port, torch.as_tensor(x))
        assert_same(got, ref_mont.reduce_redundant(ref, to_jax(x.astype(np.uint32))))
    assert_same(mont.reduce_redundant(port, torch.as_tensor(acc)),
                ints_to_limbs([sum(t) % q for t in terms], L))
    with pytest.raises(ValueError, match="wider"):
        mont.reduce_redundant(port, torch.zeros((2 * L + 1, 1), dtype=torch.int64))


# ---------------------------------------------------------------------------
# Fq2 (G2)
# ---------------------------------------------------------------------------

G2_FIELDS = ("toy_g2", "bls12_381_g2")


def fq2_operands(curve, seed):
    """(2L, n) Montgomery limbs: edge components in pairs, squares and
    non-squares of Fq2, random elements."""
    q = curve.q
    hf = F2(q, curve.nr)
    rng = np.random.default_rng(seed)
    comps = [0, 1, q - 1, q // 2, q // 2 + 1]
    rand = lambda: (int.from_bytes(rng.bytes(64), "little") % q, int.from_bytes(rng.bytes(64), "little") % q)
    vals = [(x, y) for x in comps for y in comps]
    rs = [rand() for _ in range(6)]
    vals += [hf.mul(v, v) for v in rs[:3]] + rs
    fq = curve.fq
    return vals, np.concatenate([mont_limbs(fq, [v[0] for v in vals]), mont_limbs(fq, [v[1] for v in vals])])


@pytest.mark.parametrize("name", G2_FIELDS)
def test_fq2_sign_exp_const_and_sqrt_equal_reference(name):
    ref, port = getattr(ref_curves, name), getattr(port_curves, name)
    RF, F = ref.field, port.field
    vals, a = fq2_operands(port, 6)
    ta, ja = to_torch(a), to_jax(a)
    np.testing.assert_array_equal(F.sign(ta).numpy(), np.asarray(RF.sign(ja)))
    for e in ((0, 5, port.q - 2) if port.q < 1 << 16 else (0, 5)):  # q - 2: F.sqrt's ladders
        assert_same(F.exp_const(ta, e), RF.exp_const(ja, e))
    r, ok = F.sqrt(ta)
    rr, rok = RF.sqrt(ja)
    assert_same(r, rr)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    hf = F2(port.q, port.nr)
    assert all(ok[25:28].tolist())  # the three squares
    assert not all(ok.tolist())  # and some non-squares
    root = F.to_host(r)
    for v, okv, x in zip(vals, ok.tolist(), root):
        assert okv == (hf.mul(x, x) == (v[0] % port.q, v[1] % port.q))


def test_fq2_sqrt_keeps_a_general_non_residue():
    """The port's Fq2.sqrt multiplies by u through the general product: with
    nr = -2 (a non-residue mod 9967, q = 3 mod 4) it still returns roots."""
    from zprize_wasm_msm_tpu_torch.ops.field.tower import Fq2

    q = port_curves.toy_g2.q
    assert pow(q - 2, (q - 1) // 2, q) == q - 1  # nr = -2 is a non-residue
    F = Fq2(port_curves.toy_g2.fq, -2)
    hf = F2(q, -2)
    rng = np.random.default_rng(9)
    xs = [(int(rng.integers(0, q)), int(rng.integers(0, q))) for _ in range(12)]
    sq = [hf.mul(x, x) for x in xs]
    a = torch.cat([F.const(v, (1,)) for v in sq], dim=1)
    r, ok = F.sqrt(a)
    assert ok.all()
    for x2, root in zip(sq, F.to_host(r)):
        assert hf.mul(root, root) == x2


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------

SERDE_CURVES = ("toy", "bls12_381", "bls12_381_g2")


def serde_points(curve, seed):
    """Affine points and their negatives (both sign flags), the point with
    x = 0 where the curve has one, and infinity."""
    field = F2(curve.q, curve.nr) if curve.ext == 2 else None
    oc = OracleCurve(q=curve.q, a=curve.a, b=curve.b, r=curve.r, gx=curve.gx, gy=curve.gy, field=field)
    rng = np.random.default_rng(seed)
    pts = [oc.mul(oc.g, int(rng.integers(1, min(curve.r, 1 << 20)))) for _ in range(4)]
    return pts + [oc.neg(p) for p in pts] + [None]


def affine_limbs(curve, pts):
    ctx = ZT.build_curve(curve, device="cpu")
    X, Y = ctx.points_to_device(pts)
    return X, Y


@pytest.mark.parametrize("name", SERDE_CURVES)
def test_serde_bytes_and_points_equal_reference(name):
    ref, port = getattr(ref_curves, name), getattr(port_curves, name)
    pts = serde_points(port, 11)
    X, Y = affine_limbs(port, pts)
    JX, JY = to_jax(torch_np(X)), to_jax(torch_np(Y))
    n8 = 2 * port.field.elem_len
    ctx = ZT.build_curve(port, device="cpu")
    for to_port, to_ref, from_port, from_ref, width in (
        (serde.points_to_uncompressed, ref_serde.points_to_uncompressed,
         ctx.from_uncompressed, ref_serde.points_from_uncompressed, 2 * n8),
        (serde.points_to_compressed, ref_serde.points_to_compressed,
         ctx.from_compressed, ref_serde.points_from_compressed, n8),
    ):
        raw = to_port(port, X, Y)
        want = to_ref(ref, JX, JY)
        assert raw.dtype == np.uint8 and raw.shape == (len(pts), width)
        np.testing.assert_array_equal(raw, np.asarray(want))
        got = from_port(raw)
        assert_same(got, from_ref(ref, raw))
        assert torch.equal(got[0], X) and torch.equal(got[1], Y)
        assert raw[-1, 0] == 0x40 and not raw[-1, 1:].any()
    flags = ctx.to_compressed(X, Y)[:-1, 0] & 0x80
    assert 0 < int((flags != 0).sum()) < len(pts) - 1  # both sign flags occur
    assert serde.batch_c_to_lem is serde.points_from_compressed
    assert serde.batch_lem_to_u is serde.points_to_uncompressed


def test_serde_entry_points_need_a_device():
    """None means the card: without one, decoding raises instead of
    running on the CPU."""
    port = port_curves.toy
    X, Y = affine_limbs(port, serde_points(port, 3))
    raw = serde.points_to_compressed(port, X, Y)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serde.points_from_compressed(port, raw)
    got = serde.points_from_compressed(port, raw, device="cpu")
    assert torch.equal(got[0], X) and torch.equal(got[1], Y)
