"""PyTorch port: the pairing layer (ops/pairing/tower.py, bls12.py, bn.py)
bit for bit against the JAX package.

Fast tier: the Fq6 / Fq12 tower ops, the Miller-loop steps and the host
constants on BLS12-381 and BN254 at batch 4, and the toy BN family end to
end (miller_loop, final_exponentiation and its plain oracle, pairing,
pairing_eq), as tests/test_pairing_toy_bn.py runs it.  The JAX side runs its
pairing stages op by op (tests/_torch_helpers.jax_stages_eager): the same
functions, without the minutes XLA:CPU takes to compile them fused.
Slow tier: the full-width pairings, as tests/test_pairing.py and
tests/test_pairing_bn.py run them."""

import numpy as np
import pytest
import torch

from zprize_wasm_msm_tpu.ops.field import mont as ref_mont
from zprize_wasm_msm_tpu.ops.pairing import bls12 as ref_bls12
from zprize_wasm_msm_tpu.ops.pairing import bn as ref_bn
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.models.context import build_curve
from zprize_wasm_msm_tpu_torch.ops.pairing import bls12, bn

from tests._torch_helpers import assert_same, jax_stages_eager, mont_limbs, oracle_of, to_jax, to_torch

SPECS = {
    "bls12_381": (ref_bls12.get_bls12_381_spec, bls12.get_bls12_381_spec),
    "bn254": (ref_bn.get_bn254_spec, bn.get_bn254_spec),
    "toy_bn": (ref_bn.get_toy_bn_spec, bn.get_toy_bn_spec),
}


def _elements(spec, m, batch, rng, zero_col=False):
    """(m L, batch) uint32 Montgomery limbs: m base-field components of
    random values a column (column 0 all zero if zero_col)."""
    L = spec.n_limbs
    vals = [[int.from_bytes(rng.bytes(48), "little") % spec.q for _ in range(batch)] for _ in range(m)]
    if zero_col:
        for v in vals:
            v[0] = 0
    return np.concatenate([mont_limbs(spec, v) for v in vals])


#: op name -> the components of its arguments (2: Fq2, 6: Fq6, 12: Fq12, 1: Fq)
TOWER_OPS = {
    "f2_mul_xi": (2,), "f2_scale_fq": (2, 1), "f6_add": (6, 6), "f6_sub": (6, 6), "f6_neg": (6,),
    "f6_mul_nr": (6,), "f6_mul": (6, 6), "f6_square": (6,), "f6_mul1": (6, 2), "f6_mul01": (6, 2, 2),
    "f6_inverse": (6,), "f12_mul": (12, 12), "f12_square": (12,), "f12_conjugate": (12,),
    "f12_inverse": (12,), "f12_mul014": (12, 2, 2, 2), "f12_mul024": (12, 2, 2, 2),
    "f12_frobenius": (12,), "f12_cyclotomic_square": (12,),
}


@pytest.mark.parametrize("curve", ["bls12_381", "bn254"])
@pytest.mark.parametrize("op", sorted(TOWER_OPS))
def test_tower_op_matches_jax(curve, op):
    """Every Fq2/Fq6/Fq12 op of the tower at batch 4 (the inverses with a
    zero column, which maps to zero)."""
    ref_ps, ps = (f() for f in SPECS[curve])
    rng = np.random.default_rng(len(op))
    args = [_elements(ps.tower.spec, m, 4, rng, zero_col=op.endswith("inverse")) for m in TOWER_OPS[op]]
    got = getattr(ps.tower, op)(*[to_torch(a) for a in args])
    want = getattr(ref_ps.tower, op)(*[to_jax(a) for a in args])
    assert_same(got, want, op)


@pytest.mark.parametrize("curve", ["bls12_381", "bn254", "toy_bn"])
def test_host_constants_match_jax(curve):
    ref_ps, ps = (f() for f in SPECS[curve])
    assert ps.tower.xi == ref_ps.tower.xi
    assert ps.loop_bits == ref_ps.loop_bits
    assert ps.tower._frob_gammas == ref_ps.tower._frob_gammas
    q, r = ps.g1.q, ps.g1.r
    assert bls12._hard_exp_bits(q, r) == ref_bls12._hard_exp_bits(q, r)
    e = abs(ps.x) if curve == "bls12_381" else ps.z
    assert bls12._naf_digits_msb(e) == ref_bls12._naf_digits_msb(e)
    if curve != "bls12_381":
        for attr in ("loop_count", "two_inv", "twist_b", "frob_gamma_x", "frob_gamma_y"):
            assert getattr(ps, attr) == getattr(ref_ps, attr), attr


@pytest.mark.parametrize("curve", ["bls12_381", "bn254"])
def test_miller_steps_match_jax(curve):
    """One doubling step, one addition step and both lines folded into an
    f (BN254: also the Frobenius twist of Q), at batch 4 on random
    coordinates: the formulas are algebra, on or off the curve."""
    ref_ps, ps = (f() for f in SPECS[curve])
    spec = ps.tower.spec
    rng = np.random.default_rng(3)
    R = tuple(_elements(spec, 2, 4, rng) for _ in range(3))
    Q = tuple(_elements(spec, 2, 4, rng) for _ in range(2))
    Pa = tuple(_elements(spec, 1, 4, rng) for _ in range(2))
    f = _elements(spec, 12, 4, rng)
    tR, tQ, tP, tf = (to_torch(x) for x in (R, Q, Pa, f))
    jR, jQ, jP, jf = (to_jax(x) for x in (R, Q, Pa, f))
    if curve == "bls12_381":
        dbl = bls12._dbl_step(ps.tower.f2, tR)
        rdbl = ref_bls12._dbl_step(ref_ps.tower.f2, jR)
        add = bls12._add_step(ps.tower.f2, tR, tQ)
        radd = ref_bls12._add_step(ref_ps.tower.f2, jR, jQ)
        mod, ref_mod = bls12, ref_bls12
    else:
        dbl, rdbl = bn._dbl_step(ps, tR), ref_bn._dbl_step(ref_ps, jR)
        add, radd = bn._add_step(ps, tR, tQ), ref_bn._add_step(ref_ps, jR, jQ)
        assert_same(bn._mul_by_q(ps, tQ), ref_bn._mul_by_q(ref_ps, jQ))
        mod, ref_mod = bn, ref_bn
    for got, want in ((dbl, rdbl), (add, radd)):
        assert_same(got[0], want[0])
        assert_same(got[1], want[1])
        assert_same(mod._ell(ps.tower, tf, got[1], *tP), ref_mod._ell(ref_ps.tower, jf, want[1], *jP))


# ---------------------------------------------------------------------------
# toy BN end to end
# ---------------------------------------------------------------------------


def _toy_points(pairs):
    """Affine G1 / G2 batches of toy BN, numpy limbs (None -> (0, 0))."""
    g1, g2 = port_curves.toy_bn, port_curves.toy_bn_g2
    c1, c2 = build_curve(g1, device="cpu"), build_curve(g2, device="cpu")
    P = c1.points_to_device([p for p, _ in pairs])
    Q = c2.points_to_device([q for _, q in pairs])
    return tuple(t.numpy().astype(np.uint32) for t in P), tuple(t.numpy().astype(np.uint32) for t in Q)


@pytest.fixture(scope="module")
def toy_bn_run():
    """The toy BN pairing stages on both packages, once: a batch of pairs
    with bilinear relations and the identity on either side."""
    ref_ps, ps = (f() for f in SPECS["toy_bn"])
    oc1, oc2 = oracle_of(port_curves.toy_bn), oracle_of(port_curves.toy_bn_g2)
    P, Q = oc1.g, oc2.g
    pairs = [(oc1.double(P), Q), (P, oc2.double(Q)), (P, Q), (None, Q), (P, None), (oc1.mul(P, 5), oc2.mul(Q, 7))]
    (Px, Py), (Qx, Qy) = _toy_points(pairs)
    out = {"ps": ps, "ref_ps": ref_ps}
    out["f"] = bn.miller_loop(ps, to_torch((Px, Py)), to_torch((Qx, Qy)))
    out["e"] = bn.final_exponentiation(ps, out["f"])
    out["plain"] = bls12.final_exponentiation_plain(ps, out["f"])
    out["pairing"] = bn.pairing(ps, to_torch((Px, Py)), to_torch((Qx, Qy)))
    with jax_stages_eager(ref_bn, ref_bls12):
        out["ref_f"] = ref_bn.miller_loop(ref_ps, to_jax((Px, Py)), to_jax((Qx, Qy)))
        out["ref_e"] = ref_bn.final_exponentiation(ref_ps, out["ref_f"])
        out["ref_plain"] = ref_bls12.final_exponentiation_plain(ref_ps, out["ref_f"])
    return out


def test_toy_bn_miller_loop_matches_jax(toy_bn_run):
    assert_same(toy_bn_run["f"], toy_bn_run["ref_f"])
    tw = toy_bn_run["ps"].tower
    one = tw.f12_one((1,))[:, 0]
    assert torch.equal(toy_bn_run["f"][:, 3], one) and torch.equal(toy_bn_run["f"][:, 4], one)


def test_toy_bn_final_exponentiation_matches_jax(toy_bn_run):
    """The fast chain and the plain oracle, each the JAX package's limbs;
    the chain is the plain value to the power d = 2z(6z^2+3z+1)."""
    assert_same(toy_bn_run["e"], toy_bn_run["ref_e"])
    assert_same(toy_bn_run["plain"], toy_bn_run["ref_plain"])
    ps = toy_bn_run["ps"]
    d = 2 * ps.z * (6 * ps.z * ps.z + 3 * ps.z + 1)
    assert torch.equal(bls12._cyclotomic_exp(ps.tower, toy_bn_run["plain"], d, False), toy_bn_run["e"])


def test_toy_bn_pairing_bilinear_and_matches_jax(toy_bn_run):
    """pairing = final_exponentiation(miller_loop); e(2P, Q) = e(P, 2Q) =
    e(P, Q)^2, e(5P, 7Q) = e(P, Q)^35, e(O, Q) = e(P, O) = 1, e(P, Q) != 1."""
    e = toy_bn_run["pairing"]
    assert_same(e, toy_bn_run["ref_e"])
    tw = toy_bn_run["ps"].tower
    one = tw.f12_one((1,))[:, 0]
    assert torch.equal(e[:, 0], e[:, 1])
    assert torch.equal(tw.f12_square(e[:, 2:3])[:, 0], e[:, 0])
    assert torch.equal(bls12._cyclotomic_exp(tw, e[:, 2:3], 35, False)[:, 0], e[:, 5])
    assert torch.equal(e[:, 3], one) and torch.equal(e[:, 4], one)
    assert not torch.equal(e[:, 2], one)


def test_toy_bn_pairing_eq_matches_jax():
    """e(aP, bQ) e(-abP, Q) = 1 is accepted, the perturbed product rejected,
    by both packages; the product tree over the pair axis bit for bit."""
    ref_ps, ps = (f() for f in SPECS["toy_bn"])
    oc1, oc2 = oracle_of(port_curves.toy_bn), oracle_of(port_curves.toy_bn_g2)
    P, Q = oc1.g, oc2.g
    r = port_curves.toy_bn.r
    a, b = 123, 456
    nab = oc1.neg(oc1.mul(P, a * b % r))
    for first, want in ((oc1.mul(P, a), True), (oc1.mul(P, a + 1), False)):
        Pp, Qp = _toy_points([(first, oc2.mul(Q, b)), (nab, Q)])
        got = bn.pairing_eq(ps, to_torch(Pp), to_torch(Qp))
        with jax_stages_eager(ref_bn, ref_bls12):
            ref = ref_bn.pairing_eq(ref_ps, to_jax(Pp), to_jax(Qp))
        assert bool(got) is want and bool(np.asarray(ref)) is want
    # an odd count: the tree carries its last column a level up
    P3, Q3 = _toy_points([(P, Q), (oc1.double(P), Q), (P, oc2.double(Q))])
    tree = bls12._f12_product_tree(ps, bn.miller_loop(ps, to_torch(P3), to_torch(Q3)))
    with jax_stages_eager(ref_bn, ref_bls12):
        ref_tree = ref_bn._f12_product_tree(ref_ps, ref_bn.miller_loop(ref_ps, to_jax(P3), to_jax(Q3)))
    assert_same(tree, ref_tree)


def test_context_pairing_surface_toy_bn():
    """The CurveContext dispatch: toy_bn's pairing, miller_loop,
    final_exponentiation and pairing_eq are the bn module's; MNT6753's the
    mnt6 module's; a curve with no pairing raises."""
    ps = bn.get_toy_bn_spec()
    c1 = build_curve(port_curves.toy_bn, device="cpu")
    c2 = build_curve(port_curves.toy_bn_g2, device="cpu")
    oc1, oc2 = oracle_of(port_curves.toy_bn), oracle_of(port_curves.toy_bn_g2)
    P, Q = c1.points_to_device([oc1.g]), c2.points_to_device([oc2.g])
    f = c1.miller_loop(P, Q)
    assert torch.equal(f, bn.miller_loop(ps, P, Q))
    assert torch.equal(c1.final_exponentiation(f), c1.pairing(P, Q))
    assert bool(c1.pairing_eq(P, Q)) is False
    from zprize_wasm_msm_tpu_torch.ops.pairing import mnt6

    for name in ("mnt6753", "mnt6753_g2"):
        mod, spec = build_curve(getattr(port_curves, name), device="cpu")._pairing
        assert mod is mnt6 and spec is mnt6.get_mnt6753_spec()
    with pytest.raises(NotImplementedError):
        build_curve(port_curves.toy, device="cpu").pairing(P, Q)


# ---------------------------------------------------------------------------
# full width (slow): as tests/test_pairing.py and tests/test_pairing_bn.py
# ---------------------------------------------------------------------------

#: the JAX package's field inversion compiles its ladder fused, out of memory
#: at full width: run it op by op too
FULL_WIDTH_EAGER = ((ref_mont, "inverse"), (ref_mont, "exp_const"), (ref_mont, "batch_inverse"))


@pytest.mark.slow
@pytest.mark.parametrize("curve", ["bls12_381", "bn254"])
def test_full_width_pairing_matches_jax(curve):
    """miller_loop, final_exponentiation (against its plain oracle: cubed on
    BLS12-381, to the power d on BN254) and pairing_eq on the full-width
    curves, each the JAX package's limbs."""
    ref_ps, ps = (f() for f in SPECS[curve])
    oc1, oc2 = oracle_of(ps.g1), oracle_of(ps.g2)
    P, Q = oc1.g, oc2.g
    c1, c2 = build_curve(ps.g1, device="cpu"), build_curve(ps.g2, device="cpu")
    Pd = c1.points_to_device([oc1.double(P), P, P, None])
    Qd = c2.points_to_device([Q, oc2.double(Q), Q, Q])
    jP = to_jax(tuple(t.numpy().astype(np.uint32) for t in Pd))
    jQ = to_jax(tuple(t.numpy().astype(np.uint32) for t in Qd))
    mod, ref_mod = (bls12, ref_bls12) if curve == "bls12_381" else (bn, ref_bn)
    f = mod.miller_loop(ps, Pd, Qd)
    e = mod.final_exponentiation(ps, f)
    with jax_stages_eager(ref_bn, ref_bls12, functions=FULL_WIDTH_EAGER):
        ref_f = ref_mod.miller_loop(ref_ps, jP, jQ)
        ref_e = ref_mod.final_exponentiation(ref_ps, ref_f)
        ref_ok = ref_mod.pairing_eq(ref_ps, tuple(x[:, 1:3] for x in jP), tuple(x[:, 1:3] for x in jQ))
    assert_same(f, ref_f)
    assert_same(e, ref_e)
    tw = ps.tower
    assert torch.equal(e[:, 0], e[:, 1]) and torch.equal(e[:, 3], tw.f12_one((1,))[:, 0])
    plain = bls12.final_exponentiation_plain(ps, f[:, 2:3])
    power = 3 if curve == "bls12_381" else 2 * ps.z * (6 * ps.z * ps.z + 3 * ps.z + 1)
    assert torch.equal(bls12._cyclotomic_exp(tw, plain, power, False)[:, 0], e[:, 2])
    got = mod.pairing_eq(ps, tuple(x[:, 1:3] for x in Pd), tuple(x[:, 1:3] for x in Qd))
    assert bool(got) is bool(np.asarray(ref_ok)) is False
    assert bool(mod.pairing_eq(ps, c1.points_to_device([P, oc1.neg(P)]), c2.points_to_device([Q, Q])))
