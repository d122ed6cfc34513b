"""PyTorch port: the Groth16 verifier (models/groth16.py) against the JAX
package's on the same instances (tests/_torch_groth16.make_instance, the
construction of tests/test_groth16.py): a valid proof accepted, a corrupted
C and a corrupted public input rejected, by both.  Fast tier: the toy BN
family (the JAX side's MSM and pairing stages op by op,
tests/_torch_helpers.jax_stages_eager).  Slow tier: BLS12-381 and BN254, as
tests/test_groth16.py's full-width case."""

import numpy as np
import pytest

from zprize_wasm_msm_tpu.models import context as ref_context
from zprize_wasm_msm_tpu.models import curves as ref_curves
from zprize_wasm_msm_tpu.models import groth16 as ref_groth16
from zprize_wasm_msm_tpu.ops.curve import group as ref_group
from zprize_wasm_msm_tpu.ops.pairing import bls12 as ref_bls12
from zprize_wasm_msm_tpu.ops.field import mont as ref_mont
from zprize_wasm_msm_tpu.ops.msm import pippenger as ref_pippenger
from zprize_wasm_msm_tpu.ops.pairing import bn as ref_bn
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.models import groth16
from zprize_wasm_msm_tpu_torch.models.context import build_curve

from tests._torch_groth16 import make_instance
from tests._torch_helpers import jax_stages_eager


def _cases(vk, proof, publics, oc1, c):
    bad_c = groth16.Proof(a=proof.a, b=proof.b, c=oc1.mul(oc1.g, c + 1))
    return [(proof, publics, True), (bad_c, publics, False),
            (proof, [publics[0] + 1] + publics[1:], False)]


def _both_verify(names, n_publics, seed, functions=()):
    g1, g2 = (getattr(port_curves, n) for n in names)
    r1, r2 = (getattr(ref_curves, n) for n in names)
    vk, proof, publics, oc1, c = make_instance(np.random.default_rng(seed), n_publics, g1, g2)
    ctx1, ctx2 = build_curve(g1, device="cpu"), build_curve(g2, device="cpu")
    rctx1, rctx2 = ref_context.build_curve(r1), ref_context.build_curve(r2)
    ref_vk = ref_groth16.VerifyingKey(vk.alpha1, vk.beta2, vk.gamma2, vk.delta2, vk.ic)
    for prf, pub, want in _cases(vk, proof, publics, oc1, c):
        assert groth16.verify(ctx1, ctx2, vk, prf, pub) is want
        with jax_stages_eager(ref_bn, ref_bls12, ref_pippenger, functions=functions):
            got = ref_groth16.verify(rctx1, rctx2, ref_vk, ref_groth16.Proof(prf.a, prf.b, prf.c), pub)
        assert got is want


@pytest.mark.parametrize("n_publics", [2, 0])
def test_groth16_toy_bn_matches_jax(n_publics):
    """Two public inputs (the IC MSM at N = 2), and none (vk_x = IC_0)."""
    if n_publics == 0:
        # no publics: no MSM, and no public input to corrupt
        g1, g2 = port_curves.toy_bn, port_curves.toy_bn_g2
        vk, proof, _, oc1, c = make_instance(np.random.default_rng(9), 0, g1, g2)
        ctx1, ctx2 = build_curve(g1, device="cpu"), build_curve(g2, device="cpu")
        assert groth16.verify(ctx1, ctx2, vk, proof, []) is True
        bad = groth16.Proof(a=proof.a, b=proof.b, c=oc1.mul(oc1.g, c + 1))
        assert groth16.verify(ctx1, ctx2, vk, bad, []) is False
        return
    _both_verify(("toy_bn", "toy_bn_g2"), n_publics, seed=7)


def test_groth16_refuses_a_wrong_ic_length():
    g1, g2 = port_curves.toy_bn, port_curves.toy_bn_g2
    vk, proof, publics, _, _ = make_instance(np.random.default_rng(1), 2, g1, g2)
    with pytest.raises(ValueError):
        groth16.verify(build_curve(g1, device="cpu"), build_curve(g2, device="cpu"), vk, proof, publics[:1])


@pytest.mark.slow
@pytest.mark.parametrize("names", [("bls12_381", "bls12_381_g2"), ("bn254", "bn254_g2")])
def test_groth16_full_width_matches_jax(names):
    eager = ((ref_mont, "inverse"), (ref_mont, "exp_const"), (ref_mont, "batch_inverse"),
             (ref_group, "to_affine"))
    _both_verify(names, 2, seed=11, functions=eager)
