"""A Groth16 instance synthesized host-side, for the port's verifier (the
CPU tests and chip_smoke.py): tests/test_groth16.py's make_instance, on the
port's oracle and curve specs, importing neither jax nor the JAX package.

With A = a G1, B = b G2, vk_x = k G1 (through the IC MSM) and
C = (ab - alpha beta - k gamma) / delta G1, the product
e(-A, B) e(alpha, beta) e(vk_x, gamma) e(C, delta) is exactly 1."""

from zprize_wasm_msm_tpu_torch.models.curves import bls12_381, bls12_381_g2
from zprize_wasm_msm_tpu_torch.models.groth16 import Proof, VerifyingKey
from zprize_wasm_msm_tpu_torch.oracle import Curve as OracleCurve, F2, F3


def make_instance(rng, n_publics=2, g1c=bls12_381, g2c=bls12_381_g2):
    """(vk, proof, publics, G1 oracle, c) from a numpy generator; G2 over
    Fq2 (BLS12-381, BN254) or Fq3 (MNT6753)."""
    r = g1c.r
    oc1 = OracleCurve(q=g1c.q, a=g1c.a, b=g1c.b, r=r, gx=g1c.gx, gy=g1c.gy)
    field = (F2 if g2c.ext == 2 else F3)(g2c.q, g2c.nr)
    oc2 = OracleCurve(q=g2c.q, a=g2c.a, b=g2c.b, r=r, gx=g2c.gx, gy=g2c.gy, field=field)
    nbytes = max(31, (r.bit_length() + 7) // 8)  # 31: the BLS12-381 and BN254 instances
    rnd = lambda: int.from_bytes(rng.bytes(nbytes), "little") % r
    alpha, beta, gamma, delta, a, b = (rnd() for _ in range(6))
    publics = [rnd() for _ in range(n_publics)]
    ics = [rnd() for _ in range(n_publics + 1)]
    k = (ics[0] + sum(p * i for p, i in zip(publics, ics[1:]))) % r
    c = (a * b - alpha * beta - k * gamma) % r * pow(delta, -1, r) % r

    vk = VerifyingKey(
        alpha1=oc1.mul(oc1.g, alpha),
        beta2=oc2.mul(oc2.g, beta),
        gamma2=oc2.mul(oc2.g, gamma),
        delta2=oc2.mul(oc2.g, delta),
        ic=[oc1.mul(oc1.g, i) for i in ics],
    )
    proof = Proof(a=oc1.mul(oc1.g, a), b=oc2.mul(oc2.g, b), c=oc1.mul(oc1.g, c))
    return vk, proof, publics, oc1, c
