"""Groth16 verifier: the end-to-end SNARK application of the framework.

Port of zprize_wasm_msm_tpu/models/groth16.py.  The reference is the WASM
engine underneath snarkjs' Groth16 pipeline (wasmcurves feeds
ffjavascript/snarkjs; its QAP builder build_qap.js, applyKey
build_applykey.js, MSM and pairingEq exports build_bls12381.js:1592-1597
exist exactly to serve this protocol).  A verifier is one MSM for the
public-input linear combination and one 4-pair product-of-pairings check:

    e(A, B) = e(alpha, beta) * e(vk_x, gamma) * e(C, delta)
    vk_x    = IC_0 + sum_i publics_i * IC_{i+1}

checked as  e(-A, B) * e(alpha, beta) * e(vk_x, gamma) * e(C, delta) == 1
(the reference's pairingEq4 shape, build_bls12381.js pairingEq:1560-1590).

Runs on the curve pairs with a pairing on CurveContext (BLS12-381, BN254,
toy BN, MNT6753 with its G2 over Fq3: the JAX package's groth16.py:80-81).  Every host value goes to the device first; vk_x stays on the
device (affine, (0, 0) for the identity, as the pairing takes it); the one
host synchronisation is the bool at the end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from ..ops.curve import group
from .context import CurveContext


@dataclass
class VerifyingKey:
    """Affine host-side points (ints / tuples for extension coords)."""

    alpha1: Tuple  # G1
    beta2: Tuple  # G2
    gamma2: Tuple  # G2
    delta2: Tuple  # G2
    ic: List[Tuple]  # G1, length n_publics + 1


@dataclass
class Proof:
    a: Tuple  # G1
    b: Tuple  # G2
    c: Tuple  # G1


def verify(
    ctx_g1: CurveContext,
    ctx_g2: CurveContext,
    vk: VerifyingKey,
    proof: Proof,
    publics: Sequence[int],
) -> bool:
    """Groth16 verification on the contexts' device.

    ctx_g1/ctx_g2: the curve pair (e.g. build_curve(bls12_381) and
    build_curve(bls12_381_g2)).  Returns a python bool.
    """
    if len(vk.ic) != len(publics) + 1:
        raise ValueError(f"IC length {len(vk.ic)} != n_publics + 1 = {len(publics) + 1}")
    spec = ctx_g1.spec
    # -A: negated host-side; G1 is a base-field curve in every wired family
    ax, ay = proof.a
    if isinstance(ay, tuple):
        raise TypeError("the G1 proof point must have base-field coordinates")
    neg_a = (ax, (-ay) % spec.q)

    # every host -> device copy before the first launch
    pa = ctx_g1.points_to_device([neg_a, vk.alpha1, proof.c])
    Qs = ctx_g2.points_to_device([proof.b, vk.beta2, vk.gamma2, vk.delta2])
    ic0 = group.from_affine(spec, ctx_g1.points_to_device([vk.ic[0]]))
    if publics:
        P = ctx_g1.points_to_device(vk.ic[1:])
        s = ctx_g1.scalars_to_device([int(p) % spec.r for p in publics])
        # vk_x = IC_0 + sum_i publics_i * IC_{i+1}  — the MSM stage
        acc = ctx_g1.msm(P, s)
        vkx_p = group.add(spec, tuple(c[:, None] for c in acc), ic0)
    else:
        vkx_p = ic0
    vk_x = group.to_affine(spec, vkx_p)  # (0, 0) encodes the identity

    Ps = tuple(torch.cat([a[:, :2], v, a[:, 2:]], dim=1) for a, v in zip(pa, vk_x))
    return bool(ctx_g1.pairing_eq(Ps, Qs))
