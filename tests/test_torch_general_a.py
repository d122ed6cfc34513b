"""PyTorch port, general a: the complete formulas for any a (RCB16
algorithm 1, group._add_general) that the a != 0 curves take — toy_a
(y^2 = x^3 + 3x + 1 over a 14-bit field) and MNT6753 G1 (a = 11, 753
bits) — against the JAX package's group ops and the host oracle, the same
numpy inputs through both: add, double, mixed add, in_curve, and on toy_a
the plain MSM against the JAX package's jnp MSM (the engine the reference
runs on these curves on every device).

Group ops are compared bit for bit (canonical 16-bit limbs, tolerance
zero); MSM results as affine points.  MNT6753's ops run the JAX side op by
op (tests/_torch_helpers.jax_stages_eager): its jitted group ops compile
for minutes at 753 bits on the CPU, and op by op they compute the same
values.
"""

import numpy as np

from zprize_wasm_msm_tpu.models import curves as ref_curves
from zprize_wasm_msm_tpu.ops.curve import group as ref_group
from zprize_wasm_msm_tpu.ops.msm import pippenger as ref_pippenger

import zprize_wasm_msm_tpu_torch as ZT
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.ops.curve import group
from zprize_wasm_msm_tpu_torch.ops.msm import pippenger
from zprize_wasm_msm_tpu_torch.utils.limbs import limbs_to_ints

from tests._torch_helpers import (
    affine_np, assert_same, jax_stages_eager, oracle_of, to_jax, to_torch, torch_np,
)


def curves_of(name):
    return getattr(ref_curves, name), getattr(port_curves, name)


def _cases(port, n):
    """Points P, Q with P = Q, P = -Q, identities and generic pairs."""
    oc = oracle_of(port)
    rng = np.random.default_rng(31)
    base = [oc.mul(oc.g, int(rng.integers(1, min(port.r, 1 << 62)))) for _ in range(n)]
    pts = base + [None, base[0], base[1], None]
    qts = base[1:] + base[:1] + [base[2], base[0], oc.neg(base[1]), None]
    return oc, pts, qts


def _port_affine(port, res):
    """Projective port points -> python affine points, Z inverted on the
    host (a plain Fermat ladder at 753 bits takes seconds on the CPU)."""
    fq = port.fq
    X, Y, Z = ([fq.from_mont_int(v) for v in limbs_to_ints(torch_np(c).reshape(fq.n_limbs, -1))]
               for c in res)
    out = []
    for x, y, z in zip(X, Y, Z):
        zi = pow(z, -1, fq.q) if z else 0
        out.append(None if z == 0 else (x * zi % fq.q, y * zi % fq.q))
    return out


def _ops(ref, port, pts, qts, ops=("add", "add_mixed", "double", "in_curve")):
    """{op: (port result, JAX result)} for add, add_mixed, double and
    in_curve on projective operands that are not lifted affine points."""
    PA, QA = affine_np(port, pts), affine_np(port, qts)
    tP = group.double(port, group.add(port, group.from_affine(port, to_torch(PA)),
                                      group.from_affine(port, to_torch(QA))))
    jP = to_jax(torch_np(tP))
    tQ = group.from_affine(port, to_torch(QA))
    calls = {
        "add": lambda: (group.add(port, tP, tQ),
                        ref_group.add(ref, jP, ref_group.from_affine(ref, to_jax(QA)))),
        "add_mixed": lambda: (group.add_mixed(port, tP, to_torch(QA)), ref_group.add_mixed(ref, jP, to_jax(QA))),
        "double": lambda: (group.double(port, tP), ref_group.double(ref, jP)),
        "in_curve": lambda: (group.in_curve(port, tP), ref_group.in_curve(ref, jP)),
    }
    return {op: calls[op]() for op in ops}


def test_toy_a_group_ops_match_reference_and_oracle():
    ref, port = curves_of("toy_a")
    oc, pts, qts = _cases(port, 6)
    with jax_stages_eager(ref_group):  # seconds, where its jits take ~18 s
        results = _ops(ref, port, pts, qts)
    for op, (got, want) in results.items():
        assert_same(got, want, op)
    p2 = [oc.double(oc.add(p, q)) for p, q in zip(pts, qts)]
    assert _port_affine(port, results["add"][0]) == [oc.add(p, q) for p, q in zip(p2, qts)]
    assert _port_affine(port, results["add_mixed"][0]) == [oc.add(p, q) for p, q in zip(p2, qts)]
    assert _port_affine(port, results["double"][0]) == [oc.double(p) for p in p2]
    assert bool(results["in_curve"][0].all())
    # a point off the curve
    off = (to_torch(affine_np(port, pts[:1])[0]), to_torch(affine_np(port, pts[1:2])[1]))
    assert not bool(group.in_curve(port, group.from_affine(port, off)).any())


def test_toy_a_plain_msm_matches_reference_and_oracle():
    """ctx.msm on a general-a curve: resolve_config picks the plain engine
    (on any device), against the JAX package's jnp MSM, the oracle and
    msm_legacy; the plain engine's lane tree in parts of one bucket (a
    budget of one byte) gives the same point and the same bucket sums."""
    ref, port = curves_of("toy_a")
    oc, pts, _ = _cases(port, 10)
    pts = [p for p in pts if p is not None]
    rng = np.random.default_rng(32)
    ks = [int(rng.integers(0, port.r)) for _ in pts[:-2]] + [0, port.r - 1]
    ctx = ZT.build_curve(port, device="cpu")
    P, k = ctx.points_to_device(pts), ctx.scalars_to_device(ks)
    want = oc.msm(pts, ks)
    assert pippenger.resolve_config(port, len(pts), 16, None, None, 2 << 30, "auto", device="cuda")[0] == "plain"
    assert ctx.result_to_affine(ctx.msm(P, k)) == want
    assert ctx.result_to_affine(ctx.msm_legacy(P, k)) == want
    jres = ref_pippenger.msm(ref, to_jax(torch_np(P)), to_jax(torch_np(k)), c=4, impl="xla")
    assert _port_affine(port, tuple(to_torch(np.asarray(c))[:, None] for c in jres)) == [want]
    # the lane tree's adds in parts of one bucket (a budget of a byte): the
    # same point
    assert ctx.result_to_affine(ctx.msm(P, k, c=3, lanes=4, mem_budget_bytes=1)) == want
    buckets = pippenger._bucket_sweep_plain(port, P, pippenger.windows.signed_window_digits(k, 3, 16), 2, 3)
    assert_same(pippenger._lane_tree_reduce(port, buckets, 1), pippenger._lane_tree_reduce(port, buckets))


def test_mnt6753_group_ops_match_reference():
    """MNT6753 G1 (a = 11): add and double on a few points (P = Q, P = -Q,
    identities among them), bit for bit against the JAX package's functions
    run op by op, and against the oracle.  (Its mixed add and in_curve run
    on the card, chip_smoke.py's mnt6753 phase, against the oracle.)"""
    ref, port = curves_of("mnt6753")
    oc, pts, qts = _cases(port, 3)
    with jax_stages_eager(ref_group):
        results = _ops(ref, port, pts, qts, ("add", "double"))
    for op, (got, want) in results.items():
        assert_same(got, want, op)
    p2 = [oc.double(oc.add(p, q)) for p, q in zip(pts, qts)]
    assert _port_affine(port, results["add"][0]) == [oc.add(p, q) for p, q in zip(p2, qts)]
    assert _port_affine(port, results["double"][0]) == [oc.double(p) for p in p2]
