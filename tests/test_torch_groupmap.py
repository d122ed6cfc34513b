"""PyTorch port: the SvdW group map (ops/curve/groupmap.py, ctx.group_map)
on MNT6753 G1 against the JAX package's group_map and the host SvdW of its
own tests (tests/test_groupmap.py _svdw_host), the same four field elements
through all three, limbs bit for bit (tolerance zero), every output on the
curve.

The JAX package's square root and inversion compile for minutes at 753
bits on the CPU (their loops fused); they run here op by op
(tests/_torch_helpers.jax_stages_eager: their loops as Python loops, each
field op one small jit), which computes the same values.
"""

import numpy as np
import torch

from zprize_wasm_msm_tpu.models import curves as ref_curves
from zprize_wasm_msm_tpu.ops.curve import groupmap as ref_groupmap
from zprize_wasm_msm_tpu.ops.field import mont as ref_mont

import zprize_wasm_msm_tpu_torch as ZT
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.ops.curve import groupmap
from zprize_wasm_msm_tpu_torch.utils.limbs import limbs_to_ints

from tests._torch_helpers import assert_same, jax_stages_eager, mont_limbs, to_jax, to_torch, torch_np
from tests.test_groupmap import _svdw_host


def test_group_map_mnt6753_matches_reference_and_host():
    ref, port = ref_curves.mnt6753, port_curves.mnt6753
    fq, q = port.fq, port.q
    rng = np.random.default_rng(41)
    ts = [1, 2, int.from_bytes(rng.bytes(100), "little") % q, q - 3]
    T = mont_limbs(fq, ts)
    ctx = ZT.build_curve(port, device="cpu")
    got = ctx.group_map(to_torch(T))
    with jax_stages_eager(functions=[(ref_mont, n) for n in ("sqrt", "inverse", "exp_const")]):
        want = ref_groupmap.group_map(ref, to_jax(T))
    assert_same(got, want)
    svdw = groupmap._SVDW[q]
    assert (svdw.conic_c, svdw.proj_z) == (ref_groupmap._SVDW[q].conic_c, ref_groupmap._SVDW[q].proj_z)
    xs, ys = ([fq.from_mont_int(v) for v in limbs_to_ints(torch_np(c))] for c in got[:2])
    for t, x, y in zip(ts, xs, ys):
        assert (x, y) == _svdw_host(q, port.a, port.b, svdw.conic_c, svdw.proj_z, t), t
    assert bool(ctx.in_curve(got).all())
    assert torch.equal(got[2], port.field.one((len(ts),)))  # Z = 1
