"""PyTorch port: the polynomial helpers — pol.construct_lc, the QAP helpers,
applykey and the Pedersen hash — bit for bit against the JAX package (group
results in affine), and construct_lc above the JAX package's 2^10-term bound
against the oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zprize_wasm_msm_tpu.models import curves as ref_curves
from zprize_wasm_msm_tpu.ops.curve import group as ref_group
from zprize_wasm_msm_tpu.ops.poly import applykey as ref_applykey
from zprize_wasm_msm_tpu.ops.poly import pedersen as ref_pedersen
from zprize_wasm_msm_tpu.ops.poly import pol as ref_pol
from zprize_wasm_msm_tpu.ops.poly import qap as ref_qap
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.ops.curve import group
from zprize_wasm_msm_tpu_torch.ops.poly import applykey, pedersen, pol, qap
from zprize_wasm_msm_tpu_torch.utils.limbs import ints_to_limbs, limbs_to_ints

from tests._torch_helpers import assert_same, mont_limbs, oracle_of, to_jax, to_torch

FR = {
    "toy_fft": (ref_curves.toy_fft.fr, port_curves.toy_fft.fr),
    "bls12_381": (ref_curves.bls12_381.fr, port_curves.bls12_381.fr),
}


def _values(spec, n, rng):
    return [int.from_bytes(rng.bytes(40), "little") % spec.q for _ in range(n)]


def _std(spec, t):
    return [spec.from_mont_int(v) for v in limbs_to_ints(t.numpy().astype(np.uint32))]


@pytest.mark.parametrize("field,nnz,n_out", [("bls12_381", 37, 8), ("toy_fft", 200, 5),
                                             ("bls12_381", 1 << 10, 1)])
def test_construct_lc_matches_jax(field, nnz, n_out):
    """Up to 2^10 terms an output (the last case: exactly 2^10 into one
    slot), where the JAX package's raw u32 sums are exact."""
    ref_spec, spec = FR[field]
    rng = np.random.default_rng(nnz)
    pos = rng.integers(0, n_out, size=nnz).astype(np.int32)
    coefs = mont_limbs(spec, _values(spec, nnz, rng))
    sigs = mont_limbs(spec, _values(spec, nnz, rng))
    got = pol.construct_lc(spec, to_torch(coefs), torch.as_tensor(pos), to_torch(sigs), n_out)
    want = ref_pol.construct_lc(ref_spec, to_jax(coefs), jnp.asarray(pos), to_jax(sigs), n_out)
    assert_same(got, want)


def test_construct_lc_above_2_10_terms_matches_oracle():
    """3 000 terms into two slots (and 40 into a third): above the bound of
    the JAX package's raw u32 sums, the port carries its int64 limb sums and
    gives the oracle's answer."""
    _, spec = FR["bls12_381"]
    r = spec.q
    rng = np.random.default_rng(5)
    pos = np.concatenate([np.zeros(3000), np.ones(3000), np.full(40, 2)]).astype(np.int64)
    rng.shuffle(pos)
    nnz = pos.size
    # every coefficient and signal near q: the limb sums are as large as they get
    coefs = [r - 1 - int(v) for v in rng.integers(0, 1 << 20, size=nnz)]
    sigs = [r - 1 - int(v) for v in rng.integers(0, 1 << 20, size=nnz)]
    got = pol.construct_lc(spec, to_torch(mont_limbs(spec, coefs)), torch.as_tensor(pos),
                           to_torch(mont_limbs(spec, sigs)), 3)
    want = [0, 0, 0]
    for p, c, s in zip(pos, coefs, sigs):
        want[p] = (want[p] + c * s) % r
    assert _std(spec, got) == want


def test_scatter_sum_carries_every_limb():
    """pol.scatter_sum of 2^20 copies of the largest canonical limbs (q - 1,
    read as Montgomery form) into one slot, against the oracle: limb sums
    near 2^36, carried through every limb before the one reduction."""
    for _, spec in FR.values():
        n = 1 << 20
        vals = to_torch(ints_to_limbs([spec.q - 1], spec.n_limbs)).expand(-1, n)
        got = pol.scatter_sum(spec, vals, torch.zeros(n, dtype=torch.int64), 1)
        assert _std(spec, got) == [spec.from_mont_int(n * (spec.q - 1) % spec.q)]


@pytest.mark.parametrize("field", ["toy_fft", "bls12_381"])
def test_qap_helpers_match_jax(field):
    """build_abc (A and B records into constraints), mul_ab, join_abc and
    batch_add on the same records."""
    ref_spec, spec = FR[field]
    rng = np.random.default_rng(23)
    nnz, m = 60, 7
    mat = rng.integers(0, 2, size=nnz).astype(np.int32)
    con = rng.integers(0, m, size=nnz).astype(np.int32)
    coefs = mont_limbs(spec, _values(spec, nnz, rng))
    wit = mont_limbs(spec, _values(spec, nnz, rng))
    c = mont_limbs(spec, _values(spec, m, rng))
    A, B = qap.build_abc(spec, torch.as_tensor(mat), torch.as_tensor(con), to_torch(coefs),
                         to_torch(wit), m)
    rA, rB = ref_qap.build_abc(ref_spec, jnp.asarray(mat), jnp.asarray(con), to_jax(coefs),
                               to_jax(wit), m)
    assert_same((A, B), (rA, rB))
    assert_same(qap.mul_ab(spec, A, B), ref_qap.mul_ab(ref_spec, rA, rB))
    assert_same(qap.join_abc(spec, A, B, to_torch(c)), ref_qap.join_abc(ref_spec, rA, rB, to_jax(c)))
    assert_same(qap.batch_add(spec, A, B), ref_qap.batch_add(ref_spec, rA, rB))


@pytest.mark.parametrize("field,n", [("toy_fft", 11), ("bls12_381", 11), ("bls12_381", 64)])
def test_batch_apply_key_fr_matches_jax(field, n):
    ref_spec, spec = FR[field]
    rng = np.random.default_rng(n)
    vec = mont_limbs(spec, _values(spec, n, rng))
    fi = mont_limbs(spec, _values(spec, 2, rng))
    got = applykey.batch_apply_key_fr(spec, to_torch(vec), to_torch(fi[:, 0]), to_torch(fi[:, 1]))
    want = ref_applykey.batch_apply_key_fr(ref_spec, to_jax(vec), to_jax(fi[:, 0]), to_jax(fi[:, 1]))
    assert_same(got, want)


def test_batch_apply_key_group_matches_jax_in_affine():
    ref_curve, curve = ref_curves.toy_fft, port_curves.toy_fft
    fr = curve.fr
    n = 6
    fi = mont_limbs(fr, [5, 3])
    got = applykey.batch_apply_key_group(curve, group.generator(curve, (n,)),
                                         to_torch(fi[:, 0]), to_torch(fi[:, 1]))
    want = ref_applykey.batch_apply_key_group(ref_curve, ref_group.generator(ref_curve, (n,)),
                                              to_jax(fi[:, 0]), to_jax(fi[:, 1]))
    assert_same(group.to_affine(curve, got), ref_group.to_affine(ref_curve, want))


@pytest.mark.parametrize("nbits,N,chunk", [(20, 3, 4), (31, 8, 2)])
def test_pedersen_matches_jax(nbits, N, chunk):
    """make_base_table's table and pedersen_hash's points (affine) on the toy
    curve: message lengths padded to whole windows, a new base every chunk
    windows, the last base reused past the table."""
    ref_curve, curve = ref_curves.toy, port_curves.toy
    oc = oracle_of(curve)
    bases = [oc.mul(oc.g, k) for k in (1, 7, 11)]
    table = pedersen.make_base_table(curve, bases)
    ref_table = ref_pedersen.make_base_table(ref_curve, bases)
    assert_same(table, ref_table)
    bits = np.random.default_rng(nbits).integers(0, 2, size=(nbits, N)).astype(np.uint32)
    got = pedersen.pedersen_hash(curve, torch.as_tensor(bits.astype(np.int64)), table, chunk_size=chunk)
    want = ref_pedersen.pedersen_hash(ref_curve, jnp.asarray(bits), ref_table, chunk_size=chunk)
    assert_same(group.to_affine(curve, got), ref_group.to_affine(ref_curve, want))
