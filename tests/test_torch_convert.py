"""PyTorch port: what is carried across from the JAX package — arrays
(utils.convert) and the curve / field constants of the port's own spec
copies — and the isolation of the port from jax."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from zprize_wasm_msm_tpu.models import curves as ref_curves
from zprize_wasm_msm_tpu_torch import _build
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.utils import convert
from zprize_wasm_msm_tpu_torch.utils.bigint import limbs_to_int, mod_inv

from tests._torch_helpers import field_operands, mont_limbs


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", sorted(ref_curves.CURVES))
def test_spec_constants_equal_reference(name):
    ref, port = ref_curves.CURVES[name], port_curves.CURVES[name]
    for attr in ("name", "q", "r", "a", "b", "gx", "gy", "ext", "nr", "bls_x", "b3"):
        assert getattr(ref, attr) == getattr(port, attr), attr
    assert (ref.glv is None) == (port.glv is None)
    if ref.glv is not None:
        for attr in ("beta", "lam", "u0", "u1", "v0", "v1"):
            assert getattr(ref.glv, attr) == getattr(port.glv, attr), attr
    for fname in ("fq", "fr"):
        rf, pf = getattr(ref, fname), getattr(port, fname)
        assert (rf.q, rf.bits, rf.n_limbs, rf.np16) == (pf.q, pf.bits, pf.n_limbs, pf.np16)
        for attr in ("q_limbs", "r2_limbs", "one_mont_limbs", "zero_limbs"):
            assert _same(getattr(rf, attr), getattr(pf, attr)), (fname, attr)
        # the 32-bit-word constants only the port has, against a host recomputation
        assert pf.n_words * 2 == pf.n_limbs
        assert pf.np32 == (-mod_inv(pf.q, 1 << 32)) % (1 << 32)
        assert (pf.q * pf.np32 + 1) % (1 << 32) == 0
        assert pf.np32 & 0xFFFF == pf.np16
        assert limbs_to_int(pf.q_words, 32) == pf.q
        assert limbs_to_int(pf.one_mont_words, 32) == (1 << (32 * pf.n_words)) % pf.q
    assert ref.b3_flat_limbs == port.b3_flat_limbs
    assert _same(ref.beta_mont_limbs, port.beta_mont_limbs)
    if ref.ext == 1:
        assert _same(ref.b3_mont_limbs, port.b3_mont_limbs)
        assert _same(ref.b_mont_limbs, port.b_mont_limbs)


def test_toy_curves_equal_reference():
    for name in ("toy", "toy_a", "toy_g2", "toy_g3", "toy_fft"):
        ref, port = getattr(ref_curves, name), getattr(port_curves, name)
        assert (ref.q, ref.r, ref.a, ref.b, ref.gx, ref.gy, ref.ext) == (
            port.q, port.r, port.a, port.b, port.gx, port.gy, port.ext)


@pytest.mark.parametrize("name", ["toy", "bn254", "bls12_381", "bls12_377"])
def test_kernel_constant_block(name):
    """The block the CUDA entry points receive: q, R mod q, 3b*R as 32-bit
    words (padded to 12 each), then np32."""
    curve = port_curves.CURVES.get(name) or getattr(port_curves, name)
    fq = curve.fq
    block = _build.curve_consts(curve)
    assert block.dtype == np.uint32 and block.shape == (37,)
    nw = fq.n_words
    assert limbs_to_int(block[0:12], 32) == fq.q
    assert limbs_to_int(block[12:24], 32) == fq.R_mod_q
    assert limbs_to_int(block[24:36], 32) == fq.to_mont_int(3 * curve.b)
    assert not block[nw:12].any() and int(block[36]) == fq.np32


def test_kernel_constant_block_refuses_unported_fields():
    for curve in (port_curves.bls12_381_g2, port_curves.mnt6753, port_curves.toy_a):
        with pytest.raises(NotImplementedError):
            _build.curve_consts(curve)


def test_reference_arrays_round_trip():
    fq = port_curves.bls12_381.fq
    a, _ = field_operands(fq.q, 10, seed=1)
    limbs = mont_limbs(fq, a)  # (24, N) uint32, as the JAX package holds them
    t = convert.from_reference(limbs)
    assert t.dtype == torch.int64 and t.shape == limbs.shape
    back = convert.to_reference(t)
    assert back.dtype == np.uint32 and np.array_equal(back, limbs)
    digits = np.arange(-6, 6, dtype=np.int32).reshape(3, 4)
    td = convert.from_reference(digits)
    assert td.dtype == torch.int32 and np.array_equal(convert.to_reference(td), digits)
    triple = convert.from_reference((limbs, limbs, limbs))
    assert isinstance(triple, tuple) and len(triple) == 3
    assert all(np.array_equal(x, limbs) for x in convert.to_reference(triple))
    with pytest.raises(TypeError):
        convert.from_reference(np.zeros(3, dtype=np.float32))
    with pytest.raises(ValueError):
        convert.to_reference(torch.tensor([1 << 16]))


def test_word_packing_is_the_same_integer():
    """pack_words is the JAX package's pl_bucket._pack16: word j = limb 2j |
    limb 2j+1 << 16 — the same little-endian integer; unpack inverts it."""
    from zprize_wasm_msm_tpu.ops.msm.pl_bucket import _pack16

    fq = port_curves.bls12_381.fq
    a, _ = field_operands(fq.q, 10, seed=2)
    limbs = mont_limbs(fq, a)
    words = convert.pack_words(convert.from_reference(limbs))
    assert words.dtype == torch.int32 and words.shape == (12, limbs.shape[1])
    as_u32 = words.numpy().view(np.uint32)
    assert np.array_equal(as_u32, np.asarray(_pack16(limbs)))
    for j, v in enumerate(a):
        assert limbs_to_int(as_u32[:, j], 32) == fq.to_mont_int(v)
    assert np.array_equal(convert.to_reference(convert.unpack_words(words)), limbs)
    batch3 = convert.from_reference(limbs[:, :12].reshape(24, 3, 4))
    assert torch.equal(convert.unpack_words(convert.pack_words(batch3)), batch3)


def test_point_packing_matches_word_packing():
    """_launch.pack_point (int32 views of the limbs, written in place) gives
    pack_words' words for every coordinate: limbs of all ones, batch axes,
    non-contiguous coordinates, a single element."""
    from zprize_wasm_msm_tpu_torch.ops.msm import _launch

    rng = np.random.default_rng(5)
    y = torch.as_tensor(rng.integers(0, 1 << 16, size=(24, 8, 12)), dtype=torch.int64)
    y[:, 0, :2] = 0xFFFF  # in both x and y[:, :, ::2]
    x = y[:, :, 1::2]  # (24, 8, 6), not contiguous
    for coords in ((x,), (x, x.contiguous(), y[:, :, ::2].permute(0, 2, 1)), (x[:, 3, 2],)):
        got = _launch.pack_point(coords)
        want = torch.stack([convert.pack_words(c.reshape(24, -1)) for c in coords])
        assert got.dtype == torch.int32 and got.is_contiguous()
        assert [torch.equal(g, w) for g, w in zip(got, want)] == [True] * len(coords)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys; import zprize_wasm_msm_tpu_torch as Z; "
        "import zprize_wasm_msm_tpu_torch.ops.msm.pl_bucket, zprize_wasm_msm_tpu_torch.ops.msm.pl_reduce, "
        "zprize_wasm_msm_tpu_torch.ops.curve.device_check, zprize_wasm_msm_tpu_torch.utils.convert, "
        "zprize_wasm_msm_tpu_torch.ops.msm.pl_sorted, zprize_wasm_msm_tpu_torch.ops.msm.glv, "
        "zprize_wasm_msm_tpu_torch.ops.field.batch, zprize_wasm_msm_tpu_torch.ops.field.intops, "
        "zprize_wasm_msm_tpu_torch.ops.field.kernels, zprize_wasm_msm_tpu_torch.oracle; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'zprize_wasm_msm_tpu' or m.startswith('zprize_wasm_msm_tpu.')]; "
        "assert not bad, bad; print('clean')"
    )
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=root, timeout=120
    )
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr
