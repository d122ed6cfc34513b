"""zprize_wasm_msm_tpu_torch — the multi-scalar-multiplication framework in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port, module for module, of the JAX package ``zprize_wasm_msm_tpu`` (the
capabilities of the ZPrize WASM MSM library, Manta-Network/zprize-wasm-msm).
It imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of the
JAX package; host-side modules it needs (field/curve specs, curve registry,
oracle, bigint/limb helpers) are its own copies.

What is here: the BLS12-381 / BLS12-377 / BN254 G1 and G2 MSM end to end —
field core, multi-limb integers and batched field ops (ops.field), complete
projective group law for a = 0 and any a over Fq, Fq2 and Fq3 (ops.curve),
GLV endomorphism split and signed-window Pippenger with a bucket-sweep
engine and a sorted large-window engine (ops.msm), CUDA kernels for the
Montgomery product and square (MNT6753's 753-bit fields included), the
field inversion, the bucket sweep, lane reduction, collapse, finish, sorted
sweep and segmented scan (csrc/) —, the Groth16 stack (ops.poly, the
BLS12, BN and MNT6 pairings and subgroup checks in ops.pairing,
models.groth16), the SvdW group map, and the CurveContext API (models).

Limb representation (decided once, for the whole package)
---------------------------------------------------------
  * Public layout = the JAX package's: a field element batch is
    ``(L, *batch)``, little-endian 16-bit limbs, limb axis first, Montgomery
    radix R = 2^(16 L) with L a multiple of 4 (BLS12-381 Fq L=24, Fr L=16,
    the toy field L=4).  Tests compare like with like.
  * dtype = ``torch.int64``: PyTorch has no add / shift / compare for
    uint32 on the CPU, int32 overflows on a 16x16-bit product, and a signed
    64-bit lane lets the plain arithmetic defer every carry and borrow to
    one pass (ops.field.mont).  Digits are int32.
  * The CUDA kernels see packed 32-bit words, ``NW = L/2`` per element:
    the same integer in the same Montgomery form (utils.convert.pack_words),
    with ``np32 = -q^{-1} mod 2^32`` from the port's FieldSpec.

Devices: entry points take ``device``; ``None`` means the card and raises
without one, ``"cpu"`` is for the tests.  A kernel wrapper launches its
kernel for a CUDA tensor and uses its plain PyTorch version only because a
tensor lies on the CPU.

Public API mirrors the reference's index.js:26-29 exports.
"""

from .models import curves as _curves
from .models.context import CurveContext, build_curve


def build_bls12381(device=None) -> CurveContext:
    """Analog of the reference's buildBls12381 (index.js:27)."""
    return build_curve(_curves.bls12_381, device)


def build_bls12377(device=None) -> CurveContext:
    """The ZPrize curve (not in the reference)."""
    return build_curve(_curves.bls12_377, device)


def build_bn128(device=None) -> CurveContext:
    """Analog of the reference's buildBn128 (index.js:26); BN254."""
    return build_curve(_curves.bn254, device)


build_bn254 = build_bn128


def build_f1m(q: int):
    """Analog of the reference's buildF1m (index.js:28): a standalone
    Montgomery field spec usable with ops.field.mont."""
    from .ops.field.spec import field_spec

    return field_spec(q)


__all__ = [
    "CurveContext",
    "build_curve",
    "build_bls12381",
    "build_bls12377",
    "build_bn128",
    "build_bn254",
    "build_f1m",
]
