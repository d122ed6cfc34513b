"""Curve context: the package's user-facing API object.

Counterpart of the reference's protoboard (wasmcurves/index.js:26-29
exports buildBn128/buildBls12381/buildF1m, each returning an instantiated
WASM module whose exports are methods).  A ``CurveContext`` bundles a
CurveSpec with a device and bound methods over limb-tensor batches.

The device is explicit.  ``device=None`` means the card: it resolves to
``torch.device("cuda")`` and raises if there is none; nothing here decides
on its own to run on the CPU.  Pass ``device="cpu"`` to do so.

The surface is the JAX package's CurveContext, MNT6753 (general a, Fq3
coordinates, its ate pairing and group map) included.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.curve import group
from ..ops.curve.spec import CurveSpec
from ..ops.field import batch
from ..ops.msm import glv as glv_mod
from ..ops.msm import pippenger
from ..utils.limbs import ints_to_limbs


def resolve_device(device) -> torch.device:
    """None -> the card (raises without one); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: this package runs on the card unless the "
                "caller passes device='cpu'"
            )
        return torch.device("cuda")
    return torch.device(device)


@dataclass
class CurveContext:
    spec: CurveSpec
    device: torch.device

    # ---- marshalling (role of pb.set/pb.get) -----------------------------

    def _limbs(self, ints, n_limbs) -> torch.Tensor:
        return torch.as_tensor(
            ints_to_limbs(ints, n_limbs).astype(np.int64), device=self.device
        )

    def _coords(self, vals) -> torch.Tensor:
        """Host coordinates (standard domain) -> (EL, n) Montgomery limbs:
        ints for ext=1, (c0, c1) pairs for ext=2, (c0, c1, c2) triples for
        ext=3 (component 0's limbs, then component 1's, ..., the flat layout
        of tower.Fq2 / Fq3)."""
        fq = self.spec.fq
        if self.spec.ext == 1:
            return self._limbs([fq.to_mont_int(v) for v in vals], fq.n_limbs)
        return torch.cat(
            [
                self._limbs([fq.to_mont_int(v[k]) for v in vals], fq.n_limbs)
                for k in range(self.spec.ext)
            ]
        )

    def _zero_coord(self):
        return 0 if self.spec.ext == 1 else (0,) * self.spec.ext

    def points_to_device(self, pts: Sequence[Optional[Tuple]]):
        """Affine python points (None = infinity) -> Montgomery limb batch.

        Coordinates are ints for ext=1, (c0, c1) tuples for ext=2 and
        (c0, c1, c2) tuples for ext=3, as the JAX package's points_to_device
        takes them."""
        zero = self._zero_coord()
        xs = [zero if p is None else p[0] for p in pts]
        ys = [zero if p is None else p[1] for p in pts]
        return (self._coords(xs), self._coords(ys))

    def scalars_to_device(self, ks: Sequence[int]) -> torch.Tensor:
        fr = self.spec.fr
        return self._limbs([k % (1 << fr.n_limbs * 16) for k in ks], fr.n_limbs)

    def result_to_affine(self, res) -> Optional[Tuple]:
        """Projective device point -> python affine (None = infinity);
        coordinates are component tuples over an extension.  Z is inverted
        once (over Fq2 through its norm, over Fq3 through its cofactors, by
        the Fq inversion: tower.Fq2, tower.Fq3)."""
        F = self.spec.field
        r = tuple(c[:, None] if c.ndim == 1 else c for c in res)
        x, y = group.to_affine(self.spec, r)
        xi = F.to_host(x)[0]
        yi = F.to_host(y)[0]
        zero = self._zero_coord()
        return None if (xi == zero and yi == zero) else (xi, yi)

    # ---- MSM (the reference's g1m_multiexp_multiExp) ---------------------

    def msm(
        self,
        points,
        scalars,
        c: Optional[int] = None,
        use_glv: Optional[bool] = None,
        **kw,
    ):
        """points: (X, Y) device batch; scalars: device limb batch.

        Applies GLV preprocessing when the curve supports it (the
        composition the reference leaves to the caller,
        build_glv.js preprocessEndomorphism + multiExp): 2N points,
        half-width scalars digitised at glv.MAX_BITS bits.
        """
        spec = self.spec
        max_bits = kw.pop("max_bits", None)
        if use_glv is None:
            use_glv = spec.glv is not None
        if use_glv and spec.glv is not None:
            points, scalars = glv_mod.preprocess_endomorphism(spec, points, scalars)
            max_bits = glv_mod.MAX_BITS
        return pippenger.msm(spec, points, scalars, c=c, max_bits=max_bits, **kw)

    def msm_host(self, pts, ks, **kw) -> Optional[Tuple[int, int]]:
        """Convenience end-to-end host API: python points/ints in, out."""
        P = self.points_to_device(pts)
        s = self.scalars_to_device(ks)
        return self.result_to_affine(self.msm(P, s, **kw))

    def msm_legacy(self, points, scalars, max_bits=None):
        """The reference's second engine (g1m_multiexpAffine_wasmcurve,
        build_multiexp.js:251), a differential oracle for msm()
        (test/batchAffine.js:1258-1301): a per-point double-and-add and a
        tree sum (ops.msm.naive) that shares no pipeline stage with the
        bucket engines, so a fault in a shared stage cannot cancel out of
        the comparison.  Plain PyTorch on the points' device."""
        from ..ops.msm.naive import msm_naive

        return msm_naive(self.spec, points, scalars, max_bits=max_bits)

    # ---- group-op parity surface (build_curve_jacobian_a0.js exports) -----

    def add(self, p, q):
        return group.add(self.spec, p, q)

    def add_mixed(self, p, q):
        return group.add_mixed(self.spec, p, q)

    def double(self, p):
        return group.double(self.spec, p)

    def neg(self, p):
        return group.neg(self.spec, p)

    def sub(self, p, q):
        return group.sub(self.spec, p, q)

    def eq(self, p, q):
        return group.eq(self.spec, p, q)

    def is_zero(self, p):
        return group.is_zero(self.spec, p)

    def in_curve(self, p):
        return group.in_curve(self.spec, p)

    def in_group_affine(self, P):
        """Subgroup membership on an affine batch (ref g1m/g2m_inGroupAffine,
        build_bls12381.js:1376-1556): an (N,) bool tensor.  BLS curves only
        (needs bls_x)."""
        from ..ops.pairing import ingroup

        spec = self.spec
        if spec.bls_x is None:
            raise ValueError(f"{spec.name}: no BLS parameter, no subgroup check")
        if spec.ext == 1:
            return ingroup.g1_in_group(spec, spec.bls_x, P)
        return ingroup.g2_in_group(spec, spec.bls_x, P)

    def in_group(self, p):
        """Subgroup check on a projective batch (ref g1m_inGroup)."""
        return self.in_group_affine(group.to_affine(self.spec, p))

    # ---- pairing surface (ref g1m/g2m pairing exports per assembly:
    # build_bls12381.js:1592-1615, bn128 :1368, mnt6753 :1345) -------------

    @property
    def _pairing(self):
        """(module, spec) for this curve family's pairing."""
        name = self.spec.name
        if name.startswith("bls12_381"):
            from ..ops.pairing import bls12

            return bls12, bls12.get_bls12_381_spec()
        if name.startswith("bn254") or name == "bn128":
            from ..ops.pairing import bn

            return bn, bn.get_bn254_spec()
        if name.startswith("toy_bn"):
            from ..ops.pairing import bn

            return bn, bn.get_toy_bn_spec()
        if name.startswith("mnt6753"):
            from ..ops.pairing import mnt6

            return mnt6, mnt6.get_mnt6753_spec()
        raise NotImplementedError(f"no pairing for curve {name}")

    def pairing(self, P, Q):
        """e(P, Q) batched: P affine G1 batch, Q affine G2 batch."""
        mod, spec = self._pairing
        return mod.pairing(spec, P, Q)

    def pairing_eq(self, Ps, Qs):
        """prod_i e(P_i, Q_i) == 1 (the reference's pairingEq1-5): a 0-dim
        bool tensor on the points' device."""
        mod, spec = self._pairing
        return mod.pairing_eq(spec, Ps, Qs)

    def miller_loop(self, P, Q):
        mod, spec = self._pairing
        return mod.miller_loop(spec, P, Q)

    def final_exponentiation(self, f):
        mod, spec = self._pairing
        return mod.final_exponentiation(spec, f)

    def times_scalar(self, points, scalars):
        return group.times_scalar(self.spec, points, scalars)

    def group_map(self, T):
        """SvdW hash-to-curve (ref mnt6753 g1m_groupMap,
        build_mnt6753.js:1362-1490).  T: (L, N) Montgomery field batch ->
        projective point batch.  MNT6753 G1 (curves with registered SvdW
        constants) only."""
        from ..ops.curve import groupmap

        return groupmap.group_map(self.spec, T)

    def field_exp(self, a, e):
        """Runtime-exponent field exponentiation (ref f1m_exp,
        build_timesscalar.js wired at build_f1m.js:1375-1384): a and e are
        batches on the device, e as int64 16-bit limbs, an exponent a lane."""
        if self.spec.ext != 1:
            raise ValueError(f"{self.spec.name}: field_exp is a base-field op")
        from ..ops.field import mont

        return mont.exp(self.spec.fq, a, e)

    def to_affine(self, p):
        """normalize / batchToAffine (ref :940-1128) — batched by nature."""
        return group.to_affine(self.spec, p)

    batch_to_affine = to_affine

    # ---- batched field ops (ref f1m_batch*, build_f1m.js:1351-1357) -------
    # Montgomery domain.  The multiplicative ones run the mont_mul /
    # mont_square CUDA kernels for tensors on the card (ops.field.batch).

    def batch_mul(self, a, b):
        return batch.batch_mul(self.spec.fq, a, b)

    def batch_square(self, a):
        return batch.batch_square(self.spec.fq, a)

    def batch_add(self, a, b):
        return batch.batch_add(self.spec.fq, a, b)

    def batch_sub(self, a, b):
        return batch.batch_sub(self.spec.fq, a, b)

    def batch_neg(self, a):
        return batch.batch_neg(self.spec.fq, a)

    def batch_inverse(self, a):
        return batch.batch_inverse(self.spec.fq, a)

    def batch_to_mont(self, a):
        return batch.batch_to_mont(self.spec.fq, a)

    def batch_from_mont(self, a):
        return batch.batch_from_mont(self.spec.fq, a)

    # ---- serialization (ref LEMtoU/LEMtoC/UtoLEM/CtoLEM + batch*) ---------
    # bytes are numpy arrays on the host; points land on this context's device

    def to_uncompressed(self, X, Y):
        from ..utils import serde

        return serde.points_to_uncompressed(self.spec, X, Y)

    def from_uncompressed(self, raw):
        from ..utils import serde

        return serde.points_from_uncompressed(self.spec, raw, self.device)

    def to_compressed(self, X, Y):
        from ..utils import serde

        return serde.points_to_compressed(self.spec, X, Y)

    def from_compressed(self, raw):
        from ..utils import serde

        return serde.points_from_compressed(self.spec, raw, self.device)

    # ---- FFT over Fr (ref frm_fft/ifft, build_bls12381.js:43) -------------
    # The stages' products run the mont_mul kernel for tensors on the card.

    def fft(self, x, inverse: bool = False, impl: str = "auto"):
        from ..ops.poly import fft as fft_mod

        return fft_mod.fft(self.spec.fr, x, inverse, impl)

    def ifft(self, x, impl: str = "auto"):
        from ..ops.poly import fft as fft_mod

        return fft_mod.ifft(self.spec.fr, x, impl)

    def group_fft(self, p, inverse: bool = False):
        from ..ops.poly import fft as fft_mod

        return fft_mod.group_fft(self.spec, p, inverse)

    @property
    def g1(self):
        return group.generator(self.spec, (), self.device)

    @property
    def fq(self):
        return self.spec.fq

    @property
    def fr(self):
        return self.spec.fr


def build_curve(spec: CurveSpec, device=None) -> CurveContext:
    return CurveContext(spec, resolve_device(device))
