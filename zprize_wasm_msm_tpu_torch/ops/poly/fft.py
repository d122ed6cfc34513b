"""Radix-2 FFT/NTT over Fr (and over group elements).

Port of zprize_wasm_msm_tpu/ops/poly/fft.py, the counterpart of the
reference's FFT layer (wasmcurves/src/build_fft.js — _rawfft:247,
__reversePermutation:518, __fftFinal:396, inverse + scaling; generic over
"G acted on by Fr" via opGtimesF, wired for frm/g1m/g2m at
build_bls12381.js:43,80-86).

Shape: iterative decimation-in-frequency butterflies over a dense (L, N)
Montgomery batch.  Each stage is one add, one sub and one Montgomery
product over the whole array, then one bit-reversal gather
(``index_select``).  Twiddle tables are host-precomputed per (N, root) and
kept on the device they were first asked for.

Every Montgomery product over a whole batch goes through
``ops.field.kernels.mont_mul`` with ``impl`` ("auto" by default): the
mont_mul CUDA kernel for a tensor on the card, the plain ``mont.mont_mul``
for a tensor on the CPU.  Both give the same canonical limbs.  The
kernel takes a ``b`` of ``a``'s shape or one element, so a stage's
twiddles are expanded along the block axis before the call.  The sums and
differences are the plain ``mont.add`` / ``mont.sub``.

All Fr values are Montgomery-form limb tensors ((L, N) int64).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..curve import group
from ..curve.spec import CurveSpec
from ..field import kernels, mont
from ..field.spec import FieldSpec
from ...utils.bigint import mod_inv
from ...utils.limbs import ints_to_limbs


def _mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """A product over a whole batch: b has a's shape or is one element."""
    return kernels.mont_mul(spec, a, b, impl)


@functools.lru_cache(maxsize=None)
def _smallest_nonresidue(q: int) -> int:
    """Smallest quadratic nonresidue mod q (codegen-time search, as the
    reference bakes in — build_fft.js / build_f1m.js share the same loop)."""
    g = 2
    while pow(g, (q - 1) // 2, q) == 1:
        g += 1
    return g


@functools.lru_cache(maxsize=None)
def _root_of_unity(r: int, n: int) -> int:
    """Primitive n-th root of unity in Fr (n a power of two)."""
    assert (r - 1) % n == 0, f"no {n}-th root of unity mod {r}"
    # smallest generator of the 2-Sylow subgroup, as the reference bakes in
    return pow(_smallest_nonresidue(r), (r - 1) // n, r)


@functools.lru_cache(maxsize=None)
def _twiddle_table(spec_q: int, n_limbs: int, n: int, inverse: bool):
    """(L, n//2) Montgomery twiddles w^0..w^(n/2-1), host-precomputed."""
    r = spec_q
    w = _root_of_unity(r, n)
    if inverse:
        w = mod_inv(w, r)
    R = 1 << (16 * n_limbs)
    vals, cur = [], 1
    for _ in range(n // 2):
        vals.append(cur * R % r)
        cur = cur * w % r
    return np.asarray(ints_to_limbs(vals, n_limbs))


@functools.lru_cache(maxsize=8)
def _twiddles_on(spec_q: int, n_limbs: int, n: int, inverse: bool, device: torch.device):
    """The twiddle table as an int64 tensor on ``device`` (one copy per
    device, not one per call)."""
    table = _twiddle_table(spec_q, n_limbs, n, inverse)
    return torch.as_tensor(table.astype(np.int64), device=device)


@functools.lru_cache(maxsize=None)
def _bitrev_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int32)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@functools.lru_cache(maxsize=8)
def _bitrev_on(n: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_bitrev_perm(n).astype(np.int64), device=device)


def _fft_stages(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor, impl: str = "auto"):
    """DIF butterfly stages; output bit-reversed order.  x: (L, N)."""
    L, N = x.shape
    stages = N.bit_length() - 1
    for s in range(stages):
        m = N >> s  # block size this stage
        blocks = N // m
        xv = x.reshape(L, blocks, m)
        a = xv[:, :, : m // 2]
        b = xv[:, :, m // 2 :]
        top = mont.add(spec, a, b)
        diff = mont.sub(spec, a, b)
        # twiddles w^(j * blocks), j = 0..m/2-1  == strided slice of the
        # table, the same for every block
        twd = tw[:, ::blocks][:, None, :].expand(L, blocks, m // 2)
        bot = _mul(spec, diff, twd, impl)
        x = torch.cat([top, bot], dim=2).reshape(L, N)
    return x


def fft(spec: FieldSpec, x: torch.Tensor, inverse: bool = False, impl: str = "auto") -> torch.Tensor:
    """NTT over Fr: (L, N) Montgomery batch -> (L, N), natural order.

    inverse=True gives the unscaled inverse; ifft() applies the 1/N scale
    (ref __fftFinal:396).  ``impl`` routes the stages' products ("auto",
    "kernel" or "plain", as ops.field.kernels.mont_mul takes it).
    """
    L, N = x.shape
    assert N & (N - 1) == 0, "FFT size must be a power of two"
    if N == 1:
        return x
    tw = _twiddles_on(spec.q, spec.n_limbs, N, inverse, x.device)
    y = _fft_stages(spec, x, tw, impl)
    return torch.index_select(y, 1, _bitrev_on(N, x.device))


def ifft(spec: FieldSpec, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Inverse NTT with 1/N scaling (ref build_fft.js ifft + __fftFinal)."""
    L, N = x.shape
    y = fft(spec, x, inverse=True, impl=impl)
    n_inv = _mont_scalar(spec, mod_inv(N, spec.q), x.device)
    return _mul(spec, y, n_inv[:, None], impl)


# ---------------------------------------------------------------------------
# snarkjs composite helpers (ref build_fft.js fftJoin:657, fftMix:1114,
# fftFinal:1238) — chunked-FFT building blocks over Fr
# ---------------------------------------------------------------------------


def _geometric_table(spec: FieldSpec, first: torch.Tensor, inc: torch.Tensor, n: int):
    """(L, n) Montgomery [first, first*inc, ...] — log-depth doubling."""
    p = first[:, None]
    step = inc
    while p.shape[1] < n:
        p = torch.cat([p, _mul(spec, p, step[:, None])], dim=1)
        step = _mul(spec, step, step)
    return p[:, :n]


def fft_join(spec: FieldSpec, buff1, buff2, first, inc):
    """(b1[i], b2[i]) <- (b1[i] + w_i*b2[i], b1[i] - w_i*b2[i]) with
    w_i = first * inc^i (ref fftJoin:657).  All (L, n) Montgomery;
    first/inc (L,)."""
    n = buff1.shape[1]
    w = _geometric_table(spec, first, inc, n)
    t = _mul(spec, buff2, w)
    return mont.add(spec, buff1, t), mont.sub(spec, buff1, t)


def fft_mix(spec: FieldSpec, buff, exp: int):
    """One in-place radix-2 DIT stage over groups of size 2^exp
    (ref fftMix:1114): within each group, butterfly pairs (j, j + 2^(exp-1))
    with twiddles (w_{2^exp})^j."""
    L, n = buff.shape
    m = 1 << exp
    groups = n // m
    half = m // 2
    w = _root_of_unity(spec.q, m)
    R = 1 << (16 * spec.n_limbs)
    vals, cur = [], 1
    for _ in range(half):
        vals.append(cur * R % spec.q)
        cur = cur * w % spec.q
    tw = torch.as_tensor(ints_to_limbs(vals, spec.n_limbs).astype(np.int64), device=buff.device)
    v = buff.reshape(L, groups, m)
    a = v[:, :, :half]
    b = _mul(spec, v[:, :, half:], tw[:, None, :].expand(L, groups, half))
    top = mont.add(spec, a, b)
    bot = mont.sub(spec, a, b)
    return torch.cat([top, bot], dim=2).reshape(L, n)


def fft_final(spec: FieldSpec, buff, factor):
    """Scale by factor (the 1/N of a chunked inverse FFT; ref fftFinal:1238
    also swaps halves of the bit-reversed layout — here layouts are natural
    order, so only the scale remains)."""
    return _mul(spec, buff, factor[:, None])


@functools.lru_cache(maxsize=None)
def _shift_consts(spec_q: int, total_bits: int):
    """(shiftToM, sConst) for the coset-extension helpers.

    The reference bakes these per totalBits at codegen
    (build_fft.js:80-87): shift = nr^2 with nr the smallest quadratic
    nonresidue, shiftToM = shift^(2^totalBits), sConst = 1/(1 - shiftToM).
    """
    q = spec_q
    shift = _smallest_nonresidue(q) ** 2 % q
    shift_to_m = pow(shift, 1 << total_bits, q)
    s_const = mod_inv((1 - shift_to_m) % q, q)
    return shift_to_m, s_const


def _mont_scalar(spec: FieldSpec, v: int, device) -> torch.Tensor:
    """(L,) Montgomery limbs of the host int v."""
    return mont.full_const(spec, spec.to_mont_int(v), (), device)


def fft_join_ext(spec: FieldSpec, buff1, buff2, first, inc, total_bits: int):
    """Coset-extension join (ref build_fft.js fftJoinExt:749).

    With w_i = first*inc^i and m = shift^(2^total_bits):
      b1[i] <- b1[i] + b2[i]
      b2[i] <- (b1[i] + m*b2[i]) * w_i
    All (L, n) Montgomery; first/inc (L,).  Returns (b1', b2').
    """
    n = buff1.shape[1]
    shift_to_m, _ = _shift_consts(spec.q, total_bits)
    m = _mont_scalar(spec, shift_to_m, buff1.device)[:, None]
    w = _geometric_table(spec, first, inc, n)
    u = mont.add(spec, buff1, buff2)
    t = mont.add(spec, buff1, _mul(spec, buff2, m))
    return u, _mul(spec, t, w)


def fft_join_ext_inv(spec: FieldSpec, buff1, buff2, first, inc, total_bits: int):
    """Inverse of fft_join_ext (ref buildFFTJoinExtInv, build_fft.js:859).

    With w_i = first*inc^i, m = shift^(2^total_bits), s = 1/(1-m):
      u     = b2[i] * w_i
      b2[i] <- (b1[i] - u) * s
      b1[i] <- (u - m*b1[i]) * s
    """
    n = buff1.shape[1]
    shift_to_m, s_const = _shift_consts(spec.q, total_bits)
    m = _mont_scalar(spec, shift_to_m, buff1.device)[:, None]
    s = _mont_scalar(spec, s_const, buff1.device)[:, None]
    w = _geometric_table(spec, first, inc, n)
    u = _mul(spec, buff2, w)
    b2 = _mul(spec, mont.sub(spec, buff1, u), s)
    b1m = _mul(spec, buff1, m)
    b1 = _mul(spec, mont.sub(spec, u, b1m), s)
    return b1, b2


def prepare_lagrange_evaluation(spec: FieldSpec, buff1, buff2, first, inc, total_bits: int):
    """Lagrange-evaluation preparation (ref buildPrepareLagrangeEvaluation,
    build_fft.js:991).

    With w_i = first*inc^i, m = shift^(2^total_bits), s = 1/(1-m):
      u     = b2[i] - m*b1[i]
      b2[i] <- (b1[i] - b2[i]) * w_i
      b1[i] <- u * s
    """
    n = buff1.shape[1]
    shift_to_m, s_const = _shift_consts(spec.q, total_bits)
    m = _mont_scalar(spec, shift_to_m, buff1.device)[:, None]
    s = _mont_scalar(spec, s_const, buff1.device)[:, None]
    w = _geometric_table(spec, first, inc, n)
    u = mont.sub(spec, buff2, _mul(spec, buff1, m))
    b2 = _mul(spec, mont.sub(spec, buff1, buff2), w)
    b1 = _mul(spec, u, s)
    return b1, b2


# ---------------------------------------------------------------------------
# group-valued FFT (ref: opGtimesF instantiation for g1m/g2m,
# build_bls12381.js:80-86) — butterflies over curve points, twiddle action
# is full scalar multiplication
# ---------------------------------------------------------------------------


def group_fft(curve: CurveSpec, p, inverse: bool = False):
    """FFT over group elements: p = (X, Y, Z) each (EL, N) projective.

    The Fr twiddle acts by scalar multiplication (the reference's
    opGtimesF), so each stage costs one batched times_scalar (plain group
    ops, a Python ladder over the Fr bits) — the same O(N log N * |Fr|) the
    reference pays.
    """
    fr = curve.fr
    X, _, _ = p
    N = X.shape[1]
    assert N & (N - 1) == 0
    if N == 1:
        return p
    stages = N.bit_length() - 1
    r = fr.q
    w = _root_of_unity(r, N)
    if inverse:
        w = mod_inv(w, r)
    # standard-domain twiddle exponents as scalar limb table (host)
    vals, cur = [], 1
    for _ in range(N // 2):
        vals.append(cur)
        cur = cur * w % r
    tw = torch.as_tensor(ints_to_limbs(vals, fr.n_limbs).astype(np.int64), device=X.device)

    x = p
    EL = X.shape[0]
    for s in range(stages):
        m = N >> s
        blocks = N // m
        xv = tuple(a.reshape(EL, blocks, m) for a in x)
        a = tuple(v[:, :, : m // 2] for v in xv)
        b = tuple(v[:, :, m // 2 :] for v in xv)
        top = group.add(curve, a, b)
        diff = group.sub(curve, a, b)
        twd = tw[:, ::blocks]  # (Ls, m//2)
        flat = tuple(v.reshape(EL, blocks * (m // 2)) for v in diff)
        ks = twd[:, None, :].expand(-1, blocks, -1).reshape(-1, blocks * (m // 2))
        bot = group.times_scalar(curve, flat, ks)
        bot = tuple(v.reshape(EL, blocks, m // 2) for v in bot)
        x = tuple(
            torch.cat([t, bo], dim=2).reshape(EL, N) for t, bo in zip(top, bot)
        )
    perm = _bitrev_on(N, X.device)
    return tuple(torch.index_select(v, 1, perm) for v in x)


def group_ifft(curve: CurveSpec, p):
    """Inverse group FFT with 1/N scalar scaling."""
    X, _, _ = p
    N = X.shape[1]
    y = group_fft(curve, p, inverse=True)
    fr = curve.fr
    n_inv = mod_inv(N, fr.q)
    k = torch.as_tensor(ints_to_limbs([n_inv], fr.n_limbs).astype(np.int64), device=X.device)
    return group.times_scalar(curve, y, k.expand(fr.n_limbs, N))
