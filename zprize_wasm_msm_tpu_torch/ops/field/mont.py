"""Vectorized Montgomery prime-field arithmetic on 16-bit limb tensors.

Counterpart of the reference's Montgomery field layer
(wasmcurves/src/build_f1m.js — add:71, sub:91, mul:466 CIOS, square:779,
inverse:1112, batchInverse via build_batchinverse.js) in plain PyTorch.

Representation
--------------
A batch of field elements is ONE ``torch.int64`` tensor of shape
``(L, *batch)`` — limbs first, batch last, little-endian 16-bit limbs, every
limb in [0, 2^16), value canonical (< q), Montgomery radix R = 2^(16 L).
int64 (not uint32) because PyTorch has no add / shift / compare for
``torch.uint32`` on the CPU, and because a signed 64-bit lane lets every
intermediate stay un-normalized until ONE carry pass at the end:

  * a 16x16 product is < 2^32 and a column of the schoolbook product
    collects at most 2L of them plus the reduction's 2L: < 2^40 for L <= 48;
  * differences are formed limb-wise as signed values and the same carry
    pass (arithmetic shift = floor division) resolves borrows.

These functions are the plain version of the field core.  They run on any
device a tensor lies on; the CUDA kernels (csrc/field.cuh) compute the same
canonical values on 32-bit words, and are held against these bit for bit.
Limb loops are Python loops: there is no trace or compile step.  Every
op pays one launch per loop step on the card, so the loops are kept short
(_resolve walks limb pairs).

Fields of _WIDE_FROM limbs or more (MNT6753's 753-bit Fq and Fr, 48 limbs)
take a wide form on every device, where the loops over limbs would be
longest: the product is one convolution (_conv), the Montgomery reduction
two products by constants (_mont_reduce_wide) and the carry pass a fixed
number of whole-tensor steps (_resolve_parallel), all in parts of large
batches (_in_parts).  The same words; fewer launches, more bytes.  Every
narrower field keeps the row form above.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...utils.bigint import int_to_limbs
from .spec import LIMB_BITS, LIMB_MASK, FieldSpec

I64 = torch.int64


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _limb_const(spec: FieldSpec, name: str, device: torch.device) -> torch.Tensor:
    """(L,) int64 device copy of one of the spec's limb constants (cached:
    every add/sub/mul needs q, and a fresh host->device copy per call would
    dominate small batches on the card)."""
    return torch.as_tensor(getattr(spec, name).astype(np.int64), device=device)


def _col(t: torch.Tensor, ndim_batch: int) -> torch.Tensor:
    """(K,) -> (K, 1, ..., 1) broadcastable against (K, *batch)."""
    return t.reshape(t.shape + (1,) * ndim_batch)


@functools.lru_cache(maxsize=None)
def _q_col(spec: FieldSpec, device: torch.device, ndim_batch: int) -> torch.Tensor:
    return _col(_limb_const(spec, "q_limbs", device), ndim_batch)


def _q(spec: FieldSpec, like: torch.Tensor) -> torch.Tensor:
    """q's limbs as an (L, 1, ..., 1) column beside ``like`` (cached: every
    add / sub needs it, and a view is a host dispatch too)."""
    return _q_col(spec, like.device, like.ndim - 1)


def zeros(spec: FieldSpec, batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros((spec.n_limbs,) + tuple(batch_shape), dtype=I64, device=device)


@functools.lru_cache(maxsize=256)
def _int_const(spec: FieldSpec, value: int, device: torch.device) -> torch.Tensor:
    """(L,) int64 device limbs of a host integer (cached like _limb_const:
    the curve constant 3b enters every group op)."""
    return torch.as_tensor(
        int_to_limbs(value, spec.n_limbs).astype(np.int64), device=device
    )


def _device(device) -> torch.device:
    return torch.device("cpu") if device is None else torch.device(device)


def _broadcast(limbs: torch.Tensor, batch_shape) -> torch.Tensor:
    return _col(limbs, len(batch_shape)).expand(
        limbs.shape + tuple(batch_shape)
    ).contiguous()


def full_const(spec: FieldSpec, value: int, batch_shape=(), device=None) -> torch.Tensor:
    """Broadcast a host integer (already in the desired domain) to a batch."""
    return _broadcast(_int_const(spec, int(value), _device(device)), batch_shape)


def one_mont(spec: FieldSpec, batch_shape=(), device=None) -> torch.Tensor:
    return _broadcast(
        _limb_const(spec, "one_mont_limbs", _device(device)), batch_shape
    )


def _resolve_serial(x: torch.Tensor):
    """Carry-resolve a redundant SIGNED (K, *batch) limb tensor, |limbs| < 2^46,
    in place (x is overwritten; callers pass a temporary).

    Returns (canonical limbs in [0, 2^16), carry_out).  ``>>`` on int64 is an
    arithmetic shift, so a negative limb propagates a borrow (carry -1); a
    final carry_out of -1 means the value was negative.  The serial pass runs
    over pairs of limbs as 32-bit digits (x_2j + 2^16 x_2j+1 < 2^62): two
    launches a pair (the carry in, the carry out; the digits are masked to
    32 bits once, after the pass) where a pass over limbs takes four a limb.
    Eager PyTorch pays per launch, and this pass is most of the launches of
    every field op.
    """
    K, P = x.shape[0], x.shape[0] // 2
    even, odd = x[0 : 2 * P : 2], x[1 : 2 * P : 2]
    even.add_(odd, alpha=1 << LIMB_BITS)
    carry = None
    for j in range(P):
        if carry is not None:
            even[j].add_(carry)
        carry = even[j] >> (2 * LIMB_BITS)
    even.bitwise_and_(0xFFFFFFFF)
    torch.bitwise_right_shift(even, LIMB_BITS, out=odd)
    even.bitwise_and_(LIMB_MASK)
    if K % 2:
        s = x[K - 1] if carry is None else x[K - 1] + carry
        carry = s >> LIMB_BITS
        torch.bitwise_and(s, LIMB_MASK, out=x[K - 1])
    return x, carry


#: limbs from which the field core takes its wide form (module docstring):
#: MNT6753's 48-limb fields and their 49- to 97-limb accumulators; the
#: widest other field has 24 limbs and accumulators of up to 26
_WIDE_FROM = 41

#: bytes of temporaries a wide op allocates at once: _in_parts takes larger
#: batches (the plain MSM engine's lane tree, 10^5 to 10^7 elements) in parts
_PART_BYTES = 4 << 30


def _in_parts(fn, *xs, per_element: int):
    """fn over the flattened batch of (K_i, *batch) tensors (batch shapes
    broadcast), in parts of at most _PART_BYTES // per_element elements
    where the batch is larger (``per_element``: fn's temporaries an
    element), each part's result written into the whole result as it comes;
    fn returns a tensor or a tuple of (K, *batch) / (*batch) tensors."""
    batch = tuple(torch.broadcast_shapes(*(x.shape[1:] for x in xs)))
    n = int(np.prod(batch)) if batch else 1
    step = max(1, _PART_BYTES // per_element)
    if n <= step:
        return fn(*xs)
    flat = [x.expand((x.shape[0],) + batch).reshape(x.shape[0], n) for x in xs]
    outs = None
    for s in range(0, n, step):
        part = fn(*(f[:, s : s + step] for f in flat))
        part = part if isinstance(part, tuple) else (part,)
        if outs is None:
            outs = [torch.empty(p.shape[:-1] + (n,), dtype=p.dtype, device=p.device) for p in part]
        for o, p in zip(outs, part):
            o[..., s : s + step] = p
    outs = [o.reshape(o.shape[:-1] + batch) for o in outs]
    return tuple(outs) if len(outs) > 1 else outs[0]


@functools.lru_cache(maxsize=None)
def _resolve_consts(K: int, bits: int, device: torch.device, nb: int):
    """(bias, limb index, zero, passes) of _resolve_parallel for K limbs below
    2^bits in size: the bias 2^(bits+1) on limb 0, 2^(bits+1) - 2^(bits-15)
    on the limbs above and -2^(bits-15) on the carry slot sums to zero and
    makes every limb non-negative and below 2^(bits+2); ``passes``
    normalising passes bring limbs below B to [0, 2^16] (each leaves them
    below 2^16 + B / 2^16)."""
    e = bits + 1
    bias = torch.full((K,), (1 << e) - (1 << (e - LIMB_BITS)), dtype=I64)
    bias[0] = 1 << e
    passes, bound = 0, 1 << (bits + 2)
    while bound > 1 << LIMB_BITS:
        bound, passes = LIMB_MASK + ((bound - 1) >> LIMB_BITS), passes + 1
    index = torch.arange(K, dtype=I64)
    zero = torch.zeros((), dtype=I64, device=device)
    return _col(bias, nb).to(device), _col(index, nb).to(device), zero, passes


def _resolve_parallel(x: torch.Tensor, bits: int = 46):
    """Carry-resolve a redundant SIGNED (K, *batch) limb tensor whose limbs
    lie in (-2^bits, 2^bits), bits >= 16.

    Returns (canonical limbs in [0, 2^16), carry_out): the value is the
    limbs' plus carry_out 2^(16 K), so a carry_out of -1 means the value was
    negative.  A fixed number of whole-tensor steps, whatever K (eager
    PyTorch pays per launch, and this pass is in every field op):
      1. a bias that sums to zero makes every limb non-negative;
      2. normalising passes (each limb keeps its low 16 bits and adds the
         bits above them of the limb below: two for sums of canonical limbs,
         three below 2^46) leave every limb in [0, 2^16], with the carries
         out of the top limb in a carry slot;
      3. a carry then leaves limb i iff the nearest limb j <= i that is not
         2^16 - 1 (a limb that passes a carry on) is 2^16 (a limb that makes
         one): a running maximum of the indices of such limbs and a gather.
    """
    K = x.shape[0]
    bias, index, zero, passes = _resolve_consts(K, bits, x.device, x.ndim - 1)
    y = torch.empty((K + 1,) + tuple(x.shape[1:]), dtype=I64, device=x.device)
    lo, above, top = y[:K], y[1:], y[K]
    torch.add(x, bias, out=lo)
    top.fill_(-(1 << (bits + 1 - LIMB_BITS)))
    for _ in range(passes):
        c = lo >> LIMB_BITS
        lo.bitwise_and_(LIMB_MASK)
        above.add_(c)
    # lo in [0, 2^16]: the nearest limb j <= i that does not pass a carry on
    # (limb 0 where every limb up to i passes one on: it is 2^16 - 1 then,
    # so it makes no carry, as none enters it)
    last = torch.where(lo != LIMB_MASK, index, zero).cummax(0).values
    above.add_(lo.gather(0, last) == 1 << LIMB_BITS)
    lo.bitwise_and_(LIMB_MASK)
    return lo, top


def _resolve(x: torch.Tensor, bits: int = 46):
    """Carry-resolve a redundant SIGNED (K, *batch) limb tensor whose limbs
    lie in (-2^bits, 2^bits), bits <= 46; x is a temporary (it may be
    overwritten).  Returns (canonical limbs in [0, 2^16), carry_out): the
    value is the limbs' plus carry_out 2^(16 K), so a carry_out of -1 means
    the value was negative.  Below _WIDE_FROM limbs the serial pass, from
    it the parallel pass (in parts of large batches): the same words."""
    if x.shape[0] >= _WIDE_FROM:
        return _in_parts(lambda t: _resolve_parallel(t, bits), x, per_element=48 * (x.shape[0] + 1))
    return _resolve_serial(x)


def _resolve_pair(x: torch.Tensor, y: torch.Tensor, bits: int = 46):
    """Resolve two same-shape redundant values in ONE carry pass (half the
    op count of two passes): returns (x_limbs, x_carry, y_limbs, y_carry)."""
    out, carry = _resolve(torch.stack([x, y], dim=1), bits)
    return out[:, 0], carry[0], out[:, 1], carry[1]


def _select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask is a boolean batch-shaped tensor; select limb-vectors a else b."""
    return torch.where(mask[None], a, b)


# ---------------------------------------------------------------------------
# add / sub / neg (ref build_f1m.js:71-105)
# ---------------------------------------------------------------------------


#: bits of the limbs of sums and differences of two canonical values and q
_SUM_BITS = 18


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod q, operands canonical < q."""
    s = a + b
    sl, _, dl, borrow = _resolve_pair(s, s - _q(spec, s), _SUM_BITS)
    return _select(borrow == 0, dl, sl)  # s >= q  <=>  no borrow


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod q, operands canonical < q."""
    d = a - b
    dl, borrow, tl, _ = _resolve_pair(d, d + _q(spec, d), _SUM_BITS)
    return _select(borrow != 0, tl, dl)


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """(-a) mod q = q - a, with -0 = 0 (ref build_f1m.js neg)."""
    d, _ = _resolve(_q(spec, a) - a, _SUM_BITS)
    return _select(is_zero(spec, a), torch.zeros_like(a), d)


def double(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return add(spec, a, a)


# ---------------------------------------------------------------------------
# Montgomery multiplication (ref build_f1m.js:466-777 CIOS; word size 16)
# ---------------------------------------------------------------------------


def _conv(a: torch.Tensor, b: torch.Tensor, out_len: int) -> torch.Tensor:
    """The schoolbook product's columns, out[k] = sum_{i+j=k} a_i b_j for
    k < out_len: (La, *batch) x (Lb, *batch) -> (out_len, *batch) int64,
    the batch shapes broadcast.  One outer product, written into a zero
    array row i shifted by i (a strided view), and a column sum: three
    launches whatever the widths, on La times the accumulator's bytes."""
    La, Lb = a.shape[0], b.shape[0]
    batch = tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
    W = max(La + Lb, out_len)
    n = int(np.prod(batch)) if batch else 1
    z = torch.zeros((La, W) + batch, dtype=I64, device=a.device)
    # element (i, j) of the outer product written at z[i, i + j]
    torch.mul(a.reshape((La, 1) + tuple(a.shape[1:])), b.reshape((1, Lb) + tuple(b.shape[1:])),
              out=z.as_strided((La, Lb) + batch, ((W + 1) * n, n) + z.stride()[2:]))
    return z[:, :out_len].sum(0)


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^{-1} mod q.  Operands canonical < q.

    Row-wise schoolbook product into a redundant int64 accumulator, then the
    word-serial Montgomery reduction (L rounds, each clearing one low limb
    with an m*q row update), one carry pass, one conditional subtract.  From
    _WIDE_FROM limbs the product is one convolution (_conv) and the
    reduction _mont_reduce_wide, in parts of large batches.
    a and b must have the same number of batch axes (they broadcast).
    """
    L = spec.n_limbs
    if L >= _WIDE_FROM:
        return _in_parts(lambda x, y: _mont_reduce(spec, _conv(x, y, 2 * L + 1)), a, b,
                         per_element=8 * L * (2 * L + 1))
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    acc = torch.zeros((2 * L + 1,) + tuple(batch), dtype=I64, device=a.device)
    for i in range(L):
        acc[i : i + L].addcmul_(a[i], b)
    return _mont_reduce(spec, acc)


def _mont_reduce(spec: FieldSpec, acc: torch.Tensor) -> torch.Tensor:
    """acc * R^{-1} mod q from a redundant (2L+1, *batch) int64 accumulator
    (limbs below ~2^40), updated in place: L rounds, each clearing one low
    limb with an m*q row update, one carry pass, one conditional subtract.
    Canonical when acc < q R (a product of canonical operands is).  From
    _WIDE_FROM limbs _mont_reduce_wide."""
    L = spec.n_limbs
    if L >= _WIDE_FROM:
        return _mont_reduce_wide(spec, acc)
    qv = _q(spec, acc)
    np16 = spec.np16
    for i in range(L):
        # m depends on acc[i] mod 2^16 only; int64 wraparound cannot occur
        # (acc < 2^40, np16 < 2^16)
        m = (acc[i] * np16) & LIMB_MASK
        acc[i : i + L].addcmul_(m, qv)
        # acc[i] is now == 0 mod 2^16: push its carry up and retire it
        acc[i + 1].add_(acc[i] >> LIMB_BITS)
    res = acc[L : 2 * L + 1]  # value < 2q -> L+1 limbs
    qpad = torch.cat([qv, torch.zeros_like(qv[:1])], dim=0)
    sl, _, dl, borrow = _resolve_pair(res, res - qpad)
    return _select(borrow == 0, dl, sl)[:L]


@functools.lru_cache(maxsize=None)
def _toeplitz(spec: FieldSpec, value: int, rows: int, device: torch.device) -> torch.Tensor:
    """(rows, L) float64 matrix T with T[k, i] = c_{k-i} (0 for k - i
    outside [0, L)), c the 16-bit limbs of ``value``: T @ x is the first
    ``rows`` columns of the schoolbook product of x's limbs with c's."""
    L = spec.n_limbs
    c = int_to_limbs(value, L).astype(np.float64)
    t = np.zeros((rows, L))
    for i in range(L):
        n = min(L, rows - i)
        if n > 0:
            t[i : i + n, i] = c[:n]
    return torch.as_tensor(t, device=device)


@functools.lru_cache(maxsize=None)
def _neg_q_inv(spec: FieldSpec) -> int:
    """-q^{-1} mod R."""
    return pow(-spec.q, -1, spec.R)


def _const_product(spec: FieldSpec, value: int, x: torch.Tensor, rows: int) -> torch.Tensor:
    """The first ``rows`` columns of the schoolbook product of x's limbs
    (L, *batch) with a constant's, as int64: one float64 matrix product,
    exact while every column sum stays below 2^53 (callers keep x's limbs
    below 2^31: L = 48 such products sum below 2^53)."""
    L = spec.n_limbs
    t = _toeplitz(spec, value, rows, x.device)
    out = t @ x.reshape(L, -1).to(torch.float64)
    return out.to(I64).reshape((rows,) + tuple(x.shape[1:]))


def _mont_reduce_wide(spec: FieldSpec, acc: torch.Tensor) -> torch.Tensor:
    """acc * R^{-1} mod q from a redundant (2L+1, *batch) int64 accumulator
    (limbs below ~2^40), acc a temporary.  Montgomery's reduction on whole
    numbers, not row by row (eager PyTorch pays per launch, and the row
    form is L rounds of several launches): m = (acc mod R) (-q^{-1}) mod R is
    one product by a constant (acc's low limbs after one normalising pass,
    so below 2^25), carried, its carry out dropped; acc + m q (another) is
    0 mod R, and its top L + 1 limbs, carried, are acc R^{-1} mod q plus 0
    or q: the same carry pass on it less q R says which.  Canonical when
    acc < q R (a product of canonical operands is)."""
    L = spec.n_limbs
    lo = acc[:L].clone()
    c = lo >> LIMB_BITS
    lo.bitwise_and_(LIMB_MASK)
    lo[1:].add_(c[:-1])  # the carry out of limb L - 1 is a multiple of R
    m, _ = _resolve(_const_product(spec, _neg_q_inv(spec), lo, L))
    acc[: 2 * L].add_(_const_product(spec, spec.q, m, 2 * L))
    u = torch.stack([acc, acc], dim=1)
    u[L : 2 * L, 1].sub_(_q(spec, acc))
    limbs, carry = _resolve(u, 41)  # acc below 2^39 a limb, m q's columns below 2^38
    # u / R < 2q: L + 1 limbs; borrow iff u / R < q
    return _select(carry[1] == 0, limbs[L : 2 * L, 1], limbs[L : 2 * L, 0])


def mont_square(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery squaring (same canonical value as mont_mul(a, a))."""
    return mont_mul(spec, a, a)


def reduce_redundant(spec: FieldSpec, acc: torch.Tensor) -> torch.Tensor:
    """Reduce a redundant multi-limb accumulator to a canonical element.

    acc: (K, *batch) int64, K <= 2L, whose limbs may hold up to
    ~2^26 (the raw sum of up to 2^10 canonical elements), read in the same
    domain as its summands (Montgomery in, Montgomery out).  Returns
    acc mod q as canonical (L, *batch) limbs: one Montgomery reduction
    (acc R^{-1}) and one product by R^2 mod q.  The sparse linear
    combinations of the polynomial layer sum in raw limbs and reduce once.
    """
    L = spec.n_limbs
    K = acc.shape[0]
    if K > 2 * L:
        raise ValueError(f"reduce_redundant: an accumulator of {K} limbs is wider than 2L = {2 * L}")
    wide = torch.zeros((2 * L + 1,) + tuple(acc.shape[1:]), dtype=I64, device=acc.device)
    wide[:K] = acc
    reduced = _mont_reduce(spec, wide)
    return mont_mul(spec, reduced, _col(_limb_const(spec, "r2_limbs", acc.device), acc.ndim - 1))


# ---------------------------------------------------------------------------
# domain conversion
# ---------------------------------------------------------------------------


def to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a -> a*R mod q (ref build_f1m.js:1089)."""
    r2 = _col(_limb_const(spec, "r2_limbs", a.device), a.ndim - 1)
    return mont_mul(spec, a, r2)


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a -> a*R^{-1} mod q (ref build_f1m.js:1100) — multiply by 1."""
    one = torch.zeros((spec.n_limbs,) + (1,) * (a.ndim - 1), dtype=I64, device=a.device)
    one[0] = 1
    return mont_mul(spec, a, one)


# ---------------------------------------------------------------------------
# predicates
# ---------------------------------------------------------------------------


def is_zero(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=0)


def eq(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def sign(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Sign convention of the reference (build_f1m.js sign:135): 0 for zero,
    -1 if the standard-domain value is > (q-1)/2, else +1; int32, batch
    shaped.  a is Montgomery."""
    std = from_mont(spec, a)
    half_plus1 = _col(_int_const(spec, (spec.q - 1) // 2 + 1, a.device), a.ndim - 1)
    _, borrow = _resolve(std - half_plus1, _SUM_BITS)  # -1 iff std < (q+1)/2
    out = torch.where(borrow == 0, -1, 1).to(torch.int32)
    return torch.where(is_zero(spec, a), 0, out)


def is_negative(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """build_f1m.js isNegative:120 — True iff sign == -1."""
    return sign(spec, a) == -1


# ---------------------------------------------------------------------------
# exponentiation / inverse
# ---------------------------------------------------------------------------


def exp_const(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a host-known exponent, a in Montgomery form.

    MSB-first square-and-multiply (ref build_timesscalar.js).  The exponent
    is known on the host, so the multiply is simply skipped on zero bits.
    """
    if e == 0:
        return one_mont(spec, a.shape[1:], a.device)
    acc = a  # the top bit is always 1
    for i in range(e.bit_length() - 2, -1, -1):
        acc = mont_square(spec, acc)
        if (e >> i) & 1:
            acc = mont_mul(spec, acc, a)
    return acc


def exp(spec: FieldSpec, a: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """a^e for exponents on the device, one a lane (the reference's runtime
    f1m_exp, build_timesscalar.js wired at build_f1m.js:1375-1384).

    a: (L, *batch) Montgomery; e: (Le, *batch) int64 16-bit limbs, standard
    domain, little-endian.  MSB-first square-and-multiply over all Le*16
    bits, branch-free (the product is selected per lane).
    """
    acc = one_mont(spec, a.shape[1:], a.device)
    for limb in range(e.shape[0] - 1, -1, -1):
        for bit in range(15, -1, -1):
            acc = mont_square(spec, acc)
            acc = _select(((e[limb] >> bit) & 1) == 1, mont_mul(spec, acc, a), acc)
    return acc


def inverse(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a^{-1} in Montgomery form via Fermat: a^(q-2).  Returns 0 for 0."""
    return exp_const(spec, a, spec.q - 2)


def sqrt(spec: FieldSpec, a: torch.Tensor):
    """Square root in Montgomery form (Tonelli-Shanks, ref
    build_f1m.js:1147-1215).  Returns (root, has_root mask).

    For q = 3 (mod 4) this is one exponentiation a^((q+1)/4); otherwise the
    fixed-bound Tonelli-Shanks loop with masks.  Where a has no root, the
    root returned is whatever the loop leaves (the mask says so).
    """
    if spec.q % 4 == 3:
        r = exp_const(spec, a, (spec.q + 1) // 4)
    else:
        r = _tonelli_shanks(spec, a)
    return r, eq(spec, mont_square(spec, r), a) | is_zero(spec, a)


def _tonelli_shanks(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Fixed-bound, branch-free Tonelli-Shanks (ref build_f1m.js:1147-1215).

    Classic loop state (x, w, c, m); every data-dependent inner loop runs to
    the static bound s with masks, so all lanes run the same code.  j, m
    and m - j - 1 are 32-bit unsigned values, as in the JAX package, so a
    non-residue gives the same (meaningless) root there and here.
    """
    s, t, q = spec.sqrt_s, spec.sqrt_t, spec.q
    batch, dev = a.shape[1:], a.device
    # generator of the 2-Sylow subgroup, precomputed as the reference does
    c = full_const(spec, spec.to_mont_int(pow(spec.nqr, t, q)), batch, dev)
    x = exp_const(spec, a, (t + 1) // 2)
    w = exp_const(spec, a, t)
    one = one_mont(spec, batch, dev)
    m = torch.full(tuple(batch), s, dtype=I64, device=dev)
    for _ in range(s):
        done = eq(spec, w, one)
        # j = least j with w^(2^j) == 1, by a masked chain of squarings
        wj, j, found = w, torch.zeros_like(m), eq(spec, w, one)
        for _k in range(s):
            not_found = ~found
            wj = _select(not_found, mont_square(spec, wj), wj)
            j = j + not_found.to(I64)
            found = found | eq(spec, wj, one)
        # b = c^(2^(m-j-1)) by masked repeated squaring
        b = c
        nsq = (m - j - 1) & 0xFFFFFFFF  # valid only where ~done (j < m there)
        for k in range(s):
            b = _select((k < nsq) & ~done, mont_square(spec, b), b)
        b2 = mont_square(spec, b)
        x = _select(~done, mont_mul(spec, x, b), x)
        w = _select(~done, mont_mul(spec, w, b2), w)
        c = _select(~done, b2, c)
        m = torch.where(done, m, j)
    return x


# ---------------------------------------------------------------------------
# batch inverse (Montgomery's trick, ref build_batchinverse.js)
# ---------------------------------------------------------------------------


def batch_inverse(spec: FieldSpec, a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Elementwise inverse of a batch with ONE field inversion.

    Montgomery's trick as a product tree: log2(n) levels of pairwise
    products up, one inversion of the root, and the mirrored pass down (each
    node's inverse times its sibling's product).  The root is a single
    element and goes through ops.field.kernels.inverse: one kernel launch
    for a tensor on the card, the plain Fermat ladder for a CPU tensor.
    3 n multiplies in 3 log2(n) batched calls — eager PyTorch pays per call, not per
    element, so the tree replaces the reference's 2 sqrt(n)-step blocked
    scan.  Zeros pass through as 0.  Every inverse is the unique canonical
    value, so the result does not depend on the association order.

    ``axis`` is accepted for API parity; elements are inverted independently.
    """
    del axis
    L = spec.n_limbs
    z = is_zero(spec, a)
    batch_shape = a.shape[1:]
    a1 = _select(z, one_mont(spec, batch_shape, a.device), a)
    n = int(np.prod(batch_shape)) if batch_shape else 1
    size = 1 << max(0, (n - 1).bit_length())
    flat = a1.reshape(L, n)
    if size != n:
        flat = torch.cat([flat, one_mont(spec, (size - n,), a.device)], dim=1)

    levels = [flat]
    while levels[-1].shape[1] > 1:
        cur = levels[-1]
        levels.append(mont_mul(spec, cur[:, 0::2], cur[:, 1::2]))
    from . import kernels  # kernels imports this module

    inv = kernels.inverse(spec, levels[-1])  # (L, 1)
    for cur in reversed(levels[:-1]):
        m = cur.shape[1] // 2
        siblings = cur.reshape(L, m, 2).flip(2)
        inv = mont_mul(spec, siblings, inv[:, :, None]).reshape(L, 2 * m)

    inv = inv[:, :n].reshape((L,) + tuple(batch_shape))
    return _select(z, torch.zeros_like(a), inv)
