"""PyTorch port, the collapse (K2) and the field inversion modelled on the
CPU as csrc/reduce.cu and csrc/field_kernels.cu run them.

K2 (collapse_kernel + combine_kernel, over Fq2 collapse2_kernel +
combine2_kernel): group G of lanes takes the run of m
buckets G m .. G m + m - 1 (m from pl_reduce._collapse_run), walks it from
the top bucket down (R += S_b, A += R), sets Rs = m R, and the groups of a
block of 128 lanes combine their runs in a tree, partners G ^ 1, G ^ 2, ...:
(A, Rs) + (A', Rs') of the upper run = (A + A' + Rs_upper, 2 (Rs + Rs')).
Where a window's runs span several blocks, each block's first group leaves
its pair and combine_kernel runs the same tree over the pairs, until one is
left per window.  collapse_schedule below runs that schedule group for
group on the port's plain group ops and is held, as affine points, against
the JAX package's pippenger.bucket_reduce, on toy and on toy_g2.

The inversion (field_inverse_kernel): a binary extended GCD of fixed
length (Pornin, IACR ePrint 2020/972): ceil((2 bits(q) - 1) / 31) outer
steps, each 31 iterations on 64-bit approximations of a and b, then the
matrix of signed factors applied to a, b (NW + 1 signed words, shifted by
31) and u, v (unsigned sums with q - u for a negative factor, one
Montgomery word reduction), and at the end one Montgomery product by
2^steps R^3 mod q.  inverse_model runs it word for word, asserting the
kernel's word bounds, and is held bit for bit against pow(x, -1, q) in
Montgomery form on the toy field, BN254 and BLS12-381, and against the JAX
package's mont.inverse on every element of the toy field.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from zprize_wasm_msm_tpu.ops.field import mont as ref_mont
from zprize_wasm_msm_tpu.ops.msm import pippenger as ref_pippenger
import zprize_wasm_msm_tpu_torch as ZT
from zprize_wasm_msm_tpu_torch import _build
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.ops.curve import group
from zprize_wasm_msm_tpu_torch.ops.field import kernels
from zprize_wasm_msm_tpu_torch.ops.msm import pl_reduce
from zprize_wasm_msm_tpu_torch.utils.limbs import ints_to_limbs, limbs_to_ints

from tests._torch_helpers import (
    CURVE_PAIRS, affine_np, host_points, oracle_of, random_points, to_jax, to_torch, torch_np,
)
from tests.test_torch_g2_sorted import G2, REF as REF_G2, _points as g2_points, oracle_of as g2_oracle_of
from tests.test_torch_g2_sorted import port_affine, ref_affine

NAMES = ["toy", "bn254", "bls12_381"]
M32 = (1 << 32) - 1
REF_TOY, TOY = CURVE_PAIRS["toy"]

# ---------------------------------------------------------------------------
# the field inversion
# ---------------------------------------------------------------------------


def _words(x, nw):
    return [(x >> (32 * j)) & M32 for j in range(nw)]


def _int(words):
    return sum(w << (32 * j) for j, w in enumerate(words))


def _int64(x):
    assert -(1 << 63) <= x < 1 << 63
    return x


def lin_shift(a, b, f, g, nw):
    """field_kernels.cu lin_shift: |f a + g b| / 2^31 and its sign."""
    t, c = [], 0
    for j in range(nw):
        s = _int64(a[j] * f + b[j] * g + c)
        t.append(s & M32)
        c = s >> 32
    t.append(c & M32)
    neg = M32 if c < 0 else 0
    carry, r = neg & 1, []
    for j in range(nw):
        w = (((t[j] >> 31) | (t[j + 1] << 1)) & M32) ^ neg
        s = w + carry
        r.append(s & M32)
        carry = s >> 32
    return r, neg != 0


def lin_mod(u, v, f, g, q, np32, nw):
    """field_kernels.cu lin_mod: (f u + g v) / 2^32 mod q, canonical."""
    uu = _words(q - _int(u), nw) if f < 0 else u
    vv = _words(q - _int(v), nw) if g < 0 else v
    fa, ga = abs(f), abs(g)
    c1 = c2 = m = 0
    t = [0] * nw
    qw = _words(q, nw)
    for j in range(nw):
        s1 = uu[j] * fa + vv[j] * ga + c1
        assert s1 < 1 << 64
        c1 = s1 >> 32
        tj = s1 & M32
        if j == 0:
            m = (tj * np32) & M32
        s2 = m * qw[j] + tj + c2
        assert s2 < 1 << 64
        c2 = s2 >> 32
        if j > 0:
            t[j - 1] = s2 & M32
    assert c1 + c2 <= M32
    t[nw - 1] = c1 + c2
    r = _int(t)
    assert r < 2 * q
    return _words(r - q if r >= q else r, nw)


def inverse_model(spec, x):
    """field_inverse_kernel on one stored word value x (< q): x^{-1} R^2 mod q
    (0 -> 0), with the kernel's words, approximations and steps.  Returns
    (result, b at the end, the first step after which a was 0)."""
    nw, q = spec.n_words, spec.q
    steps, fix = kernels.inverse_consts(spec)
    A, B = _words(x, nw), _words(q, nw)
    u, v = _words(1, nw), _words(0, nw)
    done = None
    for step in range(steps):
        top, topw = 0, A[0] | B[0]
        for j in range(1, nw):
            if A[j] | B[j]:
                top, topw = j, A[j] | B[j]
        length = max(32 * top + topw.bit_length(), 64)
        p = length - 33
        wi, sh = p >> 5, p & 31
        assert wi + 1 <= nw - 1
        at = ((((A[wi + 1] << 32) | A[wi]) >> sh) << 31) | (A[0] & ((1 << 31) - 1))
        bt = ((((B[wi + 1] << 32) | B[wi]) >> sh) << 31) | (B[0] & ((1 << 31) - 1))
        assert at < 1 << 64 and bt < 1 << 64
        f0, g0, f1, g1 = 1, 0, 0, 1
        for _ in range(kernels.GCD_INNER):
            odd = at & 1
            sw = odd and at < bt
            if sw:
                at, bt, f0, g0, f1, g1 = bt, at, f1, g1, f0, g0
            if odd:
                at, f0, g0 = at - bt, f0 - f1, g0 - g1
            at, f1, g1 = at >> 1, f1 * 2, g1 * 2
        assert abs(f0) + abs(g0) <= 1 << 31 and abs(f1) + abs(g1) <= 1 << 31
        An, neg = lin_shift(A, B, f0, g0, nw)
        if neg:
            f0, g0 = -f0, -g0
        Bn, neg = lin_shift(A, B, f1, g1, nw)
        if neg:
            f1, g1 = -f1, -g1
        u, v = lin_mod(u, v, f0, g0, q, spec.np32, nw), lin_mod(u, v, f1, g1, q, spec.np32, nw)
        A, B = An, Bn
        if done is None and _int(A) == 0:
            done = step
    R = 1 << (32 * nw)
    out = _int(v) * _int([int(w) for w in fix[:nw]]) * pow(R, -1, q) % q  # fe_mul(v, fix)
    return (0 if x == 0 else out), _int(B), done


def _fq(name):
    return getattr(port_curves, name).fq


def _edge_inputs(spec):
    q, R = spec.q, 1 << (32 * spec.n_words)
    vals = [0, 1, 2, q - 1, (q - 1) // 2, (q + 1) // 2, R % q, pow(R, -1, q)]
    return vals + [pow(2, k, q) for k in range(0, 32 * spec.n_words, 5)]


def _want(spec, x):
    R = 1 << (32 * spec.n_words)
    return 0 if x == 0 else pow(x, -1, spec.q) * R * R % spec.q


@pytest.mark.parametrize("name", NAMES)
def test_inverse_model_edge_and_random(name):
    """Edge values, powers of two and 300 seeded random values: the model
    equals x^{-1} R^2, b ends at gcd 1, and a reaches 0 within the steps."""
    spec = _fq(name)
    rng = np.random.default_rng(71)
    rand = [int.from_bytes(rng.bytes(64), "little") % spec.q for _ in range(300)]
    steps, _ = kernels.inverse_consts(spec)
    for x in _edge_inputs(spec) + rand:
        got, b, done = inverse_model(spec, x)
        assert got == _want(spec, x), hex(x)
        if x:
            assert b == 1 and done is not None and done < steps


@settings(max_examples=60, deadline=None)
@given(st.integers(min_value=1, max_value=port_curves.bls12_381.q - 1))
def test_inverse_model_bls12_381_hypothesis(x):
    spec = _fq("bls12_381")
    assert inverse_model(spec, x)[0] == _want(spec, x)


def test_inverse_model_every_toy_element_matches_jax():
    """Every stored value of the toy field: the model against the JAX
    package's mont.inverse (Fermat), limbs bit for bit."""
    spec = TOY.fq
    xs = list(range(spec.q))
    got = [inverse_model(spec, x)[0] for x in xs]
    want = np.asarray(ref_mont.inverse(REF_TOY.fq, to_jax(ints_to_limbs(xs, spec.n_limbs))))
    assert got == limbs_to_ints(want)


def test_inverse_consts():
    """steps and the fix-up constant 2^steps R^3 mod q per field, as the
    field kernels' library takes it (FIELD_KERNEL_MAX_WORDS words: 24, for
    MNT6753's 753-bit field)."""
    for name, steps in (("toy", 1), ("bn254", 17), ("bls12_381", 25), ("mnt6753", 49)):
        spec = _fq(name)
        s, fix = kernels.inverse_consts(spec)
        R = 1 << (32 * spec.n_words)
        assert s == steps == -(-(2 * spec.q.bit_length() - 1) // 31)
        assert _int([int(w) for w in fix]) == pow(2, s, spec.q) * pow(R, 3, spec.q) % spec.q
        assert fix.dtype == np.uint32 and len(fix) == _build.FIELD_KERNEL_MAX_WORDS == 24


# ---------------------------------------------------------------------------
# K2: the collapse
# ---------------------------------------------------------------------------


def _take(points, idx):
    return tuple(a[..., idx] for a in points)


def _where(mask, a, b):
    return tuple(torch.where(mask, x, y) for x, y in zip(a, b))


def _pad(points, n, curve):
    """points (L, k) -> (L, n), identities after the k."""
    k = points[0].shape[-1]
    if k == n:
        return points
    zero = group.zero(curve, (n - k,), "cpu")
    return tuple(torch.cat([a, z], dim=-1) for a, z in zip(points, zero))


def _run_tree(curve, A, Rs, levels, keep_rs):
    g = torch.arange(A[0].shape[-1])
    for lv in range(levels):
        d = 1 << lv
        a_p, r_p, r_hi = _take(A, g ^ d), _take(Rs, g ^ d), _take(Rs, g | d)
        A = group.add(curve, group.add(curve, A, a_p), r_hi)
        if lv + 1 < levels or keep_rs:
            Rs = group.double(curve, group.add(curve, Rs, r_p))
    return A, Rs


def collapse_schedule(curve, buckets, wave_groups, lanes=8):
    """collapse_kernel + combine_kernel group for group: (L, W, B) x3 ->
    (L, W) x3, with m = _collapse_run(W, B, wave_groups) and 128 / lanes
    groups per block."""
    L, W, B = buckets[0].shape
    GB = pl_reduce.COLLAPSE_THREADS // lanes
    m = pl_reduce._collapse_run(W, B, wave_groups)
    S = tuple(a.reshape(L, W * B) for a in buckets)
    per_window = B // m
    total = W * per_window
    n = -(-total // GB) * GB
    G = torch.arange(n)
    live = G < total
    zero = group.zero(curve, (n,), "cpu")

    def load(i):
        return _where(live, _take(S, (G * m + i).clamp(max=W * B - 1)), zero)

    R = load(m - 1)
    A = R
    for i in range(m - 2, -1, -1):
        R = group.add(curve, R, load(i))
        A = group.add(curve, A, R)
    k = m
    while k > 1:
        R = group.double(curve, R)
        k >>= 1
    A, Rs = _run_tree(curve, A, R, min(GB, per_window).bit_length() - 1, per_window > GB)
    while per_window > GB:  # the blocks' pairs, then combine_kernel
        A, Rs = _take(A, torch.arange(0, n, GB)), _take(Rs, torch.arange(0, n, GB))
        per_window //= GB
        total = W * per_window
        n = -(-total // GB) * GB
        A, Rs = _pad(A, n, curve), _pad(Rs, n, curve)
        A, Rs = _run_tree(curve, A, Rs, min(GB, per_window).bit_length() - 1, per_window > GB)
    return _take(A, torch.arange(W) * per_window)


def _affine(curve, pts):
    x, y = torch_np(group.to_affine(curve, tuple(a.reshape(a.shape[0], -1) for a in pts)))
    return host_points(curve, x, y)


def _ref_affine(res):
    from zprize_wasm_msm_tpu.ops.curve import group as ref_group

    x, y = ref_group.to_affine(REF_TOY, tuple(to_jax(np.asarray(a)) for a in res))
    return host_points(TOY, np.asarray(x), np.asarray(y))


WINDOWS = (1, 15, 38)


def _buckets(B, seed):
    """Windows of W = 1, 15 and 38 side by side, (L, 54, B): random points,
    identity buckets, P and -P at weights 1 and 2 in one window, -P at
    weight 1 beside P at weight 2 in another, and a window of one point."""
    nwin = sum(WINDOWS)
    pts = random_points(TOY, nwin * B, seed, bound=TOY.r)
    oc = oracle_of(TOY)
    for i in range(0, len(pts), 5):
        pts[i] = None
    if B >= 2:
        pts[1 * B + 1] = oc.neg(pts[1 * B]) if pts[1 * B] else pts[1 * B + 1]
        pts[3 * B] = oc.neg(pts[3 * B + 1]) if pts[3 * B + 1] else pts[3 * B]
    for b in range(B):
        pts[4 * B + b] = pts[7]  # every bucket the same point
    P = group.from_affine(TOY, to_torch(affine_np(TOY, pts)))
    return tuple(a.reshape(a.shape[0], nwin, B) for a in P)


@pytest.mark.parametrize("B", [1, 2, 64, 512])
def test_collapse_schedule_matches_reference(B):
    """The schedule at B buckets, W in (1, 15, 38), against the JAX
    package's bucket_reduce (one call for the three W side by side), with
    the groups of one warp per scheduler of a 132-SM card (528 warps of one
    group, 2 112 groups of 8 lanes) and with few groups or many, which
    force runs of many buckets, or of one and several combine launches."""
    bk = _buckets(B, seed=80 + B)
    want = _ref_affine(ref_pippenger.bucket_reduce(REF_TOY, tuple(to_jax(torch_np(a)) for a in bk)))
    w0 = 0
    for W in WINDOWS:
        part = tuple(a[:, w0 : w0 + W] for a in bk)
        for wave, lanes in ((528, 32), (2112, 8), (6336, 8), (3, 8), (5, 16)):
            got = _affine(TOY, collapse_schedule(TOY, part, wave, lanes))
            assert got == want[w0 : w0 + W], (W, wave, lanes)
        w0 += W


def _buckets_g2(B, seed):
    """Windows of W = 1, 15 and 38 side by side on toy_g2, (2L, 54, B): as
    _buckets, over Fq2."""
    nwin = sum(WINDOWS)
    pts, _ = g2_points(nwin * B, seed=seed)
    for i in range(0, len(pts), 5):
        pts[i] = None
    if B >= 2:
        oc = g2_oracle_of(G2)
        pts[1 * B + 1] = oc.neg(pts[1 * B]) if pts[1 * B] else pts[1 * B + 1]
        pts[3 * B] = oc.neg(pts[3 * B + 1]) if pts[3 * B + 1] else pts[3 * B]
    for b in range(B):
        pts[4 * B + b] = pts[7]  # every bucket the same point
    P = group.from_affine(G2, ZT.build_curve(G2, device="cpu").points_to_device(pts))
    return tuple(a.reshape(a.shape[0], nwin, B) for a in P)


@pytest.mark.parametrize("B", [2, 64])
def test_collapse_schedule_matches_reference_fq2(B):
    """The schedule over Fq2 (toy_g2; csrc/reduce.cu collapse2_kernel +
    combine2_kernel), W in (1, 15, 38), against the JAX package's
    bucket_reduce, with the same plans of groups as over Fq."""
    bk = _buckets_g2(B, seed=180 + B)
    want = ref_affine(ref_pippenger.bucket_reduce(REF_G2, tuple(to_jax(torch_np(a)) for a in bk)))
    w0 = 0
    for W in WINDOWS:
        part = tuple(a[:, w0 : w0 + W] for a in bk)
        for wave, lanes in ((528, 32), (2112, 8), (6336, 8), (3, 8), (5, 16)):
            got = port_affine(collapse_schedule(G2, part, wave, lanes))
            assert got == want[w0 : w0 + W], (W, wave, lanes)
        w0 += W


def test_collapse_run_follows_the_shape():
    """m from the shape and the groups of one warp per scheduler (528 on a
    card of 132 SMs at a warp a group, 2 112 at 8 lanes a group): one bucket
    a run where they hold every bucket, else the smallest power of two that
    fits, B at most."""
    assert pl_reduce._collapse_run(38, 64, 528) == 8  # full: 304 groups
    assert pl_reduce._collapse_run(15, 512, 528) == 16  # path B: 480 groups
    assert pl_reduce._collapse_run(23, 32, 528) == 2  # path A's window sums
    assert pl_reduce._collapse_run(38, 64, 2112) == 2  # 8 lanes a group
    assert pl_reduce._collapse_run(15, 512, 2112) == 4
    assert pl_reduce._collapse_run(3, 4096, 528) == 32
    assert pl_reduce._collapse_run(2, 16, 528) == 1
    assert pl_reduce._collapse_run(4, 8, 1) == 8  # never beyond B
    assert pl_reduce._collapse_run(1, 1, 1) == 1


def test_collapse_links_count_the_chain():
    """The collapse's depth in links: the walk, Rs = m R and 3 additions and
    a doubling a tree level, the last level without its doubling."""
    assert pl_reduce._collapse_links(64, 1) == (17, 5)  # full
    assert pl_reduce._collapse_links(512, 2) == (25, 8)  # path B
    assert pl_reduce._collapse_links(32, 1) == (14, 4)  # path A
    assert pl_reduce._collapse_links(1, 1) == (0, 0)
    assert pl_reduce._collapse_links(8, 8) == (14, 3)  # one run: walk only
