"""Curve registry: the concrete curve assemblies.

Analog of the reference's curve assembly layer
(wasmcurves/src/bls12381/build_bls12381.js:22-23 for q/r,
src/bn128/build_bn128.js, src/mnt6753/build_mnt6753.js), plus BLS12-377
(the ZPrize curve, not present in the reference but required by
BASELINE.json's config matrix).

All constants are public curve standards; GLV lattice constants match
wasmcurves/src/build_glv.js:13-30.
"""

from __future__ import annotations

from ..ops.curve.spec import CurveSpec, GLVSpec

# --------------------------------------------------------------------------
# BLS12-381 (ref: build_bls12381.js:22-23, build_glv.js:13-30)
# --------------------------------------------------------------------------

BLS12_381_Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
BLS12_381_R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

bls12_381 = CurveSpec(
    name="bls12_381",
    q=BLS12_381_Q,
    r=BLS12_381_R,
    a=0,
    b=4,
    gx=0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    gy=0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    glv=GLVSpec(
        beta=793479390729215512621379701633421447060886740281060493010456487427281649075476305620758731620350,
        # the lattice's eigenvalue: lambda = -u0 = -z^2 mod r (z^2-1 is the
        # OTHER cube root; phi with the reference's beta realizes this one —
        # verified against the oracle in tests/test_glv.py)
        lam=BLS12_381_R - 228988810152649578064853576960394133504,
        u0=228988810152649578064853576960394133504,
        u1=1,
        v0=1,
        v1=-228988810152649578064853576960394133503,
    ),
    bls_x=-0xD201000000010000,
)

# --------------------------------------------------------------------------
# BLS12-381 G2: the twist y^2 = x^3 + 4(1+u) over Fq2 = Fq[u]/(u^2+1)
# (ref: build_bls12381.js:47-53 instantiates g2m over f2m; the reference's
# optimized MSM is G1-hardcoded — SURVEY.md §2.3 wart — fixed here by the
# generic field-backend design)
# --------------------------------------------------------------------------

bls12_381_g2 = CurveSpec(
    name="bls12_381_g2",
    q=BLS12_381_Q,
    r=BLS12_381_R,
    a=0,
    b=(4, 4),
    gx=(
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    gy=(
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
    glv=None,
    ext=2,
    nr=-1,
    bls_x=-0xD201000000010000,
)

# --------------------------------------------------------------------------
# BLS12-377 (ZPrize curve; BASELINE.json config 3)
# --------------------------------------------------------------------------

BLS12_377_Q = 0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001
BLS12_377_R = 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001

# BLS parameter z; the GLV lattice for any BLS12 curve is
# (u0,u1) = (z^2, 1), (v0,v1) = (1, -(z^2-1)), determinant = z^4 - z^2 + 1 = r
# (matching build_glv.js:16-24 where z_381 = -0xd201000000010000).
_Z377 = 0x8508C00000000001


def _derive_beta(q: int, r: int, lam: int, gx: int, gy: int, b: int) -> int:
    """Pick the cube root of unity in Fq with (beta*gx, gy) == lam*G.

    Host-side, runs once at import (the analog of the reference's
    codegen-time constant baking, build_glv.js:13-30).
    """

    def add(p, s):
        if p is None:
            return s
        if s is None:
            return p
        x1, y1 = p
        x2, y2 = s
        if x1 == x2:
            if (y1 + y2) % q == 0:
                return None
            lam_ = 3 * x1 * x1 * pow(2 * y1, q - 2, q) % q
        else:
            lam_ = (y2 - y1) * pow(x2 - x1, q - 2, q) % q
        x3 = (lam_ * lam_ - x1 - x2) % q
        return (x3, (lam_ * (x1 - x3) - y1) % q)

    def mul(p, k):
        acc = None
        while k:
            if k & 1:
                acc = add(acc, p)
            p = add(p, p)
            k >>= 1
        return acc

    target = mul((gx, gy), lam)
    beta = pow(2, (q - 1) // 3, q)
    g = 2
    while beta == 1:  # 2 happened to be a cube
        g += 1
        beta = pow(g, (q - 1) // 3, q)
    for cand in (beta, beta * beta % q):
        if (cand * gx % q, gy) == target:
            return cand
    raise AssertionError("no consistent cube root found")


_LAM377 = (-_Z377 * _Z377) % BLS12_377_R
_BETA377 = _derive_beta(
    BLS12_377_Q,
    BLS12_377_R,
    _LAM377,
    0x008848DEFE740A67C8FC6225BF87FF5485951E2CAA9D41BB188282C8BD37CB5CD5481512FFCD394EEAB9B16EB21BE9EF,
    0x01914A69C5102EFF1F674F5D30AFEEC4BD7FB348CA3E52D96D182AD44FB82305C2FE3D3634A9591AFD82DE55559C8EA6,
    1,
)

bls12_377 = CurveSpec(
    name="bls12_377",
    q=BLS12_377_Q,
    r=BLS12_377_R,
    a=0,
    b=1,
    gx=0x008848DEFE740A67C8FC6225BF87FF5485951E2CAA9D41BB188282C8BD37CB5CD5481512FFCD394EEAB9B16EB21BE9EF,
    gy=0x01914A69C5102EFF1F674F5D30AFEEC4BD7FB348CA3E52D96D182AD44FB82305C2FE3D3634A9591AFD82DE55559C8EA6,
    glv=GLVSpec(
        beta=_BETA377,
        lam=_LAM377,
        u0=_Z377 * _Z377,
        u1=1,
        v0=1,
        v1=-(_Z377 * _Z377 - 1),
    ),
    bls_x=_Z377,
)

# --------------------------------------------------------------------------
# BN254 (the reference's "bn128": src/bn128/build_bn128.js)
# --------------------------------------------------------------------------

BN254_Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
BN254_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

bn254 = CurveSpec(
    name="bn254",
    q=BN254_Q,
    r=BN254_R,
    a=0,
    b=3,
    gx=1,
    gy=2,
    glv=None,  # BN GLV not wired in the reference either (G1-only module)
)

# BN254 G2: twist y^2 = x^3 + 3/(9+u) over Fq2 = Fq[u]/(u^2+1)
bn254_g2 = CurveSpec(
    name="bn254_g2",
    q=BN254_Q,
    r=BN254_R,
    a=0,
    b=(
        19485874751759354771024239261021720505790618469301721065564631296452457478373,
        266929791119991161246907387137283842545076965332900288569378510910307636690,
    ),
    gx=(
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    gy=(
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
    glv=None,
    ext=2,
    nr=-1,
)

# --------------------------------------------------------------------------
# toy curve for fast unit tests (14-bit field, L=4 limbs, ~36x faster
# compiles than the 381-bit field; exercises the same generic kernels,
# including the Tonelli-Shanks sqrt path since q ≡ 1 mod 4)
# --------------------------------------------------------------------------

toy = CurveSpec(
    name="toy",
    q=10009,
    r=3391,  # prime subgroup order; cofactor 3
    a=0,
    b=3,
    gx=164,
    gy=2415,
    glv=None,
)

# a != 0 toy: exercises the general-a complete formulas (the MNT6753
# projective-curve path) at 14-bit size
toy_a = CurveSpec(
    name="toy_a",
    q=10007,
    r=3359,  # prime subgroup order; cofactor 3
    a=3,
    b=1,
    gx=127,
    gy=4194,
    glv=None,
)

# ext=2 toy: a genuine sextic-twist-style G2 analog at 14-bit size.
# q = 7 mod 12 (so u^2 + 1 is irreducible AND a=0 curves are ordinary);
# E'(Fq2): y^2 = x^3 + (4932 + 6901 u) has order 97 * 1023973 with the
# ~2^20 prime subgroup OUTSIDE both the base-curve and quadratic-twist
# images, so generator multiples have fully generic Fq2 coordinates.
# Derived host-side the same way as the real curve constants (trace of
# E: y^2 = x^3 + b over Fq -> the six sextic twist orders of E(Fq2)).
toy_g2 = CurveSpec(
    name="toy_g2",
    q=9967,
    r=1023973,  # prime; cofactor 97
    a=0,
    b=(4932, 6901),
    gx=(7366, 4023),
    gy=(2623, 1050),
    glv=None,
    ext=2,
    nr=-1,
)

# ext=3 toy: the MNT6753-G2 analog at 14-bit size — general-a curve over
# Fq3 = Fq[v]/(v^3 - 11) (11 is a cubic non-residue mod 9967), prime
# ~2^18.4 subgroup outside E(Fq) so generator multiples have fully
# generic Fq3 coordinates.  Derived host-side from the base-curve trace
# (#E(Fq3) = q^3 + 1 - (t^3 - 3qt)).
toy_g3 = CurveSpec(
    name="toy_g3",
    q=9967,
    r=352069,  # prime; cofactor 2812320
    a=(1, 0, 0),
    b=(3, 0, 0),
    gx=(7806, 7650, 1404),
    gy=(6653, 8200, 5609),
    glv=None,
    ext=3,
    nr=11,
)

# Toy BN pairing family (z = 5 in the BN parametrization:
# q = 36z^4+36z^3+24z^2+6z+1, r = q - 6z^2, t = 6z^2+1): a COMPLETE
# 15-bit analog of bn254 — prime q and r, q = 3 mod 4 (u^2 = -1
# irreducible), xi = 4 + u a sextic non-residue whose D-type twist
# y^2 = x^3 + b/xi has order r * (2q - r).  Derived host-side exactly
# like the real curve constants; exercises the FULL BN optimal-ate
# pairing (Miller loop, mul024, Frobenius tables, final-exp chain) and
# the Groth16 verifier at toy compile cost in the fast CI tier.
toy_bn = CurveSpec(
    name="toy_bn",
    q=27631,
    r=27481,  # prime; cofactor 1
    a=0,
    b=6,
    gx=6,
    gy=9010,
    glv=None,
)

toy_bn_g2 = CurveSpec(
    name="toy_bn_g2",
    q=27631,
    r=27481,  # prime subgroup; cofactor 2q - r = 27781
    a=0,
    b=(21131, 1625),  # b / xi, xi = 4 + u
    gx=(9525, 22057),
    gy=(13834, 1256),
    glv=None,
    ext=2,
    nr=-1,
)

# FFT-friendly toy: r - 1 = 2^7 * 21, so Fr has 2-adicity 7 (group/scalar
# FFTs up to size 128); same generic kernels, 13-bit field.
toy_fft = CurveSpec(
    name="toy_fft",
    q=8089,
    r=2689,  # prime subgroup order; cofactor 3
    a=0,
    b=4,
    gx=3149,
    gy=3923,
    glv=None,
)

# --------------------------------------------------------------------------
# MNT6-753 (ref: src/mnt6753/build_mnt6753.js:19 q, :234 r, mulByA1 a=11,
# G1gen at :146; the reference uses a projective a != 0 curve via
# build_curve_projective.js — here the general-a complete formulas)
# --------------------------------------------------------------------------

MNT6753_Q = 41898490967918953402344214791240637128170709919953949071783502921025352812571106773058893763790338921418070971888458477323173057491593855069696241854796396165721416325350064441470418137846398469611935719059908164220784476160001
MNT6753_R = 41898490967918953402344214791240637128170709919953949071783502921025352812571106773058893763790338921418070971888253786114353726529584385201591605722013126468931404347949840543007986327743462853720628051692141265303114721689601
_MNT6_GX = 16364236387491689444759057944334173579070747473738339749093487337644739228935268157504218078126401066954815152892688541654726829424326599038522503517302466226143788988217410842672857564665527806044250003808514184274233938437290
_MNT6_GY = 4510127914410645922431074687553594593336087066778984214797709122300210966076979927285161950203037801392624582544098750667549188549761032654706830225743998064330900301346566408501390638273322467173741629353517809979540986561128

mnt6753 = CurveSpec(
    name="mnt6753",
    q=MNT6753_Q,
    r=MNT6753_R,
    a=11,
    # b derived from the generator: b = y^2 - x^3 - a*x (the reference's
    # projective-curve code never embeds b; it is only needed for inCurve)
    b=(_MNT6_GY * _MNT6_GY - _MNT6_GX**3 - 11 * _MNT6_GX) % MNT6753_Q,
    gx=_MNT6_GX,
    gy=_MNT6_GY,
    glv=None,
)

# MNT6-753 G2: the sextic-twist-style curve over Fq3 = Fq[v]/(v^3 - 11)
# (ref build_mnt6753.js — f3m at :56 with nonresidue 11 :41, g2m at :144
# over mulByA2 = multiplication by a2 = 11*v^2 = (0,0,11) :110-143,
# generator G2gen at :174-202).  b2 derived from the generator like b
# above (the projective-curve code never embeds b; needed here for inCurve).
_MNT6_G2X = (
    46538297238006280434045879335349383221210789488441126073640895239023832290080310125413049878152095926176013036314720850781686614265244307536450228450615346834324267478485994670716807428718518299710702671895190475661871557310,
    10329739935427016564561842963551883445915701424214177782911128765230271790215029185795830999583638744119368571742929964793955375930677178544873424392910884024986348059137449389533744851691082159233065444766899262771358355816328,
    19962817058174334691864015232062671736353756221485896034072814261894530786568591431279230352444205682361463997175937973249929732063490256813101714586199642571344378012210374327764059557816647980334733538226843692316285591005879,
)
_MNT6_G2Y = (
    5648166377754359996653513138027891970842739892107427747585228022871109585680076240624013411622970109911154113378703562803827053335040877618934773712021441101121297691389632155906182656254145368668854360318258860716497525179898,
    26817850356025045630477313828875808893994935265863280918207940412617168254772789578700316551065949899971937475487458539503514034928974530432009759562975983077355912050606509147904958229398389093697494174311832813615564256810453,
    32332319709358578441696731586704495581796858962594701633932927358040566210788542624963749336109940335257143899293177116050031684054348958813290781394131284657165540476824211295508498842102093219808642563477603392470909217611033,
)

mnt6753_g2 = CurveSpec(
    name="mnt6753_g2",
    q=MNT6753_Q,
    r=MNT6753_R,
    a=(0, 0, 11),
    b=(
        2189526091197672465268098090392210500740714959757583916377481826443393499947557697773546040576162515434508768057245887856591913752342600919117433675080691499697020523783784738694360040853591723916201150207746019687604267190251,
        0,
        0,
    ),
    gx=_MNT6_G2X,
    gy=_MNT6_G2Y,
    glv=None,
    ext=3,
    nr=11,
)

CURVES = {
    "mnt6753": mnt6753,
    "mnt6753_g2": mnt6753_g2,
    "bls12_381": bls12_381,
    "bls12_381_g2": bls12_381_g2,
    "bls12_377": bls12_377,
    "bn254": bn254,
    "bn254_g2": bn254_g2,
    "bn128": bn254,  # reference alias
    "toy_bn": toy_bn,
    "toy_bn_g2": toy_bn_g2,
}
