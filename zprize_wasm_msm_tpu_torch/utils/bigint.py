"""Host-side arbitrary-precision integer helpers.

Host-side analog of the reference's codegen-time bigint utilities
(reference: wasmcurves/src/bigint.js:46,67,130 and wasmcurves/src/utils.js).
These run on the host at *specialization time* (building FieldSpec /
CurveSpec constants), never on tensors.
"""

from __future__ import annotations

import numpy as np

MASK16 = 0xFFFF
MASK32 = 0xFFFFFFFF


def mod_inv(a: int, m: int) -> int:
    """Modular inverse via extended Euclid (ref: bigint.js:46)."""
    a %= m
    if a == 0:
        raise ZeroDivisionError("mod_inv of 0")
    g, x = _egcd(a, m)
    if g != 1:
        raise ValueError("not invertible")
    return x % m


def _egcd(a: int, b: int):
    old_r, r = a, b
    old_s, s = 1, 0
    while r:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_s, s = s, old_s - q * s
    return old_r, old_s


def mod_pow(base: int, exp: int, mod: int) -> int:
    """(ref: bigint.js:67) — python pow is already fast host-side."""
    return pow(base, exp, mod)


def is_prime(n: int, rounds: int = 32) -> bool:
    """Miller-Rabin probabilistic primality (ref: bigint.js:130)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    s = 0
    while d % 2 == 0:
        d //= 2
        s += 1
    import random

    rng = random.Random(0xC0FFEE)
    for _ in range(rounds):
        a = rng.randrange(2, n - 1)
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def bit_length(n: int) -> int:
    return int(n).bit_length()


def int_to_bytes_le(v: int, nbytes: int) -> bytes:
    """LE serialization (ref: utils.js bigInt2BytesLE)."""
    return int(v).to_bytes(nbytes, "little")


def bytes_le_to_int(b: bytes) -> int:
    return int.from_bytes(b, "little")


def int_to_limbs(v: int, n_limbs: int, limb_bits: int = 16) -> np.ndarray:
    """Split a non-negative int into little-endian limbs as uint32 ndarray."""
    v = int(v)
    if v < 0:
        raise ValueError("int_to_limbs requires non-negative value")
    mask = (1 << limb_bits) - 1
    out = np.empty(n_limbs, dtype=np.uint32)
    for i in range(n_limbs):
        out[i] = v & mask
        v >>= limb_bits
    if v:
        raise OverflowError("value does not fit in limbs")
    return out


def limbs_to_int(limbs, limb_bits: int = 16) -> int:
    """Little-endian limb array -> python int."""
    v = 0
    arr = np.asarray(limbs)
    for i in range(arr.shape[0] - 1, -1, -1):
        v = (v << limb_bits) | int(arr[i])
    return v
