"""Host <-> device conversion of bigint batches to limb-vector arrays.

The analog of the protoboard's pb.set/pb.get marshalling
(protoboard; see reference test/batchAffine.js:33-41), which
moves BigInts in/out of WASM linear memory.  Here batches of python ints
become (L, N) uint32 numpy arrays of 16-bit little-endian limbs; the
tensor side of the conversion lives in utils.convert.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .bigint import int_to_limbs, limbs_to_int


def ints_to_limbs(values: Sequence[int], n_limbs: int) -> np.ndarray:
    """(N,) python ints -> (L, N) uint32 limb array.

    Serializes through int.to_bytes + np.frombuffer (C speed) instead of a
    per-limb python loop — the difference between seconds and minutes when
    marshalling 2^20-point benches.
    """
    nbytes = n_limbs * 2
    buf = b"".join(int(v).to_bytes(nbytes, "little") for v in values)
    a = np.frombuffer(buf, dtype="<u2").reshape(len(values), n_limbs)
    return np.ascontiguousarray(a.T).astype(np.uint32)


def limbs_to_ints(arr) -> List[int]:
    """(L, N) limb array -> list of N python ints."""
    a = np.asarray(arr)
    if a.ndim == 1:
        return [limbs_to_int(a)]
    flat = a.reshape(a.shape[0], -1).T  # (N, L)
    le = flat.astype("<u2", casting="unsafe")
    raw = le.tobytes()
    nbytes = le.shape[1] * 2
    return [
        int.from_bytes(raw[j * nbytes : (j + 1) * nbytes], "little")
        for j in range(le.shape[0])
    ]


def int_to_limbvec(value: int, n_limbs: int) -> np.ndarray:
    """single int -> (L,) uint32 limb vector."""
    return int_to_limbs(value, n_limbs)
