"""State carried between the JAX package and this one, and between the
16-bit-limb public layout and the kernels' 32-bit words.

The system has no weights.  What crosses are batches of field elements,
points, scalars and digits, which the JAX package holds as uint32 arrays of
16-bit limbs (and int32 digits) and this package as int64 / int32 tensors
of the same shape and values.  ``from_reference`` / ``to_reference`` map
one to the other through numpy, recursing into tuples (affine pairs,
projective triples).

``pack_words`` / ``unpack_words`` re-pack (L, *batch) 16-bit limbs into
(L/2, *batch) 32-bit words and back: word j = limb 2j | limb 2j+1 << 16,
the same integer in the same Montgomery form (L is a multiple of 4).  Word
tensors are int32: only their bit pattern matters to a kernel.  An Fq2
batch is (2L, *batch) limbs, component 0 then component 1 (tower.Fq2); a
limb pair never straddles the two, so it packs to [c0 words][c1 words], NW
each: the CUDA kernels' Fe2 layout.  from_reference carries the JAX
package's Fq2 arrays across as they are, and its Fq6 / Fq12 batches
((6L, *batch), (12L, *batch): ops.pairing.tower's flat component layout,
the JAX package's) the same way: any uint32 limb array.
"""

from __future__ import annotations

import numpy as np
import torch


def from_reference(value, device="cpu"):
    """numpy (or array-like) uint32 limb batch -> int64 tensor, int32 digits
    -> int32 tensor, tuples element-wise, on ``device``."""
    if isinstance(value, (tuple, list)):
        return tuple(from_reference(v, device) for v in value)
    arr = np.asarray(value)
    if arr.dtype == np.uint32:
        return torch.as_tensor(arr.astype(np.int64), device=device)
    if arr.dtype == np.int32:
        return torch.as_tensor(arr, device=device)
    raise TypeError(f"from_reference: uint32 limbs or int32 digits, got {arr.dtype}")


def to_reference(value):
    """Inverse of from_reference: int64 limb tensor -> uint32 numpy array,
    int32 tensor -> int32 numpy array, tuples element-wise."""
    if isinstance(value, (tuple, list)):
        return tuple(to_reference(v) for v in value)
    arr = value.detach().cpu().numpy()
    if arr.dtype == np.int64:
        if arr.size and (arr.min() < 0 or arr.max() > 0xFFFF):
            raise ValueError("to_reference: limbs outside [0, 2^16)")
        return arr.astype(np.uint32)
    if arr.dtype == np.int32:
        return arr
    raise TypeError(f"to_reference: int64 limbs or int32 digits, got {arr.dtype}")


def pack_words(limbs: torch.Tensor) -> torch.Tensor:
    """(L, *batch) int64 16-bit limbs -> (L/2, *batch) int32 words."""
    if limbs.dtype != torch.int64 or limbs.shape[0] % 2:
        raise ValueError("pack_words: int64 tensor with an even limb count")
    words = limbs[0::2] | (limbs[1::2] << 16)
    # int64 -> int32 keeps the low 32 bits (two's complement wrap)
    return words.to(torch.int32).contiguous()


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """(NW, *batch) int32 words -> (2 NW, *batch) int64 16-bit limbs."""
    if words.dtype != torch.int32:
        raise ValueError("unpack_words: int32 tensor")
    w = words.to(torch.int64) & 0xFFFFFFFF
    out = torch.stack([w & 0xFFFF, w >> 16], dim=1)
    return out.reshape((2 * words.shape[0],) + tuple(words.shape[1:]))
