"""What the kernel wrappers of ops.msm share: engine choice, argument
checks, word (un)packing of point batches, and the raw pointers a ctypes
call takes."""

from __future__ import annotations

import ctypes

import torch

from ...utils.convert import pack_words, unpack_words


def use_kernel(impl: str, tensor: torch.Tensor) -> bool:
    """Resolve impl ("auto" | "kernel" | "plain") for this tensor: auto is
    the kernel for a CUDA tensor and the plain version for a CPU tensor;
    "kernel" on a CPU tensor raises (no silent stand-in either way)."""
    if impl == "auto":
        return tensor.is_cuda
    if impl == "kernel":
        if not tensor.is_cuda:
            raise ValueError(
                "impl='kernel' needs CUDA tensors; the tensors given lie on "
                f"{tensor.device}"
            )
        return True
    if impl == "plain":
        return False
    raise ValueError(f"impl must be 'auto', 'kernel' or 'plain', got {impl!r}")


def check_limbs(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.int64 or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"{name}: expected int64 {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )


def pack_point(coords) -> torch.Tensor:
    """k coordinate tensors (L, *batch) int64 -> one contiguous
    (k, L/2, n) int32 word tensor (n = flattened batch): the kernels'
    [coord][word][element] layout."""
    L = coords[0].shape[0]
    return torch.stack([pack_words(c.reshape(L, -1)) for c in coords]).contiguous()


def point_words(points) -> torch.Tensor:
    """Affine (X, Y), each (L, N) int64 -> the sweeps' point-contiguous
    (N, 2, NW) int32 words: one point is 2 NW consecutive words, so a point
    read at a random index is whole 16-byte loads and 32-byte sectors."""
    return pack_point(points).permute(2, 0, 1).contiguous()


def unpack_point(words: torch.Tensor, batch_shape):
    """(3, NW, n) int32 words -> (X, Y, Z), each (2 NW, *batch) int64."""
    limbs = unpack_words(words.reshape((-1,) + tuple(words.shape[2:])))
    L = 2 * words.shape[1]
    limbs = limbs.reshape((words.shape[0], L) + tuple(batch_shape))
    return tuple(limbs[i] for i in range(words.shape[0]))


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
