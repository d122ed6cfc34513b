"""Builds and loads the package's CUDA kernels.

Each ``csrc/<stem>.cu`` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` into ``<checkout>/build/`` at first use
and loaded with ``ctypes``.  The file name carries a hash of every source
under ``csrc/`` and of the compiler flags, so an edited source is rebuilt
and a finished build is reused.  No PyTorch header is included anywhere:
a library builds in seconds, not minutes.

Nothing here runs at import time; a machine without ``nvcc`` can import the
package and use its plain (CPU) paths.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
STEMS = ("bucket", "reduce", "sorted", "field_kernels", "check")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: field widths (32-bit words per element) the sources instantiate
SUPPORTED_WORDS = (2, 8, 12)
#: words per constant array in csrc/field.cuh's FieldConsts
MAX_WORDS = 12
#: the no-carry Montgomery product of csrc/field.cuh needs q[NW-1] below this
#: (zp_set_consts refuses the launch otherwise, error -4)
TOP_WORD_LIMIT = 0x7FFFFFFF


class KernelCompileError(RuntimeError):
    """nvcc is missing or refused a source; the message carries its output."""


class KernelLaunchError(RuntimeError):
    """A kernel launch was refused by the CUDA runtime."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise KernelCompileError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels build on the machine that has the card"
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(stem: str) -> Path:
    return BUILD_DIR / f"libzp_{stem}-{_source_hash()}.so"


def log_path(stem: str) -> Path:
    """nvcc's output (ptxas's registers and spills per kernel) for the
    library at library_path(stem), written beside it by the build."""
    return BUILD_DIR / f"nvcc_{stem}-{_source_hash()}.log"


def build(stems: Iterable[str] = STEMS) -> Dict[str, str]:
    """Compile the named sources that are not built yet, all nvcc processes
    started together, each compiler output kept at log_path(stem).  Returns
    {stem: compiler output} for those it built.  Raises KernelCompileError
    with nvcc's output if any fails."""
    todo = [s for s in stems if not library_path(s).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in todo:
        tmp = library_path(stem).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
        )
    logs, failed = {}, []
    for stem, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        logs[stem] = out
        if proc.returncode != 0:
            failed.append(stem)
            tmp.unlink(missing_ok=True)
        else:
            log_path(stem).write_text(out)
            os.replace(tmp, library_path(stem))
    if failed:
        raise KernelCompileError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[s] for s in failed)
        )
    return logs


@functools.lru_cache(maxsize=None)
def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu`` (built first if need be)."""
    build([stem])
    return ctypes.CDLL(str(library_path(stem)))


@functools.lru_cache(maxsize=None)
def field_consts(spec) -> np.ndarray:
    """The host block the entry points copy into csrc/field.cuh's
    FieldConsts for a bare prime field: q and R mod q as MAX_WORDS words
    each, the curve constant's slot left zero, np32."""
    nw = spec.n_words
    if nw not in SUPPORTED_WORDS:
        raise NotImplementedError(
            f"{spec!r}: the CUDA kernels cover fields of {SUPPORTED_WORDS} "
            "words per element"
        )
    if int(spec.q_words[nw - 1]) >= TOP_WORD_LIMIT:
        raise NotImplementedError(
            f"{spec!r}: the CUDA field core's no-carry product needs the top "
            f"bit of q free (top word below {TOP_WORD_LIMIT:#x})"
        )
    block = np.zeros(3 * MAX_WORDS + 1, dtype=np.uint32)
    block[:nw] = spec.q_words
    block[MAX_WORDS : MAX_WORDS + nw] = spec.one_mont_words
    block[3 * MAX_WORDS] = spec.np32
    block.setflags(write=False)
    return block


@functools.lru_cache(maxsize=None)
def curve_consts(curve) -> np.ndarray:
    """field_consts of the curve's coordinate field plus 3b (Montgomery)."""
    if curve.ext != 1 or curve.a != 0:
        raise NotImplementedError(
            f"{curve.name}: the CUDA kernels cover a=0 curves over Fq"
        )
    fq = curve.fq
    b3 = np.asarray(curve.b3_flat_limbs, dtype=np.uint32)
    block = field_consts(fq).copy()
    block[2 * MAX_WORDS : 2 * MAX_WORDS + fq.n_words] = b3[0::2] | (b3[1::2] << 16)
    block.setflags(write=False)
    return block


@functools.lru_cache(maxsize=None)
def b3_small(curve) -> int:
    """3b as an integer, the curve constant of the level-parallel group ops
    (csrc/par.cuh multiplies by it with additions): 12 on BLS12-381, 9 on
    BN254.  Raises for a curve whose 3b does not fit one 32-bit word."""
    curve_consts(curve)  # the same coverage as every kernel
    k = 3 * curve.b
    if not 0 < k < 1 << 32:
        raise NotImplementedError(
            f"{curve.name}: the window fold's group ops need 3b below 2^32"
        )
    return k


def kernel_info(stem: str, entry: str, nw: int, *args: int) -> Dict[str, int]:
    """What the CUDA runtime says of one kernel of ``csrc/<stem>.cu`` at
    field width nw: registers per thread, local (stack and spill) bytes per
    thread, static shared bytes per block and resident blocks per SM
    (``<entry>(nw, *args, int out[4])``, csrc/async.cuh zp_kernel_info;
    ``args`` pick one kernel where an entry reports several)."""
    fn = getattr(load(stem), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * (1 + len(args)) + [ctypes.c_void_p]
    out = (ctypes.c_int * 4)()
    check_launch(fn(nw, *args, ctypes.cast(out, ctypes.c_void_p)), entry)
    return dict(zip(("registers", "local_bytes", "shared_bytes", "blocks_per_sm"), out))


def check_launch(err: int, name: str) -> None:
    """Raise if an entry point reported a refused launch (the kernel then
    never ran, and a later synchronize would not say so)."""
    if err != 0:
        reason = {
            -1: "field width not instantiated",
            -2: "bucket count or run not a power of two, lanes not whole warps covering "
            "every bucket, or more bucket limbs than 32-bit offsets reach",
            -3: "inverse step count below 1",
            -4: "modulus top bit not free",
            -5: "curve constant 3b does not fit a word",
        }.get(err, f"CUDA error {err}")
        raise KernelLaunchError(f"{name}: launch refused ({reason})")
