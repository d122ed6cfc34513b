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
import time
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
#: nvcc flags of single libraries: -split-compile optimizes and assembles
#: parts of one source on 4 threads, so the two that build longest no longer
#: run alone on one core each after the others are done (chip_smoke.py's
#: build_seconds_by_library).  Not for sorted.cu: its Fq sweep then spilled
#: (chip_smoke.py's spill gate)
STEM_FLAGS = {"reduce": ("-split-compile=4",), "check": ("-split-compile=4",)}
#: field widths (32-bit words per element) the MSM sources instantiate
#: (bucket.cu, reduce.cu, sorted.cu, check.cu)
SUPPORTED_WORDS = (2, 8, 12)
#: words per constant array in csrc/field.cuh's FieldConsts
MAX_WORDS = 12
#: words of the host block copied into FieldConsts: q, R mod q, 3b's
#: component 0, np32, 3b's component 1 (over Fq2)
CONSTS_WORDS = 4 * MAX_WORDS + 1
#: field widths of the elementwise field kernels (field_kernels.cu: K5, K6,
#: the inversion), MNT6753's 753-bit fields (24 words) among them, and the
#: words per constant array of that library's FieldConsts (it defines
#: ZP_MAX_NW as this before csrc/field.cuh): the MSM libraries keep theirs
FIELD_KERNEL_WORDS = SUPPORTED_WORDS + (24,)
FIELD_KERNEL_MAX_WORDS = 24
#: extension degrees of the coordinate field the sources instantiate
SUPPORTED_EXT = (1, 2)
#: the no-carry Montgomery product of csrc/field.cuh needs q[NW-1] below this
#: (zp_set_consts refuses the launch otherwise, error -4)
TOP_WORD_LIMIT = 0x7FFFFFFF


#: seconds from the start of the last build() until each library's nvcc
#: finished (the processes run together)
BUILD_SECONDS: Dict[str, float] = {}


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
    h.update(repr(sorted(STEM_FLAGS.items())).encode())
    return h.hexdigest()[:16]


def library_path(stem: str) -> Path:
    return BUILD_DIR / f"libzp_{stem}-{_source_hash()}.so"


def log_path(stem: str) -> Path:
    """nvcc's output (ptxas's registers and spills per kernel) for the
    library at library_path(stem), written beside it by the build."""
    return BUILD_DIR / f"nvcc_{stem}-{_source_hash()}.log"


def build(stems: Iterable[str] = STEMS) -> Dict[str, str]:
    """Compile the named sources that are not built yet, all nvcc processes
    started together, each compiler output kept at log_path(stem) and each
    one's wall time in BUILD_SECONDS.  Returns {stem: compiler output} for
    those it built.  Raises KernelCompileError with nvcc's output if any
    fails."""
    todo = [s for s in stems if not library_path(s).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for stem in todo:
        tmp = library_path(stem).with_suffix(f".{os.getpid()}.tmp")
        out = tmp.with_suffix(".log")
        cmd = [nvcc, *NVCC_FLAGS, *STEM_FLAGS.get(stem, ()), "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        with open(out, "w") as f:
            procs[stem] = (subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT), tmp, out)
    pending = set(todo)
    while pending:
        for stem in [s for s in pending if procs[s][0].poll() is not None]:
            BUILD_SECONDS[stem] = time.perf_counter() - t0
            pending.discard(stem)
        time.sleep(0.05)
    logs, failed = {}, []
    for stem, (proc, tmp, out) in procs.items():
        logs[stem] = out.read_text()
        out.unlink()
        if proc.returncode != 0:
            failed.append(stem)
            tmp.unlink(missing_ok=True)
        else:
            log_path(stem).write_text(logs[stem])
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
def field_consts(spec, max_words: int = MAX_WORDS) -> np.ndarray:
    """The host block the entry points copy into csrc/field.cuh's
    FieldConsts for a bare prime field: q and R mod q as ``max_words`` words
    each, the curve constant's slots left zero, np32.  ``max_words`` is the
    library's ZP_MAX_NW: MAX_WORDS for the MSM libraries,
    FIELD_KERNEL_MAX_WORDS for field_kernels.cu (field_kernel_consts)."""
    nw = spec.n_words
    widths = FIELD_KERNEL_WORDS if max_words == FIELD_KERNEL_MAX_WORDS else SUPPORTED_WORDS
    if nw not in widths:
        raise NotImplementedError(
            f"{spec!r}: these CUDA kernels cover fields of {widths} words per element"
        )
    if int(spec.q_words[nw - 1]) >= TOP_WORD_LIMIT:
        raise NotImplementedError(
            f"{spec!r}: the CUDA field core's no-carry product needs the top "
            f"bit of q free (top word below {TOP_WORD_LIMIT:#x})"
        )
    block = np.zeros(4 * max_words + 1, dtype=np.uint32)
    block[:nw] = spec.q_words
    block[max_words : max_words + nw] = spec.one_mont_words
    block[3 * max_words] = spec.np32
    block.setflags(write=False)
    return block


def field_kernel_consts(spec) -> np.ndarray:
    """field_consts laid out for field_kernels.cu (FIELD_KERNEL_MAX_WORDS
    words a slot), which instantiates FIELD_KERNEL_WORDS."""
    return field_consts(spec, FIELD_KERNEL_MAX_WORDS)


@functools.lru_cache(maxsize=None)
def curve_consts(curve) -> np.ndarray:
    """field_consts of the curve's coordinate field plus 3b (Montgomery):
    over Fq2 its component 0 in the Fq slot and component 1 in the last.
    The kernels cover a = 0 curves over Fq, and over Fq2 = Fq[u]/(u^2 + 1)
    (csrc/field2.cuh; every Fq2 of the registry has nr = -1)."""
    if curve.ext not in SUPPORTED_EXT or curve.a != 0:
        raise NotImplementedError(
            f"{curve.name}: the CUDA kernels cover a=0 curves over Fq and Fq2"
        )
    fq = curve.fq
    if curve.ext == 2 and curve.nr % fq.q != fq.q - 1:
        raise NotImplementedError(
            f"{curve.name}: the CUDA Fq2 core multiplies with u^2 = -1; nr = {curve.nr} "
            "is not ported"
        )
    b3 = np.asarray(curve.b3_flat_limbs, dtype=np.uint32)
    words = b3[0::2] | (b3[1::2] << 16)  # ext * NW words, component 0 first
    nw = fq.n_words
    block = field_consts(fq).copy()
    block[2 * MAX_WORDS : 2 * MAX_WORDS + nw] = words[:nw]
    if curve.ext == 2:
        block[3 * MAX_WORDS + 1 : 3 * MAX_WORDS + 1 + nw] = words[nw:]
    block.setflags(write=False)
    return block


@functools.lru_cache(maxsize=None)
def b3_small(curve) -> int:
    """3b as an integer, the curve constant of the level-parallel group ops
    over Fq (csrc/par.cuh multiplies by it with additions): 12 on
    BLS12-381, 9 on BN254.  Raises for a curve whose 3b does not fit one
    32-bit word, and over Fq2, where those ops multiply by the 3b of the
    constant block or, where 3b = k (1 + u), by additions (b3_small_fq2)."""
    curve_consts(curve)  # the same coverage as every kernel
    if curve.ext != 1:
        raise NotImplementedError(
            f"{curve.name}: 3b is an Fq2 element; see b3_small_fq2"
        )
    k = 3 * curve.b
    if not 0 < k < 1 << 32:
        raise NotImplementedError(
            f"{curve.name}: the window fold's group ops need 3b below 2^32"
        )
    return k


@functools.lru_cache(maxsize=None)
def b3_small_fq2(curve) -> int:
    """The Fq2 counterpart of b3_small: k where 3b = k (1 + u), a small
    integer (12 on BLS12-381 G2, b = 4 (1 + u)), so that the level-parallel
    Fq2 group ops (csrc/par.cuh, csrc/fold2.cuh) take 3b t = k (t0 - t1) +
    k (t0 + t1) u by additions.  Raises for any other 3b (BN254 G2, whose
    3b is a full Fq2 element, and toy_g2) and over Fq."""
    curve_consts(curve)
    if curve.ext != 2:
        raise NotImplementedError(f"{curve.name}: not an Fq2 curve; see b3_small")
    k, c1 = curve.b3
    if k != c1 or not 0 < k < 1 << 32:
        raise NotImplementedError(
            f"{curve.name}: 3b = {curve.b3} is not k (1 + u) for a k below 2^32; its "
            "products by 3b keep their level of products"
        )
    return k


def fold_b3k(curve) -> int:
    """The b3k argument of the entry points that run the level-parallel
    group ops: b3_small over Fq; over Fq2 b3_small_fq2 where 3b = k (1 + u)
    (3b by additions), else 0 (a level of products by the constant block's
    3b)."""
    curve_consts(curve)  # a curve no kernel covers raises here, not below
    if curve.ext == 1:
        return b3_small(curve)
    try:
        return b3_small_fq2(curve)
    except NotImplementedError:
        return 0


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
            -1: "field width or extension degree not instantiated for this entry",
            -2: "bucket count or run not a power of two, lanes not whole warps covering "
            "every bucket, or more bucket limbs than 32-bit offsets reach",
            -3: "inverse step count below 1",
            -4: "modulus top bit not free",
            -5: "curve constant 3b does not fit a word",
        }.get(err, f"CUDA error {err}")
        raise KernelLaunchError(f"{name}: launch refused ({reason})")
