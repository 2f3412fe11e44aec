"""Build and bind the port's native code: compiler -> shared library -> ctypes.

Three libraries, each compiled at first use into
``build/tnsh_torch/<hash>/`` beside the package (``.gitignore`` lists
``build/``), never into the package directory:

  * ``fr``  -- ``csrc/fr_kernels.cu``, the sum-check round kernels (nvcc);
  * ``msm`` -- ``csrc/msm_kernels.cu``, the Fq field, group-law, MSM
    plan, MSM insertion and MSM tail kernels (nvcc);
  * ``native`` -- ``csrc/tnsh_native.cpp``, the host engine (g++).

The CUDA sources are built with ``nvcc -gencode
arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC`` and
share ``csrc/field.cuh``.  They include no PyTorch headers: the entry
points are plain C functions, which keeps a build to seconds.  The
directory name is a hash of the sources, the shared header and the flags,
so an edited source builds anew and an unchanged one is reused.

Several processes may ask for the same library at once (a test run with
many workers): a lock file lets one of them compile while the others
wait, and the compiler writes to a per-process temporary name that is
renamed into place.  A failed build raises with the compiler's output.

Nothing here runs at import time.  ``build_all`` starts every compiler at
once, for a program that will need all three.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Sequence

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tnsh_torch")

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_GXX_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-fopenmp",
              "-shared", "-fPIC"]

#: name -> (compiler, flags, source, headers the source includes, library)
_TARGETS = {
    "fr": ("nvcc", _NVCC_FLAGS, "fr_kernels.cu", ["field.cuh"],
           "libtnsh_torch_fr.so"),
    "msm": ("nvcc", _NVCC_FLAGS, "msm_kernels.cu", ["field.cuh"],
            "libtnsh_torch_msm.so"),
    "native": ("g++", _GXX_FLAGS, "tnsh_native.cpp", [],
               "libtnsh_torch_native.so"),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _compiler(kind: str) -> str:
    if kind == "nvcc":
        return _nvcc()
    path = shutil.which(kind)
    if path is None:
        raise RuntimeError(f"{kind} not found: the host engine cannot be built")
    return path


def _paths(name: str):
    """(library path, compiler argv without the output) of a target."""
    kind, flags, source, headers, lib_name = _TARGETS[name]
    h = hashlib.sha256(" ".join([kind, *flags]).encode())
    for rel in [source, *headers]:
        with open(os.path.join(_CSRC, rel), "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(BUILD_DIR, h.hexdigest()[:16])
    return (os.path.join(out_dir, lib_name),
            [kind, *flags, os.path.join(_CSRC, source)])


def compiler_log(name: str) -> str:
    """What the compiler printed when this target was last built here
    (for nvcc: ptxas' registers and spills per kernel)."""
    lib, _ = _paths(name)
    with open(lib + ".log", encoding="utf-8") as f:
        return f.read()


def _finish(name: str, lib: str, tmp: str, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {name} failed ({proc.returncode}):\n{out}")
    with open(lib + ".log", "w", encoding="utf-8") as f:
        f.write(out)
    os.replace(tmp, lib)


def build_many(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named target that has no library for its hash yet,
    all compilers started together; return name -> library path."""
    libs: Dict[str, str] = {}
    locks: List = []
    started = []
    try:
        for name in names:
            lib, argv = _paths(name)
            libs[name] = lib
            if os.path.exists(lib):
                continue
            os.makedirs(os.path.dirname(lib), exist_ok=True)
            lock = open(lib + ".lock", "w")
            locks.append(lock)
            fcntl.flock(lock, fcntl.LOCK_EX)   # waits while another builds
            if os.path.exists(lib):
                continue
            tmp = f"{lib}.{os.getpid()}.tmp"
            argv = [_compiler(argv[0]), *argv[1:], "-o", tmp]
            started.append((name, lib, tmp, subprocess.Popen(
                argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for job in started:
            _finish(*job)
    finally:
        for _, _, _, proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for lock in locks:
            lock.close()
    return libs


def build_all() -> Dict[str, str]:
    """Build the three libraries, compilers running side by side."""
    return build_many(list(_TARGETS))


def build(name: str) -> str:
    return build_many([name])[name]


def _bind(lib: ctypes.CDLL, signatures) -> ctypes.CDLL:
    for fname, argtypes in signatures:
        fn = getattr(lib, fname)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tnsh_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tnsh_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The sum-check kernel library with every entry point's C signature."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return _bind(ctypes.CDLL(build("fr")), [
        ("tnsh_fr_chain", [vp, vp, vp, i64, i64, i64, i32, vp]),
        ("tnsh_fr_fold", [vp, vp, vp, i64, i64, vp]),
        ("tnsh_fr_rlc", [vp, vp, vp, i64, i64, vp]),
        ("tnsh_fr_open_level", [vp, vp, vp, vp, i64, vp]),
        ("tnsh_fr_prefix_scan_blocks", [i64]),
        ("tnsh_fr_prefix_scan", [vp, vp, vp, vp, i64, vp, vp, i64, vp]),
        ("tnsh_fr_round_evals_blocks", [i64]),
        ("tnsh_fr_round_evals",
         [vp, i64, vp, i32, i32, vp, i32, i32, vp, i32, vp, vp]),
        ("tnsh_tbk_buckets", [vp] * 6 + [i64, i64, i32, i64, vp]),
        ("tnsh_tbk_round", [vp] * 12 + [i64, i64, i32, i64, vp]),
        ("tnsh_tbk_bind", [vp] * 7 + [i64, i32, vp]),
    ])


@functools.lru_cache(maxsize=1)
def msm_library() -> ctypes.CDLL:
    """The Fq / group-law / MSM plan, insertion and tail kernel library."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return _bind(ctypes.CDLL(build("msm")), [
        ("tnsh_fq_chain", [vp, vp, vp, i64, i64, i64, i32, vp]),
        ("tnsh_g1_padd", [vp] * 10 + [i64, vp]),
        ("tnsh_msm_insert",
         [vp, i64, i32, vp, vp, i64, i64] + [vp] * 8),
        ("tnsh_msm_insert_resident_threads",
         [ctypes.POINTER(ctypes.c_longlong)]),
        ("tnsh_msm_fold_tiles", [vp] * 7 + [i64, i32, vp]),
        ("tnsh_msm_window_sums", [vp] * 3 + [i64, vp, vp, i32, vp, vp, vp]),
        ("tnsh_msm_digits", [vp, i64, vp, i64, i64] + [vp] * 4),
        ("tnsh_msm_rank",
         [vp, i64, i64, i32, i64] + [vp] * 5 + [i64, i64, vp]),
    ])


def native_library_path() -> str:
    """Path of the built host engine (``tnsh_torch._native`` loads it)."""
    return build("native")
