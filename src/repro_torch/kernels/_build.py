"""Build and load the port's hand-written CUDA kernels.

Every ``kernels/**/csrc/*.cu`` file has a plain C interface. At first use
each source is compiled by its own ``nvcc`` process (all started together),
the objects are linked into one shared library under ``kernels/_build/``
(named by a hash of the sources, every ``kernels/**/csrc/*.cuh`` header and
the flags, so an edit to any of them rebuilds), and the library is loaded
with ``ctypes``. It links only the CUDA runtime: the one driver function a
kernel needs (``cuTensorMapEncodeTiled``, for B2's TMA tensor maps) is
reached through ``cudaGetDriverEntryPoint``. Pointers and the CUDA stream
cross the boundary as ``c_void_p``; every entry point returns
``cudaGetLastError()`` and :func:`check` raises when it is not 0.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")


@dataclasses.dataclass
class _State:
    lib: Optional[ctypes.CDLL] = None
    build_seconds: Optional[float] = None
    ptxas_log: str = ""
    funcs: Dict[str, object] = dataclasses.field(default_factory=dict)


_state = _State()


def sources(root: Path = KERNELS_DIR) -> List[Path]:
    return sorted(root.glob("**/csrc/*.cu"))


def headers(root: Path = KERNELS_DIR) -> List[Path]:
    return sorted(root.glob("**/csrc/*.cuh"))


def include_flags(root: Path = KERNELS_DIR) -> List[str]:
    """``-I`` for every directory that holds a header."""
    dirs = sorted({h.parent for h in headers(root)})
    return [f for d in dirs for f in ("-I", str(d))]


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the port's kernels are built from source at first "
                       "use")


def _digest(flags: Sequence[str], root: Path = KERNELS_DIR) -> str:
    """Hash of the flags and of every source and header under ``root``,
    each with its path relative to ``root``."""
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sources(root) + headers(root):
        h.update(p.relative_to(root).as_posix().encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the shared library's path. ptxas's
    register and spill report of a fresh build is kept in ``ptxas_log``."""
    srcs = sources()
    lib_path = BUILD_DIR / f"libreprotorch_{_digest(NVCC_FLAGS)}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in srcs:
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *include_flags(), "-c", str(src), "-o",
               str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        objs.append(obj)
    logs, failed = [], []
    for src, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = BUILD_DIR / f"{lib_path.name}.{tag}.tmp"
    link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)
    for obj in objs:
        obj.unlink(missing_ok=True)
    _state.build_seconds = time.perf_counter() - t0
    _state.ptxas_log = "\n".join(logs)
    return lib_path


def library() -> ctypes.CDLL:
    if _state.lib is None:
        _state.lib = ctypes.CDLL(str(build()))
        _state.lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        _state.lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return _state.lib


def function(name: str, argtypes: Sequence[object]):
    """The library's C entry point ``name``, typed; it returns an int
    CUDA error code."""
    fn = _state.funcs.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _state.funcs[name] = fn
    return fn


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")


def build_seconds() -> Optional[float]:
    return _state.build_seconds


def ptxas_log() -> str:
    return _state.ptxas_log
