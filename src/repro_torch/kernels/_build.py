"""Build and load the port's hand-written CUDA kernels.

Every ``kernels/**/csrc/*.cu`` file is compiled with nvcc alone. At first use
each source is compiled by its own ``nvcc`` process (all started together),
the objects are linked into one shared library under ``kernels/_build/``
(named by a hash of the sources, every ``kernels/**/csrc/*.cuh`` header and
the flags and the Python it is built for, so an edit to any of them
rebuilds), and the library is imported as the CPython extension module
``_kernels`` (:func:`module`). It links only the CUDA runtime: the one
driver function a kernel needs (``cuTensorMapEncodeTiled``, for B2's TMA
tensor maps) is reached through ``cudaGetDriverEntryPoint``. The kernels'
C entry points are declared in ``csrc/launch.cuh`` and bound in
``csrc/module.cu``, which includes ``Python.h``, never PyTorch's headers:
pointers and the CUDA stream cross as Python ints, and a launch that
returns a CUDA error raises ``RuntimeError``.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without ``nvcc``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import time
from pathlib import Path
from typing import List, Optional, Sequence

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")


@dataclasses.dataclass
class _State:
    build_seconds: Optional[float] = None
    ptxas_log: str = ""
    module: Optional[object] = None


_state = _State()


def sources(root: Path = KERNELS_DIR) -> List[Path]:
    return sorted(root.glob("**/csrc/*.cu"))


def headers(root: Path = KERNELS_DIR) -> List[Path]:
    return sorted(root.glob("**/csrc/*.cuh"))


def include_flags(root: Path = KERNELS_DIR) -> List[str]:
    """``-I`` for every directory that holds a header, and for Python.h."""
    dirs = [str(d) for d in sorted({h.parent for h in headers(root)})]
    dirs.append(sysconfig.get_paths()["include"])
    return [f for d in dirs for f in ("-I", d)]


def python_abi() -> List[str]:
    """What importing the library as an extension module depends on:
    Python's include directory (its version) and the extension suffix (its
    ABI)."""
    return [sysconfig.get_paths()["include"],
            sysconfig.get_config_var("EXT_SUFFIX") or ""]


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


def library_name() -> str:
    """The library's file name: a hash of the sources, the headers, the
    flags and the Python it is imported by."""
    return f"libreprotorch_{_digest([*NVCC_FLAGS, *python_abi()])}.so"


def build() -> Path:
    """Compile (if needed) and return the shared library's path. ptxas's
    register and spill report of a fresh build is kept in ``ptxas_log``."""
    srcs = sources()
    lib_path = BUILD_DIR / library_name()
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


def module():
    """The library imported as the extension module ``_kernels``: one
    function per kernel (``paged_decode``, ``flash_attention``,
    ``flash_attention_bwd``, ``rmsnorm``, ``rmsnorm_bwd``, ``ssd_scan``,
    ``ssd_scan_bwd``, ``whole_trace``, ``fastsim_chunk``), each
    taking its C entry point's arguments and raising ``RuntimeError`` on a
    CUDA error."""
    if _state.module is None:
        spec = importlib.util.spec_from_file_location(
            "repro_torch.kernels._kernels", build())
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _state.module = mod
    return _state.module


def build_seconds() -> Optional[float]:
    return _state.build_seconds


def ptxas_log() -> str:
    return _state.ptxas_log
