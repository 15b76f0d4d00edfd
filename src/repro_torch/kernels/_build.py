"""Build the port's CUDA kernels on first use and load them with ctypes.

Each kernel source ``kernels/<name>/csrc/<name>.cu`` has a plain C interface.
``nvcc`` compiles it for Hopper (``sm_90a``) into a shared library under
``kernels/_build/`` (listed in ``.gitignore``), named after a hash of every
file under the kernel's ``csrc/``, every shared header under
``kernels/include/`` and the flags, so an edited source or header is
rebuilt.  Several sources build in parallel,
one ``nvcc`` process each.  A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
#: headers that kernel sources share (``#include "../../include/<name>.cuh"``)
INCLUDE_DIR = KERNELS_DIR / "include"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_loaded: dict = {}


def source_path(name: str) -> Path:
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"nvcc not found (looked in {cuda_home}/bin and on PATH)")


def _lib_path(name: str, flags, build_dir: Path) -> Path:
    digest = hashlib.sha1(" ".join(flags).encode())
    for d in (source_path(name).parent, INCLUDE_DIR):
        for f in sorted(d.rglob("*")):
            if f.is_file():
                digest.update(f.name.encode() + f.read_bytes())
    return build_dir / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names, *, extra_flags=(), build_dir: Path = BUILD_DIR, log: dict | None = None) -> dict:
    """Compile every named kernel whose library is missing, all ``nvcc``
    processes started together, and return ``{name: library path}``.
    ``extra_flags`` go after ``NVCC_FLAGS``; ``log`` receives nvcc's stderr
    per kernel built (``-Xptxas -v`` prints registers, shared memory and
    spills there)."""
    flags = (*NVCC_FLAGS, *extra_flags)
    build_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name, flags, build_dir) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    procs = {}
    for name, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(source_path(name))]
        procs[name] = (tmp, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if log is not None:
            log[name] = err
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {source_path(name)} (exit {proc.returncode}):\n{err}")
        else:
            os.replace(tmp, paths[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use and cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib
