"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface. It is compiled with ``nvcc``
for Hopper (``sm_90a``) into a shared library at first use and loaded with
``ctypes``; nothing includes PyTorch's headers, so a build takes seconds.
Libraries are named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. They go to
``build/torch_kernels/`` at the root of the checkout (listed in
``.gitignore``) when the package runs from a checkout; an installed package
(the sources ship as package data) builds into
``$XDG_CACHE_HOME/owss_torch_kernels`` (``~/.cache`` when unset).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _build_dir() -> Path:
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").exists():      # a checkout of the repo
        return root / "build" / "torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "owss_torch_kernels"


BUILD_DIR = _build_dir()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    digest = hashlib.sha256(
        (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def compile_library(cmd, source: Path, out: Path) -> Path:
    """Run ``cmd + ["-o", <tmp>, source]`` unless ``out`` exists; return
    ``out``. Compiles to a private name, then renames: concurrent builders
    never load a half-written library."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed on {source.name}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library exists; return its path."""
    out = library_path(source)
    if out.exists():
        return out
    return compile_library([_nvcc(), *NVCC_FLAGS], CSRC / source, out)


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<source>``."""
    return ctypes.CDLL(str(build(source)))
