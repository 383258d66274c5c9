"""Build the port's CUDA kernels from the package's sources, at first use.

Each ``csrc/<name>.cu`` (``flash_fwd``: K1; ``flash_bwd``: K2 and K3;
``conv_bn``: K4; ``scatter_rows``: K5) is compiled by its own ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface,
``build/kernels/lib<name>-<hash>.so`` under the checkout's root, and loaded
with :mod:`ctypes`. The hash covers the source
and the flags, so an edited source builds anew and an unchanged one is
loaded as it is. ``nvcc -Xptxas -v`` reports each kernel's registers,
shared memory and spills into a ``.log`` beside the library.
:func:`build_all` starts one ``nvcc`` per source together.

Nothing here runs at import: the CPU tests import every module, and a
process that never launches a kernel never builds one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
#: every source of the port's kernels
SOURCES = ("flash_fwd", "flash_bwd", "conv_bn", "scatter_rows")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless it is built already; returns the
    library's path. Raises with the compiler's output when the build fails."""
    path = library_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    path.with_suffix(".log").write_text(out.stdout)
    if out.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc {out.returncode}):\n{out.stdout}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


def build_all() -> list[Path]:
    """Build every source with one ``nvcc`` each, all started together."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return list(pool.map(build, SOURCES))


def build_log(name: str) -> str:
    """What nvcc printed for ``name`` (ptxas register/spill report)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first when needed."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]
