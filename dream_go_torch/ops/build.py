"""Build and load the port's CUDA kernels: plain ``nvcc`` into a shared
library with a C interface, loaded with ``ctypes``.

Each kernel source under ``dream_go_torch/csrc/`` builds into its own
``lib<name>-<hash>.so`` in the build directory (``build/kernels`` at the
repository root, or ``$DG_TORCH_BUILD_DIR``).  The hash covers the source
files and the compiler flags, so an unchanged kernel is not rebuilt, and
the library is written to a temporary name and renamed into place, so
builds started in parallel never load a half-written file.  Nothing here
runs when a module is imported: a build happens at a kernel's first
launch (or when a caller asks for it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: compiler output (``-Xptxas -v`` register and shared-memory report) per
#: kernel built by this process
BUILD_LOGS: dict[str, str] = {}


def build_dir() -> Path:
    default = Path(__file__).resolve().parents[2] / "build" / "kernels"
    return Path(os.environ.get("DG_TORCH_BUILD_DIR", default))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def library_path(name: str) -> Path:
    """Where the library for kernel ``name`` (``csrc/<name>.cu``) lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib
