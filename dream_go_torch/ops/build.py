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

``check=True`` builds a kernel's bounds-checked variant (``-DDG_CHECK``:
device-side asserts on its indices, where the source has them) into its
own ``lib<name>-check-<hash>.so``, beside the release build.
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
CHECK_FLAGS = ["-DDG_CHECK"]

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


def _flags(check: bool) -> list[str]:
    return NVCC_FLAGS + CHECK_FLAGS if check else NVCC_FLAGS


def _tag(name: str, check: bool) -> str:
    return f"{name}-check" if check else name


def library_path(name: str, check: bool = False) -> Path:
    """Where the library for kernel ``name`` (``csrc/<name>.cu``) lives."""
    h = hashlib.sha256(" ".join(_flags(check)).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"lib{_tag(name, check)}-{h.hexdigest()[:16]}.so"


def build(name: str, check: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    its compiler output goes to ``BUILD_LOGS`` under ``name`` (or
    ``<name>-check``)."""
    out = library_path(name, check)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *_flags(check), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    BUILD_LOGS[_tag(name, check)] = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def load(name: str, check: bool = False) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(_tag(name, check))
        if lib is None:
            lib = ctypes.CDLL(str(build(name, check)))
            _LIBS[_tag(name, check)] = lib
        return lib


def check_arg(kernel: str, name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and
    ``shape`` on ``device`` (what a kernel's wrapper accepts)."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def launch(kernel: str, fn, device, *args) -> None:
    """Call the C launcher ``fn(*args, stream)`` on ``device``'s current
    stream; raise if it reports a CUDA error."""
    import torch

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
