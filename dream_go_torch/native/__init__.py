"""Native (C++) host-side example extraction, loaded with ctypes (port of
`dream_go_tpu/native/__init__.py`).

``sgf_extract.cc`` parses a big-SGF line, decodes its policy blobs, draws a
value-weighted training position and assembles the labels.  It builds with
``g++ -O3`` at first use into ``libdg_data-<hash>.so`` in the port's build
directory (``build/kernels``, or ``$DG_TORCH_BUILD_DIR``; the hash covers
the source and the flags).  Where there is no ``g++``,
:func:`available` says so and the pipeline parses in Python; a ``g++``
that fails to build the source raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops.build import build_dir

SOURCE = Path(__file__).resolve().parent / "sgf_extract.cc"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_MAX_MOVES = 1024
_lock = threading.Lock()
_lib = None
#: extract_batch calls, counted as the kernels count their launches
calls = 0


class _Example(ctypes.Structure):
    _fields_ = [
        ("num_moves", ctypes.c_int32),
        ("target", ctypes.c_int32),
        ("color", ctypes.c_int32),
        ("komi", ctypes.c_float),
        ("value", ctypes.c_float),
        ("has_ownership", ctypes.c_float),
        ("moves", ctypes.c_int32 * _MAX_MOVES),
        ("policy", ctypes.c_float * 362),
        ("ownership", ctypes.c_float * 361),
    ]


def _build() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode())
    out = build_dir() / f"libdg_data-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            if shutil.which("g++") is None:
                _lib = False
                return _lib
            lib = ctypes.CDLL(str(_build()))
            lib.extract_single_example.restype = ctypes.c_int
            lib.extract_single_example.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.POINTER(_Example)]
            lib.extract_batch.restype = ctypes.c_int
            lib.extract_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.c_uint64, ctypes.POINTER(_Example)]
            lib.dg_native_abi_version.restype = ctypes.c_int
            lib.dg_native_abi_version.argtypes = []
            if lib.dg_native_abi_version() != 1:
                raise RuntimeError("libdg_data: unknown ABI version")
            _lib = lib
        return _lib


def available() -> bool:
    return _load() is not False


def extract_batch(lines: list[str], seed: int) -> dict:
    """One example per line: numpy arrays and a validity mask (False rows
    failed to parse or have fewer than 30 moves)."""
    global calls
    lib = _load()
    if lib is False:
        raise RuntimeError("native loader unavailable: no g++")
    calls += 1
    n = len(lines)
    out = (_Example * n)()
    arr = (ctypes.c_char_p * n)(*[line.encode() for line in lines])
    lib.extract_batch(arr, n, ctypes.c_uint64(seed or 1), out)

    valid = np.zeros(n, bool)
    moves = np.full((n, _MAX_MOVES), 361, np.int32)
    targets = np.zeros(n, np.int32)
    komi = np.zeros(n, np.float32)
    policy = np.zeros((n, 362), np.float32)
    value = np.zeros(n, np.float32)
    ownership = np.zeros((n, 361), np.float32)
    has_ownership = np.zeros(n, np.float32)
    for i in range(n):
        e = out[i]
        if e.num_moves < 30 or e.num_moves > _MAX_MOVES:
            continue
        valid[i] = True
        moves[i] = np.ctypeslib.as_array(e.moves)
        targets[i] = e.target
        komi[i] = e.komi
        policy[i] = np.ctypeslib.as_array(e.policy)
        value[i] = e.value
        ownership[i] = np.ctypeslib.as_array(e.ownership)
        has_ownership[i] = e.has_ownership
    return dict(valid=valid, moves=moves, targets=targets, komi=komi,
                policy=policy, value=value, ownership=ownership,
                has_ownership=has_ownership,
                num_moves=np.asarray([out[i].num_moves for i in range(n)],
                                     np.int32))
