"""Per-point feature ingredients of the V1 planes: liberties after a move
for both colours, chain liberties and pseudo-legality.

Replaces the Pallas TPU kernel `dream_go_tpu/ops/libs_after.py` (one
``_kernel`` behind ``liberties_after_both`` and ``board_features_raw``)
with one CUDA kernel written for Hopper, ``csrc/libs_after.cu`` (a block
of four warps per board, its point sets as bitboards, member words only
for live chains, direct counts and the set union only where a point needs
it), built with ``nvcc`` and bound with ``ctypes``
(:mod:`dream_go_torch.ops.build`).  :func:`features_raw_checked` launches
the kernel's bounds-checked build (``-DDG_CHECK``), whose device-side
asserts trap on an index out of range or a chain id that is not its
chain's root.

:func:`features_raw` takes kernel-layout rows (stones, cid
i32[B, 1, 384], :mod:`ops.layout`) and returns i32[B, 5, 361]: rows
libs_if_black, libs_if_white, point_libs, pseudo_black, pseudo_white.  For
tensors on the CPU it runs :func:`features_raw_plain` (the port's rules
engine and ``features.liberties_if``); for tensors on a CUDA device it
launches the kernel.  :func:`liberties_after_both` and
:func:`board_features_raw` are the JAX package's two wrappers over it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..go import engine
from ..go.engine import BLACK, WHITE, GoState
from ..go.features import liberties_if
from ..go.topology import NN
from . import build, layout
from .layout import NP

#: kernel launches made by :func:`features_raw` (CPU calls do not count)
launches = 0


def features_raw_plain(stones, cid) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same inputs and output)."""
    state = layout.rows_to_states(stones, cid)
    point_libs, chain_libs = engine.chain_liberties(state.stones,
                                                    state.chain_id)
    return torch.stack([
        liberties_if(state, BLACK, chain_libs),
        liberties_if(state, WHITE, chain_libs),
        point_libs,
        engine.pseudo_legal_mask(state, BLACK).to(torch.int32),
        engine.pseudo_legal_mask(state, WHITE).to(torch.int32)], dim=1)


@functools.lru_cache(maxsize=None)
def _kernel(check: bool):
    fn = build.load("libs_after", check).dg_libs_after
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def features_raw(stones, cid) -> torch.Tensor:
    """i32[B, 5, 361] (see module docstring).  CPU tensors take
    :func:`features_raw_plain`; CUDA tensors launch the kernel on the
    current stream."""
    return _features(stones, cid, check=False)


def features_raw_checked(stones, cid) -> torch.Tensor:
    """:func:`features_raw` with the kernel's bounds-checked build: an index
    out of range traps, and the next synchronisation raises."""
    return _features(stones, cid, check=True)


def _features(stones, cid, check: bool) -> torch.Tensor:
    global launches
    if stones.device.type == "cpu":
        return features_raw_plain(stones, cid)
    if stones.device.type != "cuda":
        raise ValueError(f"libs_after: unsupported device {stones.device}")
    dev = stones.device
    b = stones.shape[0]
    for name, t in (("stones", stones), ("cid", cid)):
        build.check_arg("libs_after", name, t, torch.int32, (b, 1, NP), dev)
    out = torch.empty(b, 5, NN, dtype=torch.int32, device=dev)
    if b == 0:
        return out
    build.launch("libs_after", _kernel(check), dev, stones.data_ptr(),
                 cid.data_ptr(), out.data_ptr(), b)
    launches += 1
    return out


def liberties_after_both(states: GoState):
    """``(libs_if_black, libs_if_white)`` i32[B, 361]: exact counts (the
    identity's value at points that are not pseudo-legal; mask upstream)."""
    out = features_raw(*layout.board_rows(states))
    return out[:, 0], out[:, 1]


def board_features_raw(states: GoState) -> dict:
    """One kernel pass -> libs_if_black/white, point_libs (i32[B, 361]),
    pseudo_black/white (bool[B, 361])."""
    out = features_raw(*layout.board_rows(states))
    return dict(libs_if_black=out[:, 0], libs_if_white=out[:, 1],
                point_libs=out[:, 2], pseudo_black=out[:, 3] > 0,
                pseudo_white=out[:, 4] > 0)
