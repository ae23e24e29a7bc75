"""Ladder feature planes 30/31 with the exact branching reader, every
candidate of every board.

Replaces the Pallas TPU kernel `dream_go_tpu/ops/ladder_kernel.py`
(``ladder_planes_kernel``) with a CUDA kernel written for Hopper,
``csrc/ladder_planes.cu`` (one block per board, one warp per chase, the
chase's board as bitboards in its registers), built with ``nvcc`` and
bound with ``ctypes`` (:mod:`dream_go_torch.ops.build`).

Inputs are kernel-layout rows (:mod:`ops.layout`): stones, cid
i32[B, 1, 384] and to_move i32[B].  Returns ``(capture, escape)``
bool[B, 361].  ``budget`` (rungs per chase) and ``stack_cap`` (branch
stack depth, at most ``STACK_CAP``) default to the reader's bounds; the
tests lower them to pin the fail-safe behaviour.

:func:`ladder_planes_plain` is the same function in plain PyTorch: the
lockstep reader of :mod:`dream_go_torch.go.ladder` with no candidate
bound.  :func:`ladder_planes_kernel` runs it for tensors on the CPU and
launches the kernel for tensors on a CUDA device;
:func:`ladder_planes_checked` launches the kernel's bounds-checked build
(``-DDG_CHECK``), whose device-side asserts trap on an index out of range.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..go import ladder
from ..go.ladder import BUDGET, STACK_CAP
from ..go.topology import NN
from . import build, layout
from .layout import NP

#: kernel launches made by :func:`ladder_planes_kernel` (CPU calls do not
#: count)
launches = 0


def ladder_planes_plain(stones, cid, to_move, budget: int = BUDGET,
                        stack_cap: int = STACK_CAP,
                        stats: dict | None = None):
    """Plain PyTorch version of the kernel (same inputs and outputs);
    ``stats`` gets the rungs the reading needs
    (:func:`dream_go_torch.go.ladder.ladder_planes`)."""
    return ladder.ladder_planes(
        layout.rows_to_states(stones, cid, to_move), max_candidates=None,
        max_escapes=None, budget=budget, stack_cap=stack_cap, stats=stats)


@functools.lru_cache(maxsize=None)
def _kernel(check: bool):
    fn = build.load("ladder_planes", check).dg_ladder_planes
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ladder_planes_kernel(stones, cid, to_move, budget: int = BUDGET,
                         stack_cap: int = STACK_CAP):
    """Planes 30/31 (see module docstring).  CPU tensors take
    :func:`ladder_planes_plain`; CUDA tensors launch the kernel on the
    current stream."""
    return _planes(stones, cid, to_move, budget, stack_cap, check=False)


def ladder_planes_checked(stones, cid, to_move, budget: int = BUDGET,
                          stack_cap: int = STACK_CAP):
    """:func:`ladder_planes_kernel` with the kernel's bounds-checked build:
    an index out of range traps, and the next synchronisation raises."""
    return _planes(stones, cid, to_move, budget, stack_cap, check=True)


def _planes(stones, cid, to_move, budget, stack_cap, check: bool):
    global launches
    if not 0 <= stack_cap <= STACK_CAP:
        raise ValueError(f"ladder_planes: stack_cap must be in "
                         f"[0, {STACK_CAP}], got {stack_cap}")
    if stones.device.type == "cpu":
        return ladder_planes_plain(stones, cid, to_move, budget, stack_cap)
    if stones.device.type != "cuda":
        raise ValueError(f"ladder_planes: unsupported device {stones.device}")
    dev = stones.device
    b = stones.shape[0]
    for name, t, shape in (("stones", stones, (b, 1, NP)),
                           ("cid", cid, (b, 1, NP)),
                           ("to_move", to_move, (b,))):
        build.check_arg("ladder_planes", name, t, torch.int32, shape, dev)
    cap = torch.empty(b, NN, dtype=torch.bool, device=dev)
    esc = torch.empty(b, NN, dtype=torch.bool, device=dev)
    if b == 0:
        return cap, esc
    build.launch("ladder_planes", _kernel(check), dev, stones.data_ptr(),
                 cid.data_ptr(), to_move.data_ptr(), int(budget),
                 int(stack_cap), cap.data_ptr(), esc.data_ptr(), b)
    launches += 1
    return cap, esc
