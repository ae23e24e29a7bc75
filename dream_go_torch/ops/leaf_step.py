"""One MCTS leaf expansion: apply the selected action, then featurize the
new position.

Replaces the Pallas TPU kernel `dream_go_tpu/ops/leaf_step.py::leaf_step`
(``_make_kernel._kernel``, ``_chain_stats_g``) with a CUDA kernel written
for Hopper, ``csrc/leaf_step.cu`` (one block of 384 threads per board; no
serial section, chain sets built without atomics, liberties after a move
counted directly outside the multi-chain cases, super-ko through a ring
filter), built with ``nvcc`` and bound with ``ctypes`` (see
:mod:`dream_go_torch.ops.build`).  For each board it:

- applies the action (capture, merge, zobrist and chain-xor update, ring
  insert, pass and done handling);
- computes the 32 V1 planes and the StandardSearch candidate mask of the
  new position (chain liberties, liberties after a move for both colours,
  super-ko against the ring, pseudo-legality).

Inputs are the kernel-layout state arrays of :mod:`ops.layout`:
stones/cid i32[B,1,384], cxp i32[B,2,384], hist i32[B,2,128], meta/hashw
i32[B,1,8]; ``action`` i32[B] (361 = pass) and ``komi`` f32[B].  Returns
``(leaf_packed, feats, cand)``: the six arrays of the new position, the
planes f32[B,32,384] (plane-major) and cand bool[B,361].

:func:`leaf_step_plain` is the same function in plain PyTorch (the rules
engine and the feature extractor); :func:`leaf_step` runs it for tensors on
the CPU and launches the kernel for tensors on a CUDA device;
:func:`leaf_step_checked` launches the kernel's bounds-checked build
(``-DDG_CHECK``), whose device-side asserts trap on an index out of range
or a chain id that is not a live chain's root.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..go import engine
from ..go.features import features_v1
from ..go.options import standard_mask
from ..go.topology import NN
from . import build, layout
from .layout import NP

#: kernel launches made by :func:`leaf_step` (CPU calls do not count)
launches = 0


def leaf_step_plain(stones, cid, cxp, hist, meta, hashw, action, komi):
    """Plain PyTorch version of the kernel (same inputs and outputs)."""
    b = stones.shape[0]
    template = engine.new_states(b, device=stones.device).replace(komi=komi)
    state = layout.unpack_states(template, stones, cid, cxp, hist, meta,
                                 hashw)
    new = engine.step(state, action)
    rows = layout.repack_rows(new, stones, cid, cxp, hist, meta, hashw)
    feats = torch.zeros(b, 32, NP, dtype=torch.float32, device=stones.device)
    feats[:, :, :NN] = features_v1(new).reshape(b, NN, 32).transpose(1, 2)
    cand = standard_mask(new)[:, :NN]
    return rows, feats, cand


@functools.lru_cache(maxsize=None)
def _kernel(check: bool):
    fn = build.load("leaf_step", check).dg_leaf_step
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def leaf_step(stones, cid, cxp, hist, meta, hashw, action, komi):
    """Apply ``action`` per board and featurize the result (see module
    docstring).  CPU tensors take :func:`leaf_step_plain`; CUDA tensors
    launch the kernel on the current stream."""
    return _step(stones, cid, cxp, hist, meta, hashw, action, komi,
                 check=False)


def leaf_step_checked(stones, cid, cxp, hist, meta, hashw, action, komi):
    """:func:`leaf_step` with the kernel's bounds-checked build: an index
    out of range traps, and the next synchronisation raises."""
    return _step(stones, cid, cxp, hist, meta, hashw, action, komi,
                 check=True)


def _step(stones, cid, cxp, hist, meta, hashw, action, komi, check: bool):
    global launches
    if stones.device.type == "cpu":
        return leaf_step_plain(stones, cid, cxp, hist, meta, hashw, action,
                               komi)
    if stones.device.type != "cuda":
        raise ValueError(f"leaf_step: unsupported device {stones.device}")
    dev = stones.device
    b = stones.shape[0]
    state = dict(stones=stones, cid=cid, cxp=cxp, hist=hist, meta=meta,
                 hashw=hashw)
    for name, t in state.items():
        build.check_arg("leaf_step", name, t, torch.int32,
                        (b,) + layout.ROW_SHAPES[name], dev)
    build.check_arg("leaf_step", "action", action, torch.int32, (b,), dev)
    build.check_arg("leaf_step", "komi", komi, torch.float32, (b,), dev)
    outs = [torch.empty_like(t) for t in state.values()]
    feats = torch.empty(b, 32, NP, dtype=torch.float32, device=dev)
    cand = torch.empty(b, NN, dtype=torch.bool, device=dev)
    if b == 0:
        return tuple(outs), feats, cand
    zob = layout.zobrist_rows(str(dev))
    ptrs = [t.data_ptr() for t in (*state.values(), action, komi, zob,
                                   *outs, feats, cand)]
    build.launch("leaf_step", _kernel(check), dev, *ptrs, b)
    launches += 1
    return tuple(outs), feats, cand
