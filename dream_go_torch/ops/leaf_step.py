"""One MCTS leaf expansion: apply the selected action, then featurize the
new position.

Replaces the Pallas TPU kernel `dream_go_tpu/ops/leaf_step.py::leaf_step`
(``_make_kernel._kernel``, ``_chain_stats_g``) with a CUDA kernel written
for Hopper, ``csrc/leaf_step.cu``, built with ``nvcc`` and bound with
``ctypes`` (see :mod:`dream_go_torch.ops.build`).  For each board it:

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
the CPU and launches the kernel for tensors on a CUDA device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..go import engine
from ..go.features import features_v1
from ..go.options import standard_mask
from ..go.topology import NN
from ..go.zobrist import Z_I32
from . import build, layout
from .layout import NP, RING

#: kernel launches made by :func:`leaf_step` (CPU calls do not count)
launches = 0


def leaf_step_plain(stones, cid, cxp, hist, meta, hashw, action, komi):
    """Plain PyTorch version of the kernel (same inputs and outputs)."""
    b = stones.shape[0]
    template = engine.new_states(b, device=stones.device).replace(komi=komi)
    state = layout.unpack_states(template, stones, cid, cxp, hist, meta,
                                 hashw)
    new = engine.step(state, action)
    # write back into copies of the inputs: padding lanes, ring columns
    # 64..127, meta[7] and hash words 2..7 pass through as in the kernel,
    # and the per-point chain aggregate is not re-masked
    stones2, cid2, cxp2 = stones.clone(), cid.clone(), cxp.clone()
    hist2, meta2, hash2 = hist.clone(), meta.clone(), hashw.clone()
    stones2[:, 0, :NN] = new.stones.to(torch.int32)
    cid2[:, 0, :NN] = new.chain_id
    cxp2[:, :, :NN] = new.chain_xor.transpose(1, 2)
    hist2[:, :, :RING] = new.hash_hist.transpose(1, 2)
    meta2[:, 0, :7] = torch.stack([
        new.to_move.to(torch.int32), new.placed_count, new.move_count,
        new.pass_count, new.done.to(torch.int32), new.last_two[:, 0],
        new.last_two[:, 1]], dim=1)
    hash2[:, 0, :2] = new.hash
    feats = torch.zeros(b, 32, NP, dtype=torch.float32, device=stones.device)
    feats[:, :, :NN] = features_v1(new).reshape(b, NN, 32).transpose(1, 2)
    cand = standard_mask(new)[:, :NN]
    return (stones2, cid2, cxp2, hist2, meta2, hash2), feats, cand


@functools.lru_cache(maxsize=None)
def _zobrist(device: str) -> torch.Tensor:
    """i32[4, 384]: black word 0, black word 1, white word 0, white word 1
    (zero on padding lanes)."""
    z = np.zeros((4, NP), np.int32)
    z[0, :NN], z[1, :NN] = Z_I32[0, :, 0], Z_I32[0, :, 1]
    z[2, :NN], z[3, :NN] = Z_I32[1, :, 0], Z_I32[1, :, 1]
    return torch.as_tensor(z, device=torch.device(device))


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("leaf_step").dg_leaf_step
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_SHAPES = {"stones": (1, NP), "cid": (1, NP), "cxp": (2, NP),
           "hist": (2, 128), "meta": (1, 8), "hashw": (1, 8)}


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"leaf_step: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"leaf_step: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"leaf_step: {name} must have shape {shape}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"leaf_step: {name} must be contiguous")


def leaf_step(stones, cid, cxp, hist, meta, hashw, action, komi):
    """Apply ``action`` per board and featurize the result (see module
    docstring).  CPU tensors take :func:`leaf_step_plain`; CUDA tensors
    launch the kernel on the current stream."""
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
        _check(name, t, torch.int32, (b,) + _SHAPES[name], dev)
    _check("action", action, torch.int32, (b,), dev)
    _check("komi", komi, torch.float32, (b,), dev)
    outs = [torch.empty_like(t) for t in state.values()]
    feats = torch.empty(b, 32, NP, dtype=torch.float32, device=dev)
    cand = torch.empty(b, NN, dtype=torch.bool, device=dev)
    if b == 0:
        return tuple(outs), feats, cand
    zob = _zobrist(str(dev))
    ptrs = [t.data_ptr() for t in (*state.values(), action, komi, zob,
                                   *outs, feats, cand)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(*ptrs, b, stream)
    if err != 0:
        raise RuntimeError(f"leaf_step kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return tuple(outs), feats, cand
