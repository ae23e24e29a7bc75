"""Kernel state layout: one padded row set per board.

Port of `dream_go_tpu/ops/env_step.py:301-351` (``pack_states`` /
``unpack_states``) and its constants.  The layout, per board:

  stones  i32[1, 384]   0 empty / 1 black / 2 white (pad 0)
  cid     i32[1, 384]   chain id (point index of min member)
  cxp     i32[2, 384]   per-point chain zobrist aggregate (2 words)
  hist    i32[2, 128]   super-ko ring, 64 entries used (2 words)
  meta    i32[1, 8]     to_move, placed, move_count, pass_count, done,
                        last0, last1, pad
  hash    i32[1, 8]     words 0..1 used

The point axis is padded from 361 to ``NP = 384``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..go.engine import GoState, new_states
from ..go.topology import NN
from ..go.zobrist import Z_I32

NP = 384   # padded point axis
RING = 64  # super-ko history entries
N = 19

_IDX = np.arange(NP)
VALID = _IDX < NN
#: per direction, the lanes whose neighbour at ``q - shift`` is on board
MASK = {
    +1: VALID & (_IDX % N > 0),
    -1: VALID & (_IDX % N < N - 1),
    +N: VALID & (_IDX >= N),
    -N: VALID & (_IDX + N < NN),
}
SHIFTS = (1, -1, N, -N)
#: per-board shape of each of the six arrays, as the kernels take them
ROW_SHAPES = {"stones": (1, NP), "cid": (1, NP), "cxp": (2, NP),
              "hist": (2, 128), "meta": (1, 8), "hashw": (1, 8)}


@functools.lru_cache(maxsize=None)
def zobrist_rows(device: str) -> torch.Tensor:
    """i32[4, 384] zobrist table of the kernels: black word 0, black word
    1, white word 0, white word 1 (zero on padding lanes)."""
    z = np.zeros((4, NP), np.int32)
    z[0, :NN], z[1, :NN] = Z_I32[0, :, 0], Z_I32[0, :, 1]
    z[2, :NN], z[3, :NN] = Z_I32[1, :, 0], Z_I32[1, :, 1]
    return torch.as_tensor(z, device=torch.device(device))


def _pad_points(x: torch.Tensor, fill=0) -> torch.Tensor:
    extra = torch.full(x.shape[:1] + (NP - x.shape[1],) + x.shape[2:], fill,
                       dtype=x.dtype, device=x.device)
    return torch.cat([x, extra], dim=1)


def pack_states(states: GoState):
    """Batched GoState -> the six kernel state arrays."""
    b = states.batch
    stones = _pad_points(states.stones.to(torch.int32))
    cid = _pad_points(states.chain_id)
    cx = torch.where((states.stones != 0)[..., None], states.chain_xor, 0)
    cxp = _pad_points(cx).transpose(1, 2).contiguous()          # [B, 2, NP]
    hist = states.hash_hist.transpose(1, 2)                     # [B, 2, K]
    hist = torch.cat([hist, hist.new_zeros(b, 2, 128 - hist.shape[2])], 2)
    meta = torch.stack([
        states.to_move.to(torch.int32), states.placed_count,
        states.move_count, states.pass_count, states.done.to(torch.int32),
        states.last_two[:, 0], states.last_two[:, 1],
        torch.zeros_like(states.move_count)], dim=1)[:, None, :]
    hashw = torch.cat([states.hash, states.hash.new_zeros(b, 6)], 1)
    return (stones[:, None, :], cid[:, None, :], cxp, hist.contiguous(),
            meta, hashw[:, None, :])


def repack_rows(states: GoState, stones, cid, cxp, hist, meta, hashw):
    """The six kernel arrays of ``states``, written into copies of the
    given arrays: padding lanes, ring columns 64..127, meta[7] and hash
    words 2..7 pass through as a kernel passes them, and the per-point
    chain aggregate is taken as the state holds it (not re-masked)."""
    stones, cid, cxp = stones.clone(), cid.clone(), cxp.clone()
    hist, meta, hashw = hist.clone(), meta.clone(), hashw.clone()
    stones[:, 0, :NN] = states.stones.to(torch.int32)
    cid[:, 0, :NN] = states.chain_id
    cxp[:, :, :NN] = states.chain_xor.transpose(1, 2)
    hist[:, :, :RING] = states.hash_hist.transpose(1, 2)
    meta[:, 0, :7] = torch.stack([
        states.to_move.to(torch.int32), states.placed_count,
        states.move_count, states.pass_count, states.done.to(torch.int32),
        states.last_two[:, 0], states.last_two[:, 1]], dim=1)
    hashw[:, 0, :2] = states.hash
    return stones, cid, cxp, hist, meta, hashw


def board_rows(states: GoState):
    """The stones and cid rows of :func:`pack_states` alone."""
    return (_pad_points(states.stones.to(torch.int32))[:, None, :],
            _pad_points(states.chain_id)[:, None, :])


def unpack_states(template: GoState, stones, cid, cxp, hist, meta,
                  hashw) -> GoState:
    """Kernel state arrays -> batched GoState (komi from ``template``)."""
    return template.replace(
        stones=stones[:, 0, :NN].to(torch.int8),
        chain_id=cid[:, 0, :NN],
        chain_xor=cxp.transpose(1, 2)[:, :NN, :].contiguous(),
        to_move=meta[:, 0, 0].to(torch.int8),
        hash=hashw[:, 0, :2],
        hash_hist=hist[:, :, :RING].transpose(1, 2).contiguous(),
        placed_count=meta[:, 0, 1],
        move_count=meta[:, 0, 2],
        pass_count=meta[:, 0, 3],
        last_two=torch.stack([meta[:, 0, 5], meta[:, 0, 6]], dim=1),
        done=meta[:, 0, 4] != 0,
    )


def rows_to_states(stones, cid, to_move=None) -> GoState:
    """Stones and cid rows (and to_move) -> a GoState holding those
    fields; the others are those of fresh boards."""
    state = new_states(stones.shape[0], device=stones.device).replace(
        stones=stones[:, 0, :NN].to(torch.int8),
        chain_id=cid[:, 0, :NN].contiguous())
    if to_move is not None:
        state = state.replace(to_move=to_move.to(torch.int8))
    return state
