"""V1 input feature planes for a batch of boards.

Port of `dream_go_tpu/go/features.py` (``features_v1``, ``liberties_if``,
``extract_batch``) for the V1 set without ladder planes.  Plane order
(`features.rs:104-148`):

  0  komi plane if black to move     1  komi plane if white to move
  2  constant: any move is super-ko  3  most recent move   4 previous move
  5-10   own liberties >= 1..6       11-16  own liberties after move >= 1..6
  17-22  opp liberties >= 1..6       23-28  opp liberties after move >= 1..6
  29 is-super-ko  30/31 ladder capture/escape (zero here)

"Liberties after move" comes from the counting identity

    libs_if[p] = #{e != p : (e empty or captured by p)
                            and (e adjacent to p or to an own chain
                                 adjacent to p)}.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .engine import (BLACK, EMPTY, OFFBOARD, GoState, chain_liberties,
                     pseudo_legal_mask, superko_mask)
from .topology import NBR, NN

NUM_FEATURES_V1 = 32


@functools.lru_cache(maxsize=None)
def _static(device: str):
    adj = np.zeros((NN, NN), dtype=bool)
    for p in range(NN):
        for q in NBR[p]:
            if q < NN:
                adj[p, q] = True
    dev = torch.device(device)
    return (torch.as_tensor(adj, device=dev),
            torch.eye(NN, dtype=torch.bool, device=dev),
            torch.as_tensor(NBR, dtype=torch.long, device=dev))


def _adjacency(member: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """member [B, q, c] -> [B, x, c]: x is adjacent to a member of c."""
    mp = torch.cat([member, torch.zeros_like(member[:, :1])], dim=1)
    return (mp[:, nbr[:, 0]] | mp[:, nbr[:, 1]] | mp[:, nbr[:, 2]]
            | mp[:, nbr[:, 3]])


def liberties_if(state: GoState, color, chain_libs=None) -> torch.Tensor:
    """int32[B, 361]: liberties of the chain formed by playing ``color`` at
    each point (garbage at non-pseudo-legal points; mask upstream).
    Vectorized `get_n_liberty_if` (`board_fast.rs:484-539`)."""
    adj_static, eye, nbr = _static(str(state.stones.device))
    stones, cid = state.stones, state.chain_id
    col = torch.as_tensor(color, device=stones.device).to(stones.dtype)
    col = col.reshape(-1, 1) if col.dim() else col.expand(
        stones.shape[0]).reshape(-1, 1)
    opp = OFFBOARD - col
    if chain_libs is None:
        _, chain_libs = chain_liberties(stones, cid)

    iota = torch.arange(NN, device=stones.device)
    onehot = cid[:, :, None] == iota[None, None, :]             # [B, q, c]
    member_own = onehot & (stones == col)[:, :, None]
    own_adj = _adjacency(member_own, nbr).float()               # [B, x, c]
    match = torch.bmm(own_adj, own_adj.transpose(1, 2)) > 0     # [B, p, e]

    libs1 = chain_libs[:, :NN] == 1
    member_cap = onehot & (stones == opp)[:, :, None] & libs1[:, None, :]
    cap_adj = _adjacency(member_cap, nbr).float()
    cap_member = torch.bmm(cap_adj, member_cap.float().transpose(1, 2)) > 0

    empty = (stones == EMPTY)[:, None, :]
    open_after = empty | cap_member
    reaches = adj_static[None] | match
    return (open_after & reaches & ~eye[None]).sum(-1, dtype=torch.int32)


def features_v1(state: GoState) -> torch.Tensor:
    """float32[B, 19, 19, 32] V1 planes (NHWC, the JAX package's layout)."""
    stones = state.stones
    me = state.to_move.reshape(-1, 1)
    opp = OFFBOARD - me
    point_libs, chain_libs = chain_liberties(stones, state.chain_id)
    own_libs = torch.where(stones == me, point_libs, 0)
    opp_libs = torch.where(stones == opp, point_libs, 0)

    valid_me = pseudo_legal_mask(state, state.to_move)
    valid_opp = pseudo_legal_mask(state, opp.reshape(-1))
    libs_if_me = torch.where(
        valid_me, liberties_if(state, state.to_move, chain_libs), 0)
    libs_if_opp = torch.where(
        valid_opp, liberties_if(state, opp.reshape(-1), chain_libs), 0)

    ko = superko_mask(state, state.to_move) & valid_me
    any_ko = ko.any(-1, keepdim=True)

    b = stones.shape[0]
    komi_c = torch.clamp(0.5 + 0.5 * state.komi / 7.5, 0.0, 1.0)[:, None]
    ones = torch.ones(b, NN, device=stones.device)
    iota = torch.arange(NN, device=stones.device)[None, :]
    f32 = lambda x: x.to(torch.float32)
    one_hot = lambda p: f32((iota == p[:, None]) & (p[:, None] < NN))

    planes = [ones * f32(me == BLACK) * komi_c,
              ones * f32(me != BLACK) * komi_c,
              ones * f32(any_ko),
              one_hot(state.last_two[:, 0]),
              one_hot(state.last_two[:, 1])]
    planes += [f32(own_libs >= k) for k in range(1, 7)]
    planes += [f32(libs_if_me >= k) for k in range(1, 7)]
    planes += [f32(opp_libs >= k) for k in range(1, 7)]
    planes += [f32(libs_if_opp >= k) for k in range(1, 7)]
    planes.append(f32(ko))
    zeros = torch.zeros(b, NN, device=stones.device)
    planes += [zeros, zeros]
    return torch.stack(planes, dim=-1).reshape(b, 19, 19, NUM_FEATURES_V1)


def extract_batch(states: GoState) -> torch.Tensor:
    """Batched network input: the V1 planes (the only plane set the port
    computes so far; ladder planes 30/31 stay zero)."""
    return features_v1(states)
