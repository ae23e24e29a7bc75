"""Input feature planes for a batch of boards.

Port of `dream_go_tpu/go/features.py` (``features_v1``, ``liberties_if``,
``features_v1_batch``, ``features_v1_full``, ``apply_symmetry``,
``features_v2``, ``extract_batch``).  V1 plane order (`features.rs:104-148`):

  0  komi plane if black to move     1  komi plane if white to move
  2  constant: any move is super-ko  3  most recent move   4 previous move
  5-10   own liberties >= 1..6       11-16  own liberties after move >= 1..6
  17-22  opp liberties >= 1..6       23-28  opp liberties after move >= 1..6
  29 is-super-ko  30/31 ladder capture/escape (`go/ladder.py`)

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
from .topology import NBR, NN, SYM

NUM_FEATURES_V1 = 32
NUM_FEATURES_V2 = 18
_INV_7_5 = float(np.float32(1.0 / 7.5))


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


def features_v1(state: GoState, ladder_capture=None, ladder_escape=None,
                libs_after=None, point_libs=None,
                pseudo=None) -> torch.Tensor:
    """float32[B, 19, 19, 32] V1 planes (NHWC, the JAX package's layout).

    ``ladder_capture``/``ladder_escape`` (bool[B, 361]) fill planes 30/31
    (zero when absent).  ``libs_after`` (the to-move and opponent
    liberties after a move), ``point_libs`` and ``pseudo`` (to-move and
    opponent pseudo-legality) may come precomputed from the feature kernel
    (`ops/libs_after.py`)."""
    stones = state.stones
    me = state.to_move.reshape(-1, 1)
    opp = OFFBOARD - me
    chain_libs = None
    if point_libs is None:
        point_libs, chain_libs = chain_liberties(stones, state.chain_id)
    own_libs = torch.where(stones == me, point_libs, 0)
    opp_libs = torch.where(stones == opp, point_libs, 0)

    if pseudo is not None:
        valid_me, valid_opp = pseudo
    else:
        valid_me = pseudo_legal_mask(state, state.to_move)
        valid_opp = pseudo_legal_mask(state, opp.reshape(-1))
    if libs_after is not None:
        raw_me, raw_opp = libs_after
    else:
        raw_me = liberties_if(state, state.to_move, chain_libs)
        raw_opp = liberties_if(state, opp.reshape(-1), chain_libs)
    libs_if_me = torch.where(valid_me, raw_me, 0)
    libs_if_opp = torch.where(valid_opp, raw_opp, 0)

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
    planes.append(zeros if ladder_capture is None else f32(ladder_capture))
    planes.append(zeros if ladder_escape is None else f32(ladder_escape))
    return torch.stack(planes, dim=-1).reshape(b, 19, 19, NUM_FEATURES_V1)


def features_v1_batch(states: GoState, with_ladders: bool = False,
                      use_kernel: bool = False,
                      ladders_exact: bool = False) -> torch.Tensor:
    """V1 planes for a batch; ``use_kernel`` takes the liberties after a
    move, the chain liberties and pseudo-legality from the feature kernel
    (`ops/libs_after.py`); ``ladders_exact`` picks the ladder reader
    (:func:`dream_go_torch.go.ladder.ladder_planes_batch`)."""
    from . import ladder
    from ..ops import layout, libs_after

    caps = escs = None
    if with_ladders:
        caps, escs = ladder.ladder_planes_batch(
            *layout.board_rows(states), states.to_move, ladders_exact)
    if not use_kernel:
        return features_v1(states, ladder_capture=caps, ladder_escape=escs)
    raw = libs_after.board_features_raw(states)
    black = (states.to_move == BLACK)[:, None]
    pick = lambda a, b: torch.where(black, raw[a], raw[b])
    return features_v1(
        states, ladder_capture=caps, ladder_escape=escs,
        libs_after=(pick("libs_if_black", "libs_if_white"),
                    pick("libs_if_white", "libs_if_black")),
        point_libs=raw["point_libs"],
        pseudo=(pick("pseudo_black", "pseudo_white"),
                pick("pseudo_white", "pseudo_black")))


def features_v1_full(states: GoState, with_ladders: bool = False,
                     max_ladder_candidates: int = 24,
                     ladders_exact: bool = False) -> torch.Tensor:
    """V1 planes with planes 30/31 from the bounded reader
    (:func:`dream_go_torch.go.ladder.ladder_planes`, the first
    ``max_ladder_candidates`` capture starts of a board) when
    ``with_ladders``."""
    if not with_ladders:
        return features_v1(states)
    from .ladder import ladder_planes

    cap, esc = ladder_planes(states, max_ladder_candidates,
                             greedy=not ladders_exact)
    return features_v1(states, ladder_capture=cap, ladder_escape=esc)


def apply_symmetry(planes: torch.Tensor, symmetry) -> torch.Tensor:
    """The D8 transform ``symmetry`` of [..., 19, 19, C] planes: one index
    for all (an int or a 0-d tensor), or long[B], one per example of
    [B, 19, 19, C] planes."""
    c = planes.shape[-1]
    flat = planes.reshape(planes.shape[:-3] + (NN, c))
    perm = torch.as_tensor(SYM, dtype=torch.long, device=planes.device)[
        torch.as_tensor(symmetry, device=planes.device).long()]
    if perm.dim() == 1:
        out = flat.index_select(-2, perm)
    else:
        out = torch.take_along_dim(flat, perm[..., None], dim=-2)
    return out.reshape(planes.shape)


def _v2_masks(device):
    vx, vy = np.arange(NN) % 19, np.arange(NN) // 19
    edge = (vx == 0) | (vx == 18) | (vy == 0) | (vy == 18)
    corner = ((vx == 0) | (vx == 18)) & ((vy == 0) | (vy == 18))
    return (torch.as_tensor(corner, device=device),
            torch.as_tensor(edge & ~corner, device=device))


def features_v2(states: GoState, with_ladders: bool = False,
                ladders_exact: bool = False) -> torch.Tensor:
    """float32[B, 19, 19, 18]: the V2 plane set (`features.rs:253-396`).

    0 ones; 1 komi from the mover's side, ``clip(+-komi / 7.5, -1, 1)``;
    2 own stones; 3 opponent stones; 4-7 chains with exactly 1..4
    liberties; 8-9 exactly 1..2 liberties if played; 10 valid move; 11 own
    Benson eye; 12 opponent Benson eye; 13 super-ko; 14 ladder capture; 15
    ladder escape; 16 corner; 17 edge.  Ladders come from the bounded
    per-board reader (24 capture and 8 escape starts), never the kernel,
    as in the JAX package (`features.py:314`)."""
    from .benson import benson
    from .ladder import ladder_planes

    stones, cid = states.stones, states.chain_id
    me = states.to_move.reshape(-1, 1).to(stones.dtype)
    opp = OFFBOARD - me
    point_libs, chain_libs = chain_liberties(stones, cid)
    valid_me = pseudo_legal_mask(states, states.to_move)
    libs_if_me = torch.where(
        valid_me, liberties_if(states, states.to_move, chain_libs), 0)
    ko = superko_mask(states, states.to_move) & valid_me
    _, eye_me = benson(stones, cid, me)
    _, eye_opp = benson(stones, cid, opp)
    komi = torch.where(states.to_move == BLACK, -states.komi, states.komi)
    # XLA divides by the constant as a product with its float32 reciprocal
    komi_c = torch.clamp(komi.to(torch.float32) * _INV_7_5, -1.0,
                         1.0)[:, None]
    if with_ladders:
        cap, esc = ladder_planes(states, greedy=not ladders_exact)
    else:
        cap = esc = torch.zeros_like(valid_me)
    corner, edge = _v2_masks(stones.device)

    b = stones.shape[0]
    ones = torch.ones(b, NN, device=stones.device)
    f32 = lambda x: x.to(torch.float32).expand(b, NN)
    planes = [ones, ones * komi_c, f32(stones == me), f32(stones == opp)]
    planes += [f32(point_libs == k) for k in range(1, 5)]
    planes += [f32(valid_me & (libs_if_me == 1)),
               f32(valid_me & (libs_if_me == 2)), f32(valid_me),
               f32(eye_me), f32(eye_opp), f32(ko), f32(cap & valid_me),
               f32(esc & valid_me), f32(corner), f32(edge)]
    return torch.stack(planes, dim=-1).reshape(b, 19, 19, NUM_FEATURES_V2)


def extract_batch(states: GoState, with_ladders: bool = False,
                  use_kernel: bool = False, ladders_exact: bool = False, *,
                  feature_set: str = "v1") -> torch.Tensor:
    """Batched network input for the plane set ``feature_set``: V1
    (:func:`features_v1_batch`) or V2 (:func:`features_v2`, which takes
    no kernel)."""
    if feature_set == "v2":
        return features_v2(states, with_ladders, ladders_exact)
    return features_v1_batch(states, with_ladders, use_kernel, ladders_exact)
