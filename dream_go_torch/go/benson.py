"""Benson's unconditional life as a batched fixed-point iteration.

Port of `dream_go_tpu/go/benson.py`, with the reference's semantics
(`benson.rs`): blocks are the chains of the queried color; regions are
connected components of non-``color`` points; a region is vital to a block
iff every point of the region is adjacent to the block; blocks with fewer
than two vital healthy regions die, and regions touching a dead block stop
being healthy, until nothing changes.  ``alive`` marks stones of pass-alive
chains, ``eye`` the points of surviving vital regions.
"""

from __future__ import annotations

import torch

from .engine import BLACK, EMPTY, WHITE, GoState, gather_nbr, pad, tables
from .score import CHECK_EVERY, territory, tt_score
from .topology import NN


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """int32[B, 361]: min member index of each point's component where
    ``mask`` holds, NN elsewhere.  Min-label propagation with pointer
    jumping (every label is a member of its own component, so jumping to a
    label's label stays inside the component)."""
    iota = torch.arange(NN, dtype=torch.int32, device=mask.device)
    lbl = torch.where(mask, iota[None, :], NN)
    nbr_mask = gather_nbr(mask, False)
    while True:
        prev = lbl
        for _ in range(CHECK_EVERY):
            nbr_lbl = torch.where(nbr_mask, gather_nbr(lbl, NN), NN)
            grown = torch.minimum(lbl, nbr_lbl.min(-1).values)
            jumped = pad(grown, NN).gather(1, grown.long())
            lbl = torch.where(mask, torch.minimum(grown, jumped), NN)
        if torch.equal(lbl, prev):
            return lbl


def benson(stones: torch.Tensor, chain_id: torch.Tensor, color):
    """Returns ``(alive, eye)`` bool[B, 361] masks for ``color``."""
    b = stones.shape[0]
    in_region = stones != color
    labels = label_components(in_region)                        # [B, 361]
    iota = torch.arange(NN, device=stones.device)

    # adj[p, c]: region point p touches chain c of `color`
    member_q = ((chain_id[:, :, None] == iota[None, None, :])
                & (stones == color)[:, :, None])                 # [B, q, c]
    mp = torch.cat([member_q, torch.zeros_like(member_q[:, :1])], dim=1)
    nbr = tables(str(stones.device))["nbr"]
    adj = (mp[:, nbr[:, 0]] | mp[:, nbr[:, 1]] | mp[:, nbr[:, 2]]
           | mp[:, nbr[:, 3]]) & in_region[:, :, None]           # [B, p, c]

    # hits[r, c] = #points of region r adjacent to c; size[r] = |r|
    lbl = labels.clamp(max=NN).long()
    hits = torch.zeros(b, NN + 1, NN, dtype=torch.int32, device=stones.device)
    hits.scatter_add_(1, lbl[:, :, None].expand(-1, -1, NN),
                      adj.to(torch.int32))
    size = torch.zeros(b, NN + 1, dtype=torch.int32, device=stones.device)
    size.scatter_add_(1, lbl, in_region.to(torch.int32))
    hits, size = hits[:, :NN], size[:, :NN]
    is_region = size > 0
    vital = (hits == size[:, :, None]) & is_region[:, :, None]  # [B, r, c]
    touches = hits > 0

    healthy = vital.any(-1) & is_region
    while True:
        block_alive = (vital & healthy[:, :, None]).sum(1) >= 2  # [B, c]
        bad = (touches & ~block_alive[:, None, :]).any(-1)
        healthy2 = healthy & ~bad
        if torch.equal(healthy2, healthy):
            break
        healthy = healthy2

    block_alive = (vital & healthy[:, :, None]).sum(1) >= 2
    alive = (stones == color) & block_alive.gather(
        1, chain_id.clamp(0, NN - 1).long())
    eye = (in_region & healthy.gather(1, labels.clamp(0, NN - 1).long())
           & (labels < NN))
    return alive, eye


def life(state: GoState):
    """``(alive_b, eye_b, alive_w, eye_w)``: :func:`benson` for black, then
    white."""
    return (*benson(state.stones, state.chain_id, BLACK),
            *benson(state.stones, state.chain_id, WHITE))


def is_scorable(state: GoState, life_=None) -> torch.Tensor:
    """bool[B]: every point is Benson-decided (`score.rs:105-117`);
    ``life_`` is the state's :func:`life`, computed when not given."""
    alive_b, eye_b, alive_w, eye_w = life_ or life(state)
    st = state.stones
    ok = torch.where(
        st == EMPTY, eye_b | eye_w,
        torch.where(st == BLACK, alive_b | eye_w, alive_w | eye_b))
    return ok.all(-1)


def scorable_territory(state: GoState, life_=None) -> torch.Tensor:
    """bool[B, 361]: the points Benson-decided (alive or eye) for either
    colour (`score.rs:120-130` ``get_scorable_territory``)."""
    alive_b, eye_b, alive_w, eye_w = life_ or life(state)
    return alive_b | eye_b | alive_w | eye_w


def clear_dead(stones: torch.Tensor, chain_id: torch.Tensor) -> torch.Tensor:
    """Remove every stone that is not unconditionally alive
    (`score.rs:197-211`)."""
    alive_b, _ = benson(stones, chain_id, BLACK)
    alive_w, _ = benson(stones, chain_id, WHITE)
    keep = ((stones == BLACK) & alive_b) | ((stones == WHITE) & alive_w)
    return torch.where(keep, stones, 0)


def guess_score(finished_stones: torch.Tensor,
                finished_chain_id: torch.Tensor,
                komi: torch.Tensor) -> torch.Tensor:
    """f32[B]: Tromp-Taylor score of the boards with the Benson-dead stones
    cleared, black minus white minus komi (`score.rs:141-147`
    ``get_guess_score``)."""
    black, white = tt_score(clear_dead(finished_stones, finished_chain_id))
    return black.to(torch.float32) - white.to(torch.float32) - komi


STATUS_NONE, STATUS_ALIVE, STATUS_DEAD, STATUS_SEKI = 0, 1, 2, 3


def stone_status(stones, chain_id, finished_stones, finished_chain_id):
    """Batched `get_stone_status` (`score.rs:149-185`):
    ``(status int8[B, 361], terr int8[B, 361])``."""
    alive_b, eye_b = benson(finished_stones, finished_chain_id, BLACK)
    alive_w, eye_w = benson(finished_stones, finished_chain_id, WHITE)
    tb, tw = territory(clear_dead(finished_stones, finished_chain_id))
    is_b, is_w = stones == BLACK, stones == WHITE
    w = torch.where
    status = w(is_b, w(alive_b, STATUS_ALIVE, w(eye_w, STATUS_DEAD,
                                                STATUS_SEKI)),
               w(is_w, w(alive_w, STATUS_ALIVE, w(eye_b, STATUS_DEAD,
                                                  STATUS_SEKI)),
                 STATUS_NONE))
    terr = w(is_b, w(alive_b, BLACK, w(eye_w, WHITE, BLACK)),
             w(is_w, w(alive_w, WHITE, w(eye_b, BLACK, WHITE)),
               w(tb, BLACK, w(tw, WHITE, EMPTY))))
    return status.to(torch.int8), terr.to(torch.int8)
