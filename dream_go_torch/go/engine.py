"""Batched Go rules engine (Tromp-Taylor + positional super-ko).

Port of `dream_go_tpu/go/engine.py`.  Every function takes a batch of
boards (leading axis ``B``) as plain tensors:

- ``stones``    int8[B, 361]: 0 empty / 1 black / 2 white;
- ``chain_id``  int32[B, 361]: min-member point index of each stone's chain;
- ``chain_xor`` int32[B, 361, 2]: per-point copy of the zobrist XOR of the
  chain holding the point (two int32 bit patterns per 64-bit hash);
- ``hash_hist`` int32[B, 64, 2]: ring of post-move hashes (super-ko).

Liberties are recomputed exactly on demand: each empty point adds one to
each *distinct* neighbouring chain, by a scatter-add over chain ids.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .topology import IOTA, NBR, NN, PASS
from .zobrist import Z_I32

N = 19
EMPTY, BLACK, WHITE = 0, 1, 2
OFFBOARD = 3


@functools.lru_cache(maxsize=None)
def tables(device: str):
    """Board-independent tables on ``device`` (cached per device)."""
    dev = torch.device(device)
    return {
        "nbr": torch.as_tensor(NBR, dtype=torch.long, device=dev),
        "iota": torch.as_tensor(IOTA, dtype=torch.int32, device=dev),
        "zb": torch.as_tensor(Z_I32[0], device=dev),   # [361, 2] int32
        "zw": torch.as_tensor(Z_I32[1], device=dev),
    }


def _t(x: torch.Tensor):
    return tables(str(x.device))


@dataclasses.dataclass
class GoState:
    """A batch of boards; every field has the batch as its leading axis."""

    stones: torch.Tensor        # int8[B, 361]
    chain_id: torch.Tensor      # int32[B, 361]
    chain_xor: torch.Tensor     # int32[B, 361, 2]
    to_move: torch.Tensor       # int8[B]
    hash: torch.Tensor          # int32[B, 2]
    hash_hist: torch.Tensor     # int32[B, K, 2]
    placed_count: torch.Tensor  # int32[B]
    move_count: torch.Tensor    # int32[B]
    pass_count: torch.Tensor    # int32[B]
    last_two: torch.Tensor      # int32[B, 2]
    komi: torch.Tensor          # float32[B]
    done: torch.Tensor          # bool[B]

    def replace(self, **kw) -> "GoState":
        return dataclasses.replace(self, **kw)

    def fields(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def select(self, mask: torch.Tensor, other: "GoState") -> "GoState":
        """Per-board ``where(mask, self, other)``."""
        out = {}
        for name, a in self.fields().items():
            b = getattr(other, name)
            m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
            out[name] = torch.where(m, a, b)
        return GoState(**out)

    def index(self, idx) -> "GoState":
        return GoState(**{k: v[idx] for k, v in self.fields().items()})

    @property
    def batch(self) -> int:
        return self.stones.shape[0]


def new_states(batch: int, komi: float = 7.5, history_len: int = 64,
               device="cuda") -> GoState:
    """A batch of empty boards."""
    dev = torch.device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return GoState(
        stones=torch.zeros(batch, NN, dtype=torch.int8, device=dev),
        chain_id=torch.arange(NN, **i32).repeat(batch, 1),
        chain_xor=torch.zeros(batch, NN, 2, **i32),
        to_move=torch.full((batch,), BLACK, dtype=torch.int8, device=dev),
        hash=torch.zeros(batch, 2, **i32),
        hash_hist=torch.zeros(batch, history_len, 2, **i32),
        placed_count=torch.zeros(batch, **i32),
        move_count=torch.zeros(batch, **i32),
        pass_count=torch.zeros(batch, **i32),
        last_two=torch.full((batch, 2), PASS, **i32),
        komi=torch.full((batch,), float(komi), dtype=torch.float32,
                        device=dev),
        done=torch.zeros(batch, dtype=torch.bool, device=dev),
    )


def pad(arr: torch.Tensor, fill) -> torch.Tensor:
    """Append the sentinel point (index 361) used by off-board gathers."""
    extra = torch.full(arr.shape[:1] + (1,) + arr.shape[2:], fill,
                       dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, extra], dim=1)


def gather_nbr(arr: torch.Tensor, fill) -> torch.Tensor:
    """[B, 361, ...] -> [B, 361, 4, ...] neighbour values (fill off-board)."""
    return pad(arr, fill)[:, _t(arr)["nbr"]]


def dedup4(ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """First-occurrence mask over the last axis of size 4
    (`board_fast.rs:406-423` ``seen_blocks`` idiom)."""
    i0, i1, i2, i3 = ids.unbind(-1)
    v0, v1, v2, v3 = valid.unbind(-1)
    k1 = v1 & ~(v0 & (i1 == i0))
    k2 = v2 & ~(v0 & (i2 == i0)) & ~(v1 & (i2 == i1))
    k3 = v3 & ~(v0 & (i3 == i0)) & ~(v1 & (i3 == i1)) & ~(v2 & (i3 == i2))
    return torch.stack([v0, k1, k2, k3], dim=-1)


def xor4(x: torch.Tensor, dim: int) -> torch.Tensor:
    a, b, c, d = x.unbind(dim)
    return a ^ b ^ c ^ d


def chain_liberties(stones: torch.Tensor, chain_id: torch.Tensor):
    """Exact liberty counts: ``(point_libs[B, 361], chain_libs[B, 362])``.

    ``chain_libs`` is indexed by chain id (entry 361 stays 0); point_libs is
    the count of the chain holding each stone, 0 on empty points.
    """
    b = stones.shape[0]
    nbr_st = gather_nbr(stones, OFFBOARD)
    nbr_cid = gather_nbr(chain_id, -1)
    is_stone = (nbr_st == BLACK) | (nbr_st == WHITE)
    keep = dedup4(nbr_cid, is_stone) & (stones == EMPTY)[:, :, None]
    chain_libs = torch.zeros(b, NN + 1, dtype=torch.int32,
                             device=stones.device)
    chain_libs.scatter_add_(1, nbr_cid.clamp(0, NN).reshape(b, -1).long(),
                            keep.to(torch.int32).reshape(b, -1))
    chain_libs[:, NN] = 0
    point_libs = torch.where(
        stones != EMPTY,
        chain_libs.gather(1, chain_id.clamp(0, NN).long()), 0)
    return point_libs, chain_libs


def _color(color, like: torch.Tensor) -> torch.Tensor:
    """Per-board color column [B, 1] from a scalar or a [B] tensor."""
    c = torch.as_tensor(color, device=like.device)
    c = c.to(like.dtype)
    if c.dim() == 0:
        c = c.expand(like.shape[0])
    return c.reshape(-1, 1)


def _capture_info(state: GoState, color):
    """Per-candidate neighbour analysis shared by legality and stepping:
    ``(nbr_st, nbr_cid, nbr_libs, cap_keep)``, each [B, 361, 4]."""
    _, chain_libs = chain_liberties(state.stones, state.chain_id)
    nbr_st = gather_nbr(state.stones, OFFBOARD)
    nbr_cid = gather_nbr(state.chain_id, -1)
    b = nbr_cid.shape[0]
    nbr_libs = chain_libs.gather(
        1, nbr_cid.clamp(0, NN).reshape(b, -1).long()).reshape(b, NN, 4)
    opp = OFFBOARD - _color(color, state.stones)
    is_cap = (nbr_st == opp[:, :, None]) & (nbr_libs == 1)
    return nbr_st, nbr_cid, nbr_libs, dedup4(nbr_cid, is_cap)


def _zobrist(color_col: torch.Tensor) -> torch.Tensor:
    """[B, 361, 2] zobrist rows of the given per-board color."""
    t = _t(color_col)
    return torch.where((color_col == BLACK)[:, :, None], t["zb"], t["zw"])


def candidate_hashes(state: GoState, color) -> torch.Tensor:
    """Post-move hash for playing ``color`` at every point: int32[B, 361, 2]
    (`board_fast.rs:406-423` ``place_if`` for all candidates at once)."""
    _, _, _, cap_keep = _capture_info(state, color)
    cx = gather_nbr(state.chain_xor, 0)                      # [B,361,4,2]
    cap_xor = xor4(torch.where(cap_keep[..., None], cx, 0), 2)
    z_me = _zobrist(_color(color, state.stones))
    return state.hash[:, None, :] ^ z_me ^ cap_xor


def pseudo_legal_mask(state: GoState, color=None) -> torch.Tensor:
    """Tromp-Taylor legality ignoring super-ko: bool[B, 361]
    (`board_fast.rs:216-243`)."""
    color = state.to_move if color is None else color
    nbr_st, _, nbr_libs, _ = _capture_info(state, color)
    me = _color(color, state.stones)[:, :, None]
    opp = OFFBOARD - me
    has_empty = (nbr_st == EMPTY).any(-1)
    own_alive = ((nbr_st == me) & (nbr_libs >= 2)).any(-1)
    captures = ((nbr_st == opp) & (nbr_libs == 1)).any(-1)
    return (state.stones == EMPTY) & (has_empty | own_alive | captures)


def superko_mask(state: GoState, color=None) -> torch.Tensor:
    """bool[B, 361]: playing here would repeat a position in the ring."""
    color = state.to_move if color is None else color
    h = candidate_hashes(state, color)                       # [B,361,2]
    hist = state.hash_hist                                   # [B,K,2]
    k = hist.shape[1]
    valid = (torch.arange(k, device=h.device)[None, :]
             < state.placed_count[:, None])                  # [B,K]
    same = ((h[:, :, None, 0] == hist[:, None, :, 0])
            & (h[:, :, None, 1] == hist[:, None, :, 1]))     # [B,361,K]
    return (same & valid[:, None, :]).any(-1)


def legal_mask(state: GoState, color=None) -> torch.Tensor:
    """Full legality incl. super-ko: bool[B, 362] (index 361 = pass, always
    legal; a finished game allows only pass)."""
    color = state.to_move if color is None else color
    moves = pseudo_legal_mask(state, color) & ~superko_mask(state, color)
    moves = moves & ~state.done[:, None]
    return torch.cat([moves, torch.ones_like(moves[:, :1])], dim=1)


def _place(state: GoState, p: torch.Tensor) -> GoState:
    """Place ``to_move``'s stone at ``p`` [B] (assumed legal): capture,
    merge by relabelling to the min member, update hash and ring
    (`board_fast.rs:434-474`, `board.rs:164-188`)."""
    t = _t(p)
    b = p.shape[0]
    rows = torch.arange(b, device=p.device)
    pl = p.long()
    me = state.to_move.reshape(-1, 1)
    opp = OFFBOARD - me
    stones, cid = state.stones, state.chain_id

    nbr_st, nbr_cid, _, cap_keep = _capture_info(state, state.to_move)
    nbr_st_p, nbr_cid_p = nbr_st[rows, pl], nbr_cid[rows, pl]   # [B, 4]
    cap_keep_p = cap_keep[rows, pl]

    cap_ids = torch.where(cap_keep_p, nbr_cid_p, -2)
    captured = (stones == opp) & (
        cid[:, :, None] == cap_ids[:, None, :]).any(-1)

    own_k = nbr_st_p == me
    own_ids = torch.where(own_k, nbr_cid_p, NN + 1)
    new_id = torch.minimum(p.to(torch.int32), own_ids.min(-1).values)
    member = (stones == me) & (
        cid[:, :, None] == torch.where(own_k, nbr_cid_p, -2)[:, None, :]
    ).any(-1)

    at_p = t["iota"][None, :] == p[:, None]
    stones2 = torch.where(at_p, me, torch.where(captured, 0, stones))
    cid2 = torch.where(member, new_id[:, None], cid)
    cid2 = torch.where(at_p, new_id[:, None],
                       torch.where(captured, t["iota"][None, :], cid2))

    z_me_p = _zobrist(me)[rows, pl]                               # [B, 2]
    cx_nbr = pad(state.chain_xor, 0)[rows[:, None], t["nbr"][pl]]  # [B,4,2]
    cap_xor = xor4(torch.where(cap_keep_p[..., None], cx_nbr, 0), 1)
    h2 = state.hash ^ z_me_p ^ cap_xor

    own_keep = dedup4(nbr_cid_p, own_k)
    new_xor = z_me_p ^ xor4(torch.where(own_keep[..., None], cx_nbr, 0), 1)
    cxor2 = torch.where((member | at_p)[..., None], new_xor[:, None, :],
                        state.chain_xor)
    cxor2 = torch.where(captured[..., None], 0, cxor2)

    k = state.hash_hist.shape[1]
    at_slot = (torch.arange(k, device=p.device)[None, :]
               == (state.placed_count % k)[:, None])
    hist2 = torch.where(at_slot[..., None], h2[:, None, :], state.hash_hist)

    return state.replace(
        stones=stones2,
        chain_id=cid2,
        chain_xor=cxor2,
        to_move=opp.reshape(-1),
        hash=h2,
        hash_hist=hist2,
        placed_count=state.placed_count + 1,
        move_count=state.move_count + 1,
        pass_count=torch.zeros_like(state.pass_count),
        last_two=torch.stack([p.to(torch.int32), state.last_two[:, 0]], 1),
    )


def step(state: GoState, action: torch.Tensor) -> GoState:
    """Apply one action per board (0..360 = point, 361 = pass); a finished
    game is frozen.  The action is assumed legal (`board.rs:164-188`)."""
    action = action.to(torch.int32)
    is_pass = action >= PASS
    p = torch.clamp(action, max=PASS - 1)
    placed = _place(state, p)
    passed = state.replace(
        to_move=(OFFBOARD - state.to_move).to(torch.int8),
        move_count=state.move_count + 1,
        pass_count=state.pass_count + 1,
        done=state.done | (state.pass_count + 1 >= 2),
    )
    out = passed.select(is_pass, placed)
    return state.select(state.done, out)

