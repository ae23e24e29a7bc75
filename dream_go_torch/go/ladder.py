"""Ladder reading: feature planes 30 (ladder capture) and 31 (ladder escape).

Port of `dream_go_tpu/go/ladder.py` (`ladder.rs:20-178`).  Every function
takes a batch of boards.  A ladder chase is read as an explicit-stack DFS
over the reference's branch recursion, one *lane* per chase, all lanes of
all boards advanced together one rung per iteration:

- a rung: the attacker plays; the chased chain extends from the first
  adjacent defender chain in atari that cannot counter-capture and whose
  lone liberty is playable (`ladder.rs:60-80`); one liberty left =
  captured, three or more, or an attacker chain put in atari = this line
  fails (`ladder.rs:88-106`);
- at a branch (the chased chain keeps two liberties) both playable
  neighbours of the extension are attacks (`ladder.rs:110-119`): the lane
  continues down one and pushes the other onto a ``STACK_CAP``-deep stack,
  popping it when a line fails.  Captured anywhere = True.

The bounds are fail-safe: a lane that runs out of its ``BUDGET`` rungs, or
a branch that finds the stack full, resolves toward "no capture", as in the
reference (`tests/test_ladder_stress.py`).  ``greedy`` reads only the
tighter branch and never backtracks.

:func:`ladder_planes` bounds the candidates per board (the first
``max_candidates`` capture starts and ``max_escapes`` escape starts in point
order, as the JAX package's pooled reader does); ``None`` lifts a bound.
The kernel (`ops/ladder_kernel.py`) reads every candidate.
:func:`ladder_planes_batch` is the one place that picks the reader.
"""

from __future__ import annotations

import functools
import math

import torch

from .engine import (BLACK, EMPTY, OFFBOARD, WHITE, GoState,
                     chain_liberties, gather_nbr, pad, pseudo_legal_mask)
from .topology import NBR, NN

#: not-taken branches kept for backtracking per lane
STACK_CAP = 8
#: rungs per lane across all explored lines (a 19x19 chase is at most ~120
#: rungs deep; the corner-to-corner staircase needs 62 with alternates)
BUDGET = 320
#: candidate bounds of the pooled reader (`go/ladder.py:426-443`)
MAX_CANDIDATES = 24
MAX_ESCAPES = 8


@functools.lru_cache(maxsize=None)
def _tables(device: str):
    """``nbr`` long[362, 4] (row 361 all off-board) and ``iota``."""
    dev = torch.device(device)
    nbr = torch.full((NN + 1, 4), NN, dtype=torch.long, device=dev)
    nbr[:NN] = torch.as_tensor(NBR, dtype=torch.long, device=dev)
    return nbr, torch.arange(NN, dtype=torch.long, device=dev)


def _at(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[l, idx[l, ...]]`` for a per-lane index of any trailing shape."""
    flat = idx.reshape(idx.shape[0], math.prod(idx.shape[1:]))
    return arr.gather(1, flat).reshape(idx.shape)


def _is_stone(st: torch.Tensor) -> torch.Tensor:
    return (st == BLACK) | (st == WHITE)


def _valid_at(stones, point_libs, color, p):
    """`board_fast.rs:216-243` legality of ``color[l]`` at ``p[l]`` (NN =
    off the board, never valid) from the board's per-point liberties."""
    nbr, _ = _tables(str(stones.device))
    nb = nbr[p]                                             # [n, 4]
    st = _at(pad(stones, OFFBOARD), nb)
    pl = _at(pad(point_libs, 0), nb)
    col = color.to(stones.dtype)[:, None]
    opp = OFFBOARD - col
    ok = ((st == EMPTY).any(-1) | ((st == col) & (pl >= 2)).any(-1)
          | ((st == opp) & (pl == 1)).any(-1))
    return (_at(pad(stones, OFFBOARD), p[:, None])[:, 0] == EMPTY) & ok


def place_stones(stones, chain_id, color, p, chain_libs):
    """Hash-free placement of ``color[l]`` at ``p[l]``: captures adjacent
    opponent chains in atari and merges own chains under the smallest id
    (`engine.place_stones` of the JAX package).  ``chain_libs`` is the
    board's liberty table by chain id."""
    nbr, iota = _tables(str(stones.device))
    nb = nbr[p]                                             # [n, 4]
    nst = _at(pad(stones, OFFBOARD), nb)
    ncid = _at(pad(chain_id, -1), nb)
    nlibs = _at(chain_libs, ncid.clamp(0, NN).long())
    col = color.to(stones.dtype)[:, None]
    opp = OFFBOARD - col

    cap_ids = torch.where((nst == opp) & (nlibs == 1), ncid, -2)
    captured = (stones == opp) & (
        chain_id[:, :, None] == cap_ids[:, None, :]).any(-1)
    own_k = nst == col
    new_id = torch.minimum(
        p.to(torch.int32),
        torch.where(own_k, ncid, NN + 1).min(-1).values)[:, None]
    member = (stones == col) & (
        chain_id[:, :, None] == torch.where(own_k, ncid, -2)[:, None, :]
    ).any(-1)
    at_p = iota[None, :] == p[:, None]
    stones2 = torch.where(at_p, col, torch.where(captured, EMPTY, stones))
    cid2 = torch.where(member, new_id, chain_id)
    cid2 = torch.where(at_p, new_id,
                       torch.where(captured, iota[None, :].to(torch.int32),
                                   cid2))
    return stones2, cid2


def _chase_step(stones, chain_id, color, attack, pre_libs):
    """One rung for every lane: the attacker plays ``attack``, the chased
    chain extends.  Returns ``(stones2, chain_id2, status, c1, c2,
    libs2)``: status 0 = branch (continue), 1 = captured, 2 = line fails;
    ``c1``/``c2`` the playable neighbours of the extension (NN = none) in
    exploration order; ``libs2`` the new board's liberty table."""
    nbr, iota = _tables(str(stones.device))
    n = stones.shape[0]
    col = color.to(stones.dtype)[:, None]
    opp = (OFFBOARD - color).to(stones.dtype)
    st1, cid1 = place_stones(stones, chain_id, color, attack, pre_libs)
    pl1, cl1 = chain_liberties(st1, cid1)

    # smallest liberty of every chain, and whether it touches an attacker
    # chain in atari (its counter-capture, `ladder.rs:34-42`)
    nst1 = gather_nbr(st1, OFFBOARD)                        # [n, 361, 4]
    ncid1 = gather_nbr(cid1, -1).clamp(0, NN).long()
    lib_src = torch.where((st1 == EMPTY)[:, :, None] & _is_stone(nst1),
                          iota[None, :, None], NN)
    first_lib = torch.full((n, NN + 1), NN, dtype=torch.long,
                           device=stones.device)
    first_lib.scatter_reduce_(1, ncid1.reshape(n, 4 * NN),
                              lib_src.reshape(n, 4 * NN),
                              "amin")
    atari_atk = (st1 == col) & (pl1 == 1)
    touch = gather_nbr(atari_atk, False).any(-1) & _is_stone(st1)
    counter = torch.zeros(n, NN + 1, dtype=torch.int32, device=stones.device)
    counter.scatter_reduce_(1, cid1.clamp(0, NN).long(),
                            touch.to(torch.int32), "amax")

    st1p, cid1p = pad(st1, OFFBOARD), pad(cid1, -1)
    found = torch.zeros(n, dtype=torch.bool, device=stones.device)
    ext = torch.full((n,), NN, dtype=torch.long, device=stones.device)
    nb_a = nbr[attack]
    for k in range(4):
        q = nb_a[:, k:k + 1]
        c = _at(cid1p, q).clamp(0, NN).long()
        lib = _at(first_lib, c)[:, 0]
        ok = ((_at(st1p, q)[:, 0] == opp) & (_at(cl1, c)[:, 0] == 1)
              & (_at(counter, c)[:, 0] == 0) & (lib < NN)
              & _valid_at(st1, pl1, opp, lib.clamp(max=NN - 1)))
        ext = torch.where(ok & ~found, lib, ext)
        found = found | ok

    ext_c = ext.clamp(max=NN - 1)
    st2, cid2 = place_stones(st1, cid1, opp, ext_c, cl1)
    pl2, cl2 = chain_liberties(st2, cid2)
    def_libs = _at(cl2, _at(cid2, ext_c[:, None]).clamp(0, NN).long())[:, 0]
    nb_e = nbr[ext_c]
    self_atari = ((_at(pad(st2, OFFBOARD), nb_e) == col)
                  & (_at(pad(pl2, 0), nb_e) == 1)).any(-1)
    status = torch.where(
        ~found, 2, torch.where(
            def_libs <= 1, 1,
            torch.where((def_libs >= 3) | self_atari, 2, 0)))

    c1 = torch.full_like(ext, NN)
    c2 = torch.full_like(ext, NN)
    for k in range(4):
        q = nb_e[:, k]
        v = (q < NN) & _valid_at(st2, pl2, color, q.clamp(max=NN - 1))
        take1 = v & (c1 == NN)
        take2 = v & ~take1 & (c2 == NN)
        c1 = torch.where(take1, q, c1)
        c2 = torch.where(take2, q, c2)

    # exploration order (correctness-free under "any" semantics): the
    # branch that lets the defender breathe first, the tight chase stacked
    st2p = pad(st2, OFFBOARD)

    def after_libs(a, e):
        nb = nbr[e.clamp(max=NN - 1)]
        return ((_at(st2p, nb) == EMPTY) & (nb != a[:, None])).sum(-1)

    swap = (c1 < NN) & (c2 < NN) & (after_libs(c2, c1) > after_libs(c1, c2))
    return (st2, cid2, status, torch.where(swap, c2, c1),
            torch.where(swap, c1, c2), cl2)


def run_chases(stones, chain_id, color, attack, active, greedy: bool,
               budget: int | None = None, stack_cap: int | None = None,
               rungs: torch.Tensor | None = None) -> torch.Tensor:
    """bool[n]: the DFS of every lane (``color[l]`` attacks from
    ``attack[l]`` on board ``l``); inactive lanes read False.  ``rungs``
    (long[n]), when given, gets the rungs each lane walks."""
    budget = BUDGET if budget is None else budget
    stack_cap = STACK_CAP if stack_cap is None else stack_cap
    n = stones.shape[0]
    dev = stones.device
    alloc = 1 if greedy else max(stack_cap, 1)
    st, cid = stones.clone(), chain_id.clone()
    libs = chain_liberties(st, cid)[1]
    attack = attack.to(torch.long).clone()
    color = color.to(torch.int8)
    status = torch.where(active, 0, 2)
    sp = torch.zeros(n, dtype=torch.long, device=dev)
    sst = torch.zeros(n, alloc, NN, dtype=st.dtype, device=dev)
    scid = torch.zeros(n, alloc, NN, dtype=torch.int16, device=dev)
    sat = torch.full((n, alloc), NN, dtype=torch.long, device=dev)
    for _ in range(budget):
        idx = (status == 0).nonzero()[:, 0]
        if idx.numel() == 0:
            break
        if rungs is not None:
            rungs[idx] += 1
        st2, cid2, s, c1, c2, lb2 = _chase_step(
            st[idx], cid[idx], color[idx], attack[idx], libs[idx])
        if greedy:
            c1 = torch.where(c2 < NN, c2, c1)
            c2 = torch.full_like(c2, NN)
        cont = (s == 0) & (c1 < NN)
        fail = (s == 2) | ((s == 0) & (c1 >= NN))
        spi = sp[idx]
        push = cont & (c2 < NN) & (spi < stack_cap)
        pi, slot = idx[push], spi[push]
        sst[pi, slot] = st2[push]
        scid[pi, slot] = cid2[push].to(torch.int16)
        sat[pi, slot] = c2[push]
        spi = spi + push.long()
        pop = fail & (spi > 0)
        qi, pslot = idx[pop], spi[pop] - 1
        st2[pop] = sst[qi, pslot]
        cid2[pop] = scid[qi, pslot].to(cid2.dtype)
        if bool(pop.any()):
            lb2[pop] = chain_liberties(st2[pop], cid2[pop])[1]
        nxt = torch.where(cont, c1, NN)
        nxt[pop] = sat[qi, pslot]
        st[idx], cid[idx], libs[idx], attack[idx] = st2, cid2, lb2, nxt
        sp[idx] = torch.where(pop, spi - 1, spi)
        status[idx] = torch.where(s == 1, 1, torch.where(cont | pop, 0, 2))
    return status == 1


def is_ladder_capture(stones, chain_id, color, p, greedy: bool = False,
                      budget: int | None = None,
                      stack_cap: int | None = None) -> torch.Tensor:
    """bool[n]: playing ``color`` at ``p`` starts a winning ladder chase."""
    color = _per_lane(color, stones)
    p = torch.as_tensor(p, device=stones.device).to(torch.long).reshape(-1)
    return run_chases(stones, chain_id, color, p,
                      torch.ones_like(p, dtype=torch.bool), greedy, budget,
                      stack_cap)


def _per_lane(color, like: torch.Tensor) -> torch.Tensor:
    c = torch.as_tensor(color, device=like.device).to(torch.int8)
    return c.expand(like.shape[0]) if c.dim() == 0 else c


def _escape_jobs(stones, chain_id, color, p, root_libs):
    """Place ``color[l]`` at ``p[l]`` (an escape candidate: it touches an
    own chain in atari) and return ``(stones2, chain_id2, feasible,
    attacks[n, 4], playable[n, 4])``: the opponent's counter-attacks that
    must all fail (`ladder.rs:136-178`)."""
    nbr, _ = _tables(str(stones.device))
    st2, cid2 = place_stones(stones, chain_id, color, p, root_libs)
    pl2, cl2 = chain_liberties(st2, cid2)
    feasible = _at(cl2, _at(cid2, p[:, None]).clamp(0, NN).long())[:, 0] == 2
    attacks = nbr[p]
    opp = (OFFBOARD - color).to(torch.int8)
    playable = torch.stack(
        [(attacks[:, k] < NN) & _valid_at(st2, pl2, opp,
                                          attacks[:, k].clamp(max=NN - 1))
         for k in range(4)], dim=1)
    return st2, cid2, feasible, attacks.clamp(max=NN - 1), playable


def is_ladder_escape(stones, chain_id, color, p, greedy: bool = False,
                     budget: int | None = None,
                     stack_cap: int | None = None) -> torch.Tensor:
    """bool[n]: playing ``color`` at ``p`` escapes an atari: the opponent
    fails to ladder-capture from every playable adjacent point."""
    color = _per_lane(color, stones)
    p = torch.as_tensor(p, device=stones.device).to(torch.long).reshape(-1)
    nbr, _ = _tables(str(stones.device))
    _, root_libs = chain_liberties(stones, chain_id)
    nst = _at(pad(stones, OFFBOARD), nbr[p])
    nlibs = _at(root_libs,
                _at(pad(chain_id, -1), nbr[p]).clamp(0, NN).long())
    connected = ((nst == color[:, None]) & (nlibs == 1)).any(-1)
    st2, cid2, feasible, attacks, playable = _escape_jobs(
        stones, chain_id, color, p, root_libs)
    return connected & feasible & ~_escape_failed(
        st2, cid2, color, attacks, playable & feasible[:, None], greedy,
        budget, stack_cap)


def _escape_failed(st2, cid2, color, attacks, playable, greedy, budget,
                   stack_cap, rungs=None):
    """bool[n]: some playable counter-attack of escape ``n`` captures.
    ``rungs`` (long[n]), when given, gets the rungs each escape needs:
    those of its counter-attacks in `NBR` order up to the first that
    captures, where a reader may stop (all lanes run here)."""
    e, k = playable.nonzero(as_tuple=True)
    opp = (OFFBOARD - color).to(torch.int8)
    lane_rungs = None if rungs is None else torch.zeros_like(e)
    captured = run_chases(st2[e], cid2[e], opp[e], attacks[e, k],
                          torch.ones_like(e, dtype=torch.bool), greedy,
                          budget, stack_cap, lane_rungs)
    failed = torch.zeros(st2.shape[0], dtype=torch.int32, device=st2.device)
    failed.index_add_(0, e, captured.to(torch.int32))
    if rungs is not None:
        # lanes come grouped by escape in NBR order (row-major nonzero); a
        # lane is needed while no earlier lane of its escape captured
        hit = captured.to(torch.long)
        before = hit.cumsum(0) - hit
        needed = before == before[torch.searchsorted(e, e)]
        rungs.index_add_(0, e, torch.where(needed, lane_rungs, 0))
    return failed > 0


def _first(mask: torch.Tensor, bound: int | None) -> torch.Tensor:
    """Keep the first ``bound`` True entries of each row (point order)."""
    if bound is None:
        return mask
    return mask & (mask.to(torch.int32).cumsum(1) <= bound)


def candidates(states: GoState):
    """``(capture, escape)`` bool[B, 361]: pseudo-legal points for the
    player to move next to an opponent chain on two liberties / an own
    chain in atari (the starts both readers evaluate)."""
    stones, cid = states.stones, states.chain_id
    color = states.to_move.reshape(-1, 1, 1)
    opp = OFFBOARD - color
    _, chain_libs = chain_liberties(stones, cid)
    pseudo = pseudo_legal_mask(states, states.to_move)
    nst = gather_nbr(stones, OFFBOARD)
    b = stones.shape[0]
    nlibs = chain_libs.gather(
        1, gather_nbr(cid, -1).clamp(0, NN).reshape(b, 4 * NN).long()
    ).reshape(b, NN, 4)
    cap = pseudo & ((nst == opp) & (nlibs == 2)).any(-1)
    esc = pseudo & ((nst == color) & (nlibs == 1)).any(-1)
    return cap, esc


def ladder_planes(states: GoState,
                  max_candidates: int | None = MAX_CANDIDATES,
                  greedy: bool = False,
                  max_escapes: int | None = MAX_ESCAPES,
                  budget: int | None = None, stack_cap: int | None = None,
                  stats: dict | None = None):
    """``(capture, escape)`` bool[B, 361] for the player to move.

    Candidates past the first ``max_candidates`` capture starts and
    ``max_escapes`` escape starts of a board (point order) are left False;
    ``None`` evaluates them all.  Every chase of the batch runs as one lane
    of one lockstep DFS: capture starts directly, each escape start as up to
    four counter-attack lanes on its post-extension board.

    ``stats``, when given, gets the work the reading needs, an escape's
    counter-attacks counted up to the first that captures: ``job_board``
    and ``job_rungs`` (long[J]), one entry per candidate in the order a
    board reads them (capture starts, then escape starts, point order),
    and ``longest_chase``, the most rungs of one chase."""
    stones, cid = states.stones, states.chain_id
    color = states.to_move.to(torch.int8)
    b = stones.shape[0]
    cap_c, esc_c = candidates(states)
    cap_c, esc_c = _first(cap_c, max_candidates), _first(esc_c, max_escapes)
    cb, cp = cap_c.nonzero(as_tuple=True)
    eb, ep = esc_c.nonzero(as_tuple=True)
    _, chain_libs = chain_liberties(stones, cid)

    counting = stats is not None
    cap_r = torch.zeros_like(cb) if counting else None
    esc_r = torch.zeros_like(eb) if counting else None
    st2, cid2, feasible, attacks, playable = _escape_jobs(
        stones[eb], cid[eb], color[eb], ep, chain_libs[eb])
    esc_failed = _escape_failed(st2, cid2, color[eb], attacks,
                                playable & feasible[:, None], greedy,
                                budget, stack_cap, esc_r)
    caps = run_chases(stones[cb], cid[cb], color[cb], cp,
                      torch.ones_like(cb, dtype=torch.bool), greedy, budget,
                      stack_cap, cap_r)
    if counting:
        board = torch.cat([cb, eb])
        order = torch.sort(board, stable=True).indices
        stats["job_board"] = board[order]
        stats["job_rungs"] = torch.cat([cap_r, esc_r])[order]
        stats["longest_chase"] = int(torch.cat(
            [cap_r, esc_r, torch.zeros(1, dtype=torch.long,
                                       device=cb.device)]).max())

    capture = torch.zeros(b, NN, dtype=torch.bool, device=stones.device)
    escape = torch.zeros_like(capture)
    capture[cb, cp] = caps
    escape[eb, ep] = feasible & ~esc_failed
    return capture, escape


def ladder_planes_batch(stones, cid, to_move, exact: bool):
    """Planes 30/31 of boards given as kernel-layout rows (``stones``, cid
    i32[B, 1, 384], ``to_move`` i32[B]), the one place that picks the
    reader: the exact reader runs as the kernel (`ops/ladder_kernel.py`,
    every candidate) on CUDA rows; otherwise the bounded lockstep reader
    above, exact or greedy, on the first ``MAX_CANDIDATES`` capture and
    ``MAX_ESCAPES`` escape starts of a board, as the JAX package dispatches
    (`go/ladder.py:426-443`).  The two agree wherever a board has no more
    candidates than the bounds."""
    from ..ops import layout
    from ..ops.ladder_kernel import ladder_planes_kernel

    to_move = to_move.to(torch.int32).contiguous()
    if exact and stones.device.type == "cuda":
        return ladder_planes_kernel(stones, cid, to_move)
    return ladder_planes(layout.rows_to_states(stones, cid, to_move),
                         greedy=not exact)
