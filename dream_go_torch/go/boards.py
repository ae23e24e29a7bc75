"""Boards from raw stone lists, the ladder stress boards, a scripted ko
and the env-step kernel's parity cases.

:func:`from_stones` builds a GoState from 361-entry stone lists (0 empty,
1 black, 2 white), its chain ids by flood fill.  :func:`ladder_stress`
gives the boards that push the ladder readers to their bounds, rebuilt
from the JAX package's tests (`tests/test_ladder_stress.py`
``staircase_board``, `tests/test_ladder_bounds.py` swarms), and
:func:`ladder_capture` two on which a chase captures a third chain
mid-ladder; the card tests and `chip_smoke.py` hold the ladder kernel to
its plain version on them.  ``KO_MOVES``, :func:`ko_captured` and
:func:`env_step_cases` give both of them the same ko boards and env-step
inputs, ``LEAF_CASES`` (:func:`leaf_cases`, ``LEAF_KO``) the
leaf-step kernel's boards that reach each of its counting paths, and
``ENV_CASES`` (:func:`env_cases`) the env-step kernel's, and
``FEATURE_CASES`` (:func:`feature_cases`) the feature kernel's.
"""

from __future__ import annotations

import torch

from .engine import BLACK, GoState, legal_mask, new_states, step
from .topology import NBR, NN

_pt = lambda x, y: 19 * y + x
#: a scripted ko: these moves from an empty board, then black's capture at
#: KO_ACTION (2,1); white's recapture at KO_RECAPTURE (1,1) is then a
#: super-ko
KO_MOVES = [_pt(1, 0), _pt(2, 0), _pt(0, 1), _pt(3, 1), _pt(1, 2),
            _pt(2, 2), _pt(10, 10), _pt(1, 1)]
KO_ACTION = _pt(2, 1)
KO_RECAPTURE = _pt(1, 1)

PASS = NN
#: the leaf-step kernel's scripted cases, ``(name, moves from an empty board
#: (PASS for a pass), action)``; each reaches one of the kernel's paths:
#: - "merge three": black's move at (4,4) joins three black chains;
#: - "capture two": black's move at (10,10) captures two white chains;
#: - "union": after black's move, white's candidates at (14,4) (two white
#:   chains next to it) and at (3,14) (a white chain and a capture next to
#:   it), and black's at (16,4) (two black chains), take the set union;
#: - "wrapped ko": 76 placements far from the corner fill the 64-entry ring
#:   and wrap it, then KO_MOVES and black's capture at KO_ACTION: white's
#:   recapture at KO_RECAPTURE is a super-ko found in the wrapped ring;
#: - "two-sided capture": black's move at (1,1) captures the white corner
#:   chain (0,0), (1,0), (0,1) through two of its stones;
#: - "two-sided ko": white captures black's (1,1) and fills the corner with
#:   white's move at (0,0), a chain whose one liberty (1,1) touches two of
#:   its stones: black's recapture there repeats the position after black's
#:   (0,2), a super-ko, so its hash must count that chain once.
LEAF_CASES = [
    ("merge three",
     [_pt(4, 3), PASS, _pt(3, 4), PASS, _pt(5, 4), _pt(15, 15)], _pt(4, 4)),
    ("capture two",
     [_pt(9, 9), _pt(10, 9), _pt(11, 9), _pt(10, 11), _pt(10, 8), PASS,
      _pt(9, 11), PASS, _pt(11, 11), PASS, _pt(10, 12), PASS], _pt(10, 10)),
    ("union",
     [_pt(16, 3), _pt(14, 3), _pt(16, 5), _pt(14, 5), _pt(4, 14),
      _pt(5, 14), PASS, _pt(4, 13), PASS, _pt(4, 15), PASS, _pt(3, 13)],
     _pt(10, 10)),
    ("wrapped ko",
     [m for x in range(19) for m in (_pt(x, 14), _pt(x, 16))]
     + [m for x in range(19) for m in (_pt(x, 12), _pt(x, 18))] + KO_MOVES,
     KO_ACTION),
    ("two-sided capture",
     [_pt(2, 0), _pt(2, 1), _pt(0, 2), _pt(1, 2), PASS, _pt(0, 1), PASS,
      _pt(1, 0), PASS, _pt(0, 0)], _pt(1, 1)),
    ("two-sided ko",
     [_pt(1, 1), _pt(2, 1), _pt(2, 0), _pt(1, 2), _pt(0, 2), _pt(0, 1),
      PASS, _pt(1, 0), PASS], _pt(0, 0)),
]
#: per case, the point at which the player to move after its action would
#: repeat a position in the ring (a super-ko: plane 29 set, no candidate)
LEAF_KO = {"wrapped ko": KO_RECAPTURE, "two-sided ko": _pt(1, 1)}

_OWN_TWO = [_pt(1, 0), _pt(0, 0), _pt(2, 0), _pt(0, 1), _pt(3, 0), _pt(2, 1),
            _pt(15, 15), _pt(1, 2), _pt(15, 3), _pt(4, 0)]
#: the env-step kernel's scripted cases, ``(name, moves from an empty board,
#: the point given weight 1 (PASS: all weights 0), the move the step
#: makes)``; each reaches one of the kernel's paths:
#: - "two-sided capture": black's move at (1,1) captures the white corner
#:   chain through two of its stones (counted once in the hash and in
#:   the aggregate);
#: - "suicide": white's (0,0) between black's (1,0) and (0,1) passes;
#: - "own chain, two liberties": black's (1,1) has no empty neighbour and
#:   captures nothing; its own chain (1,0)-(3,0) has two liberties, (1,1)
#:   and (3,1), both reached from the row above in one warp slot: it
#:   plays;
#: - "own chain, one liberty": the same with white's (3,1) taking the
#:   second liberty: it passes;
#: - "own chain from two sides": black's (1,1) joins the chain (0,0),
#:   (1,0), (0,1) through two of its stones (counted once in the new
#:   aggregate);
#: - "merge three": black's (4,4) joins three black chains;
#: - "wrapped ko": the ring has wrapped (76 placements far from the
#:   corner, then KO_MOVES and black's capture at KO_ACTION): white's
#:   recapture at KO_RECAPTURE is a super-ko and passes;
#: - "wrapped ko, upper half": the same after 100 placements, so that the
#:   repeated position sits in ring slot 43 (the kernel's lanes compare
#:   slots 32..63 apart from 0..31);
#: - "two-sided ko": black's recapture at (1,1) of LEAF_CASES' corner ko
#:   is a super-ko through a chain captured from two sides, and passes;
#: - "filter miss": ring entry 0 is made (by :func:`env_cases`) to agree
#:   with black's candidate hash at (10,10) in the filter's low 12 bits of
#:   both words and to differ above them: the exact compare clears it,
#:   and it plays;
#: - "finished": two passes ended the game: it passes, frozen;
#: - "pass slot": no point has weight: it passes.
ENV_CASES = [
    ("two-sided capture", LEAF_CASES[4][1], _pt(1, 1), _pt(1, 1)),
    ("suicide", [_pt(1, 0), _pt(10, 10), _pt(0, 1)], _pt(0, 0), PASS),
    ("own chain, two liberties", _OWN_TWO, _pt(1, 1), _pt(1, 1)),
    ("own chain, one liberty", _OWN_TWO + [PASS, _pt(3, 1)], _pt(1, 1),
     PASS),
    ("own chain from two sides",
     [_pt(0, 0), _pt(10, 10), _pt(1, 0), _pt(10, 12), _pt(0, 1),
      _pt(12, 10)], _pt(1, 1), _pt(1, 1)),
    ("merge three", LEAF_CASES[0][1], _pt(4, 4), _pt(4, 4)),
    ("wrapped ko", LEAF_CASES[3][1] + [KO_ACTION], KO_RECAPTURE, PASS),
    ("wrapped ko, upper half",
     [m for x in range(12) for m in (_pt(x, 8), _pt(x, 6))]
     + LEAF_CASES[3][1] + [KO_ACTION], KO_RECAPTURE, PASS),
    ("two-sided ko", LEAF_CASES[5][1] + [_pt(0, 0)], _pt(1, 1), PASS),
    ("filter miss", [_pt(3, 3), _pt(15, 15)], _pt(10, 10), _pt(10, 10)),
    ("finished", [_pt(3, 3), PASS, PASS], _pt(10, 10), PASS),
    ("pass slot", [_pt(3, 3)], PASS, PASS),
]



def _most_chains() -> tuple[list[int], list[int]]:
    """Black and white points of a board near the most chains a legal
    position holds: stones coloured as a checkerboard (no two neighbours of
    one colour, so every stone is a chain of its own), the points with
    (x + 2 y) % 5 == 0 empty (each point of the board's inside then has one
    empty neighbour), and the edge stones without one emptied too."""
    empty = {_pt(x, y) for y in range(19) for x in range(19)
             if (x + 2 * y) % 5 == 0}
    stones = [q for q in range(NN) if q not in empty]
    lonely = [q for q in stones
              if not any(n in empty for n in NBR[q] if n < NN)]
    stones = [q for q in stones if q not in lonely]
    black = [q for q in stones if (q % 19 + q // 19) % 2 == 0]
    return black, [q for q in stones if q not in black]


_CROSS = [_pt(x, 16) for x in range(19)] + [_pt(9, y) for y in range(16)]
#: the feature kernel's scripted cases, ``(name, black points, white
#: points, the point meant)``; :func:`feature_cases` also gives each with
#: the colours swapped, so that both colours take each path.  Black at
#: the point meant (white where named) takes:
#: - "atari through two stones": no own chain; the white chain (2,1),
#:   (2,2), (1,2), whose one liberty is (1,1), is captured through two of
#:   its stones;
#: - "own chain from two sides": one black chain, through (5,4) and (6,5);
#:   its empty neighbour (5,6) touches the chain, (4,5) does not;
#: - "two own chains": (9,8) and (10,9), which share the liberty (10,8);
#: - "three own chains": (4,13), (3,14) and (5,14), two sharing (3,13);
#: - "own chain and a capture": the black chain (14,15), (14,16), (15,16)
#:   and the white chain (15,14), (15,15) in atari, whose stone (15,15)
#:   touches the black chain but not the point (14,14);
#: - "stone captured with its chain": the point is the black stone (1,5) of
#:   a chain in atari; black has one own chain there and no capture, white
#:   three own chains and the capture of the stone's own chain, the point
#:   itself among the captured stones;
#: - "single stone": the black stone (9,15) has no own neighbour; white
#:   has one own chain, the stone (10,15), and no capture;
#: - "edges and corners": black chains on columns 18 and 0 joined to a
#:   second chain at (17,4) and (1,11) (their dilations must not wrap
#:   around a row's end), two chains joined in the corner (18,18), and
#:   stones in the other corners;
#: - "long chain": the cross of row 16 and column 9 (every word of the
#:   board) joined to (7,5) at (8,5); at (18,18), black's row 18 in atari
#:   captures white's row 17 and white's captures black's;
#: - "most chains": ~280 one-stone chains (a checkerboard of stones with
#:   an empty point next to each), for any table of chains.
FEATURE_CASES = [
    ("atari through two stones",
     [_pt(2, 0), _pt(3, 1), _pt(3, 2), _pt(2, 3), _pt(1, 3), _pt(0, 2)],
     [_pt(2, 1), _pt(2, 2), _pt(1, 2)], _pt(1, 1)),
    ("own chain from two sides",
     [_pt(5, 4), _pt(6, 4), _pt(6, 5), _pt(6, 6)], [_pt(12, 12)],
     _pt(5, 5)),
    ("two own chains", [_pt(9, 8), _pt(10, 9)], [_pt(3, 3)], _pt(9, 9)),
    ("three own chains", [_pt(4, 13), _pt(3, 14), _pt(5, 14)], [_pt(15, 3)],
     _pt(4, 14)),
    ("own chain and a capture",
     [_pt(14, 15), _pt(14, 16), _pt(15, 16), _pt(16, 14), _pt(15, 13),
      _pt(16, 15)], [_pt(15, 14), _pt(15, 15)], _pt(14, 14)),
    ("stone captured with its chain", [_pt(1, 5), _pt(1, 6)],
     [_pt(0, 5), _pt(0, 6), _pt(2, 5), _pt(2, 6), _pt(1, 4)], _pt(1, 5)),
    ("single stone", [_pt(9, 15)], [_pt(10, 15)], _pt(9, 15)),
    ("edges and corners",
     [_pt(18, y) for y in range(3, 7)] + [_pt(16, 4)]
     + [_pt(0, y) for y in range(10, 14)] + [_pt(2, 11)]
     + [_pt(18, 17), _pt(17, 18), _pt(0, 0), _pt(1, 0), _pt(18, 0)],
     [_pt(0, 1), _pt(0, 18), _pt(1, 18), _pt(17, 0)], _pt(17, 4)),
    ("long chain",
     _CROSS + [_pt(7, 5)] + [_pt(x, 18) for x in range(18)],
     [_pt(x, 17) for x in range(19)], _pt(8, 5)),
    ("most chains", *_most_chains(), _pt(1, 1)),
]

#: the staircase's capture start: black at (3, 2) ladders the white stone
#: at (2, 2) across the board in 31 rungs (62 with the alternates read)
STAIRCASE_START = 19 * 3 + 2


def chain_ids(stones) -> list[int]:
    """Min-member chain ids of a 361 stones list (flood fill)."""
    cid = list(range(NN))
    seen = [False] * NN
    for p in range(NN):
        if stones[p] == 0 or seen[p]:
            continue
        group, todo = [], [p]
        seen[p] = True
        while todo:
            q = todo.pop()
            group.append(q)
            r, c = divmod(q, 19)
            for nb, ok in ((q - 19, r > 0), (q - 1, c > 0),
                           (q + 1, c < 18), (q + 19, r < 18)):
                if ok and stones[nb] == stones[p] and not seen[nb]:
                    seen[nb] = True
                    todo.append(nb)
        for q in group:
            cid[q] = min(group)
    return cid


def from_stones(boards, device, to_move: int = BLACK) -> GoState:
    """A batch of fresh GoStates holding ``boards`` (361 stones lists),
    ``to_move`` to play."""
    states = new_states(len(boards), device=device)
    return states.replace(
        stones=torch.tensor(boards, dtype=torch.int8, device=device),
        chain_id=torch.tensor([chain_ids(b) for b in boards],
                              dtype=torch.int32, device=device),
        to_move=torch.full((len(boards),), to_move, dtype=torch.int8,
                           device=device))


def ladder_stress() -> list[list[int]]:
    """Four stones lists, black to move: the 31-rung staircase, the same
    broken by a white stone at (17, 17), the 48-capture swarm and the
    12-escape swarm."""
    pt = lambda r, c: 19 * r + c
    stair = [0] * NN
    stair[pt(2, 2)] = 2
    for rc in ((1, 2), (2, 1), (1, 3)):
        stair[pt(*rc)] = 1
    broken = list(stair)
    broken[pt(17, 17)] = 2
    caps = [0] * NN
    for r in (2, 7, 12, 17):
        for c in (1, 4, 7, 10, 13, 16):
            caps[pt(r, c)] = 2
            for rc in ((r, c - 1), (r, c + 1), (r - 2, c), (r - 1, c - 1),
                       (r - 1, c + 1)):
                caps[pt(*rc)] = 1
    escs = [0] * NN
    for r in (2, 6, 10, 14):
        for c in (3, 10, 16):
            escs[pt(r, c)] = 1
            for rc in ((r + 1, c - 2), (r + 1, c + 2)):
                escs[pt(*rc)] = 1
            for rc in ((r, c - 1), (r, c + 1), (r - 1, c), (r + 2, c)):
                escs[pt(*rc)] = 2
    return [stair, broken, caps, escs]


def ladder_capture() -> list[list[int]]:
    """Two stones lists, black to move, on which a chase captures a chain
    that is neither the chased one nor the attacker's, so that other
    chains' liberties change mid-ladder:

    - the staircase with a white stone at (6, 9) boxed by black at (5, 8),
      (5, 9) and (6, 10): black's rung at (7, 9), 11 deep, captures it and
      the chase from (3, 2) still wins;
    - that board with black's first rung at (3, 2) played and the colours
      swapped, plus an escape unit at (14, 3): black's escape at (2, 3)
      fails to white's counter-ladder from (2, 4), whose rung at (7, 9)
      captures the black stone at (6, 9); the unit's escape at (15, 3)
      holds."""
    pt = lambda r, c: 19 * r + c
    board = ladder_stress()[0]
    board[pt(6, 9)] = 2
    for rc in ((5, 8), (5, 9), (6, 10)):
        board[pt(*rc)] = 1
    swapped = list(board)
    swapped[pt(3, 2)] = 1
    swapped = [3 - v if v else 0 for v in swapped]
    r, c = 14, 3
    for rc in ((r, c), (r + 1, c - 2), (r + 1, c + 2)):
        swapped[pt(*rc)] = 1
    for rc in ((r, c - 1), (r, c + 1), (r - 1, c), (r + 2, c)):
        swapped[pt(*rc)] = 2
    return [board, swapped]


def leaf_cases(device) -> tuple[GoState, torch.Tensor]:
    """The boards of ``LEAF_CASES``, each replayed from an empty board with
    the engine, and their actions i32[len(LEAF_CASES)]."""
    states = []
    for _, moves, _ in LEAF_CASES:
        s = new_states(1, device=device)
        for m in moves:
            s = step(s, torch.tensor([m], dtype=torch.int32, device=device))
        states.append(s)
    cat = GoState(**{k: torch.cat([getattr(s, k) for s in states])
                     for k in states[0].fields()})
    actions = torch.tensor([a for _, _, a in LEAF_CASES], dtype=torch.int32,
                           device=device)
    return cat, actions


def env_cases(device) -> tuple[GoState, torch.Tensor, torch.Tensor]:
    """The boards of ``ENV_CASES``, each replayed from an empty board with
    the engine (the "filter miss" board's ring entry 0 then rewritten),
    their one-hot weights f32[len(ENV_CASES), 361] and the moves
    i32[len(ENV_CASES)] the step makes."""
    states = []
    for name, moves, point, _ in ENV_CASES:
        s = new_states(1, device=device)
        for m in moves:
            s = step(s, torch.tensor([m], dtype=torch.int32, device=device))
        if name == "filter miss":
            # the candidate's hash is the hash after the move; flip bit 20
            # of word 0, above the filter's 12 bits
            h = step(s, torch.tensor([point], dtype=torch.int32,
                                     device=device)).hash
            ring = s.hash_hist.clone()
            ring[:, 0] = h ^ torch.tensor([1 << 20, 0], dtype=torch.int32,
                                          device=device)
            s = s.replace(hash_hist=ring)
        states.append(s)
    cat = GoState(**{k: torch.cat([getattr(s, k) for s in states])
                     for k in states[0].fields()})
    weights = torch.zeros(len(ENV_CASES), 361, device=device)
    for i, (_, _, point, _) in enumerate(ENV_CASES):
        if point < PASS:
            weights[i, point] = 1.0
    moves = torch.tensor([c[3] for c in ENV_CASES], dtype=torch.int32,
                         device=device)
    return cat, weights, moves


def feature_cases(device) -> GoState:
    """The boards of ``FEATURE_CASES``, then the same with the colours
    swapped (black to move)."""
    boards = []
    for swap in (False, True):
        for _, black, white, _ in FEATURE_CASES:
            stones = [0] * NN
            for q in black:
                stones[q] = 2 if swap else 1
            for q in white:
                stones[q] = 1 if swap else 2
            boards.append(stones)
    return from_stones(boards, device)


def ko_captured(states: GoState, ko: torch.Tensor) -> GoState:
    """``states`` with KO_ACTION played on the boards of the bool[B] mask
    ``ko`` (boards that hold KO_MOVES), whose recapture is then a
    super-ko."""
    act = torch.full((states.batch,), KO_ACTION, dtype=torch.int32,
                     device=states.stones.device)
    return step(states, act).select(ko, states)


def env_step_cases(states: GoState, gen: torch.Generator, ko: torch.Tensor,
                   pass_slots: torch.Tensor) -> list:
    """``(name, weights, rng_bits)`` of the env-step kernel's four parity
    cases: uniform weights with given words; uniform weights with the
    kernel's Philox words; one-hot weights on a legal point, on the
    super-ko recapture of the ``ko`` boards (after :func:`ko_captured`)
    and on no point (the pass slot) on the ``pass_slots`` boards; zero
    weights."""
    b, dev = states.batch, states.stones.device
    idx = torch.arange(b, device=dev)
    bits = torch.randint(-2**31, 2**31, (b, 361), generator=gen,
                         device=dev, dtype=torch.int64).to(torch.int32)
    uniform = torch.ones(b, 361, device=dev)
    legal = legal_mask(states)[:, :361].float()
    pick = torch.multinomial(
        torch.where(legal.any(1, keepdim=True), legal, 1.0), 1,
        generator=gen)[:, 0]
    pick = torch.where(ko, KO_RECAPTURE, pick)
    onehot = torch.zeros(b, 361, device=dev)
    onehot[idx, pick] = 1.0
    onehot[pass_slots] = 0.0
    return [("given bits", uniform, bits), ("philox", uniform, None),
            ("one-hot", onehot, None),
            ("zero", torch.zeros(b, 361, device=dev), None)]
