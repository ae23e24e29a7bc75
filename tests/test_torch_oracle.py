"""The port's pure-Python rules and ladder oracle
(`dream_go_torch/go/reference.py`) against the JAX package's, move for
move; the port's engine against the port's oracle, as
`tests/test_engine.py` holds JAX's engine against JAX's; and the port's
``ladder_differential`` on the CPU (the ladder kernel's plain version
against the oracle at every candidate point)."""

import ast
import contextlib
import io
import json
import pathlib

import numpy as np
import pytest
import torch

import _torch_bridge  # noqa: F401  (one torch thread a test process)
from dream_go_tpu.go import reference as jref
from dream_go_torch.go import engine as teng
from dream_go_torch.go import ladder as tladder
from dream_go_torch.go import reference as tref
from dream_go_torch.ops import layout
from dream_go_torch.ops.ladder_kernel import ladder_planes_plain
from dream_go_torch.tools import ladder_differential as tld

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _region(rng, confined: bool) -> np.ndarray:
    """All points, or a 6..9 wide square of them (the differential tool's
    capture-dense sub-board games)."""
    if not confined:
        return np.ones(361, bool)
    w = int(rng.integers(6, 10))
    x0, y0 = rng.integers(0, 19 - w, 2)
    m = np.zeros((19, 19), bool)
    m[y0:y0 + w, x0:x0 + w] = True
    return m.reshape(361)


def _pick(rng, mask, region, pass_prob=0.0) -> int:
    pts = np.flatnonzero(mask[:361] & region)
    if len(pts) == 0:
        pts = np.flatnonzero(mask[:361])
    if len(pts) == 0 or rng.random() < pass_prob:
        return 361
    return int(rng.choice(pts))


def _ladder_answers(b, color):
    """Every candidate point's ``(point, capture, escape)`` answers for
    ``color`` (capture starts next to an opponent chain on two liberties,
    escape starts next to an own chain in atari)."""
    opp = 3 - color
    out = []
    for p in range(361):
        if not b.is_pseudo_legal(color, p):
            continue
        nb = list(tref.neighbors(p))
        cap = any(b.stones[q] == opp and b.num_liberties(q) == 2
                  for q in nb)
        esc = any(b.stones[q] == color and b.num_liberties(q) == 1
                  for q in nb)
        if cap or esc:
            out.append((p, cap and b.is_ladder_capture(color, p),
                        esc and b.is_ladder_escape(color, p)))
    return out


@pytest.mark.parametrize("seed,confined", [(0, False), (1, False),
                                           (2, True), (3, True)])
def test_pyboard_matches_jax(seed, confined):
    """Seeded random games (two confined to a sub-board) on both oracles:
    stones, player to move, hash words, pass count and legal mask after
    every move; every 12 moves, pseudo-legality and liberties-if of both
    colours at every point, each stone's liberties, the liberty map and the
    ladder answers of both colours at every candidate."""
    rng = np.random.default_rng(seed)
    region = _region(rng, confined)
    tb, jb = tref.PyBoard(), jref.PyBoard()
    ladders = 0
    for move_no in range(110):
        mask = tb.legal_mask()
        np.testing.assert_array_equal(mask, jb.legal_mask())
        assert (tb.stones, tb.to_move, tb.hash, tb.pass_count, tb.done,
                tb.last_two) == (jb.stones, jb.to_move, jb.hash,
                                 jb.pass_count, jb.done, jb.last_two), \
            move_no
        if move_no % 12 == 11:
            for color in (1, 2):
                pseudo = [tb.is_pseudo_legal(color, p) for p in range(362)]
                assert pseudo == [jb.is_pseudo_legal(color, p)
                                  for p in range(362)]
                assert [tb.liberties_if(color, p) for p in range(361)
                        if pseudo[p] and tb.stones[p] == 0] == \
                    [jb.liberties_if(color, p) for p in range(361)
                     if pseudo[p] and jb.stones[p] == 0]
                got = _ladder_answers(tb, color)
                assert got == _ladder_answers(jb, color)
                ladders += sum(c or e for _, c, e in got)
            assert [tb.num_liberties(p) for p in range(361) if tb.stones[p]] \
                == [jb.num_liberties(p) for p in range(361) if jb.stones[p]]
            np.testing.assert_array_equal(tb.liberty_map(),
                                          jb.liberty_map())
        mv = _pick(rng, mask, region, pass_prob=0.01)
        tb.play(mv)
        jb.play(mv)
    assert tb.hash_history == jb.hash_history
    if confined:
        assert ladders > 0, "no ladder read as working in these games"


@pytest.mark.parametrize("seed", range(3))
def test_engine_matches_oracle(seed):
    """Random legal games on the port's batched engine (two boards) and on
    the port's oracle: legal masks, stones, liberty maps and hashes after
    every move, as `tests/test_engine.py` holds JAX's engine."""
    rng = np.random.default_rng(seed)
    boards = [tref.PyBoard() for _ in range(2)]
    regions = [_region(rng, False), _region(rng, True)]
    states = teng.new_states(2, device="cpu")
    for move_no in range(120):
        masks = np.stack([b.legal_mask() for b in boards])
        np.testing.assert_array_equal(
            teng.legal_mask(states).numpy(), masks,
            err_msg=f"legal mask, move {move_no} (seed {seed})")
        np.testing.assert_array_equal(
            states.stones.numpy(), np.stack([b.stones_array()
                                             for b in boards]))
        np.testing.assert_array_equal(
            teng.chain_liberties(states.stones, states.chain_id)[0].numpy(),
            np.stack([b.liberty_map() for b in boards]))
        np.testing.assert_array_equal(
            states.hash.numpy().view(np.uint32),
            np.asarray([b.hash for b in boards], np.uint32))
        np.testing.assert_array_equal(
            states.to_move.numpy(), [b.to_move for b in boards])
        mv = [_pick(rng, m, r, pass_prob=0.01)
              for m, r in zip(masks, regions)]
        for b, a in zip(boards, mv):
            b.play(a)
        states = teng.step(states, torch.as_tensor(mv, dtype=torch.int32))


def _json_keys(tool: str, var: str = "out") -> list[str]:
    """The keys of the dict literal the JAX tool assigns to ``var``."""
    tree = ast.parse((ROOT / "tools" / f"{tool}.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == var
                        for t in node.targets):
            return [k.value for k in node.value.keys]
    raise AssertionError(f"no dict assigned to {var} in {tool}")


def test_ladder_differential_on_the_cpu():
    """Ten positions of the JAX tool's seed 0: no disagreement, every key
    of the JAX tool's line, and the oracle's candidate counts of those
    positions (the two tools draw the same games)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tld.main(["--positions", "10", "--device", "cpu"])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0
    assert list(line)[:10] == _json_keys("ladder_differential")
    assert line["total_disagree"] == 0 and line["positions"] == 10
    # the JAX tool's line for these positions (its bounded reader agrees
    # on them too): 56 capture and 11 escape points
    assert (line["capture_points"], line["escape_points"]) == (56, 11)


#: two positions of ``ladder_differential``'s seed 0 (positions 162 and
#: 1103, white to move, their moves from the empty board) on which the
#: ladder kernel read no capture at the point where the oracle's
#: recursion finds one; the exact reader needs a branch stack of 16 and
#: 32 entries there, and the kernel and its plain version (and JAX's
#: reader) keep 8, past which a chase fails safe (no capture)
STACK_CASES = [
    ([268, 278, 175, 251, 116, 55, 350, 141, 56, 276, 318, 133, 352, 40,
      166, 194, 107, 222, 72, 332, 344, 59, 17, 354, 269, 24, 20, 203, 236,
      217, 0, 127, 98, 258, 216, 91, 202, 349, 139], 37, 16),
    ([234, 269, 265, 90, 330, 119, 62, 357, 287, 321, 331, 10, 136, 104,
      355, 103, 356, 311, 169, 132, 0, 312, 3, 308, 246, 290, 41], 1, 32),
]


@pytest.mark.parametrize("moves,point,stack", STACK_CASES)
def test_ladder_disagreement_is_the_branch_stack(moves, point, stack):
    """The oracle reads a capture; the exact reader at its bounds (the
    kernel's plain version) reads none, and finds it once its branch
    stack may hold ``stack`` entries (the rung budget does not matter)."""
    board = tref.PyBoard()
    states = teng.new_states(1, device="cpu")
    for mv in moves:
        board.play(mv)
        states = teng.step(states, torch.tensor([mv], dtype=torch.int32))
    color = board.to_move
    assert color == 2 and board.is_ladder_capture(color, point)
    stones, cid = layout.board_rows(states)
    to_move = states.to_move.to(torch.int32)
    cap, _ = ladder_planes_plain(stones, cid, to_move)
    assert not cap[0, point]
    cap, _ = ladder_planes_plain(stones, cid, to_move, budget=10 ** 5)
    assert not cap[0, point]
    for cap_entries, want in ((stack // 2, False), (stack, True)):
        cap, _ = tladder.ladder_planes(states, max_candidates=None,
                                       max_escapes=None, budget=10 ** 5,
                                       stack_cap=cap_entries)
        assert bool(cap[0, point]) == want, cap_entries
