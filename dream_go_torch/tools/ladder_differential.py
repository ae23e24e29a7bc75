"""Ladder planes against the recursive oracle, at scale (port of
`tools/ladder_differential.py`).

Plays random games, half of them confined to a 6..9 wide sub-board (to
force capture-dense, ladder-rich shapes), on the pure-Python oracle
(`go/reference.py`), which draws every move from its own legal mask;
replays the same moves on the port's engine, in batches; reads the exact
planes 30/31 of every position with the ladder kernel (K2,
`ops/ladder_kernel.py`; its plain version, every candidate, on the CPU);
and compares them with the oracle's ``is_ladder_capture`` /
``is_ladder_escape`` at the candidate points (the first
``--max-per-position`` of each position), as the JAX tool does.  The
same seed gives the JAX tool's positions and moves.

    python -m dream_go_torch.tools.ladder_differential [--positions N] \\
        [--seed S] [--device cuda|cpu]

Prints one JSON line (the JAX tool's keys, then where the time went);
exit code 1 if the disagreement rate exceeds 0.1%.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..go.reference import PyBoard, neighbors
from ..ops import layout
from ..ops.ladder_kernel import ladder_planes_kernel
from ..selfplay.replay import states_at
from ..utils.device import describe, resolve, sync

#: positions whose planes are read in one call
CHUNK = 256


def random_position(rng: np.random.Generator):
    """``(board, moves)`` of one random game, or None where a game ran out
    of legal points (the JAX tool's draws, in its order)."""
    b = PyBoard()
    moves = []
    depth = int(rng.integers(20, 160))
    region = np.ones(361, bool)
    if rng.random() < 0.5:
        w = int(rng.integers(6, 10))
        x0, y0 = rng.integers(0, 19 - w, 2)
        m = np.zeros((19, 19), bool)
        m[y0:y0 + w, x0:x0 + w] = True
        region = m.reshape(361)
    for _ in range(depth):
        mask = b.legal_mask()
        pts = np.flatnonzero(mask[:361] & region)
        if len(pts) == 0:
            pts = np.flatnonzero(mask[:361])
        if len(pts) == 0:
            return None
        mv = int(rng.choice(pts))
        b.play(mv)
        moves.append(mv)
    return b, moves


def read_planes(boards, move_lists, device):
    """Planes 30/31 (bool numpy [P, 361] each) of the positions, replayed
    on the engine; the replayed stones must be the oracle's."""
    t_max = max(len(m) for m in move_lists)
    moves = np.full((len(move_lists), t_max), 361, np.int32)
    for row, seq in enumerate(move_lists):
        moves[row, :len(seq)] = seq
    lengths = np.asarray([len(m) for m in move_lists], np.int32)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    states = states_at(t(moves), t(lengths),
                       t(np.full(len(move_lists), 7.5, np.float32)), 64)
    states = states.replace(to_move=t(np.asarray(
        [b.to_move for b in boards], np.int8)))
    want = np.stack([b.stones_array() for b in boards])
    if not np.array_equal(states.stones.cpu().numpy(), want):
        raise RuntimeError("the engine's replay departs from the oracle")
    stones, cid = layout.board_rows(states)
    cap, esc = ladder_planes_kernel(stones, cid,
                                    states.to_move.to(torch.int32))
    return cap.cpu().numpy(), esc.cpu().numpy()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dream_go_torch.tools.ladder_differential")
    ap.add_argument("--positions", type=int, default=1500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-per-position", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve(args.device)
    rng = np.random.default_rng(args.seed)

    t0 = time.monotonic()
    positions = []
    while len(positions) < args.positions:
        got = random_position(rng)
        if got is not None:
            positions.append(got)
    t_play = time.monotonic() - t0

    t1 = time.monotonic()
    caps, escs = [], []
    for i in range(0, len(positions), CHUNK):
        part = positions[i:i + CHUNK]
        cap, esc = read_planes([b for b, _ in part], [m for _, m in part],
                               device)
        caps.append(cap)
        escs.append(esc)
    sync(device)
    t_planes = time.monotonic() - t1
    caps, escs = np.concatenate(caps), np.concatenate(escs)

    t2 = time.monotonic()
    n_cap = n_esc = cap_dis = esc_dis = 0
    examples = []
    for pos_done, (b, _) in enumerate(positions, start=1):
        cap, esc = caps[pos_done - 1], escs[pos_done - 1]
        color = b.to_move
        opp = 3 - color
        checked = 0
        for p in range(361):
            if checked >= args.max_per_position:
                break
            if not b.is_pseudo_legal(color, p):
                continue
            is_cap_cand = any(
                b.stones[q] == opp and b.num_liberties(q) == 2
                for q in neighbors(p))
            is_esc_cand = any(
                b.stones[q] == color and b.num_liberties(q) == 1
                for q in neighbors(p))
            if is_cap_cand:
                want = b.is_ladder_capture(color, p)
                n_cap += 1
                checked += 1
                if bool(cap[p]) != want:
                    cap_dis += 1
                    if len(examples) < 20:
                        examples.append(("cap", pos_done, p, want))
            if is_esc_cand:
                want = b.is_ladder_escape(color, p)
                n_esc += 1
                checked += 1
                if bool(esc[p]) != want:
                    esc_dis += 1
                    if len(examples) < 20:
                        examples.append(("esc", pos_done, p, want))
    t_oracle = time.monotonic() - t2

    total = n_cap + n_esc
    dis = cap_dis + esc_dis
    seconds = time.monotonic() - t0
    print(json.dumps({
        "positions": len(positions),
        "capture_points": n_cap,
        "capture_disagree": cap_dis,
        "escape_points": n_esc,
        "escape_disagree": esc_dis,
        "total_points": total,
        "total_disagree": dis,
        "disagree_rate": dis / max(total, 1),
        "seconds": round(seconds, 1),
        "examples": examples,
        # where the time went: the oracle's games, the engine's replay
        # with the planes (K2 on the card), the oracle's readings
        "play_seconds": round(t_play, 3),
        "planes_seconds": round(t_planes, 3),
        "oracle_seconds": round(t_oracle, 3),
        "seed": args.seed,
        "device": describe(device),
    }))
    return 1 if dis / max(total, 1) > 0.001 else 0


if __name__ == "__main__":
    sys.exit(main())
