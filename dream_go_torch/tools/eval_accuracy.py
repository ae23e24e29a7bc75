"""Held-out policy and value accuracy of dumped weights over real games
(port of `tools/eval_accuracy.py`).

The reference's training metrics are policy top-1/3/5 accuracy and value
sign accuracy on its input stream
(`contrib/trainer/dream_tf/model_fn.py:160-183`).  This tool measures the
same quantities on a corpus the training never saw, for one or more
dumped weights files, so that an RL run's generations can be compared on
data that is not self-play.  The default corpus is the three sample games
in the repository, `tests/fixtures/sample_games.sgf`; the reference's
99-game professional fixture is not in it.

    python -m dream_go_torch.tools.eval_accuracy WEIGHTS.json [MORE.json...]
        [--games FILE.sgf] [--positions-per-game 16] [--batch 128]
        [--seed 0] [--device cuda|cpu]

Prints one JSON line per weights file:
``{"weights": ..., "examples": N, "top1": ..., "top3": ..., "top5": ...,
"value_sign": ...}``.  The V1 planes come without planes 30/31, as the
JAX tool reads them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..go import engine, features
from ..mcts.predictor import net_predictor
from ..models import params as MP
from ..models import tower as T
from ..selfplay.replay import states_at
from ..train.pipeline import parse_game

DEFAULT_GAMES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tests", "fixtures", "sample_games.sgf")


def load_games(path: str):
    with open(path) as fh:
        return [g for g in (parse_game(l) for l in fh if l.strip())
                if g is not None]


def pick_examples(games, positions_per_game: int, seed: int):
    """One evaluation set for every weights file: ``(game index,
    position, played move, +1/-1/0 whether the player to move won)``."""
    rng = np.random.default_rng(seed)
    examples = []
    for gi, g in enumerate(games):
        n = len(g.moves)
        for pos in rng.choice(n, size=min(positions_per_game, n),
                              replace=False):
            pos = int(pos)
            color = int(g.colors[pos])
            win = 0 if g.winner == 0 else (1 if g.winner == color else -1)
            examples.append((gi, pos, int(g.moves[pos]), win))
    return examples


def predictions(path: str, games, examples, batch: int, device="cuda"):
    """``(value[N], policy[N, 362])`` of the weights file ``path`` at every
    example, evaluated ``batch`` positions a call (the last call padded
    with its last example)."""
    device = torch.device(device)
    with open(path) as fh:
        cfg, folded = MP.load_json(fh.read())
    predict = net_predictor(T.from_state_dict(
        cfg, MP.to_state_dict(cfg, folded), device,
        None if device.type == "cuda" else "float32"))
    t_max = max(len(g.moves) for g in games)
    t_max = ((t_max + 127) // 128) * 128
    values, policies = [], []
    for start in range(0, len(examples), batch):
        chunk = examples[start:start + batch]
        chunk_p = chunk + [chunk[-1]] * (batch - len(chunk))
        moves = np.full((batch, t_max), engine.PASS, np.int32)
        tgt = np.zeros(batch, np.int32)
        komi = np.zeros(batch, np.float32)
        for row, (gi, pos, _, _) in enumerate(chunk_p):
            seq = games[gi].moves
            moves[row, :len(seq)] = seq
            tgt[row] = pos
            komi[row] = games[gi].komi
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        states = states_at(t(moves), t(tgt), t(komi), 64)
        value, policy = predict(features.extract_batch(
            states, False, device.type == "cuda", False))
        values.append(value[:len(chunk)].float().cpu().numpy())
        policies.append(policy[:len(chunk)].float().cpu().numpy())
    return np.concatenate(values), np.concatenate(policies)


def accuracy_row(path: str, examples, value, policy) -> dict:
    """The JSON line of ``path``: top-k hits of the played move in
    ``np.argsort(-policy)`` (as the JAX tool sorts), and the value's sign
    where the game has a winner."""
    hits = dict(top1=0, top3=0, top5=0, value=0, value_n=0)
    order = np.argsort(-policy, axis=-1)
    for row, (_, _, played, win) in enumerate(examples):
        top = order[row]
        hits["top1"] += played == top[0]
        hits["top3"] += played in top[:3]
        hits["top5"] += played in top[:5]
        if win != 0:
            hits["value_n"] += 1
            hits["value"] += (1 if value[row] > 0.5 else -1) == win
    total = len(examples)
    return {"weights": path, "examples": total,
            "top1": round(hits["top1"] / total, 4),
            "top3": round(hits["top3"] / total, 4),
            "top5": round(hits["top5"] / total, 4),
            "value_sign": round(hits["value"] / max(hits["value_n"], 1), 4)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dream_go_torch.tools.eval_accuracy")
    ap.add_argument("weights", nargs="+")
    ap.add_argument("--games", default=DEFAULT_GAMES)
    ap.add_argument("--positions-per-game", type=int, default=16)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    games = load_games(args.games)
    if not games:
        print("no parsable games", file=sys.stderr)
        return 1
    examples = pick_examples(games, args.positions_per_game, args.seed)
    for path in args.weights:
        value, policy = predictions(path, games, examples, args.batch,
                                    args.device)
        print(json.dumps(accuracy_row(path, examples, value, policy)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
