"""Engine-vs-engine arena over RL-loop generation weights (port of
`tools/arena.py`).

Plays batched lockstep matches between the per-generation weight dumps an
RL run leaves in its out dir (``weights_NNNN.json``) and fits Elo ratings
over the results: the learning-curve measurement the reference gets from
uploading generations to its REST server and CGOS (`README.md:80-93`,
`tools/sgf2elo.py`).

Both towers evaluate every position (one batched call each); the policy of
the side to move is selected per game, colours alternate with the game
index, and games are scored by Benson clearing and Tromp-Taylor like
self-play records.  Each net reads its own input contract: planes 30/31
when its ``ladder_features:0`` says so (from the exact ladder kernel on
``cuda``, the greedy reader on the CPU), zeros there otherwise.

    python -m dream_go_torch.tools.arena OUT_DIR [--games 32]
        [--max-pair-gap 4] [--rollouts R] [--gens 0,1,2] [--sgf-out FILE]
        [--max-moves 722] [--seed 0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import itertools
import json
import os
import re
import sys

import torch

from ..config import SearchConfig
from ..go import benson as bn
from ..go import engine, features
from ..go.options import scoring_mask
from ..mcts import search as S
from ..mcts.choose import choose
from ..mcts.predictor import Predictor
from ..models import params as MP
from ..models import tower as T


def load_gen_weights(out_dir: str, device="cuda"):
    """``[(gen, tower, model_cfg)]`` for every ``weights_*.json``, the
    towers in the compute dtype on ``cuda`` and float32 elsewhere."""
    device = torch.device(device)
    dtype = None if device.type == "cuda" else "float32"
    out = []
    for path in sorted(glob.glob(os.path.join(out_dir, "weights_*.json"))):
        gen = int(re.search(r"weights_(\d+)\.json$", path).group(1))
        with open(path) as fh:
            cfg, folded = MP.load_json(fh.read())
        out.append((gen, T.from_state_dict(cfg, MP.to_state_dict(cfg, folded),
                                           device, dtype), cfg))
    return out


def _net(tower: T.Tower, planes: torch.Tensor):
    """``(win rate, policy)`` of ``tower`` on plane-major inputs, planes
    30/31 zeroed unless its contract reads them."""
    if not tower.cfg.ladder_features:
        planes = torch.cat([planes[:, :30], torch.zeros_like(planes[:, 30:])],
                           1)
    with torch.no_grad():
        logits, value, _ = tower(planes)
    return (value + 1.0) * 0.5, torch.softmax(logits, dim=-1)


def _a_moves(states: engine.GoState) -> torch.Tensor:
    """True where net A is to move: A plays black in even games."""
    a_black = torch.arange(states.batch, device=states.stones.device) % 2 == 0
    return torch.where(a_black, states.to_move == engine.BLACK,
                       states.to_move == engine.WHITE)


def arena_mask(states: engine.GoState) -> torch.Tensor:
    """The moves a policy move may take: legal moves once a board is
    scorable, the ScoringSearch candidates before."""
    return torch.where(bn.is_scorable(states)[:, None],
                       engine.legal_mask(states), scoring_mask(states))


def arena_features(states: engine.GoState, ladders: bool) -> torch.Tensor:
    """The V1 planes of ``states``, planes 30/31 with ``ladders``."""
    cuda = states.stones.device.type == "cuda"
    return features.extract_batch(states, ladders, False, cuda)


def build_move_fn(model_cfg, temperature=0.7, cutoff=0.5):
    """``(move_fn, territory)``: ``move_fn(wa, wb, states, gen) ->
    (states, move, value)`` samples each game's move from the policy of
    the net to move with percentile-cutoff temperature sampling; planes
    30/31 are computed when ``model_cfg.ladder_features`` says so."""

    def move_fn(wa, wb, states, gen):
        planes = arena_features(states, model_cfg.ladder_features).permute(
            0, 3, 1, 2)
        va, pa = _net(wa, planes)
        vb, pb = _net(wb, planes)
        a_moves = _a_moves(states)
        policy = torch.where(a_moves[:, None], pa, pb)
        value = torch.where(a_moves, va, vb)
        masked = torch.where(arena_mask(states), policy, 0.0)
        move = choose(gen, masked, cutoff, temperature)
        move = torch.where(states.done, engine.PASS, move).to(torch.int32)
        return engine.step(states, move), move, value

    def territory(states):
        return bn.stone_status(states.stones, states.chain_id, states.stones,
                               states.chain_id)[1]

    return move_fn, territory


class _PairPredictor(Predictor):
    """Both nets on every leaf, each game taking the net to move at its
    root."""

    def __init__(self, wa, wb, a_to_search):
        super().__init__()
        self.wa, self.wb, self.a = wa, wb, a_to_search

    def __call__(self, feats):
        return self.planes(feats.permute(0, 3, 1, 2))

    def planes(self, x):
        va, pa = _net(self.wa, x)
        vb, pb = _net(self.wb, x)
        return (torch.where(self.a, va, vb),
                torch.where(self.a[:, None], pa, pb))


def build_search_move_fn(model_cfg, rollouts, temperature=0.7, cutoff=0.5,
                         temperature_moves=8, device="cuda"):
    """MCTS move function: each side searches with its own net (the
    reference's strength story is search play, `README.md:80-93`).  Each
    move runs a fresh batched search whose leaves evaluate both nets; the
    first ``temperature_moves`` moves sample with temperature, then
    LCB-greedy like GTP play.  The search stack is the device's (the fused
    leaf kernel and EARLY-C on ``cuda``)."""
    scfg = SearchConfig(num_rollout=rollouts, temperature=temperature,
                        cutoff_percentile=cutoff,
                        ladder_features=model_cfg.ladder_features,
                        ).resolve_auto(device)

    def move_fn(wa, wb, states, gen):
        predictor = _PairPredictor(wa, wb, _a_moves(states))
        use_scoring = ~bn.is_scorable(states) & ~states.done
        trees = S.search(states, predictor, gen, scfg, rollouts, use_scoring,
                         adaptive=bool(scfg.adaptive))
        temp = torch.where(states.move_count < temperature_moves,
                           float(temperature), 0.0)
        move, value = S.best_move(trees, gen, scfg, temp)
        move = torch.where(states.done, engine.PASS, move).to(torch.int32)
        return engine.step(states, move), move, value

    return move_fn


def play_pair(move_fn, territory_fn, wa, wb, name_a, name_b, games, seed,
              komi=7.5, max_moves=722, device="cuda"):
    """SGF lines of ``games`` lockstep games of A against B, colours
    alternating, scored after ``max_moves`` moves at most."""
    device = torch.device(device)
    states = engine.new_states(games, komi=komi, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for _ in range(max_moves):
        states, _, _ = move_fn(wa, wb, states, gen)
        if bool(states.done.all()):
            break
    terr = territory_fn(states).cpu().numpy()
    out = []
    for g in range(games):
        black = float((terr[g] == 1).sum())
        white = float((terr[g] == 2).sum()) + komi
        res = f"B+{black - white:.1f}" if black > white \
            else f"W+{white - black:.1f}" if white > black else "0"
        pb, pw = (name_a, name_b) if g % 2 == 0 else (name_b, name_a)
        out.append(f"(;GM[1]FF[4]SZ[19]KM[{komi:.1f}]PB[{pb}]PW[{pw}]"
                   f"RE[{res}])")
    return out


def fit_elo(lines):
    """{name: rating} by logistic MLE (same fit as tools/sgf2elo.py)."""
    pat_b = re.compile(r"PB\[([^\]]*)\]")
    pat_w = re.compile(r"PW\[([^\]]*)\]")
    pat_r = re.compile(r"RE\[([BW])")
    games = []
    rating = {}
    for line in lines:
        b, w, r = pat_b.search(line), pat_w.search(line), pat_r.search(line)
        if not (b and w and r):
            continue
        games.append((b.group(1), w.group(1),
                      1.0 if r.group(1) == "B" else 0.0))
        rating.setdefault(b.group(1), 0.0)
        rating.setdefault(w.group(1), 0.0)
    names = sorted(rating)
    for _ in range(2000):
        grad = {n: 0.0 for n in names}
        for b, w, s in games:
            p = 1.0 / (1.0 + 10 ** ((rating[w] - rating[b]) / 400.0))
            grad[b] += s - p
            grad[w] -= s - p
        for n in names:
            rating[n] += 8.0 * grad[n] / max(1, len(games))
        anchor = rating[names[0]]
        for n in names:
            rating[n] -= anchor
    return rating


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dream_go_torch.tools.arena")
    ap.add_argument("out_dir")
    ap.add_argument("--games", type=int, default=32)
    ap.add_argument("--max-pair-gap", type=int, default=4,
                    help="play gen i vs j only when j - i <= this "
                         "(plus power-of-two long links)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--sgf-out", help="also write match SGF lines here")
    ap.add_argument("--rollouts", type=int, default=0,
                    help="rate by MCTS play with this many rollouts a move "
                         "instead of raw policy sampling")
    ap.add_argument("--gens", help="comma-separated generation numbers to "
                                   "rate (default: all weights_*.json)")
    ap.add_argument("--max-moves", type=int, default=722,
                    help="score each game after this many moves at most")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    gens = load_gen_weights(args.out_dir, args.device)
    if args.gens:
        want = {int(g) for g in args.gens.split(",")}
        gens = [g for g in gens if g[0] in want]
    if len(gens) < 2:
        print("need >= 2 generations", file=sys.stderr)
        return 1
    # planes 30/31 are computed when any net reads them
    model_cfg = dataclasses.replace(gens[0][2], ladder_features=any(
        cfg.ladder_features for *_, cfg in gens))
    policy_fn, territory_fn = build_move_fn(model_cfg)
    move_fn = build_search_move_fn(model_cfg, args.rollouts,
                                   device=args.device) \
        if args.rollouts > 0 else policy_fn

    pairs = []
    for (i, (gi, *_)), (j, (gj, *_)) in itertools.combinations(
            enumerate(gens), 2):
        gap = j - i
        if gap <= args.max_pair_gap or (gap & (gap - 1)) == 0:
            pairs.append((i, j))

    lines = []
    for n, (i, j) in enumerate(pairs):
        gi, pa, _ = gens[i]
        gj, pb, _ = gens[j]
        res = play_pair(move_fn, territory_fn, pa, pb, f"gen{gi:04d}",
                        f"gen{gj:04d}", args.games, args.seed + 7919 * n,
                        max_moves=args.max_moves, device=args.device)
        lines.extend(res)
        wins_a = sum(1 for l in res
                     if (f"PB[gen{gi:04d}]" in l) == ("RE[B" in l))
        print(f"gen{gi:04d} vs gen{gj:04d}: {wins_a}/{len(res)}",
              file=sys.stderr, flush=True)

    if args.sgf_out:
        with open(args.sgf_out, "w") as fh:
            fh.write("\n".join(lines) + "\n")

    rating = fit_elo(lines)
    ordered = sorted(rating.items())
    print(json.dumps({"elo": {n: round(r, 1) for n, r in ordered},
                      "games": len(lines)}), flush=True)
    deltas = [ordered[k + 1][1] - ordered[k][1]
              for k in range(len(ordered) - 1)]
    rising = sum(1 for d in deltas if d > 0)
    print(f"adjacent-generation Elo rises: {rising}/{len(deltas)}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
