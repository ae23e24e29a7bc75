"""The cost of the ladder feature planes on the device (port of
`tools/profile_ladder.py`).

Times `go/ladder.py::ladder_planes_batch` (``greedy``: the greedy
reader; ``exact``: the exact reader, the ladder kernel K2 on the card)
on a batch of boards played ``--depth`` uniformly random moves deep, then
the search's simulations/s at 128 x 9 with ladders off / greedy / exact
(the fused search on the card, K1), unless ``--skip-search``.

    python -m dream_go_torch.tools.profile_ladder [--batch 1024] \\
        [--repeats 5] [--skip-search] [--device cuda|cpu]

On the CPU the exact reader is the bounded one the search uses there
(24 capture and 8 escape starts a board).  Prints the JAX tool's lines,
then one JSON line of the numbers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from ..config import SearchConfig
from ..go import engine
from ..go.ladder import ladder_planes_batch
from ..mcts import search as S
from ..ops import layout
from ..utils.device import describe, resolve, sync
from .common import load_net, random_playout


def timed(fn, repeats, device):
    """Median seconds of ``repeats`` calls, each synchronised."""
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync(device)
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dream_go_torch.tools.profile_ladder")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--depth", type=int, default=100)
    ap.add_argument("--sims", type=int, default=16)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--blocks", type=int, default=9)
    ap.add_argument("--skip-search", action="store_true")
    ap.add_argument("--modes", nargs="+", default=["greedy", "exact"],
                    choices=["greedy", "exact"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve(args.device)
    print(f"device: {describe(device)}", flush=True)
    out = {"batch": args.batch, "depth": args.depth,
           "device": describe(device)}

    gen = torch.Generator(device=device).manual_seed(0)
    states = random_playout(engine.new_states(args.batch, device=device),
                            args.depth, gen)
    stones, cid = layout.board_rows(states)
    to_move = states.to_move.to(torch.int32)

    for mode in args.modes:
        def fn(exact=mode == "exact"):
            return ladder_planes_batch(stones, cid, to_move, exact)
        t0 = time.perf_counter()
        fn()
        sync(device)
        first_s = time.perf_counter() - t0
        med = timed(fn, args.repeats, device)
        out[f"ladder_planes_{mode}_ms"] = round(med * 1e3, 3)
        print(f"ladder_planes[{mode}] batch {args.batch}: "
              f"{med * 1e3:.1f} ms/batch ({med / args.batch * 1e6:.1f} "
              f"us/board; first call {first_s:.1f}s)", flush=True)

    if not args.skip_search:
        predictor, _ = load_net(None, args.channels, args.blocks, device)
        sims = args.sims
        for label, kw in [
                ("off", dict(ladder_features=False)),
                ("greedy", dict(ladder_features=True, ladders_exact=False)),
                ("exact", dict(ladder_features=True, ladders_exact=True))]:
            if label != "off" and label not in args.modes:
                continue
            cfg = SearchConfig(num_rollout=sims, adaptive=False,
                               **kw).resolve_auto(device)

            def fn(cfg=cfg):
                g = torch.Generator(device=device).manual_seed(2)
                return S.search(states, predictor, g, cfg, sims,
                                capacity=sims + 8)
            t0 = time.perf_counter()
            fn()
            sync(device)
            first_s = time.perf_counter() - t0
            med = timed(fn, args.repeats, device)
            rate = sims * args.batch / med
            out[f"search_{label}_sims_per_sec"] = round(rate, 1)
            print(f"search[ladders={label}] batch {args.batch} x {sims} "
                  f"sims: {rate:,.0f} sims/s (first call {first_s:.1f}s)",
                  flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
