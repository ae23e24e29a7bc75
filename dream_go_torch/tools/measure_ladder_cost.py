"""The in-loop cost of ladder planes 30/31 in the search (port of
`tools/measure_ladder_cost.py`).

Simulations/s of the fused search (K1 on the card; the unfused search
with the plain feature path on the CPU) at 128 x 9, batch 1024, 16
simulations a call, median of 5 calls, in three configurations:

  off     ladder_features=False
  exact   ladder_features=True, the exact reader (K2 on the card)
  greedy  ladder_features=True, ladders_exact=False (the greedy reader)

    python -m dream_go_torch.tools.measure_ladder_cost [--batch 1024] \\
        [--sims 16] [--reps 5] [--device cuda|cpu]

On the CPU the batch, simulations and repeats are cut to 8, 4 and 2, as
the JAX tool cuts them off the TPU.  Prints one JSON line, the JAX tool's
keys (``sims_per_sec_ladders`` is the exact reader's) with the greedy
reader's and the device's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import torch

from ..config import SearchConfig
from ..go import engine
from ..mcts import search as S
from ..utils.device import describe, resolve, sync
from .common import load_net


def measure(scfg, mb, sims, reps, pred, label, device):
    """Simulations/s of ``scfg``: the median of ``reps`` calls of ``sims``
    simulations on one batch of ``mb`` trees (after a first call)."""
    gen = torch.Generator(device=device).manual_seed(0)
    trees = S.init_trees(engine.new_states(mb, device=device), pred, gen,
                         scfg, sims * (reps + 2) + 1, None)
    t0 = time.monotonic()
    trees = S.run_search(trees, pred, scfg, sims, None)
    sync(device)
    print(f"  [{label}] first call: {time.monotonic() - t0:.1f}s",
          file=sys.stderr)
    times = []
    for _ in range(reps):
        t0 = time.monotonic()
        trees = S.run_search(trees, pred, scfg, sims, None)
        sync(device)
        times.append(time.monotonic() - t0)
    sps = mb * sims / statistics.median(times)
    print(f"  [{label}] sims/s: {sps:,.0f} (median of {reps}x{sims} sims, "
          f"batch {mb})", file=sys.stderr)
    return sps


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dream_go_torch.tools.measure_ladder_cost")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--sims", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--blocks", type=int, default=9)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve(args.device)
    on_gpu = device.type == "cuda"
    mb = args.batch if on_gpu else min(args.batch, 8)
    sims = args.sims if on_gpu else min(args.sims, 4)
    reps = args.reps if on_gpu else min(args.reps, 2)
    pred, _ = load_net(None, args.channels, args.blocks, device)

    base = SearchConfig(fused=on_gpu, feature_kernel=not on_gpu,
                        adaptive=False).resolve_auto(device)
    results = {"off": measure(base, mb, sims, reps, pred, "off", device)}
    for label, exact in (("exact", True), ("greedy", False)):
        cfg = dataclasses.replace(base, ladder_features=True,
                                  ladders_exact=exact)
        results[label] = measure(cfg, mb, sims, reps, pred, label, device)
    print(json.dumps({
        "batch": mb, "sims_per_call": sims,
        "sims_per_sec_off": round(results["off"], 1),
        "sims_per_sec_ladders": round(results["exact"], 1),
        "overhead_pct": round(100 * (results["off"] / results["exact"]
                                     - 1.0), 1),
        "sims_per_sec_greedy": round(results["greedy"], 1),
        "overhead_greedy_pct": round(100 * (results["off"]
                                            / results["greedy"] - 1.0), 1),
        "device": describe(device),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
