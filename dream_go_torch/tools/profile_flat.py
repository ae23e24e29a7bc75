"""In-loop ablation of one simulation of the search (port of
`tools/profile_flat.py` and `tools/profile_sim_phases.py`, one tool).

Each variant runs ``--sims`` simulations between two synchronisations,
after a warm-up call, on a copy of the same trees (``--batch`` games of
``--capacity`` nodes, 12 random opening moves, 24 simulations deep), and
reports the median ms a simulation over ``--repeat`` calls:

  full           select + gather + K1 + net + insert/backup (the fused
                 product path, ``run_search``)
  full_fake_net  the same with a uniform predictor in place of the net
  no_insert      select + gather + K1 + net
  no_select      fixed node/action + gather + K1 + net + insert/backup
  kernel_net     fixed node/action + gather + K1 + net
  sel_only       ``_select_flat`` alone
  ins_only       ``_insert_backup_flat`` alone (fixed node/action, a fixed
                 value and uniform policy)
  gather_only    the parent-row gather alone
  unfused        the unfused product path (engine step, the feature
                 kernel, K3b, on the card)

The JAX tools' keys map as ``fused_full`` -> ``full``, ``no_insert_ctx``
-> ``no_insert`` and ``xla_full`` -> ``unfused``.  JAX ran each variant
inside one ``fori_loop`` to amortise its device round trip; here the
simulations are plain Python calls, as in ``run_search``.

    python -m dream_go_torch.tools.profile_flat [--batch 1024] \\
        [--channels 128 --blocks 9] [--sims 8] [--repeat 5] \\
        [--device cuda|cpu]

Prints one JSON line (ms a simulation per variant, the batch, the net and
the device).
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
from ..mcts import predictor as P
from ..mcts import search as S
from ..ops.leaf_step import leaf_step
from ..utils.device import describe, resolve, sync
from .common import load_net, opening

VARIANTS = ("full", "full_fake_net", "no_insert", "no_select", "kernel_net",
            "sel_only", "ins_only", "gather_only", "unfused")


def clone_tree(t: S.Tree) -> S.Tree:
    out = {}
    for f in dataclasses.fields(t):
        v = getattr(t, f.name)
        out[f.name] = S._map(v, torch.clone) if f.name == "states" \
            else v.clone()
    return S.Tree(**out)


def build_variants(cfg, pred, batch, cap):
    """Each variant as ``fn(trees, sims) -> a tensor to synchronise on``;
    ``trees`` is a copy the variant may change."""
    dev_of = lambda t: t.size.device  # noqa: E731
    fake = P.random_predictor()
    d = min(cap, S.MAX_BACKUP_DEPTH)

    def base_of(t):
        return torch.arange(batch, device=dev_of(t)) * cap

    def gather(t, node):
        base = base_of(t)
        return S._map(t.states, lambda x: S._flat(x)[base + node])

    def kernel_part(t, node, action, predictor=pred):
        parent = gather(t, node)
        leaf_packed, feats_k, cand = leaf_step(*S._widen_rows(parent),
                                               action, parent.komi)
        leaf = S._narrow_rows(leaf_packed, parent.komi)
        planes = feats_k[:, :, :361].reshape(batch, 32, 19, 19)
        candidate = torch.cat([cand, torch.ones_like(cand[:, :1])], 1)
        value, policy = predictor.planes(planes)
        return leaf, candidate, value, policy

    def fixed(t, i):
        dev = dev_of(t)
        node = torch.zeros(batch, dtype=torch.int32, device=dev)
        action = torch.full((batch,), (17 * i) % 361, dtype=torch.int32,
                            device=dev)
        path_n = torch.full((batch, d), -1, dtype=torch.int32, device=dev)
        path_n[:, 0] = 0
        path_k = torch.full((batch, d), -1, dtype=torch.int32, device=dev)
        k_exit = torch.full((batch,), -1, dtype=torch.int32, device=dev)
        return node, action, k_exit, path_n, path_k, action

    def insert(t, sel, leaf, candidate, value, policy):
        node, action, k_exit, path_n, path_k, root_a = sel
        S._insert_backup_flat(t, node, action, k_exit, path_n, path_k,
                              root_a, leaf, value, policy, None, None,
                              candidate, batch, cap)

    def full(t, sims):
        return S.run_search(t, pred, cfg, sims, None).node_n

    def full_fake_net(t, sims):
        return S.run_search(t, fake, cfg, sims, None).node_n

    def no_insert(t, sims):
        acc = 0.0
        for _ in range(sims):
            node, action, *_ = S._select_flat(t, cfg, batch, cap)
            _, _, value, _ = kernel_part(t, node, action)
            acc = acc + value.sum()
        return acc

    def no_select(t, sims):
        for i in range(sims):
            sel = fixed(t, i)
            insert(t, sel, *kernel_part(t, sel[0], sel[1]))
        return t.node_n

    def kernel_net(t, sims):
        acc = 0.0
        for i in range(sims):
            node, action, *_ = fixed(t, i)
            _, _, value, _ = kernel_part(t, node, action)
            acc = acc + value.sum()
        return acc

    def sel_only(t, sims):
        acc = 0
        for _ in range(sims):
            node, action, _, path_n, *_ = S._select_flat(t, cfg, batch, cap)
            acc = acc + node.sum() + action.sum() + path_n[:, 1].sum()
        return acc

    def ins_only(t, sims):
        dev = dev_of(t)
        leaf = S._map(t.states, lambda x: S._flat(x)[base_of(t) + 1])
        value = torch.full((batch,), 0.4, device=dev)
        policy = torch.full((batch, S.A), 1.0 / S.A, device=dev)
        cand = torch.ones(batch, S.A, dtype=torch.bool, device=dev)
        for i in range(sims):
            insert(t, fixed(t, i), leaf, cand, value, policy)
        return t.node_n

    def gather_only(t, sims):
        acc = 0
        for i in range(sims):
            node = torch.full((batch,), i % cap, dtype=torch.int32,
                              device=dev_of(t))
            acc = acc + gather(t, node).meta[:, 0].sum()
        return acc

    return {"full": full, "full_fake_net": full_fake_net,
            "no_insert": no_insert, "no_select": no_select,
            "kernel_net": kernel_net, "sel_only": sel_only,
            "ins_only": ins_only, "gather_only": gather_only}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dream_go_torch.tools.profile_flat")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--capacity", type=int, default=257)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--blocks", type=int, default=9)
    ap.add_argument("--sims", type=int, default=8)
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve(args.device)
    pred, _ = load_net(None, args.channels, args.blocks, device)
    b, cap, sims = args.batch, args.capacity, args.sims
    cfg = SearchConfig(fused=True, adaptive=False)
    gen = torch.Generator(device=device).manual_seed(1)
    states = opening(b, 12, gen, device)
    out = {}

    def timeit(name, fn, trees):
        fn(clone_tree(trees), sims)  # the warm-up
        sync(device)
        ts = []
        for _ in range(args.repeat):
            t = clone_tree(trees)
            sync(device)
            t0 = time.perf_counter()
            fn(t, sims)
            sync(device)
            ts.append(time.perf_counter() - t0)
        out[name] = round(1e3 * statistics.median(ts) / sims, 3)
        print(f"{name}: {out[name]} ms/sim", file=sys.stderr, flush=True)

    def grown(c):
        g = torch.Generator(device=device).manual_seed(2)
        t = S.init_trees(states, pred, g, c, cap, None)
        return S.run_search(t, pred, c, 24, None)

    trees = grown(cfg)
    for name, fn in build_variants(cfg, pred, b, cap).items():
        timeit(name, fn, trees)
    del trees
    cfg_u = SearchConfig(fused=False, feature_kernel=True, adaptive=False)
    timeit("unfused", lambda t, n: S.run_search(t, pred, cfg_u, n,
                                                None).node_n, grown(cfg_u))
    out["batch"] = b
    out["net"] = f"{args.blocks}x{args.channels}"
    out["device"] = describe(device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
