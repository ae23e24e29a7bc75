#!/usr/bin/env python3
"""Time the PyTorch port's leaf-step kernel K1, its env-step kernel K4 or
its feature kernel K3, in several checkouts, in turns.

    python tools/leaf_step_turns.py [--env-step | --libs-after] TREE [TREE ...]

Each TREE is an unpacked checkout (e.g. ``git archive`` of a commit); list
one twice to time it twice, as in parent, change, change, parent.  Each runs
in its own process with its own ``chip_smoke.py`` and kernel wrapper, as
CUDA-graph replays and eager calls, each checked bit for bit against the
plain version:

- K1 (the default) on ``chip_smoke.random_boards(1024, seed=1)`` at B=256
  (every fourth board, the main path's batch) and B=1024 (all of them, the
  bench's MCTS batch);
- K4 (``--env-step``) on ``chip_smoke.env_boards`` with uniform weights and
  Philox words, the bench's mode, at B=256 and B=4096 (the bench's env
  batch);
- K3 (``--libs-after``) on ``chip_smoke.random_boards(1024, seed=1)`` at
  B=256 (every fourth board, as the smoke's timing phase) and B=1024 (the
  bench's ``--full`` feature stage), all five rows against
  ``features_raw_plain``.

Prints the card's name and power limit, one line per tree and a JSON
summary.  Needs one CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys

LEAF_STEP = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as C
from dream_go_torch.ops import layout
from dream_go_torch.ops import leaf_step as L
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
states, actions = C.random_boards(1024, dev, seed=1)
out = {}
for b in (256, 1024):
    sel = torch.arange(b, device=dev) * (states.batch // b)
    sub = states.index(sel)
    args = [t.contiguous() for t in layout.pack_states(sub)]
    act, komi = actions[sel].contiguous(), sub.komi.contiguous()
    leaf = lambda: L.leaf_step(*args, act, komi)
    got = leaf()
    want = L.leaf_step_plain(*args, act, komi)
    exact = all(torch.equal(g, w) for g, w in zip(got[0], want[0])) \\
        and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    out[b] = dict(graph_us=C.graph_ms(leaf) * 1e3,
                  eager_us=C.events_ms(leaf, 50) * 1e3, exact=exact)
print(json.dumps(out))
"""

ENV_STEP = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as C
from dream_go_torch.ops import env_step as E
from dream_go_torch.ops import layout
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
rows_all = [t.contiguous() for t in layout.pack_states(C.env_boards(dev))]
out = {}
for b in (256, 4096):
    rows = [t[:b].contiguous() for t in rows_all]
    w = torch.ones(b, 361, device=dev)
    step = lambda: E.env_step(*rows, w, 7)
    got, moves = step()
    want, want_moves = E.env_step_plain(*rows, w, 7)
    exact = torch.equal(moves, want_moves) and all(
        torch.equal(g, x) for g, x in zip(got, want))
    out[b] = dict(graph_us=C.graph_ms(step) * 1e3,
                  eager_us=C.events_ms(step, 50) * 1e3, exact=exact)
print(json.dumps(out))
"""

LIBS_AFTER = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as C
from dream_go_torch.ops import layout
from dream_go_torch.ops import libs_after as LA
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
states, _ = C.random_boards(1024, dev, seed=1)
rows = layout.pack_states(states)
out = {}
for b in (256, 1024):
    sel = torch.arange(b, device=dev) * (states.batch // b)
    st, cid = rows[0][sel].contiguous(), rows[1][sel].contiguous()
    feats = lambda: LA.features_raw(st, cid)
    exact = torch.equal(feats(), LA.features_raw_plain(st, cid))
    out[b] = dict(graph_us=C.graph_ms(feats) * 1e3,
                  eager_us=C.events_ms(feats, 50) * 1e3, exact=exact)
print(json.dumps(out))
"""

MODES = {"--env-step": (ENV_STEP, "env_step"),
         "--libs-after": (LIBS_AFTER, "libs_after")}


def main(args: list[str]) -> int:
    mode = args[0] if args[:1] and args[0] in MODES else None
    trees = args[1:] if mode else args
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    snippet, kernel = MODES.get(mode, (LEAF_STEP, "leaf_step"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    rows = []
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", snippet], cwd=tree,
                              capture_output=True, text=True)
        if proc.returncode:
            print(f"{tree} failed:\n{proc.stderr}", file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.append({"tree": tree, **res})
        print(f"{tree}: " + "; ".join(
            f"B={b} {v['graph_us']:.2f} us (eager {v['eager_us']:.2f} us, "
            f"bit-exact {v['exact']})" for b, v in res.items()), flush=True)
    print(json.dumps({f"{kernel}_turns": rows, "device": smi}))
    return 0 if all(v["exact"] for r in rows for k, v in r.items()
                    if k != "tree") else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
