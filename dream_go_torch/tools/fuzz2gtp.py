"""GTP fuzzer (port of `tools/fuzz2gtp.py`, the reference's
`tools/fuzz2gtp.py`): drives a GTP engine with a seeded stream of random
chatter commands and alternating genmoves, and checks that every response
is well formed.

    python -m dream_go_torch.tools.fuzz2gtp [--moves N] [--seed S] \\
        [--device cuda|cpu] [--num-channels C --num-blocks B] \\
        [-- ENGINE COMMAND...]

With no engine command it drives the port's own engine in this process
(`gtp/engine.py::GtpEngine`, 8 rollouts a genmove, the search's defaults
for the device): a uniform random predictor, or with ``--num-channels``
and ``--num-blocks`` a seeded random net of that width.  After ``--`` it
drives that command as a subprocess over stdin/stdout.  The malformed
answers go to stderr with a count; one JSON line on stdout; exit code 1
if any answer was malformed.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys

#: commands mixed between the genmoves (the JAX tool's list)
CHATTER = ["name", "version", "protocol_version", "list_commands",
           "showboard", "komi 7.5", "known_command genmove",
           "gomill-cpu_time", "boardsize 19"]


class InProcess:
    """The port's engine in this process."""

    def __init__(self, device, channels: int = 0, blocks: int = 0):
        from ..config import SearchConfig
        from ..gtp.engine import GtpEngine
        from ..mcts.predictor import random_predictor
        from .common import load_net

        pred = load_net(None, channels, blocks, device)[0] \
            if channels and blocks else random_predictor()
        self.engine = GtpEngine(pred, SearchConfig(), num_rollout=8,
                                device=device)

    def ask(self, line):
        resp, _ = self.engine.handle(line)
        return resp.strip()


class Subproc:
    """A GTP engine command, over its stdin and stdout."""

    def __init__(self, cmd):
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, text=True)

    def ask(self, line):
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()
        out = []
        while True:
            got = self.proc.stdout.readline()
            if got == "" or (got.strip() == "" and out):
                break
            out.append(got.rstrip("\n"))
        return "\n".join(out)

    def close(self):
        self.proc.stdin.close()
        self.proc.wait(timeout=30)


def fuzz(engine, moves: int, seed: int, log=None) -> tuple[int, int]:
    """Drive ``engine`` (``ask(line) -> response``) with the JAX tool's
    command stream for ``seed``: ``(commands sent, malformed answers)``."""
    log = log or (lambda msg: print(msg, file=sys.stderr))
    rng = random.Random(seed)
    failures = 0
    engine.ask("clear_board")
    sent = 1
    color = "black"
    for _ in range(moves):
        if rng.random() < 0.3:
            resp = engine.ask(rng.choice(CHATTER))
            sent += 1
            if not (resp.startswith("=") or resp.startswith("?")):
                log(f"MALFORMED: {resp!r}")
                failures += 1
        resp = engine.ask(f"genmove {color}")
        sent += 1
        if not resp.startswith("="):
            log(f"genmove failed: {resp!r}")
            failures += 1
        color = "white" if color == "black" else "black"
    return sent, failures


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dream_go_torch.tools.fuzz2gtp")
    ap.add_argument("--moves", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-channels", type=int, default=0)
    ap.add_argument("--num-blocks", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = None
    if "--" in argv:
        cmd = argv[argv.index("--") + 1:]
        argv = argv[:argv.index("--")]
    args = build_parser().parse_args(argv)
    from ..utils.device import resolve

    device = resolve(args.device)
    engine = Subproc(cmd) if cmd else InProcess(device, args.num_channels,
                                                args.num_blocks)
    sent, failures = fuzz(engine, args.moves, args.seed)
    if cmd:
        engine.close()
    print(f"fuzzed {args.moves} genmoves, {failures} failures",
          file=sys.stderr)
    print(json.dumps({"genmoves": args.moves, "commands": sent,
                      "failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
