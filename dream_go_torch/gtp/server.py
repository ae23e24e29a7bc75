"""GTP stdin/stdout loop (`src/dg/gtp/mod.rs` run loop; port of
`dream_go_tpu/gtp/server.py`)."""

from __future__ import annotations

import sys

from .engine import GtpEngine


def run_server(engine: GtpEngine | None = None, infile=None, outfile=None):
    engine = engine or GtpEngine()
    infile = infile or sys.stdin
    outfile = outfile or sys.stdout
    for line in infile:
        response, should_quit = engine.handle(line)
        if response:
            outfile.write(response + "\n")
            outfile.flush()
        if should_quit:
            break
