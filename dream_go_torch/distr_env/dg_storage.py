"""Shared-filesystem storage contract between trainer and self-play workers.

Port of `contrib/distr-env/dg_storage.py`, kept as a copy (the port
imports nothing of the JAX side): the trainer publishes numbered weight
files, workers append big-SGF game files, and both sides only ever see
complete files (atomic rename).  The file names, the rename and the
listing order are the JAX file's, so JAX workers and the port's trainer
(or the other way round) can share one ``--root``.  Point ``--root`` at
any shared mount (NFS, gcsfuse, a docker volume).
"""

from __future__ import annotations

import os
import re
import tempfile

_WEIGHTS_RE = re.compile(r"^weights_(\d{6})\.json$")


def _ensure(root: str) -> None:
    os.makedirs(os.path.join(root, "weights"), exist_ok=True)
    os.makedirs(os.path.join(root, "games"), exist_ok=True)


def _atomic_write(path: str, text: str) -> None:
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(text)
        os.rename(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def latest_weights(root: str) -> tuple[int, str | None]:
    """Highest published generation and its path, or ``(-1, None)``."""
    _ensure(root)
    wdir = os.path.join(root, "weights")
    gens = sorted(int(m.group(1)) for name in os.listdir(wdir)
                  if (m := _WEIGHTS_RE.match(name)))
    if not gens:
        return -1, None
    g = gens[-1]
    return g, os.path.join(wdir, f"weights_{g:06d}.json")


def publish_weights(root: str, gen: int, blob: str) -> str:
    _ensure(root)
    path = os.path.join(root, "weights", f"weights_{gen:06d}.json")
    _atomic_write(path, blob)
    return path


def append_games(root: str, worker_id: str, counter: int,
                 lines: list[str]) -> str:
    """Write one batch of big-SGF lines as a new immutable file."""
    _ensure(root)
    path = os.path.join(root, "games", f"{worker_id}_{counter:06d}.sgf")
    _atomic_write(path, "\n".join(lines) + "\n")
    return path


def new_games(root: str, seen: set[str]) -> tuple[list[str], set[str]]:
    """Big-SGF lines from game files not in ``seen``; returns updated set."""
    _ensure(root)
    gdir = os.path.join(root, "games")
    fresh: list[str] = []
    seen = set(seen)
    for name in sorted(os.listdir(gdir)):
        if name.endswith(".sgf") and name not in seen:
            with open(os.path.join(gdir, name)) as fh:
                fresh.extend(l.strip() for l in fh if l.strip())
            seen.add(name)
    return fresh, seen
