"""Background pondering: keep searching while the opponent thinks (port of
`dream_go_tpu/gtp/ponder.py`).

Replaces `src/dg/gtp/ponder_service.rs:36-239`: a daemon thread runs
chunked searches of the current position in a B=1 tree of ``capacity``
nodes (bounded by ``max_visits``; the reference caps at 500k,
`ponder_service.rs:78`); a command pauses it through :meth:`take`, which
hands back the tree when it is still the position asked for (same zobrist
hash and player to move), and :meth:`start` resumes on a new position.

The worker holds the interpreter lock in the search's host-bound select
loop and checks for a stop between chunks, so :meth:`take` waits for at
most one chunk (``chunk`` simulations); ``last_wait`` keeps how long the
last one waited.  Torch's current device is per thread: the worker works
on the state's device explicitly, and the kernels launch on their
tensors' device.  Its generator is its own, seeded 0.  An exception in
the worker is raised again by the next :meth:`take`.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from ..config import SearchConfig
from ..mcts import search as S


def _position_key(state) -> bytes:
    return (state.hash[0].cpu().numpy().tobytes()
            + bytes([int(state.to_move[0])]))


class PonderService:
    def __init__(self, predictor, search_cfg: SearchConfig,
                 chunk: int = 64, max_visits: int = 500_000,
                 capacity: int = 4096):
        self.predictor = predictor
        self.cfg = search_cfg
        self.chunk = chunk
        self.max_visits = max_visits
        self.capacity = capacity
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._trees = None
        self._error: BaseException | None = None
        self._root_hash: bytes | None = None
        self.last_wait = 0.0

    def start(self, state):
        """Begin pondering the given one-board state."""
        self.stop()
        self._root_hash = _position_key(state)
        self._stop.clear()
        dev = state.stones.device

        def worker():
            ctx = torch.cuda.device(dev) if dev.type == "cuda" \
                else contextlib.nullcontext()
            try:
                with ctx, torch.no_grad():
                    gen = torch.Generator(device=dev).manual_seed(0)
                    trees = S.init_trees(state, self.predictor, gen,
                                         self.cfg, self.capacity, None)
                    visits = 1
                    while not self._stop.is_set() \
                            and visits < self.max_visits \
                            and visits + self.chunk < self.capacity:
                        trees = S.run_search(trees, self.predictor,
                                             self.cfg, self.chunk, None)
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
                        visits += self.chunk
                        with self._lock:
                            self._trees = trees
                    with self._lock:
                        self._trees = trees
            except BaseException as exc:  # noqa: BLE001 - raised by take()
                with self._lock:
                    self._error = exc

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None

    def take(self, state):
        """Pause pondering; return the trees if they match ``state``."""
        t0 = time.monotonic()
        self.stop()
        self.last_wait = time.monotonic() - t0
        with self._lock:
            trees, self._trees = self._trees, None
            error, self._error = self._error, None
        if error is not None:
            raise RuntimeError(f"ponder worker failed: {error}") from error
        if trees is None or self._root_hash != _position_key(state):
            return None
        return trees
