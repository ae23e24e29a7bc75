"""Process groups: one process a rank, brought up from torchrun's
environment (port of `dream_go_tpu/parallel/distributed.py`).

JAX drives every local device from one process and spans hosts with
``jax.distributed``; here each rank is a process of its own, on one card
(or on the CPU), joined by ``torch.distributed``:

1. every rank calls :func:`initialize`, which reads ``RANK``,
   ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``
   and ``MASTER_PORT`` as torchrun sets them; without them the process is
   a world of one on a TCP store of its own on ``127.0.0.1``, so that the
   collectives' code still runs;
2. the backend follows one rule, printed at start: ``nccl`` when every
   rank of the host has a card of its own, ``gloo`` on the CPU and when
   ranks share a card (NCCL refuses two ranks on one device).  It is
   chosen before the group starts, never after a failure;
3. the self-play actors play their :func:`local_game_slice` of the game
   batch, and the learner (`mesh.py`) reduces over its groups.

A collective that fails raises; nothing falls back to one process.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import socket
import sys
import time

import torch
import torch.distributed as dist

#: how long a collective waits for the other ranks before it raises
TIMEOUT = datetime.timedelta(seconds=600)


def free_port() -> int:
    """A TCP port on ``127.0.0.1`` that was free when asked."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(device: torch.device, local_world: int) -> tuple[str, str]:
    """``(backend, reason)`` by the rule above."""
    if device.type != "cuda":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    if local_world > cards:
        return "gloo", (f"{local_world} ranks share {cards} card"
                        f"{'s' if cards != 1 else ''}")
    return "nccl", f"{local_world} ranks, a card each"


def initialize(device="cuda") -> torch.device:
    """Join (or make) the process group; returns this rank's device:
    ``cuda:(LOCAL_RANK % cards)`` for ``cuda``, the CPU for ``cpu``.
    Idempotent.  Raises where ``cuda`` is asked for and there is no
    card."""
    device = torch.device(device)
    env = os.environ
    rank = int(env.get("RANK", 0))
    world = int(env.get("WORLD_SIZE", 1))
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda asked for, and no card")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend, why = backend_for(device, local_world)
    if "MASTER_ADDR" in env:
        init = "env://"
    elif world == 1:
        init = f"tcp://127.0.0.1:{free_port()}"
    else:
        raise RuntimeError(f"WORLD_SIZE {world} without MASTER_ADDR")
    print(f"distributed: rank {rank} of {world} on {device}, backend "
          f"{backend} ({why})", file=sys.stderr, flush=True)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world, timeout=TIMEOUT, **kw)
    return device


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_writer() -> bool:
    """Rank 0 writes the files that all ranks share."""
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def local_game_slice(total_games: int, index: int | None = None,
                     count: int | None = None) -> tuple[int, int]:
    """``(start, count)`` of rank ``index``'s share of ``total_games``
    among ``count`` ranks (this rank of the world by default): JAX's
    formula, the first ``total % count`` ranks one game more."""
    n = world_size() if count is None else count
    i = rank() if index is None else index
    per, extra = divmod(total_games, n)
    return i * per + min(i, extra), per + (1 if i < extra else 0)


def all_gather_lines(lines: list[str]) -> list[str]:
    """Every rank's lines, in rank order, on every rank."""
    if not dist.is_initialized():
        return list(lines)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, list(lines))
    return [line for part in parts for line in part]


def _spawned(target, rank: int, world: int, port: int, args) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    target(rank, *args)


def spawn(target, world: int, args=(), timeout: float = 120.0) -> None:
    """Run ``target(rank, *args)`` in ``world`` spawned processes, with
    torchrun's variables set for a group on a free port of
    ``127.0.0.1``.  Raises when a rank exits non-zero or the ranks outlast
    ``timeout`` seconds; every rank still alive is killed then."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_spawned, args=(target, r, world, port, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"a rank exited {failed[0]}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"the ranks outlasted {timeout:.0f} s")
            time.sleep(0.05)
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
