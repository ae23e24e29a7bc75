"""Batched random draws that a rank of a mesh shares with one process.

A rank plays rows ``start .. start + count`` of a batch of ``total``
games.  Handed a :class:`RowGenerator`, every batched draw of self-play
(the move's sampling, the roots' Dirichlet noise) is made for the whole
batch of ``total`` rows and this rank's rows are kept, so its games are
those rows of a one-process run of the whole batch.  A plain
``torch.Generator`` draws for the rows it is given.
"""

from __future__ import annotations

import torch


class RowGenerator:
    """``generator``'s draws for a batch of ``total`` rows, of which the
    caller holds those from ``start`` on."""

    def __init__(self, generator: torch.Generator, start: int, total: int):
        self.generator = generator
        self.start = start
        self.total = total


def draw(gen, fn, batch: int) -> torch.Tensor:
    """``fn(generator, n)`` (a draw of ``n`` rows) for a batch of
    ``batch`` rows, taken from the whole batch's draw when ``gen`` is a
    :class:`RowGenerator`."""
    if isinstance(gen, RowGenerator):
        return fn(gen.generator, gen.total)[gen.start:gen.start + batch]
    return fn(gen, batch)


def batch_rows(total: int, seed: int, device, mesh=None):
    """``(start, count, generator)``: this rank's ``local_game_slice`` of a
    batch of ``total`` rows (all of them without ``mesh``) and a
    generator seeded by ``seed`` that draws those rows of the whole
    batch's draws."""
    from ..parallel import distributed as D

    gen = torch.Generator(device=device).manual_seed(seed)
    if mesh is None:
        return 0, total, gen
    start, count = D.local_game_slice(total)
    return start, count, RowGenerator(gen, start, total)
