"""The ``(data, model)`` mesh of ranks and the learner's collectives (port
of `dream_go_tpu/parallel/mesh.py`).

JAX names the axes of a device array and lets XLA insert the collectives;
here each rank is a process and the collectives are explicit:

- ``data``: self-play games and training examples are split over it; the
  train-mode batch norm sums its statistics over the rank's **data group**
  (the ranks that hold the other rows of the batch) and the gradients are
  averaged over it;
- ``model``: the policy head's ``[362, 361 * s]`` weight is split by
  output column over the rank's **model group** (JAX's ``P(None,
  "model")`` on ``linear_1``'s kernel, `mesh.py:50-59`); each rank computes
  its columns of the logits and the group gathers them.

Rank ``r`` sits at ``(r // model, r % model)``, the order of JAX's
``np.asarray(devices).reshape(data, model)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from . import distributed as D

#: the parameters split over ``model``, by the dimension split (torch's
#: ``[out, in]`` layout: JAX's kernel columns are its rows)
MODEL_SPLIT = {"policy_linear.weight": 0}


def mesh_coords(world: int, data: int | None = None,
                model: int = 1) -> list[tuple[int, int]]:
    """``(data index, model index)`` of each rank; raises as JAX's
    ``make_mesh`` does when ``data * model`` is not the world."""
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} devices")
    return [divmod(r, model) for r in range(world)]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the mesh and its two groups."""

    data: int
    model: int
    rank: int
    data_group: object
    model_group: object

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def local_rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` split over ``data``."""
        if n % self.data:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.data} data ranks")
        per = n // self.data
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def column_bounds(self, n: int) -> list[int]:
        """Where each model rank's columns of ``n`` start, and ``n``."""
        return [0] + np.cumsum([len(c) for c in np.array_split(
            np.arange(n), self.model)]).tolist()


def make_mesh(data: int | None = None, model: int = 1) -> Mesh:
    """The mesh over the world's ranks (``data`` defaults to all of them
    over ``model``).  Every rank makes every group, in the same order."""
    world, rank = D.world_size(), D.rank()
    coords = mesh_coords(world, data, model)
    data = world // model
    data_groups = [dist.new_group([r for r in range(world)
                                   if coords[r][1] == m])
                   for m in range(model)]
    model_groups = [dist.new_group([r for r in range(world)
                                    if coords[r][0] == d])
                    for d in range(data)]
    d, m = coords[rank]
    return Mesh(data, model, rank, data_groups[m], model_groups[d])


def param_sharding(mesh: Mesh, names) -> dict:
    """``{name: dim split over model, or None}``: everything replicated
    but the policy head's weight, as JAX's ``param_sharding``."""
    return {k: MODEL_SPLIT.get(k) if mesh.model > 1 else None for k in names}


# ---------------------------------------------------------------------------
# differentiable collectives


class _AllReduce(torch.autograd.Function):
    """Sum over ``group``; the backward sums the gradients too (each
    rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradients of the model
    group's column slices, which each see part of the input's use."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # a copy in float32 at least: gloo may lack bf16
        summed = grad.to(torch.promote_types(grad.dtype, torch.float32))
        dist.all_reduce(summed, group=ctx.group)
        return summed.to(grad.dtype), None


class _GatherColumns(torch.autograd.Function):
    """``[B, hi - lo]`` column slices into the full ``[B, n]`` on every
    rank of the group (a sum of zero-padded slices, which NCCL and gloo
    take on the card alike); the backward keeps this rank's columns, as
    every rank of the group computes the same loss from the result.  The
    sum runs in float32 at least, exact with one term a column."""

    @staticmethod
    def forward(ctx, y, group, lo, hi, n):
        ctx.lo, ctx.hi = lo, hi
        full = y.new_zeros((y.shape[0], n), dtype=torch.promote_types(
            y.dtype, torch.float32))
        full[:, lo:hi] = y
        dist.all_reduce(full, group=group)
        return full.to(y.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad[:, ctx.lo:ctx.hi], None, None, None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduce.apply(x, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def gather_columns(y: torch.Tensor, group, lo: int, hi: int,
                   n: int) -> torch.Tensor:
    return _GatherColumns.apply(y, group, lo, hi, n)


@torch.no_grad()
def gather_rows(x: torch.Tensor, group, lo: int, n: int) -> torch.Tensor:
    """The full ``[n, ...]`` tensor of which this rank holds rows
    ``lo:lo + len(x)`` (not differentiable: checkpoints and dumps)."""
    full = x.new_zeros((n,) + tuple(x.shape[1:]))
    full[lo:lo + x.shape[0]] = x
    dist.all_reduce(full, group=group)
    return full
