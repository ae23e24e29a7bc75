"""Operation and byte counts, from the configurations' shapes alone.

A multiply-add counts two operations.  Only convolutions and dense layers
are counted: batch norm, activations, softmax and the optimizer are left
out, so a share of the peak built on these counts is a lower bound of the
true rate, never above it.

- dream-go tower, C channels, K blocks, S policy samples, F input planes,
  per position (19 x 19 = 361 points): the 3x3 upsample F -> C, 2K 3x3
  convs C -> C, the 3x3 policy conv C -> S and the dense 361 S -> 362,
  the 3x3 value conv C -> 2, the 1x1 ownership conv 2 -> 1 and the dense
  722 -> 1.  128 x 9 x 8 with 32 planes: 1,953.4 MFLOP.  A training step
  takes three times the forward's (the backward computes the gradients of
  the inputs and of the weights, each as many as the forward).
- K1, the leaf kernel (`csrc/leaf_step.cu`), per board: reads the six
  int32 state rows (stones 384, chain ids 384, chain hashes 2 x 384, the
  super-ko ring 2 x 128, meta 8, hash 8), the action and komi; writes the
  six rows, the 32 float32 planes of 384 points and 361 candidate bytes;
  once per launch the 4 x 384 int32 zobrist table.
"""

from __future__ import annotations

POINTS = 361


def conv_flops(cin: int, cout: int, k: int) -> int:
    return 2 * POINTS * k * k * cin * cout


def dense_flops(cin: int, cout: int) -> int:
    return 2 * cin * cout


def tower_flops(channels: int, blocks: int, samples: int,
                features: int) -> int:
    """Forward operations of the dream-go tower for one position."""
    c = channels
    return (conv_flops(features, c, 3) + 2 * blocks * conv_flops(c, c, 3)
            + conv_flops(c, samples, 3) + dense_flops(POINTS * samples, 362)
            + conv_flops(c, 2, 3) + conv_flops(2, 1, 1)
            + dense_flops(2 * POINTS, 1))


def leaf_step_bytes(boards: int) -> int:
    """Bytes K1 must move for one launch over ``boards`` boards."""
    rows = 4 * (384 + 384 + 2 * 384 + 2 * 128 + 8 + 8)
    per_in = rows + 4 + 4                      # + action, komi
    per_out = rows + 4 * 32 * 384 + POINTS     # + planes, candidates
    return boards * (per_in + per_out) + 4 * 4 * 384


def dg_config_flops(cfg: dict) -> int:
    """:func:`tower_flops` of a dream-go configuration file."""
    return tower_flops(cfg["num_channels"], cfg["num_blocks"],
                       cfg["num_samples"], cfg["num_features"])
