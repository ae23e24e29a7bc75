"""The operation and byte counts, against hand counts."""

from __future__ import annotations

import pytest

from bench_port import counts, harness


def test_dream_go_128x9():
    # upsample 2*361*9*32*128, 18 block convs 2*361*9*128*128, policy
    # 2*361*9*128*8 + 2*2888*362, value 2*361*9*128*2 + 2*361*2 + 2*722
    hand = (26_615_808 + 18 * 106_463_232 + 6_653_952 + 2_090_912
            + 1_663_488 + 1_444 + 1_444)
    assert counts.tower_flops(128, 9, 8, 32) == hand
    assert hand / 1e6 == pytest.approx(1953.4, abs=0.5)
    assert counts.dg_config_flops(harness.load_json("configs", "dg128x9")) \
        == hand


def test_k1_bytes_match_the_kernel_bound():
    # chip_smoke.py's leaf_step_bound: per board 4 * (384 + 384 + 768 + 256
    # + 8 + 8 + 1 + 1) in, 4 * (384 + 384 + 768 + 256 + 8 + 8 + 32 * 384)
    # + 361 out, and the zobrist table once
    per_board = 4 * 1810 + 4 * 14096 + 361
    assert counts.leaf_step_bytes(1024) == 1024 * per_board + 6144
    # 19.56 us at 3.35 TB/s for B = 1024, as the kernel table states
    assert counts.leaf_step_bytes(1024) / 3.35e12 * 1e6 == pytest.approx(
        19.56, abs=0.01)

