"""Self-play SGF records (port of `dream_go_tpu/selfplay/records.py`).

Byte-format parity with the reference:
- per-move records (`self_play.rs:100-214`): ``;B[dd]TV[n]P[b85]V[+0.1234]``,
  TV/P only when the move came from a search; V is the black-perspective
  win rate ``2v-1`` / ``-2v+1`` (`self_play.rs:174-185`);
- whole games (`game_result.rs:22-93`):
  ``(;GM[1]FF[4]DT[..]SZ[19]RU[Chinese]KM[..]RE[..]{moves}{TB/TW})``, the
  winner decided by counting owned points (white + komi).
"""

from __future__ import annotations

import dataclasses
import datetime

import numpy as np

from ..utils import b85, coords


@dataclasses.dataclass
class Played:
    to_move: int                    # 1 black / 2 white
    point: int                      # 0..360, 361 = pass
    value: float | None = None      # to-move win probability in [0, 1]
    num_rollout: int = 1
    softmax: np.ndarray | None = None  # [362] visit distribution

    def normalized_win_rate(self) -> float | None:
        """Win rate from black's perspective (`self_play.rs:174-185`)."""
        if self.value is None:
            return None
        return 2.0 * self.value - 1.0 if self.to_move == 1 \
            else -2.0 * self.value + 1.0

    def to_sgf(self) -> str:
        color = "B" if self.to_move == 1 else "W"
        out = f";{color}[{coords.to_sgf(self.point)}]"
        if self.num_rollout > 1 and self.softmax is not None:
            out += f"TV[{self.num_rollout}]P[{b85.encode(self.softmax)}]"
        wr = self.normalized_win_rate()
        if wr is not None:
            out += f"V[{wr:.4f}]"
        return out


def _timestamp() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S%z")


def game_result_sgf(moves_sgf: str, komi: float,
                    territory: np.ndarray | None = None) -> str:
    """Full game record; ``territory`` is the int8[361] EMPTY/BLACK/WHITE
    ownership map of :func:`dream_go_torch.go.benson.stone_status`, which
    scores the game (owned points + komi) and gives ``TB[]/TW[]``
    (`game_result.rs:46-93`)."""
    header = f"(;GM[1]FF[4]DT[{_timestamp()}]SZ[19]RU[Chinese]KM[{komi:.1f}]"
    tb = tw = ""
    black = white = 0.0
    if territory is not None:
        territory = np.asarray(territory)
        black = float((territory == 1).sum())
        white = float((territory == 2).sum()) + komi
        black_pts = "".join(f"[{coords.to_sgf(p)}]"
                            for p in np.flatnonzero(territory == 1))
        white_pts = "".join(f"[{coords.to_sgf(p)}]"
                            for p in np.flatnonzero(territory == 2))
        tb = f"TB{black_pts}" if black_pts else ""
        tw = f"TW{white_pts}" if white_pts else ""
    if black > white:
        result = f"B+{black - white:.1f}"
    elif white > black:
        result = f"W+{white - black:.1f}"
    else:
        result = "0"
    return f"{header}RE[{result}]{moves_sgf}{tb}{tw})"
