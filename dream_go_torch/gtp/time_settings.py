"""GTP time-control bookkeeping per color (a copy of
`dream_go_tpu/gtp/time_settings.py`, which imports nothing of JAX).

Replaces `src/dg/gtp/time_settings.rs`: None / Absolute / Canadian / ByoYomi
variants tracking remaining main time and period state, updated by
``time_left`` and after each generated move.
"""

from __future__ import annotations

import dataclasses

# expected game length, A. E. Brouwer's statistic (`byo_yomi.rs:70-76`)
GAME_LENGTH_ESTIMATE = 257


def _regret_cost(move_nr: float, estimate: float) -> float:
    """Blunder regret of a move: decays linearly to zero at the expected end
    of the game (`byo_yomi.rs:201-208`)."""
    return 2.5 * (estimate - move_nr) / estimate


def _regret_cost_cum(move_nr: float, estimate: float) -> float:
    """Integral of `_regret_cost` from 0 to ``move_nr``
    (`byo_yomi.rs:216-223`)."""
    return 2.5 * (move_nr * estimate - 0.5 * move_nr * move_nr) / estimate


@dataclasses.dataclass
class TimeSettings:
    kind: str = "none"           # none | absolute | canadian | byo_yomi
    main_time: float = 0.0
    period_time: float = 0.0
    period_count: int = 0

    # per-color remaining state
    remaining: dict = dataclasses.field(
        default_factory=lambda: {1: 0.0, 2: 0.0})
    periods_left: dict = dataclasses.field(
        default_factory=lambda: {1: 0, 2: 0})

    def reset(self):
        for c in (1, 2):
            self.remaining[c] = self.main_time
            self.periods_left[c] = self.period_count

    def set_none(self):
        self.kind = "none"
        self.main_time = self.period_time = 0.0
        self.period_count = 0
        self.reset()

    def set_absolute(self, main_time: float):
        self.kind = "absolute"
        self.main_time = main_time
        self.period_time = 0.0
        self.period_count = 0
        self.reset()

    def set_canadian(self, main_time: float, period_time: float,
                     stones: int):
        self.kind = "canadian"
        self.main_time = main_time
        self.period_time = period_time
        self.period_count = stones
        self.reset()

    def set_byo_yomi(self, main_time: float, period_time: float,
                     periods: int):
        self.kind = "byo_yomi"
        self.main_time = main_time
        self.period_time = period_time
        self.period_count = periods
        self.reset()

    def time_left(self, color: int, time: float, stones: int):
        self.remaining[color] = time
        self.periods_left[color] = stones

    def budget(self, color: int, move_number: int = 0) -> float:
        """Seconds to spend on the next move, regret-weighted.

        Follows `byo_yomi.rs:70-100,194-223`: the main time is divided in
        proportion to the blunder regret of the current move — regret decays
        linearly over an expected 257-move game (A. E. Brouwer's average) —
        spending 90% of what the curve allows; past move 247 fall back to
        10% of the remaining main time per move.  Byo-yomi adds one period;
        canadian adds the per-stone share of the period.
        """
        if self.kind == "none":
            return float("inf")
        main = max(self.remaining[color], 0.0)
        if move_number < GAME_LENGTH_ESTIMATE - 10:
            remaining_regret = (
                _regret_cost_cum(GAME_LENGTH_ESTIMATE, GAME_LENGTH_ESTIMATE)
                - _regret_cost_cum(move_number, GAME_LENGTH_ESTIMATE))
            fraction = _regret_cost(move_number, GAME_LENGTH_ESTIMATE) \
                / max(remaining_regret, 1e-9)
            main_part = 0.9 * fraction * main
        else:
            main_part = 0.1 * main
        if self.kind == "absolute":
            return main_part
        per_period = self.period_time / max(
            1, self.period_count if self.kind == "canadian" else 1)
        return main_part + per_period
