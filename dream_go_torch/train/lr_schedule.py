"""Plateau-detecting learning-rate scheduler (a copy of
`dream_go_tpu/train/lr_schedule.py`, which is numpy only).

Parity with `contrib/trainer/dream_tf/hooks/learning_rate.py:36-154` (the
dlib "automatic learning rate scheduling" recipe): keep the last 4096 losses,
fit a least-squares line over f(step) = loss, estimate
P(slope < -5e-6) under the fitted-slope sampling distribution, and divide the
learning rate by 3 when both the full-window and the robust (lowest 90%)
estimates say the loss is no longer decreasing.  Stops below 1e-5.
"""

from __future__ import annotations

import math

import numpy as np


def _norm_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def is_decreasing(x: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    """(P(slope decreasing), slope) — `learning_rate.py:96-110`."""
    n = x.shape[0]
    if n < 5:
        return 1.0, 0.0
    coeffs, *_ = np.linalg.lstsq(x, y, rcond=None)
    m, c = float(coeffs[0]), float(coeffs[1])
    y_hat = m * x[:, 0] + c
    variance = 1.0 / (n - 2.0) * np.sum(np.square(y[:-1] - y_hat[:-1]))
    variance = (12.0 * variance) / (n**3 - n)
    if variance <= 0:
        return (1.0 if m < -5e-6 else 0.0), m
    p = _norm_cdf((-5e-6 - m) / math.sqrt(variance))
    return p, m


class LearningRateScheduler:
    BUF_SIZE = 4096
    THRESHOLD = 2048
    MIN_LEARNING_RATE = 1e-5

    def __init__(self, initial_lr: float, decay: float = 3.0,
                 steps_to_skip: int = 0):
        self.learning_rate = initial_lr
        self.decay = decay
        self.steps_to_skip = steps_to_skip
        self.losses = np.zeros((self.BUF_SIZE, 3), np.float32)
        self.last_decrease = 0
        self.step = 0
        self.should_stop = False
        self.slope = 0.0
        self.p_decreasing = 1.0

    def state_dict(self) -> dict:
        return dict(learning_rate=self.learning_rate, losses=self.losses,
                    last_decrease=self.last_decrease, step=self.step)

    def load_state_dict(self, state: dict):
        self.learning_rate = float(state["learning_rate"])
        self.losses = np.asarray(state["losses"])
        self.last_decrease = int(state["last_decrease"])
        self.step = int(state["step"])

    def update(self, loss: float) -> float:
        """Record one loss; returns the (possibly decreased) learning rate."""
        self.losses[self.step % self.BUF_SIZE] = (self.step, 1.0, loss)
        self.step += 1
        step = self.step

        if step > 0 and step % 10 == 0:
            n = min(step, self.BUF_SIZE)
            x = self.losses[:n, 0:2]
            y = self.losses[:n, 2]
            p, m = is_decreasing(x, y)
            t = np.percentile(y, 90)
            robust = y < t
            rp, _ = is_decreasing(x[robust], y[robust])
            self.slope, self.p_decreasing = m, p

            can_lower = (step > self.steps_to_skip
                         and (step - self.last_decrease) > self.THRESHOLD)
            if can_lower and p < 0.51 and rp < 0.51:
                if self.learning_rate < self.MIN_LEARNING_RATE:
                    self.should_stop = True
                else:
                    self.learning_rate /= self.decay
                    self.last_decrease = step
        return self.learning_rate
