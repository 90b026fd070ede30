"""Learning-rate schedules (counterpart of ``mint_tpu/train/schedules.py``).

Each schedule maps an integer step to a Python float: the f32 value the JAX
schedule returns, computed here in numpy float32 in the same order of
operations (``_power`` follows XLA's rewrite of small powers), so the two
agree to the last bit, or to a few ulps on the cosine path, where numpy's
``cos`` and XLA's round apart.  Schedules run on the host: the
trainer sets the update's rate from one before every optimizer update.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

Schedule = Callable[[int], float]

_F = np.float32


def _power(x: np.float32, p: float) -> np.float32:
    """x ** p in f32 as XLA computes ``jnp.power(x, p)``: its simplifier
    turns p = 1 into x and p = 2 into x * x (numpy's pow rounds the square
    differently)."""
    if p == 1:
        return x
    if p == 2:
        return x * x
    return np.power(x, _F(p))


def manual_stepping(boundaries: Sequence[int], rates: Sequence[float],
                    warmup: bool = False) -> Schedule:
    """Piecewise-constant schedule (reference ManualStepping).

    Args:
      boundaries: strictly-increasing positive step boundaries.
      rates: len(boundaries) + 1 learning rates; rates[i] applies on
        [boundaries[i-1], boundaries[i]).
      warmup: if true, linearly interpolate from rates[0] to rates[1] over
        [0, boundaries[0]) with per-step granularity.
    """
    if any(b < 0 for b in boundaries):
        raise ValueError("boundaries must be a list of positive integers")
    if any(bn <= b for bn, b in zip(boundaries[1:], boundaries[:-1])):
        raise ValueError("Entries in boundaries must be strictly increasing.")
    if len(rates) != len(boundaries) + 1:
        raise ValueError("Number of provided learning rates must exceed "
                         "number of boundary points by exactly 1.")
    if boundaries and boundaries[0] == 0:
        raise ValueError("First step cannot be zero.")

    boundaries = [int(b) for b in boundaries]
    rates = [float(r) for r in rates]

    def index(step: int, bounds: Sequence[int]) -> int:
        return sum(step >= b for b in bounds) - 1

    if warmup and boundaries:
        slope = (rates[1] - rates[0]) / boundaries[0]

        def schedule(step: int) -> float:
            if step < boundaries[0]:
                return float(_F(rates[0]) + _F(slope) * np.floor(_F(step)))
            i = min(max(index(step, boundaries), 0), len(rates) - 2)
            return float(_F(rates[1:][i]))

        return schedule

    bounds = [0] + boundaries

    def schedule(step: int) -> float:
        return float(_F(rates[index(step, bounds)]))

    return schedule


def warmup(initial_learning_rate: float, decay_schedule_fn: Schedule,
           warmup_steps: int, power: float = 1.0) -> Schedule:
    """Polynomial warmup wrapper (reference WarmUp)."""

    def schedule(step: int) -> float:
        step_f = _F(step)
        if step_f < warmup_steps:
            pct = step_f / _F(warmup_steps)
            return float(_F(initial_learning_rate) * _power(pct, power))
        return float(_F(decay_schedule_fn(step - warmup_steps)))

    return schedule


def cosine_decay_with_warmup(initial_learning_rate: float, steps: int,
                             warmup: int = 0, alpha: float = 0.0) -> Schedule:
    """Linear warmup then cosine decay (the golden values of reference
    learning_schedules_test.py:28-30)."""

    def schedule(step: int) -> float:
        step_f = _F(step)
        if step_f < warmup:
            return float(step_f * _F(initial_learning_rate)
                         / _F(max(warmup - 1.0, 1.0)))
        t = step_f - _F(warmup) + _F(1.0)
        frac = np.clip(t / _F(max(steps - warmup, 1)), _F(0.0), _F(1.0))
        cosine = _F(0.5) * (_F(1.0) + np.cos(_F(np.pi) * frac))
        decayed = _F(1.0 - alpha) * cosine + _F(alpha)
        return float(_F(initial_learning_rate) * decayed)

    return schedule


def polynomial_decay(initial_learning_rate: float, decay_steps: int,
                     end_learning_rate: float = 0.0,
                     power: float = 1.0) -> Schedule:
    """Keras PolynomialDecay equivalent (reference trainer.py:66-71)."""

    def schedule(step: int) -> float:
        step_f = min(_F(step), _F(decay_steps))
        frac = _F(1.0) - step_f / _F(decay_steps)
        return float(_F(initial_learning_rate - end_learning_rate)
                     * _power(frac, power) + _F(end_learning_rate))

    return schedule


def constant(learning_rate: float) -> Schedule:
    def schedule(step: int) -> float:
        del step
        return float(_F(learning_rate))

    return schedule


def from_config(lr_config, *, initial_learning_rate: float | None = None,
                warmup_steps: int = 0) -> Schedule:
    """Build a schedule from a LearningRateConfig oneof.

    Mirrors reference trainer._create_learning_rate (trainer.py:49-96),
    including its quirk that the exponential-decay and cosine paths take the
    base LR from the *flag*, not the proto (`initial_learning_rate` here).
    """
    which = lr_config.which()
    if which == "manual_step_learning_rate":
        cfg = lr_config.manual_step_learning_rate
        if not cfg.schedule:
            raise ValueError("Empty learning rate schedule.")
        boundaries = [s.step for s in cfg.schedule]
        rates = [cfg.initial_learning_rate] + [s.learning_rate
                                               for s in cfg.schedule]
        return manual_stepping(boundaries, rates, cfg.warmup)
    if which == "exponential_decay_learning_rate":
        cfg = lr_config.exponential_decay_learning_rate
        base = (initial_learning_rate if initial_learning_rate is not None
                else cfg.initial_learning_rate)
        sched = polynomial_decay(base, cfg.decay_steps,
                                 cfg.min_learning_rate, cfg.decay_factor)
        if warmup_steps:
            sched = warmup(base, sched, warmup_steps)
        return sched
    if which == "cosine_decay_learning_rate":
        cfg = lr_config.cosine_decay_learning_rate
        base = (initial_learning_rate if initial_learning_rate is not None
                else 0.1)
        return cosine_decay_with_warmup(base, cfg.total_steps, warmup_steps)
    if which == "constant_learning_rate":
        return constant(lr_config.constant_learning_rate.learning_rate)
    raise ValueError(f"Learning_rate {which} not supported.")
