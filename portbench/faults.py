"""Faults planted under the timed path, for the tests and for the
readings a training cell's limits are set against (``control.py
--fault``).  A serving fault wraps the engine's forward; a training fault
wraps the trainer's step (``fault(step, trainer)``)."""

from __future__ import annotations

import torch


def half_batch(apply):
    """Only the first half of each batch is computed; the rest of the
    rows repeat it."""
    def broken(x):
        half = x.shape[0] // 2
        y = apply(x[:half])
        return torch.cat([y, y[:x.shape[0] - half]])
    return broken


def answer_altered(apply):
    """Each answer leaves the forward rolled by one row: every request
    gets another's answer."""
    def broken(x):
        return torch.roll(apply(x), 1, dims=0)
    return broken


def zeros(apply):
    """Every answer leaves the forward all zero: a kernel that writes
    nothing."""
    def broken(x):
        return torch.zeros_like(apply(x))
    return broken


def half_batch_step(step, trainer):
    """The step sees only the first half of its batch (the mean over the
    rest)."""
    return lambda batch, g: step(batch[:batch.shape[0] // 2], g)


def state_unchanged_step(step, trainer):
    """The step returns its state unchanged (a forward, no update)."""
    return lambda batch, g: trainer._eval(batch, g)


SERVING = {"half_batch": half_batch, "answer_altered": answer_altered,
           "zeros": zeros}
TRAINING = {"half_batch": half_batch_step,
            "state_unchanged": state_unchanged_step}
