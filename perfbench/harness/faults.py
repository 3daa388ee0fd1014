"""Faults planted under the timed path, for the check that each makes
``correct`` false (tests/test_perfbench_faults.py on the CPU, and
``readings.py --fault`` at a cell's own size). Each fault takes a
``setattr(obj, name, value)`` that replaces an attribute of the program
and undoes it afterwards (pytest's ``monkeypatch.setattr``, or
``planted``'s)."""

from __future__ import annotations

import builtins
import contextlib

import torch


def _half(batch: dict) -> dict:
    """The first half of the rows, or of the first spatial axis of a batch
    of one."""
    n = batch["data"].shape[0]
    if n > 1:
        return {k: v[:n // 2] for k, v in batch.items()}
    s = batch["data"].shape[1]
    return {k: v[:, :s // 2] for k, v in batch.items()}


def unchanged(setattr):
    """A step that computes its loss and leaves the state as it was."""
    from uresnet_tpu_torch.engine.trainer import Trainer

    def step(self, ts, batch):
        with torch.no_grad():
            loss, _, _ = self._loss_fn(ts.model, self._prepare(batch))
        return ts, {"loss": loss}
    setattr(Trainer, "train_step_light", step)


def half_batch_train(setattr):
    """The forward, the loss and its gradient over half of the batch."""
    from uresnet_tpu_torch.engine.trainer import Trainer

    orig = Trainer._loss_fn
    setattr(Trainer, "_loss_fn",
            lambda self, model, batch: orig(self, model, _half(batch)))


def altered_answer(setattr):
    """One event's answer altered where it is made: its scores given to
    the next class at every point."""
    from uresnet_tpu_torch.engine import evaluator

    orig = evaluator._ana_step_sparse

    def step(cfg, fn, batch):
        out = dict(orig(cfg, fn, batch))
        p = out["pscores"].clone()
        p[0] = p[0].roll(1, dims=-1)
        out["pscores"] = p
        return out
    setattr(evaluator, "_ana_step_sparse", step)


def half_batch_ana(setattr):
    """The second half of the batch's rows (of a batch of one: of its
    points) never scored."""
    from uresnet_tpu_torch.engine import evaluator

    orig = evaluator._ana_step_sparse

    def step(cfg, fn, batch):
        out = dict(orig(cfg, fn, batch))
        p = out["pscores"].clone()
        if p.shape[0] > 1:
            p[p.shape[0] // 2:] = 0.0
        else:
            p[:, int(batch["npoints"][0]) // 2:] = 0.0
        out["pscores"] = p
        return out
    setattr(evaluator, "_ana_step_sparse", step)


FAULTS = {"train": [unchanged, half_batch_train],
          "ana": [altered_answer, half_batch_ana]}


@contextlib.contextmanager
def planted(fault):
    """``fault`` planted for the duration of the block."""
    saved = []

    def setattr(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        builtins.setattr(obj, name, value)

    fault(setattr)
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            builtins.setattr(obj, name, value)
