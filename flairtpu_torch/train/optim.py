"""Optimizer and schedulers (counterpart of ``flairtpu/train/optim.py``;
reference src/flair/tasks_utils.py:95-104).

Plain SGD as ``optax.sgd`` with no momentum, ``p <- p - lr * g`` on the
float32 parameters, with the learning rate a host-side number the plateau
controller changes between epochs. ``ReduceLROnPlateau`` (factor 0.5,
patience 10, cooldown 4, min_lr 1e-7, torch's relative threshold 1e-4) and
``EarlyStopping`` (Lightning's monitor and patience, reference
tasks.py:58-63) are copies.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


class SGD:
    """``optax.inject_hyperparams(optax.sgd)``: no state but the learning rate."""

    def __init__(self, params, learning_rate: float):
        self.params = [p for p in params if p.requires_grad]
        self.lr = float(learning_rate)

    @torch.no_grad()
    def step(self) -> None:
        """p <- p - lr * p.grad for every parameter with a gradient, in one
        multi-tensor pass."""
        ps = [p for p in self.params if p.grad is not None]
        torch._foreach_add_(ps, [p.grad for p in ps], alpha=-self.lr)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"learning_rate": self.lr}

    def load_state_dict(self, state: dict) -> None:
        self.lr = float(state["learning_rate"])


def make_optimizer(params, learning_rate: float) -> SGD:
    return SGD(params, learning_rate)


def set_learning_rate(opt: SGD, lr: float) -> SGD:
    opt.lr = float(lr)
    return opt


@dataclass
class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau parity (mode='min')."""

    lr: float
    mode: str = "min"
    factor: float = 0.5
    patience: int = 10
    cooldown: int = 4
    min_lr: float = 1e-7
    threshold: float = 1e-4

    best: float = field(default=None, init=False)  # type: ignore[assignment]
    num_bad_epochs: int = field(default=0, init=False)
    cooldown_counter: int = field(default=0, init=False)

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1 - self.threshold)
        return metric > self.best * (1 + self.threshold)

    def step(self, metric: float) -> float:
        """Feed the monitored metric (per epoch); returns the current LR."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr


@dataclass
class EarlyStopping:
    """Lightning EarlyStopping parity: stop after `patience` checks w/o improvement."""

    monitor_mode: str = "min"
    patience: int = 30
    min_delta: float = 0.0

    best: float = field(default=None, init=False)  # type: ignore[assignment]
    wait: int = field(default=0, init=False)
    stopped: bool = field(default=False, init=False)

    def step(self, metric: float) -> bool:
        """Returns True when training should stop."""
        improved = (
            self.best is None
            or (self.monitor_mode == "min" and metric < self.best - self.min_delta)
            or (self.monitor_mode == "max" and metric > self.best + self.min_delta)
        )
        if improved:
            self.best = metric
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped = True
        return self.stopped
