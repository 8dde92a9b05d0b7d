"""Fault-tolerant training loop, the reference's (``repro.train.trainer``)
on one card.

Restart semantics: the state (params, moments, step, error feedback) is
checkpointed atomically; the data pipeline is stateless in the step index;
so resume = restore the latest checkpoint + replay from that step. A run
killed at any point reproduces the uninterrupted loss trajectory.

Straggler watchdog: a per-step deadline (EMA of the step time x
tolerance). The hook records the event and training goes on. The first
step is kept out of the EMA: on the card it pays the kernel build and the
context set-up. ``loss.item()`` is each step's one sync with the device.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

from ..ckpt.checkpoint import CheckpointManager, tree_leaves
from ..data.pipeline import SyntheticLM
from ..dist.sharding import Policy
from ..models.model import TrainModel
from . import optimizer
from .train_step import make_train_fns


@dataclasses.dataclass
class TrainConfig:
    steps: int = 200
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    seed: int = 0
    straggler_tolerance: float = 3.0   # x EMA step time
    ema_alpha: float = 0.2


class Trainer:
    """Trains ``model`` on ``data`` on the model's device (no mesh)."""

    def __init__(self, model: TrainModel, policy: Policy,
                 opt_cfg: optimizer.OptConfig, data: SyntheticLM,
                 cfg: TrainConfig,
                 straggler_hook: Callable[[int, float, float], None] | None
                 = None):
        self.model = model
        self.policy = policy
        self.data = data
        self.cfg = cfg
        self.ckpt = CheckpointManager(cfg.ckpt_dir)
        self.straggler_hook = straggler_hook or (lambda *a: None)
        self.straggler_events: list[tuple[int, float, float]] = []
        self._init_state, self.step_fn = make_train_fns(model, policy,
                                                        opt_cfg)
        self.losses: list[tuple[int, float]] = []

    # ------------------------------------------------------------ running
    def _initial_state(self):
        """Restore the latest checkpoint onto the model's device if there
        is one (the run may have been saved from another device), else a
        fresh init from ``cfg.seed``."""
        if self.ckpt.latest_step() is None:
            return self._init_state(self.cfg.seed), 0
        like = self._init_state(self.cfg.seed, device="meta")
        state, step = self.ckpt.restore(like, device=self.model.device)
        for p in tree_leaves(state["params"]):
            p.requires_grad_(True)
        return state, step

    def run(self, until_step: int | None = None,
            crash_at: int | None = None) -> dict:
        """Train to ``until_step`` (or cfg.steps). ``crash_at`` simulates an
        unclean node failure right after that step (for restart tests)."""
        until = self.cfg.steps if until_step is None else until_step
        state, start = self._initial_state()

        ema = None
        first_measured = True
        for step in range(start, until):
            t0 = time.perf_counter()
            batch = self.data.batch(step)
            state, metrics = self.step_fn(state, batch)
            loss = metrics["loss"].item()
            dt = time.perf_counter() - t0

            if first_measured:
                # The first step builds the kernels and sets up the
                # context: never let it into the straggler baseline.
                first_measured = False
            elif ema is None:
                ema = dt
            elif dt > self.cfg.straggler_tolerance * ema:
                self.straggler_events.append((step, dt, ema))
                self.straggler_hook(step, dt, ema)
            else:
                ema = (1 - self.cfg.ema_alpha) * ema + self.cfg.ema_alpha * dt

            self.losses.append((step, loss))
            if (step + 1) % self.cfg.ckpt_every == 0 or step + 1 == until:
                self.ckpt.save(step + 1, state)
            if crash_at is not None and step + 1 >= crash_at:
                # Simulated hard failure: no final checkpoint, no cleanup.
                # A save already handed to the writer completes, as one
                # fsynced before the failure would have.
                self.ckpt.wait()
                return {"crashed_at": step + 1, "losses": self.losses}

        self.ckpt.save(until, state, blocking=True)
        return {
            "final_step": until,
            "losses": self.losses,
            "final_loss": self.losses[-1][1] if self.losses else None,
            "straggler_events": self.straggler_events,
            "state": state,
        }
