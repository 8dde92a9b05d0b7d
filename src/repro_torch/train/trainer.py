"""Fault-tolerant training loop, the reference's (``repro.train.trainer``),
on one device (a one-rank mesh) or on a mesh of ranks.

Restart semantics: the state (params, moments, step, error feedback) is
checkpointed atomically; the data pipeline is stateless in the step index;
so resume = restore the latest checkpoint + replay from that step. A run
killed at any point reproduces the uninterrupted loss trajectory.

Straggler watchdog: a per-step deadline (EMA of the step time x
tolerance). The hook records the event and training goes on. The first
step is kept out of the EMA: on the card it pays the kernel build and the
context set-up. ``loss.item()`` is each step's one sync with the device.

Rank-aware checkpoints: the file holds the whole state, in the one-device
format, so a run saved on one mesh resumes on another. Each leaf is
gathered over the mesh, rank 0 writes (atomically, as before), and every
rank waits for the write before it goes on; on restore each rank reads
the file and keeps its shards.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch

from ..ckpt.checkpoint import CheckpointManager, tree_leaves, tree_unflatten
from ..data.pipeline import SyntheticLM
from ..dist import collectives as col
from ..dist import sharding as shd
from ..dist.sharding import Policy
from ..models.model import TrainModel
from . import optimizer
from .train_step import make_train_fns, sharded_model, tree_paths


@dataclasses.dataclass
class TrainConfig:
    steps: int = 200
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    seed: int = 0
    straggler_tolerance: float = 3.0   # x EMA step time
    ema_alpha: float = 0.2


class Trainer:
    """Trains ``model`` on ``data`` on ``mesh`` (``make_host_mesh()`` in one
    process: the model's device) under ``policy``, as the reference's."""

    def __init__(self, model: TrainModel, mesh, policy: Policy, opt_cfg,
                 data: SyntheticLM, cfg: TrainConfig,
                 straggler_hook: Callable[[int, float, float], None] | None
                 = None):
        model = sharded_model(model, mesh, policy)
        self.model = model
        self.mesh = mesh
        self.plan = model.plan
        self.policy = policy
        self.data = data
        self.cfg = cfg
        self.ckpt = CheckpointManager(cfg.ckpt_dir)
        self.straggler_hook = straggler_hook or (lambda *a: None)
        self.straggler_events: list[tuple[int, float, float]] = []
        self._init_state, self.step_fn = make_train_fns(model, mesh, policy,
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
        if self.plan is None:
            state, step = self.ckpt.restore(like, device=self.model.device)
        else:
            whole, step = self.ckpt.restore(like)
            state = tree_unflatten(like, [
                shd.local_slice(self.mesh, spec, t).contiguous().to(
                    self.model.device)
                for t, spec in zip(tree_leaves(whole), self._specs(like))])
        for p in tree_leaves(state["params"]):
            p.requires_grad_(True)
        return state, step

    def _specs(self, state) -> list:
        """The spec of each leaf of a state tree, in leaf order: the
        moments and the error feedback are split as their parameter."""
        specs = [self.plan.specs[p] for p in tree_paths(state["params"])]
        out = []
        for k in sorted(state):
            if k == "opt":
                for j in sorted(state["opt"]):
                    out += [()] if j == "step" else specs
            else:
                out += specs
        return out

    def _save(self, step: int, state, blocking: bool = False) -> None:
        """Save the whole state: rank 0 writes the gathered leaves."""
        if self.plan is None:
            self.ckpt.save(step, state, blocking=blocking)
            return
        whole = []
        for t, spec in zip(tree_leaves(state), self._specs(state)):
            with torch.no_grad():
                for d, axes in enumerate(spec):
                    t = col.all_gather(t, self.mesh, axes, d)
            whole.append(t.detach().cpu() if self._rank0 else None)
        if self._rank0:
            self.ckpt.save(step, tree_unflatten(state, whole), blocking=True)
        torch.distributed.barrier()

    @property
    def _rank0(self) -> bool:
        return all(c == 0 for c in self.mesh.coords)

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
                self._save(step + 1, state)
            if crash_at is not None and step + 1 >= crash_at:
                # Simulated hard failure: no final checkpoint, no cleanup.
                # A save already handed to the writer completes, as one
                # fsynced before the failure would have.
                self.ckpt.wait()
                return {"crashed_at": step + 1, "losses": self.losses}

        self._save(until, state, blocking=True)
        return {
            "final_step": until,
            "losses": self.losses,
            "final_loss": self.losses[-1][1] if self.losses else None,
            "straggler_events": self.straggler_events,
            "state": state,
        }
