"""Batched serving engine: prefill a batch of prompts, then step-decode
with greedy sampling (static batch, one position cursor per engine).

``Engine(model, mesh, policy, params, cfg)`` as the reference's: on a mesh
of more than one rank each rank prefills and decodes its rows of the batch
(split over the data axes as ``dist.sharding.batch_specs`` says) against
its shards of the weights and of the KV/SSM caches (``cache_specs``), the
greedy argmax reduces the vocabulary-split logits over the model axis
with the first maximum winning ties, and ``generate`` returns the whole
batch's tokens on every rank. On a one-rank mesh (``make_host_mesh()``
in one process) it is the one-device engine."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..models.model import Model, build


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    max_len: int = 256


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1) int32 argmax of the last position; the first maximum wins on
    ties, as ``jnp.argmax``."""
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]


class Engine:
    """Greedy generation on the model's device. After each ``generate``,
    ``stats`` holds the host-clock seconds of the prefill and of the decode
    steps (each ending in a device sync) and the token counts.

    ``model`` is a model built for ``mesh`` and ``policy`` (it holds this
    rank's shards), or a one-device model whose weights (or ``params``, a
    whole parameter tree, when given) are then cut to this rank's shards.
    """

    def __init__(self, model: Model, mesh, policy, params,
                 cfg: ServeConfig):
        ranks = mesh.size
        if ranks > 1 and "model" in policy.axes_for("seq"):
            raise ValueError("sequence sharding is a training policy; the "
                             "engine's prefill needs every position")
        if ranks > 1 and model.plan is None:
            model = build(model.cfg, params if params is not None
                          else model.params, device=model.device, mesh=mesh,
                          policy=policy)
        elif params is not None:
            model = build(model.cfg, params, device=model.device, mesh=mesh,
                          policy=policy)
        if ranks > 1 and (model.plan.mesh is not mesh
                          or model.plan.policy != policy):
            raise ValueError("the model was built for another mesh or policy")
        self.model = model
        self.mesh = mesh
        self.policy = policy
        self.cfg = cfg
        self.stats: dict = {}

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    @torch.inference_mode()
    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        plan = self.model.plan
        return _greedy(logits) if plan is None else plan.greedy(logits)

    def generate(self, prompts: np.ndarray) -> np.ndarray:
        """prompts (B, S_prompt) int32 -> (B, max_new_tokens) int32 (the
        whole batch's, on every rank)."""
        b, s = prompts.shape
        max_len = max(self.cfg.max_len, s + self.cfg.max_new_tokens)
        plan = self.model.plan
        tokens = torch.as_tensor(np.asarray(prompts, np.int64),
                                 device=self.model.device)
        if plan is not None:
            tokens = plan.batch_local(tokens)
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(tokens, max_len)
        tok = self._pick(logits)
        out = [tok]
        self._sync()
        t1 = time.perf_counter()
        for _ in range(self.cfg.max_new_tokens - 1):
            logits, cache = self.model.decode_step(cache, tok.long())
            tok = self._pick(logits)
            out.append(tok)
        result = torch.cat(out, dim=1)
        if plan is not None:
            with torch.inference_mode():
                result = plan.gather_rows(result, b)
        result = result.cpu().numpy()
        t2 = time.perf_counter()
        self.stats = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                      "decode_steps": self.cfg.max_new_tokens - 1,
                      "batch": b, "prompt_len": s,
                      "new_tokens": int(result.size)}
        return result
