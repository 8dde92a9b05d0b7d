"""Batched serving engine: prefill a batch of prompts, then step-decode
with greedy sampling (static batch, one position cursor per engine)."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..models.model import Model


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
    steps (each ending in a device sync) and the token counts."""

    def __init__(self, model: Model, cfg: ServeConfig):
        self.model = model
        self.cfg = cfg
        self.stats: dict = {}

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def generate(self, prompts: np.ndarray) -> np.ndarray:
        """prompts (B, S_prompt) int32 -> (B, max_new_tokens) int32."""
        b, s = prompts.shape
        max_len = max(self.cfg.max_len, s + self.cfg.max_new_tokens)
        tokens = torch.as_tensor(np.asarray(prompts, np.int64),
                                 device=self.model.device)
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(tokens, max_len)
        tok = _greedy(logits)
        out = [tok]
        self._sync()
        t1 = time.perf_counter()
        for _ in range(self.cfg.max_new_tokens - 1):
            logits, cache = self.model.decode_step(cache, tok.long())
            tok = _greedy(logits)
            out.append(tok)
        result = torch.cat(out, dim=1).cpu().numpy()
        t2 = time.perf_counter()
        self.stats = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                      "decode_steps": self.cfg.max_new_tokens - 1,
                      "batch": b, "prompt_len": s,
                      "new_tokens": int(result.size)}
        return result
