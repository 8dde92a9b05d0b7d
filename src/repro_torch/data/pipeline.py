"""Deterministic synthetic LM data: the reference's pipeline
(``repro.data.pipeline``) in numpy, copied so the port imports none of it.

The stream is a seeded random bigram automaton (each token has a fixed
likely successor, followed with prob ``determinism``; otherwise uniform),
so the achievable cross-entropy floor is known in closed form. ``batch``
depends only on (seed, step): a resumed run replays its data with no
loader state. Documents are packed end to end with a BOS separator, and
the loss mask drops the BOS targets. Batches stay numpy; the trainer moves
them to its device."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    determinism: float = 0.9
    mean_doc_len: int = 384
    bos: int = 0


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # Fixed bigram successor table (the learnable structure).
        self.successor = rng.integers(1, cfg.vocab, size=cfg.vocab)

    def entropy_floor(self) -> float:
        """Achievable mean CE in nats for a perfect model of the automaton."""
        p = self.cfg.determinism
        v = self.cfg.vocab
        # successor with prob p (+ uniform leak), every other token uniform.
        p_succ = p + (1 - p) / v
        rest = (1 - p) / v
        return float(-(p_succ * np.log(p_succ) + (v - 1) * rest * np.log(rest)))

    def _stream(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Packed documents: BOS then bigram-automaton tokens."""
        out = np.empty(n + 1, dtype=np.int32)
        i = 0
        while i < n + 1:
            doc_len = max(2, int(rng.exponential(self.cfg.mean_doc_len)))
            out[i] = self.cfg.bos
            cur = int(rng.integers(1, self.cfg.vocab))
            j = i + 1
            while j < min(i + doc_len, n + 1):
                out[j] = cur
                leak = rng.random() >= self.cfg.determinism
                cur = int(rng.integers(1, self.cfg.vocab)) if leak \
                    else int(self.successor[cur])
                j += 1
            i = j
        return out

    def batch(self, step: int) -> dict:
        """{"tokens", "targets", "mask"} — (B, S) int32 / float mask."""
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        stream = self._stream(rng, c.global_batch * c.seq_len)
        toks = stream[:-1].reshape(c.global_batch, c.seq_len)
        tgts = stream[1:].reshape(c.global_batch, c.seq_len)
        mask = (tgts != c.bos).astype(np.float32)
        return {"tokens": toks, "targets": tgts, "mask": mask}

    def frames_batch(self, step: int, d_model: int, target_len: int) -> dict:
        """Enc-dec variant: stub frame embeddings + token targets."""
        c = self.cfg
        rng = np.random.default_rng((c.seed, 7, step))
        base = self.batch(step)
        frames = rng.standard_normal(
            (c.global_batch, c.seq_len, d_model)).astype(np.float32)
        return {
            "frames": frames,
            "tokens": base["tokens"][:, :target_len],
            "targets": base["targets"][:, :target_len],
            "mask": base["mask"][:, :target_len],
        }
