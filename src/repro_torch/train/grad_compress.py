"""int8 gradient compression with error feedback, the reference's
(``repro.train.grad_compress``): per-tensor symmetric int8 quantization of
each gradient with the quantization residual fed into the next step.

The train step applies it in place, as the reference's does inside its
step (``train_step.py``). The reference's ``compressed_psum`` quantizes,
all-reduces the int8 payload over a data-parallel mesh axis and
dequantizes; one card has no such axis, so it is not ported (ROADMAP.md,
multi-card training)."""

from __future__ import annotations

import torch

from .optimizer import zeros_f32


def quantize(g: torch.Tensor, err: torch.Tensor):
    """g + err -> (int8 q, f32 scale, new f32 residual)."""
    gf = g.float() + err
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, gf - deq


def init_error(params: dict) -> dict:
    """Zeroed f32 residuals beside each parameter leaf."""
    return zeros_f32(params)
