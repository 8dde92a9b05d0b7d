"""int8 gradient compression with error feedback, the reference's
(``repro.train.grad_compress``): per-tensor symmetric int8 quantization of
each gradient with the quantization residual fed into the next step.

The train step applies it after the gradient reduction, as the
reference's does inside its step (``train_step.py``); on a mesh the
per-tensor scale is the whole tensor's (its shards' maxima reduced).
:func:`compressed_psum` is the wire form: quantize, all-reduce the int8
payload as int32 over the data-parallel mesh axes, sum the scales, and
dequantize with their mean, divided by the number of ranks."""

from __future__ import annotations

import torch

from ..ckpt.checkpoint import tree_leaves, tree_unflatten
from ..dist import collectives as col
from .optimizer import zeros_f32


def quantize(g: torch.Tensor, err: torch.Tensor,
             absmax: torch.Tensor | None = None):
    """g + err -> (int8 q, f32 scale, new f32 residual). ``absmax`` is the
    largest |g + err| of the whole tensor where ``g`` is a shard of it."""
    gf = g.float() + err
    if absmax is None:
        absmax = torch.max(torch.abs(gf))
    scale = absmax / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, gf - deq


def init_error(params: dict) -> dict:
    """Zeroed f32 residuals beside each parameter leaf."""
    return zeros_f32(params)


def compressed_psum(grads, err, mesh, axis_names=("data",)):
    """Quantize each gradient leaf with its error feedback, all-reduce the
    int8 payload (as int32 accumulators) and the scales over
    ``axis_names``, and dequantize: (the averaged gradients, the new
    residuals), trees shaped as ``grads``. Each rank passes its own
    gradients; on a mesh whose axes are all of size 1 the reduction is the
    identity, as the reference's psum over a size-1 axis."""
    n_dev = 1
    for ax in axis_names:
        n_dev *= mesh.axis_size(ax)
    out, new_err = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(err)):
        q, scale, new_e = quantize(g, e)
        acc = col.psum_scalar(q.to(torch.int32), mesh, axis_names)
        # Every rank contributes its own scale; the summed payload is
        # dequantized with their mean.
        scale_sum = col.psum_scalar(scale, mesh, axis_names)
        deq = acc.float() * (scale_sum / n_dev)
        out.append(deq / n_dev)
        new_err.append(new_e)
    return tree_unflatten(grads, out), tree_unflatten(grads, new_err)
