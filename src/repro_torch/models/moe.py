"""Top-k Mixture-of-Experts FFN (GShard/Switch-style capacity dispatch).

Dispatch and combine are the reference's dense one-hot tensors
``(g, s, e, c)``, contracted with the tokens and the expert outputs by
einsums, and the expert FFN is one batched product over the stacked
``(E, ...)`` expert weights. Tokens are routed in groups of at most
``GROUP_SIZE``; tokens past the last whole group are returned unchanged,
as the reference returns them.

The reference builds dispatch and combine from a 5-D ``(g, s, k, e, c)``
one-hot and sums it over k. The top-k experts of a token are distinct, so
each such sum has at most one non-zero term: here each kept (token,
choice) pair is written once into ``(g, s, e, c)`` by a scatter, which
gives the same tensors exactly without the 5-D intermediate.

Profiler ranges name the layer's parts in a trace: ``moe.route`` (router,
top-k, aux loss, dispatch and combine tensors), ``moe.dispatch``,
``moe.experts`` (the three batched expert products) and ``moe.combine``
(a few microseconds per layer without a profiler).

On a mesh (``models/parallel.py``) the tokens are routed in the global
batch order (each rank its own whole groups, their router means averaged
over the data axes for the aux loss; else gathered over the data axes,
each rank's rows kept after),
each rank runs the experts it holds (EP over the model axis) on its slice
of the dispatch tensor, and the combine's partial sums are summed over
the model axis; the ragged tail is added by the first rank of that
axis alone."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..tracing import span
from .common import ModelConfig, current_plan, init_dense, pshard

GROUP_SIZE = 1024  # tokens per dispatch group


def init_moe_layer(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """The router in f32 whatever ``cfg.dtype`` is; the experts' weights
    stacked ``(E, D, F)`` / ``(E, F, D)`` in ``cfg.dtype``."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    return {
        "router": init_dense(gen, (d, e), dtype=torch.float32),
        "w1": init_dense(gen, (e, d, f), scale_axis=1, dtype=cfg.dtype),
        "w3": init_dense(gen, (e, d, f), scale_axis=1, dtype=cfg.dtype),
        "w2": init_dense(gen, (e, f, d), scale_axis=1, dtype=cfg.dtype),
    }


def capacity(cfg: ModelConfig, g_size: int) -> int:
    """Slots per expert and group: Python's ``round`` (half to even), as
    the reference computes it."""
    k, e = cfg.top_k, cfg.n_experts
    return int(max(k, round(g_size * k / e * cfg.capacity_factor)))


@dataclasses.dataclass
class Routing:
    """One group-wise routing: ``probs`` (g, s, e) f32; ``gates`` and
    ``expert_ids`` (g, s, k), the gates renormalized over the k choices;
    ``slots`` (g, s, k) each choice's position in its expert's buffer
    (token-major over the flattened (s, k)); ``kept`` (g, s, k) whether
    that position is under ``capacity``."""

    probs: torch.Tensor
    gates: torch.Tensor
    expert_ids: torch.Tensor
    slots: torch.Tensor
    kept: torch.Tensor
    capacity: int


def route(cfg: ModelConfig, router: torch.Tensor, xg: torch.Tensor) -> Routing:
    """Route the grouped tokens ``xg`` (g, s, D) in f32."""
    g, s, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xg.float() @ router, dim=-1)          # (g, s, e)
    # A stable descending sort puts the lower expert first on ties, as
    # jax.lax.top_k does; torch.topk promises no order on ties.
    gates, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
    gates, expert_ids = gates[..., :k], expert_ids[..., :k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    # A choice's slot counts the earlier (token, choice) pairs, token-major,
    # that chose its expert. The scan runs along the last dimension, which
    # PyTorch's CUDA scan spreads over threads (one along an outer
    # dimension of 8192 pairs took ~3 ms a layer on an H100).
    flat = expert_ids.reshape(g, 1, s * k)
    sel = (flat == torch.arange(e, device=xg.device)[None, :, None]).to(
        torch.int32)                                            # (g, e, s*k)
    pos = torch.cumsum(sel, dim=2, dtype=torch.int32)
    slots = pos.gather(1, flat).reshape(g, s, k) - 1
    cap = capacity(cfg, s)
    return Routing(probs, gates, expert_ids, slots, slots < cap, cap)


def dispatch_combine(r: Routing, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(dispatch, combine), each (g, s, e, c) in ``dtype``: 1 and the gate
    at each kept (token, expert, slot), 0 elsewhere."""
    g, s, k = r.expert_ids.shape
    e, c = r.probs.shape[-1], r.capacity
    # A dropped choice writes its zero at slot c - 1 of its own (token,
    # expert) row, which no other choice of the token shares.
    idx = r.expert_ids * c + r.slots.clamp(max=c - 1)

    def scattered(vals):
        out = torch.zeros((g, s, e * c), dtype=dtype, device=vals.device)
        return out.scatter_(2, idx, vals.to(dtype)).reshape(g, s, e, c)

    # The gates are cast after the product, as the reference casts its f32
    # combine tensor.
    return scattered(r.kept), scattered(r.gates * r.kept)


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, seq: bool = False):
    """x (B, S, D) -> (y (B, S, D) in the compute dtype, the GShard
    load-balancing aux loss, a 0-d f32 tensor). ``seq``: the residual
    stream is split along the sequence (``models.common.pshard``)."""
    plan = current_plan()
    back, local = None, False
    x = pshard(x, "in", seq)
    if plan is not None:
        x, back, local = plan.moe_tokens(x, GROUP_SIZE)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cd = cfg.compute_dtype
    e_local = p["w1"].shape[0]
    e0 = 0 if plan is None else plan.expert_offset(e_local)

    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    g_size = min(GROUP_SIZE, t)
    n_groups = t // g_size
    xg = tokens[:n_groups * g_size].reshape(n_groups, g_size, d)

    with span("moe.route"):
        r = route(cfg, p["router"], xg)
        # Load-balancing aux loss: mean prob times mean assignment per
        # expert.
        me = r.probs.mean(dim=(0, 1))                           # (e,)
        assign = torch.zeros_like(r.probs).scatter_(2, r.expert_ids, 1.0)
        ce = assign.mean(dim=(0, 1)) / k                        # (e,)
        if local:                    # the whole batch's means
            me, ce = plan.row_mean(me, True), plan.row_mean(ce, False)
        aux = e * torch.sum(me * ce)
        dispatch, combine = dispatch_combine(r, cd)
        if e_local != e:                    # this rank's experts only
            dispatch = dispatch[:, :, e0:e0 + e_local]
            combine = combine[:, :, e0:e0 + e_local]
    with span("moe.dispatch"):
        xe = torch.einsum("gsec,gsd->egcd", dispatch, xg.to(cd))
    with span("moe.experts"):
        h = torch.einsum("egcd,edf->egcf", xe, p["w1"].to(cd))
        hg = torch.einsum("egcd,edf->egcf", xe, p["w3"].to(cd))
        h = F.silu(h) * hg
        ye = torch.einsum("egcf,efd->egcd", h, p["w2"].to(cd))
    with span("moe.combine"):
        y = torch.einsum("gsec,egcd->gsd", combine, ye).reshape(-1, d)
    if y.shape[0] < t:  # the ragged tail passes through unchanged
        tail = tokens[y.shape[0]:].to(y.dtype)
        if e_local != e:
            tail = plan.first_rank_only(tail)
        y = torch.cat([y, tail], dim=0)
    y = y.reshape(b, s, d).to(cd)
    if back is not None:
        y = pshard(back(y), "partial" if e_local != e else "whole", seq)
    return y, aux.float()
