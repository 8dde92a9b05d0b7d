"""A model's layout on a device mesh: which shard of each parameter a rank
holds, and the collectives its forward pass needs.

The shards are the reference's: every leaf is split as
``dist.sharding.param_specs`` says, on the same mesh under the same
policy. Each layer gathers its weights over the FSDP axes just before use
(and, training, reduce-scatters their gradients) and keeps only the
tensor-parallel splits that its compute runs on:

* attention: ``wq``/``wk``/``wv`` column-parallel and ``wo`` row-parallel
  over ``model`` when both the query and the kv heads divide by the model
  axis, so each rank holds whole heads, its share of the KV cache's, and
  runs K5 on them; the row-parallel output is summed over ``model``;
* the MLP: ``w1``/``w3`` column-parallel, ``w2`` row-parallel;
* MoE: the experts split over ``model`` (EP), the combine summed over it;
* the vocabulary: the embedding looked up on each rank's rows and summed,
  the logits kept split (the greedy argmax and the cross-entropy reduce
  over ``model``).

Under a policy that shards the sequence over ``model`` (training), the
residual stream between blocks is split along the sequence: each block
all-gathers it before its column-parallel products and reduce-scatters
its row-parallel output (Megatron's sequence parallelism). A full pass
decides it from its tokens (:meth:`ShardPlan.seq_split`) and hands the
flag down to its blocks (``seq``); the encoder-decoder's encoder, which
reads frames, runs unsplit.

Where a shard cannot be computed on, the compute departs from the specs
(the storage never does) and gathers the weight over ``model`` instead:

* mamba2's packed ``in_proj`` (``[z | x | B | C | dt]``), its
  ``out_proj``, conv and gate norm: a flat 1/tp cut crosses the packed
  boundaries, so the mamba mixer runs whole on every rank;
* attention whose kv heads do not divide by the model axis (gemma3-1b's
  one kv head on a model axis of 2 or 4: the flat ``wk`` dim divides, and
  the spec cuts inside the head);
* a stacked layer dim that the specs split (the encoder-decoder's MLP
  weights, which the reference's rules read as expert weights): the stack
  is gathered along it before the layer loop;
* an SSM state split over ``model`` along its state dim (``cache_specs``
  puts the kv-head logical axis on dim -2 of every 4+-d cache leaf): the
  decode step runs on the rank's slice of the state dim and sums ``C h``
  over ``model``.

MoE groups tokens in the global batch order. A rank whose token count is
a multiple of the group size holds whole groups of that order and routes
its own tokens; the aux loss's router means are averaged over the data
axes. Otherwise the tokens are gathered over the data axes before routing
and each rank keeps its rows after, so the groups, capacities and drops
are one process's, at the cost of every data rank routing, dispatching
and running the experts on the whole batch.

Installed by ``models.common.activation_sharding``; the model code calls
it through the hooks there, which do nothing when no plan is installed."""

from __future__ import annotations

import torch

from ..dist import collectives as col
from ..dist import sharding as shd
from . import encdec, transformer
from .common import (MetaGenerator, ModelConfig, activation_sharding,
                     rms_norm)

MODEL = "model"


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _pad(spec: tuple, nd: int) -> tuple:
    return tuple(spec) + ((),) * (nd - len(spec))


class ShardPlan:
    """The layout of ``cfg``'s parameters on ``mesh`` under ``policy``.
    ``params_like`` is the parameter tree (any device, meta included) whose
    shapes the specs are built from."""

    def __init__(self, cfg: ModelConfig, mesh, policy: shd.Policy,
                 params_like: dict):
        self.cfg, self.mesh, self.policy = cfg, mesh, policy
        self.tp = mesh.axis_size(MODEL)
        self.tp_rank = mesh.axis_index(MODEL)
        self.stacks = (("encoder", "decoder") if cfg.family == "encdec"
                       else ("layers",))
        specs = shd.param_specs(mesh, policy, params_like)
        self.specs = {}
        self.shapes = {}
        for path, leaf in _walk(params_like):
            spec = specs
            for k in path:
                spec = spec[k]
            self.specs[path] = _pad(spec, leaf.dim())
            self.shapes[path] = tuple(leaf.shape)
        self.keep = self._tp_plan()
        self.row_axes = ()
        self._check_caches()

    # ------------------------------------------------------------ planning
    def _on_model(self, path, dim) -> bool:
        return self.specs[path][dim] == (MODEL,)

    def _tp_plan(self) -> set:
        """The (path, dim) splits over ``model`` that the compute keeps."""
        keep = set()
        if self.tp == 1:
            return keep
        cfg = self.cfg
        heads_ok = (cfg.n_heads % self.tp == 0
                    and cfg.n_kv_heads % self.tp == 0)
        for path in self.specs:
            *pre, name = path
            pre = tuple(pre)
            if name == "wq" and heads_ok:
                trio = [(pre + (n,), -1) for n in ("wq", "wk", "wv")]
                quad = trio + [(pre + ("wo",), -2)]
                if all(self._on_model(p, d) for p, d in quad):
                    keep.update(quad)
            elif name == "w1" and pre and pre[-1] == "mlp":
                trio = [(pre + ("w1",), -1), (pre + ("w3",), -1),
                        (pre + ("w2",), -2)]
                if all(self._on_model(p, d) for p, d in trio):
                    keep.update(trio)
            elif name == "w1" and pre and pre[-1] == "moe":
                trio = [(pre + (n,), -3) for n in ("w1", "w3", "w2")]
                if all(self._on_model(p, d) for p, d in trio):
                    keep.update(trio)
            elif path == ("embed",) and self._on_model(path, -2):
                keep.add((path, -2))
            elif path == ("head",) and self._on_model(path, -1):
                keep.add((path, -1))
        return keep

    def _check_caches(self) -> None:
        """Raise where a cache split could not be run on: a conv window
        split over ``model`` (the model axis divides ``conv_width - 1``),
        or a split KV cache beside attention that is not split."""
        cfg = self.cfg
        if self.tp == 1:
            return
        kv = self.policy.axes_for("kv_heads")
        if cfg.family in ("ssm", "hybrid") and MODEL in kv \
                and (cfg.conv_width - 1) % self.tp == 0:
            raise NotImplementedError(
                f"{cfg.name}: the conv window of {cfg.conv_width - 1} "
                f"would be split over a model axis of {self.tp}")
        attn = [p for p in self.specs if p[-1] == "wq"]
        split_cache = MODEL in kv and cfg.n_kv_heads % self.tp == 0
        for p in attn:
            if split_cache and (p, -1) not in self.keep:
                raise NotImplementedError(
                    f"{cfg.name}: the policy splits the KV cache over "
                    f"{MODEL} but not {'.'.join(p)}'s heads")

    # ------------------------------------------------------------- shards
    def local(self, tree: dict, prefix: tuple = ()) -> dict:
        """This rank's shards of ``tree``, a part of the whole parameter
        tree at ``prefix`` (one drawn layer of a stack: the stack's name;
        the top-level leaves: ()). A leaf that is already this rank's
        shard is kept as it is."""
        stacked = bool(prefix) and prefix[0] in self.stacks

        def one(path, v):
            spec = self.specs[path][1:] if stacked else self.specs[path]
            whole = self.shapes[path][1:] if stacked else self.shapes[path]
            if tuple(v.shape) == whole:
                shard = shd.local_slice(self.mesh, spec, v)
                if shard.shape == v.shape:
                    return v.contiguous()
                # A copy: a view would keep the whole tensor's storage.
                return shard.clone(memory_format=torch.contiguous_format)
            if tuple(v.shape) == shd.local_shape(self.mesh, spec, whole):
                return v.contiguous()
            raise ValueError(f"{'.'.join(path)}: shape {tuple(v.shape)} is "
                             f"neither the whole {whole} nor this rank's "
                             f"shard")

        return _map(tree, prefix, one)

    def stack_rows(self, path: tuple) -> tuple[int, int] | None:
        """(first layer, layer count) of this rank's share of a stacked
        leaf whose spec splits the layer dim, else None. The reference's
        rules do that to the encoder-decoder's MLP weights: its stacks are
        not named "layers", and a 3-d ``w1``/``w2``/``w3`` reads as an
        expert weight, its dim 0 split over the experts' axes."""
        axes = self.specs[path][0] if path[0] in self.stacks else ()
        if not axes:
            return None
        i, n = shd.shard_index(self.mesh, axes)
        count = self.shapes[path][0] // n
        return i * count, count

    def gather_stack(self, tree: dict, prefix: tuple) -> dict:
        """A stack's leaves with a split layer dim gathered whole along it
        (the layer loop needs every layer on every rank)."""
        def one(path, v):
            if self.stack_rows(path) is None:
                return v
            return col.all_gather(v, self.mesh, self.specs[path][0], 0)

        return _map(tree, prefix, one)

    def gather(self, tree: dict, prefix: tuple) -> dict:
        """``tree`` (one layer's shards, or the top-level leaves) with every
        split the compute does not keep gathered."""
        stacked = bool(prefix) and prefix[0] in self.stacks

        def one(path, v):
            spec = self.specs[path][1:] if stacked else self.specs[path]
            nd = len(spec)
            for d, axes in enumerate(spec):
                if axes and not (axes == (MODEL,)
                                 and (path, d - nd) in self.keep):
                    v = col.all_gather(v, self.mesh, axes, d)
            return v

        return _map(tree, prefix, one)

    def grad_axes(self, path: tuple) -> tuple:
        """The mesh axes a leaf's gradient is summed over after the
        backward pass: those its spec does not split it over."""
        used = shd.spec_axes(self.specs[path])
        return tuple(a for a in self.mesh.axis_names
                     if a not in used and self.mesh.axis_size(a) > 1)

    def replication(self, path: tuple) -> int:
        """How many ranks hold each element of a leaf."""
        n = 1
        for a in self.grad_axes(path):
            n *= self.mesh.axis_size(a)
        return n

    # ------------------------------------------------------------- batch
    def batch_axes(self, rows: int) -> tuple:
        """The mesh axes a batch of ``rows`` rows is split over."""
        return shd._fit(self.mesh, rows, self.policy.axes_for("batch"),
                        set())

    def batch_local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole batch tensor (dim 0). The split is
        kept (``row_axes``) for the passes run on those rows: MoE's
        grouping and the loss's shares read it."""
        self.row_axes = self.batch_axes(t.shape[0])
        return col.split(t, self.mesh, self.row_axes, 0)

    def gather_rows(self, t: torch.Tensor, rows: int) -> torch.Tensor:
        """The whole batch (``rows`` rows) from this rank's rows ``t``."""
        return col.all_gather(t, self.mesh, self.batch_axes(rows), 0)

    # ------------------------------------------------------------- caches
    def _cache_spec(self, shape: tuple) -> tuple:
        """A cache leaf's spec past its batch dim (dim 1), which is
        already this rank's rows."""
        spec = shd.cache_specs(self.mesh, self.policy, self.cfg,
                               {"x": torch.empty(shape, device="meta")})["x"]
        return tuple(axes if d >= 2 else () for d, axes in enumerate(spec))

    def cache_local_shape(self, shape: tuple) -> tuple:
        """The rank's shape of a stacked ``(L, B, ...)`` cache leaf whose
        batch dim is already the rank's."""
        return shd.local_shape(self.mesh, self._cache_spec(shape), shape)

    def cache_slice(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's slice of a stacked ``(L, B, ...)`` cache tensor whose
        batch dim is already the rank's."""
        return shd.local_slice(self.mesh, self._cache_spec(tuple(t.shape)),
                               t)

    # ------------------------------------------------------------- blocks
    def seq_split(self, s: int) -> bool:
        """Whether a full pass over ``s`` positions splits the residual
        stream along the sequence over ``model``."""
        return (self.tp > 1 and MODEL in self.policy.axes_for("seq")
                and s % self.tp == 0 and s > 1)

    def enter(self, x: torch.Tensor, seq: bool) -> torch.Tensor:
        """A block's input: the whole sequence (gathered over ``model``
        when ``seq``, the stream split along the sequence)."""
        if seq:
            return col.all_gather(x, self.mesh, MODEL, 1)
        return x

    def exit(self, y: torch.Tensor, partial: bool, seq: bool
             ) -> torch.Tensor:
        """A block's output back on the residual stream: a row-parallel
        partial sum is summed over ``model`` (reduce-scattered along the
        sequence when ``seq``); a whole output is split along the sequence
        when ``seq``."""
        if partial:
            if seq:
                return col.reduce_scatter(y, self.mesh, MODEL, 1)
            return col.all_reduce(y, self.mesh, MODEL)
        if seq:
            return col.split(y, self.mesh, MODEL, 1)
        return y

    def model_sum(self, y: torch.Tensor) -> torch.Tensor:
        return col.all_reduce(y, self.mesh, MODEL)

    def ssm_slice(self, t: torch.Tensor, n_local: int) -> torch.Tensor:
        """The rank's slice of the last dim (the SSM state dim) of ``t``
        when the state is split over ``model``."""
        if n_local == t.shape[-1]:
            return t
        return t.narrow(-1, self.tp_rank * n_local, n_local)

    def moe_tokens(self, x: torch.Tensor, group_size: int):
        """(the tokens MoE routes, a function taking its output back to
        this rank's rows, whether they are this rank's rows alone) for
        grouping in the global order. A rank whose token count is a
        multiple of ``group_size`` holds whole global groups and routes
        its own; otherwise the whole batch is gathered over the row axes
        and every rank routes all of it."""
        axes = self.row_axes
        n = shd.shard_index(self.mesh, axes)[1]
        if n == 1 or (x.shape[0] * x.shape[1]) % group_size == 0:
            return x, (lambda y: y), n > 1
        return (col.all_gather(x, self.mesh, axes, 0),
                lambda y: col.split(y, self.mesh, axes, 0), False)

    def row_mean(self, t: torch.Tensor, grad: bool) -> torch.Tensor:
        """The mean of ``t`` over the ranks of the row axes (router
        statistics of locally routed groups); ``grad``: the gradient flows
        through it."""
        axes = self.row_axes
        n = shd.shard_index(self.mesh, axes)[1]
        total = (col.all_reduce(t, self.mesh, axes) if grad
                 else col.psum_scalar(t, self.mesh, axes))
        return total / n

    def expert_offset(self, n_local: int) -> int:
        return self.tp_rank * n_local if n_local < self.cfg.n_experts else 0

    def first_rank_only(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on the first rank of ``model``, zeros on the others (a
        term of a partial sum that only one rank may add)."""
        return t if self.tp_rank == 0 else torch.zeros_like(t)

    # ---------------------------------------------------------- vocabulary
    def embed(self, cfg: ModelConfig, params: dict, tokens: torch.Tensor,
              seq: bool):
        """The scaled embedding of ``tokens`` (B, S), on the residual
        stream (split along the sequence when ``seq``)."""
        table = self.gather({"embed": params["embed"]}, ())["embed"]
        if table.shape[0] == cfg.vocab:
            x = self.exit(table[tokens].to(cfg.compute_dtype), False, seq)
        else:
            v0 = self.tp_rank * table.shape[0]
            local = tokens - v0
            inside = (local >= 0) & (local < table.shape[0])
            x = table[local.clamp(0, table.shape[0] - 1)].to(
                cfg.compute_dtype)
            x = x * inside[..., None].to(x.dtype)
            x = self.exit(x, True, seq)
        return x * (cfg.d_model ** 0.5)

    def logits(self, cfg: ModelConfig, params: dict, x: torch.Tensor,
               seq: bool):
        """The logits of the residual stream ``x`` (split along the
        sequence when ``seq``), the vocabulary split over ``model`` where
        the head is."""
        name = "embed" if cfg.tie_embeddings else "head"
        top = self.gather({"final_norm": params["final_norm"],
                           name: params[name]}, ())
        x = self.enter(rms_norm(x, top["final_norm"], cfg.norm_eps), seq)
        head = top["embed"].T if cfg.tie_embeddings else top["head"]
        return x @ head.to(cfg.compute_dtype)

    def vocab_split(self, logits: torch.Tensor) -> bool:
        return logits.shape[-1] != self.cfg.vocab

    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """(B, 1) int32 argmax of the last position over the whole
        vocabulary, the first maximum winning ties as ``jnp.argmax``."""
        last = logits[:, -1, :]
        if not self.vocab_split(logits):
            return torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        vals, idx = torch.max(last.float(), dim=-1)      # first maximum
        idx = idx + self.tp_rank * last.shape[-1]
        both = torch.stack([vals, idx.float()], 0)[None]  # (1, 2, B)
        both = col.all_gather(both, self.mesh, MODEL, 0)  # (tp, 2, B)
        v, i = both[:, 0], both[:, 1]
        best = v.max(dim=0).values
        big = torch.full_like(i, float(self.cfg.vocab))
        pick = torch.where(v == best[None], i, big).min(dim=0).values
        return pick.to(torch.int32)[:, None]

    def gather_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole vocabulary's logits (for comparisons)."""
        if not self.vocab_split(logits):
            return logits
        return col.all_gather(logits, self.mesh, MODEL, -1 % logits.dim())

    def nll(self, logits: torch.Tensor, labels: torch.Tensor):
        """Per-position negative log-likelihood in f32 of vocab-split
        logits."""
        logits = logits.float()
        v_loc = logits.shape[-1]
        m = col.pmax(logits.max(dim=-1).values.detach(), self.mesh, MODEL)
        se = torch.exp(logits - m[..., None]).sum(dim=-1)
        logz = m + torch.log(col.all_reduce(se, self.mesh, MODEL))
        local = labels.long() - self.tp_rank * v_loc
        inside = (local >= 0) & (local < v_loc)
        gold = logits.gather(-1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
        gold = col.all_reduce(gold * inside, self.mesh, MODEL)
        return logz - gold

    def loss(self, logits, labels, mask, aux, aux_coef: float
             ) -> torch.Tensor:
        """This rank's share of the training loss: the token cross-entropy
        of its rows over the whole batch's token count, plus ``aux_coef``
        times the MoE aux loss, each divided by the number of ranks that
        compute it alike. Summed over the world, the shares are the
        loss."""
        if self.vocab_split(logits):
            nll = self.nll(logits, labels)
        else:
            lf = logits.float()
            nll = torch.logsumexp(lf, dim=-1) - lf.gather(
                -1, labels[..., None].long())[..., 0]
        axes = self.row_axes
        n_rows = shd.shard_index(self.mesh, axes)[1]
        if mask is None:
            num = nll.sum()
            den = float(nll.numel() * n_rows)
        else:
            mask = mask.float()
            num = (nll * mask).sum()
            den = torch.clamp(col.psum_scalar(mask.sum(), self.mesh, axes),
                              min=1.0)
        same = self.mesh.size // n_rows
        share = num / den / same
        if aux is not None:
            share = share + aux_coef * aux / self.mesh.size
        return share


def _map(tree: dict, prefix: tuple, fn) -> dict:
    return {k: _map(v, prefix + (k,), fn) if isinstance(v, dict)
            else fn(prefix + (k,), v) for k, v in tree.items()}


def plan_for(cfg: ModelConfig, mesh, policy=None) -> ShardPlan | None:
    """The plan of ``cfg`` on ``mesh`` under ``policy`` (``Policy()`` when
    None); None on a one-rank mesh (the meshless path, bit for bit)."""
    if mesh is None or mesh.size == 1:
        return None
    if policy is None:
        policy = shd.Policy()
    family = encdec if cfg.family == "encdec" else transformer
    with torch.no_grad(), activation_sharding(None):
        like = family.init_params(cfg, MetaGenerator())
    return ShardPlan(cfg, mesh, policy, like)
