"""The logical-axis sharding policy of the reference's
``repro.dist.sharding``, over the port's :class:`~repro_torch.launch.mesh.
Mesh`.

Models name the logical axes of their tensors; this module owns the one
mapping from those names to mesh axes (:class:`Policy`) and the parameter,
batch and KV/SSM-cache spec builders (:func:`param_specs`,
:func:`batch_specs`, :func:`cache_specs`). Everything funnels through
:func:`_fit`: a mesh axis is used at most once per spec, and a dim is
sharded only where the product of its mesh axes divides it (otherwise it
is replicated: whisper's vocabulary of 51 865 shards over nothing).

A spec is a tuple with one entry per leading dim, each entry the tuple of
mesh axes that dim is split over (``()`` replicated), trailing replicated
dims dropped: the reference's ``PartitionSpec(None, "data", "model")`` is
``((), ("data",), ("model",))`` here. :func:`local_slice` cuts a rank's
shard out of a whole tensor, the rank's index along a dim split over
``(a, b)`` being ``i_a * size_b + i_b`` as in JAX.

The policy also carries the training options the step reads:
gradient accumulation over ``microbatches`` and int8 gradient compression
(``grad_compress``). Nothing here touches a device or a process group."""

from __future__ import annotations

import dataclasses

import torch

#: logical axis -> mesh axes tried in order (absent mesh axes are skipped).
#: "batch" spans the whole data-parallel extent (pod x data on the 2-pod
#: mesh); the tensor-parallel logical axes all map to "model".
_DEFAULT_LOGICAL = (
    ("batch", ("pod", "data")),
    ("seq", ()),
    ("embed", ()),
    ("mlp", ("model",)),
    ("vocab", ("model",)),
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("heads_flat", ("model",)),
    ("experts", ("model",)),
)


@dataclasses.dataclass(frozen=True)
class Policy:
    """One sharding policy: microbatching, int8 gradient compression, the
    FSDP axes and the logical map."""

    microbatches: int = 1
    grad_compress: bool = False
    #: mesh axes parameters are FSDP-sharded over (() = replicate weights).
    fsdp_axes: tuple = ("data",)
    #: ((logical_name, (mesh_axis, ...)), ...); override by with_logical().
    logical: tuple = _DEFAULT_LOGICAL

    def axes_for(self, name) -> tuple:
        if name is None:
            return ()
        for key, axes in self.logical:
            if key == name:
                return tuple(axes)
        return ()

    def with_logical(self, **overrides) -> "Policy":
        """Replace logical-axis mappings, e.g. ``with_logical(seq=
        ("model",))`` for sequence sharding or ``with_logical(experts=())``
        to replicate the expert weights."""
        table = dict(self.logical)
        for key, axes in overrides.items():
            table[key] = tuple(axes)
        return dataclasses.replace(self, logical=tuple(table.items()))


def default_policy_for(kind: str) -> Policy:
    """The defaults per step kind: training microbatches 16 ways under
    FSDP; inference replicates the weights (FSDP would gather them every
    step) and leans on TP."""
    if kind == "train":
        return Policy(microbatches=16)
    return Policy(microbatches=1, fsdp_axes=())


def serve_policy(tp: bool) -> Policy:
    """The serve launcher's policy: with ``tp`` the default, else the
    attention, MLP and vocabulary replicated and the experts kept
    expert-parallel (the reference's ``--tp`` switch)."""
    if tp:
        return Policy()
    return Policy().with_logical(heads=(), kv_heads=(), heads_flat=(),
                                 vocab=(), mlp=())


# --------------------------------------------------------------------- fit
def _fit(mesh, dim: int, axes, used: set) -> tuple:
    """The longest usable prefix of ``axes`` that legally shards a dim of
    size ``dim``: drops axes absent from the mesh or used already in this
    spec, then backs off from the right until the product of the axis
    sizes divides ``dim``. () (replicate) when nothing fits. Adds the
    chosen axes to ``used``."""
    shape = mesh.shape
    avail = [a for a in axes if a in shape and a not in used]
    while avail:
        prod = 1
        for a in avail:
            prod *= shape[a]
        if prod > 1 and dim % prod == 0:
            used.update(avail)
            return tuple(avail)
        avail.pop()
    return ()


def _strip(parts: list) -> tuple:
    while parts and not parts[-1]:
        parts.pop()
    return tuple(parts)


def spec_from_logical(mesh, policy: Policy, shape, logical) -> tuple:
    """The spec of a tensor of ``shape`` whose dims have the logical names
    ``logical`` (None for an unnamed dim)."""
    used: set = set()
    return _strip([_fit(mesh, shape[i], policy.axes_for(name), used)
                   for i, name in enumerate(logical)])


# ----------------------------------------------------------------- params
#: weight name -> (tp logical axis, its dim counted from the right). TP
#: goes on the dim a product contracts *out of* (column-parallel for the
#: up-projections, row-parallel for the down-projections).
_TP_RULES = {
    "wq": ("heads_flat", 1), "wk": ("kv_heads", 1), "wv": ("kv_heads", 1),
    "wo": ("heads_flat", 2),
    "w1": ("mlp", 1), "w3": ("mlp", 1), "w2": ("mlp", 2),
    "in_proj": ("heads_flat", 1), "out_proj": ("heads_flat", 2),
    "embed": ("vocab", 2), "head": ("vocab", 1),
}


def _param_spec(mesh, policy: Policy, path: tuple, shape) -> tuple:
    """The spec of the parameter at key ``path`` with ``shape``."""
    name = path[-1] if path else ""
    nd = len(shape)
    stacked = "layers" in path
    parts = [()] * nd
    used: set = set()
    if nd >= 2:
        rule = _TP_RULES.get(name)
        # MoE expert weights carry a leading experts dim: (e, d, f) or
        # stacked (L, e, d, f); they are expert-parallel instead of TP.
        if rule and name in ("w1", "w2", "w3") and nd - int(stacked) == 3:
            e_dim = nd - 3
            parts[e_dim] = _fit(mesh, shape[e_dim], policy.axes_for("experts"),
                                used)
        elif rule:
            logical, from_right = rule
            d = nd - from_right
            if d >= int(stacked):  # never shard the stacked layer dim
                parts[d] = _fit(mesh, shape[d], policy.axes_for(logical),
                                used)
        # FSDP: the largest dim still replicated (not the layer dim) over
        # the data axes, ZeRO-3 style (gathered around use).
        if policy.fsdp_axes:
            cand = [i for i in range(int(stacked), nd) if not parts[i]]
            cand.sort(key=lambda i: -shape[i])
            for i in cand:
                axes = _fit(mesh, shape[i], policy.fsdp_axes, used)
                if axes:
                    parts[i] = axes
                    break
    return _strip(parts)


def _map_with_path(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(v, fn, path) for v in tree)
    return fn(path, tree)


def param_specs(mesh, policy: Policy, params_like) -> dict:
    """The spec tree of a parameter tree (tensors of any device, meta
    included, or anything with a ``shape``)."""
    return _map_with_path(
        params_like, lambda path, leaf: _param_spec(mesh, policy, path,
                                                    tuple(leaf.shape)))


# ------------------------------------------------------------------ batch
def _batch_spec(mesh, policy: Policy, shape) -> tuple:
    if not shape:
        return ()
    logical = ["batch"] + ["seq" if i == 1 else None
                           for i in range(1, len(shape))]
    return spec_from_logical(mesh, policy, shape, logical)


def batch_specs(mesh, policy: Policy, batch_like) -> dict:
    """Batch specs: dim 0 over the data extent, dim 1 over the seq axes
    (replicated unless the policy shards the sequence)."""
    return _map_with_path(
        batch_like, lambda path, leaf: _batch_spec(mesh, policy,
                                                   tuple(leaf.shape)))


def cache_specs(mesh, policy: Policy, cfg, cache_like) -> dict:
    """KV/SSM cache specs: leaves are layer-stacked ``(L, B, ...)``; the
    layer dim replicated, the batch over the data extent, and dim -2 of a
    4+-d leaf (the kv heads of an attention cache) over the tensor-parallel
    axes. Scalars (``pos``) are replicated."""

    def spec(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        nd = len(shape)
        if nd < 2:
            return ()
        logical = [None] * nd
        logical[1] = "batch"
        if nd >= 4:
            logical[nd - 2] = "kv_heads"
        return spec_from_logical(mesh, policy, shape, logical)

    return _map_with_path(cache_like, spec)


# ------------------------------------------------------------- local slice
def shard_index(mesh, axes: tuple) -> tuple[int, int]:
    """(this rank's index, the number of shards) along a dim split over
    ``axes``: row-major over the axes, as JAX numbers them."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
        n *= mesh.axis_size(a)
    return idx, n


def local_shape(mesh, spec: tuple, shape) -> tuple:
    """The shape of a rank's shard of a tensor of ``shape``."""
    out = list(shape)
    for d, axes in enumerate(spec):
        out[d] //= shard_index(mesh, axes)[1]
    return tuple(out)


def local_slice(mesh, spec: tuple, t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` (a view)."""
    for d, axes in enumerate(spec):
        i, n = shard_index(mesh, axes)
        if n > 1:
            size = t.shape[d] // n
            t = t.narrow(d, i * size, size)
    return t


def spec_axes(spec: tuple) -> set:
    """The mesh axes a spec uses."""
    return {a for axes in spec for a in axes}
