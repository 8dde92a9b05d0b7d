"""Collectives over one mesh axis, as autograd Functions: the
communication that GSPMD inserts into the reference's sharded programs,
written out.

Gradients follow one convention: a tensor that more than one rank holds
(replicated, or a partial sum) carries on each rank a *partial* gradient,
and the true gradient is the sum over those ranks. Hence

* :func:`all_gather` gathers shards along a dim; its backward
  reduce-scatters (sums the partial gradients and hands each rank its
  shard's);
* :func:`reduce_scatter` sums partial tensors and scatters the sum along a
  dim; its backward all-gathers;
* :func:`all_reduce` sums partial tensors; its backward all-reduces;
* :func:`psum_scalar` and :func:`pmax` reduce values no gradient flows
  through.

A loss that ``n`` ranks compute alike is divided by ``n`` on each before
the backward pass (``train.train_step``), and a parameter's gradient is
summed over the mesh axes its spec does not split it over.

On an axis of size 1 (a ``(1, 1)`` mesh included) every function returns
its input untouched. The backend goes with the tensor: NCCL for CUDA
tensors, gloo for CPU tensors; gloo on CUDA tensors only on a mesh made
with ``gloo_on_cuda=True``. A failed collective raises; nothing falls back
to another backend or to the host.

``torch.distributed.nn.functional`` has autograd collectives of the same
convention, but torch 2.13 deprecates them (a FutureWarning on every
call), its gather returns a list of tensors, and on gloo its gather's
backward emulates the reduce-scatter by an all-to-all and a sum: hence
the three small Functions here over the single-tensor collectives.

Inside an active ``launch.hlo.CollectiveLog`` every collective, as it is
issued, appends a :class:`Record` (its kind, mesh axis and group size,
dtype and result shape), and so does every narrowing of :func:`split`
(kind ``"split"``: no communication). Outside a log nothing is recorded.

On an abstract mesh (no process groups: ``launch.mesh.Mesh`` with names
and sizes alone) a collective takes **meta** tensors only: it records and
returns a meta tensor of its result's shape, and communicates nothing. A
CPU or CUDA tensor there raises, as ``Mesh.group`` does: nothing real
runs in place of a real collective. The pod tools (``launch/dryrun.py``)
run one rank's program of a pod's mesh this way."""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Record:
    """One collective as it was issued: ``kind`` ("all-gather",
    "reduce-scatter", "all-reduce", or "split" for a local narrowing), the
    mesh ``axis`` and its ``group`` size, and the result's dtype and
    shape (this rank's)."""

    kind: str
    axis: str
    group: int
    dtype: torch.dtype
    shape: tuple

    @property
    def result_bytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n * self.dtype.itemsize


#: The records of the active ``launch.hlo.CollectiveLog``, or None. A
#: module global, not a thread-local: the backward pass issues the
#: gathers' reduce-scatters on autograd's own thread.
_LOG = None


def install_log(records: list | None):
    """Make ``records`` the list that collectives append to (None: record
    nothing); returns the list it replaces."""
    global _LOG
    prev, _LOG = _LOG, records
    return prev


def _record(kind: str, mesh, axis: str, out: torch.Tensor) -> None:
    if _LOG is not None:
        _LOG.append(Record(kind, axis, mesh.axis_size(axis), out.dtype,
                           tuple(out.shape)))


def _abstract(mesh, x: torch.Tensor) -> bool:
    """Whether a collective of ``x`` only records: a meta tensor on an
    abstract mesh. A meta tensor on a mesh with process groups raises."""
    if not x.is_meta:
        return False
    if mesh.groups is not None:
        raise RuntimeError("a meta tensor over a mesh with process groups: "
                           "meta collectives run on an abstract mesh")
    return True


def _check(mesh, axis: str, x: torch.Tensor):
    """The axis's group, after checking that its backend may carry ``x``."""
    group = mesh.group(axis)
    backend = dist.get_backend(group)
    if x.is_cuda and backend != "nccl" and not mesh.gloo_on_cuda:
        raise RuntimeError(
            f"a CUDA tensor over the {backend} group of axis {axis!r}: gloo "
            f"carries CUDA tensors only on a mesh made with "
            f"gloo_on_cuda=True")
    if not x.is_cuda and backend == "nccl":
        raise RuntimeError(f"a CPU tensor over the nccl group of axis "
                           f"{axis!r}")
    return group


def _gather(mesh, axis, x, dim):
    abstract = _abstract(mesh, x)
    group = None if abstract else _check(mesh, axis, x)
    n = mesh.axis_size(axis)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    if not abstract:
        dist.all_gather_into_tensor(out, x, group=group)
    out = out.movedim(0, dim)
    _record("all-gather", mesh, axis, out)
    return out


def _scatter(mesh, axis, x, dim):
    abstract = _abstract(mesh, x)
    group = None if abstract else _check(mesh, axis, x)
    n = mesh.axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over axis {axis!r} of {n}")
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    if not abstract:
        dist.reduce_scatter_tensor(out, x, group=group)
    out = out.movedim(0, dim)
    _record("reduce-scatter", mesh, axis, out)
    return out


def _reduce(mesh, axis, x, op=dist.ReduceOp.SUM):
    abstract = _abstract(mesh, x)
    group = None if abstract else _check(mesh, axis, x)
    out = x.contiguous().clone()
    if not abstract:
        dist.all_reduce(out, op=op, group=group)
    _record("all-reduce", mesh, axis, out)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _gather(mesh, axis, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(*ctx.args[:2], g, ctx.args[2]), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _scatter(mesh, axis, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(*ctx.args[:2], g, ctx.args[2]), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return _reduce(mesh, axis, x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(*ctx.args, g), None, None


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def all_gather(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """Concatenate the shards of ``x`` along ``dim`` over ``axis`` (a mesh
    axis, or a tuple of them split row-major, as a spec entry)."""
    for a in reversed(_axes(axis)):
        if mesh.axis_size(a) > 1:
            x = _AllGather.apply(x, mesh, a, dim)
    return x


def reduce_scatter(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """Sum ``x`` over ``axis`` and keep this rank's shard along ``dim``."""
    for a in _axes(axis):
        if mesh.axis_size(a) > 1:
            x = _ReduceScatter.apply(x, mesh, a, dim)
    return x


def all_reduce(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Sum ``x`` over ``axis``."""
    for a in _axes(axis):
        if mesh.axis_size(a) > 1:
            x = _AllReduce.apply(x, mesh, a)
    return x


def psum_scalar(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Sum over ``axis`` with no gradient (counts, norms, reports)."""
    with torch.no_grad():
        for a in _axes(axis):
            if mesh.axis_size(a) > 1:
                x = _reduce(mesh, a, x)
    return x


def pmax(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Elementwise maximum over ``axis``, with no gradient."""
    with torch.no_grad():
        for a in _axes(axis):
            if mesh.axis_size(a) > 1:
                x = _reduce(mesh, a, x, dist.ReduceOp.MAX)
    return x


def split(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """This rank's shard of ``x`` along ``dim`` (no communication; the
    backward pads the gradient with zeros, partial by the convention)."""
    for a in _axes(axis):
        n = mesh.axis_size(a)
        if n > 1:
            size = x.shape[dim] // n
            x = x.narrow(dim, mesh.axis_index(a) * size, size)
            _record("split", mesh, a, x)
    return x
