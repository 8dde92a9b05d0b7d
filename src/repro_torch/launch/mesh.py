"""Device meshes, the reference's ``repro.launch.mesh`` over
``torch.distributed``.

A :class:`Mesh` names its axes and their sizes, as a JAX mesh does, and
gives this process its coordinate on each axis and the process group of
each axis. The ranks of the world are laid out row-major over the axes
(rank ``d * model + m`` on a ``("data", "model")`` mesh), as
``jax.make_mesh`` lays out its devices.

* :func:`make_host_mesh` is the mesh of the processes ``torchrun`` started:
  ``(world // model_axis, model_axis)`` over ``("data", "model")``. In one
  process with no process group it is a ``(1, 1)`` mesh that needs none,
  and every collective on it is skipped.
* :func:`make_production_mesh` keeps the reference's pod shapes, ``(16,
  16)`` and ``(2, 16, 16)``, as an abstract mesh: names and sizes, no
  processes. The spec builders of ``dist.sharding`` read it.
* :func:`init_distributed` starts the process group from the launcher's
  environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
  ``LOCAL_RANK``): NCCL for a CUDA device, gloo for the CPU. Without that
  environment it raises; nothing runs as one rank unasked.

Creating the axis groups is collective: every rank of the world calls
``Mesh.distributed`` with the same shape."""

from __future__ import annotations

import dataclasses
import os

import torch

#: The environment ``torchrun`` gives each process.
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes; with ``groups``, this rank's coordinates and
    the process group of each axis of size > 1. ``backend`` is the groups'
    backend ("nccl" or "gloo"); ``gloo_on_cuda`` says that the caller asked
    by name for gloo collectives on CUDA tensors."""

    axis_names: tuple
    axis_sizes: tuple
    coords: tuple = ()
    groups: dict | None = None
    backend: str | None = None
    gloo_on_cuda: bool = False

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError("one size per axis name")
        if not self.coords:
            object.__setattr__(self, "coords", (0,) * len(self.axis_names))

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh lacks."""
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``; 0 for an axis the mesh
        lacks."""
        if axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of ``axis`` for this rank; None where the axis
        has size 1 (nothing to communicate)."""
        if self.axis_size(axis) == 1:
            return None
        if self.groups is None:
            raise RuntimeError(f"the abstract mesh {self.shape} has no "
                               f"process groups to communicate over")
        return self.groups[axis]

    @classmethod
    def distributed(cls, shape: tuple, names: tuple, *,
                    gloo_on_cuda: bool = False) -> "Mesh":
        """The mesh of the initialized world over ``names`` with sizes
        ``shape`` (their product the world size), this rank's coordinates
        and one process group per axis of size > 1."""
        import torch.distributed as dist

        world, rank = dist.get_world_size(), dist.get_rank()
        n = 1
        for s in shape:
            n *= s
        if n != world:
            raise ValueError(f"mesh {dict(zip(names, shape))} has {n} "
                             f"ranks, the world {world}")
        backend = dist.get_backend()
        coords, r = [], rank
        for s in reversed(shape):
            coords.append(r % s)
            r //= s
        coords = tuple(reversed(coords))
        strides = [1] * len(shape)
        for i in range(len(shape) - 2, -1, -1):
            strides[i] = strides[i + 1] * shape[i + 1]
        groups = {}
        for a, (name, size) in enumerate(zip(names, shape)):
            if size == 1:
                continue
            # Every rank creates every group of the axis, in one order.
            others = [range(s) if i != a else [0]
                      for i, s in enumerate(shape)]
            for base in _product(others):
                ranks = [sum(c * st for c, st in zip(base, strides))
                         + j * strides[a] for j in range(size)]
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[name] = g
        return cls(tuple(names), tuple(shape), coords, groups, backend,
                   gloo_on_cuda)


def _product(lists):
    out = [()]
    for lst in lists:
        out = [o + (v,) for o in out for v in lst]
    return out


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's pod meshes as abstract meshes (no processes)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(model_axis: int = 1, *, gloo_on_cuda: bool = False
                   ) -> Mesh:
    """``(world // model_axis, model_axis)`` over ``("data", "model")``:
    the initialized world's ranks, or a one-rank ``(1, 1)`` mesh with no
    process group when none is initialized."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        if model_axis != 1:
            raise ValueError(f"a model axis of {model_axis} needs "
                             f"{model_axis} ranks; no process group is "
                             f"initialized")
        return Mesh(("data", "model"), (1, 1))
    world = dist.get_world_size()
    if world % model_axis:
        raise ValueError(f"a world of {world} does not split into a model "
                         f"axis of {model_axis}")
    if world == 1:
        return Mesh(("data", "model"), (1, 1), backend=dist.get_backend(),
                    gloo_on_cuda=gloo_on_cuda)
    return Mesh.distributed((world // model_axis, model_axis),
                            ("data", "model"), gloo_on_cuda=gloo_on_cuda)


def launched() -> bool:
    """Whether this process was started by a launcher (``torchrun``)."""
    return all(k in os.environ for k in LAUNCH_ENV)


def init_distributed(device: str | torch.device | None = None
                     ) -> torch.device:
    """Start the process group from the launcher's environment and return
    this rank's device: ``cuda:LOCAL_RANK`` with NCCL, or the CPU with gloo
    when ``device`` is ``"cpu"``. Raises without the environment."""
    import torch.distributed as dist

    missing = [k for k in LAUNCH_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed needs the launcher's environment (torchrun sets "
            f"{', '.join(LAUNCH_ENV)}); missing {', '.join(missing)}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed on CUDA, and no CUDA device is "
                               "available; pass --device cpu for gloo")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    return dev
