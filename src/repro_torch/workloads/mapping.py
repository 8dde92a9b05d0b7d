"""Placing a model's logical mesh onto a SystemSpec's heterogeneous tiles.

The serving stack describes *logical* parallelism — a (data, model) device
mesh, with expert parallelism riding the model axis
(the launch-layer default: "EP over 'model', batch over 'data'"). The NoC
problem describes *physical* cores: CPUs `[0, C)`, LLCs `[C, C+M)`, GPUs
`[C+M, N)` (`core.problem`). This module is the bridge:

  * every (data, model) shard of the logical mesh is hosted by one GPU
    core (row-major: shard (d, m) -> GPU index d*model + m);
  * every shard gets a *home LLC* — the bank holding its parameter shard,
    optimizer state, and KV-cache pages (round-robin over the LLC banks by
    shard index, the address-interleaving stand-in);
  * CPU 0 is the master host core (input pipeline + optimizer driver, the
    §3 "master core" analogue); remaining CPUs carry background control.

Traffic matrices built on top of a :class:`Mapping`
(`workloads.traffic_model`) are in CORE-ID space — the evaluator's
placement permutation decides which physical slot each core occupies, so
one mapping serves every candidate design.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.problem import SystemSpec


@dataclasses.dataclass(frozen=True)
class WorkloadMesh:
    """Logical 2D device mesh (data x model); EP rides the model axis."""

    data: int
    model: int

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(
                f"mesh axes must be >= 1, got data={self.data} "
                f"model={self.model}")

    @property
    def n_shards(self) -> int:
        return self.data * self.model

    def to_json(self) -> list:
        return [self.data, self.model]


#: model-parallel degree is capped (wider TP than 8 buys little and the
#: paper-scale GPU pools are small); the real bound is head count.
TP_CAP = 8


def derive_mesh(cfg, n_gpu: int) -> WorkloadMesh:
    """Deterministic default mesh for ``cfg`` on an ``n_gpu``-tile pool.

    The model axis is the largest divisor of ``n_gpu`` not exceeding
    min(TP_CAP, shardable heads) — attention heads for transformers,
    SSD heads for Mamba-family configs; the data axis takes the rest.
    """
    heads = max(int(cfg.n_heads), int(getattr(cfg, "ssm_heads", 0) or 0), 1)
    cap = max(1, min(TP_CAP, heads))
    tp = max(d for d in range(1, cap + 1) if n_gpu % d == 0)
    return WorkloadMesh(data=n_gpu // tp, model=tp)


@dataclasses.dataclass(frozen=True)
class Mapping:
    """A placed model: logical shards bound to physical core ids."""

    mesh: WorkloadMesh
    n_cpu: int
    n_llc: int
    n_gpu: int
    gpu_ids: np.ndarray    # (data, model) int — GPU core id hosting shard
    home_llc: np.ndarray   # (data, model) int — LLC core id homing shard
    master_cpu: int        # host-loop master core id (always 0)

    @property
    def cpu_ids(self) -> np.ndarray:
        return np.arange(self.n_cpu)

    @property
    def llc_ids(self) -> np.ndarray:
        return np.arange(self.n_cpu, self.n_cpu + self.n_llc)


def place_model(spec: SystemSpec, mesh: WorkloadMesh) -> Mapping:
    """Bind every (data, model) shard to a GPU core and a home LLC bank.

    Raises ``ValueError`` when the mesh does not tile the GPU pool exactly
    — a shard without a host core has no physical traffic interpretation.
    """
    if mesh.n_shards != spec.n_gpu:
        raise ValueError(
            f"mesh {mesh.data}x{mesh.model} = {mesh.n_shards} shards does "
            f"not tile the {spec.n_gpu}-GPU pool of this spec")
    C, M = spec.n_cpu, spec.n_llc
    idx = np.arange(mesh.n_shards).reshape(mesh.data, mesh.model)
    gpu_ids = C + M + idx
    home_llc = C + (idx % M)
    return Mapping(mesh=mesh, n_cpu=C, n_llc=M, n_gpu=spec.n_gpu,
                   gpu_ids=gpu_ids, home_llc=home_llc, master_cpu=0)
