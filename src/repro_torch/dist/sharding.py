"""The training policy of the reference's ``repro.dist.sharding`` on one
card: microbatching and int8 gradient compression.

The reference's module also maps logical activation axes onto a device
mesh and builds the parameter, batch and KV-cache PartitionSpecs that its
jitted steps shard with (``param_specs``, ``batch_specs``,
``cache_specs``, ``activation_shard_fn``, ``_fit``, ``named``, the logical
map and ``with_logical``). One card has no mesh, so none of that is
ported: the port's training runs the whole model on one device. They are
listed in ROADMAP.md under multi-card training."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Policy:
    """Gradient accumulation over ``microbatches`` slices of each batch,
    and int8 gradient compression with error feedback."""

    microbatches: int = 1
    grad_compress: bool = False
