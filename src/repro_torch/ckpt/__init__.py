from .checkpoint import (CheckpointManager, atomic_replace, atomic_write_json,
                         sweep_stale_tmp)

__all__ = ["CheckpointManager", "atomic_replace", "atomic_write_json",
           "sweep_stale_tmp"]
