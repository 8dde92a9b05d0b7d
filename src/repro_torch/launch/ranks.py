"""Run a function on ``world`` local ranks, each a spawned process in one
``torch.distributed`` group, and collect what each returns.

    results = spawn_ranks(fn, 2, args, backend="gloo", store_dir=d)

The group starts from a ``FileStore`` in ``store_dir`` (no port to pick);
``fn(rank, world, *args)`` runs after ``init_process_group`` and its
return value comes back pickled through a file there. The whole group has
``timeout`` seconds: a rank that hangs is killed and the call raises, as
it raises when a rank fails. ``fn`` must be importable by the spawned
children (a module-level function)."""

from __future__ import annotations

import os
import pickle
import time
import traceback
from datetime import timedelta

import torch.multiprocessing as mp


def _child(rank, world, fn, args, backend, store_dir, timeout):
    import torch.distributed as dist

    out = os.path.join(store_dir, f"rank{rank}.pkl")
    try:
        store = dist.FileStore(os.path.join(store_dir, "store"), world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=timeout))
        try:
            result = ("ok", fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(out + ".tmp", "wb") as fh:
        pickle.dump(result, fh)
    os.replace(out + ".tmp", out)


def spawn_ranks(fn, world: int, args: tuple = (), *, backend: str = "gloo",
                store_dir: str, timeout: float = 120.0) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks; the list of
    their return values, rank by rank. Raises when a rank raises, dies or
    outlives ``timeout`` seconds (the others are then killed)."""
    os.makedirs(store_dir, exist_ok=True)
    ctx = mp.start_processes(_child, args=(world, fn, args, backend,
                                           store_dir, timeout),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} did not "
                                   f"finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    results = []
    for rank in range(world):
        with open(os.path.join(store_dir, f"rank{rank}.pkl"), "rb") as fh:
            status, value = pickle.load(fh)
        if status != "ok":
            raise RuntimeError(f"rank {rank} of {fn.__name__} failed:\n"
                               f"{value}")
        results.append(value)
    return results
