"""Fault-tolerant checkpointing: atomic, async, elastic.

* ATOMIC — state is serialized to ``<dir>/tmp.<name>``, fsynced, then
  renamed to ``step_<N>.npz``; a crashed save can never shadow a good one
  and partial files are ignored on restore.
* ASYNC — saves run on a background thread; the trainer never blocks on
  I/O (wait() joins at shutdown).
* ELASTIC — checkpoints store LOGICAL arrays (no device): ``restore`` puts
  each leaf on the ``device`` it is given, so a run may resume on another
  device than it was saved from.

The format and the protocol are the reference package's (``repro.ckpt``):
one ``leaf_<i>`` array per leaf of the state, leaves in the order of a
nested ``dict`` (keys sorted) / ``list`` / ``tuple`` walk, in
``step_<N:08d>.npz``. Leaves are ``torch.Tensor``s (numpy arrays and
Python scalars are taken as they are); a bfloat16 tensor, which numpy has
no type for, is stored as its raw 16-bit pattern and given its dtype back
from the tree it is restored into.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import re

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)\.npz$")


def _flatten(tree) -> list:
    """The leaves of a nested dict / list / tuple, in the reference's order:
    dict keys sorted, sequences in order, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in _flatten(sub)]
    return [tree]


def _unflatten(tree_like, leaves):
    """``tree_like``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(sub) for sub in t)
        return next(it)

    return build(tree_like)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy()
        return t.numpy().copy()
    return np.asarray(leaf)


def sweep_stale_tmp(directory: str) -> list[str]:
    """Remove ``tmp.*`` files — the orphans of a save that died between
    write and rename. Safe because every atomic writer here renames its
    tmp away before another save can start; only call this when no save
    targeting ``directory`` is in flight (manager init, post-rename gc).
    Returns the removed names (for logging/tests)."""
    removed = []
    for name in os.listdir(directory):
        if name.startswith("tmp."):
            try:
                os.remove(os.path.join(directory, name))
                removed.append(name)
            except OSError:
                pass
    return removed


def atomic_replace(path: str, write_fn, mode: str = "wb") -> None:
    """The crash-safe write protocol: serialize to ``tmp.<name>`` in the
    target's directory, flush + fsync, then atomically rename over
    ``path``. A crash at any point leaves either the old file or a stale
    ``tmp.*`` (swept by :func:`sweep_stale_tmp`) — never a partial file
    under the final name."""
    directory = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(directory, f"tmp.{os.path.basename(path)}")
    with open(tmp, mode) as fh:
        write_fn(fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def atomic_write_json(path: str, obj) -> None:
    """JSON flavor of :func:`atomic_replace` — what the round checkpoints
    of :mod:`repro_torch.dist` and the service journal use."""
    atomic_replace(path, lambda fh: json.dump(obj, fh), mode="w")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        # A previous process that died between write and rename leaves a
        # tmp.<name> forever; restore already ignores it, but the disk
        # leak compounds across crash-loops — sweep on open.
        sweep_stale_tmp(directory)
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: cf.Future | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, blocking: bool = False):
        host_leaves = [_to_host(x) for x in _flatten(tree)]  # device -> host
        self.wait()
        fut = self._pool.submit(self._write, step, host_leaves)
        self._pending = fut
        if blocking:
            self.wait()

    def _write(self, step: int, leaves: list[np.ndarray]):
        final = os.path.join(self.dir, f"step_{step:08d}.npz")
        atomic_replace(
            final,
            lambda fh: np.savez(fh, **{f"leaf_{i}": a
                                       for i, a in enumerate(leaves)}))
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self) -> None:
        """Finish the pending save and stop the save thread."""
        self.wait()
        self._pool.shutdown(wait=True)

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            try:
                os.remove(os.path.join(self.dir, f"step_{s:08d}.npz"))
            except OSError:
                pass
        # Runs on the save thread strictly after our own tmp was renamed
        # away, and saves are serialized (save() waits for the pending
        # write) — any tmp.* here is a dead prior process's leak.
        sweep_stale_tmp(self.dir)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: int | None = None, device=None):
        """Restore into the structure of ``tree_like`` (a nested dict /
        list / tuple of tensors or arrays). Leaves come back as
        ``torch.Tensor``s on ``device`` — the elastic-resume path — or,
        with ``device=None``, on the host as they were read."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}.npz")
        like = _flatten(tree_like)
        with np.load(path) as data:
            loaded = [torch.from_numpy(data[f"leaf_{i}"].copy())
                      for i in range(len(like))]
        for i, proto in enumerate(like):
            if (isinstance(proto, torch.Tensor)
                    and proto.dtype == torch.bfloat16):
                loaded[i] = loaded[i].view(torch.bfloat16)
        if device is not None:
            from ..device import resolve_device

            dev = resolve_device(device)
            loaded = [t.to(dev) for t in loaded]
        return _unflatten(tree_like, loaded), step
