"""The port's atomic-write protocol and stores (repro_torch.ckpt,
repro_torch.dist.ckpt) against the reference's contracts
(tests/test_ckpt.py), and against the reference itself: the same bytes on
disk for the same JSON, and checkpoints that either package restores.
"""

import json
import os

import numpy as np
import pytest
import torch

import repro.ckpt as ref_ckpt
from repro_torch.ckpt import (CheckpointManager, atomic_replace,
                              atomic_write_json, sweep_stale_tmp)
from repro_torch.dist.ckpt import ROUND_STATE_FORMAT, RoundCheckpointer


# ---------------------------------------------------------------------------
# Atomic write helpers
# ---------------------------------------------------------------------------
def test_atomic_write_json_round_trips(tmp_path):
    path = tmp_path / "state.json"
    obj = {"a": [1, 2.5, None], "b": {"nested": "x"}}
    atomic_write_json(str(path), obj)
    with open(path) as fh:
        assert json.load(fh) == obj
    # No temp residue after a successful write.
    assert [n for n in os.listdir(tmp_path) if n.startswith("tmp.")] == []


@pytest.mark.parametrize("obj", [
    {"a": [1, 2.5, None], "b": {"nested": "x"}},
    {"round": 3, "pooled_y": [0.1, 1e-300, 2.0 / 3.0], "done": False},
    [{"perm": [3, 1, 0, 2], "links": [[0, 1], [2, 3]]}, "x", -0.0],
])
def test_atomic_write_json_bytes_equal_the_reference(tmp_path, obj):
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    atomic_write_json(str(ours), obj)
    ref_ckpt.atomic_write_json(str(theirs), obj)
    assert ours.read_bytes() == theirs.read_bytes()


def test_atomic_replace_crash_leaves_old_file_intact(tmp_path):
    path = tmp_path / "state.json"
    atomic_write_json(str(path), {"round": 1})

    def dies(fh):
        fh.write(b"partial garbage")
        raise RuntimeError("simulated crash mid-write")

    with pytest.raises(RuntimeError, match="mid-write"):
        atomic_replace(str(path), dies)
    # The old file is untouched; the wreck is a tmp.* orphan.
    with open(path) as fh:
        assert json.load(fh) == {"round": 1}
    assert [n for n in os.listdir(tmp_path)
            if n.startswith("tmp.")] == ["tmp.state.json"]
    # ... which the sweep removes.
    assert sweep_stale_tmp(str(tmp_path)) == ["tmp.state.json"]
    assert [n for n in os.listdir(tmp_path) if n.startswith("tmp.")] == []


def test_sweep_spares_non_tmp_files(tmp_path):
    (tmp_path / "tmp.orphan").write_text("x")
    (tmp_path / "round_000001.json").write_text("{}")
    (tmp_path / "tmpnotdot").write_text("x")  # no "tmp." prefix: kept
    assert sweep_stale_tmp(str(tmp_path)) == ["tmp.orphan"]
    assert sorted(os.listdir(tmp_path)) == ["round_000001.json", "tmpnotdot"]


# ---------------------------------------------------------------------------
# CheckpointManager on torch tensors
# ---------------------------------------------------------------------------
def _state(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(3, 4, generator=g),
            "layers": [{"b": torch.arange(5, dtype=torch.int32) + seed},
                       {"b": torch.randn(2, generator=g)
                        .to(torch.bfloat16)}],
            "step": torch.tensor(seed, dtype=torch.int64)}


def _like(state):
    return {"w": torch.zeros(3, 4),
            "layers": [{"b": torch.zeros(5, dtype=torch.int32)},
                       {"b": torch.zeros(2, dtype=torch.bfloat16)}],
            "step": torch.zeros((), dtype=torch.int64)}


def _assert_same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_manager_sweeps_stale_tmp_on_init(tmp_path):
    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "tmp.00000007").write_bytes(b"dead prior process")
    mgr = CheckpointManager(str(d), keep=2)
    assert [n for n in os.listdir(d) if n.startswith("tmp.")] == []
    # Saves still work and gc keeps sweeping.
    (d / "tmp.00000009").write_bytes(b"another orphan")
    mgr.save(1, {"w": torch.ones(3)}, blocking=True)
    assert [n for n in os.listdir(d) if n.startswith("tmp.")] == []
    restored, step = mgr.restore({"w": torch.zeros(3)})
    assert step == 1 and torch.equal(restored["w"], torch.ones(3))
    mgr.close()


def test_checkpoint_manager_round_trips_a_nested_tree(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in range(4):
        mgr.save(step, _state(step))       # async: each waits for the last
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    restored, step = mgr.restore(_like(_state(0)))
    assert step == 3
    _assert_same(restored, _state(3))
    older, step = mgr.restore(_like(_state(0)), step=2, device="cpu")
    assert step == 2
    _assert_same(older, _state(2))
    mgr.close()
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        CheckpointManager(str(tmp_path / "empty")).restore({"w": 0})


def test_checkpoint_restore_to_cuda_raises_without_a_card(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"w": torch.ones(2)}, blocking=True)
    if torch.cuda.is_available():
        restored, _ = mgr.restore({"w": torch.zeros(2)}, device="cuda")
        assert restored["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mgr.restore({"w": torch.zeros(2)}, device="cuda")
    mgr.close()


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The same npz layout: a port checkpoint restores in the reference
    and a reference checkpoint in the port, leaf for leaf."""
    g = torch.Generator().manual_seed(0)
    state = {"w": torch.randn(3, 4, generator=g),
             "layers": [torch.arange(6, dtype=torch.int32).reshape(2, 3),
                        torch.ones(2, dtype=torch.float64)]}
    ours = CheckpointManager(str(tmp_path / "ours"))
    ours.save(5, state, blocking=True)
    ours.close()
    theirs = ref_ckpt.CheckpointManager(str(tmp_path / "ours"))
    like_np = {"w": np.zeros((3, 4), np.float32),
               "layers": [np.zeros((2, 3), np.int32), np.zeros(2)]}
    got, step = theirs.restore(like_np)
    assert step == 5
    np.testing.assert_array_equal(np.asarray(got["w"]), state["w"].numpy())
    for a, b in zip(got["layers"], state["layers"]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    ref_mgr = ref_ckpt.CheckpointManager(str(tmp_path / "theirs"))
    ref_mgr.save(2, {k: (v.numpy() if k == "w" else [t.numpy() for t in v])
                     for k, v in state.items()}, blocking=True)
    back, step = CheckpointManager(str(tmp_path / "theirs")).restore(
        {"w": torch.zeros(3, 4),
         "layers": [torch.zeros(2, 3, dtype=torch.int32),
                    torch.zeros(2, dtype=torch.float64)]})
    assert step == 2
    _assert_same(back, state)


# ---------------------------------------------------------------------------
# RoundCheckpointer
# ---------------------------------------------------------------------------
def test_round_checkpointer_save_load_gc(tmp_path):
    ck = RoundCheckpointer(str(tmp_path), keep=2)
    for r in range(4):
        ck.save_round(r, {"alive": [0, 1], "spent_evals": {"0": r}})
    # keep=2: only the last two rounds survive gc.
    assert ck.rounds() == [2, 3]
    assert ck.latest_round() == 3
    state = ck.load_round()
    assert state["round"] == 3 and state["format"] == ROUND_STATE_FORMAT
    assert state["spent_evals"] == {"0": 3}
    assert ck.load_round(2)["spent_evals"] == {"0": 2}
    assert ck.n_saves == 4 and ck.save_s > 0.0


def test_round_checkpointer_files_equal_the_reference(tmp_path):
    from repro.dist.ckpt import RoundCheckpointer as RefRoundCheckpointer

    ours = RoundCheckpointer(str(tmp_path / "ours"))
    theirs = RefRoundCheckpointer(str(tmp_path / "theirs"))
    state = {"alive": [0, 2], "pooled_y": [0.5, 1.0 / 3.0], "done": True}
    ours.save_round(7, state)
    theirs.save_round(7, state)
    assert ((tmp_path / "ours" / "round_000007.json").read_bytes()
            == (tmp_path / "theirs" / "round_000007.json").read_bytes())
    assert RefRoundCheckpointer(str(tmp_path / "ours")).load_round() \
        == ours.load_round()


def test_round_checkpointer_sweeps_and_validates(tmp_path):
    (tmp_path / "tmp.round_000000.json").write_text("dead write")
    ck = RoundCheckpointer(str(tmp_path))
    assert [n for n in os.listdir(tmp_path) if n.startswith("tmp.")] == []
    # Empty dir: resume is a loud error, not a silent fresh start.
    with pytest.raises(FileNotFoundError, match="nothing to resume"):
        ck.load_round()
    # Unknown format: refused, not misread.
    with open(tmp_path / "round_000005.json", "w") as fh:
        json.dump({"format": 999, "round": 5}, fh)
    with pytest.raises(ValueError, match="format"):
        ck.load_round(5)
    with pytest.raises(ValueError, match="keep"):
        RoundCheckpointer(str(tmp_path), keep=0)
