"""The port stands alone: it imports neither JAX nor the reference package,
and its entry points run on a CUDA device unless asked for the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.evaluate import Evaluator
from repro_torch.core.problem import spec_tiny
from repro_torch.core.traffic import traffic_matrix
from repro_torch.noc import NocProblem, named_spec, run

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(\.|\s+import\b))",
    re.MULTILINE)


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.noc, repro_torch.core, "
        "repro_torch.convert\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ref\n"
        "import repro_torch.noc.cli, repro_torch.noc.parity\n"
        "import repro_torch.workloads, repro_torch.core.netsim\n"
        "import repro_torch.core.amosa, repro_torch.core.nsga2\n"
        "import repro_torch.core.pcbb, repro_torch.core.agnostic\n"
        "import repro_torch.core.phv_torch\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.serve\n"
        "import repro_torch.models.transformer, repro_torch.launch.serve\n"
        "import repro_torch.ckpt, repro_torch.dist, repro_torch.noc.server\n"
        "import repro_torch.dist.worker, repro_torch.noc.server.client\n"
        "import repro_torch.data, repro_torch.train, repro_torch.launch.train\n"
        "import repro_torch.dist.sharding, repro_torch.train.train_step\n"
        "import repro_torch.launch.mesh, repro_torch.launch.ranks\n"
        "import repro_torch.dist.collectives, repro_torch.models.parallel\n"
        "import repro_torch.launch.memory, repro_torch.train.grad_compress\n"
        "import repro_torch.launch.constants, repro_torch.launch.hlo\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
        "import repro_torch.launch.perf\n"
        "from repro_torch.configs import input_specs\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                          "PATH": "/usr/bin:/bin"},
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_of_the_port_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    assert ROOT / "src" / "repro_torch" / "models" / "transformer.py" in files
    for mod in ("train/trainer.py", "train/train_step.py",
                "train/optimizer.py", "train/grad_compress.py",
                "data/pipeline.py", "dist/sharding.py", "launch/train.py",
                "launch/mesh.py", "launch/ranks.py", "dist/collectives.py",
                "models/parallel.py", "launch/memory.py",
                "launch/constants.py", "launch/hlo.py", "launch/dryrun.py",
                "launch/roofline.py", "launch/perf.py"):
        assert ROOT / "src" / "repro_torch" / mod in files
    for path in files:
        hits = FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path}: {hits}"


def test_forbidden_import_pattern():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "from repro.core import y", "import repro.noc",
                 "  from repro import noc"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import y",
                 "from .routing import x", "# import jax is not done here"):
        assert not FORBIDDEN.search(line), line


def test_entry_points_default_to_cuda():
    spec = spec_tiny()
    f = traffic_matrix(spec, "BFS")
    if torch.cuda.is_available():
        ev = Evaluator(spec, f)
        assert ev.f.device.type == "cuda"
        assert ev.consts.vadj.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Evaluator(spec, f)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            NocProblem(spec=named_spec("tiny")).evaluator()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(NocProblem(spec=named_spec("tiny")), "stage")
    ev_cpu = Evaluator(spec, f, device="cpu")
    assert ev_cpu.f.device.type == "cpu"
    assert np.all(np.isfinite(ev_cpu(spec.mesh_design())))


def test_serving_entry_points_default_to_cuda():
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main
    from repro_torch.models import build
    from repro_torch.dist.sharding import Policy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_config("zamba2-2.7b", smoke=True).scaled(
        compute_dtype=torch.float32)
    if torch.cuda.is_available():
        assert build(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(build(cfg), make_host_mesh(), Policy(), None,
                   ServeConfig())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--arch", "zamba2-2.7b", "--smoke"])
    model = build(cfg, device="cpu")
    assert model.device.type == "cpu"
    assert all(b.device.type == "cpu" for b in model.buffers())
    out = Engine(model, make_host_mesh(), Policy(), None,
                 ServeConfig(max_new_tokens=2)).generate(
        np.ones((1, 4), np.int32))
    assert out.shape == (1, 2)


def test_training_entry_points_default_to_cuda(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist.sharding import Policy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import main
    from repro_torch.models import build_train
    from repro_torch.train import OptConfig, TrainConfig, Trainer

    cfg = get_config("yi-6b", smoke=True).scaled(compute_dtype=torch.float32)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=8,
                                  global_batch=2))
    tcfg = TrainConfig(steps=1, ckpt_dir=str(tmp_path / "t"))
    if torch.cuda.is_available():
        assert build_train(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_train(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(build_train(cfg), make_host_mesh(), Policy(),
                    OptConfig(), data, tcfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--arch", "yi-6b", "--smoke", "--steps", "1",
                  "--ckpt-dir", str(tmp_path / "l")])
    model = build_train(cfg, device="cpu")
    out = Trainer(model, make_host_mesh(), Policy(), OptConfig(), data,
                  tcfg).run()
    assert out["final_step"] == 1
    assert all(p.device.type == "cpu" for p in
               out["state"]["params"]["layers"]["attn"].values())
