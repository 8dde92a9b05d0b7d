"""Training launcher.

    python -m repro_torch.launch.train --arch zamba2-2.7b [--smoke] \\
        [--steps 200] [--dtype bfloat16] [--device cpu]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch zamba2-2.7b --distributed [--seq-shard] [--grad-compress]

Wires: config registry -> training model -> mesh and sharding policy
(microbatching, int8 gradient compression, sequence sharding) ->
fault-tolerant Trainer (atomic, rank-aware checkpoints, restart from the
latest, straggler watchdog) on the synthetic bigram stream. Runs on the
CUDA device unless ``--device cpu`` is given; ``--smoke`` takes the
reduced config, computed in f32; ``--dtype`` is the parameter dtype
(float32, as the reference, by default), and a config whose parameters,
gradients and f32 AdamW moments one card's free memory cannot hold is
refused before anything is allocated (``launch.memory``).
``--distributed`` joins the process group from ``torchrun``'s
environment (NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``) and
raises without it; the mesh is the reference launcher's,
``make_host_mesh()``: (ranks, 1), the state FSDP-split over ``data``.
``--seq-shard`` maps the sequence onto ``model``, as the reference's."""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..configs import get_config
from ..data import DataConfig, SyntheticLM
from ..device import resolve_device
from ..dist.sharding import Policy
from ..models import build_train
from ..train import OptConfig, TrainConfig, Trainer
from .memory import DTYPES, free_bytes, refuse_unless_fits, train_bytes
from .mesh import init_distributed, make_host_mesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config, computed in f32")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence parallelism: the sequence over 'model'")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group torchrun's environment "
                         "describes (raises without it)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                    help="the parameter dtype")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = cfg.scaled(compute_dtype=torch.float32)
    cfg = cfg.scaled(dtype=DTYPES[args.dtype])
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{args.arch}: the encoder-decoder loss needs audio frames, and "
            f"SyntheticLM's batches carry none (the reference's launcher "
            f"cannot train it either)")
    dev = (init_distributed(args.device) if args.distributed
           else resolve_device(args.device))
    mesh = make_host_mesh()
    policy = Policy(microbatches=args.microbatches,
                    grad_compress=args.grad_compress)
    if args.seq_shard:
        policy = policy.with_logical(seq=("model",))
    refuse_unless_fits(cfg, train_bytes(cfg, mesh, policy), free_bytes(dev))
    model = build_train(cfg, device=dev, mesh=mesh, policy=policy)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                  global_batch=args.global_batch))
    trainer = Trainer(
        model, mesh, policy,
        OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 5),
                  total_steps=args.steps),
        data,
        TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                    ckpt_every=max(args.steps // 4, 10)),
    )
    out = trainer.run()
    if any(mesh.coords):
        return 0
    where = f"{dev}" if mesh.size == 1 else f"{mesh.shape} ranks"
    print(f"[train] {args.arch} on {where}: step {out['final_step']} "
          f"loss {out['final_loss']:.6f} "
          f"(data floor {data.entropy_floor():.4f}); "
          f"stragglers: {len(out['straggler_events'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
