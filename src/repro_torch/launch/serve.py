"""Serving launcher: batched greedy generation with the KV-cache engine.

    python -m repro_torch.launch.serve --arch zamba2-2.7b --batch 8 \\
        --prompt-len 512 --new 16 [--dtype bfloat16] [--smoke] [--device cpu]
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch mistral-large-123b --dtype bfloat16 [--tp]

Runs on the CUDA device unless ``--device cpu`` is given. Weights are
random, drawn from a seeded ``torch.Generator``; prompts from a seeded
numpy generator. ``--dtype`` is the parameter dtype (float32, as the
reference, by default). Under ``torchrun`` each process joins the process
group (NCCL on its card, gloo with ``--device cpu``) and the engine runs
on the reference launcher's mesh, ``make_host_mesh()``: (ranks, 1), the
weights FSDP-split over ``data`` and each rank serving its rows of the
batch. ``--tp`` keeps tensor parallelism at decode; without it the
attention, MLP and vocabulary are replicated and the experts stay
expert-parallel, as in the reference. Before building, the launcher
reckons one card's bytes of weights and decode cache and refuses a config
the card's free memory cannot hold (``launch.memory``)."""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..dist.sharding import serve_policy
from ..models import build
from ..serve import Engine, ServeConfig
from .memory import DTYPES, free_bytes, refuse_unless_fits, serve_bytes
from .mesh import init_distributed, launched, make_host_mesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config, computed in f32")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                    help="the parameter dtype")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--tp", action="store_true",
                    help="keep tensor parallelism at decode (default: "
                         "expert parallelism only, as the reference's)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = cfg.scaled(compute_dtype=torch.float32)
    cfg = cfg.scaled(dtype=DTYPES[args.dtype])
    if cfg.family == "encdec":
        raise SystemExit("use a decoder-only arch for this launcher "
                         "(whisper serving needs audio frames)")
    dev = (init_distributed(args.device) if launched()
           else resolve_device(args.device))
    mesh = make_host_mesh()
    policy = serve_policy(args.tp)
    max_len = args.prompt_len + args.new + 8
    refuse_unless_fits(cfg, serve_bytes(cfg, args.batch, max_len, mesh,
                                        policy), free_bytes(dev))
    model = build(cfg, seed=0, device=dev, mesh=mesh, policy=policy)
    engine = Engine(model, mesh, policy, None,
                    ServeConfig(max_new_tokens=args.new, max_len=max_len))
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    out = engine.generate(prompts)
    dt = time.perf_counter() - t0
    st = engine.stats
    if any(mesh.coords):
        return 0
    where = f"{dev}" if mesh.size == 1 else f"{mesh.shape} ranks"
    print(f"[serve] {args.arch} on {where}: batch {args.batch}, {args.new} new "
          f"tokens each, {out.size / dt:.1f} tok/s; prefill "
          f"{st['prefill_s'] * 1e3:.1f} ms, decode "
          f"{st['decode_s'] * 1e3 / max(st['decode_steps'], 1):.2f} ms per "
          f"step")
    print(f"[serve] sample: {out[0][:12].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
