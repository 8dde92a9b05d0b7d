"""Serving launcher: batched greedy generation with the KV-cache engine.

    python -m repro_torch.launch.serve --arch zamba2-2.7b --batch 8 \\
        --prompt-len 512 --new 16 [--dtype bfloat16] [--smoke] [--device cpu]

Runs on the CUDA device unless ``--device cpu`` is given. Weights are
random, drawn from a seeded ``torch.Generator``; prompts from a seeded
numpy generator. ``--dtype`` is the parameter dtype (float32, as the
reference, by default); before building, the launcher reckons the bytes of
the weights and the decode cache and refuses a config the card's free
memory cannot hold (``launch.memory``)."""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import build
from ..serve import Engine, ServeConfig
from .memory import DTYPES, free_bytes, refuse_unless_fits, serve_bytes


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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = cfg.scaled(compute_dtype=torch.float32)
    cfg = cfg.scaled(dtype=DTYPES[args.dtype])
    if cfg.family == "encdec":
        raise SystemExit("use a decoder-only arch for this launcher "
                         "(whisper serving needs audio frames)")
    dev = resolve_device(args.device)
    max_len = args.prompt_len + args.new + 8
    refuse_unless_fits(cfg, serve_bytes(cfg, args.batch, max_len),
                       free_bytes(dev))
    model = build(cfg, seed=0, device=dev)
    engine = Engine(model, ServeConfig(max_new_tokens=args.new,
                                       max_len=max_len))
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    out = engine.generate(prompts)
    dt = time.perf_counter() - t0
    st = engine.stats
    print(f"[serve] {args.arch} on {dev}: batch {args.batch}, {args.new} new "
          f"tokens each, {out.size / dt:.1f} tok/s; prefill "
          f"{st['prefill_s'] * 1e3:.1f} ms, decode "
          f"{st['decode_s'] * 1e3 / max(st['decode_steps'], 1):.2f} ms per "
          f"step")
    print(f"[serve] sample: {out[0][:12].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
