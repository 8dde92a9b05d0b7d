"""Performance hillclimbing driver over the pod roofline, the counterpart
of the reference's ``repro.launch.perf``: the same 14 named experiments
on the same three cells, policies and config deltas, priced on H100s.

Each experiment is one hypothesis -> change -> re-trace -> re-analyse
cycle: the cell's roofline (``launch/roofline.py``, traced at one
microbatch) and its dry run under the experiment's own policy
(``launch/dryrun.py``: status and temp memory). Every run replaces its
entry in ``experiments/h100/perf_log.json``: {experiment, cell,
hypothesis, note, the three terms, dominant, useful ratio, roofline
fraction, temp bytes, status}.

    python -m repro_torch.launch.perf --list
    python -m repro_torch.launch.perf --run <name> [...] [--card NAME]
    python -m repro_torch.launch.perf --all [--card NAME]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from ..dist import sharding as shd
from .dryrun import card_peaks, run_cell
from .roofline import analyze_cell

LOG = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "experiments", "h100", "perf_log.json")


def _terms(arch, shape, policy=None, cfg_overrides=None, card=None) -> dict:
    c = analyze_cell(arch, shape, policy=policy, cfg_overrides=cfg_overrides,
                     card=card, save=False)
    rec = run_cell(arch, shape, multi_pod=False, policy=policy,
                   cfg_overrides=cfg_overrides, card=card, save=False)
    temp = rec.get("memory", {}).get("temp_size_in_bytes", -1)
    return {
        "compute_s": c.compute_s, "memory_s": c.memory_s,
        "collective_s": c.collective_s, "dominant": c.dominant,
        "useful_ratio": c.useful_ratio,
        "roofline_fraction": c.roofline_fraction,
        "temp_bytes": temp, "status": rec["status"],
    }


@dataclasses.dataclass
class Experiment:
    name: str
    arch: str
    shape: str
    hypothesis: str
    policy: shd.Policy | None = None          # None -> cell default
    cfg_overrides: dict | None = None
    note: str = ""


def experiments() -> dict[str, Experiment]:
    exps = [
        # ------------ cell A: mistral-large-123b x train_4k (worst frac) --
        Experiment(
            "A0_baseline", "mistral-large-123b", "train_4k",
            "baseline (paper-faithful defaults: FSDP+TP, remat, 16 ubatch)",
        ),
        Experiment(
            "A1_no_remat", "mistral-large-123b", "train_4k",
            "remat recomputes the whole forward (~+33% GEMM FLOPs and "
            "re-reads activations); 16 microbatches already cap live "
            "activations at ~1/16, so remat off should cut the compute "
            "term ~25% and the bytes, at acceptable temp growth",
            cfg_overrides={"remat": False},
        ),
        Experiment(
            "A2_int8_grads", "mistral-large-123b", "train_4k",
            "gradient all-reduce dominates the collective term at 123B "
            "params f32; int8 compression cuts grad wire bytes 4x so the "
            "collective term should drop toward the TP all-gather floor",
            policy=dataclasses.replace(
                shd.Policy(microbatches=16, grad_compress=True)),
            note="wire-byte credit modeled at 4x on the data-axis grad "
                 "reduction (int8 payload); error feedback keeps convergence "
                 "(train/grad_compress.py)",
        ),
        Experiment(
            "A3_seq_shard", "mistral-large-123b", "train_4k",
            "residual-stream activations are replicated across 'model'; "
            "sequence-sharding them (Megatron-SP) cuts activation HBM "
            "traffic and the all-gathers around attention/mlp boundaries",
            policy=shd.Policy(microbatches=16).with_logical(
                seq=("model",)),
        ),
        Experiment(
            "A4_sp_ubatch32", "mistral-large-123b", "train_4k",
            "on top of A3's sequence sharding, doubling microbatches to 32 "
            "halves live activations again -> expect temp memory to fall "
            "toward what fits beside the shards in one card's HBM, with "
            "A3's roofline terms intact",
            policy=shd.Policy(microbatches=32).with_logical(
                seq=("model",)),
        ),
        # ------------ cell B: qwen3-moe x decode_32k (most collective) ----
        Experiment(
            "B0_baseline", "qwen3-moe-30b-a3b", "decode_32k",
            "baseline (EP over 'model', batch over 'data')",
        ),
        Experiment(
            "B1_no_ep_decode", "qwen3-moe-30b-a3b", "decode_32k",
            "at decode batch 128 the expert gathers and the combine's sums "
            "dominate; dropping EP (experts replicated: all 128 experts' "
            "f32 weights on every card) should not fit beside the KV cache "
            "-> expect a memory blowup (refutation experiment)",
            policy=shd.Policy().with_logical(experts=()),
        ),
        Experiment(
            "B2_moe_groups_batch", "qwen3-moe-30b-a3b", "decode_32k",
            "shard the MoE *group* axis over 'data' only and keep expert "
            "weights EP; routing one token-group per data shard minimizes "
            "dispatch tensor resharding",
            policy=shd.Policy().with_logical(seq=()),
            cfg_overrides=None,
            note="group sharding is already batch-major; this isolates the "
                 "seq-axis constraint effect",
        ),
        Experiment(
            "B3_bf16_dispatch", "qwen3-moe-30b-a3b", "decode_32k",
            "dispatch/combine one-hots in f32 would double the bytes they "
            "move at decode; forcing bf16 compute halves them",
            cfg_overrides={"compute_dtype": "bfloat16"},
            note="compute_dtype is already bf16 by default; this experiment "
                 "documents the no-op (confirmed control)",
        ),
        Experiment(
            "B4_ep_only_no_tp", "qwen3-moe-30b-a3b", "decode_32k",
            "B0's collective term is weight-sized, not token-sized: the "
            "TP-sharded attention and vocabulary weights are gathered at "
            "decode batch 128. Turning TP OFF for attention+vocab (weights "
            "replicated) while keeping EP should collapse the collective "
            "term to the token traffic",
            policy=shd.Policy().with_logical(
                heads=(), kv_heads=(), heads_flat=(), vocab=(), mlp=()),
        ),
        # ------------ cell C: yi-6b x train_4k (paper-representative) -----
        Experiment(
            "C0_baseline", "yi-6b", "train_4k",
            "baseline: the paper-representative training cell on the "
            "default FSDP+TP layout",
        ),
        Experiment(
            "C1_no_remat", "yi-6b", "train_4k",
            "same hypothesis as A1 at 6B scale: compute term -25%, memory "
            "bytes down (no re-read of layer inputs)",
            cfg_overrides={"remat": False},
        ),
        Experiment(
            "C2_no_fsdp", "yi-6b", "train_4k",
            "at 6B params on 256 cards, FSDP's per-layer weight all-gathers "
            "may cost more wire than replicating the parameters over 'data' "
            "(each card then holds 1/16 of the f32 weights and their AdamW "
            "state after TP) — dropping FSDP trades memory for collective "
            "volume",
            policy=dataclasses.replace(shd.Policy(microbatches=16),
                                       fsdp_axes=()),
        ),
        Experiment(
            "C3_sp", "yi-6b", "train_4k",
            "sequence-shard the residual stream over 'model' (SP): "
            "activation traffic /16 between blocks",
            policy=shd.Policy(microbatches=16).with_logical(seq=("model",)),
        ),
    ]
    return {e.name: e for e in exps}


def run_experiment(e: Experiment, card=None) -> dict:
    over = dict(e.cfg_overrides or {})
    if over.get("compute_dtype") == "bfloat16":
        over["compute_dtype"] = torch.bfloat16
    res = _terms(e.arch, e.shape, e.policy, over or None, card)
    rec = {
        "experiment": e.name, "arch": e.arch, "shape": e.shape,
        "hypothesis": e.hypothesis, "note": e.note, **res,
    }
    logs = []
    if os.path.exists(LOG):
        with open(LOG) as fh:
            logs = json.load(fh)
    logs = [r for r in logs if r["experiment"] != e.name] + [rec]
    os.makedirs(os.path.dirname(LOG), exist_ok=True)
    with open(LOG, "w") as fh:
        json.dump(logs, fh, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--run", nargs="*", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--card", default=None,
                    help="the card's name as nvidia-smi prints it (default: "
                         "the card present)")
    args = ap.parse_args(argv)
    exps = experiments()
    if args.list:
        for name, e in exps.items():
            print(f"{name:22s} {e.arch} x {e.shape}: {e.hypothesis[:60]}")
        return
    card = card_peaks(args.card)
    names = list(exps) if args.all else (args.run or [])
    for name in names:
        e = exps[name]
        print(f"== {name}: {e.arch} x {e.shape}", flush=True)
        rec = run_experiment(e, card)
        print(f"   comp {rec['compute_s']:.3e}s mem {rec['memory_s']:.3e}s "
              f"coll {rec['collective_s']:.3e}s dom={rec['dominant']} "
              f"temp {rec['temp_bytes'] / 1e9:.2f}GB status={rec['status']}",
              flush=True)


if __name__ == "__main__":
    main()
