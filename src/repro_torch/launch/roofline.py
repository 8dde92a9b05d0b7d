"""Roofline of a pod cell on H100s, from the meta-device trace of
``launch/dryrun.py``: the counterpart of the reference's
``repro.launch.roofline`` (TPU v5e). Three terms per (arch x shape x
mesh), in seconds, per card:

    compute    = Σ over dtypes of FLOPs / that dtype's peak
                 (bf16 GEMMs and K5 at bf16; f32 GEMMs at FP32; K6's
                 3xTF32 products at TF32)
    memory     = bytes / HBM bandwidth
    collective = Σ over mesh axes of the axis's wire bytes / its link

An axis is on NVLink when each of its groups lies in one 8-card node
under the mesh's row-major rank layout (``launch/mesh.py``); otherwise
it runs at the card's off-node bandwidth. Both pod meshes are off-node on
every axis; a (4, 1) mesh's data axis is NVLink.

The eager trace runs every layer, so nothing is extrapolated from small
depths (the reference's compositional L1/L2 fit exists because
``cost_analysis`` counts a scan body once). As the reference does, the
roofline traces the step at ``microbatches=1``: totals do not depend on
it. Every cell also records MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D
(MoE) for training, 2*N*D for inference, the useful-compute ratio
MODEL_FLOPS / traced FLOPs, the fraction of the bf16 compute roofline the
step reaches at the largest term, the dominant term and a lever on it.
Output: ``experiments/h100/roofline/<cell>.json`` and a markdown table.

    python -m repro_torch.launch.roofline --arch yi-6b --shape train_4k \\
        --card "NVIDIA H100 80GB HBM3"
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from ..configs import ARCH_NAMES, SHAPES, applicable
from ..dist import sharding as shd
from . import dryrun, hlo
from .constants import Peaks
from .mesh import make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "h100", "roofline")

LEVERS = {
    "compute": "reduce recompute (remat policy) / fuse; compute term is "
               "irreducible once useful_ratio ~ 1",
    "memory": "increase arithmetic intensity: larger per-card tiles, fused "
              "kernels (attention, elementwise chains), bf16 cache",
    "collective": "reshard to cut gather volume or keep the axis inside one "
                  "NVLink node / int8 gradient compression / overlap with "
                  "microbatch compute",
}


@dataclasses.dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_dev: float
    bytes_per_dev: float
    wire_per_dev: float
    model_flops: float
    #: {dtype: FLOPs}; empty means all of flops_per_dev at bf16.
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    #: {mesh axis: wire bytes}; with ``links``, {axis: bytes/s}.
    wire_by_axis: dict = dataclasses.field(default_factory=dict)
    links: dict = dataclasses.field(default_factory=dict)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    useful_ratio: float = 0.0
    roofline_fraction: float = 0.0
    lever: str = ""

    def finalize(self, peaks: Peaks):
        by_dtype = self.flops_by_dtype or {"bf16": self.flops_per_dev}
        self.compute_s = sum(f / peaks.flops_for(d)
                             for d, f in by_dtype.items())
        self.memory_s = self.bytes_per_dev / peaks.hbm_bw
        self.collective_s = sum(w / self.links[a]
                                for a, w in self.wire_by_axis.items())
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.dominant = max(terms, key=terms.get)
        total_flops = self.flops_per_dev * self.chips
        self.useful_ratio = (self.model_flops / total_flops
                             if total_flops > 0 else 0.0)
        # Fraction of the bf16 compute roofline the step reaches if it
        # runs at the largest of the three terms.
        bound = max(terms.values())
        ideal = self.model_flops / (self.chips * peaks.flops_for("bf16"))
        self.roofline_fraction = ideal / bound if bound > 0 else 0.0
        self.lever = LEVERS[self.dominant]
        return self


def axis_in_node(mesh, axis: str, cards_per_node: int) -> bool:
    """Whether every group of ``axis`` lies in one node of
    ``cards_per_node`` cards, ranks laid out row-major over the axes."""
    names, sizes = mesh.axis_names, mesh.axis_sizes
    a = names.index(axis)
    stride = 1
    for s in sizes[a + 1:]:
        stride *= s
    for rank in range(mesh.size):
        if (rank // stride) % sizes[a]:
            continue                       # not the first rank of a group
        last = rank + (sizes[a] - 1) * stride
        if rank // cards_per_node != last // cards_per_node:
            return False
    return True


def axis_links(mesh, peaks: Peaks) -> dict:
    """{axis: bytes/s}: NVLink for an axis inside one node, else the
    card's off-node bandwidth."""
    return {a: (peaks.nvlink_bw
                if axis_in_node(mesh, a, peaks.cards_per_node)
                else peaks.off_node_bw)
            for a in mesh.axis_names}


def model_flops(cfg, shape) -> float:
    n_params = (cfg.active_param_count() if cfg.family == "moe"
                else cfg.param_count())
    if shape.kind == "train":
        return 6.0 * n_params * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_params * shape.global_batch * shape.seq_len
    return 2.0 * n_params * shape.global_batch   # one token per sequence


def analyze_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                 policy: shd.Policy | None = None,
                 cfg_overrides: dict | None = None, card=None,
                 save: bool = True, out_dir: str | None = None
                 ) -> CellRoofline | None:
    """The roofline of one cell on a pod mesh, traced at
    ``microbatches=1``; None for an inapplicable cell."""
    if not applicable(arch, shape_name):
        return None
    peaks = dryrun.card_peaks(card)
    shape = SHAPES[shape_name]
    policy = policy or shd.default_policy_for(shape.kind)
    policy = dataclasses.replace(policy, microbatches=1)
    name = "pod2x16x16" if multi_pod else "pod16x16"
    mesh = make_production_mesh(multi_pod=multi_pod)
    counter, args, cfg = dryrun.build_traced(arch, shape_name, mesh, policy,
                                             cfg_overrides)
    rec = dryrun.trace_record(counter, args, peaks)
    cell = CellRoofline(
        arch=arch, shape=shape_name, mesh=name, chips=mesh.size,
        flops_per_dev=rec["flops"], bytes_per_dev=rec["bytes_accessed"],
        wire_per_dev=rec["wire_bytes"], model_flops=model_flops(cfg, shape),
        flops_by_dtype=rec["flops_by_dtype"],
        wire_by_axis={a: hlo.wire_bytes(p)
                      for a, p in rec["collectives_by_axis"].items()},
        links=axis_links(mesh, peaks),
    ).finalize(peaks)
    if save:
        out_dir = out_dir or OUT_DIR
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch}__{shape_name}__{name}.json")
        with open(path, "w") as fh:
            json.dump(dataclasses.asdict(cell), fh, indent=1)
    return cell


def table(cells: list[CellRoofline]) -> str:
    hdr = ("| arch | shape | compute_s | memory_s | collective_s | dominant "
           "| useful | roofline_frac |\n|---|---|---|---|---|---|---|---|")
    rows = [hdr]
    for c in cells:
        rows.append(
            f"| {c.arch} | {c.shape} | {c.compute_s:.3e} | {c.memory_s:.3e} "
            f"| {c.collective_s:.3e} | {c.dominant} | {c.useful_ratio:.2f} "
            f"| {c.roofline_fraction:.2f} |"
        )
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--card", default=None,
                    help="the card's name as nvidia-smi prints it (default: "
                         "the card present)")
    ap.add_argument("--out", default=None, help=f"default {OUT_DIR}")
    args = ap.parse_args(argv)
    peaks = dryrun.card_peaks(args.card)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    targets = ([(args.arch, args.shape)] if not args.all
               else [(a, s) for a in ARCH_NAMES for s in SHAPES])
    cells = []
    for arch, shape in targets:
        c = analyze_cell(arch, shape, card=peaks, out_dir=args.out)
        if c is None:
            print(f"{arch:22s} {shape:12s} skipped (inapplicable)")
            continue
        cells.append(c)
        print(f"{arch:22s} {shape:12s} dom={c.dominant:10s} "
              f"comp {c.compute_s:.2e}s mem {c.memory_s:.2e}s "
              f"coll {c.collective_s:.2e}s useful {c.useful_ratio:.2f} "
              f"roofline {c.roofline_fraction:.2f}", flush=True)
    print()
    print(table(cells))


if __name__ == "__main__":
    main()
