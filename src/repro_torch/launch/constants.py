"""Peaks of the card the pod tools price work on, keyed by the name that
``nvidia-smi --query-gpu=name`` (and ``torch.cuda.get_device_name``)
prints. Import-safe: the standard library only, no device is touched.

These are data-sheet figures, not measurements. The one card:

* ``"NVIDIA H100 80GB HBM3"``, the H100 SXM5 (NVIDIA H100 Tensor Core GPU
  datasheet): dense bf16 989.4 TFLOP/s and TF32 494.7 TFLOP/s on the
  tensor cores (the sheet's 1979 and 989 TFLOP/s are with sparsity),
  FP32 66.9 TFLOP/s outside them (a fused multiply-add counted as two),
  HBM3 at 3.35 TB/s, fourth-generation NVLink at 900 GB/s a card in both
  directions (450 GB/s each way). The node (NVIDIA DGX H100 user guide)
  holds 8 cards on NVSwitch, and each card's ConnectX-7 port carries
  400 Gb/s (50 GB/s) off the node.

One figure is the driver's, not the sheet's: the sheet's 80 GB of HBM3
is five 16 GiB stacks, of which the driver exposes 81 559 MiB as the
card's framebuffer (``nvidia-smi --query-gpu=memory.total``); that is
``hbm_bytes``, what a program can be given.

:func:`peaks` raises on a name it lacks: there is no default card."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Peaks:
    """One card's peaks: ``flops`` maps a dtype name ("bf16", "tf32",
    "f32", ...) to FLOP/s; bytes/s of HBM, of NVLink (one direction, per
    card) and off the node (per card); HBM bytes; cards per node."""

    name: str
    flops: dict
    hbm_bw: float
    hbm_bytes: int
    nvlink_bw: float
    cards_per_node: int
    off_node_bw: float

    def flops_for(self, dtype: str) -> float:
        """FLOP/s of ``dtype``; raises on a dtype the card has no peak
        for."""
        if dtype not in self.flops:
            raise KeyError(f"{self.name}: no peak for {dtype!r} (has "
                           f"{sorted(self.flops)})")
        return self.flops[dtype]


CARDS = {
    "NVIDIA H100 80GB HBM3": Peaks(
        name="NVIDIA H100 80GB HBM3",
        flops={"bf16": 989.4e12, "tf32": 494.7e12, "f32": 66.9e12},
        hbm_bw=3.35e12,
        hbm_bytes=81559 * 2 ** 20,
        nvlink_bw=450e9,
        cards_per_node=8,
        off_node_bw=50e9,
    ),
}


def peaks(name: str) -> Peaks:
    """The peaks of the card named ``name``."""
    if name not in CARDS:
        raise KeyError(f"no peaks for the card {name!r}; known: "
                       f"{sorted(CARDS)}")
    return CARDS[name]
