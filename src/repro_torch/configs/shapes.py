"""Assigned input shapes and the (arch x shape) cell matrix.

  train_4k     seq_len=4096    global_batch=256  (training)
  prefill_32k  seq_len=32768   global_batch=32   (inference prefill)
  decode_32k   seq_len=32768   global_batch=128  (decode: ONE new token
                                                  against a seq_len KV cache)
  long_500k    seq_len=524288  global_batch=1    (long-context decode)

long_500k requires sub-quadratic attention: it RUNS for the SSM/hybrid archs
(constant-size state) and is SKIPPED for pure full-attention archs — the
skip list and rationale live in DESIGN.md §6.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}

# Archs whose decode state is O(1) in context length (SSD state / hybrid).
SUBQUADRATIC = ("mamba2-1.3b", "zamba2-2.7b")

# Whisper's decoder target length is capped (the audio axis carries seq_len).
WHISPER_MAX_TARGET = 448


def applicable(arch_name: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_name in SUBQUADRATIC
    return True


def all_cells(arch_names) -> list[tuple[str, str]]:
    """Every (arch, shape) cell; inapplicable cells are listed with skip
    reasons by cell_status()."""
    return [(a, s) for a in arch_names for s in SHAPES]


def cell_status(arch_name: str, shape_name: str) -> str:
    if applicable(arch_name, shape_name):
        return "run"
    return "skip: full quadratic attention cannot serve a 512k context " \
           "(task rules; DESIGN.md §6)"
