"""Bytes that the NoC kernels K1-K4 must move, by call shape, and the
card's peaks.

A kernel's roofline share is its least time on the card over its measured
time. The least time here is the bytes its inputs and outputs take, each
read once and written once, over the card's HBM bandwidth: at the
benchmark's shapes every NoC kernel is far from its compute bound.

No operation count is used for K1. The least work of an all-pairs
shortest-path computation depends on the algorithm: repeated min-plus
squaring does (log2 N + 1) N^3 adds and mins per design, Floyd-Warshall
N^3, and algorithms on sparse graphs less still. A count tied to one
algorithm would let another read above 100% of it. The bytes of an APSP
are fixed by its interface: a (B, N, N) float32 cost matrix in, a
(B, N, N) float32 distance matrix out.
"""

from __future__ import annotations

#: Published peaks of the cards the benchmark knows, by
#: ``torch.cuda.get_device_name()`` (NVIDIA's data sheet, SXM part, at the
#: full 700 W). A card not listed has no roofline share.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}

F32 = I32 = 4


def apsp_bytes(b: int, n: int) -> int:
    """K1: the (B, N, N) f32 cost matrices read, the distances written."""
    return 2 * F32 * b * n * n


def walk_bytes(b: int, n: int) -> int:
    """K4: next hops (B, N, N) i32, slot traffic (B, N, N) f32 and wire
    delays (N, N) f32 read; hop counts (B, N, N) i32, delay sums and
    directed utilisation (B, N, N) f32, router visits (B, N) f32 and one
    all-done flag per design written."""
    reads = I32 * b * n * n + F32 * b * n * n + F32 * n * n
    writes = I32 * b * n * n + 2 * F32 * b * n * n + F32 * b * n + I32 * b
    return reads + writes


def forest_bytes(n_records: int, record_bytes: int, rows: int,
                 n_features: int, n_outputs: int) -> int:
    """K2 and K3: a packed forest of ``n_records`` records read once, the
    (rows, features) f32 inputs read and ``n_outputs`` 4-byte results
    written (K2: one prediction per row; K3: the best score and its
    index)."""
    return (n_records * record_bytes + F32 * rows * n_features
            + 4 * n_outputs)


def least_seconds(n_bytes: float, card: str) -> float | None:
    """Seconds to move ``n_bytes`` at the card's HBM bandwidth, or None
    for a card without a published peak here."""
    peak = PEAKS.get(card)
    if peak is None:
        return None
    return n_bytes / peak["hbm_bytes_per_s"]
