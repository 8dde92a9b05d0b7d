"""Collective accounting for the roofline's third term, under the
reference's name (``repro.launch.hlo``) so a reader finds the
counterpart. The port has no HLO: its collectives are recorded as they
are issued (``dist.collectives``, inside a :class:`CollectiveLog`), each
with its kind, mesh axis and group size, dtype and result shape (this
rank's). The wire rules are the reference's, per device, ring
algorithm:

    all-reduce        2 x R          (reduce-scatter + all-gather phases)
    all-gather        R              (result is the gathered, full tensor)
    reduce-scatter    R x n          (operand is the full tensor)
    all-to-all        R
    collective-permute R

with R the result's bytes and n the group size; the (n-1)/n ring factor
is folded to 1. The port issues no all-to-all or collective-permute (its
MoE dispatch is the reference's dense einsum, its shards gathered by
all-gather); the schema keeps all five kinds. A ``split`` (a rank
narrowing a whole tensor to its shard) is logged and carries no bytes.

The op log of ``launch.dryrun.Counter`` stands in for the HLO text of
:func:`count_ops`."""

from __future__ import annotations

from ..dist import collectives as col

_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")


def wire(kind: str, result_bytes: int, n: int) -> float:
    """Ring wire bytes per device of one collective."""
    if kind == "all-reduce":
        return 2.0 * result_bytes
    if kind == "reduce-scatter":
        return float(result_bytes * n)
    if kind in _KINDS:
        return float(result_bytes)
    return 0.0


class CollectiveLog:
    """Collects a :class:`dist.collectives.Record` for every collective
    issued inside ``with CollectiveLog() as log:`` (``log.records``)."""

    def __init__(self):
        self.records: list = []
        self._prev = None

    def __enter__(self) -> "CollectiveLog":
        self._prev = col.install_log(self.records)
        return self

    def __exit__(self, *exc) -> None:
        col.install_log(self._prev)


def _records(log) -> list:
    return log.records if isinstance(log, CollectiveLog) else list(log)


def parse_collectives(log) -> dict:
    """{kind: {count, result_bytes, wire_bytes}} over a log's records (a
    :class:`CollectiveLog` or a list of records), the reference's schema
    and five kinds."""
    out = {k: {"count": 0, "result_bytes": 0, "wire_bytes": 0.0}
           for k in _KINDS}
    for r in _records(log):
        if r.kind not in out:
            continue
        rbytes = r.result_bytes
        out[r.kind]["count"] += 1
        out[r.kind]["result_bytes"] += rbytes
        out[r.kind]["wire_bytes"] += wire(r.kind, rbytes, r.group)
    return out


def wire_bytes(parsed: dict) -> float:
    return float(sum(v["wire_bytes"] for v in parsed.values()))


def wire_by_axis(log) -> dict:
    """{mesh axis: wire bytes per device} over a log's records."""
    out: dict = {}
    for r in _records(log):
        w = wire(r.kind, r.result_bytes, r.group)
        if r.kind in _KINDS:
            out[r.axis] = out.get(r.axis, 0.0) + w
    return out


def count_ops(trace, opname: str) -> int:
    """How many ops of the op log ``trace`` (a ``launch.dryrun.Counter``
    or its ``ops`` list of names such as ``"aten.mm.default"``) are
    ``opname``: a whole name, or its packet (``"aten.mm"``)."""
    ops = getattr(trace, "ops", trace)
    return sum(1 for o in ops
               if o == opname or o.startswith(opname + "."))
