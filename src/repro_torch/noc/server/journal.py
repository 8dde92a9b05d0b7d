"""Crash-safe request journal for the NoC-optimization service.

Layout, one directory per request under the journal root::

    <root>/req_<seq>/request.json     admission record + status
    <root>/req_<seq>/result.json      final RunResult (done/partial only)
    <root>/req_<seq>/rounds/          per-request RoundCheckpointer state

Every write goes through :func:`repro_torch.ckpt.atomic_write_json` (tmp →
fsync → rename), so a server killed mid-write leaves either the old
record or a stale ``tmp.*`` — never a torn file. Stale tmps are swept on
open, in the root *and* in every request directory (the checkpoint
stores' sweep, applied with parity to the journal). The journal is the
service's whole recovery story: a restarted server lists it, re-queues
``queued`` requests, restores ``running`` ones from their round
checkpoints, and reloads ``done``/``partial`` results into the cache —
replaying nothing that already completed.

Completed requests keep their ``request.json``/``result.json`` forever
(they are the cache), but their ``rounds/`` checkpoints are dead weight
once the result exists — :meth:`RequestJournal.gc_completed` keeps the
last ``keep_completed`` requests' rounds as a debugging window and
deletes the rest.
"""

from __future__ import annotations

import json
import os
import re
import shutil

from ...ckpt import atomic_write_json, sweep_stale_tmp

_REQ_RE = re.compile(r"^req_(\d+)$")

#: bump when the request-record schema changes incompatibly.
REQUEST_FORMAT = 1

#: request lifecycle states. ``queued`` and ``running`` survive a server
#: restart as live work; the rest are terminal.
STATUSES = ("queued", "running", "done", "partial", "error", "cancelled")
TERMINAL = ("done", "partial", "error", "cancelled")


class RequestJournal:
    """Atomic per-request record + checkpoint store."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        sweep_stale_tmp(directory)
        for seq in self.seqs():
            # Parity with the checkpoint dirs: a crash between a request
            # record's tmp write and its rename leaves the orphan here.
            sweep_stale_tmp(self.req_dir(seq))

    # --------------------------------------------------------------- paths
    def req_dir(self, seq: int) -> str:
        return os.path.join(self.dir, f"req_{int(seq):06d}")

    def rounds_dir(self, seq: int) -> str:
        return os.path.join(self.req_dir(seq), "rounds")

    def _request_path(self, seq: int) -> str:
        return os.path.join(self.req_dir(seq), "request.json")

    def _result_path(self, seq: int) -> str:
        return os.path.join(self.req_dir(seq), "result.json")

    # ------------------------------------------------------------- queries
    def seqs(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _REQ_RE.match(name)
            if m and os.path.isdir(os.path.join(self.dir, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def next_seq(self) -> int:
        seqs = self.seqs()
        return (seqs[-1] + 1) if seqs else 0

    # --------------------------------------------------------------- write
    def save_request(self, rec: dict) -> None:
        """Persist the admission record (atomic). ``rec`` must carry
        ``seq`` and a valid ``status``; ``format`` is stamped here."""
        status = rec.get("status")
        if status not in STATUSES:
            raise ValueError(f"status must be one of {STATUSES}, "
                             f"got {status!r}")
        seq = int(rec["seq"])
        os.makedirs(self.req_dir(seq), exist_ok=True)
        payload = dict(rec)
        payload["format"] = REQUEST_FORMAT
        atomic_write_json(self._request_path(seq), payload)

    def save_result(self, seq: int, result_json: dict) -> None:
        # The result may be committed before the request record (it is
        # the commit point — see NocService._finalize) — make the dir.
        os.makedirs(self.req_dir(seq), exist_ok=True)
        atomic_write_json(self._result_path(seq), result_json)

    # ---------------------------------------------------------------- read
    def load_request(self, seq: int) -> dict:
        with open(self._request_path(seq)) as fh:
            rec = json.load(fh)
        fmt = rec.get("format")
        if fmt != REQUEST_FORMAT:
            raise ValueError(
                f"request record {self._request_path(seq)!r} has format "
                f"{fmt!r}; this service reads format {REQUEST_FORMAT}")
        return rec

    def load_result(self, seq: int) -> dict | None:
        path = self._result_path(seq)
        if not os.path.exists(path):
            return None
        with open(path) as fh:
            return json.load(fh)

    def load_all(self) -> list[dict]:
        """Every request record, seq order — the recovery scan. A request
        directory whose ``request.json`` never made it to disk (crash
        between mkdir and the atomic rename) is skipped: nothing was
        admitted, there is nothing to resume."""
        out = []
        for seq in self.seqs():
            try:
                out.append(self.load_request(seq))
            except FileNotFoundError:
                continue
        return out

    # ----------------------------------------------------------------- gc
    def gc_completed(self, keep: int = 4) -> list[int]:
        """Delete the ``rounds/`` checkpoints of terminal requests beyond
        the newest ``keep`` (records and results are kept — they are the
        cache). Returns the gc'd seqs, for logging/tests."""
        if keep < 0:
            raise ValueError(f"keep must be >= 0, got {keep}")
        done = [int(rec["seq"]) for rec in self.load_all()
                if rec.get("status") in TERMINAL]
        removed = []
        for seq in done[: max(0, len(done) - keep)]:
            rounds = self.rounds_dir(seq)
            if os.path.isdir(rounds):
                shutil.rmtree(rounds, ignore_errors=True)
                removed.append(seq)
        return removed
