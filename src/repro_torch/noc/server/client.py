"""Client facade + transports for the NoC-optimization service.

Two transports, one surface:

:class:`Client`
    Wraps an in-process :class:`~repro_torch.noc.server.service.NocService` —
    zero serialization overhead beyond the pure-JSON request boundary
    itself. ``drain()`` pumps the wave loop to idle.
:class:`SubprocessClient`
    Spawns ``python -m repro_torch.noc serve`` and speaks newline-delimited
    JSON over its stdin/stdout (:func:`serve_stdio` is the server side).
    The process boundary is what the crash tests need: ``kill()`` is a
    real SIGKILL, and constructing a new client against the same
    ``journal_dir`` exercises the service's recovery path for real.

Both return :class:`repro_torch.noc.api.RunResult` objects from ``result()``
and plain dicts (the service's structured responses) everywhere else.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

from ..api import RunResult

from .service import NocService, ServiceConfig


class ServerDied(RuntimeError):
    """The subprocess transport lost its server mid-call (killed or
    crashed). Re-spawn against the same journal_dir to recover."""


class Client:
    """In-process client: the facade tests and benchmarks default to."""

    def __init__(self, service: NocService):
        self.service = service

    @classmethod
    def local(cls, **cfg_kwargs) -> "Client":
        """Build a service + client in one call (kwargs =
        :class:`ServiceConfig` fields)."""
        return cls(NocService(ServiceConfig(**cfg_kwargs)))

    def submit(self, problem_json, budget_json, config_json=None, *,
               tenant: str = "default", deadline_s: float | None = None,
               request_id: str | None = None) -> dict:
        return self.service.submit(
            problem_json, budget_json, config_json, tenant=tenant,
            deadline_s=deadline_s, request_id=request_id)

    def status(self, request_id: str | None = None) -> dict:
        return self.service.status(request_id)

    def result(self, request_id: str) -> RunResult | dict:
        return self.service.result(request_id)

    def cancel(self, request_id: str) -> dict:
        return self.service.cancel(request_id)

    def step(self) -> bool:
        return self.service.step()

    def drain(self) -> dict:
        return self.service.run_until_idle()

    def close(self) -> None:
        self.service.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False


# --------------------------------------------------------------------------
# stdio protocol (server side) — newline-delimited JSON request/response
# --------------------------------------------------------------------------
def _handle(service: NocService, msg: dict) -> tuple[dict, bool]:
    """Dispatch one protocol message; returns (response, keep_running)."""
    op = msg.get("op")
    if op == "submit":
        return service.submit(
            msg.get("problem"), msg.get("budget"), msg.get("config"),
            tenant=msg.get("tenant", "default"),
            deadline_s=msg.get("deadline_s"),
            request_id=msg.get("request_id")), True
    if op == "status":
        return service.status(msg.get("id")), True
    if op == "result":
        res = service.result(msg.get("id"))
        if isinstance(res, RunResult):
            return {"result": res.to_json()}, True
        return res, True
    if op == "cancel":
        return service.cancel(msg.get("id")), True
    if op == "step":
        return {"live": service.step()}, True
    if op == "drain":
        return service.run_until_idle(), True
    if op == "shutdown":
        return {"ok": True}, False
    return {"error": {"code": "unknown_op",
                      "message": f"unknown op {op!r}"}}, True


def serve_stdio(service: NocService, stdin=None, stdout=None) -> None:
    """The ``python -m repro_torch.noc serve`` loop: one JSON request per line
    in, one JSON response per line out, until EOF or a ``shutdown`` op.
    An injected ``kill_server`` fault propagates out of ``step``/
    ``drain`` and dies the process — exactly the crash the journal
    recovers from."""
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    with service:
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except json.JSONDecodeError as exc:
                resp, keep = {"error": {"code": "bad_json",
                                        "message": str(exc)}}, True
            else:
                resp, keep = _handle(service, msg)
            stdout.write(json.dumps(resp) + "\n")
            stdout.flush()
            if not keep:
                break


# --------------------------------------------------------------------------
# subprocess transport (client side)
# --------------------------------------------------------------------------
class SubprocessClient:
    """Same surface as :class:`Client`, served by a spawned
    ``python -m repro_torch.noc serve --device <device>`` process over
    stdio JSON lines."""

    def __init__(self, journal_dir: str, *, n_workers: int = 4,
                 executor: str = "serial", max_queue: int = 16,
                 max_inflight_per_tenant: int = 2,
                 shard_timeout_s: float | None = None,
                 max_retries: int = 1, faults: tuple = (),
                 device: str = "cuda"):
        cmd = [sys.executable, "-m", "repro_torch.noc", "serve",
               "--device", device,
               "--journal-dir", journal_dir,
               "--workers", str(int(n_workers)),
               "--executor", executor,
               "--max-queue", str(int(max_queue)),
               "--tenant-cap", str(int(max_inflight_per_tenant)),
               "--max-retries", str(int(max_retries))]
        if shard_timeout_s is not None:
            cmd += ["--shard-timeout", str(float(shard_timeout_s))]
        if faults:
            cmd += ["--faults", json.dumps(list(faults))]
        env = dict(os.environ)
        src = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))))
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        self._proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, env=env)

    # ------------------------------------------------------------ plumbing
    def _rpc(self, msg: dict) -> dict:
        proc = self._proc
        if proc.poll() is not None:
            raise ServerDied(f"server exited with code {proc.returncode}")
        try:
            proc.stdin.write(json.dumps(msg) + "\n")
            proc.stdin.flush()
            line = proc.stdout.readline()
        except (BrokenPipeError, OSError) as exc:
            raise ServerDied(f"server pipe broke: {exc}") from exc
        if not line:
            raise ServerDied(
                f"server died mid-call (exit code {proc.poll()})")
        return json.loads(line)

    # -------------------------------------------------------------- surface
    def submit(self, problem_json, budget_json, config_json=None, *,
               tenant: str = "default", deadline_s: float | None = None,
               request_id: str | None = None) -> dict:
        return self._rpc({"op": "submit", "problem": problem_json,
                          "budget": budget_json, "config": config_json,
                          "tenant": tenant, "deadline_s": deadline_s,
                          "request_id": request_id})

    def status(self, request_id: str | None = None) -> dict:
        return self._rpc({"op": "status", "id": request_id})

    def result(self, request_id: str) -> RunResult | dict:
        resp = self._rpc({"op": "result", "id": request_id})
        if "result" in resp:
            return RunResult.from_json(resp["result"])
        return resp

    def cancel(self, request_id: str) -> dict:
        return self._rpc({"op": "cancel", "id": request_id})

    def step(self) -> bool:
        return bool(self._rpc({"op": "step"})["live"])

    def drain(self) -> dict:
        return self._rpc({"op": "drain"})

    def kill(self) -> None:
        """SIGKILL the server — the crash-test seam. No flush, no
        goodbye; whatever the journal holds is what recovery gets."""
        self._proc.kill()
        self._proc.wait()

    def close(self) -> None:
        if self._proc.poll() is None:
            try:
                self._rpc({"op": "shutdown"})
            except ServerDied:
                pass
            self._proc.wait(timeout=30)
        for fh in (self._proc.stdin, self._proc.stdout):
            try:
                fh.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False
