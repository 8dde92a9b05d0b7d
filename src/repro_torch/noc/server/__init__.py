"""``repro_torch.noc.server`` — fault-tolerant multi-tenant optimization
service.

One shared worker fleet, many concurrent ``(NocProblem, Budget)``
requests, multiplexed at sync-round granularity over the pure-JSON shard
boundary::

    from repro_torch.noc.server import Client

    with Client.local(n_workers=4, journal_dir="journal/") as c:
        ack = c.submit(problem.to_json(), Budget(max_evals=400).to_json(),
                       tenant="alice")
        c.drain()
        front = c.result(ack["id"])        # RunResult

CLI: ``python -m repro_torch.noc serve --journal-dir D`` (stdio JSON lines;
:class:`SubprocessClient` is the matching client transport).

The robustness contract — admission control, backpressure, per-request
deadlines with ``partial`` degradation, fleet supervision, crash-safe
journal + recovery, canonical-key result cache — lives in
:mod:`.service`, :mod:`.admission`, and :mod:`.journal`.
"""

from .admission import (AdmissionRejected, canonical_request_key,
                        normalize_config, validate_request)
from .client import Client, ServerDied, SubprocessClient, serve_stdio
from .journal import RequestJournal
from .service import NocService, ServiceConfig

__all__ = [
    "AdmissionRejected", "Client", "NocService", "RequestJournal",
    "ServerDied", "ServiceConfig", "SubprocessClient",
    "canonical_request_key", "normalize_config", "serve_stdio",
    "validate_request",
]
