"""Model-derived NoC traffic: collective volumes -> (N, N) flit-rate matrices.

`traffic_from_model(cfg, mapping, phase)` turns one (architecture x
execution phase) scenario into the same kind of directed core-to-core
traffic matrix `core.traffic` synthesizes for the paper's Rodinia-class
apps — so LLM-era workloads flow through the evaluator, the optimizers
and the agnostic study unchanged.

Volume accounting (per phase, all in bytes before normalization):

  * tensor-parallel activation all-reduces ride a bidirectional ring over
    each data replica's model group (2(k-1)/k per ring all-reduce);
  * MoE dispatch+combine is an all-to-all over the model group — the
    GPU<->GPU block structure the paper's traffic never had;
  * FSDP weight all-gathers (training) ride a ring over each model rank's
    data group; grad-sync is an f32 ring all-reduce over the same group;
  * parameter/optimizer/KV-cache traffic goes GPU <-> its home LLC bank
    (reads are response-heavy, writes request-heavy, mirroring the 1:2
    request:response split of `core.traffic`);
  * serving decode reads the whole KV context from the home banks every
    step — the many-to-few LLC-read pattern; SSM/hybrid archs read a
    constant-size SSD state instead (no KV growth);
  * a master host CPU feeds inputs and drains metrics (the §3 "master
    core" analogue), with faint background control on the other CPUs.

The result is normalized to unit sum and scaled by a per-phase injection
intensity — exactly the `core/traffic.py` relative flits/cycle convention
— and is fully deterministic (no RNG anywhere).
"""

from __future__ import annotations

import numpy as np

from ..configs.registry import ARCH_NAMES, get_config
from ..configs.shapes import SHAPES
from ..core.problem import SystemSpec
from ..core.traffic import TrafficValidationError

from .mapping import Mapping, WorkloadMesh, derive_mesh, place_model

# ------------------------------------------------------------------ phases
#: every phase a scenario can name; training phases use the train_4k shape,
#: serving phases the 32k prefill/decode shapes (configs/shapes.py).
PHASES = ("train.fwd", "train.bwd", "train.grad_sync",
          "serve.prefill", "serve.decode")

PHASE_SHAPE = {
    "train.fwd": "train_4k",
    "train.bwd": "train_4k",
    "train.grad_sync": "train_4k",
    "serve.prefill": "prefill_32k",
    "serve.decode": "decode_32k",
}

#: relative injection intensity (flits/cycle scale), in the same 0.40-0.70
#: band as the paper apps so EDP magnitudes stay comparable. grad_sync and
#: decode are the burstiest phases (pure communication / memory-bound).
PHASE_INTENSITY = {
    "train.fwd": 0.50,
    "train.bwd": 0.58,
    "train.grad_sync": 0.66,
    "serve.prefill": 0.54,
    "serve.decode": 0.62,
}

BYTES_ACT = 2.0     # bf16 activations / streamed weights / KV entries
BYTES_GRAD = 4.0    # f32 gradient + optimizer payloads
BYTES_TOKEN = 4.0   # int32 token ids
SPILL_FRAC = 0.25   # fraction of per-block residuals spilled to the LLC
WEIGHT_STREAM = 0.25  # serving: fraction of the weight shard streamed/step

SCENARIO_SEP = ":"

#: every (model x phase) scenario addressable by string, "arch:phase".
PHASE_APP_NAMES = tuple(f"{a}{SCENARIO_SEP}{p}"
                        for a in ARCH_NAMES for p in PHASES)


def scenario_name(arch: str, phase: str) -> str:
    return f"{arch}{SCENARIO_SEP}{phase}"


def parse_scenario(name: str) -> tuple[str, str]:
    """Split "arch:phase" (arch names contain no ':')."""
    arch, sep, phase = name.partition(SCENARIO_SEP)
    if not sep:
        raise TrafficValidationError(
            f"scenario {name!r} is not of the form '<arch>:<phase>'")
    check_scenario(arch, phase)
    return arch, phase


def check_scenario(arch: str, phase: str) -> None:
    if arch not in ARCH_NAMES:
        raise TrafficValidationError(
            f"unknown model {arch!r}; known: {', '.join(ARCH_NAMES)}")
    if phase not in PHASES:
        raise TrafficValidationError(
            f"unknown phase {phase!r}; known: {', '.join(PHASES)}")


# ------------------------------------------------- per-arch volume helpers
def _tp_allreduces(cfg) -> int:
    """Activation all-reduces over the model group per forward pass."""
    if cfg.family == "moe":
        return cfg.n_layers                      # attn out; MLP is all-to-all
    if cfg.family == "ssm":
        return cfg.n_layers                      # out_proj only
    if cfg.family == "hybrid":
        sites = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
        return cfg.n_layers + 2 * sites          # mamba blocks + shared attn
    if cfg.family == "encdec":
        return 2 * cfg.encoder_layers + 3 * cfg.n_layers   # self+cross+mlp
    return 2 * cfg.n_layers                      # dense/vlm: attn + mlp


def _attention_sites(cfg) -> int:
    """KV-cache-bearing attention layers (0 for pure SSM)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    if cfg.family == "encdec":
        return 2 * cfg.n_layers                  # self + cross caches
    return cfg.n_layers


def _n_blocks(cfg) -> int:
    return cfg.n_layers + cfg.encoder_layers


def _kv_bytes_per_token(cfg) -> float:
    """KV bytes appended per token across the whole model (pre-TP-shard)."""
    return 2.0 * _attention_sites(cfg) * cfg.n_kv_heads * \
        cfg.resolved_head_dim * BYTES_ACT


def _state_bytes(cfg) -> float:
    """Recurrent SSD state per sequence (SSM/hybrid; 0 otherwise)."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    return cfg.n_layers * cfg.ssm_heads * cfg.ssm_state * \
        cfg.ssm_head_dim * BYTES_ACT


# ------------------------------------------------------ flow accumulation
def _ring_edges(ids):
    ids = list(ids)
    if len(ids) < 2:
        return []
    return [(ids[i], ids[(i + 1) % len(ids)]) for i in range(len(ids))]


def _add_allreduce_ring(f, ids, nbytes):
    """Bidirectional ring all-reduce of an ``nbytes`` buffer over ``ids``:
    each participant transmits 2(k-1)/k * nbytes, split over both ring
    directions (reduce-scatter one way, all-gather the other)."""
    k = len(ids)
    if k < 2 or nbytes <= 0:
        return
    per_dir = (k - 1) / k * nbytes
    for a, b in _ring_edges(ids):
        f[a, b] += per_dir
        f[b, a] += per_dir


def _add_allgather_ring(f, ids, nbytes):
    """Ring all-gather of a buffer whose *gathered* size is ``nbytes``:
    each participant transmits (k-1)/k * nbytes, split over directions."""
    k = len(ids)
    if k < 2 or nbytes <= 0:
        return
    per_dir = (k - 1) / (2.0 * k) * nbytes
    for a, b in _ring_edges(ids):
        f[a, b] += per_dir
        f[b, a] += per_dir


def _add_all2all(f, ids, remote_bytes_per_rank):
    """All-to-all where each rank sends ``remote_bytes_per_rank`` off-chip
    total, spread uniformly over the other k-1 peers (full bipartite
    GPU<->GPU block — the MoE dispatch signature)."""
    k = len(ids)
    if k < 2 or remote_bytes_per_rank <= 0:
        return
    per_pair = remote_bytes_per_rank / (k - 1)
    for a in ids:
        for b in ids:
            if a != b:
                f[a, b] += per_pair


def _add_home(f, gpu, llc, read_bytes=0.0, write_bytes=0.0):
    """GPU <-> home-LLC: reads are response-heavy (req up, lines down),
    writes request-heavy (lines up, acks down) — the 1:4 control:data
    split keeps both directions nonzero like `core.traffic`'s 1:2."""
    f[gpu, llc] += 0.25 * read_bytes + write_bytes
    f[llc, gpu] += read_bytes + 0.25 * write_bytes


def _add_host(f, mapping: Mapping, in_bytes_per_gpu: float):
    """Master-CPU input/metric loop + faint background control CPUs."""
    master = mapping.master_cpu
    gpus = mapping.gpu_ids.ravel()
    llcs = mapping.llc_ids
    for g in gpus:
        f[master, g] += in_bytes_per_gpu
        f[g, master] += 0.10 * in_bytes_per_gpu
    # master stages the batch out of the LLC banks first
    total_in = in_bytes_per_gpu * len(gpus)
    for m in llcs:
        _add_home(f, master, m, read_bytes=total_in / len(llcs))
    # non-master CPUs: OS/control background, ~2% of the master volume
    bg = 0.02 * total_in / max(len(llcs), 1)
    for c in mapping.cpu_ids:
        if c == master:
            continue
        for m in llcs:
            f[c, m] += 0.25 * bg
            f[m, c] += bg


# --------------------------------------------------------------- generator
def traffic_from_model(cfg, mapping: Mapping, phase: str) -> np.ndarray:
    """(N, N) directed relative flit rates for ``cfg`` in ``phase``,
    placed by ``mapping``. Deterministic; normalized to sum to the
    per-phase intensity with a zero diagonal (`core/traffic.py` rules)."""
    if phase not in PHASES:
        raise TrafficValidationError(
            f"unknown phase {phase!r}; known: {', '.join(PHASES)}")
    shape = SHAPES[PHASE_SHAPE[phase]]
    dp, tp = mapping.mesh.data, mapping.mesh.model
    n = mapping.n_cpu + mapping.n_llc + mapping.n_gpu
    f = np.zeros((n, n), dtype=np.float64)

    d = cfg.d_model
    P = float(cfg.param_count())
    shard_bytes = P / (dp * tp) * BYTES_ACT     # FSDP-stored shard (train)
    if shape.kind == "decode":
        toks = shape.global_batch / dp          # one token/seq/step
    else:
        toks = shape.global_batch * shape.seq_len / dp
    act = toks * d * BYTES_ACT                  # one activation buffer/shard
    n_ar = _tp_allreduces(cfg)
    a2a_remote = 0.0
    if cfg.family == "moe" and cfg.top_k:
        a2a_remote = 2.0 * cfg.n_layers * toks * cfg.top_k * d * \
            BYTES_ACT * (tp - 1) / max(tp, 1)

    model_groups = [mapping.gpu_ids[di, :] for di in range(dp)]
    data_groups = [mapping.gpu_ids[:, mi] for mi in range(tp)]

    def home_each(read=0.0, write=0.0):
        for di in range(dp):
            for mi in range(tp):
                _add_home(f, mapping.gpu_ids[di, mi],
                          mapping.home_llc[di, mi], read, write)

    if phase == "train.fwd":
        for g in model_groups:
            _add_allreduce_ring(f, g, n_ar * act)
            _add_all2all(f, g, a2a_remote)
        for g in data_groups:
            _add_allgather_ring(f, g, P / tp * BYTES_ACT)
        # residual spill: one activation buffer per block, SPILL_FRAC evicted
        home_each(read=shard_bytes,
                  write=SPILL_FRAC * _n_blocks(cfg) * act)
        _add_host(f, mapping, toks * BYTES_TOKEN)

    elif phase == "train.bwd":
        for g in model_groups:
            _add_allreduce_ring(f, g, 2.0 * n_ar * act)   # dgrad + wgrad
            _add_all2all(f, g, 2.0 * a2a_remote)
        for g in data_groups:
            _add_allgather_ring(f, g, P / tp * BYTES_ACT)  # re-gather weights
        home_each(read=shard_bytes + SPILL_FRAC * _n_blocks(cfg) * act)
        _add_host(f, mapping, 0.10 * toks * BYTES_TOKEN)   # loss/metrics only

    elif phase == "train.grad_sync":
        for g in data_groups:
            _add_allreduce_ring(f, g, P / tp * BYTES_GRAD)
        # optimizer: read (m, v), write (m, v, params) at the home bank
        opt = P / (dp * tp) * BYTES_GRAD
        home_each(read=2.0 * opt, write=3.0 * opt)
        _add_host(f, mapping, 64.0 * BYTES_TOKEN)          # control beat

    elif phase == "serve.prefill":
        for g in model_groups:
            _add_allreduce_ring(f, g, n_ar * act)
            _add_all2all(f, g, a2a_remote)
        kv_write = _kv_bytes_per_token(cfg) / tp * toks
        state_write = _state_bytes(cfg) / tp * (shape.global_batch / dp)
        home_each(read=WEIGHT_STREAM * P / tp * BYTES_ACT,
                  write=kv_write + state_write)
        _add_host(f, mapping, toks * BYTES_TOKEN)

    else:  # serve.decode
        batch_d = shape.global_batch / dp
        for g in model_groups:
            _add_allreduce_ring(f, g, n_ar * batch_d * d * BYTES_ACT)
            _add_all2all(f, g, a2a_remote)
        kv_read = _kv_bytes_per_token(cfg) / tp * shape.seq_len * batch_d
        state = _state_bytes(cfg) / tp * batch_d
        weight = WEIGHT_STREAM * float(cfg.active_param_count()) / tp * \
            BYTES_ACT
        home_each(read=kv_read + state + weight,
                  write=_kv_bytes_per_token(cfg) / tp * batch_d + state)
        _add_host(f, mapping, batch_d * 2.0 * BYTES_TOKEN)

    np.fill_diagonal(f, 0.0)
    total = f.sum()
    if not np.isfinite(total) or total <= 0:
        raise TrafficValidationError(
            f"scenario {cfg.name}:{phase} produced a degenerate matrix "
            f"(sum={total})")
    return f / total * PHASE_INTENSITY[phase]


# ------------------------------------------------------- registry surface
def scenario_matrix(spec: SystemSpec, arch: str, phase: str,
                    mesh=None) -> np.ndarray:
    """Build the (N, N) matrix for "arch:phase" on ``spec``. ``mesh`` is an
    optional (data, model) pair; omitted -> `derive_mesh`'s default."""
    check_scenario(arch, phase)
    cfg = get_config(arch)
    if mesh is None:
        wmesh = derive_mesh(cfg, spec.n_gpu)
    else:
        try:
            wmesh = WorkloadMesh(int(mesh[0]), int(mesh[1]))
        except (TypeError, ValueError, IndexError) as e:
            raise TrafficValidationError(
                f"mesh must be a (data, model) pair of positive ints, "
                f"got {mesh!r}") from e
    try:
        mapping = place_model(spec, wmesh)
    except ValueError as e:
        raise TrafficValidationError(str(e)) from e
    return traffic_from_model(cfg, mapping, phase)


def normalize_model_traffic(spec: SystemSpec, t: dict) -> dict:
    """Validate and canonicalize a ``{"model": ...}`` traffic spec.

    Resolves an omitted mesh to the `derive_mesh` default so explicit and
    implicit spellings of the same scenario hash identically. Raises
    `TrafficValidationError` on unknown names or non-tiling meshes."""
    extra = set(t) - {"model", "phase", "mesh"}
    if extra:
        raise TrafficValidationError(
            f"unknown model-traffic keys {sorted(extra)}; "
            "allowed: model, phase, mesh")
    arch = t.get("model")
    phase = t.get("phase", "train.fwd")
    if not isinstance(arch, str):
        raise TrafficValidationError("model-traffic spec needs a 'model' name")
    check_scenario(arch, phase)
    cfg = get_config(arch)
    mesh = t.get("mesh")
    if mesh is None:
        wmesh = derive_mesh(cfg, spec.n_gpu)
    else:
        if (not isinstance(mesh, (list, tuple)) or len(mesh) != 2
                or not all(isinstance(v, int) and not isinstance(v, bool)
                           and v >= 1 for v in mesh)):
            raise TrafficValidationError(
                f"mesh must be a [data, model] pair of positive ints, "
                f"got {mesh!r}")
        wmesh = WorkloadMesh(int(mesh[0]), int(mesh[1]))
    if wmesh.n_shards != spec.n_gpu:
        raise TrafficValidationError(
            f"mesh {wmesh.data}x{wmesh.model} = {wmesh.n_shards} shards "
            f"does not tile the {spec.n_gpu}-GPU pool of this spec")
    return {"model": arch, "phase": phase,
            "mesh": (wmesh.data, wmesh.model)}
