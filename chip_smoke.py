#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
``nvcc``. Imports nothing of JAX or of the JAX package ``repro``. Phases,
each raising on failure:

  1. header: the card's name and power limit, torch and CUDA versions; the
     kernels built from ``src/repro_torch/csrc`` (build seconds, ``-Xptxas
     -v`` registers, spills and shared memory), and the tensor-core
     instructions (HMMA, HGMMA) in each library's SASS, which must be there
     for K5 and K6;
  2. every kernel against its plain PyTorch version on the card (and the
     host numpy mirrors where the port has them); K2 and K3 bit-equal on
     forests of 24, 10 and 1 trees, of depth 0, and one large enough to
     take the L2 route, at B = 1 to 1500, with ties at lane, block and
     cluster edges and ten back-to-back calls;
  3. the main path: MOO-STAGE on spec_64 under the paper's BFS traffic,
     case5, 2000 evaluations, through ``repro_torch.noc.run`` on the card,
     with the launches of each kernel counted over that run alone;
     3b. the multi-start search (``stage_batch``, 4 starts) on the same
     problem, with 40 local steps (K1 and K4 launched; the first local
     searches spend the budget) and with 4 (the meta search runs: K1-K4
     launched), each front re-evaluated on the CPU; spec_tiny
     ``stage_batch``, seeds 0/1/2, card against CPU;
  4. card against CPU end to end on spec_tiny, seeds 0/1/2: the default
     search at 300 evaluations, and MOO-STAGE over several local and meta
     searches (4 local steps, 500 evaluations) on the host and the fused
     meta path, with K2 (and on the fused path K3) launched on every card
     run. Card-against-CPU searches must give the same front and
     accounting, or part at a knife-edge: the same designs up to the
     parting, rows within rtol 1e-5, and the card run replayed on the
     CPU's rows is the CPU run bit for bit (``repro_torch.noc.parity``);
  5. the evaluator's delta path on the card, bit-equal to the dense path,
     three neighbourhoods each on spec_64 and spec_large (N = 256);
  6. each kernel timed at its main-path shapes beside its plain version and
     its bound, printed as one JSON ``kernels`` line; K1–K4 also by the
     profiler's device time per call, which below ~20 us is the honest
     reading (events then time the wrapper's host work); K3 checked to run
     one kernel per call, and K2/K3 probed at every cluster size and route;
  7. one more main-path run under torch.profiler: device busy time, the
     device's idle share, the kernels that take the most time, and each
     NoC kernel's device time and launches in that run;
  8. the two LLM kernels (K5 attention, K6 SSD) against their plain
     versions on the card at the serving path's shapes and at ragged,
     GQA, windowed, bidirectional and f32 ones, qwen3-moe's prefill and
     whisper-base's encoder (and K6 with a partial last
     head group), each run twice and bit-identical;
  9. the serving path: zamba2-2.7b at full width (random weights from a
     seeded generator) generating 16 tokens for 8 prompts of 512 through
     ``repro_torch.serve.Engine``, with the launches of K5 and K6 counted
     over that run alone; its prefill against the same prefill through the
     plain versions on the card (next-token argmax equal on every row);
     the smoke-size hybrid on card and CPU;
 10. K5 and K6 timed at phase 9's shapes beside their plain versions, their
     bounds and (K5) PyTorch's own attention call, and one prefill and one
     ``generate`` under torch.profiler;
 11. the baselines AMOSA, NSGA-II and PCBB on phase 3's problem at 500
     evaluations (K1 and K4 launched in each, fronts re-evaluated on the
     CPU, PCBB stopped by the budget guard with a front); the NSGA-II rank
     and the PHV device twins against their host versions; the
     application-agnostic study on spec_36 (BFS, BP, CDN, HS); MOO-STAGE
     under yi-6b decode traffic and the trace link report of its min-EDP
     design (one K4 call per phase, each held against its plain version,
     the report against the CPU's); the flit simulator on spec_64 (host
     numpy). The ``kernels`` JSON line lists all six kernels;
 12. the fleet (``repro_torch.dist``, ``repro_torch.noc.server``) on
     phase 3's problem: the spawn cost of a pool of four children;
     ``stage_dist`` with four workers at 2000 evaluations under the
     ``serial``, ``process`` and ``cuda`` executors, equal merged results,
     K1–K4 counted on the in-process executors; spec_tiny W=3 card against
     CPU, each worker held by ``noc.parity``; a run killed after round 1
     and resumed from its round checkpoint, byte-identical to the
     uninterrupted run; three requests of two tenants through the service
     on a process fleet (a deadline's partial front, a duplicate served
     from the cache) and the chaos drill of tests/test_server_chaos.py on
     spec_36 with a spawned server on the card killed and restarted,
     byte-identical to a fleet never killed; the ``spmd`` evaluator's
     split rows against the serial evaluator's, and ``stage_dist`` under
     ``spmd`` against ``serial``;
 13. training (``repro_torch.train``), after phase 9's serving model is
     released: (a) the K5/K6 autograd Functions at phase 8's shapes, a
     windowed GQA attention and a ragged SSD (S = 100): forward bit-equal
     to the wrappers with one launch, none in backward, every input
     gradient against autograd through the plain version on the card;
     (b) zamba2-2.7b at full width (f32 master weights, bf16 compute,
     remat), 4 steps of 8 x 512 synthetic tokens through the step function
     ``Trainer.run`` calls, K5/K6 launches counted per step (forward +
     remat recompute), step 0's loss against the plain versions on the
     same weights, peak memory, warm step ms and tokens/s, and one step
     under torch.profiler (K5, K6, the GEMMs, the plain backward and the
     optimizer named); (c) zamba2 and yi-6b smoke in f32 from one initial
     state: 20 ``Trainer.run`` steps card against CPU, a card run crashed
     after step 12 and resumed from its step-8 checkpoint against the
     uninterrupted one, and the train launcher on the card;
 14. MoE and encoder-decoder serving, after phase 13's state is released:
     (a) qwen3-moe-30b-a3b at full width (48 layers, 128 experts top-8,
     bf16 parameters with the router in f32: 61 GB; the only cut) serving
     8 prompts of 512 for 16 new tokens through ``Engine``, with K5's 48
     launches counted over one generate, two generates equal, peak memory
     under 70 GB, the (token, choice) pairs layer 0's capacity drops, and
     the prefill against the same prefill through the plain attention
     (logits within 5% of scale; argmax equal on every row but at most one
     knife-edge row, whose plain top-2 margin is under the max |logit
     diff|); a prefill and a generate under torch.profiler, with the MoE
     layer's ranges (route, dispatch, experts, combine); (b) whisper-base
     at full width on 8 x 1500 seeded stub frames, 8-token prompts and 32
     new tokens by ``build(...).prefill`` and a greedy ``decode_step``
     loop: 6 K5 launches (the encoder's), two generates equal, the encoder
     states against the plain version; (c) the qwen3-moe, moonshot and
     whisper smoke configs in f32: tokens card = CPU, and one
     ``build_train`` loss of qwen3-moe and of whisper card against CPU
     (1e-5); (d) K5 timed at the two new shapes (phase 8 holds it against
     its plain version there) beside its plain version, SDPA and its bound;
     every decode step of phases 9 and 14 makes no host sync (PyTorch's
     sync debug mode);
 15. the five architectures no card run had reached, each model freed
     before the next is built: (a) deepseek-coder-33b at full width with
     bf16 parameters (66.69 GB) through ``Engine``, 8 prompts of 512 and 16
     new tokens (62 K5 launches); (b) chameleon-34b (the vlm family, bf16)
     through the serve launcher's own entry point (``launch.serve.main``
     with ``--dtype bfloat16``: 48 K5 launches), then mistral-large-123b
     refused by the launcher before it allocates anything (245.2 GB even
     in bf16); (c) gemma3-1b (f32 parameters, bf16 compute) on prompts of
     2048, past its 512-token window (22 windowed and 4 global K5
     launches), its windowed decode held against a prefill of the same
     tokens after decode steps 1, 8 and 16; (d) mamba2-1.3b (48 K6
     launches, the plain recurrent decode), the SSM states its prefill
     hands to decode against the plain chunked form's. For (a), (c) and
     (d): two generates equal, no host sync in a decode step, and the
     prefill against the same prefill through the plain versions (argmax
     equal on every row but at most one knife-edge row); peak memory.
     (e) all five smoke configs in f32: tokens and three train steps'
     losses card against CPU. Then K5 at the new shapes (phase 8 holds
     them against the plain version) beside SDPA, and K6 at mamba2's. The
     ``kernels`` line counts phase 15's launches in K5's and K6's;
 16. the multi-card path (``launch.mesh``, ``dist.sharding``,
     ``dist.collectives``, ``models.parallel``): (a) a one-rank NCCL
     group and ``make_host_mesh()``'s (1, 1) mesh: zamba2-2.7b served
     through ``Engine(model, mesh, Policy(), None, cfg)`` at phase 9's
     shape, tokens and K5/K6 launches bit-equal to the meshless engine's
     and no host sync in a decode step; two training steps at phase 13's
     shape with and without the mesh, losses bit-equal; the train launcher
     with ``--distributed`` on the group; (b) two spawned ranks sharing
     the card over gloo, named (``gloo_on_cuda=True``): yi-6b in bf16 on
     (1, 2) with ``--tp`` and on (2, 1) with FSDP, qwen3-moe-30b-a3b cut
     to 4 layers with EP on (1, 2), prefill logits against one rank's at
     phase 9's bar; two zamba2-2.7b training steps on (2, 1) with FSDP,
     losses within 1e-5 of one rank's with two microbatches (the rows each
     rank takes); (c) with ``--cards 4`` only: ``torchrun
     --nproc-per-node 4`` of the serve launcher for mistral-large-123b in
     bf16 on (4, 1) (prefill and decode ms, host syncs per decode step,
     peak GB a card) and of two zamba2-2.7b training steps against one
     card's with four microbatches. The ``kernels`` line counts (a)'s and
     (b)'s launches;
 17. the pod tools (``launch.{constants,hlo,dryrun,roofline,perf}``): (a)
     the card's name and power limit, its peaks from ``launch.constants``
     by the name the card reports, its ``total_memory`` within 1% of the
     table's HBM bytes; (b) zamba2-2.7b's prefill at phase 9's 8 x 512 on
     the (1, 1) host mesh traced on the meta device, then run on the card
     under the same counter: op counts, GEMM FLOPs by dtype and the K5/K6
     records equal, bytes within 1%, the meta trace's peak live bytes
     against the rise of ``max_memory_allocated``, and the prefill's time
     without the counter against its roofline bound; (c) phase 16 (b)'s
     yi-6b --tp on (1, 2): each rank's collective log (kind, axis, group,
     dtype, shape) of a prefill and a decode step traced on meta equal to
     that rank's over gloo; (d) the perf driver's baseline cells A0, B0
     and C0 on the pod16x16 mesh at full width (dry run status and the
     three roofline terms), in a subprocess beside (a)-(c). The ``kernels``
     line counts (b)'s and (c)'s launches.

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it. ``--only-phase16`` builds the kernels and runs phase
16 alone (with ``--cards 4``, (c) too); ``--only-phase17`` runs phase 17
alone.

    python3 chip_smoke.py --compare-kernels DIR

times K1 (one evaluator call's APSP), K2, K3 and K4 at phase 6's shapes
and K5 and K6 at the serving shapes, and the decode ms per step of
zamba2-2.7b, qwen3-moe-30b-a3b (bf16) and whisper-base at full width,
from another checkout ``DIR`` (for
example the parent commit, unpacked with ``git archive``) beside this
one's, each in a fresh process, in the order DIR, this, this, DIR: device
time over 10 back-to-back calls, one call between two events, and the
profiler's device time per call (with the kernels per call). Each tree
builds its NoC inputs and its forest from the same seed through its own
``routing``, ``objectives`` and ``forest``, then runs phase 3's main path
twice (wall seconds, front and PHV).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, bf16
#: and TF32 dense on the tensor cores, and HBM3 bandwidth, at the full
#: 700 W power limit.
PEAK_FP32_FLOPS = 67e12
#: FP32 instructions per second outside the tensor cores: the 67 TFLOP/s
#: peak counts a fused multiply-add as two flops. An add and a min (K1) are
#: two instructions, and so is any other pair of f32 operations.
PEAK_FP32_INSTR = PEAK_FP32_FLOPS / 2
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12

#: The kernels of the NoC main path (phase 3) and of the serving and
#: training paths (phases 9 and 13).
NOC_KERNELS = ("minplus", "forest_predict", "score_block_max", "walk")
#: The CUDA functions behind each NoC wrapper, as the profiler names them.
NOC_SYMBOLS = {
    "minplus": ("apsp_kernel", "minplus_kernel"),
    "forest_predict": ("forest_predict_cluster_kernel",),
    "score_block_max": ("score_block_max_cluster_kernel",),
    "walk": ("walk_tree_kernel", "walk_util_kernel"),
}
#: The redesigned NoC kernels' bars, in ms of device time per call at
#: phase 6's shapes, and over the phase 7 run of the main path.
NOC_BAR_MS = {"minplus": 0.02, "walk": 0.05, "forest_predict": 0.004,
              "score_block_max": 0.006}
NOC_TRACE_BAR_MS = {"minplus": 1.5, "walk": 3.0}
LLM_KERNELS = ("flash_attention", "ssd")

#: Tolerances of the LLM kernels against their plain versions (the
#: reference's own, tests/test_kernels.py): attention in bf16 / f32, SSD.
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
SSD_TOL = 2e-4
#: The K5 and K6 times at the serving shapes that the tensor-core designs
#: are held to, in ms (printed as met or missed in phase 10).
ATTN_BAR_MS = 0.30
SSD_BAR_MS = 0.35
#: The serving path's prefill, kernels against plain versions on the card:
#: largest |logit difference| allowed, as a share of the largest |logit|.
#: Both run the bf16 model; they differ by bf16 roundings of attention and
#: SSD outputs that 54 layers carry forward.
PREFILL_REL_TOL = 0.05


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, warmup: int = 5, reps: int = 20, inner: int = 10) -> float:
    """Device time of one call: the median over ``reps`` rounds of CUDA
    event time across ``inner`` back-to-back calls, divided by ``inner``.
    Queued calls hide the host's work per call wherever the device's work
    is longer."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def time_ms_per_call(fn, warmup: int = 5, reps: int = 50) -> float:
    """Median time of one call between two CUDA events, the host's work for
    that call included where the device waits for it."""
    return time_ms(fn, warmup, reps, inner=1)


_PROFILER_WARM = []


def warm_profiler(torch) -> None:
    """Open and close one throwaway torch.profiler session, once per process.
    The first session of a process sets up CUPTI's activity tracing while it
    runs and can miss a kernel record (phase 6 once saw 9 of K3's 10
    launches): the sessions that measure come after this one."""
    from torch.profiler import ProfilerActivity, profile

    if _PROFILER_WARM:
        return
    x = torch.zeros(1024, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(10):
            x.add_(1.0)
        torch.cuda.synchronize()
    _PROFILER_WARM.append(True)


def profiled(torch, fn, calls: int = 10, warmup: int = 3):
    """The CUDA kernels that ``calls`` back-to-back calls of ``fn`` run, as
    torch.profiler reads them: [(name, device ms in total, launches)]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    warm_profiler(torch)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_ms_per_call(torch, fn, symbols, calls: int = 10) -> float | None:
    """Device time of one call of ``fn`` by the profiler, counting only the
    kernels whose names hold one of ``symbols``; None when the profiler saw
    none of them (not measured)."""
    rows = [r for r in profiled(torch, fn, calls)
            if any(sym in r[0] for sym in symbols)]
    return sum(r[1] for r in rows) / calls if rows else None


def bound(n_bytes: float, n_ops: float,
          peak_ops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def trace_main_path(torch, fn, untraced_wall: float,
                    untraced_name: str = "phase 3's run (which includes "
                                         "first-use set-up)",
                    label: str = "trace",
                    symbols: dict | None = None,
                    ranges: dict | None = None) -> dict:
    """Device time of one more run of ``fn`` under torch.profiler: the sum
    of kernel times, the device's idle share of the traced run's and of an
    untraced run's wall time, and the kernels that take most of it. Returns
    {name: (device ms, launches)} for each entry of ``symbols`` (a wrapper
    name and the CUDA functions behind it) and of ``ranges`` (a name and
    the host-side ranges whose kernels it sums: an autograd node, a
    ``record_function`` span; launches are the range's calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    warm_profiler(torch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    events = prof.key_averages()
    host = [e for e in events if e.device_type != DeviceType.CUDA]
    # A record_function range also shows on the device's timeline, under
    # its host name: it is not a kernel.
    host_keys = {e.key for e in host}
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.key not in host_keys]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if not kern:
        print(f"{label}: the profiler saw no device time (not measured)")
        return {}
    print(f"{label}: device busy {busy_ms:.3f} ms over {len(kern)} kernel "
          f"names; device idle share {1 - busy_ms / (traced_wall * 1e3):.4f} "
          f"of the traced run's {traced_wall * 1e3:.1f} ms wall, "
          f"{1 - busy_ms / (untraced_wall * 1e3):.4f} of "
          f"{untraced_name}: {untraced_wall * 1e3:.1f} ms")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")
    totals = {}
    for name, syms in (symbols or {}).items():
        rows = [e for e in kern if any(sym in e.key for sym in syms)]
        totals[name] = (sum(e.self_device_time_total for e in rows) / 1e3,
                        sum(e.count for e in rows))
        print(f"  {name}: {totals[name][0]:.3f} ms of device time over "
              f"{totals[name][1]} kernel launches ({', '.join(syms)})")
    for name, keys in (ranges or {}).items():
        ms = calls = 0
        for key in keys:
            # A node's range and the engine's range around it both hold its
            # kernels: take the outer (larger) one.
            rows = [e for e in host if key in e.key]
            if rows:
                top = max(rows, key=lambda e: e.device_time_total)
                ms += top.device_time_total / 1e3
                calls += top.count
        totals[name] = (ms, calls)
        print(f"  {name}: {ms:.3f} ms of device time under {calls} host "
              f"ranges ({', '.join(keys)})")
    return totals


# ------------------------------------------------------ LLM slice (8-10)
#: (B, H, KH, S, D, causal, window, dtype): the serving path's shape first.
ATTN_CASES = (
    (8, 32, 32, 512, 80, True, None, "bfloat16"),   # zamba2 prefill
    (2, 32, 4, 512, 128, True, None, "bfloat16"),   # GQA (yi / mistral)
    (2, 4, 1, 1024, 256, True, 512, "bfloat16"),    # gemma3 sliding window
    (2, 8, 2, 333, 80, True, None, "float32"),      # off every tile, f32
    (1, 4, 4, 200, 32, False, None, "float32"),     # bidirectional, f32
    (2, 8, 2, 333, 80, True, None, "bfloat16"),     # off every tile, GQA
    (1, 4, 4, 200, 32, False, None, "bfloat16"),    # bidirectional
    (8, 32, 4, 512, 128, True, None, "bfloat16"),   # qwen3-moe prefill
    (8, 8, 8, 1500, 64, False, None, "bfloat16"),   # whisper-base encoder
    (8, 56, 8, 512, 128, True, None, "bfloat16"),   # deepseek-coder prefill
    (8, 64, 8, 512, 128, True, None, "bfloat16"),   # chameleon prefill
    (8, 4, 1, 2048, 256, True, 512, "bfloat16"),    # gemma3 local, 8 x 2048
    (8, 4, 1, 2048, 256, True, None, "bfloat16"),   # gemma3 global
    # Phase 16, a rank's share: yi-6b's heads under --tp on (1, 2), its
    # rows on (2, 1); zamba2 training's rows on (2, 1) and on four cards;
    # mistral-large-123b's prefill row on four cards.
    (8, 16, 2, 512, 128, True, None, "bfloat16"),
    (4, 32, 4, 512, 128, True, None, "bfloat16"),
    (4, 32, 32, 512, 80, True, None, "bfloat16"),
    (2, 32, 32, 512, 80, True, None, "bfloat16"),
    (1, 96, 8, 16, 128, True, None, "bfloat16"),
)
#: The K5 shapes phase 14 (qwen3-moe, whisper) and phase 15 (deepseek,
#: chameleon, gemma3's local and global layers) time.
ATTN_PHASE14 = ATTN_CASES[7:9]
ATTN_PHASE15 = ATTN_CASES[9:13]
#: (B, S, H, P, N, chunk): the serving path's shape first.
SSD_CASES = (
    (8, 512, 80, 64, 64, 64),   # zamba2 prefill, one mamba layer
    (2, 300, 8, 64, 128, 64),   # padded tail (mamba2-1.3b's N)
    (2, 40, 8, 64, 64, 40),     # S < 64: one short chunk
    (2, 128, 7, 64, 64, 64),    # H = 7: a last head group of one head
    (2, 200, 8, 64, 16, 64),    # N = 16
    (4, 512, 80, 64, 64, 64),   # phase 16: zamba2 training, a rank's rows
    (2, 512, 80, 64, 64, 64),   # on (2, 1) and on four cards
    (8, 512, 64, 64, 128, 64),  # mamba2-1.3b prefill: K6's largest N
)


def attn_inputs(torch, case, dev, seed=0):
    b, h, kh, s, d, _, _, dtype = case
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dt)
                 for shape in ((b, h, s, d), (b, kh, s, d), (b, kh, s, d)))


def ssd_inputs(torch, case, dev, seed=0):
    b, s, h, p, n, _ = case
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=g, device=dev)) * 0.1
    a = -torch.exp(torch.randn(h, generator=g, device=dev) * 0.3)
    bm = torch.randn((b, s, n), generator=g, device=dev) * 0.5
    cm = torch.randn((b, s, n), generator=g, device=dev) * 0.5
    d = torch.full((h,), 0.5, device=dev)
    return x, dt, a, bm, cm, d


def llm_kernels_vs_plain(torch, ops, ref, dev) -> dict[str, float]:
    """Phase 8: K5 and K6 against their plain versions, two runs each
    bit-identical. Returns the max |err| of each kernel."""
    errs = {"flash_attention": 0.0, "ssd": 0.0}
    for case in ATTN_CASES:
        b, h, kh, s, d, causal, window, dtype = case
        q, k, v = attn_inputs(torch, case, dev)
        out = ops.attention(q, k, v, causal=causal, window=window)
        out2 = ops.attention(q, k, v, causal=causal, window=window)
        plain = ref.attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((out.float() - plain.float()).abs().max())
        check(out.dtype == q.dtype, f"attention {case}: output {out.dtype}")
        check(err <= ATTN_TOL[dtype], f"attention {case}: |err| {err} > "
              f"{ATTN_TOL[dtype]}")
        check(torch.equal(out, out2), f"attention {case}: two runs differ")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        print(f"K5 attention B={b} H={h} KH={kh} S={s} D={d} causal={causal}"
              f" window={window} {dtype}: max |err| {err:.3g} (tolerance "
              f"{ATTN_TOL[dtype]}), two runs bit-identical")
    for case in SSD_CASES:
        b, s, h, p, n, chunk = case
        args = ssd_inputs(torch, case, dev)
        y, st = ops.ssd(*args, chunk=chunk, return_state=True)
        y2, st2 = ops.ssd(*args, chunk=chunk, return_state=True)
        py, pst = ref.ssd_padded_ref(*args, chunk=chunk, return_state=True)
        torch.cuda.synchronize()
        err = max(float((y - py).abs().max()), float((st - pst).abs().max()))
        check(err <= SSD_TOL, f"ssd {case}: |err| {err} > {SSD_TOL}")
        check(torch.equal(y, y2) and torch.equal(st, st2),
              f"ssd {case}: two runs differ")
        errs["ssd"] = max(errs["ssd"], err)
        print(f"K6 ssd B={b} S={s} H={h} P={p} N={n} chunk={chunk}: max |err|"
              f" {err:.3g} over y and the final state (tolerance {SSD_TOL}), "
              f"two runs bit-identical")
    return errs


def serve_full_width(torch, ops, ref, dev) -> dict:
    """Phase 9: zamba2-2.7b at full width served through the Engine, with
    K5/K6 launches counted over one generate; its prefill against the plain
    versions on the card; the smoke config on card and CPU."""
    import numpy as np

    from repro_torch.dist.sharding import Policy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_config("zamba2-2.7b")
    batch, prompt_len, new = 8, 512, 16
    t0 = time.perf_counter()
    model = build(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in model.buffers())
    print(f"zamba2-2.7b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params} parameters (the config's analytic count: "
          f"{cfg.param_count()}), built in {time.perf_counter() - t0:.1f} s")
    engine = Engine(model, make_host_mesh(), Policy(), None,
                    ServeConfig(max_new_tokens=new, max_len=prompt_len + new))
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(batch, prompt_len)).astype(np.int32)

    ops.reset_launches()
    out = engine.generate(prompts)
    torch.cuda.synchronize()
    launches = {k: n for k, n in ops.launches().items() if k in LLM_KERNELS}
    cold = dict(engine.stats)
    n_sites = cfg.n_layers // cfg.attn_every
    check(launches["flash_attention"] == n_sites,
          f"K5 launched {launches['flash_attention']}x, expected {n_sites}")
    check(launches["ssd"] == cfg.n_layers,
          f"K6 launched {launches['ssd']}x, expected {cfg.n_layers}")
    check(out.shape == (batch, new) and out.dtype == np.int32,
          f"generate returned {out.shape} {out.dtype}")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()), "token out of range")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out2 = engine.generate(prompts)
    wall = time.perf_counter() - t0
    st = engine.stats
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(np.array_equal(out, out2), "two generates differ")
    prefill_ms = st["prefill_s"] * 1e3
    decode_ms = st["decode_s"] * 1e3 / st["decode_steps"]
    print(f"generate (warm): wall {wall * 1e3:.1f} ms, prefill {prefill_ms:.1f}"
          f" ms, decode {decode_ms:.2f} ms per step ({st['decode_steps']} "
          f"steps of batch {batch}), {out.size / wall:.1f} generated tokens/s, "
          f"{batch * prompt_len / st['prefill_s']:.0f} prompt tokens/s in "
          f"prefill; peak memory {peak_gb:.2f} GB; first (cold) generate: "
          f"prefill {cold['prefill_s'] * 1e3:.1f} ms, decode "
          f"{cold['decode_s'] * 1e3:.1f} ms")
    print(f"launches in one generate: {json.dumps(launches)} (prefill: "
          f"{n_sites} attention sites, {cfg.n_layers} mamba layers; decode "
          f"runs no kernel, as the reference)")
    print(f"sample tokens: {out[0].tolist()}")

    # The same prefill through the plain versions on the card: the model's
    # modules call ops.attention / ops.ssd, pointed here at the plain
    # versions for this one call.
    tokens = torch.as_tensor(prompts.astype(np.int64), device=dev)
    logits, _ = model.prefill(tokens, prompt_len + new)
    kernels = (ops.attention, ops.ssd)
    try:
        ops.attention, ops.ssd = ref.attention_ref, ref.ssd_padded_ref
        plain, _ = model.prefill(tokens, prompt_len + new)
    finally:
        ops.attention, ops.ssd = kernels
    torch.cuda.synchronize()
    lg = logits.float().reshape(batch, -1)
    pl = plain.float().reshape(batch, -1)
    check(bool(torch.isfinite(lg).all()), "non-finite logits")
    scale = float(pl.abs().max())
    diff = float((lg - pl).abs().max())
    same = lg.argmax(-1) == pl.argmax(-1)
    top2 = pl.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    check(diff <= PREFILL_REL_TOL * scale,
          f"prefill logits: max |diff| {diff} > {PREFILL_REL_TOL} x {scale}")
    check(bool(same.all()),
          f"prefill: next-token argmax differs on rows "
          f"{(~same).nonzero().flatten().tolist()} (plain top-2 margins "
          f"{margin[~same].tolist()}, max |diff| {diff})")
    print(f"prefill against the plain versions on the card: max |logit diff| "
          f"{diff:.4g} = {diff / scale:.4g} of the logits' scale {scale:.4g} "
          f"(tolerance {PREFILL_REL_TOL}); next-token argmax agrees on "
          f"{int(same.sum())}/{batch} rows; plain top-2 margins "
          f"{[round(m, 4) for m in margin.tolist()]}")
    _, cache = model.prefill(tokens, prompt_len + new)
    check_decode_syncs(torch, model, cache,
                       torch.as_tensor(out[:, :1].astype(np.int64),
                                       device=dev),
                       f"zamba2-2.7b ({n_sites} attention sites)")
    del cache

    smoke = get_config("zamba2-2.7b", smoke=True).scaled(
        compute_dtype=torch.float32)
    on_card = build(smoke, seed=1, device=dev)
    on_cpu = build(smoke, _to_cpu(on_card.params), device="cpu")
    sp = np.random.default_rng(1).integers(1, smoke.vocab, size=(4, 100)
                                           ).astype(np.int32)
    scfg = ServeConfig(max_new_tokens=8, max_len=128)
    a = Engine(on_card, make_host_mesh(), Policy(), None, scfg).generate(sp)
    b = Engine(on_cpu, make_host_mesh(), Policy(), None, scfg).generate(sp)
    check(np.array_equal(a, b), "smoke zamba2: card and CPU tokens differ")
    print("smoke zamba2 (f32, S=100: a padded SSD tail): card and CPU "
          "generate identical tokens")
    return {"engine": engine, "prompts": prompts, "launches": launches,
            "wall": wall, "prefill_s": st["prefill_s"]}


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def ssd_work(case) -> tuple[int, int]:
    """(bytes, f32 multiply-adds x 2) of one K6 call at ``case``: each
    input read once and the output and final state written once; the
    intra-chunk products over the causal (i, j) pairs and the chunk-state
    products."""
    b, s, h, p, n, chunk = case
    tri = chunk * (chunk + 1) // 2              # causal (i, j) pairs per chunk
    per_chunk = 2 * tri * (n + p) + 4 * chunk * n * p
    n_ops = b * h * (s // chunk) * per_chunk
    n_bytes = 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * n + 2 * h
                   + b * h * n * p)
    return n_bytes, n_ops


def time_llm_kernels(torch, ops, ref, dev, launches, errs) -> list[dict]:
    """Phase 10: K5 and K6 at phase 9's shapes: kernel, plain version and
    bound; PyTorch's own attention call for K5 as a yardstick."""
    rows = []
    case = ATTN_CASES[0]
    b, h, kh, s, d, causal, _, _ = case
    q, k, v = attn_inputs(torch, case, dev)
    ms = time_ms(lambda: ops.attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, causal=True))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
    pairs = attn_pairs(b, h, s, True, None)
    n_bytes = 2 * (2 * b * h * s * d + 2 * b * kh * s * d)
    rows.append(("flash_attention", ms, plain_ms, lib_ms,
                 *bound(n_bytes, 4 * d * pairs, PEAK_BF16_FLOPS)))
    print(f"K5 bar {ATTN_BAR_MS} ms: {'met' if ms <= ATTN_BAR_MS else 'MISSED'}"
          f" ({ms:.4f} ms; scaled_dot_product_attention {lib_ms:.4f} ms); "
          f"one call between two events, host included: "
          f"{time_ms_per_call(lambda: ops.attention(q, k, v, causal=True)):.4f}"
          f" ms")

    case = SSD_CASES[0]
    b, s, h, p, n, chunk = case
    args = ssd_inputs(torch, case, dev)
    ms = time_ms(lambda: ops.ssd(*args, chunk=chunk, return_state=True))
    plain_ms = time_ms(lambda: ref.ssd_padded_ref(*args, chunk=chunk,
                                                  return_state=True))
    n_bytes, n_ops = ssd_work(case)
    # The kernel runs each f32 product as three TF32 products (3xTF32): its
    # bound counts them at the TF32 tensor-core peak; the FP32 CUDA-core
    # bound of the same products is printed beside it.
    rows.append(("ssd", ms, plain_ms, None,
                 *bound(n_bytes, 3 * n_ops, PEAK_TF32_FLOPS)))
    per_call = time_ms_per_call(
        lambda: ops.ssd(*args, chunk=chunk, return_state=True))
    bf16_args = tuple(t.bfloat16().float() for t in args)
    bf16_ms = time_ms(lambda: ops.ssd(*bf16_args, chunk=chunk,
                                      return_state=True))
    print(f"K6 bar {SSD_BAR_MS} ms: {'met' if ms <= SSD_BAR_MS else 'MISSED'} "
          f"({ms:.4f} ms; one call between two events, host included: "
          f"{per_call:.4f} ms; on the same inputs rounded to bf16, as the "
          f"serving path's x, B, C are: {bf16_ms:.4f} ms); bounds: bytes {n_bytes / PEAK_BYTES_PER_S * 1e3:.6f}"
          f" ms ({n_bytes / 1e6:.1f} MB), 3xTF32 operations "
          f"{3 * n_ops / PEAK_TF32_FLOPS * 1e3:.6f} ms, the same products on "
          f"the FP32 CUDA cores {n_ops / PEAK_FP32_FLOPS * 1e3:.6f} ms")

    out = []
    for name, ms, plain_ms, lib_ms, bound_ms, bound_by in rows:
        kern = ops.KERNELS[name]
        out.append({
            "name": name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        })
        lib = (f"scaled_dot_product_attention {lib_ms:.4f} ms"
               if lib_ms is not None else "no PyTorch call computes it")
        print(f"{name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms by {bound_by}; {lib})")
    return out


def run_main_path(torch):
    """The NoC main path through ``repro_torch.noc.run`` on the card:
    MOO-STAGE on spec_64 under BFS traffic, case5, 2000 evaluations from
    seed 0. Returns (problem, result, wall seconds). max_local_steps=40:
    with the default 10 000 the first local search alone spends the 2000
    evaluations and the surrogate is never queried."""
    from repro_torch.noc import Budget, NocProblem, named_spec, run

    problem = NocProblem(spec=named_spec("64"), traffic="BFS", case="case5")
    t0 = time.perf_counter()
    res = run(problem, "stage", budget=Budget(max_evals=2000, seed=0),
              config={"max_local_steps": 40}, device="cuda")
    torch.cuda.synchronize()
    return problem, res, time.perf_counter() - t0


def noc_timing_inputs(torch, dev, bsz: int = 48) -> dict:
    """Phase 6's NoC inputs: ``bsz`` random spec_64 designs (one
    neighbourhood of 24 + 24 moves) from seed 0, their hop costs, next hops
    and BFS slot traffic, through the ``repro_torch`` on ``sys.path``."""
    import numpy as np

    from repro_torch.core import routing
    from repro_torch.core.objectives import design_cost, make_consts
    from repro_torch.core.problem import random_design, spec_64

    spec = spec_64()
    consts = make_consts(spec, dev.type)
    rng = np.random.default_rng(0)
    designs = [random_design(spec, rng) for _ in range(bsz)]
    adjs = torch.as_tensor(np.stack([d.adj for d in designs]), device=dev)
    costs = design_cost(consts, adjs).contiguous()
    nh = routing.next_hop(costs, routing.apsp_batched(costs,
                                                      consts.apsp_iters))
    return {"costs": costs, "iters": consts.apsp_iters, "nh": nh.contiguous(),
            "f": slot_traffic(torch, spec, designs, consts, dev),
            "delay": consts.link_delay, "max_hops": spec.max_hops}


def forest_inputs(torch, dev) -> dict:
    """Phases 2 and 6's forest, through the ``repro_torch`` on ``sys.path``:
    the spec_64 features of 600 random designs from seed 0, labels on the
    scale of the main path's (PHVs in (0, 1)), 24 trees fitted on the first
    400 rows; x1 (row 0, normalized) and x48 (48 raw rows), xm and xs."""
    import numpy as np

    from repro_torch.core.features import design_features_batch
    from repro_torch.core.forest import RegressionForest
    from repro_torch.core.problem import random_design, spec_64

    spec = spec_64()
    rng = np.random.default_rng(0)
    x_all = design_features_batch(spec, [random_design(spec, rng)
                                         for _ in range(600)])
    z = (x_all - x_all.mean(0)) / (x_all.std(0) + 1e-9)
    y_all = 1.0 / (1.0 + np.exp(-(z @ rng.normal(size=z.shape[1]) / 4.0)))
    forest = RegressionForest(seed=0, device=dev.type).fit(x_all[:400],
                                                            y_all[:400])

    def on_card(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    return {"x_all": x_all, "y_all": y_all, "forest": forest,
            "x1": on_card(forest._normalize(x_all[:1])),
            "x48": on_card(x_all[:48]), "xm": on_card(forest._xm),
            "xs": on_card(forest._xs)}


def forest_calls(torch, ops, fi) -> dict:
    """K2 at B = 1 and K3 at B = 48 on phase 6's forest, as the main path
    of the tree that ``ops`` comes from calls them: on the packed forest
    where the tree has one, else on the four forest tensors."""
    forest, x1, x48, xm, xs = (fi[k] for k in ("forest", "x1", "x48", "xm",
                                               "xs"))
    if hasattr(ops, "pack_forest"):
        pf = forest.packed()
        out = torch.empty(2, dtype=torch.int32, device=x48.device)
        return {"forest_predict": lambda: ops.forest_predict_packed(pf, x1),
                "score_block_max": lambda: ops.score_block_max_packed(
                    pf, xm, xs, x48, 48, out)}
    nodes = forest.device_nodes()
    depth = forest._flat["depth"]
    return {"forest_predict": lambda: ops.forest_predict(*nodes, x1, depth),
            "score_block_max": lambda: ops.score_block_max(
                *nodes, xm, xs, x48, 48, depth)}


#: Rows made equal to the best row in phase 2's tie checks: across a
#: lane's rows, a block's edge, a cluster's and the last cluster's.
TIE_ROWS = ((3, 35), (63, 64), (127, 128), (10, 130), (64, 65, 199),
            (1499, 1400, 700))


def forest_kernels_vs_plain(torch, ops, ref, dev, fi, rng) -> None:
    """Phase 2's K2 and K3 checks: bit-equal to their plain versions on
    the card on five forests (24, 10 and 1 trees, depth 0, and one deep
    enough for the L2 route) at B = 1, 7, 48, 128, 1500 and three n_real
    each; the first max on ties; ten back-to-back calls bit-identical."""
    import numpy as np

    from repro_torch.core.features import design_features_batch
    from repro_torch.core.forest import RegressionForest
    from repro_torch.core.problem import random_design, spec_64

    x_all, y_all = fi["x_all"], fi["y_all"]
    forests = {"T=24": fi["forest"]}
    for name, kw in (("T=10", dict(n_trees=10)), ("T=1", dict(n_trees=1)),
                     ("depth 0", dict(max_depth=0))):
        forests[name] = RegressionForest(seed=0, device=dev.type, **kw).fit(
            x_all[:400], y_all[:400])
    spec = spec_64()
    x_big = design_features_batch(spec, [random_design(spec, rng)
                                         for _ in range(6000)])
    forests["L2 route"] = RegressionForest(
        seed=0, device=dev.type, max_depth=16, min_leaf=1).fit(
            x_big, x_big[:, 0] + rng.normal(size=6000))
    out = torch.empty(2, dtype=torch.int32, device=dev)

    def k3_matches(pf, xm, xs, x, n_real, label):
        ops.score_block_max_packed(pf, xm, xs, x, n_real, out)
        v, j = ref.score_block_max_ref(*pf.plain, xm, xs, x, n_real,
                                       pf.depth)
        check(int(out[1]) == int(j)
              and int(out[0]) == int(v.view(torch.int32)),
              f"score_block_max {label} n_real={n_real}: "
              f"({int(out[1])}, {float(out.view(torch.float32)[0])}) vs "
              f"plain ({int(j)}, {float(v)})")

    for name, forest in forests.items():
        pf = forest.packed()
        check(pf.route == ("l2" if name == "L2 route" else "smem"),
              f"forest {name}: route {pf.route}")
        xm = torch.as_tensor(forest._xm.astype(np.float32), device=dev)
        xs = torch.as_tensor(forest._xs.astype(np.float32), device=dev)
        for bsz in (1, 7, 48, 128, 1500):
            xq = x_all[rng.integers(0, 600, size=bsz)] * (
                1 + 0.05 * rng.normal(size=(bsz, x_all.shape[1])))
            xn = torch.as_tensor(forest._normalize(xq).astype(np.float32),
                                 device=dev)
            got = ops.forest_predict_packed(pf, xn)
            check(torch.equal(got, ref.forest_predict_ref(*pf.plain, xn,
                                                          pf.depth)),
                  f"forest_predict {name} B={bsz}: differs from plain")
            if name == "T=24":
                e = float(np.abs(got.cpu().numpy()
                                 - forest.predict(xq, backend="numpy")).max())
                check(e <= 1e-6, f"forest_predict B={bsz}: {e} vs the f64 "
                      f"numpy oracle")
            x = torch.as_tensor(xq.astype(np.float32), device=dev)
            for n_real in sorted({1, max(1, bsz - 5), bsz}):
                k3_matches(pf, xm, xs, x, n_real, f"{name} B={bsz}")
        print(f"K2/K3 forest {name} (T={pf.n_trees}, M={pf.records.shape[1]}"
              f", depth {pf.depth}, cluster {pf.cluster}, route {pf.route}): "
              f"bit-equal to plain at B=1,7,48,128,1500")

    forest = forests["T=24"]
    pf = forest.packed()
    nodes = forest.device_nodes()
    xm, xs = fi["xm"], fi["xs"]
    for rows in TIE_ROWS:
        bsz = 1500 if max(rows) >= 200 else 200
        x = torch.as_tensor(x_all[rng.integers(0, 600, size=bsz)]
                            .astype(np.float32), device=dev)
        vals = ref.forest_predict_ref(*pf.plain, (x - xm) / xs, pf.depth)
        j0 = int(torch.argmax(vals))
        for r in rows:
            x[r] = x[j0]
        vals = ref.forest_predict_ref(*pf.plain, (x - xm) / xs, pf.depth)
        first = int(torch.nonzero(vals == vals.max())[0])
        ops.score_block_max_packed(pf, xm, xs, x, bsz, out)
        check(int(out[1]) == first, f"tie at rows {rows}: argmax "
              f"{int(out[1])}, first max {first}")
        k3_matches(pf, xm, xs, x, bsz, f"tie {rows}")
        v, j = ops.score_block_max(*nodes, xm, xs, x, bsz, pf.depth)
        check(int(j) == first, f"tie at rows {rows}: the four-tensor "
              f"wrapper gives {int(j)}")
    x = torch.as_tensor(x_all[rng.integers(0, 600, size=1500)]
                        .astype(np.float32), device=dev)
    xn = (x - xm) / xs
    runs = [(ops.score_block_max_packed(
        pf, xm, xs, x, 1500, torch.empty(2, dtype=torch.int32, device=dev)),
        ops.forest_predict_packed(pf, xn)) for _ in range(10)]
    check(all(torch.equal(a, runs[0][0]) and torch.equal(b, runs[0][1])
              for a, b in runs), "ten back-to-back K2/K3 calls differ")
    check(torch.equal(ops.forest_predict(*nodes, xn, pf.depth), runs[0][1]),
          "the four-tensor forest_predict differs from the packed one")
    print(f"K3: first max on ties at rows {list(TIE_ROWS)}; ten back-to-back "
          f"K2/K3 calls at B=1500 bit-identical")


def forest_design_probe(torch, ops, ref, fi) -> None:
    """K2 and K3 on phase 6's forest with the cluster and route set by
    hand (the wrapper picks them from the shape): bit-equal to the plain
    versions, and the profiler's device time per call of each."""
    pf = fi["forest"].packed()
    x1, x48, xm, xs = fi["x1"], fi["x48"], fi["xm"], fi["xs"]
    out = torch.empty(2, dtype=torch.int32, device=x48.device)
    want2 = ref.forest_predict_ref(*pf.plain, x1, pf.depth)
    v, j = ref.score_block_max_ref(*pf.plain, xm, xs, x48, 48, pf.depth)
    for cluster in (8, 4, 2, 1):
        for route in ("smem", "l2"):
            alt = dataclasses.replace(pf, cluster=min(cluster, pf.n_trees),
                                      route=route)
            check(torch.equal(ops.forest_predict_packed(alt, x1), want2),
                  f"K2 cluster {cluster} {route}: differs from plain")
            ops.score_block_max_packed(alt, xm, xs, x48, 48, out)
            check(int(out[1]) == int(j)
                  and int(out[0]) == int(v.view(torch.int32)),
                  f"K3 cluster {cluster} {route}: differs from plain")
            k2 = device_ms_per_call(
                torch, lambda: ops.forest_predict_packed(alt, x1),
                NOC_SYMBOLS["forest_predict"])
            k3 = device_ms_per_call(
                torch, lambda: ops.score_block_max_packed(alt, xm, xs, x48,
                                                          48, out),
                NOC_SYMBOLS["score_block_max"])
            shown = ["not measured" if t is None else f"{t:.4f} ms"
                     for t in (k2, k3)]
            chosen = (alt.cluster, route) == (pf.cluster, pf.route)
            print(f"  probe cluster {alt.cluster} route {route}"
                  f"{' (chosen)' if chosen else ''}: K2 B=1 {shown[0]}, "
                  f"K3 B=48 {shown[1]} of device time per call")


def kernel_times(src: Path) -> dict:
    """K1, K2, K3 and K4 at phase 6's shapes and K5 and K6 at phase 10's,
    of the package under ``src``: device time (``time_ms``), one call
    between two events (``time_ms_per_call``), the profiler's device time
    per call (all of the call's kernels) and its kernels per call; then two
    runs of the main path (wall seconds, and the second run's accounting,
    front and PHV); then the decode ms per step of ``DECODE_TIMED``."""
    sys.path.insert(0, str(src))
    import torch

    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    noc = noc_timing_inputs(torch, dev)
    q, k, v = attn_inputs(torch, ATTN_CASES[0], dev)
    args = ssd_inputs(torch, SSD_CASES[0], dev)
    chunk = SSD_CASES[0][-1]
    fns = {"minplus": lambda: ops.apsp(noc["costs"], noc["iters"]),
           **forest_calls(torch, ops, forest_inputs(torch, dev)),
           "walk": lambda: ops.walk(noc["nh"], noc["f"], noc["delay"],
                                    noc["max_hops"]),
           "flash_attention": lambda: ops.attention(q, k, v, causal=True),
           "ssd": lambda: ops.ssd(*args, chunk=chunk, return_state=True)}
    out = {"package": str(Path(ops.__file__).resolve().parents[1])}
    for name, fn in fns.items():
        rows = profiled(torch, fn)
        out[name] = {"ms": time_ms(fn), "per_call_ms": time_ms_per_call(fn),
                     "trace_ms": sum(r[1] for r in rows) / 10,
                     "kernels_per_call": sum(r[2] for r in rows) / 10}
    walls = [run_main_path(torch) for _ in range(2)]
    res = walls[-1][1]
    out["main_path"] = {"first_s": walls[0][2], "second_s": walls[1][2],
                        "evals": res.n_evals, "calls": res.n_calls,
                        "front": len(res.designs), "phv": res.phv()}
    out["decode_ms"] = {arch: decode_ms(torch, arch, dtype)
                        for arch, dtype in DECODE_TIMED}
    return out


#: The decode steps ``--compare-kernels`` times: full width, batch 8,
#: parameters in the dtype named.
DECODE_TIMED = (("zamba2-2.7b", "float32"),
                ("qwen3-moe-30b-a3b", "bfloat16"),
                ("whisper-base", "float32"))


def decode_ms(torch, arch, dtype, steps=15, reps=3) -> float:
    """Host-clock ms per greedy ``decode_step`` of ``arch`` at full width
    (seeded weights in ``dtype``), batch 8, after a prefill of 512 prompt
    tokens (whisper: 1500 stub frames and 8 tokens): the median over
    ``reps`` runs of ``steps`` steps, each run ending in a sync."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build

    dev = torch.device("cuda")
    cfg = get_config(arch).scaled(dtype=getattr(torch, dtype))
    model = build(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    n = WHISPER_PROMPT if cfg.family == "encdec" else 512
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab, (8, n)), device=dev)
    max_len = n + steps * reps + 1
    if cfg.family == "encdec":
        frames = torch.as_tensor(rng.standard_normal(
            (8, WHISPER_FRAMES, cfg.d_model)).astype(np.float32), device=dev)
        logits, cache = model.prefill(frames, tokens, max_len)
    else:
        logits, cache = model.prefill(tokens, max_len)
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            logits, cache = model.decode_step(cache, tok)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3 / steps)
    del model, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return statistics.median(runs)


def compare_kernels(other: Path) -> int:
    """K1–K6 of checkout ``other`` timed beside this checkout's, each in a
    fresh process, in the order other, this, this, other."""
    root = Path(__file__).resolve().parent
    check((other / "src" / "repro_torch" / "csrc").is_dir(),
          f"{other}: no src/repro_torch/csrc")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}")
    for label, tree in (("other", other), ("this", root), ("this", root),
                        ("other", other)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--time-kernels",
             str(tree.resolve() / "src")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"timing {tree} failed:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        print(f"{label}: {proc.stdout.strip().splitlines()[-1]}", flush=True)
    return 0


def apsp_squarings(torch, ref, cost, n_iters: int) -> int:
    """Squarings the one-launch APSP runs over the batch ``cost``: per
    design up to and including the first that changes no bit, at most
    ``n_iters``."""
    total = 0
    for c in cost:
        d = c[None]
        for _ in range(n_iters):
            nxt = ref.minplus_ref(d, d)
            total += 1
            if torch.equal(nxt.view(torch.int32), d.view(torch.int32)):
                break
            d = nxt
    return total


def slot_traffic(torch, spec, designs, consts, dev):
    """(B, N, N) f32 BFS traffic between the slots of each design."""
    import numpy as np

    from repro_torch.core.traffic import traffic_matrix

    f_core = torch.as_tensor(traffic_matrix(spec, "BFS").astype(np.float32),
                             device=dev)
    perms = torch.as_tensor(np.stack([d.perm for d in designs]).astype(
        np.int64), device=dev)
    return (f_core[perms[:, :, None], perms[:, None, :]]
            * (~consts.eye).float()).contiguous()


def check_walk(torch, ops, ref, label, k4, nh, f, delay, max_hops) -> float:
    """K4's result ``k4`` against a second run, the plain version on the
    card (hops, delay, all_done bit-equal; util and visits bit-equal where
    every pair arrives) and the CPU plain version (util and visits
    bit-equal there). Returns the max |err| against the card's plain
    version."""
    k4b = ops.walk(nh, f, delay, max_hops)
    plain = ref.walk_ref(nh, f, delay, max_hops)
    cpu = ref.walk_ref(nh.cpu(), f.cpu(), delay.cpu(), max_hops)
    torch.cuda.synchronize()
    for a, b, name in zip(k4, k4b, ("hops", "delay", "util", "visits",
                                    "all_done")):
        check(torch.equal(a, b), f"walk {label}: two runs differ in {name}")
    for i, name in ((0, "hops"), (1, "delay"), (4, "all_done")):
        check(torch.equal(k4[i], plain[i]), f"walk {label}: {name} differs")
    done = k4[4].bool()
    check(bool(done.any()), f"walk {label}: no connected design")
    err = 0.0
    for i, name in ((2, "util"), (3, "visits")):
        got, want = k4[i][done], plain[i][done]
        check(torch.equal(got, want),
              f"walk {label}: {name} differs from the plain version on the "
              "card")
        check(torch.equal(got.cpu(), cpu[i][done.cpu()]),
              f"walk {label}: {name} differs from the CPU plain version")
        err = max(err, float((got - want).abs().max()))
    print(f"K4 walk {label} (B={nh.shape[0]}, max_hops {max_hops}): "
          f"hops/delay/all_done bit-equal, util/visits |err| {err:.3g} vs "
          f"plain on the card, bit-equal to the CPU plain version, two "
          f"runs bit-identical ({int(done.sum())}/{nh.shape[0]} designs "
          f"connected)")
    return err


def random_graphs(torch, rng, bsz: int, n: int, p_edge: float, dev):
    """INF-sparse (B, N, N) f32 matrices of small integer weights."""
    import numpy as np

    w = rng.integers(1, 20, size=(bsz, n, n)).astype(np.float32)
    w[rng.random((bsz, n, n)) > p_edge] = np.float32(1e9)
    return torch.as_tensor(w, device=dev)


# ------------------------------------------- searches held card against CPU
#: Objective rows on the card against the CPU (K4's order and PyTorch's
#: reductions against the plain versions): relative tolerance.
ROW_RTOL = 1e-5


def delta_on_card(spec, rng, n_moves: int = 3) -> None:
    """Phase 5 on ``spec``: ``n_moves`` neighbourhoods of 24 swaps and 24
    link moves under BFS, each from the last one's last link move, through
    the evaluator's delta path (host tables) and its dense path on the
    card, the rows bit-equal."""
    import numpy as np

    from repro_torch.core.evaluate import Evaluator
    from repro_torch.core.problem import sample_neighbor_moves
    from repro_torch.core.traffic import traffic_matrix

    f = traffic_matrix(spec, "BFS")
    ev_on = Evaluator(spec, f, delta="on", device="cuda")
    ev_off = Evaluator(spec, f, delta="off", device="cuda")
    base = spec.mesh_design()
    for k in range(n_moves):
        mv = sample_neighbor_moves(spec, base, rng, 24, 24)
        check(np.array_equal(ev_on.batch_moves(mv), ev_off.batch_moves(mv)),
              f"N={spec.n_tiles} neighbourhood {k}: delta on differs from "
              "delta off")
        base = mv.materialize(len(mv) - 1)
    print(f"N={spec.n_tiles}: {n_moves} neighbourhoods bit-equal; delta "
          f"stats {ev_on.delta_stats}")


def launches_of(ops) -> dict:
    """The launch counts of the NoC kernels."""
    return {k: n for k, n in ops.launches().items() if k in NOC_KERNELS}


def hold_on_card(torch, ops, problem, name, budget, config, device="cuda"):
    """One search on ``device`` against the same search on the CPU, by
    ``repro_torch.noc.parity.hold_runs`` at ROW_RTOL: the same front and
    accounting, or a knife-edge whose replay on the CPU's rows is the CPU's
    run bit for bit. Returns (device result, launches of the NoC kernels in
    the device run, parting summary)."""
    from repro_torch.noc import run
    from repro_torch.noc.parity import hold_runs

    counts = []

    def on_device(ev):
        n0 = launches_of(ops)
        res = run(problem, name, budget, config=config, ev=ev)
        if device != "cpu":
            torch.cuda.synchronize()
        if not counts:                      # the free run, not the replay
            counts.append({k: launches_of(ops)[k] - n0[k] for k in n0})
        return res

    def on_cpu(ev):
        return run(problem, name, budget, config=config, ev=ev)

    res, _, part = hold_runs(on_device, lambda: problem.evaluator(
        device=device), on_cpu, lambda: problem.evaluator(device="cpu"),
        ROW_RTOL)
    return res, counts[0], part


def parting_text(part: dict) -> str:
    if not part["parted"]:
        return f"same front, same accounting ({part['evals'][0]} evals)"
    return (f"KNIFE-EDGE: parts at evaluation {part['step']} of "
            f"{part['evals']}, rows before it within {part['row_rtol']:.3g} "
            f"(bar {ROW_RTOL}), {part['flips']} flipped comparisons, margin "
            f"{part['margin']:.3g}; replayed on the CPU's rows the card run "
            "is the CPU run bit for bit")


def multi_iteration_on_card(torch, ops, device="cuda", max_evals=500,
                            seeds=(0, 1, 2)) -> None:
    """Phase 4, second part: spec_tiny MOO-STAGE over several local and
    meta searches (4 local steps, 500 evaluations), seeds 0/1/2, on the
    host and the fused meta path, card against CPU. The surrogate must have
    decided something on every card run: K2 launched (both paths) and K3
    launched (the fused path; the host path scores with K2 alone)."""
    from repro_torch.noc import Budget, NocProblem, named_spec

    problem = NocProblem(spec=named_spec("tiny"), traffic="BFS",
                         case="case5")
    for seed in seeds:
        for meta in ("host", "fused"):
            res, counts, part = hold_on_card(
                torch, ops, problem, "stage",
                Budget(max_evals=max_evals, seed=seed),
                {"max_local_steps": 4, "meta_backend": meta}, device)
            if device != "cpu":
                check(counts["forest_predict"] > 0,
                      f"seed {seed} {meta}: K2 never launched")
                check(meta == "host" or counts["score_block_max"] > 0,
                      f"seed {seed} {meta}: K3 never launched")
            print(f"stage seed {seed} meta {meta}: local searches "
                  f"{res.extra['n_local_searches']}, front "
                  f"{len(res.designs)}, evals {res.n_evals} calls "
                  f"{res.n_calls}, launches {json.dumps(counts)}; "
                  f"{parting_text(part)}")


def stage_batch_on_card(torch, ops, device="cuda", spec="64",
                        max_evals=2000, tiny_evals=500,
                        seeds=(0, 1, 2)) -> None:
    """Phase 3b: multi-start MOO-STAGE (``stage_batch``, 4 starts, 40 and
    then 4 local steps) on spec_64 under BFS, case5, 2000 evaluations, with
    the launches of the NoC kernels over each run alone and its front
    re-evaluated on the CPU; then spec_tiny ``stage_batch`` (2 starts, 4
    local steps, 500 evaluations), seeds 0/1/2, card against CPU, with K2
    and K3 launched on every card run."""
    import numpy as np

    from repro_torch.core.evaluate import Evaluator
    from repro_torch.noc import Budget, NocProblem, named_spec, run

    problem = NocProblem(spec=named_spec(spec), traffic="BFS", case="case5")
    ev_cpu = Evaluator(problem.spec, problem.traffic_matrix(), device="cpu")
    # With 40 local steps the four chains' first local searches spend the
    # whole budget, so the surrogate (K2, K3) is never queried; with 4
    # steps the meta search runs between rounds of local searches.
    for steps, kernels in ((40, ("minplus", "walk")), (4, NOC_KERNELS)):
        ops.reset_launches()
        t0 = time.perf_counter()
        res = run(problem, "stage_batch", Budget(max_evals=max_evals, seed=0),
                  config={"n_starts": 4, "max_local_steps": steps},
                  device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches_of(ops)
        if device != "cpu":
            for name in kernels:
                check(counts[name] > 0,
                      f"stage_batch ({steps} steps): {name} never launched")
        phv = res.phv()
        check(len(res.designs) > 0 and math.isfinite(phv) and phv > 0,
              f"stage_batch: front {len(res.designs)}, PHV {phv}")
        check(np.allclose(ev_cpu.batch(res.designs), res.objs,
                          rtol=ROW_RTOL, atol=0.0),
              "stage_batch front re-evaluated on the CPU disagrees")
        print(f"stage_batch spec_{spec}, {steps} local steps: wall "
              f"{wall:.3f} s, evals {res.n_evals} calls {res.n_calls}, front "
              f"{len(res.designs)}, phv {phv:.6g}, local searches "
              f"{res.extra['n_local_searches']}, launches "
              f"{json.dumps(counts)}")
    tiny = NocProblem(spec=named_spec("tiny"), traffic="BFS", case="case5")
    for seed in seeds:
        res, counts, part = hold_on_card(
            torch, ops, tiny, "stage_batch",
            Budget(max_evals=tiny_evals, seed=seed),
            {"n_starts": 2, "max_local_steps": 4}, device)
        if device != "cpu":
            for name in NOC_KERNELS:
                check(counts[name] > 0,
                      f"stage_batch spec_tiny seed {seed}: {name} never "
                      "launched")
        print(f"stage_batch spec_tiny seed {seed}: front {len(res.designs)}, "
              f"evals {res.n_evals} calls {res.n_calls}, launches "
              f"{json.dumps(counts)}; {parting_text(part)}")


#: Phase 11's agnostic study: the paper's 36-tile system and four of its
#: applications.
AGNOSTIC_APPS = ("BFS", "BP", "CDN", "HS")


def baselines_on_card(torch, ops, device="cuda", spec="64",
                      max_evals=500) -> dict:
    """Phase 11 (a): AMOSA, NSGA-II and PCBB on phase 3's problem through
    ``repro_torch.noc.run``, each with the launches of K1 and K4 over its
    run alone, its front re-evaluated on the CPU. PCBB has no native budget:
    the guard stops it and its best-so-far front comes back."""
    import numpy as np

    from repro_torch.core.evaluate import Evaluator
    from repro_torch.noc import Budget, NocProblem, named_spec, run

    problem = NocProblem(spec=named_spec(spec), traffic="BFS", case="case5")
    ev_cpu = Evaluator(problem.spec, problem.traffic_matrix(), device="cpu")
    out = {}
    for name in ("amosa", "nsga2", "pcbb"):
        ops.reset_launches()
        t0 = time.perf_counter()
        res = run(problem, name, Budget(max_evals=max_evals, seed=0),
                  device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches_of(ops)
        if device != "cpu":
            check(counts["minplus"] > 0 and counts["walk"] > 0,
                  f"{name}: K1/K4 launches {counts}")
        phv = res.phv()
        check(len(res.designs) > 0 and math.isfinite(phv),
              f"{name}: front {len(res.designs)}, PHV {phv}")
        check(np.allclose(ev_cpu.batch(res.designs), res.objs,
                          rtol=ROW_RTOL, atol=0.0),
              f"{name}: front re-evaluated on the CPU disagrees")
        if name == "pcbb":
            check(res.exhausted, "pcbb: not stopped by the budget guard")
        print(f"{name}: wall {wall:.3f} s, evals {res.n_evals} calls "
              f"{res.n_calls}, front {len(res.designs)}, phv {phv:.6g}, "
              f"exhausted {res.exhausted}, launches {json.dumps(counts)}")
        out[name] = res
    return out


def twins_on_card(device="cuda") -> None:
    """Phase 11 (b): the NSGA-II rank/crowding twin against numpy on 20
    random populations of 2-64 rows with integer-valued ties, and the PHV
    twin against the host HSO at m = 1-4 with duplicates and candidates
    beyond ref, on the card."""
    import numpy as np

    from repro_torch.core.nsga2 import rank_and_crowding
    from repro_torch.core.pareto import hypervolume_with_batch
    from repro_torch.core.phv_torch import hypervolume_with_batch_torch

    rng = np.random.default_rng(0)
    worst = 0.0
    for _ in range(20):
        n = int(rng.integers(2, 65))
        m = int(rng.integers(1, 5))
        objs = rng.integers(0, 4, size=(n, m)).astype(np.float64)
        r_np, c_np = rank_and_crowding(objs, "numpy")
        r_d, c_d = rank_and_crowding(objs, "device", device=device)
        check(np.array_equal(r_np, r_d), "rank twin: ranks differ")
        fin = np.isfinite(c_np)
        check(np.array_equal(fin, np.isfinite(c_d)),
              "rank twin: infinities differ")
        check(np.allclose(c_d[fin], c_np[fin], rtol=1e-5, atol=1e-6),
              "rank twin: crowding beyond rtol 1e-5 / atol 1e-6")
        if fin.any():
            worst = max(worst, float(np.abs(c_d[fin] - c_np[fin]).max()))
    phv_err = 0.0
    for m in (1, 2, 3, 4):
        rng = np.random.default_rng(m)
        ref = np.full(m, 1.6)
        pts = rng.uniform(0.2, 1.5, size=(9, m))
        pts = np.vstack([pts, pts[:2]])
        cands = rng.uniform(0.1, 1.9, size=(13, m))
        got = hypervolume_with_batch_torch(pts, cands, ref, device=device)
        want = hypervolume_with_batch(pts, cands, ref)
        check(np.allclose(got, want, rtol=3e-5, atol=3e-6),
              f"PHV twin at m={m} beyond rtol 3e-5 / atol 3e-6")
        phv_err = max(phv_err, float(np.abs(got - want).max()))
    print(f"rank twin: 20 populations, ranks equal, crowding max |diff| "
          f"{worst:.3g}; PHV twin at m=1-4: max |diff| {phv_err:.3g}")


def nsga2_kernel_on_card(torch, ops, ref, device="cuda") -> dict:
    """Phase 11 (b'): the NSGA-II selection kernel against its plain twin
    on the card, bit for bit, at the search's populations (n = 32 and the
    union's 64, m = 5) on random and on tied rows; the kernel's device
    time, one ``rank_and_crowding`` call between two events (copies and
    host included), and the plain twin's time. Returns {n: (ms, call ms,
    plain ms, bound ms, bound by)}."""
    import numpy as np

    from repro_torch.core.nsga2 import rank_and_crowding

    def twin(x):
        rank, crowd = ref.nsga2_rank_ref(x)
        return torch.stack((rank, crowd.view(torch.int32)))

    rng = np.random.default_rng(27)
    out = {}
    for n in (32, 64):
        m = 5
        rows = rng.random((n, m))
        for objs in (rows, rng.integers(0, 4, size=(n, m))):
            x = torch.as_tensor(objs, dtype=torch.float32, device=device)
            check(torch.equal(ops.nsga2_rank(x), twin(x)),
                  f"nsga2_rank at n={n}: not bit-equal to the plain twin")
        x = torch.as_tensor(rows, dtype=torch.float32, device=device)
        ms = time_ms(lambda: ops.nsga2_rank(x))
        call_ms = time_ms_per_call(
            lambda: rank_and_crowding(rows, "device", device=device))
        plain_ms = time_ms(lambda: twin(x), reps=5, inner=3)
        bound_ms, by = bound(4 * n * m + 8 * n, 4 * n * n * m,
                             PEAK_FP32_INSTR)
        out[n] = (ms, call_ms, plain_ms, bound_ms, by)
        print(f"nsga2_rank n={n} m={m}: {ms:.4f} ms (one rank_and_crowding "
              f"call between events {call_ms:.4f} ms; plain twin "
              f"{plain_ms:.4f} ms; bound {bound_ms:.7f} ms by {by}); "
              f"bit-equal to the plain twin")
    return out


def agnostic_on_card(device="cuda", spec="36", apps=AGNOSTIC_APPS,
                     budget=None) -> None:
    """Phase 11 (c): the application-agnostic study (Fig. 9) on the paper's
    36-tile system, at ``OptimizeBudget()`` defaults, on the card."""
    import numpy as np

    from repro_torch.core.agnostic import run_agnostic_study, summarize
    from repro_torch.noc import named_spec

    t0 = time.perf_counter()
    res = run_agnostic_study(named_spec(spec), apps, "case3", budget,
                             device=device)
    wall = time.perf_counter() - t0
    check(np.allclose(np.diag(res["table"]), 1.0, rtol=0, atol=1e-9),
          "agnostic table: diagonal is not 1")
    print(f"agnostic study spec_{spec} {'/'.join(apps)}: wall {wall:.3f} s; "
          "normalized EDP (row: NoC optimized for; col: app executed)")
    for a, row in zip(apps, res["table"]):
        print(f"  {a:>4s} " + " ".join(f"{v:.6f}" for v in row))
    print("   AVG " + " ".join(f"{v:.6f}" for v in res["avg_row"]))
    print(f"  summary {json.dumps(summarize(res))}")


def workloads_on_card(torch, ops, ref, device="cuda", spec="64",
                      max_evals=500) -> None:
    """Phase 11 (d): MOO-STAGE under yi-6b decode traffic on the card, then
    ``trace_link_report`` of its min-EDP design under yi-6b serving: one K4
    call per phase, each phase's walk held against ``ref.walk_ref`` as
    phase 2 holds K4 (every output bit-equal to the plain version on the
    card and on the CPU), the report within ROW_RTOL of the CPU's."""
    import numpy as np

    from repro_torch.core.agnostic import pick_min_edp
    from repro_torch.noc import Budget, NocProblem, named_spec, run
    from repro_torch.workloads import (link_walk_inputs, trace_for,
                                       trace_link_report)

    problem = NocProblem(spec=named_spec(spec),
                         traffic={"model": "yi-6b", "phase": "serve.decode"})
    t0 = time.perf_counter()
    res = run(problem, "stage", Budget(max_evals=max_evals, seed=0),
              config={"max_local_steps": 40}, device=device)
    wall = time.perf_counter() - t0
    check(len(res.designs) > 0 and math.isfinite(res.phv()),
          "model-traffic search: empty front")
    design, _ = pick_min_edp(None, res.designs, res.objs)
    trace = trace_for("yi-6b", "serving")
    consts, nh, phases = link_walk_inputs(problem.spec, design, trace,
                                          device=device)
    for p, f in phases:
        k4 = ops.walk(nh, f, consts.link_delay, consts.max_hops)
        if device != "cpu":
            check_walk(torch, ops, ref, f"trace phase {p.name}", k4, nh, f,
                       consts.link_delay, consts.max_hops)
    n0 = ops.launches()["walk"]
    t1 = time.perf_counter()
    rep = trace_link_report(problem.spec, design, trace, device=device)
    report_s = time.perf_counter() - t1
    k4 = ops.launches()["walk"] - n0
    if device != "cpu":
        check(k4 == len(trace.phases),
              f"trace_link_report: {k4} K4 launches for "
              f"{len(trace.phases)} phases")
    cpu = trace_link_report(problem.spec, design, trace, device="cpu")
    for key in ("util", "visits"):
        check(np.allclose(rep[key], cpu[key], rtol=ROW_RTOL, atol=0.0),
              f"trace_link_report {key}: card against CPU beyond rtol")
    print(f"stage under {problem.to_json()['traffic']}: wall {wall:.3f} s, "
          f"evals {res.n_evals}, front {len(res.designs)}, phv "
          f"{res.phv():.6g}; trace_link_report (yi-6b serving, "
          f"{len(trace.phases)} phases): {report_s * 1e3:.1f} ms, K4 "
          f"launches {k4}, each phase held against walk_ref, max link "
          f"{rep['max_link']}, mean {rep['mean']:.6g} std {rep['std']:.6g}")


def netsim_host(designs, spec="64", scale=4.0, cycles=3000) -> None:
    """Phase 11 (e): the flit simulator (host numpy, no device) on the mesh
    and the given designs of spec_64 at one injection scale."""
    import numpy as np

    from repro_torch.core import netsim
    from repro_torch.core.traffic import traffic_matrix
    from repro_torch.noc import named_spec

    s = named_spec(spec)
    f = traffic_matrix(s, "BFS")
    t0 = time.perf_counter()
    r = netsim.simulate_batch(s, [s.mesh_design(), *designs], f,
                              scales=(scale,), seeds=(0,), cycles=cycles)
    secs = time.perf_counter() - t0
    check(secs < 30.0, f"netsim took {secs:.1f} s (limit 30 s)")
    check(bool(np.all(r["delivered"] > 0)), "netsim delivered nothing")
    print(f"netsim spec_{spec} BFS x{scale}, {cycles} cycles (uncut), mesh "
          f"and {len(designs)} design(s): {secs:.3f} s on the host; "
          f"throughput {r['throughput'].ravel().tolist()}, mean latency "
          f"{r['mean_latency'].ravel().tolist()}")


# ------------------------------------------------------------- phase 12
#: Phase 12's fleet: four workers of one chain each (the StageDistConfig
#: default) with 4 local steps — with 40, each worker's first local search
#: spends its share of the budget before the meta search (K2, K3) runs.
FLEET_CONFIG = {"n_workers": 4, "max_local_steps": 4}
#: The chaos drill of tests/test_server_chaos.py: request seq 0's worker 0
#: aborts in round 0 (a crash in the in-process executor), request seq 1's
#: worker 1 hangs past the shard deadline. Its deadline and hang are
#: longer on the card (10 s and 12 s against 5 s and 6 s), so that a
#: spawned server's first shard, which opens its CUDA context, stays inside
#: the deadline.
CHAOS_TIMEOUT_S = 10.0
CHAOS_FAULTS = (
    {"kind": "abort", "worker_id": 0, "round": 0, "attempt": 0},
    {"kind": "hang", "worker_id": 100_001, "round": 0, "attempt": 0,
     "hang_s": 12.0},
)
CHAOS_REQ = {"iters_max": 2, "n_swaps": 4, "n_link_moves": 4,
             "max_local_steps": 5, "n_workers": 2, "sync_every": 1}


def _child_ready(t_submit: float, device: str, hold_s: float) -> dict:
    """In a spawned child: import the port, open the device's context and
    load the NoC kernels. Returns the child's pid and, on the
    coordinator's clock from ``t_submit``, when the probe started (the
    interpreter up) and when each step ended, after holding the child for
    ``hold_s`` so that the pool's next probe goes to another child."""
    import os

    t = [time.time()]
    import torch

    from repro_torch.dist.worker import load_kernels

    t.append(time.time())
    torch.zeros(1, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t.append(time.time())
    load_kernels(device)
    t.append(time.time())
    time.sleep(hold_s)
    return {"pid": os.getpid(),
            "steps_s": [round(x - t_submit, 3) for x in t]}


def dist_payload(res) -> str:
    """tests/test_dist.py's canonical payload: wall clocks zeroed, the
    driver-naming headers left out; the JSON float encoding of
    ``RunResult.to_json`` makes it byte-exact."""
    j = res.to_json()
    j["history"] = [[0.0] + row[1:] for row in j["history"]]
    keep = ("problem", "budget", "obj_idx", "designs", "objs", "history",
            "n_evals", "n_calls", "exhausted")
    return json.dumps({k: j[k] for k in keep}, sort_keys=True)


def fleet_spawn_cost(device="cuda", n_workers=4) -> None:
    """Phase 12 (a), first: a fresh spawn pool of ``n_workers`` children,
    each made ready for a shard (the port imported, a context on
    ``device``, the NoC kernels loaded); what every ``process`` run pays."""
    from repro_torch.dist.worker import ShardPool

    t0 = time.time()
    with ShardPool(n_workers) as pool:
        futs = [pool.submit(_child_ready, time.time(), device, 2.0)
                for _ in range(n_workers)]
        ready = [f.result() for f in futs]
    wall = time.time() - t0
    print(f"process executor, {n_workers} children spawned together "
          f"({len({r['pid'] for r in ready})} processes): seconds after "
          "submission at which each child's interpreter was up, torch and "
          "the port imported, its context open, the NoC kernels loaded: "
          f"{[r['steps_s'] for r in ready]}; {wall:.3f} s wall with a 2 s "
          "hold per child and the pool's shutdown")


def fleet_executors(torch, ops, device="cuda", spec="64", max_evals=2000,
                    executors=("serial", "process", "cuda")) -> dict:
    """Phase 12 (a): ``stage_dist`` W=4 on spec_64 (BFS, case5) under each
    executor; the merged results must be equal (designs, objective bytes,
    accounting, PHV). The in-process executors count K1–K4 over their run
    alone (the coordinator's merged-PHV anchor included); ``process``
    counts only that anchor, its workers' launches are in the children.
    Returns the serial run."""
    import numpy as np

    from repro_torch.core.evaluate import Evaluator
    from repro_torch.noc import Budget, NocProblem, named_spec, run

    problem = NocProblem(spec=named_spec(spec), traffic="BFS", case="case5")
    out = {}
    for executor in executors:
        ops.reset_launches()
        t0 = time.perf_counter()
        res = run(problem, "stage_dist", Budget(max_evals=max_evals, seed=0),
                  config=dict(FLEET_CONFIG, executor=executor),
                  device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches_of(ops)
        if device != "cpu" and executor != "process":
            for name in NOC_KERNELS:
                check(counts[name] > 0,
                      f"stage_dist {executor}: {name} never launched")
        phv = res.phv()
        check(len(res.designs) > 0 and math.isfinite(phv) and phv > 0,
              f"stage_dist {executor}: front {len(res.designs)}, PHV {phv}")
        check(not res.extra["worker_failures"],
              f"stage_dist {executor}: {res.extra['worker_failures']}")
        print(f"stage_dist spec_{spec} W=4 {executor}: wall {wall:.3f} s, "
              f"evals {res.n_evals} calls {res.n_calls}, front "
              f"{len(res.designs)}, phv {phv:.6g}, evals per worker "
              f"{[w['n_evals'] for w in res.extra['workers']]}, launches "
              f"{json.dumps(counts)}"
              + (" (the coordinator's anchor only)"
                 if executor == "process" else ""))
        out[executor] = res
    ser = out[executors[0]]
    for executor, res in out.items():
        check(dist_payload(res) == dist_payload(ser)
              and res.phv() == ser.phv(),
              f"stage_dist {executor} differs from {executors[0]}")
    ev_cpu = Evaluator(problem.spec, problem.traffic_matrix(), device="cpu")
    check(np.allclose(ev_cpu.batch(ser.designs), ser.objs, rtol=ROW_RTOL,
                      atol=0.0),
          "stage_dist front re-evaluated on the CPU disagrees")
    print(f"executors {list(executors)}: merged results equal (designs, "
          f"objective bytes, evals/calls, history, PHV)")
    return ser


def fleet_card_vs_cpu(torch, ops, device="cuda", max_evals=600,
                      seeds=(0, 1, 2)) -> None:
    """Phase 12 (b): spec_tiny ``stage_dist`` W=3 ``serial``, card against
    CPU. Each worker's shard is held by ``noc.parity.hold_runs`` (the same
    front, or a knife-edge replayed on the CPU's rows bit for bit); where
    no worker parts, the merged runs must be equal."""
    import numpy as np

    from repro_torch.dist import plan_shards
    from repro_torch.noc import Budget, NocProblem, named_spec, run
    from repro_torch.noc.optimizers import StageDistConfig

    tiny = NocProblem(spec=named_spec("tiny"), traffic="BFS", case="case5")
    cfg = dict(FLEET_CONFIG, n_workers=3)
    dcfg = StageDistConfig(**cfg)
    worker_cfg = {k: getattr(dcfg, k) for k in (
        "n_starts", "iters_max", "n_swaps", "n_link_moves",
        "max_local_steps", "forest_kwargs", "forest_backend",
        "meta_backend")}
    for seed in seeds:
        budget = Budget(max_evals=max_evals, seed=seed)
        parted = []
        for s in plan_shards(tiny, budget, dcfg.n_workers):
            _, counts, part = hold_on_card(torch, ops, tiny, "stage_batch",
                                           s.budget, worker_cfg, device)
            parted.append(part["parted"])
            print(f"  seed {seed} worker {s.worker_id}: launches "
                  f"{json.dumps(counts)}; {parting_text(part)}")
        runs = {d: run(tiny, "stage_dist", budget, config=cfg, device=d)
                for d in (device, "cpu")}
        g, c = runs[device], runs["cpu"]
        if not any(parted):
            check([d.key() for d in g.designs] == [d.key()
                                                   for d in c.designs]
                  and np.allclose(g.objs, c.objs, rtol=ROW_RTOL, atol=0.0)
                  and (g.n_evals, g.n_calls) == (c.n_evals, c.n_calls),
                  f"seed {seed}: equal workers, merged runs differ")
        print(f"stage_dist spec_tiny W=3 seed {seed}: front "
              f"{len(g.designs)}, evals {g.n_evals}; "
              + ("merged runs equal" if not any(parted) else
                 f"workers parted {parted}, each replayed bit for bit"))


def fleet_resume(torch, ops, device="cuda", spec="64", max_evals=2000,
                 executor="cuda") -> None:
    """Phase 12 (c): ``stage_dist`` W=4 with ``sync_every=1`` and round
    checkpoints on spec_64; a ``kill_coordinator`` fault stops the run
    after round 1 and ``resume=True`` finishes it: byte-identical to the
    uninterrupted run."""
    import tempfile

    from repro_torch.dist import CoordinatorKilled
    from repro_torch.noc import Budget, NocProblem, named_spec, run

    problem = NocProblem(spec=named_spec(spec), traffic="BFS", case="case5")
    budget = Budget(max_evals=max_evals, seed=0)
    cfg = dict(FLEET_CONFIG, sync_every=1, iters_max=3, executor=executor)
    ops.reset_launches()
    t0 = time.perf_counter()
    ref = run(problem, "stage_dist", budget, config=cfg, device=device)
    wall = time.perf_counter() - t0
    counts = launches_of(ops)
    with tempfile.TemporaryDirectory() as ckdir:
        killed = False
        try:
            run(problem, "stage_dist", budget, config=dict(cfg, faults=(
                {"kind": "kill_coordinator", "round": 1},)),
                checkpoint_dir=ckdir, device=device)
        except CoordinatorKilled:
            killed = True
        check(killed, "kill_coordinator did not stop the run")
        t0 = time.perf_counter()
        res = run(problem, "stage_dist", budget, config=cfg,
                  checkpoint_dir=ckdir, resume=True, device=device)
        resume_wall = time.perf_counter() - t0
    check(res.extra["resumed_from_round"] == 1,
          f"resumed from {res.extra['resumed_from_round']}")
    check(dist_payload(res) == dist_payload(ref),
          "the resumed run is not the uninterrupted run byte for byte")
    ck = res.extra["checkpoint"]
    print(f"stage_dist spec_{spec} W=4 sync_every=1 {executor}: "
          f"uninterrupted wall {wall:.3f} s, evals {ref.n_evals}, rounds "
          f"{len(ref.extra['history_spans'])} worker-rounds, launches "
          f"{json.dumps(counts)}; killed after round 1, resumed in "
          f"{resume_wall:.3f} s ({ck['n_saves']} round saves, "
          f"{ck['save_s'] * 1e3:.1f} ms in saves): byte-identical")


def fleet_service(torch, ops, device="cuda", spec="64", chaos_spec="36",
                  executor="process") -> None:
    """Phase 12 (d): three requests of two tenants on spec_64 through
    ``Client.local(executor=executor, n_workers=4)`` — one finalised
    partial by its deadline, one a duplicate served from the cache; then
    tests/test_server_chaos.py's kill-and-restart contract on spec_36
    with a ``SubprocessClient`` server on ``device``."""
    import tempfile

    from repro_torch.noc import Budget, NocProblem, RunResult, named_spec
    from repro_torch.noc.server import (Client, NocService, ServiceConfig,
                                        SubprocessClient)

    problem = NocProblem(spec=named_spec(spec), traffic="BFS", case="case5")
    pj = problem.to_json()
    req = dict(FLEET_CONFIG, iters_max=3)
    t0 = time.perf_counter()
    with Client.local(executor=executor, n_workers=4, device=device) as c:
        a = c.submit(pj, Budget(max_evals=800, seed=0).to_json(), req,
                     tenant="alice")
        b = c.submit(pj, Budget(max_evals=800, seed=1).to_json(), req,
                     tenant="bob", deadline_s=1e-3)
        check(a["status"] == b["status"] == "queued", f"{a} {b}")
        summary = c.drain()
        ra, rb = c.result(a["id"]), c.result(b["id"])
        check(isinstance(ra, RunResult) and c.status(a["id"])["status"]
              == "done" and len(ra.designs) > 0, f"request a: {ra}")
        check(isinstance(rb, RunResult) and rb.extra.get("partial") is True
              and c.status(b["id"])["status"] == "partial"
              and len(rb.designs) > 0, f"request b: {rb}")
        dup = c.submit({k: pj[k] for k in reversed(list(pj))},
                       Budget(max_evals=800, seed=0).to_json(), req,
                       tenant="bob")
        hit = c.result(dup["id"])
        check(dup["cache_hit"] is True and hit.n_evals == 0
              and hit.to_json()["designs"] == ra.to_json()["designs"],
              f"duplicate not served from the cache: {dup}")
    wall = time.perf_counter() - t0
    print(f"service spec_{spec} ({executor}, 4 workers, {device}): "
          f"{wall:.3f} s for 3 requests of 2 tenants; request a done, "
          f"evals {ra.n_evals}, front {len(ra.designs)}; request b partial "
          f"after its deadline, front {len(rb.designs)}, evals "
          f"{rb.n_evals}; duplicate of a served from the cache (0 evals); "
          f"waves {summary['wave']}")

    chaos = NocProblem(spec=named_spec(chaos_spec), traffic="BFS",
                       case="case3")
    fleet = dict(n_workers=4, shard_timeout_s=CHAOS_TIMEOUT_S,
                 max_retries=1, device=device)

    def submit_tenants(client):
        ids = {}
        for seed in range(4):
            ack = client.submit(chaos.to_json(),
                                Budget(max_evals=120, seed=seed).to_json(),
                                dict(CHAOS_REQ), tenant=f"t{seed}")
            check(ack.get("status") == "queued", f"chaos submit: {ack}")
            ids[seed] = ack["id"]
        return ids

    t0 = time.perf_counter()
    with Client(NocService(ServiceConfig(faults=CHAOS_FAULTS,
                                         **fleet))) as ref_client:
        ref_ids = submit_tenants(ref_client)
        ref_client.drain()
        ref = {s: dist_payload(ref_client.result(rid))
               for s, rid in ref_ids.items()}
    ref_wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as jdir:
        t0 = time.perf_counter()
        c1 = SubprocessClient(jdir, faults=CHAOS_FAULTS, **fleet)
        try:
            ids = submit_tenants(c1)
            c1.step()
            c1.step()          # requests mid-flight, checkpoints on disk
        finally:
            c1.kill()          # no flush, no goodbye
            c1.close()
        c2 = SubprocessClient(jdir, faults=CHAOS_FAULTS, **fleet)
        try:
            c2.drain()
            results = {}
            for seed, rid in ids.items():
                st = c2.status(rid)
                check(st["status"] == "done", f"chaos request {seed}: {st}")
                results[seed] = c2.result(rid)
                check(dist_payload(results[seed]) == ref[seed],
                      f"chaos request {seed} differs from the fleet that "
                      "was never killed")
            f0 = results[0].extra["worker_failures"]
            f1 = results[1].extra["worker_failures"]
            check([(f["worker_id"], f["phase"]) for f in f0] == [(0, "run")]
                  and [(f["worker_id"], f["phase"]) for f in f1]
                  == [(1, "timeout")]
                  and not results[2].extra["worker_failures"]
                  and not results[3].extra["worker_failures"],
                  f"chaos ledgers: {f0} {f1}")
        finally:
            c2.close()
        wall = time.perf_counter() - t0
    print(f"chaos spec_{chaos_spec}, 4 tenants, SubprocessClient server on "
          f"{device} killed after 2 waves and restarted: every request "
          f"done, byte-identical to the fleet never killed "
          f"({ref_wall:.3f} s in process; {wall:.3f} s with both servers); "
          f"the abort charged t0, the hang t1")


def fleet_spmd(torch, ops, device="cuda", spec="64", bsz=48,
               ser=None) -> None:
    """Phase 12 (e): one spec_64 batch of ``bsz`` designs through the
    ``spmd`` evaluator (each batch split across every visible card, and
    split four ways on the first card alone) and the serial one: equal
    rows. ``ser``, phase (a)'s serial run, is then held against a
    ``stage_dist`` run under ``spmd``."""
    import numpy as np

    from repro_torch.core.evaluate import Evaluator
    from repro_torch.core.problem import random_design
    from repro_torch.core.traffic import traffic_matrix
    from repro_torch.dist.worker import split_devices_for
    from repro_torch.noc import Budget, NocProblem, named_spec, run

    s = named_spec(spec)
    f = traffic_matrix(s, "BFS")
    rng = np.random.default_rng(12)
    designs = [s.mesh_design()] + [random_design(s, rng)
                                   for _ in range(bsz - 1)]
    devices = split_devices_for(device)
    ops.reset_launches()
    split = Evaluator(s, f, device=device, split_devices=devices)
    rows, aux = split.batch_aux(designs)
    counts = launches_of(ops)
    want, want_aux = Evaluator(s, f, device=device).batch_aux(designs)
    check(np.array_equal(rows, want)
          and np.array_equal(aux["net_lat"], want_aux["net_lat"]),
          "spmd rows differ from the serial evaluator's")
    chunks = min(len(devices), bsz)
    if device != "cpu":
        check(counts["minplus"] == counts["walk"] == chunks,
              f"spmd: {counts} launches for {chunks} chunks")
    four, four_aux = Evaluator(s, f, device=device,
                               split_devices=[devices[0]] * 4).batch_aux(
                                   designs)
    check(np.array_equal(four, want)
          and np.array_equal(four_aux["net_lat"], want_aux["net_lat"]),
          f"rows split four ways on {devices[0]} differ from the serial "
          "evaluator's")
    print(f"spmd evaluator, spec_{spec} batch of {bsz} over {len(devices)} "
          f"device(s) {list(devices)}: rows equal to the serial "
          f"evaluator's, K1/K4 launches {counts['minplus']}/"
          f"{counts['walk']}"
          + ("; one device, so the split was trivial (one chunk)"
             if len(devices) == 1 else "")
          + f"; split four ways on {devices[0]}: rows equal too")
    if ser is not None:
        problem = NocProblem(spec=s, traffic="BFS", case="case5")
        res = run(problem, "stage_dist", Budget(max_evals=2000, seed=0),
                  config=dict(FLEET_CONFIG, executor="spmd"), device=device)
        check(dist_payload(res) == dist_payload(ser)
              and res.phv() == ser.phv(),
              "stage_dist spmd differs from serial")
        print("stage_dist spec_64 W=4 spmd: merged result equal to "
              "serial's")


# ----------------------------------------------------- training (13)
#: Phase 13 (a): K5/K6 with a gradient at phase 8's shapes and at a
#: windowed GQA case and a ragged SSD one.
TRAIN_ATTN_CASES = (ATTN_CASES[0], (2, 8, 2, 512, 128, True, 256, "bfloat16"))
TRAIN_SSD_CASES = (SSD_CASES[0], (2, 100, 8, 64, 64, 64))
#: Each input gradient of a Function against autograd through the plain
#: version on the card: largest |difference| as a share of the largest
#: |plain gradient|. The backward recomputes that same plain version, so
#: the two should be bit-equal.
TRAIN_GRAD_REL_TOL = 1e-6
#: Phase 13 (b): zamba2-2.7b at full width, steps of 8 x 512 tokens.
TRAIN_STEPS = 4
TRAIN_BATCH, TRAIN_SEQ = 8, 512
#: Step 0's loss through the kernels against the same loss through the
#: plain versions on the card, relative. Both run the bf16 model; they
#: differ by bf16 roundings of attention and SSD outputs carried through
#: 54 layers, averaged over 4096 tokens.
TRAIN_LOSS_REL_TOL = 5e-3
#: Phase 13 (c): smoke-size losses, card against CPU and resumed against
#: uninterrupted, relative (the reference trainer's own bar).
TRAIN_SMOKE_RTOL = 1e-4


def _grad_case(torch, ops, fn, plain, inputs, g):
    """(forward, grads, kernel launches in forward / in backward) of ``fn``
    through its Function, and the forward and grads of ``plain``."""
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    before = ops.launches()
    out = fn(*ins)
    mid = ops.launches()
    grads = torch.autograd.grad(out, ins, g)
    torch.cuda.synchronize()
    after = ops.launches()
    fwd = {k: mid[k] - before[k] for k in LLM_KERNELS}
    bwd = {k: after[k] - mid[k] for k in LLM_KERNELS}
    pins = [t.detach().clone().requires_grad_(True) for t in inputs]
    pout = plain(*pins)
    pgrads = torch.autograd.grad(pout, pins, g)
    with torch.no_grad():
        wrapper = fn(*inputs)
    return out, grads, fwd, bwd, wrapper, pgrads


def train_fns_on_card(torch, ops, ref, dev) -> None:
    """Phase 13 (a): the K5/K6 autograd Functions on the card. The forward
    is the wrapper's kernel output bit for bit, one launch; the backward
    launches no kernel and gives the plain version's gradients."""
    cases = []
    for case in TRAIN_ATTN_CASES:
        b, h, kh, s, d, causal, window, _ = case
        q, k, v = attn_inputs(torch, case, dev)
        g = torch.randn(q.shape, generator=torch.Generator(
            device=dev).manual_seed(1), device=dev).to(q.dtype)
        cases.append(("flash_attention", case,
                      lambda *a, c=causal, w=window: ops.attention(
                          *a, causal=c, window=w),
                      lambda *a, c=causal, w=window: ref.attention_ref(
                          *a, causal=c, window=w), (q, k, v), g))
    for case in TRAIN_SSD_CASES:
        chunk = case[-1]
        args = ssd_inputs(torch, case, dev)
        g = torch.randn(args[0].shape, generator=torch.Generator(
            device=dev).manual_seed(1), device=dev)
        cases.append(("ssd", case,
                      lambda *a, c=chunk: ops.ssd(*a, chunk=c),
                      lambda *a, c=chunk: ref.ssd_padded_ref(*a, chunk=c),
                      args, g))
    for name, case, fn, plain, inputs, g in cases:
        out, grads, fwd, bwd, wrapper, pgrads = _grad_case(
            torch, ops, fn, plain, inputs, g)
        check(torch.equal(out, wrapper),
              f"{name} {case}: the Function's forward is not the wrapper's")
        check(fwd[name] == 1 and sum(fwd.values()) == 1,
              f"{name} {case}: forward launched {fwd}, expected one {name}")
        check(sum(bwd.values()) == 0,
              f"{name} {case}: backward launched kernels {bwd}")
        worst, equal = 0.0, True
        for i, (a, p) in enumerate(zip(grads, pgrads)):
            check(a.dtype == p.dtype and a.shape == p.shape,
                  f"{name} {case}: grad {i} is {a.dtype} {tuple(a.shape)}")
            diff = float((a.float() - p.float()).abs().max())
            scale = float(p.float().abs().max())
            check(diff <= TRAIN_GRAD_REL_TOL * scale,
                  f"{name} {case}: grad {i} max |diff| {diff} > "
                  f"{TRAIN_GRAD_REL_TOL} x {scale}")
            worst = max(worst, diff / scale if scale else diff)
            equal = equal and torch.equal(a, p)
        print(f"{name} Function {case}: forward bit-equal to the wrapper, "
              f"launches forward {fwd[name]} / backward {sum(bwd.values())};"
              f" {len(grads)} input grads against the plain version: max "
              f"|diff| {worst:.3g} of their scale (tolerance "
              f"{TRAIN_GRAD_REL_TOL}), bit-equal: {equal}")


def train_full_width(torch, ops, ref, dev, card: str) -> None:
    """Phase 13 (b): zamba2-2.7b at full width (f32 master weights, bf16
    compute, remat) trained for TRAIN_STEPS steps of 8 x 512 tokens through
    the step function ``Trainer.run`` calls; K5/K6 launches counted per
    step; step 0's loss against the plain versions; memory, step time and
    one traced step."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.ckpt.checkpoint import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist.sharding import Policy
    from repro_torch.models import build_train
    from repro_torch.train import OptConfig, make_train_fns
    from repro_torch.train.train_step import batch_to

    cfg = get_config("zamba2-2.7b")
    check(cfg.remat and cfg.compute_dtype == torch.bfloat16,
          "zamba2-2.7b: expected remat and bf16 compute")
    steps = TRAIN_STEPS
    model = build_train(cfg, device=dev)
    opt = OptConfig(lr=3e-3, warmup_steps=max(steps // 10, 5),
                    total_steps=steps)
    init_state, step = make_train_fns(model, make_host_mesh(), Policy(), opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"zamba2-2.7b training: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params} parameters (analytic "
          f"{cfg.param_count()}), f32 params + grads + Adam m, v = "
          f"{16 * n_params / 1e9:.2f} GB; state drawn in "
          f"{time.perf_counter() - t0:.1f} s; remat on; steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0))

    # Step 0's loss through the plain versions on the card, on the same
    # initial parameters (the model's modules call ops.attention / ops.ssd,
    # pointed here at the plain versions for this one forward).
    b0 = batch_to(data.batch(0), dev)
    kernels = (ops.attention, ops.ssd)
    try:
        ops.attention, ops.ssd = ref.attention_ref, ref.ssd_padded_ref
        with torch.no_grad():
            plain_loss = model.loss(state["params"], b0).item()
    finally:
        ops.attention, ops.ssd = kernels
    del b0

    n_sites = cfg.n_layers // cfg.attn_every
    want = {"flash_attention": 2 * n_sites, "ssd": 2 * cfg.n_layers}
    losses, norms, walls = [], [], []
    for i in range(steps):
        batch = data.batch(i)
        ops.reset_launches()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = m["loss"].item()
        walls.append(time.perf_counter() - t0)
        launched = {k: ops.launches()[k] for k in LLM_KERNELS}
        losses.append(loss)
        norms.append(m["grad_norm"].item())
        check(launched == want, f"step {i}: launches {launched}, expected "
              f"{want} (forward + remat recompute, none in backward)")
        print(f"step {i}: loss {loss:.6f} grad_norm {norms[-1]:.6f} lr "
              f"{m['lr'].item():.6g} wall {walls[-1] * 1e3:.1f} ms "
              f"launches {json.dumps(launched)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    check(all(math.isfinite(x) for x in losses + norms),
          f"non-finite losses {losses} or grad norms {norms}")
    check(abs(losses[0] - math.log(cfg.vocab)) < 2.5,
          f"step 0 loss {losses[0]} not within 2.5 of ln V "
          f"{math.log(cfg.vocab):.4f}")
    gap = abs(losses[0] - plain_loss) / abs(plain_loss)
    check(gap <= TRAIN_LOSS_REL_TOL, f"step 0 loss {losses[0]} against the "
          f"plain versions' {plain_loss}: {gap} > {TRAIN_LOSS_REL_TOL}")
    check(peak_gb < total_gb, f"peak {peak_gb} GB over the card's {total_gb}")
    warm = statistics.mean(walls[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"{card}: step 0 loss {losses[0]:.6f} against the plain versions' "
          f"{plain_loss:.6f}: relative gap {gap:.3g} (tolerance "
          f"{TRAIN_LOSS_REL_TOL}); ln V {math.log(cfg.vocab):.4f}")
    print(f"{card}: peak memory {peak_gb:.2f} GB of {total_gb:.2f} GB; first "
          f"step {walls[0] * 1e3:.1f} ms; warm step (steps 1-{steps - 1}) "
          f"{warm * 1e3:.1f} ms, {tokens / warm:.0f} tokens/s; per step "
          f"K5 {want['flash_attention']} and K6 {want['ssd']} launches")

    def one_step():
        step(state, data.batch(steps))[1]["loss"].item()

    trace_main_path(
        torch, one_step, warm, "a warm step (mean of steps 1-3)",
        "trace of one training step",
        symbols={"K5 flash_attention": ("flash_tc_kernel", "flash_kernel"),
                 "K6 ssd": ("ssd_kernel",),
                 "GEMMs": ("gemm", "nvjet", "xmma", "cutlass")},
        ranges={"K5 plain backward": ("_AttentionFnBackward",),
                "K6 plain backward": ("_SsdFnBackward",),
                "optimizer": ("train.optimizer",)})
    del state, step, model


def train_smoke_card_vs_cpu(torch, ops, dev) -> None:
    """Phase 13 (c): zamba2 and yi-6b smoke in f32 from one initial state:
    20 ``Trainer.run`` steps on the card and on the CPU; a card run crashed
    after step 12 and resumed from its step-8 checkpoint against the
    uninterrupted card run; the launcher in this process."""
    import tempfile

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist.sharding import Policy
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import build_train
    from repro_torch.train import (OptConfig, TrainConfig, Trainer,
                                   make_train_fns)

    steps = 20
    opt = OptConfig(lr=1e-2, warmup_steps=5, total_steps=steps,
                    weight_decay=0.0)
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        for arch in ("zamba2-2.7b", "yi-6b"):
            cfg = get_config(arch, smoke=True).scaled(
                compute_dtype=torch.float32)
            data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                          global_batch=8, seed=0))
            # One initial state, drawn on the CPU, as every run's step-0
            # checkpoint: each Trainer restores it onto its own device.
            state0 = make_train_fns(build_train(cfg, device="cpu"),
                                    make_host_mesh(), Policy(), opt)[0](0)
            for name in ("card", "cpu", "crash"):
                mgr = CheckpointManager(str(root / arch / name))
                mgr.save(0, state0, blocking=True)
                mgr.close()

            def trainer(name, device):
                return Trainer(build_train(cfg, device=device),
                               make_host_mesh(), Policy(), opt,
                               data, TrainConfig(
                                   steps=steps, ckpt_every=8,
                                   ckpt_dir=str(root / arch / name)))

            ops.reset_launches()
            card = dict(trainer("card", dev).run()["losses"])
            launched = {k: ops.launches()[k] for k in LLM_KERNELS}
            cpu = dict(trainer("cpu", "cpu").run()["losses"])
            worst = max(abs(card[i] - cpu[i]) / abs(cpu[i])
                        for i in range(steps))
            check(sorted(card) == sorted(cpu) == list(range(steps)),
                  f"{arch}: steps ran {sorted(card)} / {sorted(cpu)}")
            check(worst <= TRAIN_SMOKE_RTOL, f"{arch}: card against CPU "
                  f"losses {worst} > {TRAIN_SMOKE_RTOL}")
            check(launched["flash_attention"] > 0 and (
                cfg.family != "hybrid" or launched["ssd"] > 0),
                f"{arch}: kernels not launched on the card: {launched}")
            out = trainer("crash", dev).run(crash_at=12)
            check(out["crashed_at"] == 12, f"{arch}: crash {out}")
            again = trainer("crash", dev)
            check(again.ckpt.latest_step() == 8,
                  f"{arch}: latest checkpoint {again.ckpt.latest_step()}")
            resumed = dict(again.run()["losses"])
            check(min(resumed) == 8, f"{arch}: resumed at {min(resumed)}")
            gap = max(abs(resumed[i] - card[i]) / abs(card[i])
                      for i in range(10, steps))
            check(gap <= TRAIN_SMOKE_RTOL, f"{arch}: resumed losses {gap} > "
                  f"{TRAIN_SMOKE_RTOL} from the uninterrupted card run")
            bit = all(resumed[i] == card[i] for i in range(8, steps))
            print(f"{arch} smoke f32: {steps} Trainer steps, card against "
                  f"CPU max relative loss gap {worst:.3g} (tolerance "
                  f"{TRAIN_SMOKE_RTOL}), losses {card[0]:.4f} -> "
                  f"{card[steps - 1]:.4f}, card launches "
                  f"{json.dumps(launched)}; crashed after step 12, resumed "
                  f"from step 8: steps 10-19 within {gap:.3g}, steps 8-19 "
                  f"bit-equal to the uninterrupted run: {bit}")
        ops.reset_launches()
        check(train_main(["--arch", "zamba2-2.7b", "--smoke", "--steps",
                          str(steps), "--ckpt-dir",
                          str(root / "launch")]) == 0, "launcher failed")
        launched = {k: ops.launches()[k] for k in LLM_KERNELS}
        check(all(launched.values()), f"launcher: launches {launched}")
        print(f"launcher --arch zamba2-2.7b --smoke --steps {steps} on the "
              f"card: launches {json.dumps(launched)}")


# ------------------------------------------------- MoE and encdec (14)
#: Phase 14 (a): qwen3-moe-30b-a3b at full width, bf16 parameters (the
#: only cut: f32 parameters are 122 GB), 8 prompts of 512, 16 new tokens.
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_BATCH, MOE_PROMPT, MOE_NEW = 8, 512, 16
#: The build and the two generates must fit one copy of the weights:
#: peak device memory, GB.
MOE_PEAK_GB = 70.0
#: At most this many prefill rows may part from the plain versions'
#: argmax, and only at a knife-edge: their plain top-2 margin under the
#: measured max |logit diff| (a bf16 K5 can flip a near-tie in a router
#: and so a token's experts; phase 15 holds its models so too).
KNIFE_ROWS = 1
#: Phase 14 (b): whisper-base at full width: 8 windows of 1500 frames
#: (30 s of audio), prompts of 8 tokens, 32 new tokens. Its encoder states
#: through K5 against the plain version: max |diff| as a share of the
#: largest |state|.
WHISPER_BATCH, WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_NEW = 8, 1500, 8, 32
ENC_REL_TOL = PREFILL_REL_TOL
#: Phase 14 (c): smoke-size losses, card against CPU, relative.
ENCDEC_MOE_LOSS_RTOL = 1e-5
#: The MoE layer's profiler ranges (models/moe.py).
MOE_RANGES = {f"moe.{part}": (f"moe.{part}",)
              for part in ("route", "dispatch", "experts", "combine")}
GEMM_SYMBOLS = ("gemm", "nvjet", "xmma", "cutlass")
K5_SYMBOLS = ("flash_tc_kernel", "flash_kernel")


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def hold_logits(torch, got, want, label) -> dict:
    """Last-position logits ``got`` against ``want`` (each (B, 1, V)): max
    |diff| within PREFILL_REL_TOL of the scale; the argmax equal on every
    row but at most KNIFE_ROWS knife-edge rows (``want``'s top-2 margin
    under the max |diff|), each printed."""
    b = got.shape[0]
    lg = got.float().reshape(b, -1)
    pl = want.float().reshape(b, -1)
    check(bool(torch.isfinite(lg).all()), f"{label}: non-finite logits")
    scale = float(pl.abs().max())
    diff = float((lg - pl).abs().max())
    same = lg.argmax(-1) == pl.argmax(-1)
    top2 = pl.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    parted = (~same).nonzero().flatten().tolist()
    knife = [i for i in parted if float(margin[i]) < diff]
    check(diff <= PREFILL_REL_TOL * scale,
          f"{label}: max |logit diff| {diff} > {PREFILL_REL_TOL} x {scale}")
    check(knife == parted and len(knife) <= KNIFE_ROWS,
          f"{label}: next-token argmax differs on rows {parted} (top-2 "
          f"margins {[float(margin[i]) for i in parted]}, max |diff| {diff};"
          f" at most {KNIFE_ROWS} knife-edge row may part)")
    for i in knife:
        print(f"{label}: row {i} parts at a knife-edge: top-2 margin "
              f"{float(margin[i]):.4g} < max |logit diff| {diff:.4g}")
    print(f"{label}: max |logit diff| {diff:.4g} = {diff / scale:.4g} of "
          f"the logits' scale {scale:.4g} (tolerance {PREFILL_REL_TOL}); "
          f"next-token argmax agrees on {int(same.sum())}/{b} rows; top-2 "
          f"margins {[round(m, 4) for m in margin.tolist()]}")
    return {"diff": diff, "scale": scale, "knife": knife}


def hold_prefill(torch, ops, ref, model, tokens, max_len, label,
                 plain=None, keep_caches=False) -> dict:
    """``model``'s prefill through the kernels against the same prefill
    with the wrappers in ``plain`` (``ops`` attribute -> plain version;
    by default K5's ``attention`` -> ``ref.attention_ref``) pointed at
    their plain versions, held by :func:`hold_logits`. With
    ``keep_caches`` the two prefills' caches come back too."""
    plain = plain or {"attention": ref.attention_ref}
    logits, cache = model.prefill(tokens, max_len)
    if not keep_caches:
        del cache
    kernels = {name: getattr(ops, name) for name in plain}
    try:
        for name, fn in plain.items():
            setattr(ops, name, fn)
        want, plain_cache = model.prefill(tokens, max_len)
    finally:
        for name, fn in kernels.items():
            setattr(ops, name, fn)
    _sync(torch, tokens.device)
    out = hold_logits(torch, logits, want,
                      f"{label} against the plain versions on the card")
    if keep_caches:
        out.update(cache=cache, plain_cache=plain_cache)
    return out


def host_syncs(torch, fn) -> list[str]:
    """The host-device synchronisations one call of ``fn`` makes, as
    PyTorch's sync debug mode reports them: one "file:line" of the Python
    line that made each. Only its "called a synchronizing CUDA operation"
    warnings count: the first switch to the mode in a process also warns
    that the mode "does not yet detect all synchronizing operations",
    which is no sync."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def check_decode_syncs(torch, model, cache, step, label) -> None:
    """One ``decode_step`` of ``model`` on ``cache`` (which it advances)
    must make no host sync; the count is printed, and where one is made
    its line."""
    sites = host_syncs(torch, lambda: model.decode_step(cache, step))
    print(f"{label}: host syncs in one decode step: {len(sites)}"
          + (f" at {sorted(set(sites))}" if sites else ""))
    check(not sites, f"{label}: {len(sites)} host syncs in one decode step "
          f"({sorted(set(sites))})")


def moe_dropped_at_layer0(torch, model, tokens) -> tuple[int, int, int]:
    """(dropped, routed, capacity): the (token, choice) pairs that layer
    0's capacity drops in a prefill of ``tokens``, through the model's own
    embedding, attention and norms."""
    from repro_torch.models import moe, transformer
    from repro_torch.models.attention import attn_full
    from repro_torch.models.common import rms_norm

    cfg, rp = model.cfg, model.run_params
    with torch.inference_mode():
        x = transformer._embed(cfg, rp, tokens)
        p0 = transformer.split_layers(rp["layers"], cfg.n_layers)[0]
        h, _ = attn_full(cfg, p0["attn"], rms_norm(x, p0["norm1"],
                                                   cfg.norm_eps), window=0)
        z = rms_norm(x + h, p0["norm2"], cfg.norm_eps).reshape(-1,
                                                               cfg.d_model)
        g_size = min(moe.GROUP_SIZE, z.shape[0])
        n = z.shape[0] // g_size
        r = moe.route(cfg, p0["moe"]["router"],
                      z[:n * g_size].reshape(n, g_size, -1))
        return int((~r.kept).sum()), r.kept.numel(), r.capacity


def serve_moe_full_width(torch, ops, ref, dev, batch=MOE_BATCH,
                         prompt_len=MOE_PROMPT, new=MOE_NEW) -> dict:
    """Phase 14 (a): qwen3-moe-30b-a3b at full width with bf16 parameters
    (the router f32) served through the Engine: K5 launches counted over
    one generate, two generates equal, peak memory, the capacity's drops
    at layer 0, and the prefill held against the plain versions."""
    import numpy as np

    from repro_torch.dist.sharding import Policy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_config(MOE_ARCH).scaled(dtype=torch.bfloat16)
    check(cfg.compute_dtype == torch.bfloat16, "expected bf16 compute")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, seed=0, device=dev)
    _sync(torch, dev)
    build_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in model.buffers())
    w1 = model.params["layers"]["moe"]["w1"]
    check(model.run_params["layers"]["moe"]["w1"] is w1,
          "bf16 expert weights were copied for serving")
    check(model.params["layers"]["moe"]["router"].dtype == torch.float32,
          "the router is not f32")
    print(f"{MOE_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, expert d_ff "
          f"{cfg.moe_d_ff}; {n_params} parameters in bf16 (router f32), "
          f"the config's analytic count {cfg.param_count()} (it counts "
          f"each layer's two norms twice); built in {build_s:.1f} s")
    engine = Engine(model, make_host_mesh(), Policy(), None,
                    ServeConfig(max_new_tokens=new, max_len=prompt_len + new))
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(batch, prompt_len)).astype(np.int32)

    ops.reset_launches()
    out = engine.generate(prompts)
    _sync(torch, dev)
    launches = {k: n for k, n in ops.launches().items() if k in LLM_KERNELS}
    cold = dict(engine.stats)
    check(launches == {"flash_attention": cfg.n_layers, "ssd": 0},
          f"launches {launches}, expected K5 {cfg.n_layers} (one per layer's "
          f"prefill attention; decode runs no kernel)")
    check(out.shape == (batch, new) and out.dtype == np.int32,
          f"generate returned {out.shape} {out.dtype}")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()), "token out of range")
    t0 = time.perf_counter()
    out2 = engine.generate(prompts)
    wall = time.perf_counter() - t0
    st = engine.stats
    check(np.array_equal(out, out2), "two generates differ")
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
               else 0.0)
    check(peak_gb < MOE_PEAK_GB, f"peak memory {peak_gb:.2f} GB >= "
          f"{MOE_PEAK_GB} GB: two copies of the weights?")
    prefill_ms = st["prefill_s"] * 1e3
    decode_ms = st["decode_s"] * 1e3 / st["decode_steps"]
    tokens = torch.as_tensor(prompts.astype(np.int64), device=dev)
    dropped, routed, cap = moe_dropped_at_layer0(torch, model, tokens)
    print(f"generate (warm): wall {wall * 1e3:.1f} ms, prefill "
          f"{prefill_ms:.1f} ms, decode {decode_ms:.2f} ms per step "
          f"({st['decode_steps']} steps of batch {batch}), "
          f"{out.size / wall:.1f} generated tokens/s; peak memory "
          f"{peak_gb:.2f} GB (build included); first (cold) generate: "
          f"prefill {cold['prefill_s'] * 1e3:.1f} ms, decode "
          f"{cold['decode_s'] * 1e3:.1f} ms")
    print(f"launches in one generate: {json.dumps(launches)}; layer 0 of the "
          f"prefill drops {dropped} of {routed} (token, choice) pairs at "
          f"capacity {cap} per expert and group of "
          f"{min(1024, batch * prompt_len)}")
    print(f"sample tokens: {out[0].tolist()}")
    if dev.type == "cuda":
        _, cache = model.prefill(tokens, prompt_len + new)
        step = torch.as_tensor(out[:, :1].astype(np.int64), device=dev)
        check_decode_syncs(torch, model, cache, step,
                           f"{MOE_ARCH} ({cfg.n_layers} layers)")
        del cache
    hold_prefill(torch, ops, ref, model, tokens, prompt_len + new,
                 f"{MOE_ARCH} prefill")
    return {"engine": engine, "prompts": prompts, "wall": wall,
            "prefill_s": st["prefill_s"], "tokens": tokens,
            "max_len": prompt_len + new}


def greedy_encdec(torch, model, frames, prompts, new):
    """Greedy generation of an encoder-decoder: prefill, then ``new - 1``
    decode steps, the first maximum on ties. Returns (tokens (B, new)
    int32 numpy, prefill s, decode s), each time ending in a sync."""
    dev = model.device
    t0 = time.perf_counter()
    logits, cache = model.prefill(frames, prompts, prompts.shape[1] + new)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out = [tok]
    _sync(torch, dev)
    t1 = time.perf_counter()
    for _ in range(new - 1):
        logits, cache = model.decode_step(cache, tok)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok)
    result = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
    return result, t1 - t0, time.perf_counter() - t1


def serve_whisper_full_width(torch, ops, ref, dev, batch=WHISPER_BATCH,
                             n_frames=WHISPER_FRAMES,
                             prompt_len=WHISPER_PROMPT,
                             new=WHISPER_NEW) -> None:
    """Phase 14 (b): whisper-base at full width: ``build(...).prefill``
    and a greedy decode loop on seeded stub frames; K5 launches counted
    (all in the encoder), two generates equal, the encoder states held
    against the plain version on the card."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = get_config("whisper-base")
    model = build(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    frames = torch.as_tensor(rng.standard_normal(
        (batch, n_frames, cfg.d_model)).astype(np.float32), device=dev)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab, size=(batch, prompt_len)), device=dev)
    n_params = sum(v.numel() for v in model.buffers())
    print(f"whisper-base: {cfg.encoder_layers} encoder and {cfg.n_layers} "
          f"decoder layers, d_model {cfg.d_model}, {n_params} parameters; "
          f"frames ({batch}, {n_frames}, {cfg.d_model}), prompts of "
          f"{prompt_len}, {new} new tokens")
    ops.reset_launches()
    out, _, _ = greedy_encdec(torch, model, frames, prompts, new)
    launches = {k: n for k, n in ops.launches().items() if k in LLM_KERNELS}
    check(launches == {"flash_attention": cfg.encoder_layers, "ssd": 0},
          f"launches {launches}, expected K5 {cfg.encoder_layers} (the "
          f"encoder's layers; decode runs no kernel)")
    check(out.shape == (batch, new), f"generated {out.shape}")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()), "token out of range")
    out2, prefill_s, decode_s = greedy_encdec(torch, model, frames, prompts,
                                              new)
    check(np.array_equal(out, out2), "two whisper generates differ")
    print(f"whisper generate (warm): prefill {prefill_s * 1e3:.2f} ms "
          f"(encode + cross K/V + {prompt_len} decode steps), decode "
          f"{decode_s * 1e3 / (new - 1):.2f} ms per step, "
          f"{out.size / (prefill_s + decode_s):.1f} generated tokens/s; "
          f"launches {json.dumps(launches)}")
    print(f"sample tokens: {out[0].tolist()}")
    if dev.type == "cuda":
        _, cache = model.prefill(frames, prompts, prompt_len + new)
        step = torch.as_tensor(out[:, :1].astype(np.int64), device=dev)
        check_decode_syncs(torch, model, cache, step,
                           f"whisper-base ({cfg.n_layers} decoder layers)")
        del cache

    enc = model.encode(frames)
    kernel = ops.attention
    try:
        ops.attention = ref.attention_ref
        plain = model.encode(frames)
    finally:
        ops.attention = kernel
    _sync(torch, dev)
    check(bool(torch.isfinite(enc).all()), "non-finite encoder states")
    scale = float(plain.float().abs().max())
    diff = float((enc.float() - plain.float()).abs().max())
    check(diff <= ENC_REL_TOL * scale, f"encoder states: max |diff| {diff} >"
          f" {ENC_REL_TOL} x {scale}")
    print(f"encoder states against the plain version on the card: max "
          f"|diff| {diff:.4g} = {diff / scale:.4g} of their scale "
          f"{scale:.4g} (tolerance {ENC_REL_TOL})")


def encdec_moe_smoke_card_vs_cpu(torch, dev) -> None:
    """Phase 14 (c): the qwen3-moe, moonshot and whisper smoke configs in
    f32 generate the same tokens on the card and the CPU; one
    ``build_train`` loss of qwen3-moe and of whisper, card against CPU."""
    import numpy as np

    from repro_torch.dist.sharding import Policy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import build, build_train
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.train.train_step import batch_to

    rng = np.random.default_rng(1)
    for arch in (MOE_ARCH, "moonshot-v1-16b-a3b", "whisper-base"):
        cfg = get_config(arch, smoke=True).scaled(compute_dtype=torch.float32)
        on_card = build(cfg, seed=1, device=dev)
        on_cpu = build(cfg, _to_cpu(on_card.params), device="cpu")
        if cfg.family == "encdec":
            frames = torch.as_tensor(rng.standard_normal(
                (4, 200, cfg.d_model)).astype(np.float32))
            prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 8)))
            a = greedy_encdec(torch, on_card, frames, prompts, 8)[0]
            b = greedy_encdec(torch, on_cpu, frames, prompts, 8)[0]
        else:
            prompts = rng.integers(1, cfg.vocab, (4, 100)).astype(np.int32)
            scfg = ServeConfig(max_new_tokens=8, max_len=128)
            host = make_host_mesh()
            a = Engine(on_card, host, Policy(), None, scfg).generate(prompts)
            b = Engine(on_cpu, host, Policy(), None, scfg).generate(prompts)
        check(np.array_equal(a, b), f"smoke {arch}: card and CPU tokens "
              f"differ")
        print(f"smoke {arch} (f32): card and CPU generate identical tokens")

    for arch in (MOE_ARCH, "whisper-base"):
        cfg = get_config(arch, smoke=True).scaled(compute_dtype=torch.float32)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                      global_batch=4, seed=0))
        batch = (data.frames_batch(0, cfg.d_model, 16)
                 if cfg.family == "encdec" else data.batch(0))
        card_model = build_train(cfg, device=dev)
        params = card_model.init(0)
        with torch.no_grad():
            card = card_model.loss(params, batch_to(batch, dev)).item()
            cpu = build_train(cfg, device="cpu").loss(
                _to_cpu(params), batch_to(batch, "cpu")).item()
        gap = abs(card - cpu) / abs(cpu)
        check(gap <= ENCDEC_MOE_LOSS_RTOL, f"smoke {arch}: loss card {card} "
              f"against CPU {cpu}: {gap} > {ENCDEC_MOE_LOSS_RTOL}")
        print(f"smoke {arch} (f32): build_train loss card {card:.6f}, CPU "
              f"{cpu:.6f}, relative gap {gap:.3g} (tolerance "
              f"{ENCDEC_MOE_LOSS_RTOL})")


def attn_pairs(b, h, s, causal, window) -> int:
    """(q, k) pairs under the mask of one (B, H, S, S) attention."""
    if not causal:
        return b * h * s * s
    w = window or s
    # Row i sees min(i + 1, w) keys.
    return b * h * (w * (w + 1) // 2 + (s - w) * w)


def time_k5_shapes(torch, ops, ref, dev, cases) -> None:
    """K5 at ``cases``: the kernel, its plain version, PyTorch's own
    attention call (with a boolean mask where there is a window) and the
    bound, each printed."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for case in cases:
        b, h, kh, s, d, causal, window, _ = case
        q, k, v = attn_inputs(torch, case, dev)
        ms = time_ms(lambda: ops.attention(q, k, v, causal=causal,
                                           window=window))
        plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, causal=causal,
                                                     window=window), reps=5)
        if window is None:
            lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=causal,
                                          enable_gqa=True))
        else:
            pos = torch.arange(s, device=dev)
            mask = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))
            lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask,
                                          enable_gqa=True))
        pairs = attn_pairs(b, h, s, causal, window)
        n_bytes = 2 * (2 * b * h * s * d + 2 * b * kh * s * d)
        bound_ms, bound_by = bound(n_bytes, 4 * d * pairs, PEAK_BF16_FLOPS)
        print(f"K5 B={b} H={h} KH={kh} S={s} D={d} causal={causal} "
              f"window={window} bf16: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention{' with a boolean mask' if window else ''} "
              f"{lib_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by}: "
              f"{n_bytes / 1e6:.1f} MB, {4 * d * pairs / 1e9:.2f} GFLOP)")


# ------------------------------------------- five more architectures (15)
#: Phase 15: the architectures no card run had reached, at full width with
#: seeded random weights and seeded prompts of SERVE_BATCH rows. (a) dense,
#: bf16 parameters (66.69 GB; f32 would be 133.38 GB) through ``Engine``;
#: (b) the vlm family, bf16, through the serve launcher's entry point, and
#: the one config no card holds, refused; (c) gemma3's 5:1 local/global
#: attention with prompts past its 512-token window, f32 parameters and
#: bf16 compute as the config has them; (d) the pure-SSM family, f32
#: parameters.
DENSE_ARCH = "deepseek-coder-33b"
VLM_ARCH = "chameleon-34b"
TOO_BIG_ARCH = "mistral-large-123b"
WINDOW_ARCH = "gemma3-1b"
SSM_ARCH = "mamba2-1.3b"
FIVE_ARCHS = (WINDOW_ARCH, SSM_ARCH, VLM_ARCH, DENSE_ARCH, TOO_BIG_ARCH)
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 512, 16
WINDOW_PROMPT = 2048
#: Peak device memory, GB: one copy of the weights, the KV cache and one
#: prefill's activations (66.69 + 1.09 GB; 68.59 + 0.84 GB).
DENSE_PEAK_GB = 72.0
VLM_PEAK_GB = 75.0
#: gemma3's windowed decode is held against a prefill of the prompt and
#: the tokens generated so far, after these decode steps.
WINDOW_CHECK_STEPS = (1, 8, 16)
#: mamba2's prefill hands decode the final SSM state of every layer; K6's
#: against the plain chunked form's, max |err| as a share of the largest
#: |state|: layer 0 (the same inputs, so the kernel's arithmetic alone:
#: 3xTF32 against f32) and every layer (where the bf16 roundings of each
#: layer's output carry the difference forward, as in the logits).
SSM_STATE_L0_RTOL = 1e-4
SSM_STATE_RTOL = PREFILL_REL_TOL
#: (e): smoke-size train steps card against CPU.
SMOKE_TRAIN_STEPS = 3


def release(torch) -> None:
    """Free what the last model left (its tensors are unreferenced by
    now), empty the allocator's cache and restart the peak count."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def serve_held(torch, ops, ref, dev, cfg, prompt_len, want, plain,
               peak_gb=None, keep_caches=False) -> dict:
    """``cfg`` at full width served through ``Engine``: SERVE_BATCH seeded
    prompts of ``prompt_len``, SERVE_NEW new tokens; K5/K6 launches
    counted over one generate (``want``), two generates equal, no host
    sync in a decode step, the prefill held against the model with the
    wrappers in ``plain`` pointed at their plain versions, and the peak
    memory (under ``peak_gb`` where given). Returns the model, the prompt
    tokens, the launches and :func:`hold_prefill`'s result."""
    import numpy as np

    from repro_torch.dist.sharding import Policy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.serve import Engine, ServeConfig

    name = cfg.name
    t0 = time.perf_counter()
    model = build(cfg, seed=0, device=dev)
    _sync(torch, dev)
    build_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in model.buffers())
    print(f"{name}: {cfg.family}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params} parameters in "
          f"{str(cfg.dtype).split('.')[-1]} (the config's analytic count "
          f"{cfg.param_count()}), compute "
          f"{str(cfg.compute_dtype).split('.')[-1]}; built in {build_s:.1f} s")
    max_len = prompt_len + SERVE_NEW
    engine = Engine(model, make_host_mesh(), Policy(), None,
                    ServeConfig(max_new_tokens=SERVE_NEW, max_len=max_len))
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(SERVE_BATCH, prompt_len)).astype(np.int32)
    ops.reset_launches()
    out = engine.generate(prompts)
    _sync(torch, dev)
    launches = {k: n for k, n in ops.launches().items() if k in LLM_KERNELS}
    cold = dict(engine.stats)
    check(launches == want, f"{name}: launches {launches}, expected {want}")
    check(out.shape == (SERVE_BATCH, SERVE_NEW) and out.dtype == np.int32,
          f"{name}: generate returned {out.shape} {out.dtype}")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()),
          f"{name}: token out of range")
    t0 = time.perf_counter()
    out2 = engine.generate(prompts)
    wall = time.perf_counter() - t0
    st = engine.stats
    check(np.array_equal(out, out2), f"{name}: two generates differ")
    prefill_ms = st["prefill_s"] * 1e3
    decode_ms = st["decode_s"] * 1e3 / st["decode_steps"]
    print(f"{name} generate (warm): wall {wall * 1e3:.1f} ms, prefill "
          f"{prefill_ms:.1f} ms, decode {decode_ms:.2f} ms per step "
          f"({st['decode_steps']} steps of batch {SERVE_BATCH}), "
          f"{out.size / wall:.1f} generated tokens/s; first (cold) generate:"
          f" prefill {cold['prefill_s'] * 1e3:.1f} ms, decode "
          f"{cold['decode_s'] * 1e3:.1f} ms; launches in one generate "
          f"{json.dumps(launches)}")
    print(f"{name} sample tokens: {out[0].tolist()}")
    tokens = torch.as_tensor(prompts.astype(np.int64), device=dev)
    _, cache = model.prefill(tokens, max_len)
    check_decode_syncs(torch, model, cache,
                       torch.as_tensor(out[:, :1].astype(np.int64),
                                       device=dev), name)
    del cache
    held = hold_prefill(torch, ops, ref, model, tokens, max_len,
                        f"{name} prefill", plain=plain,
                        keep_caches=keep_caches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{name}: peak memory {peak:.2f} GB (build, two generates and the "
          f"two prefills held included)")
    if peak_gb is not None:
        check(peak < peak_gb, f"{name}: peak memory {peak:.2f} GB >= "
              f"{peak_gb} GB")
    return {"model": model, "tokens": tokens, "launches": launches,
            "held": held}


def serve_dense_full_width(torch, ops, ref, dev) -> dict:
    """Phase 15 (a): deepseek-coder-33b with bf16 parameters: one K5
    launch per layer in a generate, none in decode."""
    from repro_torch.configs import get_config

    cfg = get_config(DENSE_ARCH).scaled(dtype=torch.bfloat16)
    r = serve_held(torch, ops, ref, dev, cfg, SERVE_PROMPT,
                   {"flash_attention": cfg.n_layers, "ssd": 0},
                   {"attention": ref.attention_ref}, peak_gb=DENSE_PEAK_GB)
    return r["launches"]


def serve_vlm_by_launcher(torch, ops, dev) -> dict:
    """Phase 15 (b): chameleon-34b through the serve launcher's own entry
    point with ``--dtype bfloat16``; then mistral-large-123b, which no one
    card holds even in bf16, refused before anything is allocated."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve

    cfg = get_config(VLM_ARCH)
    ops.reset_launches()
    argv = ["--arch", VLM_ARCH, "--dtype", "bfloat16", "--batch",
            str(SERVE_BATCH), "--prompt-len", str(SERVE_PROMPT), "--new",
            str(SERVE_NEW)]
    check(launch_serve.main(argv) == 0, f"serve launcher {argv} failed")
    _sync(torch, dev)
    launches = {k: n for k, n in ops.launches().items() if k in LLM_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(launches == {"flash_attention": cfg.n_layers, "ssd": 0},
          f"{VLM_ARCH}: launches {launches}, expected K5 {cfg.n_layers}")
    check(peak < VLM_PEAK_GB, f"{VLM_ARCH}: peak memory {peak:.2f} GB >= "
          f"{VLM_PEAK_GB} GB")
    print(f"launcher {' '.join(argv)}: exit 0, launches "
          f"{json.dumps(launches)}, peak memory {peak:.2f} GB")
    release(torch)
    before = torch.cuda.memory_allocated()
    argv = ["--arch", TOO_BIG_ARCH, "--dtype", "bfloat16"]
    try:
        launch_serve.main(argv)
        refused = None
    except SystemExit as exc:
        refused = str(exc)
    check(refused is not None and "245.2 GB" in refused,
          f"launcher {argv}: not refused naming 245.2 GB ({refused})")
    after = torch.cuda.memory_allocated()
    check(after == before, f"launcher {argv}: allocated {after - before} "
          f"bytes before refusing")
    print(f"launcher {' '.join(argv)}: refused, {after - before} bytes "
          f"allocated: {refused}")
    return launches


def serve_window_full_width(torch, ops, ref, dev) -> dict:
    """Phase 15 (c): gemma3-1b at 8 x 2048 (22 layers with a 512-token
    window, 4 global): the prefill held against the plain attention, and
    the windowed decode held against prefill after decode steps 1, 8 and
    16."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import window_schedule

    cfg = get_config(WINDOW_ARCH)
    sched = window_schedule(cfg)
    local = sum(1 for w in sched if w)
    print(f"{WINDOW_ARCH}: window {cfg.sliding_window} on {local} layers, "
          f"global on {len(sched) - local} "
          f"({[i for i, w in enumerate(sched) if not w]}); prompts of "
          f"{WINDOW_PROMPT}")
    r = serve_held(torch, ops, ref, dev, cfg, WINDOW_PROMPT,
                   {"flash_attention": cfg.n_layers, "ssd": 0},
                   {"attention": ref.attention_ref})
    model, tokens = r["model"], r["tokens"]
    max_len = WINDOW_PROMPT + max(WINDOW_CHECK_STEPS) + 1
    logits, cache = model.prefill(tokens, max_len)
    fed = []
    for step in range(1, max(WINDOW_CHECK_STEPS) + 1):
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        fed.append(tok)
        logits, cache = model.decode_step(cache, tok)
        if step in WINDOW_CHECK_STEPS:
            seq = torch.cat([tokens, *fed], dim=1)
            want, _ = model.prefill(seq, seq.shape[1])
            _sync(torch, dev)
            hold_logits(torch, logits, want,
                        f"{WINDOW_ARCH} decode step {step} (position "
                        f"{seq.shape[1] - 1}, keys {seq.shape[1] - cfg.sliding_window}"
                        f"-{seq.shape[1] - 1} in the window) against the "
                        f"prefill of the same {seq.shape[1]} tokens")
    return r["launches"]


def serve_ssm_full_width(torch, ops, ref, dev) -> dict:
    """Phase 15 (d): mamba2-1.3b: one K6 launch per layer in a generate,
    the plain recurrent decode; the prefill and the SSM states it hands
    to decode held against the plain chunked form."""
    from repro_torch.configs import get_config

    cfg = get_config(SSM_ARCH)
    r = serve_held(torch, ops, ref, dev, cfg, SERVE_PROMPT,
                   {"flash_attention": 0, "ssd": cfg.n_layers},
                   {"ssd": ref.ssd_chunked_ref}, keep_caches=True)
    got, want = r["held"]["cache"]["ssm"], r["held"]["plain_cache"]["ssm"]
    check(bool(torch.isfinite(got).all()), f"{SSM_ARCH}: non-finite states")
    err = (got - want).abs()
    for label, e, w, tol in (
            ("layer 0", err[0], want[0], SSM_STATE_L0_RTOL),
            (f"all {cfg.n_layers} layers", err, want, SSM_STATE_RTOL)):
        e, scale = float(e.max()), float(w.abs().max())
        check(e <= tol * scale, f"{SSM_ARCH} SSM state, {label}: max |err| "
              f"{e} > {tol} x {scale}")
        print(f"{SSM_ARCH} SSM state handed to decode, {label}: max |err| "
              f"{e:.4g} = {e / scale:.4g} of its scale {scale:.4g} "
              f"(tolerance {tol})")
    return r["launches"]


def five_smoke_card_vs_cpu(torch, ops, dev) -> None:
    """Phase 15 (e): the five architectures' smoke configs in f32: tokens
    card = CPU (prompts of 70: past the gemma3 smoke's window of 8, a
    padded SSD tail), and SMOKE_TRAIN_STEPS train steps' losses card
    against CPU from one initial state."""
    import numpy as np

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.ckpt.checkpoint import tree_leaves, tree_unflatten
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist.sharding import Policy
    from repro_torch.models import build, build_train
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.train import OptConfig, make_train_fns

    rng = np.random.default_rng(2)
    for arch in FIVE_ARCHS:
        cfg = get_config(arch, smoke=True).scaled(compute_dtype=torch.float32)
        on_card = build(cfg, seed=1, device=dev)
        on_cpu = build(cfg, _to_cpu(on_card.params), device="cpu")
        prompts = rng.integers(1, cfg.vocab, (4, 70)).astype(np.int32)
        scfg = ServeConfig(max_new_tokens=8, max_len=96)
        ops.reset_launches()
        host = make_host_mesh()
        a = Engine(on_card, host, Policy(), None, scfg).generate(prompts)
        launched = {k: ops.launches()[k] for k in LLM_KERNELS}
        b = Engine(on_cpu, host, Policy(), None, scfg).generate(prompts)
        check(np.array_equal(a, b), f"smoke {arch}: card and CPU tokens "
              f"differ")
        check(sum(launched.values()) == cfg.n_layers,
              f"smoke {arch}: launches {launched}")

        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                      global_batch=4))
        opt = OptConfig(lr=1e-2, warmup_steps=2)
        state0 = make_train_fns(build_train(cfg, device="cpu"),
                                make_host_mesh(), Policy(), opt)[0](0)
        losses = {}
        for device in ("cpu", dev):
            step = make_train_fns(build_train(cfg, device=device),
                                  make_host_mesh(), Policy(),
                                  opt)[1]
            state = tree_unflatten(state0, [
                t.detach().to(device, copy=True) for t in tree_leaves(state0)])
            for p in tree_leaves(state["params"]):
                p.requires_grad_(True)
            losses[str(device)] = [step(state, data.batch(i))[1]["loss"].item()
                                   for i in range(SMOKE_TRAIN_STEPS)]
        gap = max(abs(c - h) / abs(h) for c, h in zip(losses[str(dev)],
                                                       losses["cpu"]))
        check(gap <= TRAIN_SMOKE_RTOL, f"smoke {arch}: train losses card "
              f"{losses[str(dev)]} against CPU {losses['cpu']}: {gap} > "
              f"{TRAIN_SMOKE_RTOL}")
        print(f"smoke {arch} (f32): card and CPU generate identical tokens "
              f"(card launches {json.dumps(launched)}); {SMOKE_TRAIN_STEPS} "
              f"train steps' losses {[round(x, 5) for x in losses['cpu']]}, "
              f"card against CPU within {gap:.3g} (tolerance "
              f"{TRAIN_SMOKE_RTOL})")


def time_k6_shape(torch, ops, ref, dev, case) -> None:
    """K6 at ``case``: the kernel, its plain version (no PyTorch call
    computes it) and the bound, printed."""
    b, s, h, p, n, chunk = case
    args = ssd_inputs(torch, case, dev)
    ms = time_ms(lambda: ops.ssd(*args, chunk=chunk, return_state=True))
    plain_ms = time_ms(lambda: ref.ssd_padded_ref(*args, chunk=chunk,
                                                  return_state=True), reps=5)
    n_bytes, n_ops = ssd_work(case)
    bound_ms, bound_by = bound(n_bytes, 3 * n_ops, PEAK_TF32_FLOPS)
    print(f"K6 B={b} S={s} H={h} P={p} N={n} chunk={chunk}: {ms:.4f} ms "
          f"(plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by}:"
          f" {n_bytes / 1e6:.1f} MB, {3 * n_ops / 1e9:.2f} GFLOP as "
          f"3xTF32)")


# ------------------------------------------------------------------ phase 16
#: Phase 16: the multi-card path. (a) runs phase 9's serving shape and
#: phase 13's training shape on a one-rank mesh; (b) two ranks sharing
#: the card over gloo; (c) four cards (``--cards 4``).
MESH_ARCH, MESH_DENSE, MESH_MOE_LAYERS = "zamba2-2.7b", "yi-6b", 4
MESH_STEPS = 2
#: (b) trains zamba2 cut to 12 of its 54 layers (2 shared-attention
#: sites): gloo stages every gather and reduce-scatter through the host,
#: 37-115 s a step at full depth on an H100's host. (c) trains it whole
#: over NVLink.
MESH_GLOO_LAYERS = 12
MESH_LOSS_RTOL = 1e-5
#: The step-0 grad norm: the gradients reduced over the mesh against one
#: card's microbatches, f32 sums in another order.
MESH_NORM_RTOL = 1e-6
#: (c)'s step-1 loss on four cards against one card's: 5.47e-5 relative
#: was read on four H100s (NCCL's ring order carried through AdamW's first
#: step); the limit leaves that reading a factor of ~4.
MESH_STEP1_RTOL = 2e-4
RANKS_TIMEOUT_S = 600
TORCHRUN_TIMEOUT_S = 900


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _llm_launches(ops) -> dict:
    return {k: n for k, n in ops.launches().items() if k in LLM_KERNELS}


def mesh_train_losses(torch, ops, dev, mesh, microbatches=1,
                      n_layers=None, steps=MESH_STEPS) -> dict:
    """``steps`` steps of zamba2-2.7b at full width (phase 13's shape; its
    depth cut to ``n_layers`` where given) from seed 0 through
    ``make_train_fns``, on ``mesh`` (None: ``make_host_mesh()``) with
    ``microbatches``: the losses, the grad norms, the K5/K6 launches over
    the steps, step ms and peak GB.

    A mesh of n data shards computes what one rank computes with n
    microbatches: each rank's rows' gradients, rounded in the bf16
    compute, then summed in f32. One rank with one microbatch rounds the
    whole batch's gradients in bf16 instead, and AdamW's first step
    carries that difference into the next loss (1.6e-4 relative on (2, 1)
    at full depth on an H100). The batches carry no loss mask: with the
    pipeline's (BOS targets dropped) the halves count different tokens,
    and a microbatched step averages the halves' means where the mesh
    takes the whole batch's mean."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist.sharding import Policy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_train
    from repro_torch.train import OptConfig, make_train_fns

    cfg = get_config(MESH_ARCH)
    if n_layers is not None:
        cfg = cfg.scaled(n_layers=n_layers)
    opt = OptConfig(lr=3e-3, warmup_steps=5, total_steps=TRAIN_STEPS)
    model = build_train(cfg, device=dev)
    policy = Policy(microbatches=microbatches)
    init_state, step = make_train_fns(
        model, make_host_mesh() if mesh is None else mesh, policy, opt)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0))
    state = init_state(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, walls = [], [], []
    ops.reset_launches()
    for i in range(steps):
        t0 = time.perf_counter()
        batch = {k: v for k, v in data.batch(i).items() if k != "mask"}
        state, m = step(state, batch)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        walls.append(time.perf_counter() - t0)
    launched = _llm_launches(ops)
    out = {"losses": losses, "grad_norms": norms, "launches": launched,
           "step_ms": [w * 1e3 for w in walls],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del state, step, model
    release(torch)
    return out


def mesh_one_rank(torch, ops, dev) -> dict:
    """Phase 16 (a): a one-rank NCCL group and ``make_host_mesh()``'s (1, 1)
    mesh. zamba2-2.7b at full width through ``Engine(model, mesh,
    Policy(), None, cfg)``, 8 x 512 prompts, 16 new tokens, tokens and
    K5/K6 launches equal to those on a (1, 1) mesh with no process group
    (the meshless path), no host sync in a decode step; MESH_STEPS
    training steps (phase 13's shape) on both, losses bit-equal; the train
    launcher with ``--distributed`` on the group (smoke config). Returns
    the group's path's K5/K6 launches."""
    import os
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import Policy
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import Mesh, init_distributed, make_host_mesh
    from repro_torch.models import build
    from repro_torch.serve import Engine, ServeConfig

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    dev = init_distributed("cuda")
    mesh = make_host_mesh()
    check(mesh.shape == {"data": 1, "model": 1} and mesh.backend == "nccl"
          and dist.get_world_size() == 1,
          f"one-rank mesh {mesh.shape} over {mesh.backend}")
    cfg = get_config(MESH_ARCH)
    model = build(cfg, seed=0, device=dev)
    scfg = ServeConfig(max_new_tokens=SERVE_NEW,
                       max_len=SERVE_PROMPT + SERVE_NEW)
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    runs = {}
    meshless = Mesh(("data", "model"), (1, 1))        # no process group
    for name, engine in (("meshless", Engine(model, meshless, Policy(), None,
                                             scfg)),
                         ("mesh", Engine(model, mesh, Policy(), None, scfg))):
        engine.generate(prompts)                      # warm
        ops.reset_launches()
        out = engine.generate(prompts)
        torch.cuda.synchronize()
        runs[name] = (out, _llm_launches(ops), dict(engine.stats))
    (a, la, _), (b, lb, st) = runs["meshless"], runs["mesh"]
    check(np.array_equal(a, b), "(1, 1) mesh: tokens differ from the "
          "meshless engine's")
    check(la == lb, f"(1, 1) mesh: launches {lb}, meshless {la}")
    check(engine.model is model and model.plan is None,
          "(1, 1) mesh: the engine should serve the meshless model")
    tokens = torch.as_tensor(prompts.astype(np.int64), device=dev)
    _, cache = engine.model.prefill(tokens, scfg.max_len)
    check_decode_syncs(torch, engine.model, cache,
                       torch.as_tensor(b[:, :1].astype(np.int64), device=dev),
                       f"{MESH_ARCH} on the (1, 1) mesh")
    print(f"(a) {MESH_ARCH} on make_host_mesh() {mesh.shape} over "
          f"{mesh.backend}: tokens bit-equal to the meshless engine's, "
          f"launches {json.dumps(lb)} both; prefill "
          f"{st['prefill_s'] * 1e3:.1f} ms, decode "
          f"{st['decode_s'] * 1e3 / st['decode_steps']:.2f} ms per step")
    del cache, engine, runs, model
    release(torch)

    plain = mesh_train_losses(torch, ops, dev, meshless)
    meshed = mesh_train_losses(torch, ops, dev, mesh)
    check(plain["losses"] == meshed["losses"],
          f"(1, 1) mesh: losses {meshed['losses']} differ from the "
          f"meshless {plain['losses']}")
    check(plain["launches"] == meshed["launches"],
          f"(1, 1) mesh: train launches {meshed['launches']}, meshless "
          f"{plain['launches']}")
    print(f"(a) {MESH_ARCH} training, {MESH_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: losses bit-equal with and without the mesh "
          f"{meshed['losses']}, launches {json.dumps(meshed['launches'])}, "
          f"step ms {[round(x, 1) for x in meshed['step_ms']]}, peak "
          f"{meshed['peak_gb']:.2f} GB")
    with tempfile.TemporaryDirectory() as d:
        launch_train.main(["--arch", MESH_ARCH, "--smoke", "--distributed",
                           "--steps", "1", "--ckpt-dir", d])
    dist.destroy_process_group()
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        os.environ.pop(k, None)
    launched = {k: lb.get(k, 0) + meshed["launches"].get(k, 0)
                for k in LLM_KERNELS}
    return launched


def _serve_logits(torch, model, prompts, engine):
    """(tokens of one generate, the whole batch's last-position logits of
    that generate's prefill on the host, the engine's stats)."""
    seen = []

    def prefill(tokens, max_len, _own=model.prefill):
        out = _own(tokens, max_len)
        seen.append(out[0])
        return out

    model.prefill = prefill          # the instance's, for this generate
    try:
        tokens = engine.generate(prompts)
    finally:
        del model.prefill
    st = dict(engine.stats)
    logits, plan = seen[0], model.plan
    if plan is not None:
        with torch.inference_mode():
            logits = plan.gather_rows(plan.gather_logits(logits),
                                      len(prompts))
    return tokens, logits.float().cpu(), st


def mesh_configs(torch):
    """Phase 16 (b)'s configs: yi-6b and qwen3-moe-30b-a3b (cut to
    MESH_MOE_LAYERS layers) at full width with bf16 parameters."""
    from repro_torch.configs import get_config

    return {
        MESH_DENSE: get_config(MESH_DENSE).scaled(dtype=torch.bfloat16),
        MOE_ARCH: get_config(MOE_ARCH).scaled(dtype=torch.bfloat16,
                                              n_layers=MESH_MOE_LAYERS),
    }


#: Phase 16 (b)'s serving runs: (arch, mesh shape, --tp, new tokens), cold
#: (gloo's host staging sets their times). On (2, 1) every prefill and
#: decode step gathers the other rank's half of the weights: fewer steps.
MESH_SERVES = ((MESH_DENSE, (1, 2), True, SERVE_NEW),
               (MESH_DENSE, (2, 1), True, 2),
               (MOE_ARCH, (1, 2), False, SERVE_NEW))


def ranks_on_one_card(rank, world, root):
    """Phase 16 (b), in each of two ranks sharing ``cuda:0`` over gloo
    (named: ``gloo_on_cuda=True``): MESH_SERVES and MESH_STEPS steps of
    zamba2-2.7b on (2, 1) with FSDP. Returns per path its tokens, logits
    (rank 0), K5/K6 launches, times and peak memory."""
    sys.path.insert(0, str(Path(root) / "src"))
    import numpy as np
    import torch

    from repro_torch.dist.sharding import Policy, serve_policy
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build
    from repro_torch.serve import Engine, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    meshes = {s: Mesh.distributed(s, ("data", "model"), gloo_on_cuda=True)
              for s in ((1, 2), (2, 1))}
    cfgs = mesh_configs(torch)
    out = {}
    for arch, shape, tp, new in MESH_SERVES:
        t0 = time.perf_counter()
        mesh, policy = meshes[shape], serve_policy(tp)
        release(torch)
        model = build(cfgs[arch], seed=0, device=dev, mesh=mesh,
                      policy=policy)
        engine = Engine(model, mesh, policy, None,
                        ServeConfig(max_new_tokens=new,
                                    max_len=SERVE_PROMPT + SERVE_NEW))
        prompts = np.random.default_rng(0).integers(
            1, cfgs[arch].vocab, size=(SERVE_BATCH, SERVE_PROMPT)).astype(
            np.int32)
        ops.reset_launches()
        tokens, logits, st = _serve_logits(torch, model, prompts, engine)
        launched = _llm_launches(ops)
        out[(arch, shape)] = {
            "tokens": tokens, "logits": logits if rank == 0 else None,
            "launches": launched, "stats": st,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "wall_s": time.perf_counter() - t0}
        del model, engine
    release(torch)
    t0 = time.perf_counter()
    out["train"] = mesh_train_losses(torch, ops, dev, meshes[(2, 1)],
                                     n_layers=MESH_GLOO_LAYERS)
    out["train"]["wall_s"] = time.perf_counter() - t0
    return out


def ranks_phase(torch, ops, dev, root) -> dict:
    """Phase 16 (b): the one-rank references on the card, then two ranks
    sharing it over gloo; tokens and logits held at phase 9's bar, losses
    within MESH_LOSS_RTOL of one rank's with two microbatches (the rows
    each rank takes; the gaps to one microbatch are printed beside).
    Returns the ranks' K5/K6 launches summed."""
    import tempfile

    import numpy as np

    from repro_torch.dist.sharding import Policy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.ranks import spawn_ranks
    from repro_torch.models import build
    from repro_torch.serve import Engine, ServeConfig

    cfgs = mesh_configs(torch)
    want = {}
    for arch, cfg in cfgs.items():
        release(torch)
        model = build(cfg, seed=0, device=dev)
        engine = Engine(model, make_host_mesh(), Policy(), None,
                        ServeConfig(max_new_tokens=SERVE_NEW,
                                    max_len=SERVE_PROMPT + SERVE_NEW))
        prompts = np.random.default_rng(0).integers(
            1, cfg.vocab, size=(SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
        engine.generate(prompts)
        want[arch] = _serve_logits(torch, model, prompts, engine)
        del model, engine
    release(torch)
    one_mb = mesh_train_losses(torch, ops, dev, None,
                               n_layers=MESH_GLOO_LAYERS)
    two_mb = mesh_train_losses(torch, ops, dev, None, microbatches=2,
                               n_layers=MESH_GLOO_LAYERS)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        got = spawn_ranks(ranks_on_one_card, 2, (str(root),),
                          backend="gloo", store_dir=d,
                          timeout=RANKS_TIMEOUT_S)
    wall = time.perf_counter() - t0
    launched = {k: 0 for k in LLM_KERNELS}
    for arch, shape, tp, new in MESH_SERVES:
        r0, r1 = got[0][(arch, shape)], got[1][(arch, shape)]
        w_tokens, w_logits, w_st = want[arch]
        w_tokens = w_tokens[:, :new]
        check(np.array_equal(r0["tokens"], r1["tokens"]),
              f"{arch} on {shape}: the two ranks' tokens differ")
        label = f"(b) {arch} on {shape}{' --tp' if tp else ''}"
        hold_logits(torch, r0["logits"], w_logits,
                    f"{label} prefill against one rank's")
        rows = int((r0["tokens"] == w_tokens).all(axis=1).sum())
        for r in (r0, r1):
            for k in LLM_KERNELS:
                launched[k] += r["launches"].get(k, 0)
        check(r0["launches"]["flash_attention"] > 0,
              f"{label}: K5 not launched")
        st = r0["stats"]
        print(f"{label}: {rows}/{SERVE_BATCH} rows' {new} tokens equal "
              f"to one rank's; launches per rank {json.dumps(r0['launches'])};"
              f" prefill {st['prefill_s'] * 1e3:.1f} ms (one rank "
              f"{w_st['prefill_s'] * 1e3:.1f}), decode "
              f"{st['decode_s'] * 1e3 / st['decode_steps']:.2f} ms per step "
              f"(one rank {w_st['decode_s'] * 1e3 / w_st['decode_steps']:.2f})"
              f"; peak {max(r0['peak_gb'], r1['peak_gb']):.2f} GB a rank; "
              f"{r0['wall_s']:.1f} s")
    tr = got[0]["train"]
    for i, (a, b) in enumerate(zip(tr["losses"], two_mb["losses"])):
        check(abs(a - b) <= MESH_LOSS_RTOL * abs(b),
              f"(b) {MESH_ARCH} step {i} on (2, 1): loss {a} against one "
              f"rank's with two microbatches {b}")
    a, b = tr["grad_norms"][0], two_mb["grad_norms"][0]
    check(abs(a - b) <= MESH_NORM_RTOL * abs(b),
          f"(b) {MESH_ARCH} step 0 on (2, 1): grad norm {a} against one "
          f"rank's with two microbatches {b}")
    for r in got:
        for k in LLM_KERNELS:
            launched[k] += r["train"]["launches"].get(k, 0)
    check(tr["launches"]["ssd"] > 0, "(b) training: K6 not launched")
    gaps = [abs(a - b) / abs(b) for a, b in zip(tr["losses"],
                                                 one_mb["losses"])]
    print(f"(b) {MESH_ARCH} ({MESH_GLOO_LAYERS} layers) training on (2, 1) "
          f"FSDP over gloo: losses "
          f"{tr['losses']} against one rank's with two microbatches "
          f"{two_mb['losses']} (rtol {MESH_LOSS_RTOL}), step-0 grad norm "
          f"{tr['grad_norms'][0]} against {two_mb['grad_norms'][0]} (rtol "
          f"{MESH_NORM_RTOL}); relative gaps to "
          f"one microbatch {[f'{g:.3g}' for g in gaps]}; step ms "
          f"{[round(x, 1) for x in tr['step_ms']]} (one rank, two "
          f"microbatches {[round(x, 1) for x in two_mb['step_ms']]}); peak "
          f"{max(r['train']['peak_gb'] for r in got):.2f} GB a rank; "
          f"launches per rank {json.dumps(tr['launches'])}; "
          f"{tr['wall_s']:.1f} s")
    print(f"(b) two ranks on one card: {wall:.1f} s wall for the spawn and "
          f"every path above")
    return launched


def rank_worker(name: str) -> int:
    """One rank of phase 16 (c), started by ``torchrun`` (``--rank-worker
    NAME``): ``serve`` runs the serve launcher's ``main`` for
    mistral-large-123b in bf16 on ``make_host_mesh()`` and reports host
    syncs per decode step and peak memory; ``train`` takes MESH_STEPS
    steps of zamba2-2.7b under ``init_distributed`` and ``make_host_mesh``.
    Rank 0 prints one JSON line ``PHASE16C {...}``."""
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    if name == "serve":
        from repro_torch.launch import serve as launch_serve

        seen = {}

        class Counting(launch_serve.Engine):
            def generate(self, prompts):
                super().generate(prompts)                      # warm
                out = super().generate(prompts)
                seen["stats"] = dict(self.stats)
                model, plan = self.model, self.model.plan
                toks = torch.as_tensor(prompts.astype("int64"),
                                       device=model.device)
                _, cache = model.prefill(plan.batch_local(toks),
                                         self.cfg.max_len)
                step = torch.as_tensor(out[:, :1].astype("int64"),
                                       device=model.device)
                seen["syncs"] = host_syncs(torch, lambda: model.decode_step(
                    cache, plan.batch_local(step)))
                return out

        launch_serve.Engine = Counting
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        launch_serve.main(["--arch", TOO_BIG_ARCH, "--dtype", "bfloat16"])
        peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9],
                            device="cuda")
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        st = seen["stats"]
        report = {"prefill_ms": st["prefill_s"] * 1e3,
                  "decode_ms": st["decode_s"] * 1e3 / st["decode_steps"],
                  "syncs_per_step": len(seen["syncs"]),
                  "sync_sites": sorted(set(seen["syncs"])),
                  "peak_gb": float(peak), "launches": _llm_launches(ops)}
    else:
        from repro_torch.launch.mesh import init_distributed, make_host_mesh

        dev = init_distributed("cuda")
        mesh = make_host_mesh()
        report = mesh_train_losses(torch, ops, dev, mesh)
        peak = torch.tensor([report["peak_gb"]], device="cuda")
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        report["peak_gb"] = float(peak)
        report["mesh"] = mesh.shape
    if dist.get_rank() == 0:
        print("PHASE16C " + json.dumps(report), flush=True)
    dist.destroy_process_group()
    return 0


def four_cards(torch, ops, dev, root) -> dict:
    """Phase 16 (c): ``torchrun --nproc-per-node 4`` of the serve
    launcher (mistral-large-123b, bf16, the reference launcher's (4, 1)
    mesh) and of MESH_STEPS zamba2-2.7b training steps against one card's
    losses with four microbatches. Returns each run's report."""
    import os

    one = mesh_train_losses(torch, ops, dev, None, microbatches=4)
    losses = one["losses"]

    reports = {}
    for name in ("serve", "train"):
        cmd = ["torchrun", "--nproc-per-node", "4", "--master-port",
               str(free_port()), str(root / "chip_smoke.py"),
               "--rank-worker", name]
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              timeout=TORCHRUN_TIMEOUT_S)
        wall = time.perf_counter() - t0
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("PHASE16C ")]
        check(proc.returncode == 0 and lines,
              f"(c) torchrun {name} exited {proc.returncode}:\n"
              f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        for ln in proc.stdout.splitlines():
            if ln.startswith("[serve]") or ln.startswith("[train]"):
                print(f"(c) {ln}")
        reports[name] = json.loads(lines[-1][len("PHASE16C "):])
        reports[name]["wall_s"] = wall
    s, t = reports["serve"], reports["train"]
    gaps = [abs(x - y) / abs(y) for x, y in zip(t["losses"], losses)]
    norm_gap = abs(t["grad_norms"][0] - one["grad_norms"][0]) / abs(
        one["grad_norms"][0])
    print(f"(c) {TOO_BIG_ARCH} bf16 over 4 cards (4, 1) FSDP: prefill "
          f"{s['prefill_ms']:.1f} ms, decode {s['decode_ms']:.2f} ms per "
          f"step, {s['syncs_per_step']} host syncs per decode step, peak "
          f"{s['peak_gb']:.2f} GB a card, launches on rank 0 "
          f"{json.dumps(s['launches'])}; {s['wall_s']:.1f} s of torchrun")
    print(f"(c) {MESH_ARCH} training on 4 cards {t['mesh']}: losses "
          f"{t['losses']} against one card's with four microbatches "
          f"{losses} (relative gaps {[f'{g:.3g}' for g in gaps]}); step-0 "
          f"grad norm {t['grad_norms'][0]} against {one['grad_norms'][0]} "
          f"(relative gap {norm_gap:.3g}); step ms "
          f"{[round(x, 1) for x in t['step_ms']]} (one card "
          f"{[round(x, 1) for x in one['step_ms']]}); peak "
          f"{t['peak_gb']:.2f} GB a card; {t['wall_s']:.1f} s of torchrun")
    check(s["syncs_per_step"] == 0,
          f"(c) mistral decode step: {s['syncs_per_step']} host syncs at "
          f"{s['sync_sites']}")
    # Step 0's loss and grad norm (the gradients reduced over the four
    # cards) at the (b) bars. Four ranks sum each gradient in NCCL's ring
    # order, and AdamW's first step, which moves a parameter by about
    # lr * sign(g) where |g| is small, carries those f32 roundings into
    # step 1's loss: hence its own limit (MESH_STEP1_RTOL).
    check(gaps[0] <= MESH_LOSS_RTOL,
          f"(c) {MESH_ARCH} step 0 on {t['mesh']}: loss {t['losses'][0]} "
          f"against one card's {losses[0]}")
    check(norm_gap <= MESH_NORM_RTOL,
          f"(c) {MESH_ARCH} step 0 on {t['mesh']}: grad norm "
          f"{t['grad_norms'][0]} against one card's {one['grad_norms'][0]}")
    check(gaps[1] <= MESH_STEP1_RTOL,
          f"(c) {MESH_ARCH} step 1 on {t['mesh']}: loss {t['losses'][1]} "
          f"against one card's {losses[1]}")
    return reports


def phase16(torch, ops, dev, card: str, cards: int, root: Path,
            parts: str = "abc") -> dict:
    """Phase 16 (a)-(c), those of ``parts`` ((c) only with ``cards`` >=
    4); returns the K5/K6 launches of (a) and (b)."""
    phase("16 the multi-card path: a one-rank mesh, two ranks on one card, "
          "four cards")
    print(f"card: {card}")
    launched = {k: 0 for k in LLM_KERNELS}
    t0 = time.perf_counter()
    for part, run in (("a", lambda: mesh_one_rank(torch, ops, dev)),
                      ("b", lambda: ranks_phase(torch, ops, dev, root))):
        if part not in parts:
            print(f"({part}): not run (--only-phase16 {parts})")
            continue
        release(torch)
        got = run()
        for k in LLM_KERNELS:
            launched[k] += got[k]
    ran = [p for p in "ab" if p in parts]
    if ran:
        print(f"phase 16 ({') and ('.join(ran)}): "
              f"{time.perf_counter() - t0:.1f} s; launches "
              f"{json.dumps(launched)}, added to the kernels line's counts")
    if "c" not in parts:
        print(f"(c): not run (--only-phase16 {parts})")
    elif cards >= 4:
        check(torch.cuda.device_count() >= 4,
              f"--cards {cards}: {torch.cuda.device_count()} cards here")
        release(torch)
        four_cards(torch, ops, dev, root)
    else:
        print("(c) four cards: not run (chip_smoke.py --cards 4 runs it)")
    return launched


# ------------------------------------------------------------------ phase 17
#: Phase 17: the pod tools (``launch.{constants,hlo,dryrun,roofline,
#: perf}``). (b) traces phase 9's prefill on the meta device and runs it on
#: the card under the same counter; (c) logs phase 16 (b)'s yi-6b --tp
#: collectives on meta and on two gloo ranks; (d) runs the perf driver on
#: the three baseline cells of the pod (in a subprocess started first, so
#: it runs beside (a)-(c)).
POD_CELLS = ("A0_baseline", "B0_baseline", "C0_baseline")
#: The card's bytes (``total_memory``) against the peaks table's HBM bytes.
POD_HBM_RTOL = 0.01
#: The counter's bytes on meta against on the card.
POD_BYTES_RTOL = 0.01
#: The meta trace's peak live bytes against the rise of the card's
#: ``max_memory_allocated`` over the same prefill: -0.13% on the first
#: run on an H100 (the allocator's 512-byte rounding); the limit leaves
#: that reading a factor of ~15.
POD_PEAK_RTOL = 0.02
POD_PERF_TIMEOUT_S = 600


def pod_perf_start(root: Path, card_name: str):
    """(d), started: ``python -m repro_torch.launch.perf --run`` of
    POD_CELLS on the pod16x16 mesh, in a subprocess (its log:
    ``experiments/h100/perf_log.json`` of this checkout)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.perf", "--run",
         *POD_CELLS, "--card", card_name],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=root)


def pod_perf_finish(proc, root: Path, t0: float) -> None:
    """(d), collected: every cell's dry run ``ok`` and its three terms."""
    try:
        out, err = proc.communicate(timeout=POD_PERF_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    check(proc.returncode == 0, f"(d) the perf driver failed:\n"
          f"{out[-2000:]}{err[-3000:]}")
    log = root / "experiments" / "h100" / "perf_log.json"
    recs = {r["experiment"]: r for r in json.loads(log.read_text())}
    for name in POD_CELLS:
        r = recs[name]
        check(r["status"] == "ok", f"(d) {name}: dry run {r['status']}")
        print(f"(d) {name} {r['arch']} x {r['shape']} on pod16x16: "
              f"compute {r['compute_s']:.4e} s, memory {r['memory_s']:.4e} "
              f"s, collective {r['collective_s']:.4e} s; dominant "
              f"{r['dominant']}, useful {r['useful_ratio']:.3f}, roofline "
              f"fraction {r['roofline_fraction']:.4f}; temp "
              f"{r['temp_bytes'] / 1e9:.2f} GB a card; status {r['status']}")
    print(f"(d) the perf driver's three cells: {time.perf_counter() - t0:.1f}"
          f" s in a subprocess beside (a)-(c)")


def pod_card(torch, card: str):
    """(a): the card's peaks, by the name the card reports."""
    from repro_torch.launch.constants import peaks

    name = torch.cuda.get_device_name(0)
    p = peaks(name)
    total = torch.cuda.get_device_properties(0).total_memory
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.total", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(f"(a) nvidia-smi memory.total: {smi.strip()}")
    print(f"(a) card: {card}; peaks of {p.name}: bf16 {p.flops['bf16']:.4g}, "
          f"tf32 {p.flops['tf32']:.4g}, f32 {p.flops['f32']:.4g} FLOP/s, HBM "
          f"{p.hbm_bw:.4g} B/s, {p.hbm_bytes} B; NVLink {p.nvlink_bw:.4g} "
          f"B/s, {p.cards_per_node} cards a node, {p.off_node_bw:.4g} B/s "
          f"off it; total_memory {total} B "
          f"({total / p.hbm_bytes - 1:+.4%} of the table's)")
    check(abs(total - p.hbm_bytes) <= POD_HBM_RTOL * p.hbm_bytes,
          f"(a) total_memory {total} B is not within {POD_HBM_RTOL:.0%} of "
          f"the peaks table's {p.hbm_bytes} B")
    return p


def _op_diff(a: dict, b: dict) -> str:
    keys = sorted(set(a) | set(b))
    return ", ".join(f"{k}: meta {a.get(k, 0)} card {b.get(k, 0)}"
                     for k in keys if a.get(k, 0) != b.get(k, 0))


def pod_trace_vs_card(torch, ops, dev, peaks) -> dict:
    """(b): zamba2-2.7b's prefill at phase 9's 8 x 512 on the (1, 1) host
    mesh, traced on meta, then run on the card under the same counter:
    GEMM FLOPs by dtype, K5/K6 records and op counts equal, bytes within
    POD_BYTES_RTOL, the meta peak against the card's allocator; the time
    without the counter against the roofline bound. Returns the counted
    run's K5/K6 launches."""
    from repro_torch.configs import TOKEN_DTYPE, get_config
    from repro_torch.dist.sharding import Policy
    from repro_torch.launch.dryrun import Counter
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.train.train_step import make_prefill_fn

    cfg = get_config(MESH_ARCH)
    mesh, policy = make_host_mesh(), Policy()
    shape = (SERVE_BATCH, SERVE_PROMPT)
    t0 = time.perf_counter()
    fn = make_prefill_fn(build(cfg, device="meta", mesh=mesh, policy=policy),
                         mesh, policy)
    batch = {"tokens": torch.empty(shape, dtype=TOKEN_DTYPE, device="meta")}
    with Counter() as meta:
        fn(batch)
    meta_s = time.perf_counter() - t0
    del fn

    release(torch)
    fn = make_prefill_fn(build(cfg, seed=0, device=dev, mesh=mesh,
                               policy=policy), mesh, policy)
    tokens = torch.randint(1, cfg.vocab, shape, dtype=TOKEN_DTYPE,
                           generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    batch = {"tokens": tokens}
    fn(batch)                                 # warm: cuBLAS, the kernels
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with Counter() as card:
        fn(batch)
        torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    launched = _llm_launches(ops)

    m_ops, c_ops = meta.op_counts(), card.op_counts()
    check(m_ops == c_ops, f"(b) op counts differ: {_op_diff(m_ops, c_ops)}")
    check(meta.flops == card.flops,
          f"(b) GEMM FLOPs by dtype: meta {meta.flops}, card {card.flops}")
    check(meta.kernels == card.kernels,
          f"(b) kernel records differ: meta {meta.kernel_summary()}, card "
          f"{card.kernel_summary()}")
    check(abs(meta.bytes - card.bytes) <= POD_BYTES_RTOL * card.bytes,
          f"(b) bytes: meta {meta.bytes}, card {card.bytes}")
    k = meta.kernel_summary()
    check(k["flash_attention"]["calls"] == launched["flash_attention"]
          and k["ssd"]["calls"] == launched["ssd"],
          f"(b) kernel records {k} against launches {launched}")
    check(abs(meta.peak - rise) <= POD_PEAK_RTOL * rise,
          f"(b) meta peak {meta.peak} B against the card's rise of "
          f"max_memory_allocated {rise} B: beyond {POD_PEAK_RTOL:.0%}")
    compute = sum(f / peaks.flops_for(d)
                  for d, f in meta.flops_by_dtype().items())
    memory = meta.total_bytes() / peaks.hbm_bw
    bound = max(compute, memory)
    ms = statistics.median(times) * 1e3
    print(f"(b) {MESH_ARCH} prefill {shape[0]} x {shape[1]} on (1, 1): "
          f"traced on meta in {meta_s:.1f} s, {len(meta.ops)} ops equal to "
          f"the card's; GEMM FLOPs {json.dumps(meta.flops)}; kernels "
          f"{json.dumps(k)}; bytes meta {meta.bytes} card {card.bytes}; "
          f"live peak meta {meta.peak} B, card rise of max_memory_allocated "
          f"{rise} B ({meta.peak / rise - 1:+.2%}); launches "
          f"{json.dumps(launched)}")
    print(f"(b) roofline: compute {compute * 1e3:.3f} ms, memory "
          f"{memory * 1e3:.3f} ms (bound {bound * 1e3:.3f} ms by "
          f"{'compute' if compute >= memory else 'memory'}); measured "
          f"without the counter {ms:.2f} ms (runs "
          f"{[round(t * 1e3, 2) for t in times]}): {bound * 1e3 / ms:.3f} "
          f"of the bound")
    return launched


def _yi_tp_collectives(torch, dev, mesh) -> list:
    """Phase 16 (b)'s yi-6b --tp on ``mesh``: a prefill of SERVE_BATCH x
    SERVE_PROMPT tokens and one decode step, on ``dev`` (meta on an
    abstract mesh), under the pod tools' counter: its collective records
    as tuples."""
    from repro_torch.configs import TOKEN_DTYPE
    from repro_torch.dist.sharding import serve_policy
    from repro_torch.launch.dryrun import Counter
    from repro_torch.models import build
    from repro_torch.train.train_step import make_decode_fn, make_prefill_fn

    cfg = mesh_configs(torch)[MESH_DENSE]
    policy = serve_policy(True)
    model = build(cfg, seed=0, device=dev, mesh=mesh, policy=policy)
    shape = (SERVE_BATCH, SERVE_PROMPT)
    if dev.type == "meta":
        tokens = torch.empty(shape, dtype=TOKEN_DTYPE, device=dev)
        token = torch.empty((SERVE_BATCH, 1), dtype=TOKEN_DTYPE, device=dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(0)
        tokens = torch.randint(1, cfg.vocab, shape, dtype=TOKEN_DTYPE,
                               generator=gen, device=dev)
        token = tokens[:, -1:].contiguous()
    prefill = make_prefill_fn(model, mesh, policy)
    decode = make_decode_fn(model, mesh, policy)
    with Counter() as counter:
        _, cache = prefill({"tokens": tokens})
        decode(cache, token)
    return [(r.kind, r.axis, r.group, str(r.dtype), r.shape)
            for r in counter.collectives.records]


def pod_rank_collectives(rank, world, root):
    """(c), in each of two ranks sharing ``cuda:0`` over gloo: the
    collective log of phase 16 (b)'s yi-6b --tp on (1, 2), and the K5/K6
    launches."""
    sys.path.insert(0, str(Path(root) / "src"))
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh

    torch.cuda.set_device(0)
    mesh = Mesh.distributed((1, 2), ("data", "model"), gloo_on_cuda=True)
    ops.reset_launches()
    log = _yi_tp_collectives(torch, torch.device("cuda", 0), mesh)
    return {"log": log, "launches": _llm_launches(ops)}


def pod_collectives_vs_ranks(torch, root) -> dict:
    """(c): the meta trace's collective log of each rank of (1, 2) against
    that rank's real run over gloo, record for record. Returns the ranks'
    K5/K6 launches summed."""
    import tempfile

    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.ranks import spawn_ranks

    want = [_yi_tp_collectives(torch, torch.device("meta"),
                               Mesh(("data", "model"), (1, 2), (0, r)))
            for r in range(2)]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        got = spawn_ranks(pod_rank_collectives, 2, (str(root),),
                          backend="gloo", store_dir=d,
                          timeout=RANKS_TIMEOUT_S)
    launched = {k: 0 for k in LLM_KERNELS}
    for r, (w, g) in enumerate(zip(want, got)):
        first = next((i for i, (a, b) in enumerate(zip(w, g["log"]))
                      if a != b), None)
        check(w == g["log"], f"(c) rank {r}: meta log of {len(w)} records, "
              f"the card's {len(g['log'])}; first difference at "
              f"{first}: {w[first] if first is not None else None} against "
              f"{g['log'][first] if first is not None else None}")
        for k in LLM_KERNELS:
            launched[k] += g["launches"].get(k, 0)
    kinds = {}
    for rec in want[0]:
        kinds[rec[0]] = kinds.get(rec[0], 0) + 1
    print(f"(c) {MESH_DENSE} --tp on (1, 2), prefill {SERVE_BATCH} x "
          f"{SERVE_PROMPT} and one decode step: each rank's collective log "
          f"({len(want[0])} records: {json.dumps(kinds)}) equal on meta and "
          f"over gloo, kind, axis, group, dtype and shape; launches "
          f"{json.dumps(launched)}; {time.perf_counter() - t0:.1f} s")
    return launched


def pod_fsdp_decode(torch, peaks) -> None:
    """(d), beside the perf cells: phase 16 (c)'s mistral-large-123b decode
    step (the serve launcher's defaults: bf16, 4 rows, a cache of 40, the
    policy without --tp, FSDP over data) traced on the meta device for a
    rank of the (4, 1) mesh: the bytes its gathers move a card a step and
    the three roofline terms, the data axis priced at NVLink."""
    from repro_torch.configs import TOKEN_DTYPE, get_config
    from repro_torch.dist.sharding import serve_policy
    from repro_torch.launch import hlo
    from repro_torch.launch.dryrun import Counter
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.roofline import axis_links
    from repro_torch.models import build
    from repro_torch.models.common import activation_sharding
    from repro_torch.train.train_step import make_decode_fn

    cfg = get_config(TOO_BIG_ARCH).scaled(dtype=torch.bfloat16)
    mesh, policy = Mesh(("data", "model"), (4, 1)), serve_policy(False)
    batch, max_len = 4, 16 + 16 + 8
    t0 = time.perf_counter()
    model = build(cfg, device="meta", mesh=mesh, policy=policy)
    with activation_sharding(model.plan):
        cache = model.init_cache(batch // 4, max_len)
    decode = make_decode_fn(model, mesh, policy)
    with Counter() as c:
        decode(cache, torch.empty((batch, 1), dtype=TOKEN_DTYPE,
                                  device="meta"))
    coll = hlo.parse_collectives(c.collectives)
    links = axis_links(mesh, peaks)
    wire = hlo.wire_by_axis(c.collectives)
    collective = sum(w / links[a] for a, w in wire.items())
    compute = sum(f / peaks.flops_for(d)
                  for d, f in c.flops_by_dtype().items())
    memory = c.total_bytes() / peaks.hbm_bw
    ag = coll["all-gather"]
    print(f"(d) {TOO_BIG_ARCH} bf16 decode step on (4, 1), FSDP over data "
          f"(phase 16 (c)'s serve launcher): {ag['count']} all-gathers, "
          f"{ag['result_bytes'] / 1e9:.3f} GB gathered a card a step "
          f"({hlo.wire_bytes(coll) / 1e9:.3f} GB on the wire by the "
          f"reference's rules); data axis on "
          f"{'NVLink' if links['data'] == peaks.nvlink_bw else 'the network'}"
          f" at {links['data'] / 1e9:.0f} GB/s: collective "
          f"{collective * 1e3:.1f} ms, memory {memory * 1e3:.1f} ms, compute "
          f"{compute * 1e3:.3f} ms; traced in {time.perf_counter() - t0:.1f} s")
    check(ag["count"] > 0 and collective > 0, "(d) no gathers traced")


def phase17(torch, ops, dev, card: str, root: Path) -> dict:
    """Phase 17 (a)-(d); returns the K5/K6 launches of (b) and (c)."""
    phase("17 the pod tools: card peaks, a meta trace against the card, "
          "collective logs against two ranks, the perf driver's cells")
    t0 = time.perf_counter()
    perf = pod_perf_start(root, torch.cuda.get_device_name(0))
    try:
        peaks = pod_card(torch, card)
        release(torch)
        launched = pod_trace_vs_card(torch, ops, dev, peaks)
        release(torch)
        for k, n in pod_collectives_vs_ranks(torch, root).items():
            launched[k] += n
        pod_fsdp_decode(torch, peaks)
    except BaseException:
        perf.kill()
        perf.communicate()
        raise
    pod_perf_finish(perf, root, t0)
    print(f"phase 17: {time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps(launched)}, added to the kernels line's counts")
    return launched


def main(argv: list[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--compare-kernels", type=Path, metavar="DIR",
                        help="time K1-K6 of checkout DIR beside this "
                             "one's, and nothing else")
    parser.add_argument("--time-kernels", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--cards", type=int, default=1,
                        help="4 also runs phase 16 (c) on four cards")
    parser.add_argument("--only-phase16", nargs="?", const="abc",
                        metavar="PARTS",
                        help="build the kernels and run phase 16 alone: "
                             "its parts of PARTS (of a, b and c; all "
                             "when none is named)")
    parser.add_argument("--only-phase17", action="store_true",
                        help="build the kernels and run phase 17 alone")
    parser.add_argument("--rank-worker", help=argparse.SUPPRESS)
    opts = parser.parse_args(argv)
    if opts.rank_worker:
        return rank_worker(opts.rank_worker)
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if opts.time_kernels is not None:
        print(json.dumps(kernel_times(opts.time_kernels)))
        return 0
    if opts.compare_kernels is not None:
        return compare_kernels(opts.compare_kernels)
    sys.path.insert(0, str(root / "src"))
    import numpy as np

    from repro_torch.core import routing
    from repro_torch.core.agnostic import pick_min_edp
    from repro_torch.core.evaluate import Evaluator
    from repro_torch.core.objectives import (design_cost, design_cost_np,
                                             make_consts)
    from repro_torch.core.problem import (random_design, spec_16, spec_64,
                                          spec_large)
    from repro_torch.kernels import build, ops, ref
    from repro_torch.noc import Budget, NocProblem, RunResult, named_spec, run

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # ------------------------------------------------------------- phase 1
    phase("1 header")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} x{count}")
    t0 = time.perf_counter()
    build_secs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s wall, per source "
          + json.dumps({k: round(v, 2) for k, v in build_secs.items()}))
    for name, log in build.ptxas_log.items():
        for line in log.splitlines():
            if "Used" in line or "Compiling entry" in line or "spill" in line:
                print(f"  ptxas[{name}] {line.strip()}")
    for name in build.SOURCES:
        counts = build.sass_counts(name)
        print(f"  sass[{name}] tensor-core instructions {json.dumps(counts)}")
        if name in ("flash_attention", "ssd"):
            check(sum(counts.values()) > 0,
                  f"{name}: no HMMA/HGMMA in its SASS")
    if opts.only_phase16 or opts.only_phase17:
        if opts.only_phase16:
            phase16(torch, ops, dev, card, opts.cards, root,
                    opts.only_phase16)
        if opts.only_phase17:
            phase17(torch, ops, dev, card, root)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}))
        return 0

    # ------------------------------------------------------------- phase 2
    phase("2 kernels against their plain versions")
    rng = np.random.default_rng(0)
    errs: dict[str, float] = {}

    k1_err = 0.0
    for bsz, n in ((64, 64), (4, 7), (4, 33), (4, 129), (2, 300), (1, 1024)):
        a = random_graphs(torch, rng, bsz, n, 0.3, dev)
        b = random_graphs(torch, rng, bsz, n, 0.3, dev)
        out = ops.minplus(a, b)
        plain = ref.minplus_ref(a, b)
        torch.cuda.synchronize()
        check(torch.equal(out, plain),
              f"minplus differs from its plain version at B={bsz} N={n}")
        k1_err = max(k1_err, float((out - plain).abs().max()))
    k1_launches = {}
    for bsz, n in ((48, 64), (4, 7), (4, 33), (4, 128), (4, 129), (2, 300)):
        for diag in ("zero", "none"):
            a = random_graphs(torch, rng, bsz, n, 4.0 / n, dev)
            if diag == "zero":
                a.diagonal(dim1=1, dim2=2).zero_()
            iters = routing.apsp_iters(n)
            n0 = ops.KERNELS["minplus"].launches
            out = ops.apsp(a, iters)
            k1_launches[n] = ops.KERNELS["minplus"].launches - n0
            again = ops.apsp(a, iters)
            plain = ref.apsp_ref(a, iters)
            torch.cuda.synchronize()
            check(torch.equal(out.view(torch.int32), plain.view(torch.int32)),
                  f"apsp differs from its plain version at B={bsz} N={n} "
                  f"({diag} diagonal)")
            check(torch.equal(out, again), f"apsp at N={n}: two runs differ")
            k1_err = max(k1_err, float((out - plain).abs().max()))
    for n, launched in k1_launches.items():
        want = 1 if n <= ops.APSP_MAX_N else routing.apsp_iters(n)
        check(launched == want, f"apsp at N={n}: {launched} launches, "
              f"expected {want}")
    spec = spec_64()
    consts = make_consts(spec, "cuda")
    designs = [random_design(spec, rng) for _ in range(64)]
    adjs = torch.as_tensor(np.stack([d.adj for d in designs]), device=dev)
    costs = design_cost(consts, adjs)
    dist = routing.apsp_batched(costs, consts.apsp_iters)
    nh = routing.next_hop(costs, dist)
    torch.cuda.synchronize()
    for i, d in enumerate(designs):
        c_np = design_cost_np(spec, d.adj)
        d_np = routing.apsp_np(c_np, consts.apsp_iters)
        check(np.array_equal(dist[i].cpu().numpy(), d_np),
              f"APSP of design {i} differs from apsp_np")
        check(np.array_equal(nh[i].cpu().numpy(),
                             routing.next_hop_np(c_np, d_np)),
              f"next_hop of design {i} differs from next_hop_np")
    errs["minplus"] = k1_err
    print("K1 minplus: bit-equal at B=64/N=64, N=7,33,129,300,1024; the APSP "
          "bit-equal to the plain loop at B=48/N=64, N=7,33,128,129,300 with "
          "and without a zero diagonal, two runs bit-identical, launches per "
          f"APSP {json.dumps(k1_launches)}; spec_64 APSP and next_hop "
          "bit-equal to the host mirrors")

    fi = forest_inputs(torch, dev)
    forest_kernels_vs_plain(torch, ops, ref, dev, fi, rng)
    errs["forest_predict"] = errs["score_block_max"] = 0.0   # bit-equal

    f_slots = slot_traffic(torch, spec, designs, consts, dev)
    k4 = ops.walk(nh, f_slots, consts.link_delay, spec.max_hops)
    k4_err = check_walk(torch, ops, ref, "spec_64", k4, nh, f_slots,
                        consts.link_delay, spec.max_hops)
    for spec_k, n_k in ((spec_16(), 16), (spec_large(), 8)):
        c_k = make_consts(spec_k, "cuda")
        d_k = [spec_k.mesh_design()] + [random_design(spec_k, rng)
                                        for _ in range(n_k - 1)]
        cost_k = design_cost(c_k, torch.as_tensor(
            np.stack([d.adj for d in d_k]), device=dev))
        nh_k = routing.next_hop(cost_k, routing.apsp_batched(
            cost_k, c_k.apsp_iters))
        f_k = slot_traffic(torch, spec_k, d_k, c_k, dev)
        k4_err = max(k4_err, check_walk(
            torch, ops, ref, f"N={spec_k.n_tiles}", ops.walk(
                nh_k, f_k, c_k.link_delay, spec_k.max_hops),
            nh_k, f_k, c_k.link_delay, spec_k.max_hops))
    errs["walk"] = k4_err

    # ------------------------------------------------------------- phase 3
    phase("3 main path: stage on spec_64")
    ops.reset_launches()
    problem, res, wall = run_main_path(torch)
    main_launches = {k: n for k, n in ops.launches().items()
                     if k in NOC_KERNELS}
    for name, n in main_launches.items():
        check(n > 0, f"kernel {name} was not launched by the main path")
    phv = res.phv()
    check(len(res.designs) > 0, "empty front")
    check(math.isfinite(phv) and phv > 0, f"PHV {phv}")
    ev_cpu = Evaluator(problem.spec, problem.traffic_matrix(), device="cpu")
    objs_cpu = ev_cpu.batch(res.designs)
    check(np.allclose(objs_cpu, res.objs, rtol=1e-5, atol=0.0),
          "front re-evaluated on the CPU disagrees beyond rtol 1e-5")
    back = RunResult.from_json(json.loads(json.dumps(res.to_json())))
    check(np.array_equal(back.objs, res.objs)
          and [d.key() for d in back.designs] == [d.key() for d in res.designs],
          "RunResult JSON round trip")
    print(f"evals {res.n_evals} calls {res.n_calls} wall {wall:.3f} s "
          f"front {len(res.designs)} best_edp {res.best_edp():.6g} "
          f"phv {phv:.6g} local_searches {res.extra['n_local_searches']} "
          f"launches {json.dumps(main_launches)}")

    main_res = res

    # ------------------------------------------------------------ phase 3b
    phase("3b multi-start search: stage_batch on spec_64")
    print(f"card: {card}")
    stage_batch_on_card(torch, ops)

    # ------------------------------------------------------------- phase 4
    phase("4 card against CPU on spec_tiny")
    for seed in (0, 1, 2):
        p_tiny = NocProblem(spec=named_spec("tiny"), traffic="BFS")
        out = {d: run(p_tiny, "stage", budget=Budget(max_evals=300, seed=seed),
                      device=d) for d in ("cuda", "cpu")}
        g, c = out["cuda"], out["cpu"]
        check([d.key() for d in g.designs] == [d.key() for d in c.designs],
              f"seed {seed}: fronts differ")
        check(np.allclose(g.objs, c.objs, rtol=1e-5, atol=0.0),
              f"seed {seed}: objective rows beyond rtol 1e-5")
        check((g.n_evals, g.n_calls) == (c.n_evals, c.n_calls),
              f"seed {seed}: accounting differs")
        print(f"seed {seed}: front {len(g.designs)} identical, evals "
              f"{g.n_evals} calls {g.n_calls}")
    multi_iteration_on_card(torch, ops)

    # ------------------------------------------------------------- phase 5
    phase("5 delta path on the card")
    for spec_k in (spec, spec_large()):
        delta_on_card(spec_k, rng)

    # ------------------------------------------------------------- phase 6
    phase("6 timing at main-path shapes")
    print(f"card: {card}")
    rows = []
    fns = {}
    noc = noc_timing_inputs(torch, dev)
    bsz, n = noc["nh"].shape[:2]         # one neighbourhood of 24+24 moves
    a, iters = noc["costs"], noc["iters"]
    fns["minplus"] = lambda: ops.apsp(a, iters)
    ms = time_ms(fns["minplus"])
    plain_ms = time_ms(lambda: ref.apsp_ref(a, iters))
    squarings = apsp_squarings(torch, ref, a, iters)
    rows.append(("minplus", ms, plain_ms,
                 *bound(2 * bsz * n * n * 4, 2 * squarings * n ** 3,
                        PEAK_FP32_INSTR)))
    print(f"K1 one evaluator call's APSP, B={bsz} N={n}: {squarings} "
          f"squarings over the batch up to each design's fixed point "
          f"(at most {bsz * iters}); bound counts 2 FP32 instructions per "
          f"(add, min) pair at {PEAK_FP32_INSTR:.4g}/s")

    pf = fi["forest"].packed()
    x1, x48, xm, xs = fi["x1"], fi["x48"], fi["xm"], fi["xs"]
    t_count, depth = pf.n_trees, pf.depth
    node_bytes = 12 * depth + 4          # thr + feat + child per level, leaf
    fns.update(forest_calls(torch, ops, fi))
    ms = time_ms(fns["forest_predict"])
    plain_ms = time_ms(lambda: ref.forest_predict_ref(*pf.plain, x1, depth))
    rows.append(("forest_predict", ms, plain_ms,
                 *bound(t_count * node_bytes + 16 * 4 + 4,
                        t_count * (depth + 1))))
    ms = time_ms(fns["score_block_max"])
    plain_ms = time_ms(lambda: ref.score_block_max_ref(*pf.plain, xm, xs,
                                                       x48, 48, depth))
    rows.append(("score_block_max", ms, plain_ms,
                 *bound(48 * t_count * node_bytes + 48 * 16 * 4 + 2 * 16 * 4
                        + 8, 48 * (2 * 16 + t_count * (depth + 1)))))
    k3_kernels = profiled(torch, fns["score_block_max"])
    if k3_kernels:
        check(len(k3_kernels) == 1 and k3_kernels[0][2] == 10,
              f"K3: expected one kernel per call, the profiler saw "
              f"{k3_kernels} over 10 calls")
    print(f"K2/K3 on phase 6's forest: T={t_count}, M="
          f"{pf.records.shape[1]}, depth {depth}, cluster {pf.cluster}, "
          f"route {pf.route}; K3 kernels over 10 calls: "
          f"{[(r[0][:60], r[2]) for r in k3_kernels] or 'not measured'}; "
          f"one call between two events, host included: K2 "
          f"{time_ms_per_call(fns['forest_predict']):.4f} ms, K3 "
          f"{time_ms_per_call(fns['score_block_max']):.4f} ms")
    forest_design_probe(torch, ops, ref, fi)

    nh48, f48, delay = noc["nh"], noc["f"], noc["delay"]
    max_hops = noc["max_hops"]
    fns["walk"] = lambda: ops.walk(nh48, f48, delay, max_hops)
    hop_sum = float(fns["walk"]()[0].sum())
    ms = time_ms(fns["walk"])
    plain_ms = time_ms(lambda: ref.walk_ref(nh48, f48, delay, max_hops))
    # f32 adds: the delay along every path, and per pair one into the
    # parent's flow, one into util, one into visits and one column-sum term.
    rows.append(("walk", ms, plain_ms,
                 *bound(bsz * n * n * 4 * 5 + n * n * 4 + bsz * n * 4
                        + bsz * 4, hop_sum + 4 * bsz * n * n,
                        PEAK_FP32_INSTR)))

    kernels = []
    for name, ms, plain_ms, bound_ms, bound_by in rows:
        k = ops.KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": main_launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # No single PyTorch call computes any of these four functions.
            "library_ms": None,
        })
        dev_ms = device_ms_per_call(torch, fns[name], NOC_SYMBOLS[name])
        shown = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        print(f"{name}: {ms:.4f} ms (profiler's device time per call "
              f"{shown}; plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms by "
              f"{bound_by}; no PyTorch call computes it)")
        if name in NOC_BAR_MS:
            bar = NOC_BAR_MS[name]
            met = dev_ms is not None and dev_ms <= bar
            print(f"  {name} bar {bar} ms of device time per call: "
                  f"{'met' if met else 'MISSED'}")
    # ------------------------------------------------------------- phase 7
    phase("7 trace of the main path")
    totals = trace_main_path(torch, lambda: run_main_path(torch), wall,
                             symbols={k: NOC_SYMBOLS[k] for k in NOC_KERNELS})
    for name, bar in NOC_TRACE_BAR_MS.items():
        if name in totals:
            print(f"  {name} bar {bar} ms of device time per main path: "
                  f"{'met' if totals[name][0] <= bar else 'MISSED'}")

    # ------------------------------------------------------------- phase 8
    phase("8 K5 and K6 against their plain versions")
    errs.update(llm_kernels_vs_plain(torch, ops, ref, dev))

    # ------------------------------------------------------------- phase 9
    phase("9 serving: zamba2-2.7b at full width")
    served = serve_full_width(torch, ops, ref, dev)

    # ------------------------------------------------------------ phase 10
    phase("10 K5 and K6 timing, trace of one generate")
    print(f"card: {card}")
    kernels += time_llm_kernels(torch, ops, ref, dev, served["launches"],
                                errs)
    engine = served["engine"]
    tokens = torch.as_tensor(served["prompts"].astype("int64"), device=dev)
    max_len = tokens.shape[1] + engine.cfg.max_new_tokens
    trace_main_path(torch, lambda: engine.model.prefill(tokens, max_len),
                    served["prefill_s"], "phase 9's warm prefill",
                    "trace of one prefill")
    trace_main_path(torch, lambda: engine.generate(served["prompts"]),
                    served["wall"], "phase 9's warm generate",
                    "trace of one generate")

    # ------------------------------------------------------------ phase 11
    phase("11 baselines, device twins, agnostic study, workloads, netsim")
    print(f"card: {card}")
    baselines_on_card(torch, ops)
    twins_on_card()
    nsga2_kernel_on_card(torch, ops, ref)
    agnostic_on_card()
    workloads_on_card(torch, ops, ref)
    netsim_host([pick_min_edp(None, main_res.designs, main_res.objs)[0]])

    # ------------------------------------------------------------ phase 12
    phase("12 the fleet: stage_dist executors, resume, service, spmd")
    print(f"card: {card}")
    fleet_spawn_cost()
    fleet_ser = fleet_executors(torch, ops)
    fleet_card_vs_cpu(torch, ops)
    fleet_resume(torch, ops)
    fleet_service(torch, ops)
    fleet_spmd(torch, ops, ser=fleet_ser)

    # ------------------------------------------------------------ phase 13
    phase("13 training: K5/K6 Functions, zamba2-2.7b at full width, smoke")
    print(f"card: {card}")
    del served, engine
    gc.collect()
    torch.cuda.empty_cache()
    train_fns_on_card(torch, ops, ref, dev)
    train_full_width(torch, ops, ref, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    train_smoke_card_vs_cpu(torch, ops, dev)

    # ------------------------------------------------------------ phase 14
    phase("14 MoE and encoder-decoder serving: qwen3-moe-30b-a3b and "
          "whisper-base at full width")
    print(f"card: {card}")
    gc.collect()
    torch.cuda.empty_cache()
    moe_served = serve_moe_full_width(torch, ops, ref, dev)
    engine = moe_served["engine"]
    trace_main_path(
        torch, lambda: engine.model.prefill(moe_served["tokens"],
                                            moe_served["max_len"]),
        moe_served["prefill_s"], "phase 14's warm prefill",
        "trace of one qwen3-moe prefill",
        symbols={"K5 flash_attention": K5_SYMBOLS, "GEMMs": GEMM_SYMBOLS},
        ranges=MOE_RANGES)
    trace_main_path(
        torch, lambda: engine.generate(moe_served["prompts"]),
        moe_served["wall"], "phase 14's warm generate",
        "trace of one qwen3-moe generate",
        symbols={"K5 flash_attention": K5_SYMBOLS, "GEMMs": GEMM_SYMBOLS},
        ranges=MOE_RANGES)
    del moe_served, engine
    gc.collect()
    torch.cuda.empty_cache()
    serve_whisper_full_width(torch, ops, ref, dev)
    encdec_moe_smoke_card_vs_cpu(torch, dev)
    time_k5_shapes(torch, ops, ref, dev, ATTN_PHASE14)

    # ------------------------------------------------------------ phase 15
    phase("15 five more architectures: deepseek-coder-33b, chameleon-34b, "
          "gemma3-1b, mamba2-1.3b at full width; mistral-large-123b refused")
    print(f"card: {card}")
    release(torch)
    launched15 = [serve_dense_full_width(torch, ops, ref, dev)]
    release(torch)
    launched15.append(serve_vlm_by_launcher(torch, ops, dev))
    release(torch)
    launched15.append(serve_window_full_width(torch, ops, ref, dev))
    release(torch)
    launched15.append(serve_ssm_full_width(torch, ops, ref, dev))
    release(torch)
    five_smoke_card_vs_cpu(torch, ops, dev)
    time_k5_shapes(torch, ops, ref, dev, ATTN_PHASE15)
    time_k6_shape(torch, ops, ref, dev, SSD_CASES[-1])
    for row in kernels:
        row["launches"] += sum(n.get(row["name"], 0) for n in launched15)
    print(f"phase 15 launches on its full-width paths: "
          f"{json.dumps(launched15)}, added to the kernels line's counts")

    # ------------------------------------------------------------ phase 16
    launched16 = phase16(torch, ops, dev, card, opts.cards, root)
    for row in kernels:
        row["launches"] += launched16.get(row["name"], 0)

    # ------------------------------------------------------------ phase 17
    release(torch)
    launched17 = phase17(torch, ops, dev, card, root)
    for row in kernels:
        row["launches"] += launched17.get(row["name"], 0)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
