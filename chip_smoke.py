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
  5. the evaluator's delta path on the card, bit-equal to the dense path;
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
     GQA, windowed, bidirectional and f32 ones (and K6 with a partial last
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
     ``spmd`` against ``serial``.

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it.

    python3 chip_smoke.py --compare-kernels DIR

times K1 (one evaluator call's APSP), K2, K3 and K4 at phase 6's shapes
and K5 and K6 at the serving shapes, from another checkout ``DIR`` (for
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

#: The kernels of the NoC main path (phase 3) and of the serving path
#: (phase 9).
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


def profiled(torch, fn, calls: int = 10, warmup: int = 3):
    """The CUDA kernels that ``calls`` back-to-back calls of ``fn`` run, as
    torch.profiler reads them: [(name, device ms in total, launches)]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
                    symbols: dict | None = None) -> dict:
    """Device time of one more run of ``fn`` under torch.profiler: the sum
    of kernel times, the device's idle share of the traced run's and of an
    untraced run's wall time, and the kernels that take most of it. Returns
    {name: (device ms, launches)} for each entry of ``symbols`` (a wrapper
    name and the CUDA functions behind it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
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
)
#: (B, S, H, P, N, chunk): the serving path's shape first.
SSD_CASES = (
    (8, 512, 80, 64, 64, 64),   # zamba2 prefill, one mamba layer
    (2, 300, 8, 64, 128, 64),   # padded tail (mamba2-1.3b's N)
    (2, 40, 8, 64, 64, 40),     # S < 64: one short chunk
    (2, 128, 7, 64, 64, 64),    # H = 7: a last head group of one head
    (2, 200, 8, 64, 16, 64),    # N = 16
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
    engine = Engine(model, ServeConfig(max_new_tokens=new,
                                       max_len=prompt_len + new))
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

    smoke = get_config("zamba2-2.7b", smoke=True).scaled(
        compute_dtype=torch.float32)
    on_card = build(smoke, seed=1, device=dev)
    on_cpu = build(smoke, _to_cpu(on_card.params), device="cpu")
    sp = np.random.default_rng(1).integers(1, smoke.vocab, size=(4, 100)
                                           ).astype(np.int32)
    scfg = ServeConfig(max_new_tokens=8, max_len=128)
    a = Engine(on_card, scfg).generate(sp)
    b = Engine(on_cpu, scfg).generate(sp)
    check(np.array_equal(a, b), "smoke zamba2: card and CPU tokens differ")
    print("smoke zamba2 (f32, S=100: a padded SSD tail): card and CPU "
          "generate identical tokens")
    return {"engine": engine, "prompts": prompts, "launches": launches,
            "wall": wall, "prefill_s": st["prefill_s"]}


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


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
    pairs = b * h * s * (s + 1) // 2           # (q, k) pairs under the mask
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
    tri = chunk * (chunk + 1) // 2              # causal (i, j) pairs per chunk
    per_chunk = 2 * tri * (n + p) + 4 * chunk * n * p
    n_ops = b * h * (s // chunk) * per_chunk
    n_bytes = 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * n + 2 * h
                   + b * h * n * p)
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
    front and PHV)."""
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
    return out


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


def main(argv: list[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--compare-kernels", type=Path, metavar="DIR",
                        help="time K1-K6 of checkout DIR beside this "
                             "one's, and nothing else")
    parser.add_argument("--time-kernels", type=Path, help=argparse.SUPPRESS)
    opts = parser.parse_args(argv)
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
    from repro_torch.core.problem import (random_design, sample_neighbor_moves,
                                          spec_16, spec_64, spec_large)
    from repro_torch.core.traffic import traffic_matrix
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
    f64 = traffic_matrix(spec, "BFS")
    ev_on = Evaluator(spec, f64, delta="on", device="cuda")
    ev_off = Evaluator(spec, f64, delta="off", device="cuda")
    base = spec.mesh_design()
    for k in range(3):
        mv = sample_neighbor_moves(spec, base, rng, 24, 24)
        check(np.array_equal(ev_on.batch_moves(mv), ev_off.batch_moves(mv)),
              f"neighbourhood {k}: delta on differs from delta off")
        base = mv.materialize(len(mv) - 1)
    print(f"3 neighbourhoods bit-equal; delta stats {ev_on.delta_stats}")

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

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
