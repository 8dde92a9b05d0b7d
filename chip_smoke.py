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
     host numpy mirrors where the port has them);
  3. the main path: MOO-STAGE on spec_64 under the paper's BFS traffic,
     case5, 2000 evaluations, through ``repro_torch.noc.run`` on the card,
     with the launches of each kernel counted over that run alone;
  4. card against CPU end to end on spec_tiny, seeds 0/1/2;
  5. the evaluator's delta path on the card, bit-equal to the dense path;
  6. each kernel timed at its main-path shapes beside its plain version and
     its bound, printed as one JSON ``kernels`` line; K1–K4 also by the
     profiler's device time per call, which below ~20 us is the honest
     reading (events then time the wrapper's host work);
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
     ``generate`` under torch.profiler. The ``kernels`` JSON line lists all
     six kernels.

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it.

    python3 chip_smoke.py --compare-kernels DIR

times K1 (one evaluator call's APSP) and K4 at phase 6's shapes and K5 and
K6 at the serving shapes, from another checkout ``DIR`` (for example the
parent commit, unpacked with ``git archive``) beside this one's, each in a
fresh process, in the order DIR, this, this, DIR: device time over 10
back-to-back calls, one call between two events, and the profiler's device
time per call. Each tree builds its NoC inputs from the same seed through
its own ``routing`` and ``objectives``, then runs phase 3's main path twice
(wall seconds, front and PHV).
"""

from __future__ import annotations

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
    "forest_predict": ("forest_predict_kernel",),
    "score_block_max": ("score_block_kernel", "score_fold_kernel"),
    "walk": ("walk_tree_kernel", "walk_util_kernel"),
}
#: The redesigned NoC kernels' bars, in ms of device time per call at
#: phase 6's shapes, and over the phase 7 run of the main path.
NOC_BAR_MS = {"minplus": 0.02, "walk": 0.05}
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


def kernel_times(src: Path) -> dict:
    """K1 and K4 at phase 6's shapes and K5 and K6 at phase 10's, of the
    package under ``src``: device time (``time_ms``), one call between two
    events (``time_ms_per_call``) and the profiler's device time per call
    (all of the call's kernels); then two runs of the main path (wall
    seconds, and the second run's accounting, front and PHV)."""
    sys.path.insert(0, str(src))
    import torch

    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    noc = noc_timing_inputs(torch, dev)
    q, k, v = attn_inputs(torch, ATTN_CASES[0], dev)
    args = ssd_inputs(torch, SSD_CASES[0], dev)
    chunk = SSD_CASES[0][-1]
    fns = {"minplus": lambda: ops.apsp(noc["costs"], noc["iters"]),
           "walk": lambda: ops.walk(noc["nh"], noc["f"], noc["delay"],
                                    noc["max_hops"]),
           "flash_attention": lambda: ops.attention(q, k, v, causal=True),
           "ssd": lambda: ops.ssd(*args, chunk=chunk, return_state=True)}
    out = {"package": str(Path(ops.__file__).resolve().parents[1])}
    for name, fn in fns.items():
        out[name] = {"ms": time_ms(fn), "per_call_ms": time_ms_per_call(fn),
                     "trace_ms": sum(r[1] for r in profiled(torch, fn)) / 10}
    walls = [run_main_path(torch) for _ in range(2)]
    res = walls[-1][1]
    out["main_path"] = {"first_s": walls[0][2], "second_s": walls[1][2],
                        "evals": res.n_evals, "calls": res.n_calls,
                        "front": len(res.designs), "phv": res.phv()}
    return out


def compare_kernels(other: Path) -> int:
    """K1, K4, K5 and K6 of checkout ``other`` timed beside this
    checkout's, each in a fresh process, in the order other, this, this,
    other."""
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
    card (hops, delay, all_done bit-equal; util and visits within rtol
    1e-6 where every pair arrives) and the CPU plain version (util and
    visits bit-equal there). Returns the max |err| against the card's plain
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
        check(torch.allclose(got, want, rtol=1e-6, atol=0.0),
              f"walk {label}: {name} beyond rtol 1e-6")
        check(torch.equal(got.cpu(), cpu[i][done.cpu()]),
              f"walk {label}: {name} differs from the CPU plain version")
        err = max(err, float((got - want).abs().max()))
    print(f"K4 walk {label} (B={nh.shape[0]}, max_hops {max_hops}): "
          f"hops/delay/all_done bit-equal, util/visits |err| {err:.3g} vs "
          f"plain on the card and bit-equal to the CPU plain version, two "
          f"runs bit-identical ({int(done.sum())}/{nh.shape[0]} designs "
          f"connected)")
    return err


def random_graphs(torch, rng, bsz: int, n: int, p_edge: float, dev):
    """INF-sparse (B, N, N) f32 matrices of small integer weights."""
    import numpy as np

    w = rng.integers(1, 20, size=(bsz, n, n)).astype(np.float32)
    w[rng.random((bsz, n, n)) > p_edge] = np.float32(1e9)
    return torch.as_tensor(w, device=dev)


def main(argv: list[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--compare-kernels", type=Path, metavar="DIR",
                        help="time K1, K4, K5 and K6 of checkout DIR "
                             "beside this one's, and nothing else")
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
    from repro_torch.core.evaluate import Evaluator
    from repro_torch.core.features import design_features_batch
    from repro_torch.core.forest import RegressionForest
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

    feat_designs = [random_design(spec, rng) for _ in range(600)]
    x_all = design_features_batch(spec, feat_designs)
    # Labels on the scale of the main path's (PHVs in (0, 1)): the 1e-6
    # tolerance is about 8 f32 ulps there.
    z = (x_all - x_all.mean(0)) / (x_all.std(0) + 1e-9)
    y_all = 1.0 / (1.0 + np.exp(-(z @ rng.normal(size=z.shape[1]) / 4.0)))
    forest = RegressionForest(seed=0, device="cuda").fit(x_all[:400],
                                                          y_all[:400])
    nodes = forest.device_nodes()
    depth = forest._flat["depth"]
    k2_err = 0.0
    for bsz in (1, 7, 128, 1500):
        xq = x_all[rng.integers(0, 600, size=bsz)] * (
            1 + 0.05 * rng.normal(size=(bsz, x_all.shape[1])))
        xn = torch.as_tensor(forest._normalize(xq).astype(np.float32),
                             device=dev)
        out = ops.forest_predict(*nodes, xn, depth)
        plain = ref.forest_predict_ref(*nodes, xn, depth)
        oracle = forest.predict(xq, backend="numpy")
        e_plain = float((out - plain).abs().max())
        e_oracle = float(np.abs(out.cpu().numpy() - oracle).max())
        check(e_plain <= 1e-6 and e_oracle <= 1e-6,
              f"forest_predict at B={bsz}: {e_plain} vs plain, "
              f"{e_oracle} vs numpy oracle")
        k2_err = max(k2_err, e_plain)
    errs["forest_predict"] = k2_err
    print(f"K2 forest_predict: max |err| {k2_err:.3g} vs plain, <= 1e-6 vs "
          f"the f64 oracle at B=1,7,128,1500 (T={forest.n_fitted_trees}, "
          f"depth {depth})")

    xm = torch.as_tensor(forest._xm.astype(np.float32), device=dev)
    xs = torch.as_tensor(forest._xs.astype(np.float32), device=dev)
    k3_err = 0.0
    for bsz, n_real, tie in ((48, 48, False), (48, 40, False),
                             (200, 170, False), (200, 200, True)):
        x = torch.as_tensor(x_all[rng.integers(0, 600, size=bsz)]
                            .astype(np.float32), device=dev)
        if tie:
            vals = ref.forest_predict_ref(*nodes, (x - xm) / xs, depth)
            j0 = int(torch.argmax(vals))
            for k in (j0 + 37, j0 + 3, max(j0 - 40, 0)):
                x[min(k, bsz - 1)] = x[j0]
        v, j = ops.score_block_max(*nodes, xm, xs, x, n_real, depth)
        pv, pj = ref.score_block_max_ref(*nodes, xm, xs, x, n_real, depth)
        check(int(j) == int(pj) and abs(float(v) - float(pv)) <= 1e-6,
              f"score_block_max at B={bsz}, n_real={n_real}: "
              f"({int(j)}, {float(v)}) vs plain ({int(pj)}, {float(pv)})")
        if tie:
            vals = ref.forest_predict_ref(*nodes, (x - xm) / xs, depth)
            first = int(torch.nonzero(vals == vals.max())[0])
            check(int(j) == first, f"tie: argmax {int(j)}, first max {first}")
        k3_err = max(k3_err, abs(float(v) - float(pv)))
    errs["score_block_max"] = k3_err
    print("K3 score_block_max: same argmax (first max on ties, padding never "
          f"wins), value |err| {k3_err:.3g}")

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

    x1 = torch.as_tensor(forest._normalize(x_all[:1]).astype(np.float32),
                         device=dev)
    t_count = forest.n_fitted_trees
    node_bytes = 12 * depth + 4          # thr + feat + child per level, leaf
    ms = time_ms(lambda: ops.forest_predict(*nodes, x1, depth))
    plain_ms = time_ms(lambda: ref.forest_predict_ref(*nodes, x1, depth))
    rows.append(("forest_predict", ms, plain_ms,
                 *bound(t_count * node_bytes + 16 * 4 + 4,
                        t_count * (depth + 1))))

    x48 = torch.as_tensor(x_all[:48].astype(np.float32), device=dev)
    ms = time_ms(lambda: ops.score_block_max(*nodes, xm, xs, x48, 48, depth))
    plain_ms = time_ms(lambda: ref.score_block_max_ref(*nodes, xm, xs, x48,
                                                       48, depth))
    rows.append(("score_block_max", ms, plain_ms,
                 *bound(48 * t_count * node_bytes + 48 * 16 * 4 + 2 * 16 * 4
                        + 8, 48 * (2 * 16 + t_count * (depth + 1)))))

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
    fns["forest_predict"] = lambda: ops.forest_predict(*nodes, x1, depth)
    fns["score_block_max"] = lambda: ops.score_block_max(
        *nodes, xm, xs, x48, 48, depth)

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

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
