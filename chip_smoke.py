#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
``nvcc``. Imports nothing of JAX or of the JAX package ``repro``. Phases,
each raising on failure:

  1. header: the card's name and power limit, torch and CUDA versions; the
     four kernels built from ``src/repro_torch/csrc`` (build seconds,
     ``-Xptxas -v`` registers and shared memory);
  2. every kernel against its plain PyTorch version on the card (and the
     host numpy mirrors where the port has them);
  3. the main path: MOO-STAGE on spec_64 under the paper's BFS traffic,
     case5, 2000 evaluations, through ``repro_torch.noc.run`` on the card,
     with the launches of each kernel counted over that run alone;
  4. card against CPU end to end on spec_tiny, seeds 0/1/2;
  5. the evaluator's delta path on the card, bit-equal to the dense path;
  6. each kernel timed at its main-path shapes beside its plain version and
     its bound, printed as one JSON ``kernels`` line;
  7. one more main-path run under torch.profiler: device busy time, the
     device's idle share, the kernels that take the most time.

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores and
#: HBM3 bandwidth, at the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, warmup: int = 5, reps: int = 50) -> float:
    """Median wall time of one call on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def trace_main_path(torch, fn, untraced_wall: float) -> None:
    """Device time of one more main-path run under torch.profiler: the sum
    of kernel times, the device's idle share of the untraced run's wall
    time, and the kernels that take most of it."""
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
        print("trace: the profiler saw no device time (not measured)")
        return
    print(f"trace: device busy {busy_ms:.3f} ms over {len(kern)} kernel "
          f"names; device idle share {1 - busy_ms / (traced_wall * 1e3):.4f} "
          f"of the traced run's {traced_wall * 1e3:.1f} ms wall, "
          f"{1 - busy_ms / (untraced_wall * 1e3):.4f} of phase 3's "
          f"{untraced_wall * 1e3:.1f} ms (which includes first-use set-up)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


def random_graphs(torch, rng, bsz: int, n: int, p_edge: float, dev):
    """INF-sparse (B, N, N) f32 matrices of small integer weights."""
    import numpy as np

    w = rng.integers(1, 20, size=(bsz, n, n)).astype(np.float32)
    w[rng.random((bsz, n, n)) > p_edge] = np.float32(1e9)
    return torch.as_tensor(w, device=dev)


def main() -> int:
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from repro_torch.core import routing
    from repro_torch.core.evaluate import Evaluator
    from repro_torch.core.features import design_features_batch
    from repro_torch.core.forest import RegressionForest
    from repro_torch.core.objectives import (design_cost, design_cost_np,
                                             make_consts)
    from repro_torch.core.problem import (random_design, sample_neighbor_moves,
                                          spec_64)
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
            if "Used" in line or "Compiling entry" in line:
                print(f"  ptxas[{name}] {line.strip()}")

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
    print("K1 minplus: bit-equal at B=64/N=64, N=7,33,129,300,1024; spec_64 "
          "APSP and next_hop bit-equal to the host mirrors")

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

    f_core = torch.as_tensor(traffic_matrix(spec, "BFS").astype(np.float32),
                             device=dev)
    perms = torch.as_tensor(np.stack([d.perm for d in designs]).astype(
        np.int64), device=dev)
    f_slots = (f_core[perms[:, :, None], perms[:, None, :]]
               * (~consts.eye).float()).contiguous()
    k4 = ops.walk(nh, f_slots, consts.link_delay, spec.max_hops)
    k4b = ops.walk(nh, f_slots, consts.link_delay, spec.max_hops)
    plain = ref.walk_ref(nh, f_slots, consts.link_delay, spec.max_hops)
    cpu = ref.walk_ref(nh.cpu(), f_slots.cpu(), consts.link_delay.cpu(),
                       spec.max_hops)
    torch.cuda.synchronize()
    for a, b, name in zip(k4, k4b, ("hops", "delay", "util", "visits",
                                    "all_done")):
        check(torch.equal(a, b), f"walk: two runs differ in {name}")
    for i, name in ((0, "hops"), (1, "delay"), (4, "all_done")):
        check(torch.equal(k4[i], plain[i]), f"walk: {name} differs")
    done = k4[4].bool()
    check(bool(done.any()), "walk: no connected design in the sample")
    k4_err = 0.0
    for i, name in ((2, "util"), (3, "visits")):
        got, want = k4[i][done], plain[i][done]
        check(torch.allclose(got, want, rtol=1e-6, atol=0.0),
              f"walk: {name} beyond rtol 1e-6")
        check(torch.equal(got.cpu(), cpu[i][done.cpu()]),
              f"walk: {name} differs from the CPU plain version")
        k4_err = max(k4_err, float((got - want).abs().max()))
    errs["walk"] = k4_err
    print(f"K4 walk: hops/delay/all_done bit-equal, util/visits |err| "
          f"{k4_err:.3g} vs plain on the card and bit-equal to the CPU "
          f"plain version, two runs bit-identical "
          f"({int(done.sum())}/64 designs connected)")

    # ------------------------------------------------------------- phase 3
    phase("3 main path: stage on spec_64")
    problem = NocProblem(spec=named_spec("64"), traffic="BFS", case="case5")
    # max_local_steps=40: with the default 10 000 the first local search
    # alone spends the 2000 evaluations and the surrogate is never queried.
    main_cfg = {"max_local_steps": 40}
    ops.reset_launches()
    t0 = time.perf_counter()
    res = run(problem, "stage", budget=Budget(max_evals=2000, seed=0),
              config=main_cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = ops.launches()
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
    bsz, n = 48, spec.n_tiles            # one neighbourhood of 24+24 moves
    a = costs[:bsz].contiguous()
    b = dist[:bsz].contiguous()
    ms = time_ms(lambda: ops.minplus(a, b))
    plain_ms = time_ms(lambda: ref.minplus_ref(a, b))
    rows.append(("minplus", ms, plain_ms,
                 *bound(3 * bsz * n * n * 4, 2 * bsz * n ** 3)))

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

    nh48, f48 = nh[:bsz].contiguous(), f_slots[:bsz].contiguous()
    hop_sum = float(k4[0][:bsz].sum())
    ms = time_ms(lambda: ops.walk(nh48, f48, consts.link_delay,
                                  spec.max_hops))
    plain_ms = time_ms(lambda: ref.walk_ref(nh48, f48, consts.link_delay,
                                            spec.max_hops))
    rows.append(("walk", ms, plain_ms,
                 *bound(bsz * n * n * 4 * 5 + n * n * 4 + bsz * n * 4
                        + bsz * 4, 2 * hop_sum + 2 * bsz * n * n)))

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
        print(f"{name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms by {bound_by}; no PyTorch call computes it)")
    # ------------------------------------------------------------- phase 7
    phase("7 trace of the main path")
    trace_main_path(torch, lambda: run(
        problem, "stage", budget=Budget(max_evals=2000, seed=0),
        config=main_cfg, device="cuda"), wall)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
