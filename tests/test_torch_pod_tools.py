"""The port's pod tools (``repro_torch.launch.{constants,hlo,dryrun,
roofline,perf}``, ``configs.input_specs``, ``abstract_params``) against
the reference's on the CPU.

Importing ``repro.launch.dryrun``, ``roofline`` or ``perf`` sets
``XLA_FLAGS`` at import, so those three are reached only in subprocesses;
``repro.launch.hlo`` and ``repro.launch.constants`` import cleanly here.
The reference's compile runs on a (2, 2) mesh with Auto axes that the
subprocess builds itself, on four forced host devices."""

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import input_specs as ref_input_specs
from repro.dist import sharding as ref_shd
from repro.launch import hlo as ref_hlo
from repro.models import build as ref_build
from repro_torch.configs import (ARCH_NAMES, SHAPES, TOKEN_DTYPE, get_config,
                                 input_specs)
from repro_torch.dist import collectives as col
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch import constants, dryrun, hlo, perf, roofline
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import build, build_train

ROOT = Path(__file__).resolve().parent.parent
H100 = "NVIDIA H100 80GB HBM3"
#: The reference's dtypes as the port's (token ids: configs.TOKEN_DTYPE).
DTYPES = {jnp.int32: TOKEN_DTYPE, jnp.bfloat16: torch.bfloat16,
          jnp.float32: torch.float32}


def _flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _ref_flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(k.key for k in path): leaf for path, leaf in leaves}


def _same_tree(ref_tree, port_tree, label) -> None:
    ref, port = _ref_flat(ref_tree), _flat(port_tree)
    assert sorted(ref) == sorted(port), label
    for path, leaf in ref.items():
        got = port[path]
        if path[-1] == "pos":         # the port's decode position: an int
            assert leaf.shape == () and got == 0, (label, path)
            continue
        assert tuple(got.shape) == tuple(leaf.shape), (label, path)
        assert got.dtype == DTYPES[jnp.dtype(leaf.dtype).type], (label, path)
        assert got.device.type == "meta", (label, path)


# ------------------------------------------------------------ the inputs
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_equal_the_reference(arch):
    for name, shape in SHAPES.items():
        _same_tree(ref_input_specs(ref_get_config(arch), shape),
                   input_specs(get_config(arch), shape), (arch, name))


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch):
    return ref_build(ref_get_config(arch)).abstract_params()


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_params_equal_the_reference(arch):
    cfg = get_config(arch)
    want = _ref_abstract(arch)
    _same_tree(want, build_train(cfg, "meta").abstract_params(), arch)
    _same_tree(want, build(cfg, device="meta").abstract_params(), arch)


# ------------------------------------------------------- per-rank params
def _ref_local_bytes(mesh_shape, axes, kind, params) -> int:
    mesh = jax.sharding.AbstractMesh(mesh_shape, axes)
    specs = ref_shd.param_specs(mesh, ref_shd.default_policy_for(kind),
                                params)
    sizes = dict(zip(axes, mesh_shape))
    total = 0
    leaves = jax.tree_util.tree_leaves(params)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for leaf, spec in zip(leaves, spec_leaves):
        dims = list(leaf.shape)
        for d, entry in enumerate(spec):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                dims[d] //= sizes[a]
        total += math.prod(dims) * jnp.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rank_parameter_bytes_equal_the_reference_param_specs(arch):
    """The dry run's per-rank parameter bytes on both pod meshes, under
    the training (FSDP) and the inference policy, equal the sum of the
    reference's local shapes on an AbstractMesh, exactly."""
    cfg = get_config(arch)
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for kind in ("train", "decode"):
            got = dryrun.tree_bytes(build_train(
                cfg, "meta", mesh=mesh,
                policy=shd.default_policy_for(kind)).abstract_params())
            want = _ref_local_bytes(mesh.axis_sizes, mesh.axis_names, kind,
                                    _ref_abstract(arch))
            assert got == want, (arch, mesh.shape, kind)


# ------------------------------------------------------------ wire rules
def _hlo_line(r) -> str:
    """A record as one post-SPMD HLO instruction of the reference's
    syntax (explicit replica groups of the record's group size)."""
    dt = {torch.bfloat16: "bf16", torch.float32: "f32"}[r.dtype]
    dims = ",".join(str(s) for s in r.shape)
    groups = ",".join(str(i) for i in range(r.group))
    return (f"  %c.1 = {dt}[{dims}]{{0}} {r.kind}(%p0), "
            f"replica_groups={{{{{groups}}}}}")


def _one_of_each(n, dtype):
    """The records of an all-gather, a reduce-scatter, an all-reduce and a
    split of a meta tensor over an abstract (1, n) mesh."""
    mesh = Mesh(("data", "model"), (1, n))
    x = torch.empty((n * 3, 8), dtype=dtype, device="meta")
    with hlo.CollectiveLog() as log:
        col.all_gather(x, mesh, "model", 0)
        col.reduce_scatter(x, mesh, "model", 0)
        col.all_reduce(x, mesh, "model")
        col.split(x, mesh, "model", 1 if n <= 8 else 0)
    return log


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wire_rules_equal_the_reference_parser(n, dtype):
    log = _one_of_each(n, dtype)
    kinds = [r.kind for r in log.records]
    assert kinds == ["all-gather", "reduce-scatter", "all-reduce", "split"]
    ours = hlo.parse_collectives(log)
    for r in log.records[:3]:
        want = ref_hlo.parse_collectives(_hlo_line(r))[r.kind]
        got = hlo.parse_collectives([r])[r.kind]
        assert got == want, (r, got, want)
        assert ours[r.kind] == want
    assert hlo.wire_bytes(ours) == ref_hlo.wire_bytes(
        ref_hlo.parse_collectives("\n".join(_hlo_line(r)
                                            for r in log.records[:3])))
    assert hlo.wire_by_axis(log) == {"model": hlo.wire_bytes(ours)}
    assert log.records[3].result_bytes > 0
    assert set(ours) == set(ref_hlo.parse_collectives(""))


# --------------------------------------------------------- no fallback
def test_meta_collectives_on_an_abstract_mesh_return_the_shape():
    mesh = Mesh(("data", "model"), (2, 4))
    x = torch.empty((8, 6), device="meta")
    assert col.all_gather(x, mesh, "model", 1).shape == (8, 24)
    assert col.all_gather(x, mesh, ("data", "model"), 0).shape == (64, 6)
    assert col.reduce_scatter(x, mesh, "model", 0).shape == (2, 6)
    assert col.all_reduce(x, mesh, "data").shape == (8, 6)
    assert col.split(x, mesh, "data", 0).shape == (4, 6)
    assert col.all_reduce(x, mesh, "data").device.type == "meta"
    with pytest.raises(RuntimeError, match="abstract mesh"):
        col.all_reduce(torch.zeros(8, 6), mesh, "data")
    with pytest.raises(RuntimeError, match="abstract mesh"):
        col.all_gather(torch.zeros(8, 6), mesh, "model", 0)


def test_meta_kernel_inputs_raise_outside_a_counter():
    q = torch.empty((1, 4, 16, 32), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        ops.attention(q, q, q)
    x = torch.empty((1, 16, 2, 8), device="meta")
    args = (x, torch.empty(1, 16, 2, device="meta"),
            torch.empty(2, device="meta"), torch.empty(1, 16, 4, device="meta"),
            torch.empty(1, 16, 4, device="meta"), torch.empty(2, device="meta"))
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        ops.ssd(*args)
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        ops.minplus(torch.empty(2, 4, 4, device="meta"),
                    torch.empty(2, 4, 4, device="meta"))
    with ops.work_log([]) as work:
        y, state = ops.ssd(*args, chunk=8, return_state=True)
        out = ops.attention(q, q[:, :2], q[:, :2], causal=True, window=5)
        with pytest.raises(TypeError, match="expected torch.float32"):
            ops.ssd(x.bfloat16(), *args[1:])
    assert (y.shape, state.shape, out.shape) == (
        (1, 16, 2, 8), (1, 2, 4, 8), (1, 4, 16, 32))
    assert [w.kernel for w in work] == ["ssd", "flash_attention"]
    assert work[0] == ops.Work("ssd", *map(float, ops.ssd_work(
        1, 16, 2, 8, 4, 8, True)), "tf32")
    # The windowed causal mask: row i sees min(i + 1, 5) keys.
    pairs = sum(min(i + 1, 5) for i in range(16))
    assert work[1].flops == 4 * 32 * 1 * 4 * pairs
    assert work[1].bytes == 2 * (2 * 4 * 16 * 32 + 2 * 2 * 16 * 32)


def test_meta_kernels_count_no_launch():
    """K1-K6 on meta inputs inside a work log: the card's path, a record
    each, no launch counted."""
    before = ops.launches()
    meta = functools.partial(torch.empty, device="meta")
    q = meta((1, 4, 16, 32), dtype=torch.bfloat16)
    forest = ops.PackedForest(meta((3, 8, 4), dtype=torch.int32),
                              meta((3, 8)), (), 2, 5, 3, "smem")
    with ops.work_log([]) as work:
        ops.attention(q, q, q)
        ops.apsp(meta((3, 8, 8)), 2)
        ops.walk(meta((3, 8, 8), dtype=torch.int32), meta((3, 8, 8)),
                 meta((8, 8)), 6)
        assert ops.forest_predict_packed(forest, meta((7, 5))).shape == (7,)
        out = meta(2, dtype=torch.int32)
        assert ops.score_block_max_packed(forest, meta(5), meta(5),
                                          meta((7, 5)), 7, out) is out
    assert ops.launches() == before
    assert [w.kernel for w in work] == ["flash_attention", "minplus", "walk",
                                        "forest_predict", "score_block_max"]
    assert work[1].flops == 2 * 2 * 3 * 8 ** 3      # two squarings
    assert work[3].flops == 7 * 3 * (2 + 1)


# --------------------------------------------------------------- counter
def test_counter_counts_views_once_and_frees_dead_storages():
    with dryrun.Counter() as c:
        a = torch.empty((256, 256), device="meta").add(1.0)   # 256 KiB
        v = a.t()
        del a
        b = v.mul(2.0)                                        # 256 KiB
        del v, b
        d = torch.ones(16, device="meta")
    assert c.peak == 2 * 256 * 256 * 4
    assert c.live == 16 * 4
    assert hlo.count_ops(c, "aten.t") == 1
    assert hlo.count_ops(c.ops, "aten.mul.Tensor") == 1
    # Views and bare allocations move no bytes: the add, mul and ones do.
    assert c.bytes == (2 + 2) * 256 * 256 * 4 + 16 * 4
    del d


def test_the_meta_cache_changes_no_count(monkeypatch):
    """The counter replays pure meta ops from a shape cache; a trace with
    the cache off counts the same ops, FLOPs, bytes, peak, kernel work and
    collectives: a hybrid's train step (K5, K6 and their recomputes) and
    a decode step (whose ``_unsafe_view`` outputs alias their inputs)."""
    mesh = Mesh(("data", "model"), (2, 2))
    cells = (("zamba2-2.7b", "train_4k", {"n_layers": 6, "d_model": 512}),
             ("yi-6b", "decode_32k", {"n_layers": 2}))

    def trace():
        out = []
        for arch, shape, over in cells:
            policy = dataclasses.replace(
                shd.default_policy_for(SHAPES[shape].kind), microbatches=1)
            c, args, _ = dryrun.build_traced(arch, shape, mesh, policy, over)
            out.append((c.ops, c.flops, c.bytes, c.peak, c.kernels,
                        c.collectives.records, args))
        return out

    cached = trace()
    monkeypatch.setattr(dryrun, "_meta_key", lambda *a: None)
    assert trace() == cached


YI_PREFILL = {"n_layers": 2}


@functools.lru_cache(maxsize=None)
def _yi_prefill_trace():
    mesh = Mesh(("data", "model"), (2, 2))
    return dryrun.build_traced("yi-6b", "prefill_32k", mesh,
                               shd.default_policy_for("prefill"), YI_PREFILL)


def test_gemm_flops_equal_the_closed_form():
    """2 x the rank's tokens x the rank's weight elements of each product:
    TP over 2 cuts every layer weight in two, the batch of 32 splits over
    data 2, and the head reads only the last position."""
    counter, args, cfg = _yi_prefill_trace()
    d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    per_layer = (2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                 + 3 * d * f) // 2
    rows, seq = 32 // 2, SHAPES["prefill_32k"].seq_len
    want = 2 * rows * seq * per_layer * cfg.n_layers
    want += 2 * rows * d * cfg.vocab // 2
    assert counter.flops == {"bf16": want}
    # K5 on the rank's 16 of 32 heads, causal, at 32 768 positions.
    k5 = counter.kernel_summary()["flash_attention"]
    pairs = seq * (seq + 1) // 2
    assert k5["calls"] == cfg.n_layers
    assert k5["flops"] == cfg.n_layers * 4 * hd * rows * 16 * pairs
    assert args["params"] == dryrun.tree_bytes(build(
        cfg, device="meta", mesh=Mesh(("data", "model"), (2, 2)),
        policy=shd.default_policy_for("prefill")).abstract_params())


# ------------------------------------------- against the reference compile
_REF = r"""
import dataclasses, json
from repro.launch import dryrun as d
from repro.launch import constants as k
from repro.launch import hlo, perf, roofline
from repro.dist import sharding as shd
import jax
from jax.sharding import AxisType
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for shape in ("prefill_32k", "train_4k"):
    kind = d.SHAPES[shape].kind
    pol = dataclasses.replace(shd.default_policy_for(kind), microbatches=1)
    lowered, _ = d.build_lowered("yi-6b", shape, mesh, pol,
                                 {"n_layers": 2, "unroll_layers": True})
    compiled = lowered.compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    coll = hlo.parse_collectives(compiled.as_text())
    out[shape] = {"flops": float(cost["flops"]),
                  "bytes": float(cost["bytes accessed"]),
                  "wire": hlo.wire_bytes(coll)}
cases = [(4.852e14, 2.315e13, 6.885e10, 1e15, 256),
         (1.0e12, 5.0e12, 1.0e9, 3e14, 256),
         (1.0e12, 1.0e11, 9.0e11, 4e14, 512)]
rows = []
for f, b, w, mf, chips in cases:
    c = roofline.CellRoofline("a", "s", "m", chips, f, b, w, mf).finalize()
    rows.append(dataclasses.asdict(c))
def pol(p):
    if p is None:
        return None
    return {"microbatches": p.microbatches, "grad_compress": p.grad_compress,
            "fsdp_axes": list(p.fsdp_axes),
            "logical": [[n, list(a)] for n, a in p.logical]}
exps = [{"name": e.name, "arch": e.arch, "shape": e.shape,
         "policy": pol(e.policy), "cfg_overrides": e.cfg_overrides}
        for e in perf.experiments().values()]
print("REF " + json.dumps({"compile": out, "peak": k.PEAK_FLOPS,
                           "hbm": k.HBM_BW, "link": k.LINK_BW,
                           "cases": cases, "rows": rows,
                           "experiments": exps}))
"""


@pytest.fixture(scope="module")
def ref():
    """The reference's compile of two yi-6b cells, its ``finalize`` on
    three inputs and its experiments, from one subprocess."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_DRYRUN_DEVICES="4", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REF],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("REF ")][0]
    return json.loads(line[4:])


def test_flops_against_the_reference_compile(ref):
    """The reference's ``cost_analysis`` counts elementwise work and
    unmasked attention; the port counts GEMMs and K5 under its mask. On
    yi-6b at two layers on (2, 2) the two agree within 0.5-1.5x."""
    mesh = Mesh(("data", "model"), (2, 2))
    for shape, want in ref["compile"].items():
        pol = dataclasses.replace(
            shd.default_policy_for(SHAPES[shape].kind), microbatches=1)
        counter, _, _ = dryrun.build_traced("yi-6b", shape, mesh, pol,
                                            YI_PREFILL)
        got = sum(counter.flops_by_dtype().values())
        wire = hlo.wire_bytes(hlo.parse_collectives(counter.collectives))
        print(f"yi-6b {shape} (2,2) 2 layers: port {got:.4e} FLOPs, "
              f"reference {want['flops']:.4e}, ratio "
              f"{got / want['flops']:.3f}; bytes {counter.total_bytes():.4e}"
              f" vs {want['bytes']:.4e}; wire {wire:.4e} vs "
              f"{want['wire']:.4e}")
        assert 0.5 <= got / want["flops"] <= 1.5, (shape, got, want)


# -------------------------------------------- roofline and experiments
@pytest.mark.parametrize("case", range(3))
def test_finalize_equals_the_reference(ref, case):
    """One link for every axis and one bf16 peak: every field of the
    reference's ``finalize``; the lever is the port's restatement of the
    same dominant term's."""
    r = ref
    tpu = constants.Peaks("reference", {"bf16": r["peak"]}, r["hbm"], 0,
                          r["link"], 1, r["link"])
    f, b, w, mf, chips = r["cases"][case]
    got = roofline.CellRoofline(
        "a", "s", "m", chips, f, b, w, mf, wire_by_axis={"data": w},
        links={"data": r["link"]}).finalize(tpu)
    want = r["rows"][case]
    got = dataclasses.asdict(got)
    for key in ("flops_by_dtype", "wire_by_axis", "links"):
        got.pop(key)
    want.pop("lever")
    assert got.pop("lever") == roofline.LEVERS[want["dominant"]]
    assert got == want


def test_experiments_equal_the_reference(ref):
    exps = perf.experiments()
    want = ref["experiments"]
    assert [e["name"] for e in want] == list(exps)
    assert len(exps) == 14          # A0-A4, B0-B4, C0-C3
    for w in want:
        e = exps[w["name"]]
        assert (e.arch, e.shape, e.cfg_overrides) == (
            w["arch"], w["shape"], w["cfg_overrides"])
        if w["policy"] is None:
            assert e.policy is None
            continue
        p = e.policy
        assert {"microbatches": p.microbatches,
                "grad_compress": p.grad_compress,
                "fsdp_axes": list(p.fsdp_axes),
                "logical": [[n, list(a)] for n, a in p.logical]} \
            == w["policy"], w["name"]


def test_axis_links_price_nvlink_inside_one_node():
    card = constants.peaks(H100)
    for multi_pod in (False, True):
        links = roofline.axis_links(make_production_mesh(multi_pod=multi_pod),
                                    card)
        assert set(links.values()) == {card.off_node_bw}
    assert roofline.axis_links(Mesh(("data", "model"), (4, 1)), card) == {
        "data": card.nvlink_bw, "model": card.nvlink_bw}
    assert roofline.axis_links(Mesh(("data", "model"), (4, 2)), card) == {
        "data": card.nvlink_bw, "model": card.nvlink_bw}
    assert roofline.axis_links(Mesh(("data", "model"), (2, 8)), card) == {
        "data": card.off_node_bw, "model": card.nvlink_bw}


def test_peaks_know_the_h100_and_no_other_card():
    card = constants.peaks(H100)
    assert card.flops_for("bf16") == 989.4e12
    assert card.flops_for("tf32") == 494.7e12
    assert card.flops_for("f32") == 66.9e12
    assert card.hbm_bw == 3.35e12 and card.hbm_bytes == 81559 * 2 ** 20
    with pytest.raises(KeyError, match="no peaks"):
        constants.peaks("NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError, match="no peak for"):
        card.flops_for("f64")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--card"):
            dryrun.card_peaks(None)


# ------------------------------------------------------------------ CLI
def test_dryrun_cli_writes_ok_records(tmp_path, capsys):
    dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k",
                 "--card", H100, "--out", str(tmp_path)])
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert [r["mesh"] for r in recs] == ["pod16x16", "pod2x16x16"]
    for r in recs:
        assert r["status"] == "ok", r.get("error")
        assert r["memory"]["temp_size_in_bytes"] > 0
        assert r["memory"]["fits"] and r["flops"] > 0 and r["n_ops"] > 0
        assert r["n_devices"] in (256, 512) and r["card"] == H100
    assert "dry-run complete" in capsys.readouterr().out
    skip = dryrun.run_cell("yi-6b", "long_500k", multi_pod=False, card=H100,
                           save=False)
    assert skip["status"].startswith("skip")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_cell_traces_at_two_layers(arch):
    """Each of the arch's cells on both pod meshes, cut to two layers (and
    two encoder layers; the hybrid to one shared-attention site, as the
    reference's roofline cuts it) and to one microbatch (as the roofline
    traces it; the CLI test and ``dryrun --all`` run the sixteen), is
    ``ok`` or the reference's skip: 64 + 16 over the ten archs."""
    cfg = get_config(arch)
    over = {"n_layers": cfg.attn_every if cfg.family == "hybrid" else 2}
    if cfg.family == "encdec":
        over["encoder_layers"] = 2
    recs = [dryrun.run_cell(arch, shape, multi_pod=mp, cfg_overrides=over,
                            card=H100, save=False,
                            policy=dataclasses.replace(
                                shd.default_policy_for(SHAPES[shape].kind),
                                microbatches=1))
            for shape in SHAPES for mp in (False, True)]
    for r, shape in zip(recs, [s for s in SHAPES for _ in (0, 1)]):
        want_skip = arch not in ("mamba2-1.3b", "zamba2-2.7b") \
            and shape == "long_500k"
        if want_skip:
            assert r["status"].startswith("skip"), r
        else:
            assert r["status"] == "ok", (shape, r.get("error"))
            assert r["flops"] > 0 and r["memory"]["temp_size_in_bytes"] > 0


def test_roofline_cell_on_a_pod_mesh():
    c = roofline.analyze_cell("whisper-base", "decode_32k", card=H100,
                              save=False)
    assert c.mesh == "pod16x16" and c.chips == 256
    assert c.compute_s > 0 and c.memory_s > 0 and c.collective_s >= 0
    assert c.dominant in roofline.LEVERS
    assert 0 < c.roofline_fraction
    assert roofline.table([c]).count("\n") == 2
    assert roofline.analyze_cell("yi-6b", "long_500k", card=H100) is None
