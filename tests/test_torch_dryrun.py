"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's on the CPU: ``model_flops`` for every registered arch and
shape (the reference's module runs in a child process, since importing
it sets ``XLA_FLAGS``), the roofline's dominance cases on the H100's
constants, one reduced cell of each kind, the multi-card train and
serving cells with their collectives counted by hand, the decode cells'
serve step against the reference's, and ``--pardnn --lint`` writing a
plan that both packages load and the analysis CLI passes."""
import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.api as japi  # noqa: E402
import repro.configs as jcfg  # noqa: E402
import repro.models as jm  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.analysis.__main__ import main as cli_main  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import REGISTRY, ShapeConfig  # noqa: E402
from repro_torch.conformance.subproc import run_py  # noqa: E402
from repro_torch.core.costmodel import (H100_HBM_BW,  # noqa: E402
                                        H100_NVLINK_BW, H100_PEAK_FLOPS)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import (init_cache, init_params,  # noqa: E402
                                io_spec, prefill)
from repro_torch.train import build_serve_step  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

#: small stand-ins for the shape table's kinds
SMALL = {"train_4k": ShapeConfig("train_4k", 32, 2, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 32, 2, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 32, 2, "decode"),
         "long_500k": ShapeConfig("long_500k", 64, 1, "decode")}


def test_model_flops_match_reference():
    out = run_py("""
        import json
        from repro.configs import REGISTRY, SHAPES
        from repro.launch.dryrun import model_flops
        print(json.dumps({f"{a} {s}": model_flops(REGISTRY[a], SHAPES[s])
                          for a in REGISTRY for s in SHAPES}))
        """, timeout=300)
    want = json.loads(out.strip().splitlines()[-1])
    got = {f"{a} {s}": dryrun.model_flops(tcfg.get_config(a),
                                          dryrun.SHAPES[s])
           for a in tcfg.REGISTRY for s in dryrun.SHAPES}
    assert got == want and len(got) == 44


def test_roofline_terms_dominance():
    """The reference's cases (``tests/test_dryrun_units.py``) on the
    H100's constants."""
    t = dryrun.roofline_terms(flops=H100_PEAK_FLOPS * 256, hbm_bytes=0,
                              coll_bytes=0, chips=256)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["dominant"] == "compute"
    t = dryrun.roofline_terms(flops=0, hbm_bytes=H100_HBM_BW * 256 * 2,
                              coll_bytes=0, chips=256)
    assert t["dominant"] == "memory" and t["bound_s"] == pytest.approx(2.0)
    t = dryrun.roofline_terms(flops=0, hbm_bytes=0,
                              coll_bytes=H100_NVLINK_BW * 256 * 3, chips=256)
    assert t["dominant"] == "collective"
    assert t["bound_s"] == pytest.approx(3.0)


@pytest.fixture
def small(monkeypatch):
    """Reduced configs registered under their own names and small
    shapes in the dry run's table."""
    for name in ("granite-8b", "hubert-xlarge", "jamba-v0.1-52b"):
        c = tcfg.get_config(name)
        monkeypatch.setitem(REGISTRY, name, dataclasses.replace(
            tcfg.reduced(c, layers=len(c.prelude) + 2 * c.period),
            name=name))
    for k, v in SMALL.items():
        monkeypatch.setitem(dryrun.SHAPES, k, v)


@pytest.mark.parametrize("arch, shape, remat", [
    ("granite-8b", "train_4k", "dots"),
    ("granite-8b", "train_4k", "dots_no_batch"),
    ("hubert-xlarge", "prefill_32k", "dots"),
    ("jamba-v0.1-52b", "decode_32k", "dots"),
    ("jamba-v0.1-52b", "long_500k", "dots"),
])
def test_reduced_cell_is_ok(small, arch, shape, remat):
    r = dryrun.run_cell(arch, shape, "single", remat=remat, device="cpu")
    assert r["status"] == "OK" and r["chips"] == 1 and r["remat"] == remat
    assert r["nodes"] > 0 and r["graph_flops"] > 0 and r["graph_bytes"] > 0
    assert r["collective_bytes"] == 0.0 and r["fits"]
    assert r["model_flops"] == dryrun.model_flops(tcfg.get_config(arch),
                                                  SMALL[shape])
    assert r["useful_flops_ratio"] == pytest.approx(
        r["model_flops"] / r["graph_flops"])
    params = sum(t.numel() * t.element_size() for t in
                 tree_flatten(io_spec.params_spec(tcfg.get_config(arch)))[0])
    assert r["per_device_total_bytes"] >= params
    rf = r["roofline"]
    assert rf["bound_s"] == max(rf["compute_s"], rf["memory_s"]) > 0


def test_trace_order_peak_falls_under_remat(small):
    """The cell's one-card peak is priced in the trace's order, so a
    policy that recomputes lowers it; the emulator's figure stays under
    its own key."""
    r = {p: dryrun.run_cell("granite-8b", "train_4k", "single", remat=p,
                            device="cpu")
         for p in ("none", "full")}
    assert r["full"]["per_device_total_bytes"] < \
        r["none"]["per_device_total_bytes"]
    for rec in r.values():
        assert rec["emulated_peak_bytes"] > 0
        assert rec["fits"] == (rec["per_device_total_bytes"]
                               <= dryrun.H100_HBM_BYTES)


def test_trace_order_peak_by_hand():
    """x (64 floats) held; a = x * 2, v = a viewed, b = v + 1, c = b * 3
    returned with v: a lives while its view does, b dies at c."""
    def f(x):
        a = x * 2
        v = a.view(8, 8)
        b = v + 1
        return b * 3, v

    traced = api.trace(f, torch.zeros(64), record=True)
    n = 64 * 4
    # x, a (kept by the returned view), b and c together
    assert dryrun.trace_order_peak(traced) == 4 * n

    def g(x):
        a = x * 2
        b = a * 3
        c = b * 4
        return c * 5

    traced = api.trace(g, torch.zeros(64), record=True)
    assert dryrun.trace_order_peak(traced) == 3 * n


def test_multi_mesh_and_skips(small, monkeypatch):
    """Multi prefill and decode cells run (serving over the mesh): granite
    ``prefill_32k`` (a global batch of 32, a row for each of the 32
    data-parallel ranks) and jamba ``decode_32k`` (64 rows of 2,048
    positions) are OK and fit; the single cells' own reasons still
    hold."""
    monkeypatch.setitem(dryrun.SHAPES, "prefill_32k",
                        ShapeConfig("prefill_32k", 32, 32, "prefill"))
    monkeypatch.setitem(dryrun.SHAPES, "decode_32k",
                        ShapeConfig("decode_32k", 2048, 64, "decode"))
    r = dryrun.run_cell("granite-8b", "prefill_32k", "multi", device="cpu")
    assert r["status"] == "OK" and r["chips"] == 512 and r["fits"]
    r = dryrun.run_cell("jamba-v0.1-52b", "decode_32k", "multi",
                        device="cpu")
    assert r["status"] == "OK" and r["chips"] == 512 and r["fits"]
    assert r["rank_collective_bytes"]["all-reduce"] > 0
    r = dryrun.run_cell("hubert-xlarge", "decode_32k", "single",
                        device="cpu")
    assert r["status"] == "SKIP" and "encoder-only" in r["reason"]
    r = dryrun.run_cell("hubert-xlarge", "decode_32k", "multi",
                        device="cpu")
    assert r["status"] == "SKIP" and "encoder-only" in r["reason"]


def _serve_hand_count(cfg, rows: int, long_context: bool):
    """(bytes, counts) of the all-reduces and all-gathers of one rank's
    decode step of a reduced config (float32, every head, expert and
    channel split over model 2) over (pod 2, data 2, model 2), worked out
    from the shapes. A = rows x D floats, one token's activation:

      * the embedding's D-columns gathered (A / 2) and the vocab-split
        head's logits gathered (rows x V / 2);
      * attention: the new token's K and V of the rank's KV heads
        gathered over model (rows x KV/2 x hd each); batched, the
        sequence cut over model, the rank's query heads gathered (rows x
        H/2 x hd), then the combine over model of every head's partials,
        a pmax of the row maxima (rows x H) and one psum of the
        unnormalised outputs with the sums (rows x H x (hd + 1)); at
        long context the combine over data of the rank's heads' partials
        (rows x H/2 and rows x H/2 x (hd + 1)); *g* after ``wo`` (A);
      * MLA (batched): ``q_lat`` and ``q_rope`` gathered (rows x H/2 x r,
        rows x H/2 x rope), the combine in the latent space (rows x H,
        rows x H x (r + 1)), *g* (A);
      * RWKV6: the time mix's *g* and the channel mix's *g* (A each);
      * Mamba: ``w_x``'s product psummed (rows x (R + 2N)), *g* (A);
      * an MLP's *g* (A); an MoE's *g* (A) and, batched, the top-k
        choices gathered over the batch axes (rows x K int32), the
        routing group spanning the ranks."""
    f32, D = 4, cfg.d_model
    A = rows * D * f32
    ar = {"all-reduce": 0, "all-gather": 0}
    n = {"all-reduce": 0, "all-gather": 0}

    def add(kind, b, k=1):
        ar[kind] += b
        n[kind] += k
    add("all-gather", A // 2)
    add("all-gather", rows * cfg.padded_vocab // 2 * f32)
    H, hd = cfg.num_heads, cfg.head_dim
    for kind in cfg.prelude + cfg.block_pattern * cfg.num_periods:
        if kind == "rwkv":
            add("all-reduce", 2 * A, 2)
            continue
        if kind.startswith("mamba"):
            R, N = max(D // 16, 1), cfg.mamba.d_state
            add("all-reduce", rows * (R + 2 * N) * f32 + A, 2)
        elif kind.startswith("mla"):
            r, rd = cfg.kv_lora_rank, cfg.qk_rope_dim
            add("all-gather", rows * H // 2 * (r + rd) * f32, 2)
            add("all-reduce", rows * H * f32 + rows * H * (r + 1) * f32 + A,
                3)
        else:
            add("all-gather", 2 * rows * cfg.num_kv_heads // 2 * hd * f32,
                2)
            Hc = H // 2 if long_context else H
            if not long_context:
                add("all-gather", rows * H // 2 * hd * f32)
            add("all-reduce", rows * Hc * f32 + rows * Hc * (hd + 1) * f32
                + A, 3)
        add("all-reduce", A)
        if kind.endswith("moe") and not long_context:
            add("all-gather", rows * cfg.moe.experts_per_token * 4)
    return ar, n


@pytest.mark.parametrize("arch, shape", [
    ("granite-8b", "decode_32k"), ("deepseek-v2-lite-16b", "decode_32k"),
    ("jamba-v0.1-52b", "long_500k"), ("rwkv6-7b", "long_500k")])
def test_serve_collective_bytes_by_hand(arch, shape):
    """``collective_bytes_from_graph`` on the decode step of reduced
    granite (2 layers), deepseek (its MLA prelude layer with an MLP and
    an ``mla_moe`` layer), jamba (a period: 7 Mamba and 1 attention
    mixers, 4 MLPs, 4 MoE FFNs) and rwkv6 (2 layers), traced for rank 0
    of a (pod 2, data 2, model 2) tracing mesh: ``decode_32k`` as 8 rows
    (2 a rank) of 2,048 positions (1,024 a rank over model),
    ``long_500k`` as 1 row of 2,048 (1,024 a rank over data). Every
    kind's bytes and count as :func:`_serve_hand_count` works them out,
    and the tracing mesh's own count of what it moved the same."""
    from repro_torch.distributed import TracingMesh
    from repro_torch.launch.mesh import MeshShape
    cfg = tcfg.reduced(tcfg.get_config(arch),
                       layers=2 if arch in ("granite-8b", "rwkv6-7b")
                       else None)
    mesh = TracingMesh(MeshShape((2, 2, 2), ("pod", "data", "model")), 0,
                       "cpu")
    long_context = shape == "long_500k"
    sh = ShapeConfig(shape, 2048, 1 if long_context else 8, "decode")
    traced = dryrun.trace_rank_serve(cfg, sh, mesh, torch.device("cpu"))
    got = dryrun.collective_bytes_from_graph(traced.graph)
    want, counts = _serve_hand_count(cfg, 1 if long_context else 2,
                                     long_context)
    assert {k: got["bytes"][k] for k in want} == want
    assert {k: got["counts"][k] for k in counts} == counts
    assert got["bytes"]["reduce-scatter"] == 0
    assert got["total_bytes"] == sum(want.values())
    assert mesh.moved["psum"] + mesh.moved["pmax"] == want["all-reduce"]
    assert mesh.moved["all_gather"] == want["all-gather"]


@pytest.mark.parametrize("arch, kind", [("deepseek-v2-lite-16b", "mla"),
                                        ("rwkv6-7b", "rwkv"),
                                        ("jamba-v0.1-52b", "mamba")])
def test_multi_train_cells_skip_mla_rwkv_mamba(small_families, monkeypatch,
                                               arch, kind):
    """The multi train cell of a config with MLA, RWKV or Mamba blocks
    no longer skips (the test that held their skip, kept under its name,
    now holds that the cells run): reduced, its global batch 64 (2 rows for each of the
    32 data-parallel ranks; 32 x 32 tokens, so that a rank's 64 tokens
    are one MoE group), rank 0 of the 512-chip mesh traced, OK and
    fitting, the rank's collectives counted by kind. At model 16 the 4
    heads do not split (the layers gather their weights and run every
    head on every rank) and 4 experts split by the hidden dim; jamba's
    128 Mamba channels do split, 8 a rank."""
    monkeypatch.setitem(dryrun.SHAPES, "train_4k",
                        ShapeConfig("train_4k", 32, 64, "train"))
    cfg = tcfg.get_config(arch)
    assert kind in cfg.prelude + cfg.block_pattern
    r = dryrun.run_cell(arch, "train_4k", "multi", device="cpu")
    assert r["status"] == "OK" and r["chips"] == 512 and r["fits"]
    by = r["rank_collective_bytes"]
    assert by["all-reduce"] > 0 and by["all-gather"] > 0 and \
        by["reduce-scatter"] > 0
    assert r["collective_bytes"] == pytest.approx(512 * sum(by.values()))


@pytest.fixture
def small_families(monkeypatch):
    """deepseek, rwkv6 and jamba reduced, under their own names."""
    for name in ("deepseek-v2-lite-16b", "rwkv6-7b", "jamba-v0.1-52b"):
        c = tcfg.get_config(name)
        monkeypatch.setitem(REGISTRY, name, dataclasses.replace(
            tcfg.reduced(c), name=name))


def _hand_count(cfg, mesh, rows, seq, remat):
    """All-reduce, all-gather and reduce-scatter operand bytes of one
    rank's step of reduced granite (float32) over ``mesh`` (pod, data,
    model), worked out from the shapes: per layer the forward's two *g*
    (attention and MLP out) and the backward's two *f* (into them), one
    activation A = rows x seq x D each, and with a recompute the
    attention's *g* once more (its MLP *g* feeds nothing the backward
    reads); the head's *f* (A); the vocab-parallel CE's pmax, psum of
    exponentials and psum of the target logit (seq x rows floats each);
    the norm's three squares (over data, model, both); and each
    gradient's block all-reduced over pod. All-gathers: the embedding's
    D-columns, then each updated block over data. Reduce-scatters: each
    gradient over data (its operand the model block)."""
    from repro_torch.train.step import zero1_shardings
    L, D, f32 = cfg.num_layers, cfg.d_model, 4
    A = rows * seq * D * f32
    blocks = [math.prod(sh.shard_shape(p.shape)) * f32 for sh, p in zip(
        tree_flatten(zero1_shardings(io_spec.params_spec(cfg), mesh))[0],
        tree_flatten(io_spec.params_spec(cfg))[0])]
    per_layer = 4 + (remat != "none")
    m = mesh.shape["model"]
    return {"all-reduce": per_layer * L * A + A + 3 * rows * seq * f32
            + 3 * f32 + sum(blocks),
            "all-gather": A // m + sum(blocks),
            "reduce-scatter": mesh.shape["data"] * sum(blocks)}, \
        {"all-reduce": per_layer * L + 1 + 3 + 3 + len(blocks),
         "all-gather": 1 + len(blocks), "reduce-scatter": len(blocks)}


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_collective_bytes_from_graph_by_hand(remat):
    """``collective_bytes_from_graph`` on reduced granite's step traced
    for rank 0 of a (pod 2, data 2, model 2) tracing mesh: every kind's
    bytes and count as :func:`_hand_count` works them out, and the
    tracing mesh's own count of what it moved the same."""
    from repro_torch.distributed import TracingMesh
    from repro_torch.launch.mesh import MeshShape
    cfg = tcfg.reduced(tcfg.get_config("granite-8b"), layers=2)
    mesh = TracingMesh(MeshShape((2, 2, 2), ("pod", "data", "model")), 0,
                       "cpu")
    rows, seq = 2, 32
    traced = dryrun.trace_rank_step(cfg, ShapeConfig("t", seq, 4 * rows,
                                                     "train"),
                                    remat, mesh, torch.device("cpu"))
    got = dryrun.collective_bytes_from_graph(traced.graph)
    want, counts = _hand_count(cfg, mesh, rows, seq, remat)
    assert {k: got["bytes"][k] for k in want} == want
    assert {k: got["counts"][k] for k in counts} == counts
    assert got["bytes"]["all-to-all"] == got["bytes"][
        "collective-permute"] == 0
    assert got["total_bytes"] == sum(want.values())
    assert mesh.moved["psum"] + mesh.moved["pmax"] == want["all-reduce"]


def _block_terms(cfg, kind, A, T):
    """(all-reduce bytes, count) of one split block's activations in a
    step without recompute (float32; A one (rows, seq, D) activation, T
    the rank's tokens): each mixer's *g* forward and *f* backward (2A),
    and
      * MLA: the backward sums of ``w_dkv``, ``w_kr`` and ``kv_norm``,
        whole tensors that the rank's heads read;
      * the RWKV time mix: those of the five token-shift coefficients and
        ``w_lora_a``; its channel mix another 2A;
      * Mamba: ``w_x``'s product psummed forward and its gradient psummed
        backward, T x (R + 2N) each;
    then the FFN: an MLP's 2A, or an MoE's *f* into the experts (A),
    into the top-p weights (T x K) and its *g* (A)."""
    f32, D = 4, cfg.d_model
    if kind == "rwkv":
        return 4 * A + (5 * D + D * cfg.rwkv.lora_w) * f32, 4 + 6
    if kind.startswith("mla"):
        r = cfg.kv_lora_rank
        b, n = 2 * A + (D * r + D * cfg.qk_rope_dim + r) * f32, 5
    elif kind.startswith("mamba"):
        R, N = max(D // 16, 1), cfg.mamba.d_state
        b, n = 2 * A + 2 * T * (R + 2 * N) * f32, 4
    else:
        b, n = 2 * A, 2
    if kind.endswith("moe"):
        return b + 2 * A + T * cfg.moe.experts_per_token * f32, n + 3
    return b + 2 * A, n + 2


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "rwkv6-7b",
                                  "jamba-v0.1-52b"])
def test_collective_bytes_by_hand_families(arch):
    """``collective_bytes_from_graph`` on the step of reduced deepseek
    (the MLA prelude layer with its MLP and an ``mla_moe`` layer), rwkv6
    (2 layers) and jamba (a period: 7 Mamba and 1 attention mixers, 4
    MLPs, 4 MoE FFNs), traced without recompute for rank 0 of a (pod 2,
    data 2, model 2) tracing mesh, where every block splits: every kind's
    bytes and count worked out from the shapes. Per block
    :func:`_block_terms`; then, as for granite (:func:`_hand_count`), the
    head's *f* (A), the CE's pmax and two psums (T floats each), the
    norm's three squares, and each gradient's ZeRO-1 block all-reduced
    over pod (or over pod and data where data splits none of its dims).
    All-gathers: the embedding's D-columns and each updated block that
    data splits; reduce-scatters: each of those gradients over data (its
    operand the model block)."""
    from repro_torch.distributed import TracingMesh
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.train.step import zero1_shardings
    cfg = tcfg.reduced(tcfg.get_config(arch),
                       layers=2 if arch == "rwkv6-7b" else None)
    mesh = TracingMesh(MeshShape((2, 2, 2), ("pod", "data", "model")), 0,
                       "cpu")
    # a rank's 1,024 tokens: one MoE group
    rows, seq = 2, (512 if cfg.moe else 32)
    traced = dryrun.trace_rank_step(cfg, ShapeConfig("t", seq, 4 * rows,
                                                     "train"),
                                    "none", mesh, torch.device("cpu"))
    got = dryrun.collective_bytes_from_graph(traced.graph)
    f32, T = 4, rows * seq
    A = T * cfg.d_model * f32
    blocks = [_block_terms(cfg, kind, A, T) for kind in
              cfg.prelude + cfg.block_pattern * cfg.num_periods]
    zb, split = [], []
    for sh, p in zip(tree_flatten(zero1_shardings(
            io_spec.params_spec(cfg), mesh))[0],
            tree_flatten(io_spec.params_spec(cfg))[0]):
        zb.append(math.prod(sh.shard_shape(p.shape)) * f32)
        split.append("data" in sh.spec)
    ds = sum(b for b, s in zip(zb, split) if s)
    want = {"all-reduce": sum(b for b, _ in blocks) + A + 3 * T * f32
            + 3 * f32 + sum(zb),
            "all-gather": A // 2 + ds, "reduce-scatter": 2 * ds}
    counts = {"all-reduce": sum(k for _, k in blocks) + 1 + 3 + 3 + len(zb),
              "all-gather": 1 + sum(split), "reduce-scatter": sum(split)}
    assert {k: got["bytes"][k] for k in want} == want
    assert {k: got["counts"][k] for k in counts} == counts
    assert got["total_bytes"] == sum(want.values())
    assert mesh.moved["psum"] + mesh.moved["pmax"] == want["all-reduce"]


def test_multi_train_cell_is_ok(small, monkeypatch):
    """A multi train cell (reduced granite, its global batch 64 so that
    each of the 32 data-parallel ranks takes 2 rows): rank 0 of the
    512-chip mesh traced, OK, collective bytes counted by kind (the
    rank's times the chips), the roofline's collective term from them on
    the H100's NVLink rate. At model 16 the 4 query heads do not split:
    the attention gathers its weights and runs whole on every rank."""
    monkeypatch.setitem(dryrun.SHAPES, "train_4k",
                        ShapeConfig("train_4k", 32, 64, "train"))
    r = dryrun.run_cell("granite-8b", "train_4k", "multi", device="cpu")
    assert r["status"] == "OK" and r["chips"] == 512 and r["fits"]
    assert r["collective_bytes"] > 0
    by = r["rank_collective_bytes"]
    assert by["all-reduce"] > 0 and by["all-gather"] > 0 and \
        by["reduce-scatter"] > 0
    assert r["collective_bytes"] == pytest.approx(512 * sum(by.values()))
    assert r["collective_bytes_by_op"]["all-reduce"] == 512 * \
        by["all-reduce"]
    assert r["collective_schedule"]["all-reduce"] > 0
    rf = r["roofline"]
    assert rf["collective_s"] == pytest.approx(
        r["collective_bytes"] / (512 * H100_NVLINK_BW))
    assert r["per_device_total_bytes"] > 0 and r["nodes"] > 0


def test_cli_multi_cell_writes_its_record(small, monkeypatch, tmp_path,
                                          capsys):
    """``--mesh multi`` through the CLI: the cell's record OK on 512
    chips with the collectives by kind, and the line printed."""
    monkeypatch.setitem(dryrun.SHAPES, "train_4k",
                        ShapeConfig("train_4k", 32, 64, "train"))
    assert dryrun.main(["--arch", "granite-8b", "--shape", "train_4k",
                        "--mesh", "multi", "--remat", "dots", "--device",
                        "cpu", "--out", str(tmp_path)]) == 0
    assert "[OK] granite-8b__train_4k__multi" in capsys.readouterr().out
    rec = json.loads((tmp_path / "granite-8b__train_4k__multi.json")
                     .read_text())
    assert rec["status"] == "OK" and rec["chips"] == 512
    assert rec["remat"] == "dots" and rec["wall_s"] > 0
    assert set(rec["rank_collective_bytes"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"}


def test_abstract_args_match_reference():
    """``abstract_train_args`` and ``abstract_serve_args``: every leaf's
    shape and dtype as the reference's ``ShapeDtypeStruct``s, in its
    leaf order."""
    from repro.train.step import abstract_serve_args as jserve
    from repro.train.step import abstract_train_args as jtrain
    from repro_torch.train.step import (abstract_serve_args,
                                        abstract_train_args)

    def leaves(tree, jax_tree=False):
        if jax_tree:
            return [(tuple(x.shape), str(x.dtype))
                    for x in jax.tree_util.tree_leaves(tree)]
        return [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for t in tree_flatten(tree)[0]]
    for arch in ("granite-8b", "mixtral-8x7b", "hubert-xlarge"):
        jc = jcfg.reduced(jcfg.get_config(arch), layers=2)
        tc = tcfg.reduced(tcfg.get_config(arch), layers=2)
        for got, want in zip(abstract_train_args(tc, None, SMALL["train_4k"]),
                             jtrain(jc, None, SMALL["train_4k"])):
            assert leaves(got) == leaves(want, True), arch
            assert all(t.device.type == "meta" for t in tree_flatten(got)[0])
    jc = jcfg.reduced(jcfg.get_config("granite-8b"), layers=2)
    tc = tcfg.reduced(tcfg.get_config("granite-8b"), layers=2)
    for got, want in zip(abstract_serve_args(tc, SMALL["decode_32k"]),
                         jserve(jc, SMALL["decode_32k"])):
        assert leaves(got) == leaves(want, True)


def test_cell_asks_for_the_card_by_default(small):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is there")
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.run_cell("granite-8b", "train_4k", "single")


def test_trace_on_fake_tensors_equals_a_real_trace(small):
    """The decode cell's trace (fake tensors from the meta specs) is the
    graph a trace of real CPU tensors of the same shapes gives."""
    cfg, shape = tcfg.get_config("granite-8b"), SMALL["decode_32k"]
    fake = dryrun._trace_cell(cfg, shape, "dots", torch.device("cpu"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    caches = init_cache(cfg, shape.global_batch, shape.seq_len, "cpu")
    tokens = torch.zeros((shape.global_batch, 1), dtype=torch.int32)
    real = api.trace(build_serve_step(cfg, shape, "cpu"), params, caches,
                     tokens, torch.tensor(3, dtype=torch.int32))
    assert fake.fingerprint == real.fingerprint and fake.n == real.n


def test_serve_step_matches_reference():
    """``build_serve_step`` (the decode cells' step) against the
    reference's on a 1 x 1 mesh: the greedy token, the logits and every
    cache leaf after one step from a prefill."""
    from jax.sharding import AxisType

    from repro.configs.base import ShapeConfig as JShape
    from repro.train.step import build_serve_step as jax_build
    jc = jcfg.reduced(jcfg.get_config("granite-8b"), layers=2)
    tc = tcfg.reduced(tcfg.get_config("granite-8b"), layers=2)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jp = jm.init_params(jc, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    prompt = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 9),
                                               np.int32)
    _, jcache = jm.prefill(jc, jp, {"tokens": jnp.asarray(prompt[:, :8])},
                           32)
    built = jax_build(jc, mesh, JShape("d", 32, 2, "decode"), donate=False)
    jtok, jlogits, jnew = built.fn(jp, jcache, jnp.asarray(prompt[:, 8:]),
                                   jnp.int32(8))
    _, tcache = prefill(tc, tp, {"tokens": torch.from_numpy(prompt[:, :8])},
                        32)
    step = build_serve_step(tc, SMALL["decode_32k"], device="cpu")
    tok, logits, new = step(tp, tcache, prompt[:, 8:],
                            torch.tensor(8, dtype=torch.int32))
    assert tok.dtype == torch.int32 and tok.shape == (2, 1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        np.asarray, jnew))
    mine = tree_flatten(new)[0]
    assert len(mine) == len(got)
    for a, b in zip(mine, got):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="decode shape"):
        build_serve_step(tc, SMALL["train_4k"], device="cpu")


def test_list_prints_every_cell(capsys):
    """Every cell, single and multi: a multi cell runs exactly where its
    single cell runs (every config, every shape, serving over the mesh
    included), and a skipped one gives the single cell's reason."""
    assert dryrun.main(["--list", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(tcfg.ASSIGNED_ARCHS) * len(dryrun.SHAPES) * 2
    runs = {ln.split()[0] for ln in lines if ln.rstrip().endswith("RUN")}
    for a in tcfg.ASSIGNED_ARCHS:
        for s, shape in dryrun.SHAPES.items():
            single = dryrun.cell_name(a, s, "single") in runs
            multi = dryrun.cell_name(a, s, "multi")
            assert (multi in runs) == single, multi
    assert any(ln.split()[0].endswith("__multi") and "decode" in ln
               for ln in lines if ln.rstrip().endswith("RUN"))
    assert not any("M4.1e" in ln for ln in lines)


def test_cli_cell_writes_its_record(small, tmp_path, capsys):
    assert dryrun.main(["--arch", "granite-8b", "--shape", "train_4k",
                        "--mesh", "single", "--device", "cpu", "--out",
                        str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[OK] granite-8b__train_4k__single" in out
    rec = json.loads((tmp_path / "granite-8b__train_4k__single.json")
                     .read_text())
    assert rec["status"] == "OK" and rec["remat"] == "full"
    # a second run reads the cell back
    assert dryrun.main(["--arch", "granite-8b", "--shape", "train_4k",
                        "--mesh", "single", "--device", "cpu", "--out",
                        str(tmp_path)]) == 0
    assert "[cached]" in capsys.readouterr().out


def test_pardnn_lint_plan_loads_in_both_packages(tmp_path, capsys):
    """``--pardnn --lint --device cpu`` (0 errors), the plan loaded by
    the port and by the reference, and ``python -m repro_torch.analysis
    PLAN --arch`` clean on it; bound to another arch's trace it reports
    RP033 and exits 1."""
    assert dryrun.main(["--pardnn", "--lint", "--arch", "granite-8b",
                        "--device", "cpu", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[OK] granite-8b" in out and "(0E/" in out
    path = str(tmp_path / "granite-8b__pardnn_k4.plan.json")
    diag = json.loads((tmp_path / "granite-8b__pardnn_k4.diagnostics.json")
                      .read_text())
    assert not [d for d in diag["diagnostics"] if d["severity"] == "error"]
    mine, theirs = api.PartitionPlan.load(path), japi.PartitionPlan.load(path)
    assert mine.fingerprint == theirs.fingerprint
    np.testing.assert_array_equal(mine.assignment, theirs.assignment)
    assert cli_main([path, "--arch", "granite-8b", "--device", "cpu"]) == 0
    rep = str(tmp_path / "rep.json")
    assert cli_main([path, "--arch", "gemma3-1b", "--device", "cpu",
                     "--json", rep]) == 1
    codes = {d["code"] for d in json.loads(open(rep).read())["diagnostics"]}
    assert "RP033" in codes
