"""The port's knowledge-graph slice against the JAX package on the CPU: the
WN18RR and FB15K237 caches through both registries, the missing-cache
error, the finetune CLI's flags and ``--use_params`` presets, the FB15K237
preset through the port's CLI, and the bf16 rounding of the hub partial
sums (JAX's ``hub_bf16_acc``).

JAX's CLI reads ``sys.argv`` and runs to the end; the namespace tests stop
it at its wandb sweep round-trip, which receives the parsed arguments after
the preset (``finetune.py:166``), and hold the port's ``parse`` against
them.
"""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemgnn_tpu.data import registry as jax_registry
from stemgnn_tpu.ops import chip_profile as jax_profile
from stemgnn_tpu.ops.edge_layout import build_edge_layout as jax_layout
from stemgnn_tpu.ops.fused_sage import fused_sage_aggregate as jax_fused
from stemgnn_tpu_torch import finetune as port_cli
from stemgnn_tpu_torch.core.config import load_yaml
from stemgnn_tpu_torch.data import importers, registry
from stemgnn_tpu_torch.ops.chip_profile import V5E
from stemgnn_tpu_torch.ops.edge_layout import build_edge_layout
from stemgnn_tpu_torch.ops.fused_sage import fused_sage_aggregate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- the caches

@pytest.mark.parametrize("name,encoder", [("WN18RR", "hash"),
                                          ("FB15K237", "hash"),
                                          ("FB15K237", "tfidf")])
def test_kg_caches_equal_jax(name, encoder):
    """Every array, the split, the class count and the extras of the cached
    knowledge graph, bit for bit, through both registries."""
    dj = jax_registry.load_dataset(name, feat_dim=768, text_encoder=encoder)
    dp = registry.load_dataset(name, feat_dim=768, text_encoder=encoder)
    for f in ("node_text_feat", "edge_text_feat", "x", "xe", "edge_index",
              "labels", "class_node_text_feat"):
        a, b = np.asarray(getattr(dj, f)), getattr(dp, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (dp.name, dp.num_classes, dp.num_tasks) == (
        dj.name, dj.num_classes, dj.num_tasks)
    assert dp.extras == dj.extras
    assert len(dp.splits) == len(dj.splits) == 1
    for k in ("train", "valid", "test"):
        assert np.array_equal(dp.splits[0][k], np.asarray(dj.splits[0][k]))
    want = {"WN18RR": (40_943, 93_003, 11), "FB15K237": (14_537, 38_001,
                                                          228)}[name]
    assert (dp.num_nodes, dp.num_edges, dp.num_classes) == want
    assert dp.edge_text_feat.shape == (1, 768) and not dp.xe.any()
    if name == "FB15K237":
        assert dp.extras["resplit_missing_train"]
    else:
        assert [int(dp.splits[0][k].sum()) for k in ("train", "valid",
                                                     "test")] == [
            86_835, 3_034, 3_134]


@pytest.mark.parametrize("kw", [dict(feat_dim=64),
                                dict(text_encoder="st")])
def test_missing_kg_cache_raises_naming_the_roadmap_item(kw):
    """Once a refusal naming ROADMAP Queue 1 item 8, now JAX's route: a
    missing cache sends the loader to the raw triples, and without them it
    raises ``FileNotFoundError`` naming the file it wanted, as JAX's does;
    no cache is written."""
    path = importers.cache_path("WN18RR", kw.get("text_encoder", "hash"),
                                kw.get("feat_dim", 768))
    for reg in (registry, jax_registry):
        with pytest.raises(FileNotFoundError) as info:
            reg.load_dataset("WN18RR", root="/nonexistent-kg", **kw)
        assert "entity2text.txt" in str(info.value)
    with pytest.raises(FileNotFoundError) as info:
        registry.load_dataset("WN18RR", **kw)
    assert os.path.join(importers.DEFAULT_CACHE_ROOT, "raw", "KG",
                        "WN18RR") in str(info.value)
    assert not os.path.exists(path)


def test_cache_round_trip(tmp_path):
    """``save_dataset_cache`` then ``load_dataset_cache`` under another
    root gives the dataset back, and a name with no file gives None."""
    ds = registry.load_dataset("kg_synthetic", feat_dim=8, num_entities=50,
                               num_edges=200)
    path = importers.save_dataset_cache(ds, "hash", root=str(tmp_path))
    assert path == importers.cache_path("kg_synthetic", "hash", 8,
                                        str(tmp_path))
    back = importers.load_dataset_cache("kg_synthetic", "hash", 8,
                                        str(tmp_path))
    for f in ("node_text_feat", "edge_text_feat", "x", "xe", "edge_index",
              "labels"):
        assert np.array_equal(getattr(back, f), getattr(ds, f)), f
    assert back.num_classes == ds.num_classes
    assert importers.load_dataset_cache("none", "hash", 8,
                                        str(tmp_path)) is None


# ---------------------------------------------------------- the CLI flags

def _load_jax_cli():
    spec = importlib.util.spec_from_file_location(
        "repo_finetune", os.path.join(ROOT, "finetune.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


def _jax_namespace(argv, monkeypatch):
    """JAX's CLI parsed ``argv`` (preset applied), stopped at the sweep."""
    from stemgnn_tpu.utils import jax_cache, observability
    seen = {}

    def stop(args, *a, **k):
        seen["args"] = args
        raise _Parsed
    monkeypatch.setattr(observability, "apply_wandb_sweep_config", stop)
    monkeypatch.setattr(jax_cache, "enable_persistent_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["finetune.py", *argv])
    with pytest.raises(_Parsed):
        _load_jax_cli().main()
    return vars(seen["args"])


PRESETS = [(task, name) for task, entries in load_yaml(
    os.path.join(ROOT, "configs", "finetune.yaml")).items()
    if task in ("node", "link") for name in entries]


@pytest.mark.parametrize("task,name", PRESETS)
def test_use_params_namespace_equals_jax(task, name, monkeypatch):
    """``--use_params`` for every node and link preset of
    ``configs/finetune.yaml``: the port's namespace equals JAX's (the
    port's own ``--device`` aside), with an explicit flag above the
    preset."""
    for argv in (["--use_params", "--finetune_dataset", name, "--debug"],
                 ["--use_params", "--dataset", name, "--lr", "0.01",
                  "--repeat", "2", "--debug"]):
        want = _jax_namespace(argv, monkeypatch)
        got = vars(port_cli.parse(argv))
        assert got.pop("device") is None
        assert got == want, {k: (got.get(k), v) for k, v in want.items()
                             if got.get(k) != v}
    preset = load_yaml(os.path.join(ROOT, "configs",
                                    "finetune.yaml"))[task][name]
    assert got["finetune_lr"] == 0.01 and got["repeat"] == 2
    assert got["finetune_epochs"] == preset["epochs"]
    assert got["batch_size"] == preset["batch_size"]
    assert got["normalize"] == preset["encoder"]["normalize"]


def test_every_jax_option_is_accepted():
    """Every option string of JAX's parser names the same destination in
    the port's, with the same default, type and choices, and parses."""
    jp = _load_jax_cli().get_args()
    pp = port_cli.get_args()
    port_opts = pp._option_string_actions
    checked = 0
    for act in jp._actions:
        for opt in act.option_strings:
            if opt in ("-h", "--help"):
                continue
            assert opt in port_opts, opt
            mine = port_opts[opt]
            assert (mine.dest, mine.default, mine.type, mine.choices,
                    mine.nargs, type(mine).__name__) == (
                act.dest, act.default, act.type, act.choices, act.nargs,
                type(act).__name__), opt
            argv = [opt] if act.nargs == 0 else [opt, str(
                act.choices[0] if act.choices else
                (act.default if act.default not in (None, "") else 1))]
            assert getattr(pp.parse_args(argv), act.dest) is not None \
                or act.default is None, opt
            checked += 1
    assert checked >= 60


@pytest.mark.parametrize("flags,needle", [
    (["--donate"], "JAX mechanism"),
    (["--halo_shards", "2"], "item 10"),
    (["--halo_balance"], "item 10"),
    (["--halo_order", "rcm"], "item 10"),
    (["--reorder", "degree"], "item 3"),
    pytest.param(["--text_encoder", "e5"], None, id="flags5-item 11"),
])
def test_finetune_cli_refuses_naming_the_roadmap_item(flags, needle):
    """``--text_encoder e5``, once refused naming ROADMAP Queue 1 item 11,
    is accepted as in JAX: the default ``cora_synthetic`` is generated
    whatever the encoder, so its features equal the hash run's."""
    argv = ["--device", "cpu", "--debug", *flags]
    if needle is None:
        assert port_cli.refusals(port_cli.parse(argv)) == []
        for reg in (registry, jax_registry):
            a = reg.load_dataset("cora_synthetic", feat_dim=8,
                                 text_encoder="e5")
            b = reg.load_dataset("cora_synthetic", feat_dim=8)
            assert np.array_equal(np.asarray(a.node_text_feat),
                                  np.asarray(b.node_text_feat))
        return
    with pytest.raises(SystemExit) as info:
        port_cli.main(argv)
    assert needle in str(info.value)


@pytest.mark.parametrize("flags", [
    ["--bf16"], ["--eval_bf16", "1"],
    ["--finetune_dataset", "mol_synthetic", "--eval_bf16", "1"]])
def test_finetune_cli_accepts_the_bf16_flags(flags):
    """Once refused naming ROADMAP Queue 1 item 4, now accepted: the
    namespace equals the repo CLI's, and the config takes JAX's values
    (finetune.py:231, 249: ``--bf16`` the encoder's compute dtype, the VQ
    f32; ``--eval_bf16`` passed through)."""
    args = port_cli.parse(["--debug", *flags])
    assert not port_cli.refusals(args)
    got = vars(args).copy()
    assert got.pop("device") is None
    assert got == vars(_load_jax_cli().get_args().parse_args(
        ["--debug", *flags]))
    cfg = port_cli.make_config(args, 4)
    assert cfg.encoder.compute_dtype == ("bfloat16" if "--bf16" in flags
                                         else "float32")
    assert cfg.vq.compute_dtype == "float32"
    assert cfg.eval_bf16 == ("--eval_bf16" in flags)


@pytest.mark.parametrize("flags", [
    ["--moe"], ["--backbone", "gat"],
    ["--moe", "--moe_layers", "last", "--lamda_env", "0.1"],
    ["--backbone", "gcn"], ["--backbone", "gin"]])
def test_finetune_cli_accepts_moe_and_the_other_backbones(flags):
    """Once refused naming ROADMAP Queue 1 item 5, now accepted: the
    namespace equals the repo CLI's and the config takes JAX's encoder
    fields (finetune.py:224-233: ``--moe``, ``--moe_layers``,
    ``--moe_experts``, ``--moe_tau``, ``--backbone``) and ``lamda_env``."""
    args = port_cli.parse(["--debug", *flags])
    assert not port_cli.refusals(args)
    got = vars(args).copy()
    assert got.pop("device") is None
    assert got == vars(_load_jax_cli().get_args().parse_args(
        ["--debug", *flags]))
    cfg = port_cli.make_config(args, 4)
    enc = cfg.encoder
    assert enc.backbone == (flags[1] if "--backbone" in flags else "sage")
    assert enc.moe == ("--moe" in flags) and enc.num_experts == 3
    assert enc.moe_layers == ("last" if "last" in flags else "none")
    assert cfg.lamda_env == (0.1 if "--lamda_env" in flags else 0.0)


def test_fb15k237_preset_trains_on_the_cpu(capsys):
    """``finetune --finetune_dataset FB15K237 --use_params --device cpu``:
    the preset's batches of 1,024 edges (30 a epoch of the 30,400 train
    triples) and its full-batch evaluation, one split (the edge text's
    width fixes every layer's at 768)."""
    res = port_cli.main(["--device", "cpu", "--debug", "--finetune_dataset",
                         "FB15K237", "--use_params", "--epochs", "1",
                         "--repeat", "1"])
    out = capsys.readouterr().out
    assert "[split 0] epoch 0: loss" in out and "30 batches" in out
    assert "final/test:" in out
    (hist,) = res["history"]
    assert hist["batches"] == 30 and hist["host/sample_ms"] > 0
    assert np.isfinite(res["epoch_losses"][0]["loss"])
    assert res["graph"].num_edges_padded >= 38_001


# -------------------------------------- the bf16 hub partials (fault 2)

@pytest.mark.parametrize("hubs", ["hub", "sc_hub"])
@pytest.mark.parametrize("gwin", ["on", "off"])
def test_bf16_hub_partials_round_as_jax(hubs, gwin):
    """With a bf16 output, JAX stores the gather-hub product in bf16 and
    adds the sc block's product in bf16 (``hub_bf16_acc``); the port rounds
    the same way.  On a small hub graph with x and t0 on a grid of 1/8
    every f32 sum is exact in any order, so the two forward outputs agree
    bit for bit (a single rounding of the f32 sum of both blocks differs
    from JAX in some rows)."""
    rng = np.random.default_rng(11)
    n, e, n_pad, d = 600, 4000, 640, 32

    def skew():
        hot = rng.integers(0, 8, e // 2)
        cold = rng.integers(0, n, e - e // 2)
        return rng.permutation(np.concatenate([hot, cold])).astype(np.int32)
    s, r = skew(), skew()
    kw = dict(hub_size=8, hub_min_coverage=-1.0,
              sc_hub_size=8 if hubs == "sc_hub" else 0, feat_dim_hint=d)
    jax_profile.set_profile(jax_profile._V5E)
    try:
        lj = jax_layout(s, r, n_pad, gwin=gwin, edge_chunk=128, **kw)
    finally:
        jax_profile.set_profile(None)
    lp = build_edge_layout(s, r, n_pad, gwin=gwin, edge_chunk=128,
                           profile=V5E, **kw)
    assert lp.hub_r is not None
    assert (lp.hub_r.sc_cnt is not None) == (hubs == "sc_hub")
    x = np.zeros((n_pad, d), np.float32)
    x[:n] = rng.integers(-32, 33, (n, d)) / 8.0
    table = (rng.integers(-8, 9, (1, d)) / 8.0).astype(np.float32)
    out_j = jax_fused(jnp.asarray(x, jnp.bfloat16), lj, jnp.asarray(table),
                      reduce="mean", relu=True, bf16_messages=True,
                      interpret=True)
    out_p = fused_sage_aggregate(torch.from_numpy(x).to(torch.bfloat16), lp,
                                 torch.from_numpy(table), reduce="mean",
                                 relu=True, bf16_messages=True)
    assert out_j.dtype == jnp.bfloat16 and out_p.dtype == torch.bfloat16
    got = out_p.float().numpy()
    want = np.asarray(out_j.astype(jnp.float32))
    assert np.array_equal(got, want), np.abs(got - want).max()
