"""The port's halo partition, exchange, aggregations and encoder
(``stemgnn_tpu_torch/parallel/halo.py``) against the JAX package on the
CPU.

Host side, no processes: ``build_halo_partition`` (with per-edge features
and type ids, several shard counts and pad multiples),
``degree_balanced_relabel`` and ``relabel_dataset_balanced`` equal to
JAX's bit for bit; ``build_halo_layouts``' per-shard layouts against
JAX's stacked ones (the same edges, the cross-shard hub decisions).

Device side: one 2-rank gloo world for the module (``tests/halo_workers.py``
runs in each rank), holding against JAX's ``shard_map`` on two of the
fake CPU devices of ``tests/conftest.py`` (the fused route in interpret
mode, as ``tests/test_parallel.py`` runs it): the exchange forward and
backward, the plain and fused SAGE aggregations (typed and single-type
tables, f32 messages) value and gradient, and ``halo_encoder_apply`` in
training for sage (plain and fused), gcn, gin, gat and an MoE-SAGE last
layer (JAX's Gumbel draws handed over), with the BatchNorm running means
and the MoE statistics.  Tolerances: 1e-5 relative in f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import halo_workers
from stemgnn_tpu.core import config as jcfg
from stemgnn_tpu.data import synthetic as jax_synthetic
from stemgnn_tpu.nn import encoder as jenc
from stemgnn_tpu.parallel import halo as jhalo
from stemgnn_tpu.parallel.mesh import make_mesh
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.nn.encoder import Encoder
from stemgnn_tpu_torch.parallel import halo as ph
from stemgnn_tpu_torch.parallel import mesh
from stemgnn_tpu_torch.utils.convert import _load

S, D, N, E, T = 2, 8, 200, 1200, 3
PM = {"plain": 8, "fused": 128}     # the kernels walk 128-node blocks
TOL = dict(rtol=1e-5, atol=1e-5)
ENCODERS = ("sage", "sage_fused", "gcn", "gin", "gat", "moe")


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N, E).astype(np.int32)
    r = rng.integers(0, N, E).astype(np.int32)
    s[:80] = 5                                   # a hub sender
    x = rng.standard_normal((N, D)).astype(np.float32)
    xe = rng.integers(0, T, E).astype(np.int32)
    table = rng.standard_normal((T, D)).astype(np.float32)
    return rng, s, r, x, xe, table


# ------------------------------------------------------------------ host

@pytest.mark.parametrize("shards,pm,extras", [
    (2, 8, "ef"), (3, 8, "xe"), (4, 128, "both"), (1, 8, "none")])
def test_partition_equals_jax(shards, pm, extras):
    _, s, r, _, xe, table = _graph(1)
    kw = {}
    if extras in ("ef", "both"):
        kw["edge_feat"] = table[xe]
    if extras in ("xe", "both"):
        kw["xe_ids"] = xe
    want, nb_j, r_j = jhalo.build_halo_partition(s, r, N, shards,
                                                 pad_multiple=pm, **kw)
    got, nb, R = ph.build_halo_partition(s, r, N, shards, pad_multiple=pm,
                                         **kw)
    assert (nb, R) == (nb_j, r_j)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("shards", [2, 3, 5])
def test_balanced_relabels_equal_jax(shards):
    kw = dict(num_nodes=300, num_classes=4, feat_dim=D, num_splits=2,
              train_per_split=50, val_per_split=60, seed=2)
    ds_j = jax_synthetic.synthetic_node_dataset(**kw)
    ds_p = port_synthetic.synthetic_node_dataset(**kw)
    r = np.asarray(ds_j.edge_index[1])
    want, nb_j = jhalo.degree_balanced_relabel(r, ds_j.num_nodes, shards, 8)
    got, nb = ph.degree_balanced_relabel(r, ds_p.num_nodes, shards, 8)
    assert nb == nb_j
    np.testing.assert_array_equal(got, want)
    dj, oj = jhalo.relabel_dataset_balanced(ds_j, shards, pad_multiple=8)
    dp, op = ph.relabel_dataset_balanced(ds_p, shards, pad_multiple=8)
    np.testing.assert_array_equal(op, oj)
    for f in ("x", "edge_index", "labels", "xe"):
        np.testing.assert_array_equal(np.asarray(getattr(dp, f)),
                                      np.asarray(getattr(dj, f)), f)
    for sp, sj in zip(dp.splits, dj.splits):
        for k in sj:
            np.testing.assert_array_equal(sp[k], np.asarray(sj[k]), k)
    assert dp.num_nodes == dj.num_nodes == shards * nb


def _valid_edges(lay, order="r"):
    """The (sender, receiver) pairs of a layout's valid edges, sorted."""
    s = np.asarray(getattr(lay, f"senders_{order}"))
    r = np.asarray(getattr(lay, f"receivers_{order}"))
    m = np.asarray(getattr(lay, f"mask_{order}")).astype(bool)
    return sorted(zip(s[m].tolist(), r[m].tolist()))


@pytest.mark.parametrize("hub_cov", [0.05, 0.9])
def test_layouts_match_jax(hub_cov):
    """Each shard's layouts carry JAX's edges, node spaces, in-degrees and
    hub decisions: hubs on both families at a low coverage bar, none
    where one shard falls short of a high one."""
    rng = np.random.default_rng(4)
    n, e = 96, 1024
    s = np.where(rng.random(e) < 0.7, rng.integers(0, 8, e),
                 rng.integers(0, n, e)).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    part, nb, R = jhalo.build_halo_partition(s, r, n, 4, pad_multiple=8)
    kw = dict(node_block=8, edge_chunk=128, hub_size=8,
              hub_min_coverage=hub_cov)
    j_loc, j_rem = jhalo.build_halo_layouts(part, nb, R, 4, **kw)
    got = ph.build_halo_layouts(part, nb, R, 4, **kw)
    assert len(got) == 4
    for i, (p_loc, p_rem) in enumerate(got):
        for j_lay, p_lay in ((j_loc, p_loc), (j_rem, p_rem)):
            one = jax.tree.map(lambda a: np.asarray(a)[i], j_lay)
            assert p_lay.num_nodes_padded == one.num_nodes_padded
            assert _valid_edges(p_lay) == _valid_edges(one)
            np.testing.assert_array_equal(np.asarray(p_lay.in_degree),
                                          np.asarray(one.in_degree))
            for side in ("hub_r", "hub_s"):
                hj, hp = getattr(one, side), getattr(p_lay, side)
                assert (hj is None) == (hp is None), (i, side)
                if hj is not None:
                    np.testing.assert_array_equal(
                        np.asarray(hp.hub_ids), np.asarray(hj.hub_ids))
                    assert _valid_edges(hp.tail) == _valid_edges(hj.tail)
    assert (got[0][0].hub_r is not None) == (hub_cov < 0.5)


# ---------------------------------------------------------------- device

def _shard_map(f, in_specs, out_specs):
    return jax.jit(jax.shard_map(
        f, mesh=make_mesh(axis_names=("edge",),
                          devices=np.asarray(jax.devices()[:S])),
        in_specs=in_specs, out_specs=out_specs, check_vma=False))


def _enc_cfg(name):
    backbone = "sage" if name in ("sage_fused", "moe") else name
    moe = dict(moe=True, moe_layers="last", num_experts=3) \
        if name == "moe" else {}
    return jcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                              backbone=backbone, normalize="batch",
                              dropout=0.0, **moe)


def _route(s, r, x, rng, route, **kw):
    """One route's partition (JAX's) and the inputs the ranks read."""
    part, nb, R = jhalo.build_halo_partition(s, r, N, S,
                                             pad_multiple=PM[route], **kw)
    x_pad = np.zeros((S * nb, D), np.float32)
    x_pad[:N] = x
    # no edge reads a rank's own block of the halo buffer (the port sends
    # it nowhere and leaves it zero): no gradient reaches it
    cot_halo = rng.standard_normal((S, S * R, D)).astype(np.float32)
    for me in range(S):
        cot_halo[me, me * R:(me + 1) * R] = 0.0
    return part, dict(
        pm=PM[route], nb=nb, R=R, x_pad=x_pad,
        node_mask=np.arange(S * nb) < N, cot_halo=cot_halo,
        cot=rng.standard_normal((S, nb, D)).astype(np.float32))


@pytest.fixture(scope="module")
def world():
    """The inputs, JAX's encoder weights and the 2-rank world's outputs
    (the ranks started before the inputs are made)."""
    mesh.prestart(S, "cpu")
    rng, s, r, x, xe, table = _graph()
    part, plain = _route(s, r, x, rng, "plain", edge_feat=table[xe])
    fpart, fused = _route(s, r, x, rng, "fused", xe_ids=xe)
    enc_params = {}
    encoders = {}
    for k, name in enumerate(ENCODERS):
        cfg = _enc_cfg(name)
        params, state = jenc.encoder_init(jax.random.PRNGKey(k), cfg)
        params = jax.tree.map(np.asarray, params)
        state = jax.tree.map(np.asarray, state)
        enc_params[name] = (cfg, params, state)
        encoders[name] = _load(
            Encoder(pcfg.EncoderConfig(**dataclasses.asdict(cfg))),
            params, state)
    # JAX's Gumbel draws of the MoE layer (layer 2), per shard
    gumbel = []
    for me in range(S):
        key = jax.random.fold_in(jax.random.PRNGKey(3), me)
        for _ in range(2):
            key, _, k_g = jax.random.split(key, 3)
        gumbel.append([np.asarray(jax.random.gumbel(k_g, (plain["nb"], 3)))])
    inp = dict(n=N, s=s, r=r, xe=xe, table=table, ef=table[xe],
               plain=plain, fused=fused, encoders=encoders, gumbel=gumbel)
    outs = mesh.spawn(halo_workers.unit_checks, S, "cpu", inp)
    return dict(inp=inp, part=part, fpart=fpart, outs=outs,
                enc_params=enc_params,
                still_ready=(S, "cpu") in mesh._READY)


def test_prestarted_ranks_serve_the_spawn(world):
    """The spawn took the prestarted world, whose ranks had joined their
    group and imported the compiler stack before they read the call."""
    assert not world["still_ready"]
    for out in world["outs"]:
        marks = out["start_marks"]
        assert list(marks) == ["imported", "initialised",
                               "compiler_imported", "call_read"]
        assert marks["imported"] <= marks["initialised"] \
            <= marks["compiler_imported"] <= marks["call_read"]


def test_prestarted_worlds_are_taken_oldest_first(monkeypatch):
    """Each prestart starts one more world of its size; spawns take them
    oldest first, and a size with none left has no entry."""
    started = []

    def start(world, device_type):
        started.append((world, device_type))
        return f"world{len(started)}", []
    monkeypatch.setattr(mesh, "_start", start)
    mesh.prestart(2, "cpu")
    mesh.prestart(2, "cpu")
    assert started == [(2, "cpu"), (2, "cpu")]
    assert mesh._take_ready(2, "cpu") == ("world1", [])
    assert mesh._take_ready(2, "cpu") == ("world2", [])
    assert mesh._take_ready(2, "cpu") is None
    assert (2, "cpu") not in mesh._READY


def _cat(w, key):
    return np.concatenate([o[key] for o in w["outs"]])


def _jax_grad(w, fn, part, *extra, route="plain", cot="cot"):
    """JAX's value and the gradient of ``sum(out * cot)`` under
    shard_map, over the same shards."""
    g = w["inp"][route]
    xs = jnp.asarray(g["x_pad"].reshape(S, g["nb"], D))
    cot = jnp.asarray(g[cot])
    spec = {k: P("edge") for k in part}

    def f(x_loc, part, cot, *extra):
        loc = jhalo._local(part)

        def out(xl):
            return fn(xl, loc, *extra)
        val, vjp = jax.vjp(out, x_loc[0])
        return val[None], vjp(cot[0])[0][None]
    extra_specs = tuple(jax.tree.map(lambda _: P("edge"), e)
                        for e in extra)
    val, grad = _shard_map(f, (P("edge"), spec, P("edge")) + extra_specs,
                           (P("edge"), P("edge")))(
        xs, {k: jnp.asarray(v) for k, v in part.items()}, cot, *extra)
    return (np.asarray(val).reshape(-1, val.shape[-1]),
            np.asarray(grad).reshape(-1, D))


def _fused_layouts(w):
    g = w["inp"]["fused"]
    ll, lr = jhalo.build_halo_layouts(w["fpart"], g["nb"], g["R"], S,
                                      edge_chunk=128)
    return jax.tree.map(jnp.asarray, ll), jax.tree.map(jnp.asarray, lr)


def test_exchange_forward_and_backward(world):
    """Every peer's block equal to JAX's; a rank's own block zero."""
    want, want_g = _jax_grad(
        world, lambda xl, loc: jhalo.halo_exchange(xl, loc["send_idx"],
                                                   "edge"), world["part"],
        cot="cot_halo")
    R = world["inp"]["plain"]["R"]
    got = _cat(world, "halo").reshape(S, S, R, D)
    want = want.reshape(S, S, R, D)
    for me in range(S):
        for j in range(S):
            if j == me:
                assert not got[me, j].any()
            else:
                np.testing.assert_array_equal(got[me, j], want[me, j])
    np.testing.assert_allclose(_cat(world, "halo_grad"), want_g, **TOL)


def test_plain_aggregate_value_and_gradient(world):
    want, want_g = _jax_grad(
        world, lambda xl, loc: jhalo.halo_sage_aggregate(xl, loc,
                                                         axis="edge"),
        world["part"])
    np.testing.assert_allclose(_cat(world, "plain"), want, **TOL)
    np.testing.assert_allclose(_cat(world, "plain_grad"), want_g, **TOL)


@pytest.mark.parametrize("tag", ["typed", "single"])
def test_fused_aggregate_value_and_gradient(world, tag):
    """Kernel 2's route (its plain version here) over both layouts."""
    table = jnp.asarray(world["inp"]["table"]) if tag == "typed" else None

    def fn(xl, loc, ll_, lr_):
        return jhalo.halo_sage_aggregate_fused(
            xl, loc, jhalo._shard_layout(ll_), jhalo._shard_layout(lr_),
            table, axis="edge", interpret=True, bf16_messages=False)
    want, want_g = _jax_grad(world, fn, world["fpart"],
                             *_fused_layouts(world), route="fused")
    np.testing.assert_allclose(_cat(world, f"fused_{tag}"), want, **TOL)
    np.testing.assert_allclose(_cat(world, f"fused_{tag}_grad"), want_g,
                               **TOL)


@pytest.mark.parametrize("name", ENCODERS)
def test_encoder_in_training_matches_jax(world, name):
    inp = world["inp"]
    cfg, params, state = world["enc_params"][name]
    g, part, lays = inp["plain"], world["part"], ()
    if name == "sage_fused":
        g, part, lays = inp["fused"], world["fpart"], _fused_layouts(world)
    elif cfg.backbone != "sage":
        part = {k: v for k, v in part.items() if not k.startswith("ef_")}
    nb = g["nb"]
    rev, _, _ = jhalo.build_halo_partition(inp["r"], inp["s"], N, S,
                                           pad_multiple=PM["plain"])

    def f(x_loc, nm, part, rev, *lays):
        kw = {}
        if lays:
            kw = dict(lay_loc=jhalo._shard_layout(lays[0]),
                      lay_rem=jhalo._shard_layout(lays[1]),
                      edge_table=jnp.asarray(inp["table"]), interpret=True)
        z, st, aux = jhalo.halo_encoder_apply(
            params, state, cfg, x_loc[0], jhalo._local(part), axis="edge",
            training=True, rng=jax.random.PRNGKey(3), node_mask=nm[0],
            part_rev=jhalo._local(rev), **kw)
        stats = [(m["sum_prob"], m["sum_top1"], m["count"])
                 for m in aux["moe_stats"]]
        return z[None], [n["mean"] for n in st["norms"]], aux["env_reg"], \
            stats
    spec = {k: P("edge") for k in part}
    rspec = {k: P("edge") for k in rev}
    z, means, env, stats = _shard_map(
        f, (P("edge"), P("edge"), spec, rspec)
        + tuple(jax.tree.map(lambda _: P("edge"), la) for la in lays),
        (P("edge"), P(), P(), P()))(
        jnp.asarray(g["x_pad"].reshape(S, nb, D)),
        jnp.asarray(g["node_mask"].reshape(S, nb)),
        {k: jnp.asarray(v) for k, v in part.items()},
        {k: jnp.asarray(v) for k, v in rev.items()}, *lays)
    np.testing.assert_allclose(_cat(world, f"enc_{name}"),
                               np.asarray(z).reshape(-1, D), **TOL)
    for o in world["outs"]:
        for got, want in zip(o[f"enc_{name}_bn_mean"], means):
            np.testing.assert_allclose(got, np.asarray(want), **TOL)
        np.testing.assert_allclose(o[f"enc_{name}_env"], float(env), **TOL)
        assert len(o[f"enc_{name}_stats"]) == len(stats)
        for got, (sp, st, cnt) in zip(o[f"enc_{name}_stats"], stats):
            np.testing.assert_allclose(got["sum_prob"], np.asarray(sp),
                                       **TOL)
            np.testing.assert_allclose(got["sum_top1"], np.asarray(st))
            assert float(got["count"]) == float(cnt)


def test_pretrain_only_inputs_are_refused():
    """The halo pretrain's dropout inputs (ported since) are refused where
    JAX refuses them: one shard's keeps without the other's, the keeps
    with the pair hash, the hash without the global ids and the hash on
    the plain route."""
    x = torch.zeros(8, D)
    with pytest.raises(ValueError, match="keep_loc AND keep_rem"):
        ph.halo_drop_views(None, None, keep_loc=torch.ones(8))
    with pytest.raises(ValueError, match="exclusive"):
        ph.halo_drop_views(None, None, keep_loc=torch.ones(8),
                           keep_rem=torch.ones(8), drop_hash=(1, 0.2))
    with pytest.raises(ValueError, match="needs gids"):
        ph.halo_drop_views(None, None, drop_hash=(1, 0.2))
    enc = Encoder(pcfg.EncoderConfig(input_dim=D, hidden_dim=D,
                                     num_layers=2))
    with pytest.raises(ValueError, match="fused halo layouts"):
        ph.halo_encoder_apply(enc, x, {}, drop_hash=(1, 0.2))
