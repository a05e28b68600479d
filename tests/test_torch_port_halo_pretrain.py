"""The port's halo pretrain (``stemgnn_tpu_torch/parallel/halo_pretrain.py``,
the dropout routes of ``parallel/halo.py`` and ``ops/fused_sage.py``, and
``pretrain --halo_shards``) against the JAX package on the CPU.

Host side, no processes:

  * ``halo_pretrain_arrays`` against JAX's ``prepare_halo_pretrain_graph``:
    the partition, the combined edge view, the original endpoints and the
    global-id tables, bit for bit (2 and 4 shards, typed and not);
  * ``build_halo_layouts`` with the scatter-side hub blocks against JAX's,
    and JAX's rebuild of a family whose shards disagree on that block;
  * the kept edges at dropout 0.2 of every shard's local and remote layout,
    hub tails and count blocks (scatter-side block included) against JAX's
    ``drop_mask_layout`` with JAX's global ids, bit for bit, and the kept
    in-degrees; the typed route's keeps per partition edge against JAX's
    hash of ``cgs`` / ``cgr`` and its kept degrees.

Device side, gloo worlds whose ranks run ``tests/halo_workers.py`` (JAX
on the same number of the fake CPU devices of ``tests/conftest.py``, its
kernels in interpret mode):

  * one step of ``halo_pretrain_step`` against JAX's
    ``make_halo_pretrain_step`` from JAX's initial weights with JAX's
    draws, at S = 2 (single-type table, hub and scatter-side blocks: the
    pair hash over global ids) and on a 2 x 2 grid (a typed table: the
    runtime keeps): every loss within 1e-3 relative, the averaged
    gradients before the clip within 2e-3 of each tensor's largest entry
    (the losses' bf16 messages summed in another order), the parameters
    bit-equal across ranks.

The runner, the k-means seeding and the checkpoint handed to ``finetune``
are in ``tests/test_torch_port_halo_pretrain_run.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import halo_workers
from stemgnn_tpu.core import config as jcfg
from stemgnn_tpu.models import pretrain as jax_pre
from stemgnn_tpu.ops.fused_sage import drop_mask_layout
from stemgnn_tpu.ops.pairhash import pair_hash_uniform as jax_hash
from stemgnn_tpu.parallel import halo as jhalo
from stemgnn_tpu.parallel import halo_pretrain as jhp
from stemgnn_tpu.parallel.mesh import make_mesh
from stemgnn_tpu.train.optim import make_optimizer as jax_optimizer
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.ops.fused_sage import DropView, EdgeKeep
from stemgnn_tpu_torch.parallel import halo as ph
from stemgnn_tpu_torch.parallel import halo_pretrain as php
from stemgnn_tpu_torch.parallel import mesh

D, N, E, T = 16, 120, 900, 3
P_DROP = 0.2
LAY = dict(node_block=8, edge_chunk=128)
# the port's kernels (and their plain versions) walk blocks of 128 nodes
LAY_KERNELS = dict(node_block=128, edge_chunk=128)


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N, E).astype(np.int32)
    r = rng.integers(0, N, E).astype(np.int32)
    s[:150] = rng.integers(0, 4, 150)            # hub senders
    r[150:260] = rng.integers(60, 64, 110)       # hub receivers
    x = rng.standard_normal((N, D)).astype(np.float32)
    xe = rng.integers(0, T, E).astype(np.int32)
    table = rng.standard_normal((T, D)).astype(np.float32)
    return s, r, x, xe, table


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


# ------------------------------------------------------------------ host

@pytest.mark.parametrize("shards,typed", [(2, False), (4, True)])
def test_pretrain_arrays_equal_jax(shards, typed):
    s, r, x, xe, table = _graph(1)
    sg, nb_j, _, _ = jhp.prepare_halo_pretrain_graph(
        x, np.stack([s, r]), shards, xe_ids=xe if typed else None,
        edge_table=table if typed else None, pad_multiple=8, **LAY)
    got, nb, R, _ = php.halo_pretrain_arrays(
        x, np.stack([s, r]), shards, xe if typed else None, pad_multiple=8,
        node_block=8)
    assert nb == nb_j
    assert set(got) == set(sg)
    for k, v in sg.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _edges(s, r, m):
    s, r, m = (np.asarray(a) for a in (s, r, m))
    m = m.astype(bool)
    return sorted(zip(s[m].tolist(), r[m].tolist()))


def _shard(tree, i):
    return jax.tree.map(lambda a: np.asarray(a)[i], tree)


def _jax_layouts(part, nb, R, S, hub, typed=False):
    return jhalo.build_halo_layouts(
        part, nb, R, S, hub_size=hub, sc_hub_size=0 if typed else hub,
        num_edge_types=T if typed else 1, feat_dim_hint=D, **LAY)


def test_layouts_with_scatter_blocks_match_jax():
    """The scatter-side blocks on both families (JAX's sc_hub_size),
    their rows and edges; a family where one shard's block fails the
    exact-count guard is rebuilt without it, as JAX rebuilds it."""
    s, r, _, _, _ = _graph(2)
    for case in ("agree", "disagree"):
        ss, rr = s, r
        if case == "disagree":
            # 8 heavy senders of shard 0 take its local gather hubs; 300
            # copies of one local tail edge into node 3 then fail the
            # scatter block's count guard on shard 0's local layout alone
            heavy = np.repeat(np.arange(10, 18), 330)
            ss = np.concatenate([s, heavy, np.full(300, 50)]).astype(np.int32)
            rr = np.concatenate([r, np.arange(len(heavy)) % 60,
                                 np.full(300, 3)]).astype(np.int32)
        part, nb, R = jhalo.build_halo_partition(ss, rr, N, 2,
                                                 pad_multiple=8)
        j_loc, j_rem = _jax_layouts(part, nb, R, 2, hub=8)
        got = ph.build_halo_layouts(part, nb, R, 2, hub_size=8,
                                    sc_hub_size=8, feat_dim_hint=D, **LAY)
        for i, pair in enumerate(got):
            for fam, j_lay, p_lay in zip(("loc", "rem"), (j_loc, j_rem),
                                         pair):
                one = _shard(j_lay, i)
                assert _edges(p_lay.senders_r, p_lay.receivers_r,
                              p_lay.mask_r) == _edges(one.senders_r,
                                                      one.receivers_r,
                                                      one.mask_r)
                for side in ("hub_r", "hub_s"):
                    hj, hp = getattr(one, side), getattr(p_lay, side)
                    assert (hj is None) == (hp is None), (case, i, side)
                    if hj is None:
                        continue
                    assert (hj.sc_cnt is None) == (hp.sc_cnt is None)
                    assert (hp.sc_cnt is None) == (
                        case == "disagree" and fam == "loc"), (case, i, side)
                    if hp.sc_cnt is not None:
                        np.testing.assert_array_equal(
                            hp.sc_ids.numpy()[:hp.sc_size],
                            np.asarray(hj.sc_ids)[:hp.sc_size])
                    assert _edges(hp.tail.senders_r, hp.tail.receivers_r,
                                  hp.tail.mask_r) == _edges(
                        hj.tail.senders_r, hj.tail.receivers_r,
                        hj.tail.mask_r)


def _dense(cnt, rows, cols, shape):
    """A count block as {(row id, col id): count} over its nonzero
    entries."""
    c = np.asarray(cnt, np.float32)
    out = {}
    for a, b in zip(*np.nonzero(c)):
        out[(int(rows[a]), int(cols[b]))] = float(c[a, b])
    return out


def test_kept_edges_and_degrees_equal_jax():
    """Dropout 0.2 over global ids on every shard: the port's DropView
    keeps exactly the edges, (node, hub) counts and scatter-side counts
    JAX's ``drop_mask_layout`` bakes, on the local layout (an offset) and
    the remote one (the halo-slot table), forward and backward, and the
    kept in-degrees."""
    s, r, x, _, _ = _graph(3)
    S, hub = 2, 8
    sg, nb, (j_loc, j_rem), _ = jhp.prepare_halo_pretrain_graph(
        x, np.stack([s, r]), S, pad_multiple=8, hub_size=hub, **LAY)
    part, _, R = jhalo.build_halo_partition(s, r, N, S, pad_multiple=8,
                                            xe_ids=np.zeros(E, np.int32))
    got = ph.build_halo_layouts(part, nb, R, S, hub_size=hub,
                                sc_hub_size=hub, feat_dim_hint=D, **LAY)
    seed = 123_457
    checked = {"edges": 0, "hub": 0, "sc": 0}
    for i in range(S):
        off = i * nb
        gsrc = np.array(sg["gid_rem_src"][i])
        for name, j_lay, p_lay, ids_j, ids_p in (
                ("loc", j_loc, got[i][0], (off, off), (off, off)),
                ("rem", j_rem, got[i][1], (jnp.asarray(gsrc), off),
                 (torch.from_numpy(gsrc), off))):
            base = _shard(j_lay, i)
            baked = drop_mask_layout(jax.tree.map(jnp.asarray, base), seed,
                                     P_DROP, ids=ids_j)
            view = DropView(p_lay, torch.tensor(seed), P_DROP, ids=ids_p)
            src = (lambda a: a + off) if name == "loc" else \
                (lambda a: gsrc[np.minimum(a, len(gsrc) - 1)])
            dst = lambda a: a + off                          # noqa: E731
            subs = [(base, baked, p_lay)] + [
                (getattr(base, h).tail, getattr(baked, h).tail,
                 getattr(p_lay, h).tail) for h in ("hub_r", "hub_s")
                if getattr(p_lay, h) is not None]
            for b, bk, sub in subs:
                for o in ("r", "s"):
                    sp = getattr(sub, f"senders_{o}").numpy()
                    rp = getattr(sub, f"receivers_{o}").numpy()
                    keep = (getattr(sub, f"mask_{o}")
                            & view.keep(sub, o)).numpy()
                    want = _edges(np.asarray(getattr(bk, f"senders_{o}")),
                                  np.asarray(getattr(bk, f"receivers_{o}")),
                                  getattr(bk, f"mask_{o}"))
                    assert _edges(sp, rp, keep) == want, (i, name, o)
                    checked["edges"] += len(want)
            for o, h in (("r", "hub_r"), ("s", "hub_s")):
                hp, hj = getattr(p_lay, h), getattr(baked, h)
                assert (hp is None) == (hj is None)
                if hp is None:
                    continue
                cnt, sc_cnt, _ = view.hub(hp, o)
                rows_map, cols_map = (dst, src) if o == "r" else (src, dst)
                n_pad = cnt.shape[0]
                ids_h = np.asarray(hj.hub_ids)
                assert _dense(cnt.float(), rows_map(np.arange(n_pad)),
                              cols_map(hp.hub_ids.numpy()), None) == \
                    _dense(hj.cnt, rows_map(np.arange(n_pad)),
                           cols_map(ids_h), None), (i, name, o)
                checked["hub"] += int((cnt != 0).sum())
                if sc_cnt is not None:
                    sc_rows = rows_map(hp.sc_ids.numpy())
                    assert _dense(sc_cnt.float(), sc_rows,
                                  cols_map(np.arange(sc_cnt.shape[1])),
                                  None) == _dense(
                        hj.sc_cnt, rows_map(np.asarray(hj.sc_ids)),
                        cols_map(np.arange(sc_cnt.shape[1])), None)
                    checked["sc"] += int((sc_cnt != 0).sum())
            np.testing.assert_array_equal(view.kept_deg().numpy()[:nb],
                                          np.asarray(baked.in_degree)[:nb])
    assert min(checked.values()) > 0, checked


def test_typed_keeps_equal_jax():
    """A typed table takes the runtime keeps: per partition edge, the hash
    of the original endpoints ``cgs`` / ``cgr`` (JAX :199-202), and the
    layouts' kept in-degrees through ``EdgeKeep``."""
    s, r, x, xe, table = _graph(4)
    S = 2
    sg, nb, _, _ = jhp.prepare_halo_pretrain_graph(
        x, np.stack([s, r]), S, xe_ids=xe, edge_table=table, pad_multiple=8,
        **LAY)
    _, _, R, part = php.halo_pretrain_arrays(x, np.stack([s, r]), S, xe,
                                             pad_multiple=8, node_block=8)
    lays = ph.build_halo_layouts(part, nb, R, S, hub_size=8,
                                 num_edge_types=T, feat_dim_hint=D, **LAY)
    seed = 99_991
    cfg = pcfg.PretrainConfig(edge_p=P_DROP)
    for i in range(S):
        keepc = np.asarray(jax_hash(jnp.int32(seed), sg["cgs"][i],
                                    sg["cgr"][i]) >= P_DROP)
        el = sg["s_loc"].shape[1]
        hg = php.HaloPretrainGraph(
            part=ph.part_to_device(php.shard_of(
                {k: np.array(v) for k, v in sg.items()}, i), "cpu"),
            x=None, node_mask=None, nb=nb, R=R, offset=i * nb,
            lay_loc=lays[i][0], lay_rem=lays[i][1],
            edge_table=torch.from_numpy(table))
        kw = php.step_dropout(cfg, hg, torch.tensor(seed))
        np.testing.assert_array_equal(kw["keep_loc"].numpy(), keepc[:el])
        np.testing.assert_array_equal(kw["keep_rem"].numpy(), keepc[el:])
        for side, keep in (("loc", keepc[:el]), ("rem", keepc[el:])):
            m = np.asarray(sg[f"m_{side}"][i]) & keep
            want = np.bincount(np.asarray(sg[f"r_{side}"][i])[m],
                               minlength=nb)
            lay = lays[i][0 if side == "loc" else 1]
            deg = EdgeKeep(lay, torch.from_numpy(keep.copy())).kept_deg()
            np.testing.assert_array_equal(deg.numpy()[:nb], want)


# ---------------------------------------------------------------- device

def _jax_cfg(typed=False, **kw):
    return jcfg.PretrainConfig(
        encoder=jcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                                   normalize="batch", dropout=0.0),
        vq=jcfg.VQConfig(dim=D, codebook_size=16, codebook_dim=8, heads=2,
                         commitment_weight=1.0, orthogonal_reg_weight=0.1,
                         orthogonal_reg_max_codes=8),
        feat_p=0.2, edge_p=P_DROP, topo_recon_ratio=0.2, lr=3e-3,
        **kw)


def _port_cfg(cfg):
    return pcfg.from_dict(pcfg.PretrainConfig(), {
        **{k: v for k, v in dataclasses.asdict(cfg).items()
           if k not in ("encoder", "vq")},
        "encoder": dataclasses.asdict(cfg.encoder),
        "vq": dataclasses.asdict(cfg.vq)})


def _capture():
    """An optax transformation that passes the updates on and keeps them
    in its state: chained first, the step's averaged gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _jax_draws(cfg, sg, nb, rng_d, e):
    """The draws JAX's ``halo_pretrain_forward`` makes on edge rank ``e``
    from its replica's key (:151-152, 160-165, 213, 235-236, 250-253; the
    VQ's orthogonal subset, quantize.py:140, 177), as numpy."""
    (k_f, k_e, _, k_vq, k_topo, k_neg, _) = jax.random.split(rng_d, 7)
    e_comb = int(sg["cs"].shape[1])
    num = max(int(e_comb * cfg.topo_recon_ratio), 1)
    k_u, k_v = jax.random.split(jax.random.fold_in(k_neg, e))
    _, k_ortho, _ = jax.random.split(jax.random.fold_in(k_vq, e), 3)
    return {k: np.asarray(v) for k, v in dict(
        feat_keep=jax.random.bernoulli(k_f, 1.0 - cfg.feat_p, (D,)),
        drop_seed=jax.random.randint(k_e, (), 0, jnp.iinfo(jnp.int32).max),
        slots=jax.random.randint(jax.random.fold_in(k_topo, e), (num,), 0,
                                 e_comb),
        neg_u=jax.random.randint(k_u, (num,), 0, nb),
        neg_v=jax.random.randint(k_v, (num,), 0, nb),
        ortho_ids=jax.random.permutation(
            k_ortho, cfg.vq.codebook_size)[:cfg.vq.orthogonal_reg_max_codes]
    ).items()}


def _jax_mesh(nd, S):
    return make_mesh(axis_sizes=(nd, S), axis_names=("data", "edge"),
                     devices=np.asarray(jax.devices()[:nd * S]))


STEP_CASES = {"s2_hash": (1, 2, False, 8), "grid2x2_typed": (2, 2, True, 8)}


@pytest.fixture(scope="module", params=list(STEP_CASES))
def step_world(request):
    nd, S, typed, hub = STEP_CASES[request.param]
    mesh.prestart(nd * S, "cpu")
    s, r, x, xe, table = _graph(5)
    cfg = _jax_cfg()
    params, teacher, state = _np(jax_pre.pretrain_init(
        jax.random.PRNGKey(0), cfg))
    sg, nb, layouts, et = jhp.prepare_halo_pretrain_graph(
        x, np.stack([s, r]), S, xe_ids=xe if typed else None,
        edge_table=table if typed else table[:1], pad_multiple=128,
        hub_size=hub, **LAY_KERNELS)
    n_pad = S * nb
    rng = np.random.default_rng(6)
    seeds = rng.choice(N, 70)
    seed_w = np.zeros((nd, n_pad), np.float32)
    for d in range(nd):
        np.add.at(seed_w[d], seeds[d::nd], 1.0)
    rngs = jax.random.split(jax.random.PRNGKey(11), nd)
    draws = [[_jax_draws(cfg, sg, nb, rngs[d], e) for e in range(S)]
             for d in range(nd)]
    tx = optax.chain(_capture(), jax_optimizer(
        cfg.lr, cfg.weight_decay, grad_clip=cfg.grad_clip,
        use_scheduler=cfg.use_scheduler, epochs=cfg.epochs,
        steps_per_epoch=1))
    step = jhp.make_halo_pretrain_step(cfg, tx, _jax_mesh(nd, S), layouts,
                                       et, interpret=True)
    p2, t2, o2, _, metrics = step(
        params, teacher, tx.init(params), state, rngs,
        jnp.asarray(seed_w.reshape(nd, S, nb)), sg, *layouts)
    inp = dict(cfg=_port_cfg(cfg), S=S, init=(params, teacher, state), x=x,
               ei=np.stack([s, r]), xe=xe if typed else None,
               table=table if typed else table[:1], hub=hub, seed_w=seed_w,
               draws=draws)
    outs = mesh.spawn(halo_workers.halo_pretrain_step_checks, nd * S, "cpu",
                      inp)
    return dict(outs=outs, metrics={k: float(v) for k, v in
                                    metrics.items()},
                grads=_leaves(o2[0]), params=_leaves(p2),
                teacher=_leaves(t2), nd=nd, S=S)


def test_first_step_losses_match_jax(step_world):
    """Every loss of the first step within 1e-3 relative of JAX's; the
    same on every rank (the orthogonal term, drawn per edge rank, is rank
    0's in both)."""
    w = step_world
    assert [o["grid"] for o in w["outs"]] == [
        (d, e) for d in range(w["nd"]) for e in range(w["S"])]
    got = w["outs"][0]["losses"]
    assert got["topo_sem_recon_loss"] > 0 and got["topo_recon_loss"] > 0
    for k, v in w["metrics"].items():
        assert abs(got[k] - v) <= 1e-3 * abs(v) + 1e-6, (k, got[k], v)
    for o in w["outs"][1:]:
        for k in ("feat_recon_loss", "sem_recon_loss", "topo_recon_loss"):
            assert o["losses"][k] == got[k], k


def test_first_step_gradients_match_jax(step_world):
    """The averaged gradients before the clip within 2e-3 of each
    tensor's largest entry, the parameters after AdamW within 2.1 lr (one
    step moves each by about lr), bit-equal across ranks.  The SAGE
    biases ``lin_l.b`` feed BatchNorm, which subtracts their mean: their
    gradient is 0 up to rounding on both sides (about 1e-6 here), so
    theirs is held within 2e-3 of the step's largest gradient instead."""
    w = step_world
    got = _leaves(w["outs"][0]["grads"])
    assert set(got) == set(w["grads"])
    step_top = max(float(np.abs(v).max()) for v in w["grads"].values())
    for path, want in w["grads"].items():
        top = (step_top if "lin_l" in path and "'b'" in path
               else float(np.abs(want).max()))
        err = float(np.abs(got[path] - want).max())
        assert err <= 2e-3 * top + 1e-7, (path, err, top)
    p_got = _leaves(w["outs"][0]["params"][0])
    for path, want in w["params"].items():
        np.testing.assert_allclose(p_got[path], want, rtol=0,
                                   atol=2.1 * 3e-3, err_msg=path)
    assert len({o["digest"] for o in w["outs"]}) == 1


def test_grid_world_is_a_multiple_of_the_shards(monkeypatch):
    """The grid's world (ROADMAP, differences kept on purpose): torchrun's
    ``WORLD_SIZE`` when set, else S ranks on the CPU (one replica); a
    world that is not a multiple of S raises.  ``--data_parallel`` takes
    one rank on the CPU."""
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.halo_world(2, "cpu") == 2 and mesh.data_world("cpu") == 1
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "6")
    assert mesh.halo_world(3, "cpu") == 6 and mesh.data_world("cpu") == 6
    with pytest.raises(ValueError, match="not a multiple"):
        mesh.halo_world(4, "cpu")
    ranks = mesh.Ranks(rank=0, world=3, device=torch.device("cpu"),
                       backend="gloo")
    with pytest.raises(ValueError, match="not a multiple"):
        mesh.grid(ranks, 2)
