"""The port's pretrain slice against the JAX package on the CPU: the pair
hash, the fused aggregation under the pair-hash edge dropout
(``drop_hash``), the masked hub blocks and kept degrees, the materialized
keep of the plain path, the orthogonal loss, the optimizer's clip and
schedule, and one full pretrain step from the same converted weights.

JAX and torch cannot share random draws, so the step tests draw them with
``jax.random`` exactly as JAX's step does and hand them to the port's step,
with the encoders' dropout at 0.  JAX on the CPU runs its step as its own
CPU path does: the f32 gather/segment-sum aggregation with the pair hash's
keep folded into the edge mask.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stemgnn_tpu.core import config as jcfg
from stemgnn_tpu.data import synthetic as jax_synthetic
from stemgnn_tpu.models import pretrain as jax_pre
from stemgnn_tpu.ops import chip_profile as jax_profile
from stemgnn_tpu.ops.edge_layout import build_edge_layout as jax_layout
from stemgnn_tpu.ops.fused_sage import fused_sage_aggregate as jax_fused
from stemgnn_tpu.ops.pairhash import pair_hash_uniform as jax_hash
from stemgnn_tpu.ops.spmm import sage_aggregate as jax_sage
from stemgnn_tpu.train import augment as jax_augment
from stemgnn_tpu.train import pretrain_loop as jax_loop
from stemgnn_tpu.train.optim import make_optimizer as jax_optimizer
from stemgnn_tpu.vq.quantize import _orthogonal_loss as jax_ortho
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.models.pretrain import PretrainModel, make_teacher
from stemgnn_tpu_torch.ops import fused_sage as port_fused_mod
from stemgnn_tpu_torch.ops.chip_profile import V5E
from stemgnn_tpu_torch.ops.edge_layout import build_edge_layout
from stemgnn_tpu_torch.ops.fused_sage import (DropView, fused_sage_aggregate,
                                              masked_hub_blocks,
                                              masked_hub_blocks_dense)
from stemgnn_tpu_torch.ops.pairhash import (keep_threshold, pair_hash_keep,
                                            pair_hash_uniform)
from stemgnn_tpu_torch.ops.spmm import sage_aggregate
from stemgnn_tpu_torch.train import optim as port_optim
from stemgnn_tpu_torch.train.graph_setup import fused_full_graph
from stemgnn_tpu_torch.train.pretrain_loop import (make_pretrain_optimizer,
                                                   make_pretrain_step,
                                                   pretrain_graph)
from stemgnn_tpu_torch.utils.convert import (pretrain_from_jax,
                                             pretrain_to_jax)
from stemgnn_tpu_torch.vq.codebook import orthogonal_loss

SEEDS = (0, 1, 12345, 2 ** 31 - 2, 2 ** 31 - 1)


def _two_sided_skew(rng, n=600, e=4000):
    def skew():
        hot = rng.integers(0, 8, e // 2)
        cold = rng.integers(0, n, e - e // 2)
        return rng.permutation(np.concatenate([hot, cold])).astype(np.int32)
    return skew(), skew()


def _layouts(s, r, n_pad, **kw):
    jax_profile.set_profile(jax_profile._V5E)
    try:
        lj = jax_layout(s, r, n_pad, gwin="on", edge_chunk=128, **kw)
    finally:
        jax_profile.set_profile(None)
    lp = build_edge_layout(s, r, n_pad, gwin="on", edge_chunk=128,
                           profile=V5E, **kw)
    return lj, lp


def test_pair_hash_is_bit_equal_to_jax():
    """Ids up to 2^31 - 1 (``lo * 0x85EBCA6B`` overflows 32 bits from 2^16
    on) and seeds up to 2^31 - 1: the same f32 bits, and the same keep
    decisions at each p, the integer form included."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 31 - 1, 50_000).astype(np.int32)
    b = rng.integers(0, 2 ** 31 - 1, 50_000).astype(np.int32)
    a[:8] = [0, 1, 65_535, 65_536, 70_000, 2 ** 31 - 1, 169_342, 7]
    b[:8] = [0, 65_537, 2 ** 31 - 1, 3, 70_000, 2 ** 31 - 2, 169_343, 7]
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    for seed in SEEDS:
        want = np.asarray(jax_hash(jnp.int32(seed), jnp.asarray(a),
                                   jnp.asarray(b)))
        got = pair_hash_uniform(seed, at, bt).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        # symmetric in the pair
        assert torch.equal(pair_hash_uniform(seed, bt, at),
                           pair_hash_uniform(seed, at, bt))
        for p in (0.0, 0.15, 0.2, 0.5, 1.0):
            keep = pair_hash_keep(seed, at, bt, p).numpy()
            assert np.array_equal(keep, want >= np.float32(p)), (seed, p)
    # the integer threshold sits exactly where the f32 uniform crosses p
    for p in (0.2, 0.5, 1.0):
        h0 = keep_threshold(p)
        assert np.float32(h0) / np.float32(2 ** 32) >= np.float32(p)
        assert np.float32(h0 - 1) / np.float32(2 ** 32) < np.float32(p)


@pytest.mark.parametrize("hubs,with_t0", [
    ("hub", False), ("sc_hub", False), ("none", False), ("sc_hub", True)])
def test_fused_drop_hash_value_and_grad_match_jax(hubs, with_t0):
    """Forward and d/dx of sum(out * w) under ``drop_hash`` against JAX's
    ``fused_sage_aggregate(interpret=True, drop_hash=...)`` on the hub
    configurations of tests/test_hub_dense.py:478-481 (gather-side hubs,
    both hub blocks, no hub; both blocks with a t0 row), bf16 messages.
    Both sides keep the same edges, round the same messages and gp = w / deg
    to bf16 and differ only in the order of f32 sums: rtol/atol 1e-4 (well
    inside the 3e-2 of bf16 messages).
    The dropout drops edges: the output differs from the undropped one."""
    rng = np.random.default_rng(7)
    n, e, n_pad, d = 300, 1500, 384, 16
    s, r = _two_sided_skew(rng, n, e)
    kw = {} if hubs == "none" else dict(
        hub_size=8, hub_min_coverage=-1.0,
        sc_hub_size=8 if hubs == "sc_hub" else 0)
    lj, lp = _layouts(s, r, n_pad, feat_dim_hint=d, **kw)
    if hubs == "sc_hub":
        assert lp.hub_r.sc_cnt is not None and lp.hub_s.sc_cnt is not None
    x = np.zeros((n_pad, d), np.float32)
    x[:n] = rng.standard_normal((n, d))
    w = rng.standard_normal((n_pad, d)).astype(np.float32)
    table = (rng.standard_normal((1, d)).astype(np.float32) if with_t0
             else None)
    seed, p = 2 ** 31 - 5, 0.3

    def loss_j(xj):
        out = jax_fused(xj, lj, None if table is None else jnp.asarray(table),
                        reduce="mean", relu=True, bf16_messages=True,
                        interpret=True, drop_hash=(seed, p))
        return jnp.sum(out * w), out
    (_, out_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    tt = None if table is None else torch.from_numpy(table)
    out_p = fused_sage_aggregate(xt, lp, tt, drop_hash=(seed, p))
    (out_p * torch.from_numpy(w)).sum().backward()
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out_p.detach().numpy(), np.asarray(out_j),
                               **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), **tol)
    full = fused_sage_aggregate(torch.from_numpy(x), lp, tt)
    assert not torch.allclose(full, out_p.detach(), atol=1e-3)


def _drop_layout(rng, sc=True):
    s, r = _two_sided_skew(rng)
    return s, r, build_edge_layout(s, r, 640, hub_size=8,
                                   hub_min_coverage=-1.0,
                                   sc_hub_size=8 if sc else 0, profile=V5E)


def test_masked_hub_blocks_equal_the_dense_form():
    """Hashing only the blocks' nonzero pairs gives the blocks JAX forms by
    hashing the whole dense (row, hub) grid (``_masked_hub_mats``, its
    formula with JAX's hash), element for element, in both directions."""
    rng = np.random.default_rng(3)
    _, _, lay = _drop_layout(rng)
    seed, p = 2 ** 31 - 1, 0.4
    for hub in (lay.hub_r, lay.hub_s):
        cnt, sc_cnt, _ = masked_hub_blocks(hub, seed, p)
        dense = masked_hub_blocks_dense(hub, seed, p)
        assert torch.equal(cnt, dense[0]) and torch.equal(sc_cnt, dense[1])
        rows = jnp.arange(hub.cnt.shape[0])
        keep = np.asarray(jax_hash(jnp.int32(seed), rows[:, None],
                                   jnp.asarray(hub.hub_ids.numpy())[None, :])
                          >= p)
        assert np.array_equal(cnt.float().numpy(),
                               hub.cnt.float().numpy() * keep)
        assert float(cnt.float().sum()) < float(hub.cnt.float().sum())


def test_drop_inv_deg_is_the_kept_in_degree():
    """1 / kept in-degree from the decomposition (masked hub blocks + kept
    tail edges) equals 1 / max(1, count of the graph's kept in-edges), with
    and without the scatter-side block and without hubs; it is not
    ``in_degree``."""
    rng = np.random.default_rng(4)
    seed, p = 77, 0.35
    for sc in (True, False):
        s, r, lay = _drop_layout(rng, sc)
        keep = pair_hash_keep(seed, torch.from_numpy(s),
                              torch.from_numpy(r), p).numpy()
        deg = np.bincount(r[keep], minlength=640).astype(np.float32)
        want = 1.0 / np.maximum(deg, 1.0)
        for layout in (lay, build_edge_layout(s, r, 640, profile=V5E)):
            got = DropView(layout, seed, p).inv_deg()[:, 0].numpy()
            np.testing.assert_array_equal(got, want)
            assert not np.array_equal(
                got, 1.0 / np.maximum(layout.in_degree.numpy(), 1.0))


def test_drop_view_hashes_each_block_once_per_step(monkeypatch):
    """A two-layer encoder forward and its backward over one DropView mask
    each hub block once and each tail direction once."""
    rng = np.random.default_rng(5)
    _, _, lay = _drop_layout(rng)
    calls = []
    real = port_fused_mod.masked_hub_blocks
    monkeypatch.setattr(port_fused_mod, "masked_hub_blocks",
                        lambda hub, *a: calls.append(id(hub)) or real(hub,
                                                                      *a))
    view = DropView(lay, 9, 0.2)
    x = torch.randn(640, 16, requires_grad=True)
    out = fused_sage_aggregate(x, lay, drop_hash=view)
    out = fused_sage_aggregate(torch.relu(out), lay, drop_hash=view)
    out.sum().backward()
    assert sorted(calls) == sorted([id(lay.hub_r), id(lay.hub_s)])
    assert {k for k in view._memo if k[0] == "keep"} == {
        ("keep", id(lay.hub_r.tail), "r"), ("keep", id(lay.hub_s.tail), "s")}


def test_sage_aggregate_without_layout_folds_the_hash_keep():
    """No layout: the keep is derived from the same hash and folded into the
    edge mask, as JAX's ``sage_aggregate`` does (spmm.py:98-110)."""
    rng = np.random.default_rng(6)
    n, e, d = 300, 2000, 16
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    ef = rng.standard_normal((e, d)).astype(np.float32)
    mask = np.arange(e) < e - 50
    seed, p = 2 ** 31 - 3, 0.25
    want = jax_sage(jnp.asarray(x), jnp.asarray(s), jnp.asarray(r),
                    edge_feat=jnp.asarray(ef), edge_mask=jnp.asarray(mask),
                    drop_hash=(seed, p))
    got = sage_aggregate(torch.from_numpy(x), torch.from_numpy(s).long(),
                         torch.from_numpy(r).long(),
                         edge_feat=torch.from_numpy(ef),
                         edge_mask=torch.from_numpy(mask),
                         drop_hash=(seed, p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_drop_hash_refuses_typed_tables_and_edge_keep():
    rng = np.random.default_rng(8)
    s, r = rng.integers(0, 100, 400), rng.integers(0, 100, 400)
    lay = build_edge_layout(s, r, 128, xe_ids=rng.integers(0, 3, 400),
                            num_edge_types=3, profile=V5E)
    x = torch.randn(128, 8)
    with pytest.raises(NotImplementedError, match="factored"):
        fused_sage_aggregate(x, lay, torch.randn(3, 8), drop_hash=(1, 0.2))
    # the runtime mask route is ported; it does not combine with the hash
    with pytest.raises(ValueError, match="edge_keep and drop_hash"):
        fused_sage_aggregate(x, lay, edge_keep=torch.ones(400, dtype=bool),
                             drop_hash=(1, 0.2))


def test_orthogonal_loss_matches_jax():
    """The orthogonal term over an injected 32-code subset of 64 (JAX draws
    it from its key: the first 32 of a permutation), its value and its
    gradient: 1e-6."""
    rng = np.random.default_rng(9)
    embed = rng.standard_normal((4, 64, 16)).astype(np.float32)
    cfg = jcfg.VQConfig(dim=16, codebook_size=64, codebook_dim=16, heads=4)
    key = jax.random.PRNGKey(3)
    ids = np.asarray(jax.random.permutation(key, 64)[:32])
    want, g_want = jax.value_and_grad(
        lambda e: jax_ortho(key, e, cfg))(jnp.asarray(embed))
    et = torch.from_numpy(embed).requires_grad_(True)
    got = orthogonal_loss(et, torch.from_numpy(ids.copy()).long())
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(g_want),
                               rtol=1e-6, atol=1e-6)


def test_clip_and_schedule_match_optax():
    """The global-norm clip against optax's ``clip_by_global_norm`` on its
    own (a norm of 1.25: ``clip_grad_norm_``'s ``max_norm / (norm + 1e-6)``
    would be 8e-7 off, four times the tolerance of 2e-7, two f32 ulps), and
    the clip (above and below the norm) with the cosine LambdaLR against
    optax's chain: three AdamW steps, 1e-6."""
    rng = np.random.default_rng(10)
    g = [rng.standard_normal((5, 3)).astype(np.float32),
         rng.standard_normal(7).astype(np.float32)]
    scale = 1.25 / np.sqrt(sum(float((a.astype(np.float64) ** 2).sum())
                               for a in g))
    g = [(a * scale).astype(np.float32) for a in g]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(a) for a in g], optax.EmptyState())
    pt = [torch.zeros(a.shape, requires_grad=True) for a in g]
    for t, a in zip(pt, g):
        t.grad = torch.from_numpy(a.copy())
    norm = port_optim.clip_by_global_norm(pt, 1.0)
    assert abs(float(norm) - 1.25) < 1e-6
    for t, w in zip(pt, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-7,
                                   atol=0)
    p0 = [rng.standard_normal((5, 3)).astype(np.float32),
          rng.standard_normal(7).astype(np.float32)]
    grads = [[rng.standard_normal(a.shape).astype(np.float32) * sc
              for a in p0] for sc in (3.0, 0.01, 1.0)]
    tx = jax_optimizer(1e-2, 1e-3, grad_clip=1.0, use_scheduler=True,
                       epochs=4, steps_per_epoch=1)
    pj = [jnp.asarray(a) for a in p0]
    state = tx.init(pj)
    pt = [torch.from_numpy(a.copy()).requires_grad_(True) for a in p0]
    opt = port_optim.Optimizer(pt, 1e-2, 1e-3, grad_clip=1.0,
                               use_scheduler=True, epochs=4)
    update = jax.jit(tx.update)
    for g in grads:
        upd, state = update([jnp.asarray(a) for a in g], state, pj)
        pj = optax.apply_updates(pj, upd)
        opt.zero_grad()
        for t, a in zip(pt, g):
            t.grad = torch.from_numpy(a.copy())
        opt.step()
        for t, a in zip(pt, pj):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(a),
                                       rtol=1e-6, atol=1e-6)


def test_pretrain_config_refuses_bf16_compute():
    """Mixed precision is ported (tests/test_torch_port_mixed.py): the
    configs once refused are accepted and hold JAX's fields."""
    pcfg.PretrainConfig()
    for kw, jkw in (
            (dict(teacher_bf16=True), dict(teacher_bf16=True)),
            (dict(loss_bf16=True), dict(loss_bf16=True)),
            (dict(encoder=pcfg.EncoderConfig(compute_dtype="bfloat16")),
             dict(encoder=jcfg.EncoderConfig(compute_dtype="bfloat16"))),
            (dict(vq=pcfg.VQConfig(compute_dtype="bfloat16")),
             dict(vq=jcfg.VQConfig(compute_dtype="bfloat16")))):
        got = dataclasses.asdict(pcfg.PretrainConfig(**kw))
        want = dataclasses.asdict(jcfg.PretrainConfig(**jkw))
        assert got == {k: want[k] for k in got}


# --------------------------------------------------------------------------
# one pretrain step against JAX's make_pretrain_step + optax

D = 32
N = 512                  # a multiple of 128: both graphs pad to N nodes


def _dataset(pkg):
    return pkg.synthetic_node_dataset(num_nodes=N, num_classes=5,
                                      feat_dim=D, avg_degree=8,
                                      pref_attach=1.1, num_splits=1, seed=3)


def _jax_cfg():
    return jcfg.PretrainConfig(
        encoder=jcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                                   normalize="batch", dropout=0.0),
        vq=jcfg.VQConfig(dim=D, codebook_size=64, codebook_dim=D, heads=4),
        batch_size=0)


def _port_cfg(cfg):
    return pcfg.from_dict(pcfg.PretrainConfig(), {
        "encoder": vars(cfg.encoder).copy(), "vq": vars(cfg.vq).copy(),
        "batch_size": 0})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_draws(cfg, g, rng):
    """The draws JAX's step makes from ``rng`` (pretrain_loop.py:64-67,
    models/pretrain.py:113, 138-148, vq/quantize.py:197, 138)."""
    k_feat, k_edge, k_fwd = jax.random.split(rng, 3)
    _, k_vq, k_topo, k_neg, _, _ = jax.random.split(k_fwd, 6)
    num = max(int(g.num_edges_padded * cfg.topo_recon_ratio), 1)
    slots, _ = jax_pre._sample_edge_slots(k_topo, g.edge_mask, num)
    neg = jax_pre._negative_edges(k_neg, num, g.n_node, g.num_nodes_padded)
    _, k_ortho, _ = jax.random.split(k_vq, 3)
    keep = jax.random.bernoulli(k_feat, 1.0 - cfg.feat_p, (D,))
    t = lambda a: torch.from_numpy(np.array(a)).long()  # noqa: E731
    return dict(
        feat_keep=torch.from_numpy(np.array(keep)),
        drop_seed=t(jax_augment.dropout_edge_seed(k_edge)),
        slots=t(slots), neg=(t(neg[0]), t(neg[1])),
        ortho_ids=t(jax.random.permutation(
            k_ortho, cfg.vq.codebook_size)[:cfg.vq.orthogonal_reg_max_codes]))


def _leaves(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("route", ["plain_f32", "layout_bf16"])
def test_pretrain_step_matches_jax(route):
    """One full-graph pretrain step (dropout 0, the draws injected) from the
    same converted weights: the losses, every updated student parameter
    (the learnable codebook included), the teacher after its EMA update,
    and the BatchNorm state of the student and of the teacher.

    ``plain_f32``: the port's plain graph runs JAX's arithmetic (the hash's
    keep folded into the edge mask): losses and parameters to 1e-5.
    ``layout_bf16``: the layout path (hub blocks, the masked count blocks,
    kernel 1's plain version on the dropout tails, kernel 2's on the
    teacher's), bf16 messages: the losses and the BatchNorm state get the
    bf16-message tolerance 3e-2, and the parameters 2.1 * lr, since AdamW's
    first step moves each by about lr * sign(grad), and a gradient whose
    sign flips under that rounding moves it the other way
    (test_finetune_train_step_matches_jax).  On both routes the SAGE biases
    ``lin_l.b`` get 2.1 * lr: BatchNorm subtracts their mean, so their
    gradient is rounding noise of the size of Adam's eps."""
    cfg = _jax_cfg()
    params, teacher, state = jax_pre.pretrain_init(jax.random.PRNGKey(0),
                                                   cfg)
    params, teacher, state = _np(params), _np(teacher), _np(state)
    # a teacher some way from the student (as after many steps), so its
    # EMA update moves it by ~1e-3, well above the tolerances
    noise = np.random.default_rng(1)
    teacher = jax.tree_util.tree_map(
        lambda a: (a + noise.normal(0.0, 0.1, a.shape)).astype(a.dtype),
        teacher)
    ds_j = _dataset(jax_synthetic)
    g_j = ds_j.to_graph()
    tx = jax_optimizer(cfg.lr, cfg.weight_decay, grad_clip=cfg.grad_clip,
                       use_scheduler=cfg.use_scheduler, epochs=cfg.epochs,
                       steps_per_epoch=1)
    rng = jax.random.PRNGKey(5)
    step_j = jax_loop.make_pretrain_step(cfg, tx, bs=N)
    p_j, t_j, _, s_j, m_j = step_j(params, teacher, tx.init(params), state,
                                   g_j, rng)
    draws = _jax_draws(cfg, g_j, rng)

    pc = _port_cfg(cfg)
    model, teach = pretrain_from_jax(params, teacher, state, pc)
    ds_p = _dataset(port_synthetic)
    if route == "layout_bf16":
        g_p = fused_full_graph(ds_p, pcfg.FinetuneConfig(
            encoder=pc.encoder, hub_size=64, sc_hub_size=64), device="cpu",
            use_layout=True)
        assert g_p.layout.hub_r is not None and g_p.layout.hub_s is not None
    else:
        g_p = pretrain_graph(ds_p, pc, device="cpu")
        assert g_p.layout is None
    assert g_p.num_nodes_padded == g_j.num_nodes_padded == N
    assert g_p.num_edges_padded == g_j.num_edges_padded
    step = make_pretrain_step(pc, bs=N)
    got = step(model, teach, make_pretrain_optimizer(model, pc), g_p, draws)
    p_p, t_p, s_p = pretrain_to_jax(model, teach)

    f32 = route == "plain_f32"
    tol = dict(rtol=1e-5, atol=1e-5) if f32 else dict(rtol=3e-2, atol=3e-2)
    sign_tol = dict(rtol=0, atol=2.1 * cfg.lr)
    assert float(m_j["topo_sem_recon_loss"]) > 0
    moved = max(float(np.abs(np.asarray(a) - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(t_j), jax.tree_util.tree_leaves(teacher)))
    assert moved > 10 * sign_tol["atol"]
    for k, v in m_j.items():
        np.testing.assert_allclose(float(got[k]), float(v), err_msg=k, **tol)
    for tree_p, tree_j in ((p_p, _np(p_j)), (t_p, _np(t_j))):
        lp, lj = _leaves(tree_p), _leaves(tree_j)
        assert set(lp) == set(lj)
        for path, leaf in lj.items():
            noise = "lin_l" in path and "'b'" in path
            np.testing.assert_allclose(
                lp[path], leaf, err_msg=path,
                **(tol if f32 and not noise else sign_tol))
    assert not np.array_equal(p_p["vq"]["embed"], params["vq"]["embed"])
    for part in ("encoder", "sem_encoder"):
        for i, ns in enumerate(s_j[part]["norms"]):
            gs = s_p[part]["norms"][i]
            for k in ("mean", "var"):
                np.testing.assert_allclose(gs[k], np.asarray(ns[k]), **tol)
            assert int(gs["count"]) == int(ns["count"]) == 1


def test_pretrain_step_routes_through_kernel_1_on_the_dropout_tails(
        monkeypatch):
    """The launches a CUDA step makes, counted on the CPU through the plain
    versions: kernel 1 on the student's dropout tails (two forward, layer
    2's input gradient) and kernel 2 on the teacher's two forward tails
    (the gather gate open); the losses are finite, every student parameter
    and the teacher move, and the step's own draws repeat from a seed."""
    calls = {"gathered": 0, "scatter": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(port_fused_mod, "gathered_scatter_rows_sorted",
                        counting("gathered",
                                 port_fused_mod.gathered_scatter_rows_sorted))
    monkeypatch.setattr(port_fused_mod, "scatter_rows_sorted",
                        counting("scatter",
                                 port_fused_mod.scatter_rows_sorted))
    pc = _port_cfg(_jax_cfg())
    pc = dataclasses.replace(pc, encoder=dataclasses.replace(pc.encoder,
                                                             dropout=0.15))
    ds = _dataset(port_synthetic)
    g = fused_full_graph(ds, pcfg.FinetuneConfig(
        encoder=pc.encoder, hub_size=64, sc_hub_size=64), device="cpu",
        use_layout=True)
    assert g.layout.hub_r.tail.use_gwin_r
    losses = []
    for _ in range(2):
        model = PretrainModel(pc, generator=torch.Generator().manual_seed(0))
        teacher = make_teacher(model)
        before = [p.detach().clone() for p in model.parameters()]
        t_before = [p.detach().clone() for p in teacher.parameters()]
        step = make_pretrain_step(pc, bs=N,
                                  generator=torch.Generator().manual_seed(1))
        for k in calls:
            calls[k] = 0
        out = step(model, teacher, make_pretrain_optimizer(model, pc), g)
        assert calls == {"scatter": 3, "gathered": 2}
        assert all(np.isfinite(float(v)) for v in out.values())
        assert all(not torch.equal(a, b) for a, b in zip(
            before, model.parameters()))
        assert all(not torch.equal(a, b) for a, b in zip(
            t_before, teacher.parameters()))
        losses.append(float(out["loss"]))
    assert losses[0] == losses[1]


def test_pretrain_weights_round_trip():
    cfg = _jax_cfg()
    params, teacher, state = (_np(t) for t in jax_pre.pretrain_init(
        jax.random.PRNGKey(1), cfg))
    model, teach = pretrain_from_jax(params, teacher, state, _port_cfg(cfg))
    assert not any(p.requires_grad for p in teach.parameters())
    p2, t2, s2 = pretrain_to_jax(model, teach)
    for a, b in ((p2, params), (t2, teacher), (s2, state)):
        la, lb = _leaves(a), _leaves(b)
        assert set(la) == set(lb)
        assert all(np.array_equal(la[k], lb[k]) for k in lb)

