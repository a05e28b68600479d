"""The port's VQ training options (stemgnn_tpu_torch/vq/codebook.py and
vq/quantize.py: the EMA codebook update, dead-code expiry, the affine
statistics, stochastic and straight-through Gumbel sampling) against the
JAX package's ``vq_apply``, on the CPU.

JAX and torch cannot share random draws, so each test draws them with
``jax.random`` as ``vq_apply`` does (the Gumbel noise, the expiry's sample
rows, the orthogonal subset) and hands them to the port.  The outputs, the
loss, the gradients and every state buffer agree to 1e-5; one pretrain
step with ``ema_update`` holds the losses, the adopted codebook and the VQ
state to 1e-5; the state survives both checkpoint directions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemgnn_tpu.core import config as jcfg
from stemgnn_tpu.data import synthetic as jax_synthetic
from stemgnn_tpu.models import pretrain as jax_pre
from stemgnn_tpu.train import pretrain_loop as jax_loop
from stemgnn_tpu.train.optim import make_optimizer as jax_optimizer
from stemgnn_tpu.vq.quantize import adopt_ema_embed as jax_adopt
from stemgnn_tpu.vq.quantize import vq_apply, vq_init
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.train.pretrain_loop import (make_pretrain_optimizer,
                                                   make_pretrain_step,
                                                   pretrain_graph)
from stemgnn_tpu_torch.utils.convert import (_load, pretrain_from_jax,
                                             pretrain_to_jax,
                                             to_jax_pytree)
from stemgnn_tpu_torch.vq import codebook as cb
from stemgnn_tpu_torch.vq.quantize import VectorQuantize, adopt_ema_embed

from test_torch_port_pretrain import _jax_draws, _leaves, _np

TOL = dict(rtol=1e-5, atol=1e-5)


def vq_draws(rng, cfg, dist_shape, mask=None):
    """The draws ``vq_apply`` makes from ``rng`` (vq/quantize.py:195,
    codebook.py:58, 74-86, quantize.py:138): Gumbel noise of the distances'
    shape, the expiry's [h, C] sample rows, the orthogonal subset."""
    k_gumbel, k_ortho, k_expire = jax.random.split(rng, 3)
    h, n, c = dist_shape
    noise = np.asarray(jax.random.gumbel(k_gumbel, dist_shape, jnp.float32))
    idx = []
    for k in jax.random.split(k_expire, h):
        if mask is not None:
            logits = jnp.where(jnp.asarray(mask), 0.0, -jnp.inf)
            idx.append(jax.random.categorical(k, logits,
                                              shape=(cfg.codebook_size,)))
        else:
            idx.append(jax.random.randint(k, (cfg.codebook_size,), 0, n))
    ortho = None
    if cfg.orthogonal_reg_max_codes \
            and cfg.codebook_size > cfg.orthogonal_reg_max_codes:
        ortho = torch.from_numpy(np.array(jax.random.permutation(
            k_ortho, cfg.codebook_size)[:cfg.orthogonal_reg_max_codes]))
    return dict(gumbel=torch.from_numpy(noise.copy()),
                expire_idx=torch.from_numpy(np.stack(idx)).long(),
                ortho_ids=ortho)


CASES = {
    "ema": dict(ema_update=True),
    "ema-dead": dict(ema_update=True, threshold_ema_dead_code=2.0),
    "ema-dead-shared": dict(ema_update=True, threshold_ema_dead_code=1.5,
                            separate_codebook_per_head=False),
    "stochastic": dict(stochastic_sample_codes=True,
                       sample_codebook_temp=0.5),
    "gumbel-st": dict(stochastic_sample_codes=True,
                      straight_through_gumbel=True),
    "affine": dict(use_cosine_sim=False, affine_param=True),
    "affine-ema-gumbel": dict(use_cosine_sim=False, affine_param=True,
                              straight_through_gumbel=True,
                              stochastic_sample_codes=True, ema_update=True,
                              threshold_ema_dead_code=1.0),
    "ema-no-mask": dict(ema_update=True, threshold_ema_dead_code=2.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_vq_training_options_match_jax(case):
    kw = dict(dim=16, codebook_size=8, codebook_dim=16, heads=2,
              orthogonal_reg_max_codes=4, **CASES[case])
    jc, pc = jcfg.VQConfig(**kw), pcfg.VQConfig(**kw)
    params, state = vq_init(jax.random.PRNGKey(1), jc)
    n = 40
    z = np.random.default_rng(0).standard_normal((n, 16)).astype(np.float32)
    mask = None if case == "ema-no-mask" else np.arange(n) < 33
    rng = jax.random.PRNGKey(7)

    def fn(p):
        r = vq_apply(p, state, jc, jnp.asarray(z), training=True, rng=rng,
                     mask=None if mask is None else jnp.asarray(mask))
        return r["loss"] + jnp.sum(r["quantize"] ** 2), r

    (jl, jr), jg = jax.value_and_grad(fn, has_aux=True)(params)
    hmask = None
    if mask is not None:
        hmask = mask if pc.separate_codebook_per_head else np.repeat(
            mask, pc.heads)
    draws = vq_draws(rng, jc, jr["distances"].shape, hmask)
    vq = _load(VectorQuantize(pc), _np(params), _np(state)).train()
    zt = torch.from_numpy(z).requires_grad_()
    res = vq(zt, mask=None if mask is None else torch.from_numpy(mask),
             **draws)
    loss = res["loss"] + (res["quantize"] ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    assert np.array_equal(res["indices"].numpy(), np.asarray(jr["indices"]))
    np.testing.assert_allclose(res["quantize"].detach().numpy(),
                               np.asarray(jr["quantize"]), **TOL)
    np.testing.assert_allclose(vq.embed.grad.numpy(),
                               np.asarray(jg["embed"]), **TOL)
    for k, v in jr["state"].items():
        np.testing.assert_allclose(getattr(vq, k).numpy().astype(np.float64),
                                   np.asarray(v, np.float64), err_msg=k,
                                   **TOL)
    if "dead" in case:
        # some codes fell below the threshold and were reset to it
        assert (vq.cluster_size.numpy() == jc.threshold_ema_dead_code).any()
    if pc.ema_update:
        before = vq.embed.detach().clone()
        adopt_ema_embed(vq)
        assert torch.equal(vq.embed.detach(), vq.embed_target)
        want = jax_adopt(params, jr["state"])["embed"]
        np.testing.assert_allclose(vq.embed.detach().numpy(),
                                   np.asarray(want), **TOL)
        assert not torch.equal(before, vq.embed.detach())


def test_frozen_codebook_keeps_its_state_and_eval_samples_nothing():
    """A frozen codebook (finetune) and eval move no buffer; eval takes the
    argmax whatever the sampling options, as in JAX."""
    kw = dict(dim=16, codebook_size=8, codebook_dim=16, heads=2,
              ema_update=True, threshold_ema_dead_code=2.0,
              stochastic_sample_codes=True)
    vq = VectorQuantize(pcfg.VQConfig(**kw))
    before = {k: v.clone() for k, v in vq.state_dict().items()}
    z = torch.randn(30, 16)
    vq.train()(z, freeze_codebook=True)
    vq.eval()
    res = vq(z, gumbel=torch.full((2, 30, 8), 50.0))
    assert torch.equal(res["indices"], res["distances"].argmax(-1).T)
    for k, v in vq.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_sync_codebook_names_the_multi_gpu_item():
    """``sync_codebook`` is read by no JAX code, and now by none of the
    port's either: the multi-GPU path (ROADMAP Queue 1 item 10) syncs
    through the ``reduce`` its step hands the VQ.  A VQ built with it trains
    as one without it, and a ``reduce`` that doubles every statistic doubles
    the EMA sums it sees."""
    z = torch.randn(6, 8)
    out = []
    for sync in (True, False):
        vq = VectorQuantize(pcfg.VQConfig(
            dim=8, codebook_size=4, codebook_dim=8, heads=1,
            sync_codebook=sync, ema_update=True, decay=0.0),
            generator=torch.Generator().manual_seed(0)).train()
        out.append((vq(z), vq.cluster_size.clone()))
    assert torch.equal(out[0][0]["indices"], out[1][0]["indices"])
    assert torch.equal(out[0][1], out[1][1])
    vq = VectorQuantize(pcfg.VQConfig(
        dim=8, codebook_size=4, codebook_dim=8, heads=1, ema_update=True,
        decay=0.0), generator=torch.Generator().manual_seed(0)).train()
    vq(z, reduce=lambda t: 2 * t)
    torch.testing.assert_close(vq.cluster_size, 2 * out[1][1])


@pytest.mark.parametrize("gumbel", [False, True])
def test_pretrain_step_with_ema_matches_jax(gumbel):
    """One full-graph pretrain step with ``ema_update`` and dead-code
    expiry (and, in one case, Gumbel sampling): the losses, the adopted
    codebook, the VQ state and every student parameter to 1e-5."""
    d, n = 32, 512
    vq_kw = dict(dim=d, codebook_size=32, codebook_dim=d, heads=2,
                 ema_update=True, threshold_ema_dead_code=2.0)
    if gumbel:
        vq_kw.update(stochastic_sample_codes=True,
                     straight_through_gumbel=True)
    cfg = jcfg.PretrainConfig(
        encoder=jcfg.EncoderConfig(input_dim=d, hidden_dim=d, num_layers=2,
                                   normalize="batch", dropout=0.0),
        vq=jcfg.VQConfig(**vq_kw), batch_size=0)
    pc = pcfg.from_dict(pcfg.PretrainConfig(), {
        "encoder": vars(cfg.encoder).copy(), "vq": vars(cfg.vq).copy(),
        "batch_size": 0})
    params, teacher, state = _np(jax_pre.pretrain_init(
        jax.random.PRNGKey(0), cfg))
    kw = dict(num_nodes=n, num_classes=5, feat_dim=d, avg_degree=8,
              num_splits=1, seed=3)
    g_j = jax_synthetic.synthetic_node_dataset(**kw).to_graph()
    tx = jax_optimizer(cfg.lr, cfg.weight_decay, grad_clip=cfg.grad_clip,
                       use_scheduler=cfg.use_scheduler, epochs=cfg.epochs,
                       steps_per_epoch=1)
    rng = jax.random.PRNGKey(5)
    p_j, _, _, s_j, m_j = jax_loop.make_pretrain_step(cfg, tx, bs=n)(
        params, teacher, tx.init(params), state, g_j, rng)
    draws = _jax_draws(cfg, g_j, rng)
    _, k_fwd = jax.random.split(rng, 3)[1:]
    k_vq = jax.random.split(k_fwd, 6)[1]
    vd = vq_draws(k_vq, cfg.vq, (2, n, 32), np.asarray(g_j.node_mask))
    draws.update(vq_gumbel=vd["gumbel"], vq_expire=vd["expire_idx"])

    model, teach = pretrain_from_jax(params, teacher, state, pc)
    g_p = pretrain_graph(port_synthetic.synthetic_node_dataset(**kw), pc,
                         device="cpu")
    got = make_pretrain_step(pc, bs=n)(
        model, teach, make_pretrain_optimizer(model, pc), g_p, draws)
    p_p, _, s_p = pretrain_to_jax(model, teach)
    for k, v in m_j.items():
        np.testing.assert_allclose(float(got[k]), float(v), err_msg=k, **TOL)
    lp, lj = _leaves(p_p), _leaves(_np(p_j))
    assert set(lp) == set(lj)
    for path, leaf in lj.items():
        noise = "lin_l" in path and "'b'" in path
        np.testing.assert_allclose(
            lp[path], leaf, err_msg=path,
            **(TOL if not noise else dict(rtol=0, atol=2.1 * cfg.lr)))
    # the codebook is the EMA target, not the optimizer's update
    np.testing.assert_allclose(p_p["vq"]["embed"],
                               np.asarray(s_j["vq"]["embed_target"]), **TOL)
    for k, v in _leaves(_np(s_j["vq"])).items():
        np.testing.assert_allclose(_leaves(s_p["vq"])[k].astype(np.float64),
                                   np.asarray(v, np.float64), err_msg=k,
                                   **TOL)


def test_vq_state_round_trips_both_directions(tmp_path):
    """JAX's ``(params, state)`` trees with the EMA and affine buffers
    become the port's module and back unchanged; the port's save /
    restore keeps them."""
    from stemgnn_tpu_torch.utils import checkpoint as ckpt
    kw = dict(dim=16, codebook_size=8, codebook_dim=8, heads=2,
              use_cosine_sim=False, affine_param=True, ema_update=True)
    params, state = vq_init(jax.random.PRNGKey(3), jcfg.VQConfig(**kw))
    rng = np.random.default_rng(0)
    state = {k: (np.asarray(v) + rng.normal(0, 1, np.shape(v))).astype(
        np.asarray(v).dtype) if np.asarray(v).dtype.kind == "f"
        else np.asarray(v) for k, v in state.items()}
    state["affine_initted"] = np.asarray(True)
    vq = _load(VectorQuantize(pcfg.VQConfig(**kw)), _np(params), state)
    from stemgnn_tpu_torch.nn.encoder import Encoder
    enc = Encoder(pcfg.EncoderConfig(input_dim=16, hidden_dim=16))
    p_back, s_back = to_jax_pytree(enc, vq)
    assert sorted(s_back["vq"]) == sorted(state)
    for k, v in state.items():
        assert np.array_equal(s_back["vq"][k], v), k
    path = str(tmp_path / "vq.npz")
    ckpt.save_pytree(path, {"params": p_back["vq"], "state": s_back["vq"]})
    back = ckpt.load_pytree(path)
    vq2 = _load(VectorQuantize(pcfg.VQConfig(**kw)), back["params"],
                back["state"])
    for k, v in vq.state_dict().items():
        assert torch.equal(vq2.state_dict()[k], v), k
    # a finetune without ema_update drops the unused EMA target
    from stemgnn_tpu_torch.utils.convert import from_jax_pytree
    cfg = dataclasses.replace(
        pcfg.FinetuneConfig(), encoder=enc.cfg,
        vq=pcfg.VQConfig(**dict(kw, ema_update=False)))
    _, vq3 = from_jax_pytree(
        {"encoder": p_back["encoder"], "vq": back["params"]},
        {"encoder": s_back["encoder"], "vq": back["state"]}, cfg)
    assert not hasattr(vq3, "embed_target")
    assert torch.equal(vq3.batch_var, vq.batch_var)


def test_gumbel_noise_and_sample_indices_draw_from_the_generator():
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    a = cb.gumbel_noise((3, 5), g1)
    assert torch.equal(a, cb.gumbel_noise((3, 5), g2))
    assert torch.isfinite(a).all()
    mask = torch.arange(10) < 4
    idx = cb.sample_indices(2, 10, 50, mask, torch.Generator().manual_seed(1))
    assert idx.shape == (2, 50) and int(idx.max()) < 4


def test_run_pretrain_checkpoints_carry_the_ema_state(tmp_path):
    """``run_pretrain`` with the EMA codebook and dead-code expiry writes
    the VQ state into ``vq_<epoch>.npz`` and ``full_<epoch>.npz``: the EMA
    codebook is adopted (``embed`` equals ``embed_target``), JAX's
    ``load_pretrained_for_finetune`` reads the state, and a restored bundle
    gives back every VQ buffer."""
    from stemgnn_tpu.train.pretrain_loop import \
        load_pretrained_for_finetune
    from stemgnn_tpu_torch.data.merge import merge_datasets
    from stemgnn_tpu_torch.models.pretrain import PretrainModel, make_teacher
    from stemgnn_tpu_torch.train import pretrain_loop as port_loop
    d = 16
    cfg = pcfg.PretrainConfig(
        encoder=pcfg.EncoderConfig(input_dim=d, hidden_dim=d, num_layers=2,
                                   normalize="batch", dropout=0.0),
        vq=pcfg.VQConfig(dim=d, codebook_size=16, codebook_dim=d, heads=2,
                         ema_update=True, threshold_ema_dead_code=2.0),
        batch_size=64, fanout=5, epochs=2)
    merged = merge_datasets([port_synthetic.synthetic_node_dataset(
        num_nodes=300, num_classes=4, feat_dim=d, avg_degree=6,
        num_splits=1, seed=3)])
    model, teacher, hist = port_loop.run_pretrain(
        merged, cfg, weights=[1.0], device="cpu", save_root=str(tmp_path),
        verbose=False)
    assert len(hist) == 2
    vq = model.vq
    assert torch.equal(vq.embed.detach(), vq.embed_target)
    pre = load_pretrained_for_finetune(str(tmp_path / "encoder_2.npz"),
                                       str(tmp_path / "vq_2.npz"))
    for k, v in vq.named_buffers():
        assert np.array_equal(np.asarray(pre["vq_state"][k]), v.numpy()), k
    np.testing.assert_array_equal(np.asarray(pre["vq_params"]["embed"]),
                                  vq.embed.detach().numpy())
    m2 = PretrainModel(cfg)
    t2 = make_teacher(m2)
    bundle, epoch = port_loop.load_resume_bundle(str(tmp_path))
    assert epoch == 2
    port_loop.restore_bundle(bundle, m2, t2,
                             port_loop.make_pretrain_optimizer(m2, cfg),
                             torch.Generator())
    for k, v in vq.state_dict().items():
        assert torch.equal(m2.vq.state_dict()[k], v), k
