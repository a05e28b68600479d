"""The port's mixed precision against the JAX package on the CPU: BatchNorm
on bf16 activations, the layout-free aggregation with bf16 messages (and
JAX's bf16 degree count), the fused aggregation's forward and VJP with a
bf16 ``x``, the encoder at ``compute_dtype="bfloat16"``, the VQ's bf16
per-head pipeline, ``pretrain_forward`` under ``teacher_bf16`` +
``loss_bf16`` and the whole mixed-precision step, the bf16 feature tables
of the minibatch pretrain, and the pretrain CLI's configs and runs under
``--bf16`` and ``--mixed_precision``.  The finetune half (the ``--bf16``
finetune steps, the graph task's ``eval_bf16`` and the finetune CLI) is in
``test_torch_port_mixed_finetune.py``, which shares this file's helpers.

Tolerances.  A bf16 value holds 8 significant bits: one ulp is at most
2^-7 of it.  Where both packages round the same f32 values once, they
agree to one ulp (``_ulp_close``: the f32 sums in another order may land on
either side of a rounding), plus 1e-5 where a sum cancels.  Where a bf16
route runs several rounded layers, outputs are held at the bf16-message
route tolerance of the other port tests (3e-2) and losses at the JAX
package's own mixed-precision gate (tests/test_end_to_end.py:188-190:
2% of a loss, or of 0.1 for a small one).  JAX's XLA scatter-add of bf16
data adds one update at a time in bf16; the port sums in f32 and rounds
once, so a sum of more than a few rounded terms differs by a few ulps
(stated where it applies).
"""

import copy
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stemgnn_tpu.core import config as jcfg
from stemgnn_tpu.data import synthetic as jax_synthetic
from stemgnn_tpu.data.merge import merge_datasets as jax_merge
from stemgnn_tpu.models import pretrain as jax_pre
from stemgnn_tpu.nn.encoder import encoder_apply, encoder_init
from stemgnn_tpu.nn.layers import batchnorm_apply
from stemgnn_tpu.ops import chip_profile as jax_profile
from stemgnn_tpu.ops.edge_layout import build_edge_layout as jax_layout
from stemgnn_tpu.ops.fused_sage import fused_sage_aggregate as jax_fused
from stemgnn_tpu.ops.spmm import gather_scatter_aggregate as jax_gather
from stemgnn_tpu.train import augment as jax_augment
from stemgnn_tpu.train import pretrain_loop as jax_loop
from stemgnn_tpu.train.optim import make_optimizer as jax_optimizer
from stemgnn_tpu.utils import jax_cache
from stemgnn_tpu.vq.quantize import vq_apply, vq_init
from stemgnn_tpu_torch import pretrain as port_pretrain_cli
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.data.merge import merge_datasets as port_merge
from stemgnn_tpu_torch.models.pretrain import pretrain_forward
from stemgnn_tpu_torch.nn.encoder import Encoder
from stemgnn_tpu_torch.nn.layers import BatchNorm
from stemgnn_tpu_torch.ops import fused_sage as port_fused_mod
from stemgnn_tpu_torch.ops.chip_profile import V5E
from stemgnn_tpu_torch.ops.edge_layout import build_edge_layout
from stemgnn_tpu_torch.ops.fused_sage import fused_sage_aggregate
from stemgnn_tpu_torch.ops.spmm import gather_scatter_aggregate
from stemgnn_tpu_torch.train import pretrain_loop as port_loop
from stemgnn_tpu_torch.train.graph_setup import fused_full_graph
from stemgnn_tpu_torch.utils.convert import (from_jax_pytree,
                                             pretrain_from_jax,
                                             pretrain_to_jax)
from stemgnn_tpu_torch.vq.quantize import VectorQuantize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 32
# the z / loss tolerances of a bf16 route (module docstring)
ROUTE_TOL = dict(rtol=3e-2, atol=3e-2)


def _f32(a):
    """numpy f32 of a bf16 or f32 torch tensor or JAX array."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16(a):
    """f32 numpy values rounded to bf16 (as f32 numpy)."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _ulp_close(got, want, ulps=1, floor=1e-5, tag=""):
    """|got - want| within ``ulps`` bf16 ulps of the larger magnitude, plus
    ``floor`` for sums that cancel."""
    got, want = _f32(got), _f32(want)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    bad = np.abs(got - want) > ulps * ulp + floor
    assert not bad.any(), (tag, int(bad.sum()), float(
        np.abs(got - want).max()))


def _loss_close(got, want, tag=""):
    """The JAX package's mixed-precision gate: 2% of the loss, or of 0.1
    for a small one."""
    assert abs(got - want) <= 0.02 * max(abs(want), 0.1), (tag, got, want)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_batchnorm_bf16_matches_jax(training):
    """bf16 activations: statistics and normalization in f32, the output
    rounded once to bf16 (one ulp of JAX's), the running buffers f32 (1e-5)
    and the input gradient bf16 (one ulp, the f32 sums' order aside)."""
    rng = np.random.default_rng(8)
    n, d = 200, 16
    x = _bf16(rng.standard_normal((n, d)) * 2 + 0.5)
    x[150:] = 1e3                                  # padded rows: ignored
    mask = np.arange(n) < 150
    params = {"scale": rng.standard_normal(d).astype(np.float32),
              "bias": rng.standard_normal(d).astype(np.float32)}
    state = {"mean": rng.standard_normal(d).astype(np.float32),
             "var": rng.random(d).astype(np.float32) + 0.5,
             "count": np.int32(3)}
    w = _bf16(rng.standard_normal((n, d)))

    def loss_j(xj):
        y, ns = batchnorm_apply(params, state, xj, training=training,
                                mask=jnp.asarray(mask))
        return jnp.sum(y.astype(jnp.float32) * w), (y, ns)
    (_, (y_j, ns_j)), gx_j = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.asarray(x, jnp.bfloat16))

    bn = BatchNorm(d)
    bn.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in {**params, **state}.items()})
    bn.train(training)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    y_p = bn(xt, mask=torch.from_numpy(mask))
    (y_p.float() * torch.from_numpy(w)).sum().backward()
    assert y_j.dtype == jnp.bfloat16 and y_p.dtype == torch.bfloat16
    assert xt.grad.dtype == torch.bfloat16
    assert all(getattr(bn, k).dtype == torch.float32 for k in ("mean",
                                                                "var"))
    _ulp_close(y_p, y_j, tag="y")
    _ulp_close(xt.grad, gx_j, tag="dx")
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(ns_j[k]), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------- the layout-free route

def _hub_receiver_graph(rng, deg0=300):
    """Receiver 0 takes ``deg0`` in-edges from nodes 300..599, whose
    features are 0 or 1 (so every partial sum at receiver 0 is an integer
    below 256, exact in bf16 in any order); receivers 1..299 take 1 to 8
    in-edges from nodes 1..299, whose features lie on a grid of 1/8 in
    [-2, 2] (every partial sum of up to 8 exact in bf16)."""
    n, d = 600, 8
    x = np.zeros((n, d), np.float32)
    x[1:300] = rng.integers(-16, 17, (299, d)) / 8.0
    x[300:] = rng.integers(0, 2, (300, d)) * (rng.random((300, d)) < 0.5)
    s0 = np.arange(300, 300 + deg0)
    r0 = np.zeros(deg0, np.int64)
    degs = rng.integers(1, 9, 299)
    r1 = np.repeat(np.arange(1, 300), degs)
    s1 = rng.integers(1, 300, r1.size)
    s = np.concatenate([s0, s1]).astype(np.int64)
    r = np.concatenate([r0, r1]).astype(np.int64)
    perm = rng.permutation(s.size)
    return x, s[perm], r[perm]


def test_segment_route_bf16_matches_jax_with_its_degree_count():
    """bf16 messages through the gather + segment route against JAX's
    ``gather_scatter_aggregate`` on bf16 x.  The graph keeps every sum
    exact (``_hub_receiver_graph``), so the forward is bit-equal, and
    receiver 0's 300 in-edges show JAX's bf16 degree count: XLA adds the
    ones one at a time in bf16 and stops at 256, so the mean divides by
    256 (a count of 300 would give another value).  The input gradient:
    each sender's edge gradients (w / count, rounded to bf16) summed in f32
    and rounded once: bit-equal to the exact sum of those bf16 terms
    rounded once; JAX adds them one at a time in bf16, within 2^-6 of
    their absolute sum (measured 2^-7.3)."""
    rng = np.random.default_rng(3)
    x, s, r = _hub_receiver_graph(rng)
    n = x.shape[0]
    w = rng.integers(-8, 9, (n, x.shape[1])) / 8.0

    def loss_j(xj):
        out = jax_gather(xj, jnp.asarray(s), jnp.asarray(r), num_nodes=n,
                         reduce="mean", relu=True)
        return jnp.sum(out.astype(jnp.float32) * w), out
    (_, out_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.asarray(x, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    out_p = gather_scatter_aggregate(xt, torch.from_numpy(s),
                                     torch.from_numpy(r), num_nodes=n)
    (out_p.float() * torch.from_numpy(w).float()).sum().backward()
    assert out_p.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(out_p), _f32(out_j))
    total0 = np.maximum(x[300:], 0).sum(0)
    np.testing.assert_array_equal(_f32(out_p)[0], _bf16(total0 / 256.0))
    assert not np.array_equal(_bf16(total0 / 300.0), _bf16(total0 / 256.0))
    # dx: the edge gradients bf16(w / count) through the relu, per sender
    deg = np.bincount(r, minlength=n).astype(np.float64)
    cnt = np.maximum(np.minimum(deg, 256), 1)[r][:, None]
    ge = _bf16(w[r] / cnt) * (x[s] > 0)
    exact, scale = np.zeros(x.shape), np.zeros(x.shape)
    np.add.at(exact, s, ge)
    np.add.at(scale, s, np.abs(ge))
    np.testing.assert_array_equal(_f32(xt.grad), _bf16(exact))
    assert (np.abs(_f32(xt.grad) - _f32(g_j)) <= 2 ** -6 * scale).all()


# ------------------------------------------------ the fused aggregation

def _skew(rng, n=600, e=4000):
    def one():
        hot = rng.integers(0, 8, e // 2)
        cold = rng.integers(0, n, e - e // 2)
        return rng.permutation(np.concatenate([hot, cold])).astype(np.int32)
    return one(), one()


def _layouts(s, r, n_pad, gwin, **kw):
    jax_profile.set_profile(jax_profile._V5E)
    try:
        lj = jax_layout(s, r, n_pad, gwin=gwin, edge_chunk=128, **kw)
    finally:
        jax_profile.set_profile(None)
    lp = build_edge_layout(s, r, n_pad, gwin=gwin, edge_chunk=128,
                           profile=V5E, **kw)
    return lj, lp


FUSED_CASES = {
    # (hubs, gwin, table rows, drop_hash)
    "whole_gwin_on": ("none", "on", 1, False),
    "whole_gwin_off": ("none", "off", 1, False),
    "hub_gwin_on": ("hub", "on", 1, False),
    "hub_gwin_off": ("hub", "off", 0, False),
    "sc_hub_gwin_on": ("sc_hub", "on", 1, False),
    "sc_hub_gwin_off": ("sc_hub", "off", 1, False),
    "drop_hub": ("hub", "on", 1, True),
    "drop_sc_hub": ("sc_hub", "on", 0, True),
    "typed_whole_gwin_on": ("none", "on", 5, False),
    "typed_whole_gwin_off": ("none", "off", 5, False),
    "typed_hubs_gwin_on": ("typed", "on", 5, False),
    "typed_hubs_gwin_off": ("typed", "off", 5, False),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_bf16_x_matches_jax_interpret(case):
    """Forward and d/dx of sum(out * w) with a bf16 ``x`` against JAX's
    ``fused_sage_aggregate(..., interpret=True)``: the bf16 output (the hub
    partials stored in bf16, ``hub_bf16_acc``), the cotangent g / deg
    rounded to bf16, the relu gate of bf16 x (+ t0), the bf16 ``dx``; on
    the factored branch with and without hubs and the in-kernel gather,
    under the pair-hash dropout's ``DropView`` masks, and on the typed
    branch (kernel 2's ``xe`` mode forward, kernel 3's backward) with and
    without typed hubs.  Both sides round the same f32 sums once: one bf16
    ulp (plus 1e-5 where a sum cancels)."""
    hubs, gwin, t_rows, drop = FUSED_CASES[case]
    rng = np.random.default_rng(7)
    n, e, n_pad, d = 600, 4000, 640, 32
    s, r = _skew(rng, n, e)
    kw = dict(feat_dim_hint=d)
    if t_rows > 1:
        kw.update(xe_ids=rng.integers(0, t_rows, e).astype(np.int32),
                  num_edge_types=t_rows)
        if hubs == "typed":
            kw.update(hub_size=16, hub_min_coverage=-1.0)
    elif hubs != "none":
        kw.update(hub_size=8, hub_min_coverage=-1.0,
                  sc_hub_size=8 if hubs == "sc_hub" else 0)
    lj, lp = _layouts(s, r, n_pad, gwin, **kw)
    assert (lp.hub_r is not None) == (hubs != "none")
    if hubs == "typed":
        assert lp.hub_r.hub_xe is not None
    x = np.zeros((n_pad, d), np.float32)
    x[:n] = _bf16(rng.standard_normal((n, d)))
    w = _bf16(rng.standard_normal((n_pad, d)))
    table = (None if t_rows == 0 else
             rng.standard_normal((t_rows, d)).astype(np.float32))
    drop_hash = (2 ** 31 - 5, 0.3) if drop else None

    def loss_j(xj):
        out = jax_fused(xj, lj, None if table is None else jnp.asarray(table),
                        reduce="mean", relu=True, bf16_messages=True,
                        interpret=True, drop_hash=drop_hash)
        return jnp.sum(out.astype(jnp.float32) * w), out
    (_, out_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.asarray(x, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    out_p = fused_sage_aggregate(
        xt, lp, None if table is None else torch.from_numpy(table),
        drop_hash=drop_hash)
    (out_p.float() * torch.from_numpy(w)).sum().backward()
    assert out_j.dtype == jnp.bfloat16 and g_j.dtype == jnp.bfloat16
    assert out_p.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16
    _ulp_close(out_p, out_j, tag=f"{case} out")
    _ulp_close(xt.grad, g_j, tag=f"{case} dx")


# --------------------------------------------------------------- encoder

def _graph(rng, n=300, e=2400):
    x = rng.standard_normal((n, D)).astype(np.float32)
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    return x, s, r


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_encoder_bf16_matches_jax(training):
    """``EncoderConfig(compute_dtype="bfloat16")`` (JAX
    tests/test_encoder.py:99): bf16 ``z`` within the bf16 route tolerance
    of JAX's on the layout-free route, the BatchNorm buffers f32 and equal
    to 1e-2 relative (statistics of bf16 activations), and the per-call
    override: an f32-config encoder run at ``compute_dtype="bfloat16"``
    gives the bf16 encoder's ``z`` bit for bit, and its parameters stay
    f32."""
    rng = np.random.default_rng(11)
    x, s, r = _graph(rng)
    cfg = jcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                             normalize="batch", dropout=0.0,
                             compute_dtype="bfloat16")
    params, state = encoder_init(jax.random.PRNGKey(0), cfg)
    z_j, st_j, _ = encoder_apply(params, state, cfg, jnp.asarray(x),
                                 jnp.asarray(s), jnp.asarray(r),
                                 training=training,
                                 rng=jax.random.PRNGKey(1))
    assert z_j.dtype == jnp.bfloat16
    pc = pcfg.EncoderConfig(**dataclasses.asdict(cfg))
    vq = jcfg.VQConfig(dim=D, codebook_size=8, codebook_dim=D, heads=2)
    vq_p, vq_s = vq_init(jax.random.PRNGKey(2), vq)
    enc, _ = from_jax_pytree(
        {"encoder": _np(params), "vq": _np(vq_p)},
        {"encoder": _np(state), "vq": _np(vq_s)},
        pcfg.FinetuneConfig(encoder=pc, vq=pcfg.VQConfig(
            **dataclasses.asdict(vq))))
    f32_enc = Encoder(dataclasses.replace(pc, compute_dtype="float32"))
    f32_enc.load_state_dict(enc.state_dict())
    args = (torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(r))
    outs = []
    for m, kw in ((enc, {}), (f32_enc, {"compute_dtype": "bfloat16"})):
        m.train(training)
        outs.append(m(*args, **kw))
    z_p = outs[0]
    assert z_p.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(z_p), _f32(z_j), **ROUTE_TOL)
    assert torch.equal(outs[0], outs[1])
    assert all(p.dtype == torch.float32 for p in enc.parameters())
    for i, bn in enumerate(enc.norms):
        assert bn.mean.dtype == torch.float32
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(bn, k).numpy(),
                                       np.asarray(st_j["norms"][i][k]),
                                       rtol=1e-2, atol=1e-2)


def test_encoder_bf16_refuses_other_backbones_with_jax_message():
    cfg = pcfg.EncoderConfig(input_dim=D, hidden_dim=D, backbone="gcn",
                             compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="supports the sage backbone"):
        Encoder(cfg)


# -------------------------------------------------------------------- VQ

VQ_CASES = {"bf16_pipeline": ("bfloat16", True),
            "f32_pipeline_bf16_z": ("float32", True),
            "bf16_pipeline_no_projection": ("bfloat16", False)}


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", list(VQ_CASES))
def test_vq_bf16_matches_jax(case, training):
    """The VQ on a bf16 ``z`` (JAX tests/test_vq.py:193): the bf16
    per-head pipeline, and the f32 pipeline fed a bf16 ``z`` as the
    finetune's ``--bf16`` feeds it (projections in bf16); with and without
    the projections; training with a learnable codebook and in eval.  Both
    sides score the same bf16 xh against the same bf16 codebook and sum in
    f32: the f32 scores to 1e-6 (measured 1.8e-7), so the codes equal
    JAX's on every row whose best two scores are more than 1e-5 apart (over
    95% of the rows), ``quantize`` (f32) and ``codes`` on those rows to one
    bf16 ulp, and the loss (commitment + orthogonal) to 1e-5 relative."""
    dtype, proj = VQ_CASES[case]
    cfg = jcfg.VQConfig(dim=D, codebook_size=16,
                        codebook_dim=D // 2 if proj else D,
                        heads=4 if proj else 1, commitment_weight=1.0,
                        compute_dtype=dtype, orthogonal_reg_max_codes=None)
    assert cfg.requires_projection == proj
    params, state = vq_init(jax.random.PRNGKey(0), cfg)
    z = _bf16(np.random.default_rng(0).standard_normal((300, D)))
    res_j = vq_apply(params, state, cfg, jnp.asarray(z, jnp.bfloat16),
                     training=training, rng=jax.random.PRNGKey(1))
    vq = VectorQuantize(pcfg.VQConfig(**dataclasses.asdict(cfg)))
    enc_p, enc_s = encoder_init(jax.random.PRNGKey(3), jcfg.EncoderConfig(
        input_dim=D, hidden_dim=D))
    _, vq = from_jax_pytree(
        {"encoder": _np(enc_p), "vq": _np(params)},
        {"encoder": _np(enc_s), "vq": _np(state)},
        pcfg.FinetuneConfig(encoder=pcfg.EncoderConfig(input_dim=D,
                                                       hidden_dim=D),
                            vq=pcfg.VQConfig(**dataclasses.asdict(cfg))))
    vq.train(training)
    res_p = vq(torch.from_numpy(z).to(torch.bfloat16))
    assert res_p["quantize"].dtype == torch.float32
    want_codes_dt = (torch.bfloat16 if dtype == "bfloat16"
                     else torch.float32)
    assert res_p["codes"].dtype == want_codes_dt
    assert str(res_j["codes"].dtype) == str(want_codes_dt).split(".")[1]
    assert res_p["distances"].dtype == torch.float32
    np.testing.assert_allclose(_f32(res_p["distances"]),
                               _f32(res_j["distances"]), rtol=0, atol=1e-6)
    dist = np.sort(_f32(res_j["distances"]), -1)
    gap = dist[..., -1] - dist[..., -2]                # [num_codebooks, N']
    clear = (gap.T.reshape(300, -1) > 1e-5).all(1)
    assert clear.mean() > 0.95
    ind_p, ind_j = res_p["indices"].numpy(), np.asarray(res_j["indices"])
    np.testing.assert_array_equal(ind_p[clear], ind_j[clear])
    assert ind_p.shape == ind_j.shape == (300, cfg.heads)
    for k in ("quantize", "codes"):
        _ulp_close(_f32(res_p[k])[clear], _f32(res_j[k])[clear], tag=k)
    np.testing.assert_allclose(float(res_p["loss"]), float(res_j["loss"]),
                               rtol=1e-5, atol=1e-7)
    if not training:
        assert float(res_p["loss"]) == 0.0


# ------------------------------------------------------- the pretrain step

N = 512


def _pre_dataset(pkg):
    return pkg.synthetic_node_dataset(num_nodes=N, num_classes=5,
                                      feat_dim=D, avg_degree=8,
                                      pref_attach=1.1, num_splits=1, seed=3)


def _mp_cfg(mixed=True):
    """The step test's configuration under ``--mixed_precision`` (JAX
    pretrain.py:154-173), or its f32 twin."""
    dt = "bfloat16" if mixed else "float32"
    return jcfg.PretrainConfig(
        encoder=jcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                                   normalize="batch", dropout=0.0,
                                   compute_dtype=dt),
        vq=jcfg.VQConfig(dim=D, codebook_size=64, codebook_dim=D, heads=4,
                         compute_dtype=dt),
        batch_size=0, teacher_bf16=mixed, loss_bf16=mixed)


def _port_pcfg(cfg, **kw):
    d = {k: v for k, v in dataclasses.asdict(cfg).items()
         if k not in ("encoder", "vq")}
    d.update(kw)
    return pcfg.PretrainConfig(
        encoder=pcfg.EncoderConfig(**dataclasses.asdict(cfg.encoder)),
        vq=pcfg.VQConfig(**dataclasses.asdict(cfg.vq)), **d)


def _jax_draws(cfg, g, rng):
    """The draws JAX's step makes from ``rng`` (the pretrain tests'
    helper)."""
    k_feat, k_edge, k_fwd = jax.random.split(rng, 3)
    _, k_vq, k_topo, k_neg, _, _ = jax.random.split(k_fwd, 6)
    num = max(int(g.num_edges_padded * cfg.topo_recon_ratio), 1)
    slots, _ = jax_pre._sample_edge_slots(
        k_topo, jnp.asarray(np.asarray(g.edge_mask)), num)
    neg = jax_pre._negative_edges(k_neg, num, int(g.n_node),
                                  g.num_nodes_padded)
    _, k_ortho, _ = jax.random.split(k_vq, 3)
    keep = jax.random.bernoulli(k_feat, 1.0 - cfg.feat_p, (D,))
    t = lambda a: torch.from_numpy(np.array(a)).long()  # noqa: E731
    return dict(
        feat_keep=torch.from_numpy(np.array(keep)),
        drop_seed=t(jax_augment.dropout_edge_seed(k_edge)),
        slots=t(slots), neg=(t(neg[0]), t(neg[1])),
        ortho_ids=t(jax.random.permutation(
            k_ortho, cfg.vq.codebook_size)[:cfg.vq.orthogonal_reg_max_codes]))


LOSS_KEYS = ("feat_recon_loss", "topo_recon_loss", "topo_sem_recon_loss",
             "sem_recon_loss", "commit_loss")


def _pretrain_models(cfg):
    params, teacher, state = (_np(t) for t in jax_pre.pretrain_init(
        jax.random.PRNGKey(0), cfg))
    noise = np.random.default_rng(1)
    teacher = jax.tree_util.tree_map(
        lambda a: (a + noise.normal(0.0, 0.1, a.shape)).astype(a.dtype),
        teacher)
    return params, teacher, state


def _jax_forward_grads(cfg, params, teacher, state, g_j, draws, k_fwd):
    """JAX's ``pretrain_forward`` on the augmented view the draws make
    (JAX's step, pretrain_loop.py:64-80): (total, losses, gradients)."""
    keep = jnp.asarray(draws["feat_keep"].numpy())
    aug_j = dataclasses.replace(
        g_j, node_feat=jnp.where(keep[None, :], g_j.node_feat, 0.0),
        edge_mask=jax_augment.dropout_edges_undirected_seeded(
            jnp.asarray(draws["drop_seed"].numpy()), g_j.senders,
            g_j.receivers, g_j.edge_mask, cfg.edge_p))

    def loss_j(p):
        loss, (aux, _) = jax_pre.pretrain_forward(
            p, teacher, state, cfg, aug_j, g_j, bs=N, rng=k_fwd,
            training=True)
        return loss, aux["losses"]
    (total, losses), grads = jax.value_and_grad(loss_j, has_aux=True)(
        params)
    return float(total), {k: float(v) for k, v in losses.items()}, \
        _leaves(_np(grads))


@pytest.mark.parametrize("flags", ["teacher_loss_bf16", "mixed_precision"])
def test_pretrain_forward_mixed_precision_matches_jax(flags):
    """``pretrain_forward`` with ``teacher_bf16`` + ``loss_bf16`` (f32
    encoder and VQ), and with the whole ``--mixed_precision`` config,
    against JAX's ``pretrain_forward`` on the same weights and draws (the
    layout-free route on both sides): each loss within the JAX package's 2%
    gate of JAX's under the same flags and of JAX's f32 forward; the loss's
    gradient reaches every student parameter as f32, within 2% of the
    largest gradient of JAX's f32 ones (measured 0.9%) and within 3% of
    JAX's under the same flags (measured 2.2%).  This graph has a receiver
    of 260 in-edges, where JAX's bf16 sums, added one term at a time, move
    its own gradients 2.2% of the largest from its f32 ones: the port's
    mixed-precision gradients sit closer to the f32 ones than JAX's."""
    mixed = flags == "mixed_precision"
    cfg = _mp_cfg(mixed)
    if not mixed:
        cfg = dataclasses.replace(cfg, teacher_bf16=True, loss_bf16=True)
    params, teacher, state = _pretrain_models(cfg)
    g_j = _pre_dataset(jax_synthetic).to_graph()
    rng = jax.random.PRNGKey(5)
    draws = _jax_draws(cfg, g_j, rng)
    k_fwd = jax.random.split(rng, 3)[2]
    want = _jax_forward_grads(cfg, params, teacher, state, g_j, draws,
                              k_fwd)
    ref = _jax_forward_grads(_mp_cfg(False), params, teacher, state, g_j,
                             draws, k_fwd)

    pc = _port_pcfg(cfg)
    model, teach = pretrain_from_jax(params, teacher, state, pc)
    g_p = port_loop.pretrain_graph(_pre_dataset(port_synthetic), pc,
                                   device="cpu")
    total_p, losses_p, _ = pretrain_forward(
        model, teach, pc, port_loop.augmented(pc, g_p, draws), g_p, bs=N,
        draws=draws, drop_seed=draws["drop_seed"])
    total_p.backward()
    assert want[1]["topo_sem_recon_loss"] > 0
    for total, losses in (want[:2], ref[:2]):
        for k in LOSS_KEYS:
            _loss_close(float(losses_p[k]), losses[k], k)
        _loss_close(float(total_p), total, "total")
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    lg = _leaves(pretrain_to_jax(_grads_as_model(model), teach)[0])
    for leaves, tol in ((ref[2], 2e-2), (want[2], 3e-2)):
        assert set(lg) == set(leaves)
        top = max(float(np.abs(v).max()) for v in leaves.values())
        for path, leaf in leaves.items():
            assert float(np.abs(lg[path] - leaf).max()) <= tol * top, path


def _grads_as_model(model):
    """A copy of ``model`` whose parameters hold its gradients (zeros
    where a frozen parameter has none)."""
    gm = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(gm.parameters(), model.parameters()):
            p.copy_(q.grad if q.grad is not None else torch.zeros_like(q))
    return gm


def test_mixed_precision_step_matches_jax_and_keeps_f32_masters():
    """One whole ``--mixed_precision`` step (``make_pretrain_step``: the
    forward, backward, clip, AdamW and the EMA) against JAX's
    ``make_pretrain_step`` + optax from the same weights and draws: the
    losses within the 2% gate; the gradients reach the f32 master
    parameters as f32 (the cast's VJP) and, clipped, each lies within 3%
    of the largest of JAX's clipped by optax on the same draws (measured
    2.1%); AdamW's moments are f32, every parameter and the teacher
    stay f32 and move, and each parameter lands within 2.1 * lr of JAX's
    (AdamW's first step moves it by about lr * sign(grad), and a sign may
    flip under bf16 rounding: this holds the step's size, the gradient
    check its direction)."""
    cfg = _mp_cfg()
    params, teacher, state = _pretrain_models(cfg)
    tx = jax_optimizer(cfg.lr, cfg.weight_decay, grad_clip=cfg.grad_clip,
                       use_scheduler=cfg.use_scheduler, epochs=cfg.epochs,
                       steps_per_epoch=1)
    g_j = _pre_dataset(jax_synthetic).to_graph()
    rng = jax.random.PRNGKey(5)
    p_j, t_j, _, _, m_j = jax_loop.make_pretrain_step(cfg, tx, bs=N)(
        params, teacher, tx.init(params), state, g_j, rng)
    draws = _jax_draws(cfg, g_j, rng)
    pc = _port_pcfg(cfg)
    model, teach = pretrain_from_jax(params, teacher, state, pc)
    g_p = port_loop.pretrain_graph(_pre_dataset(port_synthetic), pc,
                                   device="cpu")
    opt = port_loop.make_pretrain_optimizer(model, pc)
    before = [p.detach().clone() for p in model.parameters()]
    got = port_loop.make_pretrain_step(pc, bs=N)(model, teach, opt, g_p,
                                                 draws)
    for k in LOSS_KEYS:
        _loss_close(float(got[k]), float(m_j[k]), k)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    want = _jax_forward_grads(cfg, params, teacher, state, g_j, draws,
                              jax.random.split(rng, 3)[2])[2]
    want = _np(optax.clip_by_global_norm(cfg.grad_clip).update(
        want, optax.EmptyState())[0])
    lg = _leaves(pretrain_to_jax(_grads_as_model(model), teach)[0])
    assert set(lg) == set(want)
    top = max(float(np.abs(v).max()) for v in want.values())
    for path, leaf in want.items():
        assert float(np.abs(lg[path] - leaf).max()) <= 3e-2 * top, path
    assert all(p.dtype == torch.float32 for p in teach.parameters())
    tree = opt.state_tree()
    moments = tree["exp_avg"] + tree["exp_avg_sq"]
    assert len(moments) == 2 * len(before)
    assert all(v.dtype == np.float32 for v in moments)
    assert all(not torch.equal(a, b) for a, b in zip(before,
                                                     model.parameters()))
    p_p, t_p, _ = pretrain_to_jax(model, teach)
    for tree_p, tree_j in ((p_p, _np(p_j)), (t_p, _np(t_j))):
        lp, lj = _leaves(tree_p), _leaves(tree_j)
        for path, leaf in lj.items():
            np.testing.assert_allclose(lp[path], leaf, rtol=0,
                                       atol=2.1 * cfg.lr, err_msg=path)


def test_mixed_precision_layout_step_routes_through_the_kernels(monkeypatch):
    """The full-graph ``--mixed_precision`` step on a hub layout, counted
    on the CPU through the kernels' plain versions (a CUDA step launches
    the same): kernel 1 three times (the dropout tails, bf16 init and out)
    and kernel 2 twice (the bf16 teacher's tails, bf16 out); its losses
    within the bf16 route tolerance of the layout-free mixed-precision
    forward's on the same draws."""
    calls = {"gathered": [], "scatter": []}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name].append(k.get("out_dtype"))
            return fn(*a, **k)
        return wrapped
    for name, attr in (("gathered", "gathered_scatter_rows_sorted"),
                       ("scatter", "scatter_rows_sorted")):
        monkeypatch.setattr(port_fused_mod, attr,
                            counting(name, getattr(port_fused_mod, attr)))
    cfg = _mp_cfg()
    params, teacher, state = _pretrain_models(cfg)
    pc = _port_pcfg(cfg)
    ds = _pre_dataset(port_synthetic)
    g_l = fused_full_graph(ds, pcfg.FinetuneConfig(
        encoder=pc.encoder, hub_size=64, sc_hub_size=64), device="cpu",
        use_layout=True)
    g_p = port_loop.pretrain_graph(ds, pc, device="cpu")
    assert g_l.layout.hub_r is not None and g_p.layout is None
    draws = _jax_draws(cfg, g_p, jax.random.PRNGKey(5))
    out = {}
    for tag, g in (("layout", g_l), ("plain", g_p)):
        model, teach = pretrain_from_jax(params, teacher, state, pc)
        out[tag] = port_loop.make_pretrain_step(pc, bs=N)(
            model, teach, port_loop.make_pretrain_optimizer(model, pc), g,
            draws)
    assert calls == {"scatter": [torch.bfloat16] * 3,
                     "gathered": [torch.bfloat16] * 2}
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(out["layout"][k]),
                                   float(out["plain"][k]), err_msg=k,
                                   **ROUTE_TOL)


# ------------------------------------------------- the bf16 feature tables

def _mb_cfg(**kw):
    return jcfg.PretrainConfig(
        encoder=jcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                                   normalize="batch", dropout=0.0,
                                   compute_dtype="bfloat16"),
        vq=jcfg.VQConfig(dim=D, codebook_size=16, codebook_dim=D, heads=4,
                         compute_dtype="bfloat16"),
        batch_size=128, fanout=5, teacher_bf16=True, loss_bf16=True, **kw)


def _mb_dataset(pkg):
    return pkg.synthetic_node_dataset(num_nodes=400, num_classes=5,
                                      feat_dim=D, avg_degree=6,
                                      pref_attach=1.1, num_splits=1, seed=3)


@pytest.mark.parametrize("route", ["auto", "on"])
def test_run_pretrain_mixed_precision_matches_jax(route, monkeypatch):
    """``run_pretrain`` under ``--mixed_precision`` for 2 epochs x 3 steps
    against JAX's, from JAX's initial weights with JAX's draws: the
    resident tables are bf16 (JAX pretrain_loop.py:237-244), so the
    batches' features and the feature-reconstruction target are the
    bf16-rounded features; each epoch's mean losses within the JAX
    package's 2% gate, on the segment route (``auto``) and on the batches'
    own layouts (``on``: kernels 1 and 2's plain versions, bf16 out)."""
    cfg = _mb_cfg(epochs=2)
    pj, tj, _, hj = jax_loop.run_pretrain(jax_merge([_mb_dataset(
        jax_synthetic)]), cfg, weights=[1.0], verbose=False)
    key = jax.random.PRNGKey(cfg.seed)
    key, k_init = jax.random.split(key)
    params, teacher, state = (_np(t) for t in jax_pre.pretrain_init(
        k_init, cfg))
    pc = _port_pcfg(cfg, fused_minibatch=route)
    assert port_loop.table_dtype(pc) == torch.bfloat16
    model, teach = pretrain_from_jax(params, teacher, state, pc)
    keys, feats = {"key": key}, []

    def draw_fn(g):
        feats.append(g.node_feat)
        assert (g.layout is not None) == (route == "on")
        keys["key"], k = jax.random.split(keys["key"])
        return _jax_draws(cfg, g, k)
    model, teach, hp = port_loop.run_pretrain(
        port_merge([_mb_dataset(port_synthetic)]), pc, weights=[1.0],
        device="cpu", model=model, teacher=teach, draw_fn=draw_fn,
        verbose=False)
    assert len(feats) == 6
    assert all(f.dtype == torch.bfloat16 for f in feats)
    assert len(hj) == len(hp) == 2
    for ej, ep in zip(hj, hp):
        for k in ("loss",) + LOSS_KEYS:
            _loss_close(ep[k], ej[k], k)


# ------------------------------------------------------------------ CLIs

class _Stop(Exception):
    pass


def _load_jax_cli(name):
    spec = importlib.util.spec_from_file_location(
        f"repo_{name}", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_config(got, want):
    """The port's config dict equals JAX's on every field the port has
    (nested), and the port has no field JAX lacks."""
    for k, v in got.items():
        assert k in want, k
        if isinstance(v, dict):
            _same_config(v, want[k])
        else:
            assert v == want[k], (k, v, want[k])


def _jax_config(monkeypatch, cli, argv, runner):
    """The config the repo's ``<cli>.py`` builds from ``argv``, caught at
    its ``runner`` call."""
    monkeypatch.setattr(jax_cache, "enable_persistent_cache",
                        lambda *a, **k: None)
    mod = _load_jax_cli(cli)
    seen = {}

    def stop(payload, cfg, *a, **k):
        seen["cfg"] = cfg
        raise _Stop
    monkeypatch.setattr(mod, runner, stop)
    monkeypatch.setattr(sys, "argv", [f"{cli}.py", *argv])
    with pytest.raises(_Stop):
        mod.main()
    return dataclasses.asdict(seen["cfg"])


def _remove_run(root):
    """A pretrain run's directory, then ``ckpts/pretrain_model`` and
    ``ckpts`` where left empty."""
    shutil.rmtree(root, ignore_errors=True)
    for parent in (os.path.dirname(root),
                   os.path.dirname(os.path.dirname(root))):
        try:
            os.rmdir(parent)
        except OSError:
            break


SMALL = ["--feat_dim", "16", "--hidden_dim", "16", "--code_dim", "16",
         "--codebook_size", "8"]


@pytest.mark.parametrize("flags", [["--bf16"], ["--mixed_precision"],
                                   ["--mp"], ["--bf16", "--mp"]],
                         ids=["bf16", "mixed_precision", "mp", "bf16_mp"])
def test_pretrain_cli_mixed_precision_config_equals_jax(flags, monkeypatch):
    """``pretrain.py --bf16`` (encoder bf16) and ``--mixed_precision`` /
    ``--mp`` (encoder and VQ bf16, ``teacher_bf16``, ``loss_bf16``; JAX
    pretrain.py:154-173): the port's namespace and config equal JAX's."""
    run_id = f"test_mixed_{uuid.uuid4().hex[:8]}"
    argv = ["--pretrain_dataset", "cora_synthetic", *SMALL,
            "--pretrain_run_id", run_id, *flags]
    try:
        want = _jax_config(monkeypatch, "pretrain", argv, "run_pretrain")
    finally:
        _remove_run(os.path.join(ROOT, "ckpts", "pretrain_model", run_id))
    args = port_pretrain_cli.parse(argv)
    assert not port_pretrain_cli.refusals(args)
    got = dataclasses.asdict(port_pretrain_cli.make_config(args))
    _same_config(got, want)
    mp = "--bf16" not in flags or len(flags) > 1
    assert got["encoder"]["compute_dtype"] == "bfloat16"
    assert got["vq"]["compute_dtype"] == ("bfloat16" if mp else "float32")
    assert got["teacher_bf16"] == got["loss_bf16"] == mp


def test_pretrain_cli_mixed_precision_runs_on_the_cpu():
    """``python -m stemgnn_tpu_torch.pretrain --mixed_precision --device
    cpu``: two steps, finite losses, the checkpoints and ``config.json``
    with the bf16 compute dtypes and flags; the saved parameters are f32."""
    run_id = f"test_mixed_{uuid.uuid4().hex[:8]}"
    root = os.path.join(ROOT, "ckpts", "pretrain_model", run_id)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "stemgnn_tpu_torch.pretrain",
             "--pretrain_dataset", "cora_synthetic", *SMALL,
             "--pretrain_run_id", run_id, "--epochs", "1", "--max_steps",
             "2", "--mixed_precision", "--device", "cpu"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert "[pretrain] epoch 1/1" in proc.stdout
        assert "nan" not in proc.stdout.split("[pretrain] epoch 1/1")[1]
        with open(os.path.join(root, "config.json")) as f:
            saved = json.load(f)
        assert saved["encoder"]["compute_dtype"] == "bfloat16"
        assert saved["vq"]["compute_dtype"] == "bfloat16"
        assert saved["pretrain"]["teacher_bf16"] is True
        assert saved["pretrain"]["loss_bf16"] is True
        enc = np.load(os.path.join(root, "encoder_1.npz"))
        assert all(enc[k].dtype in (np.float32, np.int32)
                   for k in enc.files)
    finally:
        _remove_run(root)
