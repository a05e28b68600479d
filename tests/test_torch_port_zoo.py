"""The port's OFA model zoo (``stemgnn_tpu_torch/zoo``) and the segment
ops it needs against the JAX package on the CPU: the multi-head segment
softmax and max (RGAT's [E, H] logits), JAX's handling of out-of-range
segment ids (dropped from reductions, clamped in gathers: the dead graph
slot of a padded batch), RGCN and RGAT with 3 relations and masked edges,
the GNN stack of every conv in every JK mode with the virtual node on a
padded two-graph batch (forward, BatchNorm statistics, gradients), the
MLP whose BatchNorm sees the padded rows, pooling in every mode and the
attention readout on a padded batch, the three predictors, the three
losses, the activation resolver, and each converter's round trip.

JAX's initial weights are carried across (``utils/convert.py``).
Tolerances: forwards within 1e-5 relative (f32), running statistics
within 1e-6, gradients within 1e-4 of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemgnn_tpu.ops import segment as jseg
from stemgnn_tpu.zoo import convs_rel as jrel
from stemgnn_tpu.zoo import losses as jloss
from stemgnn_tpu.zoo import mlp as jmlp
from stemgnn_tpu.zoo import pooling as jpool
from stemgnn_tpu.zoo import predictors as jpred
from stemgnn_tpu.zoo import stack as jstack
from stemgnn_tpu.zoo.resolver import resolve_activation as jresolve
from stemgnn_tpu_torch.ops import segment as pseg
from stemgnn_tpu_torch.utils import convert
from stemgnn_tpu_torch.zoo import losses as ploss
from stemgnn_tpu_torch.zoo.convs_rel import RGATEdgeConv, RGCNEdgeConv
from stemgnn_tpu_torch.zoo.pooling import global_pool
from stemgnn_tpu_torch.zoo.resolver import resolve_activation as presolve

D, T = 16, 3
SIZES = (10, 13)                  # two graphs, padded to 32 nodes
N_PAD, E_PAD = 32, 96


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rel=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def check_grads(module, jax_grads):
    """Every parameter's gradient within 1e-4 of the largest of JAX's."""
    want = {k: np.asarray(v)
            for k, v in convert._flat_names(_np(jax_grads)).items()}
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
           .numpy() for n, p in module.named_parameters()}
    assert set(got) == set(want), set(got) ^ set(want)
    top = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 * top,
                                   err_msg=k)


def check_state(module, jax_state):
    """Buffers (BatchNorm statistics) within 1e-6 of JAX's new state."""
    want = convert._flat_names(_np(jax_state))
    bufs = dict(module.named_buffers())
    assert set(bufs) == set(want), set(bufs) ^ set(want)
    for k, v in want.items():
        np.testing.assert_allclose(bufs[k].numpy(), v, rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def padded_batch(seed=0):
    """Two graphs of 10 and 13 nodes padded to 32 nodes and 96 edges:
    padded nodes carry the dead graph id 2, padded edges point at node 0
    with the mask off (the layout of ``batch_graphs``); edges of 3
    relation types, a few real edges masked too."""
    rng = np.random.default_rng(seed)
    s, r = [], []
    off = 0
    for n in SIZES:
        s.append(rng.integers(0, n, 38) + off)
        r.append(rng.integers(0, n, 38) + off)
        off += n
    s, r = np.concatenate(s), np.concatenate(r)
    e = len(s)
    snd = np.zeros(E_PAD, np.int64)
    rcv = np.zeros(E_PAD, np.int64)
    snd[:e], rcv[:e] = s, r
    em = np.arange(E_PAD) < e
    em[[3, 40, 41]] = False
    nm = np.arange(N_PAD) < off
    gid = np.full(N_PAD, len(SIZES), np.int64)
    gid[:off] = np.repeat(np.arange(len(SIZES)), SIZES)
    x = rng.standard_normal((N_PAD, D)).astype(np.float32)
    x[~nm] = 0.0
    xe = rng.standard_normal((E_PAD, D)).astype(np.float32)
    xe[~em] = 0.0
    et = rng.integers(0, T, E_PAD).astype(np.int64)
    return dict(x=x, xe=xe, s=snd, r=rcv, em=em, nm=nm, gid=gid, et=et)


def jx(b, *keys):
    return [jnp.asarray(b[k].astype(np.int32) if b[k].dtype == np.int64
                        else b[k]) for k in keys]


def pt(b, *keys):
    return [_t(b[k]) for k in keys]


# ------------------------------------------------------------ segment ops

@pytest.mark.parametrize("heads", [None, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_over_trailing_dims_matches_jax(heads, masked):
    """RGAT's [E, H] logits (one softmax a head) and the GAT backbone's
    [E]; segments with no entry and fully masked ones."""
    rng = np.random.default_rng(1)
    e, n = 80, 30
    shape = (e,) if heads is None else (e, heads)
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    ids = rng.integers(0, n - 5, e)
    mask = rng.random(e) > 0.3 if masked else None
    want = jseg.segment_softmax(jnp.asarray(logits),
                                jnp.asarray(ids.astype(np.int32)), n,
                                mask=None if mask is None
                                else jnp.asarray(mask))
    got = pseg.segment_softmax(_t(logits), _t(ids), n,
                               mask=None if mask is None else _t(mask))
    close(got, want)
    wmax = jseg.segment_max(jnp.asarray(logits),
                            jnp.asarray(ids.astype(np.int32)), n,
                            mask=None if mask is None else jnp.asarray(mask))
    close(pseg.segment_max(_t(logits), _t(ids), n,
                           mask=None if mask is None else _t(mask)), wmax)


@pytest.mark.parametrize("fn", ["segment_sum", "segment_mean", "segment_max",
                                "segment_softmax"])
@pytest.mark.parametrize("masked", [False, True])
def test_out_of_range_segment_ids_follow_jax(fn, masked):
    """Ids past the last segment (a padded batch's dead graph slot) and
    below 0: JAX's segment ops drop them and its gathers clamp them;
    ``drop_oob=True`` does the same where ``index_add_`` would raise."""
    rng = np.random.default_rng(2)
    e, n = 60, 5
    data = rng.standard_normal((e, 3)).astype(np.float32)
    ids = rng.integers(0, n, e)
    ids[-12:] = n                          # the dead slot
    ids[:2] = n + 3
    mask = rng.random(e) > 0.2 if masked else None
    if fn == "segment_softmax":
        data = data[:, 0]
    want = getattr(jseg, fn)(jnp.asarray(data),
                             jnp.asarray(ids.astype(np.int32)), n,
                             mask=None if mask is None else jnp.asarray(mask))
    got = getattr(pseg, fn)(_t(data), _t(ids), n,
                            mask=None if mask is None else _t(mask),
                            drop_oob=True)
    close(got, want)
    with pytest.raises((IndexError, RuntimeError)):
        getattr(pseg, fn)(_t(data), _t(ids), n)


def test_take_clamped_is_jax_gather_forward_and_backward():
    """JAX's ``table[ids]`` with ids past the end (the virtual node's
    ``vn[node_graph_id]`` on padded nodes) reads the last row, and its
    backward drops those reads: the gradient is not that of the clamped
    gather."""
    rng = np.random.default_rng(3)
    table = rng.standard_normal((3, 4)).astype(np.float32)
    ids = np.array([0, 2, 1, 3, 3, 5, 2])
    w = rng.standard_normal((len(ids), 4)).astype(np.float32)
    want, grad = jax.value_and_grad(
        lambda t: jnp.sum(t[jnp.asarray(ids)] * w))(jnp.asarray(table))
    t = _t(table).requires_grad_()
    rows = pseg.take_clamped(t, _t(ids))
    np.testing.assert_array_equal(rows.detach().numpy(),
                                  np.asarray(jnp.asarray(table)[ids]))
    (rows * _t(w)).sum().backward()
    close(t.grad, grad)
    assert not np.allclose(grad[2], (w[[1, 3, 4, 5, 6]]).sum(0))


# ------------------------------------------------------------ convs

@pytest.mark.parametrize("kind", ["rgcn", "rgat"])
def test_relational_conv_matches_jax(kind):
    """3 relations, masked edges: forward and every parameter's
    gradient."""
    b = padded_batch()
    key = jax.random.PRNGKey(3)
    if kind == "rgcn":
        params = jrel.rgcn_edge_init(key, D, D, T)
        japply, cls = jrel.rgcn_edge_apply, RGCNEdgeConv
    else:
        params = jrel.rgat_edge_init(key, D, D, T, heads=4)
        japply, cls = jrel.rgat_edge_apply, RGATEdgeConv
    w = np.random.default_rng(4).standard_normal((N_PAD, D)).astype(
        np.float32)
    x, xe, s, r, et, em = jx(b, "x", "xe", "s", "r", "et", "em")

    def f(p):
        out = japply(p, x, xe, s, r, et, edge_mask=em)
        return jnp.sum(out * w), out
    (_, want), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(params)
    conv = cls(D, D, T, **({"heads": 4} if kind == "rgat" else {}))
    convert._load(conv, _np(params), {})
    px, pxe, ps, pr, pet, pem = pt(b, "x", "xe", "s", "r", "et", "em")
    out = conv(px, pxe, ps, pr, pet, edge_mask=pem)
    close(out, want)
    (out * _t(w)).sum().backward()
    check_grads(conv, grads)


# ------------------------------------------------------------ the stack

def _stack_case(kind, jk, virtual):
    b = padded_batch()
    params, state = jstack.gnn_stack_init(
        jax.random.PRNGKey(5), kind, 2, D, num_relations=T, heads=4,
        virtual_node=virtual)
    x, xe, s, r, et, em, nm, gid = jx(b, "x", "xe", "s", "r", "et", "em",
                                      "nm", "gid")
    rng = np.random.default_rng(6)
    ws = [rng.standard_normal((N_PAD, D)).astype(np.float32)
          for _ in range(2)]

    def f(p):
        out, ns = jstack.gnn_stack_apply(
            p, state, kind, x, xe, s, r, edge_type=et, edge_mask=em,
            node_mask=nm, node_graph_id=gid, n_graphs=len(SIZES), JK=jk,
            training=True)
        outs = out if jk == "list" else [out]
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws)), (outs, ns)
    (_, (want, new_state)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(params)
    stack = convert.gnn_stack_from_jax(_np(params), _np(state)).train()
    px, pxe, ps, pr, pet, pem, pnm, pgid = pt(b, "x", "xe", "s", "r", "et",
                                              "em", "nm", "gid")
    out = stack(px, pxe, ps, pr, edge_type=pet, edge_mask=pem,
                node_mask=pnm, node_graph_id=pgid, n_graphs=len(SIZES),
                JK=jk)
    outs = out if jk == "list" else [out]
    assert len(outs) == len(want)
    for o, w in zip(outs, want):
        close(o, w)
    sum((o * _t(w)).sum() for o, w in zip(outs, ws)).backward()
    check_grads(stack, grads)
    check_state(stack, new_state)
    return stack, params, state


@pytest.mark.parametrize("kind", ["gine", "rgcn", "rgat"])
@pytest.mark.parametrize("jk", ["last", "sum", "mean", "list"])
def test_gnn_stack_matches_jax_on_a_padded_batch(kind, jk):
    """Every conv in every JK mode with the virtual node on the padded
    two-graph batch (dead slot 2), in training: the outputs, the
    BatchNorm statistics (the virtual node's MLP keeps its own, as JAX
    drops them) and the gradients."""
    _stack_case(kind, jk, virtual=True)


@pytest.mark.parametrize("kind", ["gine", "rgat"])
def test_gnn_stack_evaluation_and_no_virtual_node(kind):
    """Without the virtual node, after a training call: evaluation reads
    the running statistics, as JAX's ``training=False``."""
    stack, params, state = _stack_case(kind, "last", virtual=False)
    b = padded_batch(seed=9)
    x, xe, s, r, em, nm = jx(b, "x", "xe", "s", "r", "em", "nm")
    new_state = {"norms": [{k: jnp.asarray(v.numpy()) for k, v in
                            (("mean", n.mean), ("var", n.var),
                             ("count", n.count))} for n in stack.norms]}
    want, _ = jstack.gnn_stack_apply(params, new_state, kind, x, xe, s, r,
                                     edge_mask=em, node_mask=nm,
                                     training=False)
    px, pxe, ps, pr, pem, pnm = pt(b, "x", "xe", "s", "r", "em", "nm")
    with torch.no_grad():
        close(stack.eval()(px, pxe, ps, pr, edge_mask=pem, node_mask=pnm),
              want)


def test_mlp_batchnorm_takes_padded_rows_like_jax():
    """``zoo/mlp.py``'s BatchNorm has no mask: the zero rows of padding
    enter its batch statistics, in JAX and here."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N_PAD, D)).astype(np.float32)
    x[20:] = 0.0
    params, state = jmlp.mlp_init(jax.random.PRNGKey(8), [D, 2 * D, 3])
    w = rng.standard_normal((N_PAD, 3)).astype(np.float32)

    def f(p):
        y, ns = jmlp.mlp_apply(p, state, jnp.asarray(x), training=True)
        return jnp.sum(y * w), (y, ns)
    (_, (want, ns)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(params)
    mlp = convert.mlp_from_jax(_np(params), _np(state)).train()
    y = mlp(_t(x))
    close(y, want)
    (y * _t(w)).sum().backward()
    check_grads(mlp, grads)
    check_state(mlp, ns)
    masked_mean = x[:20] @ np.asarray(params["layers"][0]["w"])
    assert not np.allclose(mlp.norms[0].mean.numpy(),
                           0.1 * (masked_mean.mean(0)
                                  + np.asarray(params["layers"][0]["b"])))


# ------------------------------------------------------------ pooling

@pytest.mark.parametrize("mode", ["mean", "sum", "add", "max"])
@pytest.mark.parametrize("masked", [False, True])
def test_global_pool_drops_the_dead_slot_like_jax(mode, masked):
    b = padded_batch()
    z = np.random.default_rng(10).standard_normal((N_PAD, D)).astype(
        np.float32)
    want = jpool.global_pool(jnp.asarray(z), *jx(b, "gid"), len(SIZES),
                             mode=mode,
                             node_mask=jx(b, "nm")[0] if masked else None)
    got = global_pool(_t(z), *pt(b, "gid"), len(SIZES), mode=mode,
                      node_mask=pt(b, "nm")[0] if masked else None)
    close(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_pool_matches_jax_on_a_padded_batch(masked):
    b = padded_batch()
    z = np.random.default_rng(11).standard_normal((N_PAD, D)).astype(
        np.float32)
    params = jpool.attention_pool_init(jax.random.PRNGKey(12), D)
    w = np.random.default_rng(13).standard_normal((2, D)).astype(np.float32)
    nm = jx(b, "nm")[0] if masked else None

    def f(p):
        out = jpool.attention_pool_apply(p, jnp.asarray(z), *jx(b, "gid"),
                                         len(SIZES), node_mask=nm)
        return jnp.sum(out * w), out
    (_, want), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(params)
    pool = convert.attention_pool_from_jax(_np(params))
    out = pool(_t(z), *pt(b, "gid"), len(SIZES),
               node_mask=pt(b, "nm")[0] if masked else None)
    close(out, want)
    (out * _t(w)).sum().backward()
    check_grads(pool, grads)


# ------------------------------------------------------------ predictors

@pytest.mark.parametrize("task", ["graph", "link", "node"])
def test_predictors_match_jax(task):
    """The graph (pooled, with the virtual node), link (endpoint product)
    and node predictors, in training: outputs, statistics, gradients."""
    b = padded_batch()
    kind = "rgcn"
    params, state = jpred.graph_predictor_init(
        jax.random.PRNGKey(14), kind, 2, D, 3, num_relations=T,
        virtual_node=task == "graph")
    x, xe, s, r, et, em, nm, gid = jx(b, "x", "xe", "s", "r", "et", "em",
                                      "nm", "gid")
    q_src, q_dst = np.array([0, 4, 11, 20]), np.array([3, 9, 15, 22])
    rows = {"graph": 2, "link": 4, "node": N_PAD}[task]
    w = np.random.default_rng(15).standard_normal((rows, 3)).astype(
        np.float32)

    def f(p):
        if task == "graph":
            out, ns = jpred.graph_predictor_apply(
                p, state, kind, x, xe, s, r, gid, len(SIZES), edge_type=et,
                edge_mask=em, node_mask=nm, training=True)
        elif task == "link":
            out, ns = jpred.link_predictor_apply(
                p, state, kind, x, xe, s, r, jnp.asarray(q_src),
                jnp.asarray(q_dst), edge_type=et, edge_mask=em,
                training=True)
        else:
            out, ns = jpred.node_predictor_apply(
                p, state, kind, x, xe, s, r, edge_type=et, edge_mask=em,
                node_mask=nm, training=True)
        return jnp.sum(out * w), (out, ns)
    (_, (want, ns)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(params)
    model = convert.predictor_from_jax(_np(params), _np(state)).train()
    px, pxe, ps, pr, pet, pem, pnm, pgid = pt(b, "x", "xe", "s", "r", "et",
                                              "em", "nm", "gid")
    if task == "graph":
        out = model.graph(px, pxe, ps, pr, pgid, len(SIZES), edge_type=pet,
                          edge_mask=pem, node_mask=pnm)
    elif task == "link":
        out = model.link(px, pxe, ps, pr, _t(q_src), _t(q_dst),
                         edge_type=pet, edge_mask=pem)
    else:
        out = model.node(px, pxe, ps, pr, edge_type=pet, edge_mask=pem,
                         node_mask=pnm)
    close(out, want)
    (out * _t(w)).sum().backward()
    check_grads(model, grads)
    check_state(model, ns)


# ------------------------------------------------------------ losses

def test_losses_match_jax():
    rng = np.random.default_rng(16)
    mi = rng.standard_normal((8, 8)).astype(np.float32)
    h1 = rng.standard_normal((32, 8)).astype(np.float32)
    h2 = h1 + rng.standard_normal((32, 8)).astype(np.float32)
    scores = rng.standard_normal((6, 5)).astype(np.float32)
    scores[0, 1] = scores[0, 3]                        # a tie
    tgt = np.array([1, 0, 4, 2, 2, 3])
    close(ploss.info_nce_loss(_t(mi)), jloss.info_nce_loss(jnp.asarray(mi)))
    close(ploss.cca_loss(_t(h1), _t(h2)),
          jloss.cca_loss(jnp.asarray(h1), jnp.asarray(h2)))
    close(ploss.cca_loss(_t(h1), _t(h2), lam=0.5),
          jloss.cca_loss(jnp.asarray(h1), jnp.asarray(h2), lam=0.5))
    close(ploss.mrr(_t(scores), _t(tgt)),
          jloss.mrr(jnp.asarray(scores), jnp.asarray(tgt)))
    # gradients of the two differentiable losses
    for pf, jf, args in ((ploss.info_nce_loss, jloss.info_nce_loss, (mi,)),
                         (ploss.cca_loss, jloss.cca_loss, (h1, h2))):
        want = jax.grad(lambda *a: jf(*a), argnums=tuple(
            range(len(args))))(*map(jnp.asarray, args))
        ts = [_t(a).requires_grad_() for a in args]
        pf(*ts).backward()
        for t, w in zip(ts, want):
            close(t.grad, w, rel=1e-4)


@pytest.mark.parametrize("name", ["relu", "leaky_relu", "leakyrelu", "elu",
                                  "gelu", "sigmoid", "tanh", "silu", "swish",
                                  "identity", "none"])
def test_resolver_matches_jax(name):
    x = np.linspace(-3, 3, 25).astype(np.float32)
    close(presolve(name)(_t(x)), jresolve(name)(jnp.asarray(x)))
    with pytest.raises(ValueError):
        presolve("nope")


# ------------------------------------------------------------ converters

def _leaves(tree):
    return {k: np.asarray(v)
            for k, v in convert._flat_names(_np(tree)).items()}


@pytest.mark.parametrize("kind", ["gine", "rgcn", "rgat"])
def test_stack_and_head_round_trip(kind):
    """JAX trees -> port modules -> JAX trees: every leaf equal, for the
    stack (virtual node, BatchNorm state) and the bin-graph head (attention
    pooling and RWPE)."""
    from stemgnn_tpu.ofa import heads as jheads
    params, state = jstack.gnn_stack_init(jax.random.PRNGKey(17), kind, 2,
                                          D, num_relations=T, heads=4,
                                          virtual_node=True)
    state = jax.tree_util.tree_map(lambda a: a + 1, state)
    p2, s2 = convert.gnn_stack_to_jax(
        convert.gnn_stack_from_jax(_np(params), _np(state)))
    for got, want in ((p2, params), (s2, state)):
        g, w = _leaves(got), _leaves(want)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    hp, hs = jheads.bin_graph_init(jax.random.PRNGKey(18), kind, 2, D, D,
                                   att_pool=True, walk_length=8)
    p2, s2 = convert.bin_graph_to_jax(
        convert.bin_graph_from_jax(_np(hp), _np(hs)))
    for got, want in ((p2, hp), (s2, hs)):
        g, w = _leaves(got), _leaves(want)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_every_other_converter_round_trips():
    """The MLP, the attention readout, the predictor and
    ``ofa_train_eval``'s ``{"enc", "head"}`` model: JAX trees -> port ->
    JAX trees (``_module_trees``, what the stack's and head's reverse
    converters return), every leaf equal."""
    key = jax.random.PRNGKey(19)
    mp, ms = jmlp.mlp_init(key, [D, 2 * D, 3])
    pp, ps = jpred.graph_predictor_init(key, "rgat", 2, D, 3,
                                        num_relations=T, virtual_node=True)
    ep, es = jstack.gnn_stack_init(key, "gine", 2, D)
    hp, _ = jmlp.mlp_init(key, [D, 2 * D, 1], batch_norm=False)
    cases = [(convert.mlp_from_jax(_np(mp), _np(ms)), mp, ms),
             (convert.attention_pool_from_jax(_np(
                 jpool.attention_pool_init(key, D))),
              jpool.attention_pool_init(key, D), {}),
             (convert.predictor_from_jax(_np(pp), _np(ps)), pp, ps),
             (convert.ofa_model_from_jax(_np({"enc": ep, "head": hp}),
                                         _np({"enc": es})),
              {"enc": ep, "head": hp}, {"enc": es})]
    for module, params, state in cases:
        p2, s2 = convert._module_trees(module)
        for got, want in ((p2, params), (s2, state)):
            g, w = _leaves(got), _leaves(want)
            assert set(g) == set(w), set(g) ^ set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
