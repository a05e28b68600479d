"""The port's kernel module (stemgnn_tpu_torch/ops/scatter.py) and the fused
aggregation around it (ops/fused_sage.py) against the JAX package on the
CPU.

On CPU tensors the kernel wrapper runs its plain PyTorch version, so these
tests hold that version, and the hub/tail decomposition around it, against
the JAX Pallas kernel in interpret mode.  The CUDA kernel itself is held
against the same plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemgnn_tpu.ops import chip_profile as jax_profile
from stemgnn_tpu.ops.edge_layout import build_edge_layout as jax_layout
from stemgnn_tpu.ops.fused_sage import fused_sage_aggregate as jax_fused
from stemgnn_tpu.ops.scatter_pallas import scatter_rows_sorted as jax_scatter
from stemgnn_tpu.ops.spmm import gather_scatter_aggregate as jax_gather_scatter
from stemgnn_tpu_torch.ops import scatter as port_scatter
from stemgnn_tpu_torch.ops.chip_profile import V5E
from stemgnn_tpu_torch.ops.edge_layout import build_edge_layout
from stemgnn_tpu_torch.ops.fused_sage import fused_sage_aggregate
from stemgnn_tpu_torch.ops.spmm import gather_scatter_aggregate

# bf16 messages summed exactly on both sides, in another order
TOL_BF16_FAST = dict(rtol=1e-5, atol=1e-5)
# f32 messages: the TPU kernel's hi/lo bf16 split carries ~16 mantissa bits
TOL_F32_HILO = dict(rtol=2e-5, atol=2e-5)
# bf16 outputs: one bf16 ulp
TOL_BF16_OUT = dict(rtol=2.0 ** -7, atol=1e-6)


def _layouts(s, r, n_pad, **kw):
    """The same layout from both packages (v5e gate profile on both)."""
    jax_profile.set_profile(jax_profile._V5E)
    try:
        lj = jax_layout(s, r, n_pad, gwin="off", **kw)
    finally:
        jax_profile.set_profile(None)
    return lj, build_edge_layout(s, r, n_pad, profile=V5E, gwin="off", **kw)


def _messages(rng, lay, d, dtype):
    """Layout-order messages, zero on padded slots (as callers build them)."""
    e_pad = lay.num_edges_padded
    m = rng.standard_normal((e_pad, d)).astype(np.float32)
    m[~np.asarray(lay.mask_r)] = 0
    return m.astype(np.float32) if dtype == "f32" else np.array(
        jnp.asarray(m).astype(jnp.bfloat16).astype(jnp.float32))


def _uniform_problem(rng, n=200, e=700, n_pad=512):
    """Two node blocks of edges sharing one 512-edge chunk (a boundary chunk
    shared by two blocks), two trailing empty blocks, padded edge slots."""
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    return _layouts(s, r, n_pad)


def _run_both(lj, lp, m, n_pad, d, *, relu, init, scale, gate, fast,
              out_bf16, rng):
    opt = {}
    if init:
        opt["init"] = rng.standard_normal((n_pad, d)).astype(np.float32)
    if scale:
        opt["scale"] = (rng.random((n_pad, 1)) + 0.5).astype(np.float32)
    if gate:
        opt["gate"] = rng.standard_normal((n_pad, d)).astype(np.float32)
    mdt_j = jnp.bfloat16 if fast else jnp.float32
    mdt_t = torch.bfloat16 if fast else torch.float32
    out_j = jnp.bfloat16 if out_bf16 else jnp.float32
    out_t = torch.bfloat16 if out_bf16 else torch.float32
    want = jax_scatter(jnp.asarray(m).astype(mdt_j), lj.lrow_r,
                       lj.block_ptr_r, num_nodes_padded=n_pad,
                       interpret=True, fast=fast, relu=relu, out_dtype=out_j,
                       **{k: jnp.asarray(v) for k, v in opt.items()})
    got = port_scatter.scatter_rows_sorted(
        torch.from_numpy(m).to(mdt_t), lp.lrow_r, lp.block_ptr_r,
        num_nodes_padded=n_pad, relu=relu, out_dtype=out_t,
        **{k: torch.from_numpy(v) for k, v in opt.items()})
    assert got.dtype == out_t
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_scatter_ref_matches_pallas_bf16_every_epilogue(relu, init, scale,
                                                        gate):
    rng = np.random.default_rng(1)
    lj, lp = _uniform_problem(rng)
    m = _messages(rng, lp, 32, "bf16")
    got, want = _run_both(lj, lp, m, 512, 32, relu=relu, init=init,
                          scale=scale, gate=gate, fast=True, out_bf16=False,
                          rng=rng)
    np.testing.assert_allclose(got, want, **TOL_BF16_FAST)


@pytest.mark.parametrize("relu,init,scale,gate", [
    (False, False, False, False), (True, True, True, False),
    (True, False, True, True), (False, True, False, True)])
def test_scatter_ref_matches_pallas_f32_hilo(relu, init, scale, gate):
    rng = np.random.default_rng(2)
    lj, lp = _uniform_problem(rng)
    m = _messages(rng, lp, 32, "f32")
    got, want = _run_both(lj, lp, m, 512, 32, relu=relu, init=init,
                          scale=scale, gate=gate, fast=False, out_bf16=False,
                          rng=rng)
    np.testing.assert_allclose(got, want, **TOL_F32_HILO)


@pytest.mark.parametrize("relu,init,scale,gate", [
    (False, False, False, False), (True, True, True, True)])
def test_scatter_ref_matches_pallas_bf16_out(relu, init, scale, gate):
    rng = np.random.default_rng(3)
    lj, lp = _uniform_problem(rng)
    m = _messages(rng, lp, 32, "bf16")
    got, want = _run_both(lj, lp, m, 512, 32, relu=relu, init=init,
                          scale=scale, gate=gate, fast=True, out_bf16=True,
                          rng=rng)
    np.testing.assert_allclose(got, want, **TOL_BF16_OUT)


def test_scatter_ref_matches_pallas_stress_layout():
    """A 2000-edge hub receiver (many chunks for one block), a run of
    one-edge nodes (one chunk spanning many blocks), a mid-size hub, fully
    empty node blocks and heavy trailing node padding."""
    rng = np.random.default_rng(4)
    r = np.concatenate([np.zeros(2000, np.int32),
                        np.arange(600, dtype=np.int32),
                        np.full(300, 1400, np.int32)])
    s = rng.permutation(r).astype(np.int32)
    lj, lp = _layouts(s, r, 2048)
    m = _messages(rng, lp, 8, "bf16")
    got, want = _run_both(lj, lp, m, 2048, 8, relu=True, init=True,
                          scale=False, gate=False, fast=True, out_bf16=False,
                          rng=rng)
    np.testing.assert_allclose(got, want, **TOL_BF16_FAST)


def test_scatter_ref_sums_each_edge_into_its_receiver():
    """The plain version against a direct numpy scatter of original-order
    messages (sentinel slots and out-of-range positions contribute 0)."""
    rng = np.random.default_rng(5)
    s = rng.integers(0, 300, 900)
    r = rng.integers(0, 300, 900)
    lay = build_edge_layout(s, r, 384, profile=V5E)
    m_orig = rng.standard_normal((900, 16)).astype(np.float32)
    m = m_orig[np.minimum(lay.perm_r2o.numpy(), 899)]
    m[~lay.mask_r.numpy()] = 1e6          # padded slots must not leak
    got = port_scatter.scatter_rows_sorted_ref(
        torch.from_numpy(m), lay.lrow_r, lay.block_ptr_r,
        num_nodes_padded=384)
    want = np.zeros((384, 16), np.float32)
    np.add.at(want, r, m_orig)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_scatter_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    rng = np.random.default_rng(6)
    lay = build_edge_layout(rng.integers(0, 100, 300),
                            rng.integers(0, 100, 300), 128, profile=V5E)
    m = torch.randn(lay.num_edges_padded, 8)
    before = dict(port_scatter.launch_counts)
    a = port_scatter.scatter_rows_sorted(m, lay.lrow_r, lay.block_ptr_r,
                                         num_nodes_padded=128, relu=True)
    b = port_scatter.scatter_rows_sorted_ref(m, lay.lrow_r, lay.block_ptr_r,
                                             num_nodes_padded=128, relu=True)
    assert torch.equal(a, b)
    assert port_scatter.launch_counts == before


@pytest.mark.parametrize("bad", ["lrow_dtype", "block_ptr_len", "scale_shape",
                                 "node_block"])
def test_scatter_wrapper_rejects_bad_inputs(bad):
    rng = np.random.default_rng(7)
    lay = build_edge_layout(rng.integers(0, 100, 300),
                            rng.integers(0, 100, 300), 128, profile=V5E)
    args = dict(m=torch.randn(lay.num_edges_padded, 8),
                local_row=lay.lrow_r, block_ptr=lay.block_ptr_r)
    kw = dict(num_nodes_padded=128)
    if bad == "lrow_dtype":
        args["local_row"] = lay.lrow_r.long()
    elif bad == "block_ptr_len":
        args["block_ptr"] = lay.block_ptr_r[:-1]
    elif bad == "scale_shape":
        kw["scale"] = torch.ones(128)
    else:
        kw["node_block"] = 256
    with pytest.raises(ValueError):
        port_scatter.scatter_rows_sorted(**args, **kw)


def _graph(rng, n, e, n_pad, d, power_law=True):
    if power_law:   # skewed senders so the top ones are worth a hub block
        w = 1.0 / np.arange(1, n + 1) ** 1.2
        s = rng.choice(n, e, p=w / w.sum()).astype(np.int32)
    else:
        s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    x = np.zeros((n_pad, d), np.float32)
    x[:n] = rng.standard_normal((n, d)).astype(np.float32)
    return s, r, x


@pytest.mark.parametrize("with_t0", [False, True])
@pytest.mark.parametrize("hubs", ["none", "gather", "gather+scatter"])
def test_fused_sage_forward_matches_jax(hubs, with_t0):
    """Hub split (gather-side, + scatter-side) and the plain no-hub forward,
    bf16 messages, against JAX fused_sage_aggregate in interpret mode."""
    rng = np.random.default_rng(8)
    n, e, n_pad, d = 300, 1500, 384, 32
    s, r, x = _graph(rng, n, e, n_pad, d)
    kw = {} if hubs == "none" else dict(
        hub_size=128, hub_min_coverage=-1.0,
        sc_hub_size=128 if hubs == "gather+scatter" else 0)
    lj, lp = _layouts(s, r, n_pad, **kw)
    assert (lp.hub_r is None) == (hubs == "none")
    if hubs == "gather+scatter":
        assert lp.hub_r.sc_cnt is not None
    table = (rng.standard_normal((1, d)).astype(np.float32) if with_t0
             else None)
    want = jax_fused(jnp.asarray(x), lj,
                     None if table is None else jnp.asarray(table),
                     reduce="mean", relu=True, bf16_messages=True,
                     interpret=True)
    got = fused_sage_aggregate(
        torch.from_numpy(x), lp,
        None if table is None else torch.from_numpy(table),
        reduce="mean", relu=True, bf16_messages=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_fused_sage_f32_messages_match_jax():
    """f32 messages take the plain forward even when the layout has hubs."""
    rng = np.random.default_rng(9)
    n, e, n_pad, d = 300, 1500, 384, 32
    s, r, x = _graph(rng, n, e, n_pad, d)
    lj, lp = _layouts(s, r, n_pad, hub_size=128, hub_min_coverage=-1.0)
    table = rng.standard_normal((1, d)).astype(np.float32)
    want = jax_fused(jnp.asarray(x), lj, jnp.asarray(table), reduce="sum",
                     relu=True, bf16_messages=False, interpret=True)
    got = fused_sage_aggregate(torch.from_numpy(x), lp,
                               torch.from_numpy(table), reduce="sum",
                               bf16_messages=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_fused_sage_rejects_typed_tables():
    """What the typed aggregation does not take: a typed table on a layout
    without per-edge type ids, a table of another width, a runtime edge
    mask that is not one keep per edge, the pair-hash dropout (JAX asserts
    the factored branch) and (not ported) relu=False messages."""
    rng = np.random.default_rng(10)
    s, r, x = _graph(rng, 100, 300, 128, 8, power_law=False)
    x = torch.from_numpy(x)
    untyped = build_edge_layout(s, r, 128, profile=V5E)
    with pytest.raises(ValueError):
        fused_sage_aggregate(x, untyped, torch.randn(3, 8))
    lay = build_edge_layout(s, r, 128, xe_ids=rng.integers(0, 3, 300),
                            profile=V5E)
    with pytest.raises(ValueError):
        fused_sage_aggregate(x, lay, torch.randn(3, 4))
    with pytest.raises(ValueError):
        fused_sage_aggregate(x, lay, torch.randn(3, 8),
                             edge_keep=torch.ones(300, 2))
    for kw in (dict(relu=False), dict(drop_hash=(0, 0.1))):
        with pytest.raises(NotImplementedError):
            fused_sage_aggregate(x, lay, torch.randn(3, 8), **kw)


@pytest.mark.parametrize("reduce", ["mean", "sum"])
def test_gather_scatter_aggregate_matches_jax(reduce):
    rng = np.random.default_rng(11)
    s, r, x = _graph(rng, 100, 400, 104, 16, power_law=False)
    ef = rng.standard_normal((400, 16)).astype(np.float32)
    mask = rng.random(400) < 0.9
    want = jax_gather_scatter(jnp.asarray(x), jnp.asarray(s), jnp.asarray(r),
                              edge_feat=jnp.asarray(ef),
                              edge_mask=jnp.asarray(mask), reduce=reduce)
    got = gather_scatter_aggregate(
        torch.from_numpy(x), torch.from_numpy(s).long(),
        torch.from_numpy(r).long(), edge_feat=torch.from_numpy(ef),
        edge_mask=torch.from_numpy(mask), reduce=reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
