"""The port's ``gathered_scatter_rows_sorted`` (stemgnn_tpu_torch/ops/
scatter.py) against the JAX Pallas kernel in interpret mode, on the CPU.

On CPU tensors the wrapper runs its plain PyTorch version, so these tests
hold that version against the TPU kernel, on layouts that JAX's
``build_edge_layout(gwin="on")`` gives (the TPU kernel needs its gather
windows; the port's layout has the same edge order without them).  The
CUDA kernel itself is held against the same plain version on the card by
``chip_smoke.py``.

Both sides build the message in f32 from bf16 rows, apply relu, round it to
bf16 and sum in f32 (the TPU kernel through one-hot matrix products with f32
accumulation, exact for 0/1 weights), so they differ only in the order of
the f32 sums: rtol/atol 1e-5 for f32 outputs, one bf16 ulp for bf16
outputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemgnn_tpu.ops import chip_profile as jax_profile
from stemgnn_tpu.ops.edge_layout import build_edge_layout as jax_layout
from stemgnn_tpu.ops.scatter_pallas import \
    gathered_scatter_rows_sorted as jax_gathered
from stemgnn_tpu_torch.ops import scatter as sc
from stemgnn_tpu_torch.ops.chip_profile import V5E
from stemgnn_tpu_torch.ops.edge_layout import build_edge_layout

TOL_F32 = dict(rtol=1e-5, atol=1e-5)
TOL_BF16_OUT = dict(rtol=2.0 ** -7, atol=1e-6)


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _locality(rng, n=600, e=2400, reach=40):
    s = rng.integers(0, n, e).astype(np.int32)
    r = np.clip(s + rng.integers(-reach, reach + 1, e), 0, n - 1)
    return s, r.astype(np.int32)


def _layouts(s, r, n_pad, **kw):
    jax_profile.set_profile(jax_profile._V5E)
    try:
        lj = jax_layout(s, r, n_pad, gwin="on", edge_chunk=128, **kw)
    finally:
        jax_profile.set_profile(None)
    lp = build_edge_layout(s, r, n_pad, gwin="on", edge_chunk=128,
                           profile=V5E, **kw)
    assert np.array_equal(np.asarray(lj.senders_r), lp.senders_r.numpy())
    return lj, lp


def _run_both(lj, lp, x, table, xe_ids, *, order="r", relu, init=None,
              scale=None, gate=None, out_bf16=False):
    keys_j = lj.senders_r if order == "r" else lj.receivers_s
    keys_p = lp.senders_r if order == "r" else lp.receivers_s
    lrow = "lrow_r" if order == "r" else "lrow_s"
    bp = "block_ptr_r" if order == "r" else "block_ptr_s"
    glo = lj.gwin_lo_r if order == "r" else lj.gwin_lo_s
    gns = lj.gwin_nsub_r if order == "r" else lj.gwin_nsub_s
    n_pad, d = x.shape
    opt = dict(init=init, scale=scale, gate=gate)
    want = jax_gathered(
        keys_j[None, :], getattr(lj, lrow), getattr(lj, bp), glo, gns,
        jnp.asarray(x).astype(jnp.bfloat16),
        table=None if table is None else jnp.asarray(table).astype(
            jnp.bfloat16),
        xe=None if xe_ids is None else getattr(lj, "xe_" + order)[None, :],
        num_nodes_padded=n_pad, win_w=lj.gwin_w, edge_chunk=lj.edge_chunk,
        relu=relu, out_dtype=jnp.bfloat16 if out_bf16 else jnp.float32,
        interpret=True,
        **{k: jnp.asarray(v) for k, v in opt.items() if v is not None})
    got = sc.gathered_scatter_rows_sorted(
        keys_p[None, :], getattr(lp, lrow), getattr(lp, bp),
        torch.from_numpy(x).to(torch.bfloat16),
        None if table is None else torch.from_numpy(table).to(torch.bfloat16),
        None if xe_ids is None else getattr(lp, "xe_" + order)[None, :],
        num_nodes_padded=n_pad, relu=relu,
        out_dtype=torch.bfloat16 if out_bf16 else torch.float32,
        **{k: None if v is None else torch.from_numpy(v)
           for k, v in opt.items()})
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("table", ["none", "t0", "xe5"])
def test_gathered_ref_matches_pallas(table, relu):
    """relu on/off with no table, a broadcast t0 row and a 5-row table
    through the xe stream."""
    rng = np.random.default_rng(1)
    n_pad, d = 640, 64
    s, r = _locality(rng)
    xe = rng.integers(0, 5, len(s)).astype(np.int32) if table == "xe5" \
        else None
    lj, lp = _layouts(s, r, n_pad, xe_ids=xe)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    tab = {"none": None,
           "t0": rng.standard_normal((1, d)).astype(np.float32),
           "xe5": rng.standard_normal((5, d)).astype(np.float32)}[table]
    got, want = _run_both(lj, lp, x, tab, xe, relu=relu)
    np.testing.assert_allclose(got, want, **TOL_F32)
    # and against a direct numpy gather/scatter of bf16-rounded messages
    pre = _bf16(x)[s]
    if tab is not None:
        pre = pre + _bf16(tab)[xe if xe is not None else 0]
    msg = _bf16(np.maximum(pre, 0) if relu else pre)
    direct = np.zeros((n_pad, d), np.float32)
    np.add.at(direct, r, msg)
    np.testing.assert_allclose(got, direct, **TOL_F32)


@pytest.mark.parametrize("out_bf16", [False, True])
@pytest.mark.parametrize("epilogue", ["init", "init+scale", "scale+gate",
                                      "init+scale+gate"])
def test_gathered_ref_matches_pallas_epilogues(epilogue, out_bf16):
    """init (f32 hub partial sums), scale (1/deg) and gate (a bf16 relu
    mask, zero where <= 0) in the fused epilogue; f32 and bf16 out."""
    rng = np.random.default_rng(2)
    n_pad, d = 640, 64
    s, r = _locality(rng)
    lj, lp = _layouts(s, r, n_pad)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    t0 = rng.standard_normal((1, d)).astype(np.float32)
    opt = {}
    if "init" in epilogue:
        opt["init"] = rng.standard_normal((n_pad, d)).astype(np.float32)
    if "scale" in epilogue:
        opt["scale"] = (rng.random((n_pad, 1)) + 0.5).astype(np.float32)
    got_gate = "gate" in epilogue
    if got_gate:
        opt["gate"] = _bf16(rng.standard_normal((n_pad, d)))
    got, want = _run_both(lj, lp, x, t0, None, relu=True, out_bf16=out_bf16,
                          **opt)
    np.testing.assert_allclose(got, want,
                               **(TOL_BF16_OUT if out_bf16 else TOL_F32))
    if got_gate:
        assert (got[opt["gate"] <= 0] == 0).all()


def test_gathered_ref_matches_pallas_sender_order_backward_shape():
    """The factored backward's call: sender order, keys = receivers, no
    relu, no table, an f32 init and a gate."""
    rng = np.random.default_rng(3)
    n_pad, d = 640, 32
    s, r = _locality(rng)
    lj, lp = _layouts(s, r, n_pad)
    gp = _bf16(rng.standard_normal((n_pad, d)))
    got, want = _run_both(
        lj, lp, gp, None, None, order="s", relu=False,
        init=rng.standard_normal((n_pad, d)).astype(np.float32),
        gate=rng.standard_normal((n_pad, d)).astype(np.float32))
    np.testing.assert_allclose(got, want, **TOL_F32)


def test_gathered_ref_ignores_sentinel_padding_and_padded_rows():
    """A tail with sentinel-padded edge slots (key N_pad, lrow 128) and
    padded rows of x holding large finite values: neither reaches an
    output row, on both sides, and the valid rows match a direct sum."""
    rng = np.random.default_rng(4)
    n, n_pad, d = 600, 768, 32
    s, r = _locality(rng, n=n, e=2000)
    # padded edge slots, as a graph's edge padding gives them
    e_pad = 2304
    s_all = np.concatenate([s, np.zeros(e_pad - len(s), np.int32)])
    r_all = np.concatenate([r, np.zeros(e_pad - len(r), np.int32)])
    mask = np.arange(e_pad) < len(s)
    lj, lp = _layouts(s_all, r_all, n_pad, edge_mask=mask)
    assert (lp.senders_r.numpy()[~lp.mask_r.numpy()] == n_pad).all()
    assert (~lp.mask_r.numpy()).sum() >= e_pad - len(s)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    x[n:] = 3.0e38                         # large, finite, bf16-representable
    t0 = rng.standard_normal((1, d)).astype(np.float32)
    got, want = _run_both(lj, lp, x, t0, None, relu=True,
                          scale=(1.0 / np.maximum(
                              lp.in_degree.numpy(), 1.0))[:, None])
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, **TOL_F32)
    deg = np.maximum(np.bincount(r, minlength=n_pad), 1)[:, None]
    direct = np.zeros((n_pad, d), np.float32)
    np.add.at(direct, r, _bf16(np.maximum(_bf16(x)[s] + _bf16(t0), 0)))
    np.testing.assert_allclose(got, direct / deg, **TOL_F32)
    assert (got[n:] == 0).all()


def test_gathered_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    rng = np.random.default_rng(5)
    lay = build_edge_layout(rng.integers(0, 100, 300),
                            rng.integers(0, 100, 300), 128, profile=V5E)
    x = torch.randn(128, 8).to(torch.bfloat16)
    args = (lay.senders_r[None, :], lay.lrow_r, lay.block_ptr_r, x)
    before = dict(sc.launch_counts)
    a = sc.gathered_scatter_rows_sorted(*args, num_nodes_padded=128,
                                        relu=True)
    b = sc.gathered_scatter_rows_sorted_ref(*args, num_nodes_padded=128,
                                            relu=True)
    assert torch.equal(a, b)
    assert sc.launch_counts == before


@pytest.mark.parametrize("bad", ["x_f32", "keys_1d", "table_no_xe",
                                 "xe_no_table", "gate_shape", "stray"])
def test_gathered_wrapper_rejects_bad_inputs(bad):
    rng = np.random.default_rng(6)
    lay = build_edge_layout(rng.integers(0, 100, 300),
                            rng.integers(0, 100, 300), 128, profile=V5E)
    args = dict(keys=lay.senders_r[None, :], local_row=lay.lrow_r,
                block_ptr=lay.block_ptr_r,
                x=torch.randn(128, 8).to(torch.bfloat16))
    kw = dict(num_nodes_padded=128)
    err = ValueError
    if bad == "x_f32":
        args["x"] = args["x"].float()
    elif bad == "keys_1d":
        args["keys"] = lay.senders_r
    elif bad == "table_no_xe":
        args["table"] = torch.zeros(3, 8, dtype=torch.bfloat16)
    elif bad == "xe_no_table":
        args["xe"] = torch.zeros(1, lay.num_edges_padded, dtype=torch.int32)
    elif bad == "gate_shape":
        kw["gate"] = torch.ones(128, 4)
    else:
        # the stray inputs come all four together: one alone is refused,
        # the whole set (a merged LocSplit's) is accepted and equals the
        # plain version
        kw["stray_src"] = torch.zeros(512, 8)
        with pytest.raises(err):
            sc.gathered_scatter_rows_sorted(**args, **kw)
        sp = build_edge_layout(rng.integers(0, 100, 300),
                               rng.integers(0, 100, 300), 128, profile=V5E,
                               loc_split="on", loc_reach=8,
                               loc_merge=True).split_r
        assert sp is not None and int((sp.m_sidx >= 0).sum()) > 0
        x = torch.randn(128, 8).to(torch.bfloat16)
        stray = dict(stray_src=x[sp.m_stray_keys.long()],
                     stray_idx=sp.m_sidx, stray_off=sp.m_soff,
                     stray_cnt=sp.m_scnt)
        got = sc.gathered_scatter_rows_sorted(
            sp.m_keys, sp.m_lrow, sp.m_block_ptr, x, relu=True, **kw | stray)
        want = sc.gathered_scatter_rows_sorted_ref(
            sp.m_keys, sp.m_lrow, sp.m_block_ptr, x, relu=True, **kw | stray)
        assert torch.equal(got, want)
        return
    with pytest.raises(err):
        sc.gathered_scatter_rows_sorted(**args, **kw)
