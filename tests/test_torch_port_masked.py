"""The port's ``masked_scatter_rows_sorted`` (stemgnn_tpu_torch/ops/
scatter.py) against the JAX Pallas kernel in interpret mode, on the CPU.

On CPU tensors the wrapper runs its plain PyTorch version, so these tests
hold that version against the TPU kernel, on the sender-order arrays of
layouts that JAX's ``build_edge_layout`` gives (the TPU kernel also takes
that layout's x windows; the port's kernel needs none).  The CUDA kernel
itself is held against the same plain version on the card by
``chip_smoke.py``.

Both sides rebuild the pre-activation in f32 from bf16 rows (the TPU kernel
through one-hot matrix products with f32 accumulation, exact for 0/1
weights), keep a bf16 edge gradient where it is positive and sum in f32, so
they differ only in the order of the f32 sums: rtol/atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemgnn_tpu.ops.edge_layout import build_edge_layout as jax_layout
from stemgnn_tpu.ops.scatter_pallas import \
    masked_scatter_rows_sorted as jax_masked
from stemgnn_tpu_torch.ops import scatter as sc
from stemgnn_tpu_torch.ops.chip_profile import V5E
from stemgnn_tpu_torch.ops.edge_layout import build_edge_layout

TOL = dict(rtol=1e-5, atol=1e-5)


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _dm_sender_order(rng, lay, e, d):
    """Per-edge gradients in original edge order, and the same values in
    the layout's sender order (zero on padded slots), rounded to bf16."""
    dm_real = _bf16(rng.standard_normal((e, d)))
    dm = dm_real[np.minimum(np.asarray(lay.perm_s2o), e - 1)]
    dm[~np.asarray(lay.mask_s)] = 0
    return dm_real, dm


def _run_both(lay, dm, x, table):
    """JAX's Pallas kernel (interpret) and the port's wrapper on the same
    JAX-built layout: (port, jax) outputs as f32 numpy."""
    n_pad = x.shape[0]
    typed = table is not None
    want = jax_masked(
        jnp.asarray(dm).astype(jnp.bfloat16), lay.lrow_s,
        lay.senders_s[None, :], lay.block_ptr_s, lay.win_lo_s,
        lay.win_nsub_s, jnp.asarray(x).astype(jnp.bfloat16),
        table=jnp.asarray(table).astype(jnp.bfloat16) if typed else None,
        xe=lay.xe_s[None, :] if typed else None, num_nodes_padded=n_pad,
        win_w=lay.win_w, edge_chunk=lay.edge_chunk, interpret=True)
    got = sc.masked_scatter_rows_sorted(
        _t(dm).to(torch.bfloat16), _t(lay.lrow_s),
        _t(lay.senders_s)[None, :], _t(lay.block_ptr_s),
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(table).to(torch.bfloat16) if typed else None,
        _t(lay.xe_s)[None, :] if typed else None, num_nodes_padded=n_pad)
    return got.numpy(), np.asarray(want)


def _direct(x, table, s, xe, dm_real, n_pad):
    """numpy: sum over edges of 1[bf16 x[s] + bf16 T[xe] > 0] * dm."""
    pre = _bf16(x)[s]
    if table is not None:
        pre = pre + _bf16(table)[xe]
    want = np.zeros((n_pad, x.shape[1]), np.float32)
    np.add.at(want, s, np.where(pre > 0, dm_real, 0.0))
    return want


@pytest.mark.parametrize("t_rows", [0, 5, 11])
def test_masked_ref_matches_pallas(t_rows):
    """No table (mask x > 0) and 5- and 11-row type tables, on a uniform
    graph with trailing empty node blocks."""
    rng = np.random.default_rng(t_rows)
    n, e, d, n_pad = 300, 900, 128, 512
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    xe = rng.integers(0, max(t_rows, 1), e).astype(np.int32)
    lay = jax_layout(s, r, n_pad, xe_ids=xe if t_rows else None,
                     edge_chunk=128)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    table = (rng.standard_normal((t_rows, d)).astype(np.float32) if t_rows
             else None)
    dm_real, dm = _dm_sender_order(rng, lay, e, d)
    got, want = _run_both(lay, dm, x, table)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _direct(x, table, s, xe, dm_real, n_pad),
                               **TOL)
    assert (got[n:] == 0).all()


def test_masked_ref_matches_pallas_wide_span():
    """The sparse case of tests/test_pallas_kernels.py's wide-span test:
    chunk spans wider than the window, so the TPU kernel walks several
    subwindows; the port's version reads each sender's row directly."""
    rng = np.random.default_rng(11)
    n, e, d, n_pad = 4000, 1200, 64, 4096
    s = np.sort(rng.choice(n, e, replace=False)).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    lay = jax_layout(s, r, n_pad, edge_chunk=512)
    assert int(np.asarray(lay.win_nsub_s).max()) > 1
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    dm_real, dm = _dm_sender_order(rng, lay, e, d)
    got, want = _run_both(lay, dm, x, None)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _direct(x, None, s, None, dm_real, n_pad),
                               **TOL)


def test_masked_ref_ignores_sentinel_padding_and_padded_rows():
    """Padded edge slots (sender N_pad, lrow 128) and padded rows of x
    holding 1e30: neither reaches an output row on either side."""
    rng = np.random.default_rng(12)
    n, n_pad, d, t_rows = 600, 768, 32, 11
    e = 2000
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    xe = rng.integers(0, t_rows, e).astype(np.int32)
    e_pad = 2304
    pad = np.zeros(e_pad - e, np.int32)
    mask = np.arange(e_pad) < e
    lay = jax_layout(np.concatenate([s, pad]), np.concatenate([r, pad]),
                     n_pad, xe_ids=np.concatenate([xe, pad]),
                     edge_mask=mask, edge_chunk=128)
    senders = np.asarray(lay.senders_s)
    assert (senders[~np.asarray(lay.mask_s)] == n_pad).all()
    assert (np.asarray(lay.lrow_s)[0, ~np.asarray(lay.mask_s)] == 128).all()
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    x[n:] = 1.0e30
    table = rng.standard_normal((t_rows, d)).astype(np.float32)
    dm_real, dm = _dm_sender_order(rng, lay, e, d)
    got, want = _run_both(lay, dm, x, table)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _direct(x, table, s, xe, dm_real, n_pad),
                               **TOL)
    assert (got[n:] == 0).all()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_masked_ref_sums_an_f32_gradient_as_given(out_dtype):
    """An f32 dm is summed in f32 as it is (the TPU kernel rounded it to
    bf16 for its matrix unit; the path's dm is bf16, where both agree), on
    the port's own layout; a bf16 output is that sum rounded once."""
    rng = np.random.default_rng(13)
    n, e, d, n_pad, t_rows = 200, 800, 16, 256, 5
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    xe = rng.integers(0, t_rows, e).astype(np.int32)
    lay = build_edge_layout(s, r, n_pad, xe_ids=xe, profile=V5E)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    table = rng.standard_normal((t_rows, d)).astype(np.float32)
    dm_real = rng.standard_normal((e, d)).astype(np.float32)
    dm = dm_real[np.minimum(lay.perm_s2o.numpy(), e - 1)]
    dm[~lay.mask_s.numpy()] = 0
    got = sc.masked_scatter_rows_sorted(
        torch.from_numpy(dm), lay.lrow_s, lay.senders_s[None, :],
        lay.block_ptr_s, torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(table).to(torch.bfloat16), lay.xe_s[None, :],
        num_nodes_padded=n_pad, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    want = _direct(x, table, s, xe, dm_real, n_pad)
    if out_dtype == torch.bfloat16:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def _small_args(rng):
    lay = build_edge_layout(rng.integers(0, 100, 300),
                            rng.integers(0, 100, 300), 128,
                            xe_ids=rng.integers(0, 3, 300), profile=V5E)
    e_pad = lay.num_edges_padded
    return lay, dict(m=torch.randn(e_pad, 8).to(torch.bfloat16),
                     local_row=lay.lrow_s, senders=lay.senders_s[None, :],
                     block_ptr=lay.block_ptr_s,
                     x=torch.randn(128, 8).to(torch.bfloat16),
                     table=torch.randn(3, 8).to(torch.bfloat16),
                     xe=lay.xe_s[None, :])


def test_masked_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    _, args = _small_args(np.random.default_rng(14))
    before = dict(sc.launch_counts)
    a = sc.masked_scatter_rows_sorted(**args, num_nodes_padded=128)
    b = sc.masked_scatter_rows_sorted_ref(**args, num_nodes_padded=128)
    assert torch.equal(a, b)
    assert sc.launch_counts == before
    assert "masked_scatter_rows_sorted" in sc.KERNELS


@pytest.mark.parametrize("bad", ["m_int", "senders_1d", "x_f32", "x_rows",
                                 "table_no_xe", "xe_no_table", "table_width",
                                 "xe_int64", "out_int", "block_ptr"])
def test_masked_wrapper_rejects_bad_inputs(bad):
    lay, args = _small_args(np.random.default_rng(15))
    kw = dict(num_nodes_padded=128)
    if bad == "m_int":
        args["m"] = args["m"].to(torch.int32)
    elif bad == "senders_1d":
        args["senders"] = lay.senders_s
    elif bad == "x_f32":
        args["x"] = args["x"].float()
    elif bad == "x_rows":
        args["x"] = args["x"][:64]
    elif bad == "table_no_xe":
        args["xe"] = None
    elif bad == "xe_no_table":
        args["table"] = None
    elif bad == "table_width":
        args["table"] = torch.zeros(3, 4, dtype=torch.bfloat16)
    elif bad == "xe_int64":
        args["xe"] = args["xe"].long()
    elif bad == "out_int":
        kw["out_dtype"] = torch.int32
    else:
        args["block_ptr"] = args["block_ptr"][:-1]
    with pytest.raises(ValueError):
        sc.masked_scatter_rows_sorted(**args, **kw)
