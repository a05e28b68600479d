"""The port's local/stray split (stemgnn_tpu_torch/ops/edge_layout.py
``LocSplit``, ops/scatter.py kernel 2's stray inputs, ops/fused_sage.py's
split execution) against the JAX package's, on the CPU.

Layouts under the ``V5E`` profile equal JAX's field for field (the split's
sub-layouts less the TPU gather windows, which the port never builds).
``fused_sage_aggregate`` over split layouts (two launches, the merged
launch, a hub tail's split) matches JAX's ``interpret=True`` values and
gradients at the sizes of tests/test_hub_dense.py: rtol 1e-5 with an f32
output, one bf16 ulp with a bf16 one.  Kernel 2's plain version with stray
inputs matches the Pallas kernel in interpret mode to 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemgnn_tpu.ops import chip_profile as jax_profile
from stemgnn_tpu.ops import edge_layout as jax_el
from stemgnn_tpu.ops.fused_sage import fused_sage_aggregate as jax_fused
from stemgnn_tpu.ops.scatter_pallas import \
    gathered_scatter_rows_sorted as jax_gathered
from stemgnn_tpu_torch.data.synthetic import community_power_law_graph
from stemgnn_tpu_torch.ops import edge_layout as port_el
from stemgnn_tpu_torch.ops import scatter as sc
from stemgnn_tpu_torch.ops.chip_profile import V5E
from stemgnn_tpu_torch.ops.fused_sage import fused_sage_aggregate
from stemgnn_tpu_torch.ops.reorder import community_order, relabel

TOL_F32 = dict(rtol=1e-5, atol=1e-6)
TOL_BF16 = dict(rtol=2.0 ** -7, atol=1e-6)

# the TPU gather windows of the sub-layouts (the port's gate reads them
# off the keys and keeps none), the masked kernel's x-windows, and the
# port-only row plans and count-block pairs
_SKIP = {"gwin_lo_r", "gwin_nsub_r", "gwin_lo_s", "gwin_nsub_s", "gwin_w",
         "win_lo_s", "win_nsub_s", "win_w", "plan_r", "plan_s", "m_plan",
         "cnt_nz", "sc_nz"}


def _as_np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def _assert_same(port, ref, path="layout"):
    for f in dataclasses.fields(port):
        if f.name in _SKIP:
            continue
        p, j = getattr(port, f.name), getattr(ref, f.name)
        where = f"{path}.{f.name}"
        if dataclasses.is_dataclass(p):
            assert j is not None, where
            _assert_same(p, j, where)
        elif p is None or isinstance(p, (int, float, bool)):
            assert p == j, (where, p, j)
        else:
            assert j is not None, where
            pa, ja = _as_np(p), _as_np(j)
            assert pa.shape == ja.shape and np.array_equal(pa, ja), where


def _community(n=3000, e=18000, seed=1, communities=30):
    _, s, r, _ = community_power_law_graph(n, e, 4, seed=seed,
                                           num_communities=communities)
    perm = community_order(s, r, n)
    s, r, _ = relabel(perm, s, r)
    return s.astype(np.int32), r.astype(np.int32)


def _both(s, r, n_pad, **kw):
    jax_profile.set_profile(jax_profile._V5E)
    try:
        lj = jax_el.build_edge_layout(s, r, n_pad, to_device=False, **kw)
    finally:
        jax_profile.set_profile(None)
    return lj, port_el.build_edge_layout(s, r, n_pad, profile=V5E, **kw)


LAYOUT_CASES = {
    "on": dict(loc_split="on"),
    "auto": dict(loc_split="auto"),
    "merge": dict(loc_split="on", loc_merge=True),
    "auto-merge": dict(loc_split="auto", loc_merge=True),
    "hub-tails": dict(loc_split="on", hub_size=256, sc_hub_size=128,
                      hub_min_coverage=-1.0, loc_merge=True),
    "reach": dict(loc_split="on", loc_reach=40, edge_chunk=128),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_layouts_equal_jax_under_v5e(case):
    kw = dict(LAYOUT_CASES[case], feat_dim_hint=768)
    s, r = _community(8000, 60000, communities=16)
    lj, lp = _both(s, r, 8064, **kw)
    _assert_same(lp, lj)
    splits = [lp.split_r, lp.split_s]
    if lp.hub_r is not None:
        splits += [lp.hub_r.tail.split_r, lp.hub_s.tail.split_s]
        assert lp.split_r is None and lp.split_s is None
        # hub tails get no merged metadata (JAX passes loc_merge no further)
        assert lp.hub_r.tail.split_r.m_keys is None
    assert any(sp is not None for sp in splits), case
    for sp in splits:
        if sp is not None and sp.m_keys is not None:
            plan = sp.m_plan
            assert torch.equal(plan.stray_idx,
                               sp.m_sidx.reshape(-1)[plan.pos.long()])
            assert plan.stray_rows == int(sp.m_sidx.max()) + 1


def test_auto_split_is_off_under_the_h100_profile_and_forced_on():
    """The H100 profile's gate is open on every graph, so ``"auto"`` never
    builds a split; ``"on"`` does, as JAX's tests and bench force it."""
    s, r = _community()
    auto = port_el.build_edge_layout(s, r, 3072, loc_split="auto")
    assert auto.split_r is None and auto.split_s is None
    on = port_el.build_edge_layout(s, r, 3072, loc_split="on",
                                   loc_merge=True)
    assert on.split_r is not None and on.split_s is not None
    assert on.split_r.loc.use_gwin_r and on.split_s.loc.use_gwin_s
    with pytest.raises(ValueError):
        port_el.build_edge_layout(s, r, 3072, loc_split="yes")


FUSED_CASES = {
    "two-launch": (dict(loc_split="on"), False),
    "merged": (dict(loc_split="on", loc_merge=True), True),
    "hub-tail": (dict(loc_split="on", hub_size=8, hub_min_coverage=-1.0),
                 False),
}


@pytest.mark.parametrize("x_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_split_value_and_grad_match_jax_interpret(case, x_bf16):
    kw, merged = FUSED_CASES[case]
    n, d, n_pad = 3000, 64, 3072
    s, r = _community()
    lj, lp = _both(s, r, n_pad, feat_dim_hint=d, **kw)
    assert (lp.split_r or lp.hub_r.tail.split_r) is not None
    x = np.random.default_rng(0).standard_normal((n_pad, d)).astype(
        np.float32)
    jdt = jnp.bfloat16 if x_bf16 else jnp.float32

    def loss(xj):
        out = jax_fused(xj, lj, None, reduce="mean", relu=True,
                        interpret=True, bf16_messages=True,
                        loc_merged=merged)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, jo), jg = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(x).astype(jdt))
    xt = torch.from_numpy(x).to(torch.bfloat16 if x_bf16 else torch.float32)
    xt.requires_grad_()
    before = dict(sc.launch_counts)
    po = fused_sage_aggregate(xt, lp, None, reduce="mean",
                              loc_merged=merged)
    (po.float() ** 2).sum().backward()
    assert sc.launch_counts == before         # the CPU runs plain versions
    tol = TOL_BF16 if x_bf16 else TOL_F32
    np.testing.assert_allclose(po.detach().float().numpy()[:n],
                               np.asarray(jo, np.float32)[:n], **tol)
    np.testing.assert_allclose(xt.grad.float().numpy()[:n],
                               np.asarray(jg, np.float32)[:n], **tol)


def test_split_routes_launch_each_kernel_once_a_direction(monkeypatch):
    """The two-launch split runs kernel 1 (strays) then kernel 2 (local)
    once a direction; the merged split kernel 2 once; counted through the
    fused module's kernel names (the CPU runs the plain versions)."""
    from stemgnn_tpu_torch.ops import fused_sage as fs
    calls = []

    def counting(name, ref):
        def fn(*a, plan=None, **k):
            calls.append((name, "stray_src" in k and k["stray_src"]
                          is not None))
            return ref(*a, **k)
        return fn
    monkeypatch.setattr(fs, "scatter_rows_sorted",
                        counting("k1", sc.scatter_rows_sorted_ref))
    monkeypatch.setattr(fs, "gathered_scatter_rows_sorted",
                        counting("k2", sc.gathered_scatter_rows_sorted_ref))
    s, r = _community()
    for merged, want in ((False, [("k1", False), ("k2", False)] * 2),
                         (True, [("k2", True)] * 2)):
        lay = port_el.build_edge_layout(s, r, 3072, loc_split="on",
                                        loc_merge=merged, feat_dim_hint=64)
        x = torch.randn(3072, 16, requires_grad=True)
        calls.clear()
        fused_sage_aggregate(x, lay, None, loc_merged=merged).sum().backward()
        assert calls == want, (merged, calls)


@pytest.mark.parametrize("relu,t0", [(True, False), (True, True),
                                     (False, False)])
def test_gathered_ref_with_stray_inputs_matches_pallas(relu, t0):
    n_pad, d = 3072, 32
    s, r = _community()
    lj, lp = _both(s, r, n_pad, loc_split="on", loc_merge=True,
                   feat_dim_hint=d)
    spj, spp = lj.split_r, lp.split_r
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    table = rng.standard_normal((1, d)).astype(np.float32) if t0 else None
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    # an f32 stray buffer: the kernel rounds its rows to bf16
    sbuf = jnp.take(jnp.asarray(x), spj.m_stray_keys, axis=0)
    want = jax_gathered(
        spj.m_keys, spj.m_lrow, spj.m_block_ptr, spj.m_win_lo,
        spj.m_win_nsub, xb,
        table=None if table is None else jnp.asarray(table).astype(
            jnp.bfloat16),
        num_nodes_padded=n_pad, win_w=spj.m_gwin_w, relu=relu,
        interpret=True, stray_src=sbuf, stray_idx=spj.m_sidx,
        stray_off=spj.m_soff, stray_cnt=spj.m_scnt)
    got = sc.gathered_scatter_rows_sorted(
        spp.m_keys, spp.m_lrow, spp.m_block_ptr,
        torch.from_numpy(x).to(torch.bfloat16),
        None if table is None else torch.from_numpy(table).to(
            torch.bfloat16),
        num_nodes_padded=n_pad, relu=relu,
        stray_src=torch.from_numpy(x)[spp.m_stray_keys.long()],
        stray_idx=spp.m_sidx, stray_off=spp.m_soff, stray_cnt=spp.m_scnt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_F32)


@pytest.mark.parametrize("bad", ["count", "slice", "rows", "alone"])
def test_stray_metadata_is_checked_on_the_host(bad):
    s, r = _community()
    sp = port_el.build_edge_layout(s, r, 3072, loc_split="on",
                                   loc_merge=True).split_r
    x = torch.randn(3072, 8).to(torch.bfloat16)
    st = dict(stray_src=x[sp.m_stray_keys.long()], stray_idx=sp.m_sidx,
              stray_off=sp.m_soff, stray_cnt=sp.m_scnt)
    c = int(torch.nonzero(sp.m_scnt)[0])
    if bad == "count":
        st["stray_cnt"] = sp.m_scnt.clone()
        st["stray_cnt"][c] += 1
    elif bad == "slice":
        st["stray_off"] = sp.m_soff.clone()
        st["stray_off"][c] += 1
    elif bad == "rows":
        st["stray_src"] = st["stray_src"][:int(sp.m_sidx.max())]
    else:
        st.pop("stray_cnt")
        st["stray_cnt"] = None
    with pytest.raises(ValueError):
        sc.gathered_scatter_rows_sorted(
            sp.m_keys, sp.m_lrow, sp.m_block_ptr, x, num_nodes_padded=3072,
            **st)
    if bad in ("count", "slice"):
        with pytest.raises(ValueError):
            port_el.row_plan(sp.m_lrow, sp.m_block_ptr, sp.m_keys,
                             stray_idx=sp.m_sidx, stray_off=st["stray_off"],
                             stray_cnt=st["stray_cnt"])
