"""The port's host-side layout construction
(stemgnn_tpu_torch/ops/edge_layout.py) against the JAX package's: with the
v5e gate profile pinned on both sides, every array the port's
``build_edge_layout`` gives equals JAX's, and so do the in-kernel gather
gates (``gwin``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemgnn_tpu.ops import chip_profile as jax_profile
from stemgnn_tpu.ops import edge_layout as jax_el
from stemgnn_tpu_torch.ops import chip_profile
from stemgnn_tpu_torch.ops import edge_layout as port_el
from stemgnn_tpu_torch.ops.chip_profile import V5E


def _jax_layout(*args, **kw):
    jax_profile.set_profile(jax_profile._V5E)
    try:
        return jax_el.build_edge_layout(*args, gwin="off", **kw)
    finally:
        jax_profile.set_profile(None)


def _as_np(a):
    """numpy view of a tensor or JAX array, bf16 (the count blocks) as f32."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


# the masked kernel's x-windows: that kernel is not ported, so the port
# leaves them unset (JAX builds them whatever its gates say)
_NOT_PORTED = ("win_lo_s", "win_nsub_s", "win_w")
# the GPU row walk's plans and the count blocks' nonzero pairs, which JAX
# has no counterpart of (tests/test_torch_port_rowplan.py and
# tests/test_torch_port_pretrain.py check them)
_PORT_ONLY = ("plan_r", "plan_s", "cnt_nz", "sc_nz")


def _assert_same(port, ref, path="layout"):
    """Every field of the port's dataclass equals the JAX pytree's."""
    for f in dataclasses.fields(port):
        if f.name in _PORT_ONLY:
            continue
        p, j = getattr(port, f.name), getattr(ref, f.name)
        where = f"{path}.{f.name}"
        if f.name in _NOT_PORTED:
            assert not p, where
        elif dataclasses.is_dataclass(p):
            assert j is not None, where
            _assert_same(p, j, where)
        elif p is None or isinstance(p, (int, float, bool)):
            assert p == j, (where, p, j)
        else:
            assert j is not None, where
            pa, ja = _as_np(p), _as_np(j)
            assert pa.shape == ja.shape, (where, pa.shape, ja.shape)
            assert np.array_equal(pa, ja), where


def _power_law(rng, n, e):
    w = 1.0 / np.arange(1, n + 1) ** 1.1
    s = rng.choice(n, e, p=w / w.sum()).astype(np.int32)
    r = rng.choice(n, e, p=w / w.sum()).astype(np.int32)
    return s, r


@pytest.mark.parametrize("hub_mode", ["none", "forced", "forced+sc", "auto"])
def test_layout_arrays_equal_jax(hub_mode):
    rng = np.random.default_rng(0)
    n, e, n_pad = 900, 6000, 1024
    s, r = _power_law(rng, n, e)
    # padded edge slots (mask False) and a single-type xe stream
    e_pad = 6144
    s = np.concatenate([s, np.zeros(e_pad - e, np.int32)])
    r = np.concatenate([r, np.zeros(e_pad - e, np.int32)])
    kw = dict(xe_ids=np.zeros(e_pad, np.int32),
              edge_mask=np.arange(e_pad) < e)
    if hub_mode == "forced":
        kw.update(hub_size=256, hub_min_coverage=-1.0)
    elif hub_mode == "forced+sc":
        kw.update(hub_size=256, hub_min_coverage=-1.0, sc_hub_size=128)
    elif hub_mode == "auto":
        kw.update(hub_size=2048, sc_hub_size=2048, feat_dim_hint=64)
    ref = _jax_layout(s, r, n_pad, **kw)
    got = port_el.build_edge_layout(s, r, n_pad, profile=V5E, gwin="off",
                                    **kw)
    _assert_same(got, ref)
    if hub_mode != "none":
        assert got.hub_r is not None and got.hub_s is not None
    if hub_mode == "forced+sc":
        assert got.hub_r.sc_cnt is not None


def test_layout_uniform_graph_with_empty_blocks_equals_jax():
    rng = np.random.default_rng(1)
    s = rng.integers(0, 200, 700).astype(np.int32)
    r = rng.integers(0, 200, 700).astype(np.int32)
    ref = _jax_layout(s, r, 512, edge_chunk=256)
    got = port_el.build_edge_layout(s, r, 512, edge_chunk=256, profile=V5E,
                                    gwin="off")
    _assert_same(got, ref)
    # two trailing empty node blocks
    assert got.block_ptr_r[2] == got.block_ptr_r[4] == 700


@pytest.mark.parametrize("d", [64, 768])
def test_auto_hub_size_equals_jax(d):
    rng = np.random.default_rng(2)
    freq = np.bincount(_power_law(rng, 5000, 60000)[0], minlength=5120)
    want = jax_el._auto_hub_size(freq, 2048, 5120, d, jax_profile._V5E)
    assert port_el._auto_hub_size(freq, 2048, 5120, d, V5E) == want


def test_h100_profile_is_an_uncalibrated_spec_estimate():
    h = chip_profile.H100
    assert not h.calibrated and "ESTIMATE" in h.provenance
    assert h.hbm_bps == 3.35e12
    assert h.mxu_bf16_flops == pytest.approx(V5E.mxu_bf16_flops * 989 / 197)
    assert chip_profile.profile_for_name("NVIDIA H100 80GB HBM3") is h


def test_layout_leaves_unported_gates_off():
    """The TPU window arrays stay unset; the in-kernel gather gate opens on
    the H100 profile (no card here: the default profile) on the layout and
    on each hub tail that has edges.  The LocSplit, once never built, is
    built as asked: none by default, none under ``"auto"`` (the gate is
    open already), and under ``"on"`` on each hub tail, its local edges
    through the in-kernel gather and its strays through the gather
    route."""
    rng = np.random.default_rng(3)
    s, r = _power_law(rng, 300, 2000)
    for mode in ("off", "auto", "on"):
        lay = port_el.build_edge_layout(s, r, 384, hub_size=128,
                                        sc_hub_size=128,
                                        hub_min_coverage=-1.0,
                                        loc_split=mode)
        for sub in (lay, lay.hub_r.tail, lay.hub_s.tail):
            assert sub.use_gwin_r == sub.use_gwin_s == bool(sub.mask_r.any())
            assert sub.gwin_lo_r is None and sub.gwin_nsub_s is None
            assert sub.win_lo_s is None and sub.gwin_w == 0
        assert lay.split_r is None and lay.split_s is None   # hubs there
        for order, tail in (("r", lay.hub_r.tail), ("s", lay.hub_s.tail)):
            sp = getattr(tail, "split_" + order)
            assert (sp is not None) == (mode == "on"), (mode, order)
            if sp is not None:
                assert getattr(sp.loc, "use_gwin_" + order)
                assert not getattr(sp.stray, "use_gwin_" + order)
                n_sub = int(sp.loc.mask_r.sum() + sp.stray.mask_r.sum())
                assert n_sub == int(tail.mask_r.sum())


def _locality(rng, n=600, e=2400, reach=40):
    """Edges between nearby node ids: narrow gather windows, where the TPU
    gate opens."""
    s = rng.integers(0, n, e).astype(np.int32)
    r = np.clip(s + rng.integers(-reach, reach + 1, e), 0, n - 1)
    return s, r.astype(np.int32)


@pytest.mark.parametrize("gwin", ["auto", "on"])
@pytest.mark.parametrize("graph", ["locality", "power_law"])
def test_gwin_gates_equal_jax_on_the_tpu_profile(graph, gwin):
    """Under the v5e profile the port's gate keeps the JAX formula: the
    same decisions on the layout and on the hub tails."""
    rng = np.random.default_rng(4)
    s, r = _locality(rng) if graph == "locality" else _power_law(rng, 600,
                                                                 2400)
    kw = dict(edge_chunk=128, hub_size=8, hub_min_coverage=-1.0,
              feat_dim_hint=64)
    jax_profile.set_profile(jax_profile._V5E)
    try:
        ref = jax_el.build_edge_layout(s, r, 640, gwin=gwin, **kw)
    finally:
        jax_profile.set_profile(None)
    got = port_el.build_edge_layout(s, r, 640, gwin=gwin, profile=V5E, **kw)
    for a, b in ((got, ref), (got.hub_r.tail, ref.hub_r.tail),
                 (got.hub_s.tail, ref.hub_s.tail)):
        assert (a.use_gwin_r, a.use_gwin_s) == (b.use_gwin_r, b.use_gwin_s)
    if graph == "locality":
        assert got.use_gwin_r and got.use_gwin_s


def test_gwin_gate_on_the_h100_opens_wherever_there_is_an_edge():
    rng = np.random.default_rng(5)
    s, r = _power_law(rng, 300, 2000)
    h100 = chip_profile.H100
    lay = port_el.build_edge_layout(s, r, 384, profile=h100, feat_dim_hint=8)
    assert lay.use_gwin_r and lay.use_gwin_s
    assert port_el.gwin_gate(s, r, 384, profile=h100) == (True, True)
    none = np.zeros(len(s), bool)
    assert port_el.gwin_gate(s, r, 384, edge_mask=none,
                             profile=h100) == (False, False)
    off = port_el.build_edge_layout(s, r, 384, profile=h100, gwin="off")
    assert not (off.use_gwin_r or off.use_gwin_s)
    with pytest.raises(ValueError):
        port_el.build_edge_layout(s, r, 384, gwin="sometimes")


def test_typed_hubs_are_not_ported():
    """What of the typed hubs stays unbuilt, as in JAX: a backward-side
    (gather by receiver) block, the scatter-side block, and any hub for
    T > 32.  (The forward-side typed hubs themselves are ported and held
    against JAX in tests/test_torch_port_typed.py.)"""
    kw = dict(hub_size=128, sc_hub_size=128, hub_min_coverage=-1.0)
    lay = port_el.build_edge_layout(np.arange(10), np.arange(10), 128,
                                    xe_ids=np.arange(10) % 3,
                                    num_edge_types=3, **kw)
    assert lay.hub_r.hub_xe is not None and lay.hub_r.sc_cnt is None
    assert lay.hub_s is None
    wide = port_el.build_edge_layout(np.arange(10), np.arange(10), 128,
                                     xe_ids=np.arange(10) % 3,
                                     num_edge_types=33, **kw)
    assert wide.hub_r is None and wide.hub_s is None
