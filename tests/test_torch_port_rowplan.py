"""The row plan of the GPU kernels 1, 2 and 3 (stemgnn_tpu_torch/ops/
edge_layout.py ``RowPlan``, ``row_plan``) on the CPU.

The plan lists a layout direction's counted edges in output-row order, cut
into work items of at most ``chunk`` edges; ``csrc/row_walk.cuh`` runs one
warp per item and a second pass over the rows longer than a chunk.  The CUDA
kernels run only on the card (``chip_smoke.py`` holds them against their
plain versions there), so these tests check the plan's invariants and run a
plain torch emulation of the two-pass walk, driven by the plan, against the
plain versions and against JAX's Pallas kernels in interpret mode.

Tolerances: an unsplit row is summed in the plain version's order, so it
agrees bit for bit; a split row adds f32 partial sums of its items, a
reassociation of the same f32 sum: rtol 1e-5, atol 1e-4 on sums of up to a
few thousand unit-size terms.  Against Pallas the tolerances of
test_torch_port_gathered.py and test_torch_port_masked.py hold (the TPU
kernel sums in another order): rtol/atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemgnn_tpu.ops import chip_profile as jax_profile
from stemgnn_tpu.ops.edge_layout import build_edge_layout as jax_layout
from stemgnn_tpu.ops.scatter_pallas import \
    gathered_scatter_rows_sorted as jax_gathered
from stemgnn_tpu.ops.scatter_pallas import \
    masked_scatter_rows_sorted as jax_masked
from stemgnn_tpu_torch import tune_row_walk as tune
from stemgnn_tpu_torch.ops import scatter as sc
from stemgnn_tpu_torch.ops.chip_profile import V5E
from stemgnn_tpu_torch.ops.edge_layout import (ROW_CHUNK, RowPlan,
                                               build_edge_layout, row_plan)

SPLIT_TOL = dict(rtol=1e-5, atol=1e-4)
PALLAS_TOL = dict(rtol=1e-5, atol=1e-5)


def _power_law(rng, n, e):
    w = 1.0 / np.arange(1, n + 1) ** 1.1
    return (rng.choice(n, e, p=w / w.sum()).astype(np.int32),
            rng.choice(n, e, p=w / w.sum()).astype(np.int32))


def _graph(kind, rng):
    """(senders, receivers, n_pad, build_edge_layout keywords)."""
    if kind == "uniform_empty_rows":
        # 200 of 512 rows used: empty rows and two empty node blocks
        return (rng.integers(0, 200, 700), rng.integers(0, 200, 700), 512,
                {})
    if kind == "power_law_long_row":
        s, r = _power_law(rng, 900, 6000)
        s[:700] = 3                         # a sender and a receiver with
        r[:700] = 5                         # rows longer than ROW_CHUNK
        return s, r, 1024, {}
    if kind == "sentinel_padding":
        e, e_pad = 2000, 2304
        s = np.concatenate([rng.integers(0, 600, e), np.zeros(e_pad - e)])
        r = np.concatenate([rng.integers(0, 600, e), np.zeros(e_pad - e)])
        return s, r, 768, dict(edge_mask=np.arange(e_pad) < e)
    if kind == "hub_tail":
        s, r = _power_law(rng, 300, 2000)
        return s, r, 384, dict(hub_size=128, sc_hub_size=128,
                               hub_min_coverage=-1.0)
    if kind == "typed":
        s, r = _power_law(rng, 600, 3000)
        return s, r, 640, dict(xe_ids=rng.integers(0, 11, 3000),
                               num_edge_types=11)
    raise ValueError(kind)


GRAPHS = ["uniform_empty_rows", "power_law_long_row", "sentinel_padding",
          "hub_tail", "typed"]


def _directions(lay):
    """(name, layout, order) for every direction of ``lay`` and of its hub
    tails."""
    out = [("layout", lay, "r"), ("layout", lay, "s")]
    for hub in ("hub_r", "hub_s"):
        h = getattr(lay, hub)
        if h is not None:
            out += [(hub + ".tail", h.tail, "r"), (hub + ".tail", h.tail, "s")]
    return out


def _counted(lay, order):
    """Layout positions of the counted edges and their output rows, by the
    plain version's rule."""
    rows, ok = sc._edge_rows(getattr(lay, "lrow_" + order),
                             getattr(lay, "block_ptr_" + order))
    pos = torch.nonzero(ok).reshape(-1)
    return pos, rows[pos]


def _check_invariants(plan: RowPlan, lay, order):
    n_pad = lay.num_nodes_padded
    pos, rows = _counted(lay, order)
    got = plan.pos.long()
    # each counted edge exactly once, and no other (padded) edge
    assert sorted(got.tolist()) == pos.tolist()
    mask = getattr(lay, "mask_" + order)
    assert bool(mask[got].all())
    row_of = torch.full((lay.num_edges_padded,), -1, dtype=torch.long)
    row_of[pos] = rows
    plan_rows = row_of[got]
    # rows ascend; inside a row the layout's order
    assert bool((plan_rows[1:] >= plan_rows[:-1]).all())
    same = plan_rows[1:] == plan_rows[:-1]
    assert bool((got[1:][same] > got[:-1][same]).all())
    # items tile the plan in order, each inside one row, at most chunk long
    start, item_row = plan.item_start.long(), plan.item_row.long()
    assert start[0] == 0 and start[-1] == got.numel()
    lens = start[1:] - start[:-1]
    assert bool((lens >= 0).all()) and bool((lens <= plan.chunk).all())
    for i in torch.nonzero(lens).reshape(-1).tolist():
        assert bool((plan_rows[start[i]:start[i + 1]] == item_row[i]).all())
    # every output row has an item (its epilogue), rows in ascending order
    assert bool((item_row[1:] >= item_row[:-1]).all())
    assert torch.equal(torch.unique(item_row), torch.arange(n_pad))
    # a row is split iff it is longer than the chunk; its items own
    # consecutive slots in item order, listed by split_ptr
    deg = torch.bincount(plan_rows, minlength=n_pad)
    split = torch.nonzero(deg > plan.chunk).reshape(-1)
    assert torch.equal(plan.split_row.long(), split)
    slot = plan.item_slot.long()
    in_split = (deg > plan.chunk)[item_row]
    assert bool((slot[~in_split] == -1).all())
    assert torch.equal(slot[in_split], torch.arange(int(in_split.sum())))
    ptr = plan.split_ptr.long()
    assert ptr[0] == 0 and ptr[-1] == plan.num_slots == int(in_split.sum())
    for k, r in enumerate(split.tolist()):
        assert torch.equal(slot[item_row == r],
                           torch.arange(int(ptr[k]), int(ptr[k + 1])))


@pytest.mark.parametrize("chunk", [ROW_CHUNK, 4])
@pytest.mark.parametrize("kind", GRAPHS)
def test_plan_invariants(kind, chunk):
    """Each counted edge once and no padded edge; rows ascend and keep the
    layout's order inside; no item longer than the chunk; every row an
    epilogue; split rows and their slots consistent.  For every direction
    of the layout and of its hub tails (the layout's own plans at the
    default chunk, :func:`row_plan` at a chunk of 4)."""
    s, r, n_pad, kw = _graph(kind, np.random.default_rng(0))
    lay = build_edge_layout(s, r, n_pad, **kw)
    dirs = _directions(lay)
    assert (kind == "hub_tail") == (len(dirs) == 6)
    for _, sub, order in dirs:
        plan = getattr(sub, "plan_" + order)
        if chunk != ROW_CHUNK:
            plan = row_plan(getattr(sub, "lrow_" + order),
                            getattr(sub, "block_ptr_" + order), chunk=chunk)
        _check_invariants(plan, sub, order)
    if kind == "power_law_long_row":
        assert lay.plan_r.num_split >= 1 and lay.plan_s.num_split >= 1


@pytest.mark.parametrize("kind", GRAPHS)
def test_layout_plans_permute_their_direction(kind):
    """The layout's plans: built from that direction's arrays (the wrappers
    check this), keys, senders and types in plan order, equal to
    :func:`row_plan` on the same arrays."""
    s, r, n_pad, kw = _graph(kind, np.random.default_rng(1))
    lay = build_edge_layout(s, r, n_pad, **kw)
    for _, sub, order in _directions(lay):
        plan = getattr(sub, "plan_" + order)
        keys = sub.senders_r if order == "r" else sub.receivers_s
        xe = getattr(sub, "xe_" + order)
        pos = plan.pos.long()
        assert torch.equal(plan.keys, keys[pos])
        assert (plan.xe is None) == (xe is None)
        if xe is not None:
            assert torch.equal(plan.xe, xe[pos])
        assert plan.built_from("local_row", getattr(sub, "lrow_" + order))
        assert plan.built_from("block_ptr",
                               getattr(sub, "block_ptr_" + order))
        assert plan.built_from("keys", keys[None, :])
        assert not plan.built_from("keys", keys.clone())
        assert plan.built_from("xe", xe)
        if order == "s":
            assert torch.equal(plan.senders, sub.senders_s[pos])
            assert plan.built_from("senders", sub.senders_s[None, :])
        else:
            assert plan.senders is None
        again = row_plan(getattr(sub, "lrow_" + order),
                         getattr(sub, "block_ptr_" + order), keys=keys,
                         senders=sub.senders_s if order == "s" else None,
                         xe=xe)
        for f in ("pos", "item_row", "item_start", "item_slot", "split_row",
                  "split_ptr", "keys", "senders", "xe"):
            a, b = getattr(plan, f), getattr(again, f)
            assert (a is None and b is None) or torch.equal(a, b), f


# --------------------------------------------------------------------------
# a plain torch emulation of the two-pass walk (csrc/row_walk.cuh)


def _walk(plan: RowPlan, msg, n_pad):
    """The f32 sums the kernels form: each item adds its messages (``msg``
    [E_cnt, D] f32, in plan order) in order from zero; an unsplit row's
    item is its sum, a split row's items become partial sums that the
    second pass adds in item order.  Returns [n_pad, D] f32 before the
    epilogue."""
    d = msg.shape[1]
    start = plan.item_start.long()
    lens = start[1:] - start[:-1]
    acc = torch.zeros(plan.num_items, d)
    for t in range(int(lens.max()) if lens.numel() else 0):
        live = lens > t
        acc[live] = acc[live] + msg[start[:-1][live] + t]
    slot = plan.item_slot.long()
    unsplit = slot < 0
    sums = torch.zeros(n_pad, d)
    sums[plan.item_row.long()[unsplit]] = acc[unsplit]
    partials = torch.zeros(plan.num_slots, d)
    partials[slot[~unsplit]] = acc[~unsplit]
    ptr = plan.split_ptr.tolist()
    for k, row in enumerate(plan.split_row.tolist()):
        total = torch.zeros(d)
        for j in range(ptr[k], ptr[k + 1]):
            total = total + partials[j]
        sums[row] = total
    return sums


def _rows_or_zero(table, idx):
    ok = (idx >= 0) & (idx < table.shape[0])
    return torch.where(ok[:, None],
                       table.index_select(0, idx.clamp(0, table.shape[0] - 1)
                                          ).float(),
                       torch.zeros(()))


def _gathered_walk(plan, x, table, with_xe, *, relu, init=None, scale=None,
                   gate=None, out_dtype=torch.float32):
    pre = _rows_or_zero(x, plan.keys.long())
    if table is not None:
        pre = pre + (_rows_or_zero(table, plan.xe.long()) if with_xe
                     else table[0].float())
    if relu:
        pre = torch.relu(pre)
    msg = pre.to(torch.bfloat16).float()
    return sc._epilogue(_walk(plan, msg, x.shape[0]), init, scale, gate,
                        out_dtype)


def _scatter_walk(plan, m, *, num_nodes_padded, relu, init=None, scale=None,
                  gate=None, out_dtype=torch.float32):
    """Kernel 1's walk: the message rows at the plan's layout positions,
    relu'd, summed per item, finished with the epilogue."""
    msg = m.index_select(0, plan.pos.long()).float()
    if relu:
        msg = torch.relu(msg)
    return sc._epilogue(_walk(plan, msg, num_nodes_padded), init, scale,
                        gate, out_dtype)


def _masked_walk(plan, dm, x, table, out_dtype=torch.float32):
    pre = _rows_or_zero(x, plan.senders.long())
    if table is not None:
        pre = pre + _rows_or_zero(table, plan.xe.long())
    g = dm.index_select(0, plan.pos.long()).float()
    msg = torch.where(pre > 0, g, torch.zeros(()))
    return _walk(plan, msg, x.shape[0]).to(out_dtype)


def _assert_walk_matches(got, want, plan, out_dtype=torch.float32):
    """Bit for bit on the rows no item splits; the f32 reassociation
    tolerance (a bf16 ulp for bf16 outputs) on the split rows."""
    split = torch.zeros(got.shape[0], dtype=torch.bool)
    split[plan.split_row.long()] = True
    assert torch.equal(got[~split], want[~split])
    tol = SPLIT_TOL if out_dtype == torch.float32 else dict(rtol=2.0 ** -7,
                                                            atol=1e-4)
    np.testing.assert_allclose(got[split].float().numpy(),
                               want[split].float().numpy(), **tol)


def _bf16(t):
    return torch.from_numpy(np.asarray(t, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("chunk", [ROW_CHUNK, 3])
@pytest.mark.parametrize("epilogue", ["none", "init+scale+gate"])
@pytest.mark.parametrize("table", ["none", "t0", "xe"])
@pytest.mark.parametrize("kind", ["uniform_empty_rows", "power_law_long_row",
                                  "sentinel_padding", "typed"])
def test_gathered_walk_matches_the_plain_version(kind, table, epilogue,
                                                 chunk):
    """Kernel 2's walk over the receiver order (and, without a table, the
    sender order of the backward): the message arithmetic, the zero row of
    a key outside [0, N_pad), padded rows of x holding large values that
    no counted edge reads, empty rows under init/scale/gate."""
    rng = np.random.default_rng(2)
    s, r, n_pad, kw = _graph(kind, rng)
    if table == "xe" and "xe_ids" not in kw:
        kw = dict(kw, xe_ids=rng.integers(0, 5, len(s)))
    lay = build_edge_layout(s, r, n_pad, **kw)
    d = 24
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    x[n_pad - 40:] = 3.0e38
    x = _bf16(x)
    t_rows = {"none": 0, "t0": 1, "xe": 11 if kind == "typed" else 5}[table]
    tab = _bf16(rng.standard_normal((t_rows, d))) if t_rows else None
    opt = {}
    if epilogue != "none":
        opt = dict(init=torch.from_numpy(
                       rng.standard_normal((n_pad, d)).astype(np.float32)),
                   scale=torch.from_numpy(
                       (rng.random((n_pad, 1)) + 0.5).astype(np.float32)),
                   gate=_bf16(rng.standard_normal((n_pad, d))))
    for order in ("r", "s") if table == "none" else ("r",):
        keys = lay.senders_r if order == "r" else lay.receivers_s
        xe = getattr(lay, "xe_" + order) if table == "xe" else None
        plan = row_plan(getattr(lay, "lrow_" + order),
                        getattr(lay, "block_ptr_" + order), keys=keys, xe=xe,
                        chunk=chunk)
        want = sc.gathered_scatter_rows_sorted_ref(
            keys[None, :], getattr(lay, "lrow_" + order),
            getattr(lay, "block_ptr_" + order), x, tab,
            None if xe is None else xe[None, :], num_nodes_padded=n_pad,
            relu=order == "r", **opt)
        got = _gathered_walk(plan, x, tab, xe is not None,
                             relu=order == "r", **opt)
        assert torch.isfinite(got).all()
        _assert_walk_matches(got, want, plan)
        if chunk == 3:
            assert plan.num_split > 0


def test_gathered_walk_reads_a_zero_row_for_keys_outside_the_graph():
    """A counted edge whose key lies outside [0, N_pad) adds the message
    of a zero row (plus its type row), on the walk and on the plain
    version alike."""
    rng = np.random.default_rng(3)
    lay = build_edge_layout(rng.integers(0, 100, 300),
                            rng.integers(0, 100, 300), 128,
                            xe_ids=rng.integers(0, 3, 300))
    keys = lay.senders_r.clone()
    keys[:5] = torch.tensor([128, 500, -1, -7, 129], dtype=torch.int32)
    plan = row_plan(lay.lrow_r, lay.block_ptr_r, keys=keys, xe=lay.xe_r,
                    chunk=2)
    x = _bf16(rng.standard_normal((128, 16)))
    tab = _bf16(rng.standard_normal((3, 16)))
    want = sc.gathered_scatter_rows_sorted_ref(
        keys[None, :], lay.lrow_r, lay.block_ptr_r, x, tab,
        lay.xe_r[None, :], num_nodes_padded=128, relu=True)
    _assert_walk_matches(_gathered_walk(plan, x, tab, True, relu=True), want,
                         plan)


@pytest.mark.parametrize("chunk", [ROW_CHUNK, 3])
@pytest.mark.parametrize("epilogue", ["none", "init+scale+gate"])
@pytest.mark.parametrize("m_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["uniform_empty_rows", "power_law_long_row",
                                  "sentinel_padding", "hub_tail"])
def test_scatter_walk_matches_the_plain_version(kind, m_dtype, epilogue,
                                                chunk):
    """Kernel 1's walk over both orders (relu forward, none backward), with
    bf16 and f32 messages, padded message slots holding large values that
    no counted edge reads, empty rows under init/scale/gate, split rows
    (chunk 3) and bf16 outputs: bit for bit on unsplit rows."""
    rng = np.random.default_rng(12)
    s, r, n_pad, kw = _graph(kind, rng)
    lay = build_edge_layout(s, r, n_pad, **kw)
    d = 24
    opt = {}
    if epilogue != "none":
        opt = dict(init=torch.from_numpy(
                       rng.standard_normal((n_pad, d)).astype(np.float32)),
                   scale=torch.from_numpy(
                       (rng.random((n_pad, 1)) + 0.5).astype(np.float32)),
                   gate=_bf16(rng.standard_normal((n_pad, d))))
    splits = 0
    for _, lay_, order in _directions(lay):
        lrow = getattr(lay_, "lrow_" + order)
        bp = getattr(lay_, "block_ptr_" + order)
        e_pad = lay_.num_edges_padded
        m = rng.standard_normal((e_pad, d)).astype(np.float32)
        m[~getattr(lay_, "mask_" + order).numpy()] = 3.0e38
        m = torch.from_numpy(m).to(m_dtype)
        plan = row_plan(lrow, bp, chunk=chunk)
        splits += plan.num_split
        for out_dtype in (torch.float32, torch.bfloat16):
            kw2 = dict(num_nodes_padded=n_pad, relu=order == "r",
                       out_dtype=out_dtype, **opt)
            want = sc.scatter_rows_sorted_ref(m, lrow, bp, **kw2)
            got = _scatter_walk(plan, m, **kw2)
            assert torch.isfinite(got).all()
            _assert_walk_matches(got, want, plan, out_dtype)
    assert splits > 0 or chunk == ROW_CHUNK


def test_scatter_walk_on_dropout_tails_with_zeroed_messages():
    """Kernel 1 as the pair-hash dropout drives it: a hub tail's gathered
    messages times their keep (dropped edges' messages are zero), the hub
    sums as init, the kept-degree mean as scale, on the tail's own plan."""
    from stemgnn_tpu_torch.ops.fused_sage import (DropView, hub_partials,
                                                  tail_messages)
    rng = np.random.default_rng(13)
    s, r = _power_law(rng, 600, 4000)
    n_pad = 640
    lay = build_edge_layout(s, r, n_pad, hub_size=8, sc_hub_size=8,
                            hub_min_coverage=-1.0)
    view = DropView(lay, 2 ** 31 - 9, 0.3)
    x = _bf16(rng.standard_normal((n_pad, 32)))
    t0 = _bf16(rng.standard_normal((1, 32)))
    tail = lay.hub_r.tail
    keep = view.keep(tail, "r")
    assert 0 < int((tail.mask_r & ~keep).sum()) < int(tail.mask_r.sum())
    m = tail_messages(x, tail, t0, "r") * keep.to(torch.bfloat16)[:, None]
    kw2 = dict(num_nodes_padded=n_pad, relu=True,
               init=hub_partials(x, lay.hub_r, t0,
                                 blocks=view.hub(lay.hub_r)[:2]),
               scale=view.inv_deg())
    for chunk in (ROW_CHUNK, 3):
        plan = (tail.plan_r if chunk == ROW_CHUNK else
                row_plan(tail.lrow_r, tail.block_ptr_r, chunk=chunk))
        want = sc.scatter_rows_sorted_ref(m, tail.lrow_r, tail.block_ptr_r,
                                          **kw2)
        _assert_walk_matches(_scatter_walk(plan, m, **kw2), want,
                             plan)


@pytest.mark.parametrize("chunk", [ROW_CHUNK, 3])
@pytest.mark.parametrize("dm_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("table", ["none", "typed"])
@pytest.mark.parametrize("kind", ["uniform_empty_rows", "power_law_long_row",
                                  "sentinel_padding", "typed"])
def test_masked_walk_matches_the_plain_version(kind, table, dm_dtype, chunk):
    """Kernel 3's walk over the sender order (the output row gates its own
    edges) and over the receiver order (senders that are not their row):
    dm read at each edge's layout position, padded rows of x holding 1e30
    never read, empty rows zero."""
    rng = np.random.default_rng(4)
    s, r, n_pad, kw = _graph(kind, rng)
    if table == "typed" and "xe_ids" not in kw:
        kw = dict(kw, xe_ids=rng.integers(0, 11, len(s)))
    lay = build_edge_layout(s, r, n_pad, **kw)
    d = 24
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    x[n_pad - 40:] = 1.0e30
    x = _bf16(x)
    tab = _bf16(rng.standard_normal((11, d))) if table == "typed" else None
    for order in ("s", "r"):
        mask = getattr(lay, "mask_" + order)
        dm = torch.from_numpy(rng.standard_normal(
            (lay.num_edges_padded, d)).astype(np.float32)).to(dm_dtype)
        dm = torch.where(mask[:, None], dm, torch.zeros((), dtype=dm_dtype))
        senders = getattr(lay, "senders_" + order)
        xe = getattr(lay, "xe_" + order) if tab is not None else None
        plan = row_plan(getattr(lay, "lrow_" + order),
                        getattr(lay, "block_ptr_" + order), senders=senders,
                        xe=xe, chunk=chunk)
        want = sc.masked_scatter_rows_sorted_ref(
            dm, getattr(lay, "lrow_" + order), senders[None, :],
            getattr(lay, "block_ptr_" + order), x, tab,
            None if xe is None else xe[None, :], num_nodes_padded=n_pad)
        got = _masked_walk(plan, dm, x, tab)
        assert torch.isfinite(got).all()
        _assert_walk_matches(got, want, plan)


def test_masked_walk_on_the_layouts_own_plan_and_bf16_out():
    """The layout's own sender-order plan (what the typed backward passes)
    and a bf16 output: the f32 sums rounded once."""
    rng = np.random.default_rng(5)
    s, r, n_pad, kw = _graph("power_law_long_row", rng)
    lay = build_edge_layout(s, r, n_pad, xe_ids=rng.integers(0, 11, len(s)),
                            num_edge_types=11)
    assert lay.plan_s.num_split > 0
    d = 16
    x = _bf16(rng.standard_normal((n_pad, d)))
    tab = _bf16(rng.standard_normal((11, d)))
    dm = _bf16(rng.standard_normal((lay.num_edges_padded, d)))
    dm = torch.where(lay.mask_s[:, None], dm, torch.zeros((),
                                                          dtype=dm.dtype))
    want = sc.masked_scatter_rows_sorted_ref(
        dm, lay.lrow_s, lay.senders_s[None, :], lay.block_ptr_s, x, tab,
        lay.xe_s[None, :], num_nodes_padded=n_pad, out_dtype=torch.bfloat16)
    got = _masked_walk(lay.plan_s, dm, x, tab, out_dtype=torch.bfloat16)
    _assert_walk_matches(got, want, lay.plan_s, torch.bfloat16)


@pytest.mark.parametrize("order", ["r", "s"])
def test_gathered_walk_on_hub_tails_with_hub_sums(order):
    """The node path's launches: each hub tail's own plan, the hub partial
    sums as init, 1/deg as scale (forward) or the relu gate (backward)."""
    rng = np.random.default_rng(6)
    s, r, n_pad, kw = _graph("hub_tail", rng)
    lay = build_edge_layout(s, r, n_pad, **kw)
    tail = (lay.hub_r if order == "r" else lay.hub_s).tail
    plan = getattr(tail, "plan_" + order)
    d = 32
    x = _bf16(rng.standard_normal((n_pad, d)))
    t0 = _bf16(rng.standard_normal((1, d))) if order == "r" else None
    init = torch.from_numpy(rng.standard_normal((n_pad, d))
                            .astype(np.float32))
    epi = (dict(scale=1.0 / torch.clamp(lay.in_degree, min=1.0)[:, None])
           if order == "r" else dict(gate=_bf16(rng.standard_normal(
               (n_pad, d)))))
    keys = tail.senders_r if order == "r" else tail.receivers_s
    want = sc.gathered_scatter_rows_sorted_ref(
        keys[None, :], getattr(tail, "lrow_" + order),
        getattr(tail, "block_ptr_" + order), x, t0, num_nodes_padded=n_pad,
        relu=order == "r", init=init, **epi)
    got = _gathered_walk(plan, x, t0, False, relu=order == "r", init=init,
                         **epi)
    _assert_walk_matches(got, want, plan)


def _locality(rng, n=600, e=2400, reach=40):
    s = rng.integers(0, n, e).astype(np.int32)
    s[:400] = 60                            # near a receiver-side long row
    r = np.clip(s + rng.integers(-reach, reach + 1, e), 0, n - 1)
    r[:400] = 57
    return s, r.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("table", ["t0", "xe5"])
def test_gathered_walk_matches_pallas(table):
    """The walk against JAX's ``gathered_scatter_rows_sorted`` in interpret
    mode, on JAX's own layout (gwin on, as test_torch_port_gathered.py
    runs it), with a row longer than a chunk of 64."""
    rng = np.random.default_rng(7)
    n_pad, d = 640, 32
    s, r = _locality(rng)
    xe = rng.integers(0, 5, len(s)).astype(np.int32)
    jax_profile.set_profile(jax_profile._V5E)
    try:
        lj = jax_layout(s, r, n_pad, gwin="on", edge_chunk=128,
                        xe_ids=xe if table == "xe5" else None)
    finally:
        jax_profile.set_profile(None)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    tab = rng.standard_normal((5 if table == "xe5" else 1, d)).astype(
        np.float32)
    init = rng.standard_normal((n_pad, d)).astype(np.float32)
    scale = (rng.random((n_pad, 1)) + 0.5).astype(np.float32)
    want = jax_gathered(
        lj.senders_r[None, :], lj.lrow_r, lj.block_ptr_r, lj.gwin_lo_r,
        lj.gwin_nsub_r, jnp.asarray(x).astype(jnp.bfloat16),
        table=jnp.asarray(tab).astype(jnp.bfloat16),
        xe=lj.xe_r[None, :] if table == "xe5" else None,
        num_nodes_padded=n_pad, win_w=lj.gwin_w, edge_chunk=lj.edge_chunk,
        relu=True, init=jnp.asarray(init), scale=jnp.asarray(scale),
        interpret=True)
    plan = row_plan(_t(lj.lrow_r), _t(lj.block_ptr_r),
                    keys=_t(lj.senders_r),
                    xe=_t(lj.xe_r) if table == "xe5" else None, chunk=64)
    assert plan.num_split > 0
    got = _gathered_walk(plan, _bf16(x), _bf16(tab), table == "xe5",
                         relu=True, init=torch.from_numpy(init),
                         scale=torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **PALLAS_TOL)


@pytest.mark.parametrize("t_rows", [0, 11])
def test_masked_walk_matches_pallas(t_rows):
    """The walk against JAX's ``masked_scatter_rows_sorted`` in interpret
    mode, on JAX's own sender-order layout (as test_torch_port_masked.py
    runs it), with a sender row longer than a chunk of 64."""
    rng = np.random.default_rng(8)
    n, e, d, n_pad = 300, 900, 64, 512
    s = rng.integers(0, n, e).astype(np.int32)
    s[:300] = 40
    r = rng.integers(0, n, e).astype(np.int32)
    xe = rng.integers(0, max(t_rows, 1), e).astype(np.int32)
    lay = jax_layout(s, r, n_pad, xe_ids=xe if t_rows else None,
                     edge_chunk=128)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    table = (rng.standard_normal((t_rows, d)).astype(np.float32) if t_rows
             else None)
    dm = rng.standard_normal((np.asarray(lay.lrow_s).shape[1], d))
    dm = np.array(jnp.asarray(dm, jnp.float32).astype(jnp.bfloat16)
                  .astype(jnp.float32))
    dm[~np.asarray(lay.mask_s)] = 0
    want = jax_masked(
        jnp.asarray(dm).astype(jnp.bfloat16), lay.lrow_s,
        lay.senders_s[None, :], lay.block_ptr_s, lay.win_lo_s,
        lay.win_nsub_s, jnp.asarray(x).astype(jnp.bfloat16),
        table=(jnp.asarray(table).astype(jnp.bfloat16) if t_rows else None),
        xe=lay.xe_s[None, :] if t_rows else None, num_nodes_padded=n_pad,
        win_w=lay.win_w, edge_chunk=lay.edge_chunk, interpret=True)
    plan = row_plan(_t(lay.lrow_s), _t(lay.block_ptr_s),
                    senders=_t(lay.senders_s),
                    xe=_t(lay.xe_s) if t_rows else None, chunk=64)
    assert plan.num_split > 0
    got = _masked_walk(plan, _bf16(dm), _bf16(x),
                       _bf16(table) if t_rows else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PALLAS_TOL)


# --------------------------------------------------------------------------
# the wrappers and the plan


def test_non_cpu_calls_need_the_plan_of_their_arrays():
    """On a device other than the CPU the wrappers of kernels 2 and 3 raise
    without a plan and with a plan of other arrays, before anything else
    runs (a CUDA call reaches the kernel only through this check)."""
    rng = np.random.default_rng(9)
    lay = build_edge_layout(rng.integers(0, 100, 300),
                            rng.integers(0, 100, 300), 128,
                            xe_ids=rng.integers(0, 3, 300), profile=V5E)
    meta = {k: t.to("meta") for k, t in dict(
        lrow_r=lay.lrow_r, bp_r=lay.block_ptr_r, keys=lay.senders_r,
        lrow_s=lay.lrow_s, bp_s=lay.block_ptr_s,
        senders=lay.senders_s).items()}
    x = torch.empty(128, 8, dtype=torch.bfloat16, device="meta")
    m = torch.empty(lay.num_edges_padded, 8, dtype=torch.bfloat16,
                    device="meta")
    for plan, what in ((None, "needs the RowPlan"),
                       (lay.plan_r, "not built from")):
        with pytest.raises(ValueError, match=what):
            sc.gathered_scatter_rows_sorted(
                meta["keys"][None, :], meta["lrow_r"], meta["bp_r"], x,
                num_nodes_padded=128, plan=plan)
    for plan, what in ((None, "needs the RowPlan"),
                       (lay.plan_s, "not built from")):
        with pytest.raises(ValueError, match=what):
            sc.masked_scatter_rows_sorted(
                m, meta["lrow_s"], meta["senders"][None, :], meta["bp_s"],
                x, num_nodes_padded=128, plan=plan)


def test_kernel1_non_cpu_calls_need_the_plan_of_their_arrays():
    """Kernel 1's wrapper, like kernels 2 and 3, raises on a device other
    than the CPU without a plan or with the plan of other arrays, and on
    the CPU runs its plain version whatever plan it is given, counting no
    launch."""
    rng = np.random.default_rng(14)
    lay = build_edge_layout(rng.integers(0, 100, 300),
                            rng.integers(0, 100, 300), 128, profile=V5E)
    m = torch.empty(lay.num_edges_padded, 8, dtype=torch.bfloat16,
                    device="meta")
    lrow, bp = lay.lrow_r.to("meta"), lay.block_ptr_r.to("meta")
    for plan, what in ((None, "needs the RowPlan"),
                       (lay.plan_s, "not built from")):
        with pytest.raises(ValueError, match=what):
            sc.scatter_rows_sorted(m, lrow, bp, num_nodes_padded=128,
                                   plan=plan)
    mc = _bf16(rng.standard_normal((lay.num_edges_padded, 8)))
    args = (mc, lay.lrow_r, lay.block_ptr_r)
    before = dict(sc.launch_counts)
    want = sc.scatter_rows_sorted_ref(*args, num_nodes_padded=128, relu=True)
    for plan in (None, lay.plan_r, lay.plan_s):
        assert torch.equal(sc.scatter_rows_sorted(
            *args, num_nodes_padded=128, relu=True, plan=plan), want)
    assert sc.launch_counts == before


def test_plan_refuses_arrays_changed_or_swapped_after_it_was_built():
    rng = np.random.default_rng(10)
    lay = build_edge_layout(rng.integers(0, 100, 300),
                            rng.integers(0, 100, 300), 128)
    plan = lay.plan_s
    assert plan.built_from("keys", lay.receivers_s[None, :])
    assert not plan.built_from("keys", lay.senders_s[None, :])
    assert not plan.built_from("keys", None)
    assert plan.built_from("xe", None)
    lay.receivers_s[0] = lay.receivers_s[0]       # an in-place write
    assert not plan.built_from("keys", lay.receivers_s)
    with pytest.raises(ValueError):
        sc._check_plan("k", plan, dict(keys=lay.receivers_s), {})
    with pytest.raises(ValueError, match="chunk"):
        row_plan(lay.lrow_r, lay.block_ptr_r, chunk=0)


def test_cpu_calls_run_the_plain_versions_and_ignore_the_plan():
    rng = np.random.default_rng(11)
    lay = build_edge_layout(rng.integers(0, 100, 300),
                            rng.integers(0, 100, 300), 128,
                            xe_ids=rng.integers(0, 3, 300), profile=V5E)
    x = _bf16(rng.standard_normal((128, 8)))
    args = (lay.senders_r[None, :], lay.lrow_r, lay.block_ptr_r, x)
    before = dict(sc.launch_counts)
    want = sc.gathered_scatter_rows_sorted_ref(*args, num_nodes_padded=128,
                                               relu=True)
    for plan in (None, lay.plan_r, lay.plan_s):
        got = sc.gathered_scatter_rows_sorted(*args, num_nodes_padded=128,
                                              relu=True, plan=plan)
        assert torch.equal(got, want)
    dm = _bf16(rng.standard_normal((lay.num_edges_padded, 8)))
    margs = (dm, lay.lrow_s, lay.senders_s[None, :], lay.block_ptr_s, x)
    want = sc.masked_scatter_rows_sorted_ref(*margs, num_nodes_padded=128)
    for plan in (None, lay.plan_s):
        assert torch.equal(sc.masked_scatter_rows_sorted(
            *margs, num_nodes_padded=128, plan=plan), want)
    assert sc.launch_counts == before


def test_column_layout_follows_width_and_alignment():
    """Whole rows read 8 columns a lane at once where D and every row
    array allow it; otherwise pairs; an array not aligned to its element
    pairs raises."""
    x = torch.zeros(256, 768, dtype=torch.bfloat16)
    out = torch.zeros(256, 768)
    assert sc._col_mode(768, [x, out, None]) == 0
    assert sc._col_mode(16, [torch.zeros(4, 16, dtype=torch.bfloat16),
                             torch.zeros(4, 16)]) == 0
    assert sc._col_mode(130, [torch.zeros(4, 130,
                                          dtype=torch.bfloat16)]) == 1
    assert sc._col_mode(12, [torch.zeros(4, 12,
                                         dtype=torch.bfloat16)]) == 1
    # a table row viewed at an offset of 2 bf16 values: only pairs fit
    assert sc._col_mode(64, [x.reshape(-1)[2:2 + 64 * 4]]) == 1
    # an offset of one bf16 value: not even pairs fit
    with pytest.raises(ValueError, match="pairs"):
        sc._col_mode(64, [x.reshape(-1)[1:1 + 64 * 4]])


@pytest.mark.parametrize("variant", sorted(tune.VARIANTS))
def test_tuning_variants_name_macros_their_sources_define(variant):
    """Every -D value of ``tune_row_walk``'s variants overrides a default
    that the kernel source it is built into defines (a misspelt name would
    build the chosen kernel under another label)."""
    for name in tune.KERNELS:
        if not tune._touches(name, tune.VARIANTS[variant]):
            continue
        with open(sc._source(name)) as f:
            text = f.read()
        for header in sc._headers():
            with open(header) as f:
                text += f.read()
        for key in tune.VARIANTS[variant]:
            if key.startswith("ROW_WALK_") or key.startswith(
                    tune._PREFIX[name]):
                assert f"#ifndef {key}\n#define {key} " in text, key


def test_tuning_reads_the_path_instances_registers_from_ptxas():
    log = "\n".join(
        f"ptxas info    : Compiling entry function '_ZN4anon{kernel}I{tmpl}"
        f"EEEvNS_4ArgsE' for 'sm_90a'\n"
        f"ptxas info    : Function properties for x\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes "
        f"spill loads\nptxas info    : Used {regs} registers, used 0 barriers"
        for kernel, tmpl, regs, spill in (
            ("20gathered_rows_kernel", "Li2EfLi8ELi3ELi1ELi8", 64, 12),
            ("20gathered_rows_kernel", "Li1EfLi8ELi3ELi2ELi5", 96, 0),
            ("20gathered_rows_kernel", "Li1EfLi2ELi3ELi4ELi1", 40, 0),
            ("20gathered_rows_kernel", "Li0E13__nv_bfloat16Li8ELi3ELi2ELi5",
             78, 0),
            ("18masked_rows_kernel", "Lb1E13__nv_bfloat16fLi8ELi3ELi1ELi1",
             80, 0)))
    assert tune.path_registers(tune.K2, log) == (
        "xe 64 registers (12 B spilled), t0 96 registers")
    assert tune.path_registers(tune.K3, log) == "typed 80 registers"
