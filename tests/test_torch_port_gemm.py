"""``Linear``'s f32 products on the split-TF32 kernel
(``stemgnn_tpu_torch/ops/split_gemm.py``), on the CPU.

The kernel runs only on the card (``chip_smoke.py`` phase gemm holds it
against the plain version, cuBLAS's f32 product and f64 there).  Here: the
plain version of its arithmetic has the f32 product's error against f64,
and a TF32 control is at least 100x worse; the rule's routes and the FLOP
counters; a recorded forward kept on ``torch.matmul``; the autograd
Function against ``x @ w + b``; ``Linear``'s CPU output and gradients
unchanged; the split-K plan; the benchmark's share reader."""

import numpy as np
import pytest
import torch

from benchmark import common as bench_common
from stemgnn_tpu_torch.nn.layers import Linear
from stemgnn_tpu_torch.ops import scatter
from stemgnn_tpu_torch.ops import split_gemm as sg


def _normalised_error(c, a, b):
    """max, mean of |c - a b| / (|a| |b|), the products in f64."""
    a64, b64 = a.double(), b.double()
    err = (c.double() - a64 @ b64).abs() / (a64.abs() @ b64.abs())
    return float(err.max()), float(err.mean())


def _operands(seed, m, k, n):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(m, k, generator=gen),
            torch.randn(k, n, generator=gen) / k ** 0.5)


# the main path's products cut to CPU size: a forward [rows, 768] x [768,
# 768], a dX against the VQ's 3072-wide projection, a dW reducing over
# rows, and the per-head decoder's 160 outputs
SHAPES = {"fwd": (1024, 768, 768), "dX_3072": (512, 3072, 768),
          "dW_rows": (768, 8192, 256), "decoder_160": (1024, 3072, 160)}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_split_has_the_f32_products_error_and_tf32_does_not(name):
    a, b = _operands(7, *SHAPES[name])
    f32 = _normalised_error(a @ b, a, b)
    split = _normalised_error(sg.split_matmul_ref(a, b), a, b)
    tf32 = _normalised_error(sg.tf32_round(a) @ sg.tf32_round(b), a, b)
    assert split[0] <= 2 * f32[0] and split[1] <= 2 * f32[1], (split, f32)
    assert tf32[0] >= 100 * f32[0] and tf32[1] >= 100 * f32[1], (tf32, f32)


def test_tf32_round_is_cvt_rna():
    one = 1.0
    ulp = 2.0 ** -10                      # TF32's ulp at 1
    vals = torch.tensor([one + ulp / 2, one + ulp / 4, one + 3 * ulp / 4,
                         -(one + ulp / 2), 0.0, -0.0, 3.0e38],
                        dtype=torch.float32)
    got = sg.tf32_round(vals)
    want = torch.tensor([one + ulp, one, one + ulp, -(one + ulp), 0.0, -0.0,
                         got[-1].item()], dtype=torch.float32)
    assert torch.equal(got, want)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    x = torch.randn(10000, generator=torch.Generator().manual_seed(3))
    hi, lo = sg.split(x)
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert rel <= 2.0 ** -22


def _counted(fn):
    before = dict(sg.flop_counts)
    launches = dict(scatter.launch_counts)
    out = fn()
    assert scatter.launch_counts == launches       # no kernel on the CPU
    return out, {k: sg.flop_counts[k] - before[k] for k in before}


@pytest.mark.parametrize("case", ["cpu", "bf16", "few_rows", "narrow",
                                  "ragged_width", "vector"])
def test_rule_routes_and_counts(case):
    rows, d_in, d_out, dtype = sg.ROWS_MIN, 768, 768, torch.float32
    reason = "device"
    if case == "bf16":
        dtype, reason = torch.bfloat16, "dtype"
    elif case == "few_rows":
        rows, reason = sg.ROWS_MIN - 1, "shape"
    elif case == "narrow":
        d_out, reason = sg.WIDTH_MIN - 4, "shape"
    elif case == "ragged_width":
        d_out, reason = 770, "shape"
    x = torch.randn(rows, d_in, dtype=dtype)
    if case == "vector":
        x, rows, reason = x[0], 1, "shape"
    lin = Linear(d_in, d_out, generator=torch.Generator().manual_seed(0))
    assert sg.route(x, lin.w.to(dtype), lin.b.to(dtype)) == reason
    x.requires_grad_(True)
    y, counted = _counted(lambda: lin(x))
    flops = 2 * rows * d_in * d_out
    # the forward, and the dX and dW that autograd will run
    assert counted == {**{k: 0 for k in sg.flop_counts}, reason: 3 * flops}
    with torch.no_grad():
        _, counted = _counted(lambda: lin(x))
    assert counted[reason] == flops
    if case == "cpu":
        assert sg.shape_ok(rows, d_in, d_out)


def test_rule_keeps_the_kernel_for_the_main_path_shapes():
    for rows in (169_344, 70_784, 37_888, 7_078):
        # the SAGE layers and decoders, the VQ's projections
        for d_in, d_out in ((768, 768), (768, 3072), (3072, 768),
                            (1536, 768)):
            assert sg.shape_ok(rows, d_in, d_out), (rows, d_in, d_out)
        # the per-head task decoder and the class heads stay on torch.matmul
        for d_in, d_out in ((3072, 160), (768, 40)):
            assert not sg.shape_ok(rows, d_in, d_out), (rows, d_in, d_out)


@pytest.mark.parametrize("grad", [True, False])
def test_routed_linear_records_its_forward_on_matmul(grad, monkeypatch):
    # on a route the rule accepts: a recorded forward keeps torch.matmul's
    # bits and counts as a training forward; an unrecorded one takes the
    # kernel (its plain version on the CPU)
    monkeypatch.setattr(sg, "route", lambda x, w, b=None: "kernel")
    gen = torch.Generator().manual_seed(2)
    lin = Linear(256, 512, generator=gen)
    x = torch.randn(3, 100, 256, generator=gen)
    with torch.set_grad_enabled(grad):
        y, counted = _counted(lambda: lin(x))
    flops = 2 * 300 * 256 * 512
    want = x @ lin.w + lin.b
    if grad:
        assert torch.equal(y, want)
        assert y.requires_grad
        assert counted["training_forward"] == flops
    else:
        assert torch.equal(y, sg.split_matmul_ref(
            x.reshape(-1, 256), lin.w, lin.b).reshape(3, 100, 512))
        assert sum(counted.values()) == 0  # the kernel counts its launches
    assert y.shape == (3, 100, 512)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("x_grad", [True, False])
def test_split_linear_function_matches_x_at_w_plus_b(bias, x_grad):
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(300, 64, generator=gen, requires_grad=x_grad)
    w = (torch.randn(64, 96, generator=gen) / 8).requires_grad_(True)
    b = torch.randn(96, generator=gen).requires_grad_(True) if bias else None
    up = torch.randn(300, 96, generator=gen)
    got = sg.SplitLinear.apply(x, w, b)
    grads_got = torch.autograd.grad((got * up).sum(),
                                    [t for t in (x, w, b) if t is not None
                                     and t.requires_grad])
    want = x @ w if b is None else x @ w + b
    grads_want = torch.autograd.grad((want * up).sum(),
                                     [t for t in (x, w, b) if t is not None
                                      and t.requires_grad])
    assert torch.equal(got, want)          # the forward is torch.matmul's
    # the gradients, f32 against f32 in another order: a few ulps of the
    # sums, which reach ~200 in the 300-row reductions of unit normals
    for g, h in zip(grads_got, grads_want):
        torch.testing.assert_close(g, h, rtol=1e-5, atol=1e-4)


def test_linear_on_the_cpu_is_unchanged():
    gen = torch.Generator().manual_seed(5)
    lin = Linear(768, 256, generator=gen)
    x = torch.randn(sg.ROWS_MIN, 768, generator=gen, requires_grad=True)
    up = torch.randn(sg.ROWS_MIN, 256, generator=gen)
    y = lin(x)
    (y * up).sum().backward()
    x2 = x.detach().clone().requires_grad_(True)
    w2 = lin.w.detach().clone().requires_grad_(True)
    b2 = lin.b.detach().clone().requires_grad_(True)
    y2 = x2 @ w2 + b2
    (y2 * up).sum().backward()
    assert torch.equal(y, y2)
    assert torch.equal(x.grad, x2.grad)
    assert torch.equal(lin.w.grad, w2.grad)
    assert torch.equal(lin.b.grad, b2.grad)
    xb = x.detach().to(torch.bfloat16)
    assert torch.equal(lin(xb), xb @ lin.w.to(torch.bfloat16)
                       + lin.b.to(torch.bfloat16))


def test_split_matmul_refuses_other_devices():
    a = torch.empty(8, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        sg.matmul(a, a)
    x = torch.empty(sg.ROWS_MIN, sg.WIDTH_MIN, device="meta")
    w = torch.empty(sg.WIDTH_MIN, sg.WIDTH_MIN, device="meta")
    assert sg.route(x, w) == "device"


@pytest.mark.parametrize("m,n,k", [(768, 768, 169_344), (768, 3072, 169_344),
                                   (768, 768, 37_888), (64, 768, 8192),
                                   (12, 8, 9000), (768, 768, 1000)])
def test_split_k_plan(m, n, k, monkeypatch):
    monkeypatch.setitem(sg._sm_count, "card", 132)
    splits, kps = sg._splits(m, n, k, "card")
    assert 1 <= splits <= sg.MAX_SPLITS and kps % 32 == 0
    assert (splits - 1) * kps < k <= splits * kps
    if splits > 1:
        assert kps >= sg.SPLIT_ROWS_MIN - 32
        assert splits * m * n * 4 <= sg.SPLIT_BYTES_MAX
    tiles = -(-m // 128) * -(-n // 128)
    if tiles >= 132 * 8:
        assert splits == 1


@pytest.mark.parametrize("metric", ["split_gemm_share.pretrain",
                                    "split_gemm_share.finetune"])
def test_share_reader(metric, monkeypatch):
    reader = bench_common.metric_reader(metric)
    monkeypatch.setattr(sg, "flop_counts",
                        {"kernel": 60, "training_forward": 30, "device": 0,
                         "dtype": 4, "shape": 6})
    assert reader.read({"units": 3}) == pytest.approx(60.0)
    assert reader.read({}) is None
    monkeypatch.setattr(sg, "flop_counts",
                        {k: 0 for k in sg.flop_counts})
    assert reader.read({"units": 3}) is None


def test_split_error_grows_like_the_f32_products_over_long_reductions():
    # dW's reduction over many rows: the split and f32 stay together as
    # the reduction grows, where TF32 stays ~1,000x above both
    rng = np.random.default_rng(0)
    for k in (1024, 16384):
        a = torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((k, 64)).astype(np.float32))
        f32 = _normalised_error(a @ b, a, b)
        split = _normalised_error(sg.split_matmul_ref(a, b), a, b)
        assert split[1] <= 2 * f32[1], (k, split, f32)
