"""f32 matrix products of :class:`~stemgnn_tpu_torch.nn.layers.Linear` on the
tensor cores at f32 accuracy, and their plain PyTorch version.

``csrc/split_tf32_gemm.cu`` (its note says what it replaces, what bounds it
and how it is built) computes ``C = A B (+ bias)`` in f32 from a split of
each f32 operand into two TF32 parts, ``hi = tf32(a)`` and ``lo = tf32(a -
hi)``: ``hi.hi + hi.lo + lo.hi`` summed in f32 holds the f32 product's
error against an f64 product, where plain TF32's is ~1,000x larger
(``tests/test_torch_port_gemm.py``).  :func:`split_matmul_ref` is that
arithmetic in plain PyTorch.

:func:`linear` is ``Linear``'s product, ``x @ w (+ b)``.  Where
:func:`route` accepts the call (a CUDA tensor, f32 activations and weight,
and a shape the kernel beats cuBLAS's f32 product on), a forward that
autograd does not record (evaluation, the EMA teacher, serving) takes the
kernel, and so do both gradient products of one it records
(:class:`SplitLinear`: ``dX = dY w^T`` and ``dW = x^T dY``).  The forward of
a training step stays on ``torch.matmul``, bit for bit: its outputs decide
the VQ's discrete codes, and near-tie codes flip under any f32 product that
rounds otherwise than cuBLAS's.  That flip moves nothing a user would see
(the split's error against f64 is below cuBLAS's), but the benchmark's
finetune cell compares the first step's gradients with a cuBLAS reference
at a limit that admits about two flips, and the kernel's forward read over
it on 2 of 6 seeds (``PERF.md`` §6).  Everything else keeps
``torch.matmul`` and its own autograd, unchanged: CPU tensors, bf16
activations (already on the tensor cores) and the shapes the rule rejects.
A call the rule accepts launches the kernel or raises.

The shape rule: the activation has at least :data:`ROWS_MIN` rows and
both widths are multiples of 4 (16-byte loads) of at least
:data:`WIDTH_MIN`.  It comes from the times of ``chip_smoke.py`` phase gemm
(H100 80GB HBM3, 700 W; ms of the kernel / of ``torch.matmul`` f32 with
TF32 off, forward + dX + dW of one Linear):

=================  ===============  ===============  ===============
widths             2,048 rows       4,096 rows       8,192 rows
=================  ===============  ===============  ===============
768 -> 768         0.240 / 0.203    0.346 / 0.373    0.482 / 0.665
768 -> 3072        0.592 / 0.666    1.043 / 1.245    1.745 / 2.449
3072 -> 768        0.585 / 0.668    1.026 / 1.184    1.729 / 2.434
3072 -> 160        0.360 / 0.196    0.391 / 0.350    0.577 / 0.690
768 -> 64          0.197 / 0.048    0.210 / 0.054    0.207 / 0.083
128 -> 128         0.177 / 0.043    0.300 / 0.043    0.546 / 0.046
=================  ===============  ===============  ===============

Below 4,096 rows or 256 columns a 128 x 128 tile is mostly idle or the
product is too small to leave cuBLAS's launch and memory costs behind.

Counters: ``scatter.launch_counts["split_tf32_gemm"]`` (launches, beside
the scatter kernels'), and :data:`flop_counts`, the FLOPs of ``Linear``'s
products by route: ``"kernel"``; ``"training_forward"``, the forwards kept
on ``torch.matmul`` above; or the reason they went to ``torch.matmul``
(``"device"``, ``"dtype"``, ``"shape"``).  A kernel launch adds its own
FLOPs; a call routed to ``torch.matmul`` adds its forward and the gradient
products autograd will run for it.
"""

from __future__ import annotations

import math

import torch

from stemgnn_tpu_torch.ops import scatter

KERNEL = "split_tf32_gemm"

ROWS_MIN = 4096
WIDTH_MIN = 256
_BM = _BN = 128          # the kernel's block tile
_BK = 32
_MAX_TILE_ROWS = 65535   # the grid's y dimension
# split-K: a split keeps at least this many rows of the reduction, and the
# f32 partials of all splits at most this many bytes
SPLIT_ROWS_MIN = 2048
SPLIT_BYTES_MAX = 40 << 20
MAX_SPLITS = 16

flop_counts = {"kernel": 0, "training_forward": 0, "device": 0, "dtype": 0,
               "shape": 0}

_sm_count: dict = {}


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 explicit mantissa bits), to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32`` rounds them."""
    bits = a.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(a: torch.Tensor):
    """``(hi, lo)``: ``hi = tf32(a)``, ``lo = tf32(a - hi)``."""
    hi = tf32_round(a)
    return hi, tf32_round(a.float() - hi)


def split_matmul_ref(a, b, bias=None):
    """The kernel's arithmetic in plain PyTorch: ``a @ b`` from the TF32
    parts, the two small products first, summed in f32 (+ ``bias``)."""
    ah, al = split(a)
    bh, bl = split(b)
    out = (al @ bh + ah @ bl) + ah @ bh
    return out if bias is None else out + bias


def _aligned(t) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def shape_ok(rows: int, d_in: int, d_out: int) -> bool:
    """The shape rule (module docstring): enough rows, both widths
    multiples of 4 and wide enough, and rows the kernel's grid holds."""
    return (rows >= ROWS_MIN and min(d_in, d_out) >= WIDTH_MIN
            and d_in % 4 == 0 and d_out % 4 == 0
            and -(-rows // _BM) <= _MAX_TILE_ROWS)


def route(x, w, b=None) -> str:
    """``"kernel"`` where ``x @ w (+ b)`` may take the split kernel
    (:func:`linear` says which of its products do), else the first reason
    it keeps ``torch.matmul``: ``"dtype"``
    (not f32), ``"shape"`` (:func:`shape_ok`, or operands the kernel
    cannot read in place) or ``"device"`` (not a CUDA tensor)."""
    if x.dtype != torch.float32 or w.dtype != torch.float32 or (
            b is not None and b.dtype != torch.float32):
        return "dtype"
    if x.dim() < 2 or w.dim() != 2 or not shape_ok(
            x.numel() // max(w.shape[0], 1), *w.shape):
        return "shape"
    if x.device.type != "cuda" or w.device != x.device:
        return "device"
    if not (_aligned(x) and _aligned(w)
            and (b is None or b.is_contiguous())):
        return "shape"
    return "kernel"


def _grads_expected(x, w, b) -> int:
    if not torch.is_grad_enabled():
        return 0
    return int(x.requires_grad) + int(w.requires_grad)


def _recorded(x, w, b) -> bool:
    """Whether autograd records this product (a training forward)."""
    return torch.is_grad_enabled() and (
        x.requires_grad or w.requires_grad
        or (b is not None and b.requires_grad))


def linear(x, w, b=None):
    """``x @ w (+ b)``: where :func:`route` accepts the call, the split
    kernel for a forward that autograd does not record and for both
    gradients of one it records, whose forward stays on ``torch.matmul``
    (module docstring); else ``torch.matmul`` as before."""
    why = route(x, w, b)
    flops = 2 * (x.numel() // max(w.shape[0], 1)) * w.shape[0] * w.shape[1]
    if why != "kernel":
        flop_counts[why] += flops * (1 + _grads_expected(x, w, b))
        y = x @ w
        return y if b is None else y + b
    x2 = x.reshape(-1, w.shape[0])
    if _recorded(x, w, b):
        flop_counts["training_forward"] += flops
        y = SplitLinear.apply(x2, w, b)
    else:
        y = matmul(x2, w, bias=b)
    return y.reshape(*x.shape[:-1], w.shape[1])


class SplitLinear(torch.autograd.Function):
    """``x2 @ w (+ b)`` for a 2-D ``x2`` through ``torch.matmul``, its bits
    unchanged; saves ``x2`` and ``w``, as ``x2 @ w`` does, and runs both
    gradient products on the kernel (the plain split on CPU tensors)."""

    @staticmethod
    def forward(ctx, x2, w, b):
        ctx.save_for_backward(x2, w)
        ctx.has_bias = b is not None
        y = x2 @ w
        return y if b is None else y + b

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = matmul(dy, w, b_transposed=True)
        if ctx.needs_input_grad[1]:
            dw = matmul(x2, dy, a_transposed=True)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy.sum(0)
        return dx, dw, db


def _splits(m: int, n: int, k: int, device) -> tuple:
    """``(splits, rows a split)`` of the reduction: the count of up to
    :data:`MAX_SPLITS` that fills the SMs' last wave best, with at least
    :data:`SPLIT_ROWS_MIN` rows a split and the partials under
    :data:`SPLIT_BYTES_MAX`."""
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    sms = _sm_count[device]
    tiles = -(-m // _BM) * -(-n // _BN)
    top = max(1, min(MAX_SPLITS, k // SPLIT_ROWS_MIN,
                     SPLIT_BYTES_MAX // (4 * m * n)))
    best, best_fill = 1, 0.0
    for s in range(1, top + 1):
        blocks = tiles * s
        fill = blocks / (math.ceil(blocks / sms) * sms) - 0.01 * (s - 1)
        if fill > best_fill:
            best, best_fill = s, fill
    kps = -(-(-(-k // best)) // _BK) * _BK
    return -(-k // kps), kps


def matmul(a, b, *, a_transposed: bool = False, b_transposed: bool = False,
           bias=None):
    """``op(a) @ op(b) (+ bias)`` on the split kernel, ``op`` the transpose
    where asked (``a`` and ``b`` contiguous 2-D f32 whose rows are multiples
    of 4 floats, for 16-byte loads; any number of rows); CPU tensors run
    :func:`split_matmul_ref`."""
    opa = a.t() if a_transposed else a
    opb = b.t() if b_transposed else b
    m, k = opa.shape
    n = opb.shape[1]
    if a.device.type == "cpu":
        return split_matmul_ref(opa, opb, bias)
    if a.device.type != "cuda":
        raise ValueError(f"split_tf32_gemm runs on cpu or cuda tensors, got "
                         f"{a.device}")
    for name, t in (("a", a), ("b", b), ("bias", bias)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != a.device:
            raise ValueError(f"{name} must be f32 on {a.device}, got "
                             f"{t.dtype} on {t.device}")
        if not _aligned(t):
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if (a.shape[1] % 4 or b.shape[1] % 4 or n % 4 or opb.shape[0] != k
            or -(-m // _BM) > _MAX_TILE_ROWS):
        raise ValueError(f"split_tf32_gemm needs [M, K] @ [K, N] with N and "
                         f"both operands' rows multiples of 4 floats, got "
                         f"{tuple(opa.shape)} @ {tuple(opb.shape)}")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    splits, kps = _splits(m, n, k, a.device)
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=a.device) if splits > 1 else None)
    lib = scatter.load_library(KERNEL)
    with torch.cuda.device(a.device):
        err = lib.split_tf32_gemm_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if partial is None else partial.data_ptr(),
            m, n, k, a.shape[1], b.shape[1], n, int(not a_transposed),
            int(b_transposed), splits, kps,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed: CUDA error {err}")
    scatter.launch_counts[KERNEL] += 1
    flop_counts["kernel"] += 2 * m * n * k
    return out
