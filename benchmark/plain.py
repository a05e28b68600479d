"""Plain PyTorch layers of the benchmark's references: the SAGE mean
aggregation, the encoder, the cosine multi-head VQ, AdamW with the global
clip and the cosine schedule, and a frozen copy of the pair-hash edge
dropout.

Written from the published model (STEM-GNN's ``MySAGEConv``, its
``VectorQuantize`` and ``PretrainModel``) and the precision the
configuration states, with no kernel, layout or hub block, and importing
nothing of the program.  The one departure from plain float32 is the one
the configurations state: a message ``relu(x_j + t0)`` is rounded to
bfloat16 before it is summed in float32, and so is the per-edge gradient
``g_i / deg_i`` in the backward (``fused_bf16_messages``, the default of the
program's configuration).  Dense products run in float32; the caller
decides whether TF32 is allowed (:func:`matmul_precision`).

Parameters are plain dicts of tensors, named as the program names its
modules' parameters, so the two can be compared leaf by leaf.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

# edges a block: an [E_block, D] f32 slab is 0.8 GB at D = 768
EDGE_BLOCK = 1 << 18
BN_EPS = 1e-5
_M32 = 0xFFFFFFFF


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Dense float32 products in full float32 (``tf32=False``, the
    reference) or in TF32 (the control one precision below)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ---- the pair hash: one keep decision per undirected node pair ----------

def _mul32(h, c: int):
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def pair_hash_bits(seed, a, b):
    """A 32-bit word (int64 in [0, 2^32)) per (seed, {a, b}): murmur-style
    mixing of min(a, b), max(a, b) and the seed."""
    lo = torch.minimum(a, b).to(torch.int64) & _M32
    hi = torch.maximum(a, b).to(torch.int64) & _M32
    s = torch.as_tensor(seed, device=a.device).to(torch.int64) & _M32
    h = _mul32(lo, 0x85EBCA6B) ^ _mul32(hi, 0xC2B2AE35)
    h = h ^ _mul32(s, 0x9E3779B9)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def keep_threshold(p: float) -> int:
    """The least word ``h`` with ``f32(h) / 2^32 >= f32(p)``."""
    t = np.float32(p) * np.float32(4294967296.0)
    lo, hi = 0, 1 << 32
    while lo < hi:
        mid = (lo + hi) // 2
        if np.float32(np.int64(mid)) >= t:
            hi = mid
        else:
            lo = mid + 1
    return lo


def pair_keep(seed, a, b, p: float):
    """Whether the pair {a, b} survives the dropout at rate ``p``."""
    return pair_hash_bits(seed, a, b) >= keep_threshold(float(p))


# ---- aggregation --------------------------------------------------------

def inv_in_degree(receivers, valid, n: int):
    """[n, 1] f32 ``1 / max(#valid in-edges, 1)``."""
    deg = torch.zeros(n, dtype=torch.float32, device=receivers.device)
    deg.index_add_(0, receivers, valid.float())
    return (1.0 / deg.clamp(min=1.0))[:, None]


class SageMean(torch.autograd.Function):
    """``out[i] = inv_deg[i] * sum_{valid (j, i)} bf16(relu(bf16(x_j) +
    bf16(t0)))``, summed in f32 one block of edges at a time; the backward
    ``dx[j] = 1[bf16(x_j) + bf16(t0) > 0] * sum_{valid (j, i)}
    bf16(g_i * inv_deg[i])``."""

    @staticmethod
    def forward(ctx, x, senders, receivers, valid, t0, inv_deg):
        xb, tb = x.to(torch.bfloat16), t0.to(torch.bfloat16)
        out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for i in range(0, senders.shape[0], EDGE_BLOCK):
            sl = slice(i, i + EDGE_BLOCK)
            m = torch.relu(xb.index_select(0, senders[sl]) + tb).float()
            m.mul_(valid[sl, None])
            out.index_add_(0, receivers[sl], m)
        ctx.save_for_backward(x, senders, receivers, valid, t0, inv_deg)
        return out * inv_deg

    @staticmethod
    def backward(ctx, g):
        x, senders, receivers, valid, t0, inv_deg = ctx.saved_tensors
        gp = (g.float() * inv_deg).to(torch.bfloat16).float()
        acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for i in range(0, senders.shape[0], EDGE_BLOCK):
            sl = slice(i, i + EDGE_BLOCK)
            m = gp.index_select(0, receivers[sl])
            m.mul_(valid[sl, None])
            acc.index_add_(0, senders[sl], m)
        gate = (x.to(torch.bfloat16) + t0.to(torch.bfloat16)) > 0
        dx = torch.where(gate, acc, torch.zeros((), device=acc.device))
        return dx.to(x.dtype), None, None, None, None, None


def linear(p: dict, name: str, x):
    y = x @ p[name + ".w"]
    b = p.get(name + ".b")
    return y if b is None else y + b


def batch_norm(x, mask, scale, bias):
    """Batch statistics over the ``mask`` rows (biased variance)."""
    m = mask.float()[:, None]
    n = m.sum().clamp(min=1.0)
    mean = (x * m).sum(0) / n
    var = (((x - mean) ** 2) * m).sum(0) / n
    return (x - mean) * torch.rsqrt(var + BN_EPS) * scale + bias


def encoder(p: dict, prefix: str, x, g: dict, valid, inv_deg, *,
            num_layers: int, batch_norm_on: bool, keep_u=None,
            dropout: float = 0.0):
    """The SAGE stack: ``lin_l(mean_j relu(x_j + t0)) + lin_r(x)`` a layer,
    BatchNorm over the node mask, relu and inverted dropout between layers;
    ``keep_u`` holds the dropout's uniform draws, one [N, D] tensor a
    hidden layer (None: no dropout, evaluation).  ``g["edge_order"]``, when
    given, sums the edges in that order (the same sums, rounded in
    another order)."""
    senders, receivers = g["senders"], g["receivers"]
    order = g.get("edge_order")
    if order is not None:
        senders, receivers, valid = (senders[order], receivers[order],
                                     valid[order])
    z = x
    for i in range(num_layers):
        lp = f"{prefix}layers.{i}."
        agg = SageMean.apply(z, senders, receivers, valid, g["t0"], inv_deg)
        z = linear(p, lp + "lin_l", agg) + linear(p, lp + "lin_r", z)
        if batch_norm_on:
            z = batch_norm(z, g["node_mask"], p[f"{prefix}norms.{i}.scale"],
                           p[f"{prefix}norms.{i}.bias"])
        if i < num_layers - 1:
            z = torch.relu(z)
            if keep_u is not None:
                keep = 1.0 - dropout
                z = torch.where(keep_u[i] < keep, z / keep,
                                torch.zeros((), device=z.device))
    return z


def l2norm(t, eps: float = 1e-12):
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp(
        min=eps)


def quantize(p: dict, z, *, heads: int, code_dim: int, flip: int = 0,
             rows=None):
    """The cosine multi-head VQ's forward: ``(xh [H, N, d], q [H, N, d],
    scores [H, N, C])``, ``q`` the nearest code of each head.  ``flip``
    gives the ``flip`` (row, head) pairs of the ``rows`` mask nearest to a
    tie their second-best code instead: what a rounding difference does to
    a near-tie."""
    n = z.shape[0]
    xp = linear(p, "vq.project_in", z)
    xh = l2norm(xp.reshape(n, heads, code_dim).permute(1, 0, 2))
    embed = p["vq.embed"]
    scores = torch.einsum("hnd,hcd->hnc", xh, embed)
    ind = scores.argmax(-1)
    if flip:
        with torch.no_grad():
            top2 = scores.topk(2, dim=-1)
            gap = top2.values[..., 0] - top2.values[..., 1]
            if rows is not None:
                gap = torch.where(rows[None, :], gap, torch.full(
                    (), float("inf"), device=gap.device))
            pick = gap.flatten().topk(flip, largest=False).indices
            ind = ind.flatten().clone()
            ind[pick] = top2.indices[..., 1].flatten()[pick]
            ind = ind.view(scores.shape[:2])
    q = torch.gather(embed, 1, ind[:, :, None].expand(-1, -1, code_dim))
    return xh, q, scores


def from_heads(q):
    h, n, d = q.shape
    return q.permute(1, 0, 2).reshape(n, h * d)


def orthogonal_loss(embed, ids):
    e = l2norm(embed[:, ids])
    h, n = e.shape[0], e.shape[1]
    sim = torch.einsum("hid,hjd->hij", e, e)
    return (sim ** 2).sum() / (h * n ** 2) - 1.0 / n


def top_degree_rows(receivers, valid, n: int, k: int = 64):
    """[n] bool: the ``k`` nodes with the most valid in-edges."""
    deg = torch.zeros(n, device=receivers.device).index_add_(
        0, receivers, valid.float())
    rows = torch.zeros(n, dtype=torch.bool, device=receivers.device)
    rows[deg.topk(k).indices] = True
    return rows


def flip_rows(fault, data: dict, rows):
    """``(count, rows)`` of a near-tie fault: ``flip<k>`` flips the ``k``
    (row, head) pairs of ``rows`` nearest to a tie, ``hubflip<k>`` those of
    the 64 nodes of the largest in-degree among ``rows``."""
    if not fault or "flip" not in fault:
        return 0, rows
    if fault.startswith("hubflip"):
        hubs = top_degree_rows(data["receivers"], data["edge_valid"],
                               data["x"].shape[0])
        return int(fault[len("hubflip"):]), rows & hubs
    return int(fault[len("flip"):]), rows


def code_margin(scores):
    """[N] the smallest gap, over the heads, between a row's best and
    second-best code score."""
    top2 = scores.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).min(0).values


# ---- the optimizer -------------------------------------------------------

def clip_global(grads: dict, max_norm: float) -> dict:
    """optax's ``clip_by_global_norm``: ``g / norm * max_norm`` once the
    global norm reaches ``max_norm``."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    if float(norm) < max_norm:
        return grads
    return {k: (g.double() / norm * max_norm).float()
            for k, g in grads.items()}


def cosine_factor(step: int, epochs: int) -> float:
    """``(1 + cos(min(step, E) * pi / E)) / 2``."""
    return (1.0 + math.cos(min(step, epochs) * math.pi / epochs)) * 0.5


class AdamW:
    """Decoupled weight decay, then Adam's bias-corrected step (b1 0.9, b2
    0.999), on a dict of f32 tensors."""

    def __init__(self, params: dict, lr: float, weight_decay: float,
                 eps: float = 1e-8, b1: float = 0.9, b2: float = 0.999):
        self.lr, self.wd, self.eps, self.b1, self.b2 = (lr, weight_decay,
                                                        eps, b1, b2)
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr_factor: float = 1.0):
        self.t += 1
        lr = self.lr * lr_factor
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            p = p * (1.0 - lr * self.wd)
            denom = (self.v[k] / c2).sqrt() + self.eps
            out[k] = p - lr * (self.m[k] / c1) / denom
        return out


def dropout_draws(state, shape, count: int, device):
    """The ``count`` uniform [N, D] draws that a generator in ``state``
    makes next: the program's inverted dropout draws them in this order."""
    gen = torch.Generator(device=device)
    gen.set_state(state)
    return [torch.rand(shape, generator=gen, device=device)
            for _ in range(count)]
