"""Layer-wise streaming inference for large graphs (counterpart of
``stemgnn_tpu/train/infer.py``: the block steps :48-142, ``_stream_*``
:149-255, ``layerwise_encode`` :258-373, ``chunked_head_probs`` and
``layerwise_eval_predict`` :376-430).

The reference evaluates node and link models with full-neighbourhood
loaders (STEM-GNN/utils/loader.py:10-45).  Layer-wise inference is the same
math as a full-graph eval-mode forward: layer l's embeddings for every node
from the layer-(l-1) table, with the edge list streamed through blocks of
``edge_block`` edges (a gather and an ``index_add_`` a block), so device
memory stays O(N*D + edge_block*D) instead of the O(E*D) of materialized
messages.  No aggregation kernel runs here.  Sums differ from the
full-graph forward only in their order.

Every backbone of ``nn/encoder.py``: sage (with and without the per-edge-
type table), the MoE-SAGE layer (the reverse mean over the out-edges, the
router's softmax, the experts applied one at a time so that the [N, K, D]
expert tensor is never built), gcn (edge weights from the host's degree
count), gin (a streamed sum) and gat (two streamed passes: the running
per-receiver max of the attention logits, then the exp-sum and the
weighted message sum, an online segment softmax).
"""

from __future__ import annotations

import numpy as np
import torch

from stemgnn_tpu_torch.core.config import FinetuneConfig
from stemgnn_tpu_torch.core.graph import host_to_device, round_up
from stemgnn_tpu_torch.models.task import task_logits


def _blocks(edges: int, block: int) -> int:
    return max(1, -(-edges // block))


def _pad_edges(senders, receivers, edge_valid, edge_block, extra=None):
    """Edge arrays padded to a whole number of blocks (padded edges
    invalid); returns (number of blocks, arrays)."""
    n_blk = _blocks(senders.shape[0], edge_block)
    e_pad = n_blk * edge_block

    def pad(a, fill=0):
        out = np.full(e_pad, fill, dtype=a.dtype)
        out[:a.shape[0]] = a
        return out
    arrays = [pad(senders), pad(receivers),
              pad(edge_valid.astype(np.bool_), fill=False)]
    if extra is not None:
        arrays.append(pad(extra))
    return n_blk, arrays


class _EdgeBlocks:
    """The edge list on the device in blocks of ``edge_block`` edges:
    iterating gives ``(s, r, valid, extra)`` a block, ids clamped into the
    node range (an invalid edge carries a zero message, so its ids may
    point at any row)."""

    def __init__(self, senders, receivers, edge_valid, edge_block, n_pad,
                 dev, extra=None):
        self.n_blk, arrays = _pad_edges(senders, receivers, edge_valid,
                                        edge_block, extra=extra)
        self.block = edge_block
        s_p, r_p, v_p = arrays[:3]
        self.s = host_to_device(np.clip(s_p, 0, n_pad - 1).astype(np.int64),
                                dev)
        self.r = host_to_device(np.clip(r_p, 0, n_pad - 1).astype(np.int64),
                                dev)
        self.v = host_to_device(v_p, dev)
        self.extra = (None if extra is None
                      else host_to_device(arrays[3], dev))

    def __iter__(self):
        for b in range(self.n_blk):
            sl = slice(b * self.block, (b + 1) * self.block)
            yield (self.s[sl], self.r[sl], self.v[sl],
                   None if self.extra is None else self.extra[sl])


def _stream_aggregate(h, blocks: _EdgeBlocks, table=None, reverse=False):
    """The SUM table [N_pad, D] over the whole edge list (valid edges
    only), one block at a time; callers divide by the degree.  Forward:
    ``relu(h[s] + T[xe])`` at each receiver (``table`` None adds nothing;
    ``blocks.extra`` holds the type ids).  ``reverse``: the MoE layer's
    ``h[r]`` at each sender, no relu."""
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    acc = torch.zeros_like(h)
    for s, r, v, xe in blocks:
        if reverse:
            acc.index_add_(0, s, torch.where(v[:, None],
                                             h.index_select(0, r), zero))
            continue
        msgs = h.index_select(0, s)
        if table is not None:
            ids = (torch.zeros_like(s) if xe is None
                   else xe.long().clamp(0, table.shape[0] - 1))
            msgs = msgs + table.index_select(0, ids)
        acc.index_add_(0, r, torch.where(v[:, None], torch.relu(msgs),
                                         zero))
    return acc


def _stream_weighted_sum(h, blocks: _EdgeBlocks):
    """``sum_(s->r) w h[s]`` at each receiver, ``w`` the blocks' per-edge
    weights (``extra``; 1 when None): gcn's normalized and gin's plain
    sums."""
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    acc = torch.zeros_like(h)
    for s, r, v, w in blocks:
        msgs = h.index_select(0, s)
        if w is not None:
            msgs = msgs * w[:, None]
        acc.index_add_(0, r, torch.where(v[:, None], msgs, zero))
    return acc


def _stream_gat_attention(h, a_src, a_dst, blocks: _EdgeBlocks,
                          negative_slope: float):
    """Online segment softmax and weighted message sum (gat): pass A the
    running per-receiver max of the attention logits, pass B the exp-sum
    denominator and the exp-weighted messages; ``segment_softmax`` then a
    weighted ``segment_sum`` up to the order of the sums."""
    lrelu = torch.nn.functional.leaky_relu
    n_pad = h.shape[0]
    seg_max = torch.full((n_pad,), -torch.inf, device=h.device)
    for s, r, v, _ in blocks:
        e = lrelu(a_src[s] + a_dst[r], negative_slope)
        e = torch.where(v, e, torch.full((), -torch.inf, device=h.device))
        seg_max = seg_max.scatter_reduce(0, r, e, reduce="amax",
                                         include_self=True)
    # receivers with no in-edges: shift by 0 (segment_softmax)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros((), device=h.device))
    denom = torch.zeros(n_pad, device=h.device)
    msg = torch.zeros_like(h)
    for s, r, v, _ in blocks:
        e = lrelu(a_src[s] + a_dst[r], negative_slope)
        exp_e = torch.where(v, torch.exp(e - seg_max[r]),
                            torch.zeros((), device=h.device))
        denom.index_add_(0, r, exp_e)
        msg.index_add_(0, r, h.index_select(0, s) * exp_e[:, None])
    return msg / torch.clamp(denom, min=1e-16)[:, None]


@torch.no_grad()
def layerwise_encode(encoder, node_feat_table, senders, receivers, xe=None,
                     edge_table=None, *, num_nodes=None,
                     edge_block: int = 262_144, device="cpu"):
    """Eval-mode forward of ``encoder`` (an ``nn.encoder.Encoder``), one
    layer at a time over edge blocks.

    Host numpy arguments (real edges only): ``node_feat_table`` [N, D]
    input features, ``edge_table`` [T, D] per-edge-type features picked by
    ``xe`` (read by the sage layers).  Returns ``(z [N_pad, hidden] on
    device, node_mask [N_pad])`` with ``N_pad`` the node count rounded up
    to 128."""
    cfg = encoder.cfg
    device = torch.device(device)
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    n = int(num_nodes if num_nodes is not None
            else np.asarray(node_feat_table).shape[0])
    n_pad = round_up(n, 128)
    edge_valid = np.ones(senders.shape[0], np.bool_)

    feat = np.asarray(node_feat_table, np.float32)
    h = torch.zeros(n_pad, feat.shape[1], device=device)
    h[:n] = host_to_device(feat[:n], device)
    node_mask = torch.arange(n_pad, device=device) < n
    t_dev = None if edge_table is None else host_to_device(
        np.asarray(edge_table, np.float32), device)
    in_cnt = np.bincount(receivers, minlength=n_pad).astype(np.float32)

    def col(a):
        return host_to_device(a.astype(np.float32), device)[:, None]
    in_deg = col(np.maximum(in_cnt, 1))
    out_deg = col(np.maximum(np.bincount(senders, minlength=n_pad), 1))
    blocks = _EdgeBlocks(senders, receivers, edge_valid, edge_block, n_pad,
                         device, extra=None if xe is None
                         else np.asarray(xe, np.int32))
    plain_blocks = blocks if xe is None else _EdgeBlocks(
        senders, receivers, edge_valid, edge_block, n_pad, device)
    if cfg.backbone == "gcn":
        # symmetric normalization, fixed across layers: the full path's
        # valid in-degree + the implicit self-loop (convs.py:89-102)
        inv_sqrt = 1.0 / np.sqrt(in_cnt + 1.0)
        gcn_blocks = _EdgeBlocks(
            senders, receivers, edge_valid, edge_block, n_pad, device,
            extra=(inv_sqrt[senders] * inv_sqrt[receivers]).astype(
                np.float32))
        self_w = col(inv_sqrt ** 2)

    was_training = encoder.training
    encoder.eval()
    j = 0
    for i, layer in enumerate(encoder.layers):
        if encoder.flags[i]:
            # mean of h over each node's out-edges, the router's softmax,
            # the experts one at a time, the residual where in = out
            agg = _stream_aggregate(h, plain_blocks, reverse=True) / out_deg
            combined = torch.cat([agg, h], dim=-1)
            weights, _ = encoder.route(j, h)
            w = layer.weights
            z = torch.zeros(n_pad, w.shape[-1], device=device)
            for k in range(w.shape[0]):
                z += weights[:, k:k + 1] * (combined @ w[k])
            if h.shape[-1] == z.shape[-1]:
                z += h
            j += 1
        elif cfg.backbone == "sage":
            # mean_j relu(h_j + T[xe]) -> lin_l, plus lin_r(h)
            sums = _stream_aggregate(h, blocks, t_dev)
            z = layer.lin_l(sums / in_deg) + layer.lin_r(h)
        elif cfg.backbone == "gcn":
            h_lin = layer.lin(h)
            z = (_stream_weighted_sum(h_lin, gcn_blocks) + h_lin * self_w
                 + layer.bias)
        elif cfg.backbone == "gin":
            agg = _stream_weighted_sum(h, plain_blocks)
            z = layer.lin((1.0 + layer.eps) * h + agg)
        else:
            h_lin = layer.lin(h)
            z = _stream_gat_attention(
                h_lin, h_lin.mv(layer.att_src), h_lin.mv(layer.att_dst),
                plain_blocks, layer.negative_slope) + layer.bias
        if cfg.normalize != "none":
            z = encoder.norms[i](z, mask=node_mask)
        if i < cfg.num_layers - 1:
            z = encoder._act(z)
        h = z
    encoder.train(was_training)
    return h, node_mask


@torch.no_grad()
def chunked_head_probs(model, cfg: FinetuneConfig, z, mask, *,
                       node_chunk: int = 65_536) -> np.ndarray:
    """Head-mean softmax class probabilities [rows, C] (numpy), the VQ and
    the decoder applied ``node_chunk`` rows at a time."""
    was_training = model.training
    model.eval()
    outs = []
    for b in range(_blocks(z.shape[0], node_chunk)):
        sl = slice(b * node_chunk, (b + 1) * node_chunk)
        logits, _ = task_logits(model, cfg, z[sl], mask=mask[sl])
        outs.append(torch.softmax(logits.mean(1), dim=-1).cpu().numpy())
    model.train(was_training)
    return np.concatenate(outs, axis=0)


def layerwise_eval_predict(model, cfg: FinetuneConfig, ds, task_kind: str,
                           pad_items: int, *, edge_block: int = 262_144,
                           node_chunk: int = 65_536,
                           device="cpu") -> np.ndarray:
    """The full evaluation's predictions [pad_items, C] (numpy) through
    layer-wise inference.  Node task: per node.  Link task: the midpoints
    ``(z_u + z_v) / 2`` of the dataset's edges (task/link.py:7-8)."""
    device = torch.device(device)
    senders = np.asarray(ds.edge_index[0])
    receivers = np.asarray(ds.edge_index[1])
    z, node_mask = layerwise_encode(
        model.encoder, ds.node_features(), senders, receivers,
        xe=None if ds.xe is None else np.asarray(ds.xe),
        edge_table=(None if ds.edge_text_feat is None
                    else np.asarray(ds.edge_text_feat)),
        num_nodes=ds.num_nodes, edge_block=edge_block, device=device)
    if task_kind == "link":
        e = ds.num_edges
        u = host_to_device(senders[:e].astype(np.int64), device)
        v = host_to_device(receivers[:e].astype(np.int64), device)
        z = (z.index_select(0, u) + z.index_select(0, v)) / 2.0
        mask = torch.ones(e, dtype=torch.bool, device=device)
    else:
        mask = node_mask
    probs = chunked_head_probs(model, cfg, z, mask, node_chunk=node_chunk)
    out = np.zeros((pad_items, probs.shape[1]), np.float32)
    out[:min(pad_items, probs.shape[0])] = probs[:pad_items]
    return out
