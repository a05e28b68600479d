"""Layer-wise streaming inference for large graphs (counterpart of
``stemgnn_tpu/train/infer.py``: ``_stream_aggregate`` :149-185,
``layerwise_encode`` :258-373, ``chunked_head_probs`` and
``layerwise_eval_predict`` :376-430).

The reference evaluates node and link models with full-neighbourhood
loaders (STEM-GNN/utils/loader.py:10-45).  Layer-wise inference is the same
math as a full-graph eval-mode forward: layer l's embeddings for every node
from the layer-(l-1) table, with the edge list streamed through blocks of
``edge_block`` edges (a gather, the message relu and an ``index_add_`` a
block), so device memory stays O(N*D + edge_block*D) instead of the
O(E*D) of materialized messages.  No aggregation kernel runs here.  Sums
differ from the full-graph forward only in their order.

The sage backbone is ported, with and without the per-edge-type table.
The gcn, gin and gat blocks and the MoE-SAGE layer are ROADMAP Queue 1
item 5 and raise.
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


def _stream_aggregate(h, senders, receivers, xe, edge_valid, table,
                      edge_block: int):
    """The SUM table [N_pad, D] of ``relu(h[s] + T[xe])`` over the whole
    edge list (valid edges only), one block of ``edge_block`` edges at a
    time; callers divide by the degree.  ``table`` None adds nothing.
    (JAX's ``reverse`` direction serves the MoE-SAGE layer, which
    :func:`layerwise_encode` refuses.)"""
    dev = h.device
    if xe is None:
        n_blk, (s_p, r_p, v_p) = _pad_edges(senders, receivers, edge_valid,
                                            edge_block)
        xe_p = None
    else:
        n_blk, (s_p, r_p, v_p, xe_p) = _pad_edges(senders, receivers,
                                                  edge_valid, edge_block,
                                                  extra=xe)
    s_d = host_to_device(s_p.astype(np.int64), dev)
    r_d = host_to_device(r_p.astype(np.int64), dev)
    v_d = host_to_device(v_p, dev)
    xe_d = None if xe_p is None else host_to_device(xe_p.astype(np.int64),
                                                    dev)
    last = h.shape[0] - 1
    zero = torch.zeros((), dtype=h.dtype, device=dev)
    acc = torch.zeros_like(h)
    for b in range(n_blk):
        sl = slice(b * edge_block, (b + 1) * edge_block)
        msgs = h.index_select(0, s_d[sl].clamp(0, last))
        if table is not None:
            ids = (torch.zeros_like(s_d[sl]) if xe_d is None
                   else xe_d[sl].clamp(0, table.shape[0] - 1))
            msgs = msgs + table.index_select(0, ids)
        msgs = torch.where(v_d[sl][:, None], torch.relu(msgs), zero)
        # invalid edges carry zero messages, so their receiver may be any row
        acc.index_add_(0, r_d[sl].clamp(0, last), msgs)
    return acc


@torch.no_grad()
def layerwise_encode(encoder, node_feat_table, senders, receivers, xe=None,
                     edge_table=None, *, num_nodes=None,
                     edge_block: int = 262_144, device="cpu"):
    """Eval-mode forward of ``encoder`` (an ``nn.encoder.Encoder``), one
    layer at a time over edge blocks.

    Host numpy arguments (real edges only): ``node_feat_table`` [N, D]
    input features, ``edge_table`` [T, D] per-edge-type features picked by
    ``xe``.  Returns ``(z [N_pad, hidden] on device, node_mask [N_pad])``
    with ``N_pad`` the node count rounded up to 128."""
    cfg = encoder.cfg
    if cfg.backbone != "sage":
        raise NotImplementedError(
            f"layer-wise inference of the {cfg.backbone!r} backbone is not "
            f"ported; only sage (ROADMAP Queue 1 item 5)")
    if any(cfg.moe_layer_flags()):
        raise NotImplementedError("layer-wise inference of MoE-SAGE layers "
                                  "is not ported (ROADMAP Queue 1 item 5)")
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
    xe = None if xe is None else np.asarray(xe, np.int32)
    in_deg = np.maximum(np.bincount(receivers, minlength=n_pad), 1)
    in_deg = host_to_device(in_deg.astype(np.float32), device)[:, None]

    was_training = encoder.training
    encoder.eval()
    for i, layer in enumerate(encoder.layers):
        # mean_j relu(h_j + T[xe]) -> lin_l, plus lin_r(h)
        sums = _stream_aggregate(h, senders, receivers, xe, edge_valid,
                                 t_dev, edge_block)
        z = layer.lin_l(sums / in_deg) + layer.lin_r(h)
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
