"""Graph pooling / readout (counterpart of ``stemgnn_tpu/zoo/pooling.py``):
PyG's global_{mean,add,max}_pool (STEM-GNN/model/ft_model.py:61-69) as
masked segment reductions over a padded disjoint batch, and a gated
attention readout.  A padded node's dead graph id ``n_graphs`` is dropped
from every reduction, as JAX's segment ops drop it."""

from __future__ import annotations

from torch import nn

from stemgnn_tpu_torch.nn.layers import Linear
from stemgnn_tpu_torch.ops import segment

POOLS = {"mean": segment.segment_mean, "sum": segment.segment_sum,
         "add": segment.segment_sum, "max": segment.segment_max}


def global_pool(z, node_graph_id, n_graphs: int, mode: str = "mean",
                node_mask=None):
    return POOLS[mode](z, node_graph_id, n_graphs, mask=node_mask,
                       drop_oob=True)


class AttentionPool(nn.Module):
    """``{"gate": Linear(dim, 1), "proj": Linear(dim, dim)}``: softmax of
    the gate within each graph, the weighted sum of ``proj(z)``."""

    def __init__(self, dim: int, generator=None):
        super().__init__()
        self.gate = Linear(dim, 1, generator=generator)
        self.proj = Linear(dim, dim, generator=generator)

    def forward(self, z, node_graph_id, n_graphs: int, node_mask=None):
        gate = self.gate(z)[:, 0]
        att = segment.segment_softmax(gate, node_graph_id, n_graphs,
                                      mask=node_mask, drop_oob=True)
        h = self.proj(z) * att[:, None]
        return segment.segment_sum(h, node_graph_id, n_graphs,
                                   mask=node_mask, drop_oob=True)
