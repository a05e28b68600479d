"""Task predictors (counterpart of ``stemgnn_tpu/zoo/predictors.py``;
reference STEM-GNN/dataset/gp/nn/models/task_predictor.py:32-140): a zoo
GNN stack and an MLP head (with BatchNorm), read out for graphs (pooled
over a disjoint batch), node pairs (endpoint product) or nodes."""

from __future__ import annotations

from torch import nn

from stemgnn_tpu_torch.zoo.mlp import MLP
from stemgnn_tpu_torch.zoo.pooling import global_pool
from stemgnn_tpu_torch.zoo.stack import GNNStack


class Predictor(nn.Module):
    """``{"encoder", "head"}`` as JAX's ``graph_predictor_init`` trees;
    the link and node predictors read the same trees."""

    def __init__(self, kind: str, num_layers: int, dim: int, out_dim: int,
                 num_relations: int = 1, virtual_node: bool = False,
                 generator=None):
        super().__init__()
        self.encoder = GNNStack(kind, num_layers, dim,
                                num_relations=num_relations,
                                virtual_node=virtual_node,
                                generator=generator)
        self.head = MLP([dim, 2 * dim, out_dim], generator=generator)

    def graph(self, x, xe, senders, receivers, node_graph_id, n_graphs: int,
              edge_type=None, edge_mask=None, node_mask=None,
              pool: str = "mean"):
        z = self.encoder(x, xe, senders, receivers, edge_type=edge_type,
                         edge_mask=edge_mask, node_mask=node_mask,
                         node_graph_id=node_graph_id, n_graphs=n_graphs)
        return self.head(global_pool(z, node_graph_id, n_graphs, mode=pool,
                                     node_mask=node_mask))

    def link(self, x, xe, senders, receivers, query_src, query_dst,
             edge_type=None, edge_mask=None):
        """Node pairs scored by the elementwise product of their endpoint
        embeddings through the head (the encoder's BatchNorm over every
        row, as JAX passes no node mask here)."""
        z = self.encoder(x, xe, senders, receivers, edge_type=edge_type,
                         edge_mask=edge_mask)
        return self.head(z[query_src] * z[query_dst])

    def node(self, x, xe, senders, receivers, edge_type=None,
             edge_mask=None, node_mask=None):
        z = self.encoder(x, xe, senders, receivers, edge_type=edge_type,
                         edge_mask=edge_mask, node_mask=node_mask)
        return self.head(z)
