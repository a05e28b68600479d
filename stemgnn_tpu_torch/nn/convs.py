"""Graph convolution layers (counterpart of ``stemgnn_tpu/nn/convs.py``).

Only ``sage`` is ported: MySAGEConv (STEM-GNN/model/encoder.py:17-106),
``relu(x_j + xe)`` messages, mean aggregation, root weight.
"""

from __future__ import annotations

from torch import nn

from stemgnn_tpu_torch.nn.layers import Linear
from stemgnn_tpu_torch.ops.spmm import sage_aggregate


class SAGEConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, generator=None):
        super().__init__()
        # PyG Linear's default initializer is glorot (encoder.py:58-60)
        self.lin_l = Linear(in_dim, out_dim, bias=True, weight_init="glorot",
                            generator=generator)
        self.lin_r = Linear(in_dim, out_dim, bias=False,
                            weight_init="glorot", generator=generator)

    def forward(self, x, senders, receivers, edge_feat=None, edge_mask=None,
                layout=None, edge_table=None, bf16_messages: bool = True,
                plain: bool = False, drop_hash=None):
        """out = lin_l(mean_j relu(x_j + xe)) + lin_r(x)
        (encoder.py:82-87)."""
        agg = sage_aggregate(x, senders, receivers, edge_feat=edge_feat,
                             edge_mask=edge_mask, num_nodes=x.shape[0],
                             reduce="mean", relu=True, layout=layout,
                             edge_table=edge_table,
                             bf16_messages=bf16_messages, plain=plain,
                             drop_hash=drop_hash)
        return self.lin_l(agg) + self.lin_r(x)
