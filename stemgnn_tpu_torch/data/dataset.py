"""Text-attributed-graph dataset container (counterpart of
``stemgnn_tpu/data/dataset.py``).

Node/edge *text features* are deduplicated tables and the graph stores
integer ids into them:

  * ``node_text_feat`` [N_unique, D], ``edge_text_feat`` [T, D]
  * ``x`` [N] node->text-row ids, ``xe`` [E] edge->edge-type ids
  * ``edge_index`` [2, E]

Arrays stay numpy on the host; ``to_graph`` builds the padded device
:class:`~stemgnn_tpu_torch.core.graph.Graph`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from stemgnn_tpu_torch.core.graph import Graph, make_graph


@dataclass
class TAGDataset:
    name: str
    node_text_feat: np.ndarray           # [N_unique, D]
    edge_text_feat: np.ndarray           # [T, D]
    x: np.ndarray                        # [N] int ids into node_text_feat
    xe: np.ndarray                       # [E] int ids into edge_text_feat
    edge_index: np.ndarray               # [2, E]
    labels: Optional[np.ndarray] = None
    splits: Optional[List[Dict[str, np.ndarray]]] = None   # boolean masks
    class_node_text_feat: Optional[np.ndarray] = None
    num_classes: int = 0
    num_tasks: int = 1
    extras: dict = field(default_factory=dict)

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    def node_features(self) -> np.ndarray:
        return self.node_text_feat[self.x]

    def edge_features(self) -> np.ndarray:
        return self.edge_text_feat[self.xe]

    def to_graph(self, node_pad_to: Optional[int] = None,
                 edge_pad_to: Optional[int] = None,
                 with_edge_feat: bool = True, device="cpu") -> Graph:
        return make_graph(
            self.node_features(),
            self.edge_index[0], self.edge_index[1],
            edge_feat=self.edge_features() if with_edge_feat else None,
            node_pad_to=node_pad_to, edge_pad_to=edge_pad_to, device=device)


def make_index_splits(num_items: int, train_idx, valid_idx, test_idx=None):
    """Index arrays -> boolean-mask split dict."""
    def to_mask(idx):
        m = np.zeros(num_items, dtype=bool)
        m[np.asarray(idx)] = True
        return m
    train = to_mask(train_idx)
    valid = to_mask(valid_idx)
    test = ~(train | valid) if test_idx is None else to_mask(test_idx)
    return {"train": train, "valid": valid, "test": test}
