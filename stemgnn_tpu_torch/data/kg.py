"""Knowledge-graph datasets (WN18RR, FB15K237) from the processed cache
(counterpart of the cache route of ``stemgnn_tpu/data/kg.py``, :54-63).

A cached knowledge graph is a link task: ``edge_index`` [2, E] holds the
(head, tail) pairs of every split's triples, ``labels`` [E] their relation
ids, ``xe`` [E] all zero with a single edge text (``edge_text_feat`` [1,
D], the reference's "without using edge text"), and one split of boolean
edge masks.  FB15K237's cache carries JAX's 80/10/10 resplit of the valid
and test triples (``extras["resplit_missing_train"]``), since the reference
snapshot ships no ``train.txt``.

Only the cache is read.  The triple parser and the text encoders that
would build a missing cache from raw files are ROADMAP Queue 1 item 8,
second half: without the cache file this raises.
"""

from __future__ import annotations

from stemgnn_tpu_torch.data.dataset import TAGDataset
from stemgnn_tpu_torch.data.importers import cache_path, load_dataset_cache

KG_DATASETS = ("WN18RR", "FB15K237")


def load_kg_dataset(name: str = "WN18RR", text_encoder: str = "hash",
                    feat_dim: int = 768, root=None) -> TAGDataset:
    """The cached knowledge graph ``name`` encoded by ``text_encoder`` at
    ``feat_dim`` dims; ``root`` is the cache directory (default: the
    repository's ``data_cache/``)."""
    if name not in KG_DATASETS:
        raise NotImplementedError(f"KG dataset {name} not implemented")
    ds = load_dataset_cache(name, text_encoder, feat_dim, root)
    if ds is None:
        raise FileNotFoundError(
            f"no cached {name} for text encoder {text_encoder!r} at "
            f"{feat_dim} dims: {cache_path(name, text_encoder, feat_dim, root)}"
            f" is missing.  Building it from the raw triples (the KG triple "
            f"parser and the text encoders) is not ported yet (ROADMAP "
            f"Queue 1 item 8, second half)")
    return ds
