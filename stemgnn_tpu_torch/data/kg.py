"""Knowledge-graph datasets WN18RR / FB15K237 (counterpart of
``stemgnn_tpu/data/kg.py``).

A knowledge graph is a link task: ``edge_index`` [2, E] holds the (head,
tail) pairs of every split's triples concatenated train | valid | test,
``labels`` [E] their relation ids, ``xe`` [E] all zero with a single edge
text (``edge_text_feat`` [1, D], the reference's "without using edge
text"), node texts "feature node. entity and entity description: ...",
one class text per relation, and one split of boolean edge masks by
position in the concatenation.

The processed cache (``data/importers.py``; the repository ships WN18RR's
and FB15K237's at 768 dims, hash and tfidf) is read first.  On a miss the
raw triples are parsed from ``root`` (default ``<cache root>/raw/KG``:
``<name>/{train,valid,test}.txt`` plus ``entity2text.txt`` for WN18RR or
``entity2wikidata.json`` for FB15K237), the texts encoded, and the cache
written.  Without ``train.txt`` (the reference's FB15K237 snapshot ships
none) the triples are re-split 80/10/10 from a seeded permutation,
flagged in ``extras["resplit_missing_train"]``.
"""

from __future__ import annotations

import json
import os.path as osp
from typing import Dict, Optional

import numpy as np

from stemgnn_tpu_torch.data import importers
from stemgnn_tpu_torch.data.dataset import TAGDataset, make_index_splits
from stemgnn_tpu_torch.data.text_encoder import get_text_encoder

KG_DATASETS = ("WN18RR", "FB15K237")


def raw_kg_root() -> str:
    """``<cache root>/raw/KG``, read at call time."""
    return osp.join(importers.DEFAULT_CACHE_ROOT, "raw", "KG")


def _gen_entities(root: str, name: str):
    entity_lst, text_lst = [], []
    if name == "WN18RR":
        with open(osp.join(root, name, "entity2text.txt")) as f:
            for line in f:
                tmp = line.strip().split("\t")
                if len(tmp) >= 2:
                    entity_lst.append(tmp[0])
                    text_lst.append(tmp[1])
    elif name == "FB15K237":
        with open(osp.join(root, name, "entity2wikidata.json")) as f:
            data = json.load(f)
        for k in data:
            desc = data[k]["description"]
            # the reference's precedence: the whole text, or "None"
            text_lst.append(
                "entity names: " + data[k]["label"] + ", entity alternatives: "
                + ", ".join(data[k]["alternatives"]) + ". entity descriptions:"
                + desc if desc is not None else "None")
            entity_lst.append(k)
    else:
        raise NotImplementedError(f"KG dataset {name} not implemented")
    entity2id = {e: i for i, e in enumerate(entity_lst)}
    return entity_lst, text_lst, entity2id


def load_kg_dataset(name: str = "WN18RR", root: Optional[str] = None,
                    text_encoder: str = "hash", feat_dim: int = 768,
                    splits=("train", "valid", "test"), cache: bool = True,
                    device=None) -> TAGDataset:
    """The knowledge graph ``name`` encoded by ``text_encoder`` at
    ``feat_dim`` dims: from the cache when ``cache`` and it exists, else
    from the raw triples under ``root`` (then cached); ``device`` is where
    a neural text encoder runs."""
    if name not in KG_DATASETS:
        raise NotImplementedError(f"KG dataset {name} not implemented")
    if cache:
        cached = importers.load_dataset_cache(name, text_encoder, feat_dim)
        if cached is not None:
            return cached
    root = root or raw_kg_root()
    entity_lst, text_lst, entity2id = _gen_entities(root, name)
    relation2id: Dict[str, int] = {}
    rel_list = []

    edges, edge_types, counts = [], [], []
    for split_name in splits:
        path = osp.join(root, name, split_name + ".txt")
        if not osp.exists(path):
            counts.append(0)
            continue
        cnt = 0
        with open(path) as f:
            for line in f:
                trip = line.split()
                if len(trip) != 3:
                    continue
                h, rel, t = trip
                for ent in (h, t):
                    if ent not in entity2id:
                        entity2id[ent] = len(entity2id)
                        entity_lst.append(ent)
                        text_lst.append("entity names: Unknown")
                if rel not in relation2id:
                    relation2id[rel] = len(relation2id)
                    rel_list.append(rel)
                edges.append((entity2id[h], entity2id[t]))
                edge_types.append(relation2id[rel])
                cnt += 1
        counts.append(cnt)

    edge_index = np.asarray(edges, np.int64).T
    edge_types = np.asarray(edge_types, np.int64)
    n_ent = len(entity_lst)

    enc = get_text_encoder(text_encoder, dim=feat_dim, device=device)
    node_text = ["feature node. entity and entity description: " + t
                 for t in text_lst]
    node_text_feat = enc.encode(node_text)
    edge_text_feat = enc.encode(
        ["feature edge. relation between two entities."])
    class_text = ["prompt node. relation between two entities. " + r
                  for r in rel_list]
    class_node_text_feat = enc.encode(class_text)

    e_total = edge_index.shape[1]
    offs = np.cumsum([0] + counts)
    resplit = counts[0] == 0 and e_total > 0
    if resplit:
        perm = np.random.default_rng(0).permutation(e_total)
        n_tr = int(e_total * 0.8)
        n_va = int(e_total * 0.1)
        split = make_index_splits(e_total, perm[:n_tr],
                                  perm[n_tr: n_tr + n_va],
                                  perm[n_tr + n_va:])
    else:
        split = make_index_splits(e_total,
                                  np.arange(offs[0], offs[1]),
                                  np.arange(offs[1], offs[2]),
                                  np.arange(offs[2], offs[3]))

    ds = TAGDataset(
        name=name,
        node_text_feat=node_text_feat.astype(np.float32),
        edge_text_feat=edge_text_feat.astype(np.float32),
        x=np.arange(n_ent),
        xe=np.zeros(e_total, np.int64),
        edge_index=edge_index,
        labels=edge_types,
        splits=[split],
        class_node_text_feat=class_node_text_feat.astype(np.float32),
        num_classes=len(rel_list), num_tasks=1,
        extras={"relations": rel_list, "split_counts": counts,
                "resplit_missing_train": resplit})
    if cache:
        try:
            importers.save_dataset_cache(ds, text_encoder)
        except OSError:
            pass
    return ds
