"""Raw-corpus parsers for the single-graph families cora / pubmed / arxiv
/ wikics (counterpart of ``stemgnn_tpu/data/raw_parsers.py``).

The reference builds these datasets from raw inputs
(``dataset/data/single_graph/*/gen_data.py``): the ``cora.pt`` /
``pubmed.pt`` torch payloads + ``categories.csv``, the OGB ``ogbn-arxiv``
csv.gz tree + ``titleabs.tsv`` + the taxonomy files, and WikiCS's
``data.json`` + ``metadata.json``.  These parsers read the raw formats
themselves, with no PyG and no OGB package, build the reference's texts
verbatim and encode them with the configured text encoder
(``data/text_encoder.py``; ``device`` picks where a neural one runs).
Arrays, splits and texts equal the JAX package's bit for bit.

Without ``root`` a loader reads ``<cache root>/raw/single_graph/<Sub>``
(``Cora``, ``Pubmed``, ``arxiv``, ``wikics``), the reference's layout
under the cache root of ``data/importers.py``.
"""

from __future__ import annotations

import gzip
import json
import os.path as osp
from typing import Optional

import numpy as np

from stemgnn_tpu_torch.data import importers
from stemgnn_tpu_torch.data.dataset import TAGDataset, make_index_splits
from stemgnn_tpu_torch.data.text_encoder import get_text_encoder


def raw_root(sub: str) -> str:
    """``<cache root>/raw/single_graph/<sub>``, read at call time."""
    return osp.join(importers.DEFAULT_CACHE_ROOT, "raw", "single_graph", sub)


def _np(v):
    if v is None:
        return None
    if hasattr(v, "numpy"):
        v = v.detach().numpy() if hasattr(v, "detach") else v.numpy()
    return np.asarray(v)


def _encode(texts, enc) -> np.ndarray:
    """``enc``'s f32 features of ``texts``.  A loader builds its encoder
    once for its node, edge and class texts (JAX builds one a group,
    loading a language model's weights three times)."""
    return np.asarray(enc.encode(list(texts)), np.float32)


def _cite_splits(num_nodes: int, train_n: int, val_n: int, num_splits: int,
                 seed: int = 0):
    """Reference split convention for the citation graphs: ``train_n`` train
    / ``val_n`` val / rest test node indices, ``num_splits`` seeded draws
    (process_datasets.py:285-286)."""
    splits = []
    for s in range(num_splits):
        srng = np.random.default_rng(seed * 1000 + s)
        perm = srng.permutation(num_nodes)
        splits.append(make_index_splits(num_nodes, perm[:train_n],
                                        perm[train_n:train_n + val_n]))
    return splits


def load_citation_raw(name: str, root: Optional[str] = None,
                      text_encoder: str = "hash", feat_dim: int = 768,
                      num_splits: int = 10, seed: int = 0,
                      device=None) -> TAGDataset:
    """cora/pubmed from the raw ``{name}.pt`` torch payload +
    ``categories.csv`` (reference Cora/gen_data.py:24-94,
    Pubmed/gen_data.py:8-42).

    The payload carries ``raw_texts`` (one string per paper), ``y`` labels
    and ``edge_index``; the reference routes the edge list through
    ``networkx`` (``to_networkx(to_undirected=False).edges()``), which
    DEDUPLICATES parallel directed edges — reproduced here with
    ``np.unique`` over directed pairs.  Node text = "feature node. paper
    title and abstract: " + raw text; label text per categories.csv (cora:
    "...: {label}.{desc}" — the reference omits the space after the dot,
    Cora/gen_data.py:45; pubmed: one description per line).  No PyG needed:
    stub modules absorb the pickled classes (data/importers.py)."""
    assert name in ("cora", "pubmed"), name
    sub = {"cora": "Cora", "pubmed": "Pubmed"}[name]
    root = root or raw_root(sub)
    pt_path = osp.join(root, f"{name}.pt")
    data = importers.load_pyg_payload(pt_path)
    m = importers.pyg_mapping(data)
    texts = m.get("raw_texts") or getattr(data, "raw_texts", None)
    y = _np(m.get("y") if m.get("y") is not None
             else getattr(data, "y", None))
    ei = _np(m.get("edge_index") if m.get("edge_index") is not None
             else getattr(data, "edge_index", None))
    if texts is None or ei is None:
        raise ValueError(f"{pt_path} lacks raw_texts/edge_index")
    y = y.reshape(-1).astype(np.int64) if y is not None else None
    # networkx-equivalent dedup of directed pairs (Cora/gen_data.py:30-32)
    pair = np.unique(np.stack([ei[0], ei[1]], 1), axis=0)
    edge_index = pair.T.astype(np.int64)

    node_texts = ["feature node. paper title and abstract: " + t
                  for t in texts]
    cat_path = osp.join(root, "categories.csv")
    label_texts = []
    if osp.exists(cat_path):
        if name == "cora":
            label_names = (m.get("label_names")
                           or getattr(data, "label_names", None) or [])
            # Quoting-aware parse matching the reference's
            # ``pd.read_csv(...).values`` (Cora/gen_data.py:36-38): the
            # first row is the header, quoted descriptions may contain
            # commas and doubled quotes.
            import csv as _csv
            with open(cat_path, newline="") as f:
                rows = list(_csv.reader(f))[1:]
            # csv.reader yields [] for blank lines — tolerate them
            desc = {r[0]: (r[1] if len(r) > 1 else "") for r in rows if r}
            label_texts = [
                "prompt node. literature category and description: "
                + lab + "." + desc.get(lab, "") for lab in label_names]
        else:
            label_texts = [
                "prompt node. literature category and description: " + d
                for d in open(cat_path).read().strip().split("\n") if d]
    n = len(node_texts)
    num_classes = int(y.max()) + 1 if y is not None and y.size else 0
    enc = get_text_encoder(text_encoder, dim=feat_dim, device=device)
    feats = _encode(node_texts, enc)
    edge_text_feat = _encode(
        ["feature edge. connected papers are cited together by other "
         "papers."], enc)
    cls_feat = _encode(label_texts, enc) if label_texts else None
    train_n, val_n = (140, 500) if name == "cora" else (60, 500)
    return TAGDataset(
        name=name, node_text_feat=feats, edge_text_feat=edge_text_feat,
        x=np.arange(n), xe=np.zeros(edge_index.shape[1], np.int64),
        edge_index=edge_index, labels=y,
        splits=_cite_splits(n, train_n, val_n, num_splits, seed=seed),
        class_node_text_feat=cls_feat, num_classes=num_classes,
        extras={"raw_root": root})


def _read_csv_gz(path, header: bool):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        lines = f.read().strip().split("\n")
    if header:
        lines = lines[1:]
    return [ln.split(",") for ln in lines if ln]


def parse_arxiv_taxonomy(path: str):
    """``arxiv_CS_categories.txt`` three-line records (reference
    arxiv/gen_data.py:32-61): "cs.XX (Name)" / description / blank."""
    result = []
    state = 0
    cat = name = None
    for line in open(path).read().split("\n"):
        if state == 0:
            if not line.strip():
                continue
            assert line.strip().startswith("cs."), line
            cat = "arxiv " + " ".join(
                line.strip().split(" ")[0].split(".")).lower()
            name = line.strip()[7:-1]
            state = 1
        elif state == 1:
            result.append({"id": cat, "name": name,
                           "description": line.strip()})
            state = 2
        else:
            state = 0
    return result


def load_arxiv_raw(root: Optional[str] = None, ogb_root: Optional[str] = None,
                   text_encoder: str = "hash", feat_dim: int = 768,
                   device=None) -> TAGDataset:
    """ogbn-arxiv from raw files, no OGB package (reference
    arxiv/gen_data.py:7-29,122-193):

      * ``root``: the reference-shipped side files —
        ``nodeidx2paperid.csv.gz``, ``labelidx2arxivcategeory.csv.gz``,
        ``arxiv_CS_categories.txt`` — plus ``titleabs.tsv`` (downloaded).
      * ``ogb_root``: the OGB raw tree (``raw/edge.csv.gz``,
        ``raw/node-label.csv.gz``, ``split/time/{train,valid,test}.csv.gz``)
        (defaults to ``root``).

    Node text "feature node. paper title and abstract: {title}. {abstract}"
    (gen_data.py:21-26), label text "prompt node. literature category and
    description: {name}. {description}" (gen_data.py:76-86); the edge list
    is SYMMETRIZED + coalesced, matching the reference's
    ``transform=ToUndirected()`` (gen_data.py:123-126); splits are the OGB
    public time split (one split, process_datasets.py:288)."""
    root = root or raw_root("arxiv")
    ogb_root = ogb_root or root

    idx2pid = {}
    for row in _read_csv_gz(osp.join(root, "nodeidx2paperid.csv.gz"),
                            header=True):
        idx2pid[int(row[0])] = row[1].strip()
    titleabs = {}
    with open(osp.join(root, "titleabs.tsv")) as f:
        for ln in f:
            parts = ln.rstrip("\n").split("\t")
            # Papers with an empty abstract ship as 2-field rows; the
            # reference's pandas join keeps the partial row, so treat the
            # missing abstract as "" rather than dropping the node's text.
            if len(parts) >= 3:
                titleabs[parts[0].strip()] = (parts[1], parts[2])
            elif len(parts) == 2:
                titleabs[parts[0].strip()] = (parts[1], "")
    n = len(idx2pid)
    node_texts = []
    for i in range(n):
        title, abstract = titleabs.get(idx2pid[i], ("", ""))
        node_texts.append("feature node. paper title and abstract: "
                          + title + ". " + abstract)

    edges = np.asarray(
        [[int(a), int(b)] for a, b in
         _read_csv_gz(osp.join(ogb_root, "raw", "edge.csv.gz"),
                      header=False)], np.int64)
    pair = np.unique(np.concatenate([edges, edges[:, ::-1]], 0), axis=0)
    edge_index = pair.T

    y = np.asarray([int(r[0]) for r in _read_csv_gz(
        osp.join(ogb_root, "raw", "node-label.csv.gz"), header=False)],
        np.int64)

    tax = {t["id"]: t for t in parse_arxiv_taxonomy(
        osp.join(root, "arxiv_CS_categories.txt"))}
    label_texts = []
    for row in _read_csv_gz(osp.join(root, "labelidx2arxivcategeory.csv.gz"),
                            header=True):
        t = tax.get(row[1].strip())
        label_texts.append(
            "prompt node. literature category and description: "
            + (t["name"] if t else row[1]) + ". "
            + (t["description"] if t else ""))

    def split_idx(part):
        return np.asarray([int(r[0]) for r in _read_csv_gz(
            osp.join(ogb_root, "split", "time", part + ".csv.gz"),
            header=False)], np.int64)

    splits = [make_index_splits(n, split_idx("train"), split_idx("valid"),
                                split_idx("test"))]
    enc = get_text_encoder(text_encoder, dim=feat_dim, device=device)
    feats = _encode(node_texts, enc)
    return TAGDataset(
        name="arxiv", node_text_feat=feats,
        edge_text_feat=_encode(["feature edge. citation"], enc),
        x=np.arange(n), xe=np.zeros(edge_index.shape[1], np.int64),
        edge_index=edge_index, labels=y, splits=splits,
        class_node_text_feat=_encode(label_texts, enc)
        if label_texts else None,
        num_classes=int(y.max()) + 1 if y.size else 0,
        extras={"raw_root": root})


def load_wikics_raw(root: Optional[str] = None, text_encoder: str = "hash",
                    feat_dim: int = 768, device=None) -> TAGDataset:
    """WikiCS from the raw ``data.json`` (adjacency lists + labels + the 20
    public train/val splits and fixed test mask) and ``metadata.json``
    texts (reference wikics/gen_data.py:13-60): node text
    "feature node. wikipedia entry name: {title}. entry content: {tokens}"
    (lower-cased), label text "prompt node. wikipedia entry category:
    {label}" (lower-cased)."""
    root = root or raw_root("wikics")
    with open(osp.join(root, "data.json")) as f:
        raw = json.load(f)
    with open(osp.join(root, "metadata.json")) as f:
        meta = json.load(f)

    links = raw["links"]
    n = len(links)
    src = np.concatenate([np.full(len(nb), i, np.int64)
                          for i, nb in enumerate(links)]) \
        if n else np.zeros(0, np.int64)
    dst = np.concatenate([np.asarray(nb, np.int64) for nb in links]) \
        if n else np.zeros(0, np.int64)
    # undirected, as torch_geometric.datasets.WikiCS loads it
    pair = np.unique(np.stack([np.concatenate([src, dst]),
                               np.concatenate([dst, src])], 1), axis=0)
    edge_index = pair.T
    y = np.asarray(raw["labels"], np.int64)

    node_texts = [
        ("feature node. wikipedia entry name: " + nd["title"]
         + ". entry content: " + " ".join(nd["tokens"])).lower().strip()
        for nd in meta["nodes"]]
    label_texts = [
        ("prompt node. wikipedia entry category: " + lab).lower().strip()
        for lab in meta["labels"].values()]

    test_mask = np.asarray(raw["test_mask"], bool)
    splits = []
    for tr, va in zip(raw["train_masks"], raw["val_masks"]):
        splits.append({"train": np.asarray(tr, bool),
                       "valid": np.asarray(va, bool),
                       "test": test_mask})
    enc = get_text_encoder(text_encoder, dim=feat_dim, device=device)
    return TAGDataset(
        name="wikics", node_text_feat=_encode(node_texts, enc),
        edge_text_feat=_encode(["feature edge. wikipedia page link"], enc),
        x=np.arange(n), xe=np.zeros(edge_index.shape[1], np.int64),
        edge_index=edge_index, labels=y, splits=splits,
        class_node_text_feat=_encode(label_texts, enc)
        if label_texts else None,
        num_classes=int(y.max()) + 1 if y.size else 0,
        extras={"raw_root": root})
