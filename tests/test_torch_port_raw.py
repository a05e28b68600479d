"""The raw-file loaders of the port (``stemgnn_tpu_torch/data/{raw_parsers,
kg,importers,registry}.py``) against the JAX package's on the CPU: small
raw trees of each format (cora / pubmed / arxiv / wikics, WN18RR's and
FB15K237's triples, FB15K237 without ``train.txt``) written here go
through both registries, and the arrays, splits, extras and features come
out equal bit for bit; the reference's PyG caches import in either order
of the two packages' stub modules; the ``.st`` memmap cache written by
either package loads in the other; a cache hit draws the seeded citation
splits again; the finetune CLI trains cora from its raw files through the
ST encoder on the CPU.  Every cache goes to a temporary directory."""

import gzip
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from stemgnn_tpu.data import importers as jax_imp
from stemgnn_tpu.data import registry as jax_reg
from stemgnn_tpu_torch import finetune as port_cli
from stemgnn_tpu_torch.data import importers as port_imp
from stemgnn_tpu_torch.data import registry as port_reg

# ------------------------------------------------------- raw tree writers

WORDS = ("graph neural network paper citation learning model node edge "
         "theory proof system data mining protein molecule").split()


def _text(rng, n_words):
    return " ".join(rng.choice(WORDS, size=n_words))


def _register_fake_pyg():
    """PyG 2.3's pickle layout under the real module names (``Data`` with
    a ``_store`` GlobalStorage holding ``_mapping``), so ``torch.save``
    writes what a real PyG would."""
    mods = {name: types.ModuleType(name) for name in (
        "torch_geometric", "torch_geometric.data",
        "torch_geometric.data.data", "torch_geometric.data.storage")}

    class GlobalStorage:
        def __init__(self, mapping, parent=None):
            self._mapping = dict(mapping)
            self._parent = parent

    GlobalStorage.__module__ = "torch_geometric.data.storage"
    GlobalStorage.__qualname__ = "GlobalStorage"

    class Data:
        def __init__(self, **kwargs):
            self.__dict__["_store"] = GlobalStorage(kwargs, parent=self)

    Data.__module__ = "torch_geometric.data.data"
    Data.__qualname__ = "Data"
    mods["torch_geometric.data.storage"].GlobalStorage = GlobalStorage
    mods["torch_geometric.data.data"].Data = Data
    sys.modules.update(mods)
    return Data


def _clear_pyg_modules():
    for k in list(sys.modules):
        if k.startswith("torch_geometric"):
            del sys.modules[k]


@pytest.fixture
def no_pyg():
    """No torch_geometric module before or after the test."""
    _clear_pyg_modules()
    yield
    _clear_pyg_modules()


def write_citation_tree(root, name="cora", n=60, e=240, seed=0):
    """``{name}.pt`` (cora: a PyG ``Data``; pubmed: a plain dict) with
    duplicated directed edges, plus ``categories.csv``."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (2, e))
    ei[:, : e // 8] = ei[:, e // 8: e // 4]            # parallel edges
    payload = {"raw_texts": [_text(rng, int(k))
                             for k in rng.integers(3, 12, n)],
               "label_names": ["theory", "systems", "ml"],
               "y": torch.tensor(rng.integers(0, 3, n)),
               "edge_index": torch.tensor(ei)}
    if name == "cora":
        data = _register_fake_pyg()
        try:
            torch.save(data(**payload), os.path.join(root, "cora.pt"))
        finally:
            _clear_pyg_modules()
        # a header, quoted descriptions with commas and doubled quotes, and
        # a blank line
        with open(os.path.join(root, "categories.csv"), "w") as f:
            f.write(',description\ntheory,"about proofs, with ""rigor"""\n'
                    '\nsystems,about computers\nml,about data\n')
    else:
        torch.save(payload, os.path.join(root, f"{name}.pt"))
        with open(os.path.join(root, "categories.csv"), "w") as f:
            f.write("diabetes type 1\ndiabetes type 2\n"
                    "diabetes experimental\n")
    return n


def _gz(root, path, lines):
    with gzip.open(os.path.join(root, path), "wt") as f:
        f.write("\n".join(lines))


def write_arxiv_tree(root, n=40, seed=1):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "raw"), exist_ok=True)
    os.makedirs(os.path.join(root, "split", "time"), exist_ok=True)
    _gz(root, "nodeidx2paperid.csv.gz",
        ["node idx,paper id"] + [f"{i},{1000 + i}" for i in range(n)])
    with open(os.path.join(root, "titleabs.tsv"), "w") as f:
        for i in range(n):
            if i % 7 == 3:          # an empty abstract: a 2-field row
                f.write(f"{1000 + i}\ttitle {i}\n")
            else:
                f.write(f"{1000 + i}\ttitle {i}\t{_text(rng, 8)}\n")
    edges = rng.integers(0, n, (90, 2))
    _gz(root, "raw/edge.csv.gz", [f"{a},{b}" for a, b in edges])
    _gz(root, "raw/node-label.csv.gz",
        [str(v) for v in rng.integers(0, 3, n)])
    idx = rng.permutation(n)
    _gz(root, "split/time/train.csv.gz", [str(v) for v in idx[:20]])
    _gz(root, "split/time/valid.csv.gz", [str(v) for v in idx[20:30]])
    _gz(root, "split/time/test.csv.gz", [str(v) for v in idx[30:]])
    with open(os.path.join(root, "arxiv_CS_categories.txt"), "w") as f:
        f.write("cs.AI (Artificial Intelligence)\nCovers all areas of AI.\n"
                "\ncs.DB (Databases)\nCovers database management.\n\n")
    _gz(root, "labelidx2arxivcategeory.csv.gz",
        ["label idx,arxiv category", "0,arxiv cs ai", "1,arxiv cs db",
         "2,arxiv cs zz"])
    return n


def write_wikics_tree(root, n=30, seed=2):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    data = {"links": [sorted(set(rng.integers(0, n, 4).tolist()) - {i})
                      for i in range(n)],
            "labels": rng.integers(0, 3, n).tolist(),
            "train_masks": [(rng.random(n) < 0.3).tolist()
                            for _ in range(3)],
            "val_masks": [(rng.random(n) < 0.3).tolist() for _ in range(3)],
            "test_mask": (rng.random(n) < 0.5).tolist()}
    meta = {"nodes": [{"title": f"Page {i}",
                       "tokens": _text(rng, 5).split()} for i in range(n)],
            "labels": {str(i): f"Category {i}" for i in range(3)}}
    with open(os.path.join(root, "data.json"), "w") as f:
        json.dump(data, f)
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return n


def write_kg_tree(root, name, with_train, seed=3):
    """A KG directory under ``root/name``: WN18RR's ``entity2text.txt`` or
    FB15K237's ``entity2wikidata.json`` (one description None), and the
    split files, some triples naming entities the text file lacks."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, name)
    os.makedirs(base, exist_ok=True)
    ents = [f"e{i:03d}" for i in range(25)]
    if name == "WN18RR":
        with open(os.path.join(base, "entity2text.txt"), "w") as f:
            for e in ents:
                f.write(f"{e}\t{_text(rng, 6)}\n")
            f.write("malformed-line\n")
    else:
        wiki = {e: {"label": f"label {e}", "alternatives": ["alt", e],
                    "description": None if i == 4 else _text(rng, 5)}
                for i, e in enumerate(ents)}
        with open(os.path.join(base, "entity2wikidata.json"), "w") as f:
            json.dump(wiki, f)
    rels = ["_hypernym", "_part_of", "/film/genre", "_similar_to"]
    for split, count in (("train", 60), ("valid", 15), ("test", 15)):
        if split == "train" and not with_train:
            continue
        with open(os.path.join(base, f"{split}.txt"), "w") as f:
            for _ in range(count):
                h, t = rng.integers(0, 28, 2)    # 25-27: not in the texts
                f.write(f"e{h:03d}\t{rels[rng.integers(0, 4)]}\te{t:03d}\n")
            f.write("bad line\n")


# ------------------------------------------------------------- comparing

def _same_dataset(got, want):
    assert type(got).__name__ == type(want).__name__ == "TAGDataset"
    assert got.name == want.name
    for k in ("node_text_feat", "edge_text_feat", "class_node_text_feat",
              "x", "xe", "edge_index", "labels"):
        a, b = getattr(got, k), getattr(want, k)
        if b is None:
            assert a is None, k
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert (got.num_classes, got.num_tasks) == (want.num_classes,
                                                want.num_tasks)
    assert (got.splits is None) == (want.splits is None)
    assert len(got.splits or []) == len(want.splits or [])
    for sg, sw in zip(got.splits or [], want.splits or []):
        assert set(sg) == set(sw)
        for k in sw:
            assert np.array_equal(sg[k], np.asarray(sw[k])), k
    assert got.extras == want.extras


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Each package's cache root in its own temporary directory."""
    roots = {"jax": str(tmp_path / "jax_cache"),
             "port": str(tmp_path / "port_cache")}
    monkeypatch.setattr(jax_imp, "DEFAULT_CACHE_ROOT", roots["jax"])
    monkeypatch.setattr(port_imp, "DEFAULT_CACHE_ROOT", roots["port"])
    return roots


def _both(name, **kw):
    return (port_reg.load_dataset(name, **kw),
            jax_reg.load_dataset(name, **kw))


WRITERS = {"cora": lambda r: write_citation_tree(r, "cora"),
           "pubmed": lambda r: write_citation_tree(r, "pubmed", seed=5),
           "arxiv": write_arxiv_tree, "wikics": write_wikics_tree}


@pytest.mark.parametrize("name", ["cora", "pubmed", "arxiv", "wikics"])
def test_raw_trees_load_equal_to_jax(name, tmp_path, caches, no_pyg):
    root = str(tmp_path / "raw" / name)
    n = WRITERS[name](root)
    got, want = _both(name, feat_dim=16, seed=0, root=root)
    assert got.num_nodes == n
    _same_dataset(got, want)
    if name == "cora":
        # networkx's dedup of parallel directed edges, as JAX
        assert got.num_edges < 240
    # the second load is a cache hit in both, in the temporary roots
    assert os.path.exists(port_imp.cache_path(name, "hash", 16))
    assert os.path.exists(jax_imp.cache_path(name, "hash", 16))
    hit, hit_j = _both(name, feat_dim=16, seed=0)
    _same_dataset(hit, hit_j)
    _same_dataset(hit, got)


def test_tfidf_features_of_a_raw_tree_equal_jax(tmp_path, caches, no_pyg):
    root = str(tmp_path / "raw" / "wikics")
    write_wikics_tree(root, n=40)
    got, want = _both("wikics", feat_dim=24, text_encoder="tfidf",
                      root=root)
    _same_dataset(got, want)
    assert os.path.exists(port_imp.cache_path("wikics", "tfidf", 24))


@pytest.mark.parametrize("name,with_train", [("WN18RR", True),
                                             ("FB15K237", False),
                                             ("FB15K237", True)])
def test_kg_triples_load_equal_to_jax(name, with_train, tmp_path, caches):
    """The triple parser: the unknown entities, the malformed lines, the
    splits by position or, without ``train.txt``, JAX's 80/10/10
    resplit; then the cache written by each."""
    root = str(tmp_path / "KG")
    write_kg_tree(root, name, with_train)
    got, want = _both(name, feat_dim=16, root=root)
    _same_dataset(got, want)
    assert got.extras["resplit_missing_train"] == (not with_train)
    assert got.edge_text_feat.shape == (1, 16) and not got.xe.any()
    assert got.num_nodes > 25                     # the "Unknown" entities
    hit, hit_j = _both(name, feat_dim=16)
    _same_dataset(hit, hit_j)
    _same_dataset(hit, got)


def test_kg_default_raw_root_is_under_the_cache_root(caches):
    write_kg_tree(os.path.join(caches["port"], "raw", "KG"), "WN18RR", True)
    ds = port_reg.load_dataset("WN18RR", feat_dim=8)
    assert ds.num_edges == 90


@pytest.mark.parametrize("name", ["cora", "arxiv", "WN18RR"])
def test_missing_raw_files_raise_as_jax(name, caches, no_pyg):
    for reg in (port_reg, jax_reg):
        with pytest.raises(FileNotFoundError):
            reg.load_dataset(name, feat_dim=12, root="/nonexistent-dir")
    assert not os.path.exists(caches["port"])


def _write_reference_cache(path, n=30, e=80, t=3, d=16, full=True):
    rng = np.random.default_rng(4)
    fields = dict(edge_index=torch.tensor(rng.integers(0, n, (2, e))),
                  node_text_feat=torch.tensor(
                      rng.standard_normal((n, d)).astype(np.float32)))
    if full:
        fields.update(
            x=torch.arange(n), xe=torch.tensor(rng.integers(0, t, e)),
            edge_text_feat=torch.tensor(
                rng.standard_normal((t, d)).astype(np.float32)),
            class_node_text_feat=torch.tensor(
                rng.standard_normal((4, d)).astype(np.float32)),
            y=torch.tensor(rng.integers(0, 4, n)))
    data = _register_fake_pyg()
    try:
        torch.save((data(**fields), {"x": torch.tensor([0, n])}), path)
    finally:
        _clear_pyg_modules()


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("first", ["jax", "port"])
def test_reference_cache_imports_in_both_stub_orders(first, full, tmp_path,
                                                     no_pyg):
    """Both packages register stub ``torch_geometric`` modules under the
    same names; whichever installs them first, each package's
    ``import_reference_cache`` reads the pickle, and the two agree."""
    path = str(tmp_path / "geometric_data_processed.pt")
    _write_reference_cache(path, full=full)
    with pytest.raises(ImportError):
        import torch_geometric  # noqa: F401
    (jax_imp if first == "jax" else port_imp)._install_pyg_stub_modules()
    owner = sys.modules["torch_geometric"]
    got = port_imp.import_reference_cache(path, "cora_ref")
    want = jax_imp.import_reference_cache(path, "cora_ref")
    assert sys.modules["torch_geometric"] is owner
    _same_dataset(got, want)
    assert got.num_nodes == 30 and got.num_edges == 80
    if not full:
        assert got.edge_text_feat.shape == (1, 16) and not got.xe.any()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_st_memmap_cache_loads_in_the_other_package(writer, tmp_path,
                                                    caches, no_pyg):
    root = str(tmp_path / "raw" / "cora")
    write_citation_tree(root, "cora", n=2708 // 20)
    ds, ds_j = _both("cora", feat_dim=16, root=root, num_splits=2)
    st = str(tmp_path / "st")
    if writer == "port":
        base = port_imp.save_dataset_cache_memmap(ds, "hash", root=st)
        assert base == jax_imp.st_cache_path("cora", "hash", 16, root=st)
    else:
        base = jax_imp.save_dataset_cache_memmap(ds_j, "hash", root=st)
    got = port_imp.load_dataset_cache_memmap("cora", "hash", 16, root=st)
    want = jax_imp.load_dataset_cache_memmap("cora", "hash", 16, root=st)
    assert isinstance(got.node_text_feat, np.memmap)
    got.extras = want.extras = ds.extras = {}      # extras are not kept
    _same_dataset(got, want)
    _same_dataset(got, ds)
    assert port_imp.load_dataset_cache_memmap("cora", "hash", 8,
                                              root=st) is None


@pytest.mark.parametrize("name", ["cora", "pubmed"])
def test_cache_hit_draws_the_seeded_splits_again(name, tmp_path, caches,
                                                 no_pyg):
    root = str(tmp_path / "raw" / name)
    write_citation_tree(root, name, n=700)
    first, first_j = _both(name, feat_dim=8, seed=0, root=root,
                           num_splits=3)
    _same_dataset(first, first_j)
    again, again_j = _both(name, feat_dim=8, seed=7)
    _same_dataset(again, again_j)
    assert len(again.splits) == 3
    assert not np.array_equal(again.splits[0]["train"],
                              first.splits[0]["train"])
    # seed 0 keeps the cached splits
    zero, _ = _both(name, feat_dim=8, seed=0)
    _same_dataset(zero, first)


def test_finetune_cli_trains_cora_from_raw_files_through_st(tmp_path,
                                                            caches, no_pyg,
                                                            monkeypatch):
    """``finetune --dataset cora --text_encoder ST --device cpu``: the raw
    tree and the DistilBERT snapshot under the cache root, the features
    encoded on the CPU and cached; one epoch.  A ``--feat_dim`` other than
    the model's width fails with that width named."""
    from test_torch_port_text import (VOCAB, _random_hf_distilbert,
                                      _write_snapshot)

    from stemgnn_tpu.nn.distilbert import DistilBertConfig
    monkeypatch.delenv("ST_MODEL_DIR", raising=False)
    root = caches["port"]
    write_citation_tree(os.path.join(root, "raw", "single_graph", "Cora"),
                        "cora", n=300, e=1200)
    width = 24
    cfg = DistilBertConfig(vocab_size=len(VOCAB), dim=width, n_layers=1, n_heads=12,
                           hidden_dim=32)
    _write_snapshot(os.path.join(root, "st_model"),
                    _random_hf_distilbert(cfg, 0))
    argv = ["--device", "cpu", "--debug", "--finetune_dataset", "cora",
            "--text_encoder", "ST", "--hidden_dim", str(width), "--code_dim",
            str(width), "--codebook_size", "8", "--epochs", "1", "--repeat",
            "1",
            "--pretrain_dataset", "na"]
    res = port_cli.main(argv + ["--feat_dim", str(width)])
    assert np.isfinite(res["epoch_losses"][0]["loss"])
    assert os.path.exists(port_imp.cache_path("cora", "ST", width))
    with pytest.raises(ValueError, match=f"--feat_dim {width}"):
        port_cli.main(argv + ["--feat_dim", "16"])
