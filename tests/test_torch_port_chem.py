"""The port's RDKit-free SMILES featurizer, hash text encoder and molecule
bundles against the JAX package's, bit for bit: ``smiles2graph`` on every
string literal of ``tests/test_chem.py`` and on 2,000 strings of the port's
``random_smiles`` (and a truncation of each of the first 500, most of which
do not parse: both packages raise the same ``SmilesError``);
``HashTextEncoder`` on the atom and bond texts; ``mol_dataset_from_smiles``
in both forms, ``mol_synthetic`` and a ``smiles:<csv>`` file through both
registries; the chem datasets that need downloads raise JAX's error."""

import ast
import os

import numpy as np
import pytest

from stemgnn_tpu.data import chem as jax_chem
from stemgnn_tpu.data import registry as jax_registry
from stemgnn_tpu.data import text_encoder as jax_te
from stemgnn_tpu_torch.data import chem as port_chem
from stemgnn_tpu_torch.data import registry as port_registry
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.data import text_encoder as port_te

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chem_test_strings():
    """Every string literal of ``tests/test_chem.py``: its SMILES, and its
    other strings, which must fail alike."""
    with open(os.path.join(ROOT, "tests", "test_chem.py")) as f:
        tree = ast.parse(f.read())
    return sorted({n.value for n in ast.walk(tree)
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)
                   and "\n" not in n.value})


def _random_strings(n=2000, seed=11):
    rng = np.random.default_rng(seed)
    good = [port_synthetic.random_smiles(rng) for _ in range(n)]
    cut = [s[:int(rng.integers(1, len(s)))] for s in good[:500]]
    return good + cut


def _featurize(mod, s):
    try:
        return mod.smiles2graph(s)
    except Exception as ex:          # compared by type and message
        return (type(ex).__name__, str(ex))


def test_random_smiles_equals_the_bench_generator():
    """The port's copy of ``random_smiles`` draws what
    ``scripts/bench_graph_scale.py`` draws from the same generator."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_graph_scale", os.path.join(ROOT, "scripts",
                                          "bench_graph_scale.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    assert [bench.random_smiles(a) for _ in range(300)] == \
        [port_synthetic.random_smiles(b) for _ in range(300)]


@pytest.mark.parametrize("source", ["test_chem", "random"])
def test_smiles2graph_equals_jax(source):
    strings = (_chem_test_strings() if source == "test_chem"
               else _random_strings())
    parsed = failed = 0
    for i, s in enumerate(strings):
        want, got = _featurize(jax_chem, s), _featurize(port_chem, s)
        if isinstance(want, tuple):
            assert got == want, s
            assert want[0] == "SmilesError" or source == "test_chem", want
            # the generator is valence-safe: only its truncations fail
            assert source == "test_chem" or i >= 2000, s
            failed += 1
            continue
        parsed += 1
        assert set(got) == set(want) == {"edge_list", "edge_feat",
                                         "node_feat", "cycle"}
        assert got["node_feat"] == want["node_feat"], s
        assert got["edge_feat"] == want["edge_feat"], s
        assert got["edge_list"].dtype == want["edge_list"].dtype
        assert np.array_equal(got["edge_list"], want["edge_list"]), s
        assert got["cycle"] == want["cycle"], s
    # the chem tests' molecules parse; the truncations mostly do not
    assert parsed >= (20 if source == "test_chem" else 2000)
    assert failed >= (5 if source == "test_chem" else 200)


def test_hash_encoder_bit_equal():
    texts = ["", "UPPER case, punctuation!", "a a a b", "x" * 300]
    for s in ("c1ccccc1", "N[C@@H](C)C(=O)O", "F/C=C\\F", "[NH4+]"):
        g = jax_chem.smiles2graph(s)
        texts += g["node_feat"] + g["edge_feat"]
    for dim in (768, 32):
        want = jax_te.HashTextEncoder(dim=dim).encode(texts)
        got = port_te.get_text_encoder("hash", dim=dim).encode(texts)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)
    assert not got[0].any()            # no token, no feature


@pytest.mark.parametrize("name,item", [
    pytest.param("tfidf", None, id="tfidf-item 8"),
    pytest.param("ST", "ST_MODEL_DIR", id="ST-item 11"),
    pytest.param("e5", "e5_model", id="e5-item 11"),
    pytest.param("llama2_7b", "llama2_7b", id="llama2_7b-item 11")])
def test_unported_text_encoders_name_their_item(name, item, tmp_path,
                                                monkeypatch):
    """Once refused naming ROADMAP Queue 1 items 8 and 11, now ported:
    ``tfidf`` equals JAX's bit for bit; a neural backend without a local
    snapshot raises ``FileNotFoundError`` naming where it looked (JAX's
    ``e5`` raises so too; its ``ST`` and ``llama2_*`` go to
    ``transformers`` instead, which the port never imports for a missing
    snapshot)."""
    texts = [f"molecule {i} ring {i % 3} bond" for i in range(12)]
    if item is None:
        want = jax_te.get_text_encoder(name, dim=16).encode(texts)
        got = port_te.get_text_encoder(name, dim=16).encode(texts)
        assert np.array_equal(got, want)
        return
    from stemgnn_tpu_torch.data import importers
    monkeypatch.setattr(importers, "DEFAULT_CACHE_ROOT", str(tmp_path))
    for var in ("ST_MODEL_DIR", "E5_MODEL_DIR", "LLAMA2_7B_MODEL_DIR"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(FileNotFoundError, match=item):
        port_te.get_text_encoder(name, dim=16, device="cpu")
    if name == "e5":
        with pytest.raises(FileNotFoundError):
            jax_te.get_text_encoder(name, dim=16,
                                    model_dir=str(tmp_path / "e5_model"))


def _same_bundle(got, want):
    (gp, lp, sp), (gj, lj, sj) = got, want
    assert len(gp) == len(gj)
    assert np.array_equal(lp, lj, equal_nan=True) and lp.dtype == lj.dtype
    for k in ("train", "valid", "test"):
        assert np.array_equal(sp[k], sj[k]), k
    if hasattr(gj, "node_table"):
        assert type(gp).__name__ == "IndexedGraphList"
        for t in ("node_table", "edge_table"):
            a, b = getattr(gp, t), getattr(gj, t)
            assert a.dtype == b.dtype and np.array_equal(a, b), t
        keys = ("x", "senders", "receivers", "xe")
    else:
        keys = ("node_feat", "senders", "receivers", "edge_feat")
    for a, b in zip(gp, gj):
        assert set(a) == set(b) == set(keys)
        for k in keys:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("indexed", [False, True],
                         ids=["materialized", "indexed"])
def test_mol_dataset_from_smiles_equals_jax(indexed):
    rng = np.random.default_rng(2)
    smiles = [port_synthetic.random_smiles(rng) for _ in range(40)] + [
        "c1ccccc1", "C1=CC=CC=C1", "[Na+].[Cl-]", "C"]
    labels = (rng.random((len(smiles), 3)) > 0.5).astype(float)
    labels[rng.random(labels.shape) < 0.3] = np.nan
    names = rng.choice(["train", "valid", "test"], len(smiles))
    args = (smiles, labels, names)
    _same_bundle(port_chem.mol_dataset_from_smiles(*args, dim=24,
                                                   indexed=indexed),
                 jax_chem.mol_dataset_from_smiles(*args, dim=24,
                                                  indexed=indexed))


def test_registry_graph_datasets_equal_jax(tmp_path):
    """``mol_synthetic`` and a ``smiles:<csv>`` file (64 molecules of the
    port's ``write_smiles_csv``, 8 tasks) load equal through both
    registries; ``smiles:`` maps to the graph task."""
    kw = dict(feat_dim=16, seed=3)
    _same_bundle(port_registry.load_dataset("mol_synthetic", **kw),
                 jax_registry.load_dataset("mol_synthetic", **kw))
    path = str(tmp_path / "mols.csv")
    port_synthetic.write_smiles_csv(path, 64, num_tasks=8, seed=4)
    name = f"smiles:{path}"
    assert port_registry.dataset2task[name] == "graph"
    assert port_registry.dataset2task.get(name) == "graph"
    assert port_registry.dataset2task.get("nope") is None
    got = port_registry.load_dataset(name, feat_dim=16)
    _same_bundle(got, jax_registry.load_dataset(name, feat_dim=16))
    labels = got[1]
    assert labels.shape == (64, 8)
    assert 0.4 < np.isnan(labels).mean() < 0.8


@pytest.mark.parametrize("name", ["chemhiv", "chempcba", "chemblpre"])
def test_downloaded_chem_datasets_raise_as_jax(name):
    with pytest.raises(FileNotFoundError) as want:
        jax_registry.load_dataset(name, feat_dim=8)
    with pytest.raises(FileNotFoundError) as got:
        port_registry.load_dataset(name, feat_dim=8)
    assert str(got.value) == str(want.value)
