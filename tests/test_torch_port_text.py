"""The text encoders of the port (``stemgnn_tpu_torch/nn/{distilbert,bert,
llama}.py`` and ``data/text_encoder.py``) against the JAX package's on the
CPU: the WordPiece tokenizer's ids and masks and the tfidf features bit
for bit; DistilBERT, BERT and Llama forwards and poolings within 1e-5
relative in f32 (weights carried across by ``utils.convert``); each
Hugging Face state-dict import; the three encoders end to end from a
snapshot written here.  No pretrained weights: every model is seeded.
``transformers`` is never imported: the Llama tokenizer is a stub."""

import dataclasses
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from stemgnn_tpu.data import text_encoder as jax_te
from stemgnn_tpu.nn import bert as jax_bert
from stemgnn_tpu.nn import distilbert as jax_db
from stemgnn_tpu.nn import llama as jax_llama
from stemgnn_tpu_torch.data import importers
from stemgnn_tpu_torch.data import text_encoder as port_te
from stemgnn_tpu_torch.nn import bert as port_bert
from stemgnn_tpu_torch.nn import distilbert as port_db
from stemgnn_tpu_torch.nn import llama as port_llama
from stemgnn_tpu_torch.utils.convert import language_model_from_jax

RTOL = 1e-5

# a vocab with the specials, whole words, continuation pieces and accented
# forms (stripped by the tokenizer, so never matched)
WORDS = ["the", "graph", "node", "edge", "paper", "cat", "##s", "##ing",
         "##ed", "un", "##known", "learn", "model", "a", "b", "c", "##d",
         "caf", "##e", "naive", ".", ",", "!", "?", "(", ")", "-", "'",
         "\"", ":", ";", "1", "2", "##3", "cafe", "ubung"]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
TEXTS = [
    "The graph nodes, the edges!",
    "Café naïve Übung -- learning (models)?",
    "unknown unknowns: a b c d 123 cats",
    "x" * 101 + " paper " + "y" * 100,
    "zebra qqq papers' \"quoted\" text; semi:colon",
    "",
    "  many   spaces\tand\ttabs\nnewline  ",
    "café combining accent and emoji \U0001F600 !",
]


def _write_vocab(path):
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(VOCAB) + "\n")


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cfg(cls, jax_cfg):
    return cls(**dataclasses.asdict(jax_cfg))


# ------------------------------------------------------------- tokenizer

@pytest.mark.parametrize("max_length,pad_multiple", [(512, 64), (12, 8),
                                                     (7, 64)])
def test_wordpiece_tokenizer_ids_and_masks_equal_jax(tmp_path, max_length,
                                                     pad_multiple):
    path = str(tmp_path / "vocab.txt")
    _write_vocab(path)
    tj = jax_db.WordPieceTokenizer.from_vocab_file(path)
    tp = port_db.WordPieceTokenizer.from_vocab_file(path)
    for t in TEXTS:
        assert tp._basic(t) == tj._basic(t)
        assert tp.encode(t, max_length) == tj.encode(t, max_length)
    ids_j, mask_j = tj.batch(TEXTS, max_length, pad_multiple)
    ids_p, mask_p = tp.batch(TEXTS, max_length, pad_multiple)
    assert ids_p.dtype == ids_j.dtype == np.int32
    assert np.array_equal(ids_p, ids_j) and np.array_equal(mask_p, mask_j)
    # the long words and the unknown pieces map to [UNK]
    assert tp.unk in tp.encode(TEXTS[3]) and tp.unk in tp.encode(TEXTS[4])


# ------------------------------------------------------------ the models

def _ids_mask(rng, vocab, b, length):
    ids = rng.integers(0, vocab, size=(b, length)).astype(np.int32)
    mask = np.ones((b, length), np.int32)
    mask[0, length // 2:] = 0
    mask[2] = 0                      # an all-zero row: uniform attention
    return ids, mask


def test_distilbert_forward_and_pool_equal_jax():
    cfg = jax_db.DistilBertConfig(vocab_size=90, dim=64, n_layers=2,
                                  n_heads=4, hidden_dim=128,
                                  max_position_embeddings=40)
    params = jax_db.distilbert_init(jax.random.PRNGKey(0), cfg)
    model = language_model_from_jax(
        _np_tree(params), _port_cfg(port_db.DistilBertConfig, cfg))
    ids, mask = _ids_mask(np.random.default_rng(0), 90, 4, 24)
    want = np.asarray(jax_db.distilbert_apply(params, cfg, ids, mask))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        pooled = port_db.mean_pool_normalize(got, torch.from_numpy(mask))
    assert np.isfinite(want).all()
    _close(got, want)
    _close(pooled, jax_db.mean_pool_normalize(want, mask))


def test_bert_forward_and_e5_pool_equal_jax():
    cfg = jax_bert.BertConfig(vocab_size=90, dim=64, n_layers=2, n_heads=4,
                              hidden_dim=128, max_position_embeddings=40)
    params = _hf_to_jax_bert(_random_hf_bert(cfg, 1), cfg)
    model = language_model_from_jax(_np_tree(params),
                                    _port_cfg(port_bert.BertConfig, cfg))
    rng = np.random.default_rng(1)
    ids, mask = _ids_mask(rng, 90, 3, 20)
    tt = rng.integers(0, 2, size=ids.shape).astype(np.int32)
    for types_ in (None, tt):
        want = np.asarray(jax_bert.bert_apply(params, cfg, ids, mask,
                                              types_))
        with torch.no_grad():
            got = model(torch.from_numpy(ids).long(),
                        torch.from_numpy(mask),
                        None if types_ is None
                        else torch.from_numpy(types_).long())
        _close(got, want)
        _close(port_bert.e5_average_pool(got, torch.from_numpy(mask)),
               jax_bert.e5_average_pool(want, mask))


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_llama_forward_and_pool_equal_jax(kv_heads):
    cfg = jax_llama.LlamaConfig(vocab_size=80, dim=64, n_layers=2,
                                n_heads=4, n_kv_heads=kv_heads,
                                hidden_dim=96)
    params = _hf_to_jax_llama(_random_hf_llama(cfg, 2), cfg)
    model = language_model_from_jax(_np_tree(params),
                                    _port_cfg(port_llama.LlamaConfig, cfg))
    ids, mask = _ids_mask(np.random.default_rng(2), 80, 3, 16)
    for m in (None, mask):
        want = np.asarray(jax_llama.llama_apply(params, cfg, ids, m))
        with torch.no_grad():
            got = model(torch.from_numpy(ids).long(),
                        None if m is None else torch.from_numpy(m))
        assert np.isfinite(want).all()
        _close(got, want)
        _close(port_llama.llama_mean_pool(got),
               jax_llama.llama_mean_pool(want))


# ---------------------------------------------- Hugging Face state dicts

def _rand(gen, *shape, scale=0.1):
    return torch.randn(*shape, generator=gen) * scale


def _random_hf_distilbert(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    d, f = cfg.dim, cfg.hidden_dim
    sd = {"embeddings.word_embeddings.weight": _rand(g, cfg.vocab_size, d),
          "embeddings.position_embeddings.weight":
              _rand(g, cfg.max_position_embeddings, d),
          "embeddings.LayerNorm.weight": 1 + _rand(g, d),
          "embeddings.LayerNorm.bias": _rand(g, d)}
    for i in range(cfg.n_layers):
        p = f"transformer.layer.{i}"
        for name, (o, n) in {"attention.q_lin": (d, d),
                             "attention.k_lin": (d, d),
                             "attention.v_lin": (d, d),
                             "attention.out_lin": (d, d),
                             "ffn.lin1": (f, d), "ffn.lin2": (d, f)}.items():
            sd[f"{p}.{name}.weight"] = _rand(g, o, n)
            sd[f"{p}.{name}.bias"] = _rand(g, o)
        for ln in ("sa_layer_norm", "output_layer_norm"):
            sd[f"{p}.{ln}.weight"] = 1 + _rand(g, d)
            sd[f"{p}.{ln}.bias"] = _rand(g, d)
    # a full SequenceClassification checkpoint: the prefix is stripped
    return {"distilbert." + k: v for k, v in sd.items()}


def _random_hf_bert(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    d, f = cfg.dim, cfg.hidden_dim
    sd = {"embeddings.word_embeddings.weight": _rand(g, cfg.vocab_size, d),
          "embeddings.position_embeddings.weight":
              _rand(g, cfg.max_position_embeddings, d),
          "embeddings.token_type_embeddings.weight":
              _rand(g, cfg.type_vocab_size, d),
          "embeddings.LayerNorm.weight": 1 + _rand(g, d),
          "embeddings.LayerNorm.bias": _rand(g, d),
          "pooler.dense.weight": _rand(g, d, d),
          "pooler.dense.bias": _rand(g, d)}
    for i in range(cfg.n_layers):
        p = f"encoder.layer.{i}"
        for name, (o, n) in {"attention.self.query": (d, d),
                             "attention.self.key": (d, d),
                             "attention.self.value": (d, d),
                             "attention.output.dense": (d, d),
                             "intermediate.dense": (f, d),
                             "output.dense": (d, f)}.items():
            sd[f"{p}.{name}.weight"] = _rand(g, o, n)
            sd[f"{p}.{name}.bias"] = _rand(g, o)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{p}.{ln}.weight"] = 1 + _rand(g, d)
            sd[f"{p}.{ln}.bias"] = _rand(g, d)
    return sd


def _random_hf_llama(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    d, f = cfg.dim, cfg.hidden_dim
    kv = cfg.n_kv_heads * (d // cfg.n_heads)
    sd = {"model.embed_tokens.weight": _rand(g, cfg.vocab_size, d, scale=1),
          "model.norm.weight": 1 + _rand(g, d),
          "lm_head.weight": _rand(g, cfg.vocab_size, d)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}"
        for name, shape in {"self_attn.q_proj": (d, d),
                            "self_attn.k_proj": (kv, d),
                            "self_attn.v_proj": (kv, d),
                            "self_attn.o_proj": (d, d),
                            "mlp.gate_proj": (f, d), "mlp.up_proj": (f, d),
                            "mlp.down_proj": (d, f)}.items():
            sd[f"{p}.{name}.weight"] = _rand(g, *shape)
        for ln in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{p}.{ln}.weight"] = 1 + _rand(g, d)
    return sd


def _hf_to_jax_bert(sd, cfg):
    return jax_bert.import_hf_bert_state_dict(sd, cfg)


def _hf_to_jax_llama(sd, cfg):
    return jax_llama.import_hf_llama_state_dict(sd, cfg)


def _state_of(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("kind", ["distilbert", "bert", "llama"])
def test_hf_import_equals_jax_import(kind):
    """Each importer maps a Hugging Face state dict (with its prefix, and
    the unused pooler / LM head) onto the same weights as JAX's, in the
    same [in, out] layout; the import keeps views of the given tensors."""
    if kind == "distilbert":
        cfg = jax_db.DistilBertConfig(vocab_size=50, dim=32, n_layers=2,
                                      n_heads=4, hidden_dim=48,
                                      max_position_embeddings=20)
        sd = _random_hf_distilbert(cfg, 3)
        want = jax_db.import_hf_state_dict(sd, cfg)
        got = port_db.import_hf_state_dict(
            sd, _port_cfg(port_db.DistilBertConfig, cfg))
    elif kind == "bert":
        cfg = jax_bert.BertConfig(vocab_size=50, dim=32, n_layers=2,
                                  n_heads=2, hidden_dim=48,
                                  max_position_embeddings=20)
        sd = _random_hf_bert(cfg, 4)
        want = jax_bert.import_hf_bert_state_dict(sd, cfg)
        got = port_bert.import_hf_bert_state_dict(
            {"bert." + k: v for k, v in sd.items()},
            _port_cfg(port_bert.BertConfig, cfg))
    else:
        cfg = jax_llama.LlamaConfig(vocab_size=50, dim=32, n_layers=2,
                                    n_heads=4, n_kv_heads=2, hidden_dim=48)
        sd = _random_hf_llama(cfg, 5)
        want = jax_llama.import_hf_llama_state_dict(sd, cfg)
        got = port_llama.import_hf_llama_state_dict(
            sd, _port_cfg(port_llama.LlamaConfig, cfg))
    from stemgnn_tpu_torch.utils.convert import _flat_names
    want_flat = {k: np.asarray(v) for k, v in _flat_names(want).items()}
    got_flat = _state_of(got)
    assert set(got_flat) == set(want_flat)
    for k, v in want_flat.items():
        assert got_flat[k].shape == v.shape and np.array_equal(
            got_flat[k], v), k
    assert not any(p.requires_grad for p in got.parameters())


# ------------------------------------------------ encoders from snapshots

def _write_snapshot(path, sd, safetensors=False):
    os.makedirs(path, exist_ok=True)
    _write_vocab(os.path.join(path, "vocab.txt"))
    if safetensors:
        from safetensors.torch import save_file
        save_file({k: v.contiguous() for k, v in sd.items()},
                  os.path.join(path, "model.safetensors"))
    else:
        torch.save(sd, os.path.join(path, "pytorch_model.bin"))


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS + ["zzz", "Café"], size=int(k)))
            for k in rng.integers(1, 90, size=n)]


def test_sentence_encoder_equals_jax_from_a_snapshot(tmp_path):
    """``ST`` end to end: the snapshot's config inferred as JAX infers it
    (12 heads, 512 positions), batches of 4 over 11 texts (JAX pads the
    last batch with all-zero masks), masked mean + l2 norm."""
    cfg = jax_db.DistilBertConfig(vocab_size=len(VOCAB), dim=48, n_layers=2,
                                  n_heads=12, hidden_dim=64)
    _write_snapshot(str(tmp_path), _random_hf_distilbert(cfg, 6))
    texts = _texts(11, 6)
    want = jax_te.JaxSentenceEncoder(str(tmp_path), batch_size=4,
                                     max_length=70).encode(texts)
    enc = port_te.get_text_encoder("ST", dim=16, device="cpu",
                                   model_dir=str(tmp_path), batch_size=4,
                                   max_length=70)
    assert isinstance(enc, port_te.SentenceEncoder)
    assert enc.model.cfg == _port_cfg(port_db.DistilBertConfig, cfg)
    got = enc.encode(texts)
    assert got.dtype == np.float32 and got.shape == (11, 48)
    _close(got, want)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    hist = enc.history
    assert hist["texts"] == 11 and len(hist["tokenize_ms"]) == 3
    assert hist["tokens"] == sum(len(enc.tokenizer.encode(t, 70))
                                 for t in texts)
    assert hist["device_ms"] == []          # CUDA events on a card only


def test_e5_encoder_equals_jax_from_a_snapshot(tmp_path, monkeypatch):
    """``e5`` end to end from ``model.safetensors`` (heads = dim // 64, the
    masked mean without an l2 norm), through ``E5_MODEL_DIR``."""
    cfg = jax_bert.BertConfig(vocab_size=len(VOCAB), dim=128, n_layers=2,
                              n_heads=2, hidden_dim=96)
    _write_snapshot(str(tmp_path), _random_hf_bert(cfg, 7), safetensors=True)
    texts = _texts(5, 7)
    want = jax_te.JaxE5Encoder(str(tmp_path), batch_size=2).encode(texts)
    monkeypatch.setenv("E5_MODEL_DIR", str(tmp_path))
    enc = port_te.get_text_encoder("e5", device="cpu", batch_size=2)
    assert enc.model.cfg == _port_cfg(port_bert.BertConfig, cfg)
    got = enc.encode(texts)
    _close(got, want)
    assert not np.allclose(np.linalg.norm(got, axis=1), 1.0)


class _StubLlamaTokenizer:
    """Stands in for ``transformers.AutoTokenizer`` (never imported here):
    ids from the characters, right-padded with EOS to the batch's longest
    text, truncated at ``max_length``."""
    eos_token, eos_token_id = "</s>", 2

    @classmethod
    def from_pretrained(cls, path, local_files_only=False):
        assert local_files_only
        return cls()

    def __call__(self, texts, padding, truncation, max_length):
        assert padding == "longest" and truncation
        seqs = [[1] + [3 + ord(c) % 70 for c in t][: max_length - 1]
                for t in texts]
        n = max(len(s) for s in seqs)
        return {"input_ids": [s + [self.eos_token_id] * (n - len(s))
                              for s in seqs],
                "attention_mask": [[1] * len(s) + [0] * (n - len(s))
                                   for s in seqs]}


def test_llama_encoder_equals_jax_from_a_snapshot(tmp_path, monkeypatch):
    """``llama2_7b`` end to end: heads = dim // 128, the KV heads from
    ``k_proj``'s rows (grouped: 2 heads, 1 KV head), ids EOS-padded to a
    multiple of 64 and the UNMASKED mean over all of them; ``encode_ids``
    takes tokenized rows the same way."""
    stub = types.ModuleType("transformers")
    stub.AutoTokenizer = _StubLlamaTokenizer
    monkeypatch.setitem(sys.modules, "transformers", stub)
    cfg = jax_llama.LlamaConfig(vocab_size=80, dim=256, n_layers=2,
                                n_heads=2, n_kv_heads=1, hidden_dim=64)
    _write_snapshot(str(tmp_path), _random_hf_llama(cfg, 8))
    texts = ["short", "a somewhat longer text " * 4, "mid length text"]
    want = jax_te.JaxLlamaEncoder(str(tmp_path), batch_size=2).encode(texts)
    monkeypatch.setenv("LLAMA2_7B_MODEL_DIR", str(tmp_path))
    enc = port_te.get_text_encoder("llama2_7b", device="cpu", batch_size=2)
    assert enc.model.cfg == _port_cfg(port_llama.LlamaConfig, cfg)
    got = enc.encode(texts)
    _close(got, want)
    assert enc.history["positions"] == 2 * 128 + 64
    # the padded length changes the embedding: the mean counts the EOS rows
    ids = np.asarray(_StubLlamaTokenizer()(texts[:2], "longest", True,
                                           500)["input_ids"])
    by_ids = enc.encode_ids(ids)
    _close(by_ids, want[:2])
    padded = np.pad(ids, ((0, 0), (0, 64)), constant_values=2)
    assert not np.allclose(enc.encode_ids(padded), by_ids)


# ------------------------------------------------------ the other routes

@pytest.mark.parametrize("n,dim", [(40, 16), (6, 32)])
def test_tfidf_equals_jax_bit_for_bit(n, dim):
    texts = _texts(n, n) + ["", "the the the"]
    want = jax_te.get_text_encoder("tfidf", dim=dim).encode(texts)
    got = port_te.get_text_encoder("tfidf", dim=dim).encode(texts)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_st_without_a_snapshot_raises(tmp_path, monkeypatch):
    """JAX falls back to ``transformers`` on the CPU; the port raises,
    naming ``ST_MODEL_DIR`` and the files it needs.  Without the variable
    it looks under the cache root."""
    monkeypatch.setattr(importers, "DEFAULT_CACHE_ROOT", str(tmp_path))
    monkeypatch.delenv("ST_MODEL_DIR", raising=False)
    with pytest.raises(FileNotFoundError) as info:
        port_te.get_text_encoder("ST", device="cpu")
    msg = str(info.value)
    assert "ST_MODEL_DIR" in msg and "vocab.txt" in msg
    assert str(tmp_path / "st_model") in msg
    monkeypatch.setenv("ST_MODEL_DIR", str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError, match="nowhere"):
        port_te.get_text_encoder("st", device="cpu")
    with pytest.raises(ValueError):
        port_te.get_text_encoder("bag_of_words")


def test_neural_encoders_default_to_the_card(tmp_path):
    """Without ``device`` a neural backend asks for CUDA, and raises here
    where there is none: no slide to the CPU."""
    cfg = jax_db.DistilBertConfig(vocab_size=len(VOCAB), dim=24, n_layers=1,
                                  n_heads=12, hidden_dim=16)
    _write_snapshot(str(tmp_path), _random_hf_distilbert(cfg, 9))
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_te.get_text_encoder("ST", model_dir=str(tmp_path))
