"""``infer --mode encode`` on link datasets (stemgnn_tpu_torch/infer.py)
against the repo's JAX ``infer.py``, on the CPU.

A JAX-format pretrain checkpoint (``encoder_init`` / ``vq_init`` trees and
a ``config.json``) is encoded by both CLIs on ``kg_synthetic`` (11 edge
types) and on the tracked WN18RR cache (one edge-text row): the per-node embeddings and their
quantized form agree to 1e-5 and the codes exactly (a code at a near-tie,
where the two sums round apart, may differ: at most one row).  The port
runs its plain graph and, with the layout forced on the CPU, the typed
layout route (the typed hub block and kernel 2's ``xe`` mode, plain
versions), whose bf16 messages get the bf16-message tolerance 3e-2 and at
most 2% of the rows' codes moved at near-ties (the quantized rows compared
where the codes agree)."""

import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest

from stemgnn_tpu.core import config as jcfg
from stemgnn_tpu.nn.encoder import encoder_init
from stemgnn_tpu.utils import checkpoint as jax_ckpt
from stemgnn_tpu.vq.quantize import vq_init
from stemgnn_tpu_torch import infer as port_infer
from stemgnn_tpu_torch.train import graph_setup as port_setup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
# the layout route builds bf16 messages (JAX's does on its TPU); JAX's CPU
# run sums f32 ones
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _load_jax_infer():
    spec = importlib.util.spec_from_file_location(
        "repo_infer", os.path.join(ROOT, "infer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _checkpoint(path, d):
    enc = jcfg.EncoderConfig(input_dim=d, hidden_dim=d, num_layers=2,
                             normalize="batch", dropout=0.0)
    vq = jcfg.VQConfig(dim=d, codebook_size=16, codebook_dim=d, heads=2)
    ke, kv = jax.random.split(jax.random.PRNGKey(11))
    ep, es = encoder_init(ke, enc)
    vp, vs = vq_init(kv, vq)
    jax_ckpt.save_pytree(str(path / "encoder_50.npz"),
                         {"params": ep, "state": es})
    jax_ckpt.save_pytree(str(path / "vq_50.npz"),
                         {"params": vp, "state": vs})
    with open(path / "config.json", "w") as f:
        json.dump({"encoder": {"hidden_dim": d, "num_layers": 2,
                               "normalize": "batch"},
                   "vq": {"codebook_size": 16, "codebook_dim": d,
                          "heads": 2}}, f)


@pytest.fixture(scope="module")
def jax_encodes(tmp_path_factory):
    """JAX's ``infer.py`` encode of each dataset from its checkpoint, once
    for both of the port's routes: {name: (checkpoint dir, output npz)}."""
    out = {}
    for name, d in (("kg_synthetic", 16), ("WN18RR", 768)):
        base = tmp_path_factory.mktemp(name)
        ckpt_dir = base / "ckpt"
        ckpt_dir.mkdir()
        _checkpoint(ckpt_dir, d)
        out_j = str(base / "jax.npz")
        argv = sys.argv
        sys.argv = ["infer.py", "--finetune_dataset", name, "--feat_dim",
                    str(d), "--pretrain_path", str(ckpt_dir), "--out", out_j]
        try:
            _load_jax_infer().main()
        finally:
            sys.argv = argv
        out[name] = (ckpt_dir, out_j)
    return out


@pytest.mark.parametrize("route", ["plain", "layout"])
@pytest.mark.parametrize("name,d,types", [("kg_synthetic", 16, 11),
                                          ("WN18RR", 768, 1)])
def test_link_encode_matches_jax_infer(name, d, types, route, monkeypatch,
                                       tmp_path, capsys, jax_encodes):
    ckpt_dir, out_j = jax_encodes[name]
    common = ["--finetune_dataset", name, "--feat_dim", str(d),
              "--pretrain_path", str(ckpt_dir)]
    out_p = str(tmp_path / "port.npz")
    if route == "layout":
        monkeypatch.setattr(port_setup, "_layout_applies",
                            lambda cfg, device: True)
    res = port_infer.main([*common, "--out", out_p, "--device", "cpu"])
    a, b = np.load(out_j), np.load(out_p)
    assert set(a.files) == set(b.files) == {"embeddings", "quantized",
                                            "codes"}
    n = res["num_nodes"]
    assert b["embeddings"].shape == (n, d) and b["codes"].shape == (n, 2)
    if route == "layout":
        lay = res["graph"].layout
        assert lay is not None and lay.xe_r is not None
        assert res["graph"].edge_table.shape[0] == types
        assert ("T=11 edge types" in capsys.readouterr().out) == (types > 1)
    tol = TOL if route == "plain" else BF16_TOL
    np.testing.assert_allclose(b["embeddings"], a["embeddings"], **tol)
    rows = (b["codes"] != a["codes"]).any(axis=1)
    assert rows.sum() <= (1 if route == "plain" else n // 50)
    same = ~rows
    np.testing.assert_allclose(b["quantized"][same], a["quantized"][same],
                               **tol)
