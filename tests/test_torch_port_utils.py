"""The port's last utilities against the JAX package on the CPU:
``train/trainer.py`` (``EvalKit``, ``fit``, ``test``), ``utils/grid.py``,
``utils/timer.py``, ``utils/graph_utils.py`` and ``utils/ckpt_manager.py``
(the counterpart of ``utils/orbax_ckpt.py``).

  * ``fit`` on the same step functions as JAX's ``fit``: the best record,
    the Logger's curves and best rows, the epochs run (early stop) and the
    ``on_best`` calls, for both modes, evaluation cadences and patiences.
  * ``grid_search`` / ``combine_dict`` / ``merge_mod`` on
    ``tests/test_zoo.py``'s cases and more, equal to JAX's.
  * ``flip_edges`` (directed and undirected edge lists), ``mask2idx`` /
    ``idx2mask`` equal to JAX's; ``active_code`` on converted parameters
    equal to JAX's.
  * ``SmartTimer`` / ``DeviceTimer`` on CPU values: no device sync.
  * The checkpoint manager on ``tests/test_end_to_end.py``'s tree:
    retention ``[2, 3]``, latest 3, the template's dtypes with bf16, values
    equal to what JAX's Orbax manager restores; the one-shot forms, a
    namedtuple and numpy template, the synchronous writer, ``force``.
"""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemgnn_tpu.core import config as jcfg
from stemgnn_tpu.core.graph import make_graph as jax_make_graph
from stemgnn_tpu.nn.encoder import encoder_init
from stemgnn_tpu.train import trainer as jtrainer
from stemgnn_tpu.utils import graph_utils as jgu
from stemgnn_tpu.utils import grid as jgrid
from stemgnn_tpu.utils.orbax_ckpt import OrbaxCheckpointManager
from stemgnn_tpu.vq import vq_init
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.core.graph import make_graph as port_make_graph
from stemgnn_tpu_torch.train import trainer as ptrainer
from stemgnn_tpu_torch.utils import ckpt_manager as pckpt
from stemgnn_tpu_torch.utils import graph_utils as pgu
from stemgnn_tpu_torch.utils import grid as pgrid
from stemgnn_tpu_torch.utils import timer as ptimer
from stemgnn_tpu_torch.utils.convert import from_jax_pytree


# --------------------------------------------------------------- trainer

VALS = [50.0, 55.0, 55.0, 53.0, 60.0, 58.0, 57.0, 59.0, 56.0, 54.0, 52.0,
        51.0]


def _fit(mod, mode, eval_every, patience):
    """``mod.fit`` on a counter state with a fixed validation curve;
    returns the best record, the Logger's curves, the epochs trained and
    the ``on_best`` epochs."""
    trained, bests = [], []
    sign = 1.0 if mode == "max" else -1.0

    def train_epoch(state, epoch):
        trained.append(epoch)
        return state + 1, {"loss": 1.0 / (epoch + 1)}

    def eval_fn(state):
        v = sign * VALS[state - 1]
        return {"train": v + 1.0, "val": v, "test": v - 1.0}
    kit = mod.EvalKit(metrics={"acc": lambda p, t: float(np.mean(p == t))},
                      select="acc" if mode == "max" else "loss", mode=mode)
    state, best, logger = mod.fit(
        train_epoch, eval_fn, 0, epochs=len(VALS), evalkit=kit,
        patience=patience, eval_every=eval_every,
        on_best=lambda s, e: bests.append((s, e)))
    assert mod.test(eval_fn, state, kit) == eval_fn(state)
    return best, logger.data, logger.best, trained, bests, kit.evaluate(
        np.asarray([1, 2, 3]), np.asarray([1, 0, 3]))


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("eval_every,patience", [(1, None), (1, 3), (2, 2)])
def test_fit_matches_jax(mode, eval_every, patience):
    want = _fit(jtrainer, mode, eval_every, patience)
    got = _fit(ptrainer, mode, eval_every, patience)
    assert got == want
    if patience == 3 and mode == "max":
        assert got[3] == list(range(8))        # stopped after epoch 7


# ------------------------------------------------------------------ grid

def test_grid_combine_and_merge_match_jax():
    spaces = [{"lr": [1, 2], "wd": ["a"]},
              {"a": [1, 2, 3], "b": [None, True], "c": [0.5]}, {}]
    for space in spaces:
        assert list(pgrid.grid_search(space)) == \
            list(jgrid.grid_search(space))
    assert list(pgrid.grid_search({"lr": [1, 2], "wd": ["a"]})) == \
        [{"lr": 1, "wd": "a"}, {"lr": 2, "wd": "a"}]
    for dicts in [({"a": 1}, {"a": 2, "b": 3}), ({"a": 1}, None, {}),
                  ({}, {"x": [1]}, {"x": 2, "y": 3})]:
        assert pgrid.combine_dict(*dicts) == jgrid.combine_dict(*dicts)
    mods = ["x=5", "name=abc", "flag=True", "lst=[1, 2]", "f=1e-3",
            "eq=a=b", "none=None", "bad=[1,"]
    assert pgrid.merge_mod({"x": 1, "k": 0}, mods) == \
        jgrid.merge_mod({"x": 1, "k": 0}, mods)
    assert pgrid.merge_mod({"x": 1}, ["x=5", "name=abc", "flag=True"]) == \
        {"x": 5, "name": "abc", "flag": True}


# ----------------------------------------------------------- graph utils

@pytest.mark.parametrize("undirected", [True, False])
@pytest.mark.parametrize("p,seed", [(0.2, 0), (0.5, 3)])
def test_flip_edges_and_masks_match_jax(undirected, p, seed):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, 40, (2, 150))
    if undirected:
        ei = np.concatenate([ei, ei[::-1]], axis=1)
    want = jgu.flip_edges(ei, 40, p=p, seed=seed)
    got = pgu.flip_edges(ei, 40, p=p, seed=seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    mask = rng.random(40) < 0.3
    np.testing.assert_array_equal(pgu.mask2idx(mask), jgu.mask2idx(mask))
    idx = np.flatnonzero(mask)
    np.testing.assert_array_equal(pgu.idx2mask(idx, 40),
                                  jgu.idx2mask(idx, 40))


def test_active_code_matches_jax():
    d = 16
    ecfg = jcfg.EncoderConfig(input_dim=d, hidden_dim=d, num_layers=2,
                              normalize="batch", dropout=0.0)
    vcfg = jcfg.VQConfig(dim=d, codebook_size=8, codebook_dim=8, heads=2)
    ke, kv = jax.random.split(jax.random.PRNGKey(3))
    ep, es = encoder_init(ke, ecfg)
    vp, vs = vq_init(kv, vcfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((60, d)).astype(np.float32)
    s, r = rng.integers(0, 60, (2, 300))
    ef = rng.standard_normal((300, d)).astype(np.float32)
    gj = jax_make_graph(x, s, r, edge_feat=ef)
    gp = port_make_graph(x, s, r, edge_feat=ef)
    want = jgu.active_code(ep, es, ecfg, vp, vs, vcfg, gj)
    tree = jax.tree.map(np.asarray, ({"encoder": ep, "vq": vp},
                                     {"encoder": es, "vq": vs}))
    pc = pcfg.FinetuneConfig(
        encoder=pcfg.EncoderConfig(input_dim=d, hidden_dim=d, num_layers=2,
                                   normalize="batch", dropout=0.0),
        vq=pcfg.VQConfig(dim=d, codebook_size=8, codebook_dim=8, heads=2))
    enc, vq = from_jax_pytree(*tree, pc)
    enc.train()
    got = pgu.active_code(enc, vq, gp)
    assert enc.training and not vq.training         # modes restored
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and 0 < got[1] <= 1


# ---------------------------------------------------------------- timers

def test_timers_on_cpu_values(monkeypatch, capsys):
    def no_sync(*a):
        raise AssertionError("a CPU value synchronized a device")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    t = ptimer.SmartTimer(verbose=True)
    t.record()
    d1 = t.cal_and_update("a")
    d2 = t.cal_and_update("a")
    assert d1 >= 0 and d2 >= 0 and t.records["a"] == pytest.approx(d1 + d2)
    assert capsys.readouterr().out.count("a ") == 2
    dt = ptimer.DeviceTimer(verbose=False,
                            sync_value={"z": torch.ones(3),
                                        "l": [torch.zeros(2), (1, "x")]})
    dt.cal_and_update("step")
    dt.cal_and_update("step", value=[torch.ones(1)])
    dt.cal_and_update("host", value=3.0)
    assert set(dt.records) == {"step", "host"}
    assert ptimer._cuda_devices({"a": [torch.ones(1)], "b": 2}, set()) == \
        set()


# ----------------------------------------------------------- checkpoints

def _tree(scale=1):
    return {"a": torch.arange(6.0).reshape(2, 3) * scale,
            "b": [torch.ones(4) * scale, torch.zeros((2, 2),
                                                     dtype=torch.int32)],
            "c": {"d": torch.tensor(3.5 * scale, dtype=torch.bfloat16)}}


def _jax_tree(scale=1):
    return {"a": jnp.arange(6.0).reshape(2, 3) * scale,
            "b": [jnp.ones(4) * scale, jnp.zeros((2, 2), jnp.int32)],
            "c": {"d": jnp.asarray(3.5 * scale, jnp.bfloat16)}}


def test_manager_matches_orbax(tmp_path):
    with OrbaxCheckpointManager(str(tmp_path / "jax"), max_to_keep=2) as m:
        for s in (1, 2, 3):
            m.save(s, _jax_tree(s))
        m.wait()
        want_steps, want_latest = m.all_steps(), m.latest_step()
        want = m.restore(3, template=_jax_tree())
    with pckpt.CheckpointManager(str(tmp_path / "port"), max_to_keep=2) as m:
        for s in (1, 2, 3):
            tree = _tree(s)
            m.save(s, tree)
            tree["a"].add_(100.0)       # the save copied it first
        assert m.all_steps() == want_steps == [2, 3]
        assert m.latest_step() == want_latest == 3
        got = m.restore(3, template=_tree())
        assert m.restore(template=_tree())["c"]["d"] == got["c"]["d"]
        assert sorted(os.listdir(m.directory)) == ["2.pt", "3.pt"]
    for k, (g, w) in {"a": (got["a"], want["a"]),
                      "b0": (got["b"][0], want["b"][0]),
                      "b1": (got["b"][1], want["b"][1]),
                      "d": (got["c"]["d"], want["c"]["d"])}.items():
        assert str(g.dtype).split(".")[-1] == str(w.dtype), k
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32), err_msg=k)
    assert got["c"]["d"].dtype == torch.bfloat16


def test_manager_templates_and_one_shot_forms(tmp_path):
    Pair = collections.namedtuple("Pair", "mu nu")
    tree = {"p": Pair(torch.ones(2), np.arange(3, dtype=np.int64)),
            "n": np.float32(2.5), "k": 7}
    pckpt.save_tree(str(tmp_path / "one" / "t.pt"), tree)
    raw = pckpt.load_tree(str(tmp_path / "one" / "t.pt"))
    assert isinstance(raw["p"], tuple) and torch.is_tensor(raw["p"][1])
    back = pckpt.load_tree(str(tmp_path / "one" / "t.pt"), template=tree)
    assert isinstance(back["p"], Pair) and back["k"] == 7
    assert isinstance(back["p"].nu, np.ndarray)
    assert back["p"].nu.dtype == np.int64
    np.testing.assert_array_equal(back["p"].nu, tree["p"].nu)
    assert back["n"] == 2.5 and back["n"].dtype == np.float32
    with pckpt.CheckpointManager(str(tmp_path / "sync"),
                                 async_save=False) as m:
        assert m.restore() is None and m.latest_step() is None
        m.save(5, {"w": torch.ones(2)})
        with pytest.raises(ValueError, match="already saved"):
            m.save(5, {"w": torch.zeros(2)})
        m.save(5, {"w": torch.zeros(2)}, force=True)
        m.save(9, {"w": torch.full((2,), 9.0)})
        assert m.all_steps() == [5, 9]
        assert torch.equal(m.restore(5)["w"], torch.zeros(2))
        assert torch.equal(m.restore()["w"], torch.full((2,), 9.0))
        assert not [f for f in os.listdir(m.directory) if "tmp" in f]
