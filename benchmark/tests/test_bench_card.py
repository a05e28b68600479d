"""On the card (skipped without one): a sound run of each cell through
the kernels reads correct, and the control, the plain reference in TF32
put in the program's place, fails the cell's limits on every seed tried.
Run with ``python -m pytest benchmark/tests/test_bench_card.py`` on the
card."""

import pytest

from benchmark import calibrate, compare, run
from benchmark.tests.conftest import tiny_cell

CELLS = ("pretrain.full.arxiv", "finetune.node.arxiv")
SEEDS = (11, 2 ** 31 + 5, 3 * 10 ** 9 + 1)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_on_the_card(card, name):
    res = run.run_cell(tiny_cell(name, n=4000), SEEDS[1], 0.5, False,
                       device="cuda")
    assert res["correct"] is True, res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(card, name):
    w = tiny_cell(name, n=4000)
    got = {}
    for r in calibrate.readings(w, SEEDS, kinds=("program", "control"),
                                device="cuda"):
        ok, _ = compare.judge({k: v for k, v in r.items()
                               if isinstance(v, float)}, w["limits"])
        got[(r["seed"], r["kind"])] = ok
    for seed in SEEDS:
        assert got[(seed, "program")] is True
        assert got[(seed, "control")] is False
