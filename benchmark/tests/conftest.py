"""Fixtures of the benchmark's own tests: each cell cut to a size a CPU
test run holds (the widths of the configuration and the graph's scale cut
here only), and the ``card`` marker of tests that need a CUDA device."""

import copy

import pytest
import torch

from benchmark import common

TINY_NODES = 300


def tiny_cell(name: str, n: int = TINY_NODES) -> dict:
    """Workload ``name`` as ``common.cell`` finds it, with widths of 16, a
    2-head VQ of 8 codes, 5 classes and an ``n``-node graph."""
    w = copy.deepcopy(common.cell(name))
    c = w["conf"]
    c["encoder"].update(input_dim=16, hidden_dim=16)
    c["vq"].update(dim=16, codebook_dim=16, codebook_size=8, heads=2,
                   orthogonal_reg_max_codes=4)
    if c.get("batch_size"):
        c["batch_size"] = (n + 127) // 128 * 128
    if "num_classes" in c:
        c["num_classes"] = 5
    w["traffic_mix"]["graph"].update(num_nodes=n, num_classes=5,
                                     avg_degree=6,
                                     split={"train": 150, "valid": 50})
    return w


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    """Skip, inside the test, where no CUDA device is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    return torch.device("cuda")
