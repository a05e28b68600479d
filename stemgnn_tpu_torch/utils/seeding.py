"""Seeding of the host-side generators (counterpart of
``stemgnn_tpu/utils/seeding.py``; STEM-GNN/utils/others.py:73-81): Python's
``random``, ``PYTHONHASHSEED`` and numpy's global generator, which samplers
and split generation use.  Torch draws come from explicit
``torch.Generator`` objects and are not seeded here."""

from __future__ import annotations

import os
import random

import numpy as np


def seed_everything(seed: int):
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
