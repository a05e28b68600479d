"""Step-indexed checkpoint manager (counterpart of
``stemgnn_tpu/utils/orbax_ckpt.py``, whose Orbax backend has no PyTorch
counterpart on the card's host; built on ``torch.save`` / ``torch.load``).

A tree is nested dicts, lists and tuples of tensors, numpy arrays and
Python scalars.  :meth:`CheckpointManager.save` copies its tensors to the
host on the calling thread, so training can go on changing them, and one
background thread writes ``<directory>/<step>.pt`` atomically (a temporary
file, then ``os.replace``) and drops the oldest steps beyond
``max_to_keep``.  A restore with a ``template`` takes the template's
structure (its container types, namedtuples included), dtypes (bf16 kept)
and devices.  Numpy leaves are stored as tensors; the files load with
``torch.load(weights_only=True)``.  :func:`save_tree` / :func:`load_tree`
are the one-shot forms.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
from typing import Any, Optional

import numpy as np
import torch

_STEP = re.compile(r"^(\d+)\.pt$")


def _snapshot(tree):
    """``tree`` with every array leaf a CPU tensor of its own (numpy
    arrays converted, tensors copied) and namedtuples as plain tuples."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_snapshot(v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree))
    return tree


def _like(tree, template):
    """``tree`` in ``template``'s structure, dtypes and devices."""
    if isinstance(template, dict):
        return {k: _like(tree[k], v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_like(a, b) for a, b in zip(tree, template, strict=True)]
        if isinstance(template, list):
            return out
        return (type(template)(*out) if hasattr(template, "_fields")
                else tuple(out))
    if torch.is_tensor(template):
        return torch.as_tensor(tree).to(device=template.device,
                                        dtype=template.dtype)
    if isinstance(template, (np.ndarray, np.generic)):
        return np.asarray(torch.as_tensor(tree).numpy(), template.dtype)
    return tree


def _write(path: str, tree):
    """``torch.save`` into a temporary file beside ``path``, then renamed
    into place whole."""
    tmp = os.path.join(os.path.dirname(path),
                       f".{os.path.basename(path)}.tmp")
    torch.save(tree, tmp)
    os.replace(tmp, path)


def _read(path: str, template=None):
    tree = torch.load(path, map_location="cpu", weights_only=True)
    return tree if template is None else _like(tree, template)


def save_tree(path: str, tree: Any):
    """One-shot save of ``tree`` to the file ``path``, atomically."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _write(path, _snapshot(tree))


def load_tree(path: str, template: Any = None):
    """One-shot restore; with ``template``, its structure and dtypes."""
    return _read(os.path.abspath(path), template)


class CheckpointManager:
    """``save(step, tree)`` / ``restore(step)`` over ``directory``, keeping
    the newest ``max_to_keep`` steps (all when None).  With
    ``async_save`` a save returns once the tree is copied to the host and
    its write runs on the manager's one background thread; :meth:`wait`
    (or :meth:`close`, or leaving the ``with`` block) waits for the writes
    and raises a write's error.  The step queries and restores wait
    first."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None,
                 async_save: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._pool = (concurrent.futures.ThreadPoolExecutor(1)
                      if async_save else None)
        self._pending = []

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    def _on_disk(self):
        return sorted(int(m.group(1)) for m in map(
            _STEP.match, os.listdir(self.directory)) if m)

    def _write_and_retain(self, step: int, tree):
        _write(self._path(step), tree)
        if self.max_to_keep is not None:
            steps = self._on_disk()
            for old in steps[:max(len(steps) - self.max_to_keep, 0)]:
                os.remove(self._path(old))

    def save(self, step: int, tree: Any, *, force: bool = False) -> bool:
        """Save ``tree`` as ``step``; a step already saved raises unless
        ``force`` (which overwrites it).  Returns True."""
        self.wait()
        if not force and os.path.exists(self._path(step)):
            raise ValueError(f"step {step} is already saved in "
                             f"{self.directory}")
        snap = _snapshot(tree)
        if self._pool is None:
            self._write_and_retain(step, snap)
        else:
            self._pending.append(self._pool.submit(
                self._write_and_retain, step, snap))
        return True

    def restore(self, step: Optional[int] = None, template: Any = None):
        """Restore ``step`` (default: the latest; None when there is
        none); with ``template``, its structure and dtypes."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        self.wait()
        return _read(self._path(step), template)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        self.wait()
        return self._on_disk()

    def wait(self):
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self):
        self.wait()
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
