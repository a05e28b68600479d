"""Wall-clock probes (counterpart of ``stemgnn_tpu/utils/timer.py``;
reference STEM-GNN/dataset/gp/utils/utils.py:17-46): :class:`SmartTimer`,
and :class:`DeviceTimer`, which waits for the CUDA work behind a value
before it stamps (JAX's ``block_until_ready``): a stamp after an
asynchronous launch would time only the launch."""

from __future__ import annotations

import time

import torch


class SmartTimer:
    """Accumulating named wall-clock probe: :meth:`record` sets the mark,
    :meth:`cal_and_update` adds the seconds since it to ``records[name]``
    and moves the mark."""

    def __init__(self, verbose: bool = True):
        self.verbose = verbose
        self.last = time.time()
        self.records = {}

    def record(self):
        self.last = time.time()

    def cal_and_update(self, name: str):
        now = time.time()
        delta = now - self.last
        self.records[name] = self.records.get(name, 0.0) + delta
        if self.verbose:
            print(name, f"{delta:.4f}s")
        self.last = now
        return delta


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of the tensors in ``value`` (a tensor, or dicts,
    lists and tuples of them)."""
    if torch.is_tensor(value):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    return out


class DeviceTimer(SmartTimer):
    """A :class:`SmartTimer` that synchronizes the CUDA devices of
    ``value`` (or of ``sync_value``) before it stamps; a value on the CPU
    needs no sync."""

    def __init__(self, verbose: bool = True, sync_value=None):
        super().__init__(verbose)
        self._sync_value = sync_value

    def cal_and_update(self, name: str, value=None):
        v = value if value is not None else self._sync_value
        for dev in _cuda_devices(v, set()):
            torch.cuda.synchronize(dev)
        return super().cal_and_update(name)
