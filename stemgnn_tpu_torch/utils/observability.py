"""The two parts of ``stemgnn_tpu/utils/observability.py`` that the
pretrain loop uses: a throughput meter and a preemption latch."""

from __future__ import annotations

import signal
import time


class ThroughputMeter:
    """Edges, nodes and steps per second since construction (or
    :meth:`reset`), on the host clock."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.edges = 0
        self.nodes = 0
        self.steps = 0

    def update(self, num_edges: int, num_nodes: int = 0):
        self.edges += int(num_edges)
        self.nodes += int(num_nodes)
        self.steps += 1

    def rates(self) -> dict:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return {"throughput/edges_per_s": self.edges / dt,
                "throughput/nodes_per_s": self.nodes / dt,
                "throughput/steps_per_s": self.steps / dt}


class PreemptionHandler:
    """Latches SIGTERM (by default); training loops poll ``should_stop`` at
    step boundaries.  :meth:`restore` puts the previous handlers back."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.should_stop = False
        self._prev = {}
        for sig in signals:
            self._prev[sig] = signal.signal(sig, self._handler)

    def _handler(self, signum, frame):
        self.should_stop = True

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
