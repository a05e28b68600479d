"""The parts of ``stemgnn_tpu/utils/observability.py`` that the port uses:
the wandb sweep round-trip of the evaluation scripts, and the pretrain
loop's preemption latch."""

from __future__ import annotations

import signal


def apply_wandb_sweep_config(args, project: str, debug: bool = False):
    """The wandb sweep round-trip: ``wandb.init(config=vars(args))``, then
    read the hyperparameters back from ``wandb.config`` so that a sweep
    agent's overrides drive the run.

    Mutates ``args`` in place with every key the sweep changed (coerced to
    the existing attribute's type) and returns it.  A no-op when the wandb
    SDK is missing, when its init fails, or with ``debug``."""
    if debug:
        return args
    try:
        import wandb
    except Exception:
        return args
    base = {k: v for k, v in vars(args).items()
            if isinstance(v, (int, float, str, bool, type(None)))}
    try:
        if wandb.run is None:
            wandb.init(project=project, config=base)
        swept = dict(wandb.config)
    except Exception:
        return args
    for k, v in swept.items():
        if k not in base or v == base[k]:
            continue
        cur = base[k]
        try:
            if isinstance(cur, bool):
                v = bool(v)
            elif isinstance(cur, int) and not isinstance(v, bool):
                v = int(v)
            elif isinstance(cur, float):
                v = float(v)
        except (TypeError, ValueError):
            continue
        setattr(args, k, v)
        print(f"[wandb sweep] {k}: {cur!r} -> {v!r}")
    return args


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
