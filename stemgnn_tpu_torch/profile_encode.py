"""Where the time of one full-graph encode goes on the card.

    python -m stemgnn_tpu_torch.profile_encode [--dataset arxiv_synthetic_pl]

Builds the dataset and its layout (host stage times), runs the encoder + VQ
forward of ``infer --mode encode`` with random weights from ``--seed``, and
prints: the forward's time by CUDA events, its device time by kernel and
by stage from ``torch.profiler`` (per forward), the device's busy share of
the profiled window, and the card's name and power limit.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from stemgnn_tpu_torch.core.config import (EncoderConfig, FinetuneConfig,
                                           VQConfig)
from stemgnn_tpu_torch.core.device import resolve_device
from stemgnn_tpu_torch.data.registry import load_dataset
from stemgnn_tpu_torch.nn.encoder import Encoder
from stemgnn_tpu_torch.train.graph_setup import (describe_layout,
                                                 fused_full_graph)
from stemgnn_tpu_torch.vq.quantize import VectorQuantize


def _device_us(evt) -> float:
    """Device microseconds of a profiler event (attribute names differ
    across PyTorch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


STAGES = ("encoder", "vq")


def _on_device(evt) -> bool:
    """A GPU-side event: a kernel, a copy, or a stage's annotation range."""
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def main(argv=None):
    p = argparse.ArgumentParser("profile_encode")
    p.add_argument("--dataset", default="arxiv_synthetic_pl")
    p.add_argument("--feat_dim", type=int, default=768)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    ds = load_dataset(args.dataset, feat_dim=args.feat_dim, seed=args.seed)
    t_data = time.perf_counter() - t0
    d = args.feat_dim
    cfg = FinetuneConfig(
        encoder=EncoderConfig(input_dim=d, hidden_dim=d, dropout=0.0),
        vq=VQConfig(dim=d, codebook_dim=d))
    t0 = time.perf_counter()
    g = fused_full_graph(ds, cfg, device=dev)
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    print(f"host: dataset {t_data:.2f} s, graph + layout {t_graph:.2f} s; "
          f"{describe_layout(g.layout)}", flush=True)

    gen = torch.Generator().manual_seed(args.seed)
    enc = Encoder(cfg.encoder, generator=gen).eval().to(dev)
    vq = VectorQuantize(cfg.vq, generator=gen).eval().to(dev)

    def forward():
        with record_function(STAGES[0]):
            z = enc(g.node_feat, g.senders, g.receivers, layout=g.layout,
                    edge_table=g.edge_table)
        with record_function(STAGES[1]):
            return vq(z)

    with torch.no_grad():
        for _ in range(2):
            forward()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            forward()
        stop.record()
        torch.cuda.synchronize()
        fwd_ms = start.elapsed_time(stop) / args.reps
        print(f"encoder+VQ forward: {fwd_ms:.3f} ms (CUDA events, mean of "
              f"{args.reps})", flush=True)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.reps):
                forward()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3

    events = kernel_table(prof, args.reps, wall_ms, args.top, "forward")
    for e in events:
        if _on_device(e) and e.key in STAGES:
            ms = _device_us(e) / 1e3 / args.reps
            print(f"stage {e.key}: device {ms:.3f} ms/forward")
    print(card_line(), flush=True)


def kernel_table(prof, reps: int, wall_ms: float, top: int, unit: str,
                 ranges=STAGES):
    """Print the device busy share of a profiled window of ``reps`` runs and
    its ``top`` kernels by device time per run, then the port's own kernels
    (``csrc/``) that the top rows leave out; return the events.  The
    annotation ``ranges`` and the program's spans (``sg:*``,
    ``utils.trace``) span their kernels and stay out of the sums."""
    events = prof.key_averages()
    kernels = sorted((e for e in events
                      if _on_device(e) and e.key not in ranges
                      and not e.key.startswith("sg:")),
                     key=_device_us, reverse=True)
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    print(f"profiled {reps} {unit}s: wall {wall_ms:.3f} ms, device "
          f"busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    print(f"{'device ms/' + unit:>18}  {'calls':>6}  name")
    own = [e for e in kernels[top:] if "rows_kernel" in e.key
           or "scatter_rows_sorted" in e.key]
    for e in kernels[:top] + own:
        print(f"{_device_us(e) / 1e3 / reps:18.3f}  "
              f"{e.count // reps:6d}  {e.key[:100]}")
    return events


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


if __name__ == "__main__":
    main()
