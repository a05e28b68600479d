#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path, ``python -m stemgnn_tpu_torch.infer --mode
encode``, at arxiv scale (``arxiv_synthetic_pl``: 169,343 nodes, D = 768,
2-layer SAGE + 4-head cosine VQ, random weights from a seeded generator) and
holds every CUDA kernel of that path against its plain PyTorch version.
Phases, each announced before it starts and timed when it ends:

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds the kernels from ``stemgnn_tpu_torch/csrc``;
  3. kernel  — each kernel vs its plain version on the card: small cases
               (sentinel padding, empty node blocks, every relu/init/scale/
               gate combination, bf16/f32 in and out) and the encode's real
               shapes;
  4. slice   — a JAX-format checkpoint in a temporary directory, then
               ``stemgnn_tpu_torch.infer.main`` on it; launch counts read
               around that call; outputs checked for shape, finiteness and
               code range, and the encoder's ``z`` against the same encoder
               with the plain tail;
  5. times   — kernel, plain version, bound and ``library_ms`` (one
               ``index_add_`` of the same relu'd messages, a yardstick only)
               at the encode's shapes, with CUDA events.

Prints the ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero, with
no result line, on any failure and when no CUDA device is available.  Writes
nothing into the repository but the kernels' build directory.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from stemgnn_tpu_torch.core.config import (EncoderConfig, FinetuneConfig,
                                           VQConfig)
from stemgnn_tpu_torch.data.registry import load_dataset
from stemgnn_tpu_torch.infer import main as infer_main
from stemgnn_tpu_torch.nn.encoder import Encoder
from stemgnn_tpu_torch.ops import scatter as sc
from stemgnn_tpu_torch.ops.edge_layout import build_edge_layout
from stemgnn_tpu_torch.ops.fused_sage import (hub_partials, inv_deg,
                                              table_row, tail_messages)
from stemgnn_tpu_torch.train.graph_setup import (describe_layout,
                                                 fused_full_graph)
from stemgnn_tpu_torch.utils.checkpoint import save_pytree
from stemgnn_tpu_torch.utils.convert import to_jax_pytree
from stemgnn_tpu_torch.vq.quantize import VectorQuantize

DATASET = "arxiv_synthetic_pl"
FEAT_DIM = 768
SEED = 42
HBM_BPS = 3.35e12          # H100 SXM data sheet
F32_FLOPS = 67e12          # H100 SXM data sheet, f32 outside tensor cores
# f32 sums of the same values in another order; bf16 outputs may differ by
# one bf16 ulp (<= 2^-7 relative) where the f32 values straddle a rounding
TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2.0 ** -7, 1e-3)}
# z through the kernel vs z through the plain tail: the layer-1 sums differ
# only in order, but layer 2 rounds its input to bf16 messages again, so a
# difference can flip one bf16 rounding (the bf16-message tolerance)
Z_RTOL, Z_ATOL = 3e-2, 1e-2


def phase(name):
    """Context manager printing a flushed line before and after a phase."""
    class _P:
        def __enter__(self):
            print(f"[phase {name}] start", flush=True)
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            ok = "ok" if exc[0] is None else "FAILED"
            print(f"[phase {name}] {ok} in "
                  f"{time.perf_counter() - self.t0:.1f} s", flush=True)
            return False
    return _P()


def card_line():
    if shutil.which("nvidia-smi"):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        return out[0]
    return f"{torch.cuda.get_device_name(0)}, power limit unknown"


def max_err(got, want):
    return float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0


def check_close(tag, got, want, out_dtype):
    rtol, atol = TOL[out_dtype]
    err = max_err(got, want)
    excess = float(((got.float() - want.float()).abs()
                    - (atol + rtol * want.float().abs())).max())
    print(f"  {tag}: max_abs_err {err:.3e} (rtol {rtol:.1e}, atol "
          f"{atol:.0e}) {'ok' if excess <= 0 else 'FAIL'}", flush=True)
    if excess > 0:
        raise AssertionError(f"{tag}: kernel disagrees with the plain "
                             f"version (max_abs_err {err:.3e})")
    return err


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events, after
    two warm-up runs."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def small_cases(dev):
    """Kernel vs plain version on layouts that exercise the walk patterns."""
    rng = np.random.default_rng(0)

    def run(tag, lay, n_pad, d, mdt, odt, relu, init, scale, gate):
        e = lay.num_edges_padded
        m = torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32))
        m = m.to(dev, mdt)
        opt = {}
        if init:
            opt["init"] = torch.randn(n_pad, d, device=dev)
        if scale:
            opt["scale"] = torch.rand(n_pad, 1, device=dev) + 0.5
        if gate:
            opt["gate"] = torch.randn(n_pad, d, device=dev).to(mdt)
        args = (m, lay.lrow_r, lay.block_ptr_r)
        kw = dict(num_nodes_padded=n_pad, relu=relu, out_dtype=odt, **opt)
        got = sc.scatter_rows_sorted(*args, **kw)
        torch.cuda.synchronize()
        check_close(tag, got, sc.scatter_rows_sorted_ref(*args, **kw), odt)

    # uniform random graph, 56 trailing empty rows, padded edge slots
    s = rng.integers(0, 200, 700)
    r = rng.integers(0, 200, 700)
    lay = build_edge_layout(s, r, 256, device=dev)
    for mdt in (torch.bfloat16, torch.float32):
        for odt in (torch.float32, torch.bfloat16):
            for flags in range(16):
                relu, init, scale, gate = (bool(flags & 1), bool(flags & 2),
                                           bool(flags & 4), bool(flags & 8))
                tag = (f"uniform d=64 {str(mdt)[6:]}->{str(odt)[6:]} "
                       f"relu={relu:d} init={init:d} scale={scale:d} "
                       f"gate={gate:d}")
                run(tag, lay, 256, 64, mdt, odt, relu, init, scale, gate)
    # a 2000-edge hub receiver (many unroll batches in one block), a run of
    # one-edge nodes, a mid-size hub, fully empty node blocks
    r = np.concatenate([np.zeros(2000, np.int64), np.arange(600),
                        np.full(300, 1400)])
    s = rng.permutation(r)
    lay = build_edge_layout(s, r, 2048, device=dev)
    for d in (8, 96, 768):                 # partial and several col slices
        run(f"stress d={d} bf16->f32 relu init scale", lay, 2048, d,
            torch.bfloat16, torch.float32, True, True, True, False)
        run(f"stress d={d} f32->f32", lay, 2048, d, torch.float32,
            torch.float32, False, False, False, False)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    with phase("device"):
        card = card_line()
        print(f"  card: {card}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)",
              flush=True)

    with phase("build"):
        sc.load_library(force_build=True)
        print(f"  scatter_rows_sorted: nvcc build "
              f"{sc.build_info['seconds']:.2f} s ({sc.build_info['path']})\n"
              f"  {sc.build_info['log']}", flush=True)

    with phase("kernel"):
        small_cases(dev)
        # the encode's real shapes: layer 1's tail launch of the hub split
        ds = load_dataset(DATASET, feat_dim=FEAT_DIM, seed=SEED)
        cfg = FinetuneConfig()
        graph = fused_full_graph(ds, cfg, device=dev)
        lay = graph.layout
        print(f"  {describe_layout(lay)}", flush=True)
        if lay.hub_r is None:
            raise AssertionError("the arxiv-scale layout has no hub block")
        tail = lay.hub_r.tail
        src = graph.node_feat.to(torch.bfloat16)
        t0 = table_row(graph.edge_table, torch.bfloat16)
        real = dict(m=tail_messages(src, tail, t0), local_row=tail.lrow_r,
                    block_ptr=tail.block_ptr_r)
        real_kw = dict(num_nodes_padded=lay.num_nodes_padded, relu=True,
                       init=hub_partials(src, lay.hub_r, t0),
                       scale=inv_deg(lay), out_dtype=torch.float32)
        got = sc.scatter_rows_sorted(**real, **real_kw)
        torch.cuda.synchronize()
        real_err = check_close(
            f"arxiv tail E_pad={tail.num_edges_padded} D={FEAT_DIM} "
            f"bf16->f32 relu init scale", got,
            sc.scatter_rows_sorted_ref(**real, **real_kw), torch.float32)
        del ds, graph, src, got

    with phase("slice"), tempfile.TemporaryDirectory() as tmp:
        gen = torch.Generator().manual_seed(SEED)
        ecfg = EncoderConfig(input_dim=FEAT_DIM, hidden_dim=FEAT_DIM,
                             num_layers=2, normalize="batch", dropout=0.0)
        vcfg = VQConfig(dim=FEAT_DIM, codebook_size=128,
                        codebook_dim=FEAT_DIM, heads=4)
        enc = Encoder(ecfg, generator=gen).eval()
        with torch.no_grad():   # non-trivial BatchNorm running statistics
            for bn in enc.norms:
                bn.mean.normal_(0.0, 0.1, generator=gen)
                bn.var.uniform_(0.5, 1.5, generator=gen)
        params, state = to_jax_pytree(enc, VectorQuantize(vcfg, generator=gen))
        save_pytree(os.path.join(tmp, "encoder_50.npz"),
                    {"params": params["encoder"], "state": state["encoder"]})
        save_pytree(os.path.join(tmp, "vq_50.npz"),
                    {"params": params["vq"], "state": state["vq"]})
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({"encoder": {"hidden_dim": FEAT_DIM, "num_layers": 2,
                                   "backbone": "sage", "normalize": "batch"},
                       "vq": {"codebook_size": 128, "codebook_dim": FEAT_DIM,
                              "heads": 4}}, f)
        out = os.path.join(tmp, "out.npz")
        argv = ["--finetune_dataset", DATASET, "--feat_dim", str(FEAT_DIM),
                "--pretrain_path", tmp, "--pretrain_model_epoch", "50",
                "--seed", str(SEED), "--out", out]
        print(f"  python -m stemgnn_tpu_torch.infer {' '.join(argv)}",
              flush=True)

        for k in sc.launch_counts:
            sc.launch_counts[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = infer_main(argv)
        torch.cuda.synchronize()
        encode_wall_s = time.perf_counter() - t0
        launches = dict(sc.launch_counts)
        print(f"  encode wall {encode_wall_s:.2f} s; launches {launches}",
              flush=True)
        if launches["scatter_rows_sorted"] != 2:
            raise AssertionError(f"expected 2 scatter_rows_sorted launches "
                                 f"(one per layer), got {launches}")

        got = np.load(out)
        n = res["num_nodes"]
        shapes = {k: got[k].shape for k in got.files}
        print(f"  outputs {shapes}", flush=True)
        want = {"embeddings": (n, FEAT_DIM), "quantized": (n, FEAT_DIM),
                "codes": (n, 4)}
        if n != 169_343 or shapes != want:
            raise AssertionError(f"output shapes {shapes} != {want}")
        for k in ("embeddings", "quantized"):
            if not np.isfinite(got[k]).all():
                raise AssertionError(f"non-finite values in {k}")
        codes = got["codes"]
        if codes.min() < 0 or codes.max() >= 128:
            raise AssertionError(f"codes outside [0, 128): {codes.min()}.."
                                 f"{codes.max()}")
        print(f"  codes in [{codes.min()}, {codes.max()}], "
              f"{len(np.unique(codes))} distinct", flush=True)
        del got, codes

        g, encoder, quantizer = res["graph"], res["encoder"], res["quantizer"]
        fwd_args = (g.node_feat, g.senders, g.receivers)
        fwd_kw = dict(layout=g.layout, edge_table=g.edge_table)
        with torch.no_grad():
            z_plain = encoder(*fwd_args, **fwd_kw,
                              scatter=sc.scatter_rows_sorted_ref)
            z = res["z"]
            zerr = max_err(z[:n], z_plain[:n])
            excess = float(((z[:n] - z_plain[:n]).abs()
                            - (Z_ATOL + Z_RTOL * z_plain[:n].abs())).max())
            same = float((quantizer(z_plain)["indices"][:n]
                          == res["vq"]["indices"][:n]).all(1).float().mean())
            print(f"  z vs plain-tail z: max_abs_err {zerr:.3e} (rtol "
                  f"{Z_RTOL}, atol {Z_ATOL}); code rows equal {same:.6f}",
                  flush=True)
            if excess > 0:
                raise AssertionError("z through the kernel disagrees with z "
                                     "through the plain tail")

            def forward():
                quantizer(encoder(*fwd_args, **fwd_kw))
            fwd_ms = cuda_ms(forward, 5)
        print(f"  encoder+VQ forward on the card: {fwd_ms:.3f} ms", flush=True)
        del res, z, z_plain

    with phase("times"):
        kernel_ms = cuda_ms(lambda: sc.scatter_rows_sorted(**real, **real_kw),
                            20)
        plain_ms = cuda_ms(
            lambda: sc.scatter_rows_sorted_ref(**real, **real_kw), 5)
        bp = real["block_ptr"]
        e_used = int(bp[-1])
        d = FEAT_DIM
        n_pad = real_kw["num_nodes_padded"]
        pos = torch.arange(real["m"].shape[0], device=dev, dtype=torch.int32)
        rows = (torch.searchsorted(bp, pos, right=True).long() - 1) * 128 \
            + real["local_row"].reshape(-1).long()
        keep = (pos < bp[-1]) & (real["local_row"].reshape(-1) < 128)
        rows, msg = rows[keep], torch.relu(real["m"][keep].float())
        library_ms = cuda_ms(lambda: torch.zeros(
            n_pad, d, device=dev).index_add_(0, rows, msg), 20)
        # each input read once, each output written once: messages + rows of
        # the edges inside block ranges, block_ptr, f32 init, scale, f32 out
        nbytes = (e_used * (2 * d + 4) + bp.numel() * 4 + n_pad * d * 4
                  + n_pad * 4 + n_pad * d * 4)
        flops = e_used * d + 2 * n_pad * d           # adds + init/scale
        bytes_ms, ops_ms = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"  scatter_rows_sorted at E={e_used} D={d} N_pad={n_pad}: "
              f"kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"index_add_ {library_ms:.3f} ms, bound {bound_ms:.3f} ms "
              f"({nbytes / 1e9:.3f} GB at 3.35 TB/s); encode wall "
              f"{encode_wall_s:.2f} s, encoder+VQ forward {fwd_ms:.3f} ms",
              flush=True)

    print(json.dumps({"kernels": [{
        "name": "scatter_rows_sorted", "route": "cuda",
        "source": "stemgnn_tpu_torch/csrc/scatter_rows_sorted.cu",
        "replaces": "stemgnn_tpu/ops/scatter_pallas.py:252",
        "launches": launches["scatter_rows_sorted"],
        "max_abs_err": real_err, "max_err": real_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms}]}), flush=True)
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
