#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two entry points at arxiv scale (``arxiv_synthetic_pl``:
169,343 nodes, 2,370,802 edges, D = 768, 2-layer SAGE + 4-head cosine VQ,
random weights from a seeded generator) and holds every CUDA kernel of their
paths against its plain PyTorch version.  Phases, each announced before it
starts and timed when it ends:

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds both kernels from ``stemgnn_tpu_torch/csrc``, one
               compiler per source, started together;
  3. kernel  — ``scatter_rows_sorted`` vs its plain version: small cases
               (sentinel padding, empty node blocks, every relu/init/scale/
               gate combination, bf16/f32 in and out), then the forward and
               backward (gate) tails at arxiv shapes;
  4. kernel2 — ``gathered_scatter_rows_sorted`` vs its plain version: small
               cases (no table, t0, a 5-row xe table; every epilogue; bf16/
               f32 out; empty node blocks; sentinel padding over large
               padded rows; both edge orders), then the forward and backward
               hub tails at arxiv shapes;
  5. slice   — ``stemgnn_tpu_torch.infer.main`` (encode) from a JAX-format
               checkpoint in a temporary directory: 2 kernel-2 launches and
               no kernel-1 launch; outputs checked; the same encoder on
               ``gwin="off"`` layouts (2 kernel-1 launches) and through the
               plain versions, ``z`` compared;
  6. train   — ``stemgnn_tpu_torch.finetune.main``, 3 epochs: 3 kernel-2
               launches per training step and 2 per evaluation, finite
               losses, trainable parameters moved and the frozen VQ not,
               one step's gradients against the plain versions and against
               the ``gwin="off"`` route; epoch and step times, peak memory;
  7. times   — each kernel, its plain version, its bound and its yardsticks
               at the main path's shapes, by CUDA events.

Prints the ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero, with
no result line, on any failure and when no CUDA device is available.  Writes
nothing into the repository but the kernels' build directory.
"""

import copy
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
from stemgnn_tpu_torch.finetune import main as finetune_main
from stemgnn_tpu_torch.infer import main as infer_main
from stemgnn_tpu_torch.nn.encoder import Encoder
from stemgnn_tpu_torch.nn.layers import Linear
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
NUM_CLASSES = 40
SEED = 42
EPOCHS = 3
HBM_BPS = 3.35e12          # H100 SXM data sheet
F32_FLOPS = 67e12          # H100 SXM data sheet, f32 outside tensor cores
K1, K2 = "scatter_rows_sorted", "gathered_scatter_rows_sorted"
# f32 sums of the same values in another order; bf16 outputs may differ by
# one bf16 ulp (<= 2^-7 relative) where the f32 values straddle a rounding
TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2.0 ** -7, 1e-3)}
# z through one route vs z through another: the layer-1 sums differ only in
# order, but layer 2 rounds its input to bf16 messages again, so a
# difference can flip one bf16 rounding (the bf16-message tolerance)
Z_RTOL, Z_ATOL = 3e-2, 1e-2
# one training step's gradients on two routes: the same bf16 messages summed
# in another order, so only a few bf16 roundings of layer 2's input and of
# gp flip; each parameter's worst difference against 2% of the largest
# gradient of the step
GRAD_RTOL = 2e-2


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


def check_close(tag, got, want, rtol, atol, what="kernel", quiet=False):
    err = max_err(got, want)
    excess = float(((got.float() - want.float()).abs()
                    - (atol + rtol * want.float().abs())).max())
    if not quiet or excess > 0:
        print(f"  {tag}: max_abs_err {err:.3e} (rtol {rtol:.1e}, atol "
              f"{atol:.0e}) {'ok' if excess <= 0 else 'FAIL'}", flush=True)
    if excess > 0:
        raise AssertionError(f"{tag}: {what} disagrees (max_abs_err "
                             f"{err:.3e})")
    return err


def check_kernel(tag, got, want, out_dtype, quiet=False):
    torch.cuda.synchronize()
    return check_close(tag, got, want, *TOL[out_dtype], quiet=quiet)


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


def reset_counts():
    for k in sc.launch_counts:
        sc.launch_counts[k] = 0
    torch.cuda.synchronize()


def read_counts():
    torch.cuda.synchronize()
    return dict(sc.launch_counts)


def expect_counts(tag, got, want):
    print(f"  {tag}: launches {got}", flush=True)
    if got != want:
        raise AssertionError(f"{tag}: expected launches {want}, got {got}")


def _epilogue_opts(rng_t, n_pad, d, init, scale, gate, gate_dtype, dev):
    opt = {}
    if init:
        opt["init"] = torch.randn(n_pad, d, device=dev, generator=rng_t)
    if scale:
        opt["scale"] = torch.rand(n_pad, 1, device=dev, generator=rng_t) + .5
    if gate:
        opt["gate"] = torch.randn(n_pad, d, device=dev,
                                  generator=rng_t).to(gate_dtype)
    return opt


def kernel1_small_cases(dev):
    """Kernel 1 vs its plain version on layouts that exercise the walk."""
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_cases = 0

    def run(tag, lay, n_pad, d, mdt, odt, relu, init, scale, gate):
        nonlocal n_cases
        e = lay.num_edges_padded
        m = torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32))
        m = m.to(dev, mdt)
        opt = _epilogue_opts(gen, n_pad, d, init, scale, gate, mdt, dev)
        args = (m, lay.lrow_r, lay.block_ptr_r)
        kw = dict(num_nodes_padded=n_pad, relu=relu, out_dtype=odt, **opt)
        check_kernel(tag, sc.scatter_rows_sorted(*args, **kw),
                     sc.scatter_rows_sorted_ref(*args, **kw), odt, quiet=True)
        n_cases += 1

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
    print(f"  kernel 1: {n_cases} small cases agree with the plain version",
          flush=True)


def kernel2_small_cases(dev):
    """Kernel 2 vs its plain version: every table form and epilogue, both
    out dtypes, both edge orders, empty blocks, sentinel padding."""
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=dev).manual_seed(1)
    n_cases = 0

    def run(tag, lay, order, x, table, xe, odt, relu, init, scale, gate):
        nonlocal n_cases
        n_pad, d = x.shape
        opt = _epilogue_opts(gen, n_pad, d, init, scale, gate,
                             torch.bfloat16, dev)
        keys = lay.senders_r if order == "r" else lay.receivers_s
        args = (keys[None, :], getattr(lay, "lrow_" + order),
                getattr(lay, "block_ptr_" + order), x, table, xe)
        kw = dict(num_nodes_padded=n_pad, relu=relu, out_dtype=odt, **opt)
        check_kernel(tag, sc.gathered_scatter_rows_sorted(*args, **kw),
                     sc.gathered_scatter_rows_sorted_ref(*args, **kw), odt,
                     quiet=True)
        n_cases += 1

    # uniform graph over 200 of 256 rows (56 empty rows), 324 sentinel-padded
    # edge slots; padded rows of x hold large finite values (never read)
    n, n_pad, d = 200, 256, 64
    s = rng.integers(0, n, 700)
    r = rng.integers(0, n, 700)
    xe_ids = rng.integers(0, 5, 700)
    lay = build_edge_layout(s, r, n_pad, xe_ids=xe_ids, device=dev)
    x = torch.randn(n_pad, d, device=dev, generator=gen)
    x[n:] = 1.0e30
    x = x.to(torch.bfloat16)
    tables = {"none": (None, None),
              "t0": (torch.randn(1, d, device=dev, generator=gen)
                     .to(torch.bfloat16), None),
              "xe5": (torch.randn(5, d, device=dev, generator=gen)
                      .to(torch.bfloat16), None)}
    for name, (table, _) in tables.items():
        for order in ("r", "s"):
            xe = (getattr(lay, "xe_" + order)[None, :] if name == "xe5"
                  else None)
            for odt in (torch.float32, torch.bfloat16):
                for flags in range(16):
                    relu, init, scale, gate = (
                        bool(flags & 1), bool(flags & 2), bool(flags & 4),
                        bool(flags & 8))
                    tag = (f"table={name} order={order} ->{str(odt)[6:]} "
                           f"relu={relu:d} init={init:d} scale={scale:d} "
                           f"gate={gate:d}")
                    run(tag, lay, order, x, table, xe, odt, relu, init,
                        scale, gate)
    # hub receivers and empty blocks, at several column counts
    r = np.concatenate([np.zeros(2000, np.int64), np.arange(600),
                        np.full(300, 1400)])
    s = rng.permutation(r)
    lay = build_edge_layout(s, r, 2048, device=dev)
    for d in (8, 96, 768):
        xs = torch.randn(2048, d, device=dev, generator=gen).to(torch.bfloat16)
        t0 = torch.randn(1, d, device=dev, generator=gen).to(torch.bfloat16)
        run(f"stress d={d} t0 relu init scale", lay, "r", xs, t0, None,
            torch.float32, True, True, True, False)
        run(f"stress d={d} sender order gate", lay, "s", xs, None, None,
            torch.float32, False, True, False, True)
    print(f"  kernel 2: {n_cases} small cases agree with the plain version",
          flush=True)


def arxiv_tail_cases(graph):
    """The main path's real launches, as ``ops.fused_sage`` makes them: the
    forward hub tail of layer 1 (receiver order, relu, t0, the hub partial
    sums as init, 1/deg as scale) and the backward hub tail (sender order,
    gp = g / deg in bf16, the hub partial sums of gp as init, the relu gate
    bf16(x) + t0).  Returns the keyword sets of each kernel's two
    launches."""
    lay = graph.layout
    if lay.hub_r is None or lay.hub_s is None:
        raise AssertionError("the arxiv-scale layout has no hub blocks")
    if not (lay.hub_r.tail.use_gwin_r and lay.hub_s.tail.use_gwin_s):
        raise AssertionError("the default arxiv layout's tails do not open "
                             "the in-kernel gather gate")
    dev = graph.node_feat.device
    src = graph.node_feat.to(torch.bfloat16)
    t0 = table_row(graph.edge_table, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(2)
    gp = (torch.randn(src.shape, device=dev, generator=gen)
          * inv_deg(lay)).to(torch.bfloat16)
    ft, bt = lay.hub_r.tail, lay.hub_s.tail
    n_pad = lay.num_nodes_padded
    fwd_epi = dict(num_nodes_padded=n_pad, relu=True,
                   init=hub_partials(src, lay.hub_r, t0), scale=inv_deg(lay),
                   out_dtype=torch.float32)
    bwd_epi = dict(num_nodes_padded=n_pad, relu=False,
                   init=hub_partials(gp, lay.hub_s, None, relu=False),
                   gate=src + t0, out_dtype=torch.float32)
    k1 = {"fwd": (dict(m=tail_messages(src, ft, t0), local_row=ft.lrow_r,
                       block_ptr=ft.block_ptr_r), fwd_epi),
          "bwd": (dict(m=tail_messages(gp, bt, None, "s"),
                       local_row=bt.lrow_s, block_ptr=bt.block_ptr_s),
                  bwd_epi)}
    k2 = {"fwd": (dict(keys=ft.senders_r[None, :], local_row=ft.lrow_r,
                       block_ptr=ft.block_ptr_r, x=src, table=t0), fwd_epi),
          "bwd": (dict(keys=bt.receivers_s[None, :], local_row=bt.lrow_s,
                       block_ptr=bt.block_ptr_s, x=gp), bwd_epi)}
    return k1, k2


def save_checkpoint(tmp, gen):
    """A JAX-format pretrain checkpoint with random weights and non-trivial
    BatchNorm statistics, and its config.json; returns the encoder and VQ
    parameters as saved."""
    ecfg = EncoderConfig(input_dim=FEAT_DIM, hidden_dim=FEAT_DIM,
                         num_layers=2, normalize="batch", dropout=0.0)
    vcfg = VQConfig(dim=FEAT_DIM, codebook_size=128, codebook_dim=FEAT_DIM,
                    heads=4)
    enc = Encoder(ecfg, generator=gen).eval()
    with torch.no_grad():
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
    return params


def check_encode_outputs(out, n):
    got = np.load(out)
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


def check_z(tag, z, want, n):
    check_close(f"z vs {tag}", z[:n], want[:n], Z_RTOL, Z_ATOL,
                what="z through the kernels")


def step_grads(model, loss_fn, mask, graph, y, plain=False):
    """One training step's gradients of a copy of ``model`` (BatchNorm
    statistics of the original untouched), dropout from a fresh seeded
    generator so every route draws the same masks."""
    m = copy.deepcopy(model)
    gen = torch.Generator(device=graph.node_feat.device).manual_seed(7)
    loss, _ = loss_fn(m, mask, graph, y, gen, plain)
    loss.backward()
    return {k: p.grad for k, p in m.named_parameters() if p.requires_grad}


def check_grads(tag, got, want):
    scale = max(float(g.abs().max()) for g in want.values())
    worst = max(max_err(got[k], want[k]) for k in want)
    print(f"  step gradients vs {tag}: worst max_abs_err {worst:.3e} over "
          f"{len(want)} tensors (largest gradient {scale:.3e}, tol "
          f"{GRAD_RTOL} of it)", flush=True)
    if set(got) != set(want) or worst > GRAD_RTOL * scale:
        raise AssertionError(f"gradients disagree with {tag}")


def bound_ms(nbytes, flops):
    b, f = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return max(b, f), ("bytes" if b >= f else "operations")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_all = time.perf_counter()
    paths = {}                                      # path -> launch counts

    with phase("device"):
        card = card_line()
        print(f"  card: {card}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)",
              flush=True)

    with phase("build"):
        t0 = time.perf_counter()
        sc.build(force=True)
        print(f"  both kernels built in {time.perf_counter() - t0:.2f} s "
              f"(one nvcc per source, in parallel)", flush=True)
        for name in (K1, K2):
            info = sc.build_info[name]
            print(f"  {name}: {info['seconds']:.2f} s ({info['path']})\n"
                  f"  {info['log']}", flush=True)
            sc.load_library(name)

    with phase("kernel"):
        kernel1_small_cases(dev)
        ds = load_dataset(DATASET, feat_dim=FEAT_DIM, seed=SEED)
        cfg = FinetuneConfig()
        graph = fused_full_graph(ds, cfg, device=dev)
        print(f"  {describe_layout(graph.layout)}", flush=True)
        k1_cases, k2_cases = arxiv_tail_cases(graph)
        errs = {}
        for direction, (args, kw) in k1_cases.items():
            errs[(K1, direction)] = check_kernel(
                f"kernel 1 arxiv {direction} tail E_pad="
                f"{args['m'].shape[0]} D={FEAT_DIM}",
                sc.scatter_rows_sorted(**args, **kw),
                sc.scatter_rows_sorted_ref(**args, **kw), torch.float32)

    with phase("kernel2"):
        kernel2_small_cases(dev)
        for direction, (args, kw) in k2_cases.items():
            errs[(K2, direction)] = check_kernel(
                f"kernel 2 arxiv {direction} tail E_pad="
                f"{args['keys'].shape[1]} D={FEAT_DIM}",
                sc.gathered_scatter_rows_sorted(**args, **kw),
                sc.gathered_scatter_rows_sorted_ref(**args, **kw),
                torch.float32)

    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    with phase("slice"):
        ckpt_params = save_checkpoint(tmp, torch.Generator().manual_seed(SEED))
        out = os.path.join(tmp, "out.npz")
        argv = ["--finetune_dataset", DATASET, "--feat_dim", str(FEAT_DIM),
                "--pretrain_path", tmp, "--pretrain_model_epoch", "50",
                "--seed", str(SEED), "--out", out]
        print(f"  python -m stemgnn_tpu_torch.infer {' '.join(argv)}",
              flush=True)
        reset_counts()
        t0 = time.perf_counter()
        res = infer_main(argv)
        paths["encode"] = read_counts()
        encode_wall_s = time.perf_counter() - t0
        print(f"  encode wall {encode_wall_s:.2f} s", flush=True)
        expect_counts("encode (default layout)", paths["encode"],
                      {K1: 0, K2: 2})
        n = res["num_nodes"]
        check_encode_outputs(out, n)

        encoder, quantizer, z = res["encoder"], res["quantizer"], res["z"]
        g = res["graph"]
        graph_off = fused_full_graph(ds, cfg, device=dev, gwin="off")
        print(f"  gwin=off {describe_layout(graph_off.layout)}", flush=True)

        def encode(gr, plain=False):
            return encoder(gr.node_feat, gr.senders, gr.receivers,
                           layout=gr.layout, edge_table=gr.edge_table,
                           plain=plain)
        with torch.no_grad():
            reset_counts()
            z_off = encode(graph_off)
            paths["encode_gwin_off"] = read_counts()
            expect_counts("encode (gwin=off layout)",
                          paths["encode_gwin_off"], {K1: 2, K2: 0})
            check_z("z on gwin=off layouts (kernel 1)", z, z_off, n)
            check_z("z through the plain versions", z, encode(g, plain=True),
                    n)
            same = float((quantizer(z_off)["indices"][:n]
                          == res["vq"]["indices"][:n]).all(1).float().mean())
            print(f"  code rows equal on both routes: {same:.6f}", flush=True)
            fwd_ms = cuda_ms(lambda: quantizer(encode(g)), 5)
            fwd_off_ms = cuda_ms(lambda: quantizer(encode(graph_off)), 5)
        print(f"  encoder+VQ forward on the card: {fwd_ms:.3f} ms (kernel "
              f"2 tails), {fwd_off_ms:.3f} ms (gwin=off: gather + kernel 1)",
              flush=True)
        del res, z, z_off, g

    with phase("train"):
        argv = ["--finetune_dataset", DATASET, "--feat_dim", str(FEAT_DIM),
                "--pretrain_path", tmp, "--pretrain_model_epoch", "50",
                "--seed", str(SEED), "--epochs", str(EPOCHS), "--repeat", "1"]
        print(f"  python -m stemgnn_tpu_torch.finetune {' '.join(argv)}",
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = finetune_main(argv)
        paths["finetune"] = read_counts()
        train_wall_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"  finetune wall {train_wall_s:.2f} s ({EPOCHS} epochs); "
              f"per-epoch wall {['%.3f' % s for s in res['epoch_s']]} s; "
              f"peak device memory {peak_gb:.2f} GB", flush=True)
        expect_counts(f"finetune ({EPOCHS} x (train step + eval))",
                      paths["finetune"], {K1: 0, K2: EPOCHS * (3 + 2)})
        losses = [e["loss"] for e in res["epoch_losses"]]
        print(f"  losses {losses}", flush=True)
        if len(losses) != EPOCHS or not np.isfinite(losses).all():
            raise AssertionError(f"losses {losses}")

        model, gt, y, mask = (res["model"], res["graph"], res["y"],
                              res["train_mask"])
        loss_fn, train_step, eval_step = res["steps"]
        def saved(part, name):
            want = ckpt_params[part]
            for key in name.split("."):
                want = want[int(key)] if key.isdigit() else want[key]
            return torch.from_numpy(want)
        for name, p in model.encoder.named_parameters():
            if torch.equal(p.detach().cpu(), saved("encoder", name)):
                raise AssertionError(f"encoder.{name} did not change")
        dec0 = Linear(FEAT_DIM * 4, NUM_CLASSES * 4,
                      generator=torch.Generator().manual_seed(0))
        if torch.equal(model.decoder.w.detach().cpu(), dec0.w.detach()):
            raise AssertionError("the decoder did not change")
        for name, p in model.vq.named_parameters():
            if not torch.equal(p.detach().cpu(), saved("vq", name)):
                raise AssertionError(f"the frozen vq.{name} changed")
        print("  every encoder parameter and the decoder moved; the VQ did "
              "not", flush=True)

        reset_counts()
        g_kernel = step_grads(model, loss_fn, mask, gt, y)
        expect_counts("one training step", read_counts(), {K1: 0, K2: 3})
        reset_counts()
        eval_step(model, gt)
        expect_counts("one evaluation", read_counts(), {K1: 0, K2: 2})
        check_grads("the plain versions",
                    g_kernel, step_grads(model, loss_fn, mask, gt, y,
                                         plain=True))
        reset_counts()
        g_off = step_grads(model, loss_fn, mask, graph_off, y)
        expect_counts("one training step on gwin=off layouts", read_counts(),
                      {K1: 3, K2: 0})
        check_grads("the gwin=off route (kernel 1 with the gate)", g_kernel,
                    g_off)
        opt = torch.optim.AdamW([p for p in model.parameters()
                                 if p.requires_grad], lr=1e-3,
                                weight_decay=0.01)
        gen = torch.Generator(device=dev).manual_seed(0)
        step_ms = cuda_ms(lambda: train_step(model, opt, mask, gt, y, gen), 5)
        eval_ms = cuda_ms(lambda: eval_step(model, gt), 5)
        step_off_ms = cuda_ms(
            lambda: train_step(model, opt, mask, graph_off, y, gen), 5)
        print(f"  training step {step_ms:.3f} ms (gwin=off route "
              f"{step_off_ms:.3f} ms), evaluation {eval_ms:.3f} ms, by CUDA "
              f"events", flush=True)
        del res, model, gt, graph_off
    tmp_dir.cleanup()

    with phase("times"):
        kernels = []
        for name, cases, fn, ref in (
                (K1, k1_cases, sc.scatter_rows_sorted,
                 sc.scatter_rows_sorted_ref),
                (K2, k2_cases, sc.gathered_scatter_rows_sorted,
                 sc.gathered_scatter_rows_sorted_ref)):
            row = {}
            for direction, (args, kw) in cases.items():
                row[direction] = time_case(name, direction, args, kw, fn,
                                           ref)
            kernels.append(dict(row, name=name))
    k1_path = "encode_gwin_off"
    line = []
    for k in kernels:
        name, fwd, bwd = k["name"], k["fwd"], k["bwd"]
        entry = {
            "name": name, "route": "cuda",
            "source": f"stemgnn_tpu_torch/csrc/{name}.cu",
            "replaces": ("stemgnn_tpu/ops/scatter_pallas.py:252" if name == K1
                         else "stemgnn_tpu/ops/scatter_pallas.py:740"),
            "launches": paths[k1_path if name == K1 else "finetune"][name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": errs[(name, "fwd")],
            "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
            "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
            "library_ms": fwd["library_ms"],
            "bwd_max_abs_err": errs[(name, "bwd")], "bwd_ms": bwd["ms"],
            "bwd_plain_ms": bwd["plain_ms"], "bwd_bound_ms": bwd["bound_ms"],
            "bwd_library_ms": bwd["library_ms"]}
        if name == K2:
            entry.update(replaced_ms=fwd["replaced_ms"],
                         bwd_replaced_ms=bwd["replaced_ms"],
                         row_walk_bound_ms=fwd["row_walk_bound_ms"])
        line.append(entry)
    print(json.dumps({"kernels": line}), flush=True)
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def time_case(name, direction, args, kw, fn, ref):
    """Times of one real launch: the kernel, its plain version, its bound,
    a library yardstick and, for kernel 2, the route it replaces (gather +
    kernel 1 on the same tail)."""
    dev = kw["init"].device
    n_pad, d = kw["num_nodes_padded"], FEAT_DIM
    bp, lrow = args["block_ptr"], args["local_row"]
    e_used = int(bp[-1])
    live = lrow.reshape(-1)[:e_used] < 128
    ms = cuda_ms(lambda: fn(**args, **kw), 20)
    plain = cuda_ms(lambda: ref(**args, **kw), 5)
    # each input read once, each output written once: the epilogue's init
    # (f32), scale or gate, out (f32), block_ptr, and the edge stream
    epi = n_pad * d * 4 * 2 + bp.numel() * 4
    epi += n_pad * 4 if kw.get("scale") is not None else 0
    epi += n_pad * d * 2 if kw.get("gate") is not None else 0
    flops = e_used * d * (2 if kw["relu"] else 1) + 2 * n_pad * d
    if name == K1:
        nbytes = epi + e_used * (2 * d + 4)
    else:
        keys = args["keys"].reshape(-1)[:e_used][live]
        rows = int(torch.unique(keys).numel())     # x rows the tail reads
        nbytes = epi + e_used * 8 + rows * d * 2
        flops += e_used * d * (args.get("table") is not None)
    b_ms, b_by = bound_ms(nbytes, flops)
    out = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
    # yardstick: one PyTorch call summing the same message rows
    rows_out = ((torch.searchsorted(bp, torch.arange(
        e_used, device=dev, dtype=torch.int32), right=True).long() - 1)
        * 128 + lrow.reshape(-1)[:e_used].long())[live]
    if name == K1:
        msg = args["m"][:e_used][live].float()
        msg = torch.relu(msg) if kw["relu"] else msg
        out["library_ms"] = cuda_ms(lambda: torch.zeros(
            n_pad, d, device=dev).index_add_(0, rows_out, msg), 20)
        lib = "index_add_"
    else:
        # the sums are A @ f(x) for the tail's count matrix A (f = relu(x +
        # t0) rounded to bf16, or x itself): one sparse product
        f = args["x"].float()
        if args.get("table") is not None:
            f = f + args["table"].float()
        if kw["relu"]:
            f = torch.relu(f)
        f = f.to(torch.bfloat16).float()
        a = torch.sparse_coo_tensor(
            torch.stack([rows_out, keys.long()]),
            torch.ones(rows_out.numel(), device=dev),
            (n_pad, n_pad), check_invariants=False).coalesce().to_sparse_csr()
        out["library_ms"] = cuda_ms(lambda: torch.sparse.mm(a, f), 20)
        lib = "torch.sparse.mm (CSR f32)"
        src, keys2d = args["x"], args["keys"]

        def replaced():
            m = src.index_select(0, keys2d.reshape(-1).clamp(
                max=n_pad - 1).long())
            if args.get("table") is not None:
                m = m + args["table"]
            m = torch.where((lrow.reshape(-1) < 128)[:, None], m,
                            torch.zeros((), dtype=m.dtype, device=dev))
            return sc.scatter_rows_sorted(m, lrow, bp, **kw)
        out["replaced_ms"] = cuda_ms(replaced, 20)
        # the same bound with x read once per edge (the row walk)
        out["row_walk_bound_ms"] = bound_ms(
            epi + e_used * (8 + 2 * d), flops)[0]
    extra = "".join(f", {k} {v:.3f} ms" for k, v in out.items()
                    if k.endswith("_ms") and k not in ("plain_ms",
                                                       "bound_ms"))
    print(f"  {name} {direction} tail at E={e_used} D={d} N_pad={n_pad}: "
          f"kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.3f} ms "
          f"({b_by}, {nbytes / 1e9:.3f} GB at 3.35 TB/s){extra} "
          f"(library = {lib})", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
