"""Replays, on the card, the choice of the row walk's rows in flight per warp
(U), register caps and epilogue prefetch for kernels 1, 2 and 3
(``csrc/scatter_rows_sorted.cu``, ``csrc/gathered_scatter_rows_sorted.cu``,
``csrc/masked_scatter_rows_sorted.cu``, ``csrc/row_walk.cuh``).

    python -m stemgnn_tpu_torch.tune_row_walk [--reps 20]

Builds every variant of :data:`VARIANTS` with ``nvcc -D`` values (one
``nvcc`` per variant and source that the variant changes, all started
together, into ``_build/tune/``), then times each variant by CUDA events
through the port's own wrappers at the shapes the smoke times: the
pretrain step's forward and backward dropout tails of ``arxiv_synthetic_pl``
(kernel 1, bf16 messages), the node path's forward and backward hub tails
(kernel 2 with t0 and without a table), kernel 2's xe mode and kernel 3 over
the
whole arxiv graph with 11 random edge types, and both at the link path's
WN18RR-size layout (``kg_synthetic``).  Each variant's output is checked
against the plain version at the smoke's tolerance.  Prints each variant's
registers and spills from ``ptxas`` for the instances the paths launch, a
table of times, each case's row plan with the device time of the chosen
build's walk and of its second pass over the split rows (``torch.profiler``),
and the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from stemgnn_tpu_torch.core.config import (EncoderConfig, FinetuneConfig,
                                           VQConfig)
from stemgnn_tpu_torch.core.device import resolve_device
from stemgnn_tpu_torch.data.registry import load_dataset
from stemgnn_tpu_torch.ops import scatter as sc
from stemgnn_tpu_torch.ops.edge_layout import build_edge_layout
from stemgnn_tpu_torch.ops.fused_sage import (DropView, hub_partials,
                                              inv_deg, table_row)
from stemgnn_tpu_torch.profile_encode import (_device_us, _on_device,
                                              card_line)
from stemgnn_tpu_torch.profile_pretrain import dropout_tail_cases
from stemgnn_tpu_torch.train.graph_setup import fused_full_graph

K1, K2, K3 = ("scatter_rows_sorted", "gathered_scatter_rows_sorted",
              "masked_scatter_rows_sorted")
KERNELS = (K1, K2, K3)
# the -D prefix of each kernel's own choices
_PREFIX = {K1: "K1_", K2: "K2_", K3: "K3_"}
D, SEED, TYPES = 768, 42, 11
WN18RR_ENTITIES, WN18RR_TRIPLES = 40_943, 93_003
# f32 out against the plain version: the smoke's tolerance
RTOL, ATOL = 1e-4, 1e-3

# -D values per variant; the sources' defaults are "chosen".  U: rows in
# flight a warp; MIN_BLOCKS: blocks of 128 threads an SM that the register
# cap must allow (1 = no cap, 5 = 96 registers, 8 = 64).
_ALL = ("K1_", "K2_", "K2_XE_", "K3_")


def _each(u, blocks):
    out = {}
    for p in _ALL:
        out[p + "UNROLL"], out[p + "MIN_BLOCKS"] = u, blocks
    return out


VARIANTS = {
    "chosen": {},
    "no_prefetch": dict(ROW_WALK_PREFETCH=0),
    "u8": _each(8, 1),
    "u4": _each(4, 1),                      # the first row walk
    "u2": _each(2, 1),
    "u2_cap96": _each(2, 5),
    "u1_cap64": _each(1, 8),
    "xe_u1_nocap": dict(K2_XE_MIN_BLOCKS=1),
    "k3_u1_cap64": dict(K3_MIN_BLOCKS=8),
    "k1_u2": dict(K1_UNROLL=2),
    "k1_u1_nocap": dict(K1_MIN_BLOCKS=1),
    "k1_prefetch": dict(K1_PREFETCH=1),
}


def _touches(name: str, defines: dict) -> bool:
    return any(k.startswith(_PREFIX[name]) or k.startswith("ROW_WALK_")
               for k in defines)


def build_variants(variants: dict) -> dict:
    """{(variant, kernel): (ctypes library, ptxas log)}; a variant that
    leaves a source at its defaults shares the "chosen" build of it."""
    out_dir = os.path.join(sc.BUILD_DIR, "tune")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for var, defines in variants.items():
        for name in KERNELS:
            if var != "chosen" and not _touches(name, defines):
                continue
            path = os.path.join(out_dir, f"{name}-{var}.so")
            flags = [f"-D{k}={v}" for k, v in defines.items()]
            procs[(var, name)] = (path, subprocess.Popen(
                [sc._nvcc(), *sc.NVCC_FLAGS, *flags, "-o", path,
                 sc._source(name)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(path)
        fn = getattr(lib, f"{key[1]}_launch")
        fn.argtypes, fn.restype = sc.KERNELS[key[1]], ctypes.c_int
        built[key] = (lib, log)
    for var in variants:
        for name in KERNELS:
            built.setdefault((var, name), built[("chosen", name)])
    return built


# whole-row instances with f32 out (and bf16 dm) by the start of their
# mangled template arguments: the instances the paths launch
_PATH_INSTANCES = {K1: {"13__nv_bfloat16f": "bf16 messages",
                        "ff": "f32 messages"},
                   K2: {"Li0Ef": "plain", "Li1Ef": "t0", "Li2Ef": "xe"},
                   K3: {"Lb0E13__nv_bfloat16f": "untyped",
                        "Lb1E13__nv_bfloat16f": "typed"}}


def path_registers(name: str, log: str) -> str:
    """Registers and spilled bytes of the path instances of ``name``'s walk
    (whole rows: ``Li8ELi3E`` in the mangled name) in a ``-Xptxas -v``
    report."""
    out, fn = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn, spill = line.split("'")[1], 0
        elif fn and "bytes spill stores" in line:
            spill = int(line.split("bytes stack frame, ")[1].split()[0])
        elif fn and "Used" in line and "registers" in line:
            tmpl = fn.split("rows_kernelI")[-1]
            for prefix, label in _PATH_INSTANCES[name].items():
                if "Li8ELi3E" in tmpl and tmpl.startswith(prefix):
                    regs = int(line.split("Used ")[1].split()[0])
                    out.append(f"{label} {regs} registers"
                               + (f" ({spill} B spilled)" if spill else ""))
            fn = None
    return ", ".join(out)


def cases(dev) -> dict:
    """name -> (wrapper, positional arguments, keywords with the plan)."""
    out = {}
    ds = load_dataset("arxiv_synthetic_pl", feat_dim=D, seed=SEED)
    graph = fused_full_graph(ds, FinetuneConfig(), device=dev)
    lay = graph.layout
    src = graph.node_feat.to(torch.bfloat16)
    t0 = table_row(graph.edge_table, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(2)
    gp = (torch.randn(src.shape, device=dev, generator=gen)
          * inv_deg(lay)).to(torch.bfloat16)
    ft, bt, n_pad = lay.hub_r.tail, lay.hub_s.tail, lay.num_nodes_padded
    view = DropView(lay, torch.tensor(12345, device=dev), 0.2)
    for direction, (args, kw, plan) in dropout_tail_cases(
            graph, view, src, t0).items():
        out[f"pretrain {direction} tail"] = (
            sc.scatter_rows_sorted, tuple(args.values()), {**kw, **plan})
    out["node fwd tail (t0)"] = (sc.gathered_scatter_rows_sorted, (
        ft.senders_r[None, :], ft.lrow_r, ft.block_ptr_r, src, t0), dict(
        num_nodes_padded=n_pad, relu=True,
        init=hub_partials(src, lay.hub_r, t0), scale=inv_deg(lay),
        plan=ft.plan_r))
    out["node bwd tail (plain)"] = (sc.gathered_scatter_rows_sorted, (
        bt.receivers_s[None, :], bt.lrow_s, bt.block_ptr_s, gp), dict(
        num_nodes_padded=n_pad, init=hub_partials(gp, lay.hub_s, None,
                                                  relu=False),
        gate=src + t0, plan=bt.plan_s))
    del graph

    s, r = (np.asarray(a, np.int32) for a in ds.edge_index)
    rng = np.random.default_rng(SEED)
    whole = build_edge_layout(s, r, n_pad,
                              xe_ids=rng.integers(0, TYPES, len(s)),
                              num_edge_types=TYPES, device=dev)
    out.update(_typed_cases("arxiv", whole, dev))
    del ds

    kg = load_dataset("kg_synthetic", feat_dim=D, seed=SEED,
                      num_entities=WN18RR_ENTITIES, num_edges=WN18RR_TRIPLES)
    cfg = FinetuneConfig(
        encoder=EncoderConfig(input_dim=D, hidden_dim=D),
        vq=VQConfig(dim=D, codebook_dim=D, commitment_weight=0.25),
        dataset=kg.name, task="link",
        num_classes=kg.num_classes)
    out.update(_typed_cases("link", fused_full_graph(kg, cfg,
                                                     device=dev).layout, dev))
    return out


def _typed_cases(tag, lay, dev) -> dict:
    """Kernel 2's xe mode over the receiver order (relu, f32 sums, no
    epilogue: the typed forward without hubs) and kernel 3 over the sender
    order (bf16 dm), on seeded random values."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_pad = lay.num_nodes_padded
    x = torch.randn(n_pad, D, device=dev, generator=gen).to(torch.bfloat16)
    table = torch.randn(TYPES, D, device=dev, generator=gen).to(
        torch.bfloat16)
    dm = torch.randn(lay.num_edges_padded, D, device=dev, generator=gen,
                     dtype=torch.bfloat16)
    dm.masked_fill_(~lay.mask_s[:, None], 0)
    return {
        f"{tag} xe mode": (sc.gathered_scatter_rows_sorted, (
            lay.senders_r[None, :], lay.lrow_r, lay.block_ptr_r, x, table,
            lay.xe_r[None, :]), dict(num_nodes_padded=n_pad, relu=True,
                                     plan=lay.plan_r)),
        f"{tag} kernel 3": (sc.masked_scatter_rows_sorted, (
            dm, lay.lrow_s, lay.senders_s[None, :], lay.block_ptr_s, x,
            table, lay.xe_s[None, :]), dict(num_nodes_padded=n_pad,
                                            plan=lay.plan_s))}


def cuda_ms(fn, reps: int) -> float:
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


def walk_and_split_ms(fn, reps: int):
    """Device ms per call of the walk kernel and of the second pass
    (``split_rows_kernel``), from ``torch.profiler``; None where the
    profiler saw no walk kernel (its device events are printed then)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # one PyTorch kernel in the window beside the ctypes launches
        torch.ones(1, device="cuda").add_(1)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    walk = split = 0.0
    seen = []
    for e in prof.key_averages():
        if not _on_device(e):
            continue
        seen.append(f"{e.key[:60]} {_device_us(e):.1f} us")
        if "split_rows_kernel" in e.key:
            split += _device_us(e)
        elif "rows_kernel" in e.key:
            walk += _device_us(e)
    if walk == 0.0:
        print(f"  the profiler saw no walk kernel; device events: {seen}",
              flush=True)
        return None
    return walk / 1e3 / reps, split / 1e3 / reps


def main(argv=None):
    p = argparse.ArgumentParser("tune_row_walk")
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    built = build_variants(VARIANTS)
    print(f"built {len(VARIANTS)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for var in VARIANTS:
        for name in KERNELS:
            print(f"  {var} {name}: "
                  f"{path_registers(name, built[(var, name)][1])}",
                  flush=True)
    times, plans = {}, []
    for case, (fn, a, kw) in cases(dev).items():
        name = fn.__name__
        ref = getattr(sc, name + "_ref")
        plain_kw = {k: v for k, v in kw.items() if k != "plan"}
        want = ref(*a, **plain_kw)
        for var in VARIANTS:
            sc._libs[name] = built[(var, name)][0]
            got = fn(*a, **kw)
            bad = ~torch.isclose(got, want, rtol=RTOL, atol=ATOL)
            if bool(bad.any()):
                raise AssertionError(
                    f"{var} on {case}: {int(bad.sum())} values off, max abs "
                    f"err {float((got - want).abs().max()):.3e}")
        # two passes, the second in reverse order, against the bias of a
        # variant's place in the sequence
        for order in (1, -1):
            for var in list(VARIANTS)[::order]:
                sc._libs[name] = built[(var, name)][0]
                times[(case, var, order)] = cuda_ms(lambda: fn(*a, **kw),
                                                    args.reps)
        sc._libs[name] = built[("chosen", name)][0]
        plan = kw["plan"]
        dev_ms = walk_and_split_ms(lambda: fn(*a, **kw), args.reps)
        line = (f"  {case}: {plan.num_items} items of at most {plan.chunk} "
                f"edges, {plan.num_split} split rows over {plan.num_slots} "
                f"items; ")
        if dev_ms is None:
            line += "device times not measured"
        else:
            walk, split = dev_ms
            line += (f"walk {walk:.4f} ms, second pass {split:.4f} ms "
                     f"({100 * split / (walk + split):.1f}% of the call's "
                     f"device time)")
        plans.append(line)
        sc._libs.pop(name, None)
        del want
        torch.cuda.empty_cache()
    case_names = list(dict.fromkeys(c for c, _, _ in times))
    print(f"ms (CUDA events, mean of {args.reps}; the variants timed in the "
          f"order listed / in reverse order)")
    print(f"{'variant':>14}  " + "  ".join(f"{c:>22}" for c in case_names))
    for var in VARIANTS:
        print(f"{var:>14}  " + "  ".join(
            f"{times[(c, var, 1)]:10.4f} / {times[(c, var, -1)]:.4f}"
            for c in case_names))
    print("row plans and the chosen build's device time (torch.profiler, "
          f"mean of {args.reps}):")
    print("\n".join(plans))
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
