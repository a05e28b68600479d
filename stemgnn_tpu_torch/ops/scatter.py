"""The three segment-scatter kernels of the fused aggregation, hand-written
for Hopper, and their plain PyTorch versions.

``scatter_rows_sorted`` replaces the Pallas TPU kernel
``stemgnn_tpu/ops/scatter_pallas.py`` ``scatter_rows_sorted`` (``:252``,
``pallas_call`` at ``:339``).  Contract, for node blocks of 128 rows and
``b = n // 128``::

    out[n] = gate?(scale[n] * (init[n] + sum_{e in [bp[b], bp[b+1]),
                                              lrow[e] == n % 128} relu?(m[e])))

``m`` [E_pad, D] bf16 or f32 messages in layout order
(ops.edge_layout.build_edge_layout); ``local_row`` [1, E_pad] int32 with the
sentinel 128 on padded edges; ``block_ptr`` [N_pad/128 + 1] int32; optional
``init`` [N_pad, D] (f32 or bf16), ``scale`` [N_pad, 1] f32 and ``gate``
[N_pad, D] (zero where ``gate <= 0``).  Sums accumulate in f32 over the
message values as given (the TPU kernel's ``fast`` switch only chose how it
rounded f32 messages for its matrix unit; here a bf16 message is summed
exactly as bf16 and an f32 message as f32).

``gathered_scatter_rows_sorted`` replaces ``gathered_scatter_rows_sorted``
(``:740``, ``pallas_call`` at ``:865``): the same sum and epilogue over
messages the kernel builds from gathered rows,

    m[e] = bf16(relu?(f32(x[keys[e]]) + f32(table[xe[e]] | t0)))

with ``x`` [N_pad, D] bf16, ``keys`` [1, E_pad] int32 gather-side node ids
(sentinel N_pad on padded edges) and ``table`` None, one bf16 row ``t0``
added to every message, or [T, D] bf16 rows picked by ``xe`` [1, E_pad].
The TPU kernel's gather windows (``win_lo``, ``win_nsub``, ``win_w``) are
TPU mechanism and have no counterpart.  Its merged-LocSplit inputs come
all four together: an edge whose ``stray_idx[e] >= 0`` ([1, E_pad] int32,
-1 elsewhere) takes its row from ``stray_src[stray_idx[e]]`` ([S, D] bf16
or f32, rounded to bf16 as the TPU kernel's one-hot product rounds it) in
place of ``x[keys[e]]``; ``stray_off`` / ``stray_cnt`` [C] are the TPU
kernel's DMA metadata, checked against ``stray_idx`` on the host
(:func:`~stemgnn_tpu_torch.ops.edge_layout.check_stray_metadata`, when the
plan is built or, on the CPU, in the call) and read by no GPU kernel.

``masked_scatter_rows_sorted`` replaces ``masked_scatter_rows_sorted``
(``:480``, ``pallas_call`` at ``:546``), the typed backward's sum of edge
gradients gated by the recomputed relu mask, over sender-sorted edges::

    out[n] = sum_{e: lrow[e] == n % 128} 1[f32(x[snd[e]]) + f32(T[xe[e]]) > 0]
                                         * dm[e]

with ``dm`` [E_pad, D] bf16 or f32 (summed as given, in f32), ``senders``
[1, E_pad] int32 (sentinel N_pad on padded edges), ``x`` [N_pad, D] bf16,
and ``table`` None (mask ``x > 0``) or [T, D] bf16 with ``xe`` [1, E_pad]
int32.  No epilogue.  The TPU kernel's x windows (``win_lo``,
``win_nsub``, ``win_w``) have no counterpart: on the sender-sorted layout
the gating row is one of the node block's own rows.

All three are bound by bytes on the H100 (see the notes in ``csrc/``) and
walk output rows (``csrc/row_walk.cuh``): a host-side
:class:`~stemgnn_tpu_torch.ops.edge_layout.RowPlan` lists the counted edges
in output-row order, cut into work items of at most ``RowPlan.chunk``
edges; one warp sums one item in registers and finishes its row, and a
second pass inside the same launch call adds the partial sums of the rows
longer than a chunk.  Kernels 1 and 3 read their message rows at the plan's
layout positions, kernel 2 gathers its rows by the plan's keys.  The
wrappers take the plan (``plan=``: the layout's ``plan_r``/``plan_s``, or
:func:`~stemgnn_tpu_torch.ops.edge_layout.row_plan` for bare arrays); a
CUDA call without the plan of the arrays it is given raises.  A warp covers
whole rows (up to 768 columns a pass, 8 columns a lane at once), or pairs
of columns where D or the arrays' alignment does not allow 8.

Each wrapper runs its CUDA kernel for CUDA tensors and its plain version
(``*_ref``) for CPU tensors — nothing else; a CPU call ignores the plan —
and adds one to ``launch_counts[name]`` and to the plan's
``RowPlan.launches[name]`` per launch call (the second pass runs inside
that call and is not counted apart).  The
kernels are compiled with ``nvcc`` at first use into ``_build/`` beside this
package, keyed by a hash of the sources, one ``nvcc`` per kernel started
together (:func:`build`), and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

import torch

from stemgnn_tpu_torch.ops.edge_layout import check_stray_metadata

NODE_BLOCK = 128

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel name -> argument types of its C entry ``<name>_launch``
KERNELS = {
    "scatter_rows_sorted": [_P] * 12 + [_I] * 9 + [_P],
    "gathered_scatter_rows_sorted": [_P] * 16 + [_I] * 10 + [_P],
    "masked_scatter_rows_sorted": [_P] * 13 + [_I] * 8 + [_P],
}

# column layouts of the row walk (csrc/row_walk.cuh ``ColMode``) and the
# columns a lane reads at once in each
_COL_MODES = {"full_row": (0, 8), "pairs": (1, 2)}

# Kernel launches by name; each wrapper adds one per launch of its kernel
# (and nowhere else), so a caller can show that a run went through it.
launch_counts = {name: 0 for name in KERNELS}

# What the last build of each kernel did: seconds and the compiler's report
# (registers, shared memory, spills), or "cached" when it was already built.
build_info: dict = {}

_libs: dict = {}


def _source(name: str) -> str:
    return os.path.join(_PKG, "csrc", f"{name}.cu")


def _headers() -> list:
    csrc = os.path.join(_PKG, "csrc")
    return sorted(os.path.join(csrc, f) for f in os.listdir(csrc)
                  if f.endswith(".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): the "
                       "CUDA kernels are built from source at first use")


def _library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [_source(name)] + _headers():
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names=tuple(KERNELS), force: bool = False) -> None:
    """Compile the named kernels that are not built yet (all of them with
    ``force``), one ``nvcc`` per source, all started together."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device; none is "
                           "available")
    todo = {}
    for name in names:
        path = _library_path(name)
        if os.path.exists(path) and not force:
            build_info[name] = dict(seconds=0.0, log="cached", path=path)
        else:
            todo[name] = path
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", f"{path}.{os.getpid()}.tmp",
         _source(name)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, path in todo.items()}
    failed = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        path = todo[name]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{log}")
            continue
        os.replace(f"{path}.{os.getpid()}.tmp", path)
        build_info[name] = dict(seconds=time.perf_counter() - t0,
                                log=log.strip(), path=path)
        _libs.pop(name, None)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str = "scatter_rows_sorted",
                 force_build: bool = False) -> ctypes.CDLL:
    """Build (once per source hash, or anew with ``force_build``) and load
    one kernel's library."""
    if name in _libs and not force_build:
        return _libs[name]
    build((name,), force=force_build)
    lib = ctypes.CDLL(build_info[name]["path"])
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = KERNELS[name]
    fn.restype = ctypes.c_int
    _libs[name] = lib
    return lib


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _bf16(t) -> int:
    return int(t is not None and t.dtype == torch.bfloat16)


def _check_rows(e_pad, local_row, block_ptr, num_nodes_padded, node_block):
    if node_block != NODE_BLOCK:
        raise ValueError(f"node_block must be {NODE_BLOCK}, got {node_block}")
    if num_nodes_padded % NODE_BLOCK:
        raise ValueError(f"num_nodes_padded {num_nodes_padded} is not a "
                         f"multiple of {NODE_BLOCK}")
    if local_row.shape != (1, e_pad) or local_row.dtype != torch.int32:
        raise ValueError(f"local_row must be [1, {e_pad}] int32, got "
                         f"{tuple(local_row.shape)} {local_row.dtype}")
    nblk = num_nodes_padded // NODE_BLOCK
    if block_ptr.shape != (nblk + 1,) or block_ptr.dtype != torch.int32:
        raise ValueError(f"block_ptr must be [{nblk + 1}] int32, got "
                         f"{tuple(block_ptr.shape)} {block_ptr.dtype}")


def _check_epilogue(d, num_nodes_padded, init, scale, gate, out_dtype):
    for name, t, shape, dtypes in (
            ("init", init, (num_nodes_padded, d),
             (torch.float32, torch.bfloat16)),
            ("scale", scale, (num_nodes_padded, 1), (torch.float32,)),
            ("gate", gate, (num_nodes_padded, d),
             (torch.float32, torch.bfloat16))):
        if t is not None and (tuple(t.shape) != shape
                              or t.dtype not in dtypes):
            raise ValueError(f"{name} must be {shape} {dtypes}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be f32 or bf16, got {out_dtype}")


def _check_device(name, anchor, tensors: dict):
    """All tensors on ``anchor``'s device; that device is cpu or cuda; a
    CUDA launch also needs contiguous arrays and an even D."""
    for k, t in tensors.items():
        if t is not None and t.device != anchor.device:
            raise ValueError(f"{k} is on {t.device}, {name}'s first input "
                             f"on {anchor.device}")
    if anchor.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, got "
                         f"{anchor.device}")
    if anchor.device.type == "cuda":
        if anchor.shape[-1] % 2:
            raise ValueError(f"the CUDA kernel needs an even D, got "
                             f"{anchor.shape[-1]}")
        if any(t is not None and not t.is_contiguous()
               for t in tensors.values()):
            raise ValueError(f"{name}'s CUDA kernel needs contiguous inputs")


def _check_plan(name, plan, needed: dict, optional: dict):
    """A non-CPU call needs the plan built from the arrays it is given:
    every array of ``needed``, and those of ``optional`` that are given."""
    if plan is None:
        raise ValueError(
            f"{name} on {next(iter(needed.values())).device} needs the "
            f"RowPlan of its arrays (plan=: a layout's plan_r / plan_s, or "
            f"ops.edge_layout.row_plan)")
    for k, t in list(needed.items()) + [(k, t) for k, t in optional.items()
                                        if t is not None]:
        if not plan.built_from(k, t):
            raise ValueError(f"{name}: the plan was not built from this "
                             f"{k} array")


def _col_mode(d: int, rows: list) -> int:
    """The row walk's column layout: whole rows (8 columns a lane at once),
    or pairs of columns where D or the row arrays' alignment does not allow
    8."""
    def fits(vec):
        return d % vec == 0 and all(
            t.data_ptr() % min(16, t.element_size() * vec) == 0
            for t in rows if t is not None)
    mode, vec = _COL_MODES["full_row"]
    if fits(vec):
        return mode
    mode, vec = _COL_MODES["pairs"]
    if not fits(vec):
        raise ValueError("the CUDA kernel needs row arrays aligned to their "
                         "element pairs")
    return mode


def _launch(name, plan, *args):
    """Call ``<name>_launch`` on the current stream of the first tensor's
    device; raise on a CUDA error; count the launch, here and on ``plan``."""
    lib = load_library(name)
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, f"{name}_launch")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launch_counts[name] += 1
    plan.launches[name] = plan.launches.get(name, 0) + 1


def scatter_rows_sorted(m, local_row, block_ptr, *, num_nodes_padded: int,
                        node_block: int = NODE_BLOCK, relu: bool = False,
                        init=None, scale=None, gate=None,
                        out_dtype=torch.float32, plan=None):
    """Sum-scatter ``m`` into [num_nodes_padded, D] (module docstring).
    CPU tensors run :func:`scatter_rows_sorted_ref`; CUDA tensors launch the
    kernel over ``plan`` (a RowPlan built from ``local_row`` and
    ``block_ptr``) or raise."""
    if m.dim() != 2 or m.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"m must be [E_pad, D] bf16/f32, got "
                         f"{tuple(m.shape)} {m.dtype}")
    e_pad, d = m.shape
    _check_rows(e_pad, local_row, block_ptr, num_nodes_padded, node_block)
    _check_epilogue(d, num_nodes_padded, init, scale, gate, out_dtype)
    if m.device.type != "cpu":
        _check_plan("scatter_rows_sorted", plan,
                    dict(local_row=local_row, block_ptr=block_ptr), {})
    _check_device("scatter_rows_sorted", m, dict(
        m=m, local_row=local_row, block_ptr=block_ptr, init=init,
        scale=scale, gate=gate))
    kw = dict(num_nodes_padded=num_nodes_padded, relu=relu, init=init,
              scale=scale, gate=gate, out_dtype=out_dtype)
    if m.device.type == "cpu":
        return scatter_rows_sorted_ref(m, local_row, block_ptr, **kw)
    out = torch.empty((num_nodes_padded, d), dtype=out_dtype, device=m.device)
    partials = (torch.empty((plan.num_slots, d), dtype=torch.float32,
                            device=m.device) if plan.num_slots else None)
    mode = _col_mode(d, [m, init, gate, out, partials])
    with torch.cuda.device(m.device):
        _launch("scatter_rows_sorted", plan, _ptr(m), _ptr(plan.pos),
                _ptr(plan.item_row), _ptr(plan.item_start),
                _ptr(plan.item_slot), _ptr(plan.split_row),
                _ptr(plan.split_ptr), _ptr(init), _ptr(scale), _ptr(gate),
                _ptr(out), _ptr(partials), plan.num_items, plan.num_split, d,
                _bf16(m), _bf16(out), int(relu), _bf16(init), _bf16(gate),
                mode)
    return out


def gathered_scatter_rows_sorted(keys, local_row, block_ptr, x, table=None,
                                 xe=None, *, num_nodes_padded: int,
                                 node_block: int = NODE_BLOCK,
                                 relu: bool = False, init=None, scale=None,
                                 gate=None, out_dtype=torch.float32,
                                 plan=None, stray_src=None, stray_idx=None,
                                 stray_off=None, stray_cnt=None):
    """Gather ``x[keys]`` (+ the type row), build bf16 messages and
    sum-scatter them into [num_nodes_padded, D] (module docstring).  CPU
    tensors run :func:`gathered_scatter_rows_sorted_ref`; CUDA tensors
    launch the kernel over ``plan`` (a RowPlan built from ``local_row``,
    ``block_ptr``, ``keys`` and, when given, ``xe`` and the ``stray_*``
    metadata) or raise."""
    if keys.dim() != 2 or keys.shape[0] != 1 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be [1, E_pad] int32, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    e_pad = keys.shape[1]
    if x.shape[:1] != (num_nodes_padded,) or x.dim() != 2 \
            or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be [{num_nodes_padded}, D] bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    d = x.shape[1]
    if table is not None and (table.dim() != 2 or table.shape[1] != d
                              or table.dtype != torch.bfloat16):
        raise ValueError(f"table must be [T, {d}] bf16, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if xe is None and table is not None and table.shape[0] != 1:
        raise ValueError("a multi-row table needs the xe stream")
    if xe is not None and (table is None or xe.shape != (1, e_pad)
                           or xe.dtype != torch.int32):
        raise ValueError(f"xe must be [1, {e_pad}] int32 beside a table, "
                         f"got {tuple(xe.shape)} {xe.dtype}")
    stray = dict(stray_src=stray_src, stray_idx=stray_idx,
                 stray_off=stray_off, stray_cnt=stray_cnt)
    _check_stray(stray, e_pad, d)
    _check_rows(e_pad, local_row, block_ptr, num_nodes_padded, node_block)
    _check_epilogue(d, num_nodes_padded, init, scale, gate, out_dtype)
    if x.device.type != "cpu":
        _check_plan("gathered_scatter_rows_sorted", plan,
                    dict(local_row=local_row, block_ptr=block_ptr,
                         keys=keys), dict(xe=xe, stray_idx=stray_idx,
                                          stray_off=stray_off,
                                          stray_cnt=stray_cnt))
        if stray_src is not None and stray_src.shape[0] < plan.stray_rows:
            raise ValueError(f"stray_src has {stray_src.shape[0]} rows, the "
                             f"ranks read {plan.stray_rows}")
    _check_device("gathered_scatter_rows_sorted", x, dict(
        x=x, keys=keys, local_row=local_row, block_ptr=block_ptr,
        table=table, xe=xe, init=init, scale=scale, gate=gate, **stray))
    kw = dict(num_nodes_padded=num_nodes_padded, relu=relu, init=init,
              scale=scale, gate=gate, out_dtype=out_dtype)
    if x.device.type == "cpu":
        if stray_src is not None:
            # on the card the plan's build checks them
            need = check_stray_metadata(stray_idx, stray_off, stray_cnt)
            if stray_src.shape[0] < need:
                raise ValueError(f"stray_src has {stray_src.shape[0]} rows, "
                                 f"the ranks read {need}")
        return gathered_scatter_rows_sorted_ref(keys, local_row, block_ptr,
                                                x, table, xe, **kw, **stray)
    if stray_src is not None:
        stray_src = stray_src.to(torch.bfloat16)
    out = torch.empty((num_nodes_padded, d), dtype=out_dtype, device=x.device)
    partials = (torch.empty((plan.num_slots, d), dtype=torch.float32,
                            device=x.device) if plan.num_slots else None)
    mode = _col_mode(d, [x, table, stray_src, init, gate, out, partials])
    with torch.cuda.device(x.device):
        _launch("gathered_scatter_rows_sorted", plan, _ptr(plan.keys),
                _ptr(None if xe is None else plan.xe),
                _ptr(None if stray_src is None else plan.stray_idx),
                _ptr(stray_src), _ptr(plan.item_row),
                _ptr(plan.item_start), _ptr(plan.item_slot),
                _ptr(plan.split_row), _ptr(plan.split_ptr), _ptr(x),
                _ptr(table), _ptr(init), _ptr(scale), _ptr(gate), _ptr(out),
                _ptr(partials), plan.num_items, plan.num_split,
                num_nodes_padded, d,
                0 if table is None else table.shape[0], _bf16(out),
                int(relu), _bf16(init), _bf16(gate), mode)
    return out


def _check_stray(stray: dict, e_pad: int, d: int):
    """Shapes and dtypes of kernel 2's merged-LocSplit inputs: all four or
    none."""
    given = [k for k, v in stray.items() if v is not None]
    if not given:
        return
    if len(given) != 4:
        raise ValueError(f"stray_src, stray_idx, stray_off and stray_cnt "
                         f"come together, got only {given}")
    src, idx = stray["stray_src"], stray["stray_idx"]
    if src.dim() != 2 or src.shape[1] != d \
            or src.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"stray_src must be [S, {d}] bf16/f32, got "
                         f"{tuple(src.shape)} {src.dtype}")
    if idx.shape != (1, e_pad) or idx.dtype != torch.int32:
        raise ValueError(f"stray_idx must be [1, {e_pad}] int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    for k in ("stray_off", "stray_cnt"):
        a = stray[k]
        if a.dim() != 1 or a.dtype != torch.int32 or a.shape[0] == 0 \
                or e_pad % a.shape[0]:
            raise ValueError(f"{k} must be [C] int32 with C dividing "
                             f"{e_pad}, got {tuple(a.shape)} {a.dtype}")


def masked_scatter_rows_sorted(m, local_row, senders, block_ptr, x,
                               table=None, xe=None, *,
                               num_nodes_padded: int,
                               node_block: int = NODE_BLOCK,
                               out_dtype=torch.float32, plan=None):
    """Sum-scatter ``m`` gated per column by ``x[senders] (+ table[xe]) >
    0`` into [num_nodes_padded, D] (module docstring).  CPU tensors run
    :func:`masked_scatter_rows_sorted_ref`; CUDA tensors launch the kernel
    over ``plan`` (a RowPlan built from ``local_row``, ``block_ptr``,
    ``senders`` and, when given, ``xe``) or raise."""
    if m.dim() != 2 or m.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"m must be [E_pad, D] bf16/f32, got "
                         f"{tuple(m.shape)} {m.dtype}")
    e_pad, d = m.shape
    if senders.shape != (1, e_pad) or senders.dtype != torch.int32:
        raise ValueError(f"senders must be [1, {e_pad}] int32, got "
                         f"{tuple(senders.shape)} {senders.dtype}")
    if x.shape != (num_nodes_padded, d) or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be [{num_nodes_padded}, {d}] bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if (table is None) != (xe is None):
        raise ValueError("table and xe come together (or neither)")
    if table is not None:
        if table.dim() != 2 or table.shape[1] != d \
                or table.dtype != torch.bfloat16:
            raise ValueError(f"table must be [T, {d}] bf16, got "
                             f"{tuple(table.shape)} {table.dtype}")
        if xe.shape != (1, e_pad) or xe.dtype != torch.int32:
            raise ValueError(f"xe must be [1, {e_pad}] int32, got "
                             f"{tuple(xe.shape)} {xe.dtype}")
    _check_rows(e_pad, local_row, block_ptr, num_nodes_padded, node_block)
    _check_epilogue(d, num_nodes_padded, None, None, None, out_dtype)
    if m.device.type != "cpu":
        _check_plan("masked_scatter_rows_sorted", plan,
                    dict(local_row=local_row, block_ptr=block_ptr,
                         senders=senders), dict(xe=xe))
    _check_device("masked_scatter_rows_sorted", m, dict(
        m=m, local_row=local_row, senders=senders, block_ptr=block_ptr, x=x,
        table=table, xe=xe))
    kw = dict(num_nodes_padded=num_nodes_padded, out_dtype=out_dtype)
    if m.device.type == "cpu":
        return masked_scatter_rows_sorted_ref(m, local_row, senders,
                                              block_ptr, x, table, xe, **kw)
    out = torch.empty((num_nodes_padded, d), dtype=out_dtype, device=m.device)
    partials = (torch.empty((plan.num_slots, d), dtype=torch.float32,
                            device=m.device) if plan.num_slots else None)
    mode = _col_mode(d, [m, x, table, out, partials])
    with torch.cuda.device(m.device):
        _launch("masked_scatter_rows_sorted", plan, _ptr(m), _ptr(plan.pos),
                _ptr(plan.senders), _ptr(None if xe is None else plan.xe),
                _ptr(plan.item_row), _ptr(plan.item_start),
                _ptr(plan.item_slot), _ptr(plan.split_row),
                _ptr(plan.split_ptr), _ptr(x), _ptr(table), _ptr(out),
                _ptr(partials), plan.num_items, plan.num_split,
                num_nodes_padded, d, 0 if table is None else table.shape[0],
                _bf16(m), _bf16(out), mode)
    return out


def _edge_rows(local_row, block_ptr):
    """Each edge's output row ``block * 128 + local_row`` and whether it
    counts: a non-sentinel edge inside some block's range."""
    e_pad = local_row.shape[1]
    pos = torch.arange(e_pad, device=local_row.device, dtype=torch.int32)
    blk = torch.searchsorted(block_ptr, pos, right=True).long() - 1
    lrow = local_row.reshape(-1).long()
    ok = (blk >= 0) & (pos < block_ptr[-1]) & (lrow >= 0) & (lrow < NODE_BLOCK)
    return blk * NODE_BLOCK + lrow, ok


def _epilogue(sums, init, scale, gate, out_dtype):
    if init is not None:
        sums = sums + init.float()
    if scale is not None:
        sums = sums * scale
    if gate is not None:
        sums = torch.where(gate.float() > 0, sums,
                           torch.zeros((), device=sums.device))
    return sums.to(out_dtype)


def scatter_rows_sorted_ref(m, local_row, block_ptr, *,
                            num_nodes_padded: int, relu: bool = False,
                            init=None, scale=None, gate=None,
                            out_dtype=torch.float32):
    """The plain PyTorch version of kernel 1's contract: ``index_add_`` sums
    the (relu'd) f32 messages of the edges that count into their rows."""
    rows, ok = _edge_rows(local_row, block_ptr)
    msg = m.float()
    if relu:
        msg = torch.relu(msg)
    out = torch.zeros((num_nodes_padded, m.shape[1]), dtype=torch.float32,
                      device=m.device)
    out.index_add_(0, rows[ok], msg[ok])
    return _epilogue(out, init, scale, gate, out_dtype)


def gathered_scatter_rows_sorted_ref(keys, local_row, block_ptr, x,
                                     table=None, xe=None, *,
                                     num_nodes_padded: int,
                                     relu: bool = False, init=None,
                                     scale=None, gate=None,
                                     out_dtype=torch.float32, stray_src=None,
                                     stray_idx=None, stray_off=None,
                                     stray_cnt=None):
    """The plain PyTorch version of kernel 2's contract: gather the rows of
    the edges that count (a key outside [0, N_pad) reads a zero row; a
    stray edge reads its bf16-rounded ``stray_src`` row instead), add the
    type row in f32, relu, round to bf16, ``index_add_`` in f32.  It reads
    neither ``stray_off`` nor ``stray_cnt``: the wrapper checks them."""
    rows, ok = _edge_rows(local_row, block_ptr)
    k = keys.reshape(-1).long()[ok]
    inside = (k >= 0) & (k < x.shape[0])
    pre = torch.where(inside[:, None],
                      x.index_select(0, k.clamp(0, x.shape[0] - 1)).float(),
                      torch.zeros((), device=x.device))
    if stray_src is not None:
        s = stray_idx.reshape(-1).long()[ok]
        rows_s = stray_src.to(torch.bfloat16).float().index_select(
            0, s.clamp(min=0))
        pre = torch.where((s >= 0)[:, None], rows_s, pre)
    if table is not None:
        if xe is None:
            pre = pre + table[0].float()
        else:
            t = xe.reshape(-1).long()[ok]
            t_ok = (t >= 0) & (t < table.shape[0])
            pre = pre + torch.where(
                t_ok[:, None],
                table.index_select(0, t.clamp(0, table.shape[0] - 1)).float(),
                torch.zeros((), device=x.device))
    if relu:
        pre = torch.relu(pre)
    out = torch.zeros((num_nodes_padded, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, rows[ok], pre.to(torch.bfloat16).float())
    return _epilogue(out, init, scale, gate, out_dtype)


def masked_scatter_rows_sorted_ref(m, local_row, senders, block_ptr, x,
                                   table=None, xe=None, *,
                                   num_nodes_padded: int,
                                   out_dtype=torch.float32):
    """The plain PyTorch version of kernel 3's contract: rebuild each
    counted edge's pre-activation in f32 from the bf16 sender row (a sender
    outside [0, N_pad) reads a zero row) and type row, keep ``m`` where it
    is positive, ``index_add_`` in f32."""
    rows, ok = _edge_rows(local_row, block_ptr)
    snd = senders.reshape(-1).long()[ok]
    inside = (snd >= 0) & (snd < x.shape[0])
    zero = torch.zeros((), device=x.device)
    pre = torch.where(inside[:, None],
                      x.index_select(0, snd.clamp(0, x.shape[0] - 1)).float(),
                      zero)
    if table is not None:
        t = xe.reshape(-1).long()[ok]
        t_ok = (t >= 0) & (t < table.shape[0])
        pre = pre + torch.where(
            t_ok[:, None],
            table.index_select(0, t.clamp(0, table.shape[0] - 1)).float(),
            zero)
    msg = torch.where(pre > 0, m[ok].float(), zero)
    out = torch.zeros((num_nodes_padded, m.shape[1]), dtype=torch.float32,
                      device=m.device)
    out.index_add_(0, rows[ok], msg)
    return out.to(out_dtype)
