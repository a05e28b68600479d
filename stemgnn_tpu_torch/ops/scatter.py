"""``scatter_rows_sorted``: segment scatter-sum over block-grouped edges
with a fused epilogue — the hand-written Hopper kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``stemgnn_tpu/ops/scatter_pallas.py``
``scatter_rows_sorted`` (``:252``, ``pallas_call`` at ``:339``).  Contract,
for node blocks of 128 rows and ``b = n // 128``::

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

On the H100 the kernel is bound by bytes: ``E_pad*(2D + 4)`` bytes of bf16
messages and rows plus ``N_pad*D*4`` each for an f32 ``init`` and the f32
output, over 3.35 TB/s.  The design (see ``csrc/scatter_rows_sorted.cu``)
gives each CUDA block one node block x 128 columns with a shared-memory f32
accumulator that only the owning thread touches, and keeps 16 message loads
per thread in flight.

The wrapper runs the CUDA kernel for CUDA tensors and the plain version
(:func:`scatter_rows_sorted_ref`) for CPU tensors — nothing else.  The
kernel is compiled with ``nvcc`` at first use into ``_build/`` beside this
package, keyed by a hash of the source, and loaded with ``ctypes``.
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

NODE_BLOCK = 128

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "scatter_rows_sorted.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches by name; the wrapper adds one per launch of its kernel
# (and nowhere else), so a caller can show that a run went through it.
launch_counts = {"scatter_rows_sorted": 0}

# What the last build did: seconds and the compiler's report (registers,
# shared memory, spills), or "cached" when the library was already built.
build_info: dict = {}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): the "
                       "scatter_rows_sorted kernel is built from source at "
                       "first use")


def load_library(force_build: bool = False) -> ctypes.CDLL:
    """Build (once per source hash, or anew with ``force_build``) and load
    the kernel library."""
    global _lib
    if _lib is not None and not force_build:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("scatter_rows_sorted's CUDA kernel needs a CUDA "
                           "device; none is available")
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"scatter_rows_sorted-{digest}.so")
    if os.path.exists(path) and not force_build:
        build_info.update(seconds=0.0, log="cached", path=path)
    else:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
        build_info.update(seconds=time.perf_counter() - t0,
                          log=(proc.stdout + proc.stderr).strip(), path=path)
    lib = ctypes.CDLL(path)
    fn = lib.scatter_rows_sorted_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _check(m, local_row, block_ptr, num_nodes_padded, node_block, init,
           scale, gate, out_dtype):
    if node_block != NODE_BLOCK:
        raise ValueError(f"node_block must be {NODE_BLOCK}, got {node_block}")
    if m.dim() != 2 or m.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"m must be [E_pad, D] bf16/f32, got "
                         f"{tuple(m.shape)} {m.dtype}")
    e_pad, d = m.shape
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
    for name, t in (("local_row", local_row), ("block_ptr", block_ptr),
                    ("init", init), ("scale", scale), ("gate", gate)):
        if t is not None and t.device != m.device:
            raise ValueError(f"{name} is on {t.device}, m on {m.device}")


def scatter_rows_sorted(m, local_row, block_ptr, *, num_nodes_padded: int,
                        node_block: int = NODE_BLOCK, relu: bool = False,
                        init=None, scale=None, gate=None,
                        out_dtype=torch.float32):
    """Sum-scatter ``m`` into [num_nodes_padded, D] (module docstring).
    CPU tensors run :func:`scatter_rows_sorted_ref`; CUDA tensors launch the
    kernel or raise."""
    _check(m, local_row, block_ptr, num_nodes_padded, node_block, init, scale,
           gate, out_dtype)
    if m.device.type == "cpu":
        return scatter_rows_sorted_ref(
            m, local_row, block_ptr, num_nodes_padded=num_nodes_padded,
            relu=relu, init=init, scale=scale, gate=gate, out_dtype=out_dtype)
    if m.device.type != "cuda":
        raise ValueError(f"scatter_rows_sorted runs on cpu or cuda tensors, "
                         f"got {m.device}")
    e_pad, d = m.shape
    if d % 2:
        raise ValueError(f"the CUDA kernel needs an even D, got {d}")
    tensors = (m, local_row, block_ptr, init, scale, gate)
    if any(t is not None and not t.is_contiguous() for t in tensors):
        raise ValueError("scatter_rows_sorted's CUDA kernel needs contiguous "
                         "inputs")
    lib = load_library()
    out = torch.empty((num_nodes_padded, d), dtype=out_dtype, device=m.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        err = lib.scatter_rows_sorted_launch(
            ptr(m), ptr(local_row), ptr(block_ptr), ptr(init), ptr(scale),
            ptr(gate), ptr(out), num_nodes_padded // NODE_BLOCK, e_pad, d,
            int(m.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            int(relu), int(init is not None and init.dtype == torch.bfloat16),
            int(gate is not None and gate.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"scatter_rows_sorted kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts["scatter_rows_sorted"] += 1
    return out


def scatter_rows_sorted_ref(m, local_row, block_ptr, *,
                            num_nodes_padded: int, relu: bool = False,
                            init=None, scale=None, gate=None,
                            out_dtype=torch.float32):
    """The plain PyTorch version of the same contract: each edge's output
    row is ``block * 128 + local_row``, and ``index_add_`` sums the (relu'd)
    f32 messages of the non-sentinel edges inside some block's range."""
    e_pad, d = m.shape
    pos = torch.arange(e_pad, device=m.device, dtype=torch.int32)
    blk = torch.searchsorted(block_ptr, pos, right=True).long() - 1
    lrow = local_row.reshape(-1).long()
    ok = (blk >= 0) & (pos < block_ptr[-1]) & (lrow >= 0) & (lrow < NODE_BLOCK)
    msg = m.float()
    if relu:
        msg = torch.relu(msg)
    out = torch.zeros((num_nodes_padded, d), dtype=torch.float32,
                      device=m.device)
    out.index_add_(0, (blk * NODE_BLOCK + lrow)[ok], msg[ok])
    if init is not None:
        out = out + init.float()
    if scale is not None:
        out = out * scale
    if gate is not None:
        out = torch.where(gate.float() > 0, out,
                          torch.zeros((), device=m.device))
    return out.to(out_dtype)
