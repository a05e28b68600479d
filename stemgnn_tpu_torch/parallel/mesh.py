"""Rank set-up of the multi-GPU paths (counterpart of
``stemgnn_tpu/parallel/mesh.py``: ``make_mesh`` / ``initialize_multihost`` /
``host_shard``).

JAX runs one process over a mesh of devices; here every rank is a process
with one device, joined by ``torch.distributed``.  A run is one 1-D set of
ranks, the "edge" axis of the halo path: rank ``i`` owns node block ``i``.

  * **torchrun**: with ``RANK`` / ``WORLD_SIZE`` (and ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``) in the environment each process is one rank and
    initialises through ``env://``.
  * **spawned**: otherwise the caller starts the ranks itself
    (:func:`spawn`), one process each, initialised through a ``file://``
    store in a temporary directory (no TCP port to collide with another run
    on the host).  One rank needs no process: it runs in the caller's.
    :func:`prestart` starts a world's processes ahead of its ``spawn``, so
    that their seconds of imports and joining run beside the caller's work.

A CUDA rank takes card ``local_rank % device_count``.  The backend is NCCL
when every rank on the host has a card of its own and gloo when ranks share
a card or run on the CPU (:func:`backend_for`).  Ranks that share a card
hand gloo their CUDA tensors as they are: gloo moves them through the host
itself.  Nothing moves to the CPU unless the run asks for the CPU.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist


def host_rank_limit() -> int:
    """The ranks this host can hold: one process per CPU core it lets this
    process use."""
    return len(os.sched_getaffinity(0))


def backend_for(device_type: str, local_world: int,
                device_count: int) -> str:
    """NCCL when every rank on the host has a card of its own, else gloo
    (ranks on the CPU, or sharing a card)."""
    if device_type == "cuda" and local_world <= device_count:
        return "nccl"
    return "gloo"


@dataclasses.dataclass
class Ranks:
    """One rank's view of the run: its rank, the world size, its device,
    the backend and the process group of the edge axis (all ranks).
    ``owns_group``: :func:`init_ranks` created the default group
    (:meth:`close` destroys it).  ``timer``: None, or a function of a span
    name returning a context manager, which times every all_to_all under
    ``exchange_ms``.  Every collective is the identity at world size 1."""
    rank: int
    world: int
    device: torch.device
    backend: str
    group: Optional[object] = None
    owns_group: bool = False
    timer: Optional[Callable] = None

    def describe(self) -> str:
        shared = (" (ranks share the card)" if self.backend == "gloo"
                  and self.device.type == "cuda" else "")
        return (f"backend {self.backend}{shared}, world {self.world}, rank "
                f"{self.rank} on {self.device}")

    def all_reduce(self, t):
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        if self.world > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def all_to_all(self, blocks):
        """``blocks`` [world, R, ...]: block ``j`` goes to rank ``j``;
        returns [world, R, ...] whose block ``j`` came from rank ``j``.  A
        rank's block to itself does not travel: it comes back zero."""
        if self.world == 1:
            return blocks.clone()
        span = (self.timer("exchange_ms") if self.timer is not None
                else contextlib.nullcontext())
        with span:
            others = [j for j in range(self.world) if j != self.rank]
            src = blocks[others].contiguous()
            recv = torch.empty_like(src)
            sizes = [0 if j == self.rank else int(blocks.shape[1])
                     for j in range(self.world)]
            dist.all_to_all_single(recv.view(-1, *recv.shape[2:]),
                                   src.view(-1, *src.shape[2:]),
                                   output_split_sizes=sizes,
                                   input_split_sizes=sizes, group=self.group)
            out = blocks.new_zeros(blocks.shape)
            out[others] = recv
        return out

    def broadcast(self, t, src: int = 0):
        if self.world > 1:
            dist.broadcast(t, src, group=self.group)
        return t

    def close(self):
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False


def check_world(world: int, device_type: str):
    """Raise when the host cannot hold ``world`` ranks."""
    if world < 1:
        raise ValueError(f"the world size must be at least 1, got {world}")
    limit = host_rank_limit()
    if world > limit:
        raise ValueError(
            f"{world} ranks exceed what this host can hold: one process a "
            f"rank and {limit} CPU cores here")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA ranks asked for and CUDA is not available; "
                           "pass --device cpu to run the ranks on the CPU")


def init_ranks(rank: int, world: int, device_type: str, *,
               store: Optional[str] = None, local_rank: Optional[int] = None,
               local_world: Optional[int] = None) -> Ranks:
    """Initialise this process as ``rank`` of ``world`` (the default
    process group, through ``file://<store>`` or, without a store,
    torchrun's ``env://``) and pick its device and backend."""
    local_rank = rank if local_rank is None else local_rank
    local_world = world if local_world is None else local_world
    count = torch.cuda.device_count() if device_type == "cuda" else 0
    if device_type == "cuda":
        if count == 0:
            raise RuntimeError("CUDA ranks asked for and no card is visible")
        device = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    backend = backend_for(device_type, local_world, count)
    owns = False
    if not dist.is_initialized():
        kw = dict(backend=backend, rank=rank, world_size=world)
        if backend == "nccl":
            kw["device_id"] = device
        dist.init_process_group(
            init_method=("env://" if store is None else f"file://{store}"),
            **kw)
        owns = True
    elif dist.get_backend() != backend or dist.get_world_size() != world:
        raise RuntimeError(
            f"a process group ({dist.get_backend()}, world "
            f"{dist.get_world_size()}) already exists; this run needs "
            f"{backend} over {world} ranks")
    return Ranks(rank=rank, world=world, device=device, backend=backend,
                 group=dist.group.WORLD, owns_group=owns)


def env_world() -> Optional[dict]:
    """torchrun's rank variables, or None outside torchrun."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    return dict(rank=int(os.environ["RANK"]), world=world,
                local_rank=int(os.environ.get("LOCAL_RANK", 0)),
                local_world=int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def _rank_main(tmp: str, rank: int, world: int, device_type: str):
    """One spawned rank (``python -m stemgnn_tpu_torch.parallel.mesh``):
    threads shared fairly, the process group, ``fn(ranks, *args)`` read
    from the file beside the store once the caller has written it, its
    result pickled there (a dict result gains ``start_marks``: the host
    clock after the imports, the process group, the compiler stack's
    import and the call's read)."""
    parent = os.getppid()
    marks = {"imported": time.time()}
    torch.set_num_threads(max(1, host_rank_limit() // world))
    ranks = init_ranks(rank, world, device_type,
                       store=os.path.join(tmp, "store"))
    marks["initialised"] = time.time()
    try:
        # before the call comes: the compiler stack that every optimizer
        # imports when it is built (seconds of host time)
        importlib.import_module("torch._dynamo")
        marks["compiler_imported"] = time.time()
        call = os.path.join(tmp, "call.pkl")
        while not os.path.exists(call):
            if os.getppid() != parent:
                raise SystemExit("the process that started this rank ended")
            time.sleep(0.05)
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        marks["call_read"] = time.time()
        out = fn(ranks, *args)
        if isinstance(out, dict):
            out["start_marks"] = marks
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        ranks.close()


# worlds started by :func:`prestart`, by (world, device type)
_READY = {}


def _start(world: int, device_type: str):
    """``world`` rank processes (``python -m stemgnn_tpu_torch.parallel.mesh``,
    with this process's import path) and the temporary directory of their
    store and files."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in sys.path if p))
    tmp = tempfile.TemporaryDirectory()
    procs = [subprocess.Popen(
        [sys.executable, "-m", __name__, tmp.name, str(r), str(world),
         device_type], env=env) for r in range(world)]
    return tmp, procs


def _stop(tmp, procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        p.wait()
    tmp.cleanup()


@atexit.register
def _stop_ready():
    while _READY:
        _stop(*_READY.popitem()[1])


def prestart(world: int, device_type: str):
    """Start the ranks of the next :func:`spawn` of ``world`` ranks on
    ``device_type`` now: they import, join their group and import the
    compiler stack beside the caller's work, then wait for that call.
    Ranks never called are stopped when this process exits."""
    check_world(world, device_type)
    if world > 1 and (world, device_type) not in _READY:
        _READY[(world, device_type)] = _start(world, device_type)


def spawn(fn: Callable, world: int, device_type: str, *args) -> list:
    """Run ``fn(ranks, *args)`` on ``world`` ranks and return their results
    in rank order.  One rank runs in this process; more are processes
    started here (or by :func:`prestart`), which import only what ``fn``
    needs.  ``fn`` (a module-level function) and ``args`` are pickled once
    into a file that every rank reads: each rank gets its own copy.  When a
    rank fails the others are stopped and the call raises; every process
    is waited for."""
    check_world(world, device_type)
    if world == 1:
        with tempfile.TemporaryDirectory() as tmp:
            ranks = init_ranks(0, 1, device_type,
                               store=os.path.join(tmp, "store"))
            try:
                return [fn(ranks, *args)]
            finally:
                ranks.close()
    tmp, procs = (_READY.pop((world, device_type), None)
                  or _start(world, device_type))
    failed = None
    try:
        # renamed into place whole once written
        with open(os.path.join(tmp.name, "call.tmp"), "wb") as f:
            pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(os.path.join(tmp.name, "call.tmp"),
                   os.path.join(tmp.name, "call.pkl"))
        while failed is None and any(p.poll() is None for p in procs):
            time.sleep(0.05)
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
        if failed is None:
            failed = next((r for r, p in enumerate(procs)
                           if p.returncode != 0), None)
        if failed is not None:
            raise RuntimeError(f"rank {failed} of {world} failed (exit code "
                               f"{procs[failed].returncode}); its error is "
                               f"above")
        out = []
        for r in range(world):
            with open(os.path.join(tmp.name, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        _stop(tmp, procs)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    # the result is on disk and the group closed: skip the interpreter's
    # teardown of everything imported (seconds the caller would wait)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
