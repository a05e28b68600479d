"""Rank set-up of the multi-GPU paths (counterpart of
``stemgnn_tpu/parallel/mesh.py``: ``make_mesh`` / ``initialize_multihost`` /
``host_shard``).

JAX runs one process over a mesh of devices; here every rank is a process
with one device, joined by ``torch.distributed``.  The halo finetune is one
1-D set of ranks, the "edge" axis: rank ``i`` owns node block ``i``.  The
halo pretrain runs JAX's ``('data', 'edge')`` grid (:func:`grid`): rank
``r`` at data replica ``r // S``, edge index ``r % S``, each replica's S
ranks one group for its exchanges, the whole world the sums over both axes.
``--data_parallel`` is one 1-D "data" axis over the world.

  * **torchrun**: with ``RANK`` / ``WORLD_SIZE`` (and ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``) in the environment each process is one rank and
    initialises through ``env://``.
  * **spawned**: otherwise the caller starts the ranks itself
    (:func:`spawn`), one process each, initialised through a ``file://``
    store in a temporary directory (no TCP port to collide with another run
    on the host).  One rank needs no process: it runs in the caller's.
    Every rank process is forked from one factory process per caller
    (``python -m stemgnn_tpu_torch.parallel.mesh``, started at the first
    spawn or by :func:`warm_up`), which imported PyTorch, its compiler
    stack and the parallel modules once and never touches CUDA: a rank
    starts in a fraction of a second of host time instead of seconds of
    imports.  :func:`prestart` starts a world's processes ahead of its
    ``spawn``, so that their joining runs beside the caller's work.

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
import json
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from stemgnn_tpu_torch.utils import trace


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
    (:meth:`close` destroys it).  ``timer``: None, or a
    ``utils.trace.Recorder`` that times every all_to_all in an
    ``sg:mesh.exchange`` span and every all_reduce in an
    ``sg:mesh.allreduce`` span.  Every collective is the identity at world
    size 1."""
    rank: int
    world: int
    device: torch.device
    backend: str
    group: Optional[object] = None
    owns_group: bool = False
    timer: Optional[trace.Recorder] = None

    def describe(self) -> str:
        shared = (" (ranks share the card)" if self.backend == "gloo"
                  and self.device.type == "cuda" else "")
        return (f"backend {self.backend}{shared}, world {self.world}, rank "
                f"{self.rank} on {self.device}")

    def all_reduce(self, t):
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        if self.world > 1:
            with trace.span("sg:mesh.allreduce", self.timer):
                dist.all_reduce(t, group=self.group)
        return t

    def all_to_all(self, blocks):
        """``blocks`` [world, R, ...]: block ``j`` goes to rank ``j``;
        returns [world, R, ...] whose block ``j`` came from rank ``j``.  A
        rank's block to itself does not travel: it comes back zero."""
        if self.world == 1:
            return blocks.clone()
        with trace.span("sg:mesh.exchange", self.timer):
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

    def shift(self, t, step: int = 1):
        """``t`` [n, ...] sent to rank ``rank + step`` (mod world); returns
        rank ``rank - step``'s (JAX's ``ppermute`` by ``step``).  One
        ``all_to_all_single`` whose only nonzero splits are those two
        peers."""
        if self.world == 1:
            return t.clone()
        n = int(t.shape[0])
        nxt = (self.rank + step) % self.world
        prv = (self.rank - step) % self.world
        out = torch.empty_like(t)
        dist.all_to_all_single(
            out, t.contiguous(),
            output_split_sizes=[n if j == prv else 0
                                for j in range(self.world)],
            input_split_sizes=[n if j == nxt else 0
                               for j in range(self.world)],
            group=self.group)
        return out

    def close(self):
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False


def grid(ranks: Ranks, num_shards: int):
    """JAX's ``('data', 'edge')`` grid over ``ranks`` (the default group):
    ``(edge, data, num_data)``, ``edge`` this rank's edge-axis ``Ranks``
    (rank ``r % S`` of its replica's group of S ranks), ``data`` its replica
    ``r // S``.  Every rank creates every replica's group, in order, as
    ``torch.distributed.new_group`` requires; one replica uses the default
    group.  A world that is not a multiple of S raises."""
    S = num_shards
    if S < 1 or ranks.world % S:
        raise ValueError(f"a world of {ranks.world} ranks is not a multiple "
                         f"of {S} edge shards")
    nd = ranks.world // S
    data, e = divmod(ranks.rank, S)
    group = ranks.group
    if nd > 1:
        groups = [dist.new_group(list(range(d * S, (d + 1) * S)))
                  for d in range(nd)]
        group = groups[data]
    edge = dataclasses.replace(ranks, rank=e, world=S, group=group,
                               owns_group=False)
    return edge, data, nd


def halo_world(num_shards: int, device_type: str) -> int:
    """The halo pretrain's world: torchrun's ``WORLD_SIZE`` when set, else
    ``num_data * S`` ranks with ``num_data = max(cards // S, 1)`` on CUDA
    (JAX's ``max(len(devices) // S, 1)``, pretrain.py:189-199) and 1 on the
    CPU."""
    env = env_world()
    if env is not None:
        world = env["world"]
    elif device_type == "cuda":
        world = max(torch.cuda.device_count() // num_shards, 1) * num_shards
    else:
        world = num_shards
    if world % num_shards:
        raise ValueError(f"a world of {world} ranks is not a multiple of "
                         f"--halo_shards {num_shards}")
    return world


def data_world(device_type: str) -> int:
    """The data-parallel world: torchrun's ``WORLD_SIZE`` when set, else a
    rank a card on CUDA (JAX's mesh over every device) and 1 on the
    CPU."""
    env = env_world()
    if env is not None:
        return env["world"]
    return max(torch.cuda.device_count(), 1) if device_type == "cuda" else 1


def launch(fn: Callable, world: int, device_type: str, *args) -> list:
    """``fn(ranks, *args)`` on ``world`` ranks: this process as one rank of
    torchrun's world when its environment is set (a list of one result),
    else ranks spawned here (:func:`spawn`)."""
    env = env_world()
    if env is None:
        return spawn(fn, world, device_type, *args)
    if env["world"] != world:
        raise ValueError(f"{world} ranks asked for under a torchrun world of "
                         f"{env['world']}")
    check_world(env["local_world"], device_type)
    ranks = init_ranks(env["rank"], env["world"], device_type,
                       local_rank=env["local_rank"],
                       local_world=env["local_world"])
    try:
        return [fn(ranks, *args)]
    finally:
        ranks.close()


def describe_world(world: int, device_type: str) -> str:
    """The backend, the world and each local rank's device, as a run's
    first line names them."""
    env = env_world()
    local_world = world if env is None else env["local_world"]
    count = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = backend_for(device_type, local_world, count)
    devices = [("cpu" if device_type == "cpu" else f"cuda:{r % count}")
               for r in range(local_world)]
    shared = (" (ranks share a card)" if backend == "gloo"
              and device_type == "cuda" else "")
    return (f"backend {backend}{shared}, world {world}, devices "
            + ", ".join(f"rank {r} {d}" for r, d in enumerate(devices)))


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
    """One spawned rank (forked by the factory): threads shared fairly, the
    process group, ``fn(ranks, *args)`` read from the file beside the store
    once the caller has written it (after the caller's import path), its
    result pickled there (a dict result gains ``start_marks``: the host
    clock at its start, after the process group, the compiler stack's
    import and the call's read).  It ends without a call when the factory
    ends or its directory goes."""
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
            if os.getppid() != parent or not os.path.isdir(tmp):
                raise SystemExit("the process that started this rank ended")
            time.sleep(0.05)
        with open(call, "rb") as f:
            sys.path.extend(p for p in pickle.load(f) if p not in sys.path)
            fn, args = pickle.load(f)
        marks["call_read"] = time.time()
        out = fn(ranks, *args)
        if isinstance(out, dict):
            out["start_marks"] = marks
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        ranks.close()


# worlds started by :func:`prestart`, by (world, device type), oldest first
_READY = {}
_READY_LOCK = threading.Lock()


# what the factory imports before it forks a rank
_PRELOAD = ("torch._dynamo", "stemgnn_tpu_torch.parallel.full_graph",
            "stemgnn_tpu_torch.parallel.halo_pretrain",
            "stemgnn_tpu_torch.train.pretrain_loop")
# this process's factory: its process and the pipe it answers on
_FACTORY = {}
_FACTORY_LOCK = threading.Lock()


def _factory_main(answer_fd: int):
    """The rank factory (``python -m stemgnn_tpu_torch.parallel.mesh FD``):
    imports :data:`_PRELOAD`, then for each JSON line ``[tmp, rank, world,
    device_type]`` on its stdin forks a process that runs
    :func:`_rank_main` and writes the child's pid to ``FD``; when it reaps
    a child it writes the exit code to ``rank<r>.exit`` in its directory.
    Ends when its stdin closes (its caller ended).  CUDA is never
    initialised here, so every child can take a card."""
    import select
    import traceback
    import warnings
    # the children never use the BLAS pool threads that numpy started
    warnings.filterwarnings("ignore", message=".*fork", category=
                            DeprecationWarning)
    for name in _PRELOAD:
        importlib.import_module(name)
    answers = os.fdopen(answer_fd, "w", buffering=1)
    exits, pending = {}, b""

    def reap():
        while exits:
            try:
                pid, status = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                return
            if pid == 0:
                return
            path = exits.pop(pid, None)
            if path is not None:
                with contextlib.suppress(OSError):   # its directory went
                    with open(path + ".tmp", "w") as f:
                        f.write(str(os.waitstatus_to_exitcode(status)))
                    os.replace(path + ".tmp", path)
    while True:
        ready = select.select([0], [], [], 0.05)[0]
        reap()
        if not ready:
            continue
        chunk = os.read(0, 1 << 16)
        if not chunk:
            return
        *lines, pending = (pending + chunk).split(b"\n")
        for line in lines:
            tmp, rank, world, device_type = json.loads(line)
            pid = os.fork()
            if pid == 0:
                answers.close()
                os.dup2(os.open(os.devnull, os.O_RDONLY), 0)
                code = 0
                try:
                    _rank_main(tmp, rank, world, device_type)
                except SystemExit as e:
                    code = e.code if isinstance(e.code, int) else 1
                except BaseException:       # noqa: BLE001 - reported
                    traceback.print_exc()
                    code = 1
                # the result is on disk and the group closed: skip the
                # interpreter's teardown (seconds the caller would wait)
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(code)
            exits[pid] = os.path.join(tmp, f"rank{rank}.exit")
            answers.write(f"{pid}\n")


def _factory():
    """This process's rank factory, started if it is not running (call
    under ``_FACTORY_LOCK``): (process, pipe of the pids it answers)."""
    proc = _FACTORY.get("proc")
    if proc is None or proc.poll() is not None:
        r, w = os.pipe()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in sys.path if p), PYTORCH_NVML_BASED_CUDA_CHECK="1")
        proc = subprocess.Popen([sys.executable, "-m", __name__, str(w)],
                                stdin=subprocess.PIPE, pass_fds=(w,),
                                env=env)
        os.close(w)
        _FACTORY.update(proc=proc, pids=os.fdopen(r, "r"))
    return proc, _FACTORY["pids"]


def warm_up():
    """Start this process's rank factory now, so that the first
    :func:`prestart` or :func:`spawn` does not wait for its imports
    (seconds of host time, in a process of its own)."""
    with _FACTORY_LOCK:
        _factory()


class _Forked:
    """A rank process forked by the factory, with the part of
    ``subprocess.Popen``'s interface the spawn uses; its exit code is read
    from the file the factory writes when it reaps it."""

    def __init__(self, pid: int, exit_path: str):
        self.pid, self.exit_path, self.returncode = pid, exit_path, None

    def poll(self):
        if self.returncode is None:
            try:
                with open(self.exit_path) as f:
                    self.returncode = int(f.read())
            except FileNotFoundError:
                factory = _FACTORY.get("proc")
                if factory is not None and factory.poll() is not None \
                        and not _alive(self.pid):
                    self.returncode = -1        # the factory ended first
        return self.returncode

    def terminate(self):
        if self.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.kill(self.pid, signal.SIGTERM)

    def wait(self):
        while self.poll() is None:
            time.sleep(0.02)
        return self.returncode


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _start(world: int, device_type: str):
    """``world`` rank processes forked by the factory and the temporary
    directory of their store and files."""
    tmp = tempfile.TemporaryDirectory()
    with _FACTORY_LOCK:
        proc, pids = _factory()
        proc.stdin.write(b"".join(
            json.dumps([tmp.name, r, world, device_type]).encode() + b"\n"
            for r in range(world)))
        proc.stdin.flush()
        procs = []
        for r in range(world):
            line = pids.readline()
            if not line:
                raise RuntimeError("the rank factory ended (its error is "
                                   "above)")
            procs.append(_Forked(int(line), os.path.join(
                tmp.name, f"rank{r}.exit")))
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
    with _READY_LOCK:
        started = [w for queue in _READY.values() for w in queue]
        _READY.clear()
    for w in started:
        _stop(*w)


def prestart(world: int, device_type: str):
    """Start the ranks of a later :func:`spawn` of ``world`` ranks on
    ``device_type`` now: they import, join their group and import the
    compiler stack beside the caller's work, then wait for that call.
    Each call starts one world; spawns take them oldest first.  Ranks
    never called are stopped when this process exits."""
    check_world(world, device_type)
    if world > 1:
        started = _start(world, device_type)
        with _READY_LOCK:
            _READY.setdefault((world, device_type), []).append(started)


def _take_ready(world: int, device_type: str):
    """The oldest prestarted world of ``world`` ranks on ``device_type``
    (its temporary directory and processes), or None."""
    with _READY_LOCK:
        queue = _READY.get((world, device_type))
        if not queue:
            return None
        started = queue.pop(0)
        if not queue:
            del _READY[(world, device_type)]
        return started


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
    tmp, procs = (_take_ready(world, device_type)
                  or _start(world, device_type))
    failed = None
    try:
        # renamed into place whole once written; the import path first
        with open(os.path.join(tmp.name, "call.tmp"), "wb") as f:
            pickle.dump([p for p in sys.path if p], f)
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
    _factory_main(int(sys.argv[1]))
