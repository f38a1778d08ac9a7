"""Process groups, hybrid meshes and a local launcher (counterpart of
iterative_solvers_tpu/parallel/multihost.py).

- :func:`initialize_distributed` joins the default ``torch.distributed``
  process group, from explicit arguments or the usual environment
  (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``); a no-op when
  already joined or when nothing asks for more than one process.
- :func:`make_hybrid_mesh` builds the 3-axis ``('slice', 'y', 'x')`` mesh,
  slice axis outermost: rows split over ``('slice', 'y')`` combined.
- :func:`run_world` runs a function on N local ranks (``torch.multiprocessing``
  spawn, ``gloo``, one thread each) and returns each rank's result: the port's
  counterpart of the JAX package's virtual 8-device CPU mesh, used by the
  tests and by ``chip_smoke.py``. It has a deadline: a rank that hangs or
  dies ends the whole world, and the call raises.
"""

from __future__ import annotations

import os
import queue
import socket
import sys
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from iterative_solvers_tpu_torch.parallel.mesh import (
    SolverMesh,
    _mesh_over,
    _near_square_factors,
)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join (or skip joining) a multi-process run.

    ``coordinator_address`` is ``host:port`` (default ``MASTER_ADDR`` and
    ``MASTER_PORT``), ``num_processes`` the world size (``WORLD_SIZE``),
    ``process_id`` this rank (``RANK``). The ranks of this node are
    ``LOCAL_RANK`` of ``LOCAL_WORLD_SIZE`` (as ``torchrun`` sets them; on a
    single node without them, the global rank and world size).
    ``backend`` defaults to ``nccl`` when every local rank can have a card of
    its own (each takes card ``LOCAL_RANK``) and to ``gloo`` otherwise:
    NCCL refuses two ranks on one card, and then the halos go through host
    memory. ``nccl`` with more local ranks than cards raises."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None or not num_processes or num_processes < 2:
        return  # a single-process run
    local_rank = int(env.get("LOCAL_RANK", process_id))
    local_size = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is None:
        backend = "nccl" if cards >= local_size else "gloo"
    if backend == "nccl":
        if local_size > cards:
            raise ValueError(f"backend 'nccl' needs a card per local rank: {local_size} "
                             f"local ranks, {cards} cards (use backend='gloo')")
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def make_hybrid_mesh(n_slices: Optional[int] = None,
                     ici_shape: Optional[Tuple[int, int]] = None,
                     axis_names: Tuple[str, str, str] = ("slice", "y", "x")) -> SolverMesh:
    """A ``(slice, y, x)`` mesh over the ranks of the default process group,
    slice axis outermost (each slice owns a contiguous band of rows).
    ``n_slices`` splits the ranks into even slices (default 1);
    ``ici_shape`` defaults to a near-square factorisation of each slice."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_slices = n_slices or 1
    if world % n_slices:
        raise ValueError(f"{world} devices do not split into {n_slices} slices")
    per = world // n_slices
    ici_shape = ici_shape or _near_square_factors(per)
    if ici_shape[0] * ici_shape[1] != per:
        raise ValueError(f"ici_shape {ici_shape} != {per} devices per slice")
    return _mesh_over(world, (n_slices,) + tuple(ici_shape), axis_names)


_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, port: int, path: List[str], fn: Callable, args: tuple,
               results) -> None:
    sys.path[:] = path  # the repo, whatever the caller's environment
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=n, rank=rank)
        out = fn(rank, *args)
        dist.barrier()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn: Callable, n_ranks: int, args: Sequence = (), *,
              timeout: float = 300.0) -> List[object]:
    """Run ``fn(rank, *args)`` on ``n_ranks`` local processes joined in one
    ``gloo`` group (CPU tensors; CUDA blocks are staged through host
    memory) and return their results, by rank. The ranks share the host's
    cores: each runs one thread.

    ``fn`` and ``args`` must pickle (a module-level function), and so must
    the results: plain Python values and numpy arrays (a torch tensor would
    cross by shared memory that its rank frees on exit). The children
    get this process's ``sys.path``, so they find the repository whatever
    their environment. If any rank raises, dies or is still running after
    ``timeout`` seconds, every rank is killed and this raises."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [
        ctx.Process(target=_rank_main, daemon=True,
                    args=(r, n_ranks, port, list(sys.path), fn, tuple(args), results))
        for r in range(n_ranks)
    ]
    # one BLAS and OpenMP thread per rank (the children read these at start-up)
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update({k: "1" for k in _THREAD_VARS})
    try:
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    deadline = time.monotonic() + timeout
    got = {}
    failure = None
    try:
        while len(got) < n_ranks and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = f"world of {n_ranks} ranks timed out after {timeout:.0f} s " \
                          f"(ranks {sorted(set(range(n_ranks)) - set(got))} did not finish)"
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:  # check that every rank is alive
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                if dead:
                    failure = f"rank(s) {dead} exited without a result"
                continue
            if ok:
                got[rank] = out
            else:
                failure = f"rank {rank} raised:\n{out}"
    finally:
        for p in procs:
            p.join(timeout=5 if failure is None else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [got[r] for r in range(n_ranks)]

