"""Meshes of ``torch.distributed`` ranks, and a launcher that starts them.

``make_debug_mesh`` names the dims of an initialized process group
(``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``).
``run_ranks(fn, n, args)`` starts ``n`` ranks of ``fn(mesh, *args)`` as
processes of the ``spawn`` start method (a parent that has initialized
CUDA cannot fork them), joined by a ``file://`` rendezvous in a temporary
directory (parallel test workers never race for a TCP port), and returns
every rank's result, rank 0 first.

The backend (``backend_for``), printed by every rank:

  * ``gloo`` on the CPU, and where the ranks share one card (a machine with
    fewer cards than ranks);
  * ``nccl`` only where each rank has a card of its own (rank r on card r).
    That branch has not run yet: no machine it was tried on had a card per
    rank.

The production mesh of the compile dry run comes with it (ROADMAP item 5c).
"""
from __future__ import annotations

import datetime
import math
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# How long a rank waits in a collective before it fails: longer than any
# step of a full-width serve, far shorter than gloo's 30 minutes.
COLLECTIVE_TIMEOUT_S = 600


def backend_for(device_type: str, world: int) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def make_debug_mesh(shape=(2,), axes=("model",), device_type: str = "cpu"):
    """A ``DeviceMesh`` over the initialized default process group, its
    ranks laid out row-major in ``shape``, its dims named ``axes``."""
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def _rank_main(fn, rank: int, n: int, axis: str, device_type: str,
               init_method: str, results, args) -> None:
    backend = backend_for(device_type, n)
    if device_type == "cuda":
        torch.cuda.set_device(rank if backend == "nccl" else 0)
    dev = (f"cuda:{torch.cuda.current_device()}" if device_type == "cuda"
           else "cpu")
    print(f"[mesh] rank {rank} of {n}: backend {backend} on {dev}",
          flush=True)
    dist.init_process_group(
        backend, init_method=init_method, world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        mesh = make_debug_mesh((n,), (axis,), device_type)
        results.put((rank, True, fn(mesh, *args)))
    except Exception:           # reported to the parent, which fails
        results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n: int, args: tuple = (), *, axis: str = "model",
              device_type: str = "cpu", timeout: float = 1200.0) -> list:
    """Run ``fn(mesh, *args)`` on ``n`` spawned ranks of a 1-D mesh whose
    dim is named ``axis`` and return their results in rank order.  ``fn``
    and ``args`` are pickled: ``fn`` a module-level function of a module
    the ranks can import.  A rank that raises, exits without a result or
    outlives ``timeout`` fails the call (its traceback in the error), and
    the other ranks are stopped."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n, axis, device_type,
                                   f"file://{tmp}/rendezvous", results,
                                   args))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = True
        try:
            while len(out) < n:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    lost = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if lost:
                        raise RuntimeError(f"rank {lost[0][0]} exited with "
                                           f"code {lost[0][1]} and no result")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{n} ranks ran past {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
            failed = False
        finally:
            for p in procs:
                p.join(timeout=0 if failed else 60)
                if p.is_alive():
                    p.terminate()
                    p.join()
    return [out[r] for r in range(n)]
