"""Start R ranks in processes of this machine, for the walker mesh.

``run_ranks(fn, nranks)`` spawns ``nranks`` processes
(``torch.multiprocessing``, "spawn"), starts a process group in each over
``tcp://127.0.0.1:<free port>`` (gloo by default: the CPU, or two ranks
sharing one card; NCCL wants one card a rank), calls ``fn(rank, *args)``
there and returns the ranks' results in rank order. A rank that raises,
hangs past ``timeout`` seconds or dies fails the call, and every process
it started is ended. On a cluster, start the ranks with ``torchrun``
instead; the mesh needs only ``init_process_group``.

    from pauxy_tpu_torch.parallel import launch
    rows = launch.run_ranks(my_module.run_rank, 4)   # fn importable by name
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import socket
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank, nranks, port, backend, timeout, threads, fn, args, out):
    try:
        torch.set_num_threads(threads)
        os.environ.setdefault("LOCAL_RANK", str(rank))
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=nranks, timeout=datetime.timedelta(seconds=timeout))
        try:
            res = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        # By value: a tensor sent as such would be shared through a file
        # descriptor that dies with this process.
        out.put((rank, True, pickle.dumps(res)))
    except Exception:                          # reported to the parent
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, nranks: int, *args, backend: str = "gloo",
              timeout: float = 120.0, threads: int = 1):
    """``[fn(0, *args), ..., fn(nranks - 1, *args)]``, each in a process of
    its own inside one process group. ``fn`` and ``args`` must pickle
    (``fn`` a module-level function); so must the results."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child,
                         args=(r, nranks, port, backend, timeout, threads,
                               fn, args, out), daemon=True)
             for r in range(nranks)]
    for p in procs:
        p.start()
    results = {}
    try:
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=timeout)
        while len(results) < nranks:
            left = (deadline - datetime.datetime.now()).total_seconds()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(nranks)) - set(results))} "
                    f"gave no result within {timeout} s")
            try:
                rank, ok, res = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive()
                        and p.exitcode not in (0, None)]
                if dead:
                    raise RuntimeError(
                        f"ranks {dead} died (exit codes "
                        f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{res}")
            results[rank] = pickle.loads(res)
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(nranks)]
