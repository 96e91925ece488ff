"""Start one process per rank on this machine and join them with a timeout.

    results = run_ranks(fn, world=4, args=(...), backend="gloo", timeout=300)

Each rank is a fresh interpreter (multiprocessing "spawn": CUDA cannot be
forked) that joins a `torch.distributed` group of `world` ranks at
tcp://localhost:<a free port>, calls fn(rank, *args) and returns what fn
returned to the caller (pickled to bytes: a tensor is copied, not
shared), in rank order. A rank that raises, dies
or outlasts `timeout` seconds stops every rank and raises here: nothing
is retried. fn must be importable by name (a module-level function).
"""
from __future__ import annotations

import multiprocessing as mp
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Sequence


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, backend, port, args, out, timeout):
    import datetime

    import torch
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        try:
            res = fn(rank, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        out.put((rank, True, pickle.dumps(res)))
    except BaseException:                      # noqa: BLE001 - reported
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable[..., Any], world: int, args: Sequence = (),
              backend: str = "gloo", timeout: float = 600.0) -> List[Any]:
    """fn(rank, *args) in `world` spawned ranks; their results by rank."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, port, tuple(args), out,
                               timeout), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, res = out.get(timeout=1.0)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {procs.index(dead[0])} died "
                                       f"with exit code {dead[0].exitcode}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks not done within "
                                       f"{timeout:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{res}")
            results[rank] = pickle.loads(res)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        out.close()

