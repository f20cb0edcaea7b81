"""Run a function on N ranks of one machine: N spawned processes joined
into one process group.

    results = run_ranks(fn, 4, args=(...,), backend="gloo")

Each rank is a fresh interpreter (torch.multiprocessing's "spawn" start,
so a rank may use the card), joins the group through a file in a
temporary directory (no port to collide with other runs), pins torch to
one thread, calls fn(rank, world, *args), leaves the group and
sends fn's return value back. `run_ranks` returns the values in rank
order and raises, with the rank's traceback, if any rank fails or the
time runs out; it leaves no process behind. fn must be importable by name
(a module-level function). Several ranks may share one card with the Gloo
backend; NCCL takes one card per rank.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback

import torch.multiprocessing as mp


def _rank_main(fn, rank: int, world: int, init: str, backend: str, args: tuple, out) -> None:
    import torch
    import torch.distributed as dist

    from .distributed import initialize_process

    try:
        torch.set_num_threads(1)  # the ranks share the host's cores
        os.environ.setdefault("LOCAL_WORLD_SIZE", str(world))
        initialize_process(init, world, rank, backend=backend)
        result = fn(rank, world, *args)
        dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # the parent raises with this traceback
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, args: tuple = (), backend: str = "gloo", timeout: float = 600.0) -> list:
    """fn(rank, world, *args) on `world` spawned ranks; their return values
    in rank order."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    results, failed = {}, None
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, f"file://{d}/init", backend, args, out),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world and failed is None:
                try:
                    rank, ok, value = out.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in results]
                    if dead:
                        failed = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} and no result"
                    elif time.monotonic() > deadline:
                        failed = f"no result from ranks {sorted(set(range(world)) - set(results))} in {timeout} s"
                    continue
                if ok:
                    results[rank] = value
                else:
                    failed = f"rank {rank} failed:\n{value}"
        finally:
            for p in procs:
                p.join(timeout=10.0 if failed is None else 0.1)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failed is not None:
        raise RuntimeError(failed)
    return [results[r] for r in range(world)]
