"""Start a local world: one process per rank on this host, joined through
a file rendezvous (no network), each running one function.

PyTorch is one process per device, so a mesh fit needs a world before it
needs a mesh. `run_world(fn, world_size, ...)` spawns the ranks, has each
initialize the default process group (`init_local_group`), calls
`fn(rank, *args)` in it and returns the ranks' results in rank order.
Production clusters start their ranks with their own launcher (torchrun,
a scheduler) and call `init_process_group` themselves; the entry points
only need the group to exist.

Nothing here can outlive its deadline: every process group gets
`timeout`, so a collective one rank never joins raises instead of
hanging, and the parent ends every rank still alive when the deadline
passes or when any rank fails.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

__all__ = ["init_local_group", "run_world"]


def init_local_group(backend: str, rank: int, world_size: int,
                     rendezvous_file: str, timeout: float = 1800.0) -> None:
    """Initialize torch.distributed's default process group for rank
    `rank` of a `world_size`-rank world on this host, joined through
    `rendezvous_file` (a path every rank can reach; it must not exist
    before the first rank arrives). backend: "nccl" for a CUDA world (rank
    r takes device r), "gloo" for a CPU world. `timeout` (seconds) bounds
    every collective of the group."""
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(
        backend, init_method=f"file://{rendezvous_file}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout), **kw)


def _rank_main(rank, world_size, backend, rendezvous_file, timeout,
               threads, fn, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_local_group(backend, rank, world_size, rendezvous_file, timeout)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:   # the parent re-raises with the rank's traceback
        results.put((rank, False, traceback.format_exc()))


def run_world(fn: Callable, world_size: int, args: Sequence = (),
              backend: str = "nccl", timeout: float = 300.0,
              threads: int = 1) -> List:
    """Run `fn(rank, *args)` in `world_size` new processes that form one
    process group, and return their results in rank order.

    backend: "nccl" (the default: a world on the cards, rank r on device
    r) or "gloo" for a CPU world; a mesh must be built over the device
    type its world's backend serves (`sharding.check_backend`).

    `fn` and `args` must pickle (a module-level function; numpy arrays and
    plain containers), and so must each result. `timeout` (seconds) is
    both the process groups' collective timeout and the deadline of the
    whole world: when it passes, or a rank raises or dies, every rank is
    ended and RuntimeError carries what is known. `threads` is each
    rank's intra-op thread count (ranks share this host's cores)."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, world_size, backend, rendezvous, timeout, threads, fn,
                  tuple(args), results)) for r in range(world_size)]
        for pr in procs:
            pr.start()
        out: dict = {}
        failure = None
        try:
            while len(out) < world_size and failure is None:
                try:
                    rank, ok, val = results.get(timeout=0.2)
                except queue.Empty:   # nothing yet: look at the clock
                    if time.monotonic() > deadline:
                        failure = (f"the {world_size}-rank world did not "
                                   f"finish within {timeout:g} s")
                    elif any(pr.exitcode not in (None, 0) for pr in procs):
                        # a rank that died without a word; give the queue
                        # one more look for its last message first
                        if results.empty():
                            failure = "a rank died: exit codes " + str(
                                [pr.exitcode for pr in procs])
                    continue
                if ok:
                    out[rank] = val
                else:
                    failure = f"rank {rank} raised:\n{val}"
        finally:
            for pr in procs:
                pr.join(timeout=0 if failure else 10)
                if pr.is_alive():
                    pr.kill()
                    pr.join()
        if failure is not None:
            raise RuntimeError(failure)
    return [out[r] for r in range(world_size)]
