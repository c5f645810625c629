"""Process groups: the port's counterpart of the reference's device mesh.

Port of `dynamic3dgaussians_tpu/parallel/mesh.py`. A JAX mesh axis is a
`torch.distributed` process group here: one process per rank, each with
its own device, data moved only by explicit collectives. `init_group`
joins the world group from inside a rank, and `spawn` runs a function in
`world_size` fresh processes, each already in the world group, and returns
what each rank returned. Inside a rank, the group's size and the rank's
index are `collectives.axis_size` and `collectives.axis_index`.

    def work(rank, world_size):
        ...                                  # per-rank code, collectives
        return result                        # picklable
    results = spawn(work, 4, "gloo")         # [rank 0's, ..., rank 3's]

CUDA cannot be used after `fork`, so the processes start with the `spawn`
method and import `fn`'s module afresh. The group meets through a file in
a fresh temporary directory (no TCP port to collide on), and every
collective gives up after `GROUP_TIMEOUT_S`, so a rank that dies never
leaves the others blocked for longer.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 60.0


def init_group(backend: str, rank: int, world_size: int, init_method: str,
               timeout: float = GROUP_TIMEOUT_S):
    """Join the world group as `rank` of `world_size`; collectives that wait
    longer than `timeout` seconds raise. Returns the world group."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    return dist.group.WORLD


def destroy() -> None:
    """Leave the world group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _run_rank(fn, rank, world_size, backend, init_method, out_dir, args):
    """A spawned rank: join the group, run fn, leave its result (or its
    traceback) in out_dir; a failure exits non-zero."""
    path = os.path.join(out_dir, f"rank{rank}")
    # every spawned rank is on this host: gloo meets on the loopback
    # interface instead of looking the host name up
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        init_group(backend, rank, world_size, init_method)
        result = fn(rank, world_size, *args)
        torch.save(result, path + ".tmp")
        os.replace(path + ".tmp", path + ".pt")
    except BaseException:
        with open(path + ".err", "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        destroy()


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5.0)
        if p.is_alive():
            p.kill()
            p.join()


def spawn(fn: Callable[..., Any], world_size: int, backend: str = "gloo", *,
          timeout_s: float = 120.0, args: Sequence = ()) -> List[Any]:
    """Run `fn(rank, world_size, *args)` in `world_size` new processes, each
    in a fresh world group of `backend`, and return their results by rank.

    `fn` must be importable by name (a module-level function) and return
    something `torch.save` can write. Raises RuntimeError with the rank's
    traceback as soon as any rank fails (the others are stopped), and
    TimeoutError when the ranks have not all finished within `timeout_s`.
    """
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="d3g_group_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_run_rank, daemon=True,
                             args=(fn, r, world_size, backend, init_method,
                                   tmp, tuple(args)))
                 for r in range(world_size)]
        failed = False
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout_s
            pending = set(procs)
            while pending and not failed:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(procs.index(p) for p in pending)} "
                        f"of {world_size} did not finish within "
                        f"{timeout_s} s")
                multiprocessing.connection.wait(
                    [p.sentinel for p in pending], timeout=left)
                done = {p for p in pending if p.exitcode is not None}
                pending -= done
                failed = any(p.exitcode != 0 for p in done)
        finally:
            _stop(procs)
        if failed:
            # a rank whose peer died may fail as well: report every rank
            # that raised, with its traceback
            raise RuntimeError("\n".join(
                f"rank {r} of {world_size} failed (exit code {p.exitcode}):"
                f"\n{_read(tmp, r)}" for r, p in enumerate(procs)
                if p.exitcode != 0 and (p.exitcode > 0 or os.path.exists(
                    os.path.join(tmp, f"rank{r}.err")))))
        # written by this function's own ranks just now
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]


def _read(tmp: str, r: int) -> str:
    try:
        with open(os.path.join(tmp, f"rank{r}.err")) as fh:
            return fh.read()
    except FileNotFoundError:
        return "(no traceback: the process was killed)"
