"""A small launcher of torch.distributed worlds on one host.

`spawn(fn, world, backend, init_file, timeout)` starts `world` processes
(start method "spawn"), each of which joins a process group of the named
backend through the file store `init_file` (`file://`, so no port is
fixed and worlds run side by side), runs `fn(rank, world, *args)` with one
torch thread and returns its picklable result. The parent gets the results
in rank order. A rank's exception is raised again in the parent with the
rank and its traceback; a world that runs past `timeout` seconds is
killed and raises, naming the ranks still running. The backend is always
the caller's: `nccl` when each rank owns a card, `gloo` on the CPU or for
ranks that share one card.

This is the port's counterpart of the JAX tests' 8-device virtual mesh:
every rank is one process, and its collectives are real.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import time
import traceback
from pathlib import Path
from typing import Callable, Sequence


def _entry(fn, rank: int, world: int, backend: str, init_file: str,
           timeout: float, args: Sequence, out) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, pickle.dumps(result), None))
    except BaseException:  # noqa: BLE001 - handed to the parent
        out.put((rank, None, traceback.format_exc()))


def spawn(fn: Callable, world: int, backend: str, init_file,
          timeout: float = 120.0, args: Sequence = ()) -> list:
    """Run fn(rank, world, *args) in `world` processes over `backend`;
    returns the ranks' results in rank order. `init_file` must not exist
    yet (a fresh store); `fn` and `args` must be picklable."""
    import torch.multiprocessing as mp

    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', not {backend!r}")
    init_file = str(Path(init_file).resolve())
    if os.path.exists(init_file):
        raise FileExistsError(f"{init_file}: a world needs a fresh store")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, backend, init_file, timeout,
                               tuple(args), out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                running = sorted(set(range(world)) - set(results))
                raise TimeoutError(
                    f"a world of {world} ranks ({backend}) did not finish in "
                    f"{timeout:.0f} s; ranks {running} still running")
            try:
                rank, payload, err = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {world} exited with code "
                        f"{procs[dead[0]].exitcode} before returning")
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{err}")
            results[rank] = pickle.loads(payload)
    finally:
        for p in procs:
            p.join(timeout=10 if len(results) == world else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
    return [results[r] for r in range(world)]
