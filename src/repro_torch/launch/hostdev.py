"""N local ranks: the port's way to get N "devices" on one host.

The reference forces N virtual XLA host devices before JAX starts
(`repro/launch/hostdev.py`, ``force_host_device_count``). torch.distributed
has no virtual devices; a mesh of N is N processes. `spawn_local` plays
that role: it starts N processes with the ``spawn`` start method, joins
them in one process group over a ``file://`` rendezvous in a fresh
temporary directory (never a fixed TCP port, so concurrent runs on one
host do not collide), runs ``fn(*args)`` on every rank and returns the
ranks' results in rank order.

Each rank sets ``torch.set_num_threads(1)`` before ``fn``, so N ranks do
not oversubscribe the host's cores. ``fn`` must be importable by a fresh
interpreter (a module-level function). A rank's exception makes the call
raise, with that rank's traceback (and those of any rank that failed
within a second of it, since a rank's failure can break its peers'
collectives); the other ranks are terminated, since they may be waiting in
a collective that will never complete.

With ``backend="gloo"`` (the default) collectives move host tensors, so
ranks that share one GPU exchange host copies; NCCL needs a GPU a rank.
"""
from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List


def _rank_main(rank: int, world: int, init: str, backend: str,
               fn: Callable, args: tuple, results) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank)
        results.put((rank, True, fn(*args)))
    except Exception:                 # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_local(n: int, fn: Callable, *args, backend: str = "gloo",
                timeout: float = 600.0) -> List[Any]:
    """Run ``fn(*args)`` on ``n`` local ranks of one process group; returns
    [rank 0's result, ..., rank n-1's]. Raises RuntimeError with the failing
    ranks' tracebacks, or when the ranks do not finish within ``timeout``
    seconds."""
    import multiprocessing as mp
    if n < 1:
        raise ValueError(f"spawn_local needs n >= 1 ranks, got {n}")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro-torch-ranks-")
    init = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, init, backend, fn, args, results),
                         daemon=True) for r in range(n)]
    out: dict = {}
    failed: dict = {}
    failure = None
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        grace = None                # collect the failures of one second
        while len(out) + len(failed) < n:
            now = time.monotonic()
            if grace is not None and now > grace:
                break
            try:
                rank, ok, payload = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out
                        and r not in failed and p.exitcode not in (None, 0)]
                for r in dead:
                    failed[r] = (f"exited with code {procs[r].exitcode} and "
                                 "no result")
                if not failed and now > deadline:
                    failure = (f"ranks {sorted(set(range(n)) - set(out))} "
                               f"did not finish within {timeout} s")
                    break
                if failed and grace is None:
                    grace = now + 1.0
                continue
            if ok:
                out[rank] = payload
            else:
                failed[rank] = f"raised:\n{payload}"
                if grace is None:
                    grace = time.monotonic() + 1.0
        if failed:
            failure = "\n".join(f"rank {r} {msg}"
                                 for r, msg in sorted(failed.items()))
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"spawn_local({n}, {getattr(fn, '__name__', fn)}):"
                           f" {failure}")
    return [out[r] for r in range(n)]
