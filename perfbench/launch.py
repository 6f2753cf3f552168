"""The launcher of a cell that asks for more than one chip: one process a
rank, a card a rank, joined by ``torch.distributed`` over
``tcp://localhost`` (NCCL on the cards, gloo on the CPU).

Each rank runs ``target(rank, world, *args)`` inside its process group and
sends back what it returns; :func:`spawn` waits for every rank, stops any
that outlive ``timeout``, and returns the ranks' results in rank order. A
rank that has loaded JAX or the JAX package by then
(`perfbench/run.py:forbidden_modules`) fails, as a rank that raises does.
No cell runs over ranks yet: a driver that does calls :func:`spawn`.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import traceback


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, target, args, out):
    import torch
    import torch.distributed as dist
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        try:
            value = target(rank, world, *args)
        finally:
            dist.destroy_process_group()
        from perfbench.run import forbidden_modules
        bad = forbidden_modules()
        out.put((rank, True, value) if not bad else (
            rank, False, f"modules loaded that a run must not load: {bad}"))
    except Exception:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def spawn(world: int, target, args=(), backend: str = "nccl",
          timeout: float = 300.0) -> list:
    """Run ``target(rank, world, *args)`` in ``world`` new processes and
    return their results by rank; raise if a rank fails or does not
    finish within ``timeout`` seconds. ``target`` must be importable by
    name (the processes are spawned, not forked)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, backend, target, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            rank, ok, value = out.get(timeout=timeout)
            (results.__setitem__(rank, value) if ok
             else errors.append(f"rank {rank}:\n{value}"))
    except queue.Empty:
        errors.append(f"a rank did not finish within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world)]
