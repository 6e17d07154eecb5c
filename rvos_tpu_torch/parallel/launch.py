"""Start the processes of a run on one host: the reference's ``mp.spawn``
over a local TCP rendezvous (``tools/train_net_mm.py:72``); the JAX
package takes ``min(MESH_DATA_AXIS, devices)`` devices into one process
instead (``rvos_tpu/engine/train.py:293``).

    results = launch(fn, world=2, backend="gloo", devices=["cpu"] * 2,
                     args=(cfg,))

runs ``fn(rank, world, device, *args)`` in ``world`` spawned processes,
rank ``r`` on ``devices[r]``, joined into one process group, and returns
their return values in rank order (moved to the CPU).  ``fn`` must be
importable by name from this package, so that a child imports nothing
else.  The rendezvous is a ``TCPStore`` the parent serves on a port the
OS picks, so that concurrent launches never collide.  NCCL puts no two
processes on one card; two ranks on one card run over gloo, which
reduces CUDA tensors through the host.  A child that fails, or a run
that outlasts ``timeout`` seconds, raises here after every child is
stopped: a run never goes on with fewer processes than it asked for.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .distributed import TIMEOUT

HOST = "127.0.0.1"


def _cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def _child(rank: int, fn: Callable, world: int, backend: str, port: int,
           devices: Sequence[str], out_dir: str, threads: int):
    torch.set_num_threads(threads)
    args = torch.load(os.path.join(out_dir, "args.pt"), weights_only=False)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.TCPStore(HOST, port, is_master=False, timeout=TIMEOUT)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        result = fn(rank, world, device, *args)
        torch.save(_cpu(result), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, backend: str, devices: Sequence,
           args: tuple = (), timeout: Optional[float] = 600.0,
           threads: int = 1) -> List:
    """Run ``fn`` on ``world`` ranks (see the module's docstring);
    ``threads`` torch threads each; ``timeout`` None waits for ever."""
    devices = [torch.device(d) for d in devices]
    devices = [str(torch.device("cuda", 0) if d.type == "cuda"
                   and d.index is None else d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{world} ranks need {world} devices, got {devices}")
    if backend == "nccl" and len(set(devices)) != world:
        raise ValueError(f"NCCL puts no two ranks on one card: {devices}")
    store = dist.TCPStore(HOST, 0, is_master=True, wait_for_workers=False,
                          timeout=TIMEOUT)
    with tempfile.TemporaryDirectory() as out_dir:
        # the arguments go through a file: pickled into each child's
        # start-up pipe, megabytes of them held the parent until that
        # child had imported torch, so the children started one by one
        torch.save(args, os.path.join(out_dir, "args.pt"))
        ctx = mp.start_processes(
            _child, args=(fn, world, backend, store.port, devices, out_dir,
                          threads),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=None if deadline is None else
                               max(1.0, deadline - time.monotonic())):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} ran "
                                       f"past {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
