"""Several processes: joining a run, the batch slice of each process,
and the collectives of data-parallel training (PyTorch port of
``rvos_tpu/parallel/distributed.py``).

The reference trains one process per GPU with a TCP rendezvous
(``tools/train_net_mm.py:72`` ``mp.spawn``, DDP in
``networks/engine/train_manager_mm.py:47-57``).  The JAX package runs
one process per host and lets XLA all-reduce the gradients of a global
array.  Here, as in the reference, every process drives its own card
(or the CPU, over gloo) and holds only its slice of each global batch;
``reduce_mean_`` stands in for XLA's implicit gradient all-reduce.

* ``maybe_initialize`` joins a run launched outside (``RVOS_MULTIHOST``),
  with the JAX package's variables; ``parallel.launch`` starts the
  processes of one host itself.
* ``process_batch_slice`` gives each process its contiguous share of a
  global batch.  ``make_global_batch`` has no counterpart: no process
  ever holds the global batch; each keeps its slice and the gradient
  reduce plays the part of the global array.
* ``reduce_mean_`` and ``broadcast_`` move a list of tensors in a few
  flat buffers, one collective each, not one per tensor (a ResNet-101
  AOC-Net has several hundred parameter tensors).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# elements of one flat buffer of ``reduce_mean_`` / ``broadcast_``
BUCKET_ELEMENTS = 1 << 25
TIMEOUT = datetime.timedelta(minutes=10)


def _on(env: Dict[str, str]) -> bool:
    return env.get("RVOS_MULTIHOST", "0").lower() in ("1", "true", "yes")


def process_devices(env: Optional[Dict[str, str]] = None,
                  device: str = "cuda") -> List[torch.device]:
    """This process's devices: the cards of ``RVOS_LOCAL_DEVICE_IDS``
    ("0,1"), else card ``rank % count`` in a multi-process run, else
    every visible card; ``[cpu]`` for ``device="cpu"``."""
    env = os.environ if env is None else env
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    if env.get("RVOS_LOCAL_DEVICE_IDS"):
        return [torch.device("cuda", int(i))
                for i in env["RVOS_LOCAL_DEVICE_IDS"].split(",")]
    n = torch.cuda.device_count()
    if _on(env) and n:
        return [torch.device("cuda", int(env["RVOS_PROCESS_ID"]) % n)]
    return [torch.device("cuda", i) for i in range(n)]


def maybe_initialize(env: Optional[Dict[str, str]] = None,
                     device: str = "cuda") -> bool:
    """Join the run when ``RVOS_MULTIHOST=1``: a TCP rendezvous at
    ``RVOS_COORDINATOR`` (host:port) of ``RVOS_NUM_PROCESSES`` processes,
    this one ``RVOS_PROCESS_ID``; NCCL on the cards (each process on its
    first card of ``process_devices``), gloo for ``device="cpu"``.
    Returns True when it joined.  Unlike a TPU pod, nothing here
    discovers the layout: the three variables are required."""
    env = os.environ if env is None else env
    if not _on(env):
        return False
    missing = [k for k in ("RVOS_COORDINATOR", "RVOS_NUM_PROCESSES",
                           "RVOS_PROCESS_ID") if not env.get(k)]
    if missing:
        raise ValueError(f"RVOS_MULTIHOST=1 needs {', '.join(missing)}")
    cpu = torch.device(device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(process_devices(env, device)[0])
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://{env['RVOS_COORDINATOR']}",
                            world_size=int(env["RVOS_NUM_PROCESSES"]),
                            rank=int(env["RVOS_PROCESS_ID"]), timeout=TIMEOUT)
    return True


def rank() -> int:
    """This process's index in the run (0 outside one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The run's process count (1 outside one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes logs, images and checkpoints."""
    return rank() == 0


def process_batch_slice(global_batch: int,
                        process_index: Optional[int] = None,
                        process_count: Optional[int] = None
                        ) -> Tuple[int, int]:
    """(start, size) of this process's contiguous slice of a global
    batch, which must divide evenly: every process runs the same shapes,
    and the mean over processes of equal slices' means is the global
    batch's mean."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    if global_batch % pc:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{pc} processes")
    local = global_batch // pc
    return pi * local, local


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Consecutive tensors of one dtype and device, at most
    ``BUCKET_ELEMENTS`` a bucket (a larger tensor alone)."""
    out: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        last = out[-1] if out else None
        if (last is None or last[0].dtype != t.dtype
                or last[0].device != t.device
                or size + t.numel() > BUCKET_ELEMENTS):
            out.append([t])
            size = t.numel()
        else:
            last.append(t)
            size += t.numel()
    return out


@torch.no_grad()
def _flat_collective(tensors: Sequence[torch.Tensor], op) -> int:
    """``op(flat)`` on each bucket's flattened copy, written back into
    the tensors in place; returns the bytes moved per process."""
    n_bytes = 0
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        op(flat)
        n_bytes += flat.numel() * flat.element_size()
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))
    return n_bytes


def reduce_mean_(tensors: Sequence[torch.Tensor]) -> int:
    """Every process's tensors become their mean over the processes (a
    sum, then a division by the world size), in place.  Returns the bytes
    each process reduced.  In a run of one process the collective still
    runs (an identity); outside a run nothing does."""
    if not dist.is_initialized():
        return 0
    world = world_size()

    def op(flat):
        dist.all_reduce(flat)
        flat.div_(world)

    return _flat_collective(tensors, op)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> int:
    """Every process's tensors become process ``src``'s, in place."""
    if not dist.is_initialized():
        return 0
    return _flat_collective(tensors, lambda flat: dist.broadcast(flat, src))


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()
