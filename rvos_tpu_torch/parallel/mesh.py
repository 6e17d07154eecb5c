"""Device lists for data- and context-parallel runs (PyTorch port of
``rvos_tpu/parallel/mesh.py``).

The JAX package declares a ``jax.sharding.Mesh`` with a ``data`` and a
``model`` axis and lets XLA place the work.  Here a mesh is a list of
rows of ``torch.device``s: ``mesh[d][m]`` is the device of data row
``d`` and model column ``m``.  Data parallelism runs one process per data
row (``parallel.distributed``, ``parallel.launch``); context parallelism
splits the query rows of global, cluster and proxy matching over one
row's devices (``ops.matching.shard_rows``).  A list may repeat a device
(``[cpu] * 4``, ``[cuda:0] * 2``): every shard then runs on it, which is
how the CPU tests and a one-card machine drive the sharded code.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..configs import Config

Mesh = List[List[torch.device]]


def local_devices(device=None) -> List[torch.device]:
    """Every visible card (``device`` first when it is one of them), or
    ``[cpu]`` when ``device`` is the CPU or no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu" or not torch.cuda.is_available():
        return [torch.device("cpu")]
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    first = torch.device("cuda", torch.cuda.current_device()
                         if dev.index is None else dev.index)
    return [first] + [d for d in cards if d != first]


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """``data`` rows of ``model`` devices from ``devices`` in order
    (default every visible card; ``data`` as many rows as fit)."""
    devices = [torch.device(d) for d in
               (local_devices() if devices is None else devices)]
    n = len(devices)
    if data is None:
        data = n // model
    if data < 1 or data * model > n:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} "
                         f"devices, got {n}")
    return [devices[d * model:(d + 1) * model] for d in range(data)]


def cp_mesh(cfg: Config, devices: Optional[Sequence] = None
            ) -> Optional[Mesh]:
    """The (data, model) mesh of context-parallel matching, or None:
    when ``MESH_MODEL_AXIS <= 1``, or when there are fewer devices than
    ``MESH_MODEL_AXIS`` (the unsharded path then runs, as in the JAX
    package)."""
    if cfg.MESH_MODEL_AXIS <= 1:
        return None
    devices = local_devices() if devices is None else list(devices)
    model = cfg.MESH_MODEL_AXIS
    if len(devices) < model:
        return None
    data = max(1, min(cfg.MESH_DATA_AXIS, len(devices) // model))
    return make_mesh(data=data, model=model, devices=devices)


def resolved_cp_devices(cfg: Config, devices: Optional[Sequence] = None
                        ) -> Optional[List[torch.device]]:
    """The devices one process splits its matching rows over (the model
    axis of ``cp_mesh``'s first row), or None for the unsharded path —
    the JAX package's ``resolved_cp_axis``, which gates on the resolved
    mesh rather than the config, so that a mesh degraded for want of
    devices degrades the matching with it."""
    mesh = cp_mesh(cfg, devices)
    return None if mesh is None else mesh[0]
