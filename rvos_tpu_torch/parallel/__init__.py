"""Several devices and processes (PyTorch port of ``rvos_tpu/parallel``):
device meshes as lists (``mesh``), process groups and collectives
(``distributed``), the launch of one host's processes (``launch``) and
context-parallel global matching (``context``)."""

from .context import (global_matching_bank_sharded,
                      global_matching_context_parallel)
from .mesh import cp_mesh, local_devices, make_mesh, resolved_cp_devices

__all__ = ["cp_mesh", "global_matching_bank_sharded",
           "global_matching_context_parallel", "local_devices", "make_mesh",
           "resolved_cp_devices"]
