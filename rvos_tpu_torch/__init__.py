"""rvos_tpu_torch — the PyTorch/CUDA port of ``rvos_tpu``'s streaming
evaluator (single-scale RPA inference of one video), for NVIDIA Hopper.

The JAX package ``rvos_tpu`` is the reference each module is held
against; this package imports ``torch`` and numpy and nothing of JAX or
of ``rvos_tpu``.  Hand-written CUDA kernels (``csrc/``) carry the global
and local matching streams; every kernel has a plain PyTorch version
beside it, used for CPU tensors and as the reference on the card.
"""

__version__ = "0.1.0"
