"""Host side of the streaming evaluator's pipeline (PyTorch port of
``rvos_tpu/engine/eval_pipeline.py``): the MEM_EVERY-aligned frame
``Chunker``, the batched device-to-host copies (``D2HBatcher``) and the
mask writer thread (``MaskSaver``).

* Chunks cut at the chunk size, right after a memory-update frame, and
  on any change of the context a chunk holds fixed (shape signature,
  original size, ``obj_valid``, ``exist_mask``), so the bank appends on
  the same frames as frame by frame.
* Masks leave the card as one ``non_blocking`` copy per stacked block
  into pinned host memory, with a ``torch.cuda.Event`` recorded behind
  it.  A multi-frame block (a chunk's predictions, which a CUDA graph
  rewrites on its next replay) is copied when it is appended, on the
  stream that computed it, before that stream runs anything else; single
  frames wait for the flush and go down concatenated by resolution.
* One worker thread waits on each block's event, maps model channels
  back to raw ids (``label_backward``) and writes palette PNGs, so the
  writes overlap the card's work.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.image import save_mask

# (frame names, host block [K, H, W] uint8, event to wait on or None)
HostBlock = Tuple[Tuple[str, ...], torch.Tensor, Optional[torch.cuda.Event]]


def to_host(block: torch.Tensor) -> Tuple[torch.Tensor,
                                          Optional[torch.cuda.Event]]:
    """Start the copy of ``block`` to the host: for a CUDA tensor one
    ``non_blocking`` copy into pinned memory on the current stream and an
    event behind it; a CPU tensor is already there."""
    if block.device.type != "cuda":
        return block, None
    host = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
    host.copy_(block, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


class MaskSaver:
    """One worker thread that finishes the copies of mask blocks, maps
    them through ``remap`` (a 256-entry uint8 LUT, model channel → raw
    ground-truth id) and writes palette PNGs under ``save_dir`` when it
    is set.  ``drain()`` joins everything and returns {frame name: mask}."""

    def __init__(self, save_dir: Optional[str] = None,
                 remap: Optional[np.ndarray] = None):
        self.save_dir = save_dir
        self.remap = remap
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: List = []

    def submit_blocks(self, blocks: List[HostBlock]):
        self._pending.append(self._pool.submit(self._job, blocks))

    def submit_single(self, pred: np.ndarray, name: str):
        """A mask already on the host and remapped (the host
        post-processing path): its PNG only."""
        if self.save_dir is not None:
            png = os.path.splitext(name)[0] + ".png"
            self._pending.append(self._pool.submit(
                save_mask, pred, os.path.join(self.save_dir, png)))

    def _job(self, blocks: List[HostBlock]) -> Dict[str, np.ndarray]:
        out = {}
        for names, host, done in blocks:
            if done is not None:
                done.synchronize()
            arr = host.numpy()
            arr = self.remap[arr] if self.remap is not None else arr.copy()
            for i, nm in enumerate(names):
                if self.save_dir is not None:
                    png = os.path.splitext(nm)[0] + ".png"
                    save_mask(arr[i], os.path.join(self.save_dir, png))
                out[nm] = arr[i]
        return out

    def drain(self) -> Dict[str, np.ndarray]:
        results: Dict[str, np.ndarray] = {}
        for f in self._pending:
            out = f.result()
            if isinstance(out, dict):
                results.update(out)
        self._pending.clear()
        self._pool.shutdown(wait=True)
        return results


class D2HBatcher:
    """Gathers the masks of ``group`` frames before handing them to the
    saver.  Entries are ``(names, block [K, H, W])``: a multi-frame block
    starts its copy on ``append``; single frames are concatenated per
    resolution at ``flush`` (a mid-sequence size change may mix shapes)
    and copied then."""

    def __init__(self, saver: MaskSaver, group: int):
        self.saver = saver
        self.group = max(1, group)
        self._host: List[HostBlock] = []
        self._singles: List[Tuple[str, torch.Tensor]] = []

    def append(self, names: Tuple[str, ...], block: torch.Tensor):
        if len(names) > 1:
            self._host.append((tuple(names), *to_host(block)))
        else:
            self._singles.append((names[0], block))

    def frames(self) -> int:
        return sum(len(n) for n, _, _ in self._host) + len(self._singles)

    def flush(self):
        by_shape: Dict = {}
        for n, b in self._singles:
            by_shape.setdefault(tuple(b.shape[1:]), []).append((n, b))
        self._singles.clear()
        for same in by_shape.values():
            block = torch.cat([b for _, b in same])
            self._host.append((tuple(n for n, _ in same), *to_host(block)))
        if self._host:
            self.saver.submit_blocks(list(self._host))
            self._host.clear()

    def maybe_flush(self, timing: Optional[Dict[str, float]] = None):
        if self.frames() >= self.group:
            t0 = time.time()
            self.flush()
            if timing is not None:
                timing["flush"] += time.time() - t0


class Chunker:
    """MEM_EVERY-aligned frame buffer.  Cuts on any context change (shape
    signature, ``ori_hw``, ``obj_valid``, ``exist_mask``: what a chunk
    holds fixed), at the chunk size, and right after memory-update frames.
    A full chunk goes to ``run_full``, a shorter cut to ``run_ragged``;
    both take ``(buf, ctx)`` with ``buf`` a list of ``(frame index, name,
    payload)``."""

    def __init__(self, chunk_n: int, run_full: Callable, run_ragged: Callable,
                 mem_boundary: Callable[[int], bool],
                 d2h: Optional[D2HBatcher] = None,
                 timing: Optional[Dict[str, float]] = None):
        self.chunk_n = max(1, chunk_n)
        self.buf: List = []
        self.ctx: Dict = {}
        self.run_full = run_full
        self.run_ragged = run_ragged
        self.mem_boundary = mem_boundary
        self.d2h = d2h
        self.timing = timing

    def push(self, f: int, name: str, payload, sig, ov_np, em_np, o_hw,
             extra=None):
        if self.buf and (
                self.ctx["sig"] != sig
                or self.ctx["ori_hw"] != o_hw
                or not np.array_equal(self.ctx["ov"], ov_np)
                or not np.array_equal(self.ctx["em"], em_np)):
            self.flush()
        if not self.buf:
            self.ctx.update(sig=sig, ov=ov_np, em=em_np,
                            ori_hw=o_hw, **(extra or {}))
        self.buf.append((f, name, payload))
        if len(self.buf) >= self.chunk_n or self.mem_boundary(f):
            self.flush()

    def flush(self):
        if not self.buf:
            return
        t1 = time.time()
        if len(self.buf) == self.chunk_n and self.chunk_n > 1:
            self.run_full(self.buf, self.ctx)
        else:
            self.run_ragged(self.buf, self.ctx)
        if self.timing is not None:
            self.timing["step_dispatch"] += time.time() - t1
        self.buf = []
        if self.d2h is not None:
            self.d2h.maybe_flush(self.timing)
