"""Streaming evaluator — the RPA (reliable proxy augmentation) loop
(PyTorch port of ``rvos_tpu/engine/eval.py``, single scale, no flip).

Per video: frame 0's ground truth fills the pinned bank slot 0; every
later frame is embedded, matched against the bank and the previous
frame, decoded, upsampled to the original size and soft-maxed; the
prediction takes the argmax over existing labels, and pixels whose
Shannon entropy exceeds ``UNC_RATIO`` are stored as label 125 (excluded
from matching) when the frame joins the bank every ``MEM_EVERY``
frames.  Mid-video ground truth (``current_label`` at frame > 0) is
spliced into the prediction (``join_label``) and joins the bank.  The
bank is a fixed ring of ``TEST_BANK_CAPACITY`` slots; its flattened
form, compacted by the configured bank layout (``precompact_bank``), is
rebuilt only when the bank or the object set changes.

The pipeline is the JAX evaluator's default one:

* frames are decoded, perturbed and resized on ``TEST_WORKERS`` threads
  (``data.loader.PrefetchLoader``), ``TEST_H2D_GROUP`` frames per
  upload when that is above 1;
* ``engine.eval_pipeline.Chunker`` buffers them into chunks of
  ``TEST_FRAME_CHUNK`` frames (at most ``MEM_EVERY``), cut right after a
  memory-update frame and on any change of frame shape, original size,
  ``obj_valid`` or ``exist_mask``, so the bank is fixed inside a chunk;
* a full chunk runs the chunk step: one batch-K ``extract_feature``,
  then for each frame ``segment_frame``, the bilinear upsampling,
  softmax × exist, argmax, the entropy gate and the nearest downscales,
  carrying the previous labels and the decoder memory from frame to
  frame.  On CUDA the step is a ``torch.cuda.CUDAGraph``, captured once
  per (K, frame shape, original size) of a state and replayed for every
  full chunk; on the CPU the same function runs eagerly.  Ragged cuts,
  join frames and ``TEST_FRAME_CHUNK <= 1`` run it one frame at a time,
  eagerly;
* bank updates and compaction run eagerly between chunks and write into
  the state's tensors, which are the graph's static inputs;
* masks leave the card as one copy per block (``D2HBatcher``, grouped by
  ``TEST_D2H_GROUP``) and are remapped and written by a thread
  (``MaskSaver``).

The k-means init scores of frame ``f`` come from a ``torch.Generator``
seeded with ``KMEANS_SEED + f``, drawn outside the graph, so a chunked
and a per-frame run see the same draws, unless the caller supplies
``kmeans_scores``.  ``TEST_FUSED_POSTPROCESS=False`` (the JAX package's
host post-processing path) and the multi-scale/flip ensemble are not
ported (ROADMAP Queue A items 4 and 9): they raise.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..configs import Config
from ..data.loader import PrefetchLoader
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD, eval_variants, frame_u8
from ..device import compute_dtype, configure_precision, resolve_device
from ..models import AOCNet, DecoderMemory, precompact_bank
from ..ops.entropy import shannon_entropy
from ..ops.kmeans import draw_init_scores
from ..ops.resize import resize_nchw
from .eval_pipeline import Chunker, D2HBatcher, MaskSaver

UNCERTAIN_LABEL = 125
KMEANS_SEED = 42
PINNED_FRAMES = 3       # pinned upload buffers per frame-block shape

ScoreFn = Callable[[int, int, int], torch.Tensor]


def one_hot(lab: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot over the last axis; labels outside [0, n) (the uncertain
    125, void 255) give all-zero rows."""
    return (lab[..., None] == torch.arange(n, device=lab.device)).to(dtype)


class ChunkIO(NamedTuple):
    """What the chunk step reads and writes besides the state."""
    frames: torch.Tensor    # [K, H, W, 3] uint8
    scores: torch.Tensor    # [K, O, R] k-means init scores
    ov: torch.Tensor        # [O] obj_valid
    em: torch.Tensor        # [O] exist_mask
    preds: torch.Tensor     # [K, H0, W0] uint8 (output)


class _SeqState:
    """Streaming state of a video at one embedding size.  Its tensors are
    the chunk graphs' static inputs, so every update writes into them in
    place; the evaluator keeps one per size and reuses it video after
    video, with the graphs captured on it."""

    def __init__(self, cfg: Config, h: int, w: int, c: int, dtype, device):
        cap, o = cfg.TEST_BANK_CAPACITY, cfg.MODEL_MAX_OBJ_NUM
        self.capacity = cap
        self.ref_emb = torch.zeros((cap, h, w, c), dtype=dtype, device=device)
        self.ref_lab = torch.zeros((cap, h, w), dtype=torch.long,
                                   device=device)
        self.slot_valid = torch.zeros(cap, device=device)
        self.prev_emb = torch.zeros((h, w, c), dtype=dtype, device=device)
        self.prev_lab = torch.zeros((h, w), dtype=torch.long, device=device)
        self.conf = torch.zeros((h, w), dtype=torch.long, device=device)
        self.memory = DecoderMemory.empty(o, (h + 1) // 2, (w + 1) // 2,
                                          cfg.MODEL_HEAD_EMBEDDING_DIM,
                                          dtype, device)
        self.flat: Optional[Tuple] = None   # (flat_emb, flat_lab, tile_obj)
        self.flat_key = None
        self.graphs: Dict = {}
        self.ring_ptr = 1           # slot 0 pinned to the first frame
        self.version = 0

    def carried(self) -> Tuple[torch.Tensor, ...]:
        """The tensors the chunk step advances."""
        return (self.prev_emb, self.prev_lab, *self.memory)

    def start(self, emb, lab):
        for t in (self.ref_emb, self.ref_lab, self.slot_valid, *self.memory):
            t.zero_()
        self.ring_ptr, self.version, self.flat_key = 1, 0, None
        self.add_ref(emb, lab, first=True)
        self.prev_emb.copy_(emb)
        self.prev_lab.copy_(lab)

    def add_ref(self, emb, lab, first=False):
        if first:
            slot = 0
        else:
            slot = self.ring_ptr
            self.ring_ptr = self.ring_ptr + 1 if self.ring_ptr + 1 < self.capacity else 1
        self.ref_emb[slot].copy_(emb)
        self.ref_lab[slot].copy_(lab)
        self.slot_valid[slot] = 1.0
        self.version += 1

    def copy_to(self, device) -> "_SeqState":
        """A copy on ``device`` (no graphs): the same step from this state
        elsewhere (``engine.lockstep``)."""
        new = object.__new__(_SeqState)
        new.__dict__.update(self.__dict__)
        for name in ("ref_emb", "ref_lab", "slot_valid", "prev_emb",
                     "prev_lab", "conf"):
            setattr(new, name, getattr(self, name).to(device, copy=True))
        new.memory = DecoderMemory(*(t.to(device, copy=True)
                                     for t in self.memory))
        if self.flat is not None:
            new.flat = tuple(None if t is None else t.to(device, copy=True)
                             for t in self.flat)
        new.graphs = {}
        return new


class _ChunkGraph:
    """A chunk step's static buffers and, once captured, its graph."""

    def __init__(self, io: ChunkIO):
        self.io = io
        self.graph: Optional[torch.cuda.CUDAGraph] = None


class _PinnedFrames:
    """Pinned host buffers for frame uploads, ``n`` per block shape used
    in turn; a buffer is refilled only after the copy that last read it
    has run."""

    def __init__(self, n: int = PINNED_FRAMES):
        self.n = n
        self._ring: Dict[Tuple[int, ...], List] = {}

    def take(self, shape) -> torch.Tensor:
        ring = self._ring.setdefault(tuple(shape), [])
        if len(ring) < self.n:
            ring.append([torch.empty(shape, dtype=torch.uint8,
                                     pin_memory=True), None])
        else:
            ring.append(ring.pop(0))
        buf, done = ring[-1]
        if done is not None:
            done.synchronize()
        return buf

    def give(self, buf: torch.Tensor):
        """Mark ``buf``'s copy as enqueued on the current stream."""
        done = torch.cuda.Event()
        done.record()
        self._ring[tuple(buf.shape)][-1][1] = done


class _PrepView:
    """Frame prep on the loader's threads: the eval resize (single
    scale) and the uint8 frame the step uploads."""

    def __init__(self, dataset, cfg: Config):
        self.dataset = dataset
        self.cfg = cfg

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        sample = self.dataset[i]
        (var,) = eval_variants(sample["current_img"], self.cfg.TEST_MAX_SIZE,
                               self.cfg.TEST_MIN_SIZE, False, (1.0,))
        sample["frame"] = frame_u8(var["img"])
        return sample


class _PrepGroupView:
    """``group`` consecutive frames per loader item (the JAX
    ``_EvalPrepGroupView``): prepared as ``_PrepView`` does, then stacked
    into one uint8 block (pinned when it goes to a card) that the
    consumer uploads with one copy; a group whose frames differ in shape
    keeps them apart."""

    def __init__(self, dataset, cfg: Config, group: int, pin: bool):
        self.view = _PrepView(dataset, cfg)
        self.group = group
        self.pin = pin

    def __len__(self):
        return -(-len(self.view) // self.group)

    def __getitem__(self, g):
        lo = g * self.group
        samples = [self.view[i]
                   for i in range(lo, min(lo + self.group, len(self.view)))]
        block = None
        if len({s["frame"].shape for s in samples}) == 1:
            block = torch.empty((len(samples),) + samples[0]["frame"].shape,
                                dtype=torch.uint8, pin_memory=self.pin)
            block.numpy()[:] = np.stack([s["frame"] for s in samples])
        return samples, block


class Evaluator:
    # the model's config drives segment_frame; the evaluator prepares the
    # bank with its own — they must agree on these
    _MODEL_CFG_FIELDS = (
        "MATCHING_MAX_REF_PIXELS", "MATCHING_SEGMENTED_BANK",
        "MATCHING_OCCUPANCY_BANK", "MATCHING_DTYPE", "MODEL_FLOAT16_MATCHING",
        "TEST_GLOBAL_ATROUS_RATE", "TEST_LOCAL_ATROUS_RATE",
        "MODEL_MAX_OBJ_NUM", "MODEL_CLUSTER_NUM", "MODEL_KMEANS_ITERS")

    def __init__(self, cfg: Config, model: AOCNet, device=None,
                 kmeans_scores: Optional[ScoreFn] = None):
        """``model`` is moved to ``device`` (CUDA unless "cpu") and the
        eval compute dtype in place.  ``kmeans_scores(frame_idx, n_obj,
        n_rows)`` optionally supplies each frame's ``[O, R]`` k-means
        init scores."""
        for f in self._MODEL_CFG_FIELDS:
            if getattr(model.cfg, f) != getattr(cfg, f):
                raise ValueError(f"Evaluator cfg.{f}={getattr(cfg, f)!r} but "
                                 f"the model was built with "
                                 f"{getattr(model.cfg, f)!r}")
        if cfg.TEST_FLIP or tuple(cfg.TEST_MULTISCALE) != (1.0,):
            raise NotImplementedError(
                "the multi-scale/flip ensemble is not ported yet (ROADMAP "
                "Queue A item 4)")
        if not cfg.TEST_FUSED_POSTPROCESS:
            raise NotImplementedError(
                "TEST_FUSED_POSTPROCESS=False, the host post-processing "
                "path, is not ported (ROADMAP Queue A item 9)")
        self.cfg = cfg
        self.device = resolve_device(device)
        configure_precision(cfg)
        self.dtype = compute_dtype(cfg, self.device)
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        self.mem_every = cfg.MEM_EVERY
        self.unc_ratio = cfg.UNC_RATIO
        self.chunk_n = max(1, cfg.TEST_FRAME_CHUNK)
        if self.mem_every > 0:
            self.chunk_n = min(self.chunk_n, self.mem_every)
        self.kmeans_scores = kmeans_scores
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device)
        self._states: Dict[Tuple, _SeqState] = {}
        self._vecs: Dict[bytes, torch.Tensor] = {}
        on_card = self.device.type == "cuda"
        self._pinned = _PinnedFrames() if on_card else None
        self._pool = torch.cuda.graph_pool_handle() if on_card else None
        self.captures = 0            # CUDA graphs captured
        self.replays = 0             # chunk graph replays
        self._last_state: Optional[_SeqState] = None   # introspection

    def _mem_boundary(self, frame_idx: int) -> bool:
        return self.mem_every > 0 and frame_idx % self.mem_every == 0

    def _dev_vec(self, arr: np.ndarray) -> torch.Tensor:
        """``obj_valid``/``exist_mask`` on the device, uploaded once per
        distinct value."""
        key = arr.tobytes()
        if key not in self._vecs:
            self._vecs[key] = torch.from_numpy(arr.copy()).to(self.device)
        return self._vecs[key]

    def _init_scores(self, frame_idx: int, n_rows: int) -> torch.Tensor:
        o = self.cfg.MODEL_MAX_OBJ_NUM
        if self.kmeans_scores is not None:
            s = self.kmeans_scores(frame_idx, o, n_rows)
            return torch.as_tensor(s, dtype=torch.float32, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(KMEANS_SEED + frame_idx)
        return draw_init_scores(o, n_rows, gen, self.device)

    def _upload(self, frames: List, out: torch.Tensor) -> None:
        """Frames (host uint8 [H, W, 3], or slices of an uploaded group
        block) into ``out`` [K, H, W, 3]: one copy from a pinned buffer on
        a card."""
        if torch.is_tensor(frames[0]):
            torch.stack(frames, out=out)
        elif self._pinned is None:
            out.copy_(torch.from_numpy(np.stack(frames)))
        else:
            host = self._pinned.take(out.shape)
            hv = host.numpy()
            for k, f in enumerate(frames):
                hv[k] = f
            out.copy_(host, non_blocking=True)
            self._pinned.give(host)

    def _embed(self, frames: torch.Tensor):
        """uint8 [K, H, W, 3] → (embeddings [K, h, w, C], low-level)."""
        x = (frames.float() / 255.0 - self._mean) / self._std
        return self.model.extract_feature(x.to(self.dtype))

    def _start(self, frame, gt: np.ndarray) -> _SeqState:
        """Frame 0: its embedding and ground truth open the bank."""
        x = torch.empty((1,) + tuple(frame.shape), dtype=torch.uint8,
                        device=self.device)
        self._upload([frame], x)
        emb = self._embed(x)[0][0]
        h, w, c = emb.shape
        st = self._states.get((h, w, c))
        if st is None:
            st = self._states[(h, w, c)] = _SeqState(
                self.cfg, h, w, c, self.dtype, self.device)
        lab = torch.from_numpy(gt.astype(np.int64)).to(self.device)
        st.start(emb, resize_nchw(lab, (h, w), "nearest"))
        return st

    def _ensure_flat(self, st: _SeqState, ov_np: np.ndarray):
        """Recompact the bank when it or the object set changed, into the
        state's flat-bank tensors."""
        key = (st.version, ov_np.tobytes())
        if st.flat_key == key:
            return
        onehot = one_hot(st.ref_lab, self.cfg.MODEL_MAX_OBJ_NUM, self.dtype)
        onehot = onehot * self._dev_vec(ov_np).to(self.dtype)
        flat = precompact_bank(self.cfg, st.ref_emb, onehot, st.slot_valid)
        if st.flat is None:
            st.flat = tuple(None if t is None else t.clone() for t in flat)
        else:
            for dst, src in zip(st.flat, flat):
                if dst is None:
                    continue
                if dst.shape != src.shape:
                    raise RuntimeError(f"flat bank changed shape: "
                                       f"{tuple(dst.shape)} -> "
                                       f"{tuple(src.shape)}")
                dst.copy_(src)
        st.flat_key = key

    def chunk_step(self, io: ChunkIO, st: _SeqState, ori_hw,
                   join: Optional[torch.Tensor] = None) -> None:
        """The K frames of ``io`` from state ``st``: writes their uint8
        masks into ``io.preds``, advances ``st.prev_emb``,
        ``st.prev_lab`` and ``st.memory`` in place, and leaves the last
        frame's confident mask in ``st.conf``.  ``join`` [H0, W0] is
        spliced into a single frame's masks.  What a CUDA graph of this
        function captures."""
        o = self.cfg.MODEL_MAX_OBJ_NUM
        embs, lows = self._embed(io.frames)
        h, w = embs.shape[1:3]
        prev_embs = torch.cat([st.prev_emb[None], embs[:-1]])
        ref_onehot = one_hot(st.ref_lab, o, self.dtype)
        flat_emb, flat_lab, tile_obj = st.flat
        p_lab, memory = st.prev_lab, st.memory
        for k in range(embs.shape[0]):
            logits, memory = self.model.segment_frame(
                embs[k], lows[k], st.ref_emb, ref_onehot, st.slot_valid,
                prev_embs[k], one_hot(p_lab, o, self.dtype), io.ov, memory,
                io.scores[k], flat_emb, flat_lab, tile_obj)
            lg = resize_nchw(logits.float(), ori_hw, "bilinear")
            probs = torch.softmax(lg, dim=0) * io.em[:, None, None]
            pred = probs.argmax(dim=0)
            unc = shannon_entropy(probs, io.em)
            if join is not None:
                pred = torch.where(join == 0, pred, join)
            conf = torch.where(unc > self.unc_ratio,
                               torch.full_like(pred, UNCERTAIN_LABEL), pred)
            if join is not None:
                conf = torch.where(join == 0, conf, join)
            p_lab = resize_nchw(pred, (h, w), "nearest")
            io.preds[k].copy_(pred)
        for dst, src in zip(st.carried(), (embs[-1], p_lab, *memory)):
            dst.copy_(src)
        st.conf.copy_(resize_nchw(conf, (h, w), "nearest"))

    def _new_io(self, st: _SeqState, k_n: int, frame_hw, ori_hw) -> ChunkIO:
        o, dev = self.cfg.MODEL_MAX_OBJ_NUM, self.device
        return ChunkIO(
            torch.empty((k_n, *frame_hw, 3), dtype=torch.uint8, device=dev),
            torch.empty((k_n, o, st.flat[0].shape[0]), device=dev),
            torch.empty(o, device=dev), torch.empty(o, device=dev),
            torch.empty((k_n, *ori_hw), dtype=torch.uint8, device=dev))

    def _capture(self, io: ChunkIO, st: _SeqState, ori_hw):
        """Capture ``chunk_step`` on ``st`` as a CUDA graph.  A warm-up
        run on a side stream first (module loading, kernel attributes and
        cuDNN's choices happen outside capture); the state it advanced is
        put back.  A capture that fails raises."""
        saved = [t.clone() for t in st.carried()]
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.chunk_step(io, st, ori_hw)
        cur.wait_stream(side)
        for t, s in zip(st.carried(), saved):
            t.copy_(s)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            self.chunk_step(io, st, ori_hw)
        self.captures += 1
        return graph

    def run_chunk(self, st: _SeqState, io: ChunkIO, ori_hw,
                  join: Optional[torch.Tensor] = None) -> None:
        """One step over the frames of ``io``: for a multi-frame chunk on a
        card a replay of the graph that owns ``io`` (captured at its first
        use), else ``chunk_step`` eagerly."""
        if self.device.type != "cuda" or io.frames.shape[0] == 1:
            self.chunk_step(io, st, ori_hw, join)
            return
        g = st.graphs[(tuple(io.frames.shape), tuple(ori_hw))]
        if g.io is not io or join is not None:
            raise ValueError("a chunk graph replays its own buffers, and "
                             "joins no label")
        if g.graph is None:
            g.graph = self._capture(io, st, ori_hw)
        g.graph.replay()
        self.replays += 1

    def _io_for(self, st: _SeqState, k_n: int, frame_hw, ori_hw) -> ChunkIO:
        """The buffers of a step: a graph's own static ones for a
        multi-frame chunk on a card, else fresh ones."""
        if self.device.type != "cuda" or k_n == 1:
            return self._new_io(st, k_n, frame_hw, ori_hw)
        key = ((k_n, *frame_hw, 3), tuple(ori_hw))
        if key not in st.graphs:
            st.graphs[key] = _ChunkGraph(self._new_io(st, k_n, frame_hw,
                                                      ori_hw))
        return st.graphs[key].io

    def _step(self, st: _SeqState, buf, ctx, join=None) -> torch.Tensor:
        """Frames ``buf`` (``(index, name, frame)``) as one step → their
        masks [K, H0, W0] uint8 (a graph's output buffer: copy before the
        next step)."""
        frames = [p for _, _, p in buf]
        io = self._io_for(st, len(buf), tuple(frames[0].shape[:2]),
                          ctx["ori_hw"])
        self._upload(frames, io.frames)
        for k, (f, _, _) in enumerate(buf):
            io.scores[k].copy_(self._init_scores(f, io.scores.shape[-1]))
        io.ov.copy_(self._dev_vec(ctx["ov"]))
        io.em.copy_(self._dev_vec(ctx["em"]))
        self.run_chunk(st, io, ctx["ori_hw"], join)
        return io.preds

    def _grouped(self, groups):
        """Samples of a grouped loader, each group's frames uploaded as one
        block (a group of mixed shapes frame by frame)."""
        for samples, block in groups:
            if block is not None:
                dev = block.to(self.device, non_blocking=True)
                for j, s in enumerate(samples):
                    s["frame"] = dev[j]
            yield from samples

    @torch.no_grad()
    def evaluate_sequence(self, seq, save_dir: Optional[str] = None,
                          frame_callback: Optional[Callable[[int], None]] = None
                          ) -> Dict:
        """Stream one video.  Returns ``{"results": {frame name: uint8
        mask}, "fps", "fps_ref", "frames", "time", "timing"}``; frame 0
        (the given ground truth) has no result.  ``fps`` is wall-clock,
        from before the first frame to the end of the drain; ``fps_ref``
        leaves out the time spent waiting for the loader; ``timing``
        splits the wall time (``loader_wait``, ``flat``,
        ``step_dispatch``, ``flush``, ``drain``).  ``frame_callback(f)``
        runs once per frame, in order, after the work of the step that
        holds frame ``f`` is issued."""
        cfg = self.cfg
        o = cfg.MODEL_MAX_OBJ_NUM
        workers = max(1, cfg.TEST_WORKERS)
        group = max(1, cfg.TEST_H2D_GROUP)
        if group > 1:
            loader = self._grouped(PrefetchLoader(
                _PrepGroupView(seq, cfg, group, self.device.type == "cuda"),
                num_workers=workers, prefetch=2))
        else:
            loader = PrefetchLoader(_PrepView(seq, cfg), num_workers=workers,
                                    prefetch=3)
        saver = MaskSaver(save_dir, remap=getattr(seq, "label_backward", None))
        timing = {"loader_wait": 0.0, "flat": 0.0, "step_dispatch": 0.0,
                  "flush": 0.0, "drain": 0.0}
        d2h = D2HBatcher(saver, max(group, cfg.TEST_D2H_GROUP))
        callback = frame_callback or (lambda f: None)
        st: Optional[_SeqState] = None

        def ensure_flat(ov_np):
            t0 = time.time()
            self._ensure_flat(st, ov_np)
            timing["flat"] += time.time() - t0

        def run_full(buf, ctx):
            ensure_flat(ctx["ov"])
            preds = self._step(st, buf, ctx)
            if self._mem_boundary(buf[-1][0]):
                st.add_ref(st.prev_emb, st.conf)
            d2h.append(tuple(n for _, n, _ in buf), preds)
            for f, _, _ in buf:
                callback(f)

        def run_ragged(buf, ctx):
            ensure_flat(ctx["ov"])
            for item in buf:
                preds = self._step(st, [item], ctx)
                if self._mem_boundary(item[0]):
                    st.add_ref(st.prev_emb, st.conf)
                d2h.append((item[1],), preds)
                callback(item[0])

        chunker = Chunker(self.chunk_n, run_full, run_ragged,
                          self._mem_boundary, d2h, timing)
        label_all: List[int] = []
        n_frames = 0
        it = iter(loader)
        t_wall = time.time()
        for frame_idx in range(len(seq)):
            t0 = time.time()
            sample = next(it)
            timing["loader_wait"] += time.time() - t0
            meta = sample["meta"]
            ori_hw = (meta["height"], meta["width"])
            gt = sample.get("current_label")
            gt_all = sample.get("current_label_all")
            if frame_idx == 0 and gt is None:
                raise ValueError(f"sequence {meta.get('seq_name', '?')}: the "
                                 "first frame has no 'current_label'")
            for lab in (gt, gt_all):
                if lab is not None:
                    for lid in np.unique(lab).tolist():
                        if lid != 255 and lid not in label_all:
                            if lid >= o:
                                raise ValueError(
                                    f"sequence {meta.get('seq_name', '?')}: "
                                    f"object id {lid} >= MODEL_MAX_OBJ_NUM="
                                    f"{o}")
                            label_all.append(lid)
            if frame_idx == 0:
                st = self._start(sample["frame"], gt)
                callback(0)
                continue
            ov_np = (np.arange(o) <= int(meta["obj_num"])).astype(np.float32)
            em_np = np.zeros(o, np.float32)
            em_np[label_all] = 1.0
            n_frames += 1
            if gt is None:
                chunker.push(frame_idx, meta["current_name"], sample["frame"],
                             tuple(sample["frame"].shape[:2]), ov_np, em_np,
                             ori_hw)
                continue
            # a join frame runs alone, after the frames buffered before it
            chunker.flush()
            t1 = time.time()
            ensure_flat(ov_np)
            join = torch.from_numpy(gt.astype(np.int64)).to(self.device)
            ctx = {"ov": ov_np, "em": em_np, "ori_hw": ori_hw}
            item = (frame_idx, meta["current_name"], sample["frame"])
            preds = self._step(st, [item], ctx, join)
            st.add_ref(st.prev_emb, st.conf)
            d2h.append((item[1],), preds)
            timing["step_dispatch"] += time.time() - t1
            callback(frame_idx)
            d2h.maybe_flush(timing)
        t0 = time.time()
        chunker.flush()
        d2h.flush()
        results = saver.drain()
        timing["drain"] = time.time() - t0
        seq_time = time.time() - t_wall
        self._last_state = st
        return {"results": results, "frames": n_frames, "time": seq_time,
                "fps": n_frames / max(seq_time, 1e-6),
                "fps_ref": n_frames / max(seq_time - timing["loader_wait"],
                                          1e-6),
                "timing": timing}

    def evaluating(self, dataset, save_root: Optional[str] = None,
                   verbose: bool = True) -> Dict:
        """Every sequence of ``dataset``, with the reference's FPS lines."""
        total_time, total_frames, total_sfps = 0.0, 0, 0.0
        per_seq = {}
        for i in range(len(dataset)):
            seq = dataset[i]
            save_dir = None
            if save_root is not None:
                save_dir = os.path.join(save_root, seq.seq_name)
                os.makedirs(save_dir, exist_ok=True)
            out = self.evaluate_sequence(seq, save_dir)
            per_seq[seq.seq_name] = out["fps"]
            total_time += out["time"]
            total_frames += out["frames"]
            total_sfps += out["fps"]
            if verbose:
                print(f"Seq {seq.seq_name} FPS: {out['fps']:.2f}, Total FPS: "
                      f"{total_frames / max(total_time, 1e-6):.2f}, FPS per "
                      f"Seq: {total_sfps / (i + 1):.2f}")
        return {"per_seq_fps": per_seq,
                "total_fps": total_frames / max(total_time, 1e-6)}
