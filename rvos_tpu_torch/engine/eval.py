"""Streaming evaluator — the RPA (reliable proxy augmentation) loop
(PyTorch port of ``rvos_tpu/engine/eval.py``), single scale or the
multi-scale + flip ensemble.

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

The ensemble (``TEST_MULTISCALE``, ``TEST_FLIP``): each frame is resized
once per scale (``data.transforms.eval_variants``), and a flip twin
mirrors its scale's frame on the device (a uint8 flip, exact).  Every
variant keeps its own streaming state — bank, previous frame and labels,
decoder memory — at its own resolution and orientation; its
probabilities are flipped back and averaged over the variants, and the
joint prediction is carried back to each variant by a nearest downscale
(mirrored for a twin).  One scale alone without flip is the single
variant of the default path.

The pipeline is the JAX evaluator's default one:

* frames are decoded, perturbed and resized on ``TEST_WORKERS`` threads
  (``data.loader.PrefetchLoader``), ``TEST_H2D_GROUP`` frames per
  upload when that is above 1, one uint8 block per scale;
* ``engine.eval_pipeline.Chunker`` buffers them into chunks of
  ``TEST_FRAME_CHUNK`` frames (at most ``MEM_EVERY``), cut right after a
  memory-update frame and on any change of frame shapes, original size,
  ``obj_valid`` or ``exist_mask``, so the banks are fixed inside a chunk;
* a full chunk runs the chunk step: per scale one ``extract_feature``
  over the chunk's frames and their flip twins, then for each frame and
  variant ``segment_frame``, the bilinear upsampling and softmax, the
  flip back and the mean over the variants, × exist, the argmax, the
  entropy gate and the nearest downscales, carrying each variant's
  previous labels and decoder memory from frame to frame.  On CUDA the
  step is a ``torch.cuda.CUDAGraph``, captured once per (K, frame
  shapes, original size, live channels) of a set of states and replayed
  for every full chunk; on the CPU the same function runs eagerly.
  Ragged cuts and ``TEST_FRAME_CHUNK <= 1`` run it one frame at a time,
  eagerly;
* a join frame runs alone through the same step, its label spliced into
  the mask and the confident mask, and every bank appends.  Under
  ``TEST_FUSED_POSTPROCESS=False`` every frame runs alone this way: the
  JAX package's host post-processing path computes the same function
  (it averages the exist-masked probabilities, (Σ p·em)/n where the step
  takes (Σ p)/n·em, and embeds a flip twin on its own, so the two round
  apart, within the 99.9 % agreement its tests hold);
* bank updates and compaction run eagerly between chunks and write into
  the states' tensors, which are the graph's static inputs;
* masks leave the card as one copy per block (``D2HBatcher``, grouped by
  ``TEST_D2H_GROUP``) and are remapped and written by a thread
  (``MaskSaver``).

AOC-Net decodes a video's live object channels only: the background and
objects 1 to the largest object count the sequence lists up front, else
frame 0's (``live_channels``).  The pre-head and the calibration decoder
run with those channels as their batch (``segment_frame(..., live=n)``);
the other channels' logits are −1e9, as a dead channel's are in a decode
of all ``MODEL_MAX_OBJ_NUM``, and their decoder memory keeps the zeros a
video starts with.  Every decoder op is per object or masks by
``obj_valid``, so the masks are those of the decode of all channels, up
to the rounding of kernels chosen for another batch size.  A channel that
joins within the count is decoded as a dead channel until it joins, as
there.  A frame whose ``obj_num`` passes the count (a sequence that does
not list its counts) sends the rest of its video through all channels;
the grown channels' decoder memory then starts from zeros, where the
decode of all channels carries what their dead decode left — the one
place where the masks can differ from it.  ``decoded_channels`` counts
the channels decoded, over frames and variants.

AOT (``models/aot.py``, a model whose ``kind`` is ``"aot"``; one variant,
one device) runs through the same loader, ``Chunker``, chunk graphs,
``D2HBatcher`` and post-processing with a state of its own.  A model
family is a ``_Family`` (its frame 0, the preparation of a state before
a step and its chunk step: ``_AOC``, ``_AOT``), which the evaluator picks
once, at construction, and a state class, which the pipeline reads
through ``score_rows`` (the k-means rows a step draws), ``remember()``
(the last frame joins the memory) and ``one_frame_graph`` (whether a
ragged frame replays a one-frame graph).  AOT's state (``_AOTState``)
holds per LSTT block a long-term memory of frame 0 and every
``MEM_EVERY``-th frame (and every join frame), preallocated for
``_AOTState.CAPACITY`` frames and doubled when a video outgrows it, and
a short-term memory, the previous frame's keys and values.  Frame 0
runs AOT's reference pass on its ground truth; a later frame attends the
memory and is decoded, its mask is the argmax over the labels given so
far (no entropy gate: AOT writes its argmax), and it writes its keys and
values as the next frame's short-term memory; the long-term memory
appends them between chunks, as the AOC bank appends a frame.  One graph
per chunk kind serves every memory length: the long-term attention reads
the valid length from a device tensor
(``ops.attention.memory_attention``).  AOT's ragged frames replay a
one-frame graph (``frame_replays``): run eagerly they are launch-bound,
twice a graph frame's time.  AOC-Net's stay eager: its step is the same
function and could take the same graph, which would change what its
eval measures, so that is left to a change of its own.

The k-means init scores are the JAX evaluator's own draws
(``ops.prng``: threefry, ``fold_in(PRNGKey(42), frame)``, split over
the objects, uniform in [0.5, 1)), drawn on the evaluator's device
outside the graph, a block of frames at a time; every variant of a frame
reads the same draws, a prefix as long as its bank.  ``kmeans_scores``
replaces them (tests).

Several devices (``devices``: every visible card by default, the CPU
alone on the CPU; a list may repeat a device):

* the sharded ensemble (``TEST_ENSEMBLE_SHARD``, more than one device,
  no context parallelism, more than one variant): the variants are
  partitioned over the devices (``_ens_partitions``: one variant per
  device when the devices suffice, else one scale group per device,
  round-robin), each partition with a parameter replica and its
  variants' states pinned to its device.  A frame runs partition by
  partition — the backbone batched over the partition's variants, so a
  flip twin alone on its device embeds its frame alone — and each
  partition's probability sum goes to the first device, where the sums
  are added, gated and the joint mask carried back to every partition.
  Frame by frame: the chunked graph step sums the variants inside each
  frame, which no split over devices keeps (the JAX package's sharded
  path bypasses its chunks too);
* context parallelism (``MESH_MODEL_AXIS > 1`` with at least that many
  devices, ``parallel.mesh.resolved_cp_devices``): ``segment_frame``
  splits the query rows of global, cluster and proxy matching over the
  devices (the flat route, B.3 per shard, whatever the bank layout).
  Chunks are CUDA graphs only while every shard runs on the evaluator's
  own card; across cards they run eagerly.
"""

from __future__ import annotations

import copy
import gc
import os
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import Config
from ..data.loader import PrefetchLoader
from ..data.transforms import (IMAGENET_MEAN, IMAGENET_STD, eval_variants,
                               frame_u8, variant_list)
from ..device import compute_dtype, configure_precision, resolve_device
from ..models import AOCNet, DecoderMemory, precompact_bank
from ..models.aot import D_MODEL, LSTT_NUM
from ..ops.entropy import shannon_entropy
from ..ops.prng import kmeans_init_scores
from ..ops.resize import resize_nchw
from ..parallel.mesh import local_devices, resolved_cp_devices
from ..utils import trace
from .eval_pipeline import Chunker, D2HBatcher, MaskSaver

UNCERTAIN_LABEL = 125
PINNED_FRAMES = 3       # pinned upload buffers per frame-block shape
DRAW_BLOCK = 32         # frames of k-means draws per draw, at most ...
DRAW_ELEMENTS = 1 << 21  # ... and about this many scores

ScoreFn = Callable[[int, int, int], torch.Tensor]


def one_hot(lab: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot over the last axis; labels outside [0, n) (the uncertain
    125, void 255) give all-zero rows."""
    return (lab[..., None] == torch.arange(n, device=lab.device)).to(dtype)


class ChunkIO(NamedTuple):
    """What the chunk step reads and writes besides the states."""
    frames: Tuple[torch.Tensor, ...]   # per scale: [K, H, W, 3] uint8
    scores: torch.Tensor    # [K, O, R] k-means init scores (R ≥ each bank)
    ov: torch.Tensor        # [O] obj_valid
    em: torch.Tensor        # [O] exist_mask
    preds: torch.Tensor     # [K, H0, W0] uint8 (output)
    live: Optional[int]     # object channels decoded (None: all O)

    def copy_to(self, device) -> "ChunkIO":
        """Copies of the inputs on ``device`` and a fresh output."""
        return ChunkIO(tuple(t.to(device, copy=True) for t in self.frames),
                       *(t.to(device, copy=True)
                         for t in (self.scores, self.ov, self.em)),
                       torch.empty(self.preds.shape, dtype=self.preds.dtype,
                                   device=device), self.live)


class Variants(NamedTuple):
    """The eval variants of a config: ``flips[v]`` per variant in
    ``eval_variants``' order, and the scale groups as lists of variant
    indices, each group one frame size (the JAX evaluator's grouping by
    scale)."""
    flips: Tuple[bool, ...]
    groups: Tuple[Tuple[int, ...], ...]

    @staticmethod
    def of(cfg: Config) -> "Variants":
        layout = variant_list(cfg.TEST_FLIP, cfg.TEST_MULTISCALE)
        groups: Dict[float, List[int]] = {}
        for v, (scale, _) in enumerate(layout):
            groups.setdefault(scale, []).append(v)
        return Variants(tuple(f for _, f in layout),
                        tuple(tuple(m) for m in groups.values()))

    def group_frames(self, variants: List[Dict]) -> Tuple[np.ndarray, ...]:
        """Per group, the uint8 frame of its unflipped member (the twin's
        mirror is made on the device)."""
        return tuple(frame_u8(variants[next(v for v in m
                                            if not self.flips[v])]["img"])
                     for m in self.groups)

    def group_of(self, v: int) -> int:
        return next(g for g, m in enumerate(self.groups) if v in m)


class _SeqState:
    """Streaming state of a video for one variant at one embedding size.
    Its tensors are the chunk graphs' static inputs, so every update
    writes into them in place; the evaluator keeps one per (variant,
    size) and reuses it video after video, with the graphs captured on
    the first variant's state."""

    one_frame_graph = False     # a ragged frame runs eagerly

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

    @property
    def lab_hw(self) -> Tuple[int, int]:
        """The size of the labels the state keeps (its embedding's)."""
        return tuple(self.prev_lab.shape)

    @property
    def score_rows(self) -> int:
        """The k-means init scores' rows a step reads: the flat bank's."""
        return self.flat[0].shape[0]

    def remember(self):
        """The last frame joins the bank (its confident mask)."""
        self.add_ref(self.prev_emb, self.conf)

    def carry(self, emb, lab, memory: DecoderMemory):
        """A step's last frame becomes the previous one: its embedding,
        labels and decoder memory, whose slots fill the first channels
        (a decode of the live channels leaves the others as they are)."""
        live = memory.slots.shape[1]
        self.prev_emb.copy_(emb)
        self.prev_lab.copy_(lab)
        self.memory.slots[:, :live].copy_(memory.slots)
        self.memory.valid.copy_(memory.valid)

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
        trace.stage("pipeline.bank", self.ref_emb.device)
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


class _AOTState:
    """Streaming state of a video for AOT at one token grid (see the
    module's docstring): ``lt_k``/``lt_v`` [L, capacity·n, d], the first
    ``frames``·n rows valid and ``cu_k`` = [0, valid rows] on the device
    (what the graphs read); ``st_k``/``st_v`` [L, n, d].  Like
    ``_SeqState`` it is reused video after video and holds the graphs;
    a growth of the capacity drops them (they read the old tensors)."""

    CAPACITY = 24           # long-term frames preallocated (DAVIS: 21)
    one_frame_graph = True  # a ragged frame replays a one-frame graph
    score_rows = 0          # no k-means

    def __init__(self, grid: Tuple[int, int], lab_hw: Tuple[int, int],
                 dtype, device):
        n_layers, d = LSTT_NUM, D_MODEL
        self.grid, self.n, self.lab_hw = grid, grid[0] * grid[1], lab_hw
        self.capacity = self.CAPACITY
        self.lt_k = torch.zeros((n_layers, self.capacity * self.n, d),
                                dtype=dtype, device=device)
        self.lt_v = torch.zeros_like(self.lt_k)
        self.cu_k = torch.zeros(2, dtype=torch.int32, device=device)
        self.frames = 0
        self.st_k = torch.zeros((n_layers, self.n, d), dtype=dtype,
                                device=device)
        self.st_v = torch.zeros_like(self.st_k)
        self.graphs: Dict = {}

    def carried(self) -> Tuple[torch.Tensor, ...]:
        return (self.st_k, self.st_v)

    def start(self, k, v):
        """Frame 0's keys and values open both memories."""
        self.frames = 0
        self.st_k.copy_(k)
        self.st_v.copy_(v)
        self.remember()

    def remember(self):
        """The last frame's keys and values join the long-term memory."""
        trace.stage("pipeline.bank", self.lt_k.device)
        if self.frames == self.capacity:
            self._grow()
        lo, hi = self.frames * self.n, (self.frames + 1) * self.n
        self.lt_k[:, lo:hi].copy_(self.st_k)
        self.lt_v[:, lo:hi].copy_(self.st_v)
        self.frames += 1
        self.cu_k[1].fill_(hi)

    def _grow(self):
        rows = self.frames * self.n
        for name in ("lt_k", "lt_v"):
            old = getattr(self, name)
            new = old.new_zeros((old.shape[0], 2 * old.shape[1],
                                 old.shape[2]))
            new[:, :rows].copy_(old[:, :rows])
            setattr(self, name, new)
        self.capacity *= 2
        self.graphs.clear()


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


class _Draws:
    """The default k-means init scores (``ops.prng``), drawn on the
    evaluator's device a block of frames at a time — one hash over
    [frames, O, R] instead of one per frame — and sliced per step."""

    def __init__(self, n_obj: int, device):
        self.n_obj = n_obj
        self.device = device
        self.lo = 0
        self.table: Optional[torch.Tensor] = None     # [B, O, R]

    def take(self, frames: Sequence[int], n_rows: int) -> torch.Tensor:
        """[len(frames), O, n_rows] for consecutive frame indices."""
        f0, k = frames[0], len(frames)
        t = self.table
        if (t is None or not self.lo <= f0 <= f0 + k <= self.lo + t.shape[0]
                or n_rows > t.shape[2]):
            n = max(k, min(DRAW_BLOCK, DRAW_ELEMENTS // (self.n_obj * n_rows)))
            self.lo = f0
            t = self.table = kmeans_init_scores(range(f0, f0 + n), self.n_obj,
                                                n_rows, self.device)
        return t[f0 - self.lo:f0 - self.lo + k, :, :n_rows]


class _PrepView:
    """Frame prep on the loader's threads: the eval resize of each scale
    and, per scale group, the uint8 frame the step uploads
    (``sample["frames"]``)."""

    def __init__(self, dataset, cfg: Config, variants: Variants):
        self.dataset = dataset
        self.cfg = cfg
        self.variants = variants

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        cfg = self.cfg
        sample = self.dataset[i]
        sample["frames"] = self.variants.group_frames(eval_variants(
            sample["current_img"], cfg.TEST_MAX_SIZE, cfg.TEST_MIN_SIZE,
            cfg.TEST_FLIP, cfg.TEST_MULTISCALE))
        return sample


class _PrepGroupView:
    """``group`` consecutive frames per loader item (the JAX
    ``_EvalPrepGroupView``): prepared as ``_PrepView`` does, then stacked
    per scale into one uint8 block (pinned when it goes to a card) that
    the consumer uploads with one copy; a group whose frames differ in
    shape keeps them apart."""

    def __init__(self, dataset, cfg: Config, variants: Variants, group: int,
                 pin: bool):
        self.view = _PrepView(dataset, cfg, variants)
        self.group = group
        self.pin = pin

    def __len__(self):
        return -(-len(self.view) // self.group)

    def __getitem__(self, g):
        lo = g * self.group
        samples = [self.view[i]
                   for i in range(lo, min(lo + self.group, len(self.view)))]
        blocks = None
        if len({tuple(f.shape for f in s["frames"]) for s in samples}) == 1:
            blocks = []
            for j, f in enumerate(samples[0]["frames"]):
                block = torch.empty((len(samples),) + f.shape,
                                    dtype=torch.uint8, pin_memory=self.pin)
                block.numpy()[:] = np.stack([s["frames"][j] for s in samples])
                blocks.append(block)
        return samples, blocks


class Evaluator:
    # the model's config drives segment_frame; the evaluator prepares the
    # bank with its own — they must agree on these
    _MODEL_CFG_FIELDS = (
        "MATCHING_MAX_REF_PIXELS", "MATCHING_SEGMENTED_BANK",
        "MATCHING_OCCUPANCY_BANK", "MATCHING_DTYPE", "MODEL_FLOAT16_MATCHING",
        "TEST_GLOBAL_ATROUS_RATE", "TEST_LOCAL_ATROUS_RATE",
        "MODEL_MAX_OBJ_NUM", "MODEL_CLUSTER_NUM", "MODEL_KMEANS_ITERS",
        "MESH_MODEL_AXIS")

    def __init__(self, cfg: Config, model: AOCNet, device=None,
                 kmeans_scores: Optional[ScoreFn] = None,
                 devices: Optional[Sequence] = None):
        """``model`` is moved to ``device`` (CUDA unless "cpu") and the
        eval compute dtype in place.  ``kmeans_scores(frame_idx, n_obj,
        n_rows)`` optionally supplies each frame's ``[O, R]`` k-means
        init scores, ``R`` the largest bank of the variants (a smaller
        bank reads a prefix, as it does of the default draws).
        ``devices``: the devices the ensemble shards over or the matching
        rows split over (see the module's docstring); the JAX
        evaluator's ``jax.local_devices()``."""
        for f in self._MODEL_CFG_FIELDS:
            if getattr(model.cfg, f) != getattr(cfg, f):
                raise ValueError(f"Evaluator cfg.{f}={getattr(cfg, f)!r} but "
                                 f"the model was built with "
                                 f"{getattr(model.cfg, f)!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        configure_precision(cfg)
        self.dtype = compute_dtype(cfg, self.device)
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        self.mem_every = cfg.MEM_EVERY
        self.unc_ratio = cfg.UNC_RATIO
        self.variants = Variants.of(cfg)
        devs = [torch.device(d) for d in
                (local_devices(self.device) if devices is None else devices)]
        self.cp_devices = resolved_cp_devices(cfg, devs)
        self.ens_devices = None
        if (cfg.TEST_ENSEMBLE_SHARD and self.cp_devices is None
                and len(devs) > 1 and len(self.variants.flips) > 1):
            self.ens_devices = devs
        self.fused = cfg.TEST_FUSED_POSTPROCESS
        self.chunk_n = max(1, cfg.TEST_FRAME_CHUNK) if self.fused else 1
        if self.mem_every > 0:
            self.chunk_n = min(self.chunk_n, self.mem_every)
        if self.ens_devices is not None:
            self.chunk_n = 1
        self.kmeans_scores = kmeans_scores
        self._draws = _Draws(cfg.MODEL_MAX_OBJ_NUM, self.device)
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device)
        self._states: Dict[Tuple, _SeqState] = {}
        self._vecs: Dict[Tuple, torch.Tensor] = {}
        self._replicas: Dict[torch.device, AOCNet] = {}
        on_card = self.device.type == "cuda"
        self._graphs = on_card and all(
            d == self.device for d in self.cp_devices or ())
        self._pinned = _PinnedFrames() if on_card else None
        self._pool = torch.cuda.graph_pool_handle() if on_card else None
        self._family = _AOT if getattr(model, "kind", None) == "aot" else _AOC
        if self._family is _AOT and (len(self.variants.flips) > 1
                                     or self.cp_devices is not None):
            raise ValueError("AOT runs one variant on one device")
        self.captures = 0            # CUDA graphs captured
        self.replays = 0             # chunk graph replays
        self.frame_replays = 0       # one-frame graph replays
        self.decoded_channels = 0    # object channels decoded, × frames
        self._last_states: List[_SeqState] = []   # introspection

    def _mem_boundary(self, frame_idx: int) -> bool:
        return self.mem_every > 0 and frame_idx % self.mem_every == 0

    def _dev_vec(self, arr: np.ndarray, device=None) -> torch.Tensor:
        """``obj_valid``/``exist_mask`` on ``device`` (the evaluator's),
        uploaded once per distinct value."""
        device = self.device if device is None else device
        key = (arr.tobytes(), device)
        if key not in self._vecs:
            self._vecs[key] = torch.from_numpy(arr.copy()).to(device)
        return self._vecs[key]

    def _model_on(self, device) -> AOCNet:
        """The model on ``device``: the evaluator's own, or a replica of
        its parameters made at the first use."""
        if device == self.device:
            return self.model
        if device not in self._replicas:
            self._replicas[device] = copy.deepcopy(self.model).to(device)
        return self._replicas[device]

    def _ens_partitions(self) -> List[Tuple[Tuple[int, ...], int,
                                            torch.device]]:
        """The sharded ensemble's partitions, ``[(variants, scale group,
        device)]`` in a fixed order (so frame 0 and every later frame pin
        a variant to the same device): one variant per device when there
        are at least as many devices as variants (a flip twin then embeds
        its frame alone), else one scale group per device, round-robin
        over the devices — the JAX evaluator's mapping.  Unsharded: each
        group on the evaluator's device."""
        groups = self.variants.groups
        devs = self.ens_devices
        if devs is None:
            return [(m, g, self.device) for g, m in enumerate(groups)]
        if len(devs) >= len(self.variants.flips):
            parts = [((v,), g) for g, m in enumerate(groups) for v in m]
        else:
            parts = list((m, g) for g, m in enumerate(groups))
        return [(mem, g, devs[p % len(devs)])
                for p, (mem, g) in enumerate(parts)]

    def init_scores(self, frames: Sequence[int], n_rows: int) -> torch.Tensor:
        """The k-means init scores of consecutive ``frames`` → [K, O,
        n_rows] on the device (no rows for a model without k-means)."""
        if n_rows == 0:
            return torch.empty((len(frames), self.cfg.MODEL_MAX_OBJ_NUM, 0),
                               device=self.device)
        if self.kmeans_scores is None:
            return self._draws.take(frames, n_rows)
        o = self.cfg.MODEL_MAX_OBJ_NUM
        return torch.stack([torch.as_tensor(self.kmeans_scores(f, o, n_rows),
                                            dtype=torch.float32)
                            for f in frames]).to(self.device)

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

    def _upload_groups(self, items: List[Tuple]) -> Tuple[torch.Tensor, ...]:
        """Per scale group, the frames of ``items`` (each a tuple of group
        frames) as one fresh [K, H, W, 3] uint8 tensor on the device."""
        out = []
        for g in range(len(self.variants.groups)):
            x = torch.empty((len(items),) + tuple(items[0][g].shape),
                            dtype=torch.uint8, device=self.device)
            self._upload([it[g] for it in items], x)
            out.append(x)
        return tuple(out)

    def sum_order(self) -> List[Tuple[int, ...]]:
        """The order in which a step adds the variants' probabilities: each
        partition's in turn (``sharded_step``), or all of them in variant
        order (``chunk_step``)."""
        if self.ens_devices is None:
            return [tuple(range(len(self.variants.flips)))]
        return [mem for mem, _, _ in self._ens_partitions()]

    def _embed(self, frames: torch.Tensor, model: Optional[AOCNet] = None):
        """uint8 [K, H, W, 3] → (embeddings [K, h, w, C], low-level), by
        ``model`` (the evaluator's) on the frames' device."""
        dev = frames.device
        trace.stage("model.extract", dev)
        x = ((frames.float() / 255.0 - self._mean.to(dev))
             / self._std.to(dev))
        return (model or self.model).extract_feature(x.to(self.dtype))

    def _variant_frame(self, xs: Tuple[torch.Tensor, ...], v: int):
        """Variant ``v``'s frames from the uploaded group frames: its
        scale's, mirrored for a flip twin."""
        x = xs[self.variants.group_of(v)]
        return x.flip(2) if self.variants.flips[v] else x

    def _downscale(self, lab: torch.Tensor, v: int, st: _SeqState):
        """A full-size label map [H0, W0] at variant ``v``'s resolution and
        orientation (nearest)."""
        if self.variants.flips[v]:
            lab = lab.flip(1)
        return resize_nchw(lab, st.lab_hw, "nearest")

    def _encode(self, frames: torch.Tensor) -> List[torch.Tensor]:
        """AOT: uint8 [K, H, W, 3] → the encoder's taps."""
        trace.stage("model.extract", frames.device)
        x = ((frames.float() / 255.0 - self._mean) / self._std)
        return self.model.encode(x.permute(0, 3, 1, 2).to(self.dtype))

    def _start_aot(self, frames, gt: np.ndarray) -> List[_AOTState]:
        """AOT's frame 0: the reference pass on the ground truth writes
        both memories."""
        trace.stage("pipeline.upload", self.device)
        (x,) = self._upload_groups([frames])
        taps = self._encode(x)
        grid, lab_hw = tuple(taps[-1].shape[-2:]), tuple(x.shape[1:3])
        key = ("aot", grid, lab_hw, self.device)
        st = self._states.get(key)
        if st is None:
            st = self._states[key] = _AOTState(grid, lab_hw, self.dtype,
                                               self.device)
        trace.stage("pipeline.bank", self.device)
        lab = resize_nchw(torch.from_numpy(gt.astype(np.int64)).to(
            self.device), lab_hw, "nearest")
        id_emb = self._id_embed(lab)
        trace.stage("model.lstt", self.device)
        _, qs, us = self.model.lstt(taps[-1][0], id_emb=id_emb)
        trace.stage("pipeline.bank", self.device)
        st.start(*self.model.memory_kv(qs, us, id_emb))
        return [st]

    def _id_embed(self, lab: torch.Tensor) -> torch.Tensor:
        """AOT: a label map at the input size → its identity tokens."""
        o = self.cfg.MODEL_MAX_OBJ_NUM
        onehot = one_hot(lab, o, self.dtype).permute(2, 0, 1)[None]
        return self.model.id_embed(onehot)[0]

    def _start_aoc(self, frames, gt: np.ndarray) -> List[_SeqState]:
        """AOC-Net's frame 0: each variant's embedding and the ground truth
        (at the variant's resolution and orientation) open its bank."""
        trace.stage("pipeline.upload", self.device)
        xs = self._upload_groups([frames])
        lab = torch.from_numpy(gt.astype(np.int64)).to(self.device)
        pinned = {v: dev for mem, _, dev in self._ens_partitions()
                  for v in mem}
        states = []
        for v, flip in enumerate(self.variants.flips):
            dev = pinned[v]
            emb = self._embed(self._variant_frame(xs, v).to(dev),
                              self._model_on(dev))[0][0]
            trace.stage("pipeline.bank", dev)
            h, w, c = emb.shape
            st = self._states.get((v, h, w, c, dev))
            if st is None:
                st = self._states[(v, h, w, c, dev)] = _SeqState(
                    self.cfg, h, w, c, self.dtype, dev)
            lab_v = lab.to(dev)
            st.start(emb, resize_nchw(lab_v.flip(1) if flip else lab_v,
                                      (h, w), "nearest"))
            states.append(st)
        return states

    def _ensure_flat(self, st: _SeqState, ov_np: np.ndarray):
        """Recompact the bank when it or the object set changed, into the
        state's flat-bank tensors."""
        key = (st.version, ov_np.tobytes())
        if st.flat_key == key:
            return
        trace.stage("pipeline.bank", st.ref_lab.device)
        onehot = one_hot(st.ref_lab, self.cfg.MODEL_MAX_OBJ_NUM, self.dtype)
        onehot = onehot * self._dev_vec(ov_np, st.ref_lab.device).to(
            self.dtype)
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

    def _segment(self, st: _SeqState, emb, low, prev_emb, prev_lab, ov,
                 memory, scores, live, ref_onehot=None, model=None):
        """One variant's ``segment_frame`` from its state → (logits
        [O, h, w], decoder memory of ``live`` channels), by ``model``
        (the evaluator's).  ``scores`` [O, R'] is read as a prefix as long
        as the variant's bank."""
        o = self.cfg.MODEL_MAX_OBJ_NUM
        flat_emb, flat_lab, tile_obj = st.flat
        if ref_onehot is None:
            ref_onehot = one_hot(st.ref_lab, o, self.dtype)
        cp = {} if self.cp_devices is None else {"cp_devices": self.cp_devices}
        return (model or self.model).segment_frame(
            emb, low, st.ref_emb, ref_onehot, st.slot_valid, prev_emb,
            one_hot(prev_lab, o, self.dtype), ov, memory,
            scores[:, :flat_emb.shape[0]], flat_emb, flat_lab, tile_obj,
            live=live, **cp)

    def _probs(self, logits, ori_hw, v: int) -> torch.Tensor:
        """Logits → probabilities at the original size, orientation
        restored."""
        p = torch.softmax(resize_nchw(logits.float(), ori_hw, "bilinear"),
                          dim=0)
        return p.flip(2) if self.variants.flips[v] else p

    def _gate(self, probs, em, join=None):
        """(argmax, confident mask): pixels above ``UNC_RATIO`` entropy
        become 125; ``join`` [H0, W0], when given, is spliced into both."""
        pred = probs.argmax(dim=0)
        unc = shannon_entropy(probs, em)
        if join is not None:
            pred = torch.where(join == 0, pred, join)
        conf = torch.where(unc > self.unc_ratio,
                           torch.full_like(pred, UNCERTAIN_LABEL), pred)
        if join is not None:
            conf = torch.where(join == 0, conf, join)
        return pred, conf

    def chunk_step(self, io: ChunkIO, sts: List[_SeqState], ori_hw,
                   join: Optional[torch.Tensor] = None) -> None:
        """The K frames of ``io`` from the variants' states ``sts``: writes
        their uint8 masks into ``io.preds``, advances each state's
        ``prev_emb``, ``prev_lab`` and ``memory`` in place, and leaves the
        last frame's confident mask (at the variant's resolution) in its
        ``conf``.  ``join`` [H0, W0] is spliced into the mask and the
        confident mask (a one-frame step).  The JAX ``_step_fused_chunk``
        for one variant and ``_step_ensemble_chunk`` for several; what a
        CUDA graph of this function captures: the model family's step
        (``_chunk_step_aoc`` or ``_chunk_step_aot``)."""
        self._family.step(self, io, sts, ori_hw, join)

    def _chunk_step_aoc(self, io: ChunkIO, sts: List[_SeqState], ori_hw,
                        join: Optional[torch.Tensor] = None) -> None:
        """``chunk_step`` for AOC-Net."""
        o = self.cfg.MODEL_MAX_OBJ_NUM
        flips = self.variants.flips
        n_var = len(sts)
        k_n = io.frames[0].shape[0]
        embs, lows = [None] * n_var, [None] * n_var
        for g, members in enumerate(self.variants.groups):
            x = io.frames[g]
            if len(members) > 1 or flips[members[0]]:
                x = torch.cat([x.flip(2) if flips[v] else x for v in members])
            e, low = self._embed(x)
            for j, v in enumerate(members):
                embs[v] = e[j * k_n:(j + 1) * k_n]
                lows[v] = low[j * k_n:(j + 1) * k_n]
        prev_embs = [torch.cat([st.prev_emb[None], embs[v][:-1]])
                     for v, st in enumerate(sts)]
        ref_onehots = [one_hot(st.ref_lab, o, self.dtype) for st in sts]
        p_labs = [st.prev_lab for st in sts]
        mems = [st.memory for st in sts]
        for k in range(k_n):
            total = None
            for v in range(n_var):
                logits, mems[v] = self._segment(
                    sts[v], embs[v][k], lows[v][k], prev_embs[v][k],
                    p_labs[v], io.ov, mems[v], io.scores[k], io.live,
                    ref_onehots[v])
                trace.stage("pipeline.post", self.device)
                p = self._probs(logits, ori_hw, v)
                total = p if total is None else total + p
            if n_var > 1:
                total = total / n_var
            pred, conf = self._gate(total * io.em[:, None, None], io.em, join)
            p_labs = [self._downscale(pred, v, st) for v, st in enumerate(sts)]
            io.preds[k].copy_(pred)
        for v, st in enumerate(sts):
            st.carry(embs[v][-1], p_labs[v], mems[v])
            st.conf.copy_(self._downscale(conf, v, st))

    def _chunk_step_aot(self, io: ChunkIO, sts: List[_AOTState], ori_hw,
                        join: Optional[torch.Tensor] = None) -> None:
        """``chunk_step`` for AOT: per frame the blocks over the memory,
        the decoder, the mask, and its keys and values as the next
        frame's short-term memory; ``st.st_k``/``st_v`` end as the last
        frame's."""
        model, (st,) = self.model, sts
        taps = self._encode(io.frames[0])
        sk, sv = st.st_k, st.st_v
        lt = (st.lt_k, st.lt_v, st.cu_k)
        for k in range(io.frames[0].shape[0]):
            trace.stage("model.lstt", self.device)
            outs, qs, us = model.lstt(taps[-1][k], lt, (sk, sv))
            trace.stage("model.decode", self.device)
            logits = model.decode([t[k:k + 1] for t in taps], outs)
            trace.stage("pipeline.post", self.device)
            pred = (self._probs(logits, ori_hw, 0)
                    * io.em[:, None, None]).argmax(dim=0)
            if join is not None:
                pred = torch.where(join == 0, pred, join)
            io.preds[k].copy_(pred)
            trace.stage("pipeline.bank", self.device)
            sk, sv = model.memory_kv(qs, us, self._id_embed(
                self._downscale(pred, 0, st)))
        st.st_k.copy_(sk)
        st.st_v.copy_(sv)

    def _new_io(self, sts: List[_SeqState], shapes, ori_hw,
                live: Optional[int]) -> ChunkIO:
        """Static buffers of a chunk graph; ``shapes`` [K, H, W, 3] per
        scale group."""
        o, dev = self.cfg.MODEL_MAX_OBJ_NUM, self.device
        k_n = shapes[0][0]
        n_rows = max(st.score_rows for st in sts)
        return ChunkIO(
            tuple(torch.empty(sh, dtype=torch.uint8, device=dev)
                  for sh in shapes),
            torch.empty((k_n, o, n_rows), device=dev),
            torch.empty(o, device=dev), torch.empty(o, device=dev),
            torch.empty((k_n, *ori_hw), dtype=torch.uint8, device=dev), live)

    def _capture(self, io: ChunkIO, sts: List[_SeqState], ori_hw):
        """Capture ``chunk_step`` on ``sts`` as a CUDA graph.  A warm-up
        run on a side stream first (module loading, kernel attributes and
        cuDNN's choices happen outside capture); the state it advanced is
        put back.  A capture that fails raises."""
        carried = [t for st in sts for t in st.carried()]
        saved = [t.clone() for t in carried]
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.chunk_step(io, sts, ori_hw)
        cur.wait_stream(side)
        for t, s in zip(carried, saved):
            t.copy_(s)
        graph = torch.cuda.CUDAGraph()
        # no garbage collection while capturing: a collected evaluator's
        # graphs would be destroyed mid-capture, which invalidates it
        # (``torch.cuda.graph`` collects once before it begins)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                self.chunk_step(io, sts, ori_hw)
        finally:
            if collecting:
                gc.enable()
        self.captures += 1
        return graph

    def sharded_step(self, io: ChunkIO, sts: List[_SeqState], ori_hw,
                     join: Optional[torch.Tensor] = None) -> None:
        """``chunk_step`` of one frame with the variants partitioned over
        ``ens_devices`` (``_ens_partitions``): each partition embeds its
        variants' frames in one batch and sums their probabilities on its
        device; the sums meet on the first device, in partition order,
        for the mean, the gate and the mask; the mask goes back to each
        partition for its variants' next labels.  The JAX evaluator's
        ``run_ens_frame_sharded``."""
        o_hw = tuple(ori_hw)
        flips = self.variants.flips
        primary = self.ens_devices[0]
        total, updates = None, []
        for members, g, dev in self._ens_partitions():
            model = self._model_on(dev)
            x = io.frames[g].to(dev)
            e, low = self._embed(torch.cat([x.flip(2) if flips[v] else x
                                            for v in members]), model)
            ov, scores = io.ov.to(dev), io.scores[0].to(dev)
            part = None
            for j, v in enumerate(members):
                st = sts[v]
                logits, mem = self._segment(st, e[j], low[j], st.prev_emb,
                                            st.prev_lab, ov, st.memory,
                                            scores, io.live, model=model)
                trace.stage("pipeline.post", dev)
                p = self._probs(logits, o_hw, v)
                part = p if part is None else part + p
                updates.append((v, e[j], mem))
            part = part.to(primary)
            total = part if total is None else total + part
        em = io.em.to(primary)
        pred, conf = self._gate(total / len(sts) * em[:, None, None], em,
                                None if join is None else join.to(primary))
        io.preds[0].copy_(pred)
        for v, emb, mem in updates:
            st = sts[v]
            dev = st.prev_emb.device
            st.carry(emb, self._downscale(pred.to(dev), v, st), mem)
            st.conf.copy_(self._downscale(conf.to(dev), v, st))

    def run_chunk(self, sts: List[_SeqState], io: ChunkIO, ori_hw,
                  join: Optional[torch.Tensor] = None) -> None:
        """One step over the frames of ``io``: for a multi-frame chunk on a
        card (for AOT, a single frame too) a replay of the graph that owns
        ``io`` (captured at its first use), else ``chunk_step`` eagerly; a
        frame of the sharded ensemble through ``sharded_step``."""
        if self.ens_devices is not None:
            self.sharded_step(io, sts, ori_hw, join)
            return
        if not self._graphed(sts, io.frames[0].shape[0], join):
            self.chunk_step(io, sts, ori_hw, join)
            return
        g = sts[0].graphs[(tuple(tuple(x.shape) for x in io.frames),
                           tuple(ori_hw), io.live)]
        if g.io is not io or join is not None:
            raise ValueError("a chunk graph replays its own buffers and "
                             "joins no label")
        if g.graph is None:
            g.graph = self._capture(io, sts, ori_hw)
        g.graph.replay()
        if io.frames[0].shape[0] > 1:
            self.replays += 1
        else:
            self.frame_replays += 1

    def _graphed(self, sts, k_n: int, join) -> bool:
        """Whether a step of ``k_n`` frames replays a graph: a chunk on a
        card, a single frame where the states' ``one_frame_graph`` says
        so, never a join."""
        return (self._graphs and join is None
                and (k_n > 1 or sts[0].one_frame_graph))

    def _step(self, sts: List[_SeqState], buf, ctx,
              join: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Frames ``buf`` (``(index, name, group frames)``) as one step →
        their masks [K, H0, W0] uint8 (a multi-frame chunk's is a graph's
        output buffer: copy before the next step).  A step that replays a
        graph (``_graphed``) fills the static buffers of its graph (the
        states' set of graphs, keyed by the frame shapes, the original
        size and the live channels ``ctx["live"]``, lives on the first
        variant's state); anything else runs on fresh ones."""
        trace.stage("pipeline.upload", self.device)
        items = [p for _, _, p in buf]
        fs = [f for f, _, _ in buf]
        ori_hw, live = ctx["ori_hw"], ctx["live"]
        scores = self.init_scores(fs, max(st.score_rows for st in sts))
        ov, em = self._dev_vec(ctx["ov"]), self._dev_vec(ctx["em"])
        graphed = self._graphed(sts, len(buf), join)
        if not graphed:
            io = ChunkIO(self._upload_groups(items), scores, ov, em,
                         torch.empty((len(buf), *ori_hw), dtype=torch.uint8,
                                     device=self.device), live)
        else:
            shapes = tuple((len(buf), *x.shape) for x in items[0])
            key = (shapes, tuple(ori_hw), live)
            if key not in sts[0].graphs:
                sts[0].graphs[key] = _ChunkGraph(
                    self._new_io(sts, shapes, ori_hw, live))
            io = sts[0].graphs[key].io
            for g, x in enumerate(io.frames):
                self._upload([it[g] for it in items], x)
            for dst, src in zip(io[1:4], (scores, ov, em)):
                dst.copy_(src)
        self.run_chunk(sts, io, ori_hw, join)
        if live is not None:
            self.decoded_channels += len(buf) * len(sts) * live
        if graphed and len(buf) == 1:
            # a single frame waits in the D2H batcher past the next replay
            return io.preds.clone()
        return io.preds

    def _grouped(self, groups):
        """Samples of a grouped loader, each group's frames uploaded as one
        block per scale (a group of mixed shapes frame by frame)."""
        for samples, blocks in groups:
            if blocks is not None:
                trace.stage("pipeline.upload", self.device)
                dev = [b.to(self.device, non_blocking=True) for b in blocks]
                for j, s in enumerate(samples):
                    s["frames"] = tuple(d[j] for d in dev)
            yield from samples

    @torch.no_grad()
    def evaluate_sequence(self, seq, save_dir: Optional[str] = None,
                          frame_callback: Optional[Callable[[int], None]] = None
                          ) -> Dict:
        """Stream one video.  Returns ``{"results": {frame name: uint8
        mask}, "fps", "frames", "time", "timing"}``; frame 0 (the given
        ground truth) has no result.  ``time`` is the wall-clock seconds
        from the first frame's read to the end of the drain (the
        ``pipeline.video`` span) and ``fps`` the frames over it;
        ``timing`` holds the video's totals of its spans
        (``utils.trace``): ``loader_wait`` (``data.wait``), ``flat``
        (``pipeline.flat``), ``step_dispatch`` (``pipeline.step.*``),
        ``flush`` (``pipeline.flush``) and ``drain``
        (``pipeline.drain``).  ``frame_callback(f)`` runs once per frame,
        in order, after the work of the step that holds frame ``f`` is
        issued."""
        cfg = self.cfg
        o = cfg.MODEL_MAX_OBJ_NUM
        workers = max(1, cfg.TEST_WORKERS)
        group = max(1, cfg.TEST_H2D_GROUP)
        if group > 1:
            loader = self._grouped(PrefetchLoader(
                _PrepGroupView(seq, cfg, self.variants, group,
                               self.device.type == "cuda"),
                num_workers=workers, prefetch=2))
        else:
            loader = PrefetchLoader(_PrepView(seq, cfg, self.variants),
                                    num_workers=workers, prefetch=3)
        saver = MaskSaver(save_dir, remap=getattr(seq, "label_backward", None))
        timing = {"loader_wait": 0.0, "flat": 0.0, "step_dispatch": 0.0,
                  "flush": 0.0, "drain": 0.0}
        d2h = D2HBatcher(saver, max(group, cfg.TEST_D2H_GROUP), timing)
        callback = frame_callback or (lambda f: None)
        states: List[_SeqState] = []
        live: Optional[int] = None

        def ensure_flat(ov_np):
            with trace.span("pipeline.flat", timing, "flat"):
                for st in states:
                    self._family.prepare(self, st, ov_np)

        def add_refs():
            for st in states:
                st.remember()

        def run_full(buf, ctx):
            with trace.span("pipeline.step.full", timing, "step_dispatch"):
                ensure_flat(ctx["ov"])
                preds = self._step(states, buf, ctx)
                if self._mem_boundary(buf[-1][0]):
                    add_refs()
                d2h.append(tuple(n for _, n, _ in buf), preds)
                for f, _, _ in buf:
                    callback(f)

        def run_ragged(buf, ctx):
            for i, item in enumerate(buf):
                with trace.span("pipeline.step.ragged", timing,
                                "step_dispatch"):
                    if i == 0:
                        ensure_flat(ctx["ov"])
                    preds = self._step(states, [item], ctx)
                    if self._mem_boundary(item[0]):
                        add_refs()
                    d2h.append((item[1],), preds)
                    callback(item[0])

        chunker = Chunker(self.chunk_n, run_full, run_ragged,
                          self._mem_boundary, d2h)
        label_all: List[int] = []
        n_frames = 0
        it = iter(loader)
        with trace.span("pipeline.video") as video:
            for frame_idx in range(len(seq)):
                with trace.span("data.wait", timing, "loader_wait"):
                    sample = next(it)
                meta = sample["meta"]
                ori_hw = (meta["height"], meta["width"])
                gt = sample.get("current_label")
                gt_all = sample.get("current_label_all")
                if frame_idx == 0 and gt is None:
                    raise ValueError(f"sequence {meta.get('seq_name', '?')}: "
                                     "the first frame has no 'current_label'")
                for lab in (gt, gt_all):
                    if lab is not None:
                        for lid in np.unique(lab).tolist():
                            if lid != 255 and lid not in label_all:
                                if lid >= o:
                                    raise ValueError(
                                        f"sequence "
                                        f"{meta.get('seq_name', '?')}: object "
                                        f"id {lid} >= MODEL_MAX_OBJ_NUM={o}")
                                label_all.append(lid)
                frames = sample["frames"]
                obj_num = int(meta["obj_num"])
                if frame_idx == 0:
                    live = self._family.live(self, seq, obj_num)
                    with trace.span("pipeline.start"):
                        states = self._family.start(self, frames, gt)
                    callback(0)
                    continue
                if live is not None and obj_num >= live:
                    live = o    # grown past the count: all channels on
                ov_np = (np.arange(o) <= obj_num).astype(np.float32)
                em_np = np.zeros(o, np.float32)
                em_np[label_all] = 1.0
                n_frames += 1
                if gt is None:
                    chunker.push(frame_idx, meta["current_name"], frames,
                                 tuple(tuple(f.shape[:2]) for f in frames),
                                 ov_np, em_np, ori_hw, {"live": live})
                    continue
                # a join frame runs alone, after the frames buffered before
                # it
                chunker.flush()
                with trace.span("pipeline.step.join", timing,
                                "step_dispatch"):
                    ensure_flat(ov_np)
                    trace.stage("pipeline.upload", self.device)
                    join = torch.from_numpy(gt.astype(np.int64)).to(
                        self.device)
                    ctx = {"ov": ov_np, "em": em_np, "ori_hw": ori_hw,
                           "live": live}
                    item = (frame_idx, meta["current_name"], frames)
                    preds = self._step(states, [item], ctx, join)
                    add_refs()
                    d2h.append((item[1],), preds)
                callback(frame_idx)
                d2h.maybe_flush()
            with trace.span("pipeline.drain", timing, "drain"):
                chunker.flush()
                d2h.flush()
                results = saver.drain()
        self._last_states = states
        return {"results": results, "frames": n_frames, "time": video.seconds,
                "fps": n_frames / max(video.seconds, 1e-6), "timing": timing}

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


def live_channels(seq, obj_num: int, n_obj: int) -> int:
    """The object channels AOC-Net decodes in a video, the background
    included: ``1 + max(seq.obj_nums)`` where the sequence lists its
    frames' object counts up front (``data.VOSTest``'s sequences), else
    ``1 +`` frame 0's ``obj_num``."""
    nums = getattr(seq, "obj_nums", None)
    return min(n_obj, 1 + int(max(nums) if nums else obj_num))


class _Family(NamedTuple):
    """A model family's part of the evaluator: its frame 0 (→ its
    states), the preparation of a state before a step, its chunk step,
    and the object channels its steps decode in a video (``(evaluator,
    sequence, frame 0's obj_num)`` → a count, or None: the family's own
    step over all of them), each called with the evaluator first."""
    start: Callable
    prepare: Callable
    step: Callable
    live: Callable


_AOC = _Family(Evaluator._start_aoc, Evaluator._ensure_flat,
               Evaluator._chunk_step_aoc,
               lambda ev, seq, n: live_channels(seq, n,
                                                ev.cfg.MODEL_MAX_OBJ_NUM))
_AOT = _Family(Evaluator._start_aot, lambda ev, st, ov_np: None,  # no bank
               Evaluator._chunk_step_aot, lambda ev, seq, n: None)
