"""Device-mesh parallelism: frame batches and tile-row slabs over slots.

Counterpart of gpu_video_codec_tpu/parallel/mesh.py.  Every tile is
independent (the reference's one CUDA thread per tile, gpu.cu:540-545), so
distribution is pure data parallelism with no exchange between devices:

  * axis "data":    frames of a batch / concurrent streams across slots
  * axis "spatial": tile-row slabs of each frame across slots (slabs are
                    tile-aligned and exact; no halo is ever needed)

A mesh is an (n_data, n_spatial) grid of torch devices, its SLOTS.  A
device may appear more than once: each slot has its own CUDA graphs (and,
in MultiStreamDeblocker, its own CUDA stream), so a mesh that lists
cuda:0 k times runs k slots on one card, and a mesh of repeated "cpu"
slots runs the same code on the CPU, where the kernels' wrappers take
their plain versions.

Where the JAX package shards with shard_map, a slot here works on views of
the caller's tensors, in place, when it lives on their device; a slot on
another device gets a copy of its part and writes the result back.  Where
the JAX package pads the tile grid with no-op tiles to a multiple of the
spatial axis, slabs here are a ceiling split of the tile rows (the last
ones shorter or empty); where it pads a frame batch, chunks are uneven
(some slots idle when there are fewer frames than slots).  Both give the
same bytes.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

from ..models.streaming import _packed_steps
from ..ops.chain import tile_chain
from ..ops.cuda_kernel import BLOCK_BX, CHROMA_BLOCK_BX, SAMPLE_DTYPES, packed_grids
from ..ops.tables import SAMPLE_BLOCK_SIZE as _B
from ..ops.tables import check_bit_depth, packed_rows
from ..utils.graphs import CapturedStep, GraphCache, graphed, tensor_key
from ..utils.tiles import split_covered_data
from ..utils.tracing import RECORDER, stamp

# the _jit wrappers' graphs, one per (slot, operands, options); a slot's
# graph has a pool of its own, never shared with another slot's
_GRAPHS = GraphCache(maxsize=16)

BACKENDS = ("cuda", "torch")


class Mesh:
    """An (n_data, n_spatial) grid of torch device slots.

    devices: numpy object array of torch.device, shape (n_data, n_spatial);
    shape: {"data": n_data, "spatial": n_spatial}; size: the slot count.
    Slots are numbered in row-major order (data-major), which is the order
    frames are assigned to them."""

    def __init__(self, devices):
        arr = np.empty((len(devices), len(devices[0])), dtype=object)
        for d, row in enumerate(devices):
            for s, dev in enumerate(row):
                arr[d, s] = dev
        self.devices = arr
        self.shape = {"data": arr.shape[0], "spatial": arr.shape[1]}
        self.size = arr.size
        self._streams: dict[int, torch.cuda.Stream] = {}

    def device(self, index: int) -> torch.device:
        """The device of slot `index` (row-major)."""
        return self.devices.flat[index]

    def stream(self, index: int):
        """Slot `index`'s own CUDA stream (made at first use)."""
        if index not in self._streams:
            self._streams[index] = torch.cuda.Stream(self.device(index))
        return self._streams[index]


def _device(dev) -> torch.device:
    d = torch.device(dev)
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"mesh devices must be CUDA or CPU devices, got {d}")
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {d} requested but CUDA is not available")
        if d.index is None:  # tensors report their index: compare like with like
            d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_data: int, n_spatial: int, devices=None) -> Mesh:
    """Build a ("data", "spatial") mesh from the first n_data*n_spatial
    devices: by default the CUDA devices cuda:0 .. cuda:{count-1} (raises
    where CUDA is not available: nothing falls back to the CPU); an
    explicit list may repeat a device, e.g. ["cpu"] * 8 or [cuda:0] * 2."""
    if n_data < 1 or n_spatial < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({n_data}, {n_spatial})")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass devices= (e.g. "
                               "['cpu'] * n) to build a mesh of CPU slots")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    need = n_data * n_spatial
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    devs = [_device(d) for d in devices[:need]]
    return Mesh([devs[d * n_spatial : (d + 1) * n_spatial] for d in range(n_data)])


def default_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Split n devices into (data, spatial): largest power-of-two data axis
    that still leaves >= 2-way spatial sharding when possible."""
    if n_devices <= 1:
        return 1, 1
    n_data = 2 ** int(math.log2(n_devices) // 2) if (n_devices & (n_devices - 1)) == 0 else 1
    while n_devices % n_data:
        n_data //= 2
    return n_data, n_devices // n_data


def _ceil_split(n: int, parts: int) -> list[tuple[int, int]]:
    """[lo, hi) of `parts` contiguous chunks of ceil(n / parts) items each,
    the last ones shorter or empty."""
    c = -(-n // parts)
    return [(min(i * c, n), min((i + 1) * c, n)) for i in range(parts)]


def packed_batch_sharding(mesh: Mesh, n_frames: int) -> list[tuple[int, int]]:
    """The frames [lo, hi) of a packed batch that each slot filters, in
    slot order: contiguous chunks of ceil(n_frames / mesh.size) frames over
    all slots.  Every slot gets the same number of frames exactly when
    the slot count divides the frame count (n_frames % mesh.size == 0);
    otherwise the last chunks are shorter, and with fewer frames than
    slots the last slots idle."""
    return _ceil_split(n_frames, mesh.size)


def _placed(maps, device) -> tuple:
    """The four BS maps as contiguous uint8 tensors on `device`: the given
    tensors themselves where they already are, else copies."""
    out = []
    for m in maps:
        t = m if isinstance(m, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(m))
        if t.device != device or t.dtype != torch.uint8 or not t.is_contiguous():
            t = t.to(device=device, dtype=torch.uint8).clone(memory_format=torch.contiguous_format)
        out.append(t)
    return tuple(out)


def _local(view, device):
    """A slot's operand: the caller's view where it lives on the slot's
    device, else a copy there (written back by _home)."""
    return view if view.device == device else view.to(device)


def _home(view, local) -> None:
    if local is not view:
        view.copy_(local)


def on_device(device):
    """The context a slot's work runs in: its CUDA device made current (a
    graph replays on the current device's stream, and the kernels'
    launchers switch the thread's device), the caller's restored after;
    nothing for a CPU slot."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _run(mesh: Mesh, index: int, fn, operands: tuple, static: tuple, graph: bool,
         stamps: list | None = None) -> None:
    """fn(*operands), in place, on slot `index`: eagerly, or (graph=True)
    as ONE replay of the slot's CUDA graph of it, captured at the first
    call on these operands, on the caller's current stream of the slot's
    device, so the call is ordered like any other work of that stream.
    Slots on different cards run at once; slots on one card run in turn.
    A replay appends to `stamps`, where it is given, the five stamps of its
    spans mesh.fork (the slot's device made current), graphs.launch and
    mesh.join (the caller's device restored;
    utils/tracing.Recorder.end_call)."""
    if stamps is not None:
        fork = stamp()
    dev = mesh.device(index)
    with on_device(dev):
        if not graph:
            fn(*operands)
            return
        if stamps is not None:
            forked = stamp()
        key = (index, tensor_key(*operands), *static)
        step = _GRAPHS.get(key, lambda: CapturedStep(fn, operands))
        if stamps is None:
            step.replay()
        else:
            launch, launched = step.timed_replay()
    if stamps is not None:
        stamps += (fork, forked, launch, launched, stamp())


# -- extended planes: frames over "data", tile-row slabs over "spatial" ---------

def _slab_deblock(chroma: bool, beta: int, tc: int, backend: str):
    """fn(*slabs, *maps): the slabs (k, 8r, W) of one plane, or of U and V
    as one launch, through the chain (ops/chain.tile_chain, pad 0) with the
    slab's rows of the four maps, back into the slabs, in place."""
    def deblock(*operands):
        slabs = operands[:-4]
        tile_chain(slabs, operands[-4:], beta, tc, pad=0, chroma=chroma, backend=backend,
                   out=slabs)
    return deblock


def _covered_core(plane, name: str):
    """The tile-swept (N, 8*ncby, 8*ncbx) view of a batch of extended
    planes (quirk Q9, utils/tiles.split_covered_data): a reshape of each
    plane's bytes, so the plane must be contiguous within itself."""
    if plane.stride(-1) != 1 or plane.stride(-2) != plane.shape[-1]:
        raise ValueError(f"{name} planes must be contiguous (row stride = width), got "
                         f"strides {plane.stride()}")
    core, _ = split_covered_data(plane)
    return core


def _batch_sharded(mesh, y_batch, u_batch, v_batch, luma_maps, chroma_maps, beta, tc,
                   luma_only, backend, graphs: bool):
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    n_data, n_sp = mesh.shape["data"], mesh.shape["spatial"]
    n = y_batch.shape[0]
    if n % n_data:
        raise ValueError(f"batch {n} not divisible by data axis {n_data}")
    beta, tc = int(beta), int(tc)
    planes = [("luma", False, (y_batch,), luma_maps)]
    if not luma_only:
        planes.append(("chroma", True, (_covered_core(u_batch, "u"),
                                        _covered_core(v_batch, "v")), chroma_maps))
    chunk = n // n_data
    for index in range(mesh.size):
        dev = mesh.device(index)
        d, s = divmod(index, n_sp)
        f0, f1 = d * chunk, (d + 1) * chunk
        for name, chroma, xs, maps in planes:
            by = xs[0].shape[-2] // _B
            r0, r1 = _ceil_split(by, n_sp)[s]
            if r0 == r1 or f0 == f1:
                continue
            views = [x[f0:f1, _B * r0 : _B * r1] for x in xs]
            local = [_local(v, dev) for v in views]
            placed = _placed(maps, dev)
            slab_maps = tuple(m[r0:r1] for m in placed)  # row slices: contiguous views
            fn = _slab_deblock(chroma, beta, tc, backend)
            on_card = (graphs and graphed(backend, dev)
                       and all(loc is v for loc, v in zip(local, views))
                       and all(p is m for p, m in zip(placed, maps)))
            _run(mesh, index, fn, (*local, *slab_maps), (name, beta, tc, backend), on_card)
            for v, loc in zip(views, local):
                _home(v, loc)
    return y_batch, u_batch, v_batch


def deblock_batch_sharded(mesh: Mesh, y_batch, u_batch, v_batch, luma_maps, chroma_maps,
                          beta, tc, luma_only: bool = False, backend: str = "cuda"):
    """Deblock a batch of frames over a ("data", "spatial") mesh, IN PLACE.

    y_batch: (N, Hext, Wext) uint8 tensor of extended planes; u/v: (N,
    cHext, cWext), each plane contiguous.  N must divide by the data axis;
    frames go over "data" in equal chunks and tile-row slabs over
    "spatial", a ceiling split of the tile rows (uneven where they do not
    divide).  Each slot runs, per slab of its frames: T2 (pad 0), K1 with
    the slab's rows of the maps, T3 back into the slab (luma); the same for
    U and V together through the tile-swept flat view (Q9), whose
    remainder is never touched.  luma_maps/chroma_maps: four (By, Bx) and
    four (cBy, cBx) maps (numpy or tensors).  backend "cuda" (the kernels)
    or "torch" (their plain versions).  Returns (y_batch, u_batch, v_batch), filtered: the JAX
    package's arrays are immutable, so it returns new ones."""
    return _batch_sharded(mesh, y_batch, u_batch, v_batch, luma_maps, chroma_maps, beta, tc,
                          luma_only, backend, graphs=False)


def deblock_batch_sharded_jit(mesh: Mesh, *args, luma_only: bool = False,
                              backend: str = "cuda"):
    """deblock_batch_sharded with each slot's work as ONE CUDA graph replay
    on the caller's current stream of the slot's device (utils/graphs.py;
    _run), captured at the first call on the same tensors: with the cuda
    backend, on a CUDA slot that holds the planes and whose maps are the
    given tensors on its device (the graph reads them by address; rewrite
    them in place to change BS).  Every other slot, and every CPU slot,
    runs the eager function."""
    return _batch_sharded(mesh, *args, luma_only=luma_only, backend=backend, graphs=True)


# -- packed YV12 batches: whole frames over every slot ----------------------------

@functools.lru_cache(maxsize=64)
def _frame_tiles(w: int, h: int, chroma_format: str, luma_only: bool) -> tuple[int, int]:
    """The luma and the chroma (U and V) tiles of one frame's packed step."""
    (by, bx), (cby, cbx) = packed_grids(w, h, chroma_format)
    return by * bx, 0 if luma_only else 2 * cby * cbx


def _packed_sharded(mesh, buf, luma_maps, chroma_maps, beta, tc, w, h, luma_only, backend,
                    luma_block, chroma_block, graphs: bool, bit_depth, chroma_format):
    stamps = RECORDER.start_call()  # the call's stamps where it is recorded, else None
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    rows = packed_rows(h, chroma_format)  # luma, U and V; raises outside the formats
    if (buf.dim() != 3 or tuple(buf.shape[1:]) != (rows, w)
            or buf.dtype != SAMPLE_DTYPES.get(bit_depth)):
        dtype = SAMPLE_DTYPES[check_bit_depth(bit_depth)]  # raises outside (8, 10)
        raise ValueError(f"buf must be a {dtype} (N, {rows}, {w}) packed batch at "
                         f"bit_depth {bit_depth} and chroma_format {chroma_format}, got "
                         f"{tuple(buf.shape)} {buf.dtype}")
    beta, tc = int(beta), int(tc)
    luma, chroma = _frame_tiles(w, h, chroma_format, bool(luma_only))
    RECORDER.add_tiles(buf.shape[0] * luma, buf.shape[0] * chroma)
    # the graph key holds the bit depth through the buffer's dtype (tensor_key)
    static = (beta, tc, w, h, bool(luma_only), backend, int(luma_block), int(chroma_block))
    for index, (lo, hi) in enumerate(packed_batch_sharding(mesh, buf.shape[0])):
        if lo == hi:
            continue
        dev = mesh.device(index)
        view = buf[lo:hi]
        local = _local(view, dev)
        lm, cm = _placed(luma_maps, dev), _placed(chroma_maps, dev)
        on_card = (graphs and graphed(backend, dev) and local is view
                   and all(p is m for p, m in zip((*lm, *cm), (*luma_maps, *chroma_maps))))
        _run(mesh, index, _packed_steps(1, *static, bit_depth, chroma_format),
             (local, *lm, *cm), ("packed", *static, chroma_format), on_card, stamps)
        _home(view, local)
    if stamps is not None:
        RECORDER.end_call(stamps)
    return buf


def deblock_packed_batch_sharded(mesh: Mesh, buf, luma_maps, chroma_maps, beta, tc, *, w, h,
                                 luma_only=False, backend="cuda", luma_block=BLOCK_BX,
                                 chroma_block=CHROMA_BLOCK_BX, bit_depth=8,
                                 chroma_format="4:2:0"):
    """Filter a packed YV12 batch (N, 3h/2, w) uint8 IN PLACE (or a batch of
    another bit depth or chroma format, below); returns buf.

    Frames go over all slots in contiguous chunks (packed_batch_sharding).
    A slot with k frames runs ONE batched packed step on its chunk (models/
    streaming._deblock_yv12_packed_impl with a leading frame axis): one K2
    launch on the k frames' planes in place, where K2's guard takes the
    width and the buffer (ops/cuda_kernel.packed_fits); elsewhere T2 on the
    luma rows of the k frames (batch stride 3h/2*w), K1 on (k, 8, 8, By,
    Bx) with one shared map, T3 back into the rows; T2 on the U+V rows
    viewed as (k, 2, h/2, w/2), K1c on (2k, 8, 8, cBy, cBx), T3 back (on
    sheared geometries, Q9, T2/T3's flat view with the flat tails in a
    buffer of their own).  No layout copy outside the kernels.
    luma_maps/chroma_maps: the four (By, Bx) and four (cBy, cBx) segment
    gate maps (utils/bs; chroma gated with the luma tile counts, Q2).
    luma_block/chroma_block: K1/K1c's tiles per block, so the chain's only.
    bit_depth: 8 (HEVC Main), or 10 (Main 10): buf an int16 batch of
    samples in [0, 1023] (the 16-bit words of yuv420p10le planes), beta and
    tc still the tables' beta' and tc' at the QP, which the step scales by
    4, every filtered sample clipped to [0, 1023] (H.265 8.7.2.5).  On a
    CUDA slot a 10-bit chunk runs K2-10, one launch, where packed_fits
    holds (w % 16 == 0 and 16-byte aligned frames); elsewhere it raises
    ValueError (there is no 10-bit chain).  A CPU slot takes the plain
    version at any width.  A buffer of the other bit depth's dtype, or a
    bit_depth outside (8, 10), raises ValueError.
    chroma_format: "4:2:0" (the default), or "4:2:2" (HEVC's format range
    extensions, e.g. Main 4:2:2 10): buf (N, 2h, w), luma then U and V of
    (h, w/2) each, chroma_maps the (h/8 + 1, w/16 + 1) maps of those
    planes (looked up at the chroma width w/2 and gated by the luma tile
    counts, as at 4:2:0).  On a CUDA slot a 4:2:2 chunk runs K2 or K2-10,
    one launch, where packed_fits holds, and raises ValueError elsewhere
    (there is no 4:2:2 chain); a CPU slot takes the plain version at any
    width.  "4:4:4" (Main 4:4:4, Main 4:4:4 10): buf (N, 3h, w), luma then
    U and V of (h, w) each, chroma_maps the (h/8 + 1, w/8 + 1) maps of
    those planes (looked up at the chroma width w and gated by the luma
    tile counts, the planes' own); on a CUDA slot a 4:4:4 chunk runs K2 or
    K2-10, one launch, where packed_fits holds (w % 16 == 0 at 8 bits,
    w % 8 == 0 at 10, and 16-byte aligned frames), and raises ValueError
    elsewhere (there is no 4:4:4 chain); a CPU slot takes the plain version
    at any width.  Any other format, or a buffer of another format's rows,
    raises ValueError.
    Each call adds its frames' tiles to the counters packed.luma_tiles and
    packed.chroma_tiles (utils/tracing.RECORDER)."""
    return _packed_sharded(mesh, buf, luma_maps, chroma_maps, beta, tc, w, h, luma_only,
                           backend, luma_block, chroma_block, graphs=False, bit_depth=bit_depth,
                           chroma_format=chroma_format)


def deblock_packed_batch_sharded_jit(mesh: Mesh, buf, luma_maps, chroma_maps, beta, tc, *,
                                     w, h, luma_only=False, backend="cuda",
                                     luma_block=BLOCK_BX, chroma_block=CHROMA_BLOCK_BX,
                                     bit_depth=8, chroma_format="4:2:0"):
    """deblock_packed_batch_sharded with each slot's batched step as ONE
    CUDA graph replay on the caller's current stream of the slot's device
    (_run), captured at the first call on the same buffer and maps (cuda
    backend, a CUDA slot that holds the buffer, the maps as tensors on its
    device); elsewhere eager.  At bit_depth 10 the replay is one K2-10
    launch (LAUNCHES["packed10"]; "packed10_422" at chroma_format
    "4:2:2" and "packed10_444" at "4:4:4", the format being part of the
    graph's key; "packed", "packed_422" and "packed_444" at 8 bits)."""
    return _packed_sharded(mesh, buf, luma_maps, chroma_maps, beta, tc, w, h, luma_only,
                           backend, luma_block, chroma_block, graphs=True, bit_depth=bit_depth,
                           chroma_format=chroma_format)


__all__ = [
    "Mesh", "make_mesh", "default_mesh_shape", "packed_batch_sharding",
    "deblock_batch_sharded", "deblock_batch_sharded_jit",
    "deblock_packed_batch_sharded", "deblock_packed_batch_sharded_jit",
]
