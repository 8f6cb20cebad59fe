"""K2, the packed YV12 step as one kernel on the frames' planes, of the
PyTorch port (ops/cuda_kernel.deblock_packed_cuda, its plain version
ops/deblock.deblock_packed_plain, its guard packed_fits).

K2 runs K1's quad (csrc/deblock_quad.cuh) on blocks of 16 shifted 8x8 tiles
of one tile row of one plane, staged by the tensor memory accelerator
straight from the picture, where T2 -> K1 -> T3 and T2 -> K1c -> T3 ran
before.  Here on the CPU:
  - the wrapper (its plain version) equals the torch backend's packed step
    and golden, at 64x48, CIF 352x288 and 128x72 (h % 16 == 8, Q2 as at
    1080p), batches of 1 and 3 frames and none, in place and not, full and
    luma_only;
  - the g++ build of the kernel (csrc/host_shim.cpp, gvct_host_deblock_packed)
    runs its grid block by block, each block's 64 threads one after another
    between the kernel's exchange points, its boxes staged as the TMA would
    stage them (zero outside the plane, no store there), and equals the
    plain version on the same cases;
  - the guard's decision over a table of geometries and alignments, and the
    wrapper's operand checks.
  - the lanes' reads of the box: each reads its own words, and no read of a
    warp is more than two-way in a bank (gvct_host_packed_reads); and the host
    build == the plain version on blocks that end mid-row, at the picture's
    borders, with BS all 0 and all 2 and on uniform noise, in place and
    into a separate output;
  - the host build on views 16 bytes past a 256-byte boundary with guard
    bytes before and after them: == the plain version, no guard byte
    written.
Tests marked `cuda` launch the kernel on the card, against the chain it
replaces, at both benchmark cells' shapes, on those edge cases (and against
the plain version), on the guarded views (the box loads' L2 promotion
fetches whole lines past the planes' ends), through a graph replay and the
mesh, and skip without
a card; nothing here imports JAX, so they run on the
card (`python -m pytest tests/test_torch_packed_kernel.py -m cuda`).  Every
comparison is byte-equal."""

import ctypes
import functools
from collections import Counter

import numpy as np
import pytest
import torch

from gpu_video_codec_tpu_torch.models import streaming as st
from gpu_video_codec_tpu_torch.models.golden import deblock_frame_golden
from gpu_video_codec_tpu_torch.models.streaming import StreamingDeblocker, _deblock_yv12_packed_impl
from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck
from gpu_video_codec_tpu_torch.ops import relayout_kernel as rk
from gpu_video_codec_tpu_torch.ops.chain import tile_chain
from gpu_video_codec_tpu_torch.ops.deblock import deblock_packed_plain
from gpu_video_codec_tpu_torch.utils.bs import BoundaryStrength
from gpu_video_codec_tpu_torch.utils.yuv import planes_from_yv12_bytes, yv12_bytes_from_planes

QP = 37
GEOMS = [(64, 48), (352, 288), (128, 72)]
GEOM_IDS = ["64x48", "cif-352x288", "128x72-q2"]
LEADS = [None, 1, 3]  # no frame axis, or k frames


def _blocky(rng, n, w, h):
    """n packed YV12 frames, flat 8x8 blocks with small noise and steps
    between blocks (the strong and normal filters fire), a quarter of the
    blocks uniform noise."""
    rows = 3 * h // 2
    cell = (n, rows // 4 + 1, w // 4 + 1)  # 4x4 cells: block edges in luma and chroma
    base = np.repeat(np.repeat(rng.integers(40, 216, cell), 4, 1), 4, 2)[:, :rows, :w]
    f = base + rng.integers(-3, 4, (n, rows, w))
    noise = np.repeat(np.repeat(rng.random(cell) < 0.25, 4, 1), 4, 2)[:, :rows, :w]
    f = np.where(noise, rng.integers(0, 256, (n, rows, w)), f)
    return np.clip(f, 0, 255).astype(np.uint8)


def _random_bs(rng, w, h):
    bs = BoundaryStrength.intra_default(w, h)
    bs.set_luma(rng.integers(0, 3, bs.vert.size, dtype=np.uint8),
                rng.integers(0, 3, bs.hor.size, dtype=np.uint8))
    bs.set_chroma(rng.integers(0, 3, bs.chroma_vert.size, dtype=np.uint8),
                  rng.integers(0, 3, bs.chroma_hor.size, dtype=np.uint8))
    return bs


@functools.lru_cache(maxsize=None)
def _case(w, h):
    """Three blocky frames, a random BS and a CPU deblocker of them."""
    rng = np.random.default_rng([w, h])
    frames = _blocky(rng, 3, w, h)
    bs = _random_bs(rng, w, h)
    return frames, bs, StreamingDeblocker(w, h, QP, bs=bs, device="cpu")


@functools.lru_cache(maxsize=None)
def _golden(w, h, i, luma_only):
    frames, bs, _ = _case(w, h)
    gold = deblock_frame_golden(planes_from_yv12_bytes(frames[i].ravel(), w, h), bs, QP,
                                luma_only=luma_only)
    return np.frombuffer(yv12_bytes_from_planes(gold), np.uint8).reshape(3 * h // 2, w)


def _buf(w, h, lead):
    frames = _case(w, h)[0]
    return torch.from_numpy(frames[0].copy() if lead is None else frames[:lead].copy())


def _planes(buf, h):
    lead = tuple(buf.shape[:-2])
    w = buf.shape[-1]
    return buf[..., :h, :], buf[..., h:, :].view(*lead, 2, h // 2, w // 2)


def _args(sd):
    return sd._lm, sd._cm, sd._beta, sd._tc


def _chain(buf, h, sd, luma_only=False):
    """The chain K2 replaces, in place on buf's planes (ops/chain.tile_chain,
    pad 4): T2 -> K1 -> T3 for luma, T2 -> K1c -> T3 for U+V."""
    y, uv = _planes(buf, h)
    tile_chain([y], sd._lm, sd._beta, sd._tc, pad=4, chroma=False, out=[y])
    if not luma_only:
        tile_chain([uv], sd._cm, sd._beta, sd._tc, pad=4, chroma=True, out=[uv])


# -- the wrapper (its plain version on the CPU) -----------------------------------

@pytest.mark.parametrize("luma_only", [False, True], ids=["full", "luma_only"])
@pytest.mark.parametrize("inplace", [False, True], ids=["out", "inplace"])
@pytest.mark.parametrize("lead", LEADS, ids=["frame", "k1", "k3"])
@pytest.mark.parametrize("w,h", GEOMS, ids=GEOM_IDS)
def test_packed_wrapper_matches_torch_backend_and_golden(w, h, lead, inplace, luma_only):
    sd = _case(w, h)[2]
    buf = _buf(w, h, lead)
    want = _deblock_yv12_packed_impl(buf, sd._lm, sd._cm, sd._beta, sd._tc, w, h, luma_only,
                                     "torch")
    dst = buf if inplace else torch.zeros_like(buf)
    y_out, uv_out = _planes(dst, h)
    y, uv = _planes(buf, h)
    got_y, got_uv = ck.deblock_packed_cuda(y, uv, *_args(sd), luma_only=luma_only,
                                           out=(y_out, uv_out))
    assert got_y is y_out
    assert got_uv is (uv if luma_only else uv_out)
    if luma_only:
        assert torch.equal(got_uv, _planes(want, h)[1])  # chroma as it came in
    else:
        assert torch.equal(dst, want)
    assert torch.equal(y_out, _planes(want, h)[0])
    gold = want.reshape(-1, 3 * h // 2, w).numpy()
    for i, frame in enumerate(gold):
        assert np.array_equal(frame, _golden(w, h, i, luma_only)), i
    # without destinations: new tensors, the input untouched
    src = _buf(w, h, lead)
    new_y, new_uv = ck.deblock_packed_cuda(*_planes(src, h), *_args(sd), luma_only=luma_only)
    assert torch.equal(src, _buf(w, h, lead))
    assert torch.equal(new_y, _planes(want, h)[0]) and torch.equal(new_uv, _planes(want, h)[1])


# -- the g++ build of the kernel -----------------------------------------------------

@pytest.mark.parametrize("luma_only", [False, True], ids=["full", "luma_only"])
@pytest.mark.parametrize("inplace", [False, True], ids=["out", "inplace"])
@pytest.mark.parametrize("lead", LEADS, ids=["frame", "k1", "k3"])
@pytest.mark.parametrize("w,h", GEOMS, ids=GEOM_IDS)
def test_packed_host_build_matches_plain(w, h, lead, inplace, luma_only):
    """gvct_host_deblock_packed, K2's blocks staged as its TMA boxes would
    stage them, == deblock_packed_plain; bytes outside what K2 writes
    (chroma under luma_only) stay as they were."""
    lib = ck.load_host_library()
    sd = _case(w, h)[2]
    buf = _buf(w, h, lead)
    want_y, want_uv = deblock_packed_plain(*_planes(buf, h), *_args(sd), luma_only)
    dst = buf if inplace else torch.full_like(buf, 7)
    before = dst.clone()
    y_out, uv_out = _planes(dst, h)
    assert lib.gvct_host_deblock_packed(*ck.packed_launch_args(
        *_planes(buf, h), y_out, uv_out, *_args(sd), luma_only)) == 0
    assert torch.equal(y_out, want_y)
    assert torch.equal(uv_out, _planes(before, h)[1] if luma_only else want_uv)


def test_packed_cif_case_filters_and_ends_in_tail_blocks():
    """The CIF case is one the comparisons above can fail on: the filter
    changes luma and chroma pixels, and its rows end in tail blocks (Bx =
    45, cBx = 23: 13 and 7 tiles of 16, their boxes partly outside the
    plane)."""
    w, h = 352, 288
    sd = _case(w, h)[2]
    buf = _buf(w, h, 3)
    y, uv = _planes(buf, h)
    want_y, want_uv = deblock_packed_plain(y, uv, *_args(sd), False)
    assert (want_y != y).sum() > 1000 and (want_uv != uv).sum() > 100
    (by, bx), (cby, cbx) = ck.packed_grids(w, h)
    assert bx % ck.PACKED_TILES and cbx % ck.PACKED_TILES


# -- the lanes' registers: the box's reads and the edge cases -----------------------------

def _box_geometry(bit_depth):
    """K2's box (csrc/deblock_quad.cuh, PackedCell): bytes a sample, before
    tile 0 and a row."""
    size = 1 if bit_depth == 8 else 2
    lead = 16 - 4 * size
    return size, lead, lead + size * (8 * ck.PACKED_TILES + 4)


def _worst_conflict(reads, word):
    """The most words of one read of a block's threads (reads[tid][j]: the
    byte read at step j) that share a bank: 4-byte reads over a warp's 32
    banks, 8-byte reads over a half-warp's 16 pairs of banks."""
    group = banks = 128 // word
    return max(max(Counter(o // word % banks for o in reads[g:g + group, j]).values())
               for j in range(4) for g in range(0, len(reads), group))


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_packed_box_reads_are_conflict_free(bit_depth):
    """K2's lanes (packed_read, through gvct_host_packed_reads) read each of
    their four words once -- rows r and 4 + r of their own tile, 4 samples a
    word -- and no read of a warp is more than two-way in a bank; in the
    order f = 0..3 for every lane the same reads fall four to a bank."""
    lib = ck.load_host_library()
    threads = 4 * ck.PACKED_TILES
    out = (ctypes.c_int * (4 * threads))()
    word = lib.gvct_host_packed_reads(bit_depth, out)
    size, lead, row = _box_geometry(bit_depth)
    assert word == 4 * size
    reads = np.array(out).reshape(threads, 4)

    def at(t, r, f):
        return (4 * (f >> 1) + r) * row + lead + 2 * word * t + (f & 1) * word

    lanes = [divmod(tid, 4) for tid in range(threads)]
    for (t, r), got in zip(lanes, reads):
        assert sorted(got) == sorted(at(t, r, f) for f in range(4))
    assert _worst_conflict(reads, word) == 2
    assert _worst_conflict(np.array([[at(t, r, f) for f in range(4)] for t, r in lanes]),
                           word) == 4
    assert lib.gvct_host_packed_reads(9, out) == -1


EDGE_GEOMS = [(64, 48), (352, 288)]  # one block a row (n = 9, 5) and CIF's tails (13, 7)
EDGE_IDS = ["64x48", "cif-352x288"]
CONTENTS = ["blocky", "noise"]
BS_FILLS = ["random", "zero", "two"]


@functools.lru_cache(maxsize=None)
def _edge_case(w, h, content, fill):
    """Two frames of `content` (blocky, or uniform noise: the filters switch
    on and off tile by tile) and a BS of every edge 0, every edge 2, or
    uniform in 0..2."""
    rng = np.random.default_rng([w, h, len(content), len(fill)])
    frames = (_blocky(rng, 2, w, h) if content == "blocky"
              else rng.integers(0, 256, (2, 3 * h // 2, w), dtype=np.uint8))
    if fill == "random":
        return frames, _random_bs(rng, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    v = 0 if fill == "zero" else 2
    bs.set_luma(np.full(bs.vert.size, v, np.uint8), np.full(bs.hor.size, v, np.uint8))
    bs.set_chroma(np.full(bs.chroma_vert.size, v, np.uint8),
                  np.full(bs.chroma_hor.size, v, np.uint8))
    return frames, bs


@pytest.mark.parametrize("fill", BS_FILLS)
@pytest.mark.parametrize("content", CONTENTS)
@pytest.mark.parametrize("w,h", EDGE_GEOMS, ids=EDGE_IDS)
def test_packed_host_build_edges(w, h, content, fill):
    """gvct_host_deblock_packed == deblock_packed_plain where the lanes'
    registers meet the edge cases: blocks that end mid-row, the picture's
    borders (the box's zero fill), BS all 0 and all 2, uniform noise; in
    place == into a separate output."""
    lib = ck.load_host_library()
    frames, bs = _edge_case(w, h, content, fill)
    sd = StreamingDeblocker(w, h, QP, bs=bs, device="cpu")
    buf = torch.from_numpy(frames.copy())
    want_y, want_uv = deblock_packed_plain(*_planes(buf, h), *_args(sd), False)
    want = torch.cat([want_y, want_uv.reshape(2, h // 2, w)], dim=-2)
    out, inplace = torch.full_like(buf, 7), buf.clone()
    for src, dst in ((buf, out), (inplace, inplace)):
        assert lib.gvct_host_deblock_packed(*ck.packed_launch_args(
            *_planes(src, h), *_planes(dst, h), *_args(sd), False)) == 0
    assert torch.equal(out, want) and torch.equal(inplace, want)
    assert torch.equal(want, buf) is (fill == "zero")


GUARD_BYTES = 1024  # of guard on each side of a guarded view: four 256-byte L2 lines
GUARD_FILL = 0xA5
GUARDED = [(2, 64, 48), (2, 96, 64)]
GUARDED_IDS = ["k2-64x48", "k2-96x64"]


def _guarded(shape, dtype, device, fill):
    """A contiguous tensor of `shape` that starts 16 bytes past a 256-byte
    boundary, GUARD_BYTES + 16 bytes into a larger allocation whose every
    other element holds `fill`; and a function that is true while they all
    still do.  An L2 line fetched whole for the view's first or last rows
    (the box loads' promotion) takes in guard bytes; no store may."""
    size = torch.empty((), dtype=dtype).element_size()
    n = int(np.prod(shape))
    raw = torch.full((n + (2 * GUARD_BYTES + 512) // size,), fill, dtype=dtype, device=device)
    start = ((-raw.data_ptr()) % 256 + GUARD_BYTES + 16) // size
    view = raw[start:start + n].view(shape)
    assert view.data_ptr() % 256 == 16

    def intact():
        return bool((raw[:start] == fill).all()) and bool((raw[start + n:] == fill).all())

    return view, intact


@functools.lru_cache(maxsize=None)
def _guarded_case(k, w, h):
    """k blocky frames, a random BS and deblock_packed_plain's output."""
    rng = np.random.default_rng([k, w, h, 16])
    frames = torch.from_numpy(_blocky(rng, k, w, h))
    bs = _random_bs(rng, w, h)
    sd = StreamingDeblocker(w, h, QP, bs=bs, device="cpu")
    want_y, want_uv = deblock_packed_plain(*_planes(frames, h), *_args(sd), False)
    return frames, bs, torch.cat([want_y, want_uv.reshape(k, h // 2, w)], dim=-2)


def _guarded_step(k, w, h, device, run):
    """`run(src, dst, sd)` on guarded views of _guarded_case's frames, into
    a separate output and then in place: each == deblock_packed_plain, the
    source of the first untouched, and every guard element as it was."""
    frames, bs, want = _guarded_case(k, w, h)
    sd = StreamingDeblocker(w, h, QP, bs=bs, device=device)
    src, src_intact = _guarded(frames.shape, frames.dtype, device, GUARD_FILL)
    dst, dst_intact = _guarded(frames.shape, frames.dtype, device, GUARD_FILL)
    src.copy_(frames)
    dst.fill_(7)
    assert ck.packed_fits(w, *_planes(src, h), *_planes(dst, h))
    run(src, dst, sd)
    assert src_intact() and dst_intact()
    assert torch.equal(dst.cpu(), want) and torch.equal(src.cpu(), frames)
    run(src, src, sd)
    assert src_intact() and dst_intact()
    assert torch.equal(src.cpu(), want)
    return src, sd


@pytest.mark.parametrize("k,w,h", GUARDED, ids=GUARDED_IDS)
def test_packed_host_build_keeps_guard_bytes(k, w, h):
    """gvct_host_deblock_packed on views 16 bytes past a 256-byte boundary
    with guard bytes before and after == deblock_packed_plain, into a
    separate output and in place, and writes no guard byte: the zero fill
    at the border (Q6) and the stores' limits hold wherever the view lies."""
    lib = ck.load_host_library()

    def run(src, dst, sd):
        assert lib.gvct_host_deblock_packed(*ck.packed_launch_args(
            *_planes(src, h), *_planes(dst, h), *_args(sd), False)) == 0

    _guarded_step(k, w, h, "cpu", run)


# -- the guard -----------------------------------------------------------------------

def _views(w, h, k, offset=0, frame_pad=0):
    """(y, uv) views of a packed batch of k frames whose frames lie
    3wh/2 + frame_pad bytes apart, `offset` bytes into fresh storage."""
    fb = 3 * w * h // 2 + frame_pad
    raw = torch.zeros(k * fb + offset + 64, dtype=torch.uint8)
    base = (-raw.data_ptr()) % 64  # a 64-byte aligned start, then the offset
    buf = raw[base + offset: base + offset + k * fb].view(k, fb)[:, : 3 * w * h // 2]
    buf = buf.reshape(k, 3 * h // 2, w) if frame_pad == 0 else buf.unflatten(1, (3 * h // 2, w))
    return _planes(buf, h)


GUARD = [
    # (w, h, k, offset, frame_pad, takes K2)
    (64, 48, 1, 0, 0, True),
    (64, 48, 3, 0, 0, True),
    (1920, 1080, 2, 0, 0, True),
    (3840, 2160, 1, 0, 0, True),
    (40, 24, 1, 0, 0, False),     # sheared (Q9: w % 16 == 8)
    (360, 288, 2, 0, 0, False),   # sheared
    (88, 72, 1, 0, 0, False),     # w % 32 == 24: chroma rows 44 bytes
    (80, 48, 1, 0, 0, False),     # w % 32 == 16: chroma rows 40 bytes
    (64, 48, 1, 8, 0, False),     # a view 8 bytes past a 16-byte boundary
    (64, 48, 2, 0, 8, False),     # frames 3wh/2 + 8 bytes apart
    (64, 48, 2, 0, 16, True),     # frames 3wh/2 + 16 bytes apart
]


@pytest.mark.parametrize("w,h,k,offset,frame_pad,takes", GUARD,
                         ids=[f"{w}x{h}-k{k}-off{o}-pad{p}" for w, h, k, o, p, _ in GUARD])
def test_packed_guard(w, h, k, offset, frame_pad, takes):
    y, uv = _views(w, h, k, offset, frame_pad)
    assert ck.packed_fits(w, y, uv) is takes
    assert ck.packed_fits(w, y, uv, None, None) is takes
    if w <= 360:  # which way the cuda backend's step goes (on the CPU: plain versions)
        calls = []
        real = {name: getattr(st, name) for name in ("deblock_packed_cuda", "tile_chain")}
        sd = StreamingDeblocker(w, h, QP, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            for name, fn in real.items():
                mp.setattr(st, name, lambda *a, _n=name, _f=fn, **kw: calls.append(_n) or _f(*a, **kw))
            st._deblock_planes_impl(y, uv, sd._lm, sd._cm, sd._beta, sd._tc, w, h, False,
                                    "cuda", out=(y, uv))
        assert calls == (["deblock_packed_cuda"] if takes else ["tile_chain"] * 2)


def test_packed_guard_reads_every_tensor():
    y, uv = _views(64, 48, 1)
    bad_y, bad_uv = _views(64, 48, 1, offset=4)
    assert ck.packed_fits(64, y, uv)
    assert not ck.packed_fits(64, y, uv, bad_y, None)
    assert not ck.packed_fits(64, y, uv, None, bad_uv)
    assert not ck.packed_fits(64, y.transpose(-1, -2), uv)  # last axis not contiguous


# -- the wrapper's operand checks ----------------------------------------------------------

def _operands():
    sd = _case(64, 48)[2]
    y, uv = _planes(_buf(64, 48, 1), 48)
    return y, uv, list(sd._lm), list(sd._cm), sd._beta, sd._tc


BAD = {
    "y-int32": lambda y, uv, lm, cm: (y.int(), uv, lm, cm, {}),
    "uv-shape": lambda y, uv, lm, cm: (y, uv[..., :-8, :], lm, cm, {}),
    "uv-no-lead": lambda y, uv, lm, cm: (y, uv[0], lm, cm, {}),
    "y-4d": lambda y, uv, lm, cm: (y[None], uv[None], lm, cm, {}),
    "h-not-8": lambda y, uv, lm, cm: (y[:, :44], uv[..., :22, :], lm, cm, {}),
    "luma-map-shape": lambda y, uv, lm, cm: (y, uv, [m[:-1] for m in lm], cm, {}),
    "chroma-map-shape": lambda y, uv, lm, cm: (y, uv, lm, [m[:, :-1] for m in cm], {}),
    "map-dtype": lambda y, uv, lm, cm: (y, uv, [m.int() for m in lm], cm, {}),
    "out-shape": lambda y, uv, lm, cm: (y, uv, lm, cm, {"out": (y[..., :40, :], uv)}),
    "out-single": lambda y, uv, lm, cm: (y, uv, lm, cm, {"out": (y,)}),
    "sheared-width": lambda y, uv, lm, cm: (y[..., :56], uv[..., :28], lm, cm, {}),
    "misaligned": lambda y, uv, lm, cm: (*_views(64, 48, 1, offset=8), lm, cm, {}),
}


@pytest.mark.parametrize("case", list(BAD))
def test_packed_wrapper_checks_operands(case):
    y, uv, lm, cm, beta, tc = _operands()
    y, uv, lm, cm, kw = BAD[case](y, uv, lm, cm)
    with pytest.raises(ValueError):
        ck.deblock_packed_cuda(y, uv, lm, cm, beta, tc, **kw)


def test_packed_wrapper_checks_thresholds():
    y, uv, lm, cm, beta, _ = _operands()
    with pytest.raises(ValueError, match="non-negative"):
        ck.deblock_packed_cuda(y, uv, lm, cm, beta, -1)


# -- the card ------------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _counts() -> dict:
    return {"T2": rk.LAUNCHES["fwd"], "T3": rk.LAUNCHES["inv"], "K1": ck.LAUNCHES["luma"],
            "K1c": ck.LAUNCHES["chroma"], "K2": ck.LAUNCHES["packed"]}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items()}


def _card_case(rng, dev, k, w, h):
    """k blocky frames on the card, a random BS and its deblocker."""
    bs = _random_bs(rng, w, h)
    buf = torch.from_numpy(_blocky(rng, k, w, h)).to(dev)
    return buf, StreamingDeblocker(w, h, QP, bs=bs, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("inplace", [False, True], ids=["out", "inplace"])
@pytest.mark.parametrize("k,w,h", [(16, 1920, 1080), (4, 3840, 2160), (1, 1920, 1080),
                                   (4, 1920, 1080), (1, 3840, 2160), (3, 64, 48), (2, 352, 288),
                                   (3, 128, 72)],
                         ids=["k16-1080p", "k4-2160p", "k1-1080p", "k4-1080p", "k1-2160p",
                              "k3-64x48", "k2-cif", "k3-128x72"])
def test_packed_kernel_matches_chain_on_card(rng, cuda_device, k, w, h, inplace):
    """K2 == the chain T2 -> K1 -> T3, T2 -> K1c -> T3 it replaces, byte for
    byte, with a random BS; full and luma_only; one K2 launch a step."""
    buf, sd = _card_case(rng, cuda_device, k, w, h)
    for luma_only in (False, True):
        ref = buf.clone()
        _chain(ref, h, sd, luma_only)
        before = _counts()
        got = _deblock_yv12_packed_impl(buf, sd._lm, sd._cm, sd._beta, sd._tc, w, h, luma_only,
                                        "cuda", inplace=inplace)
        assert _delta(before) == {"T2": 0, "T3": 0, "K1": 0, "K1c": 0, "K2": 1}
        torch.cuda.synchronize()
        assert torch.equal(got, ref), luma_only
        assert (got is buf) == inplace
        if inplace:
            buf = _card_case(rng, cuda_device, k, w, h)[0]
    if w <= 352:
        plain = _deblock_yv12_packed_impl(buf.cpu(), *(tuple(m.cpu() for m in maps)
                                                        for maps in (sd._lm, sd._cm)),
                                          sd._beta, sd._tc, w, h, False, "torch")
        got = _deblock_yv12_packed_impl(buf, sd._lm, sd._cm, sd._beta, sd._tc, w, h, False,
                                        "cuda")
        assert torch.equal(got.cpu(), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(64, 48), (1920, 1080)])
def test_packed_kernel_graph_replay_on_card(rng, cuda_device, w, h):
    """_chain's graph replays K2 (one launch a step) == the chain's eager
    steps, captured and replayed."""
    buf, sd = _card_case(rng, cuda_device, 1, w, h)
    buf = buf[0]
    ref = buf.clone()
    for _ in range(3):
        _chain(ref, h, sd)
    for _ in range(2):  # the call that captures, then a replay alone
        x = buf.clone()
        before = _counts()
        assert sd._chain(x, 3) is x
        assert _delta(before) == {"T2": 0, "T3": 0, "K1": 0, "K1c": 0, "K2": 3}
        torch.cuda.synchronize()
        assert torch.equal(x, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("k,w,h,slots", [(16, 1920, 1080, 1), (4, 3840, 2160, 1),
                                         (6, 64, 48, 2)], ids=["k16-1080p", "k4-2160p",
                                                               "k6-64x48-2slots"])
def test_packed_kernel_through_the_mesh_on_card(rng, cuda_device, k, w, h, slots):
    """deblock_packed_batch_sharded_jit (graph replays per slot) runs K2 once
    a slot and equals the chain on the whole batch."""
    from gpu_video_codec_tpu_torch.parallel import mesh as pmesh

    buf, sd = _card_case(rng, cuda_device, k, w, h)
    ref = buf.clone()
    _chain(ref, h, sd)
    mesh = pmesh.make_mesh(1, slots, [cuda_device] * slots)
    for _ in range(2):
        x = buf.clone()
        before = _counts()
        pmesh.deblock_packed_batch_sharded_jit(mesh, x, sd._lm, sd._cm, sd._beta, sd._tc,
                                               w=w, h=h)
        assert _delta(before) == {"T2": 0, "T3": 0, "K1": 0, "K1c": 0, "K2": slots}
        torch.cuda.synchronize()
        assert torch.equal(x, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", BS_FILLS)
@pytest.mark.parametrize("content", CONTENTS)
@pytest.mark.parametrize("w,h", EDGE_GEOMS, ids=EDGE_IDS)
def test_packed_kernel_edges_on_card(cuda_device, w, h, content, fill):
    """K2 on test_packed_host_build_edges' cases == deblock_packed_plain and
    the chain, in place == into a separate output, one K2 launch each."""
    frames, bs = _edge_case(w, h, content, fill)
    sd = StreamingDeblocker(w, h, QP, bs=bs, device=cuda_device)
    buf = torch.from_numpy(frames.copy()).to(cuda_device)
    cpu = StreamingDeblocker(w, h, QP, bs=bs, device="cpu")
    want_y, want_uv = deblock_packed_plain(*_planes(buf.cpu(), h), *_args(cpu), False)
    ref = buf.clone()
    _chain(ref, h, sd)
    out, inplace = torch.full_like(buf, 7), buf.clone()
    before = _counts()
    ck.deblock_packed_cuda(*_planes(buf, h), *_args(sd), out=_planes(out, h))
    ck.deblock_packed_cuda(*_planes(inplace, h), *_args(sd), out=_planes(inplace, h))
    assert _delta(before) == {"T2": 0, "T3": 0, "K1": 0, "K1c": 0, "K2": 2}
    torch.cuda.synchronize()
    assert torch.equal(out, inplace) and torch.equal(out, ref)
    y, uv = _planes(out.cpu(), h)
    assert torch.equal(y, want_y) and torch.equal(uv, want_uv)


@pytest.mark.cuda
@pytest.mark.parametrize("k,w,h", GUARDED, ids=GUARDED_IDS)
def test_packed_kernel_keeps_guard_bytes_on_card(cuda_device, k, w, h):
    """K2 on views 16 bytes past a 256-byte boundary, with guard bytes
    before and after, == deblock_packed_plain into a separate output, in
    place and into new planes, one K2 launch each, and no guard byte
    changes: the box loads' L2 promotion fetches whole lines past the
    planes' ends, and the zero fill at the border (Q6) and the stores'
    limits still hold."""
    before = _counts()

    def run(src, dst, sd):
        ck.deblock_packed_cuda(*_planes(src, h), *_args(sd), out=_planes(dst, h))
        torch.cuda.synchronize()

    src, sd = _guarded_step(k, w, h, cuda_device, run)
    frames, _, want = _guarded_case(k, w, h)
    src.copy_(frames)
    new_y, new_uv = ck.deblock_packed_cuda(*_planes(src, h), *_args(sd))
    assert _delta(before) == {"T2": 0, "T3": 0, "K1": 0, "K1c": 0, "K2": 3}
    assert torch.equal(torch.cat([new_y, new_uv.reshape(k, h // 2, w)], dim=-2).cpu(), want)
    assert torch.equal(src.cpu(), frames)


@pytest.mark.cuda
def test_sheared_step_keeps_the_chain_on_card(rng, cuda_device):
    """A sheared 360x288 step (Q9) still runs T2 2, K1, K1c, T3 2, no K2,
    and equals the plain backend."""
    w, h = 360, 288
    buf, sd = _card_case(rng, cuda_device, 2, w, h)
    plain = _deblock_yv12_packed_impl(buf.cpu(), *(tuple(m.cpu() for m in maps)
                                                    for maps in (sd._lm, sd._cm)),
                                      sd._beta, sd._tc, w, h, False, "torch")
    before = _counts()
    got = _deblock_yv12_packed_impl(buf, sd._lm, sd._cm, sd._beta, sd._tc, w, h, False, "cuda")
    assert _delta(before) == {"T2": 2, "T3": 2, "K1": 1, "K1c": 1, "K2": 0}
    assert torch.equal(got.cpu(), plain)


@pytest.mark.cuda
def test_packed_kernel_info_on_card(cuda_device):
    info = ck.deblock_packed_info(cuda_device)
    assert info["threads"] == 4 * ck.PACKED_TILES and info["registers"] <= 64
    stage = 8 * (8 * ck.PACKED_TILES + 16)  # the box: 8 rows of the block's tiles and 16 bytes
    assert info["blocks_per_sm"] >= 8 and info["smem_bytes"] >= stage
