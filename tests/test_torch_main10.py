"""HEVC Main 10 on the PyTorch port: the packed batch step at bit_depth=10.

The mesh's packed entry points (parallel/mesh.deblock_packed_batch_sharded
and its _jit twin), the streaming packed step under them, K2-10's plain
version (ops/deblock.deblock_packed_plain) and the g++ build of K2-10
(csrc/host_shim.cpp, gvct_host_deblock_packed at bit depth 10) filter int16
batches of 10-bit samples in [0, 1023], with beta and tc the tables' at the
QP (the port scales them by 4) and every filtered sample clipped to 1023.
Every case is held byte for byte to the plain reference
bench_torch/references/hevc_deblock.py at bit_depth=10: plain PyTorch,
written apart from the port, imported as it is.  On the CPU:
  - seeded random 10-bit frames at QPs 22, 27, 32, 37 and 51, all-intra and
    random BS, at 64x48, 96x64 and (mesh only: the plain path takes every
    width) a sheared 72x40;
  - hand-built frames that catch the likely faults: a segment whose rows'
    dp and dq overflow a 10-bit field, strong filters beside 1023, edges
    that filter only with scaled beta and tc, and 8-bit filtering of the
    samples shifted right by 2, each through the mesh, the plain version
    and the g++ build;
  - the argument errors: bit_depth 9, a uint8 buffer at 10 bits, an int16
    buffer at 8, and K2-10's width guard.
  - K2-10's g++ build at the edges of its lanes' register path: blocks that
    end mid-row, the picture's borders, BS all 0 and all 2, uniform noise
    and samples pinned at 0 and 1023, in place and into a separate output.
HEVC Main 4:2:2 10 (chroma_format="4:2:2": (N, 2h, w) batches, chroma
planes (h, w/2)) through the same entries, held to the reference at
chroma_format="4:2:2": seeded random 10-bit frames at QPs 22, 32 and 51,
all-intra and random BS, at 64x48 and 96x64 (and a sheared 72x40 on the
mesh), an 8-bit 4:2:2 case on every path, the g++ build on blocks that
end mid-row and the picture's last chroma tile row, the argument errors
(a 4:2:0 buffer at 4:2:2 and the reverse, an unknown format), the tile
counters, the graph key and the BS arrays' sizes, parametrised over the
chroma format where each applies; and the g++ build at each format on
views 16 bytes past a 256-byte boundary with guard elements before and
after them (== the plain version, no guard element written).
HEVC Main 4:4:4 and Main 4:4:4 10 (chroma_format="4:4:4": (N, 3h, w)
batches, chroma planes (h, w)) at 8 and 10 bits: the mesh's entries, the
plain version and the g++ build against the reference at QPs 22, 32 and
51, all-intra and random BS, at 64x48 and 80x40 (w % 32 == 16, which K2
takes at 4:4:4; and 72x40 on the mesh); hand-made chroma edges at
columns and rows 8 and 24 whose filter passes the top sample (the clip);
the g++ build on blocks that end mid-row and the last chroma tile row;
K2's grid, whose 4:2:0 and 4:2:2 extents are pinned and whose 4:4:4 rows
(U's, then V's) leave no block past its row's end; and the guard's rule,
the luma rows' alone at 4:4:4.
Tests marked `cuda` launch K2-10 on the card (one launch a call, under its
own counter) against the plain path at the 4K cell's shape, at 720x576
(w % 32 == 16), on the buffer's views and on the edge cases above (and
against the reference), and check that a sheared 10-bit width raises
there; the same at 4:2:2 (the 4:2:2 cell's (4, 4320, 3840), 720x576 and
an 8-bit 64x48), with a misaligned 4:2:2 view raising; and on the guarded
views at each format (the box loads' L2 promotion fetches whole lines
past the planes' ends); the same at 4:4:4 (the 4:4:4 cell's (4, 6480,
3840) uint8, its int16 twin, 720x576 and 80x40, the edges, the
hand-made chroma edges through the graph replay), with a misaligned view
and an 8-bit width off 16 raising; they skip without
a card, and nothing here imports JAX
(`python -m pytest tests/test_torch_main10.py -m cuda`)."""

import functools

import numpy as np
import pytest
import torch

from bench_torch.references import hevc_deblock as ref
from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck
from gpu_video_codec_tpu_torch.ops.deblock import deblock_packed_plain
from gpu_video_codec_tpu_torch.ops.tables import (
    chroma_height, chroma_width, get_beta, get_tc, packed_rows,
)
from gpu_video_codec_tpu_torch.parallel import mesh as pm
from gpu_video_codec_tpu_torch.utils.bs import BoundaryStrength, segment_bs_maps_device

QPS = [22, 27, 32, 37, 51]
BS_KINDS = ["ai", "random"]
ENTRIES = {"eager": pm.deblock_packed_batch_sharded, "jit": pm.deblock_packed_batch_sharded_jit}
TOP = 1023


def _bs(kind, w, h, seed=0, fmt="4:2:0"):
    """The reference's flat BS arrays of a chroma format: all-intra, or
    uniform in 0..2."""
    ai = BoundaryStrength.intra_default(w, h, fmt)
    bs = {k: getattr(ai, k) for k in ("vert", "hor", "chroma_vert", "chroma_hor")}
    if kind == "random":
        rng = np.random.default_rng([w, h, seed, 7])
        bs = {k: rng.integers(0, 3, v.size, dtype=np.uint8) for k, v in bs.items()}
    return bs


def _maps(bs, w, h, device="cpu", fmt="4:2:0"):
    """The port's luma and chroma gate maps, built as the benchmark's feed
    builds them: the chroma maps on the chroma plane's tiles, looked up at
    its width and gated by the luma tile counts."""
    b = 8
    ny, nx = h // b + 1, w // b + 1
    lm = segment_bs_maps_device(bs["vert"], bs["hor"], w, ny, nx, ny, nx, device=device)
    cw = chroma_width(w, fmt)
    cm = segment_bs_maps_device(bs["chroma_vert"], bs["chroma_hor"], cw,
                                chroma_height(h, fmt) // b + 1, cw // b + 1, ny, nx,
                                device=device)
    return lm, cm


def _frames(seed, n, w, h, fmt="4:2:0"):
    """n packed 10-bit frames (int16, (n, 3h/2, w), or (n, 2h, w) at
    4:2:2, (n, 3h, w) at 4:4:4): flat 4x4 cells with small noise (both
    filters fire), a tenth of the cells at the ends of the range, a quarter
    uniform noise."""
    rng = np.random.default_rng(seed)
    rows = packed_rows(h, fmt)
    cell = (n, rows // 4 + 1, w // 4 + 1)

    def up(a):
        return np.repeat(np.repeat(a, 4, 1), 4, 2)[:, :rows, :w]

    base = rng.integers(160, 864, cell)
    ends = rng.random(cell)
    base = np.where(ends < 0.05, rng.integers(0, 40, cell), base)
    base = np.where(ends > 0.95, rng.integers(984, 1024, cell), base)
    f = up(base) + rng.integers(-12, 13, (n, rows, w))
    f = np.where(up(rng.random(cell) < 0.25), rng.integers(0, 1024, (n, rows, w)), f)
    return torch.from_numpy(np.clip(f, 0, TOP).astype(np.int16))


def _planes(buf, h, fmt="4:2:0"):
    lead = tuple(buf.shape[:-2])
    return buf[..., :h, :], buf[..., h:, :].view(*lead, 2, chroma_height(h, fmt),
                                                 chroma_width(buf.shape[-1], fmt))


@functools.lru_cache(maxsize=None)
def _case(qp, kind, w, h):
    """Three frames, their BS and the reference's output (read-only)."""
    frames = _frames([qp, w, h, len(kind)], 3, w, h)
    bs = _bs(kind, w, h, qp)
    return frames, bs, ref.deblock_packed(frames, w, h, qp, bs, bit_depth=10)


def _mesh_step(entry, frames, bs, qp, w, h):
    buf = frames.clone()
    lm, cm = _maps(bs, w, h)
    mesh = pm.make_mesh(1, 2, devices=["cpu"] * 2)
    out = ENTRIES[entry](mesh, buf, lm, cm, get_beta(qp), get_tc(qp), w=w, h=h, bit_depth=10)
    assert out is buf
    return buf


def _plain_step(frames, bs, qp, w, h):
    lm, cm = _maps(bs, w, h, frames.device)
    y, uv = deblock_packed_plain(*_planes(frames, h), lm, cm, get_beta(qp), get_tc(qp),
                                 bit_depth=10)
    return torch.cat([y, uv.reshape(*frames.shape[:-2], h // 2, w)], dim=-2)


def _host_step(frames, bs, qp, w, h):
    """gvct_host_deblock_packed (the g++ build of K2-10) in place on a copy."""
    lib = ck.load_host_library()
    buf = frames.clone()
    lm, cm = _maps(bs, w, h)
    y, uv = _planes(buf, h)
    assert lib.gvct_host_deblock_packed(*ck.packed_launch_args(
        y, uv, y, uv, lm, cm, get_beta(qp), get_tc(qp), False, 10)) == 0
    return buf


# -- seeded random frames against the reference -----------------------------------------

@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("w,h", [(64, 48), (96, 64), (72, 40)], ids=["64x48", "96x64",
                                                                    "72x40-sheared"])
@pytest.mark.parametrize("kind", BS_KINDS)
@pytest.mark.parametrize("qp", QPS)
def test_mesh_main10_matches_reference(qp, kind, w, h, entry):
    """The mesh's packed entries on two CPU slots (3 frames: 2 and 1)."""
    frames, bs, want = _case(qp, kind, w, h)
    got = _mesh_step(entry, frames, bs, qp, w, h)
    assert torch.equal(got, want)
    assert qp < 30 or (want != frames).sum() > 100  # the filter does work


@pytest.mark.parametrize("path", ["plain", "host"])
@pytest.mark.parametrize("w,h", [(64, 48), (96, 64)], ids=["64x48", "96x64"])
@pytest.mark.parametrize("kind", BS_KINDS)
@pytest.mark.parametrize("qp", QPS)
def test_k2_10_paths_match_reference(qp, kind, w, h, path):
    """K2-10's plain version and its g++ build, on the frames' planes."""
    frames, bs, want = _case(qp, kind, w, h)
    step = _plain_step if path == "plain" else _host_step
    assert torch.equal(step(frames, bs, qp, w, h), want)


# -- K2-10's registers at the edges --------------------------------------------------------

EDGE_GEOMS = [(64, 48), (352, 288)]  # one block a row (n = 9, 5) and CIF's tails (13, 7)
EDGE_IDS = ["64x48", "cif-352x288"]
EDGE_QP = 37


@functools.lru_cache(maxsize=None)
def _edge_case(content, fill, w, h):
    """Two 10-bit frames and a BS: uniform noise (the filters switch on and
    off tile by tile), or samples pinned at 0 and 1023 -- 16x16 regions near
    one end of the range, 4x4 cells 0..11 from it, small noise, clipped, so
    filtered edges sit at the clip -- with every BS 0, every BS 2, or BS
    uniform in 0..2; and the reference's output (read-only)."""
    rng = np.random.default_rng([w, h, len(content), len(fill)])
    n, rows = 2, 3 * h // 2

    def up(a, k):
        return np.repeat(np.repeat(a, k, 1), k, 2)[:, :rows, :w]

    if content == "noise":
        f = rng.integers(0, TOP + 1, (n, rows, w))
    else:
        high = up(rng.random((n, rows // 16 + 1, w // 16 + 1)) < 0.5, 16)
        base = up(rng.integers(0, 12, (n, rows // 4 + 1, w // 4 + 1)), 4)
        f = np.where(high, TOP - base, base) + rng.integers(-3, 4, (n, rows, w))
    frames = torch.from_numpy(np.clip(f, 0, TOP).astype(np.int16))
    bs = _bs("random", w, h, EDGE_QP)
    if fill != "random":
        bs = {k: np.full_like(v, 0 if fill == "zero" else 2) for k, v in bs.items()}
    return frames, bs, ref.deblock_packed(frames, w, h, EDGE_QP, bs, bit_depth=10)


@pytest.mark.parametrize("fill", ["random", "zero", "two"])
@pytest.mark.parametrize("content", ["noise", "pinned"])
@pytest.mark.parametrize("w,h", EDGE_GEOMS, ids=EDGE_IDS)
def test_k2_10_host_build_edges(w, h, content, fill):
    """K2-10's g++ build == the reference on blocks that end mid-row, the
    picture's borders, BS all 0 and all 2, uniform noise and samples pinned
    at 0 and 1023; in place == into a separate output."""
    frames, bs, want = _edge_case(content, fill, w, h)
    lm, cm = _maps(bs, w, h)
    lib = ck.load_host_library()
    out, inplace = torch.full_like(frames, 7), frames.clone()
    for src, dst in ((frames, out), (inplace, inplace)):
        assert lib.gvct_host_deblock_packed(*ck.packed_launch_args(
            *_planes(src, h), *_planes(dst, h), lm, cm, get_beta(EDGE_QP), get_tc(EDGE_QP),
            False, 10)) == 0
    assert torch.equal(out, want) and torch.equal(inplace, want)
    assert torch.equal(want, frames) is (fill == "zero")
    if content == "pinned":
        assert int((frames == 0).sum()) > 100 and int((frames == TOP).sum()) > 100


# -- hand-built frames that catch the likely faults ----------------------------------------

W, H = 64, 48


def _flat(v=512):
    return torch.full((1, 3 * H // 2, W), v, dtype=torch.int16)


def _overflow_frame():
    """Flat 512 but for segment rows 16 and 19 of the vertical edge at x = 16:
    p2, p1, p0 = 1, 0, 1023 and q0, q1, q2 = 1003, 0, 21, so dp = dq = 1024
    in each row and dp0 + dp3 = dq0 + dq3 = 2048 (the segment is skipped)."""
    f = _flat()
    for r in (16, 19):
        f[0, r, 13:19] = torch.tensor([1, 0, 1023, 1003, 0, 21])
    return f


def _strong_frame():
    """Smooth halves at 1020 and 1000 (luma) and 1015 and 1000 (U, V): the
    strong filter and the chroma filter set samples above 255."""
    f = _flat()
    f[0, :H, : W // 2] = 1020
    f[0, :H, W // 2 :] = 1000
    c = f[0, H:].view(2, H // 2, W // 2)
    c[:, :, : W // 4] = 1015
    c[:, :, W // 4 :] = 1000
    return f


def _scaled_frame():
    """Every 8 columns q0..q3, p3..p0 = 540, 540, 550, 545, 505, 510, 500, 500:
    dp = dq = 10 a row, so a segment's d is 40, at or above QP 32's beta'
    26 but below its scaled beta 104; the step of 40 passes the normal
    filter's gate at the scaled tc."""
    f = _flat()
    pattern = torch.tensor([540, 540, 550, 545, 505, 510, 500, 500], dtype=torch.int16)
    f[0, :H] = pattern.repeat(W // 8)
    return f


def _overflow_fault(frame):
    """The 10-bit-field exchange's reading of the segment at x = 16, rows
    16-19: rows 0 and 3 packed as dp | dq << 10 | fail << 20 and summed;
    returns (dp + dq as that sum reads it, as it is)."""
    def d(row, a, b, c):
        return abs(int(frame[0, row, a]) - 2 * int(frame[0, row, b]) + int(frame[0, row, c]))

    dps = [d(r, 13, 14, 15) for r in (16, 19)]
    dqs = [d(r, 18, 17, 16) for r in (16, 19)]
    total = sum(dp | dq << 10 for dp, dq in zip(dps, dqs))
    return (total & 1023) + (total >> 10 & 1023), sum(dps) + sum(dqs)


FAULTS = {
    # name: (frame, qp, bs kind)
    "dp-dq-overflow": (_overflow_frame, 37, "ai"),
    "strong-beside-1023": (_strong_frame, 51, "ai"),
    "unscaled-thresholds": (_scaled_frame, 32, "ai"),
    "shifted-8-bit": (_strong_frame, 37, "random"),
}


def _faulty(name, frame, qp, bs, monkeypatch):
    """What the fault would give where the reference can say (None where it
    cannot: the overflow is shown on the exchange's arithmetic)."""
    if name == "strong-beside-1023":
        with monkeypatch.context() as m:
            m.setattr(ref, "max_pixel", lambda bit_depth=8: 255)
            return ref.deblock_packed(frame, W, H, qp, bs, bit_depth=10)
    if name == "unscaled-thresholds":
        with monkeypatch.context() as m:
            m.setattr(ref, "beta_tc", lambda q, bit_depth=8: (ref.BETA[q], ref.TC[q]))
            return ref.deblock_packed(frame, W, H, qp, bs, bit_depth=10)
    if name == "shifted-8-bit":
        eight = ref.deblock_packed((frame >> 2).to(torch.uint8), W, H, qp, bs)
        return eight.to(torch.int16) << 2
    return None


@pytest.mark.parametrize("path", ["mesh", "plain", "host"])
@pytest.mark.parametrize("name", list(FAULTS))
def test_main10_catches_likely_faults(name, path, monkeypatch):
    make, qp, kind = FAULTS[name]
    frame = make()
    bs = _bs(kind, W, H, qp)
    want = ref.deblock_packed(frame, W, H, qp, bs, bit_depth=10)
    if path == "mesh":
        got = _mesh_step("jit", frame, bs, qp, W, H)
    elif path == "plain":
        got = _plain_step(frame, bs, qp, W, H)
    else:
        got = _host_step(frame, bs, qp, W, H)
    assert torch.equal(got, want)
    faulty = _faulty(name, frame, qp, bs, monkeypatch)
    if faulty is None:  # 12-bit fields hold what 10-bit ones wrap
        wrapped, d = _overflow_fault(frame)
        beta = get_beta(qp) * 4
        assert d >= beta > wrapped  # skipped, where 10-bit fields would filter
        assert torch.equal(want[0, 16:20, 14:18], frame[0, 16:20, 14:18])
    else:
        assert not torch.equal(faulty, want)
    assert int(want.max()) > 255 and int(want.min()) >= 0


# -- argument errors ------------------------------------------------------------------------

def _args(dtype=torch.int16, w=W, h=H):
    bs = _bs("ai", w, h)
    lm, cm = _maps(bs, w, h)
    return torch.zeros((2, 3 * h // 2, w), dtype=dtype), lm, cm, get_beta(32), get_tc(32)


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("dtype,bit_depth", [(torch.int16, 9), (torch.uint8, 9),
                                             (torch.uint8, 10), (torch.int16, 8),
                                             (torch.int32, 10)],
                         ids=["int16-bd9", "uint8-bd9", "uint8-bd10", "int16-bd8",
                              "int32-bd10"])
def test_mesh_main10_argument_errors(entry, dtype, bit_depth):
    buf, lm, cm, beta, tc = _args(dtype)
    before = buf.clone()
    mesh = pm.make_mesh(1, 1, devices=["cpu"])
    with pytest.raises(ValueError, match="bit_depth"):
        ENTRIES[entry](mesh, buf, lm, cm, beta, tc, w=W, h=H, bit_depth=bit_depth)
    assert torch.equal(buf, before)


def test_packed_wrapper_main10_argument_errors():
    buf, lm, cm, beta, tc = _args()
    y, uv = _planes(buf, H)
    with pytest.raises(ValueError, match="bit_depth"):
        ck.deblock_packed_cuda(y, uv, lm, cm, beta, tc, bit_depth=9)
    with pytest.raises(ValueError, match="int16"):
        ck.deblock_packed_cuda(*_planes(buf.to(torch.uint8), H), lm, cm, beta, tc, bit_depth=10)
    with pytest.raises(ValueError, match="uint8"):
        ck.deblock_packed_cuda(y, uv, lm, cm, beta, tc)
    assert ck.load_host_library().gvct_host_deblock_packed(*ck.packed_launch_args(
        y, uv, y, uv, lm, cm, beta, tc, False, 9)) == -1


GUARD_10 = [
    # (w, h, takes K2-10, takes K2)
    (64, 48, True, True),
    (720, 576, True, False),     # w % 32 == 16
    (3840, 2160, True, True),
    (72, 40, False, False),      # sheared (Q9: w % 16 == 8)
    (360, 288, False, False),    # sheared
]


@pytest.mark.parametrize("w,h,takes10,takes8", GUARD_10,
                         ids=[f"{w}x{h}" for w, h, _, _ in GUARD_10])
def test_packed_guard_main10(w, h, takes10, takes8):
    """K2-10's width rule, w % 16 == 0, beside K2's w % 32 == 0, on int16
    and uint8 planes of a 16-byte aligned batch; every JCTVC-L1100 / JVET
    CTC width passes it."""
    buf = torch.zeros((1, 3 * h // 2, w), dtype=torch.int16)
    assert buf.data_ptr() % 16 == 0
    assert ck.packed_fits(w, *_planes(buf, h), bit_depth=10) is takes10
    assert ck.packed_fits(w, *_planes(buf.to(torch.uint8), h)) is takes8
    for ctc in (3840, 2560, 1920, 1280, 832, 416):
        assert ck.packed_fits(ctc, bit_depth=10)


def test_packed_guard_main10_counts_bytes():
    """Strides count in bytes: an int16 view 8 samples (16 bytes) in fits,
    one 4 samples (8 bytes) in does not."""
    raw = torch.zeros(3 * H // 2 * W + 64, dtype=torch.int16)
    base = (-raw.data_ptr() // 2) % 8
    for off, fits in ((0, True), (8, True), (4, False)):
        buf = raw[base + off : base + off + 3 * H // 2 * W].view(1, 3 * H // 2, W)
        assert ck.packed_fits(W, *_planes(buf, H), bit_depth=10) is fits


# -- HEVC Main 4:2:2 10: chroma planes (h, w/2) in a (N, 2h, w) buffer --------------------

FORMATS = ["4:2:0", "4:2:2", "4:4:4"]
QPS_422 = [22, 32, 51]


@functools.lru_cache(maxsize=None)
def _format_case(fmt, qp, kind, w, h, bit_depth=10):
    """Three frames of a chroma format (10-bit, or the same shifted to 8
    bits), their BS and the reference's output at that format
    (read-only)."""
    frames = _frames([qp, w, h, len(kind), int(fmt.replace(":", ""))], 3, w, h, fmt)
    if bit_depth == 8:
        frames = (frames >> 2).to(torch.uint8)
    bs = _bs(kind, w, h, qp, fmt)
    return frames, bs, ref.deblock_packed(frames, w, h, qp, bs, bit_depth=bit_depth,
                                          chroma_format=fmt)


def _format_step(fmt, path, frames, bs, qp, w, h, bit_depth):
    """One packed step of a chroma format by `path`: the mesh's eager or
    _jit entry on two slots of the frames' device, K2's plain version, or
    its g++ build in place."""
    lm, cm = _maps(bs, w, h, frames.device, fmt)
    if path in ENTRIES:
        buf = frames.clone()
        mesh = pm.make_mesh(1, 2, devices=[frames.device] * 2)
        out = ENTRIES[path](mesh, buf, lm, cm, get_beta(qp), get_tc(qp), w=w, h=h,
                            bit_depth=bit_depth, chroma_format=fmt)
        assert out is buf
        return buf
    if path == "plain":
        y, uv = deblock_packed_plain(*_planes(frames, h, fmt), lm, cm, get_beta(qp),
                                     get_tc(qp), bit_depth=bit_depth)
        return torch.cat([y, uv.reshape(*frames.shape[:-2], -1, w)], dim=-2)
    buf = frames.clone()
    y, uv = _planes(buf, h, fmt)
    assert ck.load_host_library().gvct_host_deblock_packed(*ck.packed_launch_args(
        y, uv, y, uv, lm, cm, get_beta(qp), get_tc(qp), False, bit_depth)) == 0
    return buf


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("w,h", [(64, 48), (96, 64), (72, 40)], ids=["64x48", "96x64",
                                                                    "72x40-sheared"])
@pytest.mark.parametrize("kind", BS_KINDS)
@pytest.mark.parametrize("qp", QPS_422)
def test_mesh_main422_10_matches_reference(qp, kind, w, h, entry):
    """The mesh's packed entries at chroma_format="4:2:2" on two CPU slots
    (3 frames: 2 and 1) == the reference at 4:2:2, byte for byte; the
    chroma planes, half the samples, are filtered."""
    frames, bs, want = _format_case("4:2:2", qp, kind, w, h)
    got = _format_step("4:2:2", entry, frames, bs, qp, w, h, 10)
    assert torch.equal(got, want)
    if qp > 30:
        assert (want[:, h:] != frames[:, h:]).sum() > 50  # chroma filtered too


@pytest.mark.parametrize("path", ["plain", "host"])
@pytest.mark.parametrize("w,h", [(64, 48), (96, 64)], ids=["64x48", "96x64"])
@pytest.mark.parametrize("kind", BS_KINDS)
@pytest.mark.parametrize("qp", QPS_422)
def test_k2_10_422_paths_match_reference(qp, kind, w, h, path):
    """K2-10's plain version and its g++ build on 4:2:2 planes (h, w/2)."""
    frames, bs, want = _format_case("4:2:2", qp, kind, w, h)
    assert torch.equal(_format_step("4:2:2", path, frames, bs, qp, w, h, 10), want)


@pytest.mark.parametrize("path", [*ENTRIES, "plain", "host"])
def test_k2_422_8bit_matches_reference(path):
    """8-bit 4:2:2 (K2's instance on the shared grid) == the reference."""
    w, h, qp = 96, 64, 37
    frames, bs, want = _format_case("4:2:2", qp, "random", w, h, bit_depth=8)
    assert frames.dtype == torch.uint8
    assert torch.equal(_format_step("4:2:2", path, frames, bs, qp, w, h, 8), want)
    assert (want[:, h:] != frames[:, h:]).sum() > 50


@functools.lru_cache(maxsize=None)
def _edge_case_fmt(fill, w, h, fmt="4:2:2", bit_depth=10):
    """Two frames of a chroma format (4:2:2 by default) of uniform noise,
    10-bit (or 8-bit), with BS all 0, all 2 or uniform, and the reference's
    output (read-only)."""
    rng = np.random.default_rng([w, h, len(fill), int(fmt.replace(":", ""))])
    top = (1 << bit_depth) - 1
    frames = rng.integers(0, top + 1, (2, packed_rows(h, fmt), w))
    frames = torch.from_numpy(frames.astype(np.int16 if bit_depth == 10 else np.uint8))
    bs = _bs("random", w, h, EDGE_QP, fmt)
    if fill != "random":
        bs = {k: np.full_like(v, 0 if fill == "zero" else 2) for k, v in bs.items()}
    return frames, bs, ref.deblock_packed(frames, w, h, EDGE_QP, bs, bit_depth=bit_depth,
                                          chroma_format=fmt)


@pytest.mark.parametrize("fill", ["random", "zero", "two"])
@pytest.mark.parametrize("w,h", EDGE_GEOMS, ids=EDGE_IDS)
def test_k2_10_422_host_build_edges(w, h, fill):
    """K2-10's g++ build at 4:2:2 == the reference on blocks that end
    mid-row (cBx 5 and 23: one short block, and 16 + 7) and on the
    picture's last chroma tile row ((h + 8) / 8 rows, its lower half
    outside the plane), BS all 0, all 2 and uniform; in place == into a
    separate output."""
    frames, bs, want = _edge_case_fmt(fill, w, h)
    lm, cm = _maps(bs, w, h, fmt="4:2:2")
    (_, _), (cby, cbx) = ck.packed_grids(w, h, "4:2:2")
    assert cby == h // 8 + 1 and cbx % ck.PACKED_TILES != 0
    lib = ck.load_host_library()
    out, inplace = torch.full_like(frames, 7), frames.clone()
    for src, dst in ((frames, out), (inplace, inplace)):
        assert lib.gvct_host_deblock_packed(*ck.packed_launch_args(
            *_planes(src, h, "4:2:2"), *_planes(dst, h, "4:2:2"), lm, cm, get_beta(EDGE_QP),
            get_tc(EDGE_QP), False, 10)) == 0
    assert torch.equal(out, want) and torch.equal(inplace, want)
    assert torch.equal(want, frames) is (fill == "zero")
    if fill == "two":  # the last chroma tile row's edge (chroma rows h - 4 .. h - 1) filters
        last = slice(h + h - 4, 2 * h)
        assert not torch.equal(want[:, last], frames[:, last])


GUARD_BYTES = 1024  # of guard on each side of a guarded view: four 256-byte L2 lines
GUARD_FILL = -21846  # 0xAAAA: no 10-bit sample
GUARDED = [(2, 64, 48), (2, 96, 64)]
GUARDED_IDS = ["k2-64x48", "k2-96x64"]


def _guarded(shape, device):
    """An int16 tensor of `shape` that starts 16 bytes past a 256-byte
    boundary, GUARD_BYTES + 16 bytes into a larger allocation whose every
    other element holds GUARD_FILL; and a function that is true while they
    all still do.  An L2 line fetched whole for the view's first or last
    rows (the box loads' promotion) takes in guard elements; no store may."""
    n = int(np.prod(shape))
    raw = torch.full((n + GUARD_BYTES + 256,), GUARD_FILL, dtype=torch.int16, device=device)
    start = ((-raw.data_ptr()) % 256 + GUARD_BYTES + 16) // 2
    view = raw[start:start + n].view(shape)
    assert view.data_ptr() % 256 == 16

    def intact():
        return bool((raw[:start] == GUARD_FILL).all()) and bool(
            (raw[start + n:] == GUARD_FILL).all())

    return view, intact


@functools.lru_cache(maxsize=None)
def _guarded_case(fmt, k, w, h):
    """k 10-bit frames of a chroma format, a random BS, its maps and
    deblock_packed_plain's output (read-only)."""
    frames = _frames([k, w, h, 16, len(fmt)], k, w, h, fmt)
    bs = _bs("random", w, h, k, fmt)
    lm, cm = _maps(bs, w, h, fmt=fmt)
    y, uv = deblock_packed_plain(*_planes(frames, h, fmt), lm, cm, get_beta(EDGE_QP),
                                 get_tc(EDGE_QP), bit_depth=10)
    return frames, bs, torch.cat([y, uv.reshape(k, -1, w)], dim=-2)


def _guarded_step(fmt, k, w, h, device, run):
    """`run(src, dst, lm, cm)` on guarded views of _guarded_case's frames,
    into a separate output and then in place: each == deblock_packed_plain,
    the source of the first untouched, and every guard element as it was.
    Returns the source view and the maps."""
    frames, bs, want = _guarded_case(fmt, k, w, h)
    lm, cm = _maps(bs, w, h, device, fmt)
    src, src_intact = _guarded(frames.shape, device)
    dst, dst_intact = _guarded(frames.shape, device)
    src.copy_(frames)
    dst.fill_(7)
    assert ck.packed_fits(w, *_planes(src, h, fmt), *_planes(dst, h, fmt), bit_depth=10)
    run(src, dst, lm, cm)
    assert src_intact() and dst_intact()
    assert torch.equal(dst.cpu(), want) and torch.equal(src.cpu(), frames)
    run(src, src, lm, cm)
    assert src_intact() and dst_intact()
    assert torch.equal(src.cpu(), want)
    return src, (lm, cm)


@pytest.mark.parametrize("k,w,h", GUARDED, ids=GUARDED_IDS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_k2_10_host_build_keeps_guard_bytes(fmt, k, w, h):
    """K2-10's g++ build on views 16 bytes past a 256-byte boundary with
    guard elements before and after == deblock_packed_plain, into a
    separate output and in place, at 4:2:0, 4:2:2 and 4:4:4, and writes no guard
    element: the zero fill at the border (Q6) and the stores' limits hold
    wherever the view lies."""
    lib = ck.load_host_library()

    def run(src, dst, lm, cm):
        assert lib.gvct_host_deblock_packed(*ck.packed_launch_args(
            *_planes(src, h, fmt), *_planes(dst, h, fmt), lm, cm, get_beta(EDGE_QP),
            get_tc(EDGE_QP), False, 10)) == 0

    _guarded_step(fmt, k, w, h, "cpu", run)


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("fmt,rows,match", [
    ("4:4:4", 2 * H, r"\(N, 144, 64\)"),
    ("4:2:2", 3 * H // 2, r"\(N, 96, 64\)"),
    ("4:2:0", 2 * H, r"\(N, 72, 64\)"),
    ("4:0:0", H, "chroma_format"),
], ids=["444", "420-buffer-at-422", "422-buffer-at-420", "400"])
def test_mesh_chroma_format_argument_errors(entry, fmt, rows, match):
    """A buffer of another format's rows (a 4:2:2 buffer at 4:4:4, a
    4:2:0 one at 4:2:2 and the reverse), and a format the port does not
    take (4:0:0), raise ValueError and leave the buffer as it was."""
    buf = torch.zeros((2, rows, W), dtype=torch.int16)
    lm, cm = _maps(_bs("ai", W, H), W, H)
    mesh = pm.make_mesh(1, 1, devices=["cpu"])
    with pytest.raises(ValueError, match=match):
        ENTRIES[entry](mesh, buf, lm, cm, get_beta(32), get_tc(32), w=W, h=H, bit_depth=10,
                       chroma_format=fmt)
    assert not buf.any()


def test_packed_wrapper_chroma_format_argument_errors():
    """K2's wrapper takes 4:2:2 planes only at chroma_format "4:2:2" and
    its (cBy, cBx) maps only; at "4:4:4" it asks for (h, w) planes, and a
    format it does not take raises."""
    buf = _frames(5, 1, W, H, "4:2:2")
    bs = _bs("ai", W, H, 0, "4:2:2")
    lm, cm = _maps(bs, W, H, fmt="4:2:2")
    y, uv = _planes(buf, H, "4:2:2")
    with pytest.raises(ValueError, match=r"uv must be \(1, 2, 48, 64\)"):
        ck.deblock_packed_cuda(y, uv, lm, cm, 26, 3, bit_depth=10, chroma_format="4:4:4")
    with pytest.raises(ValueError, match="chroma_format"):
        ck.deblock_packed_cuda(y, uv, lm, cm, 26, 3, bit_depth=10, chroma_format="4:0:0")
    with pytest.raises(ValueError, match=r"uv must be \(1, 2, 24, 32\)"):
        ck.deblock_packed_cuda(y, uv, lm, cm, 26, 3, bit_depth=10)
    with pytest.raises(ValueError, match="bs_ver1 has shape"):
        ck.deblock_packed_cuda(y, uv, lm, _maps(_bs("ai", W, H), W, H)[1], 26, 3, bit_depth=10,
                               chroma_format="4:2:2")
    new_y, new_uv = ck.deblock_packed_cuda(y, uv, lm, cm, get_beta(32), get_tc(32),
                                           bit_depth=10, chroma_format="4:2:2")
    want = ref.deblock_packed(buf, W, H, 32, bs, bit_depth=10, chroma_format="4:2:2")
    assert torch.equal(torch.cat([new_y, new_uv.reshape(1, H, W)], dim=-2), want)


@pytest.mark.parametrize("luma_only", [False, True], ids=["luma-chroma", "luma-only"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_packed_tile_counters(fmt, luma_only):
    """packed.luma_tiles and packed.chroma_tiles count the packed_grids
    tiles of every frame a packed call hands over (U and V both; none
    under luma_only), beside mesh.calls, over the slots of the mesh."""
    from gpu_video_codec_tpu_torch.utils.tracing import RECORDER

    w, h, n = 64, 48, 3
    bs = _bs("ai", w, h, 0, fmt)
    lm, cm = _maps(bs, w, h, fmt=fmt)
    buf = _frames(9, n, w, h, fmt)
    mesh = pm.make_mesh(1, 2, devices=["cpu"] * 2)
    (by, bx), (cby, cbx) = ck.packed_grids(w, h, fmt)
    assert (by, bx) == (7, 9) and (cby, cbx) == {"4:2:0": (4, 5), "4:2:2": (7, 5),
                                                 "4:4:4": (7, 9)}[fmt]
    RECORDER.reset()
    for i in range(1, 3):
        pm.deblock_packed_batch_sharded_jit(mesh, buf, lm, cm, 26, 3, w=w, h=h, bit_depth=10,
                                            chroma_format=fmt, luma_only=luma_only)
        want = {"mesh.calls": i, "packed.luma_tiles": i * n * by * bx,
                "packed.chroma_tiles": 0 if luma_only else i * n * 2 * cby * cbx}
        assert RECORDER.counters() == {k: v for k, v in want.items() if v}
    RECORDER.reset()


@pytest.mark.parametrize("fmt", FORMATS)
def test_chroma_format_is_part_of_the_graph_key(fmt, monkeypatch):
    """The mesh hands _run a static key that names the chroma format, so
    that a graph captured for one format is never replayed for the other."""
    keys = []
    real = pm._run

    def spy(mesh, index, fn, operands, static, graph, stamps=None):
        keys.append(static)
        return real(mesh, index, fn, operands, static, graph, stamps)

    monkeypatch.setattr(pm, "_run", spy)
    bs = _bs("ai", W, H, 0, fmt)
    lm, cm = _maps(bs, W, H, fmt=fmt)
    mesh = pm.make_mesh(1, 1, devices=["cpu"])
    buf = _frames(2, 1, W, H, fmt)
    pm.deblock_packed_batch_sharded_jit(mesh, buf, lm, cm, 26, 3, w=W, h=H, bit_depth=10,
                                        chroma_format=fmt)
    (key,) = keys
    assert key[0] == "packed" and key[-1] == fmt
    assert torch.equal(buf, ref.deblock_packed(_frames(2, 1, W, H, fmt), W, H, 32, bs,
                                               bit_depth=10, chroma_format=fmt))


@pytest.mark.parametrize("fmt", FORMATS)
def test_intra_default_sizes_follow_the_chroma_format(fmt):
    """BoundaryStrength.intra_default's chroma arrays are the benchmark's
    all-intra arrays of the format (sizes at the chroma plane (ch, cw),
    zero stripes), and its maps are the chroma plane's; a format the port
    does not take raises."""
    from bench_torch.lib import frames as fr

    w, h = 96, 64
    ai = BoundaryStrength.intra_default(w, h, fmt)
    bench = fr.bs_arrays(w, h, {"bs": "ai"}, 1, "cpu", fmt)
    for k in ("vert", "hor", "chroma_vert", "chroma_hor"):
        assert np.array_equal(getattr(ai, k), bench[k]), k
    from gpu_video_codec_tpu_torch.utils.bs import chroma_segment_maps

    cm = chroma_segment_maps(ai)
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(cm, _maps(bench, w, h, fmt=fmt)[1]))
    assert cm[0].shape == ck.packed_grids(w, h, fmt)[1]
    if fmt == "4:4:4":  # the chroma arrays are the luma arrays' sizes
        assert ai.chroma_vert.size == ai.vert.size and ai.chroma_hor.size == ai.hor.size
        assert all(a.shape == (h // 8 + 1, w // 8 + 1) for a in cm)
    with pytest.raises(ValueError, match="chroma_format"):
        BoundaryStrength.intra_default(w, h, "4:0:0")


@pytest.mark.parametrize("w,takes10,takes8", [(64, True, True), (720, True, False),
                                              (72, False, False)],
                         ids=["64", "720", "72-sheared"])
def test_packed_guard_422(w, takes10, takes8):
    """The guard reads the width and the planes alone, so 4:2:2 planes
    (h, w/2) of a 16-byte aligned (1, 2h, w) batch fit where 4:2:0's do."""
    h = 48
    buf = torch.zeros((1, 2 * h, w), dtype=torch.int16)
    assert ck.packed_fits(w, *_planes(buf, h, "4:2:2"), bit_depth=10) is takes10
    assert ck.packed_fits(w, *_planes(buf.to(torch.uint8), h, "4:2:2")) is takes8

# -- HEVC Main 4:4:4 (and 4:4:4 10): chroma planes (h, w) in a (N, 3h, w) buffer -------------

BIT_DEPTHS = [8, 10]
GEOMS_444 = [(64, 48), (80, 40)]  # 80: w % 32 == 16, which K2 takes at 4:4:4 alone
GEOM_IDS_444 = ["64x48", "80x40"]


@pytest.mark.parametrize("bit_depth", BIT_DEPTHS)
@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("w,h", [*GEOMS_444, (72, 40)], ids=[*GEOM_IDS_444, "72x40"])
@pytest.mark.parametrize("kind", BS_KINDS)
@pytest.mark.parametrize("qp", QPS_422)
def test_mesh_main444_matches_reference(qp, kind, w, h, entry, bit_depth):
    """The mesh's packed entries at chroma_format="4:4:4" on two CPU slots
    (3 frames: 2 and 1) == the reference at 4:4:4, byte for byte, at 8
    and 10 bits; the chroma planes, two thirds of the samples, are
    filtered.  72 (w % 16 == 8) is a width K2 refuses at 8 bits; the CPU
    slots take the plain version at every width."""
    frames, bs, want = _format_case("4:4:4", qp, kind, w, h, bit_depth)
    got = _format_step("4:4:4", entry, frames, bs, qp, w, h, bit_depth)
    assert torch.equal(got, want)
    if qp > 30:
        assert (want[:, h:] != frames[:, h:]).sum() > 100  # chroma filtered too


@pytest.mark.parametrize("bit_depth", BIT_DEPTHS)
@pytest.mark.parametrize("path", ["plain", "host"])
@pytest.mark.parametrize("w,h", [*GEOMS_444, (72, 40)], ids=[*GEOM_IDS_444, "72x40"])
@pytest.mark.parametrize("kind", BS_KINDS)
@pytest.mark.parametrize("qp", QPS_422)
def test_k2_444_paths_match_reference(qp, kind, w, h, path, bit_depth):
    """K2's and K2-10's plain version and g++ build on 4:4:4 planes (h, w)
    == the reference; the g++ build runs the grid whose U and V take grid
    rows of their own.  72 (w % 16 == 8) is a width K2-10 takes at 4:4:4
    alone (w % 8 == 0 at 10 bits); the 8-bit g++ build checks the same
    arithmetic there, a width the card's K2 refuses."""
    frames, bs, want = _format_case("4:4:4", qp, kind, w, h, bit_depth)
    assert torch.equal(_format_step("4:4:4", path, frames, bs, qp, w, h, bit_depth), want)


def _edges_444(bit_depth):
    """A 64x48 4:4:4 frame, flat luma, whose chroma holds steps at chroma
    columns (U) and rows (V) 8 and 24 -- edges of the (h, w) planes' own
    8x8 grid, at luma columns and rows 8 and 24 -- with U's edge at column
    8 and V's at row 8 set so that the one-sample filter takes both p0
    and q0 past the top sample: p1, p0 | q0, q1 = 1023, 1019 | 1003, 900
    (the 8-bit frame is the 10-bit one's quarter: 255, 254 | 250, 225)."""
    profile = torch.full((W,), 512, dtype=torch.int32)
    profile[:8] = TOP
    profile[7] = TOP - 4
    profile[8:24] = 900
    profile[8] = TOP - 20
    f = torch.full((1, 3 * H, W), 512, dtype=torch.int32)
    f[0, H : 2 * H] = profile[None, :]
    f[0, 2 * H :] = profile[:H, None]
    return f.to(torch.int16) if bit_depth == 10 else (f >> 2).to(torch.uint8)


EDGE_PATHS = [*ENTRIES, "plain", "host", pytest.param("card", marks=pytest.mark.cuda)]


@pytest.mark.parametrize("path", EDGE_PATHS)
@pytest.mark.parametrize("bit_depth", BIT_DEPTHS)
def test_main444_chroma_edges(bit_depth, path, monkeypatch, request):
    """Hand-made chroma edges at columns (U) and rows (V) 8 and 24 of a
    4:4:4 frame, BS all 2 at QP 51: every path (the card's through the
    mesh's graph replay, one launch) == the reference; in a row of U (a
    column of V) away from the other edges the samples that change are p0
    and q0 of those edges, columns 7, 8, 23 and 24 (rows of V), and the
    picture's first and last, where BS 2 filters against the zero padding
    (Q6); and the edge at 8 filters p0 and
    q0 past the top sample (1023, or 255 at 8 bits), so the clip sets the
    result (the reference without it differs)."""
    frame = _edges_444(bit_depth)
    bs = {k: np.full_like(v, 2) for k, v in _bs("ai", W, H, 0, "4:4:4").items()}
    want = ref.deblock_packed(frame, W, H, 51, bs, bit_depth=bit_depth, chroma_format="4:4:4")
    if path == "card":
        dev = request.getfixturevalue("cuda_device")
        key = ck.PACKED_LAUNCHES[bit_depth, "4:4:4"]
        before = ck.LAUNCHES[key]
        got = _format_step("4:4:4", "jit", frame.to(dev), bs, 51, W, H, bit_depth).cpu()
        assert ck.LAUNCHES[key] == before + 1  # one slot takes the frame
    else:
        got = _format_step("4:4:4", path, frame, bs, 51, W, H, bit_depth)
    assert torch.equal(got, want)
    u, v = want[0, H : 2 * H], want[0, 2 * H :]
    u0, v0 = frame[0, H : 2 * H], frame[0, 2 * H :]
    assert (u[12] != u0[12]).nonzero().flatten().tolist() == [0, 7, 8, 23, 24, W - 1]
    assert (v[:, 12] != v0[:, 12]).nonzero().flatten().tolist() == [0, 7, 8, 23, 24, H - 1]
    assert torch.equal(want[0, 8 : H - 8, 8 : W - 8], frame[0, 8 : H - 8, 8 : W - 8])  # flat
    top = (1 << bit_depth) - 1
    assert int(u[12, 7]) == int(u[12, 8]) == int(v[7, 12]) == int(v[8, 12]) == top
    monkeypatch.setattr(ref, "max_pixel", lambda bit_depth=8: 4095)
    unclipped = ref.deblock_packed(frame.to(torch.int32), W, H, 51, bs, bit_depth=bit_depth,
                                   chroma_format="4:4:4")  # int32: room above 255
    assert all(int(unclipped[0, r, c]) > top for r, c in ((H + 12, 7), (H + 12, 8),
                                                          (2 * H + 7, 12), (2 * H + 8, 12)))


@pytest.mark.parametrize("bit_depth", BIT_DEPTHS)
@pytest.mark.parametrize("fill", ["random", "zero", "two"])
@pytest.mark.parametrize("w,h", EDGE_GEOMS, ids=EDGE_IDS)
def test_k2_444_host_build_edges(w, h, fill, bit_depth):
    """K2's and K2-10's g++ build at 4:4:4 == the reference on blocks that
    end mid-row (cBx 9 and 45: one short block, and 2 x 16 + 13), on the
    picture's last chroma tile row, BS all 0, all 2 and uniform; in place
    == into a separate output."""
    frames, bs, want = _edge_case_fmt(fill, w, h, "4:4:4", bit_depth)
    lm, cm = _maps(bs, w, h, fmt="4:4:4")
    (by, bx), (cby, cbx) = ck.packed_grids(w, h, "4:4:4")
    assert (cby, cbx) == (by, bx) and cbx % ck.PACKED_TILES != 0
    lib = ck.load_host_library()
    out, inplace = torch.full_like(frames, 7), frames.clone()
    for src, dst in ((frames, out), (inplace, inplace)):
        assert lib.gvct_host_deblock_packed(*ck.packed_launch_args(
            *_planes(src, h, "4:4:4"), *_planes(dst, h, "4:4:4"), lm, cm, get_beta(EDGE_QP),
            get_tc(EDGE_QP), False, bit_depth)) == 0
    assert torch.equal(out, want) and torch.equal(inplace, want)
    assert torch.equal(want, frames) is (fill == "zero")
    if fill == "two":  # V's last tile row (rows h - 4 .. h - 1 of the plane) filters
        last = slice(3 * h - 4, 3 * h)
        assert not torch.equal(want[:, last], frames[:, last])


# K2's grid (gx, rows) for 4:2:0 and 4:2:2 frames, pinned: U and V side by
# side in a grid row, gx = max(lx, 2 cx), rows = by + cby
GRIDS_420_422 = {
    ("4:2:0", 3840, 2160): (32, 407), ("4:2:2", 3840, 2160): (32, 542),
    ("4:2:0", 1920, 1080): (16, 204), ("4:2:2", 1920, 1080): (16, 272),
    ("4:2:0", 64, 48): (2, 11), ("4:2:2", 64, 48): (2, 14),
    ("4:2:0", 352, 288): (4, 56), ("4:2:2", 352, 288): (4, 74),
}


@pytest.mark.parametrize("fmt,w,h", list(GRIDS_420_422),
                         ids=[f"{f}-{w}x{h}" for f, w, h in GRIDS_420_422])
def test_packed_grid_420_422_unchanged(fmt, w, h):
    """K2's grid for 4:2:0 and 4:2:2 frames keeps its extents (U and V
    side by side), and its blocks own every tile of the three planes once;
    under luma_only it is the luma rows alone."""
    g = ck.packed_blocks(w, h, fmt)
    (by, bx), (cby, cbx) = ck.packed_grids(w, h, fmt)
    assert (g["gx"], g["rows"]) == GRIDS_420_422[fmt, w, h]
    assert g["tiles"] == (by * bx, cby * cbx, cby * cbx)
    luma = ck.packed_blocks(w, h, fmt, luma_only=True)
    lx = -(-bx // ck.PACKED_TILES)
    assert (luma["gx"], luma["rows"], luma["empty"], luma["tiles"]) == (lx, by, 0,
                                                                        (by * bx, 0, 0))


@pytest.mark.parametrize("w,h", [(3840, 2160), (1920, 1080), (64, 48), (352, 288),
                                 (4096, 2160), (80, 40)],
                         ids=["3840x2160", "1920x1080", "64x48", "352x288", "4096x2160",
                              "80x40"])
def test_packed_grid_444_leaves_no_block_empty(w, h):
    """At 4:4:4 U and V take grid rows of their own: the grid is lx blocks
    wide and by + 2 cby rows, no block lies past its row's end, only each
    row's last block may be short, and the blocks own every tile once.  At
    4K: 25,203 blocks, where U and V side by side would launch 33,604 with
    8,401 empty."""
    g = ck.packed_blocks(w, h, "4:4:4")
    (by, bx), (cby, cbx) = ck.packed_grids(w, h, "4:4:4")
    lx = -(-bx // ck.PACKED_TILES)
    assert (cby, cbx) == (by, bx)
    assert (g["gx"], g["rows"], g["empty"]) == (lx, 3 * by, 0)
    assert g["short"] == (g["rows"] if bx % ck.PACKED_TILES else 0)
    assert g["tiles"] == (by * bx,) * 3
    if (w, h) == (3840, 2160):
        assert g["blocks"] == 25_203 and 2 * lx * (by + cby) - g["blocks"] == 8_401


@pytest.mark.parametrize("w,takes10,takes8", [(64, True, True), (80, True, True),
                                              (720, True, True), (72, True, False),
                                              (3840, True, True)],
                         ids=["64", "80", "720", "72", "3840"])
def test_packed_guard_444(w, takes10, takes8):
    """At 4:4:4 the chroma rows are as wide as the luma rows, so the guard
    keeps the luma rows' rule alone: w % 16 == 0 at 8 bits, w % 8 == 0 at
    10 (16-bit samples), on a 16-byte aligned (1, 3h, w) batch; 4:2:0 keeps
    w % 32 at 8 bits."""
    h = 40
    buf = torch.zeros((1, 3 * h, w), dtype=torch.int16)
    assert ck.packed_fits(w, *_planes(buf, h, "4:4:4"), bit_depth=10,
                          chroma_format="4:4:4") is takes10
    assert ck.packed_fits(w, *_planes(buf.to(torch.uint8), h, "4:4:4"),
                          chroma_format="4:4:4") is takes8
    assert ck.packed_width(8, "4:4:4") == 16 and ck.packed_width(10, "4:4:4") == 8
    assert ck.packed_fits(w) is (w % 32 == 0)


# -- the card ---------------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _launches():
    return {k: ck.LAUNCHES[k] for k in ("packed", "packed10", "luma", "chroma")}


def _card_case(k, w, h, dev, qp=32):
    frames = _frames([k, w, h], k, w, h).to(dev)
    bs = _bs("random", w, h, k)
    return frames, bs, _maps(bs, w, h, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("k,w,h", [(4, 3840, 2160), (2, 720, 576), (3, 64, 48)],
                         ids=["k4-2160p", "k2-720x576", "k3-64x48"])
def test_k2_10_matches_plain_on_card(cuda_device, k, w, h):
    """K2-10 through the mesh's graph replay == the plain path on the card,
    one K2-10 launch a call; on the buffer's views through the wrapper, in
    place and into new planes; and == the reference below 4K."""
    qp = 32
    frames, bs, (lm, cm) = _card_case(k, w, h, cuda_device, qp)
    want = _plain_step(frames, bs, qp, w, h)
    mesh = pm.make_mesh(1, 1, devices=[cuda_device])
    for _ in range(2):  # the call that captures, then a replay
        buf = frames.clone()
        before = _launches()
        pm.deblock_packed_batch_sharded_jit(mesh, buf, lm, cm, get_beta(qp), get_tc(qp), w=w,
                                            h=h, bit_depth=10)
        torch.cuda.synchronize()
        assert {n: v - before[n] for n, v in _launches().items()} == {
            "packed": 0, "packed10": 1, "luma": 0, "chroma": 0}
        assert torch.equal(buf, want)
    y, uv = _planes(frames, h)
    new_y, new_uv = ck.deblock_packed_cuda(y, uv, lm, cm, get_beta(qp), get_tc(qp),
                                           bit_depth=10)
    assert torch.equal(torch.cat([new_y, new_uv.reshape(k, h // 2, w)], dim=-2), want)
    if w <= 720:
        assert torch.equal(want.cpu(), ref.deblock_packed(frames.cpu(), w, h, qp, bs,
                                                          bit_depth=10))


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["random", "zero", "two"])
@pytest.mark.parametrize("content", ["noise", "pinned"])
@pytest.mark.parametrize("w,h", EDGE_GEOMS, ids=EDGE_IDS)
def test_k2_10_edges_on_card(cuda_device, w, h, content, fill):
    """K2-10 on test_k2_10_host_build_edges' cases == the reference and the
    plain path, in place == into a separate output, one K2-10 launch each."""
    frames, bs, want = _edge_case(content, fill, w, h)
    lm, cm = _maps(bs, w, h, cuda_device)
    src = frames.to(cuda_device)
    out, inplace = torch.full_like(src, 7), src.clone()
    before = _launches()
    for s, d in ((src, out), (inplace, inplace)):
        ck.deblock_packed_cuda(*_planes(s, h), lm, cm, get_beta(EDGE_QP), get_tc(EDGE_QP),
                               out=_planes(d, h), bit_depth=10)
    torch.cuda.synchronize()
    assert {n: v - before[n] for n, v in _launches().items()} == {
        "packed": 0, "packed10": 2, "luma": 0, "chroma": 0}
    assert torch.equal(out, inplace)
    assert torch.equal(out.cpu(), want)
    assert torch.equal(out, _plain_step(src, bs, EDGE_QP, w, h))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_k2_10_sheared_or_misaligned_raises_on_card(cuda_device, entry):
    """A 10-bit width K2-10 cannot take, or a buffer off 16 bytes, raises
    ValueError on the card and leaves the buffer as it was; the card then
    still runs K2-10."""
    w, h = 360, 288
    frames, bs, (lm, cm) = _card_case(1, w, h, cuda_device)
    mesh = pm.make_mesh(1, 1, devices=[cuda_device])
    before = frames.clone()
    with pytest.raises(ValueError, match="K2-10 takes w % 16 == 0"):
        ENTRIES[entry](mesh, frames, lm, cm, get_beta(32), get_tc(32), w=w, h=h, bit_depth=10)
    raw = torch.zeros(3 * H // 2 * W + 8, dtype=torch.int16, device=cuda_device)
    buf = raw[4 : 4 + 3 * H // 2 * W].view(1, 3 * H // 2, W)  # 8 bytes off
    buf.copy_(_frames(3, 1, W, H))
    lm, cm = _maps(_bs("ai", W, H), W, H, cuda_device)
    with pytest.raises(ValueError, match="K2-10"):
        ENTRIES[entry](mesh, buf, lm, cm, get_beta(32), get_tc(32), w=W, h=H, bit_depth=10)
    torch.cuda.synchronize()
    assert torch.equal(frames, before) and torch.equal(buf.cpu(), _frames(3, 1, W, H))
    good = buf.clone()
    ENTRIES[entry](mesh, good, lm, cm, get_beta(32), get_tc(32), w=W, h=H, bit_depth=10)
    assert torch.equal(good.cpu(), ref.deblock_packed(buf.cpu(), W, H, 32, _bs("ai", W, H),
                                                      bit_depth=10))


@pytest.mark.cuda
def test_k2_10_info_on_card(cuda_device):
    info = ck.deblock_packed_info(cuda_device, bit_depth=10)
    assert info["threads"] == 4 * ck.PACKED_TILES and info["registers"] <= 64
    assert info["blocks_per_sm"] >= 8 and info["smem_bytes"] >= 8 * 272


@pytest.mark.cuda
@pytest.mark.parametrize("k,w,h,bit_depth", [(4, 3840, 2160, 10), (2, 720, 576, 10),
                                             (3, 64, 48, 8)],
                         ids=["k4-2160p", "k2-720x576", "k3-64x48-8bit"])
def test_k2_422_matches_plain_on_card(cuda_device, k, w, h, bit_depth):
    """K2-10 (and K2 at 8 bits) at 4:2:2 through the mesh's graph replay ==
    the plain path on the card, one launch a call under "packed10_422" (or
    "packed_422"); through the wrapper on the buffer's views; and == the
    reference below 4K.  The 4K case is the benchmark cell's shape: an
    int16 (4, 4320, 3840) buffer."""
    qp = 32
    frames = _frames([k, w, h, 422], k, w, h, "4:2:2").to(cuda_device)
    if bit_depth == 8:
        frames = (frames >> 2).to(torch.uint8)
    bs = _bs("random", w, h, k, "4:2:2")
    lm, cm = _maps(bs, w, h, cuda_device, "4:2:2")
    y, uv = _planes(frames, h, "4:2:2")
    want_y, want_uv = deblock_packed_plain(y, uv, lm, cm, get_beta(qp), get_tc(qp),
                                           bit_depth=bit_depth)
    want = torch.cat([want_y, want_uv.reshape(k, h, w)], dim=-2)
    key = "packed10_422" if bit_depth == 10 else "packed_422"
    mesh = pm.make_mesh(1, 1, devices=[cuda_device])
    for _ in range(2):  # the call that captures, then a replay
        buf = frames.clone()
        before = dict(ck.LAUNCHES)
        pm.deblock_packed_batch_sharded_jit(mesh, buf, lm, cm, get_beta(qp), get_tc(qp), w=w,
                                            h=h, bit_depth=bit_depth, chroma_format="4:2:2")
        torch.cuda.synchronize()
        assert {n: v - before[n] for n, v in ck.LAUNCHES.items() if v != before[n]} == {key: 1}
        assert torch.equal(buf, want)
    new_y, new_uv = ck.deblock_packed_cuda(y, uv, lm, cm, get_beta(qp), get_tc(qp),
                                           bit_depth=bit_depth, chroma_format="4:2:2")
    assert torch.equal(torch.cat([new_y, new_uv.reshape(k, h, w)], dim=-2), want)
    if w <= 720:
        assert torch.equal(want.cpu(), ref.deblock_packed(frames.cpu(), w, h, qp, bs,
                                                          bit_depth=bit_depth,
                                                          chroma_format="4:2:2"))


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["random", "zero", "two"])
@pytest.mark.parametrize("w,h", EDGE_GEOMS, ids=EDGE_IDS)
def test_k2_10_422_edges_on_card(cuda_device, w, h, fill):
    """K2-10 at 4:2:2 on test_k2_10_422_host_build_edges' cases == the
    reference, in place == into a separate output, one launch each."""
    frames, bs, want = _edge_case_fmt(fill, w, h)
    lm, cm = _maps(bs, w, h, cuda_device, "4:2:2")
    src = frames.to(cuda_device)
    out, inplace = torch.full_like(src, 7), src.clone()
    before = ck.LAUNCHES["packed10_422"]
    for s_, d in ((src, out), (inplace, inplace)):
        ck.deblock_packed_cuda(*_planes(s_, h, "4:2:2"), lm, cm, get_beta(EDGE_QP),
                               get_tc(EDGE_QP), out=_planes(d, h, "4:2:2"), bit_depth=10,
                               chroma_format="4:2:2")
    torch.cuda.synchronize()
    assert ck.LAUNCHES["packed10_422"] == before + 2
    assert torch.equal(out, inplace) and torch.equal(out.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("k,w,h", GUARDED, ids=GUARDED_IDS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_k2_10_keeps_guard_bytes_on_card(cuda_device, fmt, k, w, h):
    """K2-10 at 4:2:0, 4:2:2 and 4:4:4 on views 16 bytes past a 256-byte
    boundary, with guard elements before and after, == deblock_packed_plain into a
    separate output, in place and into new planes, one launch each, and no
    guard element changes: the box loads' L2 promotion fetches whole lines
    past the planes' ends, and the zero fill at the border (Q6) and the
    stores' limits still hold."""
    key = ck.PACKED_LAUNCHES[(10, fmt)]
    before = ck.LAUNCHES[key]

    def run(src, dst, lm, cm):
        ck.deblock_packed_cuda(*_planes(src, h, fmt), lm, cm, get_beta(EDGE_QP),
                               get_tc(EDGE_QP), out=_planes(dst, h, fmt), bit_depth=10,
                               chroma_format=fmt)
        torch.cuda.synchronize()

    src, (lm, cm) = _guarded_step(fmt, k, w, h, cuda_device, run)
    frames, _, want = _guarded_case(fmt, k, w, h)
    src.copy_(frames)
    new_y, new_uv = ck.deblock_packed_cuda(*_planes(src, h, fmt), lm, cm, get_beta(EDGE_QP),
                                           get_tc(EDGE_QP), bit_depth=10, chroma_format=fmt)
    assert ck.LAUNCHES[key] == before + 3
    assert torch.equal(torch.cat([new_y, new_uv.reshape(k, -1, w)], dim=-2).cpu(), want)
    assert torch.equal(src.cpu(), frames)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_k2_10_422_misaligned_raises_on_card(cuda_device, entry):
    """A 4:2:2 view off 16 bytes, or a sheared width, raises ValueError on
    the card (no 4:2:2 chain) and leaves the buffer as it was; the aligned
    buffer then filters as the reference does."""
    mesh = pm.make_mesh(1, 1, devices=[cuda_device])
    bs = _bs("ai", W, H, 0, "4:2:2")
    lm, cm = _maps(bs, W, H, cuda_device, "4:2:2")
    n = 2 * H * W
    raw = torch.zeros(n + 8, dtype=torch.int16, device=cuda_device)
    buf = raw[4 : 4 + n].view(1, 2 * H, W)  # 8 bytes off
    buf.copy_(_frames(3, 1, W, H, "4:2:2"))
    with pytest.raises(ValueError, match="K2-10"):
        ENTRIES[entry](mesh, buf, lm, cm, get_beta(32), get_tc(32), w=W, h=H, bit_depth=10,
                       chroma_format="4:2:2")
    sw, sh = 360, 288
    sheared = _frames(4, 1, sw, sh, "4:2:2").to(cuda_device)
    slm, scm = _maps(_bs("ai", sw, sh, 0, "4:2:2"), sw, sh, cuda_device, "4:2:2")
    with pytest.raises(ValueError, match="K2-10 takes w % 16 == 0"):
        ENTRIES[entry](mesh, sheared, slm, scm, get_beta(32), get_tc(32), w=sw, h=sh,
                       bit_depth=10, chroma_format="4:2:2")
    torch.cuda.synchronize()
    assert torch.equal(buf.cpu(), _frames(3, 1, W, H, "4:2:2"))
    assert torch.equal(sheared.cpu(), _frames(4, 1, sw, sh, "4:2:2"))
    good = buf.clone()
    ENTRIES[entry](mesh, good, lm, cm, get_beta(32), get_tc(32), w=W, h=H, bit_depth=10,
                   chroma_format="4:2:2")
    assert torch.equal(good.cpu(), ref.deblock_packed(buf.cpu(), W, H, 32, bs, bit_depth=10,
                                                      chroma_format="4:2:2"))


@pytest.mark.cuda
@pytest.mark.parametrize("k,w,h,bit_depth", [(4, 3840, 2160, 8), (4, 3840, 2160, 10),
                                             (2, 720, 576, 8), (3, 80, 40, 8),
                                             (3, 64, 48, 10), (3, 72, 40, 10)],
                         ids=["k4-2160p", "k4-2160p-10bit", "k2-720x576", "k3-80x40",
                              "k3-64x48-10bit", "k3-72x40-10bit"])
def test_k2_444_matches_plain_on_card(cuda_device, k, w, h, bit_depth):
    """K2 (and K2-10 at 10 bits) at 4:4:4 through the mesh's graph replay
    == the plain path on the card, one launch a call under "packed_444"
    (or "packed10_444"); through the wrapper on the buffer's views; and ==
    the reference below 4K.  The 8-bit 4K case is the benchmark cell's
    shape: a uint8 (4, 6480, 3840) buffer; 720 and 80 are w % 32 == 16,
    and 72 is w % 16 == 8, which K2-10 takes at 4:4:4 alone."""
    qp = 32
    frames = _frames([k, w, h, 444], k, w, h, "4:4:4").to(cuda_device)
    if bit_depth == 8:
        frames = (frames >> 2).to(torch.uint8)
    bs = _bs("random", w, h, k, "4:4:4")
    lm, cm = _maps(bs, w, h, cuda_device, "4:4:4")
    y, uv = _planes(frames, h, "4:4:4")
    want_y, want_uv = deblock_packed_plain(y, uv, lm, cm, get_beta(qp), get_tc(qp),
                                           bit_depth=bit_depth)
    want = torch.cat([want_y, want_uv.reshape(k, 2 * h, w)], dim=-2)
    key = ck.PACKED_LAUNCHES[bit_depth, "4:4:4"]
    mesh = pm.make_mesh(1, 1, devices=[cuda_device])
    for _ in range(2):  # the call that captures, then a replay
        buf = frames.clone()
        before = dict(ck.LAUNCHES)
        pm.deblock_packed_batch_sharded_jit(mesh, buf, lm, cm, get_beta(qp), get_tc(qp), w=w,
                                            h=h, bit_depth=bit_depth, chroma_format="4:4:4")
        torch.cuda.synchronize()
        assert {n: v - before[n] for n, v in ck.LAUNCHES.items() if v != before[n]} == {key: 1}
        assert torch.equal(buf, want)
    new_y, new_uv = ck.deblock_packed_cuda(y, uv, lm, cm, get_beta(qp), get_tc(qp),
                                           bit_depth=bit_depth, chroma_format="4:4:4")
    assert torch.equal(torch.cat([new_y, new_uv.reshape(k, 2 * h, w)], dim=-2), want)
    if w <= 720:
        assert torch.equal(want.cpu(), ref.deblock_packed(frames.cpu(), w, h, qp, bs,
                                                          bit_depth=bit_depth,
                                                          chroma_format="4:4:4"))


@pytest.mark.cuda
@pytest.mark.parametrize("bit_depth", BIT_DEPTHS)
@pytest.mark.parametrize("fill", ["random", "zero", "two"])
@pytest.mark.parametrize("w,h", EDGE_GEOMS, ids=EDGE_IDS)
def test_k2_444_edges_on_card(cuda_device, w, h, fill, bit_depth):
    """K2 and K2-10 at 4:4:4 on test_k2_444_host_build_edges' cases == the
    reference, in place == into a separate output, one launch each."""
    frames, bs, want = _edge_case_fmt(fill, w, h, "4:4:4", bit_depth)
    lm, cm = _maps(bs, w, h, cuda_device, "4:4:4")
    src = frames.to(cuda_device)
    out, inplace = torch.full_like(src, 7), src.clone()
    key = ck.PACKED_LAUNCHES[bit_depth, "4:4:4"]
    before = ck.LAUNCHES[key]
    for s_, d in ((src, out), (inplace, inplace)):
        ck.deblock_packed_cuda(*_planes(s_, h, "4:4:4"), lm, cm, get_beta(EDGE_QP),
                               get_tc(EDGE_QP), out=_planes(d, h, "4:4:4"),
                               bit_depth=bit_depth, chroma_format="4:4:4")
    torch.cuda.synchronize()
    assert ck.LAUNCHES[key] == before + 2
    assert torch.equal(out, inplace) and torch.equal(out.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_k2_444_misaligned_raises_on_card(cuda_device, entry):
    """A 4:4:4 view off 16 bytes, or an 8-bit width off 16 (72), raises
    ValueError on the card (no 4:4:4 chain) and leaves the buffer as it
    was; the aligned buffer then filters as the reference does."""
    mesh = pm.make_mesh(1, 1, devices=[cuda_device])
    bs = _bs("ai", W, H, 0, "4:4:4")
    lm, cm = _maps(bs, W, H, cuda_device, "4:4:4")
    n = 3 * H * W
    raw = torch.zeros(n + 8, dtype=torch.uint8, device=cuda_device)
    buf = raw[8 : 8 + n].view(1, 3 * H, W)  # 8 bytes off
    src = (_frames(3, 1, W, H, "4:4:4") >> 2).to(torch.uint8)
    buf.copy_(src)
    with pytest.raises(ValueError, match="K2 takes w % 16 == 0 at chroma_format 4:4:4"):
        ENTRIES[entry](mesh, buf, lm, cm, get_beta(32), get_tc(32), w=W, h=H,
                       chroma_format="4:4:4")
    sw, sh = 72, 40
    narrow = (_frames(4, 1, sw, sh, "4:4:4") >> 2).to(torch.uint8).to(cuda_device)
    slm, scm = _maps(_bs("ai", sw, sh, 0, "4:4:4"), sw, sh, cuda_device, "4:4:4")
    with pytest.raises(ValueError, match="no 4:4:4 chain: K2 takes w % 16 == 0"):
        ENTRIES[entry](mesh, narrow, slm, scm, get_beta(32), get_tc(32), w=sw, h=sh,
                       chroma_format="4:4:4")
    torch.cuda.synchronize()
    assert torch.equal(buf.cpu(), src)
    assert torch.equal(narrow.cpu(), (_frames(4, 1, sw, sh, "4:4:4") >> 2).to(torch.uint8))
    good = buf.clone()
    ENTRIES[entry](mesh, good, lm, cm, get_beta(32), get_tc(32), w=W, h=H,
                   chroma_format="4:4:4")
    assert torch.equal(good.cpu(), ref.deblock_packed(src, W, H, 32, bs, chroma_format="4:4:4"))
