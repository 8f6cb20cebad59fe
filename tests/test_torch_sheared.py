"""Sheared chroma (quirk Q9, w % 16 == 8) through T2 and T3 alone.

The reference sweeps chroma over the flat (vh, vw) view of the padded plane
(utils/tiles.py split_covered).  T2 and T3 address that view themselves
(flat=True, csrc/relayout_tile.cuh), reading from and writing to the
interior planes, and copy the flat tail past it out and back (rem), so
that no F.pad, torch.stack, torch.cat, .contiguous() or copy_ of the
chroma planes runs outside the kernels' wrappers on any sheared path: the
streaming step, the resident ingest/readback, the chain's own calls
(ops/chain.tile_chain: deblock_frame_cuda's U+V) and DeblockPipeline.batch.

Here on the CPU: the kernels' block loops (g++ build of csrc/host_shim.cpp)
against split_covered_data + plane_to_tiles_plain at every 16-byte address
residue, and spy tests of each path (their wrappers then run the plain
versions) against the golden oracle.  Tests marked `cuda` launch the
kernels and skip without a card; this file imports nothing of JAX, so they
also run where JAX is not installed
(`python -m pytest tests/test_torch_sheared.py -m cuda`).  Every comparison
is byte-equal."""

import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gpu_video_codec_tpu_torch.models.golden import deblock_frame_golden
from gpu_video_codec_tpu_torch.ops import chain
from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck
from gpu_video_codec_tpu_torch.ops import relayout_kernel as rk
from gpu_video_codec_tpu_torch.ops.tables import get_beta, get_tc
from gpu_video_codec_tpu_torch.utils.bs import BoundaryStrength
from gpu_video_codec_tpu_torch.utils.tiles import split_covered_data, tiles_to_plane
from gpu_video_codec_tpu_torch.utils.yuv import (
    FramePlanes, extend_plane, planes_from_yv12_bytes, yv12_bytes_from_planes,
)

CWS = (4, 12, 20, 180)  # chroma widths: w % 16 == 8, from 8x8 frames to 360-wide
SHEARED = [(40, 24), (360, 288)]


def _RESIDUE_FORMS(cw):
    """(lead, h, w, pad): a sheared chroma plane whose flat tail holds
    interior rows (h % 8 == 4), a U+V pair whose tail is padding, and an
    extended U+V pair (pad 0, as deblock_frame_cuda has them)."""
    return (((), 12, cw, 4), ((2,), 8, cw, 4), ((2,), 20, cw + 8, 0))


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    return rk.load_host_library()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _at_residue(rng, shape, off, device="cpu", row_pad=3):
    """A random uint8 view of `shape` that starts `off` bytes past a 16-byte
    boundary, rows row_pad bytes wider than long, outer strides one byte
    more than the extent inside them.  Returns (view, the whole buffer)."""
    strides = [shape[-1] + row_pad, 1]
    for n in reversed(shape[1:-1]):
        strides.insert(0, strides[0] * n + 1)
    size = off + sum((n - 1) * st for n, st in zip(shape, strides)) + 1 + 64
    big = torch.empty(size + 16, dtype=torch.uint8, device=device)
    big.copy_(torch.from_numpy(rng.integers(0, 256, size + 16, dtype=np.uint8)))
    start = off - big.data_ptr() % 16 + (16 if big.data_ptr() % 16 > off else 0)
    view = torch.as_strided(big, shape, strides, storage_offset=start)
    assert view.data_ptr() % 16 == off
    return view, big


def _expect(big, view, value):
    want = big.clone()
    torch.as_strided(want, view.shape, view.stride(), view.storage_offset()).copy_(value)
    return want


def _reference_tiles(x, pad):
    """The flat view's tiles the long way: pad, split_covered_data, T2's
    plain version with pad 0 on the covered core."""
    core, rem = split_covered_data(F.pad(x, (pad, pad, pad, pad)))
    return rk.plane_to_tiles_plain(core.contiguous(), 0), rem.contiguous()


def _round_trip(rng, run_t2, run_t3, lead, ch, cw, pad, p_off, t_off, device="cpu"):
    """T2 (flat, with the tail) from a plane view at residue p_off into a
    tile view at t_off, then T3 back into a plane view: with the tail
    (rem) and without it (the tail's interior bytes keep the destination's
    own); bytes outside each destination view never change."""
    vh, vw, n = rk.flat_view(ch, cw, pad)
    x, _ = _at_residue(rng, (*lead, ch, cw), p_off, device)
    t, tbig = _at_residue(rng, (*lead, 8, 8, vh // 8, vw // 8), t_off, device)
    rem = torch.zeros((*lead, n), dtype=torch.uint8, device=device)
    want_t, want_rem = _reference_tiles(x, pad)
    want = _expect(tbig, t, want_t)
    run_t2(x, t, rem)
    assert torch.equal(tbig, want), ("T2", lead, ch, cw, pad, p_off, t_off)
    assert torch.equal(rem, want_rem), ("T2 tail", lead, ch, cw, pad)
    tiles = torch.randint(0, 256, t.shape, dtype=torch.uint8, device=device)
    for with_rem in (True, False):
        back, bbig = _at_residue(rng, (*lead, ch, cw), p_off, device)
        ext = F.pad(back, (pad, pad, pad, pad))
        core, tail = split_covered_data(ext)
        core.copy_(tiles_to_plane(tiles[..., : vh // 8, : vw // 8]))
        if with_rem:
            tail.copy_(rem)
        want = _expect(bbig, back, ext[..., pad : pad + ch, pad : pad + cw])
        run_t3(tiles, back, rem if with_rem else None)
        assert torch.equal(bbig, want), ("T3", with_rem, lead, ch, cw, pad, p_off, t_off)


@pytest.mark.parametrize("off", range(16))
@pytest.mark.parametrize("cw", CWS)
def test_host_flat_relayout_every_residue(host_lib, cw, off):
    """The flat view's block loops (1 thread and the kernel's 128) at every
    address residue on the plane side and the tile side, pad 4 (sheared
    chroma) and pad 0 (extended planes), one plane and a U+V pair, with
    chroma heights whose flat tail holds interior rows (ch % 8 == 4) and
    does not."""
    rng = np.random.default_rng(1000 * cw + off)
    for threads in (1, rk.HOST_THREADS):
        for lead, ch, gw, pad in _RESIDUE_FORMS(cw):
            def t2(x, t, rem):
                vh, vw, _ = rk.flat_view(ch, gw, pad)
                assert host_lib.gvct_host_relayout_flat(
                    threads, 0, x.data_ptr(), t.data_ptr(),
                    *rk._geom_args(x, t, ch, gw, pad, vh // 8, vw // 8),
                    *rk._flat_args(True, rem)) == 0

            def t3(tiles, back, rem):
                vh, vw, _ = rk.flat_view(ch, gw, pad)
                assert host_lib.gvct_host_relayout_flat(
                    threads, 1, tiles.data_ptr(), back.data_ptr(),
                    *rk._geom_args(back, tiles, ch, gw, pad, vh // 8, vw // 8),
                    *rk._flat_args(True, rem)) == 0

            _round_trip(rng, t2, t3, lead, ch, gw, pad, off, (7 * off + cw) % 16)


def test_host_flat_on_8_aligned_planes_is_the_rows_view(host_lib, rng):
    """With an 8-aligned extended width the flat view is the first vh rows:
    flat=True takes the kernels' row path and only adds the tail (1080p
    chroma's 548 extended rows: 544 tiled, 4 in the tail)."""
    for ch, cw, pad in ((540, 960, 4), (548, 968, 0), (13, 16, 0)):
        x = torch.from_numpy(rng.integers(0, 256, (2, ch, cw), dtype=np.uint8))
        vh, vw, n = rk.flat_view(ch, cw, pad)
        assert vw == cw + 2 * pad and n == (ch + 2 * pad - vh) * vw
        t = torch.zeros((2, 8, 8, vh // 8, vw // 8), dtype=torch.uint8)
        rem = torch.zeros((2, n), dtype=torch.uint8)
        assert host_lib.gvct_host_relayout_flat(
            rk.HOST_THREADS, 0, x.data_ptr(), t.data_ptr(),
            *rk._geom_args(x, t, ch, cw, pad, vh // 8, vw // 8), *rk._flat_args(True, rem)) == 0
        want_t, want_rem = _reference_tiles(x, pad)
        assert torch.equal(t, want_t) and torch.equal(rem, want_rem)
        back = torch.zeros_like(x)
        assert host_lib.gvct_host_relayout_flat(
            rk.HOST_THREADS, 1, t.data_ptr(), back.data_ptr(),
            *rk._geom_args(back, t, ch, cw, pad, vh // 8, vw // 8),
            *rk._flat_args(True, rem)) == 0
        assert torch.equal(back, x)
        # a grid padded past the view by a tile row and two tile columns
        byg, bxg = vh // 8 + 1, vw // 8 + 2
        t = torch.full((2, 8, 8, byg, bxg), 7, dtype=torch.uint8)
        assert host_lib.gvct_host_relayout_flat(
            1, 0, x.data_ptr(), t.data_ptr(), *rk._geom_args(x, t, ch, cw, pad, byg, bxg),
            *rk._flat_args(True, None)) == 0
        assert torch.equal(t, rk.plane_to_tiles_plain(x, pad, byg, bxg, flat=True))
        back = torch.zeros_like(x)
        assert host_lib.gvct_host_relayout_flat(
            1, 1, t.data_ptr(), back.data_ptr(), *rk._geom_args(back, t, ch, cw, pad, byg, bxg),
            *rk._flat_args(True, rem)) == 0
        assert torch.equal(back, x)


def test_host_flat_refuses_bad_arguments(host_lib):
    x = torch.zeros((12, 20), dtype=torch.uint8)
    t = torch.zeros((8, 8, 2, 3), dtype=torch.uint8)
    rem = torch.zeros(64, dtype=torch.uint8)
    args = rk._geom_args(x, t, 12, 20, 4, 2, 3)
    assert host_lib.gvct_host_relayout_flat(1, 0, x.data_ptr(), t.data_ptr(), *args,
                                            1, None, 0, 0) == 0
    # a tail buffer on the rows view, a flat flag other than 0/1, a grid
    # smaller than the view's tiles, a negative tail stride
    assert host_lib.gvct_host_relayout_flat(1, 0, x.data_ptr(), t.data_ptr(), *args,
                                            0, rem.data_ptr(), 0, 0) == -1
    assert host_lib.gvct_host_relayout_flat(1, 0, x.data_ptr(), t.data_ptr(), *args,
                                            2, None, 0, 0) == -1
    small = list(args)
    small[4] = 2
    assert host_lib.gvct_host_relayout_flat(1, 0, x.data_ptr(), t.data_ptr(), *small,
                                            1, None, 0, 0) == -1
    assert host_lib.gvct_host_relayout_flat(1, 0, x.data_ptr(), t.data_ptr(), *args,
                                            1, rem.data_ptr(), -1, 0) == -1
    # the rows view still refuses a sheared plane
    assert host_lib.gvct_host_relayout(1, 0, x.data_ptr(), t.data_ptr(), *args) == -1


@pytest.mark.parametrize("h,w,pad", [(12, 20, 4), (8, 4, 4), (144, 180, 4), (20, 28, 0),
                                     (548, 968, 0), (540, 960, 4), (13, 16, 0), (3, 9, 1)])
def test_flat_view_and_tail_holds_interior(h, w, pad):
    """flat_view against split_covered, tail_holds_interior against the
    tail's bytes of a plane whose interior is 1 and padding 0."""
    ones = torch.ones((h, w), dtype=torch.uint8)
    core, rem = split_covered_data(F.pad(ones, (pad, pad, pad, pad)))
    assert rk.flat_view(h, w, pad) == (*core.shape, rem.numel())
    assert rk.tail_holds_interior(h, w, pad) == bool(rem.any())


def test_wrappers_flat_round_trip_and_checks(rng):
    """The wrappers' flat view on CPU tensors (their plain versions): a
    round trip through the tail, the U-over-V stack, and the checks."""
    uv = torch.from_numpy(rng.integers(0, 256, (2, 12, 20), dtype=np.uint8))
    vh, vw, n = rk.flat_view(12, 20, 4)
    rem = torch.empty((2, n), dtype=torch.uint8)
    t = rk.plane_to_tiles_cuda(uv, 4, flat=True, rem_out=rem)
    assert t.shape == (2, 8, 8, vh // 8, vw // 8)
    want_t, want_rem = _reference_tiles(uv, 4)
    assert torch.equal(t, want_t) and torch.equal(rem, want_rem)
    stack = torch.zeros((8, 8, 2, vh // 8, vw // 8), dtype=torch.uint8)
    rk.plane_to_tiles_cuda(uv, 4, out=stack.movedim(2, 0), flat=True)
    assert torch.equal(stack.movedim(2, 0), t)
    assert torch.equal(rk.tiles_to_plane_cuda(t, 4, 12, 20, flat=True, rem=rem), uv)
    keep = uv.clone()
    assert rk.tiles_to_plane_cuda(t, 4, 12, 20, out=uv, flat=True) is uv  # in place
    assert torch.equal(uv, keep)
    with pytest.raises(ValueError, match="needs rem"):
        rk.tiles_to_plane_cuda(t, 4, 12, 20, flat=True)  # the tail holds rows 11, 12
    with pytest.raises(ValueError, match="flat=True"):
        rk.plane_to_tiles_cuda(uv, 4, rem_out=rem)
    with pytest.raises(ValueError, match="rem_out has shape"):
        rk.plane_to_tiles_cuda(uv, 4, flat=True, rem_out=rem[:, 1:])
    with pytest.raises(ValueError, match="extended width"):
        rk.plane_to_tiles_cuda(uv, 4)  # the rows view refuses a sheared plane
    with pytest.raises(ValueError, match="holds no tile"):
        rk.plane_to_tiles_cuda(uv[..., :2, :3], 0, flat=True)


# -- spy tests: each sheared path through T2/T3 and nothing else ----------------

class _Spy:
    """Counts T2, T3, T4, deblock and K2 (the packed step's one kernel)
    calls and bans, outside the kernels' wrappers, the layout work they
    replace: F.pad, torch.stack, torch.cat, Tensor.contiguous, Tensor.copy_
    (copy=False) and the plain relayouts."""

    def __init__(self, monkeypatch, copy=False):
        from gpu_video_codec_tpu_torch.models import streaming as st
        from gpu_video_codec_tpu_torch.utils import tiles as ut

        self.calls = {"T2": 0, "T3": 0, "T4": 0, "deblock": 0, "K2": 0}
        self.inside = 0
        wrapped = [self._counted(kind, getattr(mod, name)) for mod, name, kind in (
            (rk, "plane_to_tiles_cuda", "T2"), (rk, "tiles_to_plane_cuda", "T3"),
            (rk, "pack_yv12_cuda", "T4"), (ck, "deblock_tiles_cuda", "deblock"),
            (ck, "deblock_packed_cuda", "K2"))]
        for fn, name in zip(wrapped, ("plane_to_tiles_cuda", "tiles_to_plane_cuda",
                                      "pack_yv12_cuda", "deblock_tiles_cuda",
                                      "deblock_packed_cuda")):
            for mod in (rk, ck, st):  # where the paths look the wrappers up
                if hasattr(mod, name):
                    monkeypatch.setattr(mod, name, fn)
        monkeypatch.setitem(chain.KERNELS, "cuda", tuple(wrapped[:4]))
        banned = [(F, "pad"), (torch, "stack"), (torch, "cat"), (torch.Tensor, "contiguous"),
                  (ut, "plane_to_tiles"), (ut, "tiles_to_plane"), (ut, "join_covered"),
                  (ut, "split_covered_data"), (rk, "plane_to_tiles_plain"),
                  (rk, "tiles_to_plane_plain")]
        if not copy:
            banned.append((torch.Tensor, "copy_"))
        for mod, name in banned:
            monkeypatch.setattr(mod, name, self._guarded(name, getattr(mod, name)))

    def _counted(self, kind, fn):
        def counted(*args, **kwargs):
            self.calls[kind] += 1
            self.inside += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.inside -= 1
        return counted

    def _guarded(self, name, fn):
        def guarded(*args, **kwargs):
            assert self.inside, f"{name} ran outside the kernels' wrappers"
            return fn(*args, **kwargs)
        return guarded


def _raw(rng, w, h):
    return rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)


def _gold(raw, w, h, steps=1):
    """`steps` packed-frame steps of the golden oracle (each from the packed
    bytes: the padding starts at 0 every step, as in a packed buffer)."""
    out = bytes(raw)
    for _ in range(steps):
        out = yv12_bytes_from_planes(deblock_frame_golden(
            planes_from_yv12_bytes(out, w, h), BoundaryStrength.intra_default(w, h), 35))
    return np.frombuffer(out, np.uint8)


@pytest.mark.parametrize("w,h", SHEARED, ids=["40x24", "360x288"])
def test_streaming_sheared_goes_through_t2_t3(rng, monkeypatch, w, h):
    """The packed step in place and into a new buffer, _chain and run()'s
    frames: per step T2 2, K1 1, K1c 1, T3 2 and no layout work outside the
    wrappers; == golden."""
    from gpu_video_codec_tpu_torch.models.streaming import StreamingDeblocker

    raws = [_raw(rng, w, h) for _ in range(2)]
    s = StreamingDeblocker(w, h, 35, device="cpu")
    bufs = [s._put(r) for r in raws]
    spy = _Spy(monkeypatch)
    out = s._packed(bufs[0], False)
    assert spy.calls == {"T2": 2, "T3": 2, "T4": 0, "deblock": 2, "K2": 0}
    assert s._chain(bufs[1], 2) is bufs[1]
    assert spy.calls == {"T2": 6, "T3": 6, "T4": 0, "deblock": 6, "K2": 0}
    assert np.array_equal(out.numpy().ravel(), _gold(raws[0], w, h))
    assert np.array_equal(bufs[1].numpy().ravel(), _gold(raws[1], w, h, steps=2))
    assert not np.array_equal(bufs[0].numpy().ravel(), out.numpy().ravel())  # input kept
    monkeypatch.undo()
    spy = _Spy(monkeypatch)
    outs = list(s.run(raws))
    assert spy.calls == {"T2": 4, "T3": 4, "T4": 0, "deblock": 4, "K2": 0}
    assert all(np.array_equal(o, _gold(r, w, h)) for o, r in zip(outs, raws))


@pytest.mark.parametrize("w,h", SHEARED, ids=["40x24", "360x288"])
def test_resident_sheared_ingest_readback_go_through_t2_t3(rng, monkeypatch, w, h):
    """Resident ingest (T2 2) and readback (T3 2, T4) of a sheared batch, no
    layout work outside the wrappers; the remainders are the JAX package's
    flat tails (rows of one buffer); == golden."""
    from gpu_video_codec_tpu_torch.models.resident import ResidentDeblocker, _readback

    raws = np.stack([_raw(rng, w, h) for _ in range(3)])
    rd = ResidentDeblocker(w, h, 35, device="cpu")
    buf = torch.from_numpy(raws.copy())
    spy = _Spy(monkeypatch)
    tf = rd.ingest(buf)
    assert spy.calls == {"T2": 2, "T3": 0, "T4": 0, "deblock": 0, "K2": 0}
    tf = rd.step(tf)
    out = _readback(tf, w, h)
    assert spy.calls == {"T2": 2, "T3": 2, "T4": 1, "deblock": 2, "K2": 0}
    monkeypatch.undo()
    _, tail = split_covered_data(F.pad(
        torch.from_numpy(raws[:, w * h :].reshape(3, 2, h // 2, w // 2)), (4, 4, 4, 4)))
    assert torch.equal(tf.u_rem, tail[:, 0]) and torch.equal(tf.v_rem, tail[:, 1])
    for o, r in zip(out.numpy(), raws):
        assert np.array_equal(o, _gold(r, w, h))


@pytest.mark.parametrize("how", ["new", "out", "inplace", "torch"])
@pytest.mark.parametrize("w,h", SHEARED + [(64, 72)], ids=["40x24", "360x288", "64x72"])
def test_chroma_ext_goes_through_t2_t3(rng, monkeypatch, w, h, how):
    """The chain on extended U and V planes (tile_chain, pad 0, as
    deblock_frame_cuda calls it): T2 and T3 once per plane, one K1c, the
    flat tail through the kernels (64x72: 8-aligned, its tail 4 rows of the
    extended plane); == golden's chroma.  Into new planes; into
    destinations of zeros, V with a leading axis of its own (the tail must
    come through T2 and T3); in place (the tail stays where it is); and
    with backend "torch" (the plain versions), == the cuda backend."""
    from gpu_video_codec_tpu_torch.utils.bs import chroma_segment_maps

    frame = FramePlanes(*(extend_plane(rng.integers(0, 256, s, dtype=np.uint8))
                          for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))), w, h)
    bs = BoundaryStrength.intra_default(w, h)
    gold = deblock_frame_golden(frame, bs, 35)
    cm = [torch.from_numpy(m) for m in chroma_segment_maps(bs)]
    u, v = torch.from_numpy(frame.u.copy()), torch.from_numpy(frame.v.copy())
    args = (cm, get_beta(35), get_tc(35))
    if how == "torch":
        uo, vo = chain.tile_chain([u, v], *args, pad=0, chroma=True, backend="torch")
        assert all(torch.equal(a, b) for a, b in zip(
            (uo, vo), chain.tile_chain([u, v], *args, pad=0, chroma=True)))
    else:
        planes = [u, v[None]] if how == "out" else [u, v]
        out = {"new": None, "out": [torch.zeros_like(p) for p in planes], "inplace": planes}[how]
        spy = _Spy(monkeypatch)
        got = chain.tile_chain(planes, *args, pad=0, chroma=True, out=out)
        assert spy.calls == {"T2": 2, "T3": 2, "T4": 0, "deblock": 1, "K2": 0}
        monkeypatch.undo()
        assert out is None or all(g is o for g, o in zip(got, out))
        uo, vo = got[0], got[1].reshape(v.shape)
    assert np.array_equal(uo.numpy(), gold.u) and np.array_equal(vo.numpy(), gold.v)


@pytest.mark.parametrize("w,h", SHEARED, ids=["40x24", "360x288"])
def test_pipeline_batch_goes_through_t2_t3(rng, monkeypatch, w, h):
    """DeblockPipeline.batch of 3 sheared frames: T2 2, K1 1, K1c 1, T3 2 in
    all, no layout work on the device outside the wrappers; == golden."""
    from gpu_video_codec_tpu_torch.models.pipeline import DeblockPipeline

    frames = [FramePlanes(*(extend_plane(rng.integers(0, 256, s, dtype=np.uint8))
                            for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))), w, h)
              for _ in range(3)]
    pipe = DeblockPipeline(w, h, 35, device="cpu")
    spy = _Spy(monkeypatch)
    outs = pipe.batch(frames)
    assert spy.calls == {"T2": 2, "T3": 2, "T4": 0, "deblock": 2, "K2": 0}
    monkeypatch.undo()
    bs = BoundaryStrength.intra_default(w, h)
    for f, o in zip(frames, outs):
        gold = deblock_frame_golden(f, bs, 35)
        assert all(np.array_equal(getattr(o, k), getattr(gold, k)) for k in "yuv")


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("cw", CWS)
def test_flat_relayout_every_residue_on_card(cuda_device, cw):
    """_round_trip through the wrappers on the card, every residue."""
    rng = np.random.default_rng(cw)
    before = dict(rk.LAUNCHES)
    for off in range(16):
        for lead, ch, gw, pad in _RESIDUE_FORMS(cw):
            _round_trip(
                rng, lambda x, t, rem: rk.plane_to_tiles_cuda(x, pad, out=t, flat=True,
                                                              rem_out=rem),
                lambda tiles, back, rem: rk.tiles_to_plane_cuda(tiles, pad, ch, gw, out=back,
                                                                flat=True, rem=rem),
                lead, ch, gw, pad, off, (7 * off + cw) % 16, cuda_device)
    assert rk.LAUNCHES["fwd"] - before["fwd"] == 48 and rk.LAUNCHES["inv"] - before["inv"] == 96
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("ch,cw,pad", [(144, 180, 4), (540, 964, 4), (548, 968, 0),
                                       (12, 20, 4)])
def test_flat_relayout_at_frame_sizes_on_card(rng, cuda_device, ch, cw, pad):
    """The sheared 360x288 and 1928x1080 chroma pairs, the 1080p extended
    chroma pair (pad 0: deblock_frame_cuda's), 40x24's: T2 and its
    tail == plain, T3 == plain with and without the tail."""
    x = torch.from_numpy(rng.integers(0, 256, (2, ch, cw), dtype=np.uint8)).to(cuda_device)
    vh, vw, n = rk.flat_view(ch, cw, pad)
    rem = torch.empty((2, n), dtype=torch.uint8, device=cuda_device)
    t = rk.plane_to_tiles_cuda(x, pad, flat=True, rem_out=rem)
    assert torch.equal(t, rk.plane_to_tiles_plain(x, pad, flat=True))
    assert torch.equal(rem, rk.flat_tail_plain(x, pad))
    tiles = torch.randint(0, 256, t.shape, dtype=torch.uint8, device=cuda_device)
    assert torch.equal(rk.tiles_to_plane_cuda(tiles, pad, ch, cw, flat=True, rem=rem),
                       rk.tiles_to_plane_plain(tiles, pad, ch, cw, True, rem))
    dst = x.clone()
    rk.tiles_to_plane_cuda(tiles, pad, ch, cw, out=dst, flat=True)
    assert torch.equal(dst, rk.tiles_to_plane_plain(tiles, pad, ch, cw, True, None, x))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", SHEARED, ids=["40x24", "360x288"])
def test_sheared_paths_on_card_equal_golden(rng, cuda_device, w, h):
    """On the card: the streaming step (T2 2, K1 1, K1c 1, T3 2), resident
    ingest + step + readback and deblock_frame_cuda (T2 3, T3 3) of a
    sheared frame == golden."""
    from gpu_video_codec_tpu_torch.models.resident import ResidentDeblocker
    from gpu_video_codec_tpu_torch.models.streaming import StreamingDeblocker
    from gpu_video_codec_tpu_torch.utils.bs import chroma_segment_maps, luma_segment_maps

    raw = _raw(rng, w, h)
    gold = _gold(raw, w, h)
    s = StreamingDeblocker(w, h, 35, device=cuda_device)
    before = {**rk.LAUNCHES, **ck.LAUNCHES}
    out = s._packed(s._put(raw), False).cpu().numpy().ravel()
    after = {**rk.LAUNCHES, **ck.LAUNCHES}
    assert {k: after[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0), "fwd": 2, "inv": 2, "luma": 1, "chroma": 1}
    assert np.array_equal(out, gold)
    assert np.array_equal(ResidentDeblocker(w, h, 35, device=cuda_device)(raw), gold)
    f = planes_from_yv12_bytes(raw, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    lm = [torch.from_numpy(m).to(cuda_device) for m in luma_segment_maps(bs)]
    cm = [torch.from_numpy(m).to(cuda_device) for m in chroma_segment_maps(bs)]
    before = dict(rk.LAUNCHES)
    y, u, v = chain.deblock_frame_cuda(
        *(torch.from_numpy(p).to(cuda_device) for p in (f.y, f.u, f.v)), lm, cm, get_beta(35),
        get_tc(35))
    assert rk.LAUNCHES["fwd"] - before["fwd"] == 3 and rk.LAUNCHES["inv"] - before["inv"] == 3
    gf = deblock_frame_golden(f, bs, 35)
    assert np.array_equal(y.cpu().numpy(), gf.y)
    assert np.array_equal(u.cpu().numpy(), gf.u) and np.array_equal(v.cpu().numpy(), gf.v)
