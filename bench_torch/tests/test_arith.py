"""The benchmark's own arithmetic, on the CPU: roofline bytes, the seeded
generators, the trace reader and the metric readers.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from bench_torch.lib import frames as fr
from bench_torch.lib import roofline, spec
from bench_torch.lib import trace as tr
from bench_torch.lib.feeds import Record

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("w, h, frame, moved", [
    (1920, 1080, 3_110_400, 6_220_800),
    (3840, 2160, 12_441_600, 24_883_200),
    (64, 48, 4_608, 9_216),
])
def test_roofline_bytes_per_geometry(w, h, frame, moved):
    assert roofline.frame_bytes(w, h) == frame
    assert roofline.deblock_bytes(w, h) == moved
    assert roofline.deblock_bytes(w, h, frames=8) == 8 * moved


def test_roofline_bytes_at_10_bits():
    # an int16 a sample: twice the bytes; 4 2160p frames move 199.1 MB
    assert roofline.frame_bytes(3840, 2160, sample_bytes=2) == 24_883_200
    assert roofline.deblock_bytes(3840, 2160, 4, sample_bytes=2) == 199_065_600
    assert roofline.deblock_bytes(64, 48, sample_bytes=2) == 2 * roofline.deblock_bytes(64, 48)


def test_roofline_bytes_at_4_2_2():
    # two (h, w/2) chroma planes: 2wh samples a frame, 4/3 of 4:2:0's; 4 Main 4:2:2 10
    # frames at 2160p move 265.4 MB
    assert roofline.frame_bytes(3840, 2160, 2, "4:2:2") == 33_177_600
    assert roofline.deblock_bytes(3840, 2160, 4, 2, "4:2:2") == 265_420_800
    for w, h in ((1920, 1080), (64, 48), (72, 40)):
        assert roofline.frame_bytes(w, h, chroma_format="4:2:2") == 2 * w * h
        four_two_two = roofline.deblock_bytes(w, h, 16, 2, "4:2:2")
        assert 3 * four_two_two == 4 * roofline.deblock_bytes(w, h, 16, 2)


def test_roofline_bytes_at_4_4_4():
    # two (h, w) chroma planes: 3wh samples a frame and 6wh moved, twice 4:2:0's; 4 Main
    # 4:4:4 frames at 2160p move 199.1 MB, as many as 4 Main 10 frames
    assert roofline.frame_bytes(3840, 2160, 1, "4:4:4") == 24_883_200
    assert roofline.deblock_bytes(3840, 2160, 4, 1, "4:4:4") == 199_065_600
    for w, h in ((1920, 1080), (64, 48), (72, 40)):
        for sample_bytes in (1, 2):
            assert roofline.frame_bytes(w, h, sample_bytes, "4:4:4") == 3 * w * h * sample_bytes
            assert roofline.deblock_bytes(w, h, 1, sample_bytes, "4:4:4") == \
                6 * w * h * sample_bytes
        assert roofline.deblock_bytes(w, h, 16, 2, "4:4:4") == \
            2 * roofline.deblock_bytes(w, h, 16, 2)


def test_roofline_share_against_the_peak():
    # 8 1080p frames moved at exactly the peak take 14.855 us
    t = roofline.deblock_bytes(1920, 1080, 8) / 3.35e12
    assert roofline.roofline_pct(roofline.deblock_bytes(1920, 1080, 8), t, H100) == pytest.approx(100)
    assert roofline.roofline_pct(1e6, 1e-3, H100) == pytest.approx(100 * 1e6 / 3.35e12 / 1e-3)
    assert roofline.roofline_pct(1e6, 1e-3, "some other card") is None
    assert roofline.roofline_pct(1e6, 0.0, H100) is None


@pytest.mark.parametrize("w, h", [(1920, 1080), (3840, 2160), (64, 48)])
@pytest.mark.parametrize("chroma_format, sub_h", [("4:2:0", 2), ("4:2:2", 1)])
def test_bs_sizes_are_the_reference_flat_sizes(w, h, chroma_format, sub_h):
    sizes = fr.bs_sizes(w, h, chroma_format)
    assert sizes["vert"] == ((w // 8 + 1) * h // 8, w // 8 + 1)
    assert sizes["hor"] == ((h // 8 + 1) * w // 8, h // 8 + 1)
    cw, ch = w // 2, h // sub_h
    assert fr.chroma_plane(w, h, chroma_format) == (ch, cw)
    assert sizes["chroma_vert"] == (((cw // 8 + 1) * ch) // 8, cw // 8 + 1)
    assert sizes["chroma_hor"] == (((ch // 8 + 1) * cw) // 8, ch // 8 + 1)


@pytest.mark.parametrize("w, h", [(1920, 1080), (3840, 2160), (64, 48), (72, 40)])
def test_bs_sizes_at_4_4_4_are_the_luma_sizes(w, h):
    # chroma planes (h, w): each chroma array is as long as the luma array of its
    # direction, with the same zero stripe
    assert fr.chroma_plane(w, h, "4:4:4") == (h, w)
    sizes = fr.bs_sizes(w, h, "4:4:4")
    assert sizes["chroma_vert"] == sizes["vert"] == ((w // 8 + 1) * h // 8, w // 8 + 1)
    assert sizes["chroma_hor"] == sizes["hor"] == ((h // 8 + 1) * w // 8, h // 8 + 1)
    bs = fr.bs_arrays(w, h, {"bs": "ra", "bs_shares": [0.2, 0.3, 0.5]}, 2**31 + 5, "cpu",
                      "4:4:4")
    assert bs["chroma_vert"].size == bs["vert"].size and bs["chroma_hor"].size == bs["hor"].size


@pytest.mark.parametrize("chroma_format", ["4:2:0", "4:2:2", "4:4:4"])
def test_ai_bs_is_the_reference_default(chroma_format):
    bs = fr.bs_arrays(64, 48, {"bs": "ai"}, 5, "cpu", chroma_format)
    for name, (size, stripe) in fr.bs_sizes(64, 48, chroma_format).items():
        a = bs[name]
        assert a.size == size and a.dtype == np.uint8
        assert (a[::stripe] == 0).all()
        keep = np.ones(size, bool)
        keep[::stripe] = False
        assert (a[keep] == 2).all()


def test_ra_bs_shares_on_a_seed():
    mix = {"bs": "ra", "bs_shares": [0.70, 0.25, 0.05]}
    bs = fr.bs_arrays(1920, 1080, mix, 2**31 + 17, "cpu")
    drawn = []
    for name, (size, stripe) in fr.bs_sizes(1920, 1080).items():
        keep = np.ones(size, bool)
        keep[::stripe] = False
        assert (bs[name][::stripe] == 0).all()
        drawn.append(bs[name][keep])
    drawn = np.concatenate(drawn)
    shares = [float((drawn == v).mean()) for v in (0, 1, 2)]
    assert shares == pytest.approx([0.70, 0.25, 0.05], abs=0.01)
    again = fr.bs_arrays(1920, 1080, mix, 2**31 + 17, "cpu")
    other = fr.bs_arrays(1920, 1080, mix, 2**31 + 18, "cpu")
    assert all((again[k] == bs[k]).all() for k in bs)
    assert any((other[k] != bs[k]).any() for k in bs)


@pytest.mark.parametrize("n, w, h, seed, digest", [
    (3, 64, 48, 2**33 + 1, "3fc6b5471fc58666964259d12ef7e8ea850432d77e5c9a5c53d89129cd8e11e9"),
    (2, 136, 88, 2**31 + 99, "c45198f8ea9926e7cd8acfbd8cc3922ebc6e11baeeb4afd8c13bae4bbd6b90c7"),
])
def test_8_bit_pool_keeps_its_bytes(n, w, h, seed, digest):
    # sha256 of the pools the generator made before it took a bit depth:
    # 8-bit cells read the same frames as before
    pool = fr.frame_pool(n, w, h, seed, {"luma_dc": 24, "chroma_dc": 12}, "cpu", 8)
    assert pool.dtype == torch.uint8
    assert hashlib.sha256(pool.numpy().tobytes()).hexdigest() == digest


def test_10_bit_pool():
    content = {"luma_dc": 96, "chroma_dc": 48}
    a = fr.frame_pool(3, 64, 48, 2**33 + 1, content, "cpu", 10)
    assert a.shape == (3, 72, 64) and a.dtype == torch.int16
    assert int(a.min()) >= 0 and int(a.max()) <= 1023 and int(a.max()) > 255
    assert torch.equal(a, fr.frame_pool(3, 64, 48, 2**33 + 1, content, "cpu", 10))
    assert not torch.equal(a, fr.frame_pool(3, 64, 48, 2**33 + 2, content, "cpu", 10))
    for plane in (a[:, :48], a[:, 48:]):
        # the low two bits vary: each of their four values holds a fair share
        shares = torch.bincount((plane & 3).flatten().long(), minlength=4) / plane.numel()
        assert (shares > 0.2).all()


@pytest.mark.parametrize("bit_depth", [7, 9, 12, 16])
def test_other_bit_depths_are_refused(bit_depth):
    with pytest.raises(ValueError, match="bit_depth"):
        fr.frame_pool(1, 64, 48, 1, {"luma_dc": 24, "chroma_dc": 12}, "cpu", bit_depth)


def test_4_2_2_pool():
    # (n, 2h, w): luma, then U and V (h, w/2); at 10 bits a yuv422p10le frame.  The
    # generator's calls are 4:2:0's in the same order, so luma is 4:2:0's
    content = {"luma_dc": 96, "chroma_dc": 48}
    a = fr.frame_pool(3, 64, 48, 2**33 + 1, content, "cpu", 10, "4:2:2")
    assert a.shape == (3, 96, 64) and a.dtype == torch.int16
    assert fr.packed_rows(64, 48, "4:2:2") == 96 and fr.packed_rows(64, 48) == 72
    assert torch.equal(a, fr.frame_pool(3, 64, 48, 2**33 + 1, content, "cpu", 10, "4:2:2"))
    assert not torch.equal(a, fr.frame_pool(3, 64, 48, 2**33 + 2, content, "cpu", 10, "4:2:2"))
    b = fr.frame_pool(3, 64, 48, 2**33 + 1, content, "cpu", 10)
    assert torch.equal(a[:, :48], b[:, :48])
    u, v = a[:, 48:].reshape(3, 2, 48, 32).unbind(1)
    for plane in (u, v):
        assert int(plane.min()) >= 0 and int(plane.max()) <= 1023
        # each chroma plane holds its own blocky content down to its last row
        assert (plane[:, 24:].float().std() > 4) and not torch.equal(plane[:, :24], plane[:, 24:])
    assert not torch.equal(u, v)


@pytest.mark.parametrize("bit_depth, content", [(8, {"luma_dc": 24, "chroma_dc": 12}),
                                                (10, {"luma_dc": 96, "chroma_dc": 48})])
def test_4_4_4_pool(bit_depth, content):
    # (n, 3h, w): luma, then U and V (h, w); at 10 bits a yuv444p10le frame.  The
    # generator's calls are 4:2:0's in the same order, so luma is 4:2:0's byte for byte
    a = fr.frame_pool(3, 64, 48, 2**33 + 1, content, "cpu", bit_depth, "4:4:4")
    assert a.shape == (3, 144, 64) and a.dtype == fr.sample_dtype(bit_depth)
    assert fr.packed_rows(64, 48, "4:4:4") == 144
    assert torch.equal(a, fr.frame_pool(3, 64, 48, 2**33 + 1, content, "cpu", bit_depth, "4:4:4"))
    assert not torch.equal(a, fr.frame_pool(3, 64, 48, 2**33 + 2, content, "cpu", bit_depth,
                                            "4:4:4"))
    b = fr.frame_pool(3, 64, 48, 2**33 + 1, content, "cpu", bit_depth)
    assert a[:, :48].numpy().tobytes() == b[:, :48].numpy().tobytes()
    u, v = a[:, 48:].reshape(3, 2, 48, 64).unbind(1)
    for plane in (u, v):
        assert int(plane.min()) >= 0 and int(plane.max()) <= (1 << bit_depth) - 1
        # each chroma plane holds its own blocky content down to its last row and column
        assert plane[:, 24:, 32:].float().std() > 1
        assert not torch.equal(plane[:, :24], plane[:, 24:])
        assert not torch.equal(plane[..., :32], plane[..., 32:])
    assert not torch.equal(u, v)


@pytest.mark.parametrize("chroma_format", ["4:0:0", "4:4:0", "420", "", None])
def test_other_chroma_formats_are_refused(chroma_format):
    from bench_torch.references import hevc_deblock as ref

    content = {"luma_dc": 24, "chroma_dc": 12}
    calls = [
        lambda: fr.chroma_plane(64, 48, chroma_format),
        lambda: fr.packed_rows(64, 48, chroma_format),
        lambda: fr.frame_pool(1, 64, 48, 1, content, "cpu", 8, chroma_format),
        lambda: fr.bs_sizes(64, 48, chroma_format),
        lambda: fr.bs_arrays(64, 48, {"bs": "ai"}, 1, "cpu", chroma_format),
        lambda: roofline.frame_bytes(64, 48, 1, chroma_format),
        lambda: ref.deblock_packed(torch.zeros((1, 96, 64), dtype=torch.uint8), 64, 48, 37,
                                   fr.bs_arrays(64, 48, {"bs": "ai"}, 1, "cpu"),
                                   chroma_format=chroma_format),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="chroma_format"):
            call()


# -- the configurations read what they read before: sha256 of their pools (64x48 and
# 72x40), BS arrays (the configuration's size; ai and ra), reference and control
# outputs, the check's counts of the control's wrong bytes, and the roofline's bytes
# a frame at the configuration's own size.  The 4:2:0 configurations' digests were
# taken before the harness took a chroma format; the 4:2:2 configuration's, and every
# roofline figure, before it took 4:4:4

DIGEST_SEED = 2**31 + 4242
DIGEST_MIXES = [{"bs": "ai"}, {"bs": "ra", "bs_shares": [0.2, 0.3, 0.5]}]
DIGESTS = {
    "hevc_ctc_b_1080p_qp37": {
        "chroma_format": "4:2:0",
        "pool": "b38ed2c099d5f3c8392540ef52685391089e3c31824fbf787663afbf7652d33d",
        "bs": "f83a3bb90c974b7d72508145b2e7c4d476bb95361a6e83b7ccc11728e3a9a1cf",
        "ref": "ec1e3a6a259682e40612b13d00bafa7ff8ac28ad743c5a3ca00e0f1d6b855d87",
        "wrong": [[1007, 2, 2], [780, 2, 2], [974, 2, 2], [785, 2, 2]],
        "roofline": 6_220_800,
    },
    "hevc_l51_2160p_qp32": {
        "chroma_format": "4:2:0",
        "pool": "b38ed2c099d5f3c8392540ef52685391089e3c31824fbf787663afbf7652d33d",
        "bs": "b8fee9212599dd60f9468a110a517454c9de56c2e0d915cd723d8a9a59d11700",
        "ref": "4670ef5e6f64ae93dc23ce1495c4e6edf200f31b7a2cf009118625438ee55b4a",
        "wrong": [[688, 2, 2], [509, 2, 2], [740, 2, 2], [579, 2, 2]],
        "roofline": 24_883_200,
    },
    "hevc_main10_l51_2160p_qp32": {
        "chroma_format": "4:2:0",
        "pool": "ef4c8583347fa62935e1f6e78657b42333b90dbe2a01b58e52709d8b6c123917",
        "bs": "b8fee9212599dd60f9468a110a517454c9de56c2e0d915cd723d8a9a59d11700",
        "ref": "fbbff401410ac8e957a44a8c53ba5461d992547f47444ea1b26c31f6817fa06d",
        "wrong": [[966, 2, 2], [754, 2, 2], [892, 2, 2], [745, 2, 2]],
        "roofline": 49_766_400,
    },
    "hevc_main422_10_l51_2160p_qp32": {
        "chroma_format": "4:2:2",
        "pool": "55a1a6b30b49e7644859b0a11d6a98482da39d9c5bf07a670e0c0a6fd9074229",
        "bs": "da9a2f1ded920f37b61b562ec70b7fc7e53a9644d69322507f7bc682c8f000c1",
        "ref": "a32bf99e73269539a1e4f40d03ed1b2e4a9323bc0b5c11476ff48d432bccc6a1",
        "wrong": [[1134, 2, 2], [850, 2, 2], [1127, 2, 2], [892, 2, 2]],
        "roofline": 66_355_200,
    },
}


def _digest(tensors):
    d = hashlib.sha256()
    for t in tensors:
        d.update(t.numpy().tobytes() if isinstance(t, torch.Tensor) else t.tobytes())
    return d.hexdigest()


def _inputs_and_outputs(cfg):
    """What the harness reads of a configuration at small sizes, through the
    chroma format its file states."""
    from bench_torch.lib import check
    from bench_torch.references import hevc_deblock as ref

    bd, qp, cf = cfg["bit_depth"], cfg["qp"], cfg["chroma_format"]
    moved = roofline.deblock_bytes(cfg["width"], cfg["height"], 1,
                                   fr.sample_dtype(bd).itemsize, cf)
    bs = [a for m in DIGEST_MIXES
          for a in fr.bs_arrays(cfg["width"], cfg["height"], m, DIGEST_SEED, "cpu", cf).values()]
    pools, outs, wrong = [], [], []
    for w, h in ((64, 48), (72, 40)):
        pool = fr.frame_pool(2, w, h, DIGEST_SEED, cfg["content"], "cpu", bd, cf)
        pools.append(pool)
        for m in DIGEST_MIXES:
            small_bs = fr.bs_arrays(w, h, m, DIGEST_SEED, "cpu", cf)
            out = ref.deblock_packed(pool, w, h, qp, small_bs, bit_depth=bd, chroma_format=cf)
            control = ref.deblock_packed(pool, w, h, qp, small_bs, shift="trunc", bit_depth=bd,
                                         chroma_format=cf)
            outs += [out, control]
            small = dict(cfg, width=w, height=h)
            wrong.append(list(check.wrong_bytes([(pool, control)], small, small_bs, "cpu")))
    return {"chroma_format": cf, "pool": _digest(pools), "bs": _digest(bs), "ref": _digest(outs),
            "wrong": wrong, "roofline": moved}


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_4_2_0_configurations_read_what_they_read_before(name):
    cfg = spec.load_json(spec.ROOT / next(c["file"] for c in spec.load_spec()["configs"]
                                          if c["name"] == name))
    assert _inputs_and_outputs(cfg) == DIGESTS[name]


def test_frame_pool_is_the_seed_s():
    content = {"luma_dc": 24, "chroma_dc": 12}
    a = fr.frame_pool(3, 64, 48, 2**33 + 1, content, "cpu")
    b = fr.frame_pool(3, 64, 48, 2**33 + 1, content, "cpu")
    c = fr.frame_pool(3, 64, 48, 2**33 + 2, content, "cpu")
    assert a.shape == (3, 72, 64) and a.dtype == torch.uint8
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])


# -- a canned Chrome trace: two kernels of one replay overlapping by 0.5 us,
# a harness memcpy, runtime calls with correlations, and the marks' queries

def _canned_trace(path):
    ev = [
        {"ph": "M", "name": "process_labels", "pid": 0, "args": {"labels": "GPU 0"}},
        {"ph": "M", "name": "process_labels", "pid": 5, "args": {"labels": "GPU 5"}},
        {"ph": "M", "name": "process_labels", "pid": 99, "args": {"labels": "CPU"}},
        # refresh copy at 1000 (10 us), then the step's two kernels 1015-1035, 1034.5-1050
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)", "pid": 0,
         "tid": 7, "ts": 1000.0, "dur": 10.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k_a", "pid": 0, "tid": 13, "ts": 1015.0,
         "dur": 20.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k_b", "pid": 0, "tid": 13, "ts": 1034.5,
         "dur": 15.5, "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "scope", "pid": 0, "tid": 13,
         "ts": 1000.0, "dur": 60.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "pid": 99, "tid": 1,
         "ts": 995.0, "dur": 3.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "pid": 99, "tid": 1,
         "ts": 1005.0, "dur": 4.0, "args": {"correlation": 2}},
    ]
    for ts in (900.0, 901.0, 902.0, 1100.0, 1101.0, 1102.0):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaEventQuery", "pid": 99,
                   "tid": 1, "ts": ts, "dur": 0.2})
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_trace_reader_keeps_overlapping_kernels_and_finds_the_idle(tmp_path):
    p = tmp_path / "t.json"
    _canned_trace(p)
    events = tr.load_events(str(p))
    assert tr.device_pids(events) == {0: 0, 5: 5}
    leaves = tr.device_leaves(events)[0]
    assert [e[2] for e in leaves] == ["Memcpy DtoD (Device -> Device)", "k_a", "k_b"]
    stats_ = tr.device_op_stats(leaves)
    assert stats_["k_a"] == (20.0, 1) and stats_["k_b"] == (15.5, 1)
    assert tr.busy_us(leaves) == pytest.approx(10.0 + 35.0)
    spans = [(990.0, 1000.0, "refresh"), (1002.0, 1014.0, "step_call")]
    gaps = tr.idle_gaps(leaves, 990.0, 1060.0, spans)
    assert gaps == [("refresh", 10.0), ("other", 10.0), ("step_call", 5.0)]
    assert tr.launch_spans(events, spans) == {1: "refresh", 2: "step_call"}
    assert tr.clip(leaves, 1040.0, 1045.0) == [(1040.0, 5.0, "k_b", 2)]


def _traced_record(tmp_path):
    p = tmp_path / "t.json"
    _canned_trace(p)
    events = tr.load_events(str(p))
    spans = [(990.0, 1000.0, "refresh"), (1002.0, 1012.0, "step_call")]
    rec = Record("device", 1920, 1080, 8, H100)
    rec.trace = {"lo": 990.0, "hi": 1060.0, "spans": spans,
                 "cards": {0: tr.clip(tr.device_leaves(events)[0], 990.0, 1060.0)},
                 "launch_span": tr.launch_spans(events, spans), "batches": 1}
    return rec


def test_step_roofline_leaves_out_the_harness_copy(tmp_path):
    rec = _traced_record(tmp_path)
    got = spec.reader("step_roofline_pct.devfed")(rec)
    # the step's device time is 20 + 15.5 us: the refresh memcpy is the harness's
    assert got == pytest.approx(roofline.roofline_pct(6_220_800 * 8, 35.5e-6, H100))
    assert spec.reader("step_roofline_pct.devfed")(Record("device", 1, 1, 1, H100)) is None
    rec.sample_bytes = 2  # 10-bit frames: twice the bytes in the same time
    assert spec.reader("step_roofline_pct.devfed")(rec) == pytest.approx(2 * got)
    assert rec.chroma_format == "4:2:0"
    rec.sample_bytes, rec.chroma_format = 1, "4:2:2"  # 2wh samples a frame, not 3wh/2
    assert spec.reader("step_roofline_pct.devfed")(rec) == pytest.approx(4 / 3 * got)
    rec.chroma_format = "4:4:4"  # 3wh samples a frame
    assert spec.reader("step_roofline_pct.devfed")(rec) == pytest.approx(2 * got)


def test_idle_share_is_the_traced_stretch_s_own(tmp_path):
    rec = _traced_record(tmp_path)
    # busy 10 + 35 us of the stretch's 70: whatever the untraced window did
    rec.frames, rec.window_s = 8 * 1000, 0.09
    assert spec.reader("idle_pct.devfed")(rec) == pytest.approx(100 * (1 - 45 / 70))
    rec.trace["cards"][1] = []  # a second card that ran nothing: the mean of 35.7% and 100%
    assert spec.reader("idle_pct.devfed")(rec) == pytest.approx((100 * 25 / 70 + 100) / 2)
    assert spec.reader("idle_pct.devfed")(Record("device", 1, 1, 1, H100)) is None


def test_rates_count_every_frame_of_the_window():
    rec = Record("device", 1920, 1080, 8, H100)
    rec.frames, rec.window_s, rec.setup_s = 80_000, 1.25, 7.5
    assert spec.reader("device_fps")(rec) == 64_000
    assert spec.reader("setup_s")(rec) == 7.5


def test_tracer_clock_maps_host_stamps_by_the_tightest_marks(tmp_path):
    from bench_torch.lib.feeds import Tracer

    p = tmp_path / "t.json"
    _canned_trace(p)
    t = Tracer(True)
    t.marks = [(400e-6, 401e-6), (401e-6, 410e-6), (402e-6, 420e-6),
               (600e-6, 601e-6), (601e-6, 640e-6), (602e-6, 650e-6)]
    clock = t._clock(tr.load_events(str(p)))
    assert clock(400.5e-6) == pytest.approx(900.1)
    assert clock(500e-6) == pytest.approx(999.6)
    assert Tracer(True)._clock([]) is None
