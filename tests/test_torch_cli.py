"""The PyTorch port's CLI on the bundled frames, against the golden oracle
and the JAX package's CLI output, plus its error paths."""

import json
import os

import numpy as np
import pytest

from gpu_video_codec_tpu.cli import main as jax_main
from gpu_video_codec_tpu_torch.cli import build_parser, main
from gpu_video_codec_tpu_torch.models.golden import deblock_frame_golden
from gpu_video_codec_tpu_torch.utils.bs import BoundaryStrength
from gpu_video_codec_tpu_torch.utils.yuv import read_yv12, yv12_bytes_from_planes

CIF = "mother-daughter_352x288_yv12.yuv"


def _gold(path, w, h, qp, luma_only=False):
    frame = read_yv12(path, w, h)
    out = deblock_frame_golden(frame, BoundaryStrength.intra_default(w, h), qp,
                               luma_only=luma_only)
    return yv12_bytes_from_planes(out)


@pytest.mark.parametrize("backend", ["cuda", "torch", "golden", "native"])
def test_cli_roundtrip(tmp_path, testdata_dir, capsys, backend):
    inp = os.path.join(testdata_dir, CIF)
    out = str(tmp_path / "out.yuv")
    rc = main(["--input", inp, "--width", "352", "--height", "288", "--qp", "35",
               "--output", out, "--backend", backend, "--device", "cpu"])
    assert rc == 0
    res = json.loads(capsys.readouterr().out)
    assert res["frames"] == 1 and res["backend"] == backend
    with open(out, "rb") as f:
        assert f.read() == _gold(inp, 352, 288, 35)


def test_cli_matches_jax_cli(tmp_path, testdata_dir, capsys):
    inp = os.path.join(testdata_dir, CIF)
    mine, ref = str(tmp_path / "mine.yuv"), str(tmp_path / "ref.yuv")
    assert main(["-i", inp, "-W", "352", "-H", "288", "--qp", "30", "-o", mine,
                 "--device", "cpu"]) == 0
    assert jax_main(["-i", inp, "-W", "352", "-H", "288", "--qp", "30", "-o", ref,
                     "--backend", "jnp"]) == 0
    capsys.readouterr()
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_cli_stream_frames_and_luma_only(tmp_path, testdata_dir, capsys):
    one = open(os.path.join(testdata_dir, CIF), "rb").read()
    two = open(os.path.join(testdata_dir, "image1_352x288_yv12.yuv"), "rb").read()
    inp = tmp_path / "stream.yuv"
    inp.write_bytes(one + two + two[:100])  # a truncated tail frame is ignored
    out = tmp_path / "out.yuv"
    assert main(["-i", str(inp), "-W", "352", "-H", "288", "--qp", "35", "-o", str(out),
                 "--device", "cpu", "--depth", "1", "--luma-only"]) == 0
    assert json.loads(capsys.readouterr().out)["frames"] == 2
    data = out.read_bytes()
    assert len(data) == 2 * len(one)
    gold = [_gold(os.path.join(testdata_dir, n), 352, 288, 35, luma_only=True)
            for n in (CIF, "image1_352x288_yv12.yuv")]
    assert data == gold[0] + gold[1]
    assert main(["-i", str(inp), "-W", "352", "-H", "288", "-o", str(out),
                 "--device", "cpu", "--frames", "1"]) == 0
    assert json.loads(capsys.readouterr().out)["frames"] == 1
    assert out.stat().st_size == len(one)


def test_cli_device_info(capsys):
    assert main(["--device-info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["num_devices"] == len(info["devices"])
    assert "torch" in info


def test_cli_errors(tmp_path, testdata_dir, capsys):
    assert main([]) == 2
    f = tmp_path / "x.yuv"
    f.write_bytes(b"\0" * (3 * 50 * 50 // 2))
    assert main(["--input", str(f), "-W", "50", "-H", "50", "--device", "cpu"]) == 1
    small = tmp_path / "small.yuv"
    small.write_bytes(b"\0" * 10)
    assert main(["--input", str(small), "-W", "64", "-H", "48", "--device", "cpu"]) == 1
    assert main(["--input", str(tmp_path / "missing.yuv"), "-W", "64", "-H", "48"]) == 1
    # timing needs a CUDA device; on a CPU device the CLI reports it
    inp = os.path.join(testdata_dir, CIF)
    assert main(["-i", inp, "-W", "352", "-H", "288", "--device", "cpu", "--bench"]) == 1
    assert "CUDA" in capsys.readouterr().err


def test_cli_bench_passes_device_split_through(testdata_dir, capsys, monkeypatch):
    """--bench turns time_breakdown's seconds into µs and passes the nested
    device_split_us (already µs) through.  The JAX CLI maps every value
    through round(v * 1e6, 1) (gpu_video_codec_tpu/cli.py:261-264) and
    would raise on that dict: a reference defect the port does not inherit."""
    from gpu_video_codec_tpu_torch.models.streaming import StreamingDeblocker

    split = {"deblock_kernels": 7.81, "layout_and_copies": 12.4, "other": 0.0}
    monkeypatch.setattr(StreamingDeblocker, "time_breakdown", lambda self, frame: {
        "h2d_s": 5.1e-4, "kernel_s": 3.12e-5, "dispatch_s": 2.93e-5,
        "device_split_us": split, "e2e_sync_s": 4.46e-3})
    inp = os.path.join(testdata_dir, CIF)
    assert main(["-i", inp, "-W", "352", "-H", "288", "--device", "cpu", "--bench"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["timing"] == {"h2d_us": 510.0, "kernel_us": 31.2, "dispatch_us": 29.3,
                             "device_split_us": split, "e2e_sync_us": 4460.0}
    assert res["timing_unit"] == "us/frame"


def test_cli_batch_resident_with_tail(tmp_path, testdata_dir, capsys):
    """--batch 2 over three frames: one batch of two, then the tail frame as
    a batch of its own, each frame equal to golden."""
    names = (CIF, "image1_352x288_yv12.yuv", CIF)
    inp = tmp_path / "stream.yuv"
    inp.write_bytes(b"".join(open(os.path.join(testdata_dir, n), "rb").read() for n in names))
    out = tmp_path / "out.yuv"
    assert main(["-i", str(inp), "-W", "352", "-H", "288", "--qp", "35", "-o", str(out),
                 "--device", "cpu", "--batch", "2"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert (res["frames"], res["batch"], res["mode"], res["backend"]) == (3, 2, "resident", "cuda")
    assert out.read_bytes() == b"".join(_gold(os.path.join(testdata_dir, n), 352, 288, 35)
                                        for n in names)
    assert main(["-i", str(inp), "-W", "352", "-H", "288", "--qp", "35", "-o", str(out),
                 "--device", "cpu", "--batch", "4", "--frames", "1", "--luma-only"]) == 0
    assert json.loads(capsys.readouterr().out)["frames"] == 1
    assert out.read_bytes() == _gold(os.path.join(testdata_dir, CIF), 352, 288, 35,
                                     luma_only=True)


def test_cli_batch_errors(tmp_path, testdata_dir, capsys):
    inp = os.path.join(testdata_dir, CIF)
    base = ["-i", inp, "-W", "352", "-H", "288", "--device", "cpu"]
    assert main(base + ["--batch", "0"]) == 1
    assert main(base + ["--batch", "2", "--bench"]) == 1
    assert main(base + ["--batch", "2", "--backend", "torch"]) == 1
    assert main(base + ["--batch", "2", "--backend", "golden"]) == 1
    small = tmp_path / "small.yuv"
    small.write_bytes(b"\0" * 10)
    assert main(["-i", str(small), "-W", "64", "-H", "48", "--device", "cpu", "--batch", "2"]) == 1
    assert "--batch" in capsys.readouterr().err


def test_parser_leaves_out_resident_and_multistream_modes():
    """Every mode of the JAX CLI is ported: the resident --batch mode, the
    native backend's --num-threads and the multi-stream --streams/--mesh
    (none set by default)."""
    opts = {a for action in build_parser()._actions for a in action.option_strings}
    assert {"--batch", "--num-threads", "--streams", "--mesh"} <= opts
    defaults = build_parser().parse_args([])
    assert defaults.batch is None and defaults.streams is None and defaults.mesh is None
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--backend", "pallas"])
    assert build_parser().parse_args([]).backend == "cuda"
    assert build_parser().parse_args([]).num_threads == 0


def test_cli_native_threads_matches_jax_cli(tmp_path, testdata_dir, capsys):
    """--backend native --num-threads 2, as the JAX CLI runs it."""
    from gpu_video_codec_tpu.runtime import native as jnative

    inp = os.path.join(testdata_dir, "image2_768x576.yuv")
    mine, ref = str(tmp_path / "mine.yuv"), str(tmp_path / "ref.yuv")
    assert main(["-i", inp, "-W", "768", "-H", "576", "--qp", "35", "-o", mine,
                 "--backend", "native", "--num-threads", "2"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert (res["frames"], res["backend"]) == (1, "native")
    with open(mine, "rb") as f:
        got = f.read()
    assert got == _gold(inp, 768, 576, 35)
    if jnative.available():
        assert jax_main(["-i", inp, "-W", "768", "-H", "576", "--qp", "35", "-o", ref,
                         "--backend", "native", "--num-threads", "2"]) == 0
        capsys.readouterr()
        with open(ref, "rb") as f:
            assert got == f.read()


@pytest.mark.parametrize("backend", ["native", "golden"])
def test_cli_bench_host_backends(testdata_dir, capsys, backend):
    """--bench on a host backend reports the filter's host time per frame."""
    inp = os.path.join(testdata_dir, CIF)
    assert main(["-i", inp, "-W", "352", "-H", "288", "--backend", backend,
                 "--num-threads", "2", "--bench"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["timing"]["filter_us"] > 0 and res["timing_unit"] == "us/frame"


def test_cli_device_info_native_runtime(capsys):
    from gpu_video_codec_tpu_torch.runtime import native

    assert main(["--device-info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["native_runtime"] == {"isa": native.active_isa(),
                                      "omp_max_threads": native.load().gvct_num_threads()}


def test_cli_rejects_negative_threads(testdata_dir, capsys):
    inp = os.path.join(testdata_dir, CIF)
    assert main(["-i", inp, "-W", "352", "-H", "288", "--backend", "native",
                 "--num-threads", "-1"]) == 1
    assert "num_threads" in capsys.readouterr().err


def _stream_file(tmp_path, n, w=64, h=48):
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8) for _ in range(n)]
    inp = tmp_path / "streams.yuv"
    inp.write_bytes(b"".join(f.tobytes() for f in frames))
    return inp, frames


def _gold_raw(raw, w, h, qp=35):
    from gpu_video_codec_tpu_torch.utils.yuv import planes_from_yv12_bytes

    out = deblock_frame_golden(planes_from_yv12_bytes(raw.tobytes(), w, h),
                               BoundaryStrength.intra_default(w, h), qp)
    return yv12_bytes_from_planes(out)


@pytest.mark.parametrize("mesh", ["1,2", "2,2"])
def test_cli_streams_matches_jax_cli(tmp_path, capsys, mesh):
    """--streams 2 (and 4) --mesh over five 64x48 frames: on the frames the
    JAX CLI keeps (whole batches) the two outputs are byte-equal."""
    n_streams = 2 if mesh == "1,2" else 4
    inp, _ = _stream_file(tmp_path, 5)
    mine, ref = tmp_path / "mine.yuv", tmp_path / "ref.yuv"
    args = ["-i", str(inp), "-W", "64", "-H", "48", "--qp", "35", "--streams",
            str(n_streams), "--mesh", mesh]
    assert main(args + ["-o", str(mine), "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert (res["frames"], res["streams"], res["device"]) == (5, n_streams, "cpu")
    assert res["mesh"] == dict(zip(("data", "spatial"), map(int, mesh.split(","))))
    assert jax_main(args + ["-o", str(ref), "--backend", "jnp"]) == 0
    kept = json.loads(capsys.readouterr().out)["frames"]
    assert kept == 5 - 5 % n_streams
    assert mine.read_bytes()[: ref.stat().st_size] == ref.read_bytes()


def test_cli_streams_filters_the_tail_the_jax_cli_drops(tmp_path, capsys):
    """Exemption from the JAX CLI (gpu_video_codec_tpu/cli.py:145-147, which
    keeps whole batches only and drops the tail frames): the port fills the
    last short batch with zero frames, drops their outputs, and filters and
    writes every input frame; --frames counts input frames."""
    w, h = 64, 48
    inp, frames = _stream_file(tmp_path, 5)
    out = tmp_path / "out.yuv"
    assert main(["-i", str(inp), "-W", "64", "-H", "48", "--qp", "35", "-o", str(out),
                 "--device", "cpu", "--streams", "2", "--mesh", "1,2"]) == 0
    assert json.loads(capsys.readouterr().out)["frames"] == 5
    assert out.read_bytes() == b"".join(_gold_raw(f, w, h) for f in frames)
    assert main(["-i", str(inp), "-W", "64", "-H", "48", "--qp", "35", "-o", str(out),
                 "--device", "cpu", "--streams", "4", "--frames", "3"]) == 0
    assert json.loads(capsys.readouterr().out)["frames"] == 3
    assert out.read_bytes() == b"".join(_gold_raw(f, w, h) for f in frames[:3])


def test_cli_streams_errors(tmp_path, capsys):
    """The JAX CLI's mutual-exclusion errors (cli.py:310-327) and the mode's
    own; with the default device and no CUDA the mesh raises (exit 1)."""
    inp, _ = _stream_file(tmp_path, 2)
    base = ["-i", str(inp), "-W", "64", "-H", "48", "--device", "cpu"]
    for extra, msg in ((["--streams", "2", "--batch", "2"], "mutually exclusive"),
                       (["--streams", "2", "--bench"], "--bench is not supported with --streams"),
                       (["--streams", "0"], "--streams must be >= 1"),
                       (["--streams", "2", "--backend", "golden"], "requires a device backend"),
                       (["--streams", "3", "--mesh", "2,1"], "must divide by the data axis"),
                       (["--streams", "2", "--mesh", "1x2"], "error")):
        assert main(base + extra) == 1, extra
        assert msg in capsys.readouterr().err, extra
    assert jax_main(base[:-2] + ["--streams", "2", "--batch", "2"]) == 1
    assert "mutually exclusive" in capsys.readouterr().err
    if not __import__("torch").cuda.is_available():
        assert main(base[:-2] + ["--streams", "2"]) == 1
        assert "CUDA is not available" in capsys.readouterr().err
