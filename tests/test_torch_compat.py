"""The port's reference-API shim (gpu_video_codec_tpu_torch/compat.py):
counterparts of tests/test_compat.py, each held against the JAX package's
compat outputs byte for byte, on the CPU (device="cpu": the kernels' plain
versions)."""

import os

import numpy as np
import pytest

import gpu_video_codec_tpu.compat as jcompat
from gpu_video_codec_tpu_torch import compat
from gpu_video_codec_tpu_torch.compat import ReadYuvFrame

CIF = "mother-daughter_352x288_yv12.yuv"


def _jax_flow(inp, out, backend="jnp", bs=None):
    f = jcompat.ReadYuvFrame(inp, 352, 288, Qp=35, backend=backend)
    if bs is not None:
        f.SetBoundaryStrenght(*bs)
    f.DeblockingFilter(8)
    f.Save(out)
    with open(out, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("backend", ["cuda", "torch", "golden", "native"])
def test_reference_flow(tmp_path, testdata_dir, backend):
    """The reference main()'s CPU flow, ported line for line
    (main.cu:128-133: mother-daughter CIF, Qp 35, filter, save)."""
    inp = os.path.join(testdata_dir, CIF)
    out = str(tmp_path / "out.yuv")
    frame = ReadYuvFrame(inp, 352, 288, Qp=35, backend=backend, device="cpu")
    frame.DeblockingFilter(8)
    frame.Save(out)
    with open(out, "rb") as f:
        assert f.read() == _jax_flow(inp, str(tmp_path / "jax.yuv"))
    assert frame.planes.width == 352


def test_set_boundary_strenght_both_forms(tmp_path, testdata_dir, rng):
    inp = os.path.join(testdata_dir, "image1_352x288_yv12.yuv")
    frame = ReadYuvFrame(inp, 352, 288, Qp=35, device="cpu")
    nv, nh = frame._bs.vert.size, frame._bs.hor.size
    v = rng.integers(0, 3, nv, dtype=np.uint8)
    h = rng.integers(0, 3, nh, dtype=np.uint8)
    frame.SetBoundaryStrenght(v, nv, h, nh)  # C-style 4-arg form
    assert np.array_equal(frame._bs.vert, v)
    v2 = np.roll(v, 1)
    frame.SetBoundaryStrenght(v2, h)  # Python 2-arg form
    assert np.array_equal(frame._bs.vert, v2) and np.array_equal(frame._bs.hor, h)
    with pytest.raises(ValueError):  # size mismatch raises, like the reference throw
        frame.SetBoundaryStrenght(v[:5], np.zeros(nh, np.uint8))
    with pytest.raises(ValueError, match="num_vert_bs"):
        frame.SetBoundaryStrenght(v, nv + 1, h, nh)
    out = str(tmp_path / "out.yuv")
    frame.DeblockingFilter()
    frame.Save(out)
    with open(out, "rb") as f:
        assert f.read() == _jax_flow(inp, str(tmp_path / "jax.yuv"), bs=(v2, h))


def test_ctor_validation(tmp_path):
    bad = tmp_path / "bad.yuv"
    bad.write_bytes(b"\0" * 100)
    with pytest.raises(ValueError):
        ReadYuvFrame(str(bad), 352, 288)


def test_execute_cpu_parity(tmp_path, testdata_dir):
    inp = os.path.join(testdata_dir, CIF)
    out = str(tmp_path / "out.yuv")
    timings = compat.ExecuteCpu(inp, out, 352, 288, 35, thread_counts=(1, 2))
    assert set(timings) == {1, 2} and all(t > 0 for t in timings.values())
    jax_out = str(tmp_path / "jax.yuv")
    jcompat.ExecuteCpu(inp, jax_out, 352, 288, 35, thread_counts=(2,))
    with open(out, "rb") as a, open(jax_out, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("blocks", [(None, None), (32, 16)], ids=["default", "32-16"])
def test_execute_gpu_output_then_no_cpu_timing(tmp_path, testdata_dir, blocks):
    """ExecuteGpu writes the filtered frame (== the JAX ExecuteTpu's) with
    the caller's tiles per block, then times the CUDA device: on a CPU
    device it raises instead of reporting host times as device ones."""
    inp = os.path.join(testdata_dir, "image1_352x288_yv12.yuv")
    out = str(tmp_path / "out.yuv")
    with pytest.raises(RuntimeError, match="CUDA"):
        compat.ExecuteGpu(inp, out, 352, 288, 35, *blocks, device="cpu")
    jax_out = str(tmp_path / "jax.yuv")
    t = jcompat.ExecuteTpu(inp, jax_out, 352, 288, 35)
    assert set(t) == {"kernel_s", "h2d_s", "total_s"}
    with open(out, "rb") as a, open(jax_out, "rb") as b:
        assert a.read() == b.read()


def test_get_gpu_device_info():
    info = compat.GetGpuDeviceInfo()
    assert info["num_devices"] == len(info["devices"])
    from gpu_video_codec_tpu_torch.runtime import native

    if native.available():
        assert info["native_runtime"]["isa"] == native.active_isa()
        assert info["native_runtime"]["omp_max_threads"] >= 1
