"""The port's driver layer without JAX: the examples run in-process, the
pipeline's path through the kernels' wrappers, the port's imports, and on
the card the pipeline's and compat's launches and bytes.

This file imports nothing of JAX, so its `cuda` tests also run where JAX
is not installed (`python -m pytest tests/test_torch_drivers.py -m cuda`);
tests/test_torch_{pipeline,compat,native,cli}.py hold the same surface
against the JAX package on the CPU.  Every comparison is byte-equal."""

import ast
import os

import numpy as np
import pytest
import torch

from gpu_video_codec_tpu_torch.models.golden import deblock_frame_golden
from gpu_video_codec_tpu_torch.models.pipeline import DeblockPipeline
from gpu_video_codec_tpu_torch.ops import chain
from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck
from gpu_video_codec_tpu_torch.ops import relayout_kernel as rk
from gpu_video_codec_tpu_torch.utils.bs import BoundaryStrength
from gpu_video_codec_tpu_torch.utils.yuv import (
    FramePlanes, extend_plane, read_yv12, yv12_bytes_from_planes,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("one_shot", "streaming", "resident_chain", "multi_stream", "mesh_streams")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _frame(rng, w, h):
    return FramePlanes(*(extend_plane(rng.integers(0, 256, s, dtype=np.uint8))
                         for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))), w, h)


def _same(a, b, what=""):
    for k in "yuv":
        assert np.array_equal(getattr(a, k), getattr(b, k)), (what, k)


def _counts() -> dict:
    return {"T2": rk.LAUNCHES["fwd"], "T3": rk.LAUNCHES["inv"], "T4": rk.LAUNCHES["pack"],
            "K1": ck.LAUNCHES["luma"], "K1c": ck.LAUNCHES["chroma"], "K2": ck.LAUNCHES["packed"]}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items()}


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_and_self_verifies_on_cpu(name, capsys):
    import importlib

    mod = importlib.import_module(f"gpu_video_codec_tpu_torch.examples.{name}")
    assert mod.main(["--device", "cpu"]) == 0
    assert "bit-exact" in capsys.readouterr().out


def test_one_shot_writes_its_output(tmp_path, capsys):
    from gpu_video_codec_tpu_torch.examples import one_shot

    out = tmp_path / "out.yuv"
    assert one_shot.main(["--device", "cpu", "--output", str(out)]) == 0
    assert out.stat().st_size == 3 * 352 * 288 // 2


@pytest.mark.parametrize("luma_only", [False, True], ids=["full", "luma_only"])
def test_pipeline_cuda_call_goes_through_the_frame_kernels(rng, monkeypatch, luma_only):
    """The cuda backend's __call__ is deblock_frame_cuda: T2 3, one K1, one
    K1c, T3 3 per frame (T2 1, K1 1, T3 1 under luma_only), on the CPU the
    wrappers' plain versions; == golden."""
    calls = {"T2": 0, "T3": 0, "deblock": 0}

    def spy(name, fn):
        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return counted

    t2, t3, t4, k1 = chain.KERNELS["cuda"]
    monkeypatch.setitem(chain.KERNELS, "cuda",
                        (spy("T2", t2), spy("T3", t3), t4, spy("deblock", k1)))
    w, h = 40, 24
    frame = _frame(rng, w, h)
    out = DeblockPipeline(w, h, 35, luma_only=luma_only, device="cpu")(frame)
    n = 1 if luma_only else 3
    assert calls == {"T2": n, "T3": n, "deblock": 1 if luma_only else 2}
    _same(out, deblock_frame_golden(frame, BoundaryStrength.intra_default(w, h), 35,
                                    luma_only=luma_only))


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_port_and_chip_smoke_import_no_jax():
    """No module of the port and not chip_smoke.py imports jax or the JAX
    package (gpu_video_codec_tpu), at any depth of the file."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "gpu_video_codec_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    for path in files:
        bad = {m for m in _imports(path)
               if m.split(".")[0] in ("jax", "jaxlib", "gpu_video_codec_tpu")}
        assert not bad, (os.path.relpath(path, REPO), bad)


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(1920, 1080), (360, 288), (40, 24)])
def test_pipeline_on_card_launches_and_bytes(rng, cuda_device, w, h):
    """cuda backend on the card: T2 3, K1 1, K1c 1, T3 3 per frame; batch()
    of 4 in one K1 and one K1c (T2 2, T3 2) == four single calls; both ==
    the torch backend on the card (and golden below 1080p)."""
    frames = [_frame(rng, w, h) for _ in range(4)]
    pipe = DeblockPipeline(w, h, 35, device=cuda_device)
    before = _counts()
    single = [pipe(f) for f in frames]
    assert _delta(before) == {"T2": 12, "T3": 12, "T4": 0, "K1": 4, "K1c": 4, "K2": 0}
    before = _counts()
    batch = pipe.batch(frames)
    assert _delta(before) == {"T2": 2, "T3": 2, "T4": 0, "K1": 1, "K1c": 1, "K2": 0}
    plain = DeblockPipeline(w, h, 35, backend="torch", device=cuda_device)
    for f, s, b in zip(frames, single, batch):
        _same(s, b, "batch")
        _same(s, plain(f), "torch")
        if w < 1000:
            _same(s, deblock_frame_golden(f, BoundaryStrength.intra_default(w, h), 35), "golden")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_compat_on_card(tmp_path, cuda_device):
    """ReadYuvFrame on the card and ExecuteGpu's three times (seconds per
    frame, CUDA events and host clock), each output == golden."""
    from gpu_video_codec_tpu_torch import compat

    inp = os.path.join(REPO, "testdata", "image2_768x576.yuv")
    gold = deblock_frame_golden(read_yv12(inp, 768, 576),
                                BoundaryStrength.intra_default(768, 576), 35)
    frame = compat.ReadYuvFrame(inp, 768, 576, Qp=35, device=cuda_device)
    frame.DeblockingFilter()
    _same(frame.planes, gold)
    out = tmp_path / "out.yuv"
    t = compat.ExecuteGpu(inp, str(out), 768, 576, 35, luma_block=32, chroma_block=64)
    assert set(t) == {"kernel_s", "h2d_s", "total_s"} and all(v > 0 for v in t.values())
    assert out.read_bytes() == yv12_bytes_from_planes(gold)


@pytest.mark.cuda
@pytest.mark.parametrize("name", EXAMPLES)
def test_example_on_card(name, cuda_device, capsys):
    import importlib

    mod = importlib.import_module(f"gpu_video_codec_tpu_torch.examples.{name}")
    assert mod.main([]) == 0
    assert "bit-exact" in capsys.readouterr().out
