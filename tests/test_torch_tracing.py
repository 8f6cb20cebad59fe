"""utils/tracing.py of the PyTorch port against the JAX package's: the same
device-lane leaf accounting and op buckets on the synthetic Chrome traces of
tests/test_tracing.py, plus a trace in torch.profiler's own format (one CUDA
graph replay of the 1080p packed step as export_chrome_trace wrote it on an
H100, cut to its metadata and one replay), which pins how that format names
its device lanes."""

import gzip
import json
import os

import pytest
import torch

from gpu_video_codec_tpu.utils import tracing as jtracing
from gpu_video_codec_tpu_torch.utils import tracing


def _write_trace(tmp_path, events, name="host.trace.json.gz"):
    d = tmp_path / "plugins" / "profile" / "run1"
    d.mkdir(parents=True, exist_ok=True)
    path = os.path.join(d, name)
    opener = gzip.open if name.endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(tmp_path)


def _meta(pid, name):
    return {"ph": "M", "name": "process_name", "pid": pid, "args": {"name": name}}


def _ev(pid, tid, name, ts, dur):
    return {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": ts, "dur": dur}


# the synthetic traces of tests/test_tracing.py, by its test names
SYNTHETIC = {
    "leaf_only_no_double_count": ([
        _meta(1, "/device:TPU:0"),
        _ev(1, 0, "fusion", 0.0, 100.0),
        _ev(1, 0, "copy", 10.0, 30.0),
        _ev(1, 0, "reshape", 50.0, 20.0),
        _ev(1, 0, "dot", 200.0, 40.0),
    ], {"copy": 30.0, "reshape": 20.0, "dot": 40.0}),
    "host_lanes_excluded": ([
        _meta(1, "/device:TPU:0"),
        _meta(2, "python"),
        _ev(1, 0, "dot", 0.0, 10.0),
        _ev(2, 0, "dispatch", 0.0, 9999.0),
    ], {"dot": 10.0}),
    "scopes_filtered": ([
        _meta(1, "/device:TPU:0"),
        _ev(1, 0, "jit_step", 0.0, 500.0),
        _ev(1, 1, "while", 0.0, 500.0),
        _ev(1, 1, "dot", 10.0, 50.0),
        _ev(1, 0, "copy", 20.0, 5.0),
    ], {"dot": 50.0, "copy": 5.0}),
    "same_name_leafs_sum_across_tracks": ([
        _meta(1, "TPU:0 runtime"),
        _ev(1, 0, "dot", 0.0, 10.0),
        _ev(1, 1, "dot", 0.0, 15.0),
        _ev(1, 0, "dot", 100.0, 25.0),
    ], {"dot": 50.0}),
    "gpu_lane_by_process_name": ([
        _meta(3, "/device:GPU:0"),
        _meta(4, "python"),
        _ev(3, 7, "copy.1", 0.0, 4.0),
        _ev(3, 7, "custom-call.3", 5.0, 6.0),
        _ev(4, 7, "copy.1", 0.0, 100.0),
    ], {"copy.1": 4.0, "custom-call.3": 6.0}),
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_device_op_totals_matches_jax(tmp_path, case):
    events, want = SYNTHETIC[case]
    d = _write_trace(tmp_path, events)
    got = tracing.device_op_totals(d)
    assert got == jtracing.device_op_totals(d) == want


def test_empty_trace_dir_matches_jax(tmp_path):
    assert tracing.device_op_totals(str(tmp_path)) == jtracing.device_op_totals(str(tmp_path)) == {}


@pytest.mark.parametrize("totals", [
    # tests/test_tracing.py::test_categorize_buckets
    {"deblock_tiles_pallas": 10.0, "custom-call.3": 5.0, "copy.1": 7.0,
     "convolution_convert_fusion": 3.0, "rng-something": 2.0},
    {"fusion": 1.0, "transpose.2": 2.0, "bitcast": 3.0, "reshape.1": 4.0,
     "concatenate": 5.0, "pad.7": 6.0, "slice": 7.0, "convert": 8.0, "dot.1": 9.0,
     "mosaic_kernel": 10.0, "jit_step": 11.0, "while": 12.0, "all-reduce": 13.0},
    {},
], ids=["jax-test", "xla-names", "empty"])
def test_categorize_matches_jax(totals):
    assert tracing.categorize_ops(totals) == jtracing.categorize_ops(totals)


def test_categorize_port_names():
    """The port's kernels and PyTorch's copy kernels land in their buckets."""
    cats = tracing.categorize_ops({
        "void (anonymous namespace)::deblock_quad_kernel<false, 8>(...)": 5.0,
        "void (anonymous namespace)::deblock_tiles_i16_kernel<true>(...)": 1.0,
        "void (anonymous namespace)::deblock_rows_kernel<false>(...)": 1.0,
        "(anonymous namespace)::swar_tiles_kernel(...)": 1.0,
        "(anonymous namespace)::plane_to_tiles_kernel(...)": 3.0,
        "(anonymous namespace)::tiles_to_plane_kernel(...)": 3.0,
        "(anonymous namespace)::pack_yv12_kernel(...)": 2.0,
        "Memcpy HtoD (Pinned -> Device)": 1.5,
        "Memset (Device)": 0.5,
        "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<unsigned "
        "char>, ...>(...)": 0.25,
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>(...)": 0.25,
        "void at::native::elementwise_kernel<128, 2, ...direct_copy_kernel_cuda...>(...)": 0.5,
        "ncclDevKernel_AllReduce": 2.0,
    })
    assert cats["deblock_kernels"] == 8.0
    assert cats["layout_and_copies"] == 11.0
    assert cats["other"] == 2.0
    assert cats["total"] == 21.0


# One replay of the streaming step's CUDA graph at 1920x1080 (T2, K1, T3 for
# luma; T2, K1c, T3 for U+V), as torch.profiler's export_chrome_trace wrote
# it on an H100 80GB HBM3 (torch 2.11, CUDA 12.8): the host process and the
# device share process_name "python3"; process_labels tells "CPU" from
# "GPU 0"; kernels sit on the device pid with tid = the stream; the host's
# cudaGraphLaunch, the flow arrows (ac2g), the profiler's overhead span
# (pid -1) and its own spans (pid "Spans") are no device work.
_T2 = "(anonymous namespace)::plane_to_tiles_kernel(unsigned char const*, unsigned char*, " \
      "gvct::RelayoutGeom)"
_T3 = "(anonymous namespace)::tiles_to_plane_kernel(unsigned char const*, unsigned char*, " \
      "gvct::RelayoutGeom)"
_QUAD_ARGS = "(unsigned char const*, unsigned char*, unsigned char const*, unsigned char " \
             "const*, unsigned char const*, unsigned char const*, gvct::Thresholds, long " \
             "long, long long)"
_K1 = "void (anonymous namespace)::deblock_quad_kernel<false, 8>" + _QUAD_ARGS
_K1C = "void (anonymous namespace)::deblock_quad_kernel<true, 4>" + _QUAD_ARGS
TORCH_TRACE = {
    "schemaVersion": 1,
    "deviceProperties": [{"id": 0, "name": "NVIDIA H100 80GB HBM3", "computeMajor": 9,
                          "computeMinor": 0, "numSms": 132}],
    "traceEvents": [
        {"name": "process_name", "ph": "M", "ts": 1341806263182.914, "pid": 118, "tid": 0,
         "args": {"name": "python3"}},
        {"name": "process_labels", "ph": "M", "ts": 1341806263182.914, "pid": 118, "tid": 0,
         "args": {"labels": "CPU"}},
        {"name": "process_sort_index", "ph": "M", "ts": 1341806263182.914, "pid": 118,
         "tid": 0, "args": {"sort_index": 118}},
        {"name": "process_name", "ph": "M", "ts": 1341806263182.914, "pid": 0, "tid": 0,
         "args": {"name": "python3"}},
        {"name": "process_labels", "ph": "M", "ts": 1341806263182.914, "pid": 0, "tid": 0,
         "args": {"labels": "GPU 0"}},
        {"name": "process_sort_index", "ph": "M", "ts": 1341806263182.914, "pid": 0, "tid": 0,
         "args": {"sort_index": 5000000}},
        {"name": "thread_name", "ph": "M", "ts": 1341806263182.914, "pid": 0, "tid": 7,
         "args": {"name": "stream 7 "}},
        {"ph": "X", "cat": "overhead", "name": "Activity Buffer Request", "pid": -1, "tid": 0,
         "ts": 1341806263443.884, "dur": 2639.125},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "pid": 118,
         "tid": 952429824, "ts": 1341806266124.517, "dur": 121.768,
         "args": {"cbid": 311, "correlation": 7}},
        {"ph": "s", "id": 7, "pid": 118, "tid": 952429824, "ts": 1341806266124.517,
         "cat": "ac2g", "name": "ac2g"},
        {"ph": "X", "cat": "kernel", "name": _T2, "pid": 0, "tid": 7,
         "ts": 1341806266249.733, "dur": 3.745},
        {"ph": "f", "id": 7, "pid": 0, "tid": 7, "ts": 1341806266249.733, "cat": "ac2g",
         "name": "ac2g", "bp": "e"},
        {"ph": "X", "cat": "kernel", "name": _K1, "pid": 0, "tid": 7,
         "ts": 1341806266253.734, "dur": 4.386},
        {"ph": "X", "cat": "kernel", "name": _T3, "pid": 0, "tid": 7,
         "ts": 1341806266258.376, "dur": 3.17},
        {"ph": "X", "cat": "kernel", "name": _T2, "pid": 0, "tid": 7,
         "ts": 1341806266261.802, "dur": 2.945},
        {"ph": "X", "cat": "kernel", "name": _K1C, "pid": 0, "tid": 7,
         "ts": 1341806266265.003, "dur": 2.722},
        {"ph": "X", "cat": "kernel", "name": _T3, "pid": 0, "tid": 7,
         "ts": 1341806266267.981, "dur": 2.753},
        {"ph": "X", "cat": "Trace", "ts": 1341806263091.86, "dur": 4578.757, "pid": "Spans",
         "tid": "PyTorch Profiler", "name": "PyTorch Profiler (0)", "args": {"Op count": 0}},
        {"name": "Record Window End", "ph": "i", "s": "g", "pid": "", "tid": "",
         "ts": 1341806267895.506},
    ],
}


@pytest.mark.parametrize("name", ["trace.json", "trace.json.gz"])
def test_torch_profiler_format(tmp_path, name):
    """Only the GPU lane's kernels count; both file forms are read."""
    path = tmp_path / name
    opener = gzip.open if name.endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump(TORCH_TRACE, f)
    totals = tracing.device_op_totals(str(tmp_path))
    assert totals == pytest.approx({_T2: 3.745 + 2.945, _T3: 3.17 + 2.753, _K1: 4.386,
                                    _K1C: 2.722})
    cats = tracing.categorize_ops(totals)
    assert cats["deblock_kernels"] == pytest.approx(4.386 + 2.722)
    assert cats["layout_and_copies"] == pytest.approx(3.745 + 2.945 + 3.17 + 2.753)
    assert "other" not in cats


def test_annotation_spans_are_not_device_work(tmp_path):
    """A record_function range mirrored onto the GPU lane encloses kernels
    (or none): it is filtered by category, not counted as a leaf."""
    events = TORCH_TRACE["traceEvents"][:7] + [
        {"ph": "X", "cat": "gpu_user_annotation", "name": "step", "pid": 0, "tid": 8,
         "ts": 10.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": _K1, "pid": 0, "tid": 7, "ts": 12.0, "dur": 4.0},
    ]
    assert tracing.device_op_totals(_write_trace(tmp_path, events, "t.json")) == {_K1: 4.0}


def test_profiled_device_us_none_without_a_device_lane():
    """On the CPU the trace holds host lanes only."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the trace has a device lane")
    x = torch.arange(64)
    assert tracing.profiled_device_us(lambda: x + 1, iters=3) is None


def test_profiled_device_us_keeps_trace(tmp_path):
    """trace_dir keeps the exported Chrome trace, which device_op_totals reads."""
    x = torch.arange(64)
    res = tracing.profiled_device_us(lambda: x * 2, iters=2, trace_dir=str(tmp_path / "t"))
    files = os.listdir(tmp_path / "t")
    assert files == ["trace.json"]
    with open(tmp_path / "t" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert (res is None) == (not torch.cuda.is_available())
