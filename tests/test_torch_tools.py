"""The port's host tools: tools/psnr.py, tools/sass.py with swar_exp --ops,
and tools/validate_vs_reference.py, against the JAX package's tools.

Here on the CPU: psnr as a subprocess beside the JAX tool on the same
files (stdout, stderr and exit code equal; the usage text names its own
program); the SASS and ptxas parsers on canned listings; swar_exp --ops
on the CPU (null counts and the reason) and without a toolchain (it
raises); validate_vs_reference's driver, cases, LCG, UB mask and fuzz
draws against the JAX tool's, and its plumbing through g++ against two
stand-ins for the reference header (one that leaves the frame unfiltered,
one that filters with the port's own runtime/src).  Tests marked `cuda`
run on the card; those marked `slow` compile the real reference from its
checkout ($GVCT_REFERENCE_DIR, else the JAX tool's DEFAULT_REF) and skip
without it.  The JAX tools are imported inside the tests that compare
with them, so this file imports nothing of JAX and its `cuda` tests also
run where JAX is not installed.  There is no tolerance:
every comparison is byte or value equality."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from gpu_video_codec_tpu_torch.models.golden import deblock_frame_golden
from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck
from gpu_video_codec_tpu_torch.tools import psnr, sass, swar_exp
from gpu_video_codec_tpu_torch.tools import validate_vs_reference as vvr
from gpu_video_codec_tpu_torch.utils.bs import BoundaryStrength
from gpu_video_codec_tpu_torch.utils.yuv import read_yv12, yv12_bytes_from_planes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNTIME_SRC = os.path.join(REPO, "gpu_video_codec_tpu_torch", "runtime", "src")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _run(*args) -> tuple[int, str, str]:
    r = subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    return r.returncode, r.stdout, r.stderr


# -- psnr --------------------------------------------------------------------------

W, H = 16, 8  # a frame is 192 bytes
FRAME = 3 * W * H // 2


def _psnr_files(tmp_path, case: str) -> list[str]:
    """Two files of `case` (or the wrong argument list for "usage")."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, 3 * FRAME, dtype=np.uint8)
    b = a.copy()
    b[FRAME:2 * FRAME] ^= (rng.random(FRAME) < 0.3).astype(np.uint8) * 3  # frame 1 differs
    b[2 * FRAME + W * H:] = rng.integers(0, 256, FRAME - W * H)  # frame 2: chroma only
    pairs = {
        "identical": (a[:2 * FRAME], a[:2 * FRAME]),
        "differing": (a[:FRAME], 255 - a[:FRAME]),
        "three-frames": (a, b),
        "truncated-mid-frame": (a, b[:2 * FRAME + FRAME // 2]),
        "shorter-than-a-frame": (a[:FRAME - 1], a[:FRAME - 1]),
    }
    if case == "usage":
        return [str(tmp_path / "x.yuv"), str(W), str(H)]
    paths = []
    for name, data in zip("ab", pairs[case]):
        paths.append(str(tmp_path / f"{name}.yuv"))
        data.tofile(paths[-1])
    return paths + [str(W), str(H)]


@pytest.mark.parametrize("case", ["identical", "differing", "three-frames", "truncated-mid-frame",
                                  "shorter-than-a-frame", "usage"])
def test_psnr_matches_jax_tool(tmp_path, case):
    """The port's psnr and tools/psnr.py, both as subprocesses on the same
    files: equal stdout, stderr and exit code.  The usage text differs only
    in the command it names."""
    args = _psnr_files(tmp_path, case)
    want = _run(os.path.join("tools", "psnr.py"), *args)
    got = _run("-m", "gpu_video_codec_tpu_torch.tools.psnr", *args)
    rc, out, err = got
    err = err.replace("python -m gpu_video_codec_tpu_torch.tools.psnr", "python tools/psnr.py")
    assert (rc, out, err) == want
    expect_rc = {"usage": 2, "truncated-mid-frame": 1, "shorter-than-a-frame": 1}.get(case, 0)
    assert rc == expect_rc, (case, got)
    if case == "three-frames":
        frames = json.loads(out)
        assert [f["identical"] for f in frames] == [True, False, False]
        assert frames[0]["psnr_y"] is None and frames[2]["psnr_y"] is None
        assert frames[1]["psnr_y"] > 0 and frames[2]["psnr_uv"] > 0
    if case == "truncated-mid-frame":
        assert len(json.loads(out)) == 2 and "comparing the first 2" in err


def test_psnr_on_cli_output_against_golden(tmp_path, capsys):
    """The port CLI's output (--backend torch --device cpu) and golden's,
    written with yv12_bytes_from_planes: identical, psnr null; against the
    unfiltered input: finite PSNRs."""
    from gpu_video_codec_tpu_torch import cli

    src = os.path.join(REPO, "testdata", "mother-daughter_352x288_yv12.yuv")
    out, gold = str(tmp_path / "cli.yuv"), str(tmp_path / "gold.yuv")
    assert cli.main(["-i", src, "-W", "352", "-H", "288", "--qp", "35", "-o", out,
                     "--backend", "torch", "--device", "cpu"]) == 0
    g = deblock_frame_golden(read_yv12(src, 352, 288), BoundaryStrength.intra_default(352, 288), 35)
    with open(gold, "wb") as f:
        f.write(yv12_bytes_from_planes(g))
    capsys.readouterr()
    assert psnr.main([out, gold, "352", "288"]) == 0
    (frame,) = json.loads(capsys.readouterr().out)
    assert frame == {"frame": 0, "psnr_y": None, "psnr_uv": None, "max_abs_diff": 0,
                     "identical": True}
    assert psnr.main([src, out, "352", "288"]) == 0
    (frame,) = json.loads(capsys.readouterr().out)
    assert not frame["identical"] and frame["max_abs_diff"] > 0
    assert 20 < frame["psnr_y"] < 99 and 20 < frame["psnr_uv"] < 99


# -- static SASS counts --------------------------------------------------------------

LISTING = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

	code for sm_90a
		Function : _Z8kernel_aPhi
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                       /* 0x00000a00ff017b82 */
                                                                                /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                           /* 0x0000000000007919 */
                                                                                /* 0x000e220000002100 */
        /*0020*/               @P0 EXIT ;                                       /* 0x000000000000094d */
        /*0030*/              @!PT LDS RZ, [RZ] ;                               /* 0x00000000ffff7984 */
        /*0040*/                   IMAD.MOV.U32 R2, RZ, RZ, R0 ;                /* 0x000000ffff027224 */
        /*0050*/              @UP0 IMAD.MOV.U32 R3, RZ, RZ, 0x1 ;               /* 0x00000001ff037424 */
.L_x_0:
        /*0060*/                   BRA `(.L_x_0);                               /* 0xfffffffc00fc7947 */
        /*0070*/                   NOP;                                         /* 0x0000000000007918 */
		..........


		Function : _Z8kernel_bv
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LOP3.LUT R0, R1, 0xff, RZ, 0xc0, !PT ;       /* 0x000000ff01007812 */
        /*0010*/             @!UP1 VIADD.16 R2, R0, 0x2 ;                       /* 0x0000000200027836 */
        /*0020*/                   LOP3.LUT R3, R2, 0x1, RZ, 0xc0, !PT ;        /* 0x0000000102037812 */
        /*0030*/                   EXIT ;                                       /* 0x000000000000794d */
		..........
"""

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z8kernel_aPhi' for 'sm_90a'
ptxas info    : Function properties for _Z8kernel_aPhi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 47 registers, 4352 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z8kernel_bv' for 'sm_90a'
ptxas info    : Function properties for _Z8kernel_bv
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, 360 bytes cmem[0]
"""


def test_sass_entries_counts_a_listing():
    """Instructions are the /*address*/ lines with a `;`, predicated or not;
    labels, encodings, headers and dots are not."""
    got = sass.sass_entries(LISTING)
    assert list(got) == ["_Z8kernel_aPhi", "_Z8kernel_bv"]
    n, ops = got["_Z8kernel_aPhi"]
    assert n == 8
    assert ops == {"LDC": 1, "S2R": 1, "EXIT": 1, "LDS": 1, "IMAD.MOV.U32": 2, "BRA": 1, "NOP": 1}
    n, ops = got["_Z8kernel_bv"]
    assert n == 4 and ops == {"LOP3.LUT": 2, "VIADD.16": 1, "EXIT": 1}
    assert sass.sass_entries("") == {}


def test_ptxas_entries_reads_registers_spills_smem():
    assert sass.ptxas_entries(PTXAS_LOG) == {
        "_Z8kernel_aPhi": {"smem": 4352, "spill_stores": 0, "spill_loads": 0, "registers": 47},
        "_Z8kernel_bv": {"smem": 0, "spill_stores": 12, "spill_loads": 16, "registers": 255},
    }


def test_static_sass_needs_cuobjdump(tmp_path):
    with pytest.raises(FileNotFoundError, match="cuobjdump not found"):
        sass.static_sass(tmp_path / "lib.so", str(tmp_path / "bin" / "nvcc"))


def test_swar_ops_on_cpu_prints_nulls_and_reason(capsys):
    res = swar_exp.main(["--ops", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == res
    assert res["reason"] == "static SASS needs nvcc and cuobjdump" and res["device"] == "cpu"
    counts = {k: v for k, v in res.items() if k not in ("reason", "device")}
    assert "int32_sass_static" in counts and "swar_chroma_sass_static" in counts
    assert all(v is None for v in counts.values())


def test_swar_ops_without_toolchain_raises(tmp_path, monkeypatch):
    """On the card's path (no --device cpu) a missing nvcc is an error, not
    a null."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(ck, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        swar_exp.ops("cuda")


@pytest.mark.cuda
def test_swar_ops_on_card(cuda_device, capsys):
    """K1's luma W8 entry keeps chip_smoke's QUAD_INT_COUNTS count (960);
    T1's lane-equivalent ratio is its count / 2 over K1's."""
    res = swar_exp.main(["--ops"])
    assert res["int32_sass_static"] == 960
    for part in ("", "_chroma"):
        swar, int32 = res[f"swar{part}_sass_static"], res[f"int32{part}_sass_static"]
        assert res[f"swar{part}_lane_equivalent"] == swar / 2
        assert res[f"predicted{part}_ratio_vs_int32"] == round(swar / 2 / int32, 2)
    assert all(len(c) == 12 for c in res["opcodes"].values())


# -- validate_vs_reference: what it shares with the JAX tool -------------------------------

def _jax_tool():
    from tools import validate_vs_reference

    return validate_vs_reference


def test_validate_driver_and_cases_equal_jax_tool():
    jt = _jax_tool()
    assert vvr.DRIVER == jt.DRIVER
    assert vvr.CASES == jt.CASES


@pytest.mark.parametrize("seed,nv,nh", [(12345, 1, 1), (999, 3705, 3744), (1, 15, 10),
                                        ((1 << 64) + 7, 40, 0), (2 ** 31 - 1, 130, 129)])
def test_lcg_bs_equals_jax_tool(seed, nv, nh):
    want = _jax_tool()._lcg_bs(seed, nv, nh)
    got = vvr._lcg_bs(seed, nv, nh)
    assert all(np.array_equal(g, w) and g.dtype == np.uint8 for g, w in zip(got, want))
    assert got[0].size == nv and got[1].size == nh


@pytest.mark.parametrize("chroma_ub", [False, True])
@pytest.mark.parametrize("ww,hh", [(20, 12), (36, 28), (52, 4)])
def test_ub_masked_diffs_equals_jax_tool(ww, hh, chroma_ub):
    """Random pairs at sheared widths (ww % 8 == 4): both tools count the
    same diffs outside the UB regions, and the mask hides some."""
    rng = np.random.default_rng(ww * 100 + hh + chroma_ub)
    jt = _jax_tool()
    masked_some = False
    for density in (0.02, 0.2, 1.0):
        o = rng.integers(0, 256, ww * hh, dtype=np.uint8)
        r = np.where(rng.random(ww * hh) < density, rng.integers(0, 256, ww * hh), o).astype(
            np.uint8)
        got = vvr._ub_masked_diffs(o, r, ww, hh, chroma_ub=chroma_ub)
        assert got == jt._ub_masked_diffs(o, r, ww, hh, chroma_ub=chroma_ub)
        masked_some |= got < int(np.sum(o != r))
    assert masked_some


def test_fuzz_cases_draw_what_the_jax_fuzz_draws(monkeypatch, capsys):
    """Run the JAX tool's fuzz() with its reference binary replaced by a
    recorder (which leaves the frame unfiltered): the cases it writes are
    fuzz_cases(8, 3)'s, dims, QP, BS seed and bytes."""
    jt = _jax_tool()
    seen = []

    def run(cmd, check=True, **kw):
        raw = np.fromfile(cmd[1], np.uint8)
        seen.append((int(cmd[2]), int(cmd[3]), int(cmd[4]),
                     int(cmd[6]) if len(cmd) > 6 else None, raw))
        raw.tofile(cmd[5])

    monkeypatch.setattr(jt, "build_reference", lambda ref_dir, td: "reference")
    monkeypatch.setattr(jt, "subprocess", type("Recorder", (), {"run": staticmethod(run)}))
    jt.fuzz("unused", 8, seed=3)
    capsys.readouterr()
    got = list(vvr.fuzz_cases(8, 3))
    assert len(seen) == len(got) == 8
    for (w, h, qp, seed, raw), (gw, gh, gqp, gseed, graw) in zip(seen, got):
        assert (w, h, qp, seed) == (gw, gh, gqp, gseed)
        assert np.array_equal(raw, graw)
    assert any(s is None for *_, s, _ in seen) and any(s is not None for *_, s, _ in seen)


# -- validate_vs_reference: plumbing through g++ against stand-in headers ---------------

STUB_HEADER = r"""// Stand-in for the reference's hevc_deblocking_filter_cpu.h: its class API
// over extended planes (image at +4, zero padding) and the flat all-Intra
// BS arrays; DeblockingFilter runs the port's native runtime when
// GVCT_STUB_FILTER is 1 and leaves the frame unfiltered when it is 0.
#pragma once
#define GVCT_STUB_FILTER @FILTER@
#include <cstdint>
#include <cstdio>
#include <vector>
#if GVCT_STUB_FILTER
#include "@RUNTIME@/deblock_cpu.cpp"
#include "@RUNTIME@/deblock_cpu_avx512.cpp"
#endif

class ReadYuvFrame {
 public:
  ReadYuvFrame(const char *path, unsigned w, unsigned h, int qp) : w_(w), h_(h), qp_(qp) {
    if (w % 8 || h % 8) throw "Width and height of image must be multiplier of sample block size";
    FILE *f = fopen(path, "rb");
    if (!f) throw "Cannot open file";
    std::vector<uint8_t> raw(3 * w * h / 2);
    size_t got = fread(raw.data(), 1, raw.size(), f);
    fclose(f);
    if (got != raw.size()) throw "Incorrect file size";
    const uint8_t *p = extend(y_, raw.data(), w, h);
    extend(v_, extend(u_, p, w / 2, h / 2), w / 2, h / 2);
    vert_ = intra((w / 8 + 1) * h / 8, w / 8 + 1);
    hor_ = intra((h / 8 + 1) * w / 8, h / 8 + 1);
    cvert_ = intra((w / 16 + 1) * (h / 2) / 8, w / 16 + 1);
    chor_ = intra((h / 16 + 1) * (w / 2) / 8, h / 16 + 1);
  }
  void SetBoundaryStrenght(unsigned char *v, unsigned nv, unsigned char *hh, unsigned nh) {
    if (nv != vert_.size() || nh != hor_.size()) throw "Incorrect size of BS arrays";
    vert_.assign(v, v + nv);
    hor_.assign(hh, hh + nh);
  }
  void DeblockingFilter(int threads) {
#if GVCT_STUB_FILTER
    if (gvct_deblock_frame(y_.data(), u_.data(), v_.data(), w_, h_, vert_.data(), vert_.size(),
                           hor_.data(), hor_.size(), cvert_.data(), cvert_.size(),
                           chor_.data(), chor_.size(), qp_, 0, threads))
      throw "gvct_deblock_frame failed";
#endif
  }
  void Save(const char *path) {
    FILE *f = fopen(path, "wb");
    if (!f) throw "Cannot open output file";
    save(f, y_, w_, h_);
    save(f, u_, w_ / 2, h_ / 2);
    save(f, v_, w_ / 2, h_ / 2);
    fclose(f);
  }

 private:
  static const uint8_t *extend(std::vector<uint8_t> &ext, const uint8_t *p, unsigned w,
                               unsigned h) {
    ext.assign((h + 8) * (w + 8), 0);
    for (unsigned r = 0; r < h; ++r)
      for (unsigned c = 0; c < w; ++c) ext[(r + 4) * (w + 8) + c + 4] = p[r * w + c];
    return p + w * h;
  }
  static void save(FILE *f, const std::vector<uint8_t> &ext, unsigned w, unsigned h) {
    for (unsigned r = 0; r < h; ++r) fwrite(&ext[(r + 4) * (w + 8) + 4], 1, w, f);
  }
  static std::vector<uint8_t> intra(unsigned n, unsigned stride) {
    std::vector<uint8_t> bs(n, 2);
    for (unsigned i = 0; i < n; i += stride) bs[i] = 0;
    return bs;
  }
  unsigned w_, h_;
  int qp_;
  std::vector<uint8_t> y_, u_, v_, vert_, hor_, cvert_, chor_;
};
"""


def _stub(tmp_path, filtering: bool) -> str:
    d = tmp_path / ("filtering" if filtering else "unfiltered")
    d.mkdir()
    (d / vvr.HEADER).write_text(STUB_HEADER.replace("@FILTER@", str(int(filtering)))
                                .replace("@RUNTIME@", RUNTIME_SRC))
    return str(d)


def _validate(*argv) -> tuple[int, list[str]]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = vvr.main(list(argv))
    return rc, buf.getvalue().splitlines()


@pytest.mark.parametrize("mode", [[], ["--fuzz", "2", "0", "32", "32"], ["--fullscale"]],
                         ids=["cases", "fuzz", "fullscale"])
def test_validate_without_header_exits_2(tmp_path, capsys, monkeypatch, mode):
    """A REF_DIR without the header exits 2, in every mode, with the JAX
    tool's message; with no REF_DIR the directory comes from
    $GVCT_REFERENCE_DIR, and with neither the tool exits 2 and says so."""
    want = f"reference header not found at {tmp_path / vvr.HEADER}; pass REF_DIR\n"
    monkeypatch.delenv(vvr.REF_ENV, raising=False)
    rc, lines = _validate(*mode, str(tmp_path), "--backend", "golden")
    assert rc == 2 and lines == [] and capsys.readouterr().err == want
    rc, lines = _validate(*mode, "--backend", "golden")
    assert rc == 2 and lines == []
    assert capsys.readouterr().err == ("no reference checkout given; pass REF_DIR or set "
                                       "GVCT_REFERENCE_DIR\n")
    monkeypatch.setenv(vvr.REF_ENV, str(tmp_path))
    rc, lines = _validate(*mode, "--backend", "golden")
    assert rc == 2 and lines == [] and capsys.readouterr().err == want


def test_validate_reports_an_unfiltered_reference(tmp_path):
    """Against a stand-in that leaves frames unfiltered, the 8 cases and a
    fuzz campaign on the golden backend report diffs and exit 1."""
    ref = _stub(tmp_path, filtering=False)
    rc, lines = _validate(ref, "--backend", "golden")
    assert rc == 1 and len(lines) == len(vvr.CASES)
    assert all(line.endswith(" byte diffs") for line in lines), lines
    rc, lines = _validate("--fuzz", "2", "0", "128", "96", ref, "--backend", "golden")
    assert rc == 1 and len(lines) == 3 and lines[0].startswith("fuzz[0] ")
    assert sum("REAL DIVERGENCE outside UB regions" in line for line in lines) >= 1, lines
    assert lines[-1].startswith("fuzz: 2 cases, ") and not lines[-1].endswith(" 0 real divergences")


@pytest.mark.parametrize("backend", ["cuda", "torch", "golden", "native"])
def test_validate_fuzz_identical_to_a_filtering_reference(tmp_path, backend):
    """Against a stand-in that filters with the port's runtime/src, every
    backend (cuda and torch on the CPU: the kernels' plain versions) is
    byte-identical on fuzz cases: sheared widths, QPs above 51, LCG BS."""
    ref = _stub(tmp_path, filtering=True)
    rc, lines = _validate("--fuzz", "6", "3", "128", "96", ref, "--backend", backend,
                          "--device", "cpu")
    assert rc == 0, lines
    if backend == "native":  # the JAX tool names the native backend only
        assert lines.pop(0).startswith("fuzz backend: native (")
    assert len(lines) == 7 and all(line.endswith(": IDENTICAL") for line in lines[:-1]), lines
    assert lines[-1] == "fuzz: 6 cases, 0 real divergences"


def test_validate_cases_and_fullscale_identical_to_a_filtering_reference(tmp_path):
    ref = _stub(tmp_path, filtering=True)
    rc, lines = _validate(ref, "--backend", "native")
    assert rc == 0 and len(lines) == len(vvr.CASES)
    assert all(line.endswith(": IDENTICAL") for line in lines), lines
    rc, lines = _validate("--fullscale", ref, "--backend", "native")
    assert rc == 0
    assert lines[0] == "fullscale 1920x1080 qp=35: 1-thread vs 4-thread reference: IDENTICAL"
    assert lines[1].startswith("fullscale 1920x1080 qp=35: native vs compiled reference: "
                               "IDENTICAL (")


@pytest.mark.cuda
def test_validate_fuzz_on_card_against_a_filtering_reference(tmp_path, cuda_device):
    ref = _stub(tmp_path, filtering=True)
    rc, lines = _validate("--fuzz", "12", "0", "256", "160", ref)
    assert rc == 0, lines
    assert lines[-1] == "fuzz: 12 cases, 0 real divergences"


# -- validate_vs_reference against the compiled reference (its checkout) ----------------

@pytest.mark.slow
@pytest.mark.parametrize("backend", ["cuda", "native"])
@pytest.mark.parametrize("mode", ["cases", "fuzz", "fullscale"])
def test_validate_against_compiled_reference(mode, backend):
    ref_dir = os.environ.get(vvr.REF_ENV) or _jax_tool().DEFAULT_REF
    if not os.path.exists(os.path.join(ref_dir, vvr.HEADER)):
        pytest.skip("reference checkout unavailable")
    if backend == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = {"cases": [ref_dir], "fuzz": ["--fuzz", "6", "3", "128", "96", ref_dir],
            "fullscale": ["--fullscale", ref_dir]}[mode]
    rc, out, err = _run("-m", "gpu_video_codec_tpu_torch.tools.validate_vs_reference", *args,
                        "--backend", backend)
    assert rc == 0, f"stdout:\n{out}\nstderr:\n{err}"
    lines = out.strip().splitlines()
    if mode == "cases":
        assert all(line.endswith("IDENTICAL") for line in lines), out
    elif mode == "fuzz":
        assert lines[-1] == "fuzz: 6 cases, 0 real divergences", out
    else:
        assert "1-thread vs 4-thread reference: IDENTICAL" in lines[0], out
        assert f"{backend} vs compiled reference: IDENTICAL" in lines[1], out
