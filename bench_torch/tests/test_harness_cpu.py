"""The harness end to end on the CPU at a small size, its look for a chip
skipped: sound runs come out correct, and the control and each fault the
cells can have come out not correct.  Also the shape of BENCHMARK.json
(keys, names, units, bounds, files), and the exit without a card.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
import types

import pytest
import torch

from bench_torch.lib import harness, spec

SPEC = spec.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
# every traffic mix of bench_torch/traffic, a cell of BENCHMARK.json or not
MIXES = sorted(p.stem for p in (spec.BENCH / "traffic").glob("*.json"))


def _mix(traffic):
    return spec.load_json(spec.BENCH / "traffic" / f"{traffic}.json")


DEVICE_MIXES = [t for t in MIXES if _mix(t)["feed"] == "device"]


SEED = 2**31 + 99


def small_run(traffic, control=False, seconds=0.3, **cfg_keys):
    """One run of a mix on the CPU at 64x48, under the cell of BENCHMARK.json
    that uses it (or a cell of its own on the first configuration), with
    cfg_keys in place of the configuration's own."""
    cell = next((w for w in SPEC["workloads"] if w["traffic"] == traffic),
                {"name": f"cpu_{traffic}", "config": SPEC["configs"][0]["name"],
                 "traffic": traffic, "chips": 1})
    cfg = dict(spec.config(SPEC, cell), width=64, height=48, **cfg_keys)
    mix = dict(_mix(traffic), warmup_batches=2)
    return harness.run_cell(SPEC, cell, cfg, mix, SEED, seconds, False, control,
                            time.perf_counter(), device="cpu")


@pytest.mark.parametrize("traffic", MIXES)
def test_sound_run_is_correct(traffic):
    result, compared = small_run(traffic)
    assert result["correct"] is True
    assert compared["wrong_bytes"] == 0 and compared["frames_compared"] > 0
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    for w in SPEC["workloads"]:
        if w["traffic"] == traffic:
            assert set(result["metrics"]) == {m["name"] for m in spec.metrics(SPEC, w["name"], False)}


@pytest.mark.parametrize("traffic", MIXES)
def test_control_is_not_correct(traffic):
    result, compared = small_run(traffic, control=True)
    assert result["correct"] is False
    assert compared["wrong_bytes"] > 0


def _faulty_packed(mp, fault):
    from gpu_video_codec_tpu_torch.parallel import mesh as pm

    real = pm.deblock_packed_batch_sharded_jit

    def step(mesh, buf, *args, **kw):
        if fault == "unchanged":
            return buf
        if fault == "half_batch":
            return real(mesh, buf[: buf.shape[0] // 2], *args, **kw)
        real(mesh, buf, *args, **kw)
        buf[-1, 5, 7] ^= 1  # one byte altered where it is produced
        return buf
    mp.setattr(pm, "deblock_packed_batch_sharded_jit", step)


@pytest.mark.parametrize("traffic", DEVICE_MIXES)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_device_fed_faults_are_caught(traffic, fault, monkeypatch):
    _faulty_packed(monkeypatch, fault)
    result, compared = small_run(traffic)
    assert result["correct"] is False and compared["wrong_bytes"] > 0


# -- 10 bits (HEVC Main 10): the program called as feeds/device.py's docstring says,
# played by the reference's floor arithmetic; a program that filters as at 8 bits fails

MAIN10 = {"bit_depth": 10, "content": {"luma_dc": 96, "chroma_dc": 48}}


def _standin_program(mp, traffic, fault=None, chroma_format="4:2:0", bit_depth=10):
    """Put a stand-in program in place of deblock_packed_batch_sharded_jit:
    a copy of the plain reference (its own module, so a fault planted in it
    leaves the check's reference whole) at the feed's bit depth and chroma
    format, with the fault planted."""
    from gpu_video_codec_tpu_torch.parallel import mesh as pm

    from bench_torch.lib import frames as fr
    from bench_torch.references import hevc_deblock as tables

    ref = spec._module(spec.BENCH / "references" / "hevc_deblock.py", "standin_hevc_deblock")
    cell = next(w for w in SPEC["workloads"] if w["traffic"] == traffic)
    qp = int(spec.config(SPEC, cell)["qp"])
    bs = fr.bs_arrays(64, 48, _mix(traffic), SEED, "cpu", chroma_format)
    if fault == "clip_255":
        ref.max_pixel = lambda bit_depth=8: 255
    if fault == "unscaled":
        ref.beta_tc = lambda qp, bit_depth=8: tables.beta_tc(qp)
    if fault in ("hor_every_16", "ver_every_16"):
        # chroma tile row by (column bx) holds the edge at chroma row 8 by (column 8 bx):
        # the horizontal (vertical) segments of odd tile rows (columns) left out
        gates = ref.gates

        def every_16(*args):
            g = gates(*args)
            if args[7]:  # chroma
                if fault == "hor_every_16":
                    g[2:, 1::2] = False
                else:
                    g[:2, :, 1::2] = False
            return g
        ref.gates = every_16
    expect_bd = bit_depth

    def program(mesh, buf, lm, cm, beta, tc, *, w, h, bit_depth=8, chroma_format="4:2:0"):
        # the feed's contract: the (k, rows, w) batch of the bit depth's dtype, the
        # tables' beta' and tc', bit_depth=10 at 10 bits, chroma_format other than 4:2:0
        rows = fr.packed_rows(w, h, chroma_format)
        assert (buf.dtype, buf.shape[1:], bit_depth, (beta, tc)) == \
            (fr.sample_dtype(expect_bd), (rows, w), expect_bd, tables.beta_tc(qp))
        cf = chroma_format
        if fault == "unchanged":
            return buf
        if fault == "shifted_8bit":
            eight = ref.deblock_packed((buf >> 2).to(torch.uint8), w, h, qp, bs, chroma_format=cf)
            return buf.copy_(eight.to(torch.int16) << 2)
        if fault == "halves_as_420":
            # each (h, w/2) chroma plane filtered as two (h/2, w/2) planes: the 4:2:0
            # chroma of two frames of height h, U's and V's, with 4:2:0's BS arrays
            planes = buf[:, h:].reshape(-1, h // 2, w)
            frames = torch.cat([buf[:, :h].repeat_interleave(2, 0), planes], dim=1)
            done = ref.deblock_packed(frames, w, h, qp, fr.bs_arrays(w, h, _mix(traffic), SEED,
                                                                     "cpu"), bit_depth=bit_depth)
            buf[:, :h] = done[0::2, :h]
            buf[:, h:] = done[:, h:].reshape(buf.shape[0], h, w)
            return buf
        before = buf.clone()
        part = buf[: buf.shape[0] // 2] if fault == "half_batch" else buf
        part.copy_(ref.deblock_packed(part, w, h, qp, bs, bit_depth=bit_depth, chroma_format=cf))
        if fault == "altered":
            buf[-1, 5, 7] ^= 1  # one byte altered where it is produced
        if fault == "v_unfiltered":  # V is the last (rows - h) / 2 rows
            buf[:, (rows + h) // 2 :] = before[:, (rows + h) // 2 :]
        return buf
    mp.setattr(pm, "deblock_packed_batch_sharded_jit", program)


@pytest.mark.parametrize("traffic", DEVICE_MIXES)
def test_main10_sound_program_is_correct(traffic, monkeypatch):
    _standin_program(monkeypatch, traffic)
    result, compared = small_run(traffic, **MAIN10)
    assert result["correct"] is True
    assert compared["wrong_bytes"] == 0 and compared["frames_compared"] > 0


@pytest.mark.parametrize("traffic", DEVICE_MIXES)
def test_main10_control_is_not_correct(traffic):
    result, compared = small_run(traffic, control=True, **MAIN10)
    assert result["correct"] is False and compared["wrong_bytes"] > 0


@pytest.mark.parametrize("traffic", DEVICE_MIXES)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "clip_255",
                                   "unscaled", "shifted_8bit"])
def test_main10_faults_are_caught(traffic, fault, monkeypatch):
    _standin_program(monkeypatch, traffic, fault)
    result, compared = small_run(traffic, **MAIN10)
    assert result["correct"] is False and compared["wrong_bytes"] > 0
    if fault == "altered":  # one byte in each batch compared
        assert compared["wrong_bytes"] == compared["frames_compared"] // _mix(traffic)["streams"]


@pytest.mark.parametrize("bit_depth, flip, wrong", [(8, 0x01, 1), (10, 0x0001, 1), (10, 0x0101, 2)])
@pytest.mark.parametrize("chroma_format, row", [("4:2:0", 50), ("4:2:2", 50), ("4:2:2", 90),
                                                 ("4:4:4", 130)])
def test_wrong_bytes_counts_bytes(bit_depth, flip, wrong, chroma_format, row):
    from bench_torch.lib import check
    from bench_torch.lib import frames as fr

    cfg = dict(spec.config(SPEC, SPEC["workloads"][0]), width=64, height=48, **MAIN10)
    cfg["bit_depth"], cfg["chroma_format"] = bit_depth, chroma_format
    frames = fr.frame_pool(2, 64, 48, 5, cfg["content"], "cpu", bit_depth, chroma_format)
    bs = fr.bs_arrays(64, 48, {"bs": "ai"}, 5, "cpu", chroma_format)
    out = check.reference_of(cfg).deblock_packed(frames, 64, 48, int(cfg["qp"]), bs,
                                                 bit_depth=bit_depth, chroma_format=chroma_format)
    assert check.wrong_bytes([(frames, out)], cfg, bs, "cpu") == (0, 2, 0)
    # row 90 of 96: the V plane of a 4:2:2 frame, past 4:2:0's 72 rows; row 130 of 144:
    # the V plane of a 4:4:4 frame, past 4:2:2's 96
    out[1, row, 9] ^= flip
    assert check.wrong_bytes([(frames, out)], cfg, bs, "cpu") == (wrong, 2, 1)


# -- 4:2:2 (HEVC Main 4:2:2 10): the program called with chroma_format="4:2:2" on a
# (k, 2h, w) batch; a program that filters the chroma planes with 4:2:0's geometry fails

MAIN422 = dict(MAIN10, chroma_format="4:2:2")


@pytest.mark.parametrize("traffic", DEVICE_MIXES)
def test_main422_sound_program_is_correct(traffic, monkeypatch):
    _standin_program(monkeypatch, traffic, chroma_format="4:2:2")
    result, compared = small_run(traffic, **MAIN422)
    assert result["correct"] is True
    assert compared["wrong_bytes"] == 0 and compared["frames_compared"] > 0


@pytest.mark.parametrize("traffic", DEVICE_MIXES)
def test_main422_control_is_not_correct(traffic):
    result, compared = small_run(traffic, control=True, **MAIN422)
    assert result["correct"] is False and compared["wrong_bytes"] > 0


@pytest.mark.parametrize("traffic", DEVICE_MIXES)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "halves_as_420",
                                   "hor_every_16", "v_unfiltered"])
def test_main422_faults_are_caught(traffic, fault, monkeypatch):
    _standin_program(monkeypatch, traffic, fault, chroma_format="4:2:2")
    result, compared = small_run(traffic, **MAIN422)
    assert result["correct"] is False and compared["wrong_bytes"] > 0


# -- 4:4:4 (HEVC Main 4:4:4, Main 4:4:4 10): the program called with
# chroma_format="4:4:4" on a (k, 3h, w) batch; a program that filters the (h, w) chroma
# planes with a subsampled format's edges, every 16 luma rows or columns, fails

MAIN444 = {8: {"bit_depth": 8, "chroma_format": "4:4:4",
               "content": {"luma_dc": 24, "chroma_dc": 12}},
           10: dict(MAIN10, chroma_format="4:4:4")}


@pytest.mark.parametrize("traffic", DEVICE_MIXES)
@pytest.mark.parametrize("bit_depth", sorted(MAIN444))
def test_main444_sound_program_is_correct(traffic, bit_depth, monkeypatch):
    _standin_program(monkeypatch, traffic, chroma_format="4:4:4", bit_depth=bit_depth)
    result, compared = small_run(traffic, **MAIN444[bit_depth])
    assert result["correct"] is True
    assert compared["wrong_bytes"] == 0 and compared["frames_compared"] > 0


@pytest.mark.parametrize("traffic", DEVICE_MIXES)
@pytest.mark.parametrize("bit_depth", sorted(MAIN444))
def test_main444_control_is_not_correct(traffic, bit_depth):
    result, compared = small_run(traffic, control=True, **MAIN444[bit_depth])
    assert result["correct"] is False and compared["wrong_bytes"] > 0


@pytest.mark.parametrize("traffic", DEVICE_MIXES)
@pytest.mark.parametrize("bit_depth", sorted(MAIN444))
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "hor_every_16",
                                   "ver_every_16", "v_unfiltered"])
def test_main444_faults_are_caught(traffic, bit_depth, fault, monkeypatch):
    _standin_program(monkeypatch, traffic, fault, chroma_format="4:4:4", bit_depth=bit_depth)
    result, compared = small_run(traffic, **MAIN444[bit_depth])
    assert result["correct"] is False and compared["wrong_bytes"] > 0


@pytest.mark.parametrize("bit_depth, chroma_format, extra", [
    (8, "4:2:0", {}),
    (10, "4:2:0", {"bit_depth": 10}),
    (8, "4:2:2", {"chroma_format": "4:2:2"}),
    (10, "4:2:2", {"bit_depth": 10, "chroma_format": "4:2:2"}),
    (8, "4:4:4", {"chroma_format": "4:4:4"}),
    (10, "4:4:4", {"bit_depth": 10, "chroma_format": "4:4:4"}),
])
def test_device_feed_calls_the_program_as_its_docstring_says(bit_depth, chroma_format, extra,
                                                             monkeypatch):
    """At 4:2:0 the call as it was before the harness took a chroma format,
    8-bit or 10-bit; at 4:2:2 the same call with chroma_format="4:2:2", a
    (k, 2h, w) batch and chroma maps of the (h, w/2) planes, at 4:4:4 with
    chroma_format="4:4:4", a (k, 3h, w) batch and chroma maps of the (h, w)
    planes, each gated by the luma tile counts."""
    from gpu_video_codec_tpu_torch.parallel import mesh as pm

    from bench_torch.lib import frames as fr
    from bench_torch.references import hevc_deblock as ref

    calls = []

    def program(mesh, buf, lm, cm, beta, tc, **kw):
        calls.append((buf.shape, buf.dtype, cm, kw))
        return buf
    monkeypatch.setattr(pm, "deblock_packed_batch_sharded_jit", program)
    traffic = DEVICE_MIXES[0]
    content = MAIN10["content"] if bit_depth == 10 else {"luma_dc": 24, "chroma_dc": 12}
    small_run(traffic, bit_depth=bit_depth, chroma_format=chroma_format, content=content)
    shape, dtype, cm, kw = calls[0]
    rows = {"4:2:0": 72, "4:2:2": 96, "4:4:4": 144}[chroma_format]
    assert shape == (_mix(traffic)["streams"], rows, 64)
    assert dtype == (torch.int16 if bit_depth == 10 else torch.uint8)
    assert kw == {"w": 64, "h": 48, **extra}
    ch, cw = {"4:2:0": (24, 32), "4:2:2": (48, 32), "4:4:4": (48, 64)}[chroma_format]
    assert all(m.shape == (ch // 8 + 1, cw // 8 + 1) for m in cm)
    bs = fr.bs_arrays(64, 48, _mix(traffic), SEED, "cpu", chroma_format)
    gates = ref.gates(bs["chroma_vert"], bs["chroma_hor"], cw, ch // 8 + 1, cw // 8 + 1, 7, 9,
                      True, "cpu")
    assert torch.equal(torch.stack([m.to(torch.int32) for m in cm]) == 2, gates)


@pytest.mark.parametrize("traffic", DEVICE_MIXES)
def test_main422_on_the_port_is_correct(traffic):
    # the port's own packed batch step (its plain path on a CPU slot) at 4:2:2 10-bit
    result, compared = small_run(traffic, **MAIN422)
    assert result["correct"] is True and result["failed"] == 0
    assert compared["wrong_bytes"] == 0 and compared["frames_compared"] > 0


@pytest.mark.parametrize("bit_depth", sorted(MAIN444))
def test_main444_on_the_port_is_correct_or_refused_by_the_port(bit_depth):
    """A 4:4:4 run through the port: where the port lists 4:4:4 among its
    chroma formats, a correct run; where it does not, the port's own
    ValueError naming chroma_format at set-up's first call of the program,
    with no result and nothing in its place."""
    from pathlib import Path

    from gpu_video_codec_tpu_torch.ops import tables
    from gpu_video_codec_tpu_torch.parallel import mesh as pm

    if "4:4:4" in tables.CHROMA_FORMATS:
        result, compared = small_run(DEVICE_MIXES[0], **MAIN444[bit_depth])
        assert result["correct"] is True and compared["frames_compared"] > 0
        return
    with pytest.raises(ValueError, match="chroma_format") as info:
        small_run(DEVICE_MIXES[0], **MAIN444[bit_depth])
    frames = [(Path(str(e.path)).resolve(), e.name) for e in info.traceback]
    port = Path(pm.__file__).resolve().parents[1]
    # raised inside the port, below the feed's call of the program in set-up
    assert frames[-1][0].is_relative_to(port)
    at = [i for i, (path, name) in enumerate(frames)
          if path == spec.BENCH / "feeds" / "device.py" and name == "step"]
    assert at and frames[at[0] + 1] == (Path(pm.__file__).resolve(),
                                        "deblock_packed_batch_sharded_jit")
    assert any(name == "setup" for _, name in frames[: at[0]])
    assert all(path.is_relative_to(port) for path, _ in frames[at[0] + 1 :])


@pytest.mark.parametrize("chroma_format", ["4:0:0", "4:4:0"])
def test_other_chroma_formats_give_no_run(chroma_format):
    with pytest.raises(ValueError, match="chroma_format"):
        small_run(DEVICE_MIXES[0], chroma_format=chroma_format)


def test_a_configuration_without_chroma_format_is_4_2_0():
    cell = next(w for w in SPEC["workloads"] if _mix(w["traffic"])["feed"] == "device")
    cfg = dict(spec.config(SPEC, cell), width=64, height=48)
    del cfg["chroma_format"]
    mix = dict(_mix(cell["traffic"]), warmup_batches=2)
    result, compared = harness.run_cell(SPEC, cell, cfg, mix, SEED, 0.3, False, False,
                                        time.perf_counter(), device="cpu")
    assert result["correct"] is True and compared["frames_compared"] > 0


def test_no_card_exits_nonzero_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "bench_torch/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 2
    assert res.stdout == ""
    assert "no result" in res.stderr


@pytest.mark.parametrize("loads", [None, "jax", "jaxlib", "flax", "gpu_video_codec_tpu",
                                   "gpu_video_codec_tpu.ops.tables"])
def test_jax_loaded_in_the_run_gives_no_result(loads, monkeypatch, capsys):
    """main, its look for a card faked and the run at 64x48 on the CPU: a
    program that loads JAX or the JAX package in the window gets no result
    line; the port's own package (a longer name) is no such module."""
    from gpu_video_codec_tpu_torch.parallel import mesh as pm

    for name in harness.forbidden_modules():  # a test session may hold JAX already
        monkeypatch.delitem(sys.modules, name)
    assert "gpu_video_codec_tpu_torch" in sys.modules
    real_step, real_run = pm.deblock_packed_batch_sharded_jit, harness.run_cell
    stub = types.ModuleType(loads or "unused")

    def step(*args, **kw):
        if loads and sys.modules.get(loads) is not stub:
            monkeypatch.setitem(sys.modules, loads, stub)
        return real_step(*args, **kw)

    def run_cell(spec_, cell, cfg, mix, *rest):
        cfg = dict(cfg, width=64, height=48)
        return real_run(spec_, cell, cfg, dict(mix, warmup_batches=2), *rest, device="cpu")

    monkeypatch.setattr(pm, "deblock_packed_batch_sharded_jit", step)
    monkeypatch.setattr(harness, "run_cell", run_cell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cell = next(w["name"] for w in SPEC["workloads"] if _mix(w["traffic"])["feed"] == "device")
    rc = harness.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.3"],
                      time.perf_counter())
    out, err = capsys.readouterr()
    if loads is None:
        assert rc == 0 and json.loads(out.splitlines()[-1])["correct"] is True
    else:
        assert rc != 0 and out == ""
        assert loads in err and "no result" in err


# -- the shape of BENCHMARK.json ---------------------------------------------------

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench_torch/run.py"]
    assert SPEC["paths"] == ["bench_torch"]
    assert 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("bench_torch/") and (spec.ROOT / c["file"]).is_file()
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert (spec.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (spec.BENCH / "feeds" / f"{_mix(w['traffic'])['feed']}.py").is_file()
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (spec.BENCH / "metrics" / f"{m['name']}.py").is_file()
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(name):
    e2e = {m["name"] for m in spec.metrics(SPEC, name, False)}
    layers = spec.metrics(SPEC, name, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    assert all(m["moves"] in e2e for m in layers)
