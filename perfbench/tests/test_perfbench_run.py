"""The harness end to end on the CPU at a tiny size: a cell added as files
only runs, the check passes on the port and fails on each planted fault,
the reference agrees with the port and imports nothing of it, nothing of
JAX loads, and the command refuses to run without a card."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchlib import checks, content, runner, spec

ROOT = os.path.dirname(spec.PERFBENCH)
TINY_CONFIG = {
    "deployment": "test geometry", "source": "test", "picture": [64, 64],
    "encoder_config": {"width": 64, "height": 64, "log2_ctu_size": 5,
                       "max_split_depth": 3},
    "search": {"chroma_stage_a": "device"}, "reduced": [], "assumed": {}}
SEED = 3_000_000_019


def tiny_traffic():
    t = json.load(open(os.path.join(spec.PERFBENCH, "traffic",
                                    "clip16_qp22.json")))
    return dict(t, frames_per_call=2, qp=32, pool_frames=4, check_calls=2,
                check_blocks_per_size=3)


@pytest.fixture(scope="module")
def bench_copy(tmp_path_factory):
    """A copy of BENCHMARK.json and perfbench/ with one more cell, added as
    a configuration file, a traffic file and two entries: no code edited."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(spec.PERFBENCH, root / "perfbench", ignore=shutil.ignore_patterns(
        "out", ".cache", "__pycache__", "tests"))
    (root / "perfbench" / "configs" / "tiny.json").write_text(
        json.dumps(TINY_CONFIG))
    (root / "perfbench" / "traffic" / "tiny2_qp32.json").write_text(
        json.dumps(tiny_traffic()))
    b = spec.load_benchmark(ROOT)
    b["configs"].append({"name": "tiny", "source": "test",
                         "file": "perfbench/configs/tiny.json", "reduced": [],
                         "why": "test"})
    b["workloads"].append({"name": "tiny_qp32", "config": "tiny",
                           "traffic": "tiny2_qp32", "chips": 1,
                           "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


def _run_copy(root, trace):
    """The copy's harness in a fresh process on the CPU; its result and the
    banned modules it finds loaded afterwards."""
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(root / 'perfbench')!r}, {ROOT!r}]\n"
        "from benchlib import runner\n"
        f"r = runner.run({str(root)!r}, 'tiny_qp32', {SEED}, 0.5, {trace}, "
        "device='cpu')\n"
        "print(json.dumps([r, runner.banned_modules(), runner.__file__]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(root))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_cell_added_as_files_runs(bench_copy):
    r, banned, path = _run_copy(bench_copy, 0)
    assert path.startswith(str(bench_copy))
    assert banned == []
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"encode_fps", "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"
    _sound(r["checks"])


def test_a_traced_run_reads_the_program_spans(bench_copy):
    r, banned, _ = _run_copy(bench_copy, 1)
    assert banned == [] and r["correct"] is True
    assert "breakdown" in r and r["device"]["window_s"] > 0
    # the new cell is named by no per-layer metric's workloads list
    assert r["metrics"] == {}


def test_the_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "cif_qp37_live",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "torch.cuda.is_available() is false" in out.stderr


def _sound(numbers):
    """Every number of a sound run: 0, but the cost gap, which is f32
    rounding under its limit."""
    assert set(numbers) == set(checks.LIMITS)
    for k, v in numbers.items():
        v = v["value"] if isinstance(v, dict) else v
        if k == "stage_a_cost_gap":
            assert 0 <= v <= checks.LIMITS[k]
        else:
            assert v == 0, (k, v)


def _port_call(width=96, qp=27, n=3, chroma="device"):
    """A CPU encode by the port of n frames (chroma stage A `chroma`),
    with its stage-A outputs kept as the window keeps them: (config,
    frames, stream, recons, kept)."""
    from wrenc_tpu_torch.core.config import EncoderConfig
    from wrenc_tpu_torch.encoder import Encoder
    from wrenc_tpu_torch.search import WavefrontSearch, wavefront
    from benchlib import capture
    t = tiny_traffic()
    cfg = dict(TINY_CONFIG, picture=[width, 64],
               encoder_config=dict(TINY_CONFIG["encoder_config"],
                                   width=width))
    frames = content.make_frames(t["content"], (width, 60), (width, 64), n,
                                 content.seed_sequence(SEED, 0))
    ec = EncoderConfig(**dict(cfg["encoder_config"], qp=qp))
    enc = Encoder(ec, search=WavefrontSearch(ec, device="cpu",
                                             chroma_stage_a=chroma))
    cap = capture.StageACapture(wavefront).install()
    try:
        cap.active = True
        stream, recons = enc.encode(frames)
        chunks = capture.StageACapture.fetch(cap.take())
    finally:
        cap.uninstall()
    return cfg, frames, stream, recons, chunks


def test_the_reference_imports_nothing_of_the_program(tmp_path):
    ref_files = [os.path.join(spec.PERFBENCH, "benchlib", f)
                 for f in ("stage_a_ref.py", "checks.py")]
    for dirpath, _, files in os.walk(os.path.join(spec.PERFBENCH, "vvcref")):
        ref_files += [os.path.join(dirpath, f) for f in files
                      if f.endswith(".py")]
    for path in ref_files:
        src = open(path).read()
        for word in ("import wrenc_tpu", "from wrenc_tpu", "import torch",
                     "from torch", "import jax"):
            assert word not in src, (path, word)
    cfg, frames, stream, recons, chunks = _port_call(n=1)
    np.save(tmp_path / "frame.npy", np.stack(frames[0][0]))
    (tmp_path / "stream.bin").write_bytes(bytes(stream))
    code = (
        "import sys\n"
        f"sys.path[:0] = [{spec.PERFBENCH!r}]\n"
        "import numpy as np\n"
        "from benchlib import checks, stage_a_ref\n"
        f"s = open({str(tmp_path / 'stream.bin')!r}, 'rb').read()\n"
        "print(checks.pictures_in(s))\n"
        "from vvcref.decoder import decode_annexb\n"
        "assert len(decode_annexb(s, use_native=False)) == 1\n"
        f"y = np.load({str(tmp_path / 'frame.npy')!r})\n"
        "b = stage_a_ref.Block(y, 8, 8, 8, 5, stage_a_ref.Params(27))\n"
        "b.costs(b.cands)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'wrenc_tpu', 'wrenc_tpu_torch', "
        "'torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=spec.PERFBENCH)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines() == ["1", "[]"]


@pytest.mark.parametrize("chroma", ["device", "native"])
def test_the_reference_equals_the_port_on_the_cpu(chroma):
    cfg, frames, stream, recons, chunks = _port_call(chroma=chroma)
    assert len(chunks["chroma"]) == (chroma == "device")
    assert checks.pictures_missing(len(frames), stream, recons) == 0
    assert checks.decode_samples_differing(frames, stream, recons,
                                           range(len(frames))) == 0
    # a picture decoded alone equals the same picture of the whole decode
    from vvcref.decoder import decode_annexb
    whole = decode_annexb(bytes(stream), use_native=False)
    alone = checks.decode_pictures(stream, {1})
    assert list(alone) == [1]
    assert all((a == b).all() for a, b in zip(alone[1], whole[1]))
    assert checks.pictures_nearer_another_frame(frames, recons, frames) == 0
    numbers = checks.stage_a_numbers(chunks, frames, 27, cfg, 6,
                                     content.seed_sequence(SEED, 3))
    assert numbers["stage_a_cands_differing"] == 0
    assert numbers["stage_a_picks_differing"] == 0
    assert 0 <= numbers["stage_a_cost_gap"] <= checks.LIMITS[
        "stage_a_cost_gap"]
    # each chunk row holds one of the frames; the padded rows repeat the
    # picture's last row
    assert all(any(np.array_equal(c["planes"][r], f[0]) for f in frames)
               for c in chunks["luma"] for r in range(c["planes"].shape[0]))
    assert (frames[0][0][60:] == frames[0][0][59]).all()


def _fault(kind):
    """wrap(encoder) -> encode with one fault planted in what it returns."""
    def wrap(enc):
        prev = []

        def encode(frames):
            if kind == "half":          # half of the batch left out
                out = enc.encode(frames[:len(frames) // 2])
            else:
                out = enc.encode(frames)
            stream, recons = out
            if kind == "byte":          # the answer altered where produced
                stream = bytearray(stream)
                stream[-3] ^= 0x10
                stream = bytes(stream)
            elif kind == "recon":
                recons = [tuple(np.array(p) for p in r) for r in recons]
                recons[-1][0][5, 7] ^= 1
            elif kind == "stale":       # the state returned unchanged:
                if prev:                # the call before's (the warm-up's)
                    stream, recons = prev[0]
                prev[:] = [(stream, recons)]
            return stream, recons
        return encode
    return wrap


@pytest.mark.parametrize("kind", ["byte", "recon", "half", "stale",
                                  "decision", "cost", "chroma"])
def test_a_planted_fault_fails_the_check(bench_copy, kind, monkeypatch):
    from wrenc_tpu_torch.search import wavefront
    wrap = None
    if kind == "decision":
        # stage A's luma decisions altered where they are made: every
        # ranked candidate of each size made PLANAR
        select = wavefront._select_modes_dev

        def skewed(*a, **kw):
            rk, best, top2 = select(*a, **kw)
            return rk.zero_(), best, top2
        monkeypatch.setattr(wavefront, "_select_modes_dev", skewed)
    elif kind == "cost":
        # stage A's costs in a lower precision: rounded to bfloat16
        import torch
        rd_cost = wavefront._rd_cost
        monkeypatch.setattr(wavefront, "_rd_cost", lambda *a: rd_cost(
            *a).to(torch.bfloat16).to(torch.float32))
    elif kind == "chroma":
        # chroma stage A's derived-mode costs rounded to bfloat16
        import torch
        chroma = wavefront.fused_chroma_stage_a

        def rounded(*a, **kw):
            out = chroma(*a, **kw)
            return {k: (v.to(torch.bfloat16).to(torch.float32)
                        if k[0] == "d" else v) for k, v in out.items()}
        monkeypatch.setattr(wavefront, "fused_chroma_stage_a", rounded)
    else:
        wrap = _fault(kind)
    r = runner.run(str(bench_copy), "tiny_qp32", SEED, 0.1, 0, device="cpu",
                   wrap=wrap)
    assert r["correct"] is False
    assert r["failed"] >= 1
    assert any(v["value"] > v["limit"] for v in r["checks"].values())
