"""Containers in and out, and the C++ daemon in front of the port.

The port builds av1_tool and the daemon from the sources in the checkout
(av1tpu_torch/_build.py).  An mkv holding mpeg4 video and a PCM tone
(av1_tool encode --codec mpeg4 --audio tone, as tests/test_daemon.py
makes its fixture) goes through av1tpu_torch.cli.main and comes out as an
AV1 mkv with the audio kept.  The daemon reads deploy/config.torch.toml,
whose template passes the hardware-encoder guard, and with --device cuda
appended the guard refuses it at startup.  chip_smoke.py phase 13 runs
here on the CPU with its template run for real (chip_smoke.torch_command:
the interpreter spelled as sys.executable, --device cpu --preset fast
appended): the daemon's --once cycle, the in-process runs it keeps for
tools/card_decode_check.py, and that tool.  Port runs only, on the CPU, at
192x128 and 6 frames; skipped where pkg-config finds no libav."""

import importlib.util
import json
import os
import subprocess

import pytest
import torch

import chip_smoke as cs
from av1tpu_torch import _build
from av1tpu_torch import cli
from av1tpu_torch.utils.yuv import synthetic_clip, write_y4m
from tests.test_torch_threads import single_torch_thread  # noqa: F401

REPO = _build.REPO
FRAMES = 6


@pytest.fixture(scope="module")
def tool():
    if not _build.libav_available():
        pytest.skip("pkg-config finds no libavcodec, libavformat, libavutil")
    return _build.av1_tool_path()


@pytest.fixture(scope="module")
def daemon(tool):
    return _build.daemon_path()


@pytest.fixture(scope="module")
def source(tool, tmp_path_factory):
    """A 192x128 mpeg4 mkv with a tone track."""
    base = tmp_path_factory.mktemp("source")
    y4m, mkv = str(base / "src.y4m"), str(base / "source.mkv")
    write_y4m(y4m, synthetic_clip(192, 128, FRAMES, seed=3))
    cs.av1_tool(tool, "encode", y4m, mkv, "--codec", "mpeg4", "--audio",
                "tone")
    return mkv


def _probe(tool, path):
    info = cs.av1_tool(tool, "probe", path)
    return info["format"], {s["type"]: s["codec"] for s in info["streams"]}


def test_mkv_round_trip(tool, source, tmp_path, capsys):
    out = str(tmp_path / "out.mkv")
    assert cli.main(["encode", "-i", source, "-o", out, "--preset", "fast",
                     "--temp", str(tmp_path), "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert stats["frames"] == FRAMES and stats["output"] == out
    assert stats["audio_streams"] == 1 and stats["subtitle_streams"] == 0
    assert stats["bytes"] == os.path.getsize(out)
    fmt, codecs = _probe(tool, out)
    assert fmt.startswith("matroska")
    assert codecs == {"video": "av1", "audio": "pcm_s16le"}
    assert cs.av1_tool(tool, "decode", out)["frames"] == FRAMES


def _run_daemon(daemon, tmp_path, library, encode_cmd):
    """One --once cycle with deploy/config.torch.toml, its paths, gates
    and template overridden for the test (chip_smoke.torch_config)."""
    cfg = cs.torch_config(str(tmp_path), str(library), encode_cmd)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([daemon, "--config", cfg, "--metrics-port", "0",
                           "--once"], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)


def test_daemon_accepts_the_torch_config(daemon, tmp_path):
    library = tmp_path / "library"
    library.mkdir()
    r = _run_daemon(daemon, tmp_path, library, cs.torch_template())
    assert r.returncode == 0, r.stdout + r.stderr
    assert "enqueued 0 job(s)" in r.stdout
    assert "cuda" not in cs.torch_template().lower()


# what phase 13 counts on the CPU: the plain versions launch nothing
NO_LAUNCHES = {"transform_quantize": 0, "wave_luma16": 0,
               "wave_sub_chroma": 0}


def test_daemon_cycle_runs_the_port(daemon, tool, tmp_path, monkeypatch,
                                    capsys):
    """chip_smoke.py phase 13 (a) on the CPU, with --preset fast appended:
    the daemon's --once cycle replaces the source with an AV1 mkv that
    keeps its tone (success / complete, psnr_y and tpu_vmaf read from the
    port's stats line, all frames decoded), and the same command in
    process has the replaced file's TUs, kept with its recon for
    tools/card_decode_check.py, whose decode of a fast stream is exact."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "out"
    out.mkdir()
    assert cs.container_daemon(torch, str(tmp_path), str(out), tool, daemon,
                               device="cpu", size=(192, 128, FRAMES),
                               extra=("--preset", "fast")) == NO_LAUNCHES
    log = capsys.readouterr().out
    assert "job status=success stage=complete" in log
    assert f"TUs identical to the replaced file's: {FRAMES} of {FRAMES}" \
        in log
    assert (f"daemon_command decode check (cpu; " in log
            and f"decoded frames={FRAMES}, differing pixels" in log
            and "total 0\n" in log), log


def test_fast_run_kept_for_the_decode_check(tool, tmp_path, capsys):
    """chip_smoke.py phase 13 (b) on the CPU at a small size (its decode
    must equal the recon), then tools/card_decode_check.py on the files it
    kept."""
    out = tmp_path / "out"
    out.mkdir()
    assert cs.container_1080p(torch, str(tmp_path), str(out), tool,
                              device="cpu", size=(192, 128, FRAMES)) == (
        NO_LAUNCHES)
    assert sorted(p.name for p in out.iterdir()) == [
        "fast_1080p.ivf", "fast_1080p.json", "fast_1080p_recon.npz"]
    spec = importlib.util.spec_from_file_location(
        "card_decode_check", os.path.join(REPO, "tools",
                                          "card_decode_check.py"))
    check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check)
    capsys.readouterr()
    assert check.main([str(out)]) == 0
    (line,) = capsys.readouterr().out.splitlines()
    assert line.startswith("fast_1080p decode check (cpu; ")
    assert line.endswith(f"decoded frames={FRAMES}, differing pixels (y, u, "
                         f"v) per frame {[(0, 0, 0)] * FRAMES}, total 0")


def test_daemon_refuses_cuda_in_the_template(daemon, tmp_path):
    library = tmp_path / "library"
    library.mkdir()
    r = _run_daemon(daemon, tmp_path, library,
                    cs.torch_command("--device", "cuda"))
    assert r.returncode == 1
    assert "cuda" in r.stdout + r.stderr
