"""The port's encode command is the reference's: the same options with the
same defaults and choices, the workers clamp on one device, --max-frames,
and the refusal of container input where its own av1_tool cannot be built
(tests/test_torch_container.py runs the container paths).  Port
runs only, on the CPU device, at 64x96 and a few frames; the reference's
parser is read, never run.  tests/test_torch_slice_quality.py runs the C++
daemon's command template on the port, and tests/test_torch_slice.py and
tests/test_torch_slice_quality.py hold the scene batch over several
devices to the reference's streams."""

import argparse
import json
import os

import pytest

import av1tpu.cli as ref_cli
from av1tpu.utils.yuv import write_y4m
from av1tpu_torch import cli as port_cli
from av1tpu_torch.utils.yuv import synthetic_clip
from tests.test_torch_threads import single_torch_thread  # noqa: F401

class _Parsed(Exception):
    pass


def _encode_options(main, monkeypatch):
    """{dest: (option strings, default, choices, type, required)} of a
    main()'s encode subcommand, read from the parser object it builds."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        main(["encode", "-i", "x.y4m", "-o", "x.ivf"])
    monkeypatch.undo()
    sub = next(a for a in seen["parser"]._actions
               if isinstance(a, argparse._SubParsersAction))
    enc = sub.choices["encode"]
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type,
                     a.required)
            for a in enc._actions if a.dest != "help"}


def test_encode_options_equal_the_reference(monkeypatch):
    want = _encode_options(ref_cli.main, monkeypatch)
    got = _encode_options(port_cli.main, monkeypatch)
    assert len(want) == 17
    for dest, opt in want.items():
        assert got.get(dest) == opt, dest
    assert set(got) - set(want) == {"device"}
    assert got["device"][1] == "cuda"
    assert want["metric"][1:3] == ("tpu_vmaf", ("tpu_vmaf", "ssim", "psnr"))


def _run(capsys, argv):
    assert port_cli.main(argv + ["--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    return lines[:-1], lines[-1]


@pytest.fixture(scope="module")
def y4m(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("src") / "in.y4m")
    write_y4m(path, synthetic_clip(96, 64, 3, seed=21))
    return path


def test_workers_on_one_device_is_the_single_device_path():
    clip = synthetic_clip(96, 64, 3, seed=22)
    kw = dict(chunk=2, metric="psnr", partitions=False, device="cpu")
    one, _ = port_cli.encode_clip(clip, 100, workers=1, **kw)
    four, _ = port_cli.encode_clip(clip, 100, workers=4, **kw)
    assert four == one


def test_max_frames_truncates(y4m, tmp_path, capsys):
    ivf = str(tmp_path / "out.ivf")
    _, stats = _run(capsys, ["encode", "-i", y4m, "-o", ivf, "--max-frames",
                             "2", "--preset", "fast", "--metric", "ssim",
                             "--qindex", "120"])
    assert stats["frames"] == 2 and 0.0 < stats["ssim"] <= 1.0
    with open(ivf, "rb") as f:
        assert int.from_bytes(f.read()[24:28], "little") == 2  # IVF frames


def test_container_input_needs_av1_tool(monkeypatch, tmp_path):
    """A non-y4m input is decoded by the port's own av1_tool, which
    _build.av1_tool_path() compiles at the first container use.  Where
    pkg-config finds no libav, the port refuses with the build's error,
    which names pkg-config and the libraries, and builds nothing: neither
    in its build directory nor in the reference's native/build/."""
    from av1tpu_torch import _build

    build = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    # a pkg-config search path that holds no .pc file
    monkeypatch.setenv("PKG_CONFIG_LIBDIR", str(tmp_path))
    monkeypatch.delenv("PKG_CONFIG_PATH", raising=False)
    reference_tool = os.path.join(_build.REPO, "native", "build", "av1_tool")
    had_reference_tool = os.path.exists(reference_tool)
    src = str(tmp_path / "in.mkv")
    with pytest.raises(RuntimeError) as got:
        port_cli.main(["encode", "-i", src, "-o", str(tmp_path / "o.ivf"),
                       "--temp", str(tmp_path), "--device", "cpu"])
    assert "pkg-config" in str(got.value)
    assert all(lib in str(got.value) for lib in _build.LIBAV)
    assert not build.exists()
    assert os.path.exists(reference_tool) == had_reference_tool
