"""The port stands on its own.  In a subprocess whose import system refuses
av1tpu, av1tpu.* and jax, every module of av1tpu_torch imports,
chip_smoke.py and tools/profile_torch_slice.py import as modules,
encode_clip runs both presets on the CPU, `python -m av1tpu_torch.cli
encode` with the daemon's arguments (the quality preset and the tpu_vmaf
metric by default) turns a y4m into an IVF and, through the port's own
av1_tool, an mkv with a tone track into an AV1 mkv that keeps it, and the
scene batch runs on two worker processes that refuse both as well.  A scan
of the sources finds no import of either, and no path into the reference's
native/build/."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from tests.test_torch_threads import single_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Run as a file: the scene batch's spawned workers import it again (as
# __mp_main__) before anything of the port, so they refuse both too.
_SCRIPT = r'''
import importlib, importlib.abc, importlib.util, json, multiprocessing, os
import pkgutil, runpy, sys, tempfile

BLOCKED = ("av1tpu", "jax")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"refused import of {name}")
        return None


def ours():
    return sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)


PRELOADED = ours()
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, os.getcwd())


def main():
    out = {"preloaded": PRELOADED}
    run(out)
    out["leaked"] = ours()
    print("RESULT " + json.dumps(out))


def run(out):
    import av1tpu_torch
    out["modules"] = []
    for m in pkgutil.walk_packages(av1tpu_torch.__path__, "av1tpu_torch."):
        importlib.import_module(m.name)
        out["modules"].append(m.name)
    for name, path in (("chip_smoke", "chip_smoke.py"),
                       ("profile_torch_slice",
                        "tools/profile_torch_slice.py")):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = callable(mod.main)

    from av1tpu_torch.cli import encode_clip
    from av1tpu_torch.utils.yuv import synthetic_clip, write_y4m

    streams, stats = encode_clip(synthetic_clip(128, 64, 6, seed=5), 100,
                                 chunk=4, metric="psnr", partitions=False,
                                 device="cpu")
    out["encode"] = {"tus": len(streams),
                     "empty": sum(not s for s in streams),
                     "psnr_y": stats["psnr_y"]}
    streams, stats = encode_clip(synthetic_clip(128, 64, 3, seed=5), 100,
                                 chunk=2, metric="psnr", partitions=True,
                                 device="cpu")
    out["quality"] = {"tus": len(streams),
                      "empty": sum(not s for s in streams),
                      "psnr_y": stats["psnr_y"]}
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.y4m"), os.path.join(d, "out.ivf")
        write_y4m(src, synthetic_clip(96, 64, 3, seed=4))
        sys.argv = ["av1tpu_torch.cli", "encode", "-i", src, "-o", dst,
                    "--qindex", "100", "--workers", "4", "--chunk", "2",
                    "--device", "cpu"]
        try:
            runpy.run_module("av1tpu_torch.cli", run_name="__main__",
                             alter_sys=True)
        except SystemExit as e:
            out["cli_rc"] = e.code
        with open(dst, "rb") as f:
            out["ivf"] = {"magic": f.read(4).decode(),
                          "size": os.path.getsize(dst)}
    # a container in and out, through the av1_tool the port builds
    from av1tpu_torch import _build
    out["container"] = None
    if _build.libav_available():
        out["container"] = container_round_trip(_build.av1_tool_path())
    # the scene batch on two worker processes (two devices reported)
    import av1tpu_torch.cli as cli
    from av1tpu_torch.parallel import gop

    ran = []
    encode = gop.SceneBatchEncoder.encode

    def spy(enc, *a, **k):
        res = encode(enc, *a, **k)
        ran.extend(r["pid"] for r in res)
        return res

    gop.SceneBatchEncoder.encode = spy
    cli._device_count = lambda dev: 2
    clip = synthetic_clip(64, 64, 4, seed=5)
    clip.y[2:] = 255 - clip.y[2:]
    streams, stats = encode_clip(clip, 100, chunk=2, metric="psnr",
                                 device="cpu", workers=2)
    out["batch"] = {"tus": len(streams), "scenes": stats["scenes"],
                    "workers": len(set(ran)) if len(ran) == 2 else 0,
                    "children": len(multiprocessing.active_children())}


def container_round_trip(tool):
    import contextlib, io, subprocess
    from av1tpu_torch.utils.yuv import synthetic_clip, write_y4m

    with tempfile.TemporaryDirectory() as d:
        y4m, mkv, dst = (os.path.join(d, n)
                         for n in ("src.y4m", "src.mkv", "out.mkv"))
        write_y4m(y4m, synthetic_clip(96, 64, 3, seed=4))
        subprocess.run([tool, "encode", y4m, mkv, "--codec", "mpeg4",
                        "--audio", "tone"], check=True, capture_output=True,
                       timeout=120)
        sys.argv = ["av1tpu_torch.cli", "encode", "-i", mkv, "-o", dst,
                    "--preset", "fast", "--device", "cpu"]
        lines = io.StringIO()
        with contextlib.redirect_stdout(lines):
            try:
                runpy.run_module("av1tpu_torch.cli", run_name="__main__",
                                 alter_sys=True)
            except SystemExit as e:
                rc = e.code
        stats = json.loads(lines.getvalue().splitlines()[-1])
        probe = json.loads(subprocess.run(
            [tool, "probe", dst], check=True, capture_output=True,
            text=True, timeout=60).stdout)
    return {"rc": rc, "frames": stats["frames"],
            "audio_streams": stats["audio_streams"],
            "codecs": {s["type"]: s["codec"] for s in probe["streams"]}}


if __name__ == "__main__":
    main()
'''


@pytest.fixture(scope="module")
def alone(tmp_path_factory):
    # one OpenMP thread: the suite's workers share the machine's cores
    script = tmp_path_factory.mktemp("alone") / "alone.py"
    script.write_text(_SCRIPT)
    r = subprocess.run([sys.executable, str(script)], cwd=REPO,
                       env=dict(os.environ, OMP_NUM_THREADS="1"),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    out = json.loads(line[len("RESULT "):])
    out["cli_stats"] = [json.loads(x) for x in r.stdout.splitlines()
                        if x.startswith("{") and "output" in x]
    # modules a site hook imported before the finder are not the port's
    assert set(out["leaked"]) <= set(out["preloaded"])
    return out


def test_every_port_module_imports_alone(alone):
    mods = set(alone["modules"])
    for m in ("av1tpu_torch.cli", "av1tpu_torch.coding.packer",
              "av1tpu_torch.kernels.transform_quant",
              "av1tpu_torch.kernels.inter_code", "av1tpu_torch.kernels.cdef",
              "av1tpu_torch.kernels.motion", "av1tpu_torch.kernels.deblock",
              "av1tpu_torch.models.rates", "av1tpu_torch.ops.transforms",
              "av1tpu_torch.models.intra_part",
              "av1tpu_torch.models.intra_wave", "av1tpu_torch.spec.predict",
              "av1tpu_torch.spec.encode_frame", "av1tpu_torch.spec.headers",
              "av1tpu_torch.state", "av1tpu_torch.utils.yuv",
              "av1tpu_torch.metrics.quality", "av1tpu_torch.utils.log",
              "av1tpu_torch.models.cq", "av1tpu_torch.parallel.gop"):
        assert m in mods, m


def test_chip_scripts_import_alone(alone):
    assert alone["chip_smoke"] and alone["profile_torch_slice"]


def test_encode_clip_runs_alone(alone):
    enc = alone["encode"]
    assert enc["tus"] == 6 and enc["empty"] == 0
    assert enc["psnr_y"] > 30.0


def test_quality_preset_runs_alone(alone):
    enc = alone["quality"]
    assert enc["tus"] == 3 and enc["empty"] == 0
    assert enc["psnr_y"] > 30.0


def test_cli_module_encodes_alone(alone):
    assert alone["cli_rc"] == 0
    assert alone["ivf"]["magic"] == "DKIF" and alone["ivf"]["size"] > 32
    (stats,) = alone["cli_stats"]
    assert 0.0 < stats["tpu_vmaf"] <= 100.0 and stats["frames"] == 3


def test_container_round_trip_runs_alone(alone):
    """An mpeg4 mkv with a tone track through the CLI to an AV1 mkv that
    keeps the tone, with av1_tool built in the refusing process."""
    if alone["container"] is None:
        pytest.skip("pkg-config finds no libavcodec, libavformat, libavutil")
    assert alone["container"] == {
        "rc": 0, "frames": 3, "audio_streams": 1,
        "codecs": {"video": "av1", "audio": "pcm_s16le"}}


def test_scene_batch_runs_alone(alone):
    """A two-worker batch encode, with the workers refusing both too."""
    assert alone["batch"] == {"tus": 4, "scenes": 2, "workers": 2,
                              "children": 0}


_IMPORT = re.compile(r"^\s*(import|from)\s+(av1tpu|jax)(\.|\s|$)")


def _sources():
    paths = [os.path.join(REPO, p) for p in
             ("chip_smoke.py", "tools/profile_torch_slice.py",
              "tools/tq_compare.py", "tools/time_encode.py",
              "tools/layered_bytes.py", "tools/card_decode_check.py")]
    for root, _, files in os.walk(os.path.join(REPO, "av1tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return paths


def _native_build_paths(tree) -> list[int]:
    """Lines of code (docstrings aside) that name native/build: a string
    holding it, or "native", "build" as neighbouring arguments."""
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    lines = []
    for n in ast.walk(tree):
        if (isinstance(n, ast.Constant) and isinstance(n.value, str)
                and id(n) not in docs and "native/build" in n.value):
            lines.append(n.lineno)
        if isinstance(n, ast.Call):
            args = [a.value if isinstance(a, ast.Constant) else None
                    for a in n.args]
            if any(a == "native" and b == "build"
                   for a, b in zip(args, args[1:])):
                lines.append(n.lineno)
    return lines


def test_no_av1tpu_or_jax_import_in_sources():
    """Nor a path into native/build/: the port's av1_tool, daemon and
    libraries come from _build.py's own builds (av1_tool_path,
    daemon_path, packer_lib_path, build_cuda)."""
    offenders = []
    for path in _sources():
        with open(path) as fh:
            text = fh.read()
        offenders += [f"{path}:{i}" for i, line in
                      enumerate(text.splitlines(), 1) if _IMPORT.match(line)]
        offenders += [f"{path}:{i} native/build"
                      for i in _native_build_paths(ast.parse(text))]
    assert offenders == []
    scan = _native_build_paths(ast.parse(
        'os.path.join(REPO, "native", "build", "av1_tool")\n'
        'TOOL = "native/build/av1_tool"\n'))
    assert scan == [1, 2]
