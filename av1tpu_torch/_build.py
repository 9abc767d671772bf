"""Build the port's native libraries and tools from the sources in this
checkout.

Each is built at first use into ``av1tpu_torch/_build/`` (listed in
.gitignore) and rebuilt when a source is newer than the output:

- ``libav1cuda.so``: the CUDA kernels under ``av1tpu_torch/csrc/``, each
  source compiled by its own ``nvcc`` for ``sm_90a`` (all started
  together), behind a plain C interface and loaded with ctypes (no PyTorch
  headers, so the build takes seconds);
- ``libav1pack.so``: the shared C++ entropy packer
  (``native/coding/pack.cpp``), compiled with ``g++`` directly.  The CMake
  project also wants libavcodec for its tools, which a GPU host may lack,
  and its ``native/build/`` output directory belongs to the reference;
- ``av1_tool``: the container and codec tool (``native/tools/av1_tool.c``,
  as ``native/CMakeLists.txt`` builds it): it demuxes a non-y4m input,
  muxes the AV1 output with the source's audio and subtitles, probes, and
  decodes (libdav1d where present);
- ``av1tpu-daemon``: the media-library daemon (``native/daemon/``: the
  ``av1daemon_core`` sources and ``main.cpp``).

The last two link libavcodec, libavformat and libavutil, found by
``pkg-config``; without them their builds raise, and nothing falls back to
the reference's ``native/build/``.  Builds write to a temporary name and
rename into place, so concurrent test workers never load a half-written
library or run a half-written tool.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess
import tempfile

PKG = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(PKG)
BUILD_DIR = os.path.join(PKG, "_build")
CUDA_SOURCES = tuple(os.path.join(PKG, "csrc", f)
                     for f in ("transform_quant.cu", "intra_wave.cu",
                               "inter_code.cu", "cdef.cu", "deblock.cu",
                               "motion.cu", "intra_part.cu"))
# headers the sources include: a change rebuilds, nothing compiles them alone
CUDA_HEADERS = (os.path.join(PKG, "csrc", "itx.cuh"),)
PACK_SOURCES = (os.path.join(REPO, "native", "coding", "pack.cpp"),
                os.path.join(REPO, "native", "coding", "tables_gen.h"))
TOOL_SOURCES = (os.path.join(REPO, "native", "tools", "av1_tool.c"),)
DAEMON_DIR = os.path.join(REPO, "native", "daemon")
# av1daemon_core and the daemon's main (native/CMakeLists.txt)
DAEMON_SOURCES = tuple(
    os.path.join(DAEMON_DIR, f + ".cpp")
    for f in ("config", "scan", "probe", "jobs", "log", "replace", "encoder",
              "metrics", "executor", "daemon", "main"))
LIBAV = ("libavcodec", "libavformat", "libavutil")


def _stale(out: str, sources) -> bool:
    if not os.path.exists(out):
        return True
    t = os.path.getmtime(out)
    return any(os.path.getmtime(s) > t for s in sources)


def _compile(out: str, head, compile_sources, sources,
             link=list) -> tuple[str, str]:
    """Build `out` unless it is newer than every source.  head() and
    link() give the command's arguments before and after the sources; they
    are called only when a build is due.  Returns (path, the compiler's
    output; empty when nothing was built)."""
    if not _stale(out, sources):
        return out, ""
    cmd, tail = head(), list(compile_sources) + link()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".tmp")
    os.close(fd)
    try:
        r = subprocess.run(cmd + ["-o", tmp] + tail, capture_output=True,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(f"build of {os.path.basename(out)} failed:\n"
                               + r.stdout[-4000:] + r.stderr[-4000:])
        os.chmod(tmp, 0o755)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, r.stdout + r.stderr


def _which(prog: str, needed_by: str) -> str:
    path = shutil.which(prog)
    if path is None:
        raise RuntimeError(f"{prog} not found: needed to build {needed_by}")
    return path


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def build_cuda() -> tuple[str, str]:
    """Compile the CUDA kernels, one nvcc per source in parallel, and link
    them into one library; returns (library path, compiler output).  The
    output holds -Xptxas -v's registers, shared memory and spills per
    kernel (empty when the library was already up to date)."""
    out = os.path.join(BUILD_DIR, "libav1cuda.so")
    if not _stale(out, CUDA_SOURCES + CUDA_HEADERS):
        return out, ""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs, log = _objects(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"], CUDA_SOURCES,
            objdir)
        _, link_log = _compile(out, lambda: [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared"],
            objs, CUDA_SOURCES + CUDA_HEADERS)
    return out, log + link_log


@functools.cache
def cuda_lib() -> ctypes.CDLL:
    """The loaded CUDA kernel library with its C signatures declared."""
    lib = ctypes.CDLL(build_cuda()[0])
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    signatures = {
        "av1_transform_quantize": [vp, vp, vp, vp, vp, vp, vp, ci, ci, cf,
                                   cf, vp],
        # WaveTabs*, src_y, src_u, src_v, height, width, rec_y/u/v,
        # lv_y/u/v, modes, txds, lanes, n, d0, flags, stream
        "av1_wave_key": [vp, vp, vp, vp, ci, ci, vp, vp, vp, vp, vp, vp, vp,
                         vp, vp, ci, ci, vp, vp],
        # (return the resident clusters, each CTA's shared memory bytes)
        "av1_wave_key_clusters": [],
        "av1_wave_key_smem": [],
        # CodeTabs*, coefs, src, pred, nblocks, lv, rec, dist, rate, dskip,
        # stream
        "av1_code_blocks": [vp, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp],
        # n, out (4 ints: blocks and threads per CTA, dynamic and static
        # shared bytes)
        "av1_code_blocks_layout": [ci, vp],
        # y, u, v, skip8, weights, h, w, pri_y, sec_y, pri_uv, sec_uv,
        # damping, coeff_shift, out y, u, v, stream
        "av1_cdef_filter": [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                            ci, vp, vp, vp, vp],
        # out (7 ints: units per tile in rows and columns, apron rows and
        # columns, luma and chroma stage strides, threads)
        "av1_cdef_layout": [vp],
        # in, out, h, w, luma, v_on, h_on, split16, limit, blimit, thresh,
        # bit_depth, stream
        "av1_deblock_edges": [vp, vp, ci, ci, ci, vp, vp, vp, ci, ci, ci, ci,
                              vp],
        # luma, out (7 ints: the tile's rows, columns, taps, halo columns,
        # row stride, dynamic shared bytes, threads)
        "av1_deblock_layout": [ci, vp],
        # kind, h, w (returns int32 words)
        "av1_motion_ws_words": [ci, ci, ci],
        # y, ref, h, w, bias (host), margin, ws, coarse, coarse2, shifts4,
        # stream
        "av1_coarse_search": [vp, vp, ci, ci, vp, cf, vp, vp, vp, vp, vp],
        # h, w, out (5 ints: the three grids, the sweep's threads and
        # static shared bytes)
        "av1_coarse_layout": [ci, ci, vp],
        # y, ref, h, w, shifts4, zeroed ws, vol, sad_g, c0, g_full, stream
        "av1_global_search": [vp, vp, ci, ci, vp, vp, vp, vp, vp, vp, vp],
        # y, ref, h, w, base0, base1, base2, c0, g_full, sad_g, unit_r,
        # unit_s, m14, pix_max, taps (host), tot, vol, out, pred, stream
        "av1_refine_subpel": [vp, vp, ci, ci, vp, vp, vp, vp, vp, vp, cf, cf,
                              cf, ci, vp, vp, vp, vp, vp, vp],
        # jobs (an array of the kernel's job structs), count, stream
        **{f"av1_part_{k}": [vp, ci, vp]
           for k in ("chain", "pred", "code", "merge")},
        # jobs, count, out (3 ints: CTAs, dynamic and static shared bytes)
        "av1_part_code_layout": [vp, ci, vp],
        # jobs, count, out (4 ints: CTAs, CTAs per cluster, threads,
        # dynamic shared bytes)
        "av1_part_chain_layout": [vp, ci, vp],
        # jobs, count, out (4 ints: CTAs, threads, launch attributes, PDL)
        "av1_part_pred_layout": [vp, ci, vp],
        # jobs, count, out (6 ints: CTAs along x, rows, CTAs per cluster,
        # threads, static shared bytes, launch attributes)
        "av1_part_merge_layout": [vp, ci, vp],
        # count, pdl, stream: launches of an empty kernel
        "av1_part_empty": [ci, ci, vp],
        # out (text), cap (bytes; returns the text's length)
        "av1_part_layout": [vp, ci],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.restype = ci
        fn.argtypes = argtypes
    return lib


def packer_lib_path() -> str:
    """Compile the C++ entropy packer; returns the library path."""
    out = os.path.join(BUILD_DIR, "libav1pack.so")
    return _compile(out, lambda: [
        _which("g++", "the packer"), "-O3", "-march=native",
        "-fno-exceptions", "-shared", "-fPIC"], PACK_SOURCES[:1],
        PACK_SOURCES)[0]


def libav_flags() -> list[str]:
    """The compile and link flags of libavcodec, libavformat and libavutil
    as pkg-config prints them.  Raises RuntimeError naming pkg-config and
    the libraries when pkg-config or any of them is missing."""
    need = (f"av1_tool and the daemon link {', '.join(LIBAV)} (install "
            "their development packages)")
    pkg_config = shutil.which("pkg-config")
    if pkg_config is None:
        raise RuntimeError(f"pkg-config not found: {need}")
    r = subprocess.run([pkg_config, "--cflags", "--libs", *LIBAV],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"pkg-config finds no {', '.join(LIBAV)}: {need}: "
                           + r.stderr.strip())
    return r.stdout.split()


def libav_available() -> bool:
    """Whether pkg-config finds libavcodec, libavformat and libavutil."""
    try:
        libav_flags()
    except RuntimeError:
        return False
    return True


def av1_tool_path() -> str:
    """Compile native/tools/av1_tool.c; returns the executable's path."""
    out = os.path.join(BUILD_DIR, "av1_tool")
    return _compile(out, lambda: [_which("gcc", "av1_tool"), "-O2"],
                    TOOL_SOURCES, TOOL_SOURCES,
                    link=lambda: libav_flags() + ["-lm"])[0]


def _objects(cmd: list[str], sources,
             objdir: str) -> tuple[list[str], str]:
    """Compile each source to an object file in objdir, one compiler
    process per source, all started together.  Returns (the objects, the
    compilers' output)."""
    jobs = []
    for src in sources:
        obj = os.path.join(objdir, os.path.basename(src) + ".o")
        jobs.append((obj, subprocess.Popen(
            cmd + ["-c", src, "-o", obj], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    logs = [(p.communicate()[0], p.returncode) for _, p in jobs]
    failed = [log for log, rc in logs if rc != 0]
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed)[-8000:])
    return [obj for obj, _ in jobs], "".join(log for log, _ in logs)


def daemon_path() -> str:
    """Compile the media-library daemon (native/daemon/), its sources in
    parallel; returns the executable's path."""
    out = os.path.join(BUILD_DIR, "av1tpu-daemon")
    headers = tuple(sorted(glob.glob(os.path.join(DAEMON_DIR, "*.h"))))
    if not _stale(out, DAEMON_SOURCES + headers):
        return out
    gxx, flags = _which("g++", "the daemon"), libav_flags()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs, _ = _objects([gxx, "-std=c++17", "-O2", "-pthread", "-I",
                            DAEMON_DIR, *flags], DAEMON_SOURCES, objdir)
        return _compile(out, lambda: [gxx, "-pthread"], objs,
                        DAEMON_SOURCES + headers, link=lambda: flags)[0]
