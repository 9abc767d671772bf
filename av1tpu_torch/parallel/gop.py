"""Multi-device GOP encode: the scene batch, one worker process per device
(port of av1tpu/parallel/gop.py, the CLI's --workers path).

Scenes are independent: each starts at a keyframe, and its recon and CDF
chains never cross a cut, so the batch needs no collective.  The reference
vmaps its per-scene bodies over a scene axis sharded across a device mesh.
The port's bodies are eager PyTorch that read values on the host inside
them (the motion search reads its candidates three times per frame), so
they cannot be vmapped; and the port is host-bound, so threads feeding
several devices would share one interpreter lock and one host's dispatch
rate.  So each entry of `devices` gets a worker process of its own
(spawned: a forked CUDA context is unusable), which runs the scenes dealt
to it in turn with the single-device code.  The parent sends the frames
as shared-memory tensors, gets the compact buffers back as numpy and packs
them, as the reference's parent does; so each scene's stream equals the
one encoding that scene alone would give.

    with ScenePool(scene_devices(2, "cuda")) as pool:
        res = SceneBatchEncoder(scenes, pool, h, w).encode(key_cap, inter_cap)
"""

from __future__ import annotations

import functools
import os
import queue
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

# how often a wait for results checks that every worker is still alive
_POLL_S = 0.5
# how long a worker gets to exit after it was told to stop
_JOIN_S = 30.0


def scene_devices(n: int, device) -> list[torch.device]:
    """The devices a batch of n scenes in flight runs on (the reference's
    scene_mesh): the first min(n, GPU count) GPUs for a CUDA device; for
    the CPU, the CPU n times (one worker process each)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(min(n, torch.cuda.device_count()))]
    return [dev] * n


def key_skip8(buf: np.ndarray, height: int, width: int) -> np.ndarray:
    """The keyframe's (H/8, W/8) CDEF skip map from its compact buffer's
    significance bitmap: the CLI's extractor, as a top-level function so
    that a functools.partial of it can be sent to a worker."""
    from av1tpu_torch.models.cdef import skip8_host
    from av1tpu_torch.models.intra_v import split_compact

    return skip8_host(split_compact(buf, height, width)[1], height, width)


def build_forward_matrices(part: bool) -> None:
    """Build in this process the forward matrices a worker's scenes use:
    the wavefront keyframe's (4x4, 8x8 and 16x16, four transform types
    each) and, with partitions, the inter step's 32x32 and 64x64 ones.
    Built once here, they are copied to every worker, which would
    otherwise build its own, all at once."""
    from av1tpu_torch.ops.transforms import forward_matrix, fwd64

    for n in (4, 8, 16):
        for tx_type in range(4):
            forward_matrix(n, n, tx_type)
    if part:
        forward_matrix(32, 32, 0)
        fwd64()


def _process_settings() -> dict:
    """What a spawned worker must copy from its parent, because each
    changes bits: the PyTorch thread count (the CPU bits of the 1024- and
    4096-deep forward products depend on it), TF32 (off on the encode
    path), and the forward matrices built so far (their np.linalg.pinv
    bits depend on the BLAS thread count, and rebuilding them costs tens
    of seconds on the CPU)."""
    from av1tpu_torch.ops.transforms import built_forward_matrices

    return {"threads": torch.get_num_threads(),
            "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "forward": built_forward_matrices()}


def _adopt_settings(settings: dict) -> None:
    from av1tpu_torch.ops.transforms import adopt_forward_matrices

    torch.set_num_threads(settings["threads"])
    torch.backends.cuda.matmul.allow_tf32 = settings["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = settings["cudnn_tf32"]
    adopt_forward_matrices(settings["forward"])


def _encode_scene(scene: dict, dev: torch.device, height: int, width: int,
                  bit_depth: int, key_cap: int, inter_cap: int, part: bool,
                  skip8_host_fn, key_lam_scale: float) -> dict:
    """One scene on one device, in the order of the reference's batch: the
    wavefront keyframe (_scenes_key), its CDEF search over every preset
    and the filter (_scenes_cdef), then one inter step per frame with the
    filtered keyframe as GOLDEN and the MV field carried (_scenes_step),
    each frame's buffer fetched while the next frame's step is queued."""
    from av1tpu_torch.kernels.intra_wave import wave_luma16, wave_sub_chroma
    from av1tpu_torch.kernels.transform_quant import transform_quantize
    from av1tpu_torch.models import inter_v, intra_wave
    from av1tpu_torch.models.cdef import cdef_fused, select_strengths

    # the hand kernels' launch counts are per process: each scene reports
    # what it launched, so that the parent can count a batch's launches
    kernels = (transform_quantize, wave_luma16, wave_sub_chroma)
    before = [k.launches for k in kernels]
    seconds = {}
    t = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    frames = scene["frames"].to(dev)
    f0 = frames[0]
    buf, ref = intra_wave.encode_intra_wave_key_recon(
        f0, scene["key_q"], height, width, cap=key_cap, lf=scene["key_lf"],
        lam_scale=key_lam_scale, noise_gate=scene.get("key_gate", 0.0),
        bit_depth=bit_depth)
    key_buf = buf.cpu().numpy()
    seconds["key_device"] = time.perf_counter() - t

    t = time.perf_counter()
    skip8 = torch.from_numpy(skip8_host_fn(key_buf)).to(dev)
    cdef_s = select_strengths(ref, f0, skip8, height, width,
                              bit_depth=bit_depth)
    ref = cdef_fused(ref, skip8, cdef_s, height, width, bit_depth=bit_depth)
    seconds["cdef"] = time.perf_counter() - t

    gld = ref
    mv = None
    fetch_state: dict = {}
    seconds["inter_dispatch"] = seconds["inter_fetch"] = 0.0

    def fetch(b):
        t = time.perf_counter()
        # the partitioned buffer's used prefix only
        out = (inter_v.fetch_inter_part_prefix(b, height, width, fetch_state)
               if part else b.cpu().numpy())
        seconds["inter_fetch"] += time.perf_counter() - t
        return out

    inter_bufs = []
    pending = None
    for k in range(1, frames.shape[0]):
        t = time.perf_counter()
        if part:
            bufs, ref, mv = inter_v.encode_gop_chunk_part(
                frames[k : k + 1], ref, scene["q"], height, width,
                cap=inter_cap, lf=scene["inter_lf"], cdef_s=cdef_s,
                gld_fused=gld, prev_mv=mv,
                noise_gate=scene.get("inter_gate", 0.0), bit_depth=bit_depth)
        else:
            bufs, ref = inter_v.encode_gop_chunk(
                frames[k : k + 1], ref, scene["q"], height, width,
                cap=inter_cap, lf=scene["inter_lf"], cdef_s=cdef_s,
                bit_depth=bit_depth)
        seconds["inter_dispatch"] += time.perf_counter() - t
        if pending is not None:
            inter_bufs.append(fetch(pending))
        pending = bufs[0]
    if pending is not None:
        inter_bufs.append(fetch(pending))
    return {"key_buf": key_buf, "inter_bufs": inter_bufs,
            "cdef_s": np.asarray(cdef_s), "ref": ref.cpu().numpy(),
            "device": str(dev), "pid": os.getpid(), "seconds": seconds,
            "launches": {k.__name__: k.launches - b
                         for k, b in zip(kernels, before)},
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None)}


def _worker(device: str, jobs, results) -> None:
    """A worker process: on `device`, take from `jobs` ("settings", the
    parent's settings) and ("scene", index, scene, kwargs) messages in
    order, until None arrives or the parent is gone.  Puts ("ok", index,
    result) or ("error", index, traceback) on `results`."""
    parent = os.getppid()
    dev = torch.device(device)
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    except Exception:
        results.put(("error", None, traceback.format_exc()))
        return
    while True:
        try:
            msg = jobs.get(timeout=_POLL_S)
        except queue.Empty:
            if os.getppid() != parent:  # orphaned: nobody reads results
                return
            continue
        if msg is None:
            return
        index = msg[1] if msg[0] == "scene" else None
        try:
            if msg[0] == "settings":
                _adopt_settings(msg[1])
            else:
                results.put(("ok", index, _encode_scene(msg[2], dev,
                                                        **msg[3])))
        except Exception:
            results.put(("error", index, traceback.format_exc()))


class ScenePool:
    """One spawned worker process per entry of `devices` (an entry may
    repeat: several workers then share that device), kept open across
    batches.  A worker's exception or death raises in the parent, and the
    pool then takes no more batches (results of the failed one may still
    be in flight); `timeout` bounds each wait for a result (None: no
    bound).  Close it, or use it as a context manager: the workers stop on
    every exit path."""

    def __init__(self, devices, timeout: float | None = None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a scene pool needs at least one device")
        self.timeout = timeout
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._jobs = [ctx.Queue() for _ in self.devices]
        # the settings go through the queues, not the process arguments:
        # a spawned child reads its arguments before start() returns, so
        # large arguments would start the workers one after another
        self._sent = None       # what the workers last adopted
        self._failed = False
        self._procs = [ctx.Process(target=_worker, daemon=True,
                                   args=(str(d), q, self._results))
                       for d, q in zip(self.devices, self._jobs)]
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self.close(graceful=False)
            raise

    def __enter__(self) -> ScenePool:
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(graceful=exc_type is None)

    def run(self, jobs: list) -> list:
        """Deal the (scene, kwargs) jobs round-robin over the workers and
        return their results in job order."""
        if self._failed:
            raise RuntimeError("a scene pool takes no batch after a failure")
        try:
            return self._run(jobs)
        except BaseException:
            self._failed = True
            raise

    def _run(self, jobs: list) -> list:
        settings = _process_settings()
        sig = (settings["threads"], settings["matmul_tf32"],
               settings["cudnn_tf32"], sorted(map(str, settings["forward"])))
        if sig != self._sent:   # new matrices (or flags) since last time
            for q in self._jobs:
                q.put(("settings", settings))
            self._sent = sig
        n = len(self._procs)
        for i, (scene, kw) in enumerate(jobs):
            self._jobs[i % n].put(("scene", i, scene, kw))
        out: list = [None] * len(jobs)
        left = len(jobs)
        since = time.monotonic()
        while left:
            try:
                kind, index, payload = self._results.get(timeout=_POLL_S)
            except queue.Empty:
                for d, p in zip(self.devices, self._procs):
                    if not p.is_alive():
                        raise RuntimeError(
                            f"scene worker {p.pid} on {d} exited with code "
                            f"{p.exitcode}") from None
                if (self.timeout is not None
                        and time.monotonic() - since > self.timeout):
                    raise TimeoutError(
                        f"no scene result within {self.timeout} s") from None
                continue
            if kind == "error":
                where = "" if index is None else f" (scene {index})"
                raise RuntimeError(f"scene worker failed{where}:\n{payload}")
            out[index] = payload
            left -= 1
            since = time.monotonic()
        return out

    def close(self, graceful: bool = True) -> None:
        """Stop the workers: graceful lets each finish its scene and exit,
        otherwise they are terminated at once.  Either way every worker is
        gone (killed if it does not exit) when this returns."""
        if graceful:
            for q in self._jobs:
                q.put(None)
        deadline = time.monotonic() + (_JOIN_S if graceful else 0.0)
        for p in self._procs:
            if p.pid is None:       # never started
                continue
            if not graceful:
                p.terminate()
            # drain what the workers wrote before joining them: a worker
            # blocks at exit until its queued results are read
            while p.is_alive() and time.monotonic() < deadline:
                self._drain()
                p.join(timeout=_POLL_S)
            if p.is_alive():
                p.kill()
            p.join(timeout=_JOIN_S)
        self._drain()
        for q in [*self._jobs, self._results]:
            q.cancel_join_thread()
            q.close()

    def _drain(self) -> None:
        try:
            while True:
                self._results.get_nowait()
        except (queue.Empty, OSError, ValueError):
            pass


def _scene_frames(frames: np.ndarray) -> torch.Tensor:
    """A scene's fused sources as a shared-memory tensor (10-bit sources
    ride as int32, as the single-device path uploads them)."""
    a = np.ascontiguousarray(frames)
    if a.dtype != np.uint8:
        a = a.astype(np.int32)
    return torch.from_numpy(a).share_memory_()


class SceneBatchEncoder:
    """The parent's side of one batch of scenes (the CLI's --workers path).

    scenes: list of per-scene dicts with
      frames: (L_s, n_pix) fused uint8/uint16 sources (keyframe first)
      q / key_q: scene and keyframe qindex
      key_lf / inter_lf: (3,) loop-filter levels
      key_gate / inter_gate: optional RDOQ noise floors (default 0)
    pool: the open ScenePool to run on (the reference's mesh), reused
    across batches.  Unlike the reference, which pads the batch to the
    mesh and short scenes to the longest to keep XLA's shapes static, no
    padded scene or step is computed.
    """

    def __init__(self, scenes, pool: ScenePool, height: int, width: int,
                 bit_depth: int = 8):
        self.scenes = scenes
        self.pool = pool
        self.h, self.w = height, width
        self.bd = bit_depth

    def encode(self, key_cap: int, inter_cap: int, part: bool = True,
               skip8_host_fn=None, key_lam_scale: float = 1.0) -> list:
        """Run the batch.  Returns per scene a dict with key_buf,
        inter_bufs (L_s - 1 of them), cdef_s and the final recon ref, all
        numpy; and where it ran: device, pid, seconds per stage, the hand
        kernels' launches by name and, on a GPU, peak_bytes allocated.
        skip8_host_fn(key_buf) -> (H/8, W/8) bool is the keyframe's CDEF
        skip map extractor; it runs in the
        workers, so it must pickle (default: key_skip8)."""
        if skip8_host_fn is None:
            skip8_host_fn = functools.partial(key_skip8, height=self.h,
                                              width=self.w)
        kw = dict(height=self.h, width=self.w, bit_depth=self.bd,
                  key_cap=key_cap, inter_cap=inter_cap, part=part,
                  skip8_host_fn=skip8_host_fn, key_lam_scale=key_lam_scale)
        build_forward_matrices(part)
        return self.pool.run([(dict(s, frames=_scene_frames(s["frames"])),
                               kw) for s in self.scenes])
