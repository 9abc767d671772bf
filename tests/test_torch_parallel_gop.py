"""The scene batch over worker processes (av1tpu_torch/parallel/gop.py), on
the CPU: each scene of a batch dealt to two workers equals the same scene
run alone, whatever worker it landed on (the port's
test_scene_batch_matches_single_device of tests/test_parallel_gop.py); a
worker's failure fails the encode, and no worker outlives its pool.  The
CLI's batch branch is held to the reference's streams in
tests/test_torch_slice_quality.py and tests/test_torch_slice.py.

Every wait on a worker is bounded (the pool's result timeout, its bounded
joins), so a hung worker fails its test instead of the suite's clock."""

import multiprocessing
import os
import time

import numpy as np
import pytest
import torch

from av1tpu_torch.models.intra_v import fuse_planes
from av1tpu_torch.parallel import gop
from av1tpu_torch.utils.yuv import synthetic_clip
from tests.test_torch_threads import single_torch_thread  # noqa: F401

H = W = 64
LENS = [3, 2, 4]        # three scenes on two workers: an uneven deal
TIMEOUT = 300.0         # seconds a test waits for one scene's result


def _scene(k, seed):
    clip = synthetic_clip(W, H, k, seed=seed)
    return np.stack([fuse_planes(clip.y[i], clip.u[i], clip.v[i])
                     for i in range(k)])


def _scenes():
    # tests/test_parallel_gop.py's scenes, with the noise gates on in one
    return [{"frames": _scene(n, seed=100 + s),
             "q": 100 + 4 * (s % 3), "key_q": 80 + 4 * (s % 3),
             "key_lf": (10, 7, 7), "inter_lf": (12, 8, 8),
             "key_gate": 22.5 if s == 1 else 0.0,
             "inter_gate": 6.25 if s == 1 else 0.0}
            for s, n in enumerate(LENS)]


def _encode(scenes, pool, **kw):
    return gop.SceneBatchEncoder(scenes, pool, H, W).encode(8192, 8192,
                                                            **kw)


def _no_children(pool):
    assert not any(p.is_alive() for p in pool._procs)
    assert multiprocessing.active_children() == []


@pytest.fixture(scope="module")
def runs():
    """The batch on [cpu, cpu], each scene alone on [cpu] (one pool, one
    batch per scene), and scene 0 in this process, with the forward
    matrices the batch builds for its workers (and the matrices this
    process had before the in-process scene and after it)."""
    from av1tpu_torch.ops.transforms import built_forward_matrices

    scenes = _scenes()
    cpu = torch.device("cpu")
    gop.build_forward_matrices(True)
    before = set(built_forward_matrices())
    here = gop._encode_scene(
        dict(scenes[0], frames=torch.from_numpy(scenes[0]["frames"])), cpu,
        H, W, 8, 8192, 8192, True,
        lambda b: gop.key_skip8(b, H, W), 1.0)
    after = set(built_forward_matrices())
    with gop.ScenePool(gop.scene_devices(2, "cpu"), TIMEOUT) as pool:
        batch = _encode(scenes, pool)
    _no_children(pool)
    with gop.ScenePool([cpu], TIMEOUT) as pool:
        alone = [_encode([s], pool)[0] for s in scenes]
    _no_children(pool)
    return here, batch, alone, before, after


def test_scene_batch_matches_single_device(runs):
    _, batch, alone, _, _ = runs
    for s, (a, b) in enumerate(zip(batch, alone)):
        assert np.array_equal(a["key_buf"], b["key_buf"]), s
        assert np.array_equal(a["cdef_s"], b["cdef_s"]), s
        assert len(a["inter_bufs"]) == len(b["inter_bufs"]) == LENS[s] - 1
        for t, (x, y) in enumerate(zip(a["inter_bufs"], b["inter_bufs"])):
            assert np.array_equal(x, y), (s, t)
        assert np.array_equal(a["ref"], b["ref"]), s


def test_batch_deals_round_robin_and_returns_real_scenes(runs):
    """One result per scene (no padded scene) with L_s - 1 inter buffers
    (no padded step), dealt 0, 1, 0 over two distinct workers."""
    _, batch, _, _, _ = runs
    assert len(batch) == 3
    assert [len(r["inter_bufs"]) for r in batch] == [n - 1 for n in LENS]
    pids = [r["pid"] for r in batch]
    assert pids[0] == pids[2] != pids[1] and os.getpid() not in pids
    assert {r["device"] for r in batch} == {"cpu"}
    assert all(r["peak_bytes"] is None for r in batch)
    assert {"key_device", "cdef", "inter_dispatch",
            "inter_fetch"} == set(batch[0]["seconds"])


def test_worker_matches_in_process_scene(runs):
    """A worker adopts the parent's thread count and forward matrices: its
    scene equals the same scene encoded in this process.  The matrices the
    batch builds for its workers are all that a scene uses."""
    here, _, alone, before, after = runs
    assert after == before
    for k in ("key_buf", "cdef_s", "ref"):
        assert np.array_equal(here[k], alone[0][k]), k
    for x, y in zip(here["inter_bufs"], alone[0]["inter_bufs"]):
        assert np.array_equal(x, y)


def test_scene_devices(monkeypatch):
    cpu = torch.device("cpu")
    assert gop.scene_devices(1, "cpu") == [cpu]
    assert gop.scene_devices(3, cpu) == [cpu] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert gop.scene_devices(8, "cuda") == [torch.device("cuda", 0),
                                            torch.device("cuda", 1)]
    assert gop.scene_devices(1, "cuda:1") == [torch.device("cuda", 0)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert gop.scene_devices(4, "cuda") == []


def _die(buf):
    os._exit(3)


def _hang(buf):
    time.sleep(600)


def test_worker_failure_fails_the_encode(runs):
    """An exception in a worker (a scene whose frames are not H x W), a
    worker's death and a hung worker (past the pool's timeout) all raise
    in the parent; the pool then takes no more batches, and its workers
    are gone once it is closed."""
    bad = dict(_scenes()[1], frames=np.zeros((2, 100), np.uint8))
    pool = gop.ScenePool(["cpu", "cpu"], TIMEOUT)
    try:
        with pytest.raises(RuntimeError, match="scene 1"):
            _encode([_scenes()[0], bad], pool)
        with pytest.raises(RuntimeError, match="no batch after a failure"):
            _encode(_scenes()[:1], pool)
    finally:
        pool.close(graceful=False)
    _no_children(pool)
    for fn, timeout, err, match in ((_die, TIMEOUT, RuntimeError,
                                     "exited with code 3"),
                                    (_hang, 1.0, TimeoutError, "within")):
        with pytest.raises(err, match=match):
            with gop.ScenePool(["cpu"], timeout) as pool:
                _encode(_scenes()[:1], pool, skip8_host_fn=fn)
        _no_children(pool)
