"""Logging and the profiler hook of the encode command (port of
av1tpu/utils/log.py).

``get_logger`` gives timestamped, leveled, component-tagged lines on
stderr, with the level from AV1TPU_LOG_LEVEL (the C++ daemon's format).
``profile_trace`` wraps a code region in a torch.profiler trace when
AV1TPU_PROFILE=<dir> is set; it is off by default.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys

_CONFIGURED = False


def get_logger(component: str) -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        level = os.environ.get("AV1TPU_LOG_LEVEL", "info").upper()
        if level == "WARN":
            level = "WARNING"
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s.%(msecs)03dZ %(levelname)-5s [%(name)s] %(message)s",
            datefmt="%Y-%m-%dT%H:%M:%S"))
        root = logging.getLogger("av1tpu_torch")
        root.addHandler(handler)
        root.setLevel(getattr(logging, level, logging.INFO))
        root.propagate = False
        _CONFIGURED = True
    return logging.getLogger(f"av1tpu_torch.{component}")


@contextlib.contextmanager
def profile_trace(label: str = "encode"):
    """A torch.profiler trace of the region (host activity, and the card's
    where CUDA is present), written as the Chrome trace <dir>/<label>.json
    when AV1TPU_PROFILE=<dir> is set; a no-op otherwise."""
    trace_dir = os.environ.get("AV1TPU_PROFILE")
    if not trace_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(trace_dir, f"{label}.json")
    get_logger("profile").info("capturing a torch.profiler trace of '%s' "
                               "to %s", label, path)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)
