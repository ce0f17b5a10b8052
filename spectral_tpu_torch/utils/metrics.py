"""Observability: structured logging, throughput counters, profiler hooks.

Counterpart of ``spectral_tpu/utils/metrics.py``. The reference's only
observability is print("[DEBUG] ...") statements and a status label
(SURVEY.md §5). Here: a std-logging based structured logger, a throughput
meter in the benchmark's units (frames/s, audio-hours/min), timer contexts
that synchronise the card before they read the clock, and
``torch.profiler`` wrappers: a named range in the trace and a profiler
that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

logger = logging.getLogger("spectral_tpu_torch")


def configure_logging(level: int = logging.INFO, json_lines: bool = False
                      ) -> None:
    """Install a handler for the framework's logger (idempotent)."""
    if logger.handlers:
        logger.setLevel(level)
        return
    h = logging.StreamHandler()
    if json_lines:
        class _Json(logging.Formatter):
            def format(self, rec):
                payload = {"t": round(rec.created, 3), "lvl": rec.levelname,
                           "msg": rec.getMessage()}
                if rec.args and isinstance(rec.args, dict):
                    payload.update(rec.args)
                return json.dumps(payload)
        h.setFormatter(_Json())
    else:
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(h)
    logger.setLevel(level)


@dataclass
class ThroughputMeter:
    """Accumulates processed audio and reports the benchmark units."""
    samples: int = 0
    frames: int = 0
    seconds_audio: float = 0.0
    _t0: float = field(default_factory=time.time)

    def add(self, n_samples: int, fs: float, n_frames: int = 0) -> None:
        self.samples += int(n_samples)
        self.frames += int(n_frames)
        self.seconds_audio += n_samples / fs

    def report(self) -> Dict[str, float]:
        wall = max(time.time() - self._t0, 1e-9)
        return {
            "wall_s": round(wall, 3),
            "audio_hours": round(self.seconds_audio / 3600.0, 4),
            "audio_hours_per_min": round(
                (self.seconds_audio / 3600.0) / (wall / 60.0), 2),
            "frames_per_s": round(self.frames / wall, 1),
        }


def _synchronize(device) -> None:
    """Wait for the card's queued work when ``device`` is a CUDA device
    (kernel launches return before the kernels end); nothing otherwise."""
    if device is None:
        return
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def timed(name: str, log: bool = True, device=None
          ) -> Iterator[Dict[str, float]]:
    """Timer context; yields a dict that receives {'seconds': ...}. With a
    CUDA ``device`` the card is synchronised before each reading of the
    clock, so the span covers the work launched inside it."""
    out: Dict[str, float] = {}
    _synchronize(device)
    t0 = time.time()
    try:
        yield out
    finally:
        _synchronize(device)
        out["seconds"] = time.time() - t0
        if log:
            logger.info("%s took %.3fs", name, out["seconds"])


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named range in a ``torch.profiler`` trace
    (``torch.profiler.record_function``); costs a few microseconds when
    no profiler runs."""
    import torch
    with torch.profiler.record_function(name):
        yield


_PROFILER: list = []


def start_profiler_trace(log_dir: str) -> bool:
    """Start a ``torch.profiler`` run of the host and, where CUDA is
    available, the card; :func:`stop_profiler_trace` writes it to
    ``log_dir`` as a Chrome trace. False if one is already running."""
    if _PROFILER:
        return False
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    _PROFILER.append((prof, log_dir))
    return True


def stop_profiler_trace() -> Optional[str]:
    """Stop the run :func:`start_profiler_trace` started and write its
    Chrome trace; returns the file's path, or None when none ran."""
    if not _PROFILER:
        return None
    import os
    prof, log_dir = _PROFILER.pop()
    prof.__exit__(None, None, None)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path
