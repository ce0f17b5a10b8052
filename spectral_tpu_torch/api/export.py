"""Exporters: CSV burst tables, spectrogram PNGs, batch signal PNGs.

Counterpart of ``spectral_tpu/api/export.py``. Reproduces ExportManager's
data semantics with the rendering replaced by the colormap and waveform
paths on the card:

  * CSV columns and ordering (ExportManager.py:73-81): Burst ID, Source File,
    Sweep, Start/End Time, Inter-Burst Interval (NaN for the first row,
    :46-50), with combined-plot source attribution through the segment map
    (:55-64) and sweep indices parsed from display names (:61-63). The
    same bytes as the JAX package's.
  * Spectrogram PNG: colormap to packed words on the session's device ->
    one transfer -> the native encoder, replacing savefig(dpi=3000) (:108).
  * Batch signal PNGs: two passes — shared symmetric y-limit from the global
    max amplitude (:126-144, :179), then one waveform image per item with
    processed-over-raw selection and fs choice (:159-164) and filename
    sanitization (:181). The reference's fixed 0-300 s x-window (:178) is
    the default; pass window_seconds=None for the full signal.

Errors are swallowed into status strings, as the reference does
(ExportManager.py:89-90): a caller checks for "Successfully" or
"Exported".
"""

from __future__ import annotations

import csv
import os
import re
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from spectral_tpu_torch.io.registry import SweepRegistry, split_display_name
from spectral_tpu_torch.ops.colormap import apply_colormap_packed, unpack_rgba
from spectral_tpu_torch.render.png import encode_png
from spectral_tpu_torch.render.waveform import waveform_rgba
from spectral_tpu_torch.utils.device import DeviceLike, resolve_device

CSV_HEADER = ["Burst ID", "Source File", "Sweep",
              "Start Time (s)", "End Time (s)", "Inter Burst Interval (s)"]


def export_events_csv(filepath: str, session) -> str:
    """Write the burst table (ExportManager.export_to_csv semantics)."""
    events = list(session.last_detected_events)
    if not events:
        return "Error: No burst data to export."
    try:
        segment_map = session.segment_map
        plotted = session.currently_plotted_items
        is_combined = bool(segment_map)

        rows = []
        sorted_bursts = sorted(events)
        for i, (start, end) in enumerate(sorted_bursts):
            ibi = np.nan if i == 0 else start - sorted_bursts[i - 1][1]
            source_file, sweep_str = "Unknown", "Unknown"
            if is_combined:
                for seg in segment_map:
                    if seg.start_time_combined <= start < seg.end_time_combined:
                        source_file, idx = split_display_name(seg.source_name)
                        if idx is not None:
                            sweep_str = idx
                        break
            elif plotted:
                source_file, idx = split_display_name(plotted[0])
                if idx is not None:
                    sweep_str = idx
            rows.append([i + 1, source_file, sweep_str, start, end, ibi])

        # explicit utf-8: the Source File column carries arbitrary
        # basenames, and the platform default encoding (locale-dependent)
        # turns a non-ASCII recording name into an export failure under
        # C/POSIX locales. surrogateescape makes names that arrived through
        # an ASCII filesystem encoding round-trip to their on-disk bytes.
        with open(filepath, "w", newline="", encoding="utf-8",
                  errors="surrogateescape") as fh:
            w = csv.writer(fh)
            w.writerow(CSV_HEADER)
            w.writerows(rows)
        return (f"Successfully exported {len(rows)} events to "
                f"{os.path.basename(filepath)}")
    except Exception as e:  # reference swallows into a status string (:89-90)
        return f"Error exporting to CSV: {e}"


def export_spectrogram_png(filepath: str, session, colormap: str = "jet",
                           compress_level: int = 4) -> str:
    """Render session.last_image through the LUT on the session's device
    (the card unless the session was made with device='cpu') and encode."""
    if session.last_image is None:
        return "Error: No spectrogram to export."
    try:
        img = torch.tensor(session.last_image,
                           device=resolve_device(session.device))
        packed = apply_colormap_packed(img, colormap, flip_rows=True)
        rgba = unpack_rgba(packed)
        encode_png(rgba, path=filepath, compress_level=compress_level)
        return f"Successfully exported transparent PNG to {filepath}"
    except Exception as e:
        return f"Error exporting PNG: {e}"


_SAFE_RE = re.compile(r'[\\/:"*?<>|]+')


def export_batch_signals_png(out_dir: str, registry: SweepRegistry,
                             names: Sequence[str], *,
                             use_proc: bool = False, use_raw: bool = True,
                             height: int = 1200, width: int = 3600,
                             window_seconds: Optional[float] = 300.0,
                             compress_level: int = 4,
                             device: DeviceLike = "cuda") -> str:
    """Batch waveform export with the reference's two-pass shared y-scale,
    the waveforms rasterized on ``device`` (the card by default).

    window_seconds defaults to the reference's hardcoded 0-300 s x-limit
    (ExportManager.py:178 — signals shorter than the window leave the
    remaining columns empty, exactly like the fixed xlim); pass None to
    size the axis to each signal instead.
    """
    if not names:
        return "No items selected for batch export."
    dev = resolve_device(device)
    Path(out_dir).mkdir(parents=True, exist_ok=True)

    # pass 1: global max amplitude across every exported signal (:126-144)
    max_amp = 0.0
    for name in names:
        if name not in registry.data:
            continue
        e = registry.data[name]
        sigs = []
        if use_proc and e.processed is not None:
            sigs.append(np.asarray(e.processed))
        if use_raw and e.raw is not None:
            sigs.append(np.asarray(e.raw))
        for s in sigs:
            if s.size:
                max_amp = max(max_amp, float(np.max(np.abs(s))))
    if max_amp == 0.0:
        max_amp = 1.0

    success = []
    used_paths = set()
    for name in names:
        if name not in registry.data:
            continue
        e = registry.data[name]
        # selection + fs choice (:159-164): processed wins, else raw
        if use_proc and e.processed is not None:
            sig, fs = e.processed, e.fs
        elif use_raw and e.raw is not None:
            # the reference reads entry["fs_raw"] directly here (:164), not
            # get_signal's fallback to fs, so a raw stream whose own rate
            # is unknown is skipped (:168-169)
            sig, fs = e.raw, e.fs_raw
        else:
            continue
        if sig is None or fs is None:
            continue
        nvis = int(window_seconds * fs) if window_seconds else None
        img = waveform_rgba(
            torch.tensor(np.asarray(sig, np.float32), device=dev),
            height=height, width=width, y_limit=max_amp,
            n_samples_visible=nvis)
        rgba = img.cpu().numpy()
        safe = _SAFE_RE.sub("_", name)
        # sanitization can collide distinct names ('a:b' and 'a_b') onto
        # one path — a silent overwrite that would report N exported with
        # N-1 files on disk; suffix until unique
        k = 2
        while safe in used_paths:
            safe = f"{_SAFE_RE.sub('_', name)}_{k}"
            k += 1
        used_paths.add(safe)
        encode_png(rgba, path=str(Path(out_dir) / f"{safe}.png"),
                   compress_level=compress_level)
        success.append(name)
    return f"Exported {len(success)} signal PNGs to {out_dir}"
