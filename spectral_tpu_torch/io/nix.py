"""NIX / generic HDF5 loading (h5py-based, no neo dependency).

The reference reads NIX HDF5 through ``neo.NixIO.read_block`` and then, per
segment, picks analog signals by case-insensitive (bytes-safe) name matching:
signals containing 'proc' -> processed, 'raw' -> raw, fallback to the first
signal, cross-filling whichever is missing, with fs taken from the signal's
sampling rate and the sweep skipped when no fs exists
(SweepManager._load_h5, SweepManager.py:60-149). This module reproduces those
selection semantics directly against the NIX HDF5 layout:

    /data/<block>/groups/<segment>/data_arrays/<signal>  (hard links)
    /data/<block>/data_arrays/<signal>/{data, dimensions/1}
    signal attrs: name (or the group name); dimension attrs:
    dimension_type='sample', sampling_interval, unit ('s'/'ms'/'us')

plus a generic fallback for plain HDF5 files: every 1-D dataset is a
candidate signal, segment grouping by parent group, fs from an 'fs' /
'sampling_rate' attribute on the dataset or its parents.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover - h5py is in the target image
    h5py = None


def _to_str(name) -> str:
    """Bytes-safe string conversion (SweepManager.py:69-73)."""
    if isinstance(name, bytes):
        return name.decode("utf-8", "ignore")
    return str(name)


_TIME_UNIT_S = {"s": 1.0, "ms": 1e-3, "us": 1e-6, "µs": 1e-6, "ns": 1e-9}


def _natkey(name: str):
    """Natural-sort key: digit runs compare numerically, so seg10 sorts
    after seg9. h5py iterates members in LEXICOGRAPHIC name order, which
    would load segment 10 as sweep 2 in any file with >= 10 segments —
    silently registering data under the wrong display name."""
    import re
    s = _to_str(name)
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", s)]


def _natsorted(container):
    return sorted(container, key=_natkey)


def _fs_from_nix_dims(sig_group) -> Optional[float]:
    """fs = 1 / (sampling_interval * unit_in_seconds) from dimension 1."""
    dims = sig_group.get("dimensions")
    if dims is None:
        return None
    for key in sorted(dims.keys()):
        d = dims[key]
        dt = _to_str(d.attrs.get("dimension_type", ""))
        if dt and dt != "sample":
            continue
        si = d.attrs.get("sampling_interval")
        if si is None:
            continue
        unit = _to_str(d.attrs.get("unit", "s")) or "s"
        scale = _TIME_UNIT_S.get(unit)
        # a corrupt interval (0, negative, NaN/Inf, non-numeric) means the
        # rate is unknowable: treat like missing fs (sweep skipped,
        # :130-132 semantics) rather than registering a rate that divides
        # to ZeroDivisionError/NaN downstream. NaN fails the > 0 compare.
        try:
            si_f = float(np.asarray(si).reshape(-1)[0])
        except (TypeError, ValueError):
            return None
        if scale is None or not si_f > 0 or not np.isfinite(si_f):
            return None
        return 1.0 / (si_f * scale)
    return None


def _collect_nix_segments(f) -> List[List[Tuple[str, np.ndarray, Optional[float]]]]:
    """Returns per-segment lists of (signal_name, data, fs) from NIX layout."""
    segments = []
    data_root = f.get("data")
    # every container level is isinstance-checked: a generic HDF5 file may
    # have a DATASET named 'data' (or datasets where NIX has groups), and
    # iterating/`.get`ing a Dataset raises — such files must fall through
    # to the generic collector instead of crashing the load
    if not isinstance(data_root, h5py.Group):
        return segments
    for block_name in _natsorted(data_root):
        block = data_root[block_name]
        if not isinstance(block, h5py.Group):
            continue
        groups = block.get("groups")
        das = block.get("data_arrays")
        if not isinstance(groups, h5py.Group):
            continue
        for seg_name in _natsorted(groups):
            seg = groups[seg_name]
            if not isinstance(seg, h5py.Group):
                continue
            seg_das = seg.get("data_arrays")
            sigs = []
            src = seg_das if isinstance(seg_das, h5py.Group) else das
            if not isinstance(src, h5py.Group):
                continue
            for da_name in _natsorted(src):
                da = src[da_name]
                if not isinstance(da, h5py.Group) or "data" not in da:
                    continue
                name = _to_str(da.attrs.get("name", da_name))
                # reshape(-1) on purpose, INCLUDING 2-D (samples, channels)
                # arrays: the reference does exactly
                # `magnitude.copy().reshape(-1)` (SweepManager.py:135-136),
                # so multi-channel AnalogSignals interleave identically here
                arr = np.asarray(da["data"]).reshape(-1)
                fs = _fs_from_nix_dims(da)
                sigs.append((name, arr, fs))
            segments.append(sigs)
    return segments


def _collect_generic_segments(f) -> List[List[Tuple[str, np.ndarray, Optional[float]]]]:
    """Fallback: group 1-D datasets by parent group path."""
    by_parent: Dict[str, List] = {}

    def fs_of(ds) -> Optional[float]:
        for obj in (ds, ds.parent):
            for key in ("fs", "sampling_rate", "sample_rate"):
                if key in obj.attrs:
                    try:
                        v = float(np.asarray(obj.attrs[key]).reshape(-1)[0])
                    except (TypeError, ValueError):
                        continue
                    # 0/negative/NaN/Inf = unknowable rate -> missing-fs
                    # skip semantics (the NaN compare is False)
                    return v if (v > 0 and np.isfinite(v)) else None
        return None

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset) and obj.ndim in (1, 2):
            # corrupted link names can arrive as non-UTF-8 BYTES from
            # h5py's visititems — '"/" in name' on bytes is a TypeError
            # (found by the 25x loader fuzz soak); normalize first
            name = _to_str(name)
            parent = name.rsplit("/", 1)[0] if "/" in name else ""
            by_parent.setdefault(parent, []).append(
                (name.rsplit("/", 1)[-1],
                 np.asarray(obj).reshape(-1), fs_of(obj)))

    f.visititems(visit)
    return [by_parent[k] for k in sorted(by_parent, key=_natkey)]


def load_nix_h5(filepath: str, registry) -> List[str]:
    """Load a NIX (or generic) HDF5 file into the registry. Reproduces the
    reference's per-segment signal selection (SweepManager.py:86-147)."""
    if h5py is None:
        raise RuntimeError("h5py is required for HDF5 loading")
    from spectral_tpu_torch.io.registry import SweepEntry

    display_names: List[str] = []
    base = os.path.splitext(os.path.basename(filepath))[0]

    try:
        with h5py.File(filepath, "r") as f:
            segments = _collect_nix_segments(f) if "data" in f else []
            # a NIX-shaped tree whose members are not {group with 'data'}
            # yields segment lists of EMPTY lists — truthy, but containing
            # no signals; the generic collector must still get its chance
            if not any(segments):
                segments = _collect_generic_segments(f)
    except FileNotFoundError:
        # a typo'd path is not corruption; keep the distinct type the
        # .wav/.abf loaders raise for missing files
        raise
    except (OSError, RuntimeError, KeyError) as e:
        # h5py surfaces corruption as RuntimeError/KeyError/OSError
        # internals; the loader contract is a clean ValueError at the
        # untrusted-input boundary
        raise ValueError(f"{filepath}: not a readable HDF5 file: {e}")

    for i, sigs in enumerate(segments):
        raw_sig = proc_sig = None
        # name matching: 'proc' / 'raw', case-insensitive (:91-92)
        potential_proc = [s for s in sigs if "proc" in s[0].lower()]
        potential_raw = [s for s in sigs if "raw" in s[0].lower()]
        if potential_proc:
            proc_sig = potential_proc[0]
        if potential_raw:
            raw_sig = potential_raw[0]
        # fallback to the first signal (:100-103)
        if proc_sig is None and raw_sig is None and sigs:
            proc_sig = sigs[0]
        # cross-fill (:105-106)
        if proc_sig is None:
            proc_sig = raw_sig
        if raw_sig is None:
            raw_sig = proc_sig
        if proc_sig is None:
            continue

        fs_proc = proc_sig[2]
        fs_raw = raw_sig[2] if raw_sig is not proc_sig else fs_proc
        authoritative_fs = fs_proc if fs_proc is not None else fs_raw
        if authoritative_fs is None:  # skip sweeps without any fs (:130-132)
            continue

        name = f"{base}_sweep{i}"
        registry.register(name, SweepEntry(
            filepath=filepath, sweep_idx=i, fs=float(authoritative_fs),
            fs_raw=(float(fs_raw) if fs_raw is not None else None),
            raw=np.ascontiguousarray(raw_sig[1]),
            processed=np.ascontiguousarray(proc_sig[1])))
        display_names.append(name)

    return display_names


def write_nix_fixture(filepath: str, segments, fs: float = 1000.0) -> None:
    """Write a minimal NIX-layout HDF5 file (test fixture / interchange).

    segments: list of dicts {signal_name: 1-D array}. Sampling interval is
    stored NIX-style (dimension 1, unit 's').
    """
    if h5py is None:
        raise RuntimeError("h5py is required")
    with h5py.File(filepath, "w") as f:
        f.attrs["format"] = "nix"
        block = f.create_group("data/block0")
        das = block.create_group("data_arrays")
        groups = block.create_group("groups")
        for i, seg in enumerate(segments):
            g = groups.create_group(f"seg{i}")
            gdas = g.create_group("data_arrays")
            for sig_name, arr in seg.items():
                da = das.create_group(f"da_{i}_{sig_name}")
                da.attrs["name"] = sig_name
                da.create_dataset("data", data=np.asarray(arr))
                d1 = da.create_group("dimensions/1")
                d1.attrs["dimension_type"] = "sample"
                d1.attrs["sampling_interval"] = 1.0 / fs
                d1.attrs["unit"] = "s"
                gdas[f"da_{i}_{sig_name}"] = da  # hard link (NIX style)
