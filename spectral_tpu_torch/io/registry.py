"""Sweep registry: the framework's data-management core.

Preserves the reference's de-facto data API — ``SweepManager.data``, a dict
keyed by display name with schema ``{filepath, sweep_idx, fs, fs_raw, raw,
processed}`` (SweepManager.py:10, :48-55, :139-146) — including the exact
``get_signal`` fallback rules (:151-185): requesting the processed signal
falls back to raw (with fs_raw) when absent; raw paths use fs_raw with NO
fallback to fs — the reference's ``entry.get("fs_raw", entry.get("fs"))``
only falls back when the KEY is absent, which its loaders never produce
(abf :50-53, h5 :139-146 always store the key), so a raw stream whose own
rate is unknown (fs_raw None) raises, it is not served at the processed
rate (proven by executing the reference,
tests/test_reference_differential.py::test_get_signal_semantics_fuzz).

File-type dispatch extends the reference's {.abf, .h5} (:12-19) with .wav and
.npz for the north-star audio workloads.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class SweepEntry:
    """One sweep's registry record (the reference's per-name dict).

    start_seconds extends the reference schema: the absolute recording
    time of the sweep's first sample, known only for event-driven
    variable-length ABF files (the SynchArray's lStart — pyabf exposes it
    as sweepX offsets; the reference app never surfaces it). None for
    uniform-grid modes and other formats."""
    filepath: str
    sweep_idx: int
    fs: float
    fs_raw: Optional[float]
    raw: Optional[np.ndarray]
    processed: Optional[np.ndarray]
    start_seconds: Optional[float] = None


class SweepRegistry:
    """In-memory registry of loaded sweeps (reference: SweepManager)."""

    def __init__(self):
        self.data: Dict[str, SweepEntry] = {}

    # -- loading ------------------------------------------------------------

    def load_file(self, filepath: str) -> List[str]:
        """Dispatch on extension; returns the display names registered
        (SweepManager.load_file, :12-19)."""
        ext = os.path.splitext(filepath)[1].lower()
        if ext == ".abf":
            from spectral_tpu_torch.io import abf
            return abf.load_abf(filepath, self)
        elif ext in (".h5", ".nix"):
            from spectral_tpu_torch.io import nix
            return nix.load_nix_h5(filepath, self)
        elif ext == ".wav":
            from spectral_tpu_torch.io import wav
            return wav.load_wav(filepath, self)
        elif ext == ".npz":
            return self._load_npz(filepath)
        raise ValueError(f"Unsupported file type: {ext}")

    def _load_npz(self, filepath: str) -> List[str]:
        """npz convenience format: arrays 'raw'/'processed' (1-D or
        (sweeps, n)), scalar 'fs' (and optional 'fs_raw')."""
        import struct
        import zipfile
        import zlib
        try:
            # materialize everything INSIDE the guard: the member arrays
            # decompress lazily, so a CRC error can surface at z["raw"]
            # rather than np.load — corruption must be a clean ValueError
            # at the untrusted-input boundary either way
            z = np.load(filepath)
            if "fs" not in z:
                raise ValueError("npz file must contain an 'fs' scalar")
            fs = float(np.asarray(z["fs"]).reshape(-1)[0])
            fs_raw = (float(np.asarray(z["fs_raw"]).reshape(-1)[0])
                      if "fs_raw" in z else fs)
            raw = z["raw"] if "raw" in z else None
            proc = z["processed"] if "processed" in z else None
        except FileNotFoundError:
            # a typo'd path is not corruption; keep the distinct type the
            # .wav/.abf loaders raise for missing files
            raise
        except (zipfile.BadZipFile, zipfile.LargeZipFile,
                NotImplementedError,   # corrupted compression-method field
                zlib.error, struct.error, OSError, EOFError) as e:
            raise ValueError(f"{filepath}: not a readable npz: {e}")
        src = raw if raw is not None else proc
        if src is None:
            raise ValueError("npz file must contain 'raw' or 'processed'")
        src2 = np.atleast_2d(src)
        proc2 = np.atleast_2d(proc) if proc is not None else None
        for label, a in (("raw", src2 if raw is not None else None),
                         ("processed", proc2)):
            if a is not None and a.ndim != 2:
                # atleast_2d passes 3-D arrays through; a (sweeps, ch, n)
                # array would register 2-D per-sweep signals that violate
                # the 1-D contract and fail far away inside the STFT
                raise ValueError(
                    f"npz '{label}' must be 1-D or (sweeps, n); "
                    f"got shape {a.shape}")
        if (raw is not None and proc2 is not None
                and proc2.shape[0] != src2.shape[0]):
            # validate BEFORE registering anything: an IndexError mid-loop
            # would leave the registry partially populated
            raise ValueError(
                f"npz 'raw' has {src2.shape[0]} sweep(s) but 'processed' "
                f"has {proc2.shape[0]} — sweep counts must match")
        base = os.path.splitext(os.path.basename(filepath))[0]
        names = []
        for i in range(src2.shape[0]):
            name = f"{base}_sweep{i}"
            self.register(name, SweepEntry(
                filepath=filepath, sweep_idx=i, fs=fs, fs_raw=fs_raw,
                raw=np.asarray(src2[i]) if raw is not None else None,
                processed=np.asarray(proc2[i]) if proc2 is not None else None))
            names.append(name)
        return names

    # -- registry API -------------------------------------------------------

    def register(self, name: str, entry: SweepEntry) -> None:
        # backstop for every loader: a non-positive/non-finite rate from a
        # corrupt file would otherwise surface as a bare ZeroDivisionError
        # (1/fs in freq_axis/time_axis) or NaN axes far from the input
        # boundary. fs_raw=None is legal (missing raw stream); 0 is not.
        for label, v, optional in (("fs", entry.fs, False),
                                   ("fs_raw", entry.fs_raw, True)):
            if v is None and optional:
                continue
            if v is None or not (v > 0 and np.isfinite(v)):
                raise ValueError(
                    f"cannot register {name!r}: {label}={v!r} is not a "
                    f"positive finite sampling rate")
        self.data[name] = entry

    def names(self) -> List[str]:
        return list(self.data.keys())

    def __contains__(self, name: str) -> bool:
        return name in self.data

    def get_signal(self, display_name: str, processed: bool = False
                   ) -> Tuple[np.ndarray, float]:
        """Exact reproduction of SweepManager.get_signal (:151-185)."""
        if display_name not in self.data:
            raise KeyError(f"{display_name} not found in registry")
        e = self.data[display_name]

        if processed:
            sig = e.processed
            if sig is None:
                sig = e.raw
                if sig is None:
                    raise KeyError(
                        f"No 'processed' or 'raw' signal for {display_name}")
                fs = e.fs_raw  # no fs fallback: see module docstring
            else:
                fs = e.fs
            if fs is None:
                raise KeyError(
                    f"No sampling rate for processed signal of {display_name}")
            return sig, fs

        sig = e.raw
        if sig is None:
            raise KeyError(f"No 'raw' signal for {display_name}")
        fs = e.fs_raw  # no fs fallback: see module docstring
        if fs is None:
            raise KeyError(f"No sampling rate for raw signal of {display_name}")
        return sig, fs

    # -- combined sweeps (GUI.py:226-276 registers "combine{n}" entries) ----

    def register_combined(self, names: List[str]) -> str:
        """Concatenate the named sweeps and register the result as a new
        'combineN' entry, mirroring the GUI's persistent-combine flow
        (GUI.on_add_combined_entry, GUI.py:226-276): BOTH streams are
        combined — raw from get_signal(processed=False) and processed
        from get_signal(processed=True), whose documented fallback fills
        missing processed data with raw (:239-240) — the declared entry
        fs is authoritative (:237; get_signal's returned fs is discarded),
        mixed rates are rejected (:243-245), and the new entry carries
        fs_raw = fs and sweep_idx = -1 (:260-267)."""
        raws, procs, fss = [], [], []
        for n in names:
            sig_raw, _ = self.get_signal(n, processed=False)
            sig_proc, _ = self.get_signal(n, processed=True)
            raws.append(np.asarray(sig_raw))
            procs.append(np.asarray(sig_proc))
            fss.append(self.data[n].fs)
        if len(set(fss)) > 1:
            raise ValueError(f"Mixed sampling rates: {sorted(set(fss))}")
        idx = 0
        while f"combine{idx}" in self.data:
            idx += 1
        name = f"combine{idx}"
        self.register(name, SweepEntry(
            filepath="<combined>", sweep_idx=-1, fs=fss[0], fs_raw=fss[0],
            raw=np.concatenate(raws), processed=np.concatenate(procs)))
        return name


# The reference parses sweep indices out of display names with this pattern
# (ExportManager.py:61-63); kept as a module helper.
_SWEEP_RE = re.compile(r"_sweep(\d+)$")


def split_display_name(name: str) -> Tuple[str, Optional[str]]:
    """'{base}_sweep{i}' -> (base, 'i'); no match -> (name, None)."""
    base = _SWEEP_RE.sub("", os.path.basename(name))
    m = _SWEEP_RE.search(name)
    return base, (m.group(1) if m else None)
