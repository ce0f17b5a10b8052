"""Event / feature / band-power algebra, in torch.

The port's counterpart of ``spectral_tpu/core/events.py``. That module
imports jax, so this one is written anew rather than copied:

  * features:        PlotEngine._calculate_features   (PlotEngine.py:229-242)
  * baseline scan:   unsupervised state->events       (PlotEngine.py:449-470)
  * label scan:      supervised  state->events        (PlotEngine.py:313-321)
  * interval merge:  _merge_overlapping_events        (PlotEngine.py:669-684)
  * band powers:     calculate_band_powers            (PlotEngine.py:692-719)
  * absolute power:  calculate_absolute_power         (PlotEngine.py:686-690)
  * ROI editing ops: add/delete/merge-contained       (PlotEngine.py:608-645,
                     :553-606) as pure functions on event lists

The features run in torch on the PSD's device: the band's bins are summed
in float64 and the sum rounded to float32, the JAX package's feature type,
before the float32 log10 and difference the JAX package applies. The scans
run on the host in numpy, exactly as the reference's loops do.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Event = Tuple[float, float]

# Default EEG bands (PlotEngine.py:698-706).
EEG_BANDS: Dict[str, Tuple[float, float]] = {
    "Delta (δ)": (0, 4),
    "Theta (θ)": (4, 8),
    "Alpha (α)": (8, 13),
    "Beta (β)": (13, 30),
    "Gamma (γ)": (30, 80),
    "HFO (ripples)": (80, 250),
}


# ---------------------------------------------------------------------------
# Features (device)
# ---------------------------------------------------------------------------

def features_from_band_power(power: torch.Tensor) -> torch.Tensor:
    """(..., T) per-frame band power -> (..., T, 2) HMM features: the exact
    PlotEngine.py:238-242 arithmetic (log10(power + 1e-20) and its
    prepend-first np.diff) in power's dtype."""
    log_power = torch.log10(power + 1e-20)
    delta = torch.diff(log_power, dim=-1, prepend=log_power[..., :1])
    return torch.stack([log_power, delta], dim=-1)


def band_bins(f: np.ndarray, fmin: float, fmax: float) -> np.ndarray:
    """The bins of the feature band: the reference's mask (f >= fmin) &
    (f <= fmax), inclusive at both ends (PlotEngine.py:238)."""
    f = np.asarray(f)
    return np.flatnonzero((f >= fmin) & (f <= fmax))


def features_from_psd(f: np.ndarray, psd_tf: torch.Tensor, fmin: float,
                      fmax: float) -> torch.Tensor:
    """HMM features from a frame-major PSD (..., T, F) -> (..., T, 2)
    float32, on the PSD's device.

    Mirrors PlotEngine.py:238-242: per-frame band power = sum of the PSD
    bins in [fmin, fmax] (inclusive), taken here in float64 and rounded to
    float32; feature 0 = log10(power + 1e-20); feature 1 = delta of
    feature 0 with the first value prepended. ``f`` is the PSD's own
    frequency axis: a PSD computed for a band alone passes that band's
    bins (``f[lo:hi]``), and the mask then selects the same bins as on the
    full axis."""
    f = np.asarray(f)
    if psd_tf.shape[-1] != f.shape[0]:
        raise ValueError(f"PSD of {psd_tf.shape[-1]} bins for a frequency "
                         f"axis of {f.shape[0]}")
    idx = band_bins(f, fmin, fmax)
    if idx.size and idx[-1] - idx[0] + 1 == idx.size:
        sel = psd_tf[..., int(idx[0]):int(idx[-1]) + 1]
    else:
        sel = torch.index_select(psd_tf, -1, torch.as_tensor(
            idx, dtype=torch.long, device=psd_tf.device))
    power = sel.to(torch.float64).sum(dim=-1).to(torch.float32)
    return features_from_band_power(power)


# ---------------------------------------------------------------------------
# State-sequence -> event-interval scans (host, exact)
# ---------------------------------------------------------------------------

def baseline_scan(states: np.ndarray, t: np.ndarray, baseline_state: int
                  ) -> List[Event]:
    """Unsupervised scan (PlotEngine.py:447-470).

    An event opens at t[i-1] (the last baseline point) when the state leaves
    baseline, closes at t[i-1] (the last non-baseline point) when it returns,
    is kept only if end > start, and an open event at the end of the sequence
    closes at t[-1]."""
    states = np.asarray(states)
    t = np.asarray(t)
    is_base = states == baseline_state
    events: List[Event] = []
    in_event, start_time = False, 0.0
    for i in range(1, len(states)):
        if not in_event and is_base[i - 1] and not is_base[i]:
            in_event = True
            start_time = float(t[i - 1])
        elif in_event and is_base[i] and not is_base[i - 1]:
            in_event = False
            end_time = float(t[i - 1])
            if end_time > start_time:
                events.append((start_time, end_time))
    if in_event:
        events.append((start_time, float(t[-1])))
    return events


def label_scan(states: np.ndarray, t: np.ndarray) -> List[Event]:
    """Supervised scan (PlotEngine.py:313-321).

    States {1, 2} open an event at t[i]; state 0 closes it at t[i] (kept only
    if t[i] > start). State 3 neither opens nor closes. An open event at the
    end closes at t[-1]."""
    states = np.asarray(states)
    t = np.asarray(t)
    events: List[Event] = []
    in_event, start_time = False, 0.0
    for i in range(len(states)):
        if not in_event and states[i] in (1, 2):
            in_event, start_time = True, float(t[i])
        elif in_event and states[i] == 0:
            in_event = False
            if t[i] > start_time:
                events.append((start_time, float(t[i])))
    if in_event:
        events.append((start_time, float(t[-1])))
    return events


def merge_overlapping_events(events: Sequence[Event], tolerance: float = 1e-6
                             ) -> List[Event]:
    """Sort by start; merge intervals overlapping within tolerance
    (PlotEngine.py:669-684)."""
    if not events:
        return []
    ev = sorted(events, key=lambda x: x[0])
    merged = [ev[0]]
    for cur_start, cur_end in ev[1:]:
        last_start, last_end = merged[-1]
        if cur_start <= last_end + tolerance:
            merged[-1] = (last_start, max(last_end, cur_end))
        else:
            merged.append((cur_start, cur_end))
    return merged


def build_label_track(t: np.ndarray, bursts: Sequence[Event]) -> np.ndarray:
    """4-state labels (PlotEngine.py:301-308): 0 baseline, 1 onset sample,
    2 interior, 3 offset sample. For each burst (start_t, end_t), start_idx
    and end_idx by np.searchsorted; skipped if start_idx >= end_idx."""
    t = np.asarray(t)
    labels = np.zeros(len(t), dtype=int)
    for start_t, end_t in bursts:
        start_idx, end_idx = np.searchsorted(t, start_t), np.searchsorted(t, end_t)
        if start_idx >= end_idx:
            continue
        labels[start_idx] = 1
        if end_idx > start_idx + 1:
            labels[start_idx + 1:end_idx] = 2
        if end_idx < len(labels):
            labels[end_idx] = 3
    return labels


# ---------------------------------------------------------------------------
# Band powers / absolute power
# ---------------------------------------------------------------------------

def _host(sxx) -> np.ndarray:
    if isinstance(sxx, torch.Tensor):
        return sxx.detach().cpu().numpy()
    return np.asarray(sxx)


def absolute_power(sxx) -> float:
    """Total power = sum of the (masked) PSD (PlotEngine.py:686-690), on
    the host."""
    return float(np.sum(_host(sxx)))


def band_powers(f: np.ndarray, sxx, bands: Optional[Dict[str, Tuple[float, float]]] = None
                ) -> Dict[str, float]:
    """Relative band powers (PlotEngine.py:692-719), on the host.

    Sxx (F, T) is clamped to >= 0; band mask is f >= low AND f < high
    (upper edge exclusive); relative power = band sum / total sum; if the
    total is below 1e-18 every band reports 0.0."""
    if bands is None:
        bands = EEG_BANDS
    f = np.asarray(f)
    sxx_lin = np.maximum(0.0, _host(sxx))
    total = float(sxx_lin.sum())
    if total < 1e-18:
        return {name: 0.0 for name in bands}
    out: Dict[str, float] = {}
    for name, (low, high) in bands.items():
        mask = (f >= low) & (f < high)
        band = float(sxx_lin[mask, :].sum()) if mask.any() else 0.0
        out[name] = float(np.clip(band / total, 0.0, None))
    return out


def band_powers_device(f: np.ndarray, psd_tf: torch.Tensor,
                       band_edges: Sequence[Tuple[float, float]]
                       ) -> torch.Tensor:
    """Batched variant on the PSD's device: frame-major PSD (..., T, F) ->
    (..., bands) relative powers in psd's dtype, zeros where the total is
    below 1e-18. Sums in float64."""
    f = np.asarray(f)
    masks = np.stack([((f >= lo) & (f < hi)).astype(np.float64)
                      for lo, hi in band_edges])                  # (bands, F)
    sxx_lin = torch.clamp_min(psd_tf.to(torch.float64), 0.0)
    total = sxx_lin.sum(dim=(-2, -1))
    band = sxx_lin.sum(dim=-2) @ torch.as_tensor(
        masks, dtype=torch.float64, device=psd_tf.device).T
    rel = band / torch.clamp_min(total[..., None], 1e-30)
    rel = torch.where(total[..., None] < 1e-18, torch.zeros_like(rel), rel)
    return rel.to(psd_tf.dtype)


# ---------------------------------------------------------------------------
# ROI editing operations (pure functions on event lists)
# ---------------------------------------------------------------------------

def add_roi(events: Sequence[Event], start: float, end: float,
            min_width: float) -> List[Event]:
    """Add a drawn ROI (PlotEngine.on_release, :626-642): endpoints are
    sorted, and the ROI is dropped if narrower than one sample period."""
    ev = list(events)
    if abs(start - end) >= min_width:
        ev.append((min(start, end), max(start, end)))
    return ev


def delete_roi(events: Sequence[Event], roi: Event) -> List[Event]:
    """Delete one ROI (PlotEngine.remove_patch semantics, :647-653)."""
    ev = list(events)
    if roi in ev:
        ev.remove(roi)
    return ev


def merge_contained_rois(events: Sequence[Event], container: Event
                         ) -> List[Event]:
    """Context-menu Merge (PlotEngine.on_press, :565-599): ROIs contained in
    the container are replaced by their union, the container removed too;
    unchanged if nothing is contained. The result is sorted (:598)."""
    contained = [e for e in events
                 if e != container and e[0] >= container[0] and e[1] <= container[1]]
    if not contained:
        return list(events)
    to_remove = set(contained) | {container}
    kept = [e for e in events if e not in to_remove]
    kept.append((min(s for s, _ in contained), max(e for _, e in contained)))
    return sorted(kept)
