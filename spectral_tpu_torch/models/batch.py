"""Batched burst detection over many sweeps/clips, in torch.

The port's counterpart of ``spectral_tpu/models/batch.py``: the unsupervised
flow of PlotEngine.unsupervised_detect (:411-473) per clip, with the batch
axis written out where the JAX package vmaps (:42-45). On the card one
launch of each kernel serves the whole batch: the H1 fit (or, from
SEQ_SAFE_T frames, the host EM loop over H3), the escape-route patch in
torch, H2's Viterbi; then one device-to-host read of the states, and the
state-sequence -> interval scans on the host. The host k-means
initialization runs once a clip, as the JAX package's does (:78).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spectral_tpu_torch.core import events as ev
from spectral_tpu_torch.models import hmm, hmm_pscan
from spectral_tpu_torch.utils.device import detection_device, host_features

Event = Tuple[float, float]


def _engine(T: int):
    return hmm_pscan if T >= hmm_pscan.SEQ_SAFE_T else hmm


def batch_unsupervised_detect(t: np.ndarray, feats, n_states: int = 4,
                              n_iter: int = 100, seed: int = 42,
                              device="auto",
                              timings: Optional[Dict[str, float]] = None
                              ) -> List[List[Event]]:
    """Run the full unsupervised flow per clip over a batch.

    t: (T,) shared frame times; feats: (B, T, D), numpy or a tensor.
    Returns per-clip merged event lists. Mirrors
    PlotEngine.unsupervised_detect per clip: EM fit, escape-route transmat
    patch, Viterbi, baseline scan, merge. device as BurstDetector's
    ('auto' is the card). ``timings``, when given, receives the stages'
    host seconds: "init" (the host k-means), "fit" (fit, patch and
    Viterbi, through the states' read), "scan" (the host scans)."""
    dev = detection_device(device)
    feats_np = host_features(feats)
    B, T, D = feats_np.shape
    if not np.isfinite(feats_np).all():
        bad = np.where(~np.isfinite(feats_np).reshape(B, -1).all(axis=1))[0]
        raise ValueError(
            f"features contain NaN/Inf (clips {bad.tolist()[:8]}"
            f"{'...' if bad.size > 8 else ''}); if the input waveforms "
            "are finite, their power overflows float32 analysis — "
            "rescale the signals (the analysis is scale-invariant)")
    if T < n_states:
        raise ValueError(
            "Not enough data to train the model. Signal may be too short.")

    t0 = time.perf_counter()
    inits = [hmm.init_params(feats_np[b], n_states, seed=seed, device="cpu")
             for b in range(B)]
    params0 = hmm.HMMParams(*(torch.stack(a).to(dev) for a in zip(*inits)))
    t1 = time.perf_counter()
    X = torch.as_tensor(feats_np.astype(np.float64), device=dev)
    _params, states, baselines, _ll, _it = _engine(T).unsupervised_fit_decode(
        params0, X, n_iter=n_iter)
    states = states.cpu().numpy()
    baselines = baselines.cpu().numpy()
    t2 = time.perf_counter()
    out: List[List[Event]] = []
    for b in range(B):
        evs = ev.baseline_scan(states[b], t, int(baselines[b]))
        out.append(ev.merge_overlapping_events(evs))
    if timings is not None:
        timings.update(init=t1 - t0, fit=t2 - t1,
                       scan=time.perf_counter() - t2)
    return out


def batch_viterbi_detect(params: hmm.HMMParams, t: np.ndarray, feats,
                         scan: str = "label") -> List[List[Event]]:
    """Decode a batch with one shared model, on the model's device.

    scan='label': the learn_and_detect semantics (states {1,2} open, 0
    closes) — appropriate for supervised-fit models. scan='baseline': the
    unsupervised semantics with baseline = argmin(mean log-power)."""
    dev = params.means.device
    X = torch.as_tensor(host_features(feats).astype(np.float64), device=dev)
    states = _engine(X.shape[1]).viterbi(params, X).cpu().numpy()
    if scan == "label":
        return [ev.merge_overlapping_events(ev.label_scan(states[b], t))
                for b in range(states.shape[0])]
    baseline = int(torch.argmin(params.means[:, 0]))
    return [ev.merge_overlapping_events(ev.baseline_scan(states[b], t,
                                                         baseline))
            for b in range(states.shape[0])]
