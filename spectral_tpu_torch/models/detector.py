"""Burst detection flows: headless equivalents of the reference's
PlotEngine.unsupervised_detect (PlotEngine.py:411-473) and
PlotEngine.learn_and_detect (:244-326), in torch.

The port's counterpart of ``spectral_tpu/models/detector.py``, with one
change of device policy: the JAX detector runs problems under
``AUTO_CPU_THRESHOLD`` feature elements on the host under
``device='auto'`` (spectral_tpu/models/detector.py:81, :119-136). The port
does not: ``'auto'`` and ``'default'`` mean the card, ``'cpu'`` is the only
way to the plain versions, and ``None`` is refused. On the card a detection
is the H1 fit kernel, the escape-route patch in torch and the H2 Viterbi
kernel below :attr:`BurstDetector.PSCAN_THRESHOLD` frames; from it, the H3
chunked E-step under a host EM loop and H2's chunked form.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spectral_tpu_torch.core import events as ev
from spectral_tpu_torch.models import hmm, hmm_pscan
from spectral_tpu_torch.utils.device import detection_device, host_features

Event = Tuple[float, float]


def _engine(parallel: bool):
    """The sequential engine (models/hmm.py, a block a sequence on the
    card) or the chunked one (models/hmm_pscan.py)."""
    return hmm_pscan if parallel else hmm


def _check_finite_features(X: np.ndarray) -> None:
    """Refuse non-finite feature matrices like the reference stack does
    (hmmlearn -> sklearn check_array raises on NaN/Inf at
    PlotEngine.py:432 model.fit): without this, NaN flows through KMeans
    and EM and the flow silently reports zero events."""
    if not np.isfinite(X).all():
        raise ValueError(
            "features contain NaN/Inf; if the input waveform is finite, "
            "its power overflows float32 analysis — rescale the signal "
            "(the analysis is scale-invariant)")


class BurstDetector:
    """Holds the persistent 4-state Gaussian HMM and its refinement flag
    (PlotEngine.py:20-21: GaussianHMM(4, diag, n_iter=100, random_state=42),
    is_model_refined)."""

    # At or above this many FRAMES, engine='auto' takes the chunked engine
    # (models/hmm_pscan.py), as the JAX package does. In the JAX package
    # that is a correctness threshold for its float32 sequential E-step;
    # the port's float64 engines agree on either side of it, and the
    # threshold stays so both packages route the same problems alike.
    PSCAN_THRESHOLD = hmm_pscan.SEQ_SAFE_T

    def __init__(self, n_states: int = 4, n_iter: int = 100, seed: int = 42,
                 device: str = "auto", engine: str = "auto"):
        """device: 'auto' or 'default' (the card), 'cpu', 'cuda' or
        'cuda:N'; resolved at each detection. engine: 'auto' (the chunked
        engine for sequences of >= PSCAN_THRESHOLD frames), 'scan' (always
        sequential), or 'pscan' (always chunked)."""
        if engine not in ("auto", "scan", "pscan"):
            raise ValueError(f"unknown engine {engine!r}")
        if device is None:
            raise ValueError("pass a device explicitly: 'auto', 'cpu', "
                             "'cuda' or 'cuda:N'")
        self.n_states = n_states
        self.n_iter = n_iter
        self.seed = seed
        self.device = device
        self.engine = engine
        self.params: Optional[hmm.HMMParams] = None
        self.is_model_refined = False
        self.timings: dict = {}

    def _parallel(self, T: int) -> bool:
        if self.engine == "pscan":
            return True
        return self.engine == "auto" and T >= self.PSCAN_THRESHOLD

    def _device(self) -> torch.device:
        return detection_device(self.device)

    def reset(self) -> None:
        """PlotEngine.reset_model (:475-478)."""
        self.params = None
        self.is_model_refined = False

    def warmup(self) -> None:
        """Build and load the HMM kernels' library on a CUDA device, so the
        first detection pays no build. It does nothing else: the kernels
        take every shape, so there is nothing to compile per shape (the
        JAX package's ``warmup(T, D, background)`` compiles its programs
        for shape (T, D)). On the CPU it does nothing."""
        if self._device().type == "cuda":
            from spectral_tpu_torch.ops import hmm_cuda
            hmm_cuda._library()

    # ------------------------------------------------------------------
    # Unsupervised detection (PlotEngine.py:411-473)
    # ------------------------------------------------------------------

    def unsupervised_detect(self, t: np.ndarray, features) -> List[Event]:
        """Events of one recording; features (T, D), numpy or a tensor.
        ``self.timings`` receives the stages' host seconds ("init", the
        host k-means; "fit", fit and decode through the states' read;
        "scan") and the EM iterations run ("iterations", 0 for a refined
        model)."""
        t = np.asarray(t)
        if t.size == 0:
            return []
        feats_np = host_features(features)
        _check_finite_features(feats_np)
        dev = self._device()
        par = self._parallel(feats_np.shape[0])
        eng = _engine(par)
        t0 = time.perf_counter()
        X = torch.as_tensor(feats_np.astype(np.float64), device=dev)
        it = 0
        if not self.is_model_refined:
            if X.shape[0] < self.n_states:
                raise ValueError(
                    "Not enough data to train the model. Signal may be too short.")
            params0 = hmm.init_params(feats_np, self.n_states,
                                      seed=self.seed, device=dev)
            t1 = time.perf_counter()
            self.params, states, baseline, _ll, it = \
                eng.unsupervised_fit_decode(params0, X, n_iter=self.n_iter)
        else:
            t1 = time.perf_counter()
            states = eng.viterbi(self.params, X)
            baseline = torch.argmin(self.params.means[:, 0])
        states = states.cpu().numpy()
        t2 = time.perf_counter()
        events = ev.merge_overlapping_events(
            ev.baseline_scan(states, t, int(baseline)))
        self.timings = {"init": t1 - t0, "fit": t2 - t1,
                        "scan": time.perf_counter() - t2,
                        "iterations": int(it)}
        return events

    # ------------------------------------------------------------------
    # Semi-supervised "learn from examples" (PlotEngine.py:244-326)
    # ------------------------------------------------------------------

    def learn_and_detect(self, t: np.ndarray, features,
                         rois: Sequence[Event]) -> List[Event]:
        if not rois:
            raise ValueError("No manual regions provided to learn from.")
        t = np.asarray(t)
        X = host_features(features)
        _check_finite_features(X)

        precise_bursts: List[Event] = []
        for roi_start_t, roi_end_t in rois:
            idx = np.where((t >= roi_start_t) & (t <= roi_end_t))[0]
            if len(idx) < 2:  # PlotEngine.py:279-281
                continue
            pb = self._find_burst_in_roi(X[idx, :], t[idx])
            if pb:
                precise_bursts.append(pb)

        if not precise_bursts:
            raise ValueError(
                "Could not identify a clear burst in any of the provided regions.")

        dev = self._device()
        labels = ev.build_label_track(t, precise_bursts)
        self.params = hmm.supervised_fit(X, labels, self.n_states, device=dev)
        self.is_model_refined = True  # PlotEngine.py:387
        states = _engine(self._parallel(X.shape[0])).viterbi(
            self.params, torch.as_tensor(X.astype(np.float64), device=dev))
        events = ev.label_scan(states.cpu().numpy(), t)
        return ev.merge_overlapping_events(events)

    def _find_burst_in_roi(self, roi_features: np.ndarray, roi_t: np.ndarray
                           ) -> Optional[Event]:
        """2-state HMM burst localization in one ROI (PlotEngine.py:389-409).

        Note the reference's guard compares against the MAIN model's
        n_components (4), not the temp model's 2 — reproduced here. Only
        the host initialization's ValueError declines an ROI; a kernel's
        failure propagates."""
        if len(roi_features) < self.n_states:
            return None
        dev = self._device()
        eng = _engine(self._parallel(len(roi_features)))
        try:
            params0 = hmm.init_params(roi_features, 2, seed=self.seed,
                                      device=dev)
        except (ValueError, FloatingPointError):
            return None
        X = torch.as_tensor(np.asarray(roi_features, np.float64), device=dev)
        params, _, _ = eng.fit(params0, X, n_iter=50)
        burst_state = int(torch.argmax(params.means[:, 0]))  # larger mean log-power
        states = eng.viterbi(params, X).cpu().numpy()
        burst_idx = np.where(states == burst_state)[0]
        if len(burst_idx) == 0:
            return None
        return float(roi_t[burst_idx[0]]), float(roi_t[burst_idx[-1]])
