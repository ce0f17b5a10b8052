"""Headless analysis session: the user-facing API, on the card.

Counterpart of ``spectral_tpu/api/session.py``. Covers the reference's
PlotEngine + GUI-orchestration surface (SURVEY.md §1 L1/L2/L3 + C6/C20)
without any GUI: sweep composition with segment-map provenance,
spectrogram computation/normalization, burst detection (unsupervised +
learn-from-examples), ROI editing operations, band powers, and state for
the exporters. This class is the thin stateful shell around the port's
kernels, mirroring the reference's implicit state API
(last_f/last_t/last_Sxx, last_detected_events, segment_map,
spec_data_source, currently_plotted_items — PlotEngine.py:22-29).

A plot runs on the session's device (the card unless the session was made
with ``device="cpu"``): the route's STFT/PSD kernel on the full band, the
mel kernel when ``n_mels`` is set, the band's rows and
``core.scale.normalize``, then one device-to-host copy of the displayed
pair. Detection runs the HMM kernels through ``models.detector``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spectral_tpu_torch.config import SpecConfig, ViewSettings
from spectral_tpu_torch.core import events as ev
from spectral_tpu_torch.core.mel import mel_centers, mel_filterbank
from spectral_tpu_torch.core.scale import normalize
from spectral_tpu_torch.core.stft import (band_row_slice, effective_config,
                                          freq_axis, mask_band_rows,
                                          time_axis)
from spectral_tpu_torch.io.registry import SweepRegistry
from spectral_tpu_torch.models.detector import BurstDetector
from spectral_tpu_torch.models.hmm import HMMParams
from spectral_tpu_torch.ops.mel_cuda import mel_project, mel_spans
from spectral_tpu_torch.ops.stft_cuda import stft_psd
from spectral_tpu_torch.utils.device import (DeviceLike, detection_device,
                                             resolve_device)

Event = Tuple[float, float]


def _power(x: torch.Tensor, fs: float, cfg: SpecConfig) -> torch.Tensor:
    """Frame-major PSD (T, F) float32 of a float32 waveform on its device,
    computed in float64 and rounded once, a bin past the float32 range
    inf: one launch of the route's STFT/PSD kernel on a CUDA tensor, the
    kernels' plain version on a CPU tensor (``ops.stft_cuda.stft_psd``)."""
    return stft_psd(x, fs, cfg).float()


def _mel_rows(psd: torch.Tensor, fb: np.ndarray) -> torch.Tensor:
    """The filterbank rows fb (M, F) of a frame-major PSD (T, F): (T, M)
    float32, one launch of the mel kernel on a CUDA tensor."""
    return mel_project(psd[None].contiguous(), mel_spans(fb, psd.device))[0][0]


def _plot_program(x: torch.Tensor, fs: float, cfg: SpecConfig,
                  band: Optional[Tuple[int, int]],
                  global_max: Optional[float]):
    """The interactive plot on x's device.

    Returns (full frame-major PSD, stack([banded freq-major sxx, image])).
    The PSD stays on the device for the detection cache; the display pair
    comes back as ONE stacked tensor, so the host makes a single
    device-to-host copy. With n_mels the mel kernel computes the band's
    mel rows alone, each the same sum as the full set's."""
    psd = _power(x, fs, cfg)                          # (T, F)
    if cfg.n_mels:
        fb = mel_filterbank(cfg.n_mels, psd.shape[-1], fs, cfg.mel_fmin,
                            cfg.mel_fmax, cfg.mel_htk)
        disp_fm = _mel_rows(psd, fb if band is None
                            else fb[band[0]:band[1]]).transpose(-1, -2)
    else:
        disp_fm = psd.transpose(-1, -2)
        if band is not None:
            disp_fm = disp_fm[band[0]:band[1]]
    img = normalize(disp_fm, cfg.log_scale, global_max)
    return psd, torch.stack([disp_fm, img])


@dataclasses.dataclass
class SegmentRecord:
    """Provenance of one sweep inside a combined plot
    (PlotEngine.segment_map entries, PlotEngine.py:184-188)."""
    start_time_combined: float
    end_time_combined: float
    source_name: str


@dataclasses.dataclass
class SpectrogramResult:
    """What the reference renders: masked frequency axis, frame times,
    raw PSD (freq-major), and the normalized [0,1] display image, on the
    host."""
    f: np.ndarray
    t: np.ndarray
    sxx: np.ndarray
    image: np.ndarray

    @property
    def total_power(self) -> float:
        return float(np.sum(self.sxx))


class AnalysisSession:
    """Headless equivalent of the reference application.

    Typical flow::

        s = AnalysisSession()                  # on the card
        s.load("recording.wav")
        result = s.plot_sweeps(s.registry.names()[:3],
                               SpecConfig.scipy_default(1024, fmin=0, fmax=30),
                               ViewSettings(combine=True))
        events = s.unsupervised_detect()
        s.export_csv("bursts.csv")
        s.export_png("figure.png")
    """

    def __init__(self, registry: Optional[SweepRegistry] = None,
                 detector: Optional[BurstDetector] = None,
                 warm_detection: bool = True,
                 device: DeviceLike = "cuda"):
        """device: where plots, detection and PNG colormaps run: 'cuda'
        (the card, the default), 'cuda:N' or 'cpu' (the kernels' plain
        versions); it is resolved at each plot, and a session on the card
        raises there when there is none. A detector made here takes the
        same device. warm_detection: load the HMM kernels' library at plot
        time, so the first detection pays no build."""
        self.device = device
        self.registry = registry if registry is not None else SweepRegistry()
        self.detector = (detector if detector is not None
                         else BurstDetector(device=device))
        self.warm_detection = warm_detection
        self.config: Optional[SpecConfig] = None
        self.view = ViewSettings()
        # reference state mirror
        self.last_fs: Optional[float] = None
        self.last_f: Optional[np.ndarray] = None
        self.last_t: np.ndarray = np.array([])
        self.last_sxx: Optional[np.ndarray] = None
        self.last_image: Optional[np.ndarray] = None
        self.segment_map: List[SegmentRecord] = []
        self.currently_plotted_items: List[str] = []
        self.last_detected_events: List[Event] = []
        self.rois: List[Event] = []
        self.spec_data_source: Optional[np.ndarray] = None
        self.signal_raw: Optional[np.ndarray] = None
        self.signal_proc: Optional[np.ndarray] = None
        # the reference's last_raw_t[-1]: the combined signal's last sample
        # time, set ONLY by the combine branch (PlotEngine.py:200, cleared
        # :75) — it gates the stretch-x-to-signal-duration axis policy
        # (plot_extra:91-92, _plot_spectrogram:139-143); non-combined plots
        # clip x to the spectrogram's t[-1]
        self.last_signal_t_end: Optional[float] = None
        # plot-time PSD reuse for detection: (source identity, effective
        # config, fs, full freq axis, frame times, device PSD) — see
        # _compute_spectrogram / _features
        self._psd_cache = None

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------

    def load(self, filepath: str) -> List[str]:
        return self.registry.load_file(filepath)

    # ------------------------------------------------------------------
    # Plot path (GUI.plot_selected + PlotEngine.plot_sweeps semantics)
    # ------------------------------------------------------------------

    def clear(self) -> None:
        """PlotEngine.clear (:68-76)."""
        self.segment_map.clear()
        self.currently_plotted_items.clear()
        self.last_detected_events = []
        self.rois = []
        self.last_t = np.array([])
        self.last_fs = None
        self.last_sxx = None
        self.last_image = None
        self.spec_data_source = None
        self.signal_raw = None
        self.signal_proc = None
        self.last_signal_t_end = None
        self._psd_cache = None

    def plot_sweeps(self, names: Sequence[str],
                    config: Optional[SpecConfig] = None,
                    view: Optional[ViewSettings] = None,
                    global_max: Optional[float] = None
                    ) -> Optional[SpectrogramResult]:
        """Compose sweeps and compute the spectrogram.

        Mirrors GUI.plot_selected validation (:392-418: authoritative fs from
        the registry; mixed sampling rates rejected) + PlotEngine.plot_sweeps
        (:147-213: combine concatenation, segment-map provenance,
        processed-over-raw source preference).
        """
        if not names:
            raise ValueError("no sweeps selected")
        if config is not None:
            self.config = config
        if self.config is None:
            self.config = SpecConfig.scipy_default()
        if view is not None:
            self.view = view
        v = self.view

        self.clear()
        self.currently_plotted_items = list(names)

        infos = []
        fs_set = set()
        for name in names:
            entry = self.registry.data.get(name)
            if entry is None:
                known = self.registry.names()
                raise ValueError(
                    f"unknown sweep {name!r}; loaded sweeps: "
                    f"{known[:12]}{'...' if len(known) > 12 else ''}")
            # entry.fs for EVERY signal, including raw ones whose fs_raw
            # differs: GUI.plot_selected:393-414 takes manager.data[name]
            # ['fs'] as the source of truth (so the mixed-rate guard below
            # also only sees entry.fs, GUI.py:401/416-418). The batch
            # exporter is the one reference path that honors fs_raw
            # (ExportManager.py:159-164), mirrored in api/export.py.
            fs = entry.fs
            infos.append((name, entry.raw, entry.processed, fs))
            fs_set.add(fs)
        if len(fs_set) > 1:  # GUI.py:416-418
            raise ValueError(f"Mixed sampling rates: {sorted(fs_set)}")
        fs0 = infos[0][3]

        sig_raw_plot = sig_proc_plot = None
        if v.combine:
            use_proc = v.draw_proc  # PlotEngine.py:167
            offset = 0.0
            pieces = []
            any_proc = any(p is not None for _, _, p, _ in infos)
            for name, raw, proc, fs in infos:
                proc_eff = proc if proc is not None else raw
                sig = proc_eff if use_proc else raw
                if sig is None:
                    continue
                dur = len(sig) / fs
                self.segment_map.append(SegmentRecord(offset, offset + dur, name))
                pieces.append(np.asarray(sig))
                offset += dur
            if pieces:
                final = np.concatenate(pieces)
                if use_proc and any_proc:
                    sig_proc_plot = final
                else:
                    sig_raw_plot = final
                if len(final) > 1:  # PlotEngine.py:200 (len(last_raw_t)>1)
                    self.last_signal_t_end = (len(final) - 1) / fs0
        else:  # first sweep only (PlotEngine.py:203-206)
            name, raw, proc, fs = infos[0]
            sig_raw_plot = raw if v.draw_raw else None
            sig_proc_plot = proc if v.draw_proc else None

        self.signal_raw, self.signal_proc = sig_raw_plot, sig_proc_plot
        self.last_fs = fs0

        # spectrogram source selection: PROC wins over RAW (PlotEngine.py:95-99)
        source = None
        if v.mode_proc in ("Spectrogram", "Both") and sig_proc_plot is not None:
            source = sig_proc_plot
        elif v.mode_raw in ("Spectrogram", "Both") and sig_raw_plot is not None:
            source = sig_raw_plot
        # headless default: if no mode requests a spectrogram, still compute
        # from whatever is available (proc preferred), since detection and
        # export need it
        if source is None:
            source = sig_proc_plot if sig_proc_plot is not None else sig_raw_plot
        if source is None:
            return None
        self.spec_data_source = np.asarray(source, np.float32)
        result = self._compute_spectrogram(global_max)
        self._maybe_trim()
        return result

    def _compute_spectrogram(self, global_max: Optional[float] = None
                             ) -> SpectrogramResult:
        """PlotEngine._plot_spectrogram compute portion (:110-131)."""
        cfg, fs = self.config, self.last_fs
        # scipy shrinks nperseg to the signal length for short signals
        # (one-frame spectrogram, like the reference GUI) instead of
        # returning an empty one
        cfg = effective_config(cfg, len(self.spec_data_source))
        f = freq_axis(cfg, fs)
        t = time_axis(cfg, fs, len(self.spec_data_source))
        if cfg.n_mels:
            f_disp = mel_centers(cfg.n_mels, fs, cfg.mel_fmin, cfg.mel_fmax,
                                 cfg.mel_htk)
        else:
            f_disp = f
        x = torch.as_tensor(self.spec_data_source,
                            device=resolve_device(self.device))

        fast = t.size > 0
        band = None
        if fast:
            try:
                band = band_row_slice(f_disp, cfg.fmin, cfg.fmax)
            except ValueError:
                # empty band (reference early-return, PlotEngine.py:122-124)
                # or a non-contiguous two-sided mask: legacy host path
                fast = False

        if fast:
            # one device-to-host copy (the stacked display pair); the full
            # PSD never leaves the device
            psd, packed = _plot_program(x, fs, cfg, band, global_max)
            arr = packed.cpu().numpy()
            sxx, img = arr[0], arr[1]
            if band is not None:
                f_disp = f_disp[band[0]:band[1]]
            # validate the PSD (not the image: nan_to_num in the dB map
            # and the global-max clip both launder inf into finite
            # pixels) BEFORE caching or publishing anything — a raise
            # leaves the session in the cleared at-plot-start state with
            # no overflowed PSD in the detection cache
            self._check_power_health(sxx)
            self._store_psd_cache(cfg, fs, f, t, psd)
            self.last_f, self.last_t, self.last_sxx = f_disp, t, sxx
            self.last_image = img
            if self.warm_detection:
                self.detector.warmup()
            return SpectrogramResult(f_disp, t, sxx, img)

        # legacy host-mask path: zero frames, an empty band, or a
        # non-contiguous (two-sided fftfreq) mask
        psd = _power(x, fs, cfg)  # (T, F)
        psd_full = psd            # pre-mel, for the detection cache
        if cfg.n_mels:
            psd = _mel_rows(psd, mel_filterbank(
                cfg.n_mels, psd.shape[-1], fs, cfg.mel_fmin, cfg.mel_fmax,
                cfg.mel_htk))
        f_full = f  # pre-mask/pre-mel rfft axis, paired with psd_full
        f = f_disp  # mel centers when a mel stage ran, rfft bins otherwise
        sxx = psd.cpu().numpy().T  # freq-major
        if cfg.fmin is not None or cfg.fmax is not None:
            f, sxx = mask_band_rows(f, sxx, cfg.fmin, cfg.fmax)
        if sxx.size == 0:  # PlotEngine.py:122-124
            self._store_psd_cache(cfg, fs, f_full, t, psd_full)
            self.last_f, self.last_sxx = f, sxx
            self.last_t = np.array([])
            self.last_image = None
            return SpectrogramResult(f, np.array([]), sxx,
                                     np.zeros_like(sxx))
        # validate the PSD before caching or publishing (see the fast path)
        self._check_power_health(sxx)
        img = normalize(torch.as_tensor(np.ascontiguousarray(sxx),
                                        device=x.device),
                        cfg.log_scale, global_max).cpu().numpy()
        self._store_psd_cache(cfg, fs, f_full, t, psd_full)
        self.last_f, self.last_t, self.last_sxx = f, t, sxx
        self.last_image = img
        if self.warm_detection:
            self.detector.warmup()
        return SpectrogramResult(f, t, sxx, img)

    def _check_power_health(self, sxx: np.ndarray) -> None:
        """Refuse a plot whose PSD was wrecked by float32 overflow or
        underflow.

        The reference computes in float64 throughout, where no plausible
        recording overflows. The port computes in float64 too but stores
        a float32 PSD, so |X|² of waveform amplitudes around 1e19 lands as
        inf, and everything downstream of the inf is silent garbage: the
        linear normalize renders inf/inf = NaN pixels, the dB map's
        nan_to_num and the global-max clip launder the inf into
        finite-but-wrong pixels, and the band-power ratios go inf/inf.
        Checking the PSD itself (not the image) catches all of those.
        Non-finite SAMPLES propagate exactly like the reference's (they
        pass through untouched), while a non-finite PSD from an all-finite
        waveform can only be the float32 store: raise with the fix, which
        is lossless for every normalized output (display image, detected
        events and relative band powers are unit-invariant; power-of-two
        prescaling is bitwise exact)."""
        if sxx.size and not np.isfinite(sxx).all() \
                and np.isfinite(self.spec_data_source).all():
            amax = float(np.abs(self.spec_data_source).max())
            raise ValueError(
                f"spectral power overflows float32 (waveform amplitude "
                f"~{amax:.3g}): rescale the recording by a power of two "
                f"(e.g. x * 2**-40) before loading — the normalized "
                f"display, detected events and relative band powers are "
                f"invariant to the unit change")
        # The symmetric failure: |X|^2 of a tiny-but-real waveform
        # (amplitude below ~1e-19) underflows the float32 store to exact
        # zero, and the degenerate-normalize gate then renders an all-zero
        # image with all-zero band ratios — silently, where the
        # reference's float64 succeeds. Only TOTAL underflow diverges: a
        # partially underflowed PSD renders identically under the 1e-12
        # display floor and the min-max rescale. Gate on a tiny nonzero
        # DETRENDED amplitude so signals that legitimately zero out (true
        # digital silence, pure DC under constant detrend) keep their
        # reference-faithful zeros image.
        if sxx.size and not sxx.any() \
                and np.isfinite(self.spec_data_source).all():
            x = self.spec_data_source
            adet = float(np.abs(x - x.mean(dtype=np.float64)).max())
            if 0.0 < adet < 1e-10:
                raise ValueError(
                    f"spectral power underflows float32 (waveform "
                    f"amplitude ~{adet:.3g}): rescale the recording by a "
                    f"power of two (e.g. x * 2**80) before loading — the "
                    f"normalized display, detected events and relative "
                    f"band powers are invariant to the unit change")

    def _store_psd_cache(self, cfg, fs, f, t, psd) -> None:
        """Keep the pre-mask/pre-mel PSD on the device for detection:
        _features needs exactly this tensor (the reference recomputes the
        spectrogram per detect, PlotEngine.py:232). Capped so a
        pathological plot cannot pin unbounded device memory; above the
        cap detection recomputes on the device."""
        if psd.numel() <= 64 * 1024 * 1024:
            self._psd_cache = (self.spec_data_source, cfg, fs, f, t, psd)
        else:
            self._psd_cache = None

    # ------------------------------------------------------------------
    # Detection (PlotEngine.py:244-473 flows via BurstDetector)
    # ------------------------------------------------------------------

    def _features(self):
        if self.spec_data_source is None:
            raise ValueError("Please plot a spectrogram before detecting.")
        # the SAME shrunk config the plot used (scipy short-signal
        # auto-shrink): detection must compute features on the frames the
        # user sees, not zero frames from the unshrunk nperseg
        cfg = effective_config(self.config, len(self.spec_data_source))
        fs = self.last_fs
        cache = self._psd_cache
        if (cache is not None and cache[0] is self.spec_data_source
                and cache[1] == cfg and cache[2] == fs):
            _, _, _, f, t, psd = cache  # plot-time PSD, still on the device
        else:
            psd = _power(torch.as_tensor(self.spec_data_source,
                                         device=resolve_device(self.device)),
                         fs, cfg)
            f = freq_axis(cfg, fs)
            t = time_axis(cfg, fs, len(self.spec_data_source))
        fmin = cfg.fmin if cfg.fmin is not None else 0.0
        fmax = cfg.fmax if cfg.fmax is not None else float(f[-1])
        feat = ev.features_from_psd(f, psd, fmin, fmax).cpu().numpy()
        return t, feat

    def unsupervised_detect(self) -> List[Event]:
        t, feat = self._features()
        self.last_detected_events = self.detector.unsupervised_detect(t, feat)
        self._maybe_trim()
        return self.last_detected_events

    def learn_and_detect(self, rois: Optional[Sequence[Event]] = None
                         ) -> List[Event]:
        if rois is None:
            rois = self.rois
        if not rois:
            raise ValueError("No manual regions provided to learn from.")
        t, feat = self._features()
        self.last_detected_events = self.detector.learn_and_detect(
            t, feat, rois)
        self._maybe_trim()
        return self.last_detected_events

    @staticmethod
    def _maybe_trim() -> None:
        """Opt-in memory backstop (SPECTRAL_TPU_MAX_RSS_MB): long sessions
        exploring many configs grow the per-config constant caches;
        utils/memory.py drops them when RSS crosses the threshold."""
        from spectral_tpu_torch.utils.memory import maybe_trim_caches
        maybe_trim_caches()

    def reset_model(self) -> None:
        self.detector.reset()

    # ------------------------------------------------------------------
    # ROI editing (pure-function ops over session state)
    # ------------------------------------------------------------------

    def min_roi_width(self) -> float:
        """One sample period (PlotEngine.py:627-631)."""
        if self.last_fs:
            return 1.0 / self.last_fs
        return 0.01

    def add_roi(self, start: float, end: float) -> List[Event]:
        self.rois = ev.add_roi(self.rois, start, end, self.min_roi_width())
        self.last_detected_events = ev.add_roi(
            self.last_detected_events, start, end, self.min_roi_width())
        return self.rois

    def delete_roi(self, roi: Event) -> List[Event]:
        """Deliberate deviation from the reference: its Delete removes the
        PATCH only (remove_patch, PlotEngine.py:647-653) and never touches
        last_detected_events, so a deleted burst still appears in a later
        CSV export while learning (which reads the patches) excludes it.
        Here both lists drop the event, keeping export/learn/redraw
        consistent, as the JAX package does."""
        self.rois = ev.delete_roi(self.rois, roi)
        self.last_detected_events = ev.delete_roi(self.last_detected_events, roi)
        return self.rois

    def merge_rois(self, container: Event) -> List[Event]:
        # NO outer sort: a no-op merge (nothing contained) leaves the list
        # order untouched in the reference (PlotEngine.py:578-580 early
        # return); only a fired merge sorts (:598, which
        # merge_contained_rois reproduces). The hover scan is first-match
        # in insertion order (:524-529), so a re-sort would change which
        # container a later Merge acts on.
        self.last_detected_events = ev.merge_contained_rois(
            self.last_detected_events, container)
        self.rois = list(self.last_detected_events)
        return self.rois

    # ------------------------------------------------------------------
    # Analytics (PlotEngine.py:686-719)
    # ------------------------------------------------------------------

    def calculate_absolute_power(self) -> Optional[float]:
        if self.last_sxx is None:
            return None
        return ev.absolute_power(self.last_sxx)

    def calculate_band_powers(self, bands=None) -> Optional[Dict[str, float]]:
        if self.last_sxx is None or self.last_f is None:
            return None
        return ev.band_powers(self.last_f, self.last_sxx, bands)

    # ------------------------------------------------------------------
    # Export (delegates; see spectral_tpu_torch.api.export)
    # ------------------------------------------------------------------

    def export_csv(self, filepath: str) -> str:
        from spectral_tpu_torch.api import export
        return export.export_events_csv(filepath, self)

    def export_png(self, filepath: str, colormap: str = "jet",
                   compress_level: int = 4) -> str:
        from spectral_tpu_torch.api import export
        return export.export_spectrogram_png(filepath, self, colormap,
                                             compress_level)

    def export_batch_png(self, out_dir: str, names: Sequence[str],
                         use_proc: bool = False, use_raw: bool = True,
                         **kw) -> str:
        from spectral_tpu_torch.api import export
        return export.export_batch_signals_png(out_dir, self.registry, names,
                                               use_proc=use_proc,
                                               use_raw=use_raw,
                                               device=self.device, **kw)

    # ------------------------------------------------------------------
    # Persistence (checkpoint/resume — absent in the reference, SURVEY §5)
    # ------------------------------------------------------------------

    def save_state(self, filepath: str) -> None:
        """Serialize model params + events + config to an .npz, plus the
        provenance context (segment map + plotted items) so a CSV export
        after load_state keeps its combined-plot source attribution
        (ExportManager.py:55-64) instead of degrading to 'Unknown'. The
        format is the JAX package's: a state saved by either package loads
        in the other."""
        payload = {
            "events": np.asarray(self.last_detected_events, dtype=np.float64
                                 ).reshape(-1, 2),
            "rois": np.asarray(self.rois, dtype=np.float64).reshape(-1, 2),
            "is_model_refined": np.asarray(self.detector.is_model_refined),
            "config_json": np.asarray(
                self.config.to_json() if self.config else ""),
            "segment_spans": np.asarray(
                [[s.start_time_combined, s.end_time_combined]
                 for s in self.segment_map], dtype=np.float64).reshape(-1, 2),
            "segment_names": np.asarray(
                [s.source_name for s in self.segment_map], dtype=np.str_),
            "plotted_items": np.asarray(self.currently_plotted_items,
                                        dtype=np.str_),
        }
        if self.detector.params is not None:
            p = self.detector.params
            payload.update(
                (f"hmm_{k}", v.detach().cpu().numpy())
                for k, v in zip(HMMParams._fields, p))
        np.savez(filepath, **payload)

    def load_state(self, filepath: str) -> None:
        z = np.load(filepath, allow_pickle=False)
        self.last_detected_events = [tuple(r) for r in z["events"]]
        self.rois = [tuple(r) for r in z["rois"]]
        if "segment_spans" in z:  # absent in older state files
            self.segment_map = [
                SegmentRecord(float(a), float(b), str(n))
                for (a, b), n in zip(z["segment_spans"], z["segment_names"])]
            self.currently_plotted_items = [str(n)
                                            for n in z["plotted_items"]]
        self.detector.is_model_refined = bool(z["is_model_refined"])
        cfg_json = str(z["config_json"])
        if cfg_json:
            self.config = SpecConfig.from_json(cfg_json)
        if "hmm_means" in z:
            dev = detection_device(self.detector.device)
            self.detector.params = HMMParams(*(
                torch.as_tensor(np.asarray(z[f"hmm_{k}"], np.float64),
                                device=dev)
                for k in HMMParams._fields))
