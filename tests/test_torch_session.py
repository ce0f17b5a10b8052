"""The port's interactive session (spectral_tpu_torch.api.session and
api/export) on the CPU, held against the JAX package's AnalysisSession:
the session blocks of tests/test_api.py, each run through both packages on
the same seeded numpy inputs.

Tolerances (tests/test_torch_pipeline.py's):
- f and t equal exactly;
- sxx within PSD_TOL = 5e-6 of the plot's PSD max (the JAX side's float32
  transforms against the port's float64);
- the log image's error times the image's dB range within DB_TOL = 5e-3
  dB, the budget the JAX package's golden test gives its float32 routes
  against scipy float64; a linear image within PSD_TOL;
- events, CSV bytes and PNG bytes equal exactly (the PNGs from the same
  image: a pixel within the tolerances above may cross a 1/256 LUT edge).
"""

import csv
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spectral_tpu import config as jconfig  # noqa: E402
from spectral_tpu.api import export as jexport  # noqa: E402
from spectral_tpu.api import session as jsession  # noqa: E402
from spectral_tpu.io import registry as jreg  # noqa: E402
from spectral_tpu.native import png_native as jnative  # noqa: E402
from spectral_tpu_torch import SpecConfig, ViewSettings  # noqa: E402
from spectral_tpu_torch.api import export as texport  # noqa: E402
from spectral_tpu_torch.api import session as tsession  # noqa: E402
from spectral_tpu_torch.io import registry as treg  # noqa: E402
from spectral_tpu_torch.io.wav import write_wav  # noqa: E402
from spectral_tpu_torch.native import png_native as tnative  # noqa: E402
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402
from spectral_tpu_torch.ops.colormap import (apply_colormap_packed,  # noqa: E402
                                             unpack_rgba)
from spectral_tpu_torch.render.png import decode_png  # noqa: E402

PSD_TOL = 5e-6
DB_TOL = 5e-3


def _jcfg(cfg):
    return None if cfg is None else jconfig.SpecConfig.from_json(
        cfg.to_json())


def _jview(view):
    return None if view is None else jconfig.ViewSettings(
        **dataclasses.asdict(view))


def _bursty(fs=1000.0, dur=60.0, bursts=((10, 15), (30, 38)), seed=0):
    rng = np.random.RandomState(seed)
    n = int(fs * dur)
    t = np.arange(n) / fs
    x = 0.02 * rng.randn(n)
    for a, b in bursts:
        m = (t >= a) & (t < b)
        x[m] += 0.6 * np.hanning(m.sum()) * np.sin(2 * np.pi * 6.0 * t[m])
    return x.astype(np.float32)


class Pair:
    """A port session on the CPU and a JAX session over the same
    registry contents; each call runs on both."""

    def __init__(self, **kw):
        self.t = tsession.AnalysisSession(device="cpu", warm_detection=False,
                                          **kw)
        self.j = jsession.AnalysisSession(warm_detection=False, **kw)

    def register(self, name, filepath, sweep_idx, fs, fs_raw, raw, proc):
        for s, entry in ((self.t, treg.SweepEntry), (self.j,
                                                     jreg.SweepEntry)):
            s.registry.register(name, entry(filepath=filepath,
                                            sweep_idx=sweep_idx, fs=fs,
                                            fs_raw=fs_raw, raw=raw,
                                            processed=proc))

    def plot(self, names, cfg=None, view=None, **kw):
        rt = self.t.plot_sweeps(names, cfg, view, **kw)
        rj = self.j.plot_sweeps(names, _jcfg(cfg), _jview(view), **kw)
        return rt, rj

    def both(self, method, *args):
        return (getattr(self.t, method)(*args),
                getattr(self.j, method)(*args))


def _sweeps(n_sweeps=2, fs=1000.0, dur=30.0):
    p = Pair()
    for i in range(n_sweeps):
        x = _bursty(fs=fs, dur=dur, bursts=((5, 9),), seed=i)
        p.register(f"rec_sweep{i}", "rec.h5", i, fs, fs, x, x * 0.5)
    return p


def _long(n_sweeps=1):
    p = _sweeps(n_sweeps, dur=60.0)
    x = _bursty(dur=60.0)
    for i in range(n_sweeps):
        for s in (p.t, p.j):
            s.registry.data[f"rec_sweep{i}"].raw = x
            s.registry.data[f"rec_sweep{i}"].processed = None
    return p


def _same_plot(rt, rj, log_scale):
    assert np.array_equal(rt.f, rj.f) and np.array_equal(rt.t, rj.t)
    assert rt.sxx.shape == rj.sxx.shape and rt.image.shape == rj.image.shape
    assert rt.sxx.dtype == rt.image.dtype == np.float32
    if rj.sxx.size == 0:
        return
    scale = float(np.nanmax(np.abs(rj.sxx)))
    assert np.array_equal(np.isnan(rt.sxx), np.isnan(rj.sxx))
    assert np.nanmax(np.abs(rt.sxx - rj.sxx)) <= PSD_TOL * scale
    assert np.array_equal(np.isnan(rt.image), np.isnan(rj.image))
    both = ~np.isnan(rj.image)
    if not both.any():
        return
    err = np.max(np.abs(rt.image[both] - rj.image[both]))
    p = rj.sxx[rj.sxx > 0].astype(np.float64)
    if log_scale and p.size:
        err *= 10 * np.log10(p.max() / p.min())
        assert err <= DB_TOL, err
    elif log_scale:
        assert err == 0.0, err
    else:
        assert err <= PSD_TOL, err


# ---- plotting --------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    SpecConfig.scipy_default(512, fmin=0.0, fmax=30.0),
    SpecConfig.scipy_default(512, fmin=2.0, fmax=40.0, log_scale=True),
    SpecConfig.north_star(256, 64, log_scale=True),
], ids=["band_linear", "band_log", "north_star_log"])
def test_plot_single_sweep_and_analytics(cfg):
    p = _sweeps()
    rt, rj = p.plot(["rec_sweep0"], cfg, ViewSettings())
    _same_plot(rt, rj, cfg.log_scale)
    assert rt.image.min() >= 0 and rt.image.max() <= 1
    a, b = p.both("calculate_absolute_power")
    assert a == pytest.approx(rt.total_power) and a == pytest.approx(
        b, rel=PSD_TOL)
    bt, bj = p.both("calculate_band_powers")
    assert list(bt) == list(bj)
    assert np.allclose(list(bt.values()), list(bj.values()), atol=PSD_TOL)


def test_combine_segment_map_and_source_precedence():
    p = _sweeps(3, dur=10.0)
    names = [f"rec_sweep{i}" for i in range(3)]
    rt, rj = p.plot(names, SpecConfig.scipy_default(512),
                    ViewSettings(combine=True, mode_proc="Spectrogram"))
    _same_plot(rt, rj, False)
    assert [dataclasses.astuple(s) for s in p.t.segment_map] == \
        [dataclasses.astuple(s) for s in p.j.segment_map]
    assert p.t.segment_map[1].start_time_combined == pytest.approx(10.0)
    assert p.t.last_signal_t_end == p.j.last_signal_t_end
    assert np.array_equal(p.t.spec_data_source, p.j.spec_data_source)
    assert np.abs(p.t.spec_data_source).max() < 0.5
    # PROC wins over RAW (PlotEngine.py:95-99); only RAW asks -> RAW
    for view, loud in ((ViewSettings(mode_raw="Spectrogram",
                                     mode_proc="Spectrogram"), False),
                       (ViewSettings(mode_raw="Both", mode_proc="Signal"),
                        True)):
        rt, rj = p.plot(["rec_sweep0"], SpecConfig.scipy_default(512), view)
        _same_plot(rt, rj, False)
        assert np.array_equal(p.t.spec_data_source, p.j.spec_data_source)
        assert (np.abs(p.t.spec_data_source).max() > 0.5) == loud


def test_refusals_match_jax():
    p = _sweeps(1)
    x = np.zeros(100, np.float32)
    p.register("other_sweep0", "o", 0, 2000.0, 2000.0, x, None)
    cases = [(["rec_sweep0", "other_sweep0"], "Mixed sampling rates"),
             ([], "no sweeps selected"),
             (["nope"], "unknown sweep 'nope'.*rec_sweep0")]
    for names, match in cases:
        msgs = []
        for s, cfg, view in ((p.t, SpecConfig.scipy_default(256),
                              ViewSettings(combine=True)),
                             (p.j, _jcfg(SpecConfig.scipy_default(256)),
                              _jview(ViewSettings(combine=True)))):
            with pytest.raises(ValueError, match=match) as e:
                s.plot_sweeps(names, cfg, view)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_short_signal_shrinks_nperseg_and_misuse_defaults(tmp_path):
    """scipy's short-signal shrink (one frame, not an empty plot), and the
    out-of-order calls: the reference's friendly errors, None queries and
    the config=None / view=None defaults."""
    p = Pair()
    for s in (p.t, p.j):
        with pytest.raises(ValueError, match="plot a spectrogram"):
            s.unsupervised_detect()
        with pytest.raises(ValueError, match="No manual regions"):
            s.learn_and_detect()
        assert s.calculate_band_powers() is None
        assert s.min_roi_width() == 0.01
        assert s.export_csv(str(tmp_path / "x.csv")).startswith("Error")
        assert s.export_png(str(tmp_path / "x.png")).startswith("Error")
        assert s.merge_rois((0.0, 1.0)) == []
    x = np.random.default_rng(0).standard_normal(4000).astype(np.float32)
    p.register("rec_sweep0", "f", 0, 1000.0, 1000.0, x, None)
    p.register("short_sweep0", "f", 0, 1000.0, 1000.0, x[:300], None)
    rt, rj = p.plot(["rec_sweep0"])
    _same_plot(rt, rj, False)
    assert p.t.config == SpecConfig.scipy_default()
    assert rt.sxx.shape[0] == 513
    assert p.t.min_roi_width() == 1.0 / 1000.0
    with pytest.warns(UserWarning, match="using nperseg = 300"):
        rt, rj = p.plot(["short_sweep0"], SpecConfig.scipy_default(
            1024, log_scale=True))
    _same_plot(rt, rj, True)
    assert rt.sxx.shape == (151, 1)


def test_band_edges_empty_twosided_and_dataless():
    """The legacy host-mask path: an empty band (the reference's early
    return), a two-sided spectrum's non-contiguous mask, entries with no
    data."""
    p = _sweeps()
    rt, rj = p.plot(["rec_sweep0"], SpecConfig.scipy_default(
        512, fmin=600.0, fmax=700.0), ViewSettings())
    assert rt.t.size == 0 and p.t.last_t.size == 0 and p.t.last_image is None
    assert rt.sxx.shape == rj.sxx.shape == (0, 66)
    cfg = SpecConfig(nperseg=256, onesided=False, fmin=-50.0, fmax=50.0,
                     detrend="constant")
    rt, rj = p.plot(["rec_sweep0"], cfg, ViewSettings())
    _same_plot(rt, rj, False)
    assert rt.sxx.shape[0] == int(((np.fft.fftfreq(256, 1e-3) >= -50) & (
        np.fft.fftfreq(256, 1e-3) <= 50)).sum())
    p.register("empty_sweep0", "f", 0, 1000.0, 1000.0, None, None)
    for view in (ViewSettings(), ViewSettings(combine=True)):
        assert p.plot(["empty_sweep0"], SpecConfig(nperseg=256),
                      view) == (None, None)
    rt, rj = p.plot(["empty_sweep0", "rec_sweep1"], SpecConfig(nperseg=256),
                    ViewSettings(combine=True))
    _same_plot(rt, rj, False)
    assert [s.source_name for s in p.t.segment_map] == ["rec_sweep1"]


@pytest.mark.parametrize("cfg", [
    SpecConfig.scipy_default(512, fmin=2.0, fmax=40.0, log_scale=True),
    dataclasses.replace(SpecConfig.north_star(256, 64, log_scale=True),
                        n_mels=32, fmin=20.0, fmax=400.0),
], ids=["band", "mel_band"])
def test_legacy_host_path_matches_the_plot_program(cfg, monkeypatch):
    """The plot program (band and mel on the device, one copy to the host)
    against the legacy host-mask flow, forced by making band_row_slice
    refuse, and both against JAX; the mel rows of the band alone."""
    p = _sweeps()
    rt, rj = p.plot(["rec_sweep0"], cfg, ViewSettings())
    _same_plot(rt, rj, True)
    if cfg.n_mels:
        assert 0 < rt.sxx.shape[0] < 32

    def refuse(*a, **kw):
        raise ValueError("forced legacy path")

    monkeypatch.setattr(tsession, "band_row_slice", refuse)
    s = tsession.AnalysisSession(device="cpu", warm_detection=False)
    s.registry = p.t.registry
    r2 = s.plot_sweeps(["rec_sweep0"], cfg, ViewSettings())
    assert np.array_equal(r2.f, rt.f) and np.array_equal(r2.t, rt.t)
    assert np.array_equal(r2.sxx, rt.sxx)
    assert np.array_equal(r2.image, rt.image)


def test_mel_branch_and_global_max():
    cfg = SpecConfig.north_star(256, 64, n_mels=48, log_scale=True)
    p = _sweeps()
    rt, rj = p.plot(["rec_sweep0"], cfg, ViewSettings())
    _same_plot(rt, rj, True)
    assert rt.sxx.shape[0] == 48
    rt, rj = p.plot(["rec_sweep0"], cfg, ViewSettings(),
                    global_max=4.0 * float(rj.sxx.max()))
    _same_plot(rt, rj, True)
    cfg = SpecConfig.scipy_default(512)
    rt, rj = p.plot(["rec_sweep0"], cfg, ViewSettings())
    rt, rj = p.plot(["rec_sweep0"], cfg, ViewSettings(),
                    global_max=4.0 * float(rj.sxx.max()))
    _same_plot(rt, rj, False)
    assert rt.image.max() == pytest.approx(0.25, rel=1e-5)


# ---- the float32 store's health check ---------------------------------------

def test_overflow_refused_nan_samples_propagate(tmp_path):
    rng = np.random.default_rng(0)
    big = (1e19 * rng.standard_normal(4096)).astype(np.float32)
    bad = np.zeros(4096, np.float32)
    bad[1000] = np.nan
    p = Pair()
    p.register("ok_sweep0", "f", 0, 1000.0, 1000.0,
               np.sin(0.3 * np.arange(4096)).astype(np.float32), None)
    p.register("big_sweep0", "f", 0, 1000.0, 1000.0, big, None)
    p.register("nan_sweep0", "f", 0, 1000.0, 1000.0, bad, None)
    p.plot(["ok_sweep0"], SpecConfig(nperseg=256), ViewSettings())
    # the guard reads the PSD, so the dB map and the global-max clip
    # cannot launder the inf
    for kwargs, gm in (({}, None), ({"log_scale": True}, None), ({}, 1.0)):
        msgs = []
        for s, cfg in ((p.t, SpecConfig(nperseg=256, **kwargs)),
                       (p.j, _jcfg(SpecConfig(nperseg=256, **kwargs)))):
            with pytest.raises(ValueError, match="power of two") as e:
                s.plot_sweeps(["big_sweep0"], cfg, None, global_max=gm)
            msgs.append(str(e.value))
            assert s.last_image is None
            assert s.export_png("/nonexistent-dir/x.png").startswith("Error")
        assert msgs[0] == msgs[1]
    for cfg in (SpecConfig(nperseg=256), SpecConfig(nperseg=256,
                                                     log_scale=True)):
        rt, rj = p.plot(["nan_sweep0"], cfg, ViewSettings())
        _same_plot(rt, rj, cfg.log_scale)
        assert np.isnan(rt.sxx).any() and not np.isnan(rt.sxx).all()
        # the dB map's nan_to_num clears NaN pixels; the linear map keeps
        assert np.isnan(rt.image).any() == (not cfg.log_scale)


def test_underflow_refused_true_silence_and_dc_kept():
    rng = np.random.default_rng(0)
    tiny = (1e-25 * rng.standard_normal(4096)).astype(np.float32)
    p = Pair()
    p.register("tiny_sweep0", "f", 0, 1000.0, 1000.0, tiny, None)
    p.register("fixed_sweep0", "f", 0, 1000.0, 1000.0, tiny * 2.0 ** 80,
               None)
    p.register("silence_sweep0", "f", 0, 1000.0, 1000.0,
               np.zeros(4096, np.float32), None)
    p.register("dc_sweep0", "f", 0, 1000.0, 1000.0,
               np.full(4096, 0.25, np.float32), None)
    for kwargs in ({"log_scale": True}, {}):
        msgs = []
        for s, cfg in ((p.t, SpecConfig(nperseg=256, **kwargs)),
                       (p.j, _jcfg(SpecConfig(nperseg=256, **kwargs)))):
            with pytest.raises(ValueError,
                               match="underflows.*power of two") as e:
                s.plot_sweeps(["tiny_sweep0"], cfg, None)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    rt, rj = p.plot(["fixed_sweep0"], SpecConfig(nperseg=256))
    _same_plot(rt, rj, False)
    assert rt.image.max() == 1.0
    for name in ("silence_sweep0", "dc_sweep0"):
        for cfg in (SpecConfig(nperseg=256),
                    SpecConfig(nperseg=256, log_scale=True)):
            rt, rj = p.plot([name], cfg)
            assert not rt.sxx.any() and not rj.sxx.any()
            assert not rt.image.any() and not rj.image.any()


# ---- detection, ROIs, band powers -------------------------------------------

def test_detect_reuses_the_plot_psd_and_events_match(monkeypatch):
    calls = {"n": 0}
    real = tsession.stft_psd

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tsession, "stft_psd", counting)
    p = _long()
    cfg = SpecConfig.scipy_default(1024, fmin=0.0, fmax=30.0)
    p.plot(["rec_sweep0"], cfg, ViewSettings())
    assert calls["n"] == 1
    et, ej = p.both("unsupervised_detect")
    assert calls["n"] == 1          # the cached PSD, no second STFT
    assert et == ej and len(et) == 2
    assert p.t.last_detected_events == et
    p.t._psd_cache = None           # the recompute branch: same events
    assert p.t.unsupervised_detect() == et and calls["n"] == 2
    p.t.config = SpecConfig.scipy_default(256, fmin=0.0, fmax=30.0)
    p.j.config = _jcfg(p.t.config)
    et, ej = p.both("unsupervised_detect")
    assert calls["n"] == 3 and et == ej


def test_roi_edits_learn_and_band_powers():
    p = _long()
    p.plot(["rec_sweep0"], SpecConfig.scipy_default(1024, fmin=0.0,
                                                    fmax=30.0),
           ViewSettings())
    assert p.both("add_roi", 17.0, 8.0) == ([(8.0, 17.0)],) * 2
    rt, rj = p.both("add_roi", 28.0, 40.0)
    assert rt == rj == [(8.0, 17.0), (28.0, 40.0)]
    rt, rj = p.both("add_roi", 50.0, 50.0)    # below the min width
    assert rt == rj and len(rt) == 2
    et, ej = p.both("learn_and_detect")
    assert et == ej and len(et) >= 2 and p.t.detector.is_model_refined
    assert p.both("unsupervised_detect")[0] == p.j.last_detected_events
    assert p.both("delete_roi", (8.0, 17.0)) == ([(28.0, 40.0)],) * 2
    assert p.t.last_detected_events == p.j.last_detected_events
    p.both("add_roi", 30.0, 31.0)
    rt, rj = p.both("merge_rois", (27.0, 41.0))
    assert rt == rj
    bt, bj = p.both("calculate_band_powers")
    assert list(bt) == list(bj)
    assert np.allclose(list(bt.values()), list(bj.values()), atol=PSD_TOL)


# ---- exports and state ------------------------------------------------------

def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_csv_bytes_match(tmp_path):
    p = _long()
    p.plot(["rec_sweep0"], SpecConfig.scipy_default(1024, fmin=0.0,
                                                    fmax=30.0),
           ViewSettings())
    p.both("unsupervised_detect")
    a, b = str(tmp_path / "t.csv"), str(tmp_path / "j.csv")
    assert p.t.export_csv(a) == p.j.export_csv(b).replace("j.csv", "t.csv")
    assert "Successfully exported 2 events" in p.t.export_csv(a)
    assert _read(a) == _read(b)
    with open(a) as fh:
        rows = list(csv.reader(fh))
    assert rows[1][1] == "rec" and rows[1][2] == "0" and rows[1][5] == "nan"
    # combined attribution through the segment map
    q = _sweeps(2)
    q.plot(["rec_sweep0", "rec_sweep1"], SpecConfig.scipy_default(512),
           ViewSettings(combine=True))
    for s in (q.t, q.j):
        s.last_detected_events = [(5.0, 9.0), (35.0, 39.0)]
    q.t.export_csv(a)
    q.j.export_csv(b)
    assert _read(a) == _read(b)
    assert [r[2] for r in list(csv.reader(open(a)))[1:]] == ["0", "1"]
    for s in (q.t, q.j):
        s.last_detected_events = []
    assert texport.export_events_csv(a, q.t) == jexport.export_events_csv(
        b, q.j) == "Error: No burst data to export."


def _native_both():
    if not (tnative.available() and jnative.available()):
        pytest.skip("no C++ toolchain with zlib here")


def test_png_exports_bytes_match(tmp_path):
    _native_both()
    p = _sweeps(1)
    rt, rj = p.plot(["rec_sweep0"], SpecConfig.scipy_default(
        512, fmin=0.0, fmax=100.0, log_scale=True), ViewSettings())
    _same_plot(rt, rj, True)
    a, b = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    assert "Successfully" in p.t.export_png(a)
    img = decode_png(a)
    assert img.shape == rt.image.shape + (4,)
    want = unpack_rgba(apply_colormap_packed(torch.from_numpy(rt.image),
                                             flip_rows=True))
    assert np.array_equal(img, want)
    # the same image through both exporters: the same bytes
    p.t.last_image = rj.image
    assert "Successfully" in p.t.export_png(a, "hot", 6)
    assert "Successfully" in p.j.export_png(b, "hot", 6)
    assert _read(a) == _read(b)


def test_batch_png_bytes_match(tmp_path):
    """The reference's shared symmetric y-limit, the raw stream without a
    rate skipped, sanitized names deduplicated: the same files with the
    same bytes."""
    _native_both()
    loud = np.sin(np.linspace(0, 40 * np.pi, 4000)).astype(np.float32)
    regs = (treg.SweepRegistry(), jreg.SweepRegistry())
    for r, E in zip(regs, (treg.SweepEntry, jreg.SweepEntry)):
        r.register("a_sweep0", E("f", 0, 100.0, 100.0, loud, None))
        r.register("b:sweep0", E("f", 1, 100.0, 100.0, loud * 0.5,
                                 loud * 0.25))
        r.register("b_sweep0", E("f", 2, 100.0, 100.0, loud * 0.3, None))
        r.register("norate_sweep0", E("f", 3, 100.0, None, loud, None))
    names = ["a_sweep0", "b:sweep0", "b_sweep0", "norate_sweep0"]
    for kw in (dict(height=200, width=400),
               dict(height=64, width=128, use_proc=True,
                    window_seconds=None)):
        dt, dj = str(tmp_path / "t"), str(tmp_path / "j")
        mt = texport.export_batch_signals_png(dt, regs[0], names,
                                              device="cpu", **kw)
        mj = jexport.export_batch_signals_png(dj, regs[1], names, **kw)
        assert mt.replace(dt, dj) == mj and "Exported 3" in mt
        assert sorted(os.listdir(dt)) == sorted(os.listdir(dj)) == [
            "a_sweep0.png", "b_sweep0.png", "b_sweep0_2.png"]
        for f in os.listdir(dt):
            assert _read(os.path.join(dt, f)) == _read(os.path.join(dj, f))
    a = decode_png(os.path.join(dt, "a_sweep0.png"))
    rows = np.where((a[..., 3] == 255).any(axis=1))[0]
    assert rows.min() < 5 and rows.max() > 58


def test_state_round_trips_across_packages(tmp_path):
    """save_state / load_state in both directions: events, ROIs, config,
    the segment map (so a CSV after loading keeps its attribution) and the
    model."""
    p = _long(2)
    cfg = SpecConfig.scipy_default(1024, fmin=0.0, fmax=30.0)
    p.plot(["rec_sweep0", "rec_sweep1"], cfg, ViewSettings(combine=True))
    p.both("unsupervised_detect")
    p.both("add_roi", 3.0, 4.0)
    paths = {}
    for key, s in (("t", p.t), ("j", p.j)):
        paths[key] = str(tmp_path / f"{key}.npz")
        s.save_state(paths[key])
    for src, dst in (("j", tsession.AnalysisSession(device="cpu")),
                     ("t", jsession.AnalysisSession()),
                     ("t", tsession.AnalysisSession(device="cpu"))):
        s = p.t if src == "t" else p.j
        dst.load_state(paths[src])
        assert dst.config.to_json() == cfg.to_json()
        assert dst.last_detected_events == s.last_detected_events
        assert dst.rois == s.rois
        assert [dataclasses.astuple(r) for r in dst.segment_map] == \
            [dataclasses.astuple(r) for r in s.segment_map]
        assert dst.detector.is_model_refined == s.detector.is_model_refined
        for a, b in zip(dst.detector.params, s.detector.params):
            a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)
        c1, c2 = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
        assert "Successfully" in texport.export_events_csv(c1, p.t)
        exporter = (texport if isinstance(dst, tsession.AnalysisSession)
                    else jexport)
        assert "Successfully" in exporter.export_events_csv(c2, dst)
        assert _read(c1) == _read(c2) and b"Unknown" not in _read(c2)
    assert isinstance(tsession.AnalysisSession(device="cpu").detector.params,
                      type(None))


def test_the_whole_slice_load_plot_detect_export(tmp_path):
    """The reference app's flow on one WAV: load through the registry,
    plot, detect, ROI edit, band powers, CSV and PNG exports and the state,
    through both packages; the port on the CPU launches no kernel."""
    fs = 1000.0
    x = _bursty(fs=fs, dur=90.0, bursts=((12, 20), (41, 47), (70, 78)),
                seed=3)
    path = str(tmp_path / "rec.wav")
    write_wav(path, x, fs)
    p = Pair()
    assert p.both("load", path) == (["rec_sweep0"],) * 2
    before = dict(stft_cuda.launches)
    cfg = SpecConfig.scipy_default(1024, fmin=0.0, fmax=30.0, log_scale=True)
    rt, rj = p.plot(["rec_sweep0"], cfg, ViewSettings())
    _same_plot(rt, rj, True)
    et, ej = p.both("unsupervised_detect")
    assert et == ej and len(et) == 3
    p.both("add_roi", 80.0, 85.0)
    assert p.t.last_detected_events == p.j.last_detected_events
    bt, bj = p.both("calculate_band_powers")
    assert np.allclose(list(bt.values()), list(bj.values()), atol=PSD_TOL)
    for method, name in (("export_csv", "b.csv"), ("export_png", "s.png"),
                         ("save_state", "s.npz")):
        for s, d in ((p.t, "t"), (p.j, "j")):
            os.makedirs(tmp_path / d, exist_ok=True)
            getattr(s, method)(str(tmp_path / d / name))
    assert _read(tmp_path / "t" / "b.csv") == _read(tmp_path / "j" / "b.csv")
    assert decode_png(str(tmp_path / "t" / "s.png")).shape == \
        rt.image.shape + (4,)
    assert stft_cuda.launches == before
