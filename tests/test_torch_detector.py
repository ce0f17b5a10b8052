"""The port's detection flows (spectral_tpu_torch.models.detector and
models.batch, device='cpu': the plain versions) held against the JAX
package's (spectral_tpu.models.detector, spectral_tpu.models.batch) and
against the float64 oracle flow of tests/test_hmmlearn_parity.py, on the
fixtures of tests/test_detector.py and tests/test_hmmlearn_parity.py.

Tolerances: event lists equal exactly (the same float times), refusals
with the same messages. The features fed to both packages are the same
float32 arrays, except in the waveform-to-events flow, where each package
computes its own (within the features' float32 tolerance) and the events
must still be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spectral_tpu.config import SpecConfig as JConfig  # noqa: E402
from spectral_tpu.core import events as jev  # noqa: E402
from spectral_tpu.models import batch as jbatch  # noqa: E402
from spectral_tpu.models import hmm as jhmm  # noqa: E402
from spectral_tpu.models.detector import BurstDetector as JDetector  # noqa: E402
from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.core import events as tev  # noqa: E402
from spectral_tpu_torch.core.stft import (freq_axis,  # noqa: E402
                                          power_spectrogram, time_axis)
from spectral_tpu_torch.models import batch, hmm  # noqa: E402
from spectral_tpu_torch.models.detector import BurstDetector  # noqa: E402
from test_detector import _bursty_signal, _features  # noqa: E402
from test_hmmlearn_parity import HmmlearnOracle, _synthetic_features  # noqa: E402

FS = 1000.0


def _det(**kw):
    return BurstDetector(device="cpu", **kw)


@pytest.fixture(scope="module")
def eeg():
    """tests/test_detector.py's bursty EEG fixture through the JAX
    package's features (t, features)."""
    x = _bursty_signal(fs=FS)
    return _features(x, FS, JConfig.scipy_default(1024), 0.0, 30.0)


def test_unsupervised_detect_equals_jax(eeg):
    t, feat = eeg
    want = JDetector(seed=42).unsupervised_detect(t, feat)
    det = _det(seed=42)
    got = det.unsupervised_detect(t, feat)
    assert got == want and len(got) == 2
    assert not det.is_model_refined
    assert det.unsupervised_detect(t, torch.from_numpy(feat.copy())) == got
    assert det.timings["iterations"] >= 1


def test_learn_and_detect_equals_jax(eeg):
    t, feat = eeg
    rois = [(8.0, 17.0), (28.0, 40.0)]
    jd, td = JDetector(seed=42), _det(seed=42)
    assert td.learn_and_detect(t, feat, rois) == jd.learn_and_detect(t, feat,
                                                                     rois)
    assert td.is_model_refined
    # the refined model decodes without refitting, as JAX's does
    assert td.unsupervised_detect(t, feat) == jd.unsupervised_detect(t, feat)
    assert td.timings["iterations"] == 0
    for a, b in zip(td.params, jd.params):
        np.testing.assert_array_equal(a.numpy().astype(np.float32),
                                      np.asarray(b))


def test_waveform_to_events_equals_jax():
    """Each package's own PSD and features of the same waveform, then
    detection: the same events."""
    x = _bursty_signal(fs=FS, bursts=((12, 18), (33, 41)), seed=3)
    t_j, f_j = _features(x, FS, JConfig.scipy_default(1024), 0.0, 30.0)
    cfg = SpecConfig.scipy_default(1024)
    psd = power_spectrogram(torch.from_numpy(x), FS, cfg)
    f_t = tev.features_from_psd(freq_axis(cfg, FS), psd, 0.0, 30.0)
    t_t = time_axis(cfg, FS, len(x))
    np.testing.assert_array_equal(t_t, t_j)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0, atol=5e-6)
    assert (_det().unsupervised_detect(t_t, f_t)
            == JDetector().unsupervised_detect(t_j, f_j))


def test_flow_equals_the_float64_oracle_flow():
    """tests/test_hmmlearn_parity.py's end-to-end fixture: the oracle's fit,
    escape patch, Viterbi, baseline scan and merge give the port's events."""
    feats = _synthetic_features(np.random.RandomState(7), T=500,
                                burst_spans=((60, 110), (200, 260),
                                             (380, 450)))
    t = 0.5 + np.arange(500) * 0.128
    got = _det().unsupervised_detect(t, feats.astype(np.float32))
    oracle = HmmlearnOracle(4).fit(feats.astype(np.float32).astype(np.float64))
    base = int(np.argmin(oracle.means_[:, 0]))
    oracle.transmat_ = jhmm.patch_escape_routes(oracle.transmat_, base)
    want = jev.merge_overlapping_events(jev.baseline_scan(
        oracle.predict(feats.astype(np.float32).astype(np.float64)), t, base))
    assert got == want
    assert got == JDetector().unsupervised_detect(t, feats.astype(np.float32))


def test_refusals_match_jax():
    cases = [
        (lambda d: d.unsupervised_detect(np.array([0.0, 1.0]),
                                         np.zeros((2, 2), np.float32)),
         "Not enough data"),
        (lambda d: d.learn_and_detect(np.arange(10.0), np.zeros((10, 2)), []),
         "No manual regions"),
        (lambda d: d.learn_and_detect(
            np.arange(100.0),
            np.random.RandomState(0).randn(100, 2).astype(np.float32),
            [(1000.0, 1001.0)]), "Could not identify"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match) as want:
            call(JDetector())
        with pytest.raises(ValueError, match=match) as got:
            call(_det())
        assert str(got.value) == str(want.value)
    assert _det().unsupervised_detect(np.array([]), np.zeros((0, 2))) == []


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_nonfinite_features_refused_like_jax(bad):
    rng = np.random.RandomState(0)
    t = np.arange(64) / 10.0
    feats = rng.randn(64, 2).astype(np.float32)
    feats[10, 0] = bad
    for call in (lambda d: d.unsupervised_detect(t, feats),
                 lambda d: d.learn_and_detect(t, feats, [(1.0, 4.0)])):
        with pytest.raises(ValueError, match="NaN/Inf") as want:
            call(JDetector())
        with pytest.raises(ValueError, match="NaN/Inf") as got:
            call(_det())
        assert str(got.value) == str(want.value)


def test_roi_guards_equal_jax():
    t = np.arange(100.0)
    feat = np.random.RandomState(0).randn(100, 2).astype(np.float32)
    feat[40:50, 0] += 6.0
    for rois in ([(5.0, 5.5), (35.0, 55.0)], [(10.0, 12.0), (35.0, 55.0)]):
        td, jd = _det(), JDetector()
        assert td.learn_and_detect(t, feat, rois) == jd.learn_and_detect(
            t, feat, rois)
    td = _det()
    with pytest.raises(ValueError, match="Could not identify"):
        td.learn_and_detect(t, feat, [(10.0, 12.0)])
    assert not td.is_model_refined


def test_roi_two_state_localization_equals_jax():
    feats = _synthetic_features(np.random.RandomState(11), T=120,
                                burst_spans=((40, 80),)).astype(np.float32)
    t = np.arange(120) * 0.25
    assert (_det()._find_burst_in_roi(feats, t)
            == JDetector()._find_burst_in_roi(feats, t))


def test_engines_agree_and_route_like_jax():
    rng = np.random.RandomState(3)
    T = 400
    t = np.arange(T) / 20.0
    feats = rng.randn(T, 2).astype(np.float32)
    feats[120:180, 0] += 6.0
    feats[260:300, 0] += 6.0
    scan = _det(engine="scan").unsupervised_detect(t, feats)
    assert _det(engine="pscan").unsupervised_detect(t, feats) == scan
    # JAX's own tests hold its pscan engine to its scan engine here
    assert JDetector(engine="scan").unsupervised_detect(t, feats) == scan
    det = _det(engine="auto")
    assert det.PSCAN_THRESHOLD == JDetector.PSCAN_THRESHOLD == 2048
    assert not det._parallel(2047) and det._parallel(2048)
    assert _det(engine="pscan")._parallel(2)
    assert not _det(engine="scan")._parallel(10 ** 9)
    with pytest.raises(ValueError, match="engine"):
        _det(engine="fancy")


def test_reset_and_warmup():
    det = _det()
    det.params, det.is_model_refined = "sentinel", True
    det.reset()
    assert det.params is None and not det.is_model_refined
    det.warmup()                          # the CPU: nothing to build


def test_device_policy(monkeypatch):
    """'auto' (the default) and 'default' mean the card, never the CPU;
    None is refused; 'cpu' is the only way to the plain versions."""
    with pytest.raises(ValueError, match="device"):
        BurstDetector(device=None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = np.arange(50.0)
    feats = np.random.RandomState(0).randn(50, 2).astype(np.float32)
    for det in (BurstDetector(), BurstDetector(device="default"),
                BurstDetector(device="cuda")):
        with pytest.raises(RuntimeError, match="is_available"):
            det.unsupervised_detect(t, feats)
    with pytest.raises(RuntimeError, match="is_available"):
        batch.batch_unsupervised_detect(t, feats[None])
    with pytest.raises(ValueError, match="device"):
        batch.batch_unsupervised_detect(t, feats[None], device=None)


def _clips(n=4, T=300):
    return np.stack([_synthetic_features(
        np.random.RandomState(s), T=T,
        burst_spans=((40 + 10 * s, 90 + 10 * s), (180, 230)))
        for s in range(n)]).astype(np.float32)


def test_batch_unsupervised_detect_equals_jax_and_one_by_one():
    feats = _clips()
    t = np.arange(feats.shape[1]) * 0.1
    timings = {}
    got = batch.batch_unsupervised_detect(t, feats, device="cpu",
                                          timings=timings)
    assert got == jbatch.batch_unsupervised_detect(t, feats)
    assert got == [_det().unsupervised_detect(t, f) for f in feats]
    assert set(timings) == {"init", "fit", "scan"}
    assert batch.batch_unsupervised_detect(
        t, torch.from_numpy(feats), device="cpu") == got


def test_batch_refusals_match_jax():
    feats = _clips(3)
    t = np.arange(feats.shape[1]) * 0.1
    bad = feats.copy()
    bad[1, 5, 0] = np.nan
    with pytest.raises(ValueError, match="NaN/Inf") as want:
        jbatch.batch_unsupervised_detect(t, bad)
    with pytest.raises(ValueError, match="NaN/Inf") as got:
        batch.batch_unsupervised_detect(t, bad, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="Not enough data"):
        batch.batch_unsupervised_detect(t[:3], feats[:, :3], device="cpu")


@pytest.mark.parametrize("scan", ["label", "baseline"])
def test_batch_viterbi_detect_equals_jax(scan):
    feats = _clips(3)
    t = np.arange(feats.shape[1]) * 0.1
    labels = jev.build_label_track(t, [(4.0, 9.0), (18.0, 23.0)])
    p = hmm.supervised_fit(feats[0], labels, 4, device="cpu")
    jp = jhmm.supervised_fit(feats[0], labels, 4)
    assert (batch.batch_viterbi_detect(p, t, feats, scan=scan)
            == jbatch.batch_viterbi_detect(jp, t, feats, scan=scan))


def test_follows_the_float64_oracle_where_jax_float32_departs():
    """A 1,262-frame sweep (below PSCAN_THRESHOLD, so both packages take
    the sequential engine): the port's float64 flow gives the oracle's
    356 events; the JAX package's float32 E-step, whose gamma drifts from
    the oracle with T (spectral_tpu/models/hmm.py:20-27), ends on 357
    (ROADMAP queue 3)."""
    rng = np.random.RandomState(107)
    T = int(rng.randint(1200, 2047))
    feats = _synthetic_features(rng, T=T, burst_spans=(
        (200, 260), (700, 790), (1100, 1150))).astype(np.float32)
    t = np.arange(T) * 0.1
    oracle = HmmlearnOracle(4).fit(feats.astype(np.float64))
    base = int(np.argmin(oracle.means_[:, 0]))
    oracle.transmat_ = jhmm.patch_escape_routes(oracle.transmat_, base)
    want = jev.merge_overlapping_events(jev.baseline_scan(
        oracle.predict(feats.astype(np.float64)), t, base))
    got = _det().unsupervised_detect(t, feats)
    assert T == 1262 and len(want) == 356
    assert got == want
