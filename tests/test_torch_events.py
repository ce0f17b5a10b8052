"""The port's event and feature algebra (spectral_tpu_torch.core.events)
held against the JAX package's (spectral_tpu.core.events) on the same
numpy-seeded inputs.

Tolerances:
- the host scans, the label track, the merge and the ROI operations:
  exact (the same control flow on the same numbers);
- band_powers and absolute_power: exact (both sum on the host in numpy);
- the features: the port sums the band's bins in float64 and rounds once
  to float32, JAX sums in float32, so the log-power and its delta agree
  within FEATURE_TOL absolute (a few float32 ulps of log10 power near -6);
  the port's own band-sliced and full-axis features are bitwise equal;
- band_powers_device: 1e-6 relative (JAX float32 einsum, the port float64).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spectral_tpu.core import events as jev  # noqa: E402
from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.core import events as tev  # noqa: E402
from spectral_tpu_torch.core.stft import freq_axis  # noqa: E402

FEATURE_TOL = 5e-6


def _psd(seed, shape, lo=1e-7, hi=1e-4):
    rng = np.random.RandomState(seed)
    return (lo + (hi - lo) * rng.rand(*shape)).astype(np.float32)


@pytest.mark.parametrize("fmin,fmax", [(0.0, 30.0), (3.0, 12.5),
                                       (0.0, 500.0), (100.0, 100.5)])
def test_features_from_psd_match_jax(fmin, fmax):
    f = freq_axis(SpecConfig.scipy_default(1024), 1000.0)
    psd = _psd(0, (3, 40, f.size))
    got = tev.features_from_psd(f, torch.from_numpy(psd), fmin, fmax)
    want = np.asarray(jev.features_from_psd(f, jnp.asarray(psd), fmin, fmax))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FEATURE_TOL)


def test_band_edge_on_a_bin_sums_the_inclusive_mask():
    """fmin and fmax exactly on bins: both edge bins are summed (f >= fmin
    and f <= fmax), and the PSD of the band's bins alone gives the same
    features bit for bit as the full axis under the mask."""
    f = freq_axis(SpecConfig.scipy_default(1024), 1000.0)
    lo, hi = 3, 30
    fmin, fmax = float(f[lo]), float(f[hi])
    psd = torch.from_numpy(_psd(1, (2, 25, f.size)))
    full = tev.features_from_psd(f, psd, fmin, fmax)
    band = tev.features_from_psd(f[lo:hi + 1], psd[..., lo:hi + 1].contiguous(),
                                 fmin, fmax)
    assert torch.equal(full, band)
    want = torch.log10(psd[..., lo:hi + 1].double().sum(-1).float() + 1e-20)
    assert torch.equal(full[..., 0], want)
    assert np.array_equal(tev.band_bins(f, fmin, fmax), np.arange(lo, hi + 1))
    jax_f = np.asarray(jev.features_from_psd(f, jnp.asarray(psd.numpy()),
                                             fmin, fmax))
    np.testing.assert_allclose(full.numpy(), jax_f, rtol=0, atol=FEATURE_TOL)


def test_features_from_psd_refuses_a_foreign_axis():
    f = freq_axis(SpecConfig.scipy_default(256), 1000.0)
    with pytest.raises(ValueError, match="bins"):
        tev.features_from_psd(f[:10], torch.zeros(4, f.size), 0.0, 30.0)


def test_features_from_band_power_match_jax():
    power = np.random.RandomState(2).rand(4, 60).astype(np.float32) * 1e-3
    power[0, :5] = 0.0
    got = tev.features_from_band_power(torch.from_numpy(power))
    want = np.asarray(jev.features_from_band_power(jnp.asarray(power)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FEATURE_TOL)
    assert torch.equal(got[..., 0, 1], torch.zeros(4))


def _states(seed, T, K):
    rng = np.random.RandomState(seed)
    runs = rng.randint(1, 12, size=T)
    s = np.repeat(rng.randint(0, K, size=T), runs)[:T]
    return s


@pytest.mark.parametrize("seed", range(6))
def test_scans_equal_jax(seed):
    T = 300
    t = np.cumsum(np.random.RandomState(seed + 50).rand(T))
    states = _states(seed, T, 4)
    for base in range(4):
        assert (tev.baseline_scan(states, t, base)
                == jev.baseline_scan(states, t, base))
    assert tev.label_scan(states, t) == jev.label_scan(states, t)
    evs = tev.baseline_scan(states, t, 0) + tev.label_scan(states, t)
    assert (tev.merge_overlapping_events(evs)
            == jev.merge_overlapping_events(evs))
    bursts = tev.label_scan(states, t)[:5]
    np.testing.assert_array_equal(tev.build_label_track(t, bursts),
                                  jev.build_label_track(t, bursts))


@pytest.mark.parametrize("states,t,base", [
    ([0, 0, 1, 1, 0], [0.0, 1.0, 2.0, 3.0, 4.0], 0),
    ([0, 1, 1], [0.0, 1.0, 2.0], 0),
    ([1, 1, 0, 1], [0.0, 1.0, 2.0, 3.0], 0),
    ([0, 0, 1, 0], [0.0, 1.0, 1.0, 2.0], 0),
    ([2], [5.0], 2),
])
def test_baseline_scan_edge_cases_equal_jax(states, t, base):
    states, t = np.array(states), np.array(t)
    assert tev.baseline_scan(states, t, base) == jev.baseline_scan(states, t,
                                                                   base)
    assert tev.label_scan(states, t) == jev.label_scan(states, t)


def test_merge_and_label_track_edge_cases_equal_jax():
    for evs in ([], [(3.0, 4.0), (0.0, 1.0), (1.0 + 5e-7, 2.0)],
                [(0.0, 1.0), (1.0 + 1e-5, 2.0)], [(0.0, 10.0), (2.0, 3.0)]):
        assert (tev.merge_overlapping_events(evs)
                == jev.merge_overlapping_events(evs))
    t = np.arange(5, dtype=float)
    for bursts in ([(3.0, 4.0)], [(3.0, 7.0)], [(2.0, 2.0)], [(0.0, 4.0)]):
        np.testing.assert_array_equal(tev.build_label_track(t, bursts),
                                      jev.build_label_track(t, bursts))


def test_roi_operations_equal_jax():
    evs = [(0.0, 1.0), (2.0, 3.0), (2.5, 2.8), (5.0, 9.0), (6.0, 7.0)]
    for s, e in ((4.0, 4.05), (4.0, 4.2), (8.0, 3.0)):
        assert tev.add_roi(evs, s, e, 0.1) == jev.add_roi(evs, s, e, 0.1)
    for roi in ((2.0, 3.0), (9.0, 9.5)):
        assert tev.delete_roi(evs, roi) == jev.delete_roi(evs, roi)
    for box in ((5.0, 9.0), (1.9, 3.1), (10.0, 11.0)):
        assert (tev.merge_contained_rois(evs, box)
                == jev.merge_contained_rois(evs, box))


def test_band_powers_and_absolute_power_equal_jax():
    f = np.arange(0, 251, 1.0)
    sxx = np.random.RandomState(1).rand(len(f), 50) - 0.05
    assert tev.band_powers(f, sxx) == jev.band_powers(f, sxx)
    assert tev.band_powers(f, torch.from_numpy(sxx)) == jev.band_powers(f, sxx)
    assert tev.band_powers(f, np.zeros((len(f), 3))) == jev.band_powers(
        f, np.zeros((len(f), 3)))
    assert tev.absolute_power(sxx) == jev.absolute_power(sxx)
    assert tev.EEG_BANDS == jev.EEG_BANDS


def test_band_powers_device_match_jax():
    f = freq_axis(SpecConfig.scipy_default(512), 1000.0)
    psd = _psd(3, (2, 30, f.size))
    edges = list(tev.EEG_BANDS.values())
    got = tev.band_powers_device(f, torch.from_numpy(psd), edges)
    want = np.asarray(jev.band_powers_device(f, jnp.asarray(psd), edges))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)
    zero = tev.band_powers_device(f, torch.zeros(1, 4, f.size), edges)
    assert torch.equal(zero, torch.zeros(1, len(edges)))
