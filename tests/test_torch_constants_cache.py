"""The kernels' device-operand cache (``ops/stft_cuda.py::_CONSTANTS``):
least recently used first out, at most ``CONSTANTS_BUDGET`` bytes of
device tensors a device. On the CPU, with a small budget."""

import collections
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402
from spectral_tpu_torch.utils.memory import trim_caches  # noqa: E402

FS = 1000.0


@pytest.fixture
def cache(monkeypatch):
    """An empty cache of its own for the test."""
    fresh = collections.OrderedDict()
    monkeypatch.setattr(stft_cuda, "_CONSTANTS", fresh)
    return fresh


def held(cache, device="cpu"):
    return sum(stft_cuda._tensor_bytes(v) for k, v in cache.items()
               if k[1] == device)


def fft_bytes(k):
    """An FFT entry's bytes: the window (k), the twiddles (k - 1, 2) and the
    weights (k/2 + 1), float64."""
    return 8 * (k + 2 * (k - 1) + k // 2 + 1)


def test_many_configs_leave_at_most_the_budget(cache, monkeypatch):
    budget = 3 * fft_bytes(1024)
    monkeypatch.setattr(stft_cuda, "CONSTANTS_BUDGET", budget)
    for k in (64, 128, 256, 512, 1024, 2048, 96, 160, 24, 1000):
        cfg = SpecConfig.scipy_default(k)
        stft_cuda.fft_constants(cfg, FS, "cpu")
        stft_cuda.mixed_constants(cfg, FS, "cpu")
        stft_cuda.bluestein_constants(cfg, FS, "cpu")
        stft_cuda.dft_constants(cfg, FS, "cpu")
        assert held(cache) <= budget
    assert 0 < len(cache) < 40


def test_a_hit_returns_the_same_tensors(cache):
    cfg = SpecConfig.north_star(256, 64)
    for get in (lambda: stft_cuda.fft_constants(cfg, FS, "cpu", "psd"),
                lambda: stft_cuda.dft_constants(cfg, FS, "cpu", (3, 40)),
                lambda: stft_cuda.mixed_constants(cfg, FS, "cpu"),
                lambda: stft_cuda.bluestein_constants(cfg, FS, "cpu")):
        first, again = get(), get()
        assert all(a is b for a, b in zip(first, again))
    # each key its own entry: another band, output or fs is another entry
    stft_cuda.dft_constants(cfg, FS, "cpu", (3, 41))
    stft_cuda.fft_constants(cfg, FS, "cpu", "magnitude")
    stft_cuda.fft_constants(cfg, 2 * FS, "cpu", "psd")
    assert len(cache) == 7


def test_eviction_is_least_recently_used(cache, monkeypatch):
    monkeypatch.setattr(stft_cuda, "CONSTANTS_BUDGET", 3 * fft_bytes(256))
    cfgs = [dataclasses.replace(SpecConfig.scipy_default(256), window=w)
            for w in ("hann", "hamming", "blackman", "boxcar")]
    a, b, c, d = (lambda cfg=cfg: stft_cuda.fft_constants(cfg, FS, "cpu")
                  for cfg in cfgs)
    ta = a()
    b(), c()
    assert a() is ta                   # a hit: a is now the newest
    d()                                # evicts b, the least recently used
    windows = [k[2].window for k in cache]
    assert windows == ["blackman", "hann", "boxcar"]
    assert a() is ta
    # the evicted entry's tensors stay valid where a caller holds them
    tb = stft_cuda.fft_constants(cfgs[1], FS, "cpu")
    assert float(tb.window.sum()) > 0
    assert [k[2].window for k in cache] == ["boxcar", "hann", "hamming"]


def test_an_entry_larger_than_the_budget_is_returned_not_kept(cache,
                                                              monkeypatch):
    monkeypatch.setattr(stft_cuda, "CONSTANTS_BUDGET", fft_bytes(512))
    small = stft_cuda.fft_constants(SpecConfig.scipy_default(256), FS, "cpu")
    big = stft_cuda.dft_constants(SpecConfig.scipy_default(256), FS, "cpu")
    assert big.a_re.shape == (256, 129)
    assert len(cache) == 1 and next(iter(cache.values())) is small
    again = stft_cuda.dft_constants(SpecConfig.scipy_default(256), FS, "cpu")
    assert again is not big and torch.equal(again.a_re, big.a_re)


def test_the_budget_is_a_devices(cache, monkeypatch):
    """Entries on another device neither count against nor evict this
    device's."""
    monkeypatch.setattr(stft_cuda, "CONSTANTS_BUDGET", 2 * fft_bytes(256))
    cfg = SpecConfig.scipy_default(256)
    on_cpu = stft_cuda.fft_constants(cfg, FS, "cpu")
    for w in ("hann", "hamming", "blackman"):
        stft_cuda.fft_constants(dataclasses.replace(cfg, window=w), FS,
                                "meta")
    assert held(cache, "meta") <= 2 * fft_bytes(256)
    assert stft_cuda.fft_constants(cfg, FS, "cpu") is on_cpu


def test_trim_caches_empties_the_cache(cache):
    stft_cuda.fft_constants(SpecConfig.scipy_default(64), FS, "cpu")
    stft_cuda.dft_constants(SpecConfig.scipy_default(64), FS, "cpu")
    assert len(cache) == 2
    trim_caches()
    assert len(cache) == 0


def test_the_budget_holds_the_largest_dense_operands():
    """4 GiB a device: seven configs' (8192, 4097) float64 matrix pairs."""
    pair = 2 * 8192 * 4097 * 8
    assert stft_cuda.CONSTANTS_BUDGET == 4 * 2 ** 30
    assert 7 * pair <= stft_cuda.CONSTANTS_BUDGET < 8 * pair
