"""The port's bounded-memory backstop (spectral_tpu_torch/utils/memory.py)
and observability helpers (utils/metrics.py), after tests/test_memory.py:
the same RSS reading, threshold and hysteresis as the JAX package's; a
trim drops the port's per-config caches (the kernels' device operands in
ops/stft_cuda._CONSTANTS, the host constants' lru_caches, the packed
colormaps); the session's hook honours SPECTRAL_TPU_MAX_RSS_MB; a serve
worker with a tiny --max-rss-mb trims after every request and keeps
answering the same replies.
"""

import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spectral_tpu.utils import memory as jmemory  # noqa: E402
from spectral_tpu.utils import metrics as jmetrics  # noqa: E402
from spectral_tpu_torch import SpecConfig, ViewSettings  # noqa: E402
from spectral_tpu_torch.core import mel, stft  # noqa: E402
from spectral_tpu_torch.io.registry import SweepEntry  # noqa: E402
from spectral_tpu_torch.ops import colormap, stft_cuda  # noqa: E402
from spectral_tpu_torch.utils import memory, metrics  # noqa: E402


@pytest.fixture(autouse=True)
def _reset_hysteresis():
    memory._post_trim_rss = 0.0
    yield
    memory._post_trim_rss = 0.0


def _fill_caches():
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 4096).astype(
        np.float32))
    for cfg in (SpecConfig.scipy_default(256), SpecConfig(nperseg=128,
                                                          nfft=512)):
        stft_cuda.stft_psd(x, 1000.0, cfg)
        stft_cuda.fft_constants(cfg, 1000.0, "cpu")
    stft.fft_plan(96)
    stft.bluestein_plan(2049)
    mel.mel_filterbank(16, 129, 1000.0)
    colormap.packed_lut("jet", "cpu")


def _cached():
    return {"constants": len(stft_cuda._CONSTANTS),
            "window": stft._window_f64.cache_info().currsize,
            "dft": stft.dft_matrices.cache_info().currsize,
            "twiddles": stft.fft_twiddles.cache_info().currsize,
            "plan": stft.fft_plan.cache_info().currsize,
            "bluestein": stft.bluestein_plan.cache_info().currsize,
            "mel": mel.mel_filterbank.cache_info().currsize,
            "lut": colormap._packed_lut_np.cache_info().currsize
            + len(colormap._LUT_CACHE)}


def test_rss_threshold_and_hysteresis_are_the_jax_packages(monkeypatch):
    assert memory.rss_mb() > 10.0
    assert abs(memory.rss_mb() - jmemory.rss_mb()) < 64.0
    monkeypatch.delenv("SPECTRAL_TPU_MAX_RSS_MB", raising=False)
    assert memory.maybe_trim_caches() is False
    assert memory.maybe_trim_caches(0) is False
    assert memory.maybe_trim_caches(1e9) is False
    for value, want in (("not-a-number", 0.0), ("", 0.0), ("512", 512.0)):
        monkeypatch.setenv("SPECTRAL_TPU_MAX_RSS_MB", value)
        assert memory.env_threshold_mb() == jmemory.env_threshold_mb() \
            == want
    monkeypatch.setenv("SPECTRAL_TPU_MAX_RSS_MB", "not-a-number")
    assert memory.maybe_trim_caches() is False


def test_trim_clears_the_ports_caches():
    _fill_caches()
    before = _cached()
    assert all(v >= 1 for v in before.values()), before
    assert memory.maybe_trim_caches(1.0) is True        # 1 MB: always over
    assert all(v == 0 for v in _cached().values()), _cached()
    # anti-thrash hysteresis: RSS barely moved since the trim
    assert memory.maybe_trim_caches(1.0) is False
    # everything rebuilds on the next call, with the same values
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 4096).astype(
        np.float32))
    cfg = SpecConfig(nperseg=128, nfft=512)
    a = stft_cuda.stft_psd(x, 1000.0, cfg)
    memory.trim_caches()
    assert torch.equal(a, stft_cuda.stft_psd(x, 1000.0, cfg))


def test_trim_keeps_tensors_a_caller_holds():
    consts = stft_cuda.dft_constants(SpecConfig(nperseg=64), 1000.0, "cpu")
    memory.trim_caches()
    assert consts.a_re.shape == (64, 33) and torch.isfinite(consts.a_re).all()


def _session():
    from spectral_tpu_torch.api.session import AnalysisSession
    s = AnalysisSession(warm_detection=False, device="cpu")
    t = np.arange(6000) / 100.0
    x = (np.sin(2 * np.pi * 6 * t) * (t > 20) * (t < 30)
         + 0.05 * np.random.RandomState(0).randn(t.size)).astype(np.float32)
    s.registry.register("m_sweep0", SweepEntry("m", 0, 100.0, 100.0, x,
                                               None))
    return s


def test_session_plot_and_detection_honor_env_knob(monkeypatch):
    """The session's hook calls maybe_trim_caches after each plot and
    detection (it did nothing before utils/memory.py was ported)."""
    s = _session()
    monkeypatch.delenv("SPECTRAL_TPU_MAX_RSS_MB", raising=False)
    s.plot_sweeps(["m_sweep0"], SpecConfig.scipy_default(256), ViewSettings())
    assert len(stft_cuda._CONSTANTS) >= 1                # disabled: kept
    monkeypatch.setenv("SPECTRAL_TPU_MAX_RSS_MB", "1")   # force a trim
    r = s.plot_sweeps(["m_sweep0"], SpecConfig.scipy_default(256),
                      ViewSettings())
    assert r is not None and r.image is not None
    assert len(stft_cuda._CONSTANTS) == 0
    assert stft.dft_matrices.cache_info().currsize == 0
    _fill_caches()
    memory._post_trim_rss = 0.0
    assert s.unsupervised_detect() is not None
    assert len(stft_cuda._CONSTANTS) == 0


def test_serve_trims_and_keeps_answering(tmp_path):
    """serve --max-rss-mb 1: the trim fires after every request; the
    worker keeps rebuilding sessions and answers what an untrimmed worker
    answers."""
    from spectral_tpu_torch.cli import _serve
    from spectral_tpu_torch.io.wav import write_wav
    fs = 1000.0
    t = np.arange(int(20 * fs)) / fs
    x = (0.02 * np.random.RandomState(0).randn(t.size)
         + 0.5 * np.sin(2 * np.pi * 6 * t) * ((t > 5) & (t < 9)))
    p = str(tmp_path / "s.wav")
    write_wav(p, x.astype(np.float32), fs)
    reqs = [{"cmd": "bands", "files": [p], "config": {"nperseg": 256}}
            for _ in range(3)]
    reqs += [{"cmd": "stats"}, {"cmd": "shutdown"}]
    text = "\n".join(json.dumps(r) for r in reqs) + "\n"
    outs = []
    for cap in (1.0, 0.0):
        stdout = io.StringIO()
        assert _serve(io.StringIO(text), stdout, max_rss_mb=cap,
                      device="cpu") == 0
        outs.append([json.loads(line) for line in
                     stdout.getvalue().splitlines()])
    trimmed, plain = outs
    assert [o["ok"] for o in trimmed] == [True] * 5
    assert trimmed[:3] == plain[:3]
    assert trimmed[3]["cache_trims"] >= 1 and plain[3]["cache_trims"] == 0


def test_metrics_match_the_jax_package_and_use_torch_profiler(tmp_path,
                                                              monkeypatch):
    m, jm = metrics.ThroughputMeter(), jmetrics.ThroughputMeter()
    for meter in (m, jm):
        meter.add(16000 * 3600, 16000.0, n_frames=1000)
    assert set(m.report()) == set(jm.report())
    assert m.report()["audio_hours"] == jm.report()["audio_hours"] == 1.0
    with metrics.timed("x", log=False, device="cpu") as out:
        sum(range(1000))
    assert out["seconds"] >= 0.0
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    with metrics.timed("y", log=False, device="cuda:0"):
        assert len(synced) == 1            # before the clock is read
    assert synced == [torch.device("cuda:0")] * 2
    metrics.configure_logging()
    metrics.configure_logging(json_lines=True)
    assert metrics.logger.name == "spectral_tpu_torch"
    assert metrics.start_profiler_trace(str(tmp_path)) is True
    assert metrics.start_profiler_trace(str(tmp_path)) is False
    with metrics.trace_annotation("spectral_tpu_torch.test_span"):
        torch.ones(4).sum()
    path = metrics.stop_profiler_trace()
    assert path and os.path.exists(path)
    with open(path) as fh:
        assert "spectral_tpu_torch.test_span" in fh.read()
    assert metrics.stop_profiler_trace() is None
