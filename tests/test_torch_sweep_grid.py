"""The port's sweep grid (spectral_tpu_torch.parallel.sweep_grid,
device='cpu': the kernel's plain version) held against the JAX package's
(spectral_tpu.parallel.sweep_grid, run as tests/test_sweep_grid_batch.py
runs it), scipy in float64 and the port's power_spectrogram, on seeded
numpy signals of a few seconds at 8-16 kHz.

Tolerances: each result equal to the port's power_spectrogram of its
config (the same call on the same buffer); within PSD_REL of the
reference's max against scipy float64 and the JAX package; refusals with
the JAX package's texts, or naming the port's ROADMAP item.
"""

import numpy as np
import pytest
import scipy.signal

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spectral_tpu import config as jconfig  # noqa: E402
from spectral_tpu.parallel import sweep_grid as jsg  # noqa: E402
from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.core.stft import (num_frames,  # noqa: E402
                                          power_spectrogram)
from spectral_tpu_torch.parallel import sweep_grid as sg  # noqa: E402

PSD_REL = 2e-5


def _j(cfg):
    return jconfig.SpecConfig.from_json(cfg.to_json())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _scipy(x, fs, cfg):
    win = cfg.window if isinstance(cfg.window, str) else tuple(cfg.window)
    _, _, s = scipy.signal.spectrogram(
        np.asarray(x, np.float64), fs=fs, window=win, nperseg=cfg.nperseg,
        noverlap=cfg.nperseg - cfg.hop_,
        detrend=False if cfg.detrend == "none" else cfg.detrend,
        scaling="density", mode="psd")
    return s.T


def test_default_grid_is_the_jax_grid():
    grid = sg.default_grid()
    assert len(grid) == 16
    assert [c.to_json() for c in grid] == [c.to_json()
                                           for c in jsg.default_grid()]
    small = sg.default_grid(n_ffts=(256, 1024), hop_divisor=8)
    assert [c.to_json() for c in small] == [
        c.to_json() for c in jsg.default_grid(n_ffts=(256, 1024),
                                              hop_divisor=8)]
    assert all(sg._shape_key(c) == jsg._shape_key(_j(c)) for c in grid)


def test_sweep_grid_matches_individual_configs_and_jax():
    fs = 8000.0
    x = np.random.RandomState(0).randn(16384).astype(np.float32)
    configs = [
        SpecConfig(nperseg=256, hop=64, window="hann", detrend="none"),
        SpecConfig(nperseg=256, hop=64, window="hamming", detrend="none"),
        SpecConfig(nperseg=256, hop=64, window=("tukey", 0.25),
                   detrend="constant"),
        SpecConfig(nperseg=512, hop=128, window="hann", detrend="none"),
        SpecConfig(nperseg=300, hop=70, window="blackman",
                   detrend="linear"),
    ]
    outs = sg.sweep_grid(x, fs, configs, device="cpu")
    jouts = jsg.sweep_grid(jnp.asarray(x), fs, [_j(c) for c in configs])
    assert len(outs) == len(configs)
    for cfg, out, jout in zip(configs, outs, jouts):
        assert out.device.type == "cpu"
        assert torch.equal(out, power_spectrogram(torch.from_numpy(x), fs,
                                                  cfg))
        assert _rel(out, jout) <= PSD_REL, cfg
        assert _rel(out, _scipy(x, fs, cfg)) <= PSD_REL, cfg


def test_sweep_grid_full_grid_against_scipy():
    fs = 16000.0
    x = np.random.RandomState(1).randn(32768).astype(np.float32)
    grid = sg.default_grid()
    outs = sg.sweep_grid(x, fs, grid, device="cpu")
    for cfg, out in zip(grid, outs):
        assert out.shape == (num_frames(32768, cfg.nperseg, cfg.hop_),
                             cfg.n_freqs)
        assert _rel(out, _scipy(x, fs, cfg)) <= PSD_REL, cfg


def test_sweep_grid_over_a_clip_batch():
    """A (B, n) batch: each clip's result is its own grid's."""
    fs = 8000.0
    grid = sg.default_grid(n_ffts=(256, 1024))
    xb = np.random.RandomState(5).randn(3, 16384).astype(np.float32)
    outs = sg.sweep_grid(xb, fs, grid, device="cpu")
    for cfg, out in zip(grid, outs):
        assert out.shape[0] == 3
        for b in range(3):
            one = sg.sweep_grid(xb[b], fs, [cfg], device="cpu")[0]
            assert _rel(out[b], one) <= 1e-6


def test_sweep_grid_refusals():
    fs = 8000.0
    x = np.zeros(8192, np.float32)
    magnitude = SpecConfig(nperseg=256, hop=64, mode="magnitude",
                           detrend="none")
    with pytest.raises(ValueError, match="psd") as got:
        sg.sweep_grid(x, fs, [magnitude], device="cpu")
    with pytest.raises(ValueError, match="psd") as want:
        jsg.sweep_grid(jnp.asarray(x), fs, [_j(magnitude)])
    assert str(got.value) == str(want.value)
    ok = SpecConfig(nperseg=256, hop=64, detrend="none")
    with pytest.raises(NotImplementedError, match=r"\[large-nperseg\]"):
        sg.sweep_grid(x, fs, [ok, SpecConfig.scipy_default(65536)],
                      device="cpu")
    # a transform past 8192 ([large-nperseg], to 32,768) is a config like
    # any other: the JAX package's grid's PSD
    big = SpecConfig(nperseg=16384, hop=4096, detrend="none")
    z = np.random.RandomState(6).randn(24576).astype(np.float32)
    got = sg.sweep_grid(z, fs, [ok, big], device="cpu")
    want = jsg.sweep_grid(jnp.asarray(z), fs, [_j(ok), _j(big)])
    assert got[1].shape == want[1].shape == (3, 8193)
    assert _rel(got[1], np.asarray(want[1])) <= PSD_REL
    # a centered group, refused until [ext-modes], pads as the JAX
    # package's grid does (one jnp.pad a group)
    centered = SpecConfig(nperseg=256, hop=64, detrend="none", center=True)
    y = np.random.RandomState(4).randn(8192).astype(np.float32)
    got = sg.sweep_grid(y, fs, [ok, centered], device="cpu")
    want = jsg.sweep_grid(jnp.asarray(y), fs, [_j(ok), _j(centered)])
    assert got[1].shape == want[1].shape == (8192 // 64 + 1, 129)
    assert _rel(got[1], np.asarray(want[1])) <= PSD_REL
    # nfft > nperseg, refused until the GEMM kernel took it, is a config
    # like any other: the same call as power_spectrogram's
    padded = SpecConfig(nperseg=250, nfft=512, hop=64, detrend="none")
    y = np.random.RandomState(5).randn(8192).astype(np.float32)
    got = sg.sweep_grid(y, fs, [ok, padded], device="cpu")
    assert torch.equal(got[1], power_spectrogram(torch.from_numpy(y), fs,
                                                 padded))
    assert got[1].shape[-1] == 257


def test_sweep_grid_takes_the_card_by_default(monkeypatch):
    import inspect
    assert inspect.signature(sg.sweep_grid).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        sg.sweep_grid(np.zeros(4096, np.float32), 8000.0,
                      sg.default_grid(n_ffts=(256,)))


def test_sweep_grid_puts_the_signal_on_the_card_once(monkeypatch):
    """One copy of the signal to the device (the ``meta`` stand-in for the
    card), and every config's PSD computed from that one tensor."""
    moves, inputs = [], []
    real_to = torch.Tensor.to

    def to(self, *args, **kwargs):
        moves.append(args)
        return real_to(self, *args, **kwargs)

    monkeypatch.setattr(sg, "resolve_device",
                        lambda device: torch.device("meta"))
    monkeypatch.setattr(sg, "power_spectrogram",
                        lambda x, fs, cfg: inputs.append(x) or x)
    monkeypatch.setattr(torch.Tensor, "to", to)
    sg.sweep_grid(np.zeros(4096, np.float32), 8000.0, sg.default_grid())
    assert len(moves) == 1 and len(inputs) == 16
    assert all(x is inputs[0] for x in inputs)
    assert inputs[0].device.type == "meta"
    assert inputs[0].dtype == torch.float32
