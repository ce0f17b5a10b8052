"""The host operands the port caches and shares between callers (the
window, the folded DFT matrices, the radix-2 twiddle table and the FFT
kernels' zero-padded window) are read-only, so that a caller that edits
one in place raises at once instead of changing the results of every
later call in the process; the device operands built from them are
copies, free to edit."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.core import stft as tstft  # noqa: E402
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402

CFGS = [SpecConfig.scipy_default(24),
        SpecConfig(nperseg=250, hop=125, nfft=256, onesided=False),
        dataclasses.replace(SpecConfig.north_star(64, 16), detrend="linear")]


def _cached(cfg):
    """Each cached operand of cfg beside a fresh build of it."""
    a_re, a_im = tstft.dft_matrices(cfg)
    b_re, b_im = tstft.dft_matrices.__wrapped__(cfg)
    w = np.zeros(cfg.nfft_)
    w[:cfg.nperseg] = tstft._window_f64.__wrapped__(cfg)
    return [(tstft._window_f64(cfg), tstft._window_f64.__wrapped__(cfg)),
            (a_re, b_re), (a_im, b_im),
            (stft_cuda.padded_window(cfg), w)] + (
        [(tstft.fft_twiddles(cfg.nfft_),
          tstft.fft_twiddles.__wrapped__(cfg.nfft_))]
        if cfg.nfft_ & (cfg.nfft_ - 1) == 0 else [])


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: f"{c.nperseg}_{c.nfft_}")
def test_cached_operands_are_read_only(cfg):
    """An in-place edit of a cached operand raises; the cache hands out
    the same array again, equal to a fresh build."""
    for got, fresh in _cached(cfg):
        assert not got.flags.writeable
        with pytest.raises(ValueError, match="read-only"):
            got[..., 0] = 1.0
        with pytest.raises(ValueError, match="read-only"):
            got *= 2.0
        assert np.array_equal(got, fresh)
    again = _cached(cfg)
    assert all(a is b for (a, _), (b, _) in zip(_cached(cfg), again))


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: f"{c.nperseg}_{c.nfft_}")
def test_device_operands_are_copies(cfg):
    """The kernels' operands built from the cached arrays are tensors of
    their own: editing one leaves the host arrays and the next build
    alone."""
    consts = stft_cuda.constants_from_numpy(
        *stft_cuda.mirrored_dft_matrices(cfg),
        stft_cuda.kernel_weights(cfg, 1000.0), "cpu", torch.float64)
    consts.a_re.add_(1.0)
    consts.wts.zero_()
    a_re = stft_cuda.mirrored_dft_matrices(cfg)[0]
    assert np.array_equal(a_re + 1.0, consts.a_re.numpy())
    again = stft_cuda.constants_from_numpy(
        *stft_cuda.mirrored_dft_matrices(cfg),
        stft_cuda.kernel_weights(cfg, 1000.0), "cpu", torch.float64)
    assert np.array_equal(again.a_re.numpy(), a_re)
    assert bool((again.wts > 0).all())
