"""The mixed-radix route of the port's STFT/PSD kernel (spectral_tpu_torch.
ops.stft_cuda.route, mixed_constants; core.stft.fft_plan;
csrc/stft_psd.cu::stft_mixed_fft_psd_kernel), held on the CPU through a
numpy model of the kernel's exact algorithm
(``tools/torch_precision.py::psd_mixed_fft``: the same digit-reversed load,
the same stage order and butterflies, the same host twiddle rows). The
mixed-radix kernel's own passes are transcribed in
``tests/test_torch_mixed_registers.py``; the pass engine that runs its
Rader plans, and the odd and Bluestein kernels, in
``tests/test_torch_conv_registers.py``.

The model is held to the kernels' plain version (``stft_psd_reference``,
a float64 dense DFT) in float64, to the JAX package's Pallas kernel in
interpret mode (as ``tests/test_torch_fft.py`` runs it), and to scipy in
float64. Tolerances, each with its reason:

- against the plain version, both in float64 before the float32 store:
  1e-12 of each clip's largest bin. Both sum in float64 in other orders;
  the direct odd-radix DFTs add at most (p - 1)/2 roundings a stage.
  Under linear detrend the ramp clips take half the ramp, for the plain
  version's own rounding (``tests/test_torch_fft.py``).
- against the Pallas kernel, which sums in float32: the 5e-6 of each
  clip's max that ``tests/test_torch_stft.py`` holds the plain version to.
- against scipy in float64: 1e-6 dB of display error, three orders inside
  the 1e-3 dB contract.
"""

import dataclasses
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectral_tpu import config as jconfig  # noqa: E402
from spectral_tpu.ops import stft_pallas  # noqa: E402
from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.core import stft as tstft  # noqa: E402
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402
import torch_precision  # noqa: E402

FS = 16000.0
PSD_TOL = 5e-6          # against float32 arithmetic, of the clip's max
F64_TOL = 1e-12         # against the float64 dense DFT, of the clip's max
GUI = range(32, 8193, 32)
MIXED_GUI = [k for k in GUI if k & (k - 1)]


def _jax(cfg):
    return jconfig.SpecConfig.from_json(cfg.to_json())


def _config(nperseg, detrend):
    """nperseg with hop nperseg/4: a Hann window for detrend none (the
    north_star family), scipy's Tukey 0.25 for constant and linear."""
    if detrend == "none":
        return SpecConfig.north_star(nperseg, nperseg // 4)
    return SpecConfig(nperseg=nperseg, hop=nperseg // 4, detrend=detrend)


def _clips(seed, cfg, n_clips=2, offset=3.0, trend=1.0):
    """White noise plus offset; under linear detrend, ramp clips instead:
    noise plus ``trend`` times ``torch_precision.trend``, the 5·t + 3 of
    ``tests/test_extended_modes.py`` scaled to the clip's length."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n_clips, 8 * cfg.nperseg)
    if cfg.detrend == "linear":
        return (x + trend * torch_precision.trend(x.shape[-1])).astype(
            np.float32)
    return (x + offset).astype(np.float32)


def _model(x, cfg, round_f32=False):
    """The mixed-radix kernel's PSD of each clip in x, (B, T, F), from the
    operands the wrapper hands the kernel."""
    mc = stft_cuda.mixed_constants(cfg, FS, "cpu")
    plan = tstft.fft_plan(cfg.nperseg)
    return np.stack([torch_precision.psd_mixed_fft(
        torch_precision.frames_of(clip, cfg), mc.window.numpy(), plan,
        mc.wts.numpy(), detrend=cfg.detrend, round_f32=round_f32)
        for clip in x])


def _plain(x, cfg):
    return stft_cuda.stft_psd_reference(
        torch.from_numpy(x).double(), stft_cuda.dft_constants(cfg, FS, "cpu"),
        cfg).numpy()


def _assert_close(got, want, tol):
    scale = want.max(axis=(-2, -1))
    err = np.abs(got - want).max(axis=(-2, -1))
    assert np.all(err <= tol * scale), err / scale


@pytest.mark.parametrize("nperseg", [96, 100, 352, 960, 4576, 8032, 8160])
def test_plan_factors_order_and_load_permutation(nperseg):
    plan = tstft.fft_plan(nperseg)
    M = nperseg // 2
    factors = plan.stages[:, 0].tolist()
    assert factors == list(tstft.fft_radices(M))
    assert int(np.prod(factors)) == M
    odd = [p for p in factors if p % 2]
    assert factors == sorted(odd, reverse=True) + [2] * (len(factors)
                                                         - len(odd))
    assert all(all(p % d for d in range(2, p)) for p in factors)
    assert plan.stages.dtype == np.int32 and plan.perm.dtype == np.int32
    assert np.array_equal(np.sort(plan.perm), np.arange(M))
    # span L of each stage is the product of the radices before it
    assert plan.stages[:, 1].tolist() == [
        int(np.prod(factors[:s])) for s in range(len(factors))]
    # the mixed-radix digit reversal: value m's digits, least significant
    # in the last stage's radix, read back most significant first
    for m in (0, 1, M // 3, M - 1):
        slot, rest, span = 0, m, M
        for p in reversed(factors):
            span //= p
            slot += (rest % p) * span
            rest //= p
        assert plan.perm[m] == slot


@pytest.mark.parametrize("nperseg", [100, 992, 4576, 8160])
def test_plan_twiddles_are_numpys_float64_values(nperseg):
    """Every row is numpy's (cos, sin) of -2π j / K, j an integer reduced
    mod K, bitwise; each stands for the root of unity its stage needs."""
    plan = tstft.fft_plan(nperseg)
    K, M = nperseg, nperseg // 2
    tw = plan.twiddles

    def numpy_rows(j):
        ang = -2.0 * np.pi * (np.asarray(j) % K) / K
        return np.stack([np.cos(ang), np.sin(ang)], axis=-1)

    for p, L, tw_row, root_row in plan.stages.tolist():
        q, k = np.meshgrid(np.arange(1, p), np.arange(L), indexing="ij")
        rows = tw[tw_row:tw_row + (p - 1) * L]
        assert np.array_equal(rows, numpy_rows((q * k * (K // (L * p)))
                                               .ravel()))
        want = np.exp(-2j * np.pi * (q * k).ravel() / (L * p))
        assert np.allclose(rows[:, 0] + 1j * rows[:, 1], want, atol=1e-15)
        if p % 2:
            roots = tw[root_row:root_row + p]
            assert np.array_equal(roots, numpy_rows(np.arange(p) * (K // p)))
    split = tw[plan.split:plan.split + M]
    assert plan.split + M == len(tw)
    assert np.array_equal(split, numpy_rows(np.arange(M)))


def test_mixed_constants_build_no_dft_matrix(monkeypatch):
    """The mixed route's set-up never builds the (K, F) matrices (537 MB
    in float64 at 8160)."""
    def refuse(cfg):
        raise AssertionError("the mixed-radix route built a DFT matrix")

    monkeypatch.setattr(stft_cuda, "dft_matrices", refuse)
    monkeypatch.setattr(tstft, "dft_matrices", refuse)
    cfg = SpecConfig.scipy_default(8160, log_scale=True)
    mc = stft_cuda.mixed_constants(cfg, FS, "cpu")
    plan = tstft.fft_plan(8160)
    assert mc.window.shape == (8160,) and mc.wts.shape == (4081,)
    assert mc.perm.dtype == torch.int32 and mc.perm.shape == (4080,)
    assert mc.twiddles.dtype == torch.float64
    assert np.array_equal(mc.twiddles.numpy(), plan.twiddles)
    assert mc.stages.dtype == np.int32 and mc.stages.flags.c_contiguous
    assert mc.split == plan.split
    assert stft_cuda.mixed_constants(cfg, FS, "cpu") is mc      # cached


CSRC = os.path.join(os.path.dirname(stft_cuda.__file__), "csrc",
                    "stft_psd.cu")


def _cuda_constant(name):
    with open(CSRC) as fh:
        m = re.search(rf"constexpr int {name} = (\d+);", fh.read())
    return int(m.group(1))


def test_generic_stage_rounds_fit_the_block():
    """Every nperseg from 32 to 8192 that :func:`route` sends to the
    mixed-radix kernel (even) or the odd kernel is a plan its launcher
    takes: at most MIX_MAX_STAGES stages, odd radices up to MIX_MAX_RADIX
    (the constants of csrc/stft_psd.cu, which the host's MAX_MIXED_RADIX
    repeats), stages that multiply to the transform length (less one under
    a Rader stage). The mixed kernel's block of MIX_THREADS threads gives
    each of a generic butterfly's (p + 1)/2 output pairs a thread; the
    pass engine's, ``conv_plan``'s (``ConvRegisters``, width the transform
    length), does so on the odd plans and on every Rader plan, the mixed
    route's 405 among them, in whole warps up to FFT_MAX_THREADS with a
    round of each generic pass at least (odd nperseg 193: p = 193 needs 97
    threads, where K/4 gives 96)."""
    from test_torch_conv_registers import ConvRegisters
    max_radix = _cuda_constant("MIX_MAX_RADIX")
    max_stages = _cuda_constant("MIX_MAX_STAGES")
    max_threads = _cuda_constant("FFT_MAX_THREADS")
    mix_threads = _cuda_constant("MIX_THREADS")
    assert max_radix == stft_cuda.MAX_MIXED_RADIX == tstft.MAX_MIXED_RADIX
    routes = {k: stft_cuda.route(SpecConfig(nperseg=k, hop=k // 4,
                                            detrend="constant"))
              for k in range(32, 8193)}
    mixed = [k for k, r in routes.items() if r == "mixed"]
    odd = [k for k, r in routes.items() if r == "odd"]
    assert set(MIXED_GUI) <= set(mixed) and 386 in mixed
    assert all(k % 2 == 0 for k in mixed) and all(k % 2 for k in odd)
    assert len(mixed) == 2660 + 405 and len(odd) == 1999 + 699
    rader = 0
    for k in mixed + odd:
        n = tstft.transform_length(k)
        factors = tstft.plan_radices(k)
        r = tstft.rader_prime(n)
        rader += r
        assert int(np.prod(factors)) == n - r
        assert len(factors) <= max_stages
        assert all(p == 2 or 3 <= p <= max_radix for p in factors)
        if k % 2 == 0 and not r:
            assert all((p + 1) // 2 <= mix_threads for p in factors)
            continue
        cr = ConvRegisters(tstft.fft_plan(k).stages.tolist(), n - r, r, n,
                           r and k % 2 == 0)
        assert cr.threads % 32 == 0 and cr.threads <= max_threads
        assert all((p + 1) // 2 <= cr.threads for p in factors)
        for ps in cr.passes:
            if ps.radix % 2 and ps.radix > 7:
                assert cr.rounds(ps)[2] >= 1, (k, ps.radix)
    assert rader == 405 + 699
    assert ConvRegisters([[193, 1, 0, 0]], 193, False, 193).threads == 128


@pytest.mark.parametrize("detrend", ["none", "constant", "linear"])
@pytest.mark.parametrize("nperseg", [96, 100, 160, 224, 352, 386, 960, 992])
def test_mixed_model_matches_plain_version(nperseg, detrend):
    cfg = _config(nperseg, detrend)
    assert stft_cuda.route(cfg) == "mixed"
    # half the ramp: the plain version's own rounding grows with the
    # samples' size (module docstring)
    x = _clips(20 + nperseg, cfg, trend=0.5)
    want = _plain(x, cfg)
    got = _model(x, cfg)
    assert got.shape == want.shape and got.shape[1] >= 7
    _assert_close(got, want, F64_TOL)
    # and as the kernel stores it: float32, against the plain version's
    # float32 (both round once)
    plain32 = stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg).numpy()
    _assert_close(_model(x, cfg, round_f32=True), plain32, 1.2e-7)


def test_mixed_model_two_sided():
    """onesided=False: the epilogue reads all K bins of the transform."""
    cfg = SpecConfig(nperseg=960, hop=240, window="hann", detrend="none",
                     onesided=False)
    assert stft_cuda.route(cfg) == "mixed" and cfg.n_freqs == 960
    x = _clips(60, cfg)
    _assert_close(_model(x, cfg), _plain(x, cfg), F64_TOL)


@pytest.mark.parametrize("detrend", ["none", "constant", "linear"])
@pytest.mark.parametrize("nperseg", [96, 352])
def test_mixed_model_matches_pallas_kernel(nperseg, detrend):
    """The Pallas kernel sums in float32: offset 1 and a twentieth of the
    ramp, as ``tests/test_torch_fft.py`` holds the radix-2 model to it."""
    cfg = _config(nperseg, detrend)
    x = _clips(40 + nperseg, cfg, offset=0.0 if detrend == "none" else 1.0,
               trend=0.05)
    psd_j, lo_j, hi_j = (np.asarray(a) for a in jax.jit(
        lambda v: stft_pallas.stft_psd_pallas(v, FS, _jax(cfg),
                                              with_stats=True))(
            jnp.asarray(x)))
    got = _model(x, cfg, round_f32=True)
    assert got.shape == psd_j.shape
    _assert_close(got, psd_j, PSD_TOL)
    np.testing.assert_allclose(got.max(axis=(1, 2)), hi_j, rtol=1e-5)
    assert np.all(np.abs(got.min(axis=(1, 2)) - lo_j) <= PSD_TOL * hi_j)


@pytest.mark.parametrize("nperseg", [8032, 8160])
def test_mixed_model_scipy_within_the_display_contract(nperseg):
    """The GUI's largest prime (8032 = 32 · 251) and its largest value that
    is not a power of two (8160, M = 2^4 · 3 · 5 · 17)."""
    cfg = SpecConfig.scipy_default(nperseg)
    x = _clips(61, cfg, n_clips=1)
    psd = _model(x, cfg, round_f32=True)[0]
    assert psd.dtype == np.float32 and psd.shape == (9, nperseg // 2 + 1)
    err = torch_precision.display_error_db(psd.T, x[0].astype(np.float64),
                                           cfg)
    assert err <= 1e-6, err


def test_mixed_model_nan_and_overflow_like_the_plain_version():
    """A NaN sample makes its frames' every bin NaN, and |X|² past
    float32's range is inf, as in the other routes."""
    cfg = _config(992, "constant")
    x = _clips(62, cfg)
    x[0, 700] = np.nan
    x[1] *= 1e19
    want = stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg).numpy()
    got = _model(x, cfg, round_f32=True)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0]).any() and np.isinf(got[1]).any()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    scale = np.nanmax(np.where(ok, want, np.nan), axis=(1, 2))[:, None, None]
    with np.errstate(invalid="ignore"):
        diff = np.where(ok, got - want, 0.0)
    assert np.all(np.abs(diff) <= 1.2e-7 * scale)


@pytest.mark.parametrize("nperseg", [992, 8032, 8160])
def test_mixed_model_linear_detrend_within_the_display_contract(nperseg):
    """Under linear detrend on a ramp clip, against scipy's
    detrend='linear' in float64: 1e-6 dB, as the other detrends (8160 and
    8032 are chip_smoke.py's path 6 and the GUI's largest prime)."""
    cfg = dataclasses.replace(SpecConfig.scipy_default(nperseg),
                              detrend="linear")
    assert stft_cuda.route(cfg) == "mixed"
    x = _clips(65, cfg, n_clips=1)
    psd = _model(x, cfg, round_f32=True)[0]
    err = torch_precision.display_error_db(psd.T, x[0].astype(np.float64),
                                           cfg)
    assert err <= 1e-6, err


@pytest.mark.parametrize("nperseg, nfft, detrend, onesided", [(1000, 1536, "constant", True), (700, 960, "linear", False),
     (500, 514, "none", False)])
def test_mixed_model_zero_padded_load_and_output_modes(nperseg, nfft, detrend, onesided):
    """The mixed-radix model's zero-padded load through the digit
    reversal, a Rader plan's (nfft 514) through the Rader order, and the
    magnitude and complex outputs of the split epilogue, one- and
    two-sided, against the plain version
    (test_torch_ext_modes.check_model_modes)."""
    from test_torch_ext_modes import check_model_modes
    cfg = SpecConfig(nperseg=nperseg, hop=max(1, nperseg // 2), nfft=nfft,
                     detrend=detrend, onesided=onesided)
    assert stft_cuda.route(cfg) == "mixed"
    check_model_modes(cfg)
