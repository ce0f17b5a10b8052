"""Gradients through the port's spectrogram front-end, held to the JAX
package's on the CPU.

The JAX package is differentiable end to end (tests/test_differentiability.py:
jax.grad through ``power_spectrogram``, the mel product and ``normalize``;
``batched_spectrogram_fn`` is jnp and XLA throughout). The port's kernels
carry autograd Functions whose backward is a CUDA kernel on the card and,
on a CPU tensor, a plain version written out as torch arithmetic
(``ops/stft_cuda.py::stft_backward_reference``,
``ops/mel_cuda.py::mel_backward_reference``,
``ops/display_cuda.py::display_backward_reference``). Here, on seeded
numpy inputs:

- the port's gradients against ``jax.grad`` of the JAX counterparts, within
  1e-4 of the largest |gradient| (JAX computes in float32; the log-scale
  image of a full band is held to JAX in float64, see
  :func:`test_pipeline_log_image_grad_matches_jax_float64`);
- against central finite differences (rel 2e-2, as
  tests/test_differentiability.py);
- ``torch.autograd.gradcheck`` in float64 on each Function's plain backward;
- each explicit plain backward against torch autograd of its plain
  forward, 1e-12 in float64;
- complex outputs only through real losses (torch's gradient of a complex
  tensor is the conjugate of JAX's);
- no grad asked, nothing saved; ``log10_out`` with grad refused.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from spectral_tpu.config import SpecConfig as JaxSpecConfig  # noqa: E402
from spectral_tpu.core import stft as jstft  # noqa: E402
from spectral_tpu.parallel.sharding import (  # noqa: E402
    batched_spectrogram_fn as jax_pipeline)

from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.core import stft as tstft  # noqa: E402
from spectral_tpu_torch.core.mel import mel_filterbank  # noqa: E402
from spectral_tpu_torch.ops import display_cuda, mel_cuda, stft_cuda  # noqa: E402
from spectral_tpu_torch.parallel.sharding import (  # noqa: E402
    batched_spectrogram_fn)

FS = 1000.0
TOL = 1e-4          # of the largest |gradient|; JAX computes in float32
EXACT = 1e-12       # plain backward against autograd, float64
NS = SpecConfig.north_star(64, 16)


def jcfg(cfg):
    return JaxSpecConfig.from_json(cfg.to_json())


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def signal(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def weights(seed, shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def port_grad(fn, x):
    """The gradient of the real loss fn(x) by x (numpy in, numpy out)."""
    xt = torch.from_numpy(np.array(x)).requires_grad_()
    fn(xt).backward()
    return xt.grad.numpy()


def jax_grad(fn, x):
    return np.asarray(jax.grad(fn)(jnp.asarray(x)))


# ---------------------------------------------------------------------------
# the PSD and the magnitude, against jax.grad
# ---------------------------------------------------------------------------

PSD_CONFIGS = {
    "north_star": NS,
    "magnitude": dataclasses.replace(NS, mode="magnitude"),
    "two_sided": dataclasses.replace(NS, onesided=False),
    "nfft": dataclasses.replace(NS, nfft=128),
    "centered": dataclasses.replace(NS, center=True, pad_mode="reflect"),
    "linear": SpecConfig(nperseg=48, hop=12, detrend="linear"),
    "constant": SpecConfig.scipy_default(64),
    "gemm": SpecConfig.scipy_default(24),
    "odd": SpecConfig.scipy_default(45),
}


@pytest.mark.parametrize("name", sorted(PSD_CONFIGS))
@pytest.mark.parametrize("use_matmul", [False, True])
def test_power_spectrogram_grad_matches_jax(name, use_matmul):
    """core/stft.py::power_spectrogram (the dense route on the CPU) and
    ops/stft_cuda.py::stft_psd (the kernels' Function, its plain
    backward) against jax.grad of the JAX package's power_spectrogram on
    both its engines."""
    cfg = PSD_CONFIGS[name]
    x = signal(3, (2, 600))
    c = weights(4, tuple(tstft.power_spectrogram(torch.from_numpy(x), FS,
                                                 cfg).shape))
    want = jax_grad(lambda v: jnp.sum(jstft.power_spectrogram(
        v, FS, jcfg(cfg), use_matmul=use_matmul) * c), x)
    dense = port_grad(lambda v: (tstft.power_spectrogram(v, FS, cfg)
                                 * torch.from_numpy(c)).sum(), x)
    fn = port_grad(lambda v: (stft_cuda.stft_psd(v, FS, cfg)
                              * torch.from_numpy(c)).sum(), x)
    assert rel_err(dense, want) <= TOL
    assert rel_err(fn, want) <= TOL


@pytest.mark.parametrize("flip", [False, True])
def test_power_spectrogram_fm_band_grad_matches_jax(flip):
    """The freq-major PSD with a band and the display flip."""
    x = signal(5, (2, 700))
    band = (3, 17)
    c = weights(6, (2, 14, 40))
    want = jax_grad(lambda v: jnp.sum(jstft.power_spectrogram_fm(
        v, FS, jcfg(NS), use_matmul=True, flip_freqs=flip, band=band) * c), x)
    got = port_grad(lambda v: (tstft.power_spectrogram_fm(
        v, FS, NS, flip_freqs=flip, band=band) * torch.from_numpy(c)).sum(), x)
    def fm(v):
        p = stft_cuda.stft_psd(v, FS, NS, band=band).transpose(-1, -2)
        return p.flip(-2) if flip else p

    fn = port_grad(lambda v: (fm(v) * torch.from_numpy(c)).sum(), x)
    assert rel_err(got, want) <= TOL
    assert rel_err(fn, want) <= TOL


# ---------------------------------------------------------------------------
# the complex STFT, through real losses only
# ---------------------------------------------------------------------------

STFT_CONFIGS = {
    "north_star": NS,
    "two_sided": dataclasses.replace(NS, onesided=False),
    "nfft": dataclasses.replace(NS, nfft=100),
    "centered": dataclasses.replace(NS, center=True, pad_mode="constant"),
    "constant": SpecConfig.scipy_default(40),
}


def _real_losses(shape, seed):
    u, v, c = (weights(seed + i, shape) - 0.5 for i in range(3))

    def torch_losses(z):
        return ((z.real * torch.from_numpy(u) + z.imag * torch.from_numpy(v))
                .sum(), (z.abs() ** 2 * torch.from_numpy(c)).sum())

    def jax_losses(z):
        return (jnp.sum(z.real * u + z.imag * v),
                jnp.sum(jnp.abs(z) ** 2 * c))

    return torch_losses, jax_losses


@pytest.mark.parametrize("name", sorted(STFT_CONFIGS))
@pytest.mark.parametrize("which", [0, 1])
def test_stft_grad_matches_jax_through_real_losses(name, which):
    """core/stft.py::stft (the kernels' complex epilogue, unscaled) against
    jax.grad of the JAX stft, by sum(Re z u + Im z v) and sum(|z|^2 c):
    real losses, never the raw complex gradients (torch's is the
    conjugate of JAX's)."""
    cfg = STFT_CONFIGS[name]
    x = signal(7, (2, 500))
    shape = tuple(tstft.stft(torch.from_numpy(x), cfg).shape)
    tl, jl = _real_losses(shape, 8)
    want = jax_grad(lambda v: jl(jstft.stft(v, jcfg(cfg), use_matmul=True))
                    [which], x)
    got = port_grad(lambda v: tl(tstft.stft(v, cfg))[which], x)
    assert rel_err(got, want) <= TOL


SPECTROGRAM_CONFIGS = {
    "psd": SpecConfig.scipy_default(64),
    "magnitude": dataclasses.replace(SpecConfig.scipy_default(64),
                                     mode="magnitude"),
    "complex": dataclasses.replace(SpecConfig.scipy_default(64),
                                   mode="complex"),
    "band": SpecConfig.scipy_default(64, fmin=50.0, fmax=240.0),
    "band_magnitude": dataclasses.replace(
        SpecConfig.scipy_default(64, fmin=50.0, fmax=240.0),
        mode="magnitude"),
    "band_complex": dataclasses.replace(
        SpecConfig.scipy_default(64, fmin=50.0, fmax=240.0), mode="complex"),
    "two_sided_band": dataclasses.replace(
        SpecConfig.scipy_default(64, fmin=50.0, fmax=240.0),
        onesided=False),
    "centered": dataclasses.replace(NS, center=True, pad_mode="edge"),
    "nfft": dataclasses.replace(SpecConfig.scipy_default(64), nfft=96),
}


@pytest.mark.parametrize("name", sorted(SPECTROGRAM_CONFIGS))
def test_spectrogram_grad_matches_jax(name):
    """spectrogram in each mode, with a band (the kernels' band, and
    mask_band_rows' gather on a two-sided axis), centered and zero-padded,
    against jax.grad of the JAX spectrogram."""
    cfg = SPECTROGRAM_CONFIGS[name]
    x = signal(9, (2, 640))
    sxx = tstft.spectrogram(torch.from_numpy(x), FS, cfg)[2]
    if cfg.mode == "complex":
        tl, jl = _real_losses(tuple(sxx.shape), 10)
        tloss = lambda z: sum(tl(z))                          # noqa: E731
        jloss = lambda z: sum(jl(z))                          # noqa: E731
    else:
        c = weights(10, tuple(sxx.shape))
        tloss = lambda s: (s * torch.from_numpy(c)).sum()     # noqa: E731
        jloss = lambda s: jnp.sum(s * c)                      # noqa: E731
    want = jax_grad(lambda v: jloss(jstft.spectrogram(
        v, FS, jcfg(cfg), use_matmul=True)[2]), x)
    got = port_grad(lambda v: tloss(tstft.spectrogram(v, FS, cfg)[2]), x)
    assert rel_err(got, want) <= TOL


# ---------------------------------------------------------------------------
# the pipeline: psd, mel and image
# ---------------------------------------------------------------------------

PIPE = {
    "log": SpecConfig.north_star(64, 16, log_scale=True),
    "linear": SpecConfig.north_star(64, 16),
    "mel_log": dataclasses.replace(
        SpecConfig.north_star(128, 32, log_scale=True), n_mels=16),
    "mel_band_log": dataclasses.replace(
        SpecConfig.north_star(128, 32, log_scale=True, fmin=50.0,
                              fmax=350.0), n_mels=16),
    "band_log": SpecConfig.north_star(64, 16, log_scale=True, fmin=50.0,
                                      fmax=300.0),
    "scipy_band": SpecConfig.scipy_default(64, fmin=0.0, fmax=120.0),
}


def _pipeline_grads(cfg, key, flip, share, seed=11, x64=False):
    x = signal(seed, (3, 1500))
    fn = batched_spectrogram_fn(FS, cfg, flip_image=flip, share_max=share,
                                device="cpu")
    c = weights(seed + 1, tuple(fn(torch.from_numpy(x))[key].shape))
    got = port_grad(lambda v: (fn(v)[key] * torch.from_numpy(c)).sum(), x)
    jf = jax_pipeline(FS, jcfg(cfg), flip_image=flip, share_max=share)
    if x64:
        with jax.enable_x64(True):
            want = jax_grad(lambda v: jnp.sum(jf(v)[key] * c),
                            x.astype(np.float64))
    else:
        want = jax_grad(lambda v: jnp.sum(jf(v)[key] * c), x)
    return got, want


# the log-scale images of PSD bins go to JAX in float64 (below)
LOG_BINS = ("log", "band_log")
PIPE_CASES = [
    (name, key, flip, share)
    for name in sorted(PIPE)
    for key in ("psd", "mel", "image") if key != "mel" or PIPE[name].n_mels
    if not (key == "image" and name in LOG_BINS)
    for flip, share in ((False, False), (True, True), (True, False))
]


@pytest.mark.parametrize("name,key,flip,share", PIPE_CASES)
def test_pipeline_grad_matches_jax(name, key, flip, share):
    """batched_spectrogram_fn's psd, mel and image (linear, or log over
    mel rows) through the three Functions' plain backward, against
    jax.grad of the JAX pipeline (use_matmul=True) in float32."""
    got, want = _pipeline_grads(PIPE[name], key, flip, share)
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("name", LOG_BINS)
@pytest.mark.parametrize("flip,share", [(False, False), (True, True)])
def test_pipeline_log_image_grad_matches_jax_float64(name, flip, share):
    """The log-scale image of PSD bins: its gradient runs through
    1 / (each pixel's PSD), so the clip's deepest bins carry most of it,
    and JAX's float32 PSD holds those bins to a few percent (its DFT sums
    round at the clip's largest bins' scale), which moves JAX's float32
    gradient up to about 1.6e-4 of its largest entry on white-noise clips
    (ROADMAP queue 3, "In the reference"). The port computes the PSD in
    float64 and rounds once, so it is held to JAX run in float64."""
    got, want = _pipeline_grads(PIPE[name], "image", flip, share, x64=True)
    assert rel_err(got, want) <= TOL


def test_pipeline_outputs_without_a_gradient():
    """rgb_packed, index_packed and finite carry no gradient, as in JAX."""
    x = torch.from_numpy(signal(12, (2, 900))).requires_grad_()
    out = batched_spectrogram_fn(FS, PIPE["log"], device="cpu")(x)
    assert out["psd"].requires_grad and out["image"].requires_grad
    assert not out["rgb_packed"].requires_grad
    assert not out["finite"].requires_grad
    pal = batched_spectrogram_fn(FS, PIPE["log"], palette=True,
                                 device="cpu")(x)
    assert not pal["index_packed"].requires_grad


# ---------------------------------------------------------------------------
# finite differences
# ---------------------------------------------------------------------------

def _central_differences(loss, x, coords, eps=1e-3):
    out = []
    for i in coords:
        e = np.zeros_like(x)
        e.flat[i] = eps
        out.append((loss(x + e) - loss(x - e)) / (2 * eps))
    return np.array(out)


FD_CASES = {
    "psd": (NS, "psd"),
    "magnitude": (dataclasses.replace(NS, mode="magnitude"), "psd"),
    "complex": (SpecConfig.scipy_default(64), "complex"),
    "image_log": (SpecConfig.north_star(64, 16, log_scale=True), "image"),
    "mel_image": (dataclasses.replace(
        SpecConfig.north_star(64, 16, log_scale=True), n_mels=12), "image"),
}


@pytest.mark.parametrize("name", sorted(FD_CASES))
def test_grad_matches_finite_differences(name):
    """The Functions' gradients against central finite differences on a
    few coordinates (float64 waveform, so the differences are not float32
    noise), rel 2e-2 as tests/test_differentiability.py."""
    cfg, kind = FD_CASES[name]
    x = signal(13, (1, 400)).astype(np.float64)
    c = None

    def loss_t(v):
        nonlocal c
        if kind == "complex":
            z = stft_cuda.stft_complex(v, FS, cfg)
            out = z.real * 0.7 - z.imag * 0.3
        elif kind == "psd":
            out = stft_cuda.stft_psd(v, FS, cfg)
        else:
            out = batched_spectrogram_fn(FS, cfg, device="cpu")(v)["image"]
        if c is None:
            c = torch.from_numpy(weights(14, tuple(out.shape))).double()
        return (out * c).sum()

    g = port_grad(loss_t, x)
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    coords = (0, 57, 200, 399)
    num = _central_differences(
        lambda v: float(loss_t(torch.from_numpy(v))), x, coords)
    for got, want in zip(g.ravel()[list(coords)], num):
        assert got == pytest.approx(want, rel=2e-2, abs=1e-6)


# ---------------------------------------------------------------------------
# gradcheck, and the explicit plain backward against autograd
# ---------------------------------------------------------------------------

FN_CONFIGS = {
    "psd": NS,
    "magnitude": dataclasses.replace(NS, mode="magnitude"),
    "two_sided": dataclasses.replace(NS, onesided=False),
    "nfft": dataclasses.replace(NS, nfft=80),
    "linear": SpecConfig(nperseg=40, hop=13, detrend="linear"),
    "gemm": SpecConfig.scipy_default(20),
    "magnitude_constant": dataclasses.replace(SpecConfig.scipy_default(48),
                                              mode="magnitude"),
}
BANDS = {"psd": (2, 9), "nfft": (5, 30), "linear": (0, 4)}


def _x64(seed, shape):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape))


@pytest.mark.parametrize("name", sorted(FN_CONFIGS))
def test_stft_function_gradcheck(name):
    """gradcheck of the STFT Function's plain backward in float64, with
    its band where the config has one and its partials beside it."""
    cfg = FN_CONFIGS[name]
    band = BANDS.get(name)
    x = _x64(15, (2, 170)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda v: stft_cuda.stft_psd(v, FS, cfg, band=band), (x,))
    assert torch.autograd.gradcheck(
        lambda v: stft_cuda.stft_psd_partials(v, FS, cfg, band)[0], (x,))


@pytest.mark.parametrize("name", ["psd", "two_sided", "nfft", "linear",
                                  "gemm"])
@pytest.mark.parametrize("scaled", [False, True])
def test_stft_complex_function_gradcheck(name, scaled):
    """gradcheck of the complex output through its real view."""
    cfg = FN_CONFIGS[name]
    x = _x64(16, (2, 150)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda v: torch.view_as_real(stft_cuda.stft_complex(
            v, FS, cfg, BANDS.get(name), scaled=scaled)), (x,))


@pytest.mark.parametrize("name", sorted(FN_CONFIGS))
@pytest.mark.parametrize("out", ["psd", "complex", "stft"])
def test_stft_plain_backward_is_autograd_of_the_plain_forward(name, out):
    """stft_backward_reference (explicit torch arithmetic that mirrors
    the kernels) against torch autograd through stft_psd_reference /
    stft_complex_reference, in float64."""
    cfg = FN_CONFIGS[name]
    band = BANDS.get(name)
    out_name = cfg.mode if out == "psd" else out
    consts = stft_cuda.dft_constants(cfg, FS, "cpu", band, out_name)
    x = _x64(17, (3, 230)).requires_grad_()
    if out == "psd":
        y = stft_cuda.stft_psd_reference(x, consts, cfg)
        g = torch.from_numpy(np.random.RandomState(18).rand(*y.shape))
        loss = (y * g).sum()
    else:
        y = stft_cuda.stft_complex_reference(x, consts, cfg)
        rs = np.random.RandomState(18)
        g = torch.complex(torch.from_numpy(rs.randn(*y.shape)),
                          torch.from_numpy(rs.randn(*y.shape)))
        loss = (y.real * g.real + y.imag * g.imag).sum()
    loss.backward()
    got = stft_cuda.stft_backward_reference(x.detach(), g, consts, cfg,
                                            out_name)
    assert rel_err(got.numpy(), x.grad.numpy()) <= EXACT


def test_overlap_add_reference_is_the_framing_adjoint():
    """overlap_add_reference against autograd of unfold, hop below, at and
    past the frame, the signal's tail past the last frame."""
    for hop in (3, 8, 11):
        x = _x64(19, (2, 61)).requires_grad_()
        frames = x.unfold(-1, 8, hop)
        d = _x64(20, tuple(frames.shape))
        (frames * d).sum().backward()
        got = stft_cuda.overlap_add_reference(d, 61, hop)
        assert torch.allclose(got, x.grad, rtol=0, atol=1e-14)


def _mel_spans(n_mels=12, F=33, band=(2, 11)):
    fb = mel_filterbank(n_mels, F, FS)[band[0]:band[1]]
    return mel_cuda.mel_spans(fb, "cpu")


def test_mel_function_gradcheck_and_plain_backward():
    spans = _mel_spans()
    psd = torch.from_numpy(np.random.RandomState(21).rand(2, 7, 33))
    psd.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda p: mel_cuda.mel_project(p, spans)[0], (psd,))
    mel, parts = mel_cuda.mel_project(psd, spans)
    assert not parts.requires_grad
    dmel = torch.from_numpy(np.random.RandomState(22).randn(*mel.shape))
    (mel * dmel).sum().backward()
    want = psd.grad.clone()
    psd.grad = None
    (mel_cuda.mel_project_reference(psd, spans)[0] * dmel).sum().backward()
    got = mel_cuda.mel_backward_reference(dmel, spans)
    assert rel_err(got.numpy(), psd.grad.numpy()) <= EXACT
    assert rel_err(want.numpy(), psd.grad.numpy()) <= EXACT


def test_mel_bin_table_transposes_the_spans():
    """bin_table lists, for each bin, exactly the rows whose span holds
    it, ascending, with the filterbank's weights (the kernel's operand),
    and bins no span holds have none."""
    fb = mel_filterbank(40, 129, 8000.0)[4:33]
    start, count, row, weight = mel_cuda.bin_table(fb)
    s0, length, _, _ = mel_cuda.span_table(fb)
    for f in range(fb.shape[1]):
        rows = row[start[f]:start[f] + count[f]]
        want = [m for m in range(len(fb))
                if s0[m] <= f < s0[m] + length[m]]
        assert rows.tolist() == want
        assert np.array_equal(weight[start[f]:start[f] + count[f]],
                              fb[want, f])
    assert (count == 0).any()          # bins past the band's last row


def test_mel_backward_reference_is_dense_on_non_finite_gradients():
    """The plain backward is the dense product: a non-finite gradient of a
    mel row makes every bin outside its span NaN (0 * inf), which the
    kernel reproduces by counting non-finite rows."""
    spans = _mel_spans()
    dmel = torch.zeros((1, 1, 9), dtype=torch.float64)
    dmel[0, 0, 4] = np.inf
    got = mel_cuda.mel_backward_reference(dmel, spans)[0, 0]
    lo, n = int(spans.start[4]), int(spans.length[4])
    inside = torch.zeros(33, dtype=torch.bool)
    inside[lo:lo + n] = True
    assert torch.isnan(got[~inside]).all()
    assert not torch.isnan(got[inside][spans.rows[4, lo:lo + n] > 0]).any()


DISPLAY_CASES = [(log, flip, share) for log in (False, True)
                 for flip in (False, True) for share in (False, True)]


def _display_inputs(seed, B=3, T=9, F=6, ties=False):
    """Distinct PSD values well apart (a permutation of a grid), so that
    gradcheck's steps cross no extremum and no clip bound."""
    rs = np.random.RandomState(seed)
    grid = 0.1 + np.stack([rs.permutation(T * F) for _ in range(B)]) / (T * F)
    psd = grid.reshape(B, T, F) * 10.0 ** rs.uniform(-2, 0, (B, 1, 1))
    if ties:
        psd[0, 2, 1] = psd[0].max()
        psd[1, 5, :] = psd[1].min()
    return torch.from_numpy(psd)


def _plain_image(p, log, flip, share):
    stats = display_cuda.clip_stats_reference(
        torch.zeros((p.shape[0], 64), dtype=p.dtype),
        stft_cuda.row_partials(p), share)
    return display_cuda.display_map_reference(
        p, stats.params, log_scale=log, flip_image=flip, colormap=None)[0]


@pytest.mark.parametrize("log,flip,share", DISPLAY_CASES)
def test_display_function_gradcheck_and_plain_backward(log, flip, share):
    """The image's Function in float64: gradcheck, and the explicit plain
    backward against autograd through clip_stats_reference and
    display_map_reference (the operands from the PSD's extrema)."""
    psd = _display_inputs(23 + 4 * log + 2 * flip + share)
    params = display_cuda.clip_stats_reference(
        torch.zeros((3, 64), dtype=torch.float64),
        stft_cuda.row_partials(psd), share).params
    x = psd.clone().requires_grad_()
    g = torch.from_numpy(np.random.RandomState(31).randn(3, 6, 9))
    (_plain_image(x, log, flip, share) * g).sum().backward()
    got = display_cuda.display_backward_reference(
        g, psd, params, log_scale=log, flip_image=flip, share_max=share)
    assert rel_err(got.numpy(), x.grad.numpy()) <= EXACT

    def image(p):
        prm = display_cuda.clip_stats_reference(
            torch.zeros((3, 64), dtype=torch.float64),
            stft_cuda.row_partials(p.detach()), share).params
        return display_cuda.display_map(p, prm, log_scale=log,
                                        flip_image=flip, colormap=None,
                                        share_max=share)[0]

    assert torch.autograd.gradcheck(image, (psd.clone().requires_grad_(),))


@pytest.mark.parametrize("log", [False, True])
@pytest.mark.parametrize("share", [False, True])
def test_display_backward_splits_ties_like_jax(log, share):
    """Tied maxima and minima: the operands' gradient is split evenly among
    every tied pixel of the clip (and of the batch under share_max), as
    jax.grad of the JAX package's normalize splits it."""
    from spectral_tpu.core.scale import normalize_batch
    psd = _display_inputs(41, ties=True).float()
    g = np.random.RandomState(42).randn(3, 6, 9).astype(np.float32)
    params = display_cuda.clip_stats_reference(
        torch.zeros((3, 64)), stft_cuda.row_partials(psd), share).params
    got = display_cuda.display_backward_reference(
        torch.from_numpy(g), psd, params, log_scale=log, share_max=share)
    want = jax_grad(lambda p: jnp.sum(normalize_batch(
        jnp.swapaxes(p, 1, 2), log, share) * g), psd.numpy())
    assert rel_err(got.numpy(), want) <= TOL


# ---------------------------------------------------------------------------
# the magnitude at |X| = 0
# ---------------------------------------------------------------------------

MAG0 = dataclasses.replace(SpecConfig.north_star(64, 16, mode="magnitude"),
                           detrend="constant")


def test_magnitude_zero_bins_take_the_minimal_norm_subgradient():
    """A constant stretch under constant detrend: its frames are exactly
    zero once their mean is out, so |X| = 0 at every bin. The port's
    convention (the kernels' and the plain backward's): such a bin
    contributes 0. With zero loss weight on those frames the gradient is
    JAX's matmul engine's (its TPU default, finite there; its rfft engine
    gives NaN, ROADMAP queue 3); with a nonzero weight it is finite and
    the same as with their weight zeroed."""
    x = signal(50, (1, 400))
    x[0, 100:260] = 0.7
    p = stft_cuda.stft_psd(torch.from_numpy(x), FS, MAG0)
    zero = (p == 0).all(-1)[0]
    assert zero.sum() >= 5
    c = weights(51, tuple(p.shape))
    c0 = c.copy()
    c0[0, zero.numpy()] = 0.0
    want = jax_grad(lambda v: jnp.sum(jstft.power_spectrogram(
        v, FS, jcfg(MAG0), use_matmul=True) * c0[0]), x[0])
    got0 = port_grad(lambda v: (stft_cuda.stft_psd(v, FS, MAG0)
                                * torch.from_numpy(c0)).sum(), x)
    got = port_grad(lambda v: (stft_cuda.stft_psd(v, FS, MAG0)
                               * torch.from_numpy(c)).sum(), x)
    assert rel_err(got0[0], want) <= TOL
    assert np.isfinite(got).all()
    assert np.array_equal(got, got0)


# ---------------------------------------------------------------------------
# no gradient asked; refusals
# ---------------------------------------------------------------------------

def _saved_count(fn):
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        out = fn()
    return out, len(saved)


def test_no_grad_asked_saves_nothing_and_builds_no_graph():
    x = torch.from_numpy(signal(60, (2, 900)))
    calls = {
        "stft_psd": lambda v: stft_cuda.stft_psd(v, FS, NS),
        "partials": lambda v: stft_cuda.stft_psd_partials(v, FS, NS)[0],
        "complex": lambda v: stft_cuda.stft_complex(v, FS, NS),
        "pipeline": lambda v: batched_spectrogram_fn(
            FS, PIPE["mel_log"], device="cpu")(v)["image"],
    }
    for name, call in calls.items():
        out, n = _saved_count(lambda: call(x))
        assert n == 0 and out.grad_fn is None, name
        with torch.no_grad():
            out, n = _saved_count(lambda: call(x.clone().requires_grad_()))
        assert n == 0 and out.grad_fn is None, name
    # with grad: the STFT Function saves the waveform alone
    out, n = _saved_count(
        lambda: stft_cuda.stft_psd(x.clone().requires_grad_(), FS, NS))
    assert n == 1 and out.grad_fn is not None


def test_log10_out_with_grad_raises():
    x = torch.from_numpy(signal(61, (2, 500))).requires_grad_()
    with pytest.raises(ValueError, match=r"\[grad\]"):
        stft_cuda.stft_psd(x, FS, NS, log10_out=True)
    # without grad it runs as before
    assert stft_cuda.stft_psd(x.detach(), FS, NS, log10_out=True).shape[-1] \
        == NS.n_freqs


def test_extrema_and_partials_carry_no_gradient():
    x = torch.from_numpy(signal(62, (2, 500))).requires_grad_()
    p, lo, hi = stft_cuda.stft_psd(x, FS, NS, with_stats=True)
    assert p.requires_grad and not lo.requires_grad and not hi.requires_grad
    p, parts = stft_cuda.stft_psd_partials(x, FS, NS)
    assert p.requires_grad and not parts.requires_grad
    p.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
