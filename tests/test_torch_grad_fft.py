"""The STFT backward on the radix-2 route (``stft_fft_backward_kernel``),
held on the CPU to the dense backward and to the JAX package.

The kernel recomputes X on the forward's radix-2 engine and takes the
transform's adjoint as a c2r transform (``csrc/stft_grad.cu``); its plain
version is ``ops/stft_cuda.py::frames_backward_fft_reference`` (torch.fft
in float64). Here, on seeded numpy inputs:

- the plain FFT adjoint against the dense plain backward
  (``frames_backward_reference``, the folded matrices) in float64, within
  EXACT of each clip's largest |d|, over nfft 32-1024, zero-padded
  transforms, every detrend, one- and two-sided spectra, a band, every
  output mode and a frame of equal samples (|X| = 0 in magnitude mode);
- ``backward_route`` on a grid of configs (the radix-2, mixed, odd and
  Bluestein routes' own FFT adjoints; on the GEMM route B1-small at its
  small-K configs, B1 past them, tests/test_torch_grad_small.py);
- the whole backward chain through the plain FFT adjoint (the framing's
  adjoint and the centered pad's after it) against ``jax.grad`` of the JAX
  package's ``power_spectrogram`` and ``stft``, at tests/test_torch_grad.py's
  tolerance;
- the wrapper's dispatch off the CPU (meta tensors): the radix-2 route
  launches the new kernel alone, with no recompute of X and no dense
  operands, the GEMM route past its small-K configs and a forced "dense"
  the dense kernel
  (tests/test_torch_grad_mixed.py does the mixed, odd and Bluestein
  routes);
- the engine that stft_grad.cu copies from stft_psd.cu, and that
  stft_grad_mixed.cu copies from stft_psd.cu and stft_grad.cu, text for
  text.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from spectral_tpu.config import SpecConfig as JaxSpecConfig  # noqa: E402
from spectral_tpu.core import stft as jstft  # noqa: E402

from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.core.stft import center_pad, num_frames  # noqa: E402
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402

FS = 1000.0
EXACT = 1e-12       # of each clip's largest |d|, float64 against float64
TOL = 1e-4          # against JAX (float32), as tests/test_torch_grad.py
NS = SpecConfig.north_star(64, 16)
CSRC = Path(stft_cuda.__file__).resolve().parent / "csrc"


def jcfg(cfg):
    return JaxSpecConfig.from_json(cfg.to_json())


def clip_rel(got, want):
    """The worst clip's largest |Δ| over its largest |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    b = want.shape[0]
    diff = np.abs(got - want).reshape(b, -1).max(axis=1)
    return float((diff / np.abs(want).reshape(b, -1).max(axis=1)).max())


def signal(seed, shape, dtype=np.float64):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def cotangent(seed, shape, out):
    """A seeded gradient of the output: real for the PSD and magnitude,
    complex for the complex outputs."""
    rs = np.random.RandomState(seed)
    g = rs.rand(*shape)
    if out in ("complex", "stft"):
        g = g + 1j * (rs.rand(*shape) - 0.5)
    return torch.from_numpy(g)


# ---------------------------------------------------------------------------
# the plain FFT adjoint against the dense plain backward, float64
# ---------------------------------------------------------------------------

def _adjoint_cases():
    cases = {}
    for k in (32, 64, 256, 1024):
        for det in ("none", "constant", "linear"):
            cases[f"k{k}_{det}"] = (SpecConfig(nperseg=k, hop=k // 4,
                                               detrend=det), "psd", None)
    s64 = SpecConfig.scipy_default(64)
    cases.update({
        "nfft_256_over_64": (dataclasses.replace(s64, nfft=256), "psd",
                             None),
        "nfft_1024_over_1000": (dataclasses.replace(
            SpecConfig.scipy_default(1000), nfft=1024), "psd", None),
        "nperseg_1000_dense_route": (SpecConfig.scipy_default(1000), "psd",
                                     None),
        "two_sided": (dataclasses.replace(NS, onesided=False), "psd", None),
        "two_sided_linear": (dataclasses.replace(
            NS, onesided=False, detrend="linear"), "psd", None),
        "band": (s64, "psd", (3, 10)),
        "two_sided_band": (dataclasses.replace(NS, onesided=False), "psd",
                           (20, 50)),
        "nfft_band": (dataclasses.replace(s64, nfft=256), "psd", (100, 129)),
    })
    for out in ("magnitude", "complex", "stft"):
        cases[f"{out}"] = (s64, out, None)
        cases[f"{out}_two_sided"] = (dataclasses.replace(NS, onesided=False),
                                     out, None)
        cases[f"{out}_two_sided_band"] = (
            dataclasses.replace(NS, onesided=False), out, (40, 64))
        cases[f"{out}_nfft"] = (dataclasses.replace(s64, nfft=128), out,
                                None)
    cases["magnitude_linear"] = (
        dataclasses.replace(s64, detrend="linear"), "magnitude", None)
    return cases


ADJOINT_CASES = _adjoint_cases()


def _dense_frames_grad(g, x, cfg, band, out):
    consts = stft_cuda.dft_constants(cfg, FS, "cpu", band, out)
    X = torch.complex(*stft_cuda._reference_dft(x, consts, cfg))
    return stft_cuda.frames_backward_reference(g, X, consts, out)


@pytest.mark.parametrize("name", sorted(ADJOINT_CASES))
def test_fft_adjoint_matches_the_dense_backward(name):
    """frames_backward_fft_reference (X in float64, H, the c2r transform,
    the window and the detrend's projection) against
    frames_backward_reference (d = H A^T against the folded matrices), both
    in float64."""
    cfg, out, band = ADJOINT_CASES[name]
    x = torch.from_numpy(signal(1, (2, 5 * cfg.nperseg + 37)))
    lo, hi = stft_cuda.check_band(cfg, band)
    T = num_frames(x.shape[-1], cfg.nperseg, cfg.hop_)
    g = cotangent(2, (2, T, hi - lo), out)
    got = stft_cuda.frames_backward_fft_reference(g, x, cfg, FS, band, out)
    want = _dense_frames_grad(g, x, cfg, band, out)
    assert got.dtype == torch.float64
    assert got.shape == (2, T, cfg.nperseg)
    assert clip_rel(got, want) <= EXACT


@pytest.mark.parametrize("detrend", ["constant", "linear"])
def test_fft_adjoint_of_a_frame_of_equal_samples(detrend):
    """Magnitude mode on a frame of equal samples: its detrended X is 0
    exactly, the cotangent there 0 (the minimal-norm subgradient), and the
    frame's gradient 0 in both versions."""
    cfg = dataclasses.replace(SpecConfig.scipy_default(64), mode="magnitude",
                              detrend=detrend)
    x = signal(3, (2, 400))
    x[0, :64] = 0.75
    x = torch.from_numpy(x)
    T = num_frames(400, 64, cfg.hop_)
    g = cotangent(4, (2, T, cfg.n_freqs), "magnitude")
    got = stft_cuda.frames_backward_fft_reference(g, x, cfg, FS)
    want = _dense_frames_grad(g, x, cfg, None, "magnitude")
    assert bool((got[0, 0] == 0).all()) and bool((want[0, 0] == 0).all())
    assert clip_rel(got, want) <= EXACT


def test_fft_adjoint_rounds_once_to_the_waveforms_dtype():
    """A float32 waveform gives float32 d, the float64 result rounded."""
    cfg = SpecConfig.scipy_default(64)
    x = signal(5, (2, 600), np.float32)
    T = num_frames(600, 64, cfg.hop_)
    g = cotangent(6, (2, T, cfg.n_freqs), "psd").float()
    got = stft_cuda.frames_backward_fft_reference(g, torch.from_numpy(x),
                                                  cfg, FS)
    want = stft_cuda.frames_backward_fft_reference(
        g.double(), torch.from_numpy(x.astype(np.float64)), cfg, FS)
    assert got.dtype == torch.float32
    assert torch.equal(got, want.float())


# ---------------------------------------------------------------------------
# backward_route
# ---------------------------------------------------------------------------

ROUTE_GRID = [
    (SpecConfig.scipy_default(k), "fft") for k in (32, 64, 256, 1024, 8192)
] + [
    (SpecConfig.scipy_default(k), "small") for k in (24, 31)
] + [
    (dataclasses.replace(SpecConfig.scipy_default(24), onesided=False),
     "dense"),
] + [
    (SpecConfig.scipy_default(k), "bluestein") for k in (2049, 8185)
] + [
    (SpecConfig.scipy_default(k), "mixed")
    for k in (96, 992, 1000, 8160, 514, 8186)
] + [
    (SpecConfig.scipy_default(k), "odd") for k in (33, 1023, 8191)
] + [
    (dataclasses.replace(SpecConfig.scipy_default(1000), nfft=1024), "fft"),
    (dataclasses.replace(SpecConfig.scipy_default(16), nfft=64), "fft"),
    (dataclasses.replace(SpecConfig.scipy_default(1024), nfft=1536),
     "mixed"),
    (dataclasses.replace(SpecConfig.scipy_default(1024), nfft=2047), "odd"),
    (dataclasses.replace(SpecConfig.scipy_default(8192), nfft=16384),
     "dense"),
    (SpecConfig(nperseg=512, hop=128, detrend="linear"), "fft"),
    (dataclasses.replace(NS, onesided=False, mode="magnitude"), "fft"),
    (dataclasses.replace(NS, center=True, pad_mode="reflect"), "fft"),
]


@pytest.mark.parametrize("cfg,want", ROUTE_GRID,
                         ids=[f"{c.nperseg}_{c.nfft_}_{w}"
                              for c, w in ROUTE_GRID])
def test_backward_route(cfg, want):
    """The radix-2, mixed, odd and Bluestein routes' FFT adjoints exactly
    where the forward's route is that kernel's, by nfft up to 8192,
    whatever the detrend, mode, sides or centering; past nfft 8192 (the
    radix-2 or Bluestein kernel's forward) and on the GEMM route the
    small-K backward where the forward runs its small-K tile (at most 16
    bins at nperseg below 32) and the dense kernel past it."""
    assert stft_cuda.backward_route(cfg) == want
    r = stft_cuda.route(cfg)
    small = cfg.n_freqs <= 16 and cfg.nperseg < 32
    assert want == (r if r in ("fft", "mixed", "odd", "bluestein")
                    and cfg.nfft_ <= 8192
                    else "small" if small else "dense")


def test_backward_route_refuses_what_the_kernels_refuse():
    with pytest.raises(NotImplementedError, match="large-nperseg"):
        stft_cuda.backward_route(SpecConfig.scipy_default(8193))


# ---------------------------------------------------------------------------
# the chain through the plain FFT adjoint against jax.grad
# ---------------------------------------------------------------------------

def fft_chain_grad(x, g, cfg, band=None, out=None):
    """The gradient of the waveform x (numpy) from the gradient g of the
    output: the centered pad, then the plain FFT adjoint and the framing's
    adjoint, then the pad's adjoint by autograd."""
    xt = torch.from_numpy(x).requires_grad_()
    xp = center_pad(xt, cfg)
    xd = xp.detach()
    d = stft_cuda.frames_backward_fft_reference(g, xd, cfg, FS, band, out)
    dxp = stft_cuda.overlap_add_reference(d, xd.shape[-1], cfg.hop_)
    if cfg.center:
        return torch.autograd.grad(xp, xt, dxp)[0].numpy()
    return dxp.numpy()


def jax_grad(fn, x):
    return np.asarray(jax.grad(fn)(jnp.asarray(x)))


PSD_CHAIN = {
    "north_star": NS,
    "magnitude": dataclasses.replace(NS, mode="magnitude"),
    "two_sided": dataclasses.replace(NS, onesided=False),
    "nfft": dataclasses.replace(NS, nfft=128),
    "centered": dataclasses.replace(NS, center=True, pad_mode="reflect"),
    "linear": SpecConfig(nperseg=64, hop=16, detrend="linear"),
    "constant": SpecConfig.scipy_default(64),
    "nperseg_32": SpecConfig.scipy_default(32),
}


@pytest.mark.parametrize("name", sorted(PSD_CHAIN))
@pytest.mark.parametrize("use_matmul", [False, True])
def test_psd_chain_through_the_fft_adjoint_matches_jax(name, use_matmul):
    """The loss sum(psd * c): its gradient through the plain FFT adjoint
    against jax.grad of the JAX package's power_spectrogram on both its
    engines, float32 in."""
    cfg = PSD_CHAIN[name]
    x = signal(3, (2, 600), np.float32)
    shape = tuple(stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg).shape)
    c = np.random.RandomState(4).rand(*shape).astype(np.float32)
    want = jax_grad(lambda v: jnp.sum(jstft.power_spectrogram(
        v, FS, jcfg(cfg), use_matmul=use_matmul) * c), x)
    got = fft_chain_grad(x.astype(np.float64), torch.from_numpy(c).double(),
                         cfg)
    assert clip_rel(got[None], want[None]) <= TOL


STFT_CHAIN = {
    "north_star": NS,
    "two_sided": dataclasses.replace(NS, onesided=False),
    "nfft": dataclasses.replace(NS, nfft=128),
    "centered": dataclasses.replace(NS, center=True, pad_mode="constant"),
    "constant": SpecConfig.scipy_default(64),
}


@pytest.mark.parametrize("name", sorted(STFT_CHAIN))
@pytest.mark.parametrize("which", [0, 1])
def test_stft_chain_through_the_fft_adjoint_matches_jax(name, which):
    """The unscaled STFT z through real losses, sum(Re z u + Im z v) (the
    output's gradient u + i v) and sum(|z|^2 c) (2 c z), through the plain
    FFT adjoint, against jax.grad of the JAX stft."""
    cfg = STFT_CHAIN[name]
    x = signal(7, (2, 500), np.float32)
    z = stft_cuda.stft_complex(torch.from_numpy(x.astype(np.float64)), FS,
                               cfg, scaled=False)
    rs = np.random.RandomState(8)
    u, v, c = (rs.rand(*z.shape) - 0.5 for _ in range(3))
    if which == 0:
        g = torch.from_numpy(u + 1j * v)
        jloss = lambda s: jnp.sum(s.real * u + s.imag * v)  # noqa: E731
    else:
        g = 2 * torch.from_numpy(c) * z
        jloss = lambda s: jnp.sum(jnp.abs(s) ** 2 * c)      # noqa: E731
    want = jax_grad(lambda s: jloss(jstft.stft(s, jcfg(cfg),
                                               use_matmul=True)), x)
    got = fft_chain_grad(x.astype(np.float64), g, cfg, out="stft")
    assert clip_rel(got[None], want[None]) <= TOL


@pytest.mark.parametrize("band", [(5, 20), (0, 33)])
def test_banded_chain_through_the_fft_adjoint_matches_jax(band):
    """The band's bins alone (the kernels' band=(lo, hi)) against jax.grad
    of the JAX package's power_spectrogram_fm with the same band."""
    x = signal(5, (2, 700), np.float32)
    lo, hi = band
    T = num_frames(700, NS.nperseg, NS.hop_)
    c = np.random.RandomState(6).rand(2, hi - lo, T).astype(np.float32)
    want = jax_grad(lambda v: jnp.sum(jstft.power_spectrogram_fm(
        v, FS, jcfg(NS), use_matmul=True, band=band) * c), x)
    g = torch.from_numpy(c).double().transpose(1, 2)
    got = fft_chain_grad(x.astype(np.float64), g, NS, band)
    assert clip_rel(got[None], want[None]) <= TOL


# ---------------------------------------------------------------------------
# the wrapper off the CPU: which kernel the backward reaches
# ---------------------------------------------------------------------------

class _RecordingLib:
    """The backward library's launchers, recording each call and
    succeeding."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.endswith("error_string"):
            return lambda code: b"no error"
        return lambda *args: self.calls.append(name) or 0


class _NoStream:
    cuda_stream = 0


def _fail(*args, **kwargs):
    raise AssertionError("reached off the radix-2 backward")


def _meta_setup(monkeypatch):
    import contextlib
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _NoStream())
    lib = _RecordingLib()
    monkeypatch.setattr(stft_cuda, "_grad_library", lambda: lib)
    return lib


def _meta_op(cfg, out=None, band=None):
    return stft_cuda.GradOp(FS, cfg, band, out or cfg.mode,
                            stft_cuda.route(cfg))


@pytest.mark.parametrize("cfg,out,band", [
    (NS, "psd", None),
    (dataclasses.replace(NS, onesided=False, mode="magnitude"), None,
     (10, 60)),
    (dataclasses.replace(SpecConfig.scipy_default(1000), nfft=1024), "stft",
     None),
    (SpecConfig.scipy_default(8192), "complex", None),
])
def test_radix2_backward_launches_the_fft_kernel_alone(monkeypatch, cfg, out,
                                                       band):
    """On a tensor off the CPU the radix-2 route's backward is one launch of
    stft_fft_backward_launch and the overlap-add: no recompute of X by
    the forward's complex epilogue, no dense operands, no plain version."""
    lib = _meta_setup(monkeypatch)
    monkeypatch.setattr(stft_cuda, "_stft_psd_cuda", _fail)
    monkeypatch.setattr(stft_cuda, "dft_constants", _fail)
    monkeypatch.setattr(stft_cuda, "frames_backward_fft_reference", _fail)
    op = _meta_op(cfg, out, band)
    lo, hi = stft_cuda.check_band(cfg, band)
    n = 4 * cfg.nperseg + 5
    T = num_frames(n, cfg.nperseg, cfg.hop_)
    x = torch.empty((2, n), device="meta")
    cplx = op.out in ("complex", "stft")
    g = torch.empty((2, T, hi - lo), device="meta",
                    dtype=torch.complex64 if cplx else torch.float32)
    before = dict(stft_cuda.grad_launches)
    dx = stft_cuda.stft_backward(x, g, op)
    assert dx.shape == x.shape and dx.device.type == "meta"
    assert lib.calls == ["stft_fft_backward_launch", "overlap_add_launch"]
    moved = {k: stft_cuda.grad_launches[k] - before[k] for k in before}
    assert moved == {"stft_backward": 0, "stft_small_backward": 0,
                     "stft_fft_backward": 1, "stft_mixed_backward": 0,
                     "stft_odd_backward": 0, "stft_bluestein_backward": 0,
                     "overlap_add": 1}


def test_dense_backward_on_the_other_routes_and_when_forced(monkeypatch):
    """The GEMM route's backward past its small-K configs (a two-sided
    spectrum of 24 bins) recomputes X and launches stft_backward_launch;
    forced "dense" does so on a radix-2 config; a forced "fft" off the
    radix-2 route raises, and so does the radix-2 wrapper on such a
    config."""
    lib = _meta_setup(monkeypatch)

    def meta_x(x, fs, cfg, *args, band=None, out_mode=None, **kwargs):
        lo, hi = stft_cuda.check_band(cfg, band)
        T = num_frames(x.shape[-1], cfg.nperseg, cfg.hop_)
        return torch.empty((x.shape[0], T, hi - lo), device="meta",
                           dtype=torch.complex64)

    monkeypatch.setattr(stft_cuda, "_stft_psd_cuda", meta_x)
    for cfg, forced in ((dataclasses.replace(SpecConfig.scipy_default(24),
                                             onesided=False), None),
                        (NS, "dense")):
        lib.calls.clear()
        n = 4 * cfg.nperseg + 5
        T = num_frames(n, cfg.nperseg, cfg.hop_)
        x = torch.empty((2, n), device="meta")
        g = torch.empty((2, T, cfg.n_freqs), device="meta")
        stft_cuda.stft_backward(x, g, _meta_op(cfg), _backward=forced)
        assert lib.calls == ["stft_backward_launch", "overlap_add_launch"]
    cfg = SpecConfig.scipy_default(96)
    x = torch.empty((2, 500), device="meta")
    g = torch.empty((2, num_frames(500, 96, cfg.hop_), cfg.n_freqs),
                    device="meta")
    assert stft_cuda.backward_route(cfg) == "mixed"
    with pytest.raises(ValueError, match="no 'fft' backward"):
        stft_cuda.stft_backward(x, g, _meta_op(cfg), _backward="fft")
    with pytest.raises(ValueError, match="radix-2 route"):
        stft_cuda.frames_backward_fft(g, x, cfg, FS)


def test_cpu_backward_stays_the_dense_plain_version(monkeypatch):
    """A CPU tensor's backward is the dense plain backward on every route;
    frames_backward_fft on CPU tensors is the plain FFT adjoint."""
    monkeypatch.setattr(stft_cuda, "frames_backward_fft", _fail)
    x = torch.from_numpy(signal(9, (2, 600), np.float32)).requires_grad_()
    stft_cuda.stft_psd(x, FS, NS).sum().backward()
    assert x.grad is not None and x.grad.dtype == torch.float32
    monkeypatch.undo()
    g = cotangent(10, (2, num_frames(600, 64, 16), NS.n_freqs), "psd")
    xd = x.detach().double()
    assert torch.equal(stft_cuda.frames_backward_fft(g, xd, NS, FS),
                       stft_cuda.frames_backward_fft_reference(g, xd, NS, FS))


# ---------------------------------------------------------------------------
# the copied engine
# ---------------------------------------------------------------------------

ENGINE = ("block_sum", "Band", "R2Geometry", "brev_low", "r2_base",
          "r2_index", "r2_slot", "r2_butterfly", "r2_stage", "r2_pass",
          "r2_store", "r2_load", "r2_sync", "r2_exchange_pass",
          "r2_frame_sum")
ENGINE_CONSTANTS = ("R2_BLOCK", "R2_MAX_THREADS", "R2_WARPS", "R2_LR")


def definition(src, name):
    """The text of the top-level definition of ``name`` in a CUDA source:
    its template line, if any, to its closing brace in column 0."""
    found = re.search(
        rf"^(?:template <[^\n]*>\n)?(?:__\w+__ |struct )[^\n]*?\b{name}\b"
        rf"[ (][^\n]*\n(?:[^\n]*\n)*?}};?\n", src, re.M)
    assert found, f"no definition of {name}"
    return found.group(0)


def constant(src, name):
    found = re.search(rf"^constexpr int {name}\b[^\n]*\n", src, re.M)
    assert found, f"no constant {name}"
    return found.group(0)


@pytest.mark.parametrize("name", ENGINE + ENGINE_CONSTANTS)
def test_backward_engine_is_the_forward_engine(name):
    """stft_grad.cu builds as a library of its own, so it carries the
    forward kernel's radix-2 engine; each copied definition and constant
    is stft_psd.cu's, text for text."""
    fwd = (CSRC / "stft_psd.cu").read_text()
    bwd = (CSRC / "stft_grad.cu").read_text()
    get = constant if name in ENGINE_CONSTANTS else definition
    assert get(bwd, name) == get(fwd, name)


# the definitions stft_grad_mixed.cu copies: from stft_psd.cu, the mixed
# kernel's passes and the pass engine with their plans, constants and host
# planners, the Bluestein transform and its constants; from stft_grad.cu,
# the cotangent arithmetic
MIXED_ENGINE = (
    "FastDiv", "block_sum", "frame_line", "Band", "r2_butterfly", "cmul",
    "mix_rmax", "MixPass", "MixRegPlan", "mix_base", "r2_dif_butterfly",
    "mix_r2_stage", "mix_r2_stages", "SlotMap", "mix_r2_pass",
    "mix_odd_pass", "mix_rm", "mix_generic_sums", "mix_generic_pass",
    "mix_frame_sum", "small_root_at", "ConvPlan", "conv_stage_roots",
    "conv_pass", "RaderProduct", "odd_dft", "conv_turn_r2",
    "conv_turn_odd", "conv_forward", "conv_transform", "ConvRead",
    "ConvRaderRead", "BluesteinProduct", "BluesteinRead",
    "bluestein_transform", "odd_min_blocks", "make_fastdiv", "raise_smem",
    "detrend_ok", "fft_threads", "group_passes", "mixed_register_plan",
    "conv_plan", "band_ok")
MIXED_ENGINE_CONSTANTS = (
    "OUT_PSD", "OUT_MAGNITUDE", "OUT_COMPLEX", "FFT_MAX_THREADS",
    "FFT_MAX_WARPS", "DETREND_NONE", "DETREND_CONSTANT", "DETREND_LINEAR",
    "MIX_MAX_STAGES", "MIX_MAX_RADIX", "MIX_THREADS", "MIX_LOAD",
    "MIX_R2_BITS", "MIX_NARROW_RADIX", "MIX_MAX_PASSES", "SMALL_ROOTS",
    "ODD_SMALL_BLOCKS", "ODD_NARROW_POINTS", "RADER_NARROW_POINTS",
    "PACKED_R2_BITS", "PAIR_MAX_RATIO", "FFT_MAX_DEVICES", "BLUE_MAX_RADIX",
    "BLUE_MIN_BLOCKS", "BLUE_TWO_BLOCK_POINTS", "BLOCK_SMEM",
    "BLUE_MAX_BLOCK_POINTS")
MIXED_FROM_GRAD = ("cotangent_of", "split_bin", "inverse_split",
                   "half_weight", "F32_MAX")


def any_definition(src, name):
    """The text of the top-level definition of ``name`` in a CUDA source,
    device or host: from its template line, if any, to its closing brace
    in column 0; or a constexpr constant's line."""
    found = re.search(rf"^constexpr (?:int|double) {name}\b[^\n]*\n", src,
                      re.M)
    if found:
        return found.group(0)
    found = re.search(
        rf"^(?:template <[^\n]*>\n)?(?:__\w+__ |struct |bool |int |"
        rf"constexpr int |FastDiv )[^\n]*?\b{name}\b[ (][^\n]*\n"
        rf"(?:[^\n]*\n)*?}};?\n", src, re.M)
    assert found, f"no definition of {name}"
    return found.group(0)


@pytest.mark.parametrize("name", MIXED_ENGINE + MIXED_ENGINE_CONSTANTS
                         + MIXED_FROM_GRAD)
def test_mixed_backward_engine_is_the_forward_engine(name):
    """stft_grad_mixed.cu builds as a library of its own, so it carries the
    mixed-radix kernel's passes, the pass engine and their host planners
    (stft_psd.cu's) and the cotangent arithmetic (stft_grad.cu's); each
    copied definition and constant is its source's, text for text."""
    origin = "stft_grad.cu" if name in MIXED_FROM_GRAD else "stft_psd.cu"
    fwd = (CSRC / origin).read_text()
    bwd = (CSRC / "stft_grad_mixed.cu").read_text()
    assert any_definition(bwd, name) == any_definition(fwd, name)
