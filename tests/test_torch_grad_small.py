"""The GEMM route's STFT backward at its small-K configs
(``csrc/stft_grad.cu::stft_small_backward_kernel``, B1-small), held on the
CPU to the JAX package, to the dense plain backward and to a numpy
transcription of the kernel.

B1-small serves the configs that run the forward's small-K tile
(nperseg 2-31 with at most 16 bins): one launch recomputes X in registers
by that tile's DFMA chains from the folded matrices, forms the cotangent H
in float64 and takes d = H A^T. Its plain version is
``ops/stft_cuda.py::frames_backward_small_reference`` (torch float64, the
kernel's summation order). Here, on seeded numpy inputs:

- the whole chain (the plain version, then the framing's adjoint) against
  ``jax.grad`` of the JAX package's ``power_spectrogram`` and ``stft`` under
  ``jax.enable_x64``, at every nperseg 2-31, in every mode, under each
  detrend, with and without a band, within X64_TOL of each clip's largest
  |gradient|;
- the plain version against the dense plain backward
  (``frames_backward_reference``, which rounds X to complex64 as B1 reads
  it) within the bound that rounding sets, element by element;
- a numpy transcription of the kernel (``SmallBackTile``: the forward
  tile's row table and staged spans, its bins a thread, K padded to KP,
  the H rows, the sample slices, the odd-stride stage and the contiguous
  store), bitwise the plain version in float64, where both round each
  product before its sum (the card fuses them);
- ``backward_route``'s "small" on a grid of configs, the two-sided spectra
  past 16 bins and nfft past 8192 kept on B1 ("dense");
- the wrapper off the CPU (meta tensors): one launch of
  ``stft_small_backward_launch`` and the overlap-add, no recompute of X by
  the forward's complex epilogue; B1 forced; refusals;
- the forward's staging and X chains, which stft_grad.cu copies from
  stft_psd.cu, text for text, and the ctypes prototype.
"""

import dataclasses
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from spectral_tpu.config import SpecConfig as JaxSpecConfig  # noqa: E402
from spectral_tpu.core import stft as jstft  # noqa: E402

from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.core.stft import num_frames  # noqa: E402
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402
from test_torch_gemm_tile import SmallTile  # noqa: E402

FS = 1000.0
X64_TOL = 1e-10     # of each clip's largest |gradient|, float64 against
                    # float64 (jax_enable_x64): roundings of sums of at most
                    # 31 terms, the detrend folded or not
CSRC = Path(stft_cuda.__file__).resolve().parent / "csrc"
GRAD = (CSRC / "stft_grad.cu").read_text()
PSD = (CSRC / "stft_psd.cu").read_text()
U32 = 2.0 ** -24    # float32's unit roundoff


def jcfg(cfg):
    return JaxSpecConfig.from_json(cfg.to_json())


def clip_rel(got, want):
    """The worst clip's largest |Δ| over its largest |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    b = want.shape[0]
    diff = np.abs(got - want).reshape(b, -1).max(axis=1)
    return float((diff / np.abs(want).reshape(b, -1).max(axis=1)).max())


def gradient(seed, shape, out):
    """A seeded gradient of the output: real for the PSD and magnitude,
    complex for the complex outputs; float32 values."""
    rs = np.random.RandomState(seed)
    g = rs.rand(*shape).astype(np.float32).astype(np.float64)
    if out in ("complex", "stft"):
        g = g + 1j * (rs.rand(*shape).astype(np.float32) - 0.5)
    return torch.from_numpy(g)


def small_chain(x, g, cfg, band, out):
    """The gradient of the waveform x (numpy float64) from the output's
    gradient g: B1-small's plain version, then the framing's adjoint."""
    xt = torch.from_numpy(x)
    d = stft_cuda.frames_backward_small_reference(g, xt, cfg, FS, band, out)
    return stft_cuda.overlap_add_reference(d, x.shape[-1], cfg.hop_).numpy()


# ---------------------------------------------------------------------------
# the chain against jax.grad, float64
# ---------------------------------------------------------------------------

MODES = ("psd", "magnitude", "stft", "psd", "magnitude")
DETRENDS = ("constant", "none", "linear")


def jax_case(k):
    """nperseg k's config, output and band: the modes, detrends, hops and
    bands in turn, so that each appears at every few nperseg."""
    out = MODES[k % len(MODES)]
    det = DETRENDS[k % len(DETRENDS)]
    cfg = SpecConfig(nperseg=k, hop=max(1, k // (2 + k % 3)), detrend=det,
                     mode="magnitude" if out == "magnitude" else "psd")
    F = cfg.n_freqs
    band = (1, min(F, 3 + k // 4)) if k % 2 and F > 2 else None
    return cfg, out, band


@pytest.mark.parametrize("k", range(2, 32))
def test_small_chain_matches_jax_x64(k):
    """sum(out[..., band] * g) for the PSD and the magnitude, and
    sum(Re z u + Im z v) for the unscaled STFT z (g = u + i v): the
    gradient through B1-small's plain version and the overlap-add against
    jax.grad of the JAX package's power_spectrogram or stft (its dense
    matmul route, the band sliced after) in float64."""
    cfg, out, band = jax_case(k)
    assert stft_cuda.backward_route(cfg, band) == "small"
    n = 12 * k + 37
    x = np.random.RandomState(k).randn(2, n)
    T = num_frames(n, k, cfg.hop_)
    lo, hi = stft_cuda.check_band(cfg, band)
    g = gradient(100 + k, (2, T, hi - lo), out).numpy()
    got = small_chain(x, torch.from_numpy(g), cfg, band, out)
    with jax.enable_x64(True):
        if out == "stft":
            def loss(v):
                z = jstft.stft(v, jcfg(cfg), use_matmul=True)[..., lo:hi]
                return jnp.sum(z.real * g.real + z.imag * g.imag)
        else:
            def loss(v):
                p = jstft.power_spectrogram(v, FS, jcfg(cfg),
                                            use_matmul=True)[..., lo:hi]
                return jnp.sum(p * g)
        want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    assert want.dtype == np.float64
    assert clip_rel(got, want) <= X64_TOL


# ---------------------------------------------------------------------------
# against the dense plain backward, X rounded to complex64
# ---------------------------------------------------------------------------

F32X_CASES = {
    "24": (SpecConfig.scipy_default(24), "psd", None),
    "13 linear band": (SpecConfig(nperseg=13, hop=4, detrend="linear"),
                       "psd", (1, 5)),
    "31 magnitude": (dataclasses.replace(SpecConfig.scipy_default(31),
                                         mode="magnitude"), "magnitude",
                     None),
    "12 two-sided": (dataclasses.replace(SpecConfig.scipy_default(12),
                                         onesided=False), "psd", None),
    "24 complex": (SpecConfig.scipy_default(24), "complex", None),
    "5 none": (SpecConfig(nperseg=5, hop=2, detrend="none"), "psd", None),
}


@pytest.mark.parametrize("name", sorted(F32X_CASES))
def test_small_plain_within_the_float32_rounding_of_x(name):
    """The frames' gradient from X kept in float64 (B1-small) and from X
    rounded to complex64 (B1, as it reads the recomputed X) differ by what
    that rounding moves, sample by sample: each part of X by at most 2^-24
    of itself, so H (2 w g X; w g X / |X|, whose direction moves by at
    most 2^-23) by at most 2^-22 |H| a part, and d[n] by at most 2^-22
    sum_f |H_re a_re[n, f]| + |H_im a_im[n, f]|, plus each float32 result's
    own rounding; the complex outputs need no X and agree bitwise."""
    cfg, out, band = F32X_CASES[name]
    x = np.random.RandomState(7).randn(3, 400).astype(np.float32)
    xt = torch.from_numpy(x)
    T = num_frames(400, cfg.nperseg, cfg.hop_)
    lo, hi = stft_cuda.check_band(cfg, band)
    g = gradient(8, (3, T, hi - lo), out)
    g = g.to(torch.complex64 if g.is_complex() else torch.float32)
    got = stft_cuda.frames_backward_small_reference(g, xt, cfg, FS, band, out)
    consts = stft_cuda.dft_constants(cfg, FS, "cpu", band, out)
    X = torch.complex(*stft_cuda._reference_dft(xt, consts, cfg))
    want = stft_cuda.frames_backward_reference(g, X.to(torch.complex64),
                                               consts, out)
    assert got.dtype == want.dtype == torch.float32
    if out == "complex":
        assert torch.equal(got, want)
        return
    hr, hi_ = stft_cuda._cotangent_reference(g, X, consts.wts, out)
    spread = hr.abs() @ consts.a_re.abs().T + hi_.abs() @ consts.a_im.abs().T
    bound = 4 * U32 * spread + U32 * (got.double().abs()
                                      + want.double().abs())
    diff = (got.double() - want.double()).abs()
    assert bool((diff <= bound).all()), float((diff / bound).max())
    assert float(diff.max()) > 0          # the rounding shows somewhere


# ---------------------------------------------------------------------------
# the kernel's transcription
# ---------------------------------------------------------------------------

def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", GRAD).group(1))


SKB_TN = _constant("SKB_TN")


class SmallBackTile(SmallTile):
    """stft_small_backward_kernel's geometry and arithmetic, for R rows of
    T a clip, F bins, K = L samples a frame, hop and output ``out``: the
    forward tile's rows, staging, groups and bins a thread (SmallTile),
    then the launcher's sample slices (small_back_plan) and the H and d
    stages. Products are rounded before their sums (numpy), as the plain
    version rounds them."""

    def __init__(self, R, T, F, K, hop, out):
        super().__init__(R, T, F, K, hop,
                         "complex" if out in ("complex", "stft") else "psd")
        self.out = out
        per = -(-K // self.groups)
        self.m = -(-per // SKB_TN)
        self.tn = -(-K // (self.groups * self.m))
        self.hs = F | 1
        self.ls = K | 1

    @staticmethod
    def sqrt(s):
        """The plain version's square root, torch's on the CPU: it may
        land an ulp from the correctly rounded one (numpy's, and the
        card's __dsqrt_rn) where torch's CPU kernel takes a vectorized
        approximation; the transcription holds the order, not that."""
        return torch.sqrt(torch.from_numpy(np.ascontiguousarray(s))).numpy()

    def cotangent(self, re, im, g, w):
        """H of X = (re, im) from the output's gradient g and weights w,
        cotangent_of's operations."""
        if self.out in ("complex", "stft"):
            return w * g.real, w * g.imag
        s = re * re + im * im
        keep = s <= stft_cuda.F32_MAX
        if self.out == "magnitude":
            keep = keep & (s != 0)
            c = w * g / self.sqrt(np.where(keep, s, 1.0))
        else:
            c = 2.0 * w * g
        c = np.where(keep, c, 0.0)
        return c * re, c * im

    def block(self, x, g, a_re, a_im, wts, r0):
        """One block: its rows' d as stored (float64, unrounded)."""
        xs, off = self.staged(x, r0)
        rows = min(self.R - r0, self.rb)
        K, F, kp = self.K, self.F, self.kp
        for i in range(rows):                      # every row reads its frame
            b, t = divmod(r0 + i, self.T)
            assert np.array_equal(xs[off[i]:off[i] + K],
                                  x[b, t * self.hop:t * self.hop + K],
                                  equal_nan=True)
        ar = np.zeros((kp, F))
        ai = np.zeros((kp, F))
        ar[:K], ai[:K] = a_re, a_im
        gb = np.zeros((self.rb, F), g.dtype)
        gb[:rows] = g[r0:r0 + rows]
        hs = np.zeros((self.rb, self.hs, 2))
        nb = -(-F // self.groups)
        for grp in range(self.groups):
            f0 = grp * nb
            fn = min(F - f0, nb)
            ia = np.arange(self.tpg)
            for i in (ia, ia + self.tpg):          # a thread's two rows
                re = np.zeros((self.tpg, fn))
                im = np.zeros((self.tpg, fn))
                for k in range(kp):                # k ascending, k < KP
                    v = (xs[off[i] + k].astype(np.float64) if k < K
                         else np.zeros(self.tpg))
                    re = re + v[:, None] * ar[k, f0:f0 + fn]
                    im = im + v[:, None] * ai[k, f0:f0 + fn]
                hr, hi = self.cotangent(re, im, gb[i, f0:f0 + fn],
                                        wts[f0:f0 + fn])
                live = (i < rows)[:, None]
                hs[i, f0:f0 + fn, 0] = np.where(live, hr, 0.0)
                hs[i, f0:f0 + fn, 1] = np.where(live, hi, 0.0)
        os_ = np.full(self.rb * self.ls, np.nan)
        for grp in range(self.groups):
            ia = np.arange(self.tpg)
            for q in range(self.m):
                n0 = (grp + self.groups * q) * self.tn
                nn = min(K - n0, self.tn)
                if nn <= 0:
                    break
                for i in (ia, ia + self.tpg):
                    acc = np.zeros((self.tpg, nn))
                    for f in range(F):             # bins ascending
                        acc = acc + hs[i, f, 0][:, None] * ar[n0:n0 + nn, f]
                        acc = acc + hs[i, f, 1][:, None] * ai[n0:n0 + nn, f]
                    at = (i * self.ls)[:, None] + n0 + np.arange(nn)
                    os_[at] = acc
        e = np.arange(rows * K)                    # the contiguous store
        return os_[(e // K) * self.ls + e % K].reshape(rows, K)

    def run(self, x, g, consts):
        a_re, a_im, wts = (c.numpy() for c in consts)
        return np.concatenate([
            self.block(x, g, a_re, a_im, wts, blk * self.rb)
            for blk in range(self.blocks)])


MODEL_CASES = {
    # F <= 8: one group, 512 rows a block; hop below K with a NaN sample
    "7 constant, NaN": (SpecConfig(nperseg=7, hop=2), "psd", None, 200),
    # F > 8: two groups, 256 rows a block, two slices a row
    "24 scipy_default": (SpecConfig.scipy_default(24), "psd", None, 800),
    "31 linear, hop past K": (SpecConfig(nperseg=31, hop=35,
                                         detrend="linear"), "psd", None,
                              31 + 60 * 35),
    "31 magnitude": (dataclasses.replace(SpecConfig.scipy_default(31),
                                         mode="magnitude"), "magnitude",
                     None, 1431),
    "16 two-sided": (dataclasses.replace(SpecConfig.scipy_default(16),
                                         onesided=False), "psd", None, 600),
    "29 band of 5 bins (one group, three slices)": (
        SpecConfig(nperseg=29, hop=9, detrend="none"), "psd", (4, 9), 749),
    "20 stft": (SpecConfig.scipy_default(20), "stft", None, 740),
    "2 scipy_default": (SpecConfig.scipy_default(2), "psd", None, 150),
}


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_kernel_transcription_is_bitwise_the_plain_version(name):
    """The transcription of stft_small_backward_kernel against the plain
    version in float64, bitwise, NaN in the same places: 7 clips, so a
    block's rows cross clips and the last block is partial. Every staged
    sample is the signal's where a row reads it (SmallTile.staged)."""
    cfg, out, band, n = MODEL_CASES[name]
    rs = np.random.RandomState(len(name))
    x = rs.randn(7, n).astype(np.float32)
    T = num_frames(n, cfg.nperseg, cfg.hop_)
    if "NaN" in name:
        x[3, T // 2 * cfg.hop_] = np.nan
    lo, hi = stft_cuda.check_band(cfg, band)
    F = hi - lo
    g = gradient(9, (7, T, F), out)
    consts = stft_cuda.dft_constants(cfg, FS, "cpu", band, out)
    tile = SmallBackTile(7 * T, T, F, cfg.nperseg, cfg.hop_, out)
    assert tile.blocks >= 2 and tile.tn <= SKB_TN
    got = tile.run(x, g.numpy().reshape(7 * T, F), consts)
    want = stft_cuda.frames_backward_small_reference(
        g, torch.from_numpy(x.astype(np.float64)), cfg, FS, band, out)
    want = want.numpy().reshape(7 * T, cfg.nperseg)
    assert np.array_equal(got, want, equal_nan=True)
    assert np.isnan(want).any() == ("NaN" in name)


def test_the_transcription_is_the_sources():
    """The transcription's geometry and arithmetic are stft_grad.cu's."""
    flat = " ".join(GRAD.split())
    for line in (
            "p.groups = F > SK_BINS ? 2 : 1;",
            "p.nb = (F + p.groups - 1) / p.groups;",
            "p.rb = 2 * SK_THREADS / p.groups;",
            "const int per = (K + p.groups - 1) / p.groups;",
            "p.m = (per + SKB_TN - 1) / SKB_TN;",
            "p.tn = (K + p.groups * p.m - 1) / (p.groups * p.m);",
            "const int HS = F | 1;",
            "const int LS = K | 1;",
            "hs[i * HS + f0 + j] = make_double2(re[h][j], im[h][j]);",
            "const int n0 = (g + groups * q) * tn;",
            "const int nn = K - n0 < tn ? K - n0 : tn;",
            "acc[0][j] = fma(u.y, a.y, fma(u.x, a.x, acc[0][j]));",
            "os[ia * LS + n0 + j] = static_cast<float>(acc[0][j]);",
            "dst[e] = os[i * LS + (e - i * K)];",
            "if (F < 1 || F > SK_MAX_F || K < 1 || K >= 2 * SK_MAX_F ||"):
        assert " ".join(line.split()) in flat, line
    assert stft_cuda.SMALL_MAX_F == _constant("SK_MAX_F")
    assert stft_cuda.SMALL_MAX_L == 2 * _constant("SK_MAX_F")


# ---------------------------------------------------------------------------
# backward_route
# ---------------------------------------------------------------------------

SD = SpecConfig.scipy_default
ROUTES = [(SD(k), None, "small") for k in (2, 7, 13, 24, 31)] + [
    (dataclasses.replace(SD(16), onesided=False), None, "small"),
    (dataclasses.replace(SD(24), onesided=False), None, "dense"),
    (dataclasses.replace(SD(24), onesided=False), (4, 20), "small"),
    (dataclasses.replace(SD(24), onesided=False), (4, 21), "dense"),
    (dataclasses.replace(SD(24), nfft=30), None, "small"),
    (dataclasses.replace(SD(24), nfft=8200), None, "dense"),
    (dataclasses.replace(SD(24), nfft=8200), (100, 110), "small"),
    (dataclasses.replace(SD(1024), nfft=16384), None, "dense"),
    (dataclasses.replace(SD(1024), nfft=16384), (0, 16), "dense"),
    (SpecConfig(nperseg=20, hop=5, detrend="linear", mode="magnitude"),
     None, "small"),
    (SD(32), None, "fft"),
    (SD(33), None, "odd"),
]


@pytest.mark.parametrize("cfg,band,want", ROUTES,
                         ids=[f"{c.nperseg}_{c.nfft_}_"
                              f"{'1' if c.onesided else '2'}_{b}_{w}"
                              for c, b, w in ROUTES])
def test_backward_route_small(cfg, band, want):
    """"small" exactly where the forward runs its small-K tile, or would
    past nfft 8192 (whose forward is now the radix-2 or Bluestein kernel's,
    the backward unchanged): the GEMM route with the band's F <= 16 bins
    at nperseg below 32; "dense" (B1) on the rest of the GEMM route (a
    two-sided spectrum past 16 bins, nperseg from 32) and past nfft 8192
    over its bins; the FFT routes' own adjoints unchanged."""
    assert stft_cuda.backward_route(cfg, band) == want
    b1_route = stft_cuda.route(cfg) == "gemm" or cfg.nfft_ > 8192
    if want in ("small", "dense"):
        assert b1_route
    lo, hi = stft_cuda.check_band(cfg, band)
    assert (want == "small") == (b1_route and hi - lo <= 16
                                 and cfg.nperseg < 32)


# ---------------------------------------------------------------------------
# the wrapper off the CPU
# ---------------------------------------------------------------------------

class _RecordingLib:
    """The backward library's launchers, recording each call's arguments
    and succeeding."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.endswith("error_string"):
            return lambda code: b"no error"
        return lambda *args: self.calls.append((name, args)) or 0


class _NoStream:
    cuda_stream = 0


def _fail(*args, **kwargs):
    raise AssertionError("reached off the small-K backward")


def _meta_setup(monkeypatch):
    import contextlib
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _NoStream())
    lib = _RecordingLib()
    monkeypatch.setattr(stft_cuda, "_grad_library", lambda: lib)
    return lib


def _meta_consts(cfg, fs, device, band=None, out=None):
    lo, hi = stft_cuda.check_band(cfg, band)
    m = torch.empty((cfg.nperseg, hi - lo), dtype=torch.float64,
                    device="meta")
    return stft_cuda.DftConstants(m, m, torch.empty(hi - lo, device="meta"))


@pytest.mark.parametrize("cfg,out,band", [
    (SD(24), "psd", None),
    (SpecConfig(nperseg=13, hop=4, detrend="linear"), "psd", (1, 5)),
    (dataclasses.replace(SD(31), mode="magnitude"), "magnitude", None),
    (SD(24), "stft", None),
    (dataclasses.replace(SD(24), onesided=False), "complex", (4, 20)),
])
def test_small_backward_launches_one_kernel(monkeypatch, cfg, out, band):
    """On a tensor off the CPU the small-K configs' backward is one launch
    of stft_small_backward_launch with the forward's folded operands and
    the overlap-add: no recompute of X by the complex epilogue, no B1, no
    plain version."""
    lib = _meta_setup(monkeypatch)
    monkeypatch.setattr(stft_cuda, "_stft_psd_cuda", _fail)
    monkeypatch.setattr(stft_cuda, "frames_backward", _fail)
    monkeypatch.setattr(stft_cuda, "frames_backward_small_reference", _fail)
    monkeypatch.setattr(stft_cuda, "dft_constants", _meta_consts)
    op = stft_cuda.GradOp(FS, cfg, band, out, stft_cuda.route(cfg))
    lo, hi = stft_cuda.check_band(cfg, band)
    n = 4 * cfg.nperseg + 5
    T = num_frames(n, cfg.nperseg, cfg.hop_)
    x = torch.empty((2, n), device="meta")
    cplx = out in ("complex", "stft")
    g = torch.empty((2, T, hi - lo), device="meta",
                    dtype=torch.complex64 if cplx else torch.float32)
    before = dict(stft_cuda.grad_launches)
    dx = stft_cuda.stft_backward(x, g, op)
    assert dx.shape == x.shape and dx.device.type == "meta"
    assert [c for c, _ in lib.calls] == ["stft_small_backward_launch",
                                         "overlap_add_launch"]
    args = lib.calls[0][1]
    assert args[6:] == (2, n, T, hi - lo, cfg.nperseg, cfg.hop_,
                        stft_cuda._out_mode(out), 0)
    moved = {k: stft_cuda.grad_launches[k] - before[k] for k in before}
    assert moved == {"stft_backward": 0, "stft_small_backward": 1,
                     "stft_fft_backward": 0, "stft_mixed_backward": 0,
                     "stft_odd_backward": 0, "stft_bluestein_backward": 0,
                     "overlap_add": 1}


def test_b1_forced_and_the_refusals(monkeypatch):
    """_backward="dense" on a small-K config recomputes X and launches B1;
    a forced FFT adjoint there raises, and so does frames_backward_small
    on a config or band off the small-K backward."""
    lib = _meta_setup(monkeypatch)

    def meta_x(x, fs, cfg, *args, band=None, out_mode=None, **kwargs):
        lo, hi = stft_cuda.check_band(cfg, band)
        T = num_frames(x.shape[-1], cfg.nperseg, cfg.hop_)
        return torch.empty((x.shape[0], T, hi - lo), device="meta",
                           dtype=torch.complex64)

    monkeypatch.setattr(stft_cuda, "_stft_psd_cuda", meta_x)
    monkeypatch.setattr(stft_cuda, "dft_constants", _meta_consts)
    cfg = SD(24)
    T = num_frames(200, 24, cfg.hop_)
    x = torch.empty((2, 200), device="meta")
    g = torch.empty((2, T, cfg.n_freqs), device="meta")
    op = stft_cuda.GradOp(FS, cfg, None, "psd", "gemm")
    stft_cuda.stft_backward(x, g, op, _backward="dense")
    assert [c for c, _ in lib.calls] == ["stft_backward_launch",
                                         "overlap_add_launch"]
    with pytest.raises(ValueError, match="no 'fft' backward"):
        stft_cuda.stft_backward(x, g, op, _backward="fft")
    two = dataclasses.replace(cfg, onesided=False)
    g2 = torch.empty((2, T, two.n_freqs), device="meta")
    assert stft_cuda.backward_route(two) == "dense"
    with pytest.raises(ValueError, match="small-K backward"):
        stft_cuda.frames_backward_small(g2, x, two, FS)
    with pytest.raises(ValueError, match="gradient"):
        stft_cuda.frames_backward_small(g2, x, cfg, FS)


def test_cpu_tensors_take_the_plain_version():
    """frames_backward_small on CPU tensors is its plain version; a CPU
    tensor's whole backward stays the dense plain backward."""
    cfg = SD(24)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 300))
    T = num_frames(300, 24, cfg.hop_)
    g = gradient(4, (2, T, cfg.n_freqs), "psd")
    assert torch.equal(stft_cuda.frames_backward_small(g, x, cfg, FS),
                       stft_cuda.frames_backward_small_reference(g, x, cfg,
                                                                 FS))
    op = stft_cuda.GradOp(FS, cfg, None, "psd", "gemm")
    consts = stft_cuda.dft_constants(cfg, FS, "cpu", None, "psd")
    assert torch.equal(stft_cuda.stft_backward(x, g, op),
                       stft_cuda.stft_backward_reference(x, g, consts, cfg,
                                                         "psd"))


def test_the_prototype_is_the_sources():
    """The ctypes prototype of stft_small_backward_launch has the C entry's
    parameters: pointers for pointers, int64 for long long, int32 for
    int."""
    import ctypes
    found = re.search(r"^int stft_small_backward_launch\((.*?)\) {", GRAD,
                      re.M | re.S)
    params = [p.strip() for p in found.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in p else ctypes.c_longlong
            if p.startswith("long long") else ctypes.c_int for p in params]
    src = Path(stft_cuda.__file__).read_text()
    got = re.search(r"lib\.stft_small_backward_launch\.argtypes = (.*?)\n"
                    r"    lib\.stft_small_backward_launch\.restype", src,
                    re.S).group(1)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert eval(got) == want


# ---------------------------------------------------------------------------
# the copied staging and chains
# ---------------------------------------------------------------------------

def _definition(src, name):
    """A top-level definition's text (its template line, if any, to its
    closing brace in column 0) or a constexpr constant's line."""
    found = re.search(rf"^constexpr (?:int|double) {name}\b[^\n]*\n", src,
                      re.M)
    if found:
        return found.group(0)
    found = re.search(
        rf"^(?:template <[^\n]*>\n)?(?:__\w+__ |struct |int |FastDiv )"
        rf"[^\n]*?\b{name}\b[ (][^\n]*\n(?:[^\n]*\n)*?}};?\n", src, re.M)
    assert found, f"no definition of {name}"
    return found.group(0)


COPIED = ("FastDiv", "make_fastdiv", "cp_async_f32", "cp_async_wait_all",
          "raise_smem", "SK_THREADS", "SK_MAX_F", "SK_BINS", "SK_K_STEP",
          "FFT_MAX_DEVICES")


@pytest.mark.parametrize("name", COPIED)
def test_copied_definitions_are_the_forwards(name):
    """stft_grad.cu builds as a library of its own, so it carries the
    small-K tile's helpers and constants; each is stft_psd.cu's, text for
    text."""
    assert _definition(GRAD, name) == _definition(PSD, name)


def _fragment(src, start, end):
    i = src.index(start)
    return src[i:src.index(end, i) + len(end)]


FRAGMENTS = {
    "staging": ("  const int r0 = blockIdx.x * RB;\n",
                "  cp_async_wait_all();\n  __syncthreads();\n"),
    "X chains": ("  const int g = tid / tpg;\n  const int ia",
                 "        }\n      }\n    }\n  }\n"),
}


@pytest.mark.parametrize("name", sorted(FRAGMENTS))
def test_copied_kernel_lines_are_the_forwards(name):
    """The small-K tile's staging (the row table, the matrices, the span's
    cp.async) and its X chains (k ascending, re and im apart) stand in
    stft_small_backward_kernel as in stft_psd_small_kernel, text for text,
    once each."""
    start, end = FRAGMENTS[name]
    text = _fragment(PSD, start, end)
    assert PSD.count(text) == 1 and GRAD.count(text) == 1
    kernel = GRAD[GRAD.index("stft_small_backward_kernel(const float*"):]
    assert kernel.index(text) < kernel.index("\n}\n")
