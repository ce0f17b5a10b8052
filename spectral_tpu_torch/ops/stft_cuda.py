"""Fused STFT/PSD: the CUDA kernels' wrapper and their plain version.

Counterpart of ``spectral_tpu/ops/stft_pallas.py``. Five kernels in
``csrc/stft_psd.cu`` replace ``stft_psd_pallas`` with its ``with_stats``
and ``log10_out`` modes, across the GUI's whole nperseg range up to 8192
(the TPU's auto kernel K1 and, above nperseg 6144, its manual-DMA kernel
K2): framing, the windowed and detrended real DFT, |X|² times the
one-sided PSD weights, and the per-clip PSD extrema, with no frame tensor
written to memory. All compute the same function, by five routes that
:func:`route` picks from the config alone:

- ``"fft"`` (``stft_fft_psd_launch``): power-of-two nperseg from 32 to
  8192 under any detrend (the GUI's nine powers of two, and the driven
  paths at 1024 and 8192). A frame on nperseg/16 threads with 8 values
  each up to 1024 (a warp at 512), on nperseg/32 with 16 values from 2048
  (8 warps at 8192): the frame read straight into registers and widened
  to float64, its mean (constant detrend) or its least-squares line
  (linear detrend, the slope against the centred sample index)
  subtracted after a reduction over the frame's threads, the window
  applied, two real samples packed into each complex value, a radix-2
  FFT of nperseg/2 points three or four stages at a time in registers
  with an exchange through shared memory between, then the split step
  into the nperseg/2 + 1 bins and the PSD epilogue. Its host
  constants are the window, the twiddles (numpy's cos and sin of
  -2π j / nperseg, j < nperseg/2, laid out stage by stage) and the
  weights (:func:`fft_constants`);
- ``"mixed"`` (``stft_mixed_fft_psd_launch``): the other even nperseg
  from 32 to 8192, under any detrend, whose nperseg/2 has no odd prime
  factor past 255 (:data:`MAX_MIXED_RADIX`), which covers the
  other 247 values of the GUI's range (32-8192 in steps of 32,
  GUI.py:87-90), or is itself a prime p whose p - 1 has none. The same
  structure with a mixed-radix transform: radix 2, 3, 5 and 7 stages and
  a generic odd-radix stage, in the order and with the load permutation
  and twiddle rows of the host plan (``core.stft.fft_plan``,
  :func:`mixed_constants`), and for the prime a Rader stage: a cyclic
  convolution of length p - 1 by two transforms of those radices, which
  the same launcher runs on the odd kernel's pass engine, one packed frame
  a block (its PACKED form);
- ``"odd"`` (``stft_odd_fft_psd_launch``): odd nperseg from 33 to 8191,
  under any detrend, with no prime factor past 255, or itself a prime p
  whose p - 1 has none (a Rader stage; scipy_default 8191). The
  mixed-radix kernel's stages on a complex nperseg-point transform that
  carries two frames of one clip, one in each part, separated in the
  epilogue; a guard transforms a frame alone beside a frame that is not
  finite, is all zero or is far louder;
- ``"bluestein"`` (``stft_bluestein_psd_launch``): the other 2,389
  nperseg from 32 to 8192, under any detrend, whose transform length
  (nperseg/2, or nperseg when odd) has a prime past 255 beside other
  factors (2049 = 3 · 683), or is a prime p whose p - 1 has one (8185 =
  5 · 1637); none of them on the GUI's range. The transform as a cyclic
  convolution of a 2, 3, 5, 7-smooth length M >= 2N - 1 by Bluestein's
  chirp (``core.stft.bluestein_plan``, :func:`bluestein_constants`): M's
  stages in frequency, a product with the host's b̂, the stages in time,
  on even nperseg's packed frames or odd nperseg's pairs of frames as the
  routes above; past 14,406 points (odd nperseg from 7207, M up to
  16,384) on a cluster of two blocks that hold half of M each;
- ``"gemm"`` (``stft_psd_launch``): nperseg below 32. The real DFT as a
  GEMM against (nperseg, F) matrices with the window and detrend folded in
  (:func:`dft_constants`): at F <= 16 (every nperseg below 32) a tile of
  its own, 256 or 512 rows a block with all their bins, the rows' frames
  staged once as the clip's span; a 128-row by 64-bin register-blocked
  tile past it, forced on any config for timing.

The FFT kernels take the detrend as a code (:data:`DETREND_CODES`: 0
none, 1 constant, 2 linear); their launchers refuse any other value.

The fmin/fmax band mask (the reference masks rows before it normalizes,
PlotEngine.py:114-127) is a bin range ``band=(lo, hi)``: every route writes
the bins lo to hi - 1 alone, bin f at column f - lo, and reduces each
row's (min, max) over them, so the display reads the displayed spectrum.
The FFT routes still compute the whole transform; only their epilogues
and stores shrink. The GEMM route computes the band's columns alone, as
the JAX package folds the band into its dense matrix columns. Each bin's
arithmetic is the full band's, so a banded output is bitwise the matching
columns of the full band's on every route.

Precision. Every route computes in float64 from the float32 load to the
float32 store, with the host's float64 constants unrounded, and round
once at the store. A float32 chain does not hold the 1e-3 dB display
contract at any nperseg in the GUI's range: its error lands on the clip's
deepest bin, and how deep that bin is depends on the clip. Display error
against scipy in float64 (``bench.py``'s formula), the kernels' orders
emulated in numpy on the CPU, on white-noise clips of 8·nperseg samples,
seeds 0-99 (``python3 tools/torch_precision.py``):

    config                 clip       one fp32 chain: worst, seeds above 1e-3 dB
    north_star 128/32      noise      1.74e-3 dB   3 of 100
    north_star 256/64      noise      2.29e-3      1 of 100
    north_star 512/128     noise      5.39e-3      6 of 100
    north_star 1024/256    noise + 3  4.55e-3     24 of 100
    scipy_default 1024     noise + 3  2.92e-2     45 of 100
    scipy_default 8192     noise + 3  9.86e-3     seed 0 alone

The float64 GEMM route stays below 5e-7 dB on every one of those clips,
and so do the float64 FFT routes (the sweep's last columns, with the
mixed-radix, odd and Bluestein routes' own configs).

:func:`stft_psd` takes a kernel for a CUDA tensor and the plain version
(:func:`stft_psd_reference`, a float64 dense DFT, the plain version of
every kernel) for a CPU tensor, and only because the tensor lies on the
CPU; so does :func:`stft_psd_partials`, the display pipeline's call,
which returns the kernel's per-frame extrema unreduced for
``ops.display_cuda.clip_stats``. On a CUDA tensor they launch the route's
kernel or raise; nothing falls back to another route.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from spectral_tpu_torch.config import SpecConfig
from spectral_tpu_torch.core.stft import (MAX_MIXED_RADIX, _window_f64,
                                          bluestein_plan, dense_dft,
                                          dft_matrices, ensure_real_waveform,
                                          fft_plan, fft_twiddles,
                                          frame_signal, num_frames,
                                          onesided_weights, plan_radices)
from spectral_tpu_torch.ops import build

KERNEL = "stft_psd"
MAX_NPERSEG = 8192           # the GUI's ceiling (GUI.py:87-90)
MIN_FFT_NPERSEG = 32         # the GUI's floor, the FFT kernels' smallest;
                             # below it the GEMM kernel computes
# |X|² past float32's range makes the bin inf, as the JAX package's float32
# pipeline overflows there: the clip's extrema turn inf and its finite flag
# (the overflow guard) trips, though float64 could carry the value
F32_MAX = float(np.finfo(np.float32).max)
# B * T: the kernels index rows with int32; with nperseg <= 8192 (at most
# 65 frequency tiles) the GEMM route's block count then stays below 2**31
# too, and the FFT routes launch one block per row
MAX_ROWS = 2 ** 31 - 256

# kernel launches per route, for run-time proof of the path
launches = {"gemm": 0, "fft": 0, "mixed": 0, "odd": 0, "bluestein": 0}
# the FFT kernels' detrend codes (DETREND_* in csrc/stft_psd.cu)
DETREND_CODES = {"none": 0, "constant": 1, "linear": 2}


class DftConstants(NamedTuple):
    """The kernel's operands: folded DFT matrices (K, F) and weights (F,)."""
    a_re: torch.Tensor
    a_im: torch.Tensor
    wts: torch.Tensor


def unsupported_reason(cfg: SpecConfig) -> Optional[str]:
    """Why the kernel cannot compute cfg (naming, by its bracketed label,
    the ROADMAP item that will bring it), or None when it can. These are the semantic conditions of
    the JAX package's ``pallas_supported``; its gcd and VMEM conditions are
    TPU layout limits, and the kernel reads frames by pointer."""
    if cfg.mode != "psd" or cfg.center or cfg.nfft_ != cfg.nperseg:
        return ("the STFT kernel computes uncentered PSD with nfft == "
                "nperseg; other modes arrive with ROADMAP [ext-modes] "
                "(the extended modes)")
    if cfg.nperseg > MAX_NPERSEG:
        return (f"nperseg {cfg.nperseg} > {MAX_NPERSEG}, the GUI's ceiling "
                "(GUI.py:87-90); larger transforms arrive with ROADMAP "
                "[ext-modes] (the extended modes)")
    return None


def kernel_supported(cfg: SpecConfig) -> bool:
    """The semantic conditions of the JAX package's ``pallas_supported``:
    nfft == nperseg <= 8192, PSD mode, uncentered. The band mask and the mel
    branch are not the kernel's concern: the caller passes the bins
    (``band``) and projects the PSD (``ops.mel_cuda``)."""
    return unsupported_reason(cfg) is None


def check_supported(cfg: SpecConfig) -> None:
    reason = unsupported_reason(cfg)
    if reason is not None:
        raise NotImplementedError(reason)


def route(cfg: SpecConfig) -> str:
    """The kernel that computes a supported config (:func:`kernel_supported`;
    others raise NotImplementedError), under any detrend and whatever its
    band or mel settings: ``"gemm"`` for
    nperseg below 32; ``"fft"`` for a power-of-two nperseg from 32 to
    8192; for the other nperseg in that range whose plan's radices
    (``core.stft.plan_radices``: the prime factors of the transform
    length, nperseg/2 or an odd nperseg, or of the length less one where
    a Rader stage takes a prime length past :data:`MAX_MIXED_RADIX`) are
    all at most :data:`MAX_MIXED_RADIX`, ``"mixed"`` when even and
    ``"odd"`` when odd; ``"bluestein"`` for the rest (transform lengths
    with a larger prime). A pure function of the config."""
    check_supported(cfg)
    k = cfg.nperseg
    if not MIN_FFT_NPERSEG <= k <= MAX_NPERSEG:
        return "gemm"
    if k & (k - 1) == 0:
        return "fft"
    if max(plan_radices(k)) > MAX_MIXED_RADIX:
        return "bluestein"
    return "odd" if k % 2 else "mixed"


def _put(a, device, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """A copy of host array ``a`` on ``device`` in ``dtype``, never shared
    with the (cached) numpy array."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def constants_from_numpy(a_re: np.ndarray, a_im: np.ndarray,
                         wts: np.ndarray, device,
                         dtype: torch.dtype) -> DftConstants:
    """Host f64 constants (``dft_matrices(cfg)``, ``onesided_weights(cfg,
    fs)`` of either package) -> the kernel's operands on ``device`` in
    ``dtype``. The numpy arrays are copied, never shared."""
    return DftConstants(*(_put(a, device, dtype) for a in (a_re, a_im, wts)))


_CONSTANTS: dict = {}


def check_band(cfg: SpecConfig, band) -> Tuple[int, int]:
    """band as (lo, hi), the bins lo to hi - 1 of cfg's n_freqs; None is
    the full band. Raises ValueError on an empty band or one past the
    bins."""
    lo, hi = (0, cfg.n_freqs) if band is None else (int(band[0]),
                                                     int(band[1]))
    if not 0 <= lo < hi <= cfg.n_freqs:
        raise ValueError(f"band {band} is not a nonempty range of the "
                         f"{cfg.n_freqs} bins")
    return lo, hi


def dft_constants(cfg: SpecConfig, fs: float, device,
                  band=None) -> DftConstants:
    """The operands for (cfg, fs) in float64, the kernel's precision,
    cached per device: with band=(lo, hi) the matrices' columns and the
    weights of those bins only (the JAX package folds the band into the
    dense matrix columns the same way, spectral_tpu/core/stft.py:746-755),
    copied contiguous."""
    lo, hi = check_band(cfg, band)
    key = (cfg, float(fs), str(torch.device(device)), lo, hi)
    consts = _CONSTANTS.get(key)
    if consts is None:
        a_re, a_im = dft_matrices(cfg)
        consts = constants_from_numpy(
            np.ascontiguousarray(a_re[:, lo:hi]),
            np.ascontiguousarray(a_im[:, lo:hi]),
            onesided_weights(cfg, fs)[lo:hi], device, torch.float64)
        _CONSTANTS[key] = consts
    return consts


class FftConstants(NamedTuple):
    """The FFT kernel's operands, float64: the window (K,), the stage
    twiddle table (K - 1, 2) of (cos, sin) (``core.stft.fft_twiddles``),
    and the weights (F,)."""
    window: torch.Tensor
    twiddles: torch.Tensor
    wts: torch.Tensor


def fft_constants(cfg: SpecConfig, fs: float, device) -> FftConstants:
    """The FFT route's operands for (cfg, fs), the host's float64 numpy
    values unrounded, cached per device. No (K, F) matrix is built."""
    key = ("fft", cfg, float(fs), str(torch.device(device)))
    consts = _CONSTANTS.get(key)
    if consts is None:
        consts = FftConstants(_put(_window_f64(cfg), device),
                              _put(fft_twiddles(cfg.nperseg), device),
                              _put(onesided_weights(cfg, fs), device))
        _CONSTANTS[key] = consts
    return consts


class MixedConstants(NamedTuple):
    """The mixed-radix and odd kernels' operands: the window (K,), the
    load order (N,) int32 (N = K/2, or K when odd), the plan's twiddle
    table (rows, 2) and the weights (F,) in float64 on the device, and the
    plan's (S, 4) int32 stage rows, the split step's first row (-1 when
    odd) and the Rader stage's (-1 without one) on the host
    (``core.stft.fft_plan``)."""
    window: torch.Tensor
    perm: torch.Tensor
    twiddles: torch.Tensor
    wts: torch.Tensor
    stages: np.ndarray
    split: int
    rader: int


def mixed_constants(cfg: SpecConfig, fs: float, device) -> MixedConstants:
    """The mixed-radix and odd routes' operands for (cfg, fs), the host's
    float64 numpy values unrounded, cached per device. No (K, F) matrix is
    built."""
    key = ("mixed", cfg, float(fs), str(torch.device(device)))
    consts = _CONSTANTS.get(key)
    if consts is None:
        plan = fft_plan(cfg.nperseg)
        consts = MixedConstants(_put(_window_f64(cfg), device),
                                _put(plan.perm, device, torch.int32),
                                _put(plan.twiddles, device),
                                _put(onesided_weights(cfg, fs), device),
                                plan.stages.copy(), plan.split, plan.rader)
        _CONSTANTS[key] = consts
    return consts


class BluesteinConstants(NamedTuple):
    """The Bluestein kernel's operands (``core.stft.bluestein_plan``): the
    window (K,), the plan's twiddle table (rows, 2) and the weights (F,)
    in float64 on the device; M's (S, 4) int32 stage rows on the host; M
    and the first rows of b̂, the chirp and the split step (-1 when odd)."""
    window: torch.Tensor
    twiddles: torch.Tensor
    wts: torch.Tensor
    stages: np.ndarray
    m: int
    bhat: int
    chirp: int
    split: int


def bluestein_constants(cfg: SpecConfig, fs: float,
                        device) -> BluesteinConstants:
    """The Bluestein route's operands for (cfg, fs), the host's float64
    numpy values unrounded, cached per device. No (K, F) matrix is
    built."""
    key = ("bluestein", cfg, float(fs), str(torch.device(device)))
    consts = _CONSTANTS.get(key)
    if consts is None:
        plan = bluestein_plan(cfg.nperseg)
        consts = BluesteinConstants(_put(_window_f64(cfg), device),
                                    _put(plan.twiddles, device),
                                    _put(onesided_weights(cfg, fs), device),
                                    plan.stages.copy(), plan.m, plan.bhat,
                                    plan.chirp, plan.split)
        _CONSTANTS[key] = consts
    return consts


def _empty_result(B: int, F: int, like: torch.Tensor, with_stats: bool):
    empty = like.new_zeros((B, 0, F))
    if with_stats:
        return empty, like.new_zeros(B), like.new_zeros(B)
    return empty


def stft_psd_reference(x: torch.Tensor, consts: DftConstants,
                       cfg: SpecConfig, *, log10_out: bool = False,
                       with_stats: bool = False):
    """The plain version of the kernel: (B, n) -> (B, T, F) PSD in x's
    dtype, plus (pmin, pmax) of shape (B,) under with_stats
    (NaN-propagating, like jnp.min/jnp.max). F is the constants' columns:
    the band's bins for banded constants (``dft_constants(..., band)``),
    each the same dot product as the full band's.

    It computes as the kernel does: float64 matmuls, epilogue and log10,
    rounded once to x's dtype, and a bin whose |X|² lies past the float32
    range is inf (:data:`F32_MAX`). ``consts`` must be float64
    (``dft_constants(cfg, fs, device)``): float32 matrices would round A,
    which the kernel does not."""
    B = x.shape[0]
    if num_frames(x.shape[-1], cfg.nperseg, cfg.hop_) <= 0:
        return _empty_result(B, consts.a_re.shape[1], x, with_stats)
    if consts.a_re.dtype != torch.float64:
        raise ValueError(f"the plain STFT computes in float64; got "
                         f"{consts.a_re.dtype} constants")
    frames = frame_signal(x.double(), cfg.nperseg, cfg.hop_)
    xr, xi = dense_dft(frames, consts.a_re, consts.a_im)
    power = xr * xr + xi * xi
    p = torch.where(power > F32_MAX, torch.inf, power * consts.wts)
    if log10_out:
        p = torch.log10(p + 1e-20)
    p = p.to(x.dtype)
    if with_stats:
        return p, torch.amin(p, dim=(1, 2)), torch.amax(p, dim=(1, 2))
    return p


_LIB: list = []      # the library once loaded: finding it hashes the source


def _library() -> ctypes.CDLL:
    """The STFT kernels' library, built and loaded at first use, then kept
    for the process: ``build.load_library`` reads and hashes the CUDA
    source to find it, host time that no launch should wait for."""
    if _LIB:
        return _LIB[0]
    lib = build.load_library(KERNEL)
    if lib.stft_psd_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.stft_psd_launch.argtypes = [ptr] * 7 + [
            i32, ctypes.c_longlong, i32, i32, i32, i32, i32, i32, ptr]
        lib.stft_psd_launch.restype = i32
        lib.stft_fft_psd_launch.argtypes = [ptr] * 7 + [
            i32, ctypes.c_longlong] + [i32] * 8 + [ptr]
        lib.stft_fft_psd_launch.restype = i32
        lib.stft_mixed_fft_psd_launch.argtypes = [ptr] * 5 + [i32] * 3 + [
            ptr] * 4 + [i32, ctypes.c_longlong] + [i32] * 8 + [ptr]
        lib.stft_mixed_fft_psd_launch.restype = i32
        lib.stft_odd_fft_psd_launch.argtypes = [ptr] * 5 + [i32] * 2 + [
            ptr] * 4 + [i32, ctypes.c_longlong] + [i32] * 9 + [ptr]
        lib.stft_odd_fft_psd_launch.restype = i32
        lib.stft_bluestein_psd_launch.argtypes = [ptr] * 4 + [i32] * 5 + [
            ptr] * 4 + [i32, ctypes.c_longlong] + [i32] * 8 + [ptr]
        lib.stft_bluestein_psd_launch.restype = i32
        lib.stft_psd_freq_tiles.argtypes = [i32]
        lib.stft_psd_freq_tiles.restype = i32
        lib.stft_psd_error_string.argtypes = [i32]
        lib.stft_psd_error_string.restype = ctypes.c_char_p
    _LIB.append(lib)
    return lib


def _stft_psd_cuda(x: torch.Tensor, fs: float, cfg: SpecConfig,
                   log10_out: bool, with_stats: bool,
                   kernel: Optional[str] = None, pack: bool = True,
                   partials: bool = False, band=None):
    """The route's launch; ``pack=False`` makes the odd kernel transform
    every frame alone, for timing its packing. With ``partials`` (and
    with_stats) it returns the PSD and the kernel's raw partials, (2,
    n_tiles, B, T), unreduced. band=(lo, hi) writes those bins only, and
    the partials reduce over them: the FFT kernels compute the whole
    transform and store the band's bins from its weights' rows (the full
    weights, read at the band's bins), the GEMM kernel computes the band's
    columns alone."""
    lib = _library()
    kernel = kernel or route(cfg)
    if x.dtype != torch.float32:
        raise TypeError(f"the STFT kernel computes in float32, got {x.dtype}; "
                        "cast the waveform explicitly")
    if x.device.type != "cuda":
        raise ValueError(f"the STFT kernel takes CUDA tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("the STFT kernel needs a contiguous (B, n) waveform")
    B, n = x.shape
    T = num_frames(n, cfg.nperseg, cfg.hop_)
    f_lo, f_hi = check_band(cfg, band)
    F = f_hi - f_lo
    if T <= 0:
        if partials:
            return x.new_zeros((B, 0, F)), x.new_zeros((2, 1, B, 0))
        return _empty_result(B, F, x, with_stats)
    if B * T > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} frames per launch, got "
                         f"{B} clips x {T} frames")
    n_tiles = lib.stft_psd_freq_tiles(F) if kernel == "gemm" else 1
    out = torch.empty((B, T, F), dtype=torch.float32, device=x.device)
    parts = (torch.empty((2, n_tiles, B * T), dtype=torch.float32,
                         device=x.device) if with_stats else None)
    stats = ((parts[0].data_ptr(), parts[1].data_ptr()) if with_stats
             else (None, None))
    detrend = DETREND_CODES[cfg.detrend]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if kernel == "fft":
            fc = fft_constants(cfg, fs, x.device)
            err = lib.stft_fft_psd_launch(
                x.data_ptr(), fc.window.data_ptr(), fc.twiddles.data_ptr(),
                fc.wts.data_ptr(), out.data_ptr(), *stats, B, n, T, F,
                cfg.nperseg, cfg.hop_, detrend, int(log10_out),
                int(with_stats), f_lo, stream)
        elif kernel == "mixed":
            mc = mixed_constants(cfg, fs, x.device)
            err = lib.stft_mixed_fft_psd_launch(
                x.data_ptr(), mc.window.data_ptr(), mc.perm.data_ptr(),
                mc.twiddles.data_ptr(), mc.stages.ctypes.data,
                len(mc.stages), mc.split, mc.rader, mc.wts.data_ptr(),
                out.data_ptr(), *stats, B, n, T, F, cfg.nperseg, cfg.hop_,
                detrend, int(log10_out), int(with_stats), f_lo, stream)
        elif kernel == "odd":
            mc = mixed_constants(cfg, fs, x.device)
            err = lib.stft_odd_fft_psd_launch(
                x.data_ptr(), mc.window.data_ptr(), mc.perm.data_ptr(),
                mc.twiddles.data_ptr(), mc.stages.ctypes.data,
                len(mc.stages), mc.rader, mc.wts.data_ptr(), out.data_ptr(),
                *stats, B, n, T, F, cfg.nperseg, cfg.hop_, detrend,
                int(log10_out), int(with_stats), int(pack), f_lo, stream)
        elif kernel == "bluestein":
            bc = bluestein_constants(cfg, fs, x.device)
            err = lib.stft_bluestein_psd_launch(
                x.data_ptr(), bc.window.data_ptr(), bc.twiddles.data_ptr(),
                bc.stages.ctypes.data, len(bc.stages), bc.m, bc.bhat,
                bc.chirp, bc.split, bc.wts.data_ptr(), out.data_ptr(),
                *stats, B, n, T, F, cfg.nperseg, cfg.hop_, detrend,
                int(log10_out), int(with_stats), f_lo, stream)
        else:
            dc = dft_constants(cfg, fs, x.device, (f_lo, f_hi))
            err = lib.stft_psd_launch(
                x.data_ptr(), dc.a_re.data_ptr(), dc.a_im.data_ptr(),
                dc.wts.data_ptr(), out.data_ptr(), *stats, B, n, T, F,
                cfg.nperseg, cfg.hop_, int(log10_out), int(with_stats),
                stream)
    if err != 0:
        raise RuntimeError(f"stft_psd {kernel} kernel launch failed: "
                           + lib.stft_psd_error_string(err).decode())
    launches[kernel] += 1
    if with_stats:
        per_clip = parts.view(2, n_tiles, B, T)
        if partials:
            return out, per_clip
        return (out, torch.amin(per_clip[0], dim=(0, 2)),
                torch.amax(per_clip[1], dim=(0, 2)))
    return out


def stft_psd_partials(x: torch.Tensor, fs: float, cfg: SpecConfig,
                      band=None):
    """The PSD of a (B, n) waveform and its per-row extrema unreduced:
    (B, T, F) float32 and the partials (2, n_tiles, B, T), the min and then
    the max of each frame's bins in each frequency tile (n_tiles 1 but on
    the GEMM route's forced large tile), which ``ops.display_cuda.
    clip_stats`` reduces per clip. band=(lo, hi) gives the bins lo to hi -
    1 alone (F = hi - lo), and the partials over them. One launch of the
    route's kernel for a CUDA tensor; for a CPU tensor the plain version,
    and the partials its per-frame min and max (n_tiles 1)."""
    if x.ndim != 2:
        raise ValueError(f"expected a (B, n) waveform, got {x.ndim}-D")
    check_supported(cfg)
    if x.device.type == "cpu":
        p = stft_psd_reference(x, dft_constants(cfg, fs, x.device, band),
                               cfg)
        return p, row_partials(p)
    return _stft_psd_cuda(x, fs, cfg, False, True, partials=True, band=band)


def row_partials(p: torch.Tensor) -> torch.Tensor:
    """The plain partials of a (B, T, F) tensor: each row's NaN-propagating
    min and max over its F values, (2, 1, B, T), the kernels' layout."""
    return torch.stack([torch.amin(p, dim=-1), torch.amax(p, dim=-1)])[:, None]


def stft_psd(x, fs: float, cfg: SpecConfig, *, log10_out: bool = False,
             with_stats: bool = False, band=None,
             _route: Optional[str] = None):
    """Fused PSD spectrogram: (n,) or (B, n) -> (B?, T, F) float32.

    band=(lo, hi) computes the bins lo to hi - 1 alone (F = hi - lo; the
    fmin/fmax mask, ``core.stft.band_row_slice``), each bitwise the full
    band's bin on every route; None is the full band. with_stats=True
    also returns each clip's PSD min and max over those bins, (B?,) each,
    NaN-propagating, for ``core.scale.normalize_from_stats``; it cannot be
    combined with log10_out. A config outside :func:`kernel_supported`
    raises NotImplementedError on every device. On a CUDA tensor the
    kernel is the one :func:`route` picks; ``_route`` forces another the
    config allows ("gemm" always, "bluestein" on any nperseg from 32,
    else only the config's own route), for timing the kernels against
    each other."""
    if with_stats and log10_out:
        raise ValueError("with_stats computes linear-PSD extrema; "
                         "combine with log10_out is unsupported")
    kernel = route(cfg)
    if _route is not None:
        forced = ["gemm", kernel]
        if cfg.nperseg >= MIN_FFT_NPERSEG:
            forced.append("bluestein")
        if _route not in forced:
            raise ValueError(f"no {_route!r} route for nperseg "
                             f"{cfg.nperseg}, detrend {cfg.detrend!r}")
        kernel = _route
    check_band(cfg, band)
    x = ensure_real_waveform(x)
    if x.ndim == 1:
        out = stft_psd(x[None], fs, cfg, log10_out=log10_out,
                       with_stats=with_stats, band=band, _route=_route)
        return tuple(o[0] for o in out) if with_stats else out[0]
    if x.ndim != 2:
        raise ValueError(f"expected a (n,) or (B, n) waveform, got {x.ndim}-D")
    if x.device.type == "cpu":
        return stft_psd_reference(x, dft_constants(cfg, fs, x.device, band),
                                  cfg, log10_out=log10_out,
                                  with_stats=with_stats)
    return _stft_psd_cuda(x, fs, cfg, log10_out, with_stats, kernel,
                          band=band)
