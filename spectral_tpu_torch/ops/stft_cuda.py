"""Fused STFT/PSD: the CUDA kernels' wrapper and their plain version.

Counterpart of ``spectral_tpu/ops/stft_pallas.py``. Five kernels in
``csrc/stft_psd.cu`` replace ``stft_psd_pallas`` with its ``with_stats``
and ``log10_out`` modes, across the GUI's whole nperseg range up to 8192
(the TPU's auto kernel K1 and, above nperseg 6144, its manual-DMA kernel
K2), and past it to 32,768 (:data:`MAX_FFT_NFFT`; the JAX package
computes those frames on its rFFT route, its Pallas kernel stopping at
8192): framing, the windowed and detrended real DFT, |X|² times the
one-sided PSD weights, and the per-clip PSD extrema, with no frame tensor
written to memory. All compute the same function, by five routes that
:func:`route` picks from the config alone:

- ``"fft"`` (``stft_fft_psd_launch``): power-of-two nperseg from 32 to
  32,768 under any detrend (the GUI's nine powers of two, and the driven
  paths at 1024, 8192, 16384 and 32768; 16384 on one block of 8192
  points; from :data:`R2_SPLIT_NFFT` a frame is two blocks, each the
  half transform of the bins of one parity, ``stft_fft_split_psd_kernel``,
  whose partials are two tiles a frame). A frame on nperseg/16 threads with 8 values
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
  routes above; past 14,406 points on a cluster of 2, 4 or 8 blocks that
  hold M / RANKS slots each (``core.stft.bluestein_ranks``; odd nperseg
  from 7207 on two, 14,407 on four, 28,813 on eight); and every nfft from
  8193 to 32,768 that is not a power of two (the mixed and odd routes
  stop at 8192), those divisible by 4 as two half transforms a frame, one
  a bin parity, each on one block or a cluster of two
  (``core.stft.bluestein_split_plan``);
- ``"gemm"`` (``stft_psd_launch``): nfft below 32, and past 32,768 at
  nperseg up to 8192. The real DFT as a
  GEMM against (nperseg, F) matrices with the window and detrend folded in
  (:func:`dft_constants`): at F <= 16 (every nperseg below 32) a tile of
  its own, 256 or 512 rows a block with all their bins, the rows' frames
  staged once as the clip's span; a 128-row by 64-bin register-blocked
  tile past it, forced on any config for timing.

The FFT kernels take the detrend as a code (:data:`DETREND_CODES`: 0
none, 1 constant, 2 linear); their launchers refuse any other value.

The extended modes. Routes go by the transform length nfft: a frame's
nperseg samples load into an nfft-point transform whose other slots are
zero (scipy's nfft, the zero-padded transform), the detrend taken over
the nperseg samples, so nfft from 32 to 32,768 runs on the FFT family of
nfft's factorization whatever nperseg is (the descriptions above name
the transform length nperseg where nfft == nperseg). Every epilogue takes
an output mode (:data:`OUTPUT_MODES`): the PSD; the magnitude
sqrt(re² + im²)·sqrt(w) in float64, rounded once (scipy's
mode='magnitude'; its partials the magnitude's extrema); the complex STFT
X·s as interleaved float2, s sqrt of the PSD scale (mode='complex') or 1
(:func:`stft_complex`). A two-sided spectrum's bins past nfft/2 are the
conjugates of their mirrors, bit for bit. A centered config is padded on
the card before the launch (``core.stft.center_pad``, plain torch: the
JAX package pads with ``jnp.pad``, no Pallas kernel).

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
every kernel; past nperseg 8192 float64 ``torch.fft``, no dense matrix,
:func:`plain_constants`) for a CPU tensor, and only because the tensor lies on the
CPU; so does :func:`stft_psd_partials`, the display pipeline's call,
which returns the kernel's per-frame extrema unreduced for
``ops.display_cuda.clip_stats``. On a CUDA tensor they launch the route's
kernel or raise; nothing falls back to another route.

The gradient. A waveform that requires grad (with grad enabled) goes
through an autograd Function (:class:`_StftGrad`) around the same
launch, which saves only the waveform; its backward runs the kernels of
``csrc/stft_grad.cu`` and ``csrc/stft_grad_mixed.cu`` (each its own
library) by :func:`backward_route`. On the radix-2, mixed, odd and
Bluestein routes (``"fft"``, ``"mixed"``, ``"odd"``, ``"bluestein"``) one
launch of the route's backward kernel (``stft_fft_backward_kernel``,
``stft_mixed_fft_backward_kernel``, on the odd route and the mixed
route's Rader plans ``stft_odd_fft_backward_kernel``, or
``stft_bluestein_fft_backward_kernel``) recomputes X on the forward's own
engine, forms the cotangent H from the output's gradient and X (the
PSD's 2 w g X, the magnitude's w g X / |X|, 0 at |X| = 0, the complex
STFT's w g) and takes the transform's adjoint as a c2r transform on the
same engine, no dense matrix and no X in memory; on the GEMM route at
the configs of its small-K tile (``"small"``: nperseg below 32 and at most
16 bins) one launch of ``stft_small_backward_kernel``, which recomputes X
in registers by that tile's chains and takes the adjoint d = H A^T
against the folded matrices in the same launch; on the rest of the GEMM
route (``"dense"``: two-sided spectra past 16 bins, nfft past 8192) one
launch of the route's complex epilogue recomputes X, then
``stft_backward_kernel`` takes d = H A^T. The framing's adjoint, an
overlap-add in gather form, follows every route. A CPU tensor takes the plain
backward (:func:`stft_backward_reference`, the same arithmetic as
explicit torch). The partials and the extrema carry no gradient, and
``log10_out`` has none (it raises with a waveform that requires grad,
as the JAX package's Pallas kernel has no gradient there). Without grad
the entry points run exactly as before: one launch, nothing saved. Past
nperseg 8192 a CUDA waveform that requires grad raises naming ROADMAP
[large-nperseg] before any launch, and a CPU one is differentiated by
autograd through the plain version (``core.stft.fft_dft``).

The device operands (:func:`dft_constants`, :func:`fft_constants`,
:func:`mixed_constants`, :func:`bluestein_constants`) are cached per
device, least recently used first out, in at most
:data:`CONSTANTS_BUDGET` bytes of device tensors a device.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from spectral_tpu_torch.config import SpecConfig
from spectral_tpu_torch.core.stft import (DENSE_MAX_NPERSEG,
                                          MAX_MIXED_RADIX, _require_power,
                                          _window_f64, bluestein_plan,
                                          bluestein_route_plan,
                                          center_pad, dense_dft,
                                          detrend_frames as _detrend_frames,
                                          dft_matrices, ensure_real_waveform,
                                          fft_dft, fft_plan, fft_twiddles,
                                          frame_signal, num_frames,
                                          onesided_weights, plan_radices,
                                          psd_scale)
from spectral_tpu_torch.ops import build

KERNEL = "stft_psd"
MAX_NPERSEG = 8192           # the GUI's ceiling (GUI.py:87-90): the mixed
                             # and odd routes' longest transform, and the
                             # longest frame of the GEMM route and of the
                             # dense plain version
MAX_FFT_NFFT = 32768         # the radix-2 and Bluestein routes' longest
                             # transform (R2_MAX_K and BLUE_MAX_K in
                             # csrc/stft_psd.cu), and the longest frame
MIN_FFT_NPERSEG = 32         # the GUI's floor, the FFT kernels' shortest
                             # transform; below it the GEMM kernel computes
# the radix-2 kernel runs a frame as two blocks, each the half transform of
# the bins of one parity, from this nfft on (R2_SPLIT_K in the source);
# nfft 16384 runs on one block of 8192 points, 7% faster on the card
R2_SPLIT_NFFT = 32768
# |X|² past float32's range makes the bin inf, as the JAX package's float32
# pipeline overflows there: the clip's extrema turn inf and its finite flag
# (the overflow guard) trips, though float64 could carry the value
F32_MAX = float(np.finfo(np.float32).max)
# B * T: the kernels index rows with int32, and the FFT routes launch one
# block per row
MAX_ROWS = 2 ** 31 - 256
# the GEMM kernel's 128 x 64 tile (BM x BN in the source) launches a block
# per 128 rows and 64 bins: past 65 frequency tiles (nfft > 8192) the
# count can pass the grid's 2**31 - 1
GEMM_TILE_ROWS = 128
MAX_BLOCKS = 2 ** 31 - 1

# kernel launches per route, for run-time proof of the path
launches = {"gemm": 0, "fft": 0, "mixed": 0, "odd": 0, "bluestein": 0}
# the FFT kernels' detrend codes (DETREND_* in csrc/stft_psd.cu)
DETREND_CODES = {"none": 0, "constant": 1, "linear": 2}
# the epilogues' output modes (OUT_* in csrc/stft_psd.cu): cfg.mode, and
# "complex" for the complex STFT
OUTPUT_MODES = {"psd": 0, "magnitude": 1, "complex": 2}
# the backward's launches (csrc/stft_grad.cu), for run-time proof of the
# gradient path; its recompute of X counts in ``launches``
GRAD_KERNEL = "stft_grad"
GRAD_MIXED_KERNEL = "stft_grad_mixed"
grad_launches = {"stft_backward": 0, "stft_small_backward": 0,
                 "stft_fft_backward": 0, "stft_mixed_backward": 0,
                 "stft_odd_backward": 0, "stft_bluestein_backward": 0,
                 "overlap_add": 0}
# the GEMM route's small-K tile and its backward: at most SMALL_MAX_F bins
# and nperseg below SMALL_MAX_L (SK_MAX_F and 2 SK_MAX_F in the sources)
SMALL_MAX_F = 16
SMALL_MAX_L = 32
# the bytes of device tensors the operand cache keeps a device: seven
# configs' dense (8192, 4097) float64 pairs, the largest, fit
CONSTANTS_BUDGET = 4 * 2 ** 30


class DftConstants(NamedTuple):
    """The kernel's operands: folded DFT matrices (K, F) and weights (F,)."""
    a_re: torch.Tensor
    a_im: torch.Tensor
    wts: torch.Tensor


def unsupported_reason(cfg: SpecConfig) -> Optional[str]:
    """Why the kernels cannot compute cfg (naming, by its bracketed label,
    the ROADMAP item that will bring it), or None when they can: a frame
    past :data:`MAX_FFT_NFFT` samples, or past 8192 with a transform past
    :data:`MAX_FFT_NFFT` (the GEMM route's matrices stop at 8192 rows).
    Every mode, centered framing and a two-sided spectrum are computed;
    the JAX package's ``pallas_supported`` refuses those, and its gcd and
    VMEM conditions are TPU layout limits (the kernels read frames by
    pointer)."""
    if cfg.nperseg > MAX_FFT_NFFT:
        return (f"nperseg {cfg.nperseg} > {MAX_FFT_NFFT}, the FFT kernels' "
                "ceiling; transforms past it arrive with ROADMAP "
                "[large-nperseg] (passes through L2)")
    if cfg.nperseg > MAX_NPERSEG and cfg.nfft_ > MAX_FFT_NFFT:
        return (f"nperseg {cfg.nperseg} > {MAX_NPERSEG} with nfft "
                f"{cfg.nfft_} > {MAX_FFT_NFFT}: past the FFT kernels' "
                "ceiling, and the GEMM route's matrices stop at nperseg "
                f"{MAX_NPERSEG}; ROADMAP [large-nperseg]")
    return None


def kernel_supported(cfg: SpecConfig) -> bool:
    """Whether the kernels compute cfg: nperseg <= 32,768, in any mode,
    centered or not, one- or two-sided, with any nfft >= nperseg up to
    32,768, and past it where nperseg <= 8192 (the JAX package computes
    those outside its Pallas kernel, on its dense matmul or rFFT route).
    The band mask and the mel branch are not the kernel's concern: the
    caller passes the bins (``band``) and projects the PSD
    (``ops.mel_cuda``)."""
    return unsupported_reason(cfg) is None


def check_supported(cfg: SpecConfig) -> None:
    reason = unsupported_reason(cfg)
    if reason is not None:
        raise NotImplementedError(reason)


def route(cfg: SpecConfig) -> str:
    """The kernel that computes a supported config (:func:`kernel_supported`;
    others raise NotImplementedError), by its transform length nfft, under
    any detrend and mode and whatever its band or mel settings: ``"gemm"``
    for nfft below 32 or past :data:`MAX_FFT_NFFT` (its folded (nperseg,
    F) matrices carry any zero padding; nperseg <= 8192 there); ``"fft"``
    for a power-of-two nfft from 32 to 32,768 (from
    :data:`R2_SPLIT_NFFT` two blocks a frame); ``"bluestein"`` for every
    other nfft from 8193 to 32,768 (on one block or a cluster of 2, 4 or
    8); for the other nfft from 32 to 8192 whose plan's radices
    (``core.stft.plan_radices``: the prime factors of the transform
    length, nfft/2 or an odd nfft, or of the length less one where a
    Rader stage takes a prime length past :data:`MAX_MIXED_RADIX`) are
    all at most :data:`MAX_MIXED_RADIX`, ``"mixed"`` when even and
    ``"odd"`` when odd; ``"bluestein"`` for the rest (transform lengths
    with a larger prime). The FFT kernels load a frame's nperseg samples
    and zero the rest of the nfft slots. A pure function of the config."""
    check_supported(cfg)
    k = cfg.nfft_
    if not MIN_FFT_NPERSEG <= k <= MAX_FFT_NFFT:
        return "gemm"
    if k & (k - 1) == 0:
        return "fft"
    if k > MAX_NPERSEG or max(plan_radices(k)) > MAX_MIXED_RADIX:
        return "bluestein"
    return "odd" if k % 2 else "mixed"


# the routes whose backward recomputes X on the forward's own engine
FFT_BACKWARD_ROUTES = ("fft", "mixed", "odd", "bluestein")


def backward_route(cfg: SpecConfig, band=None) -> str:
    """The STFT backward's kernel for a supported config and band (None the
    full band), a pure function of them: the forward's :func:`route` where
    it is ``"fft"``
    (``stft_fft_backward_kernel``, the radix-2 engine), ``"mixed"``
    (``stft_mixed_fft_backward_kernel``, the mixed-radix passes; its Rader
    plans on ``stft_odd_fft_backward_kernel``'s PACKED form), ``"odd"``
    (``stft_odd_fft_backward_kernel``, the pass engine) or
    ``"bluestein"`` (``stft_bluestein_fft_backward_kernel``, the Bluestein
    transform on the pass engine, one block or a cluster of two), each
    recomputing X and taking the adjoint as a c2r transform on that
    engine; on the GEMM route ``"small"`` (``stft_small_backward_kernel``,
    X recomputed in registers and d = H A^T in one launch) where the
    forward runs its small-K tile, the band's F <= :data:`SMALL_MAX_F`
    bins at nperseg below :data:`SMALL_MAX_L`, else ``"dense"`` (the
    route's complex epilogue, then ``stft_backward_kernel`` against the
    folded matrices: two-sided spectra past 16 bins, nfft past 8192, whose
    X the radix-2 or Bluestein kernel recomputes). nperseg past 8192
    raises NotImplementedError naming ROADMAP [large-nperseg]: its adjoint
    on the card (B1-fft on the parity split, B1-bluestein on 4 and 8
    ranks) is a later slice's."""
    r = route(cfg)
    if cfg.nperseg > MAX_NPERSEG:
        raise NotImplementedError(
            f"no gradient on the card at nperseg {cfg.nperseg} > "
            f"{MAX_NPERSEG}: the STFT's backward past it arrives with "
            "ROADMAP [large-nperseg]")
    if r in FFT_BACKWARD_ROUTES and cfg.nfft_ <= MAX_NPERSEG:
        return r
    lo, hi = check_band(cfg, band)
    if hi - lo <= SMALL_MAX_F and cfg.nperseg < SMALL_MAX_L:
        return "small"
    return "dense"


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


# the kernels' operands by (kind, device, config...), oldest use first
_CONSTANTS: "collections.OrderedDict" = collections.OrderedDict()


def _tensor_bytes(consts) -> int:
    return sum(t.numel() * t.element_size() for t in consts
               if isinstance(t, torch.Tensor))


def _cached(kind: str, device, key: tuple, build):
    """The operands of ``key`` on ``device`` from :data:`_CONSTANTS`, or
    ``build()`` kept there: a hit becomes the newest entry and returns the
    same tensors; a miss evicts the device's oldest entries until the new
    one fits :data:`CONSTANTS_BUDGET`, and an entry larger than the whole
    budget is returned without being kept. Eviction drops references only,
    so tensors a caller holds stay valid."""
    dev = str(torch.device(device))
    key = (kind, dev) + key
    consts = _CONSTANTS.get(key)
    if consts is not None:
        _CONSTANTS.move_to_end(key)
        return consts
    consts = build()
    size = _tensor_bytes(consts)
    if size > CONSTANTS_BUDGET:
        return consts
    mine = [k for k in _CONSTANTS if k[1] == dev]
    held = sum(_tensor_bytes(_CONSTANTS[k]) for k in mine)
    for k in mine:
        if held + size <= CONSTANTS_BUDGET:
            break
        held -= _tensor_bytes(_CONSTANTS.pop(k))
    _CONSTANTS[key] = consts
    return consts


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


def kernel_weights(cfg: SpecConfig, fs: float,
                   out: Optional[str] = None) -> np.ndarray:
    """The epilogues' per-bin weights (F,) float64 for the output ``out``
    (cfg.mode when None): the PSD's one-sided weights for "psd"; for
    "magnitude" their square roots (scipy's mode='magnitude', which has no
    one-sided doubling: ``onesided_weights`` doubles PSD mode alone);
    sqrt of the PSD scale at every bin for "complex" (scipy's
    mode='complex'); 1 for "stft", the unscaled complex STFT."""
    out = out or cfg.mode
    if out == "stft":
        return np.ones(cfg.n_freqs)
    if out == "complex":
        return np.full(cfg.n_freqs, np.sqrt(psd_scale(cfg, fs)))
    w = onesided_weights(cfg, fs)
    return np.sqrt(w) if out == "magnitude" else w


def _out_mode(out: str) -> int:
    """The epilogue's OUTPUT_MODES code of an output name."""
    return OUTPUT_MODES["complex" if out == "stft" else out]


def mirrored_dft_matrices(cfg: SpecConfig) -> Tuple[np.ndarray, np.ndarray]:
    """``dft_matrices(cfg)``, with a two-sided spectrum's bins f past nfft/2
    the conjugates of bins nfft - f column for column (X[f] = conj X[nfft -
    f] for a real frame), so that the GEMM kernel and the plain version
    give mirrored bins bitwise conjugate, as the FFT kernels do. The
    arrays are copies for a two-sided config, else the shared cache's."""
    a_re, a_im = dft_matrices(cfg)
    if cfg.onesided:
        return a_re, a_im
    K = cfg.nfft_
    f = np.arange(K // 2 + 1, K)
    a_re, a_im = a_re.copy(), a_im.copy()
    a_re[:, f] = a_re[:, K - f]
    a_im[:, f] = -a_im[:, K - f]
    return a_re, a_im


@functools.lru_cache(maxsize=16)
def padded_window(cfg: SpecConfig) -> np.ndarray:
    """The FFT kernels' window operand: cfg's nperseg-point window, zero
    past it to nfft points, so the kernels read a pair of window values
    anywhere in the transform. The array is cached, shared and
    read-only."""
    w = np.zeros(cfg.nfft_)
    w[:cfg.nperseg] = _window_f64(cfg)
    w.setflags(write=False)
    return w


def dft_constants(cfg: SpecConfig, fs: float, device, band=None,
                  out: Optional[str] = None) -> DftConstants:
    """The operands for (cfg, fs) in float64, the kernel's precision,
    cached per device: with band=(lo, hi) the matrices' columns and the
    weights of those bins only (the JAX package folds the band into the
    dense matrix columns the same way, spectral_tpu/core/stft.py:746-755),
    copied contiguous; the weights of the output ``out``
    (:func:`kernel_weights`), the matrices mirrored when two-sided
    (:func:`mirrored_dft_matrices`)."""
    lo, hi = check_band(cfg, band)
    out = out or cfg.mode

    def build():
        a_re, a_im = mirrored_dft_matrices(cfg)
        return constants_from_numpy(
            np.ascontiguousarray(a_re[:, lo:hi]),
            np.ascontiguousarray(a_im[:, lo:hi]),
            kernel_weights(cfg, fs, out)[lo:hi], device, torch.float64)

    return _cached("dense", device, (cfg, float(fs), lo, hi, out), build)


class FftConstants(NamedTuple):
    """The FFT kernel's operands, float64: the window zero-padded to the
    transform length K = nfft (:func:`padded_window`), the stage twiddle
    table (K - 1, 2) of (cos, sin) (``core.stft.fft_twiddles``), and the
    weights (F,) (:func:`kernel_weights`)."""
    window: torch.Tensor
    twiddles: torch.Tensor
    wts: torch.Tensor


def fft_constants(cfg: SpecConfig, fs: float, device,
                  out: Optional[str] = None) -> FftConstants:
    """The FFT route's operands for (cfg, fs) and the output ``out``
    (cfg.mode when None), the host's float64 numpy values unrounded,
    cached per device. No (K, F) matrix is built."""
    out = out or cfg.mode
    return _cached("fft", device, (cfg, float(fs), out), lambda: FftConstants(
        _put(padded_window(cfg), device),
        _put(fft_twiddles(cfg.nfft_), device),
        _put(kernel_weights(cfg, fs, out), device)))


class MixedConstants(NamedTuple):
    """The mixed-radix and odd kernels' operands: the window zero-padded to
    K = nfft, the load order (N,) int32 (N = K/2, or K when odd), the
    plan's twiddle
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


def mixed_constants(cfg: SpecConfig, fs: float, device,
                    out: Optional[str] = None) -> MixedConstants:
    """The mixed-radix and odd routes' operands for (cfg, fs) and the output
    ``out`` (cfg.mode when None), the host's float64 numpy values
    unrounded, cached per device. No (K, F) matrix is built."""
    out = out or cfg.mode

    def build():
        plan = fft_plan(cfg.nfft_)
        return MixedConstants(_put(padded_window(cfg), device),
                              _put(plan.perm, device, torch.int32),
                              _put(plan.twiddles, device),
                              _put(kernel_weights(cfg, fs, out), device),
                              plan.stages.copy(), plan.split, plan.rader)

    return _cached("mixed", device, (cfg, float(fs), out), build)


class BluesteinConstants(NamedTuple):
    """The Bluestein kernel's operands (``core.stft.bluestein_route_plan``:
    ``bluestein_plan``, or ``bluestein_split_plan`` where the kernel splits
    a frame by bin parity): the
    window zero-padded to K = nfft, the plan's twiddle table (rows, 2) and
    the weights (F,)
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


def bluestein_constants(cfg: SpecConfig, fs: float, device,
                        out: Optional[str] = None) -> BluesteinConstants:
    """The Bluestein route's operands for (cfg, fs) and the output ``out``
    (cfg.mode when None), the host's float64 numpy values unrounded,
    cached per device. No (K, F) matrix is built."""
    out = out or cfg.mode

    def build():
        plan = bluestein_route_plan(cfg.nfft_)
        return BluesteinConstants(_put(padded_window(cfg), device),
                                  _put(plan.twiddles, device),
                                  _put(kernel_weights(cfg, fs, out), device),
                                  plan.stages.copy(), plan.m, plan.bhat,
                                  plan.chirp, plan.split)

    return _cached("bluestein", device, (cfg, float(fs), out), build)


def _empty_result(B: int, F: int, like: torch.Tensor, with_stats: bool):
    empty = like.new_zeros((B, 0, F))
    if with_stats:
        return empty, like.new_zeros(B), like.new_zeros(B)
    return empty


class BinWeights(NamedTuple):
    """The plain version's operands past nperseg 8192, where no dense
    matrix is built: the band's bins lo to hi - 1 and their weights (F,)
    float64 (:func:`kernel_weights`)."""
    lo: int
    hi: int
    wts: torch.Tensor


def plain_constants(cfg: SpecConfig, fs: float, device, band=None,
                    out: Optional[str] = None):
    """The plain version's operands for (cfg, fs), the band and the output
    ``out`` (cfg.mode when None): :func:`dft_constants` up to nperseg
    8192; past it :class:`BinWeights`, the transform then being
    ``core.stft.fft_dft``'s, and no (nperseg, F) matrix built."""
    if cfg.nperseg <= DENSE_MAX_NPERSEG:
        return dft_constants(cfg, fs, device, band, out)
    lo, hi = check_band(cfg, band)
    return BinWeights(lo, hi, _put(kernel_weights(cfg, fs, out)[lo:hi],
                                   device))


def _reference_dft(x: torch.Tensor, consts, cfg: SpecConfig):
    """The plain version's float64 transform of x's (uncentered) frames:
    (X_re, X_im), (B, T, F) each, as the kernels compute it: from nfft 32
    to 32,768, where the FFT routes take it, each nperseg-sample frame
    detrended explicitly (``core.stft.detrend_frames``); elsewhere the
    detrend only folded into the matrices, as the GEMM kernel has it; the
    zero padding to nfft in the matrices' rows (``dft_matrices``). Past
    nperseg 8192 (``consts`` a :class:`BinWeights`) the one-sided bins of
    the frames' float64 FFT (``core.stft.fft_dft``)."""
    frames = frame_signal(x.double(), cfg.nperseg, cfg.hop_)
    if isinstance(consts, BinWeights):
        return fft_dft(frames, cfg, (consts.lo, consts.hi))
    if consts.a_re.dtype != torch.float64:
        raise ValueError(f"the plain STFT computes in float64; got "
                         f"{consts.a_re.dtype} constants")
    if route(cfg) != "gemm":              # the FFT routes' explicit detrend
        frames = _detrend_frames(frames, cfg.detrend)
    return dense_dft(frames, consts.a_re, consts.a_im)


def stft_psd_reference(x: torch.Tensor, consts: DftConstants,
                       cfg: SpecConfig, *, log10_out: bool = False,
                       with_stats: bool = False):
    """The plain version of the kernel: (B, n) -> (B, T, F) PSD, or with
    cfg.mode 'magnitude' the magnitude, in x's dtype, plus (pmin, pmax) of
    shape (B,) under with_stats (NaN-propagating, like jnp.min/jnp.max). F
    is the constants' columns: the band's bins for banded constants
    (``dft_constants(..., band)``), each the same dot product as the full
    band's. x is framed as it stands (the caller pads a centered config,
    ``core.stft.center_pad``).

    It computes as the kernel does (:func:`_reference_dft`): float64
    matmuls, epilogue and log10, rounded once to x's dtype; the power
    (re² + im²)·w, the magnitude sqrt(re² + im²)·w with w the weights'
    square roots (``dft_constants``' weights for cfg.mode), and a bin whose
    |X|² lies past the float32 range inf (:data:`F32_MAX`). ``consts``
    must be float64 (``dft_constants(cfg, fs, device)``): float32 matrices
    would round A, which the kernel does not; past nperseg 8192 they are
    :func:`plain_constants`' bins and weights, the transform a float64
    FFT."""
    B = x.shape[0]
    if num_frames(x.shape[-1], cfg.nperseg, cfg.hop_) <= 0:
        return _empty_result(B, consts.wts.shape[0], x, with_stats)
    xr, xi = _reference_dft(x, consts, cfg)
    power = xr * xr + xi * xi
    p = power.sqrt() if cfg.mode == "magnitude" else power
    p = torch.where(power > F32_MAX, torch.inf, p * consts.wts)
    if log10_out:
        p = torch.log10(p + 1e-20)
    p = p.to(x.dtype)
    if with_stats:
        return p, torch.amin(p, dim=(1, 2)), torch.amax(p, dim=(1, 2))
    return p


def stft_complex_reference(x: torch.Tensor, consts: DftConstants,
                           cfg: SpecConfig) -> torch.Tensor:
    """The plain version of the kernels' complex output: (B, n) -> (B, T,
    F) X·w (``dft_constants(..., out='complex')`` scales by sqrt of the
    PSD scale, ``out='stft'`` by 1), complex in x's precision (complex64
    for float32), computed in float64 as :func:`stft_psd_reference` and
    rounded once."""
    ctype = torch.complex128 if x.dtype == torch.float64 else torch.complex64
    if num_frames(x.shape[-1], cfg.nperseg, cfg.hop_) <= 0:
        return torch.zeros((x.shape[0], 0, consts.wts.shape[0]),
                           dtype=ctype, device=x.device)
    xr, xi = _reference_dft(x, consts, cfg)
    return torch.complex(xr * consts.wts, xi * consts.wts).to(ctype)


def _cotangent_reference(g: torch.Tensor, X: torch.Tensor,
                         wts: torch.Tensor, out: str):
    """(H_re, H_im) float64, the gradient of the loss by X_re and X_im,
    from the output's gradient g and the unscaled STFT X, as
    ``stft_grad.cu::cotangent`` forms them: the PSD's 2 w g X, the
    magnitude's w g X / |X| (0 at |X| = 0), the complex STFT's w g; 0
    where |X|² is past float32's range (the forward's inf there is a
    constant)."""
    if out in ("complex", "stft"):
        return wts * g.real.double(), wts * g.imag.double()
    xr, xi = X.real.double(), X.imag.double()
    s = xr * xr + xi * xi
    keep = s <= F32_MAX
    if out == "magnitude":
        keep = keep & (s != 0)
        c = wts * g.double() / torch.sqrt(torch.where(keep, s, 1.0))
    else:
        c = 2.0 * wts * g.double()
    c = torch.where(keep, c, 0.0)
    return c * xr, c * xi


def overlap_add_reference(d: torch.Tensor, n: int, hop: int) -> torch.Tensor:
    """The framing's adjoint: frames' gradients d (B, T, L) -> (B, n),
    sample i the sum of d[b, t, i - t hop] over the frames that hold it,
    in float64, rounded once to d's dtype; samples past the last frame 0."""
    B, T, L = d.shape
    pos = (torch.arange(T, device=d.device) * hop)[:, None] \
        + torch.arange(L, device=d.device)
    dx = torch.zeros((B, n), dtype=torch.float64, device=d.device)
    dx.index_add_(1, pos.reshape(-1), d.reshape(B, T * L).double())
    return dx.to(d.dtype)


def frames_backward_reference(g: torch.Tensor, X: torch.Tensor,
                              consts: DftConstants, out: str) -> torch.Tensor:
    """The plain version of ``stft_backward_kernel``: the frames' gradient
    d = H_re A_re^T + H_im A_im^T (B, T, L) in float64, rounded once to
    X's real type, H from g and X (:func:`_cotangent_reference`)."""
    hr, hi = _cotangent_reference(g, X, consts.wts, out)
    return (hr @ consts.a_re.T + hi @ consts.a_im.T).to(X.real.dtype)


def frames_backward_fft_reference(g: torch.Tensor, x: torch.Tensor,
                                  cfg: SpecConfig, fs: float, band=None,
                                  out: Optional[str] = None) -> torch.Tensor:
    """The plain version of the FFT adjoints (``stft_fft_backward_kernel``,
    ``stft_mixed_fft_backward_kernel``, ``stft_odd_fft_backward_kernel``,
    ``stft_bluestein_fft_backward_kernel``):
    the frames' gradient (B, T, L) from the gradient g (B, T, F) of the
    output ``out``
    (cfg.mode when None; "complex" or "stft" for the complex STFT) of the
    band's F bins, and the (uncentered) waveform x (B, n), in torch
    float64 by ``torch.fft``, rounded once to x's dtype, as the kernel
    computes it: X of each frame (detrended explicitly, windowed,
    zero-padded to nfft) kept in float64; the cotangent H
    (:func:`_cotangent_reference`) at the band's bins, 0 elsewhere, a
    two-sided spectrum's bins past nfft/2 folded onto their mirrors as
    conj H; the c2r adjoint d_v = K irfft(Y, K) with Y the folded H, its
    interior bins at half weight (every bin past 0 for an odd nfft, which
    has no Nyquist bin); then the first L samples times the window, less
    their mean or least-squares line (the detrend's projection, its own
    transpose). For nfft from 32 to 8192 on the radix-2, mixed, odd and
    Bluestein routes in the port, any nfft here."""
    out = out or cfg.mode
    lo, hi = check_band(cfg, band)
    K, L = cfg.nfft_, cfg.nperseg
    M = K // 2
    w = torch.tensor(_window_f64(cfg), device=x.device)
    wts = torch.from_numpy(kernel_weights(cfg, fs, out)[lo:hi]).to(x.device)
    frames = frame_signal(x.double(), L, cfg.hop_)
    X = torch.fft.rfft(_detrend_frames(frames, cfg.detrend) * w, n=K)
    bins = torch.arange(lo, hi, device=x.device)
    mirrored = bins > M
    onesided = torch.where(mirrored, K - bins, bins)
    Xb = X[..., onesided]
    h = torch.complex(*_cotangent_reference(
        g, torch.where(mirrored, Xb.conj(), Xb), wts, out))
    Y = torch.zeros(X.shape, dtype=torch.complex128, device=x.device)
    Y.index_add_(-1, onesided, torch.where(mirrored, h.conj(), h))
    Y[..., 1:(K + 1) // 2] *= 0.5
    Y[..., 0].imag.zero_()
    if K % 2 == 0:
        Y[..., M].imag.zero_()
    d = K * torch.fft.irfft(Y, n=K)[..., :L] * w
    return _detrend_frames(d, cfg.detrend).to(x.dtype)


def frames_backward_small_reference(g: torch.Tensor, x: torch.Tensor,
                                    cfg: SpecConfig, fs: float, band=None,
                                    out: Optional[str] = None
                                    ) -> torch.Tensor:
    """The plain version of ``stft_small_backward_kernel``: the frames'
    gradient (B, T, L) from the gradient g (B, T, F) of the output ``out``
    (cfg.mode when None) of the band's F bins and the (uncentered) waveform
    x (B, n), in torch float64, rounded once to x's dtype, in the kernel's
    order: X of each frame from the folded matrices (:func:`dft_constants`:
    window, detrend projection and band in its columns), summed over the
    samples ascending, re and im apart, and kept in float64; the cotangent
    H (:func:`_cotangent_reference`); d summed over the bins ascending,
    H_re A_re before H_im A_im. The kernel fuses each product into its sum
    (FMA), which this version rounds apart."""
    out = out or cfg.mode
    consts = dft_constants(cfg, fs, x.device, band, out)
    frames = frame_signal(x.double(), cfg.nperseg, cfg.hop_)
    F = consts.a_re.shape[1]
    xr = frames.new_zeros(frames.shape[:-1] + (F,))
    xi = torch.zeros_like(xr)
    for k in range(cfg.nperseg):
        xr = xr + frames[..., k, None] * consts.a_re[k]
        xi = xi + frames[..., k, None] * consts.a_im[k]
    hr, hi = _cotangent_reference(g, torch.complex(xr, xi), consts.wts, out)
    d = torch.zeros_like(frames)
    for f in range(F):
        d = d + hr[..., f, None] * consts.a_re[:, f]
        d = d + hi[..., f, None] * consts.a_im[:, f]
    return d.to(x.dtype)


def stft_backward_reference(x: torch.Tensor, g: torch.Tensor,
                            consts: DftConstants, cfg: SpecConfig,
                            out: str) -> torch.Tensor:
    """The plain version of the backward kernels: the gradient of x (B, n)
    from the gradient g (B, T, F) of the output ``out`` ("psd",
    "magnitude", "complex" or "stft"), consts the forward's
    (``dft_constants(cfg, fs, device, band, out)``: the band's folded
    matrices and the output's weights). As the kernels compute it: X
    recomputed unscaled and rounded to x's complex type (the route's
    complex epilogue), the cotangent H in float64
    (:func:`_cotangent_reference`), the frames' gradient d = H_re A_re^T +
    H_im A_im^T in float64 rounded to x's dtype, then
    :func:`overlap_add_reference`. The matrices' transposes carry the
    window, the detrend projection and nfft > nperseg."""
    B, n = x.shape
    T = num_frames(n, cfg.nperseg, cfg.hop_)
    if T <= 0:
        return torch.zeros_like(x)
    ctype = torch.complex128 if x.dtype == torch.float64 else torch.complex64
    X = torch.complex(*_reference_dft(x, consts, cfg)).to(ctype)
    return overlap_add_reference(frames_backward_reference(g, X, consts, out),
                                 n, cfg.hop_)


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
            i32, ctypes.c_longlong, i32, i32, i32, i32, i32, i32, i32, ptr]
        lib.stft_psd_launch.restype = i32
        lib.stft_fft_psd_launch.argtypes = [ptr] * 7 + [
            i32, ctypes.c_longlong] + [i32] * 10 + [ptr]
        lib.stft_fft_psd_launch.restype = i32
        lib.stft_mixed_fft_psd_launch.argtypes = [ptr] * 5 + [i32] * 3 + [
            ptr] * 4 + [i32, ctypes.c_longlong] + [i32] * 10 + [ptr]
        lib.stft_mixed_fft_psd_launch.restype = i32
        lib.stft_odd_fft_psd_launch.argtypes = [ptr] * 5 + [i32] * 2 + [
            ptr] * 4 + [i32, ctypes.c_longlong] + [i32] * 11 + [ptr]
        lib.stft_odd_fft_psd_launch.restype = i32
        lib.stft_bluestein_psd_launch.argtypes = [ptr] * 4 + [i32] * 5 + [
            ptr] * 4 + [i32, ctypes.c_longlong] + [i32] * 10 + [ptr]
        lib.stft_bluestein_psd_launch.restype = i32
        lib.stft_psd_freq_tiles.argtypes = [i32]
        lib.stft_psd_freq_tiles.restype = i32
        lib.stft_bluestein_clusters.argtypes = [
            i32, i32, i32, ctypes.POINTER(ctypes.c_int)]
        lib.stft_bluestein_clusters.restype = i32
        lib.stft_psd_error_string.argtypes = [i32]
        lib.stft_psd_error_string.restype = ctypes.c_char_p
    _LIB.append(lib)
    return lib


def partial_tiles(cfg: SpecConfig, kernel: str) -> int:
    """The per-frame partials' tiles of an FFT route's launch: 2 where the
    radix-2 kernel runs a frame as two half transforms (nfft from
    :data:`R2_SPLIT_NFFT`), each block's bins of one parity, and where the
    Bluestein kernel does (``core.stft.bluestein_halves``); the ranks of a
    Bluestein cluster of 4 or 8, each its share of the bins; else 1 (a
    cluster of two stores from rank 0 alone)."""
    if kernel == "fft" and cfg.nfft_ >= R2_SPLIT_NFFT:
        return 2
    if kernel == "bluestein":
        plan = bluestein_route_plan(cfg.nfft_)
        return plan.halves if plan.ranks <= 2 else plan.ranks
    return 1


def _stft_psd_cuda(x: torch.Tensor, fs: float, cfg: SpecConfig,
                   log10_out: bool, with_stats: bool,
                   kernel: Optional[str] = None, pack: bool = True,
                   partials: bool = False, band=None,
                   out_mode: Optional[str] = None):
    """The route's launch on x's uncentered frames; ``pack=False`` makes
    the odd kernel transform every frame alone, for timing its packing.
    With ``partials`` (and with_stats) it returns the PSD and the kernel's
    raw partials, (2, n_tiles, B, T), unreduced. band=(lo, hi) writes
    those bins only, and the partials reduce over them: the FFT kernels
    compute the whole transform and store the band's bins from its
    weights' rows (the full weights, read at the band's bins), the GEMM
    kernel computes the band's columns alone. ``out_mode`` is the
    epilogue's output (:func:`kernel_weights`; cfg.mode when None):
    "complex" and "stft" give a complex64 (B, T, F) tensor, without
    log10_out or with_stats."""
    lib = _library()
    kernel = kernel or route(cfg)
    out_mode = out_mode or cfg.mode
    if x.dtype != torch.float32:
        raise TypeError(f"the STFT kernel computes in float32, got {x.dtype}; "
                        "cast the waveform explicitly")
    if x.device.type != "cuda":
        raise ValueError(f"the STFT kernel takes CUDA tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("the STFT kernel needs a contiguous (B, n) waveform")
    mode = _out_mode(out_mode)
    cplx = mode == OUTPUT_MODES["complex"]
    B, n = x.shape
    T = num_frames(n, cfg.nperseg, cfg.hop_)
    f_lo, f_hi = check_band(cfg, band)
    F = f_hi - f_lo
    out_dtype = torch.complex64 if cplx else torch.float32
    if T <= 0:
        if partials:
            return x.new_zeros((B, 0, F)), x.new_zeros((2, 1, B, 0))
        if cplx:
            return torch.zeros((B, 0, F), dtype=out_dtype, device=x.device)
        return _empty_result(B, F, x, with_stats)
    if B * T > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} frames per launch, got "
                         f"{B} clips x {T} frames")
    n_tiles = (lib.stft_psd_freq_tiles(F) if kernel == "gemm"
               else partial_tiles(cfg, kernel))
    if n_tiles > 1 and -(-B * T // GEMM_TILE_ROWS) * n_tiles > MAX_BLOCKS:
        raise ValueError(f"{B} clips x {T} frames x {F} bins is past the "
                         f"GEMM kernel's {MAX_BLOCKS} blocks a launch")
    if kernel != "gemm" and B * T * n_tiles > MAX_BLOCKS:
        raise ValueError(f"{B} clips x {T} frames is past the "
                         f"{MAX_BLOCKS} blocks a launch at {n_tiles} blocks "
                         f"a frame on the {kernel} route")
    out = torch.empty((B, T, F), dtype=out_dtype, device=x.device)
    parts = (torch.empty((2, n_tiles, B * T), dtype=torch.float32,
                         device=x.device) if with_stats else None)
    stats = ((parts[0].data_ptr(), parts[1].data_ptr()) if with_stats
             else (None, None))
    detrend = DETREND_CODES[cfg.detrend]
    K, L = cfg.nfft_, cfg.nperseg
    opts = (detrend, int(log10_out), mode, int(with_stats))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if kernel == "fft":
            fc = fft_constants(cfg, fs, x.device, out_mode)
            err = lib.stft_fft_psd_launch(
                x.data_ptr(), fc.window.data_ptr(), fc.twiddles.data_ptr(),
                fc.wts.data_ptr(), out.data_ptr(), *stats, B, n, T, F, K, L,
                cfg.hop_, *opts, f_lo, stream)
        elif kernel == "mixed":
            mc = mixed_constants(cfg, fs, x.device, out_mode)
            err = lib.stft_mixed_fft_psd_launch(
                x.data_ptr(), mc.window.data_ptr(), mc.perm.data_ptr(),
                mc.twiddles.data_ptr(), mc.stages.ctypes.data,
                len(mc.stages), mc.split, mc.rader, mc.wts.data_ptr(),
                out.data_ptr(), *stats, B, n, T, F, K, L, cfg.hop_, *opts,
                f_lo, stream)
        elif kernel == "odd":
            mc = mixed_constants(cfg, fs, x.device, out_mode)
            err = lib.stft_odd_fft_psd_launch(
                x.data_ptr(), mc.window.data_ptr(), mc.perm.data_ptr(),
                mc.twiddles.data_ptr(), mc.stages.ctypes.data,
                len(mc.stages), mc.rader, mc.wts.data_ptr(), out.data_ptr(),
                *stats, B, n, T, F, K, L, cfg.hop_, *opts, int(pack), f_lo,
                stream)
        elif kernel == "bluestein":
            bc = bluestein_constants(cfg, fs, x.device, out_mode)
            err = lib.stft_bluestein_psd_launch(
                x.data_ptr(), bc.window.data_ptr(), bc.twiddles.data_ptr(),
                bc.stages.ctypes.data, len(bc.stages), bc.m, bc.bhat,
                bc.chirp, bc.split, bc.wts.data_ptr(), out.data_ptr(),
                *stats, B, n, T, F, K, L, cfg.hop_, *opts, f_lo, stream)
        else:
            dc = dft_constants(cfg, fs, x.device, (f_lo, f_hi), out_mode)
            err = lib.stft_psd_launch(
                x.data_ptr(), dc.a_re.data_ptr(), dc.a_im.data_ptr(),
                dc.wts.data_ptr(), out.data_ptr(), *stats, B, n, T, F,
                cfg.nperseg, cfg.hop_, int(log10_out), mode,
                int(with_stats), stream)
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


_GRAD_LIB: list = []


def _grad_library() -> ctypes.CDLL:
    """The backward kernels' library (``csrc/stft_grad.cu``), built and
    loaded at first use, then kept for the process."""
    if _GRAD_LIB:
        return _GRAD_LIB[0]
    lib = build.load_library(GRAD_KERNEL)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.stft_backward_launch.argtypes = [ptr] * 5 + [i64, i32, i32, i32,
                                                     ptr, ptr]
    lib.stft_backward_launch.restype = i32
    lib.overlap_add_launch.argtypes = [ptr, i64, i64, i32, i32, i32, ptr,
                                       ptr]
    lib.overlap_add_launch.restype = i32
    lib.stft_fft_backward_launch.argtypes = [ptr] * 6 + [
        i32, i64] + [i32] * 9 + [ptr]
    lib.stft_fft_backward_launch.restype = i32
    lib.stft_small_backward_launch.argtypes = [ptr] * 6 + [
        i32, i64] + [i32] * 5 + [ptr]
    lib.stft_small_backward_launch.restype = i32
    lib.stft_grad_error_string.argtypes = [i32]
    lib.stft_grad_error_string.restype = ctypes.c_char_p
    _GRAD_LIB.append(lib)
    return lib


_GRAD_MIXED_LIB: list = []


def _grad_mixed_library() -> ctypes.CDLL:
    """The mixed, odd and Bluestein routes' backward kernels' library
    (``csrc/stft_grad_mixed.cu``), built and loaded at first use, then
    kept for the process."""
    if _GRAD_MIXED_LIB:
        return _GRAD_MIXED_LIB[0]
    lib = build.load_library(GRAD_MIXED_KERNEL)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.stft_mixed_fft_backward_launch.argtypes = [ptr] * 6 + [
        i32, i32, i32, ptr, ptr, i32, i64] + [i32] * 9 + [ptr]
    lib.stft_mixed_fft_backward_launch.restype = i32
    lib.stft_odd_fft_backward_launch.argtypes = [ptr] * 6 + [
        i32, i32, ptr, ptr, i32, i64] + [i32] * 9 + [ptr]
    lib.stft_odd_fft_backward_launch.restype = i32
    lib.stft_bluestein_fft_backward_launch.argtypes = [ptr] * 5 + [
        i32] * 5 + [ptr] * 2 + [i32, i64] + [i32] * 9 + [ptr]
    lib.stft_bluestein_fft_backward_launch.restype = i32
    lib.stft_grad_mixed_error_string.argtypes = [i32]
    lib.stft_grad_mixed_error_string.restype = ctypes.c_char_p
    _GRAD_MIXED_LIB.append(lib)
    return lib


class GradOp(NamedTuple):
    """What the forward computed, for its backward: the output ``out``
    ("psd" or "magnitude" by cfg.mode, "complex" scaled, "stft"
    unscaled), its band, the route's kernel, and the extrema it returned
    beside the output ("" none, "extrema" as with_stats, "partials" as
    :func:`stft_psd_partials`)."""
    fs: float
    cfg: SpecConfig
    band: Optional[Tuple[int, int]]
    out: str
    kernel: str
    stats: str = ""


def _forward(x: torch.Tensor, op: GradOp, log10_out: bool = False):
    """The entry points' one launch of the route's kernel for a CUDA
    tensor, the plain version for a CPU tensor, of x's (uncentered)
    frames."""
    cfg, fs = op.cfg, op.fs
    if x.device.type == "cpu":
        if op.out in ("complex", "stft"):
            return stft_complex_reference(
                x, plain_constants(cfg, fs, x.device, op.band, op.out), cfg)
        p = stft_psd_reference(x, plain_constants(cfg, fs, x.device,
                                                  op.band),
                               cfg, log10_out=log10_out,
                               with_stats=op.stats == "extrema")
        return (p, row_partials(p)) if op.stats == "partials" else p
    return _stft_psd_cuda(x, fs, cfg, log10_out, bool(op.stats), op.kernel,
                          partials=op.stats == "partials", band=op.band,
                          out_mode=op.out)


class _StftGrad(torch.autograd.Function):
    """The STFT kernels' output as a differentiable function of the
    waveform: forward :func:`_forward` (saving only x), backward
    :func:`stft_backward`. The partials and extrema beside the output are
    marked non-differentiable."""

    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        ctx.save_for_backward(x)
        out = _forward(x, op)
        if isinstance(out, tuple):
            ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    def backward(ctx, g, *_):
        x, = ctx.saved_tensors
        return stft_backward(x, g, ctx.op), None


def _apply(x: torch.Tensor, op: GradOp, log10_out: bool = False):
    """:func:`_forward`, through :class:`_StftGrad` when x needs a
    gradient; past nperseg 8192 autograd through the plain version on a
    CPU tensor, and on a CUDA tensor NotImplementedError naming ROADMAP
    [large-nperseg] before any launch (:func:`backward_route`)."""
    if x.requires_grad and torch.is_grad_enabled():
        if op.cfg.nperseg > DENSE_MAX_NPERSEG:
            if x.device.type == "cpu":
                return _forward(x, op, log10_out)
            backward_route(op.cfg, op.band)       # raises
        if log10_out:
            raise ValueError("log10_out has no gradient (ROADMAP [grad]; "
                             "the JAX package's Pallas kernel has none "
                             "there): detach the waveform, or take "
                             "torch.log10 of the PSD")
        return _StftGrad.apply(x, op)
    return _forward(x, op, log10_out)


def stft_backward(x: torch.Tensor, g: torch.Tensor, op: GradOp,
                  _backward: Optional[str] = None) -> torch.Tensor:
    """The gradient of the (uncentered) waveform x (B, n) from the
    gradient g of the output ``op`` describes. For a CUDA tensor, by
    :func:`backward_route` (``_backward`` forces "dense" on any config, for
    cross-checks and timing; a forced adjoint the config does not allow
    raises): "fft", "mixed", "odd" or "bluestein", one launch of the
    route's FFT adjoint (:func:`frames_backward_fft`,
    :func:`frames_backward_mixed`, :func:`frames_backward_odd`,
    :func:`frames_backward_bluestein`), X recomputed inside it; "small"
    (the GEMM route's small-K configs), one launch of
    :func:`frames_backward_small`, X recomputed inside it; "dense" (the
    rest of the GEMM route), one launch of the route's complex epilogue (X
    unscaled), then :func:`frames_backward` against the folded matrices;
    then :func:`overlap_add`. For a CPU tensor the plain version
    (:func:`stft_backward_reference`)."""
    cfg = op.cfg
    if x.device.type == "cpu":
        consts = dft_constants(cfg, op.fs, x.device, op.band, op.out)
        return stft_backward_reference(x, g, consts, cfg, op.out)
    kind = _backward or backward_route(cfg, op.band)
    if kind not in ("dense", backward_route(cfg, op.band)):
        raise ValueError(f"no {kind!r} backward for nperseg {cfg.nperseg}, "
                         f"nfft {cfg.nfft_}")
    lo, hi = check_band(cfg, op.band)
    B, n = x.shape
    T = num_frames(n, cfg.nperseg, cfg.hop_)
    if tuple(g.shape) != (B, T, hi - lo):
        raise ValueError(f"the STFT backward takes a ({B}, {T}, {hi - lo}) "
                         f"gradient, got {tuple(g.shape)}")
    if T <= 0:
        return torch.zeros_like(x)
    if kind in FFT_BACKWARD_ROUTES:
        frames = {"fft": frames_backward_fft, "mixed": frames_backward_mixed,
                  "odd": frames_backward_odd,
                  "bluestein": frames_backward_bluestein}[kind]
        d = frames(g, x, cfg, op.fs, op.band, op.out)
    elif kind == "small":
        d = frames_backward_small(g, x, cfg, op.fs, op.band, op.out)
    else:
        X = _stft_psd_cuda(x, op.fs, cfg, False, False, op.kernel,
                           band=op.band, out_mode="stft")
        d = frames_backward(g, X, dft_constants(cfg, op.fs, x.device,
                                                op.band, op.out), op.out)
    return overlap_add(d, n, cfg.hop_)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def frames_backward(g: torch.Tensor, X: torch.Tensor, consts: DftConstants,
                    out: str) -> torch.Tensor:
    """The frames' gradient (B, T, L) from the output's gradient g and the
    unscaled STFT X (B, T, F): one launch of ``stft_backward_kernel`` for
    CUDA tensors (float32 g, complex64 for a complex output; complex64 X;
    consts on the same device), the plain version
    (:func:`frames_backward_reference`) for CPU tensors."""
    if X.device.type == "cpu":
        return frames_backward_reference(g, X, consts, out)
    lib = _grad_library()
    B, T, F = X.shape
    L = consts.a_re.shape[0]
    want = torch.complex64 if out in ("complex", "stft") else torch.float32
    if (X.dtype != torch.complex64 or consts.a_re.shape[1] != F
            or g.dtype != want or g.shape != X.shape):
        raise ValueError(f"the STFT backward takes a complex64 X of the "
                         f"constants' {consts.a_re.shape[1]} bins and a "
                         f"{want} gradient of its shape, got X {X.dtype} "
                         f"{tuple(X.shape)}, g {g.dtype} {tuple(g.shape)}")
    g = g.resolve_conj().contiguous()
    X = X.contiguous()
    d = torch.empty((B, T, L), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        err = lib.stft_backward_launch(
            g.data_ptr(), X.data_ptr(), consts.wts.data_ptr(),
            consts.a_re.data_ptr(), consts.a_im.data_ptr(), B * T, F, L,
            _out_mode(out), d.data_ptr(), _stream(X))
    if err != 0:
        raise RuntimeError("stft_backward kernel launch failed: "
                           + lib.stft_grad_error_string(err).decode())
    grad_launches["stft_backward"] += 1
    return d


# the FFT adjoints' names in messages
_ROUTE_NAMES = {"fft": "radix-2", "mixed": "mixed", "odd": "odd",
                "bluestein": "Bluestein"}


def _frames_backward_engine(g: torch.Tensor, x: torch.Tensor,
                            cfg: SpecConfig, fs: float, band, out: str,
                            kind: str) -> torch.Tensor:
    """One launch of the FFT adjoint of route ``kind`` ("fft", "mixed",
    "odd" or "bluestein") for CUDA tensors, on the forward's operands
    (:func:`fft_constants`, :func:`mixed_constants`,
    :func:`bluestein_constants`); the plain version for CPU tensors. A
    config off that route raises."""
    if x.device.type == "cpu":
        return frames_backward_fft_reference(g, x, cfg, fs, band, out)
    name = _ROUTE_NAMES[kind]
    if backward_route(cfg) != kind:
        raise ValueError(f"nfft {cfg.nfft_} is not on the {name} route")
    lo, hi = check_band(cfg, band)
    B, n = x.shape
    T = num_frames(n, cfg.nperseg, cfg.hop_)
    want = torch.complex64 if out in ("complex", "stft") else torch.float32
    if (x.dtype != torch.float32 or g.dtype != want
            or tuple(g.shape) != (B, T, hi - lo)):
        raise ValueError(f"the {name} backward takes a float32 (B, n) "
                         f"waveform and a {want} ({B}, {T}, {hi - lo}) "
                         f"gradient, got x {x.dtype}, g {g.dtype} "
                         f"{tuple(g.shape)}")
    if B * T > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} frames per launch, got "
                         f"{B} clips x {T} frames")
    d = torch.empty((B, T, cfg.nperseg), dtype=torch.float32, device=x.device)
    if T <= 0:
        return d
    g = g.resolve_conj().contiguous()
    x = x.contiguous()
    sizes = (B, n, T, hi - lo, cfg.nfft_, cfg.nperseg, cfg.hop_,
             DETREND_CODES[cfg.detrend], _out_mode(out), int(not cfg.onesided),
             lo)
    if kind == "fft":
        lib = _grad_library()
        fc = fft_constants(cfg, fs, x.device, out)
        args = (x.data_ptr(), g.data_ptr(), fc.window.data_ptr(),
                fc.twiddles.data_ptr(), fc.wts.data_ptr(), d.data_ptr(),
                *sizes)
        launch = lib.stft_fft_backward_launch
        errors = lib.stft_grad_error_string
    elif kind == "bluestein":
        lib = _grad_mixed_library()
        bc = bluestein_constants(cfg, fs, x.device, out)
        args = (x.data_ptr(), g.data_ptr(), bc.window.data_ptr(),
                bc.twiddles.data_ptr(), bc.stages.ctypes.data,
                len(bc.stages), bc.m, bc.bhat, bc.chirp, bc.split,
                bc.wts.data_ptr(), d.data_ptr(), *sizes)
        launch = lib.stft_bluestein_fft_backward_launch
        errors = lib.stft_grad_mixed_error_string
    else:
        lib = _grad_mixed_library()
        mc = mixed_constants(cfg, fs, x.device, out)
        args = (x.data_ptr(), g.data_ptr(), mc.window.data_ptr(),
                mc.perm.data_ptr(), mc.twiddles.data_ptr(),
                mc.stages.ctypes.data, len(mc.stages))
        if kind == "mixed":
            args += (mc.split, mc.rader, mc.wts.data_ptr(), d.data_ptr(),
                     *sizes)
            launch = lib.stft_mixed_fft_backward_launch
        else:
            args += (mc.rader, mc.wts.data_ptr(), d.data_ptr(), *sizes)
            launch = lib.stft_odd_fft_backward_launch
        errors = lib.stft_grad_mixed_error_string
    with torch.cuda.device(x.device):
        err = launch(*args, _stream(x))
    if err != 0:
        raise RuntimeError(f"stft_{kind}_backward kernel launch failed: "
                           + errors(err).decode())
    grad_launches[f"stft_{kind}_backward"] += 1
    return d


def frames_backward_fft(g: torch.Tensor, x: torch.Tensor, cfg: SpecConfig,
                        fs: float, band=None,
                        out: Optional[str] = None) -> torch.Tensor:
    """The frames' gradient (B, T, L) on the radix-2 route from the
    output's gradient g (B, T, F) (the band's bins; complex64 for a
    complex output, else float32) and the forward's uncentered float32
    waveform x (B, n): one launch of ``stft_fft_backward_kernel`` for CUDA
    tensors, X recomputed in registers, the FFT route's operands
    (:func:`fft_constants`), no dense matrix; the plain version
    (:func:`frames_backward_fft_reference`) for CPU tensors. A config off
    the radix-2 route raises."""
    return _frames_backward_engine(g, x, cfg, fs, band, out or cfg.mode,
                                   "fft")


def frames_backward_mixed(g: torch.Tensor, x: torch.Tensor, cfg: SpecConfig,
                          fs: float, band=None,
                          out: Optional[str] = None) -> torch.Tensor:
    """The frames' gradient (B, T, L) on the mixed route, as
    :func:`frames_backward_fft`: one launch of
    ``stft_mixed_fft_backward_kernel`` (a Rader plan:
    ``stft_odd_fft_backward_kernel``'s PACKED form) for CUDA tensors, X
    recomputed on the mixed route's engine, its operands
    (:func:`mixed_constants`), no dense matrix; the plain version for CPU
    tensors. A config off the mixed route raises."""
    return _frames_backward_engine(g, x, cfg, fs, band, out or cfg.mode,
                                   "mixed")


def frames_backward_odd(g: torch.Tensor, x: torch.Tensor, cfg: SpecConfig,
                        fs: float, band=None,
                        out: Optional[str] = None) -> torch.Tensor:
    """The frames' gradient (B, T, L) on the odd route, as
    :func:`frames_backward_mixed`: one launch of
    ``stft_odd_fft_backward_kernel`` for CUDA tensors, two frames of a
    clip a block, paired in the recompute as the forward pairs them and in
    the inverse where the cotangents' guard allows; the plain version for
    CPU tensors. A config off the odd route raises."""
    return _frames_backward_engine(g, x, cfg, fs, band, out or cfg.mode,
                                   "odd")


def frames_backward_bluestein(g: torch.Tensor, x: torch.Tensor,
                              cfg: SpecConfig, fs: float, band=None,
                              out: Optional[str] = None) -> torch.Tensor:
    """The frames' gradient (B, T, L) on the Bluestein route, as
    :func:`frames_backward_mixed`: one launch of
    ``stft_bluestein_fft_backward_kernel`` for CUDA tensors (a block a
    unit, or a cluster of two past the one-block buffer), X recomputed on
    the Bluestein transform and the inverse by the same transform, its
    operands (:func:`bluestein_constants`), no dense matrix; the plain
    version for CPU tensors. A config off the Bluestein route raises."""
    return _frames_backward_engine(g, x, cfg, fs, band, out or cfg.mode,
                                   "bluestein")


def frames_backward_small(g: torch.Tensor, x: torch.Tensor, cfg: SpecConfig,
                          fs: float, band=None,
                          out: Optional[str] = None) -> torch.Tensor:
    """The frames' gradient (B, T, L) on the GEMM route's small-K configs
    (:func:`backward_route` "small") from the output's gradient g (B, T, F)
    (the band's bins; complex64 for a complex output, else float32) and the
    forward's uncentered float32 waveform x (B, n): one launch of
    ``stft_small_backward_kernel`` for CUDA tensors, X recomputed in
    registers from the folded matrices (:func:`dft_constants`), no X in
    memory; the plain version (:func:`frames_backward_small_reference`)
    for CPU tensors. A config or band off those configs raises."""
    out = out or cfg.mode
    if x.device.type == "cpu":
        return frames_backward_small_reference(g, x, cfg, fs, band, out)
    if backward_route(cfg, band) != "small":
        raise ValueError(f"nperseg {cfg.nperseg}, nfft {cfg.nfft_} with "
                         f"band {band} is not on the GEMM route's small-K "
                         "backward")
    lo, hi = check_band(cfg, band)
    B, n = x.shape
    T = num_frames(n, cfg.nperseg, cfg.hop_)
    want = torch.complex64 if out in ("complex", "stft") else torch.float32
    if (x.dtype != torch.float32 or g.dtype != want
            or tuple(g.shape) != (B, T, hi - lo)):
        raise ValueError(f"the small-K backward takes a float32 (B, n) "
                         f"waveform and a {want} ({B}, {T}, {hi - lo}) "
                         f"gradient, got x {x.dtype}, g {g.dtype} "
                         f"{tuple(g.shape)}")
    if B * T > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} frames per launch, got "
                         f"{B} clips x {T} frames")
    d = torch.empty((B, T, cfg.nperseg), dtype=torch.float32, device=x.device)
    if T <= 0:
        return d
    lib = _grad_library()
    consts = dft_constants(cfg, fs, x.device, band, out)
    g = g.resolve_conj().contiguous()
    x = x.contiguous()
    with torch.cuda.device(x.device):
        err = lib.stft_small_backward_launch(
            x.data_ptr(), g.data_ptr(), consts.a_re.data_ptr(),
            consts.a_im.data_ptr(), consts.wts.data_ptr(), d.data_ptr(), B,
            n, T, hi - lo, cfg.nperseg, cfg.hop_, _out_mode(out), _stream(x))
    if err != 0:
        raise RuntimeError("stft_small_backward kernel launch failed: "
                           + lib.stft_grad_error_string(err).decode())
    grad_launches["stft_small_backward"] += 1
    return d


def overlap_add(d: torch.Tensor, n: int, hop: int) -> torch.Tensor:
    """The framing's adjoint, (B, T, L) -> (B, n): one launch of
    ``overlap_add_kernel`` for a contiguous float32 CUDA tensor (T >= 1),
    the plain version (:func:`overlap_add_reference`) for a CPU tensor."""
    if d.device.type == "cpu":
        return overlap_add_reference(d, n, hop)
    lib = _grad_library()
    B, T, L = d.shape
    if d.dtype != torch.float32 or not d.is_contiguous():
        raise TypeError("the overlap-add kernel takes a contiguous float32 "
                        "(B, T, L) tensor")
    dx = torch.empty((B, n), dtype=torch.float32, device=d.device)
    with torch.cuda.device(d.device):
        err = lib.overlap_add_launch(d.data_ptr(), B, n, T, L, hop,
                                     dx.data_ptr(), _stream(d))
    if err != 0:
        raise RuntimeError("overlap_add kernel launch failed: "
                           + lib.stft_grad_error_string(err).decode())
    grad_launches["overlap_add"] += 1
    return dx


def stft_psd_partials(x: torch.Tensor, fs: float, cfg: SpecConfig,
                      band=None):
    """The PSD (or cfg.mode's magnitude) of a (B, n) waveform and its
    per-row extrema unreduced: (B, T, F) float32 and the partials (2,
    n_tiles, B, T), the min and then the max of each frame's bins in each
    frequency tile (n_tiles 1 but on the GEMM route's forced large tile),
    which ``ops.display_cuda.clip_stats`` reduces per clip. band=(lo, hi)
    gives the bins lo to hi - 1 alone (F = hi - lo), and the partials over
    them. A centered config pads x first (``core.stft.center_pad``). One
    launch of the route's kernel for a CUDA tensor; for a CPU tensor the
    plain version, and the partials its per-frame min and max (n_tiles
    1)."""
    if x.ndim != 2:
        raise ValueError(f"expected a (B, n) waveform, got {x.ndim}-D")
    check_supported(cfg)
    _require_power(cfg)
    x = center_pad(x, cfg)
    return _apply(x, GradOp(fs, cfg, band, cfg.mode, route(cfg),
                            "partials"))


def bluestein_clusters(cfg: SpecConfig, device) -> int:
    """How many of the Bluestein kernel's clusters of 4 or 8 blocks for
    cfg's nfft the card ``device`` holds at once at their shared memory
    (``cudaOccupancyMaxActiveClusters``); the launcher refuses a cluster
    that cannot be placed (0). A config on another form raises."""
    plan = bluestein_route_plan(cfg.nfft_)
    if plan.ranks < 4:
        raise ValueError(f"nfft {cfg.nfft_} runs on {plan.ranks} block(s), "
                         "not a cluster of 4 or 8")
    lib = _library()
    count = ctypes.c_int(0)
    ext = int(cfg.nperseg < cfg.nfft_ or cfg.mode != "psd")
    with torch.cuda.device(torch.device(device)):
        err = lib.stft_bluestein_clusters(plan.ranks, plan.m // plan.ranks,
                                          ext, ctypes.byref(count))
    if err != 0:
        raise RuntimeError("stft_bluestein_clusters failed: "
                           + lib.stft_psd_error_string(err).decode())
    return count.value


def row_partials(p: torch.Tensor) -> torch.Tensor:
    """The plain partials of a (B, T, F) tensor: each row's NaN-propagating
    min and max over its F values, (2, 1, B, T), the kernels' layout."""
    return torch.stack([torch.amin(p, dim=-1), torch.amax(p, dim=-1)])[:, None]


def stft_psd(x, fs: float, cfg: SpecConfig, *, log10_out: bool = False,
             with_stats: bool = False, band=None,
             _route: Optional[str] = None):
    """Fused PSD spectrogram: (n,) or (B, n) -> (B?, T, F) float32, the
    PSD, or the magnitude when cfg.mode is 'magnitude' (scipy's
    mode='magnitude'); cfg.mode 'complex' raises the JAX package's
    ValueError (:func:`stft_complex` computes it).

    band=(lo, hi) computes the bins lo to hi - 1 alone (F = hi - lo; the
    fmin/fmax mask, ``core.stft.band_row_slice``), each bitwise the full
    band's bin on every route; None is the full band. with_stats=True
    also returns each clip's min and max over those bins, (B?,) each,
    NaN-propagating, for ``core.scale.normalize_from_stats``; it cannot be
    combined with log10_out. A centered config pads x first
    (``core.stft.center_pad``); a two-sided one gives all nfft bins. A
    config outside :func:`kernel_supported` raises NotImplementedError on
    every device. On a CUDA tensor the kernel is the one :func:`route`
    picks; ``_route`` forces another the config allows ("gemm" at nperseg
    up to 8192, "bluestein" on any nfft from 32 to 32,768, else only the
    config's own route), for timing the kernels against each other."""
    if with_stats and log10_out:
        raise ValueError("with_stats computes linear-PSD extrema; "
                         "combine with log10_out is unsupported")
    _require_power(cfg)
    kernel = route(cfg)
    if _route is not None:
        forced = [kernel]
        if cfg.nperseg <= MAX_NPERSEG:
            forced.append("gemm")
        if MIN_FFT_NPERSEG <= cfg.nfft_ <= MAX_FFT_NFFT:
            forced.append("bluestein")
        if _route not in forced:
            raise ValueError(f"no {_route!r} route for nperseg "
                             f"{cfg.nperseg}, nfft {cfg.nfft_}, detrend "
                             f"{cfg.detrend!r}")
        kernel = _route
    check_band(cfg, band)
    x = ensure_real_waveform(x)
    if x.ndim == 1:
        out = stft_psd(x[None], fs, cfg, log10_out=log10_out,
                       with_stats=with_stats, band=band, _route=_route)
        return tuple(o[0] for o in out) if with_stats else out[0]
    if x.ndim != 2:
        raise ValueError(f"expected a (n,) or (B, n) waveform, got {x.ndim}-D")
    x = center_pad(x, cfg)
    return _apply(x, GradOp(fs, cfg, band, cfg.mode, kernel,
                            "extrema" if with_stats else ""), log10_out)


def stft_complex(x, fs: float, cfg: SpecConfig, band=None, *,
                 scaled: bool = True):
    """The complex STFT from the kernels' epilogue: (n,) or (B, n) -> (B?,
    T, F), frame-major, X of each windowed, detrended (and zero-padded)
    frame, whatever cfg.mode. scaled=True multiplies it by sqrt of the PSD
    scale (scipy's mode='complex', with no one-sided doubling); False
    gives the unscaled transform (``core.stft.stft``). A two-sided
    spectrum's bins past nfft/2 are the conjugates of their mirrors
    bitwise. band, centering, routes and devices as :func:`stft_psd`: on a
    CUDA tensor one launch of the route's kernel (float32 in, complex64
    out; another dtype raises TypeError), on a CPU tensor the plain
    version (:func:`stft_complex_reference`), complex in x's
    precision."""
    kernel = route(cfg)
    out_mode = "complex" if scaled else "stft"
    check_band(cfg, band)
    x = ensure_real_waveform(x)
    if x.ndim == 1:
        return stft_complex(x[None], fs, cfg, band, scaled=scaled)[0]
    if x.ndim != 2:
        raise ValueError(f"expected a (n,) or (B, n) waveform, got {x.ndim}-D")
    x = center_pad(x, cfg)
    return _apply(x, GradOp(fs, cfg, band, out_mode, kernel))
