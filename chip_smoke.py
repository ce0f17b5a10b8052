#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (spectral_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; run it from the root of a checkout. It
builds every kernel of the port's paths from the sources in the checkout
(``csrc/stft_psd.cu``, ``csrc/display.cu``, ``csrc/mel.cu`` and
``csrc/hmm.cu``, one nvcc each, started together) and holds each kernel
against its plain PyTorch version on the card: the STFT/PSD kernel's five routes (the FFT kernel at power-of-two
nperseg 32-8192, under every detrend, beside zero, NaN and 1e-6 frames,
an overflow clip, log10_out, B T = 1 and T = 0, each held to 1 float32
ulp, with its ptxas registers and spills printed; the mixed-radix
kernel at the other GUI values, every radix from 3 to 251, nperseg
96-8160, the edges of its passes, with its ptxas registers and spills
printed too; both under linear detrend on ramp clips too; each
mixed-radix, Rader and odd kernel's first launch at a buffer just under 48
KB, in a fresh process; the odd kernel at nperseg 33-8191 under every
detrend, with and without a Rader stage, and on frames that its pairing
must keep apart; the mixed route's Rader plans on the odd kernel's PACKED
form at each of its four instantiations and at plans of few butterflies
(MIXED_RADER_CASES); the Bluestein kernel on one block at 563-8182 and on
a cluster of two at 7207-8189, the same way, and forced at 33, 1024, 8032
and 8191; the GEMM route's small-K tile at every nperseg 2-31 with hop
below and above nperseg, rows that cross a clip's edge inside a block,
NaN and overflow clips, log10_out and T = 0 (GEMM_CASES); the ptxas
registers and spills of the odd, Bluestein and GEMM kernels'
instantiations; the GEMM kernel's large tile forced beside them) and the
display tail's two kernels (``clip_stats``: pmin and pmax bitwise
``torch.amin``/``amax`` of the partials, the flags and display operands
the plain version's, on NaN, inf, DC, tiny, silent and loud clips, odd n,
forced GEMM partials of several frequency tiles, T = 0, share_max and a
batch past 65,535 clips; the display map: the image within IMAGE_TOL of
the plain version, the words at least 99.9% identical and never more
than one LUT index apart, at odd T and F, T < 4, T = 0, share_max,
flip_image, colormap=None, RGBA and palette words with and without the
image, and past 65,535 clips). Pure-DC clips (1e-4, 3e-3, 0.1; 10 s)
through ``batched_spectrogram_fn`` at scipy_default 1024 and 8160 must
come out healthy. The fmin/fmax band on each of the five routes (phase
``band``: the radix-2 kernel at 32, 1024 and 8192, the mixed-radix one at
960 under linear detrend and 8160, its Rader plan at 1006, the odd one at
1023 and 8191, the Bluestein one at 2049, 8182 and 8185, the GEMM one's
small-K tile at 24 and its large tile forced at 1024) must give, at every
band of ``_bands`` (DC alone, the Nyquist or last bin alone, a band from
past 0, one row, inside one GEMM tile and across tiles), the full band's
columns bitwise: the PSD, its log10_out and the partials; the PSD entry
points of ``core/stft.py`` on a CUDA tensor must launch the route's kernel
once each. The mel kernel (phase ``mel``) must match its plain version
with injected inf and NaN bins, NaN and inf in the same places and the
rest within MEL_ULPS. The HMM kernels (phase ``hmm``, float64): H1, the
Baum-Welch fit, at T 4, 5, 600 and 2047, D 1 and 2, K 4 and 2, on a
model with structural zeros and with the loop stopped at it == 1 and
it == 2, its iteration counts equal to its plain version's, parameters
within HMM_PARAM_TOL and log-likelihoods within HMM_LL_TOL; H2, Viterbi,
at T 1, 2, 3, 600, 2047, 2048 and 65,536 on an escape-patched EM model
and a supervised one, both forms (a block a sequence up to 2048, chunked
at every T), paths identical to the plain versions' and to each other;
H3, the chunked E-step, at T 2048, 8192 and 524,288, statistics within
HMM_STATS_TOL and the log-likelihood within HMM_LL_TOL; a six-state model
(the instantiation for 5-8 states) through all three at T 3000; with
each kernel's ptxas registers and spills. Then it drives fifteen paths at
full size, each
with the launch counts set to 0 just before it and read just after; each
call of the pipeline on paths 1-11 and 13 is one launch of the route's
STFT kernel, one of clip_stats and one of the display map, and on path 12
the STFT kernel, the mel kernel, clip_stats and the display map (path 1
also under ``torch.profiler``, which must show those three kernels and no
other; it prints them and the device's idle share; paths 14 and 15
launch the detection kernels named there):

1. the display spine: 1024 clips of 10 s at 16 kHz through
   ``batched_spectrogram_fn`` at north_star 1024/256 log (RGBA words), on
   the FFT route;
2. the end of the GUI's range: 256 clips of 60 s through
   ``batched_spectrogram_fn`` at scipy_default 8192 log (the TPU's
   manual-DMA kernel K2's counterpart), on the FFT route;
3. the dataset export: ``export_spectrograms`` at the CLI's defaults
   (north_star 1024/256 log, 10 s clips, batch 64, palette PNGs) over 1024
   synthetic clips, a batch of int16 WAVs and a NaN clip, on the FFT
   route;
4. the mixed-radix route at the GUI's largest value that is not a power
   of two: path 2's batch at scipy_default 8160 (M = 2^4 3 5 17);
5. the mixed-radix route's slowest GUI value, its largest prime: path 2's
   batch at scipy_default 8032 (M = 2^4 251);
6. linear detrend on the mixed-radix route: path 2's batch at
   scipy_default 8160 with detrend='linear', held to scipy on a ramp clip
   too;
7. the odd route with a Rader stage, off the GUI's range: path 2's batch
   at scipy_default 8191 (a prime; 8190 = 2 3^2 5 7 13), timed with its
   frames packed two a transform and alone;
8. the Bluestein route on a cluster of two blocks: path 2's batch at
   scipy_default 8185 (5 1637, and 1636 = 2^2 409; M = 16384);
9. the Bluestein route on one block: path 2's batch at scipy_default 8182
   (2 4091, and 4090 = 2 5 409; M = 8192);
10. the GEMM route on a config it still computes: path 1's batch at
    scipy_default 24, below the FFT kernels' 32 (the small-K tile);
11. the mixed route's Rader plan at full width: path 2's batch at
    scipy_default 8186 (2 4093, and 4092 = 2^2 3 11 31), on the odd
    kernel's PACKED form;
12. the mel branch (BASELINE.json config 2): path 1's batch at north_star
    1024/256 with 128 log mels, the mel kernel timed against its bound
    and against ``torch.matmul`` in float64 with ``amin``/``amax``; then
    ``export_spectrograms`` over four batches of 64 of its clips;
13. the GUI's band on an EEG-rate batch: 256 clips of 16 min at 1 kHz at
    scipy_default 1024 with fmin 0 and fmax 30 (31 of 513 bins), held to
    scipy in float64, its STFT kernel timed beside the full band's;
14. fleet detection (the CLI's ``detect --each --batched`` flow): path
    13's batch with planted bursts (3-25 Hz, 6-12 dB, 2-20 s) through the
    STFT kernel on the 0-30 Hz band, ``features_from_psd`` and
    ``batch_unsupervised_detect``: one launch each of the STFT kernel, H1
    and H2 (a block a sequence); the states of all 256 sweeps and the
    events of the first 8 held to the plain versions, H2's chunked form
    to the block form on the same inputs, the planted bursts found in the
    decoded states (``detection_quality``); the stages timed (host
    k-means init, H1, H2 in both forms, scans) with the EM iterations;
15. one long recording: ``BurstDetector(engine='auto')`` on 524,288
    frames (48 kHz, north_star 1024/256), features 0-4000 Hz: the STFT
    kernel, one H3 launch an EM iteration and H2's chunked form; the path
    held to the plain chunked versions (Viterbi on every frame, the
    E-step's statistics and log-likelihood), the planted bursts found.

It checks images against scipy in float64 (limit 1e-3 dB), the oracle in
``tools/torch_precision.py``, and times kernel, plain and library paths
with CUDA events (the display tail's kernels also as runs of RUN
launches between two events, over the count; also scipy_default 1024, 992, 2049 and 8186, the
mixed route's Rader plan, on path 1's batch): the library
yardstick of the STFT kernels is cuFFT's
float64 real transform of the same frames (``library_psd``), which the
port never calls. The GEMM kernel is also timed on paths 1, 2 and 4-9,
and the Bluestein kernel on paths 2 and 4-7, forced through
``stft_psd``'s module-private ``_route``, beside the route's kernel.

``main(_phases={...})`` runs the named phases only (a short first call
after a kernel changes: ``python3 -c "import chip_smoke;
chip_smoke.main(_phases={'kernels'})"``); with no arguments every phase
runs.

Every phase that fails raises, so the script exits nonzero and prints no
result. Without a CUDA card, or without the package beside it, it fails.
The last line of its output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import itertools
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))

FS = 16000.0
CLIP_SECONDS = 10.0
BATCH = 1024
K2_CLIPS = 256
K2_SECONDS = 60.0
MIXED_NPERSEG = 8160    # the GUI's largest nperseg that is not a power of 2
PRIME_NPERSEG = 8032    # 32 * 251: the GUI's largest odd prime factor
ODD_NPERSEG = 8191      # a prime off the GUI's grid: the odd route, Rader
BLUESTEIN_NPERSEG = 8185  # 5 * 1637, 1636 = 2^2 409: Bluestein, a cluster
BLUESTEIN_EVEN_NPERSEG = 8182   # 2 * 4091, 4090 = 2 5 409: one block
RADER_NPERSEG = 8186    # 2 * 4093, 4092 = 2^2 3 11 31: the mixed route's
                        # Rader plan (the odd kernel's PACKED form, path 11)
GEMM_NPERSEG = 24       # below the FFT kernels' 32: the GEMM kernel
# the odd route's kernel cases: each of the odd kernel's eight
# instantiations <RADER, RMAX> (conv_plan), without a Rader stage 45 <0, 0>,
# 33 and 1023 <0, 1>, 8181 <0, 4>, 8183 <0, 8>, with one 257 <1, 0>, 1021
# <1, 1>, 4093 and 8191 <1, 4>, 7487 <1, 8>
ODD_CASES = (33, 45, 257, 1021, 1023, 4093, 7487, 8181, 8183, 8191)
# the mixed route's Rader plans (even nperseg whose half is a prime p past
# 255 with a 255-smooth p - 1), on the odd kernel's PACKED form: both of
# its instantiations <true, RMAX, true>, 514 (P = 256, swizzled) and 1082
# <0>, and <1> (narrow generic passes) at 526, 934, 1006 and 2894 (a
# generic pass of 2 or 6 butterflies: 131, 233, 251, 241; 2 or 4 a round,
# the round's butterflies across the lanes), 4934 (137, 7 a round, the
# output pairs across the lanes), 4106 and 8186 (19; 31 and 11)
MIXED_RADER_CASES = (514, 526, 934, 1006, 1082, 2894, 4106, 4934, 8186)
# the GEMM route's small-K tile: every nperseg below 32
GEMM_CASES = tuple(range(2, 32))
# the Bluestein route's kernel cases: even (1126 = 2 563, 8182 = 2 4091),
# odd on one block (563, 2049 = 3 683, and 7201 at the block's budget, M =
# 14406) and on a cluster of two (7207, M = 14580; 8185, 8189, M = 16384)
BLUESTEIN_CASES = (563, 1126, 2049, 7201, 7207, 8182, 8185, 8189)
# the radix-2 route's kernel cases: every power of two it takes, each
# with its own geometry (8 values a thread, 128 to 1 frames a block)
R2_CASES = tuple(2 ** b for b in range(5, 14))
EXPORT_CLIPS = 1024
EXPORT_BATCH = 64
REPS = 5
RUN = 20                # launches a run, timing a kernel by runs
PSD_TOL = 5e-6          # max|Δ| per clip, relative to the clip's PSD max
IMAGE_TOL = 1e-6        # display image, same PSD in (shared scalars)
DB_TOL = 1e-3           # display contract against scipy float64
SAME_WORDS = 0.999      # packed words identical, else one LUT index apart
FP64_PEAK = 67e12       # H100 SXM, FP64 on the tensor cores (data sheet)
HBM_RATE = 3.35e12      # H100 SXM device memory, bytes/s


def require(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(name):
    print(f"== {name}", flush=True)


def run_text(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def psd_err(got, want):
    """Largest |Δ| per clip over the clip's PSD max; both (B, T, F)."""
    import torch
    diff = torch.amax(torch.abs(got - want), dim=(1, 2))
    scale = torch.amax(torch.abs(want), dim=(1, 2)).clamp_min(1e-30)
    return float(torch.amax(diff / scale)), float(torch.amax(diff))


def ulp_distance(got, want):
    """Largest distance in float32 ulps between entries finite in both
    (the bit patterns as ordered integers)."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    ok = torch.isfinite(got) & torch.isfinite(want)
    if not bool(ok.any()):
        return 0
    return int(torch.where(ok, (ordered(got) - ordered(want)).abs(), 0).max())


def library_psd(x, cfg, fs=FS):
    """The STFT kernels' library yardstick, never called by the port: the
    same PSD through cuFFT's float64 real transform (the transform
    ``torch.stft`` runs) of the same frames, framed with ``unfold`` so the
    detrend fits (the frame's mean, or its least-squares line), then |X|²
    times the weights, rounded to float32."""
    import torch
    from spectral_tpu_torch.core.stft import _window_f64, onesided_weights
    frames = x.double().unfold(-1, cfg.nperseg, cfg.hop_)
    if cfg.detrend in ("constant", "linear"):
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.detrend == "linear":
        t = torch.arange(cfg.nperseg, dtype=torch.float64, device=x.device)
        t = t - t.mean()
        frames = frames - ((frames @ t) / (t @ t))[..., None] * t
    win = torch.tensor(_window_f64(cfg), dtype=torch.float64, device=x.device)
    wts = torch.tensor(onesided_weights(cfg, fs), dtype=torch.float64,
                       device=x.device)
    spec = torch.view_as_real(torch.fft.rfft(frames * win, dim=-1))
    return (spec.square().sum(dim=-1) * wts).float()


def word_index_range(words):
    """First and last LUT index of each packed word (duplicates of the jet
    table are neighbours)."""
    import numpy as np
    from spectral_tpu_torch.ops.colormap import packed_lut
    lut = packed_lut("jet").numpy().view(np.uint32)
    first = {}
    last = {}
    for i, w in enumerate(lut.tolist()):
        first.setdefault(w, i)
        last[w] = i
    w = np.asarray(words, np.uint32).ravel()
    uniq, inv = np.unique(w, return_inverse=True)
    lo = np.array([first[u] for u in uniq.tolist()])[inv]
    hi = np.array([last[u] for u in uniq.tolist()])[inv]
    return lo, hi


def check_words(got, want, what):
    """>= 99.9% identical words and never more than one LUT index apart."""
    import numpy as np
    import torch
    a = got.cpu().view(torch.int32).numpy().view(np.uint32)
    b = want.cpu().view(torch.int32).numpy().view(np.uint32)
    same = float(np.mean(a == b))
    alo, ahi = word_index_range(a)
    blo, bhi = word_index_range(b)
    step = int(np.max(np.maximum(0, np.maximum(alo - bhi, blo - ahi))))
    require(same >= SAME_WORDS and step <= 1,
            f"{what}: {same:.6f} identical words, max index step {step}")
    return same


def check_indices(got, want, what):
    """Index images (uint8 LUT indices): >= 99.9% identical and never more
    than one index apart."""
    import numpy as np
    a = np.asarray(got).astype(np.int64)
    b = np.asarray(want).astype(np.int64)
    require(a.shape == b.shape, f"{what}: shapes {a.shape} vs {b.shape}")
    same = float(np.mean(a == b))
    step = int(np.abs(a - b).max()) if a.size else 0
    require(same >= SAME_WORDS and step <= 1,
            f"{what}: {same:.6f} identical indices, max step {step}")
    return same


def db_error_vs_scipy(img_unflipped, x64, cfg):
    """bench.py's display-error formula: max |Δimage| x dB range against
    scipy.signal.spectrogram in float64 at cfg's framing and window."""
    import numpy as np
    from torch_precision import scipy_display
    oracle, rng_db = scipy_display(x64, cfg, FS)
    require(img_unflipped.shape == oracle.shape,
            f"image {img_unflipped.shape} vs scipy {oracle.shape}")
    return float(np.max(np.abs(img_unflipped - oracle)) * rng_db)


def time_ms(fn, reps=REPS, run=1):
    """Median of reps CUDA-event timings after one warm-up, in ms: of one
    call between two events, or with ``run`` > 1 of a run of that many
    calls between two events, over the count (the host's time to launch
    is then hidden behind the card's work wherever the card is slower)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(run):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / run)
        del out
    return sorted(times)[reps // 2], times


def reset_counts():
    from spectral_tpu_torch.ops import (display_cuda, hmm_cuda, mel_cuda,
                                        stft_cuda)
    for counts in (stft_cuda.launches, display_cuda.launches,
                   mel_cuda.launches, hmm_cuda.launches):
        for key in counts:
            counts[key] = 0


def read_counts():
    from spectral_tpu_torch.ops import (display_cuda, hmm_cuda, mel_cuda,
                                        stft_cuda)
    return {"stft_psd": dict(stft_cuda.launches),
            "display": dict(display_cuda.launches),
            "mel": dict(mel_cuda.launches),
            "hmm": dict(hmm_cuda.launches)}


def require_one_call(counts, route, calls, what):
    """Each pipeline call launched one STFT kernel (of ``route``), one
    clip_stats and one display map, and nothing else."""
    stft, tail = counts["stft_psd"], counts["display"]
    require(stft[route] == calls and sum(stft.values()) == calls
            and counts["mel"]["mel"] == 0
            and not any(counts["hmm"].values())
            and tail["clip_stats"] == calls
            and tail["rgba"] + tail["palette"] == calls,
            f"{what}: {calls} call(s), each one {route} STFT kernel, one "
            f"clip_stats and one display map; counts {counts}")


def clip_stats_bound(B, n, T, n_tiles=1):
    """Bytes: the waveform and the partials read once, the per-clip
    results (pmin, pmax, finite, params) written once."""
    bytes_ = B * n * 4 + 2 * n_tiles * B * T * 4 + B * (4 + 4 + 1 + 12)
    return 1e3 * bytes_ / HBM_RATE, "bytes"


def card_flags(x, lo, hi):
    """The finite flags of clips x given their PSD extrema, through the
    clip_stats kernel (extrema as one partial row a clip), held to its
    plain version."""
    import torch
    from spectral_tpu_torch.ops import display_cuda
    parts = torch.stack([lo, hi])[:, None, :, None].contiguous()
    got = display_cuda.clip_stats(x, parts)
    want = display_cuda.clip_stats_reference(x, parts)
    torch.cuda.synchronize()
    require(torch.equal(got.finite, want.finite),
            f"clip_stats flags {got.finite.tolist()} against the plain "
            f"version's {want.finite.tolist()}")
    return got.finite.tolist()


def stft_bound(B, n, T, F, K):
    """(bound_ms, bound_by) of the STFT/PSD function, one count for both
    routes: the signal read once and the PSD and per-clip min and max
    written once, against a real FFT's 2.5*K*log2(K) operations per frame
    plus 3 per output bin (the power and its weight) at the card's FP64
    peak."""
    bytes_ = B * n * 4 + B * T * F * 4 + 2 * B * 4
    ops = B * T * (2.5 * K * math.log2(K) + 3.0 * F)
    t_mem, t_ops = bytes_ / HBM_RATE, ops / FP64_PEAK
    return (1e3 * max(t_mem, t_ops),
            "operations" if t_ops >= t_mem else "bytes")


def dense_dft_bound_ms(B, T, F, K):
    """The GEMM design's ceiling: its 4*B*T*F*K float64 operations at the
    card's FP64 peak."""
    return 1e3 * 4.0 * B * T * F * K / FP64_PEAK


def display_bound(B, T, F, words_per_row, image=True, lut=True):
    """Bytes: the PSD and per-clip scalars read (and the LUT for RGBA
    words), the words written, and the image when it is stored; a handful
    of operations per pixel."""
    bytes_ = (B * T * F * 4 + B * 3 * 4 + (256 * 4 if lut else 0)
              + (B * F * T * 4 if image else 0) + B * F * words_per_row * 4)
    return 1e3 * bytes_ / HBM_RATE, "bytes"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def toolchain():
    import torch
    phase("toolchain")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this run needs a CUDA card")
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import spectral_tpu_torch
    pkg = os.path.dirname(os.path.abspath(spectral_tpu_torch.__file__))
    require(pkg == os.path.join(HERE, "spectral_tpu_torch"),
            f"spectral_tpu_torch imported from {pkg}, not this checkout")
    from spectral_tpu_torch.ops.build import find_nvcc
    nvcc = find_nvcc()
    require(nvcc is not None, "nvcc not found")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(run_text([nvcc, "--version"]).splitlines()[-1])
    card = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]).splitlines()[0]
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(run_text(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"]).splitlines()[0])
    dfma = sms * 64 * 2 * mhz * 1e6
    print(f"{sms} SMs, max SM clock {mhz:g} MHz: DFMA outside the tensor "
          f"cores {dfma / 1e12:.2f} TFLOP/s (64 per clock per SM), the most "
          f"the STFT kernel's design can reach and the HMM kernels' bound; "
          f"the other bounds use the FP64 peak on the tensor cores, "
          f"{FP64_PEAK / 1e12:g} TFLOP/s, and HBM {HBM_RATE / 1e12:g} TB/s "
          f"(data sheet)")
    try:
        import PIL
        print(f"PIL {PIL.__version__}: PNGs encode through PIL")
    except ImportError:
        print("no PIL: PNGs encode through the stdlib zlib path")
    return card, dfma


def build_kernels():
    from concurrent.futures import ThreadPoolExecutor
    from spectral_tpu_torch.ops import build
    phase("build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        info, tail, mel, hmm_lib = pool.map(
            build.build_library, ("stft_psd", "display", "mel", "hmm"))
    print(f"the four sources built side by side in "
          f"{time.perf_counter() - t0:.2f} s")
    print(f"hmm.cu -> {os.path.relpath(hmm_lib['path'], HERE)} in "
          f"{hmm_lib['seconds']:.2f} s; ptxas: "
          + "; ".join(hmm_ptxas(hmm_lib["log"])))
    build.load_library("hmm")
    print(f"mel.cu -> {os.path.relpath(mel['path'], HERE)} in "
          f"{mel['seconds']:.2f} s; ptxas: " + "; ".join(radix2_ptxas(
              mel["log"], r"(mel_project_kernel)", lambda e: "mel_project")))
    build.load_library("mel")
    print(f"display.cu -> {os.path.relpath(tail['path'], HERE)} in "
          f"{tail['seconds']:.2f} s; ptxas: " + "; ".join(radix2_ptxas(
              tail["log"], r"(clip_stats_kernel|display_map_kernelILi(\d)"
              r"ELb(\d)E)",
              lambda e: "clip_stats" if e.group(2) is None else
              f"display_map<MODE {e.group(2)}, LOG {e.group(3)}>")))
    build.load_library("display")
    print(f"stft_psd.cu -> {os.path.relpath(info['path'], HERE)} in "
          f"{info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if ("registers" in line or "spill" in line or "error" in line
                or "Compiling entry" in line):
            print("  " + line.strip())
    print("radix-2 kernel (stft_fft_psd_kernel<LOG2M, LR>), ptxas: "
          + "; ".join(radix2_ptxas(info["log"])))
    print("mixed-radix kernel (stft_mixed_fft_psd_kernel<RMAX>), ptxas: "
          + "; ".join(mixed_ptxas(info["log"])))
    print("odd kernel (stft_odd_fft_psd_kernel<RADER, RMAX, PACKED>; "
          "PACKED the mixed route's Rader plans), ptxas: "
          + "; ".join(radix2_ptxas(
              info["log"],
              r"stft_odd_fft_psd_kernelILb(\d)ELi(\d+)ELb(\d)E",
              lambda e: f"RADER {e.group(1)}, RMAX {e.group(2)}, PACKED "
                        f"{e.group(3)}")))
    print("GEMM kernel (stft_psd_kernel, 128 x 64 tile; "
          "stft_psd_small_kernel, nperseg 2-31), ptxas: "
          + "; ".join(radix2_ptxas(
              info["log"], r"stft_psd_(small_kernelILi(\d)E|kernelE)",
              lambda e: f"small-K tile<NB {e.group(2)}>" if e.group(2)
              else "large tile")))
    print("Bluestein kernel (stft_bluestein_psd_kernel<RANKS, TWO>), ptxas: "
          + "; ".join(radix2_ptxas(
              info["log"], r"stft_bluestein_psd_kernelILi(\d)ELb(\d)E",
              lambda e: f"RANKS {e.group(1)}, TWO {e.group(2)}")))
    build.load_library("stft_psd")


def mixed_ptxas(log):
    """The registers and spills of each instantiation of the mixed-radix
    kernel, as "RMAX m: r registers, s bytes spilled"."""
    return radix2_ptxas(log, r"stft_mixed_fft_psd_kernelILi(\d+)E",
                        lambda e: f"RMAX {e.group(1)}")


def radix2_ptxas(log, pattern=r"stft_fft_psd_kernelILi(\d+)ELi(\d+)E",
                 label=lambda e: f"LOG2M {e.group(1)}, "
                 f"{2 ** int(e.group(2))} values"):
    """The registers and spills of each radix-2 instantiation (or of the
    entries ``pattern`` matches) in nvcc's -Xptxas -v log, as "LOG2M m, v
    values: r registers, s bytes spilled"."""
    import re
    rows, m = [], None
    for line in log.splitlines():
        entry = re.search(pattern, line)
        if "Compiling entry" in line:
            m = label(entry) if entry else None
            spill = "?"
        elif m is not None and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif m is not None and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            rows.append(f"{m}: {regs} registers, {spill} bytes spilled")
            m = None
    return rows or [f"no entry {pattern} in the build log"]


# a fresh process's first launch of the mixed-radix, Rader and odd kernels
# at buffers just under 48 KB, each against its plain version
SMEM_EDGE_SCRIPT = """
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from spectral_tpu_torch import SpecConfig
from spectral_tpu_torch.ops import stft_cuda
for k, route in ((96, "mixed"), (5594, "mixed"), (3001, "odd")):
    cfg = SpecConfig.scipy_default(k)
    assert stft_cuda.route(cfg) == route
    x = torch.from_numpy(np.random.RandomState(k).randn(2, 8 * k).astype(
        np.float32)).cuda()
    got = stft_cuda.stft_psd(x, 16000.0, cfg)
    want = stft_cuda.stft_psd_reference(
        x, stft_cuda.dft_constants(cfg, 16000.0, x.device), cfg)
    rel = float((got - want).abs().amax() / want.abs().amax())
    assert rel <= 5e-6, (k, rel)
    print(f"first launch at nperseg {k} [{route}] in a fresh process: "
          f"{rel:.2e} of the max")
"""


def kernel_cases(dev):
    import dataclasses
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.ops import stft_cuda
    from torch_precision import trend

    phase("kernels against their plain versions")
    rs = np.random.RandomState(1)
    n = int(FS * CLIP_SECONDS)
    north = SpecConfig.north_star(1024, 256, log_scale=True)
    scipy_cfg = SpecConfig.scipy_default(1024, log_scale=True)
    s992 = SpecConfig.scipy_default(992)         # the mixed route's, M 16 31
    s2048 = SpecConfig.scipy_default(2048)
    linear = SpecConfig(nperseg=960, hop=240, detrend="linear")  # mixed
    north_linear = dataclasses.replace(north, detrend="linear")   # radix 2

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def both(x, cfg, route=None, **kw):
        """The kernel (the route's, checked by its launch count) and the
        plain version on the same input."""
        want_route = route or stft_cuda.route(cfg)
        before = dict(stft_cuda.launches)
        got = stft_cuda.stft_psd(x, FS, cfg, _route=route, **kw)
        torch.cuda.synchronize()
        after = dict(stft_cuda.launches)
        require(after[want_route] == before[want_route] + 1
                and sum(after.values()) == sum(before.values()) + 1,
                f"nperseg {cfg.nperseg}: one launch of the {want_route} "
                f"kernel, counts {before} -> {after}")
        want = stft_cuda.stft_psd_reference(
            x, stft_cuda.dft_constants(cfg, FS, dev), cfg, **kw)
        torch.cuda.synchronize()
        return got, want, want_route

    def check_stats(got, want, route, what):
        psd_rel, _ = psd_err(got[0], want[0])
        scale = torch.amax(want[0], dim=(1, 2))
        lo = float(torch.amax(torch.abs(got[1] - want[1]) / scale))
        hi = float(torch.amax(torch.abs(got[2] - want[2]) / scale))
        require(psd_rel <= PSD_TOL and lo <= PSD_TOL and hi <= PSD_TOL,
                f"{what} [{route}]: psd {psd_rel:.2e}, pmin {lo:.2e}, pmax "
                f"{hi:.2e} (relative to clip max)")
        print(f"{what} [{route}]: psd {psd_rel:.2e}, pmin {lo:.2e}, pmax "
              f"{hi:.2e}; largest float32 ulp distance "
              f"{ulp_distance(got[0], want[0])}")

    def check_log(x, cfg, what, route=None):
        got, want, used = both(x, cfg, route, log10_out=True)
        lin_rel, _ = psd_err(10.0 ** got.double(), 10.0 ** want.double())
        require(lin_rel <= PSD_TOL, f"{what} [{used}]: {lin_rel:.2e}")
        print(f"{what} [{used}] (compared in linear units): {lin_rel:.2e}; "
              f"largest float32 ulp distance {ulp_distance(got, want)}")

    x8 = on_card(rs.randn(8, n))
    t0 = time.perf_counter()
    got, want, route = both(x8, north, with_stats=True)
    print(f"first stft_psd launch (module load) {time.perf_counter() - t0:.2f}"
          " s")
    check_stats(got, want, route, "8 x 10 s, north_star 1024/256, with_stats")

    xs = on_card(rs.randn(4, n) + 3.0)           # DC offset: detrend works
    check_stats(*both(xs, scipy_cfg, with_stats=True),
                "scipy_default 1024 (hop 896, Tukey, constant detrend), "
                "noise + 3")
    for route in (None, "gemm"):
        check_stats(*both(xs, s992, route, with_stats=True),
                    "scipy_default 992 (hop 868), noise + 3")
        check_stats(*both(x8[:4], SpecConfig.north_star(960, 240), route,
                          with_stats=True), "north_star 960/240")
    check_stats(*both(xs, linear, with_stats=True),
                "nperseg 960, hop 240, linear detrend, noise + 3")
    for route in (None, "gemm"):
        check_log(x8[:2], north, "log10_out", route)
    check_log(xs[:2], s992, "scipy_default 992 log10_out")

    xr = on_card(rs.randn(3, 40000))             # T = 153: ragged frame tile
    for cfg, route in ((north, None), (north, "gemm"),
                       (SpecConfig.north_star(992, 256), None)):
        check_stats(*both(xr, cfg, route, with_stats=True),
                    f"nperseg {cfg.nperseg}, ragged T = 153")
    # the FFT kernel's smallest sizes: 32 threads, idle lanes in the
    # butterflies at nperseg 32
    for cfg in (SpecConfig.north_star(32, 8), SpecConfig.scipy_default(64),
                SpecConfig.north_star(128, 32),
                SpecConfig.north_star(256, 64),
                SpecConfig.north_star(512, 128)):
        check_stats(*both(xr, cfg, with_stats=True),
                    f"nperseg {cfg.nperseg}, hop {cfg.hop_}, detrend "
                    f"{cfg.detrend}")
    # nperseg 100: K not a multiple of the GEMM kernel's 16-sample stage;
    # M = 50 = 2 5^2 on the mixed route, a repeated radix and one radix-2
    # stage
    for route in (None, "gemm"):
        check_stats(*both(xr, SpecConfig.scipy_default(100), route,
                          with_stats=True), "scipy_default 100 (hop 88)")
    # the mixed-radix kernel at each radix it has (hand-written 3, 5, 7;
    # the generic stage from 11 to 251, and twice where M has two primes
    # past 7, so a generic stage runs at span L > 1), noise + 3 under
    # constant detrend; from 6176 its buffer passes 48 KB
    for what, cfg in (
            ("north_star 96/24, M = 2^4 3", SpecConfig.north_star(96, 24)),
            ("scipy_default 160, M = 2^4 5", SpecConfig.scipy_default(160)),
            ("scipy_default 224, M = 2^4 7", SpecConfig.scipy_default(224)),
            ("scipy_default 352, M = 2^4 11", SpecConfig.scipy_default(352)),
            # off the GUI's grid: p = 193 needs 97 threads, K/4 gives 96
            ("scipy_default 386, M = 193", SpecConfig.scipy_default(386)),
            ("scipy_default 4576, M = 2^4 13 11",
             SpecConfig.scipy_default(4576)),
            ("scipy_default 7904, M = 2^4 19 13",
             SpecConfig.scipy_default(7904)),
            ("scipy_default 7968, M = 2^4 83 3",
             SpecConfig.scipy_default(7968)),
            ("scipy_default 8032, M = 2^4 251",
             SpecConfig.scipy_default(PRIME_NPERSEG)),
            ("scipy_default 8160, M = 2^4 17 5 3",
             SpecConfig.scipy_default(MIXED_NPERSEG)),
            # the passes' own edges: radix-2 passes of 4, 8 and 16 values
            # (2 at 100 above), merged as 8 + 4 and 16 + 8 + 8; a block of
            # 512 threads (radix 131); a generic pass at span 41 past the
            # compile-time primes (and 11 at span 13 at 4576 above)
            ("scipy_default 120, M = 2^2 5 3", SpecConfig.scipy_default(120)),
            ("scipy_default 240, M = 2^3 5 3", SpecConfig.scipy_default(240)),
            ("scipy_default 192, M = 2^5 3", SpecConfig.scipy_default(192)),
            ("scipy_default 6144, M = 2^10 3",
             SpecConfig.scipy_default(6144)),
            ("scipy_default 4192, M = 2^4 131",
             SpecConfig.scipy_default(4192)),
            ("scipy_default 6068, M = 2 41 37",
             SpecConfig.scipy_default(6068))):
        x = on_card(rs.randn(3, 8 * cfg.nperseg) + 3.0)
        check_stats(*both(x, cfg, with_stats=True), what)
    # each kernel's first launch at a buffer just under 48 KB beside its
    # static arrays (the shared-memory opt-in must cover both), in a fresh
    # process: nperseg 96 (64 frames of 48 values: 48 KB), 5594 (a Rader
    # stage, 43.7 KB) and 3001 (the odd kernel, 46.9 KB)
    edge = subprocess.run(
        [sys.executable, "-c", SMEM_EDGE_SCRIPT, HERE], capture_output=True,
        text=True)
    require(edge.returncode == 0, f"first launches at the 48 KB edge:\n"
            f"{edge.stdout}{edge.stderr}")
    print(edge.stdout.strip())
    # several frames a block, a ragged last block (T = 29 and 25: 87 and 75
    # rows against 64 and 32 frames a block) under every detrend
    for k in (96, 160, 224):
        for detrend in ("none", "constant", "linear"):
            cfg = SpecConfig(nperseg=k, hop=k // 4, detrend=detrend)
            x = rs.randn(3, 8 * k) + 3.0
            if detrend == "linear":
                x = x + trend(8 * k)
            check_stats(*both(on_card(x), cfg, with_stats=True),
                        f"nperseg {k}, hop {k // 4}, {detrend}, frames "
                        "several a block")
    # |X|^2 past float32's range: inf, as the float32 pipeline overflows
    xo = on_card(np.stack([rs.randn(20000), 1e19 * rs.randn(20000)]))
    for cfg, route in ((north, None), (north, "gemm"), (s992, None)):
        used = route or stft_cuda.route(cfg)
        p_o, lo_o, hi_o = stft_cuda.stft_psd(xo, FS, cfg, with_stats=True,
                                             _route=route)
        require(bool(torch.isfinite(hi_o[0])) and bool(torch.isinf(hi_o[1]))
                and card_flags(xo, lo_o, hi_o) == [True, False],
                f"overflow guard [{used}]: pmax {hi_o.tolist()}")
        print(f"1e19-amplitude clip, nperseg {cfg.nperseg} [{used}]: pmax "
              "inf, finite [True, False]")

    # nperseg 2048-8192: K1's frequency-tiled sizes and K2's range (for the
    # GEMM kernel, the clips' frames share row tiles across clip
    # boundaries); the FFT kernel's buffer passes 48 KB of shared memory
    # from 4096 on
    for what, cfg, offset in (
            ("north_star 2048/512", SpecConfig.north_star(2048, 512), 0.0),
            ("scipy_default 4096, noise + 3", SpecConfig.scipy_default(4096),
             3.0),
            ("scipy_default 8192 (hop 7168), noise + 3",
             SpecConfig.scipy_default(8192), 3.0),
            ("north_star 8192/2048", SpecConfig.north_star(8192, 2048), 0.0)):
        x = on_card(rs.randn(3, 8 * cfg.nperseg) + offset)
        check_stats(*both(x, cfg, with_stats=True), what)
    x = on_card(rs.randn(3, 8 * MIXED_NPERSEG) + 3.0)
    check_stats(*both(x, SpecConfig.scipy_default(MIXED_NPERSEG), "gemm",
                      with_stats=True),
                f"scipy_default {MIXED_NPERSEG}, noise + 3")
    xr2 = on_card(rs.randn(5, 40000) + 1.0)      # T = 22, 110 rows, 5 clips
    check_stats(*both(xr2, s2048, with_stats=True),
                "scipy_default 2048, ragged T = 22")
    check_log(on_card(rs.randn(2, 8 * 4096) + 3.0),
              SpecConfig.scipy_default(4096), "scipy_default 4096 log10_out")

    # linear detrend on both FFT kernels, on ramp clips (noise plus a trend
    # rising from 3 to 43 over the clip), each against the GEMM kernel
    # forced too: the radix-2 kernel at its smallest block, the headline
    # and 8192; the mixed kernel at 960, a generic stage wider than K/4
    # threads (386), the largest prime (8032) and path 6's 8160
    for what, cfg in (
            ("north_star 1024/256", SpecConfig.north_star(1024, 256)),
            ("nperseg 32, hop 8", SpecConfig(nperseg=32, hop=8)),
            ("scipy_default 8192", SpecConfig.scipy_default(8192)),
            ("north_star 960/240", SpecConfig.north_star(960, 240)),
            ("scipy_default 386", SpecConfig.scipy_default(386)),
            ("scipy_default 8032", SpecConfig.scipy_default(PRIME_NPERSEG)),
            ("scipy_default 8160", SpecConfig.scipy_default(MIXED_NPERSEG))):
        cfg = dataclasses.replace(cfg, detrend="linear")
        x = on_card(rs.randn(3, 8 * cfg.nperseg) + trend(8 * cfg.nperseg))
        for route in (None, "gemm"):
            check_stats(*both(x, cfg, route, with_stats=True),
                        f"{what}, linear detrend, ramp")
    xrl = on_card(rs.randn(3, 40000) + trend(40000))    # T = 153
    for cfg in (north_linear, SpecConfig(nperseg=992, hop=256,
                                         detrend="linear")):
        for route in (None, "gemm"):
            check_stats(*both(xrl, cfg, route, with_stats=True),
                        f"nperseg {cfg.nperseg}, linear detrend, ramp, "
                        "ragged T")

    for cfg in (north, SpecConfig.scipy_default(8192), s992, linear):
        before = read_counts()["stft_psd"]
        psd0, lo0, hi0 = stft_cuda.stft_psd(on_card(rs.randn(2, 500)), FS,
                                            cfg, with_stats=True)
        require(tuple(psd0.shape) == (2, 0, cfg.n_freqs)
                and read_counts()["stft_psd"] == before
                and float(lo0.abs().sum() + hi0.abs().sum()) == 0.0,
                "T = 0 gives empty PSD and zero extrema without a launch")
        print(f"nperseg {cfg.nperseg}, T = 0: empty PSD, zero extrema, "
              "no launch")

    for cfg, route in ((north, None), (s2048, None), (s992, None),
                       (s992, "gemm"), (north_linear, None),
                       (north_linear, "gemm"), (linear, None),
                       (linear, "gemm")):
        xn = rs.randn(3, 20000)
        xn[1, 5000] = np.nan
        xn = on_card(xn)
        psd_n, lo_n, hi_n = stft_cuda.stft_psd(xn, FS, cfg, with_stats=True,
                                               _route=route)
        flags = card_flags(xn, lo_n, hi_n)
        require(bool(torch.isnan(lo_n[1])) and bool(torch.isnan(hi_n[1]))
                and bool(torch.isfinite(lo_n[0]))
                and bool(torch.isfinite(lo_n[2]))
                and flags == [True, False, True],
                f"NaN sample: pmin {lo_n.tolist()}, pmax {hi_n.tolist()}, "
                f"finite {flags}")
        _, want_lo, want_hi = stft_cuda.stft_psd_reference(
            xn, stft_cuda.dft_constants(cfg, FS, dev), cfg, with_stats=True)
        require(torch.equal(torch.isnan(lo_n), torch.isnan(want_lo))
                and torch.equal(torch.isnan(hi_n), torch.isnan(want_hi)),
                "NaN extrema agree with the plain version")
        print(f"nperseg {cfg.nperseg} [{route or stft_cuda.route(cfg)}], NaN "
              "sample: pmin and pmax NaN as in the plain version, finite "
              "[True, False, True]")


def bitwise(a, b):
    """Equal bit patterns, NaN in the same places (any payload)."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    ia = torch.where(na, 0, a.contiguous().view(torch.int32))
    ib = torch.where(nb, 0, b.contiguous().view(torch.int32))
    return bool(torch.equal(na, nb) and torch.equal(ia, ib))


def image_err(got, want, what):
    """Largest |Δ| of two images, NaN required in the same places; the
    share of bitwise-equal pixels."""
    import torch
    nan = torch.isnan(want)
    require(torch.equal(torch.isnan(got), nan), f"{what}: NaN pixels differ")
    err = float(torch.where(nan, 0.0, (got - want).abs()).amax()) \
        if want.numel() else 0.0
    require(err <= IMAGE_TOL, f"{what}: image {err:.2e}")
    same = float((got.view(torch.int32) == want.view(torch.int32)).float()
                 .mean()) if want.numel() else 1.0
    return err, same


def tail_cases(dev):
    """The display tail's two kernels against their plain versions:
    clip_stats on the flag's cases (noise, NaN, inf, 1e-25, silence, pure
    DC, 1e19) at odd n, under constant detrend, with share_max, on the
    forced GEMM tile's partials of nine frequency tiles, at T = 0, at n
    from 1 to 960,000 and past 65,535 clips; the display map on a real
    PSD in every mode and on synthetic PSDs at odd T and F, T < 4, T = 0
    and past 65,535 clips. Returns the largest differences seen."""
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.ops import display_cuda as disp
    from spectral_tpu_torch.ops import stft_cuda
    from spectral_tpu_torch.ops.colormap import unpack_indices

    phase("the display tail (clip_stats, display map) against the plain "
          "versions")
    rs = np.random.RandomState(12)
    worst = {"stats": 0.0, "image": 0.0}

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def stats_case(x, parts, what, share_max=False, want_flags=None):
        before = read_counts()["display"]["clip_stats"]
        got = disp.clip_stats(x, parts, share_max)
        torch.cuda.synchronize()
        launched = read_counts()["display"]["clip_stats"] - before
        want = disp.clip_stats_reference(x, parts, share_max)
        amin = (torch.amin(parts[0], dim=(0, 2)) if parts.numel()
                else torch.zeros_like(got.pmin))
        amax = (torch.amax(parts[1], dim=(0, 2)) if parts.numel()
                else torch.zeros_like(got.pmax))
        require(launched == (1 if x.shape[0] else 0)
                and bitwise(got.pmin, amin) and bitwise(got.pmax, amax)
                and bitwise(got.params, want.params)
                and torch.equal(got.finite, want.finite),
                f"clip_stats {what}: pmin/pmax bitwise torch.amin/amax "
                f"{bitwise(got.pmin, amin)}/{bitwise(got.pmax, amax)}, "
                f"params {bitwise(got.params, want.params)}, flags "
                f"{got.finite.tolist()[:12]} against "
                f"{want.finite.tolist()[:12]}, launches {launched}")
        if want_flags is not None:
            require(got.finite.tolist() == want_flags,
                    f"clip_stats {what}: flags {got.finite.tolist()}, "
                    f"expected {want_flags}")
        print(f"clip_stats {what}: pmin, pmax bitwise torch.amin/amax of "
              f"the partials, params bitwise, flags "
              f"{got.finite.tolist() if x.shape[0] <= 12 else 'equal'}")
        return got

    n = 40001                                   # odd: rows not aligned
    clips = [rs.randn(n), rs.randn(n), rs.randn(n), 1e-25 * rs.randn(n),
             np.zeros(n), np.full(n, 0.25), np.full(n, 1e-4),
             np.full(n, 3e-3), np.full(n, 0.1), 1e19 * rs.randn(n)]
    clips[1][n // 3] = np.nan
    clips[2][n // 2] = np.inf
    flags = [True, False, False, False, True, True, True, True, True, False]
    xf = on_card(np.stack(clips))
    for cfg in (SpecConfig.north_star(1024, 256, log_scale=True),
                SpecConfig.scipy_default(1024, log_scale=True),
                SpecConfig.scipy_default(MIXED_NPERSEG, log_scale=True)):
        psd, parts = stft_cuda.stft_psd_partials(xf, FS, cfg)
        what = (f"nperseg {cfg.nperseg} detrend {cfg.detrend}, noise, NaN, "
                "inf, 1e-25, silent, DC 0.25 1e-4 3e-3 0.1, 1e19, n 40001")
        stats_case(xf, parts, what, want_flags=flags)
        stats_case(xf, parts, what + ", share_max", share_max=True)
        stats_case(xf[[0, 4, 5]].contiguous(),
                   parts[:, :, [0, 4, 5]].contiguous(),
                   f"nperseg {cfg.nperseg}, share_max without NaN",
                   share_max=True)
    xg = on_card(rs.randn(3, 20000) + 3.0)
    _, parts = stft_cuda._stft_psd_cuda(xg, FS, SpecConfig.north_star(1024,
                                                                      256),
                                        False, True, "gemm", partials=True)
    require(parts.shape[1] > 1, f"GEMM partials {tuple(parts.shape)}")
    stats_case(xg, parts, f"forced GEMM tile, {parts.shape[1]} frequency "
               "tiles of partials")
    stats_case(on_card(rs.randn(3, 500)), torch.zeros((2, 1, 3, 0),
                                                      device=dev),
               "T = 0 (no partial rows)")
    for n in (1, 3, 5, 16383, 16384, 16385, 960000):
        x = on_card(rs.randn(4, n) * 1e-3 + 0.5)
        parts = on_card(rs.rand(2, 1, 4, 7))
        stats_case(x, parts, f"n {n}")
    big = 70000                                 # past grid axis y's 65,535
    xb = on_card(rs.randn(big, 37))
    psd_b, parts_b = stft_cuda.stft_psd_partials(
        xb, FS, SpecConfig.north_star(32, 8, log_scale=True))
    stats_b = stats_case(xb, parts_b, f"{big} clips of 37 samples")

    def map_case(psd, params, what, **kw):
        before = read_counts()["display"]
        img_k, w_k = disp.display_map(psd, params, **kw)
        torch.cuda.synchronize()
        after = read_counts()["display"]
        key = "palette" if kw.get("palette") else "rgba"
        writes = kw.get("with_image", True) or kw.get("palette") or \
            kw.get("colormap", "jet")
        require(after[key] - before[key] == (
                    1 if psd.numel() and writes else 0),
                f"display map {what}: launches {before} -> {after}")
        img_p, w_p = disp.display_map_reference(psd, params, **kw)
        torch.cuda.synchronize()
        err, same_px = 0.0, 1.0
        if img_p is not None:
            err, same_px = image_err(img_k, img_p, f"display map {what}")
            worst["image"] = max(worst["image"], err)
        else:
            require(img_k is None, f"{what}: no image asked, one returned")
        same = 1.0
        if w_p is None:
            require(w_k is None, f"{what}: no words asked, some returned")
        elif not psd.numel():
            require(w_k.shape == w_p.shape, f"{what}: word shapes")
        elif kw.get("palette"):
            T = psd.shape[1]
            require(w_k.shape == w_p.shape, f"{what}: word shapes")
            same = check_indices(unpack_indices(w_k, T),
                                 unpack_indices(w_p, T), what)
            pad = w_k.cpu().view(torch.int32).numpy().view(np.uint8)
            require(not pad.reshape(w_k.shape[0], w_k.shape[1], -1)[
                ..., T:].any(), f"{what}: pad bytes past T are zero")
        else:
            same = check_words(w_k, w_p, what)
        print(f"display map {what}: image {err:.2e} ({same_px:.6f} of the "
              f"pixels bitwise), words identical {same:.6f}")

    x8 = on_card(rs.randn(8, int(FS * CLIP_SECONDS)))
    north = SpecConfig.north_star(1024, 256, log_scale=True)
    psd8, parts8 = stft_cuda.stft_psd_partials(x8, FS, north)
    for share in (False, True):
        params = disp.clip_stats(x8, parts8, share).params
        for log_scale, flip in ((True, True), (True, False), (False, True)):
            for palette in (False, True):
                for with_image in (True, False):
                    map_case(psd8, params,
                             f"8 x 10 s log={log_scale} flip={flip} "
                             f"share_max={share} "
                             f"{'palette' if palette else 'rgba'} "
                             f"image={with_image}",
                             log_scale=log_scale, flip_image=flip,
                             palette=palette, with_image=with_image)
    map_case(psd8, params, "8 x 10 s colormap=None", log_scale=True,
             colormap=None)
    for B, T, F in ((3, 261, 45), (2, 3, 33), (2, 1, 1), (2, 130, 4097),
                    (4, 622, 513), (2, 0, 513)):
        psd = 10.0 ** rs.uniform(-9, -1, (B, T, F))
        if T:
            psd[0, T // 2, F // 2] = np.nan
            psd[1] = 2.5e-4                     # one value: rng 0
        psd = on_card(psd)
        if T:
            lo = torch.where(psd.isnan(), torch.inf, psd).amin(dim=(1, 2))
            hi = torch.where(psd.isnan(), -torch.inf, psd).amax(dim=(1, 2))
        else:
            lo = hi = torch.zeros(B, device=dev)
        params = disp.clip_params(lo, hi)
        for log_scale in (True, False):
            for palette in (False, True):
                map_case(psd, params, f"B {B} T {T} F {F} log={log_scale} "
                         f"{'palette' if palette else 'rgba'}",
                         log_scale=log_scale, flip_image=True,
                         palette=palette)
    for palette in (False, True):
        map_case(psd_b, stats_b.params, f"{big} clips, T 1, F 17, "
                 f"{'palette' if palette else 'rgba'}", log_scale=True,
                 palette=palette)
    return worst


def dc_check(dev):
    """Pure-DC clips under constant detrend stay healthy: 10 s of 1e-4,
    3e-3 and 0.1 through batched_spectrogram_fn at scipy_default 1024 and
    8160 (the float64 STFT kernels detrend them to exactly 0)."""
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.parallel.sharding import batched_spectrogram_fn
    phase("pure DC clips (1e-4, 3e-3, 0.1; 10 s) under constant detrend")
    n = int(FS * CLIP_SECONDS)
    x = torch.stack([torch.full((n,), v, device=dev)
                     for v in (1e-4, 3e-3, 0.1)])
    for k in (1024, MIXED_NPERSEG):
        out = batched_spectrogram_fn(FS, SpecConfig.scipy_default(
            k, log_scale=True))(x)
        flags = out["finite"].tolist()
        print(f"scipy_default {k}: PSD max {out['psd'].amax(dim=(1, 2)).tolist()}"
              f", finite {flags}")
        require(flags == [True, True, True],
                f"pure DC at scipy_default {k}: finite {flags}")


def odd_kernel_cases(dev, cases=ODD_CASES, edges=(1023, 8191),
                     title="the odd route and the Rader stage", seed=7,
                     forced=((1023, "gemm"),), hop_of=lambda k: k // 4,
                     wide=False):
    """The odd route (two frames of a clip a transform) and its Rader stage,
    or with ``cases=MIXED_RADER_CASES`` the mixed route's Rader plans (the
    odd kernel's PACKED form), or with ``cases=BLUESTEIN_CASES`` the
    Bluestein route, against the plain
    version: every detrend on clips with an odd T (a lone last frame),
    the pairing's guard on an all-zero, a NaN and a 1e-6 frame beside
    loud ones, overflow, log10_out and T = 0 at ``edges``, and ``forced``
    (nperseg, route) pairs, and one clip of one frame (B T = 1). Every bin
    finite in both is held to 1 float32 ulp of the plain version, and NaN
    and inf bins to the same places. With ``cases=R2_CASES`` the radix-2
    route: 27 and 14 rows are no multiple of its frames a block (128 to 8
    at nperseg 32-512, where the NaN frame shares a block with finite
    ones; one frame a block from 1024). With ``cases=GEMM_CASES`` (hops
    ``hop_of``, at least 1) the GEMM route's small-K tile, and with
    ``wide`` a hop past nperseg and 5 clips of 300 frames each (blocks of
    256 or 512 rows that cross clips' edges)."""
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.ops import stft_cuda
    from torch_precision import trend

    phase(f"{title} against the plain version")
    rs = np.random.RandomState(seed)
    worst = {}

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def compare(x, cfg, what, route=None):
        used = route or stft_cuda.route(cfg)
        before = dict(stft_cuda.launches)
        got = stft_cuda.stft_psd(x, FS, cfg, with_stats=True, _route=route)
        torch.cuda.synchronize()
        after = dict(stft_cuda.launches)
        require(after[used] == before[used] + 1
                and sum(after.values()) == sum(before.values()) + 1,
                f"{what}: one launch of the {used} kernel, counts {before} "
                f"-> {after}")
        want = stft_cuda.stft_psd_reference(
            x, stft_cuda.dft_constants(cfg, FS, dev), cfg, with_stats=True)
        for g, w in zip(got, want):
            require(torch.equal(torch.isnan(g), torch.isnan(w))
                    and torch.equal(torch.isinf(g), torch.isinf(w)),
                    f"{what} [{used}]: NaN or inf in other places")
        ok = torch.isfinite(want[0])
        diff = torch.where(ok, (got[0] - want[0]).abs(), 0.0)
        scale = torch.where(ok, want[0].abs(), 0.0).amax(dim=(1, 2))
        rel = float((diff.amax(dim=(1, 2)) / scale.clamp_min(1e-30)).amax())
        ulps = [ulp_distance(g, w) for g, w in zip(got, want)]
        worst[what + f" [{used}]"] = max(ulps)
        print(f"{what} [{used}]: psd {rel:.2e} of the clip max; float32 ulp "
              f"distance psd {ulps[0]}, pmin {ulps[1]}, pmax {ulps[2]}")
        return got, want

    for k in cases:
        hop = hop_of(k)
        n = k + 8 * hop                          # T = 9
        noise = rs.randn(3, n)
        for detrend, x in (("none", noise), ("constant", noise + 3.0),
                           ("linear", noise + trend(n))):
            cfg = (SpecConfig.north_star(k, hop) if detrend == "none" else
                   SpecConfig(nperseg=k, hop=hop, detrend=detrend))
            compare(on_card(x), cfg, f"nperseg {k}, {detrend}, T = 9")
        # frames apart (hop = nperseg), T = 7: clip 0's frame 1 all zero
        # beside loud frame 0, its frame 4 at 1e-6 beside frame 5; clip 1
        # a NaN in frame 3 beside frame 2; frame 6 alone
        cfg = SpecConfig(nperseg=k, hop=k, window="hann", detrend="constant")
        xc = rs.randn(2, 7 * k) + 3.0
        xc[0, k:2 * k] = 0.0
        xc[0, 4 * k:5 * k] = 1e-6 * rs.randn(k)
        xc[1, 3 * k + k // 2] = np.nan
        got, _ = compare(on_card(xc), cfg,
                         f"nperseg {k}, zero, 1e-6 and NaN frames beside "
                         "loud ones")
        frames_ok = torch.isfinite(got[0][1]).all(dim=1).tolist()
        require(bool((got[0][0, 1] == 0).all()) and float(got[1][0]) == 0.0
                and bool(torch.isnan(got[1][1]))
                and frames_ok == [True, True, True, False, True, True, True],
                f"nperseg {k}: the zero frame's bins exactly 0 and the "
                f"clip's pmin 0, the NaN only in its own frame: {frames_ok}")
        if wide:
            cfg = SpecConfig(nperseg=k, hop=k + 3, detrend="linear")
            compare(on_card(rs.randn(3, k + 8 * (k + 3)) + trend(
                k + 8 * (k + 3))), cfg, f"nperseg {k}, hop {k + 3}, linear")
            cfg = SpecConfig.scipy_default(k)
            compare(on_card(rs.randn(5, k + 299 * cfg.hop_) + 3.0), cfg,
                    f"nperseg {k}, hop {cfg.hop_}, 5 clips x T = 300")
    for k, route in forced:
        compare(on_card(rs.randn(3, k + 8 * (k // 4)) + 3.0),
                SpecConfig(nperseg=k, hop=k // 4), f"nperseg {k}, constant",
                route=route)
    for k in edges:
        cfg = SpecConfig.north_star(k, hop_of(k))
        xo = on_card(np.stack([rs.randn(8 * k), 1e19 * rs.randn(8 * k)]))
        _, lo_o, hi_o = stft_cuda.stft_psd(xo, FS, cfg, with_stats=True)
        used = stft_cuda.route(cfg)
        require(bool(torch.isfinite(hi_o[0])) and bool(torch.isinf(hi_o[1]))
                and card_flags(xo, lo_o, hi_o) == [True, False],
                f"overflow guard [{used}], nperseg {k}: pmax {hi_o.tolist()}")
        print(f"1e19-amplitude clip, nperseg {k} [{used}]: pmax inf, finite "
              "[True, False]")
        xl = on_card(rs.randn(2, 8 * k) + 3.0)
        got = stft_cuda.stft_psd(xl, FS, cfg, log10_out=True)
        want = stft_cuda.stft_psd_reference(
            xl, stft_cuda.dft_constants(cfg, FS, dev), cfg, log10_out=True)
        lin_rel, _ = psd_err(10.0 ** got.double(), 10.0 ** want.double())
        require(lin_rel <= PSD_TOL, f"nperseg {k} log10_out: {lin_rel:.2e}")
        worst[f"nperseg {k} log10_out"] = ulp_distance(got, want)
        print(f"nperseg {k} log10_out [{used}] (compared in linear units): "
              f"{lin_rel:.2e}; float32 ulp distance "
              f"{ulp_distance(got, want)}")
        before = read_counts()["stft_psd"]
        psd0, lo0, hi0 = stft_cuda.stft_psd(
            on_card(rs.randn(2, min(500, k - 1))), FS, cfg, with_stats=True)
        require(tuple(psd0.shape) == (2, 0, cfg.n_freqs)
                and read_counts()["stft_psd"] == before
                and float(lo0.abs().sum() + hi0.abs().sum()) == 0.0,
                "T = 0 gives empty PSD and zero extrema without a launch")
        print(f"nperseg {k}, T = 0: empty PSD, zero extrema, no launch")
        compare(on_card(rs.randn(1, k) + 3.0), cfg, f"nperseg {k}, B T = 1")
    over = {k: v for k, v in worst.items() if v > 1}
    print(f"{title}: largest float32 ulp distance {max(worst.values())} over "
          f"{len(worst)} cases")
    require(not over, f"cases past 1 float32 ulp of the plain version: "
            f"{over}")


def scipy_checks(dev, card):
    """The display contract against scipy float64 on clips that break a
    float32 chain (tools/torch_precision.py): scipy_default 1024 on
    noise + 3, and north_star 1024/256 on the sweep's worst clips, all on
    the FFT route; then the kernels' times at scipy_default 1024 (FFT),
    992 (mixed radix), 2049 (Bluestein on one block) and 8186 (the
    mixed route's Rader plan, the odd kernel's PACKED form), each beside the
    GEMM kernel, on the display spine's batch."""
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.stft import num_frames
    from spectral_tpu_torch.ops import stft_cuda
    from spectral_tpu_torch.parallel.sharding import batched_spectrogram_fn
    phase("against scipy float64 (limit 1e-3 dB)")
    cfg = SpecConfig.scipy_default(1024, log_scale=True)
    n = int(FS * CLIP_SECONDS)
    x = (np.random.RandomState(3).randn(2, n) + 3.0).astype(np.float32)
    cases = [("scipy_default 1024, 10 s noise + 3", cfg, x[:1])]
    # the precision sweep's worst clips for one float32 chain: 4.87e-3 dB
    # (seed 7, noise) and 4.55e-3 dB (seed 44, noise + 3)
    north = SpecConfig.north_star(1024, 256, log_scale=True)
    for seed, offset in ((7, 0.0), (44, 3.0)):
        clip = (np.random.RandomState(seed).randn(8 * 1024)
                + offset).astype(np.float32)
        cases.append((f"north_star 1024/256, sweep seed {seed}"
                      + (" noise + 3" if offset else " noise"), north,
                      clip[None]))
    for what, c, xc in cases:
        before = read_counts()["stft_psd"]["fft"]
        out = batched_spectrogram_fn(FS, c, flip_image=True)(xc)
        require(read_counts()["stft_psd"]["fft"] == before + 1,
                f"{what}: one launch of the FFT kernel")
        err = db_error_vs_scipy(out["image"][0].flip(0).cpu().numpy(),
                                xc[0].astype(np.float64), c)
        require(err <= DB_TOL, f"{what}: {err:.3e} dB")
        print(f"{what} vs scipy float64: {err:.3e} dB (limit {DB_TOL:g})")

    gen = torch.Generator(device=dev).manual_seed(3)
    xb = torch.randn((BATCH, n), generator=gen, device=dev) + 3.0
    for c in (cfg, SpecConfig.scipy_default(992),
              SpecConfig.scipy_default(2049),
              SpecConfig.scipy_default(RADER_NPERSEG)):
        kernel = stft_cuda.route(c)
        consts = stft_cuda.dft_constants(c, FS, dev)
        k_ms = time_ms(lambda: stft_cuda.stft_psd(xb, FS, c, with_stats=True))
        g_ms = time_ms(lambda: stft_cuda.stft_psd(xb, FS, c, with_stats=True,
                                                  _route="gemm"))
        p_ms = time_ms(lambda: stft_cuda.stft_psd_reference(xb, consts, c,
                                                            with_stats=True))
        l_ms = time_ms(lambda: library_psd(xb, c))
        T = num_frames(n, c.nperseg, c.hop_)
        bound = stft_bound(BATCH, n, T, c.n_freqs, c.nperseg)
        print(f"STFT at scipy_default {c.nperseg}, {BATCH} x "
              f"{CLIP_SECONDS:g} s (CUDA events, median of {REPS}): "
              f"{kernel} kernel {k_ms[0]:.3f} ms, GEMM kernel {g_ms[0]:.3f} "
              f"ms, plain {p_ms[0]:.3f} ms, library {l_ms[0]:.3f} ms, bound "
              f"{bound[0]:.3f} ms ({bound[1]}) [{card}]")
    del xb
    torch.cuda.synchronize()


def profile_path(fn, x, card):
    """One call of the pipeline under torch.profiler: the device kernels
    by name, and the device's idle share over the call's window (host
    launch to the end of its last kernel) and over its kernels' span."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    phase(f"path 1 under torch.profiler ({card})")
    fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("pipeline_call"):
            out = fn(x)
            torch.cuda.synchronize()
    del out
    events = prof.events()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name != "pipeline_call"]
    if not device:
        print("torch.profiler shows no device time on this machine; the "
              "kernels' times come from CUDA events")
        return
    calls = [e for e in events if e.name == "pipeline_call"
             and e.device_type == torch.autograd.DeviceType.CPU]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    first, last = spans[0][0], max(b for _, b in spans)
    window_start = calls[0].time_range.start if calls else first
    for e in device:
        print(f"  device: {e.name[:100]} "
              f"{e.time_range.end - e.time_range.start:.1f} us")
    kernels = [e.name for e in device if "emset" not in e.name]
    print(f"device kernels in one call: {len(kernels)}; busy {busy:.1f} us "
          f"of the call's window {last - window_start:.1f} us (idle share "
          f"{1 - busy / (last - window_start):.4f}) and of the kernels' span "
          f"{last - first:.1f} us (idle share "
          f"{1 - busy / (last - first):.4f}) [{card}]")
    want = ("stft_fft_psd_kernel", "clip_stats_kernel", "display_map_kernel")
    require(len(kernels) == 3 and all(
        any(w in k for k in kernels) for w in want),
        f"path 1's call ran other device kernels than the three: {kernels}")


def main_path(dev, card):
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.stft import num_frames
    from spectral_tpu_torch.ops import display_cuda as disp
    from spectral_tpu_torch.ops import stft_cuda
    from spectral_tpu_torch.ops.colormap import unpack_rgba
    from spectral_tpu_torch.parallel.sharding import batched_spectrogram_fn
    from spectral_tpu_torch.render.png import encode_png

    phase(f"path 1, the display spine: {BATCH} clips x {CLIP_SECONDS:g} s "
          f"at {FS:g} Hz, north_star 1024/256 log")
    n = int(FS * CLIP_SECONDS)
    cfg = SpecConfig.north_star(1024, 256, log_scale=True)
    x_host = np.random.RandomState(0).randn(BATCH, n).astype(np.float32)
    x = torch.from_numpy(x_host).to(dev)
    fn = batched_spectrogram_fn(FS, cfg, flip_image=True)
    consts = stft_cuda.dft_constants(cfg, FS, dev)

    reset_counts()
    out = fn(x)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"launches in this path's run: {counts}")
    require_one_call(counts, "fft", 1, "path 1")

    T, F = num_frames(n, cfg.nperseg, cfg.hop_), cfg.n_freqs   # 622, 513
    require(tuple(out["psd"].shape) == (BATCH, T, F)
            and tuple(out["image"].shape) == (BATCH, F, T)
            and tuple(out["rgb_packed"].shape) == (BATCH, F, T)
            and out["rgb_packed"].dtype == torch.uint32
            and tuple(out["finite"].shape) == (BATCH,),
            "output shapes and dtypes")
    require(bool(out["finite"].all()), "every clip finite")
    require(bool(torch.isfinite(out["image"]).all())
            and float(out["image"].amin()) == 0.0
            and float(out["image"].amax()) == 1.0, "image spans [0, 1]")

    db_err = db_error_vs_scipy(
        out["image"][0].flip(0).cpu().numpy(), x_host[0].astype(np.float64),
        cfg)
    require(db_err <= DB_TOL, f"clip 0 vs scipy f64: {db_err:.3e} dB")
    print(f"clip 0 vs scipy float64: {db_err:.3e} dB (limit {DB_TOL:g})")

    # the plain path on the same card, same input
    psd_p, pmin_p, pmax_p = stft_cuda.stft_psd_reference(x, consts, cfg,
                                                         with_stats=True)
    stft_rel, stft_abs = psd_err(out["psd"], psd_p)
    require(stft_rel <= PSD_TOL, f"main-path psd vs plain: {stft_rel:.2e}")
    print(f"psd vs plain: {stft_rel:.2e} of clip max ({stft_abs:.3e} abs); "
          f"largest float32 ulp distance (64 clips) "
          f"{ulp_distance(out['psd'][:64], psd_p[:64])}")
    lib_rel, _ = psd_err(library_psd(x[:64], cfg), psd_p[:64])
    require(lib_rel <= PSD_TOL, f"library yardstick vs plain: {lib_rel:.2e}")
    print(f"library yardstick (cuFFT f64) vs plain, 64 clips: {lib_rel:.2e} "
          "of clip max")
    _, parts = stft_cuda.stft_psd_partials(x, FS, cfg)
    stats = disp.clip_stats(x, parts)
    stats_p = disp.clip_stats_reference(x, parts)
    stats_err = float(torch.amax(torch.abs(stats.params - stats_p.params)))
    require(bitwise(stats.params, stats_p.params)
            and torch.equal(stats.finite, stats_p.finite)
            and torch.equal(out["finite"], stats.finite),
            f"path 1 clip_stats vs plain: {stats_err:.2e}")
    print(f"clip_stats vs plain: params bitwise, flags equal")
    img_ref, _ = disp.display_map_reference(
        out["psd"], stats.params, log_scale=True, flip_image=True)
    disp_abs, bitwise_px = image_err(out["image"], img_ref, "path 1 image")
    print(f"image vs plain display on the same PSD: {disp_abs:.2e}, "
          f"{bitwise_px:.6f} of the pixels bitwise")
    del img_ref
    _, rgb_p = disp.display_map_reference(
        psd_p[:8], disp.clip_params(pmin_p[:8], pmax_p[:8]), log_scale=True,
        flip_image=True)
    same = check_words(out["rgb_packed"][:8], rgb_p, "rgb_packed, 8 clips")
    print(f"rgb_packed of 8 clips vs the plain path: {same:.6f} identical")
    del psd_p, pmin_p, pmax_p, rgb_p
    profile_path(fn, x, card)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip0.png")
        encode_png(unpack_rgba(out["rgb_packed"][0]), path)
        with open(path, "rb") as fh:
            head = fh.read(8)
    require(head == b"\x89PNG\r\n\x1a\n", "PNG signature")
    print("clip 0 PNG written, signature ok")

    phase(f"path 1 times (CUDA events, median of {REPS} after a warm-up; "
          f"{card})")
    psd, params = out["psd"], stats.params
    del out

    def plain_pipeline():
        p = stft_cuda.stft_psd_reference(x, consts, cfg)
        parts_p = torch.stack([p.amin(dim=-1), p.amax(dim=-1)])[:, None]
        st = disp.clip_stats_reference(x, parts_p)
        img, rgb = disp.display_map_reference(p, st.params, log_scale=True,
                                              flip_image=True)
        return p, img, rgb, st.finite

    disp_kw = dict(log_scale=True, flip_image=True)
    timings = {
        "stft_kernel": time_ms(lambda: stft_cuda.stft_psd(
            x, FS, cfg, with_stats=True)),
        "stft_gemm_kernel": time_ms(lambda: stft_cuda.stft_psd(
            x, FS, cfg, with_stats=True, _route="gemm")),
        "stft_plain": time_ms(lambda: stft_cuda.stft_psd_reference(
            x, consts, cfg, with_stats=True)),
        "stft_library": time_ms(lambda: library_psd(x, cfg)),
        "display_kernel": time_ms(lambda: disp.display_map(
            psd, params, **disp_kw)),
        "display_kernel_run": time_ms(lambda: disp.display_map(
            psd, params, **disp_kw), run=RUN),
        "display_plain": time_ms(lambda: disp.display_map_reference(
            psd, params, **disp_kw)),
        "clip_stats_kernel": time_ms(lambda: disp.clip_stats(x, parts)),
        "clip_stats_kernel_run": time_ms(lambda: disp.clip_stats(x, parts),
                                         run=RUN),
        "clip_stats_plain": time_ms(lambda: disp.clip_stats_reference(
            x, parts)),
        "pipeline_kernel": time_ms(lambda: fn(x)),
        "pipeline_plain": time_ms(plain_pipeline),
        # K1-log, the kernel's log10_out mode, off the driven paths
        "stft_kernel_log10": time_ms(lambda: stft_cuda.stft_psd(
            x, FS, cfg, log10_out=True)),
        "stft_plain_log10": time_ms(lambda: stft_cuda.stft_psd_reference(
            x, consts, cfg, log10_out=True)),
        "stft_library_log10": time_ms(lambda: torch.log10(
            library_psd(x, cfg) + 1e-20)),
    }
    audio_h = BATCH * CLIP_SECONDS / 3600.0
    summary = {"card": card, "batch": BATCH, "peak_gib": round(
        torch.cuda.max_memory_allocated() / 2 ** 30, 3)}
    for name, (ms, reps) in timings.items():
        summary[name] = {"ms": ms, "ms_per_clip": ms / BATCH,
                         "audio_h_per_min": audio_h / (ms / 60000.0),
                         "reps_ms": reps}
        print(f"{name}: {ms:.3f} ms/batch, {ms / BATCH:.5f} ms/clip, "
              f"{audio_h / (ms / 60000.0):.1f} audio-h/min [{card}]")
    stft_b = stft_bound(BATCH, n, T, F, 1024)
    print(f"STFT stage: FFT kernel {timings['stft_kernel'][0]:.3f} ms, GEMM "
          f"kernel {timings['stft_gemm_kernel'][0]:.3f} ms (its design's "
          f"ceiling, the dense DFT at the FP64 peak, "
          f"{dense_dft_bound_ms(BATCH, T, F, 1024):.3f} ms), plain (cuBLAS "
          f"DGEMM) {timings['stft_plain'][0]:.3f} ms, library (cuFFT f64) "
          f"{timings['stft_library'][0]:.3f} ms; bound {stft_b[0]:.3f} ms "
          f"({stft_b[1]}) [{card}]")
    log_b = stft_bound(BATCH, n, T, F, 1024)
    print(f"K1-log (log10_out) at path 1's batch: kernel "
          f"{timings['stft_kernel_log10'][0]:.3f} ms, plain "
          f"{timings['stft_plain_log10'][0]:.3f} ms, library "
          f"{timings['stft_library_log10'][0]:.3f} ms; bound {log_b[0]:.3f} "
          f"ms ({log_b[1]}) [{card}]")
    print(json.dumps({"path1_times": summary}))
    disp_b = display_bound(BATCH, T, F, T)
    stats_b = clip_stats_bound(BATCH, n, T)
    for name, b in (("display_kernel", disp_b),
                    ("clip_stats_kernel", stats_b)):
        print(f"{name}: {timings[name][0]:.4f} ms a single call, "
              f"{timings[name + '_run'][0]:.4f} ms a launch in runs of "
              f"{RUN}; bound {b[0]:.4f} ms ({b[1]}) [{card}]")
    return {
        "stft_1024": dict(launches=counts["stft_psd"]["fft"],
                          err=stft_abs, ms=timings["stft_kernel"][0],
                          plain_ms=timings["stft_plain"][0], bound=stft_b,
                          library_ms=timings["stft_library"][0]),
        "display_rgba": dict(launches=counts["display"]["rgba"],
                             err=disp_abs,
                             ms=timings["display_kernel_run"][0],
                             plain_ms=timings["display_plain"][0],
                             bound=disp_b),
        "clip_stats": dict(launches=counts["display"]["clip_stats"],
                           err=stats_err,
                           ms=timings["clip_stats_kernel_run"][0],
                           plain_ms=timings["clip_stats_plain"][0],
                           bound=stats_b),
    }


def long_path(dev, card, dfma_peak, cfg, label, clips=K2_CLIPS,
              seconds=K2_SECONDS):
    """``clips`` clips of ``seconds`` through ``batched_spectrogram_fn`` at
    cfg: path 2 at scipy_default 8192 (the FFT route; K2's counterpart),
    paths 4, 5 and 6 at scipy_default 8160, 8032 and 8160 under linear
    detrend (the mixed-radix route), path 7 at 8191 (the odd route,
    Rader), paths 8 and 9 at 8185 and 8182 (the Bluestein route, on a
    cluster of two blocks and on one), all on 256 clips of 60 s, and path
    10 at 24 on 1024 clips of 10 s (the GEMM route). Times the GEMM
    kernel and, off the Bluestein route, the Bluestein kernel forced
    beside the route's kernel. Returns the STFT kernel's row."""
    import numpy as np
    import torch
    from spectral_tpu_torch.core.stft import num_frames
    from spectral_tpu_torch.ops import display_cuda as disp
    from spectral_tpu_torch.ops import stft_cuda
    from spectral_tpu_torch.parallel.sharding import batched_spectrogram_fn
    from torch_precision import trend

    n = int(FS * seconds)
    nperseg = cfg.nperseg
    route = stft_cuda.route(cfg)
    phase(f"{label}: {clips} clips x {seconds:g} s, nperseg {nperseg} "
          f"hop {cfg.hop_}, detrend {cfg.detrend}, log, the {route} route")
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((clips, n), generator=gen, device=dev)
    if route != "gemm":
        setup = {"fft": stft_cuda.fft_constants,
                 "bluestein": stft_cuda.bluestein_constants}.get(
                     route, stft_cuda.mixed_constants)
        t0 = time.perf_counter()
        setup(cfg, FS, dev)
        print(f"{route} route's f64 constants (window, "
              f"{'' if route == 'fft' else 'plan, '}twiddles, weights) on "
              f"the card in {time.perf_counter() - t0:.4f} s (host build + "
              "upload; set-up)")
    t0 = time.perf_counter()
    consts = stft_cuda.dft_constants(cfg, FS, dev)
    print(f"f64 DFT matrices on the card in {time.perf_counter() - t0:.2f} s "
          f"(host f64 build + upload; set-up of the GEMM route and the plain "
          f"version)")
    fn = batched_spectrogram_fn(FS, cfg, flip_image=True)

    reset_counts()
    out = fn(x)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"launches in this path's run: {counts}")
    require_one_call(counts, route, 1, label)
    # 133 and 4097 at 8192
    T, F = num_frames(n, cfg.nperseg, cfg.hop_), cfg.n_freqs
    require(tuple(out["psd"].shape) == (clips, T, F)
            and tuple(out["image"].shape) == (clips, F, T)
            and bool(out["finite"].all())
            and float(out["image"].amin()) == 0.0
            and float(out["image"].amax()) == 1.0,
            f"{label} shapes, finite flags and image range")
    x0 = x[0].double().cpu().numpy()
    db_err = db_error_vs_scipy(out["image"][0].flip(0).cpu().numpy(), x0,
                               cfg)
    require(db_err <= DB_TOL, f"{label} clip 0 vs scipy f64: {db_err:.3e} dB")
    print(f"clip 0 vs scipy float64: {db_err:.3e} dB (limit {DB_TOL:g})")
    x3 = np.random.RandomState(4).randn(1, n) + 3.0
    checks = [("noise + 3", x3)]
    if cfg.detrend == "linear":
        # noise plus a trend rising from 3 to 43 over the clip
        checks.append(("ramp", x3 - 3.0 + trend(n)))
    for what, xc in checks:
        xc = xc.astype(np.float32)
        img = fn(xc)["image"][0].flip(0).cpu().numpy()
        db = db_error_vs_scipy(img, xc[0].astype(np.float64), cfg)
        require(db <= DB_TOL, f"{label} {what} vs scipy f64: {db:.3e} dB")
        print(f"{what} clip vs scipy float64: {db:.3e} dB "
              f"(limit {DB_TOL:g})")

    psd_p, pmin_p, pmax_p = stft_cuda.stft_psd_reference(x, consts, cfg,
                                                         with_stats=True)
    stft_rel, stft_abs = psd_err(out["psd"], psd_p)
    require(stft_rel <= PSD_TOL, f"{label} psd vs plain: {stft_rel:.2e}")
    print(f"psd vs plain (cuBLAS f64): {stft_rel:.2e} of clip max "
          f"({stft_abs:.3e} abs); largest float32 ulp distance "
          f"{ulp_distance(out['psd'], psd_p)}")
    lib_rel, _ = psd_err(library_psd(x, cfg), psd_p)
    require(lib_rel <= PSD_TOL, f"library yardstick vs plain: {lib_rel:.2e}")
    print(f"library yardstick (cuFFT f64) vs plain: {lib_rel:.2e} of clip "
          "max")
    if route == "odd":
        alone = stft_cuda._stft_psd_cuda(x, FS, cfg, False, False, "odd",
                                         pack=False)
        a_rel, _ = psd_err(alone, psd_p)
        require(a_rel <= PSD_TOL, f"{label} frames alone vs plain: "
                f"{a_rel:.2e}")
        print(f"odd kernel, every frame alone, vs plain: {a_rel:.2e} of clip "
              f"max; largest float32 ulp distance {ulp_distance(alone, psd_p)}"
              f"; packed vs alone {ulp_distance(out['psd'], alone)} ulp")
        del alone
    _, parts = stft_cuda.stft_psd_partials(x, FS, cfg)
    stats = disp.clip_stats(x, parts)
    stats_p = disp.clip_stats_reference(x, parts)
    require(bitwise(stats.params, stats_p.params)
            and torch.equal(stats.finite, stats_p.finite)
            and torch.equal(out["finite"], stats.finite)
            and torch.equal(torch.isnan(stats.pmin), torch.isnan(pmin_p)),
            f"{label} clip_stats vs plain")
    img_ref, _ = disp.display_map_reference(
        out["psd"], stats.params, log_scale=True, flip_image=True)
    disp_abs, bitwise_px = image_err(out["image"], img_ref, f"{label} image")
    print(f"clip_stats vs plain: params bitwise, flags equal; image vs plain "
          f"display on the same PSD: {disp_abs:.2e}, {bitwise_px:.6f} of "
          f"the pixels bitwise")
    del img_ref, psd_p, pmin_p, pmax_p, out

    phase(f"{label} times (CUDA events, median of {REPS} after a warm-up; "
          f"{card})")
    timings = {
        "stft_kernel": time_ms(lambda: stft_cuda.stft_psd(
            x, FS, cfg, with_stats=True)),
        "stft_plain": time_ms(lambda: stft_cuda.stft_psd_reference(
            x, consts, cfg, with_stats=True)),
        "stft_library": time_ms(lambda: library_psd(x, cfg)),
        "pipeline_kernel": time_ms(lambda: fn(x)),
        "clip_stats_kernel_run": time_ms(lambda: disp.clip_stats(x, parts),
                                         run=RUN),
    }
    if route == "odd":
        timings["stft_kernel_frames_alone"] = time_ms(
            lambda: stft_cuda._stft_psd_cuda(x, FS, cfg, False, True, "odd",
                                             pack=False))
    if route != "gemm":
        timings["stft_gemm_kernel"] = time_ms(lambda: stft_cuda.stft_psd(
            x, FS, cfg, with_stats=True, _route="gemm"))
    if route not in ("gemm", "bluestein"):
        timings["stft_bluestein_kernel"] = time_ms(
            lambda: stft_cuda.stft_psd(x, FS, cfg, with_stats=True,
                                       _route="bluestein"))
    for name, (ms, reps) in timings.items():
        print(f"{name}: {ms:.3f} ms [{card}] reps {reps}")
    audio_h = clips * seconds / 3600.0
    ms = timings["pipeline_kernel"][0]
    print(f"pipeline: {ms:.3f} ms per batch, {audio_h / (ms / 60000.0):.1f} "
          f"audio-h/min [{card}]")
    dense_ms = dense_dft_bound_ms(clips, T, F, nperseg)
    gemm_ms = timings.get("stft_gemm_kernel", timings["stft_kernel"])[0]
    flops = 4.0 * clips * T * F * nperseg
    print(f"GEMM kernel: {flops / 1e12:.3f} TFLOP of dense DFT in "
          f"{gemm_ms:.3f} ms = {flops / gemm_ms / 1e9:.2f} TFLOP/s; that "
          f"design's ceiling {dense_ms:.3f} ms at the FP64 peak "
          f"{FP64_PEAK / 1e12:g} TFLOP/s, {1e3 * flops / dfma_peak:.3f} ms "
          f"at the {dfma_peak / 1e12:.2f} TFLOP/s of DFMA [{card}]")
    bound = stft_bound(clips, n, T, F, nperseg)
    print(f"STFT kernel ({route}): {timings['stft_kernel'][0]:.3f} ms; "
          f"bound {bound[0]:.3f} ms ({bound[1]}) [{card}]")
    print(json.dumps({f"path_{nperseg}_{cfg.detrend}_times": {
        k: v[0] for k, v in timings.items()}, "card": card}))
    return dict(launches=counts["stft_psd"][route], err=stft_abs,
                ms=timings["stft_kernel"][0],
                plain_ms=timings["stft_plain"][0], bound=bound,
                library_ms=timings["stft_library"][0])


def decode_palette_png(path):
    """The index image of an indexed-color PNG (8-bit, any filter)."""
    import numpy as np
    with open(path, "rb") as fh:
        data = fh.read()
    require(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: PNG signature")
    pos, idat = 8, b""
    while pos < len(data):
        size, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + size]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            require(depth == 8 and ctype == 3, f"{path}: 8-bit palette PNG")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    out = np.zeros((h, w), np.int64)
    prev = np.zeros(w, np.int64)
    for r in range(h):
        f, line = raw[r, 0], raw[r, 1:].astype(np.int64)
        if f == 0:
            cur = line
        elif f == 2:
            cur = (line + prev) % 256
        else:          # sub, average, paeth: byte by byte (bpp 1)
            cur = np.zeros(w, np.int64)
            for i in range(w):
                a = cur[i - 1] if i else 0
                b, c = prev[i], prev[i - 1] if i else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (line[i] + pred) % 256
        out[r] = cur
        prev = cur
    return out.astype(np.uint8)


def export_path(dev, card):
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.io.wav import write_wav
    from spectral_tpu_torch.ops import display_cuda as disp
    from spectral_tpu_torch.ops import stft_cuda
    from spectral_tpu_torch.ops.colormap import unpack_indices
    from spectral_tpu_torch.parallel.pipeline import (export_spectrograms,
                                                      wav_clip_source)

    n = int(FS * CLIP_SECONDS)
    cfg = SpecConfig.north_star(1024, 256, log_scale=True)
    phase(f"path 3, the dataset export: {EXPORT_CLIPS} clips x "
          f"{CLIP_SECONDS:g} s, north_star 1024/256 log, batch "
          f"{EXPORT_BATCH}, palette PNGs")
    clips = np.random.RandomState(5).randn(EXPORT_CLIPS, n).astype(
        np.float32)
    nan_clip = clips[0].copy()
    nan_clip[777] = np.nan
    t = np.arange(n) / FS
    with tempfile.TemporaryDirectory() as tmp:
        wav_dir = os.path.join(tmp, "wav")
        out_dir = os.path.join(tmp, "png")
        os.makedirs(wav_dir)
        # one batch of int16 WAVs, so it stages as raw int16: tones from
        # 100 Hz up, with a little noise
        wavs = []
        for i in range(EXPORT_BATCH):
            path = os.path.join(wav_dir, f"tone{i}.wav")
            write_wav(path, 0.5 * np.sin(2 * np.pi * (100.0 + 100.0 * i) * t)
                      + 0.01 * np.random.RandomState(i).randn(n), FS)
            wavs.append(path)
        source = itertools.chain(
            ((f"clip{i:04d}", clips[i]) for i in range(EXPORT_CLIPS)),
            wav_clip_source(wavs), [("nan_clip", nan_clip)])
        reset_counts()
        stats = export_spectrograms(source, FS, cfg, out_dir,
                                    clip_samples=n, batch=EXPORT_BATCH,
                                    on_error="skip")
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"launches in this path's run: {counts}")
        batches = -(-(EXPORT_CLIPS + EXPORT_BATCH + 1) // EXPORT_BATCH)
        require_one_call(counts, "fft", batches, "path 3")
        require(counts["display"]["palette"] == batches,
                f"path 3: palette words in every batch: {counts}")
        names = set(os.listdir(out_dir))
        want = {f"clip{i:04d}.png" for i in range(EXPORT_CLIPS)}
        require(want <= names and len(want) == EXPORT_CLIPS,
                f"{len(want & names)} of {EXPORT_CLIPS} clip PNGs written")
        tones = {f"tone{i}.png" for i in range(EXPORT_BATCH)}
        require(tones <= names and "nan_clip.png" not in names
                and stats.nonfinite == 1 and stats.failed == 1
                and stats.pngs_written == EXPORT_CLIPS + EXPORT_BATCH
                and stats.clips == EXPORT_CLIPS + EXPORT_BATCH + 1,
                f"export counts: {stats}")
        print(f"{EXPORT_CLIPS} clip PNGs + {EXPORT_BATCH} WAV PNGs written, "
              f"the NaN clip skipped: {stats}")
        ahpm = stats.seconds_audio / 3600.0 / (stats.wall_s / 60.0)
        print(f"export: {stats.seconds_audio:.0f} s of audio in "
              f"{stats.wall_s:.3f} s = {ahpm:.1f} audio-h/min [{card}]")
        print(json.dumps({"export_breakdown": stats.breakdown(),
                          "audio_h_per_min": ahpm, "card": card}))

        # decoded PNG indices against the plain path on the card
        check = [0, 1, EXPORT_CLIPS // 2 - 1, EXPORT_CLIPS - 1]
        xc = torch.from_numpy(clips[check]).to(dev)
        consts = stft_cuda.dft_constants(cfg, FS, dev)
        p, lo, hi = stft_cuda.stft_psd_reference(xc, consts, cfg,
                                                 with_stats=True)
        _, words = disp.display_map_reference(
            p, disp.clip_params(lo, hi), log_scale=True, flip_image=True,
            palette=True)
        T = p.shape[1]
        want_idx = unpack_indices(words, T)
        for j, i in enumerate(check):
            got = decode_palette_png(os.path.join(out_dir,
                                                  f"clip{i:04d}.png"))
            same = check_indices(got, want_idx[j], f"clip{i:04d}.png")
            print(f"clip{i:04d}.png decoded: {got.shape}, indices identical "
                  f"to the plain path {same:.6f}")
        tone = decode_palette_png(os.path.join(out_dir, "tone0.png"))
        require(tone.shape == (513, T)
                and int(np.argmax(tone.mean(axis=1))) >= 513 - 10,
                "the 100 Hz WAV's energy sits at the bottom rows")
        print("tone0.png (int16 WAV, 100 Hz): energy at the bottom rows")

    # the palette display kernel at the export's batch shape
    # as the export calls it: palette indices, no float image; the error
    # is in LUT indices
    phase(f"path 3 display kernel times (CUDA events; {card})")
    xb = torch.from_numpy(clips[:EXPORT_BATCH]).to(dev)
    psd, parts = stft_cuda.stft_psd_partials(xb, FS, cfg)
    params = disp.clip_stats(xb, parts).params
    kw = dict(log_scale=True, flip_image=True, palette=True,
              with_image=False)
    _, idx_k = disp.display_map(psd, params, **kw)
    _, idx_p = disp.display_map_reference(psd, params, **kw)
    torch.cuda.synchronize()
    got, want = unpack_indices(idx_k, T), unpack_indices(idx_p, T)
    check_indices(got, want, "palette at the export batch")
    err = float(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
    k_ms = time_ms(lambda: disp.display_map(psd, params, **kw))
    k_run = time_ms(lambda: disp.display_map(psd, params, **kw), run=RUN)
    p_ms = time_ms(lambda: disp.display_map_reference(psd, params, **kw))
    s_ms = time_ms(lambda: disp.clip_stats(xb, parts))
    s_run = time_ms(lambda: disp.clip_stats(xb, parts), run=RUN)
    bound = display_bound(EXPORT_BATCH, T, 513, -(-T // 4), image=False,
                          lut=False)
    s_bound = clip_stats_bound(EXPORT_BATCH, n, T)
    print(f"palette display without the image: kernel {k_ms[0]:.4f} ms a "
          f"single call, {k_run[0]:.4f} ms a launch in runs of {RUN}, plain "
          f"{p_ms[0]:.3f} ms, bound {bound[0]:.4f} ms per batch of "
          f"{EXPORT_BATCH}; largest index difference {err:g} [{card}]")
    print(f"clip_stats at the export batch: {s_ms[0]:.4f} ms a single call, "
          f"{s_run[0]:.4f} ms a launch in runs of {RUN}, bound "
          f"{s_bound[0]:.4f} ms [{card}]")
    return {"display_palette": dict(
        launches=counts["display"]["palette"], err=err, ms=k_run[0],
        plain_ms=p_ms[0], bound=bound),
        "stft_export_launches": counts["stft_psd"]["fft"]}


# ---------------------------------------------------------------------------
# the band mask, the mel branch and the PSD entry points on the card
# ---------------------------------------------------------------------------

def _bands(F):
    """The bands each route is held to: the full band, DC alone, the last
    bin alone (the Nyquist bin g = M of an even K, the last bin of an odd
    K), all but the edges, one row inside, a band from past 0 inside one
    GEMM tile of 64 bins and one across tiles."""
    cands = [(0, F), (0, 1), (F - 1, F), (1, F - 1), (F // 3, F // 3 + 1),
             (3, 20), (5, 70), (60, 130)]
    return sorted({(lo, hi) for lo, hi in cands if 0 <= lo < hi <= F})


def _launched(route, before, what):
    from spectral_tpu_torch.ops import stft_cuda
    after = dict(stft_cuda.launches)
    require(after[route] == before[route] + 1
            and sum(after.values()) == sum(before.values()) + 1,
            f"{what}: one launch of the {route} kernel, counts {before} -> "
            f"{after}")


def band_kernel_cases(dev):
    """A band on each of the five routes, bitwise the matching columns of
    the full band's output: the PSD, its log10_out and each row's (min,
    max) partials (the full PSD's columns' min and max), at the bands of
    ``_bands`` on 3 clips (one with a NaN sample), every kernel's launch
    counted; the banded kernel held to the banded plain version too."""
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.ops import stft_cuda

    phase("the band mask on every route, bitwise against the full band")
    rs = np.random.RandomState(12)
    cases = [
        (SpecConfig.north_star(1024, 256), None),      # radix 2, 8 values
        (SpecConfig.scipy_default(32), None),          # radix 2, 16 frames
        (SpecConfig.scipy_default(8192), None),        # radix 2, 16 values
        (SpecConfig(nperseg=960, hop=240, detrend="linear"), None),  # mixed
        (SpecConfig.scipy_default(8160), None),        # mixed, RMAX 4
        (SpecConfig.scipy_default(1006), None),        # mixed Rader, PACKED
        (SpecConfig.scipy_default(1023), None),        # odd
        (SpecConfig.scipy_default(8191), None),        # odd, Rader
        (SpecConfig.scipy_default(2049), None),        # Bluestein, odd pairs
        (SpecConfig.scipy_default(8182), None),        # Bluestein, one block
        (SpecConfig.scipy_default(8185), None),        # Bluestein, cluster
        (SpecConfig.scipy_default(24), None),          # GEMM, small-K tile
        (SpecConfig.scipy_default(1024), "gemm"),      # GEMM, 128 x 64 tile
    ]
    worst = 0.0
    for cfg, forced in cases:
        route = forced or stft_cuda.route(cfg)
        K, F = cfg.nperseg, cfg.n_freqs
        x = rs.randn(3, 5 * K + 37) + 0.5
        x[2, 2 * K] = np.nan
        x = torch.from_numpy(x.astype(np.float32)).to(dev)
        full = stft_cuda.stft_psd(x, FS, cfg, _route=forced)
        full_log = stft_cuda.stft_psd(x, FS, cfg, log10_out=True,
                                      _route=forced)
        bands = _bands(F)
        for band in bands:
            lo, hi = band
            what = f"nperseg {K} [{route}] band {band} of {F}"
            before = dict(stft_cuda.launches)
            got = stft_cuda.stft_psd(x, FS, cfg, band=band, _route=forced)
            torch.cuda.synchronize()
            _launched(route, before, what)
            got_log = stft_cuda.stft_psd(x, FS, cfg, log10_out=True,
                                         band=band, _route=forced)
            psd, parts = stft_cuda._stft_psd_cuda(
                x, FS, cfg, False, True, route, partials=True, band=band)
            torch.cuda.synchronize()
            cols = full[..., lo:hi].contiguous()
            want_parts = torch.stack([torch.amin(cols, dim=-1),
                                      torch.amax(cols, dim=-1)])
            got_parts = torch.stack([torch.amin(parts[0], dim=0),
                                     torch.amax(parts[1], dim=0)])
            require(tuple(got.shape) == (3, full.shape[1], hi - lo)
                    and bitwise(got, cols) and bitwise(psd, cols)
                    and bitwise(got_log, full_log[..., lo:hi].contiguous())
                    and bitwise(got_parts, want_parts),
                    f"{what}: bitwise the full band's columns (psd "
                    f"{bitwise(got, cols)}, log10 "
                    f"{bitwise(got_log, full_log[..., lo:hi].contiguous())},"
                    f" partials {bitwise(got_parts, want_parts)})")
        band = bands[len(bands) // 2]
        want = stft_cuda.stft_psd_reference(
            x, stft_cuda.dft_constants(cfg, FS, dev, band), cfg)
        got = stft_cuda.stft_psd(x, FS, cfg, band=band, _route=forced)
        rel, _ = psd_err(got[:2], want[:2])
        require(rel <= PSD_TOL, f"nperseg {K} band {band} vs the banded "
                f"plain version: {rel:.2e}")
        worst = max(worst, rel)
        print(f"nperseg {K} [{route}]: {len(bands)} bands of {F} bins "
              f"bitwise the full band's columns (psd, log10_out, partials); "
              f"band {band} vs the banded plain version {rel:.2e} of clip "
              f"max")
    print(f"the band mask: every route bitwise; worst kernel vs plain "
          f"{worst:.2e} (limit {PSD_TOL:g})")


MEL_ULPS = 1      # the mel kernel against its plain version, float32 ulps


def mel_kernel_cases(dev):
    """The mel kernel against its plain version (the float64 dense
    product, ``mel_project_reference``) on PSDs with injected inf and NaN
    bins: an inf bin inside a triangle (that row inf, the others NaN), an
    inf bin at Nyquist (no filter's: every row NaN), a NaN bin, a silent
    frame; at 128 mels over 513 bins, 8 wide mels, HTK mels over a band of
    the mel axis, 64 mels over 4097 bins (two rows a block), 600 mels over
    513 bins (rows with no nonzero weight), T = 0. NaN and inf in the same
    places, the rest within MEL_ULPS float32 ulps, and the partials the
    same."""
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.mel import mel_centers, mel_filterbank
    from spectral_tpu_torch.core.stft import band_row_slice
    from spectral_tpu_torch.ops import mel_cuda

    phase("the mel kernel against its plain version")
    rs = np.random.RandomState(13)
    cases = [
        (SpecConfig.north_star(1024, 256, n_mels=128), FS),
        (SpecConfig.north_star(512, 128, n_mels=8), FS),
        (SpecConfig.north_star(256, 64, n_mels=40, mel_htk=True,
                               mel_fmin=300.0, mel_fmax=6000.0, fmin=500.0,
                               fmax=4000.0), FS),
        (SpecConfig.scipy_default(8192, n_mels=64), FS),
        (SpecConfig.north_star(1024, 256, n_mels=600), FS),
    ]
    for cfg, fs in cases:
        F = cfg.n_freqs
        results = []
        fb = mel_filterbank(cfg.n_mels, F, fs, cfg.mel_fmin, cfg.mel_fmax,
                            cfg.mel_htk)
        m_lo, m_hi = band_row_slice(
            mel_centers(cfg.n_mels, fs, cfg.mel_fmin, cfg.mel_fmax,
                        cfg.mel_htk), cfg.fmin, cfg.fmax) or (0, cfg.n_mels)
        spans = mel_cuda.mel_spans(fb[m_lo:m_hi], dev)
        start = spans.start.cpu().numpy()
        length = spans.length.cpu().numpy()
        m = int(np.argmax(length))                 # the widest triangle
        psd = rs.exponential(1e-3, (5, 37, F)).astype(np.float32)
        psd[0, 3, start[m] + length[m] // 2] = np.inf
        psd[0, 4, F - 1] = np.inf
        psd[1, 5, 7] = np.nan
        psd[2, 6] = 0.0
        psd = torch.from_numpy(psd).to(dev)
        for p in (psd, psd[:, :0].contiguous()):
            what = (f"mel {cfg.n_mels} rows {m_lo}-{m_hi} over {F} bins, T "
                    f"{p.shape[1]}")
            before = dict(mel_cuda.launches)
            got, gp = mel_cuda.mel_project(p, spans)
            torch.cuda.synchronize()
            want, wp = mel_cuda.mel_project_reference(p, spans)
            torch.cuda.synchronize()
            launched = mel_cuda.launches["mel"] - before["mel"]
            require(launched == (1 if p.shape[1] else 0),
                    f"{what}: mel kernel launches {launched}")
            results.append((got, want))
            for a, b, name in ((got, want, "mel"), (gp, wp, "partials")):
                require(tuple(a.shape) == tuple(b.shape)
                        and torch.equal(torch.isnan(a), torch.isnan(b))
                        and torch.equal(torch.isinf(a), torch.isinf(b))
                        and ulp_distance(a, b) <= MEL_ULPS,
                        f"{what}: {name} vs plain: NaN "
                        f"{torch.equal(torch.isnan(a), torch.isnan(b))}, "
                        f"inf {torch.equal(torch.isinf(a), torch.isinf(b))}"
                        f", {ulp_distance(a, b)} ulp")
        got, want = results[0]
        require(bool(torch.isinf(got[0, 3, m]))
                and bool(torch.isnan(got[0, 3]).any())
                and bool(torch.isnan(got[0, 4]).all())
                and bool(torch.isnan(got[1, 5]).all())
                and bool((got[2, 6] == 0).all()),
                f"{what}: the inf row, the NaN rows and the silent frame")
        print(f"{what[:what.index(', T')]}: NaN and inf in the plain "
              f"version's places, "
              f"{ulp_distance(got, want)} ulp (limit {MEL_ULPS}); "
              f"{int((length == 0).sum())} rows with no weight")


def repair_cases(dev):
    """The PSD entry points of core/stft.py on a CUDA tensor launch the
    route's STFT/PSD kernel once, bitwise its output, not the plain dense
    product on the card: power_spectrogram, power_spectrogram_fm with a
    band and a flip, and spectrogram with the GUI's band."""
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core import stft as tstft
    from spectral_tpu_torch.ops import stft_cuda

    phase("the PSD entry points launch the kernel for a CUDA tensor")
    rs = np.random.RandomState(14)
    x = torch.from_numpy(rs.randn(2, 3, 20000).astype(np.float32)).to(dev)
    for cfg, route in ((SpecConfig.scipy_default(1024), "fft"),
                       (SpecConfig.scipy_default(992), "mixed"),
                       (SpecConfig.scipy_default(24), "gemm")):
        kern = stft_cuda.stft_psd(x.reshape(6, -1), FS, cfg).reshape(
            2, 3, -1, cfg.n_freqs)
        before = dict(stft_cuda.launches)
        p = tstft.power_spectrogram(x, FS, cfg)
        torch.cuda.synchronize()
        _launched(route, before, f"power_spectrogram at {cfg.nperseg}")
        require(bitwise(p, kern), f"power_spectrogram at {cfg.nperseg}: "
                "the kernel's output")
        band = (1, cfg.n_freqs // 2)
        before = dict(stft_cuda.launches)
        fm = tstft.power_spectrogram_fm(x, FS, cfg, flip_freqs=True,
                                        band=band)
        torch.cuda.synchronize()
        _launched(route, before, f"power_spectrogram_fm at {cfg.nperseg}")
        want = kern[..., band[0]:band[1]].transpose(-1, -2).flip(-2)
        require(bitwise(fm.contiguous(), want.contiguous()),
                f"power_spectrogram_fm band {band} at {cfg.nperseg}")
    cfg = SpecConfig.scipy_default(1024, fmin=0.0, fmax=30.0)
    xs = torch.from_numpy(rs.randn(60000).astype(np.float32))
    before = dict(stft_cuda.launches)
    f, t, sxx = tstft.spectrogram(xs.to(dev), 1000.0, cfg)
    torch.cuda.synchronize()
    _launched("fft", before, "spectrogram")
    f_c, t_c, sxx_c = tstft.spectrogram(xs.double(), 1000.0, cfg)
    rel, _ = psd_err(sxx.cpu()[None], sxx_c.float()[None])
    require(np.array_equal(f, f_c) and np.array_equal(t, t_c)
            and tuple(sxx.shape) == (31, len(t)) and rel <= PSD_TOL,
            f"spectrogram on the card vs the CPU: {rel:.2e}")
    print(f"power_spectrogram, power_spectrogram_fm and spectrogram: one "
          f"kernel launch each, bitwise the kernel; spectrogram's 0-30 Hz "
          f"band ({len(f)} rows) on the card vs the plain version {rel:.2e}")


def mel_bound(B, T, F, M):
    """Bytes: the PSD read once, the mel rows and the per-frame partials
    written once (the arithmetic, 2 per nonzero weight, is far below)."""
    return 1e3 * (B * T * F * 4 + B * T * M * 4 + 2 * B * T * 4) / HBM_RATE, \
        "bytes"


def require_counts(counts, want, what):
    """The path's run launched exactly ``want`` (kernel -> launches), every
    other count 0."""
    flat = {**{f"stft_{k}": v for k, v in counts["stft_psd"].items()},
            **counts["display"], **counts["mel"],
            **{f"hmm_{k}": v for k, v in counts["hmm"].items()}}
    extra = {k: v for k, v in flat.items() if k not in want and v}
    require(all(flat[k] == v for k, v in want.items()) and not extra,
            f"{what}: launches {want} and no other, got {counts}")


def mel_path(dev, card):
    """Path 12, the mel branch (BASELINE.json config 2): 1024 clips of 10 s
    at 16 kHz through ``batched_spectrogram_fn`` at north_star 1024/256
    with 128 log mels (four launches: the STFT kernel without extrema, the
    mel kernel, clip_stats and the display map), held to the plain path on
    the card, timed against the bounds; then ``export_spectrograms`` over
    four batches of 64 clips."""
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.mel import mel_filterbank
    from spectral_tpu_torch.core.stft import num_frames
    from spectral_tpu_torch.ops import display_cuda as disp
    from spectral_tpu_torch.ops import mel_cuda, stft_cuda
    from spectral_tpu_torch.ops.colormap import unpack_indices
    from spectral_tpu_torch.parallel.pipeline import export_spectrograms
    from spectral_tpu_torch.parallel.sharding import batched_spectrogram_fn

    n = int(FS * CLIP_SECONDS)
    cfg = SpecConfig.north_star(1024, 256, n_mels=128, log_scale=True)
    phase(f"path 12, the mel branch: {BATCH} clips x {CLIP_SECONDS:g} s at "
          f"{FS:g} Hz, north_star 1024/256, 128 log mels")
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((BATCH, n), generator=gen, device=dev)
    fn = batched_spectrogram_fn(FS, cfg, flip_image=True)
    reset_counts()
    out = fn(x)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"launches in this path's run: {counts}")
    require_counts(counts, {"stft_fft": 1, "mel": 1, "clip_stats": 1,
                            "rgba": 1}, "path 12")
    mel_launches = counts["mel"]["mel"]
    T, F, M = num_frames(n, 1024, 256), cfg.n_freqs, 128
    require(tuple(out["psd"].shape) == (BATCH, T, F)
            and tuple(out["mel"].shape) == (BATCH, T, M)
            and tuple(out["image"].shape) == (BATCH, M, T)
            and tuple(out["rgb_packed"].shape) == (BATCH, M, T)
            and bool(out["finite"].all())
            and bool(torch.isfinite(out["image"]).all())
            and float(out["image"].amin()) == 0.0
            and float(out["image"].amax()) == 1.0,
            "path 12 shapes, flags and image range")
    spans = mel_cuda.mel_spans(mel_filterbank(128, F, FS), dev)
    consts = stft_cuda.dft_constants(cfg, FS, dev)
    psd_p = stft_cuda.stft_psd_reference(x, consts, cfg)
    stft_rel, stft_abs = psd_err(out["psd"], psd_p)
    require(stft_rel <= PSD_TOL, f"path 12 psd vs plain: {stft_rel:.2e}")
    mel_p, parts_p = mel_cuda.mel_project_reference(out["psd"], spans)
    mel_ulp = ulp_distance(out["mel"], mel_p)
    mel_abs = float((out["mel"] - mel_p).abs().amax())
    require(mel_ulp <= MEL_ULPS, f"path 12 mel vs plain: {mel_ulp} ulp")
    mel_full_p, _ = mel_cuda.mel_project_reference(psd_p, spans)
    mel_rel, _ = psd_err(out["mel"], mel_full_p)
    require(mel_rel <= PSD_TOL, f"path 12 mel vs the plain path: "
            f"{mel_rel:.2e}")
    _, parts = mel_cuda.mel_project(out["psd"], spans)
    stats = disp.clip_stats(x, parts)
    stats_p = disp.clip_stats_reference(x, parts)
    require(bitwise(stats.params, stats_p.params)
            and torch.equal(stats.finite, stats_p.finite)
            and torch.equal(out["finite"], stats.finite),
            "path 12 clip_stats vs plain")
    img_ref, rgb_ref = disp.display_map_reference(
        out["mel"], stats.params, log_scale=True, flip_image=True)
    disp_abs, bitwise_px = image_err(out["image"], img_ref, "path 12 image")
    same = check_words(out["rgb_packed"][:64], rgb_ref[:64],
                       "path 12 rgb_packed, 64 clips")
    print(f"psd vs plain {stft_rel:.2e} of clip max; mel vs plain on the "
          f"same PSD {mel_ulp} ulp ({mel_abs:.3e} abs), vs the plain path "
          f"{mel_rel:.2e} of clip max; clip_stats params bitwise; image vs "
          f"plain {disp_abs:.2e} ({bitwise_px:.6f} bitwise); words "
          f"{same:.6f} identical")
    del img_ref, rgb_ref, psd_p, mel_full_p

    phase(f"path 12 times (CUDA events, median of {REPS} after a warm-up; "
          f"{card})")
    psd, mel, params = out["psd"], out["mel"], stats.params
    rows64 = spans.rows

    def library():
        mm = torch.matmul(psd.double(), rows64.T)
        return mm, torch.amin(mm, dim=-1), torch.amax(mm, dim=-1)

    kw = dict(log_scale=True, flip_image=True)
    timings = {
        "stft_kernel": time_ms(lambda: stft_cuda.stft_psd(x, FS, cfg)),
        "mel_kernel": time_ms(lambda: mel_cuda.mel_project(psd, spans)),
        "mel_kernel_run": time_ms(lambda: mel_cuda.mel_project(psd, spans),
                                  run=RUN),
        "mel_plain": time_ms(lambda: mel_cuda.mel_project_reference(
            psd, spans)),
        "mel_library": time_ms(library),
        "clip_stats_kernel_run": time_ms(lambda: disp.clip_stats(x, parts),
                                         run=RUN),
        "display_kernel_run": time_ms(lambda: disp.display_map(
            mel, params, **kw), run=RUN),
        "pipeline_kernel": time_ms(lambda: fn(x)),
    }
    for name, (ms, reps) in timings.items():
        print(f"{name}: {ms:.4f} ms [{card}] reps {reps}")
    b_mel = mel_bound(BATCH, T, F, M)
    b_disp = display_bound(BATCH, T, M, T)
    print(f"mel kernel: {timings['mel_kernel_run'][0]:.4f} ms a launch in "
          f"runs of {RUN} ({timings['mel_kernel'][0]:.4f} single); bound "
          f"{b_mel[0]:.4f} ms ({b_mel[1]}); plain (f64 dense product + "
          f"amin/amax, cast) {timings['mel_plain'][0]:.3f} ms; library "
          f"(torch.matmul f64 + amin/amax) {timings['mel_library'][0]:.3f} "
          f"ms [{card}]")
    print(f"display map over the mel rows: "
          f"{timings['display_kernel_run'][0]:.4f} ms; bound "
          f"{b_disp[0]:.4f} ms [{card}]")
    ms = timings["pipeline_kernel"][0]
    print(f"pipeline: {ms:.3f} ms per batch, "
          f"{BATCH * CLIP_SECONDS / 3600.0 / (ms / 60000.0):.1f} audio-h/min "
          f"[{card}]")
    print(json.dumps({"path12_times": {k: v[0] for k, v in
                                       timings.items()}, "card": card}))
    del out, psd, mel

    phase(f"path 12 export: 4 batches of {EXPORT_BATCH} clips x "
          f"{CLIP_SECONDS:g} s, 128 log mels, palette PNGs")
    clips = x[:4 * EXPORT_BATCH].cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        st = export_spectrograms(
            ((f"mel{i:03d}", clips[i]) for i in range(len(clips))), FS, cfg,
            tmp, clip_samples=n, batch=EXPORT_BATCH)
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"launches in the export's run: {counts}")
        require_counts(counts, {"stft_fft": 4, "mel": 4, "clip_stats": 4,
                                "palette": 4}, "path 12 export")
        require(st.pngs_written == len(clips) and st.failed == 0,
                f"path 12 export: {st}")
        xc = x[:2]
        p_c = stft_cuda.stft_psd_reference(xc, consts, cfg)
        m_c, parts_c = mel_cuda.mel_project_reference(p_c, spans)
        st_c = disp.clip_stats_reference(xc, parts_c)
        _, words = disp.display_map_reference(
            m_c, st_c.params, log_scale=True, flip_image=True, palette=True)
        want_idx = unpack_indices(words, T)
        for i in range(2):
            got = decode_palette_png(os.path.join(tmp, f"mel{i:03d}.png"))
            same = check_indices(got, want_idx[i], f"mel{i:03d}.png")
            require(got.shape == (M, T), f"mel{i:03d}.png {got.shape}")
            print(f"mel{i:03d}.png decoded: {got.shape}, indices identical "
                  f"to the plain path {same:.6f}")
        ahpm = st.seconds_audio / 3600.0 / (st.wall_s / 60.0)
        print(f"export: {st.pngs_written} PNGs, {st.seconds_audio:.0f} s of "
              f"audio in {st.wall_s:.3f} s = {ahpm:.1f} audio-h/min [{card}]")
        print(json.dumps({"path12_export_breakdown": st.breakdown(),
                          "audio_h_per_min": ahpm, "card": card}))
    return {"mel_project": dict(
        launches=mel_launches, err=mel_abs,
        ms=timings["mel_kernel_run"][0], plain_ms=timings["mel_plain"][0],
        bound=b_mel, library_ms=timings["mel_library"][0])}


BAND_FS = 1000.0
BAND_SECONDS = 960.0    # 16 min of EEG-rate recording a clip
BAND_CLIPS = 256


def band_path(dev, card, dfma_peak):
    """Path 13, the GUI's defaults on an EEG-rate batch: 256 clips of 16
    min at 1 kHz through ``batched_spectrogram_fn`` at scipy_default 1024
    with the GUI's band, 0-30 Hz (rows 0-30 of 513; three launches: the
    STFT kernel on the band's bins, clip_stats and the display map), held
    to the plain path on the card and to scipy in float64, timed against
    the bounds beside the full band's kernel."""
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.stft import (band_row_slice, freq_axis,
                                              num_frames)
    from spectral_tpu_torch.ops import display_cuda as disp
    from spectral_tpu_torch.ops import stft_cuda
    from spectral_tpu_torch.parallel.sharding import batched_spectrogram_fn
    from torch_precision import log_display, scipy_psd

    n = int(BAND_FS * BAND_SECONDS)
    cfg = SpecConfig.scipy_default(1024, fmin=0.0, fmax=30.0, log_scale=True)
    band = band_row_slice(freq_axis(cfg, BAND_FS), cfg.fmin, cfg.fmax)
    phase(f"path 13, the GUI's band: {BAND_CLIPS} clips x {BAND_SECONDS:g} "
          f"s at {BAND_FS:g} Hz, scipy_default 1024, 0-30 Hz (bins "
          f"{band[0]}-{band[1] - 1}), log")
    gen = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn((BAND_CLIPS, n), generator=gen, device=dev)
    fn = batched_spectrogram_fn(BAND_FS, cfg, flip_image=True)
    reset_counts()
    out = fn(x)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"launches in this path's run: {counts}")
    require_counts(counts, {"stft_fft": 1, "clip_stats": 1, "rgba": 1},
                   "path 13")
    T, Fb = num_frames(n, 1024, cfg.hop_), band[1] - band[0]
    require(band == (0, 31) and tuple(out["psd"].shape) == (BAND_CLIPS, T,
                                                            Fb)
            and tuple(out["image"].shape) == (BAND_CLIPS, Fb, T)
            and bool(out["finite"].all())
            and float(out["image"].amin()) == 0.0
            and float(out["image"].amax()) == 1.0,
            "path 13 shapes, flags and image range")
    db_worst = 0.0
    for i in (0, BAND_CLIPS - 1):
        x64 = x[i].double().cpu().numpy()
        ref = scipy_psd(x64, cfg, BAND_FS)[band[0]:band[1]]
        img_ref, rng = log_display(ref)
        img = out["image"][i].flip(0).cpu().numpy().astype(np.float64)
        db = float(np.max(np.abs(img - img_ref)) * rng)
        db_worst = max(db_worst, db)
    require(db_worst <= DB_TOL, f"path 13 vs scipy f64: {db_worst:.3e} dB")
    print(f"clips 0 and {BAND_CLIPS - 1}, band 0-30 Hz, vs scipy float64: "
          f"{db_worst:.3e} dB (limit {DB_TOL:g})")
    consts = stft_cuda.dft_constants(cfg, BAND_FS, dev, band)
    psd_p = stft_cuda.stft_psd_reference(x, consts, cfg)
    stft_rel, stft_abs = psd_err(out["psd"], psd_p)
    require(stft_rel <= PSD_TOL, f"path 13 psd vs plain: {stft_rel:.2e}")
    full = stft_cuda.stft_psd(x[:16], BAND_FS, cfg)
    require(bitwise(out["psd"][:16], full[..., band[0]:band[1]].contiguous()),
            f"path 13 psd bitwise the full band's first {Fb} bins")
    _, parts = stft_cuda.stft_psd_partials(x, BAND_FS, cfg, band)
    stats = disp.clip_stats(x, parts)
    stats_p = disp.clip_stats_reference(x, parts)
    require(bitwise(stats.params, stats_p.params)
            and torch.equal(stats.finite, stats_p.finite)
            and torch.equal(out["finite"], stats.finite),
            "path 13 clip_stats vs plain")
    img_ref, _ = disp.display_map_reference(
        out["psd"], stats.params, log_scale=True, flip_image=True)
    disp_abs, bitwise_px = image_err(out["image"], img_ref, "path 13 image")
    print(f"psd vs plain (cuBLAS f64, banded matrices) {stft_rel:.2e} of "
          f"clip max ({stft_abs:.3e} abs), {ulp_distance(out['psd'], psd_p)}"
          f" ulp; bitwise the full band's columns (16 clips); clip_stats "
          f"params bitwise; image vs plain {disp_abs:.2e} "
          f"({bitwise_px:.6f} bitwise)")
    del img_ref, psd_p, full

    phase(f"path 13 times (CUDA events, median of {REPS} after a warm-up; "
          f"{card})")
    psd, params = out["psd"], stats.params
    del out
    timings = {
        "stft_kernel": time_ms(lambda: stft_cuda.stft_psd(
            x, BAND_FS, cfg, with_stats=True, band=band)),
        "stft_kernel_full_band": time_ms(lambda: stft_cuda.stft_psd(
            x, BAND_FS, cfg, with_stats=True)),
        "stft_gemm_kernel": time_ms(lambda: stft_cuda.stft_psd(
            x, BAND_FS, cfg, with_stats=True, band=band, _route="gemm")),
        "stft_plain": time_ms(lambda: stft_cuda.stft_psd_reference(
            x, consts, cfg, with_stats=True)),
        "stft_library": time_ms(lambda: library_psd(x, cfg, BAND_FS)[
            ..., band[0]:band[1]].contiguous()),
        "clip_stats_kernel_run": time_ms(lambda: disp.clip_stats(x, parts),
                                         run=RUN),
        "display_kernel_run": time_ms(lambda: disp.display_map(
            psd, params, log_scale=True, flip_image=True), run=RUN),
        "pipeline_kernel": time_ms(lambda: fn(x)),
    }
    for name, (ms, reps) in timings.items():
        print(f"{name}: {ms:.4f} ms [{card}] reps {reps}")
    bound = stft_bound(BAND_CLIPS, n, T, Fb, 1024)
    full_bound = stft_bound(BAND_CLIPS, n, T, cfg.n_freqs, 1024)
    print(f"STFT kernel (fft) on the band: {timings['stft_kernel'][0]:.3f} "
          f"ms, bound {bound[0]:.3f} ms ({bound[1]}); on the full band "
          f"{timings['stft_kernel_full_band'][0]:.3f} ms, bound "
          f"{full_bound[0]:.3f} ms; the GEMM kernel on the band's columns "
          f"{timings['stft_gemm_kernel'][0]:.3f} ms (its ceiling "
          f"{dense_dft_bound_ms(BAND_CLIPS, T, Fb, 1024):.3f} ms at the FP64 "
          f"peak, {4e3 * BAND_CLIPS * T * Fb * 1024 / dfma_peak:.3f} ms of "
          f"DFMA) [{card}]")
    disp_b = display_bound(BAND_CLIPS, T, Fb, T)
    print(f"display map on the band: "
          f"{timings['display_kernel_run'][0]:.4f} ms a launch in runs of "
          f"{RUN}, bound {disp_b[0]:.4f} ms ({disp_b[1]}) [{card}]")
    ms = timings["pipeline_kernel"][0]
    print(f"pipeline: {ms:.3f} ms per batch, "
          f"{BAND_CLIPS * BAND_SECONDS / 3600.0 / (ms / 60000.0):.1f} "
          f"audio-h/min [{card}]")
    print(json.dumps({"path13_times": {k: v[0] for k, v in
                                       timings.items()}, "card": card}))
    return {"stft_band": dict(
        launches=counts["stft_psd"]["fft"], err=stft_abs,
        ms=timings["stft_kernel"][0], plain_ms=timings["stft_plain"][0],
        bound=bound, library_ms=timings["stft_library"][0])}


# ---------------------------------------------------------------------------
# detection: the HMM kernels (H1-H3) and paths 14-15
# ---------------------------------------------------------------------------

HMM_PARAM_TOL = 1e-8    # fitted parameters, max |Δ| over each field's max
HMM_LL_TOL = 1e-10      # log-likelihoods, relative
HMM_STATS_TOL = 1e-9    # E-step statistics, max |Δ| over each group's max
FIT_CASES = (           # (T, D, K, variant, n_iter)
    (4, 2, 4, "init", 100), (5, 1, 4, "init", 100), (5, 2, 2, "init", 100),
    (600, 2, 4, "init", 100), (600, 1, 4, "init", 100),
    (600, 2, 2, "init", 50), (600, 2, 4, "zeros", 100),
    (600, 2, 4, "converged", 100), (600, 2, 4, "init", 1),
    (2047, 2, 4, "init", 8),
    (2047, 1, 2, "init", 8), (600, 2, 6, "init", 30))
VITERBI_T = (1, 2, 3, 600, 2047, 2048, 65536)
ESTEP_T = (2048, 8192, 524288)


def hmm_features(rng, T, D=2):
    """Detection-like features (T, D) float64: log-power about -6 with
    bursts about -3 (one per 200 frames, 3 to T/8 frames long), its delta
    second; D = 1 keeps the log-power alone."""
    import numpy as np
    logp = -6.0 + 0.15 * rng.randn(T)
    for _ in range(max(1, T // 200)):
        a = int(rng.randint(0, max(1, T - 3)))
        n = int(rng.randint(3, max(4, T // 8)))
        logp[a:a + n] = -3.0 + 0.2 * rng.randn(len(logp[a:a + n]))
    feats = np.stack([logp, np.diff(logp, prepend=logp[0])], axis=1)
    return feats[:, :D]


def field_err(got, want):
    """max |Δ| over max |want|, 0 for two zero fields."""
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    return diff / scale if scale else diff


def hmm_ptxas(log):
    return radix2_ptxas(
        log, r"(hmm_fit|hmm_viterbi|chunk_transfer|vit_scan|vit_decode|"
        r"vit_compose|vit_backtrace|est_scan|est_chunk|est_reduce)_kernel"
        r"(?:ILi(\d)E)?(?:Lb(\d)E)?",
        lambda e: e.group(1) + (f"<KM {e.group(2)}" + (
            f", LOGSUM {e.group(3)}" if e.group(3) else "") + ">"
            if e.group(2) else ""))


def hmm_params(feats, K, dev, variant):
    """A model to start EM from: the host initialization, or that with
    structural zeros (startprob [.5, .5, 0, ...], transmat[0, K-1] and
    transmat[K-1, 1] pinned at 0)."""
    import torch
    from spectral_tpu_torch.models import hmm
    p = hmm.init_params(feats, K, device=dev)
    if variant != "zeros":
        return p
    start = torch.zeros(K, dtype=torch.float64, device=dev)
    start[:2] = 0.5
    trans = p.transmat.clone()
    trans[0, K - 1] = 0.0
    trans[K - 1, 1] = 0.0
    trans = trans / trans.sum(dim=1, keepdim=True)
    return hmm.HMMParams(start, trans, p.means, p.covars)


def stack_params(ps):
    import torch
    from spectral_tpu_torch.models import hmm
    return hmm.HMMParams(*(torch.stack(f).contiguous() for f in zip(*ps)))


def hmm_kernel_cases(dev):
    """H1-H3 against their plain versions on the card, float64: iteration
    counts equal, fitted parameters within HMM_PARAM_TOL and
    log-likelihoods within HMM_LL_TOL relative (the same arithmetic,
    rounded alike but for the order of the frame sums), Viterbi paths
    identical, E-step statistics within HMM_STATS_TOL."""
    import numpy as np
    import torch
    from spectral_tpu_torch.core import events as ev
    from spectral_tpu_torch.models import hmm
    from spectral_tpu_torch.ops import hmm_cuda

    phase("the HMM kernels against their plain versions (float64)")
    for T, D, K, variant, n_iter in FIT_CASES:
        feats = [hmm_features(np.random.RandomState(100 * T + 10 * s + D),
                              T, D) for s in range(2)]
        X = torch.tensor(np.stack(feats), device=dev)
        p0 = stack_params([hmm_params(f, K, dev, variant) for f in feats])
        # "converged": a tolerance no gain reaches, so the convergence
        # test stops the loop at its first chance, it == 2 (the first
        # gain is against -inf); n_iter 1 stops it at it == 1
        tol = 1e30 if variant == "converged" else hmm.DEFAULT_TOL
        got, ll, it = hmm_cuda.fit_seq(X, p0, n_iter, tol)
        want, ll_p, it_p = hmm_cuda.fit_seq_reference(X, p0, n_iter, tol)
        torch.cuda.synchronize()
        errs = [field_err(g, w) for g, w in zip(got, want)]
        ll_rel = float(((ll - ll_p).abs() / ll_p.abs()).max())
        require(torch.equal(it, it_p) and max(errs) <= HMM_PARAM_TOL
                and ll_rel <= HMM_LL_TOL
                and bool((it == min(n_iter, 2)).all()
                         if variant == "converged" or n_iter == 1 else True),
                f"H1 T={T} D={D} K={K} {variant}: iterations {it.tolist()} "
                f"vs {it_p.tolist()}, params {errs}, ll {ll_rel:.2e}")
        if variant == "zeros":
            require(bool((got[1][:, 0, K - 1] == 0).all())
                    and bool((got[0][:, 2:] == 0).all()),
                    "H1 keeps structural zeros")
        print(f"H1 fit T={T} D={D} K={K} {variant}: iterations "
              f"{it.tolist()} (plain {it_p.tolist()}), params max rel "
              f"{max(errs):.2e}, ll rel {ll_rel:.2e}")

    # H2 on an EM-fitted model with the escape patch and on a supervised
    # model (1e-6 variances, structural zeros), at the main path's engine
    # boundaries and past them
    rng = np.random.RandomState(7)
    long = hmm_features(rng, max(VITERBI_T))
    fitted, _, _ = hmm_cuda.fit_seq(
        torch.tensor(long[None, :600], device=dev),
        stack_params([hmm.init_params(long[:600], 4, device=dev)]), 100,
        hmm.DEFAULT_TOL)
    fitted = hmm.HMMParams(*(f[0] for f in fitted))
    base = torch.argmin(fitted.means[:, 0])
    patched = fitted._replace(transmat=hmm.patch_escape_routes_traced(
        fitted.transmat, base))
    labels = ev.build_label_track(np.arange(600.0), [(100.0, 180.0),
                                                     (300.0, 420.0)])
    supervised = hmm.supervised_fit(long[:600], labels, 4, device=dev)
    models = stack_params([patched, supervised])
    for T in VITERBI_T:
        X = torch.tensor(np.stack([long[:T], long[-T:]]), device=dev)
        chunked = hmm_cuda.viterbi_chunked(X, models, hmm_cuda.chunk_len(4))
        chunked_p = hmm_cuda.viterbi_chunked_reference(
            X, models, hmm_cuda.chunk_len(4))
        same = torch.equal(chunked, chunked_p)
        line = f"H2 T={T}: chunked form vs plain identical {same}"
        if T <= 2048:
            seq = hmm_cuda.viterbi_seq(X, models)
            seq_p = hmm_cuda.viterbi_seq_reference(X, models)
            same = (same and torch.equal(seq, seq_p)
                    and torch.equal(seq, chunked))
            line += (f"; block a sequence vs plain identical "
                     f"{torch.equal(seq, seq_p)}, vs the chunked form "
                     f"{torch.equal(seq, chunked)}")
        require(same, line)
        print(line)

    # score on the card: H3's log-likelihood, against the plain forward
    Xs = torch.tensor(long[:2048], device=dev)
    got_ll = float(hmm.score(patched, Xs))
    want_ll = float(hmm._forward_b(stack_params([patched]), hmm._log_emission_b(
        stack_params([patched]), Xs[None]))[1][0])
    require(abs(got_ll - want_ll) <= HMM_LL_TOL * abs(want_ll),
            f"hmm.score on the card {got_ll} vs the plain forward {want_ll}")
    print(f"hmm.score on the card (H3) vs the plain forward pass, T=2048: "
          f"{abs(got_ll - want_ll) / abs(want_ll):.2e} relative")

    # six states: the instantiation for 5-8 states, chunks of 170 frames
    X6 = torch.tensor(long[None, :3000], device=dev)
    six, _, _ = hmm_cuda.fit_seq(
        X6[:, :600].contiguous(),
        stack_params([hmm.init_params(long[:600], 6, device=dev)]), 30,
        hmm.DEFAULT_TOL)
    L6 = hmm_cuda.chunk_len(6)
    seq6 = hmm_cuda.viterbi_seq(X6, six)
    same6 = (torch.equal(seq6, hmm_cuda.viterbi_seq_reference(X6, six))
             and torch.equal(hmm_cuda.viterbi_chunked(X6, six, L6), seq6)
             and torch.equal(hmm_cuda.viterbi_chunked_reference(X6, six, L6),
                             seq6))
    st6, ll6 = hmm_cuda.estep_chunked(X6, six, L6)
    st6_p, ll6_p = hmm_cuda.estep_chunked_reference(X6, six, L6)
    err6 = max(field_err(g, w) for g, w in zip(
        hmm_cuda.split_stats(st6, 6, 2), hmm_cuda.split_stats(st6_p, 6, 2)))
    ll6_rel = float((ll6 - ll6_p).abs().max() / ll6_p.abs().max())
    require(same6 and err6 <= HMM_STATS_TOL and ll6_rel <= HMM_LL_TOL,
            f"K=6 T=3000: paths identical {same6}, H3 statistics {err6:.2e},"
            f" ll {ll6_rel:.2e}")
    print(f"K=6 T=3000 (chunks of {L6}): H2 both forms identical to the "
          f"plain versions; H3 statistics max rel {err6:.2e}, ll rel "
          f"{ll6_rel:.2e}")

    for T in ESTEP_T:
        X = torch.tensor(hmm_features(np.random.RandomState(T), T)[None],
                         device=dev)
        p = stack_params([fitted])
        L = hmm_cuda.chunk_len(4)
        st, ll = hmm_cuda.estep_chunked(X, p, L)
        st_p, ll_p = hmm_cuda.estep_chunked_reference(X, p, L)
        torch.cuda.synchronize()
        errs = [field_err(g, w) for g, w in zip(
            hmm_cuda.split_stats(st, 4, 2), hmm_cuda.split_stats(st_p, 4, 2))]
        ll_rel = float(((ll - ll_p).abs() / ll_p.abs()).max())
        require(max(errs) <= HMM_STATS_TOL and ll_rel <= HMM_LL_TOL,
                f"H3 T={T}: statistics {errs}, ll {ll_rel:.2e}")
        print(f"H3 E-step T={T}: statistics max rel {max(errs):.2e}, ll "
              f"{float(ll[0]):.6f} rel {ll_rel:.2e}")


def hmm_fit_ops(T, D, K, iters):
    """Float64 operations of iters E-steps on T frames, an exp or a log
    counted as one (a lower bound): emissions 5KD a frame, the forward
    and backward steps K(3K + 3) each, gamma 3K, the moments 5KD, xi
    6K^2 (308 a frame at K = 4, D = 2). The sequential E-step's own work:
    what a chunked form adds (transfers from K one-hot starts, a second
    emission pass) is its overhead, not the function's."""
    return iters * T * (10 * K * D + 2 * K * (3 * K + 3) + 3 * K
                        + 6 * K * K)


def hmm_viterbi_ops(T, D, K):
    """Float64 operations of one Viterbi decode on T frames: emissions
    5KD a frame, the max-plus step's K^2 additions and K^2 comparisons."""
    return T * (5 * K * D + 2 * K * K)


def hmm_bound(bytes_, ops, rate):
    """The HMM kernels' bound: ops at ``rate``, the card's float64 rate
    outside the tensor cores (their exps, logs, maxima and sums are
    scalar work), beside bytes at HBM_RATE."""
    t_mem, t_ops = bytes_ / HBM_RATE, ops / rate
    return (1e3 * max(t_mem, t_ops),
            "operations" if t_ops >= t_mem else "bytes")


EEG_FS = 1000.0
EEG_SECONDS = 960.0     # 16 min sweeps at 1 kHz, path 13's shape
EEG_CLIPS = 256
DETECT_CHECK = 8        # sweeps whose event lists meet the plain versions'


def planted_bursts(rng, seconds, lo_hz, hi_hz):
    """A clip's bursts: (start s, length s, Hz, dB above the band's noise
    floor), lengths 2-20 s, 6-12 dB, gaps 20-150 s."""
    out = []
    t = rng.uniform(10.0, 60.0)
    while t < seconds - 30.0:
        n = rng.uniform(2.0, 20.0)
        out.append((t, n, rng.uniform(lo_hz, hi_hz), rng.uniform(6.0, 12.0)))
        t += n + rng.uniform(20.0, 150.0)
    return out


def bursty_batch(dev, clips, n, fs, band_hz, lo_hz, hi_hz, seed):
    """Unit white noise on the card with tone bursts planted at seeded
    times, each 6-12 dB above the noise's power in [0, band_hz] (a Tukey
    envelope, 10% tapers): (x (clips, n) float32, plans)."""
    import numpy as np
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((clips, n), generator=gen, device=dev)
    rng = np.random.RandomState(seed)
    floor = band_hz / (fs / 2.0)
    plans = []
    for c in range(clips):
        plan = planted_bursts(rng, n / fs, lo_hz, hi_hz)
        plans.append(plan)
        for start, length, hz, db in plan:
            i0, m = int(start * fs), int(length * fs)
            amp = math.sqrt(2.0 * (10.0 ** (db / 10.0) - 1.0) * floor)
            r = np.linspace(0.0, 1.0, m)
            env = np.clip(np.minimum(r, 1.0 - r) / 0.05, 0.0, 1.0)
            tone = amp * env * np.sin(2.0 * np.pi * hz * np.arange(m) / fs)
            x[c, i0:i0 + m] += torch.tensor(tone, dtype=torch.float32,
                                            device=dev)
    return x, plans


DETECT_RECALL = 0.9     # burst frames decoded to a loud state, at least
DETECT_FALSE = 0.05     # other frames decoded to a loud state, at most
DETECT_HIT = 0.95       # planted bursts with a loud frame, at least


def detection_quality(t, states, means, plans, events):
    """What the decode found of the planted bursts, pooled over sequences.

    A state is loud when its mean log-power lies above the midpoint of the
    model's lowest and highest; a frame lies in a burst when its time
    does. Returns the share of burst frames decoded to a loud state
    (recall), the share of the other frames decoded so (false), the share
    of bursts with a loud frame, and the shares of burst and other frames
    inside an event. The events are runs of non-baseline states
    (baseline_scan, the reference's semantics): the 4-state fit splits
    the noise floor, so they cover most noise frames too and say little
    of detection; the loud states do."""
    import numpy as np
    burst, other, ev_burst, ev_other = [], [], [], []
    hits = []
    for b, plan in enumerate(plans):
        mu = means[b, :, 0]
        loud = (mu > 0.5 * (mu.min() + mu.max()))[states[b]]
        inb = np.zeros(len(t), bool)
        for a, m, _, _ in plan:
            span = (t >= a) & (t <= a + m)
            inb |= span
            hits.append(bool(loud[span].any()))
        inev = np.zeros(len(t), bool)
        for s, e in events[b]:
            inev |= (t >= s) & (t <= e)
        burst.append(loud[inb])
        other.append(loud[~inb])
        ev_burst.append(inev[inb])
        ev_other.append(inev[~inb])
    return tuple(float(np.concatenate(v).mean()) for v in (
        burst, other, [np.array(hits)], ev_burst, ev_other))


def check_detection(what, q):
    recall, false, hit, ev_b, ev_o = q
    line = (f"{what}: burst frames decoded to a loud state {recall:.4f} (at "
            f"least {DETECT_RECALL}), other frames {false:.4f} (at most "
            f"{DETECT_FALSE}), bursts with a loud frame {hit:.4f} (at least "
            f"{DETECT_HIT}); inside an event: burst frames {ev_b:.4f}, other "
            f"frames {ev_o:.4f}")
    require(recall >= DETECT_RECALL and false <= DETECT_FALSE
            and hit >= DETECT_HIT, line)
    print(line)


def detect_path(dev, card, dfma_peak):
    """Path 14, fleet detection (the CLI's ``detect --each --batched``
    flow, spectral_tpu/cli.py:139-204): path 13's EEG batch with planted
    bursts -> the STFT kernel on the 0-30 Hz band -> features_from_psd ->
    batch_unsupervised_detect (host k-means, H1, the patch, H2, host
    scans), n_states 4, n_iter 100."""
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core import events as ev
    from spectral_tpu_torch.core.stft import (band_row_slice, freq_axis,
                                              power_spectrogram, time_axis)
    from spectral_tpu_torch.models import batch, hmm
    from spectral_tpu_torch.ops import hmm_cuda, stft_cuda

    n = int(EEG_FS * EEG_SECONDS)
    cfg = SpecConfig.scipy_default(1024)
    f = freq_axis(cfg, EEG_FS)
    t = time_axis(cfg, EEG_FS, n)
    band = band_row_slice(f, 0.0, 30.0)
    fb = f[band[0]:band[1]]
    phase(f"path 14, fleet detection: {EEG_CLIPS} sweeps x {EEG_SECONDS:g} s "
          f"at {EEG_FS:g} Hz, scipy_default 1024 ({len(t)} frames), features "
          f"0-30 Hz (bins {band[0]}-{band[1] - 1}), 4 states, n_iter 100")
    x, plans = bursty_batch(dev, EEG_CLIPS, n, EEG_FS, 30.0, 3.0, 25.0, 14)
    torch.cuda.synchronize()
    timings = {}
    reset_counts()
    t0 = time.perf_counter()
    psd = power_spectrogram(x, EEG_FS, cfg, band=band)
    feats = ev.features_from_psd(fb, psd, 0.0, 30.0)
    events = batch.batch_unsupervised_detect(t, feats, device=dev,
                                             timings=timings)
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"launches in this path's run: {counts}")
    require_counts(counts, {"stft_fft": 1, "hmm_fit": 1, "hmm_viterbi": 1},
                   "path 14")
    T = len(t)
    require(tuple(feats.shape) == (EEG_CLIPS, T, 2)
            and feats.dtype == torch.float32
            and bool(torch.isfinite(feats).all()), "path 14 features")
    full = stft_cuda.stft_psd(x[:16], EEG_FS, cfg)
    require(torch.equal(ev.features_from_psd(f, full, 0.0, 30.0),
                        feats[:16]),
            "features of the band's bins bitwise the full axis' mask")
    print(f"{sum(map(len, plans))} bursts planted, {sum(map(len, events))} "
          f"events found")

    # the kernels and their plain versions on the whole batch, the same
    # initial models
    feats_np = feats.cpu().numpy()
    p0 = stack_params([hmm.init_params(feats_np[b], 4, device=dev)
                       for b in range(EEG_CLIPS)])
    X = feats.to(torch.float64).contiguous()
    t1 = time.perf_counter()
    fit_p, ll_p, it_p = hmm_cuda.fit_seq_reference(X, p0, 100,
                                                   hmm.DEFAULT_TOL)
    torch.cuda.synchronize()
    fit_plain_ms = 1e3 * (time.perf_counter() - t1)
    fit_k, ll_k, it_k = hmm_cuda.fit_seq(X, p0, 100, hmm.DEFAULT_TOL)
    torch.cuda.synchronize()
    errs = [field_err(g, w) for g, w in zip(fit_k, fit_p)]
    fit_abs = max(float((g - w).abs().max()) for g, w in zip(fit_k, fit_p))
    require(torch.equal(it_k, it_p) and max(errs) <= HMM_PARAM_TOL,
            f"path 14 H1 vs plain: iterations equal {torch.equal(it_k, it_p)}"
            f", params {errs}")
    fitted = hmm.HMMParams(*fit_k)
    base = torch.argmin(fitted.means[..., 0], dim=-1)
    patched = stack_params([fitted._replace(
        transmat=hmm.patch_escape_routes_traced(fitted.transmat, base))])
    patched = hmm.HMMParams(*(f[0] for f in patched))
    states_k = hmm_cuda.viterbi_seq(X, patched)
    t1 = time.perf_counter()
    states_p = hmm_cuda.viterbi_seq_reference(X, patched)
    torch.cuda.synchronize()
    vit_plain_ms = 1e3 * (time.perf_counter() - t1)
    vit_err = float((states_k.long() - states_p.long()).abs().max())
    vit_diff = int((states_k != states_p).sum())
    L = hmm_cuda.chunk_len(4)
    states_c = hmm_cuda.viterbi_chunked(X, patched, L)
    require(vit_diff == 0 and torch.equal(states_c, states_k),
            f"path 14 H2 vs plain: {vit_diff} of {states_p.numel()} states "
            f"differ; the chunked form equal "
            f"{torch.equal(states_c, states_k)}")
    sp = states_p.cpu().numpy()
    ev_plain = [ev.merge_overlapping_events(ev.baseline_scan(
        sp[b], t, int(base[b]))) for b in range(DETECT_CHECK)]
    require(ev_plain == events[:DETECT_CHECK],
            "path 14 event lists vs the plain versions' (first 8 sweeps)")
    check_detection(f"path 14, all {EEG_CLIPS} sweeps", detection_quality(
        t, states_k.cpu().numpy(), fitted.means.cpu().numpy(), plans,
        events))
    its = it_k.cpu().numpy()
    print(f"H1 vs plain (all {EEG_CLIPS} sweeps): iterations equal, params "
          f"max rel {max(errs):.2e} ({fit_abs:.2e} abs); H2 paths identical "
          f"({vit_diff} of {states_p.numel()} states differ; the chunked form"
          f" identical too); event lists of the first {DETECT_CHECK} sweeps "
          f"identical; EM iterations min {its.min()} median "
          f"{int(np.median(its))} max {its.max()}")

    phase(f"path 14 times (CUDA events, median of {REPS} after a warm-up; "
          f"{card})")
    tm = {
        "stft_kernel": time_ms(lambda: stft_cuda.stft_psd(
            x, EEG_FS, cfg, band=band)),
        "features": time_ms(lambda: ev.features_from_psd(fb, psd, 0.0,
                                                         30.0)),
        "fit_kernel": time_ms(lambda: hmm_cuda.fit_seq(
            X, p0, 100, hmm.DEFAULT_TOL), reps=3),
        "viterbi_kernel": time_ms(lambda: hmm_cuda.viterbi_seq(X, patched)),
        "viterbi_chunked_kernel": time_ms(lambda: hmm_cuda.viterbi_chunked(
            X, patched, L)),
        "fit_plain": (fit_plain_ms, [fit_plain_ms]),
        "viterbi_plain": (vit_plain_ms, [vit_plain_ms]),
    }
    for name, (ms, reps) in tm.items():
        print(f"{name}: {ms:.4f} ms [{card}] reps {reps}")
    steps = int(its.max()) * (T - 1)
    print(f"host: init (k-means, {EEG_CLIPS} sweeps) {timings['init']:.3f} s,"
          f" fit + patch + Viterbi + states read {timings['fit']:.3f} s, "
          f"scans {1e3 * timings['scan']:.3f} ms; the flow's wall time "
          f"{wall:.3f} s, {EEG_CLIPS * EEG_SECONDS / 3600.0 / (wall / 60.0):.2f}"
          f" audio-h/min [{card}]")
    print(f"H1's chain: {its.max()} iterations x {T - 1} steps = {steps} "
          f"steps a pass on its slowest sweep, "
          f"{1e6 * tm['fit_kernel'][0] / steps:.1f} ns a step")
    fit_bound = hmm_bound(X.numel() * 8 + EEG_CLIPS * (4 + 16 + 16) * 8,
                          sum(hmm_fit_ops(T, 2, 4, int(i)) for i in its),
                          dfma_peak)
    vit_bound = hmm_bound(X.numel() * 8 + EEG_CLIPS * T * 4,
                          EEG_CLIPS * hmm_viterbi_ops(T, 2, 4), dfma_peak)
    print(f"bounds: H1 {fit_bound[0]:.4f} ms ({fit_bound[1]}), H2 "
          f"{vit_bound[0]:.4f} ms ({vit_bound[1]})")
    print(json.dumps({"path14_times": {k: v[0] for k, v in tm.items()},
                      "host_s": timings, "wall_s": wall,
                      "iterations": [int(its.min()), int(np.median(its)),
                                     int(its.max())], "card": card}))
    return {
        "hmm_fit": dict(launches=counts["hmm"]["fit"], err=fit_abs,
                        ms=tm["fit_kernel"][0], plain_ms=fit_plain_ms,
                        bound=fit_bound, library_ms=None),
        "hmm_viterbi": dict(launches=counts["hmm"]["viterbi"], err=vit_err,
                            ms=tm["viterbi_kernel"][0],
                            plain_ms=vit_plain_ms, bound=vit_bound,
                            library_ms=None)}


LONG_FS = 48000.0
LONG_T = 524288         # frames: an hour of 48 kHz audio at hop 256


def long_detect_path(dev, card, dfma_peak):
    """Path 15, one long recording: BurstDetector(engine='auto') on 524,288
    frames (48 kHz, north_star 1024/256, 134,218,496 samples), features
    0-4000 Hz: the chunked engine (the host EM loop over H3, then H2's
    chunked form)."""
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core import events as ev
    from spectral_tpu_torch.core.stft import (band_row_slice, freq_axis,
                                              power_spectrogram, time_axis)
    from spectral_tpu_torch.models import hmm, hmm_pscan
    from spectral_tpu_torch.models.detector import BurstDetector
    from spectral_tpu_torch.ops import hmm_cuda, stft_cuda

    cfg = SpecConfig.north_star(1024, 256)
    n = cfg.hop_ * (LONG_T - 1) + cfg.nperseg
    f = freq_axis(cfg, LONG_FS)
    t = time_axis(cfg, LONG_FS, n)
    band = band_row_slice(f, 0.0, 4000.0)
    fb = f[band[0]:band[1]]
    phase(f"path 15, one long recording: {n} samples at {LONG_FS:g} Hz, "
          f"north_star 1024/256 ({len(t)} frames), features 0-4000 Hz (bins "
          f"{band[0]}-{band[1] - 1}), BurstDetector(engine='auto')")
    require(len(t) == LONG_T, f"path 15 frames {len(t)}")
    x, plan = bursty_batch(dev, 1, n, LONG_FS, 4000.0, 200.0, 3000.0, 15)
    torch.cuda.synchronize()
    det = BurstDetector(engine="auto", device=dev)
    reset_counts()
    t0 = time.perf_counter()
    psd = power_spectrogram(x, LONG_FS, cfg, band=band)
    feats = ev.features_from_psd(fb, psd, 0.0, 4000.0)[0]
    events = det.unsupervised_detect(t, feats)
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"launches in this path's run: {counts}")
    iters = det.timings["iterations"]
    require_counts(counts, {"stft_fft": 1, "hmm_estep_chunked": iters,
                            "hmm_viterbi_chunked": 1}, "path 15")
    require(iters >= 1 and len(events) >= 1, f"path 15: {iters} "
            f"iterations, {len(events)} events")
    X = feats.to(torch.float64)[None].contiguous()
    patched = hmm.HMMParams(*(p[None].contiguous() for p in det.params))
    L = hmm_cuda.chunk_len(4)
    states_k = hmm_cuda.viterbi_chunked(X, patched, L)
    states_p = hmm_cuda.viterbi_chunked_reference(X, patched, L)
    vit_err = float((states_k.long() - states_p.long()).abs().max())
    vit_diff = int((states_k != states_p).sum())
    states_b = hmm_cuda.viterbi_seq(X, patched)
    require(vit_diff == 0 and torch.equal(states_b, states_k),
            f"path 15 Viterbi vs plain: {vit_diff} of {LONG_T} states "
            f"differ; the block form equal {torch.equal(states_b, states_k)}")
    check_detection(f"path 15, {len(plan[0])} bursts planted, {len(events)} "
                    f"events", detection_quality(
                        t, states_k.cpu().numpy(),
                        patched.means.cpu().numpy(), plan, [events]))
    st, ll = hmm_cuda.estep_chunked(X, patched, L)
    st_p, ll_p = hmm_cuda.estep_chunked_reference(X, patched, L)
    ll_rel = float((ll - ll_p).abs().max() / ll_p.abs().max())
    st_abs = float((st - st_p).abs().max())
    errs = [field_err(g, w) for g, w in zip(
        hmm_cuda.split_stats(st, 4, 2), hmm_cuda.split_stats(st_p, 4, 2))]
    require(ll_rel <= HMM_LL_TOL and max(errs) <= HMM_STATS_TOL,
            f"path 15 H3 vs plain: ll {ll_rel:.2e}, statistics {errs}")
    print(f"{iters} EM iterations; Viterbi vs plain: all {LONG_T} frames "
          f"identical (the block form too); H3 vs plain at the fitted model: ll {float(ll[0]):.6f} "
          f"rel {ll_rel:.2e}, statistics max rel {max(errs):.2e}")

    phase(f"path 15 times (CUDA events, median of {REPS} after a warm-up; "
          f"{card})")
    tiny = torch.zeros(1, dtype=torch.bool, device=dev)

    def read():
        bool(tiny.any())

    tm = {
        "stft_kernel": time_ms(lambda: stft_cuda.stft_psd(
            x, LONG_FS, cfg, band=band)),
        "estep_kernel": time_ms(lambda: hmm_cuda.estep_chunked(
            X, patched, L)),
        "estep_plain": time_ms(lambda: hmm_cuda.estep_chunked_reference(
            X, patched, L), reps=1),
        "viterbi_kernel": time_ms(lambda: hmm_cuda.viterbi_chunked(
            X, patched, L)),
        "viterbi_plain": time_ms(lambda: hmm_cuda.viterbi_chunked_reference(
            X, patched, L), reps=1),
        "viterbi_block_kernel": time_ms(lambda: hmm_cuda.viterbi_seq(
            X, patched)),
    }
    t1 = time.perf_counter()
    for _ in range(100):
        read()
    read_ms = 1e3 * (time.perf_counter() - t1) / 100
    for name, (ms, reps) in tm.items():
        print(f"{name}: {ms:.4f} ms [{card}] reps {reps}")
    fit_s = det.timings["fit"]
    print(f"host: init (k-means) {det.timings['init']:.3f} s, the EM loop + "
          f"patch + Viterbi + states read {fit_s:.3f} s "
          f"({1e3 * fit_s / iters:.3f} ms an iteration beside H3's "
          f"{tm['estep_kernel'][0]:.3f} ms; "
          f"a device-to-host read of the continue flag {read_ms:.4f} ms), "
          f"scans {1e3 * det.timings['scan']:.3f} ms; the call's wall time "
          f"{wall:.3f} s [{card}]")
    est_bound = hmm_bound(X.numel() * 8 + 8 * (2 * 4 + 2 * 8 + 16 + 1),
                          hmm_fit_ops(LONG_T, 2, 4, 1), dfma_peak)
    vit_bound = hmm_bound(X.numel() * 8 + LONG_T * 4,
                          hmm_viterbi_ops(LONG_T, 2, 4), dfma_peak)
    print(f"bounds: H3 {est_bound[0]:.4f} ms ({est_bound[1]}), H2 chunked "
          f"{vit_bound[0]:.4f} ms ({vit_bound[1]})")
    print(json.dumps({"path15_times": {k: v[0] for k, v in tm.items()},
                      "host": det.timings, "read_ms": read_ms,
                      "wall_s": wall, "card": card}))
    return {
        "hmm_estep_chunked": dict(
            launches=counts["hmm"]["estep_chunked"], err=st_abs,
            ms=tm["estep_kernel"][0], plain_ms=tm["estep_plain"][0],
            bound=est_bound, library_ms=None),
        "hmm_viterbi_chunked": dict(
            launches=counts["hmm"]["viterbi_chunked"], err=vit_err,
            ms=tm["viterbi_kernel"][0], plain_ms=tm["viterbi_plain"][0],
            bound=vit_bound, library_ms=None)}


PHASES = ("kernels", "tail", "dc", "scipy", "band", "mel", "path1", "path2",
          "path3", "path4", "path5", "path6", "path7", "path8", "path9",
          "path10", "path11", "path12", "path13", "hmm", "path14", "path15")


def main(_phases=None):
    """Every phase, then the kernels line and the contract line; with
    ``_phases`` (a subset of PHASES) the build and those phases only,
    and no result line."""
    import dataclasses
    import torch
    from spectral_tpu_torch import SpecConfig
    t_start = time.perf_counter()
    phases = set(PHASES if _phases is None else _phases)
    require(phases <= set(PHASES), f"phases {sorted(phases)} of {PHASES}")
    card, dfma_peak = toolchain()
    dev = torch.device("cuda", 0)
    build_kernels()
    if "kernels" in phases:
        kernel_cases(dev)
        odd_kernel_cases(dev, R2_CASES, edges=R2_CASES,
                         title="the radix-2 route", seed=9, forced=())
        odd_kernel_cases(dev)
        odd_kernel_cases(dev, MIXED_RADER_CASES, edges=(1006, 8186),
                         title="the mixed route's Rader plans", seed=10,
                         forced=((1006, "gemm"),))
        odd_kernel_cases(dev, GEMM_CASES, edges=(2, 13, 24, 31),
                         title="the GEMM route's small-K tile", seed=11,
                         forced=(), hop_of=lambda k: max(1, k // 4),
                         wide=True)
        odd_kernel_cases(
            dev, BLUESTEIN_CASES, edges=(2049, 8182, 8185),
            title="the Bluestein route", seed=8,
            forced=((2049, "gemm"), (1024, "bluestein"), (8032, "bluestein"),
                    (8191, "bluestein"), (33, "bluestein")))
    if "tail" in phases:
        tail_cases(dev)
    if "dc" in phases:
        dc_check(dev)
    if "scipy" in phases:
        scipy_checks(dev, card)
    if "band" in phases:
        band_kernel_cases(dev)
        repair_cases(dev)
    if "mel" in phases:
        mel_kernel_cases(dev)
    rows = {}
    if "path1" in phases:
        rows.update(main_path(dev, card))
        torch.cuda.empty_cache()
    if "path2" in phases:
        rows["stft_8192"] = long_path(
            dev, card, dfma_peak,
            SpecConfig.scipy_default(8192, log_scale=True), "path 2")
        torch.cuda.empty_cache()
    if "path3" in phases:
        rows.update(export_path(dev, card))
        torch.cuda.empty_cache()
    s8160 = SpecConfig.scipy_default(MIXED_NPERSEG, log_scale=True)
    for name, key, label, cfg in (
            ("path4", "stft_mixed_8160", "path 4, the mixed-radix route",
             s8160),
            ("path5", "stft_mixed_8032",
             "path 5, the mixed-radix route's largest prime",
             SpecConfig.scipy_default(PRIME_NPERSEG, log_scale=True)),
            ("path6", "stft_mixed_8160_linear",
             "path 6, linear detrend on the mixed-radix route",
             dataclasses.replace(s8160, detrend="linear")),
            ("path7", "stft_odd",
             "path 7, the odd route with a Rader stage",
             SpecConfig.scipy_default(ODD_NPERSEG, log_scale=True)),
            ("path8", "stft_bluestein_cluster",
             "path 8, the Bluestein route on a cluster of two blocks",
             SpecConfig.scipy_default(BLUESTEIN_NPERSEG, log_scale=True)),
            ("path9", "stft_bluestein",
             "path 9, the Bluestein route on one block",
             SpecConfig.scipy_default(BLUESTEIN_EVEN_NPERSEG,
                                      log_scale=True))):
        if name in phases:
            rows[key] = long_path(dev, card, dfma_peak, cfg, label)
            torch.cuda.empty_cache()
    if "path10" in phases:
        rows["stft_gemm"] = long_path(
            dev, card, dfma_peak,
            SpecConfig.scipy_default(GEMM_NPERSEG, log_scale=True),
            "path 10, the GEMM route", clips=BATCH, seconds=CLIP_SECONDS)
        torch.cuda.empty_cache()
    if "path11" in phases:
        rows["stft_mixed_rader"] = long_path(
            dev, card, dfma_peak,
            SpecConfig.scipy_default(RADER_NPERSEG, log_scale=True),
            "path 11, the mixed route's Rader plan")
        torch.cuda.empty_cache()
    if "path12" in phases:
        rows.update(mel_path(dev, card))
        torch.cuda.empty_cache()
    if "path13" in phases:
        rows.update(band_path(dev, card, dfma_peak))
        torch.cuda.empty_cache()
    if "hmm" in phases:
        hmm_kernel_cases(dev)
        torch.cuda.empty_cache()
    if "path14" in phases:
        rows.update(detect_path(dev, card, dfma_peak))
        torch.cuda.empty_cache()
    if "path15" in phases:
        rows.update(long_detect_path(dev, card, dfma_peak))
        torch.cuda.empty_cache()
    if _phases is not None:
        print(f"chip_smoke phases {sorted(phases)} passed in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0
    print(f"the FFT kernel's launches: path 1 {rows['stft_1024']['launches']}"
          f", path 2 {rows['stft_8192']['launches']}, path 3 "
          f"{rows['stft_export_launches']}; the mixed-radix kernel's: path 4 "
          f"{rows['stft_mixed_8160']['launches']}, path 5 "
          f"{rows['stft_mixed_8032']['launches']}, path 6 "
          f"{rows['stft_mixed_8160_linear']['launches']}; the odd kernel's: "
          f"path 7 {rows['stft_odd']['launches']}; the Bluestein kernel's: "
          f"path 8 {rows['stft_bluestein_cluster']['launches']}, path 9 "
          f"{rows['stft_bluestein']['launches']}; the GEMM kernel's: path 10 "
          f"{rows['stft_gemm']['launches']}; the mixed route's Rader plan's "
          f"(the odd kernel's PACKED form): path 11 "
          f"{rows['stft_mixed_rader']['launches']}; the mel kernel's: path "
          f"12 {rows['mel_project']['launches']}; the FFT kernel on the "
          f"band: path 13 {rows['stft_band']['launches']}; the HMM kernels': "
          f"path 14 fit {rows['hmm_fit']['launches']}, Viterbi "
          f"{rows['hmm_viterbi']['launches']}; path 15 chunked E-step "
          f"{rows['hmm_estep_chunked']['launches']}, chunked Viterbi "
          f"{rows['hmm_viterbi_chunked']['launches']}")
    src = "spectral_tpu_torch/ops/csrc/stft_psd.cu"
    tail_src = "spectral_tpu_torch/ops/csrc/display.cu"
    mel_src = "spectral_tpu_torch/ops/csrc/mel.cu"
    hmm_src = "spectral_tpu_torch/ops/csrc/hmm.cu"
    # each row names the instantiation its path launches
    meta = {
        "stft_1024": ("stft_fft_psd<LOG2M 9, 8 values>, nperseg 1024 "
                      "(path 1)", "cuda", src,
                      "spectral_tpu/ops/stft_pallas.py:217"),
        "stft_8192": ("stft_fft_psd<LOG2M 12, 16 values>, nperseg 8192 "
                      "(path 2)", "cuda", src,
                      "spectral_tpu/ops/stft_pallas.py:367"),
        "stft_mixed_8160": (
            f"stft_mixed_fft_psd<RMAX 4>, nperseg {MIXED_NPERSEG} (path 4)",
            "cuda", src, "spectral_tpu/ops/stft_pallas.py:367"),
        "stft_mixed_8032": (
            f"stft_mixed_fft_psd<RMAX 8>, nperseg {PRIME_NPERSEG} (path 5)",
            "cuda", src, "spectral_tpu/ops/stft_pallas.py:367"),
        "stft_mixed_8160_linear": (
            f"stft_mixed_fft_psd<RMAX 4>, nperseg {MIXED_NPERSEG} linear "
            "detrend (path 6)", "cuda", src,
            "spectral_tpu/ops/stft_pallas.py:367"),
        "stft_odd": (f"stft_odd_fft_psd<RADER 1, RMAX 4>, nperseg "
                     f"{ODD_NPERSEG} (path 7)", "cuda", src,
                     "spectral_tpu/ops/stft_pallas.py:367"),
        "stft_bluestein_cluster": (
            f"stft_bluestein_psd<RANKS 2> on a cluster of two blocks, "
            f"nperseg {BLUESTEIN_NPERSEG} (path 8)", "cuda", src,
            "spectral_tpu/ops/stft_pallas.py:367"),
        "stft_bluestein": (
            f"stft_bluestein_psd<RANKS 1> on one block, nperseg "
            f"{BLUESTEIN_EVEN_NPERSEG} (path 9)", "cuda", src,
            "spectral_tpu/ops/stft_pallas.py:367"),
        "stft_gemm": (f"stft_psd GEMM, small-K tile (stft_psd_small), "
                      f"nperseg {GEMM_NPERSEG} (path 10)", "cuda", src,
                      "spectral_tpu/ops/stft_pallas.py:217"),
        "stft_mixed_rader": (
            f"stft_odd_fft_psd<RADER 1, RMAX 1, PACKED>, the mixed route's "
            f"Rader plan, nperseg {RADER_NPERSEG} (path 11)", "cuda", src,
            "spectral_tpu/ops/stft_pallas.py:367"),
        "stft_band": ("stft_fft_psd<LOG2M 9, 8 values>, nperseg 1024, the "
                      "band 0-30 Hz, 31 of 513 bins (path 13)", "cuda", src,
                      "spectral_tpu/ops/stft_pallas.py:217"),
        "mel_project": ("mel_project, 128 mels over 513 bins (path 12)",
                        "cuda", mel_src,
                        "spectral_tpu/parallel/sharding.py:99 (an XLA "
                        "einsum; no TPU kernel)"),
        "display_rgba": ("display_map<RGBA, LOG>, RGBA words and the "
                         "image (path 1)", "cuda", tail_src,
                         "spectral_tpu/ops/stft_pallas.py:456"),
        "display_palette": ("display_map<PALETTE, LOG>, palette words, no "
                            "image (path 3)", "cuda", tail_src,
                            "spectral_tpu/ops/stft_pallas.py:456"),
        "clip_stats": ("clip_stats, finite flag and per-clip extrema "
                       "(path 1)", "cuda", tail_src,
                       "spectral_tpu/ops/stft_pallas.py:486"),
        "hmm_fit": ("hmm_fit<KM 4>, Baum-Welch a block a sequence, "
                    f"{EEG_CLIPS} sweeps x 1071 frames (path 14)", "cuda",
                    hmm_src, "spectral_tpu/models/hmm.py:188 (_em_loop, an "
                    "XLA lax.while_loop; no TPU kernel)"),
        "hmm_viterbi": ("hmm_viterbi<KM 4>, a block a sequence, "
                        f"{EEG_CLIPS} sweeps x 1071 frames (path 14)", "cuda",
                        hmm_src, "spectral_tpu/models/hmm.py:104 (viterbi, "
                        "an XLA lax.scan; no TPU kernel)"),
        "hmm_estep_chunked": (
            f"hmm_estep_chunked<KM 4>, one E-step, {LONG_T} frames in "
            "chunks of 256 (path 15)", "cuda", hmm_src,
            "spectral_tpu/models/hmm_pscan.py:289 (e_step, an XLA "
            "associative scan; no TPU kernel)"),
        "hmm_viterbi_chunked": (
            f"hmm_viterbi_chunked<KM 4>, {LONG_T} frames in chunks of 256 "
            "(path 15)", "cuda", hmm_src,
            "spectral_tpu/models/hmm_pscan.py:322 (viterbi, an XLA "
            "associative scan; no TPU kernel)"),
    }
    kernels = []
    for key, (name, route, source, replaces) in meta.items():
        r = rows[key]
        require(r["launches"] >= 1, f"{name}: no launch on its path")
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": r["launches"],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r.get("library_ms")})
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
