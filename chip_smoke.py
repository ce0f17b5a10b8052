#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (spectral_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and triton; run it from the root of a checkout.
It builds every kernel of the port's paths from the sources in the
checkout and holds each kernel against its plain PyTorch version on the
card: the STFT/PSD kernel's five routes (the FFT kernel at power-of-two
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
display kernel in both output modes, with and without the float image.
Then it drives eleven paths at full size, each with the launch counts set
to 0 just before it and read just after:

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
    kernel's PACKED form.

It checks images against scipy in float64 (limit 1e-3 dB), the oracle in
``tools/torch_precision.py``, and times kernel, plain and library paths
with CUDA events (also scipy_default 1024, 992, 2049 and 8186, the
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


def library_psd(x, cfg):
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
    wts = torch.tensor(onesided_weights(cfg, FS), dtype=torch.float64,
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


def time_ms(fn, reps=REPS):
    """Median of reps CUDA-event timings after one warm-up, in ms."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        del out
    return sorted(times)[reps // 2], times


def reset_counts():
    from spectral_tpu_torch.ops import display_triton, stft_cuda
    for counts in (stft_cuda.launches, display_triton.launches):
        for key in counts:
            counts[key] = 0


def read_counts():
    from spectral_tpu_torch.ops import display_triton, stft_cuda
    return {"stft_psd": dict(stft_cuda.launches),
            "display_epilogue": dict(display_triton.launches)}


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
    # Triton's kernel cache goes into the checkout's build directory
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(HERE, "build", "triton"))
    import spectral_tpu_torch
    pkg = os.path.dirname(os.path.abspath(spectral_tpu_torch.__file__))
    require(pkg == os.path.join(HERE, "spectral_tpu_torch"),
            f"spectral_tpu_torch imported from {pkg}, not this checkout")
    import triton
    from spectral_tpu_torch.ops.build import find_nvcc
    nvcc = find_nvcc()
    require(nvcc is not None, "nvcc not found")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, triton {triton.__version__}")
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
          f"the STFT kernel's design can reach; bounds use the FP64 peak on "
          f"the tensor cores, {FP64_PEAK / 1e12:g} TFLOP/s, and HBM "
          f"{HBM_RATE / 1e12:g} TB/s (data sheet)")
    try:
        import PIL
        print(f"PIL {PIL.__version__}: PNGs encode through PIL")
    except ImportError:
        print("no PIL: PNGs encode through the stdlib zlib path")
    return card, dfma


def build_kernels():
    from spectral_tpu_torch.ops import build
    phase("build")
    info = build.build_library("stft_psd")
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
    from spectral_tpu_torch.ops import display_triton as disp
    from spectral_tpu_torch.ops import stft_cuda
    from spectral_tpu_torch.ops.colormap import unpack_indices
    from spectral_tpu_torch.parallel.sharding import finite_flags
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
    psd8, pmin8, pmax8 = got

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
                and finite_flags(xo, lo_o, hi_o).tolist() == [True, False],
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
        flags = finite_flags(xn, lo_n, hi_n).tolist()
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

    T8 = psd8.shape[1]
    for log_scale, flip, share in ((True, True, False), (True, False, False),
                                   (True, True, True), (True, False, True),
                                   (False, True, False)):
        kw = dict(log_scale=log_scale, share_max=share, flip_image=flip)
        what = f"display log={log_scale} flip={flip} share_max={share}"
        img_k, rgb_k = disp.display_epilogue(psd8, pmin8, pmax8, **kw)
        img_p, rgb_p = disp.display_epilogue_reference(psd8, pmin8, pmax8,
                                                       **kw)
        torch.cuda.synchronize()
        err = float(torch.amax(torch.abs(img_k - img_p)))
        require(err <= IMAGE_TOL, f"{what}: image {err:.2e}")
        same = check_words(rgb_k, rgb_p, what)
        print(f"{what}: image {err:.2e}, words identical {same:.6f}")
        img_k, idx_k = disp.display_epilogue(psd8, pmin8, pmax8, palette=True,
                                             **kw)
        img_p, idx_p = disp.display_epilogue_reference(psd8, pmin8, pmax8,
                                                       palette=True, **kw)
        torch.cuda.synchronize()
        err = float(torch.amax(torch.abs(img_k - img_p)))
        require(err <= IMAGE_TOL and tuple(idx_k.shape) == (
            8, 513, -(-T8 // 4)), f"palette {what}: image {err:.2e}")
        same = check_indices(unpack_indices(idx_k, T8),
                             unpack_indices(idx_p, T8), f"palette {what}")
        pad = idx_k.cpu().view(torch.int32).numpy().view(np.uint8)
        require(not pad.reshape(8, 513, -1)[..., T8:].any(),
                f"palette {what}: pad bytes past T are zero")
        print(f"palette {what}: image {err:.2e}, indices identical "
              f"{same:.6f}, T = {T8} padded to {4 * idx_k.shape[-1]}")
        for palette in (False, True):
            none, lean = disp.display_epilogue(psd8, pmin8, pmax8,
                                               palette=palette,
                                               with_image=False, **kw)
            _, full = disp.display_epilogue_reference(
                psd8, pmin8, pmax8, palette=palette, **kw)
            torch.cuda.synchronize()
            require(none is None, "with_image=False returns no image")
            if palette:
                same = check_indices(unpack_indices(lean, T8),
                                     unpack_indices(full, T8),
                                     f"palette {what}, no image")
            else:
                same = check_words(lean, full, f"{what}, no image")
            print(f"{'palette' if palette else 'rgba'} {what}, no image: "
                  f"identical {same:.6f}")


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
    from spectral_tpu_torch.parallel.sharding import finite_flags
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
                and finite_flags(xo, lo_o, hi_o).tolist() == [True, False],
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


def main_path(dev, card):
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.stft import num_frames
    from spectral_tpu_torch.ops import display_triton as disp
    from spectral_tpu_torch.ops import stft_cuda
    from spectral_tpu_torch.ops.colormap import unpack_rgba
    from spectral_tpu_torch.parallel.sharding import (batched_spectrogram_fn,
                                                      finite_flags)
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
    require(counts["stft_psd"]["fft"] >= 1
            and counts["display_epilogue"]["rgba"] >= 1,
            f"a kernel of the path did not launch: {counts}")

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
    pmin_k = torch.amin(out["psd"], dim=(1, 2))
    pmax_k = torch.amax(out["psd"], dim=(1, 2))
    img_ref, _ = disp.display_epilogue_reference(
        out["psd"], pmin_k, pmax_k, log_scale=True, flip_image=True)
    disp_abs = float(torch.amax(torch.abs(out["image"] - img_ref)))
    require(disp_abs <= IMAGE_TOL, f"main-path image vs plain: {disp_abs:.2e}")
    print(f"image vs plain display on the same PSD: {disp_abs:.2e}")
    del img_ref
    _, rgb_p = disp.display_epilogue_reference(
        psd_p[:8], pmin_p[:8], pmax_p[:8], log_scale=True, flip_image=True)
    same = check_words(out["rgb_packed"][:8], rgb_p, "rgb_packed, 8 clips")
    print(f"rgb_packed of 8 clips vs the plain path: {same:.6f} identical")
    del psd_p, pmin_p, pmax_p, rgb_p

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip0.png")
        encode_png(unpack_rgba(out["rgb_packed"][0]), path)
        with open(path, "rb") as fh:
            head = fh.read(8)
    require(head == b"\x89PNG\r\n\x1a\n", "PNG signature")
    print("clip 0 PNG written, signature ok")

    phase(f"path 1 times (CUDA events, median of {REPS} after a warm-up; "
          f"{card})")
    psd, pmin, pmax = out["psd"], pmin_k, pmax_k
    del out

    def plain_pipeline():
        p, lo, hi = stft_cuda.stft_psd_reference(x, consts, cfg,
                                                 with_stats=True)
        img, rgb = disp.display_epilogue_reference(p, lo, hi, log_scale=True,
                                                   flip_image=True)
        return p, img, rgb, finite_flags(x, lo, hi)

    disp_kw = dict(log_scale=True, flip_image=True)
    timings = {
        "stft_kernel": time_ms(lambda: stft_cuda.stft_psd(
            x, FS, cfg, with_stats=True)),
        "stft_gemm_kernel": time_ms(lambda: stft_cuda.stft_psd(
            x, FS, cfg, with_stats=True, _route="gemm")),
        "stft_plain": time_ms(lambda: stft_cuda.stft_psd_reference(
            x, consts, cfg, with_stats=True)),
        "stft_library": time_ms(lambda: library_psd(x, cfg)),
        "display_kernel": time_ms(lambda: disp.display_epilogue(
            psd, pmin, pmax, **disp_kw)),
        "display_plain": time_ms(lambda: disp.display_epilogue_reference(
            psd, pmin, pmax, **disp_kw)),
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
    print(json.dumps({"path1_times": summary}))
    disp_b = display_bound(BATCH, T, F, T)
    return {
        "stft_1024": dict(launches=counts["stft_psd"]["fft"],
                          err=stft_abs, ms=timings["stft_kernel"][0],
                          plain_ms=timings["stft_plain"][0], bound=stft_b,
                          library_ms=timings["stft_library"][0]),
        "display_rgba": dict(launches=counts["display_epilogue"]["rgba"],
                             err=disp_abs, ms=timings["display_kernel"][0],
                             plain_ms=timings["display_plain"][0],
                             bound=disp_b),
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
    from spectral_tpu_torch.ops import display_triton as disp
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
    require(counts["stft_psd"][route] == 1
            and sum(counts["stft_psd"].values()) == 1
            and counts["display_epilogue"]["rgba"] >= 1,
            f"one launch of the {route} kernel and the display kernel: "
            f"{counts}")
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
    pmin_k = torch.amin(out["psd"], dim=(1, 2))
    pmax_k = torch.amax(out["psd"], dim=(1, 2))
    require(torch.equal(torch.isnan(pmin_k), torch.isnan(pmin_p)),
            f"{label} extrema")
    img_ref, _ = disp.display_epilogue_reference(
        out["psd"], pmin_k, pmax_k, log_scale=True, flip_image=True)
    disp_abs = float(torch.amax(torch.abs(out["image"] - img_ref)))
    require(disp_abs <= IMAGE_TOL, f"{label} image vs plain: {disp_abs:.2e}")
    print(f"image vs plain display on the same PSD: {disp_abs:.2e}")
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
    from spectral_tpu_torch.ops import display_triton as disp
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
        require(counts["stft_psd"]["fft"] >= 1
                and counts["display_epilogue"]["palette"] >= 1,
                f"a kernel of the path did not launch: {counts}")
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
        _, words = disp.display_epilogue_reference(
            p, lo, hi, log_scale=True, flip_image=True, palette=True)
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
    psd, pmin, pmax = stft_cuda.stft_psd(xb, FS, cfg, with_stats=True)
    kw = dict(log_scale=True, flip_image=True, palette=True,
              with_image=False)
    _, idx_k = disp.display_epilogue(psd, pmin, pmax, **kw)
    _, idx_p = disp.display_epilogue_reference(psd, pmin, pmax, **kw)
    torch.cuda.synchronize()
    got, want = unpack_indices(idx_k, T), unpack_indices(idx_p, T)
    check_indices(got, want, "palette at the export batch")
    err = float(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
    k_ms = time_ms(lambda: disp.display_epilogue(psd, pmin, pmax, **kw))
    p_ms = time_ms(lambda: disp.display_epilogue_reference(psd, pmin, pmax,
                                                           **kw))
    bound = display_bound(EXPORT_BATCH, T, 513, -(-T // 4), image=False,
                          lut=False)
    print(f"palette display without the image: kernel {k_ms[0]:.3f} ms, "
          f"plain {p_ms[0]:.3f} ms, bound {bound[0]:.4f} ms per batch of "
          f"{EXPORT_BATCH}; largest index difference {err:g} [{card}]")
    return {"display_palette": dict(
        launches=counts["display_epilogue"]["palette"], err=err, ms=k_ms[0],
        plain_ms=p_ms[0], bound=bound),
        "stft_export_launches": counts["stft_psd"]["fft"]}


PHASES = ("kernels", "scipy", "path1", "path2", "path3", "path4", "path5",
          "path6", "path7", "path8", "path9", "path10", "path11")


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
    if "scipy" in phases:
        scipy_checks(dev, card)
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
          f"{rows['stft_mixed_rader']['launches']}")
    src = "spectral_tpu_torch/ops/csrc/stft_psd.cu"
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
        "display_rgba": ("display_epilogue rgba", "triton",
                         "spectral_tpu_torch/ops/display_triton.py",
                         "spectral_tpu/ops/stft_pallas.py:456"),
        "display_palette": ("display_epilogue palette", "triton",
                            "spectral_tpu_torch/ops/display_triton.py",
                            "spectral_tpu/ops/stft_pallas.py:456"),
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
