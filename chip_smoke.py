#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (spectral_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; run it from the root of a checkout. It
builds every kernel of the port's paths from the sources in the checkout
(``csrc/stft_psd.cu``, ``csrc/display.cu``, ``csrc/mel.cu``,
``csrc/hmm.cu``, ``csrc/stft_grad.cu`` and ``csrc/stft_grad_mixed.cu``,
one nvcc each, started
together, beside the native PNG
encoder's g++ build, which must succeed too) and holds each kernel
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
instantiations; the GEMM kernel's large tile forced beside them; past
8192 (``large_kernel_cases``) the radix-2 kernel on one block of 8192
points at nfft 16384 and as two half transforms a frame at 32768, and
the Bluestein kernel on one block at
8194, on clusters of four at 14409, 28814 and 30002 and of eight at 28813
and 32767, and split by bin parity into two half transforms a frame at
14408 and 20000 (one block) and 30000 and 32764 (clusters of two),
within PSD_TOL of the plain version (float64 ``torch.fft``),
within BLUE_MODEL_TOL of the kernel's numpy model
(``tools/torch_precision.py::psd_bluestein``) and bitwise themselves on a
rerun, under every detrend, the
magnitude and the complex STFT, two-sided, bands bitwise the full band's
columns, log10_out, an odd pair's zero, NaN and 1e-6 frames, nperseg 1024
and 20000 zero-padded to 16384 and 32768, the partials' tiles, each
cluster of four and eight placed on the card) and the
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
rest within MEL_ULPS, on tiles of whole rows (F 513, 1025 and 1537, the
last with its weights read from global memory) and in its chunked form (F
4097 and 8193). The HMM kernels (phase ``hmm``, float64): H1, the
Baum-Welch fit, at T 4, 5, 600 and 2047, D 1 and 2, K 4 and 2, on a
model with structural zeros and with the loop stopped at it == 1 and
it == 2, its iteration counts equal to its plain version's, parameters
within HMM_PARAM_TOL and log-likelihoods within HMM_LL_TOL; H2, Viterbi,
at T 1, 2, 3, 600, 2047, 2048 and 65,536 on an escape-patched EM model
and a supervised one, both forms (a block a sequence up to 2048, chunked
at every T), paths identical to the plain versions' and to each other
(on paths 14-17 too);
H3, the chunked E-step, at T 2048, 8192 and 524,288, statistics within
HMM_STATS_TOL and the log-likelihood within HMM_LL_TOL; H3's EM loop on
the card (``fit_chunked``) at T 2048, 4097 and 65,536 on 1-4 sequences
that converge apart, n_iter 0, 1, 12 and 100, with structural zeros and
stopped at it == 2, its iteration counts equal to the plain loop's,
within HMM_PARAM_TOL and HMM_LL_TOL of it, and bitwise the host loop over
one E-step launch an iteration and the torch M-step; a six-state model
(the instantiation for 5-8 states) through all three at T 3000; with
each kernel's ptxas registers and spills. Then it drives eighteen paths at
full size, the GUI, the command line, the extended modes, the
gradients and transforms past 8192, each with the launch counts set to 0 just before it and read
just after; each
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
    kernel, H3's EM loop on the card (one call, the flags read once every
    EM_GROUP iterations) and H2's chunked form; the path held to the plain
    chunked versions (Viterbi on every frame, the E-step's statistics and
    log-likelihood), the loop bitwise the host loop over one E-step launch
    an iteration and the torch M-step, the planted bursts found; the loop
    timed and split by stage (``torch.profiler``), and H2 chunked split by
    its five kernels;
16. the interactive session (``api/session.py``, the reference app's
    flow): an hour at 48 kHz with path 15's kind of planted bursts,
    written as a 16-bit WAV, loaded through ``SweepRegistry`` and plotted
    by ``AnalysisSession(device="cuda")`` at scipy_default 1024, 0-4000
    Hz (one STFT launch a plot; sxx and image held to the plain float64
    PSD; the plot's latency split into upload, kernel, band + normalize,
    the copy back and the host), a 10-minute cut held to scipy float64,
    128 log mels with a global max (the mel kernel), ``unsupervised_detect``
    (the PSD recomputed past the session's cache cap, H3's EM loop and H2
    chunked,
    ``detection_quality``), the CSV and PNG exports (their status strings
    and files; the PNG encoded natively, timed beside PIL and zlib), and
    an ABF file of 20 sweeps combined, its segment map and CSV
    attribution checked, learned from two ROIs;
17. long recordings in bounded memory (``parallel/streaming.py``,
    BASELINE.json config 4): an hour of 48 kHz stereo (2 x 172,800,000
    float32 samples on the host, path 15's kind of planted bursts) at
    north_star 1024/256, chunks of 49,152 samples, 64 to a block:
    ``scan_spectrogram`` on the fleet, one FFT launch a block (55),
    bitwise the monolithic ``power_spectrogram`` of each channel, its
    wall time, rate from the host and the device's idle share
    (``torch.profiler``); ``stream_band_powers`` and ``stream_features``
    on each channel at half and the whole hour, within 1e-6 of
    ``band_powers_device`` and bitwise ``features_from_psd`` (0-4000 Hz),
    the rise of ``max_memory_allocated`` under a bound from the block size
    and no larger at the hour than at half of it; ``stream_detect`` on
    channel 0, its events equal to ``BurstDetector(engine='auto')`` on the
    monolithic features (H3's EM loop once, H2 chunked once),
    ``detection_quality``; ``iter_stream`` over a 10-minute cut ending in
    a short chunk, bitwise the monolithic frames; ``stream_spectrogram``
    over the cut at scipy_default 8191 (the odd route) within 2 float32
    ulps; the FFT kernel on one streamed block timed against its plain
    version, cuFFT and its bound;
18. the sweep grid (``parallel/sweep_grid.py``, BASELINE.json config 3):
    ``default_grid()``'s 16 configs over a 10-minute clip at 48 kHz, one
    upload and 16 FFT launches (``torch.profiler``), each result bitwise
    ``power_spectrogram`` of its config, a 10 s cut of each within 2e-5
    of scipy float64, the time of each shape group;

the GUI (``gui/app.py`` over the port's session, ``device='cuda'``):
under the real Qt offscreen where the host has PyQt5 and matplotlib, under
``tests/qt_stub.py`` where it has matplotlib alone, plot (one STFT launch
a plot), detect and the CSV and PNG exports on a synthetic sweep; where
the host has no matplotlib, one line that says so; and

19. the command line (``cli.py``, ``client.py``): every subcommand through
    ``cli.main`` in this process, its launch counts read (a command that
    computes and launches no kernel fails; ``info``, ``export-batch`` and
    ``gui`` launch none), its outputs held to the same library calls made
    in process and its wall time printed beside theirs: on path 16's hour
    (scipy_default 1024, 0-4000 Hz) ``render --log`` (the PNG bytewise
    ``export_png``'s), ``--mels 128`` (the mel kernel) and ``--nfft 4096``
    (the radix-2 kernel at K = 4096 over the zero-padded frames, 192,857
    frames x 2,049 bins, held to its plain version within 1 float32 ulp,
    timed against it, the GEMM kernel's 128 x 64 tile forced, cuFFT's f64
    ``rfft(n=4096)`` and its bound, and on a 10-minute cut within 1e-3 dB
    of scipy float64 at nfft 4096), ``detect --csv`` (lines and CSV bytes)
    and ``bands``;
    ``info`` on the WAV and path 16's ABF file, ``learn --combine`` with
    two ROIs and ``detect --each --batched`` over its sweeps (each
    sweep's events the sequential flow's); ``grid`` over 60 s (bitwise
    ``sweep_grid``); ``stream`` over a 10-minute cut (``-o x.npz``
    bitwise ``stream_spectrogram``, ``--scan -o x.png`` bytewise, ``--bands``,
    ``--detect --csv``); ``export-batch`` of the cut; ``export-specs`` of
    64 WAV clips with ``--stats-json`` (PNG bytes the pipeline's);
    ``doctor --json --probe-link``; NIX files where the host has h5py,
    ``render --decorated`` where it has matplotlib, ``gui`` exiting 2
    without PyQt5; then ``serve --tcp 0`` in a child process driven by
    ``ServeClient`` (ping, render, detect, detect_batch, render_batch,
    stream_bands, stats, shutdown), each reply the in-process command's.

20. the extended modes (``ext_modes_path``): zero-padded transforms on
    every FFT family at 1024 clips of 10 s (PADDED_CASES: nperseg 1000 to
    nfft 1536 on the mixed-radix kernel, 1024 to 2047 on the odd one, 2000
    to 2049 on the Bluestein one, 24 to 64 on the radix-2 one, 4096 to
    8190 on the mixed-radix one, 8000 to 8185 on the Bluestein one's
    cluster of two blocks), each within 1 float32 ulp of its plain
    version and timed against the GEMM kernel forced, cuFFT and its
    bound; the magnitude (1 ulp, partials bitwise), the complex STFT (one-
    and two-sided, the full band and a band, each frame within 2^-22 of
    its max |X|, mirrored bins bitwise conjugates) and the two-sided PSD
    (1 ulp) on each of the five routes (MODE_CASES); centered framing
    (reflect, constant, edge, symmetric, wrap) through
    ``batched_spectrogram_fn`` on path 1's batch, one STFT kernel,
    clip_stats and display map a call, the words against the plain path
    and clip 0 within 1e-3 dB of scipy float64 on the np.pad-padded clip;
    ``spectrogram`` in magnitude and complex mode and ``stft`` on path
    16's hour, one radix-2 launch each, against the plain version and, on
    a 10-minute cut, scipy float64 (complex within 2e-5 of max |X|,
    magnitude within 1e-3 dB), the magnitude and complex epilogues timed
    against their plain versions, cuFFT with the same epilogue and their
    bounds.

21. gradients (``grad_path``): path 1's batch as a waveform that requires
    grad, three SGD steps through ``batched_spectrogram_fn`` at
    north_star 1024/256 log (the loss on the image and the PSD) and
    three at path 12's 128 log mels (on the mel rows and the image), each
    step the forward kernels and the backward kernels
    (``stft_fft_backward_kernel``, the radix-2 route's adjoint with X
    recomputed in registers, ``overlap_add_kernel``,
    ``mel_backward_kernel``, the display backward's kernel), its
    gradient on GRAD_CLIPS clips held within GRAD_TOL of the clip's
    largest |gradient| to the plain backward on the card;
    ``power_spectrogram`` and ``stft`` on 10 minutes at 48 kHz (path 16's
    config) the same way; ``power_spectrogram`` on 8 clips of 60 s at
    scipy_default 8160 (the mixed route, ``stft_mixed_fft_backward_kernel``),
    8186 (its Rader plan, the odd kernel's PACKED form) and 8191 (the odd
    route, ``stft_odd_fft_backward_kernel``), 8182 and 8185 (the Bluestein
    route on one block and on a cluster of two,
    ``stft_bluestein_fft_backward_kernel``), one forward launch and one
    backward launch each, X recomputed inside, 24 (the GEMM route's
    small-K configs: one launch of ``stft_small_backward_kernel``, X
    recomputed in registers, held to its plain version and to B1
    forced), and 24 two-sided and nfft 8200 over 24 (the "dense"
    backward: one recompute of X by the route's complex epilogue, the GEMM
    kernel's or, at nfft 8200, the Bluestein kernel's, then
    ``stft_backward_kernel``); one SGD step at path 4's
    config on its full batch (256 x 60 s at scipy_default 8160 log);
    each backward kernel timed against its plain version, its bound and
    its library call (the backward of ``library_psd`` under autograd for
    the STFT's, ``F.fold`` for the overlap-add, ``torch.matmul`` in
    float64 for the mel projection's), ``stft_small_backward_kernel``
    (B1-small) and ``stft_backward_kernel`` (B1) on the GEMM route at
    path 10's shapes, B1 forced at path 1's, and the
    mixed, odd and Bluestein adjoints at paths 4, 7, 11, 8 and 9's shapes
    beside B1 forced there. No cache is trimmed before
    it: the device operands' cache is bounded. Before it, phase ``grad``
    holds the STFT backward to its plain version on every route (radix-2
    at 32, 1024 and 8192, mixed at 992, 8032 and 8160, the mixed route's
    Rader plans at 1006 and 8186, odd at 1023, 8191 (Rader) and with T
    odd, Bluestein on one block (at one and at two blocks an SM), on a
    cluster, zero-padded, in every output, two-sided with a band, with T
    odd and with a NaN in g, GEMM, nfft past nperseg, two-sided,
    magnitude, complex, unscaled, a band, centered, linear detrend, T =
    0), each radix-2, mixed, odd and Bluestein case also to the plain FFT
    adjoint and to ``stft_backward_kernel`` forced, with no recompute
    launch and no dense operands built, each small-K case (GEMM at 2, 12
    two-sided, 13 linear on a band, 24, 24 two-sided on a band of 16
    bins, 24 unscaled, 31 magnitude) to its plain version and to B1
    forced within GRAD_TOL and to itself run again bit for bit (the
    kernel fuses each product into an FMA where the plain version rounds
    it apart, so it need not equal the plain version), and the GEMM route
    past it (24 two-sided, nfft 8200 over 24, whose X the Bluestein kernel
    recomputes) on B1, and the mel and display
    backward at paths 12's and 1's shapes (tied extrema, share_max,
    linear and log, flipped); and a CUDA step at nperseg 16384, refused
    naming [large-nperseg] before any launch.

22. transforms past 8192 (``large_path``, [large-nperseg]): path 2's
    batch through ``batched_spectrogram_fn`` at scipy_default 16384 (the
    radix-2 kernel, one block of 8192 points a frame) and 32768 (two half
    transforms a frame), 20000, 30000
    and 32767 (the Bluestein kernel on clusters of two, four and eight),
    and at 16384 with 128 log mels and with the 0-30 Hz band: one launch
    of the route's kernel a call and none of the GEMM kernel, clip 0
    within 1e-3 dB of scipy float64, the PSD within PSD_TOL of the plain
    version, each kernel timed beside its bound, cuFFT and the plain
    version.

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


def library_psd(x, cfg, fs=FS, out=None):
    """The STFT kernels' library yardstick, never called by the port: the
    same PSD through cuFFT's float64 real transform (the transform
    ``torch.stft`` runs; its complex transform for a two-sided spectrum)
    of the same frames, zero-padded to nfft, framed with ``unfold`` so the
    detrend fits (the frame's mean, or its least-squares line), then the
    same epilogue: |X|² times the weights, sqrt(|X|²) times their square
    roots for out 'magnitude', X times sqrt of the PSD scale for out
    'complex' (out cfg.mode when None), rounded to float32 (complex64)."""
    import torch
    from spectral_tpu_torch.core.stft import _window_f64
    from spectral_tpu_torch.ops.stft_cuda import kernel_weights
    out = out or cfg.mode
    frames = x.double().unfold(-1, cfg.nperseg, cfg.hop_)
    if cfg.detrend in ("constant", "linear"):
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.detrend == "linear":
        t = torch.arange(cfg.nperseg, dtype=torch.float64, device=x.device)
        t = t - t.mean()
        frames = frames - ((frames @ t) / (t @ t))[..., None] * t
    win = torch.tensor(_window_f64(cfg), dtype=torch.float64, device=x.device)
    wts = torch.tensor(kernel_weights(cfg, fs, out), dtype=torch.float64,
                       device=x.device)
    fft = torch.fft.rfft if cfg.onesided else torch.fft.fft
    spec = fft(frames * win, n=cfg.nfft_, dim=-1)
    if out == "complex":
        return (spec * wts).to(torch.complex64)
    power = torch.view_as_real(spec).square().sum(dim=-1)
    if out == "magnitude":
        return (power.sqrt() * wts).float()
    return (power * wts).float()


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
                   mel_cuda.launches, mel_cuda.form_launches,
                   hmm_cuda.launches,
                   stft_cuda.grad_launches, mel_cuda.grad_launches,
                   display_cuda.grad_launches):
        for key in counts:
            counts[key] = 0


def read_counts():
    from spectral_tpu_torch.ops import (display_cuda, hmm_cuda, mel_cuda,
                                        stft_cuda)
    return {"stft_psd": dict(stft_cuda.launches),
            "display": dict(display_cuda.launches),
            "mel": dict(mel_cuda.launches),
            "mel_form": dict(mel_cuda.form_launches),
            "hmm": dict(hmm_cuda.launches),
            "grad": {**stft_cuda.grad_launches, **mel_cuda.grad_launches,
                     **display_cuda.grad_launches}}


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


def stft_bound(B, n, T, F, K, out_bytes=4):
    """(bound_ms, bound_by) of the STFT/PSD function, one count for both
    routes: the signal read once and the PSD (or magnitude; out_bytes 8
    for the complex STFT) and per-clip min and max written once, against
    a real FFT's 2.5*K*log2(K) operations per frame plus 3 per output bin
    (the power and its weight) at the card's FP64 peak, K the transform
    length (nfft)."""
    bytes_ = B * n * 4 + B * T * F * out_bytes + 2 * B * 4
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
        print(f"PIL {PIL.__version__}, a fallback PNG encoder (the native "
              f"one comes first)")
    except ImportError:
        print("no PIL: the stdlib zlib encoder is the fallback")
    return card, dfma


def build_kernels():
    from concurrent.futures import ThreadPoolExecutor
    from spectral_tpu_torch.ops import build
    phase("build")
    t0 = time.perf_counter()
    # the native PNG encoder (g++ and zlib) beside the four nvcc builds; a
    # failed build is fatal here, with the compiler's message
    native = subprocess.Popen(
        [sys.executable, "-m", "spectral_tpu_torch.native.build"], cwd=HERE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    with ThreadPoolExecutor(6) as pool:
        info, tail, mel, hmm_lib, grad, grad_mixed = pool.map(
            build.build_library,
            ("stft_psd", "display", "mel", "hmm", "stft_grad",
             "stft_grad_mixed"))
    out, err = native.communicate(timeout=300)
    require(native.returncode == 0,
            f"the native PNG encoder did not build (it needs g++ and zlib's "
            f"headers): {out}{err}")
    from spectral_tpu_torch.native import build as native_build
    from spectral_tpu_torch.native import png_native
    require(png_native.available(), "the native PNG encoder does not load")
    print(f"the six sources and the native PNG encoder built side by side "
          f"in {time.perf_counter() - t0:.2f} s: "
          f"{os.path.relpath(native_build.lib_path('libspectpu_png.so'), HERE)}")
    print(f"hmm.cu -> {os.path.relpath(hmm_lib['path'], HERE)} in "
          f"{hmm_lib['seconds']:.2f} s; ptxas: "
          + "; ".join(hmm_ptxas(hmm_lib["log"])))
    build.load_library("hmm")
    print(f"stft_grad.cu -> {os.path.relpath(grad['path'], HERE)} in "
          f"{grad['seconds']:.2f} s; ptxas: " + "; ".join(radix2_ptxas(
              grad["log"], r"(stft_backward_kernel|overlap_add_kernel|"
              r"stft_fft_backward_kernelILi(\d+)ELi(\d+)E|"
              r"stft_small_backward_kernelILi(\d)E)",
              lambda e: f"stft_small_backward<NB {e.group(4)}>"
              if e.group(4) is not None else e.group(1)
              if e.group(2) is None else
              f"stft_fft_backward<LOG2M {e.group(2)}, "
              f"{2 ** int(e.group(3))} values>")))
    build.load_library("stft_grad")
    print(f"stft_grad_mixed.cu -> "
          f"{os.path.relpath(grad_mixed['path'], HERE)} in "
          f"{grad_mixed['seconds']:.2f} s; ptxas: " + "; ".join(radix2_ptxas(
              grad_mixed["log"],
              r"stft_(mixed_fft_backward_kernelILi(\d+)E|odd_fft_backward_"
              r"kernelILb(\d)ELi(\d+)ELb(\d)E|bluestein_fft_backward_"
              r"kernelILi(\d)ELb(\d)ELb(\d)E)",
              lambda e: f"stft_mixed_fft_backward<RMAX {e.group(2)}>"
              if e.group(2) is not None else
              f"stft_odd_fft_backward<RADER {e.group(3)}, RMAX "
              f"{e.group(4)}, PACKED {e.group(5)}>"
              if e.group(3) is not None else
              f"stft_bluestein_fft_backward<RANKS {e.group(6)}, TWO "
              f"{e.group(7)}{', EXT' if e.group(8) == '1' else ''}>")))
    build.load_library("stft_grad_mixed")
    print(f"mel.cu -> {os.path.relpath(mel['path'], HERE)} in "
          f"{mel['seconds']:.2f} s; ptxas: " + "; ".join(radix2_ptxas(
              mel["log"], r"(mel_project_kernel|mel_chunked_kernel|"
              r"mel_backward_kernel)",
              lambda e: e.group(1))))
    build.load_library("mel")
    print(f"display.cu -> {os.path.relpath(tail['path'], HERE)} in "
          f"{tail['seconds']:.2f} s; ptxas: " + "; ".join(radix2_ptxas(
              tail["log"], r"(clip_stats_kernel|display_map_kernelILi(\d)"
              r"ELb(\d)E|display_grad_kernelILb(\d)E|"
              r"display_grad_prep_kernel)",
              lambda e: "clip_stats" if e.group(1) == "clip_stats_kernel"
              else f"display_map<MODE {e.group(2)}, LOG {e.group(3)}>"
              if e.group(2) is not None
              else f"display_grad<LOG {e.group(4)}>"
              if e.group(4) is not None else "display_grad_prep")))
    build.load_library("display")
    print(f"stft_psd.cu -> {os.path.relpath(info['path'], HERE)} in "
          f"{info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if ("registers" in line or "spill" in line or "error" in line
                or "Compiling entry" in line):
            print("  " + line.strip())
    print("radix-2 kernel (stft_fft_psd_kernel<LOG2M, LR, EXT>; EXT the "
          "zero-padded load or another output than the PSD), ptxas: "
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
              info["log"], r"stft_psd_(small_kernelILi(\d)ELb(\d)E|kernelE)",
              lambda e: (f"small-K tile<NB {e.group(2)}"
                         f"{', EXT' if e.group(3) == '1' else ''}>")
              if e.group(2) else "large tile")))
    print("radix-2 kernel past 8192 (stft_fft_split_psd_kernel<LOG2M, LR, "
          "EXT>, two half transforms a frame), ptxas: " + "; ".join(
              radix2_ptxas(info["log"],
                           r"stft_fft_split_psd_kernelILi(\d+)ELi(\d+)ELb(\d)E")))
    print("Bluestein kernel on clusters of four and eight "
          "(stft_bluestein_cluster_psd_kernel<RANKS, EXT>), ptxas: "
          + "; ".join(radix2_ptxas(
              info["log"], r"stft_bluestein_cluster_psd_kernelILi(\d)ELb(\d)E",
              lambda e: f"RANKS {e.group(1)}"
                        f"{', EXT' if e.group(2) == '1' else ''}")))
    print("Bluestein kernel (stft_bluestein_psd_kernel<RANKS, TWO, EXT, "
          "SPLIT>), ptxas: " + "; ".join(radix2_ptxas(
              info["log"],
              r"stft_bluestein_psd_kernelILi(\d)ELb(\d)ELb(\d)ELb(\d)E",
              lambda e: f"RANKS {e.group(1)}, TWO {e.group(2)}"
                        f"{', EXT' if e.group(3) == '1' else ''}"
                        f"{', SPLIT' if e.group(4) == '1' else ''}")))
    build.load_library("stft_psd")


def mixed_ptxas(log):
    """The registers and spills of each instantiation of the mixed-radix
    kernel, as "RMAX m: r registers, s bytes spilled"."""
    return radix2_ptxas(log, r"stft_mixed_fft_psd_kernelILi(\d+)E",
                        lambda e: f"RMAX {e.group(1)}")


def radix2_ptxas(log, pattern=r"stft_fft_psd_kernelILi(\d+)ELi(\d+)ELb(\d)E",
                 label=lambda e: f"LOG2M {e.group(1)}, "
                 f"{2 ** int(e.group(2))} values"
                 f"{', EXT' if e.group(3) == '1' else ''}"):
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
    """Equal bit patterns, NaN in the same places (any payload); 4- or
    8-byte elements of one dtype."""
    import torch
    if a.dtype != b.dtype:
        return False
    bits = torch.int64 if a.element_size() == 8 else torch.int32
    na, nb = torch.isnan(a), torch.isnan(b)
    ia = torch.where(na, 0, a.contiguous().view(bits))
    ib = torch.where(nb, 0, b.contiguous().view(bits))
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


LARGE_R2_CASES = (16384, 32768)
# one block, a cluster of two (even = 2 mod 4: 20002, M = 20160), clusters
# of four (odd, even = 2 mod 4) and of eight (odd); then split by bin
# parity: halves on one block (14408, the first split length; 20000) and on
# clusters of two (30000; 32764, M' = 16384, the swizzled slots)
LARGE_BLUESTEIN_CASES = (8194, 20002, 14409, 28814, 30002, 28813, 32767,
                         14408, 20000, 30000, 32764)
# the Bluestein kernel past 8192 against its numpy model, of the frame's
# largest bin: one float32 ulp of it (both round one float64 value; the
# card fuses products and sums the detrend in another order)
BLUE_MODEL_TOL = 2.0 ** -23


def bluestein_form(k):
    """The Bluestein kernel's form at nfft k, in words."""
    from spectral_tpu_torch.core.stft import bluestein_route_plan
    plan = bluestein_route_plan(k)
    where = ("one block" if plan.ranks == 1 else
             f"a cluster of {plan.ranks}")
    if plan.halves == 2:
        return (f"two half transforms of {plan.n} points a frame, M' = "
                f"{plan.m} on {where} each")
    return f"M = {plan.m} on {where}"


def large_kernel_cases(dev):
    """[large-nperseg]: the radix-2 kernel past 8192 at nfft 16384 (one
    block of 8192 points a frame) and 32768 (a frame as two half
    transforms, the bins of each parity), and the
    Bluestein kernel on one block (8194), a cluster of two (20002), clusters
    of four (14409, 28814, 30002) and of eight (28813, 32767), and split by
    bin parity into two
    half transforms a frame ([large-bluestein]: 14408 and 20000 on one
    block, 30000 and 32764 on clusters of two), against the
    plain version (``plain_constants``: float64 ``torch.fft``, no dense
    matrix) within PSD_TOL on 2 clips of T = 5 (an odd pair's lone last
    frame), the Bluestein configs under each detrend against the numpy
    model of their form too (within BLUE_MODEL_TOL):
    every detrend, the magnitude and the complex STFT (its mirrored bins
    bitwise conjugates two-sided), a two-sided spectrum, bands bitwise the
    full band's columns, log10_out, the zero, NaN and 1e-6 frames an odd
    pair must keep apart, nperseg 1024 and 20000 zero-padded to 16384 and
    32768; each launch once, its rerun bitwise, the partials' tiles (the
    split's two, a cluster's ranks) reduced to each frame's extrema; the
    clusters of four and eight placed on the card
    (``cudaOccupancyMaxActiveClusters``)."""
    import dataclasses
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.stft import bluestein_route_plan
    from spectral_tpu_torch.ops import stft_cuda
    from torch_precision import trend

    phase("transforms past 8192 ([large-nperseg]) against the plain version")
    rs = np.random.RandomState(28)
    worst = {}

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def run(x, cfg, band, out, log10_out=False):
        if out == "complex":
            return (stft_cuda.stft_complex(x, FS, cfg, band),)
        if log10_out:
            return (stft_cuda.stft_psd(x, FS, cfg, band=band,
                                       log10_out=True),)
        return stft_cuda.stft_psd(x, FS, cfg, with_stats=True, band=band)

    def check(x, cfg, what, band=None, out=None, log10_out=False):
        route = stft_cuda.route(cfg)
        require(route in ("fft", "bluestein"), f"{what}: route {route}")
        before = dict(stft_cuda.launches)
        got = run(x, cfg, band, out, log10_out)
        torch.cuda.synchronize()
        _launched(route, before, what)
        again = run(x, cfg, band, out, log10_out)
        require(all(bitwise(a, b) for a, b in zip(got, again)),
                f"{what}: a rerun is not bitwise the first run")
        consts = stft_cuda.plain_constants(cfg, FS, dev, band, out)
        if out == "complex":
            want = (stft_cuda.stft_complex_reference(x, consts, cfg),)
            rel, _ = frame_err(got[0], want[0])
            require(rel <= PSD_TOL, f"{what}: complex {rel:.2e} of a "
                    "frame's max |X|")
            if not cfg.onesided:
                require(mirrored(got[0], cfg.nfft_),
                        f"{what}: mirrored bins not conjugates bitwise")
        else:
            want = stft_cuda.stft_psd_reference(
                x, consts, cfg, log10_out=log10_out,
                with_stats=not log10_out)
            want = (want,) if log10_out else want
            for name, g, w in zip(("psd", "pmin", "pmax"), got, want):
                odd = (torch.isnan(g) != torch.isnan(w)) | (
                    torch.isinf(g) != torch.isinf(w))
                require(not bool(odd.any()),
                        f"{what}: NaN or inf in other places in {name}: "
                        f"{odd.nonzero()[:8].tolist()} of "
                        f"{int(odd.sum())}")
            p, q = got[0], want[0]
            if log10_out:
                p, q = 10.0 ** p.double(), 10.0 ** q.double()
            ok = torch.isfinite(q)
            diff = torch.where(ok, (p - q).abs(), 0.0).amax(dim=(1, 2))
            scale = torch.where(ok, q.abs(), 0.0).amax(dim=(1, 2))
            rel = float((diff / scale.clamp_min(1e-30)).amax())
            require(rel <= PSD_TOL, f"{what}: {rel:.2e} of the clip max")
            if not log10_out:
                require(bitwise(got[1], torch.amin(got[0], dim=(1, 2)))
                        and bitwise(got[2], torch.amax(got[0], dim=(1, 2))),
                        f"{what}: the extrema are not the PSD's")
        ulps = ulp_distance(got[0], want[0]) if out != "complex" else 0
        worst[f"{what} [{route}]"] = rel
        print(f"{what} [{route}]: {rel:.2e} of the "
              f"{'frame' if out == 'complex' else 'clip'} max"
              + (f", {ulps} float32 ulps" if out != "complex" else ""))
        return got

    def bands_of(x, cfg, what):
        full = run(x, cfg, None, None)[0]
        F = cfg.n_freqs
        for lo, hi in ((0, 1), (F - 1, F), (1, F - 1), (3, 20),
                       (F // 3, F // 3 + 1), (F // 2 - 7, F // 2 + 8)):
            got = check(x, cfg, f"{what}, band ({lo}, {hi})", band=(lo, hi))
            require(bitwise(got[0], full[..., lo:hi]),
                    f"{what}: band ({lo}, {hi}) is not the full band's "
                    "columns bitwise")

    def tiles(x, cfg, what):
        psd, parts = stft_cuda.stft_psd_partials(x, FS, cfg)
        want = stft_cuda.partial_tiles(cfg, stft_cuda.route(cfg))
        require(parts.shape[1] == want
                and bitwise(parts[0].amin(dim=0), psd.amin(dim=-1))
                and bitwise(parts[1].amax(dim=0), psd.amax(dim=-1)),
                f"{what}: {parts.shape[1]} tiles of partials, not {want} "
                "that reduce to each frame's extrema")
        print(f"{what}: {want} tile(s) of partials a frame, each frame's "
              "extrema bitwise")

    def clips(k, hop, offset, detrend):
        n = k + 4 * hop                         # T = 5
        x = rs.randn(2, n) + offset
        return x + trend(n) if detrend == "linear" else x

    def model(x, cfg, what):
        """The Bluestein kernel against its numpy model of the route's
        form (the halves or the whole transform), on the card's float32
        frames, within BLUE_MODEL_TOL of each frame's largest bin."""
        from torch_precision import (bluestein_route_operands, frames_of,
                                     psd_bluestein)
        got = stft_cuda.stft_psd(x, FS, cfg).cpu().numpy()
        window, plan, wts = bluestein_route_operands(cfg, FS)
        worst = 0.0
        for b, xb in enumerate(x.cpu().numpy()):
            want = psd_bluestein(frames_of(xb, cfg), window, plan, wts,
                                 cfg.detrend)
            err = np.abs(got[b].astype(np.float64) - want).max(axis=-1)
            worst = max(worst, float((err / want.max(axis=-1)).max()))
        require(worst <= BLUE_MODEL_TOL, f"{what}: {worst:.2e} of a "
                "frame's largest bin from the numpy model")
        print(f"{what} [{bluestein_form(cfg.nfft_)}]: {worst:.2e} of a "
              f"frame's largest bin from the numpy model (limit "
              f"{BLUE_MODEL_TOL:.2e})")

    for k in LARGE_R2_CASES + LARGE_BLUESTEIN_CASES:
        hop = k // 2
        for detrend, offset in (("none", 0.0), ("constant", 3.0),
                                ("linear", 0.0)):
            cfg = SpecConfig(nperseg=k, hop=hop, detrend=detrend)
            x = on_card(clips(k, hop, offset, detrend))
            check(x, cfg, f"nperseg {k}, {detrend}, T = 5")
            if stft_cuda.route(cfg) == "bluestein":
                model(x, cfg, f"nperseg {k}, {detrend}, T = 5")
        cfg = SpecConfig(nperseg=k, hop=hop, detrend="constant")
        x = on_card(clips(k, hop, 3.0, "constant"))
        tiles(x, cfg, f"nperseg {k}")
        bands_of(x, cfg, f"nperseg {k}")
        check(x, cfg, f"nperseg {k}, log10_out", log10_out=True)
        check(x, dataclasses.replace(cfg, mode="magnitude"),
              f"nperseg {k}, magnitude")
        check(x, cfg, f"nperseg {k}, complex", out="complex")
        if k in (16384, 28814, 32767):
            two = dataclasses.replace(cfg, onesided=False)
            check(x, two, f"nperseg {k}, two-sided")
            check(x, two, f"nperseg {k}, two-sided complex", out="complex")
        if stft_cuda.route(cfg) == "bluestein" and k % 2:
            # frames apart (hop = nperseg), T = 7: clip 0's frame 1 all
            # zero beside loud frame 0, its frame 4 at 1e-6 beside frame 5;
            # clip 1 a NaN in frame 3 beside frame 2; frame 6 alone
            pcfg = SpecConfig(nperseg=k, hop=k, detrend="constant")
            xc = rs.randn(2, 7 * k) + 3.0
            xc[0, k:2 * k] = 0.0
            xc[0, 4 * k:5 * k] = 1e-6 * rs.randn(k)
            xc[1, 3 * k + k // 2] = np.nan
            got = check(on_card(xc), pcfg, f"nperseg {k}, zero, 1e-6 and "
                        "NaN frames beside loud ones")
            frames_ok = torch.isfinite(got[0][1]).all(dim=1).tolist()
            require(bool((got[0][0, 1] == 0).all())
                    and float(got[1][0]) == 0.0
                    and bool(torch.isnan(got[1][1]))
                    and frames_ok == [True] * 3 + [False] + [True] * 3,
                    f"nperseg {k}: the zero frame's bins exactly 0, the NaN "
                    f"only in its own frame: {frames_ok}")
        ranks = (bluestein_route_plan(k).ranks
                 if stft_cuda.route(cfg) == "bluestein" else 0)
        if ranks > 2:
            held = stft_cuda.bluestein_clusters(cfg, dev)
            require(held >= 1, f"nperseg {k}: no cluster of {ranks} fits")
            print(f"nperseg {k}: {bluestein_form(k)}, {held} clusters on "
                  "the card at once")
    for L, K in ((1024, 16384), (20000, 32768)):
        cfg = SpecConfig(nperseg=L, nfft=K, hop=L // 2, detrend="linear")
        x = on_card(clips(L, L // 2, 0.0, "linear"))
        check(x, cfg, f"nperseg {L} zero-padded to {K}")
        check(x, cfg, f"nperseg {L} zero-padded to {K}, complex",
              out="complex")
    print(f"transforms past 8192: {len(worst)} cases, largest error "
          f"{max(worst.values()):.2e} (limit {PSD_TOL:g})")


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


# path 22: transforms past 8192 at full width, the radix-2 kernel (16384 on
# one block, 32768 split by bin parity), the Bluestein kernel split by bin
# parity (20000, 30000) and on clusters of four (30002, 2 mod 4) and eight
# (32767, odd)
LARGE_PATH = ((16384, "radix-2, one block of 8192 points a frame"),
              (32768, "radix-2, two half transforms a frame"),
              (20000, "Bluestein, two halves of 5000 points a frame on one "
                      "block each"),
              (30000, "Bluestein, two halves of 7500 points a frame on a "
                      "cluster of two each"),
              (30002, "Bluestein on a cluster of four"),
              (32767, "Bluestein on a cluster of eight"))


# the kernels past 8192 replace no TPU kernel: the JAX package computes those
# frames on its rFFT route, its Pallas kernel's VMEM stopping at 8192
LARGE_REPLACES = ("none: power_spectrogram's XLA rFFT past the Pallas "
                  "kernel's 8192 (spectral_tpu/core/stft.py:769, :794; "
                  "spectral_tpu/ops/stft_pallas.py:93)")


def large_kernel_name(k):
    """The instantiation path 22 launches at scipy_default k."""
    from spectral_tpu_torch.core.stft import bluestein_route_plan
    if k & (k - 1) == 0:
        if k >= 32768:
            return (f"stft_fft_split_psd<LOG2M {k.bit_length() - 3}, 16 "
                    f"values>, two half transforms a frame (the bins of each "
                    f"parity), scipy_default {k} (path 22)")
        return (f"stft_fft_psd<LOG2M {k.bit_length() - 2}, 16 values>, one "
                f"block of {k // 2} points a frame, scipy_default {k} (path "
                f"22)")
    plan = bluestein_route_plan(k)
    if plan.halves == 2:
        return (f"stft_bluestein_psd<RANKS {plan.ranks}, SPLIT> split by bin "
                f"parity, two half transforms of {plan.n} points a frame, M' "
                f"= {plan.m} on {'one block' if plan.ranks == 1 else 'a '
                'cluster of two'} each, scipy_default {k} (path 22)")
    if plan.ranks <= 2:
        return (f"stft_bluestein_psd<RANKS {plan.ranks}>, M = {plan.m}, "
                f"scipy_default {k} (path 22)")
    return (f"stft_bluestein_cluster_psd<RANKS {plan.ranks}> on a cluster, "
            f"M = {plan.m}, scipy_default {k} (path 22)")


def large_grad_refusal(dev):
    """[large-nperseg]: one training step at nperseg 16384 on a CUDA
    waveform that requires grad raises NotImplementedError naming the item
    before any launch; without grad the same call runs."""
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.stft import power_spectrogram
    from spectral_tpu_torch.ops import stft_cuda
    phase("the gradient past 8192: refused on the card")
    cfg = SpecConfig.scipy_default(16384)
    x = torch.randn((2, 40000), device=dev, requires_grad=True)
    reset_counts()
    try:
        power_spectrogram(x, FS, cfg).sum().backward()
    except NotImplementedError as err:
        require("[large-nperseg]" in str(err), f"the refusal's text: {err}")
        print(f"a step at nperseg 16384 raises: {err}")
    else:
        raise RuntimeError("chip_smoke check failed: a CUDA step at "
                           "nperseg 16384 did not raise")
    require(not any(flat_counts(read_counts()).values()),
            f"launches before the refusal: {read_counts()}")
    p = power_spectrogram(x.detach(), FS, cfg)
    torch.cuda.synchronize()
    require(stft_cuda.launches["fft"] == 1 and tuple(p.shape) == (2, 2, 8193),
            "the same call without grad: one radix-2 launch")


def large_path(dev, card):
    """Path 22, transforms past 8192 ([large-nperseg]): path 2's batch (256
    clips of 60 s at 16 kHz) through ``batched_spectrogram_fn`` at
    scipy_default 16384 (the radix-2 kernel, one block of 8192 points a
    frame) and 32768 (two half transforms a frame), 20000 and 30000 (the
    Bluestein kernel split by bin parity: two halves a frame, on one block
    and on clusters of two), 30002 and 32767 (the Bluestein kernel on
    clusters of four and eight), log, then 128 log mels (the mel kernel's
    chunked form, F = 8,193) and the 0-30 Hz band at 16384: one launch of
    the route's kernel a call and no GEMM launch, clip 0 within 1e-3 dB
    of scipy float64 (the band's rows, or the mel rows of scipy's PSD),
    the PSD within PSD_TOL of the plain version (float64 ``torch.fft``),
    a Bluestein config's clip 0 within BLUE_MODEL_TOL of the numpy model
    of its form, the mel rows within MEL_ULPS of the plain version; the
    kernel's ms (CUDA events, median of REPS after a warm-up) beside its
    bound, cuFFT's f64 yardstick (``library_psd``) and the plain
    version's. Returns the kernels' rows (the mel kernel's chunked form's
    row from the 128-mel config)."""
    import dataclasses
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.mel import mel_filterbank
    from spectral_tpu_torch.core.stft import (band_row_slice, freq_axis,
                                              num_frames)
    from spectral_tpu_torch.ops import mel_cuda, stft_cuda
    from spectral_tpu_torch.parallel.sharding import batched_spectrogram_fn
    from torch_precision import (bluestein_route_operands, frames_of,
                                 log_display, psd_bluestein, scipy_psd)

    n = int(FS * K2_SECONDS)
    gen = torch.Generator(device=dev).manual_seed(22)
    x = torch.randn((K2_CLIPS, n), generator=gen, device=dev)
    x0 = x[0].double().cpu().numpy()
    rows = {}
    configs = [(k, SpecConfig.scipy_default(k, log_scale=True), what)
               for k, what in LARGE_PATH]
    base = SpecConfig.scipy_default(16384, log_scale=True)
    configs += [(16384, dataclasses.replace(base, n_mels=128),
                 "128 log mels"),
                (16384, dataclasses.replace(base, fmin=0.0, fmax=30.0),
                 "the 0-30 Hz band")]
    for k, cfg, what in configs:
        route = stft_cuda.route(cfg)
        label = f"path 22, scipy_default {k}, {what}"
        phase(f"{label}: {K2_CLIPS} clips x {K2_SECONDS:g} s, the {route} "
              "route")
        T, F = num_frames(n, k, cfg.hop_), cfg.n_freqs
        band = (band_row_slice(freq_axis(cfg, FS), cfg.fmin, cfg.fmax)
                if cfg.fmax is not None else None)
        lo, hi = band or (0, F)
        fn = batched_spectrogram_fn(FS, cfg, flip_image=True)
        reset_counts()
        out = fn(x)
        torch.cuda.synchronize()
        counts = read_counts()
        flat = flat_counts(counts)
        print(f"launches by route: "
              + ", ".join(f"{r} {c}" for r, c in counts["stft_psd"].items()))
        want = {f"stft_{route}": 1, "clip_stats": 1, "rgba": 1}
        if cfg.n_mels:
            want["mel"] = 1
        require_counts(counts, want, label)
        require(flat["stft_gemm"] == 0, f"{label}: a GEMM launch")
        chunked = counts["mel_form"]["mel_chunked"]
        require(chunked == (1 if cfg.n_mels else 0),
                f"{label}: {chunked} launches of the mel kernel's chunked "
                "form")
        if route == "bluestein":
            print(f"the Bluestein kernel's form: {bluestein_form(k)}; "
                  f"launches {flat['stft_bluestein']}")
        # clip 0 against scipy float64: the band's rows, or its mel rows
        ref = scipy_psd(x0, cfg, FS)[lo:hi]
        if cfg.n_mels:
            ref = mel_filterbank(cfg.n_mels, F, FS) @ ref
        oracle, db_range = log_display(ref)
        img = out["image"][0].flip(0).double().cpu().numpy()
        require(img.shape == oracle.shape,
                f"{label}: image {img.shape}, scipy {oracle.shape}")
        db_err = float(np.max(np.abs(img - oracle)) * db_range)
        require(db_err <= DB_TOL, f"{label} clip 0 vs scipy f64: "
                f"{db_err:.3e} dB")
        consts = stft_cuda.plain_constants(cfg, FS, dev, band)
        psd_p = stft_cuda.stft_psd_reference(x, consts, cfg)
        rel, err = psd_err(out["psd"], psd_p)
        require(rel <= PSD_TOL, f"{label} psd vs plain: {rel:.2e}")
        print(f"clip 0 vs scipy float64: {db_err:.3e} dB (limit "
              f"{DB_TOL:g}); psd vs plain (torch.fft f64): {rel:.2e} of "
              f"clip max ({err:.3e} abs), largest float32 ulp distance "
              f"{ulp_distance(out['psd'], psd_p)}")
        if route == "bluestein" and band is None:
            # clip 0's frames through the numpy model of the kernel's form
            window, plan, wts = bluestein_route_operands(cfg, FS)
            p0 = stft_cuda.stft_psd(x[:1], FS, cfg)[0].cpu().numpy()
            want0 = psd_bluestein(frames_of(x0.astype(np.float32), cfg),
                                  window, plan, wts, cfg.detrend)
            m_err = float((np.abs(p0.astype(np.float64) - want0).max(axis=-1)
                           / want0.max(axis=-1)).max())
            require(m_err <= BLUE_MODEL_TOL, f"{label} clip 0 vs the numpy "
                    f"model: {m_err:.2e} of a frame's largest bin")
            print(f"clip 0 vs the numpy model of its form: {m_err:.2e} of a "
                  f"frame's largest bin (limit {BLUE_MODEL_TOL:.2e})")
        if cfg.n_mels:
            fb = mel_filterbank(cfg.n_mels, F, FS)
            spans = mel_cuda.mel_spans(fb, dev)
            mel_p, _ = mel_cuda.mel_project_reference(out["psd"], spans)
            mel_k = out["mel"]
            require(tuple(mel_k.shape) == tuple(mel_p.shape)
                    and torch.equal(torch.isnan(mel_k), torch.isnan(mel_p))
                    and ulp_distance(mel_k, mel_p) <= MEL_ULPS,
                    f"{label}: mel rows vs plain: "
                    f"{ulp_distance(mel_k, mel_p)} ulp")
            mel_err = float((mel_k.double() - mel_p).abs().max())
            print(f"mel rows (the chunked form) vs plain on the same PSD: "
                  f"{ulp_distance(mel_k, mel_p)} ulp (limit {MEL_ULPS}), "
                  f"{mel_err:.3e} abs")
            del mel_p
        del psd_p, out
        timings = {
            "stft_kernel": time_ms(lambda: stft_cuda.stft_psd(
                x, FS, cfg, with_stats=True, band=band)),
            "stft_plain": time_ms(lambda: stft_cuda.stft_psd_reference(
                x, consts, cfg, with_stats=True)),
            "stft_library": time_ms(lambda: library_psd(x, cfg)[..., lo:hi]),
            "pipeline_kernel": time_ms(lambda: fn(x)),
        }
        if cfg.n_mels:
            psd = stft_cuda.stft_psd(x, FS, cfg)
            spans = mel_cuda.mel_spans(mel_filterbank(cfg.n_mels, F, FS),
                                       dev)
            timings["mel_kernel"] = time_ms(
                lambda: mel_cuda.mel_project(psd, spans))
            timings["mel_plain"] = time_ms(
                lambda: mel_cuda.mel_project_reference(psd, spans))

            def mel_library():
                mm = torch.matmul(psd.double(), spans.rows.T)
                return mm, torch.amin(mm, dim=-1), torch.amax(mm, dim=-1)

            timings["mel_library"] = time_ms(mel_library)
            mb = mel_bound(K2_CLIPS, T, F, cfg.n_mels)
            print(f"mel kernel at F = {F}: {timings['mel_kernel'][0]:.3f} ms;"
                  f" bound {mb[0]:.3f} ms ({mb[1]}); torch.matmul f64 + "
                  f"amin/amax {timings['mel_library'][0]:.3f} ms [{card}]")
            del psd
        for name, (ms, reps) in timings.items():
            print(f"{name}: {ms:.3f} ms [{card}] reps {reps}")
        bound = stft_bound(K2_CLIPS, n, T, hi - lo, cfg.nfft_)
        ms = timings["pipeline_kernel"][0]
        print(f"STFT kernel ({route}): {timings['stft_kernel'][0]:.3f} ms; "
              f"bound {bound[0]:.3f} ms ({bound[1]}); cuFFT f64 "
              f"{timings['stft_library'][0]:.3f} ms; plain "
              f"{timings['stft_plain'][0]:.3f} ms; pipeline {ms:.3f} ms, "
              f"{K2_CLIPS * K2_SECONDS / 3600.0 / (ms / 60000.0):.1f} "
              f"audio-h/min [{card}]")
        print(json.dumps({f"path22_{k}_{what}_times": {
            key: v[0] for key, v in timings.items()}, "card": card}))
        if cfg.n_mels is None and band is None:
            rows[f"stft_large_{k}"] = dict(
                launches=flat[f"stft_{route}"], err=err,
                ms=timings["stft_kernel"][0],
                plain_ms=timings["stft_plain"][0], bound=bound,
                library_ms=timings["stft_library"][0])
        if cfg.n_mels:
            rows["mel_chunked"] = dict(
                launches=chunked, err=mel_err, ms=timings["mel_kernel"][0],
                plain_ms=timings["mel_plain"][0], bound=mb,
                library_ms=timings["mel_library"][0])
        torch.cuda.empty_cache()
    return rows


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
        print(f"export: {stats.breakdown().get('encode_ms_per_png')} ms of "
              f"encode CPU time a PNG through the {png_backend()} encoder")
        print(json.dumps({"export_breakdown": stats.breakdown(),
                          "png_backend": png_backend(),
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
    the mel axis, 600 mels over 513 bins (rows with no nonzero weight), T
    = 0, 128 mels over 1025 bins and 64 over 1537 (tiles of 16, the
    latter's weights read from global memory) on tiles of whole rows; 64
    mels over 4097 bins and 128 over 8193 in the chunked form. NaN and inf
    in the same places, the rest within MEL_ULPS float32 ulps, and the
    partials the same."""
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.mel import mel_centers, mel_filterbank
    from spectral_tpu_torch.core.stft import band_row_slice
    from spectral_tpu_torch.ops import mel_cuda

    phase("the mel kernel against its plain version")
    rs = np.random.RandomState(13)
    # each config with the form its launch must take (True: chunked)
    cases = [
        (SpecConfig.north_star(1024, 256, n_mels=128), FS, False),
        (SpecConfig.north_star(512, 128, n_mels=8), FS, False),
        (SpecConfig.north_star(256, 64, n_mels=40, mel_htk=True,
                               mel_fmin=300.0, mel_fmax=6000.0, fmin=500.0,
                               fmax=4000.0), FS, False),
        (SpecConfig.scipy_default(8192, n_mels=64), FS, True),
        (SpecConfig.north_star(1024, 256, n_mels=600), FS, False),
        (SpecConfig.north_star(2048, 512, n_mels=128), FS, False),
        (SpecConfig.north_star(3072, 768, n_mels=64), FS, False),
        (SpecConfig.scipy_default(16384, n_mels=128), FS, True),
    ]
    for cfg, fs, form in cases:
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
            chunked = mel_cuda.form_launches["mel_chunked"]
            got, gp = mel_cuda.mel_project(p, spans)
            torch.cuda.synchronize()
            want, wp = mel_cuda.mel_project_reference(p, spans)
            torch.cuda.synchronize()
            launched = mel_cuda.launches["mel"] - before["mel"]
            chunked = mel_cuda.form_launches["mel_chunked"] - chunked
            require(launched == (1 if p.shape[1] else 0)
                    and chunked == (launched if form else 0),
                    f"{what}: mel kernel launches {launched}, of the "
                    f"chunked form {chunked}")
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
        print(f"{what[:what.index(', T')]} "
              f"({'chunked' if form else 'tiles of whole rows'}): NaN "
              f"and inf in the plain version's places, "
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


def flat_counts(counts):
    """``read_counts()`` as one dict: stft_<route>, the display and mel
    kernels by name, hmm_<kernel>, the backward kernels by name."""
    return {**{f"stft_{k}": v for k, v in counts["stft_psd"].items()},
            **counts["display"], **counts["mel"],
            **{f"hmm_{k}": v for k, v in counts["hmm"].items()},
            **counts.get("grad", {})}


def require_counts(counts, want, what):
    """The path's run launched exactly ``want`` (kernel -> launches), every
    other count 0."""
    flat = flat_counts(counts)
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
    require(counts["mel_form"]["mel_chunked"] == 0,
            "path 12: 513 bins take tiles of whole rows, not the chunked "
            "form")
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
FIT_CHUNKED_CASES = (   # (T, B, variant, n_iter) of H3's EM loop
    (2048, 1, "init", 100), (4097, 3, "init", 100), (4097, 2, "zeros", 100),
    (4097, 2, "converged", 100), (2048, 4, "init", 0), (2048, 2, "init", 1),
    (65536, 2, "init", 12))


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


# every kernel of csrc/hmm.cu in nvcc's log: (entry pattern, label)
HMM_PTXAS = (r"(hmm_fit|hmm_viterbi|chunk_transfer|est_transfer|vit_scan|"
             r"vit_decode|vit_compose|vit_backtrace|est_scan|est_chunk|"
             r"est_reduce|est_mstep)_kernel(?:ILi(\d)E)?(?:Li(\d)E)?"
             r"(?:Lb(\d)E)?",
             lambda e: e.group(1) + (f"<KM {e.group(2)}" + (
                 f", KC {e.group(3)}" if e.group(3) else "") + (
                 f", LOGSUM {e.group(4)}" if e.group(4) else "") + ">"
                 if e.group(2) else ""))


def hmm_ptxas(log):
    return radix2_ptxas(log, *HMM_PTXAS)


def host_chunked_fit(X, p0, L, n_iter, tol):
    """The chunked EM loop as the port ran it before the loop moved to the
    card: ``models/hmm.py::_em_loop`` on the host over one launch of H3's
    E-step an iteration (``estep_chunked``) and the M-step in float64
    torch. Returns (params, ll, it)."""
    from spectral_tpu_torch.models import hmm
    from spectral_tpu_torch.ops import hmm_cuda
    K, D = p0[0].shape[-1], X.shape[-1]

    def estep(p, X):
        st, ll = hmm_cuda.estep_chunked(X, tuple(q.contiguous() for q in p),
                                        L)
        return hmm_cuda.split_stats(st, K, D), ll
    p, ll, it = hmm._em_loop(estep, hmm.HMMParams(*p0), X, n_iter, tol)
    return tuple(p), ll, it


# H3's kernels by stage, by a part of their names (the first match)
HMM_STAGES = (("transfer", "transfer"), ("scan", "est_scan"),
              ("chunk_pass", "est_chunk"), ("reduce_mstep", "est_mstep"),
              ("reduce_mstep", "est_reduce"))


# H2 chunked's five kernels, by a part of their names
H2_STAGES = (("transfer", "chunk_transfer"), ("scan", "vit_scan"),
             ("decode", "vit_decode"), ("compose", "vit_compose"),
             ("backtrace", "vit_backtrace"))


def kernel_split(fn, stages):
    """fn() once under torch.profiler, the device traced alone: the summed
    device ms of the kernels of each stage ((stage, part of the kernel's
    name) pairs, the first that matches), the device's busy ms and its
    idle share over the span from its first event to its last, and the
    device-to-host copies; None when the profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.5)               # let the device tracing start first
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = max(b for _, b in spans) - spans[0][0]
    split = {}
    for e in device:
        stage = next((st for st, part in stages if part in e.name), None)
        if stage:
            split[stage] = split.get(stage, 0.0) + 1e-3 * (
                e.time_range.end - e.time_range.start)
    copies = sum("DtoH" in e.name or "Device -> P" in e.name for e in device)
    return {"stage_ms": split, "busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "idle_share": 1 - busy / span if span else 0.0,
            "d2h_copies": copies}


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

    # H3's EM loop on the card against the plain loop (the host loop over
    # the plain E-step) and, bitwise, against the host loop over H3's
    # single E-step and the torch M-step
    for T, B, variant, n_iter in FIT_CHUNKED_CASES:
        feats = [hmm_features(np.random.RandomState(T + s), T)
                 for s in range(B)]
        X = torch.tensor(np.stack(feats), device=dev)
        p0 = tuple(stack_params([hmm_params(f, 4, dev, variant)
                                 for f in feats]))
        tol = 1e30 if variant == "converged" else hmm.DEFAULT_TOL
        L = hmm_cuda.chunk_len(4)
        got, ll, it = hmm_cuda.fit_chunked(X, p0, L, n_iter, tol)
        host, ll_h, it_h = host_chunked_fit(X, p0, L, n_iter, tol)
        want, ll_p, it_p = hmm_cuda.fit_chunked_reference(X, p0, L, n_iter,
                                                          tol)
        torch.cuda.synchronize()
        same = (all(bitwise(g, h) for g, h in zip(got, host))
                and bitwise(ll, ll_h) and bitwise(it, it_h))
        errs = [field_err(g, w) for g, w in zip(got, want)]
        if n_iter == 0:
            ll_rel = 0.0 if bool(torch.isneginf(ll).all()) else math.inf
        else:
            ll_rel = float(((ll - ll_p).abs() / ll_p.abs()).max())
        line = (f"H3's EM loop T={T} B={B} {variant} n_iter {n_iter}: "
                f"iterations {it.tolist()} (plain {it_p.tolist()}), params "
                f"max rel {max(errs):.2e}, ll rel {ll_rel:.2e}; bitwise the "
                f"host loop over one E-step a launch {same}")
        require(same and torch.equal(it, it_p)
                and max(errs) <= HMM_PARAM_TOL and ll_rel <= HMM_LL_TOL
                and (variant != "converged" or it.tolist() == [2] * B)
                and (n_iter > 0 or all(bitwise(g, q)
                                       for g, q in zip(got, p0))), line)
        if variant == "zeros" and n_iter > 0:
            require(bool((got[1][:, 0, 3] == 0).all())
                    and bool((got[0][:, 2:] == 0).all()),
                    "H3's EM loop keeps structural zeros")
        print(line)


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


def in_events(t, events):
    """Whether each time lies in one of the (start, end) intervals, ends
    included: the largest end among the intervals that start at or before
    it reaches it (a search, not a pass over t an event: an hour's decode
    splits the noise floor into hundreds of thousands of events)."""
    import numpy as np
    if not len(events):
        return np.zeros(len(t), bool)
    iv = np.asarray(sorted(events), np.float64)
    reach = np.maximum.accumulate(iv[:, 1])
    k = np.searchsorted(iv[:, 0], t, side="right") - 1
    return (k >= 0) & (t <= reach[np.maximum(k, 0)])


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
        inev = in_events(t, events[b])
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
        "viterbi_kernel_run": time_ms(lambda: hmm_cuda.viterbi_seq(
            X, patched), run=RUN),
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
    vit_ms = tm["viterbi_kernel_run"][0]
    print(f"H2's chain: {T - 1} steps a sweep, {EEG_CLIPS} sweeps at once; "
          f"H2 {vit_ms:.4f} ms in runs of {RUN} "
          f"({tm['viterbi_kernel'][0]:.4f} a single call through the "
          f"wrapper), {1e6 * vit_ms / (T - 1):.1f} ns a step [{card}]")
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
                        bound=fit_bound, library_ms=None, extra={
                            "ns_a_step": 1e6 * tm["fit_kernel"][0] / steps,
                            "iterations": int(its.max())}),
        "hmm_viterbi": dict(launches=counts["hmm"]["viterbi"], err=vit_err,
                            ms=vit_ms, plain_ms=vit_plain_ms,
                            bound=vit_bound, library_ms=None, extra={
                                "single_call_ms": tm["viterbi_kernel"][0],
                                "ns_a_step": 1e6 * vit_ms / (T - 1)})}


LONG_FS = 48000.0
LONG_T = 524288         # frames: an hour of 48 kHz audio at hop 256


def long_detect_path(dev, card, dfma_peak):
    """Path 15, one long recording: BurstDetector(engine='auto') on 524,288
    frames (48 kHz, north_star 1024/256, 134,218,496 samples), features
    0-4000 Hz: the chunked engine (H3's EM loop on the card, then H2's
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
    hmm_cuda.flag_reads["fit_chunked"] = 0
    t0 = time.perf_counter()
    psd = power_spectrogram(x, LONG_FS, cfg, band=band)
    feats = ev.features_from_psd(fb, psd, 0.0, 4000.0)[0]
    events = det.unsupervised_detect(t, feats)
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"launches in this path's run: {counts}")
    iters = det.timings["iterations"]
    reads = hmm_cuda.flag_reads["fit_chunked"]
    require_counts(counts, {"stft_fft": 1, "hmm_fit_chunked": 1,
                            "hmm_viterbi_chunked": 1}, "path 15")
    require(iters >= 1 and len(events) >= 1, f"path 15: {iters} "
            f"iterations, {len(events)} events")
    require(reads <= math.ceil(iters / hmm_cuda.EM_GROUP) + 1,
            f"path 15: {reads} host reads of the flags for {iters} "
            f"iterations")
    print(f"the EM loop on the card: {iters} iterations, {reads} host reads "
          f"of the flags (groups of {hmm_cuda.EM_GROUP})")
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

    # the loop from the detector's start (the host k-means again), against
    # the host loop over one E-step a launch and the torch M-step, bitwise
    p0 = tuple(q[None].contiguous() for q in hmm.init_params(
        feats.cpu().numpy(), 4, seed=det.seed, device=dev))
    fit_k = hmm_cuda.fit_chunked(X, p0, L, det.n_iter, hmm.DEFAULT_TOL)
    fit_h = host_chunked_fit(X, p0, L, det.n_iter, hmm.DEFAULT_TOL)
    require(all(bitwise(a, b) for a, b in zip((*fit_k[0], fit_k[1]),
                                                (*fit_h[0], fit_h[1])))
            and torch.equal(fit_k[2], fit_h[2]) and int(fit_k[2][0]) == iters,
            "path 15: the EM loop on the card vs the host loop over H3's "
            "E-step and the torch M-step (bitwise)")
    print(f"the EM loop on the card: bitwise the host loop over one E-step "
          f"a launch and the torch M-step ({iters} iterations)")
    split = kernel_split(lambda: hmm_cuda.fit_chunked(
        X, p0, L, det.n_iter, hmm.DEFAULT_TOL), HMM_STAGES)
    if split is None:
        print("path 15's EM loop: torch.profiler shows no device time on "
              "this machine")
    else:
        print(f"path 15's EM loop, {iters} iterations: kernels by stage "
              f"{split['stage_ms']} ms; device busy {split['busy_ms']:.3f} "
              f"ms of {split['span_ms']:.3f} (idle share "
              f"{split['idle_share']:.4f}); {split['d2h_copies']} "
              f"device-to-host copies [{card}]")
    vsplit = kernel_split(lambda: [hmm_cuda.viterbi_chunked(X, patched, L)
                                   for _ in range(REPS)], H2_STAGES)
    if vsplit is None:
        print("path 15's H2 chunked: torch.profiler shows no device time on "
              "this machine")
    else:
        vsplit = {k: v / REPS for k, v in vsplit["stage_ms"].items()}
        print(f"path 15's H2 chunked ({math.ceil(LONG_T / L)} chunks of {L}):"
              f" its five kernels' device ms a call {vsplit} [{card}]")
    tm = {
        "stft_kernel": time_ms(lambda: stft_cuda.stft_psd(
            x, LONG_FS, cfg, band=band)),
        "fit_chunked": time_ms(lambda: hmm_cuda.fit_chunked(
            X, p0, L, det.n_iter, hmm.DEFAULT_TOL), reps=3),
        "fit_chunked_plain_one_iteration": time_ms(
            lambda: hmm_cuda.fit_chunked_reference(
                X, p0, L, 1, hmm.DEFAULT_TOL), reps=1),
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
    it_ms = tm["fit_chunked"][0] / iters
    print(f"host: init (k-means) {det.timings['init']:.3f} s, the EM loop + "
          f"patch + Viterbi + states read {fit_s:.3f} s "
          f"({1e3 * fit_s / iters:.3f} ms an iteration beside the loop's "
          f"{it_ms:.3f} ms an iteration on the card and one E-step's "
          f"{tm['estep_kernel'][0]:.3f} ms; "
          f"a device-to-host read of the flags {read_ms:.4f} ms), "
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
                      "flag_reads": reads, "split": split,
                      "wall_s": wall, "card": card}))
    return {
        "hmm_fit_chunked": dict(
            launches=counts["hmm"]["fit_chunked"], err=st_abs,
            ms=it_ms, plain_ms=tm["fit_chunked_plain_one_iteration"][0],
            bound=est_bound, library_ms=None, extra={
                "ns_a_step": 1e6 * it_ms / (2 * L + math.ceil(LONG_T / L)),
                "loop_ms": tm["fit_chunked"][0], "iterations": iters,
                "flag_reads": reads, "estep_ms": tm["estep_kernel"][0],
                "split_ms_an_iteration": None if split is None else {
                    k: v / iters for k, v in split["stage_ms"].items()},
                "idle_share": None if split is None
                else split["idle_share"]}),
        "hmm_viterbi_chunked": dict(
            launches=counts["hmm"]["viterbi_chunked"], err=vit_err,
            ms=tm["viterbi_kernel"][0], plain_ms=tm["viterbi_plain"][0],
            bound=vit_bound, library_ms=None,
            extra={"split_ms": vsplit,
                   "ns_a_step": 1e6 * tm["viterbi_kernel"][0]
                   / (3 * L + 2 * math.ceil(LONG_T / L))})}


SESSION_FS = 48000.0
SESSION_SECONDS = 3600.0   # an hour at 48 kHz, the JAX README's hour row
SESSION_CUT_SECONDS = 600.0
SESSION_REPS = 5
ABF_SWEEPS = 20
ABF_SECONDS = 60.0
ABF_FS = 20000.0


_SHARED = {}


def shared_dir():
    """One temporary directory for the whole run, removed at exit: paths
    16 and 19 read the same recordings from it."""
    if "dir" not in _SHARED:
        import atexit
        import shutil
        _SHARED["dir"] = tempfile.mkdtemp(prefix="chip_smoke_")
        atexit.register(shutil.rmtree, _SHARED["dir"], True)
    return _SHARED["dir"]


def session_wav(dev):
    """Path 16's recording: an hour at 48 kHz with path 15's kind of
    planted bursts, written once as a 16-bit WAV. Returns (path, plans,
    seconds the write took)."""
    if "wav" not in _SHARED:
        from spectral_tpu_torch.io.wav import write_wav
        fs = SESSION_FS
        x, plans = bursty_batch(dev, 1, int(fs * SESSION_SECONDS), fs,
                                4000.0, 200.0, 3000.0, 16)
        wav = os.path.join(shared_dir(), "hour.wav")
        t0 = time.perf_counter()
        write_wav(wav, 0.1 * x[0].cpu().numpy(), fs)
        _SHARED["wav"] = (wav, plans, time.perf_counter() - t0)
    return _SHARED["wav"]


def session_abf(dev):
    """Path 16's ABF file: ABF_SWEEPS sweeps of ABF_SECONDS at ABF_FS with
    planted bursts, written once. Returns (path, plans)."""
    if "abf" not in _SHARED:
        from spectral_tpu_torch.io.abf import write_abf2_fixture
        xa, plans = bursty_batch(dev, ABF_SWEEPS, int(ABF_FS * ABF_SECONDS),
                                 ABF_FS, 2000.0, 100.0, 1500.0, 17)
        abf = os.path.join(shared_dir(), "abf.abf")
        write_abf2_fixture(abf, xa.cpu().numpy(), ABF_FS)
        _SHARED["abf"] = (abf, plans)
    return _SHARED["abf"]


def png_backend():
    """The backend ``render/png.py`` encodes with: native, PIL or zlib."""
    from spectral_tpu_torch.render import png
    if png._get_native() is not None:
        return "native"
    try:
        import PIL  # noqa: F401
        return "PIL"
    except ImportError:
        return "zlib"


def encode_ms(rgba, level=4):
    """ms to encode one RGBA image through each backend, the same pixels
    and level; the native and PIL bytes decode to the same pixels."""
    import io
    from PIL import Image
    from spectral_tpu_torch.native import png_native
    from spectral_tpu_torch.render.png import decode_png, encode_png_pure

    def pil(a):
        buf = io.BytesIO()
        Image.fromarray(a, "RGBA").save(buf, format="PNG",
                                        compress_level=level)
        return buf.getvalue()

    out = {}
    for name, fn in (("native", lambda a: png_native.encode(a, level)),
                     ("PIL", pil),
                     ("zlib", lambda a: encode_png_pure(a, level))):
        t0 = time.perf_counter()
        data = fn(rgba)
        out[name] = (1e3 * (time.perf_counter() - t0), len(data))
        if name != "zlib":
            require(bool((decode_png(data) == rgba).all()),
                    f"{name} PNG decodes to other pixels")
    return out


def plain_unsupervised(det, feats, dev):
    """``det.unsupervised_detect``'s compute through the plain versions on
    the card: the same host k-means start, the host EM loop over the
    chunked E-step's plain version, the escape-route patch and the chunked
    Viterbi's plain version. Returns (patched params, states (T,) numpy,
    baseline, log-likelihood, iterations)."""
    import numpy as np
    import torch
    from spectral_tpu_torch.models import hmm
    from spectral_tpu_torch.ops import hmm_cuda
    K, D = det.n_states, feats.shape[-1]
    L = hmm_cuda.chunk_len(K)

    def estep(p, X):
        st, ll = hmm_cuda.estep_chunked_reference(X, p, L)
        return hmm_cuda.split_stats(st, K, D), ll

    def fit(p0, X, n_iter, tol):
        return hmm._em_loop(estep, p0, X, n_iter, tol)

    p0 = hmm.init_params(feats, K, seed=det.seed, device=dev)
    X = torch.as_tensor(feats.astype(np.float64), device=dev)
    p0, X, _ = hmm._as_batch(p0, X)
    params, states, base, ll, it = hmm._decode_patched(
        fit, lambda p, X: hmm_cuda.viterbi_chunked_reference(X, p, L),
        p0, X, det.n_iter, hmm.DEFAULT_TOL)
    return (hmm.HMMParams(*(q[0] for q in params)), states[0].cpu().numpy(),
            int(base[0]), float(ll[0]), int(it[0]))


def nonzero_counts(counts):
    """A run's launch counts, the kernels launched only."""
    return {k: v for k, v in flat_counts(counts).items() if v}


def session_path(dev, card):
    """Path 16, the interactive session (the reference app's flow,
    spectral_tpu/api/session.py): an hour of 48 kHz audio written as a
    16-bit WAV and loaded through ``SweepRegistry``, then
    ``AnalysisSession(device="cuda")``: ``plot_sweeps`` at
    scipy_default(1024, fmin=0, fmax=4000) (one STFT kernel launch), a
    10-minute cut held to scipy float64, a 128-mel log plot with a
    global max (the mel kernel), ``unsupervised_detect`` (the PSD
    recomputed: it is past the session's 64 Mi cache cap; H3 under the
    host EM loop, H2 chunked), the CSV and PNG exports, and an ABF file's
    20 sweeps combined, attributed in the CSV and learned from two
    ROIs."""
    import csv
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig, ViewSettings
    from spectral_tpu_torch.api.session import AnalysisSession, _power
    from spectral_tpu_torch.core import events as ev
    from spectral_tpu_torch.core.mel import mel_centers, mel_filterbank
    from spectral_tpu_torch.core.scale import normalize
    from spectral_tpu_torch.core.stft import band_row_slice, freq_axis
    from spectral_tpu_torch.models import hmm
    from spectral_tpu_torch.models.detector import BurstDetector
    from spectral_tpu_torch.native import png_native
    from spectral_tpu_torch.ops import hmm_cuda, mel_cuda, stft_cuda
    from spectral_tpu_torch.ops.colormap import (apply_colormap_packed,
                                                 unpack_rgba)
    from spectral_tpu_torch.render.png import decode_png, encode_png_pure
    from torch_precision import log_display, scipy_psd

    require(png_native.available() and png_backend() == "native",
            "the native PNG encoder is not the session's backend")
    fs = SESSION_FS
    n = int(fs * SESSION_SECONDS)
    cfg = SpecConfig.scipy_default(1024, fmin=0.0, fmax=4000.0)
    f = freq_axis(cfg, fs)
    lo, hi = band_row_slice(f, 0.0, 4000.0)
    phase(f"path 16, the interactive session: {SESSION_SECONDS:g} s at "
          f"{fs:g} Hz ({n} samples) as a 16-bit WAV, scipy_default 1024, "
          f"0-4000 Hz (bins {lo}-{hi - 1})")
    wav, plans, write_s = session_wav(dev)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        s = AnalysisSession(device=dev)
        names = s.load(wav)
        load_s = write_s + time.perf_counter() - t0
        require(names == ["hour_sweep0"], f"registered {names}")
        print(f"{len(plans[0])} bursts planted; WAV written and loaded "
              f"through SweepRegistry.load_file in {load_s:.3f} s")

        # the plot: one STFT launch, held to the plain versions
        reset_counts()
        t0 = time.perf_counter()
        res = s.plot_sweeps(names, cfg)
        first_s = time.perf_counter() - t0
        counts = read_counts()
        print(f"launches in the plot: {counts}")
        require_counts(counts, {"stft_fft": 1}, "path 16 plot")
        run_counts = {"plot": nonzero_counts(counts)}
        T = len(res.t)
        require(res.sxx.shape == (hi - lo, T) and res.image.shape
                == res.sxx.shape and bool(np.isfinite(res.sxx).all())
                and float(res.image.max()) == 1.0
                and (s._psd_cache is None) == (T * cfg.n_freqs > 2 ** 26),
                "path 16 plot shapes, range and the PSD cache's cap")
        xd = torch.as_tensor(s.spec_data_source, device=dev)
        psd_p = stft_cuda.stft_psd_reference(
            xd[None], stft_cuda.dft_constants(cfg, fs, dev), cfg)[0]
        sxx_p = psd_p[:, lo:hi].T.contiguous()
        sxx_k = torch.as_tensor(res.sxx, device=dev)
        rel, abs_ = psd_err(sxx_k[None], sxx_p[None])
        img_err = float((torch.as_tensor(res.image, device=dev)
                         - normalize(sxx_p)).abs().max())
        require(rel <= PSD_TOL and img_err <= IMAGE_TOL,
                f"path 16 plot vs plain: psd {rel:.2e}, image {img_err:.2e}")
        print(f"{T} frames x {hi - lo} rows on the host; vs the plain "
              f"float64 PSD on the card: psd max rel {rel:.2e} ({abs_:.2e} "
              f"abs), image {img_err:.2e}; the full PSD {T * cfg.n_freqs} "
              f"elements, cached for detection: {s._psd_cache is not None} "
              f"(the cap is 64 Mi)")
        del psd_p

        # the plot's latency and its split
        walls = []
        for _ in range(SESSION_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.plot_sweeps(names, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        h2d = []
        for _ in range(SESSION_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xd = torch.as_tensor(s.spec_data_source, device=dev)
            torch.cuda.synchronize()
            h2d.append(time.perf_counter() - t0)
        stft_ms = time_ms(lambda: _power(xd, fs, cfg))
        psd = _power(xd, fs, cfg)

        def display():
            band = psd.transpose(-1, -2)[lo:hi]
            return torch.stack([band, normalize(band)])

        disp_ms = time_ms(display)
        packed = display()
        d2h = []
        for _ in range(SESSION_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            packed.cpu()
            d2h.append(time.perf_counter() - t0)
        med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
        lat = {"plot_wall_ms": 1e3 * med(walls), "first_plot_ms":
               1e3 * first_s, "h2d_ms": 1e3 * med(h2d),
               "stft_kernel_ms": stft_ms[0], "band_normalize_ms": disp_ms[0],
               "d2h_ms": 1e3 * med(d2h)}
        lat["host_rest_ms"] = lat["plot_wall_ms"] - sum(
            lat[k] for k in ("h2d_ms", "stft_kernel_ms", "band_normalize_ms",
                             "d2h_ms"))
        print(f"plot latency, median of {SESSION_REPS} after a warm-up, the "
              f"card synchronised: {lat['plot_wall_ms']:.3f} ms (the first "
              f"plot {lat['first_plot_ms']:.3f}); the waveform's upload "
              f"{lat['h2d_ms']:.3f} ms ({xd.numel() * 4 / 2 ** 20:.0f} MiB), "
              f"the STFT kernel {lat['stft_kernel_ms']:.3f} ms (CUDA events),"
              f" band + normalize + stack {lat['band_normalize_ms']:.3f} ms, "
              f"the display pair's copy to the host {lat['d2h_ms']:.3f} ms "
              f"({packed.numel() * 4 / 2 ** 20:.0f} MiB), the rest on the "
              f"host {lat['host_rest_ms']:.3f} ms [{card}]")
        print(json.dumps({"path16_plot": lat, "frames": T, "card": card}))
        del psd, packed

        # a 10-minute cut through the same session against scipy float64
        cut = int(fs * SESSION_CUT_SECONDS)
        entry = s.registry.data[names[0]]
        s.registry.register("cut_sweep0", type(entry)(
            filepath=wav, sweep_idx=0, fs=fs, fs_raw=fs,
            raw=entry.raw[:cut], processed=None))
        cfg_log = SpecConfig.scipy_default(1024, fmin=0.0, fmax=4000.0,
                                           log_scale=True)
        reset_counts()
        rc = s.plot_sweeps(["cut_sweep0"], cfg_log)
        require_counts(read_counts(), {"stft_fft": 1}, "path 16 cut")
        oracle, rng_db = log_display(scipy_psd(
            s.spec_data_source.astype(np.float64), cfg_log, fs)[lo:hi])
        db_err = float(np.max(np.abs(rc.image - oracle)) * rng_db)
        require(db_err <= DB_TOL, f"path 16 cut vs scipy: {db_err:.2e} dB")
        print(f"the {SESSION_CUT_SECONDS:g} s cut ({len(rc.t)} frames, log) "
              f"vs scipy float64: {db_err:.2e} dB (limit {DB_TOL:g})")

        # mel rows and a global max: the mel kernel once
        cfg_mel = SpecConfig.scipy_default(1024, fmin=0.0, fmax=4000.0,
                                           n_mels=128, log_scale=True)
        gm = 2.0 * float(res.sxx.max())
        reset_counts()
        rm = s.plot_sweeps(names, cfg_mel, global_max=gm)
        counts = read_counts()
        require_counts(counts, {"stft_fft": 1, "mel": 1}, "path 16 mel")
        run_counts["mel_plot"] = nonzero_counts(counts)
        m_lo, m_hi = band_row_slice(mel_centers(128, fs), 0.0, 4000.0)
        spans = mel_cuda.mel_spans(mel_filterbank(128, cfg.n_freqs, fs)
                                   [m_lo:m_hi], dev)
        psd_k = stft_cuda.stft_psd(xd, fs, cfg_mel)
        mel_p = mel_cuda.mel_project_reference(psd_k[None], spans)[0][0].T
        mel_k = torch.as_tensor(rm.sxx, device=dev)
        ulps = ulp_distance(mel_k, mel_p)
        mel_img = float((torch.as_tensor(rm.image, device=dev) - normalize(
            mel_p.contiguous(), True, gm)).abs().max())
        require(rm.sxx.shape == (m_hi - m_lo, T) and ulps <= MEL_ULPS
                and mel_img <= IMAGE_TOL and torch.equal(
                    torch.isfinite(mel_k), torch.isfinite(mel_p)),
                f"path 16 mel vs plain: {ulps} ulps, image {mel_img:.2e}")
        print(f"mel plot: {m_hi - m_lo} of 128 mel rows in the band, "
              f"launches {counts}; vs the plain version {ulps} ulps, image "
              f"{mel_img:.2e} (global max {gm:.4g})")
        del psd_k, mel_p, mel_k

        # detection on the linear plot: the PSD recomputed on the card
        s.plot_sweeps(names, cfg)
        det = s.detector
        reset_counts()
        t0 = time.perf_counter()
        events = s.unsupervised_detect()
        det_s = time.perf_counter() - t0
        counts = read_counts()
        iters = det.timings["iterations"]
        print(f"launches in the detection: {counts}")
        require_counts(counts, {"stft_fft": 1, "hmm_fit_chunked": 1,
                                "hmm_viterbi_chunked": 1}, "path 16 detect")
        run_counts["detect"] = nonzero_counts(counts)
        # the same detection through the plain versions on the card: the
        # fit's 46-odd E-steps, the fitted parameters, every frame's state
        # and the event list
        t, feat = s._features()
        p_par, states, base, ll_p, it_p = plain_unsupervised(det, feat, dev)
        perr = max(field_err(g, w) for g, w in zip(det.params, p_par))
        require(it_p == iters and perr <= HMM_PARAM_TOL
                and base == int(torch.argmin(det.params.means[:, 0])),
                f"path 16 fit vs plain: iterations {iters} (plain {it_p}), "
                f"params max rel {perr:.2e}")
        X = torch.as_tensor(feat, dtype=torch.float64, device=dev)[None]
        patched = hmm.HMMParams(*(q[None].contiguous() for q in det.params))
        L = hmm_cuda.chunk_len(det.n_states)
        states_k = hmm_cuda.viterbi_chunked(X, patched, L)[0].cpu().numpy()
        vit_diff = int((states_k != states).sum())
        require(vit_diff == 0 and events == ev.merge_overlapping_events(
            ev.baseline_scan(states, t, base)),
            f"path 16 Viterbi vs plain: {vit_diff} of {len(t)} states "
            "differ, or the events are not the plain states' events")
        st, ll = hmm_cuda.estep_chunked(X, patched, L)
        st_p, ll_q = hmm_cuda.estep_chunked_reference(X, patched, L)
        ll_rel = float((ll - ll_q).abs().max() / ll_q.abs().max())
        errs = [field_err(g, w) for g, w in zip(
            hmm_cuda.split_stats(st, det.n_states, X.shape[-1]),
            hmm_cuda.split_stats(st_p, det.n_states, X.shape[-1]))]
        require(ll_rel <= HMM_LL_TOL and max(errs) <= HMM_STATS_TOL,
                f"path 16 H3 vs plain: ll {ll_rel:.2e}, statistics {errs}")
        print(f"vs the plain versions on the card: the fit's {it_p} "
              f"iterations, params max rel {perr:.2e}; all {len(t)} states "
              f"identical and the same {len(events)} events; H3 at the "
              f"fitted model ll rel {ll_rel:.2e}, statistics max rel "
              f"{max(errs):.2e}")
        check_detection(f"path 16, {len(plans[0])} bursts planted, "
                        f"{len(events)} events", detection_quality(
                            t, states[None],
                            det.params.means[None].cpu().numpy(), plans,
                            [events]))
        print(f"unsupervised_detect: {det_s:.3f} s of wall time, {iters} EM "
              f"iterations: the host's k-means {det.timings['init']:.3f} s, "
              f"the EM loop + patch + Viterbi + states read "
              f"{det.timings['fit']:.3f} s, scans "
              f"{1e3 * det.timings['scan']:.3f} ms, the rest (the STFT "
              f"kernel, features, copies) "
              f"{det_s - det.timings['init'] - det.timings['fit'] - det.timings['scan']:.3f}"
              f" s [{card}]")

        # the exports: their status strings, the files they wrote
        csv_path = os.path.join(tmp, "bursts.csv")
        msg = s.export_csv(csv_path)
        require(msg.startswith(f"Successfully exported {len(events)} "
                               "events"), f"path 16 CSV: {msg}")
        with open(csv_path) as fh:
            rows = list(csv.reader(fh))
        require(len(rows) == len(events) + 1
                and all(r[1] == "hour" and r[2] == "0" for r in rows[1:]),
                "path 16 CSV rows")
        png_path = os.path.join(tmp, "hour.png")
        t0 = time.perf_counter()
        msg = s.export_png(png_path)
        export_ms = 1e3 * (time.perf_counter() - t0)
        require(msg.startswith("Successfully"), f"path 16 PNG: {msg}")
        want = unpack_rgba(apply_colormap_packed(
            torch.as_tensor(s.last_image, device=dev), flip_rows=True))
        require(bool((decode_png(png_path) == want).all()),
                "path 16 PNG decodes to the colormapped image")
        enc = encode_ms(want)
        # level 0 (stored blocks): the stdlib encoder's bytes against the
        # native encoder's, the case that keeps the native encoder first
        l0 = {"native": png_native.encode(want, 0),
              "zlib": encode_png_pure(want, 0)}
        require(all(bool((decode_png(v) == want).all()) for v in l0.values()),
                "path 16 level-0 PNGs decode to other pixels")
        l0_same = l0["native"] == l0["zlib"]
        print(f"at compress level 0 the native and stdlib-zlib bytes are "
              f"{'identical' if l0_same else 'different'} ({len(l0['native'])}"
              f" and {len(l0['zlib'])} bytes, the same pixels)")
        del l0
        print(f"export_png ({want.shape[1]} x {want.shape[0]} RGBA): "
              f"{export_ms:.1f} ms through the {png_backend()} encoder; the "
              f"same image encoded at level 4: "
              + ", ".join(f"{k} {v[0]:.1f} ms ({v[1]} bytes)"
                          for k, v in enc.items()) + f" [{card}]")
        print(json.dumps({"path16_detect_s": det_s,
                          "host": det.timings, "export_png_ms": export_ms,
                          "encode_ms": {k: v[0] for k, v in enc.items()},
                          "backend": png_backend(),
                          "level0_bytes_identical": l0_same, "card": card}))

        # ABF sweeps combined: the segment map, the CSV's attribution, two
        # ROIs learned
        abf, plans_a = session_abf(dev)
        sa = AnalysisSession(device=dev)
        names_a = sa.load(abf)
        require(len(names_a) == ABF_SWEEPS, f"ABF sweeps {names_a}")
        cfg_a = SpecConfig.scipy_default(1024, fmin=0.0, fmax=2000.0)
        reset_counts()
        ra = sa.plot_sweeps(names_a, cfg_a, ViewSettings(combine=True))
        require_counts(read_counts(), {"stft_fft": 1}, "path 16 ABF plot")
        spans_ok = all(
            seg.source_name == names_a[k]
            and abs(seg.start_time_combined - k * ABF_SECONDS) < 1e-9
            and abs(seg.end_time_combined - (k + 1) * ABF_SECONDS) < 1e-9
            for k, seg in enumerate(sa.segment_map))
        require(len(sa.segment_map) == ABF_SWEEPS and spans_ok,
                "path 16 ABF segment map")
        planted = [(k * ABF_SECONDS + a, k * ABF_SECONDS + a + m)
                   for k, plan in enumerate(plans_a) for a, m, _, _ in plan]
        require(len(planted) >= 2, f"{len(planted)} ABF bursts planted")
        rois = [(a - 2.0, b + 2.0) for a, b in planted[:2]]
        reset_counts()
        t0 = time.perf_counter()
        ev_a = sa.learn_and_detect(rois)
        learn_s = time.perf_counter() - t0
        counts = read_counts()
        n_fit = counts["hmm"]["fit"]
        print(f"launches in the ABF learn: {counts}")
        require(1 <= n_fit <= len(rois), f"path 16 ABF learn: {n_fit} ROI "
                "fits")
        # each ROI fitted (H1) and decoded (H2) on its own, then the whole
        # sequence's decode (H2 chunked)
        require_counts(counts, {"hmm_fit": n_fit, "hmm_viterbi": n_fit,
                                "hmm_viterbi_chunked": 1,
                                "stft_fft": int(sa._psd_cache is None)},
                       "path 16 ABF learn")
        run_counts["abf_learn"] = nonzero_counts(counts)
        # its Viterbi against the plain version on the card, every frame;
        # the whole learn through the plain versions (a CPU detector)
        t_a, feat_a = sa._features()
        X = torch.as_tensor(feat_a, dtype=torch.float64, device=dev)[None]
        fitted = hmm.HMMParams(*(q[None].contiguous()
                                 for q in sa.detector.params))
        L = hmm_cuda.chunk_len(sa.detector.n_states)
        st_k = hmm_cuda.viterbi_chunked(X, fitted, L)
        st_p = hmm_cuda.viterbi_chunked_reference(X, fitted, L)
        diff_a = int((st_k != st_p).sum())
        cpu_det = BurstDetector(device="cpu")
        ev_cpu = cpu_det.learn_and_detect(t_a, feat_a, rois)
        perr_a = max(field_err(g.cpu(), w) for g, w in zip(
            sa.detector.params, cpu_det.params))
        require(diff_a == 0 and ev_a == ev.merge_overlapping_events(
            ev.label_scan(st_p[0].cpu().numpy(), t_a)) and ev_a == ev_cpu
            and perr_a <= HMM_PARAM_TOL,
            f"path 16 ABF learn vs plain: {diff_a} of {len(t_a)} states "
            f"differ, params max rel {perr_a:.2e}, events {len(ev_a)} "
            f"(plain {len(ev_cpu)})")
        print(f"ABF learn vs the plain versions: all {len(t_a)} states "
              f"identical on the card; the learn on a CPU detector gives "
              f"the same {len(ev_a)} events, params max rel {perr_a:.2e}")
        csv_a = os.path.join(tmp, "abf.csv")
        msg = sa.export_csv(csv_a)
        require(msg.startswith("Successfully") and len(ev_a) >= 2,
                f"path 16 ABF learn: {len(ev_a)} events, {msg}")
        with open(csv_a) as fh:
            rows_a = list(csv.reader(fh))[1:]
        require(all(r[1] == "abf" and int(r[2]) == int(float(r[3])
                                                       // ABF_SECONDS)
                    for r in rows_a), "path 16 ABF CSV attribution")
        hits = sum(any(s_ <= b and e_ >= a for s_, e_ in ev_a)
                   for a, b in planted)
        print(f"ABF: {ABF_SWEEPS} sweeps x {ABF_SECONDS:g} s at {ABF_FS:g} "
              f"Hz combined ({len(ra.t)} frames), segment map and CSV "
              f"attribution checked; learn_and_detect from 2 ROIs: "
              f"{len(ev_a)} events, {hits} of {len(planted)} planted bursts "
              f"overlapped, {learn_s:.3f} s [{card}]")
    return {"session_launches": run_counts}


# ---------------------------------------------------------------------------
# long recordings in bounded memory (parallel/streaming.py), the sweep grid
# (parallel/sweep_grid.py) and the Qt window (gui/): paths 17-18, the GUI
# ---------------------------------------------------------------------------

STREAM_FS = 48000.0
STREAM_SECONDS = 3600.0     # BASELINE.json config 4: an hour, stereo
STREAM_CHUNK = 49152        # 192 hops of 256
STREAM_CPB = 64             # chunks a block: 3,145,728 samples
STREAM_CUT_SECONDS = 600.0  # iter_stream, 8191 and the grid's clip
STREAM_ULPS = 2             # odd nperseg: the pairing may move the last bit
GRID_SCIPY_SECONDS = 10.0
GRID_REL = 2e-5


def idle_share(fn, what, card, want_kernel):
    """fn() once under torch.profiler, tracing the device alone (tracing
    the host's ops too stretched path 17's window 3-fold on the H100):
    the device's busy time (the union of its kernels and copies) over the
    span from its first event's start to its last event's end, the summed
    ms of the kernels whose name holds ``want_kernel``, and the events by
    kind."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a profiler session after the process's first one was seen to
        # miss the device's first events on the H100: let its device
        # tracing start before the call
        time.sleep(0.5)
        out = fn()
        torch.cuda.synchronize()
    del out
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        print(f"{what}: torch.profiler shows no device time on this machine")
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    start, last = spans[0][0], max(b for _, b in spans)
    kernel_us = sum(e.time_range.end - e.time_range.start for e in device
                    if want_kernel in e.name)
    kinds = {}
    for e in device:
        key = ("kernel " + want_kernel if want_kernel in e.name
               else e.name.split("(")[0][:40])
        kinds[key] = kinds.get(key, 0) + 1
    share = 1 - busy / (last - start)
    print(f"{what}: device busy {busy / 1e3:.3f} ms of the "
          f"{(last - start) / 1e3:.3f} ms from its first event to its last "
          f"(idle share {share:.4f}); {want_kernel} kernels "
          f"{kernel_us / 1e3:.3f} ms summed; device events {kinds} [{card}]")
    return {"busy_ms": busy / 1e3, "span_ms": (last - start) / 1e3,
            "idle_share": share, "kernel_ms": kernel_us / 1e3,
            "events": kinds}


def fold_memory(fn):
    """fn()'s result and two rises over what was allocated before it, the
    allocator's cache emptied first: of max_memory_allocated() (the
    allocator's blocks, which may hold up to 1 MiB past a request that
    did not split its block) and of the peak of the bytes the tensors
    requested (the allocator's ``requested_bytes``)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    req = torch.cuda.memory_stats()["requested_bytes.all.current"]
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.memory_stats()["requested_bytes.all.peak"]
    return out, torch.cuda.max_memory_allocated() - base, peak - req


def stream_path(dev, card, dfma_peak):
    """Path 17 (BASELINE.json config 4): an hour of 48 kHz stereo streamed
    from the host at north_star 1024/256, chunks of 49,152 samples, 64 to a
    block (55 blocks)."""
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core import events as ev
    from spectral_tpu_torch.core.stft import (band_row_slice, freq_axis,
                                              num_frames, power_spectrogram,
                                              time_axis)
    from spectral_tpu_torch.models import hmm
    from spectral_tpu_torch.models.detector import BurstDetector
    from spectral_tpu_torch.ops import hmm_cuda, stft_cuda
    from spectral_tpu_torch.parallel import streaming

    cfg = SpecConfig.north_star(1024, 256)
    fs = STREAM_FS
    n = int(STREAM_SECONDS * fs)
    T = num_frames(n, cfg.nperseg, cfg.hop_)
    F = cfg.n_freqs
    L = STREAM_CHUNK * STREAM_CPB
    c = streaming.carry_len(cfg)
    fpb = L // cfg.hop_
    n_blocks = math.ceil(n / L)
    phase(f"path 17, an hour of 48 kHz stereo streamed from the host: 2 x "
          f"{n} float32 samples ({2 * n * 4 / 1e9:.3f} GB), north_star "
          f"1024/256 ({T} frames a channel), chunks of {STREAM_CHUNK}, "
          f"{STREAM_CPB} a block ({L} samples, {fpb} frames), {n_blocks} "
          f"blocks")
    require((T, n_blocks) == (674997, 55), f"path 17 shape {T}, {n_blocks}")
    x_dev, plans = bursty_batch(dev, 2, n, fs, 4000.0, 200.0, 3000.0, 17)
    x = x_dev.cpu().numpy()
    mono = power_spectrogram(x_dev, fs, cfg)
    torch.cuda.synchronize()
    print(f"the monolithic PSD: {tuple(mono.shape)}, "
          f"{mono.numel() * 4 / 1e9:.3f} GB ({mono.numel() * 2:.0f} bytes a "
          f"channel)")

    def scan():
        return streaming.scan_spectrogram(x, fs, cfg, STREAM_CHUNK,
                                          chunks_per_block=STREAM_CPB)

    scan()                               # warm: constants, allocator
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = scan()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    require_counts(counts, {"stft_fft": n_blocks}, "path 17 scan")
    require(torch.equal(out, mono), "path 17: the streamed stereo PSD is "
            "not bitwise the monolithic power_spectrogram")
    scan_launches = counts["stft_psd"]["fft"]
    del out
    torch.cuda.empty_cache()
    print(f"scan_spectrogram on the (2, {n}) fleet: {scan_launches} FFT "
          f"launches (one a block), bitwise the monolithic PSD of each "
          f"channel; wall {wall:.3f} s, {2 * n * 4 / 1e9 / wall:.3f} GB/s "
          f"from the host [{card}]")
    prof = idle_share(scan, "path 17 scan_spectrogram", card,
                      "stft_fft_psd_kernel")
    torch.cuda.empty_cache()

    phase("path 17 folds: stream_band_powers and stream_features a channel "
          "at a time, at half and the whole hour")
    band = band_row_slice(freq_axis(cfg, fs), 0.0, 4000.0)
    Fb = band[1] - band[0]
    bcfg = SpecConfig.north_star(1024, 256, fmin=0.0, fmax=4000.0)
    f = freq_axis(cfg, fs)
    edges = list(ev.EEG_BANDS.values())
    # the buffers, two blocks' PSD and a third for the fold's temporaries,
    # from the block size alone; the output track on top
    work = 2 * (c + L) * 4 + 3 * fpb * F * 4 + (streaming._SUM_ELEMENTS + F) * 8
    memo = {}
    for ch in (0, 1):
        for frac in (0.5, 1.0):
            m = int(n * frac)
            Tm = num_frames(m, cfg.nperseg, cfg.hop_)
            (rel, total), rise_b, req_b = fold_memory(
                lambda: streaming.stream_band_powers(
                    x[ch, :m], fs, cfg, STREAM_CHUNK,
                    chunks_per_block=STREAM_CPB))
            want = ev.band_powers_device(f, mono[ch, :Tm], edges).cpu()
            got = torch.tensor([rel[k] for k in ev.EEG_BANDS],
                               dtype=torch.float64)
            b_err = float(((got - want.double()).abs()
                           / want.double().abs().clamp_min(1e-30)).max())
            total_want = float(mono[ch, :Tm].double().sum())
            t_err = abs(total - total_want) / total_want
            (t, feats), rise_f, req_f = fold_memory(
                lambda: streaming.stream_features(
                    x[ch, :m], fs, bcfg, STREAM_CHUNK,
                    chunks_per_block=STREAM_CPB))
            feats_want = ev.features_from_psd(f, mono[ch, :Tm], 0.0, 4000.0)
            track = -(-Tm * 4 // 512) * 512       # the power track, allocated
            require(b_err <= 1e-6 and t_err <= 1e-6,
                    f"path 17 channel {ch} at {frac:g} h: band powers rel "
                    f"{b_err:.2e}, total rel {t_err:.2e}")
            require(torch.equal(feats, feats_want) and len(t) == Tm,
                    f"path 17 channel {ch} at {frac:g} h: the streamed "
                    "features are not bitwise the monolithic ones")
            require(rise_b <= work and rise_f <= work + track,
                    f"path 17 channel {ch} at {frac:g} h: memory rise band "
                    f"powers {rise_b}, features {rise_f} over the bound "
                    f"{work} (+ the track {track})")
            memo[(ch, frac)] = (req_b, req_f - Tm * 4)
            print(f"channel {ch}, {frac:g} h ({Tm} frames): band powers rel "
                  f"{b_err:.2e} of band_powers_device (total {total:.6e}, "
                  f"rel {t_err:.2e}); features bitwise features_from_psd "
                  f"0-4000 Hz ({Fb} bins); max_memory_allocated rise: band "
                  f"powers {rise_b / 2**20:.2f} MiB, features "
                  f"{rise_f / 2**20:.2f} MiB (the track {track / 2**20:.2f}"
                  f" MiB); requested bytes' rise: band powers {req_b}, "
                  f"features {req_f} less the track {req_f - Tm * 4}; "
                  f"the bound {work / 2**20:.2f} MiB + the track, "
                  f"the monolithic PSD {Tm * F * 4 / 2**20:.2f} MiB [{card}]")
        require(memo[(ch, 1.0)][0] <= memo[(ch, 0.5)][0]
                and memo[(ch, 1.0)][1] <= memo[(ch, 0.5)][1],
                f"path 17 channel {ch}: the fold's requested bytes grew "
                f"with the length: {memo}")

    phase("path 17 stream_detect on channel 0 against the monolithic flow")
    tb = time_axis(cfg, fs, n)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    events = streaming.stream_detect(x[0], fs, bcfg, STREAM_CHUNK,
                                     chunks_per_block=STREAM_CPB)
    det_wall = time.perf_counter() - t0
    counts = read_counts()
    det = BurstDetector(engine="auto", device=dev)
    feats_mono = ev.features_from_psd(f, mono[0], 0.0, 4000.0)
    want_events = det.unsupervised_detect(tb, feats_mono)
    iters = det.timings["iterations"]
    require_counts(counts, {"stft_fft": n_blocks, "hmm_fit_chunked": 1,
                            "hmm_viterbi_chunked": 1}, "path 17 detect")
    require(events == want_events and len(events) >= 1,
            f"path 17: stream_detect gave {len(events)} events, the "
            f"monolithic flow {len(want_events)}")
    X = feats_mono.to(torch.float64)[None].contiguous()
    patched = hmm.HMMParams(*(p[None].contiguous() for p in det.params))
    states = hmm_cuda.viterbi_chunked(X, patched, hmm_cuda.chunk_len(4))
    require(torch.equal(states, hmm_cuda.viterbi_chunked_reference(
        X, patched, hmm_cuda.chunk_len(4))),
            "path 17: H2 chunked's states differ from the plain version's")
    check_detection(f"path 17, {len(plans[0])} bursts planted on channel 0, "
                    f"{len(events)} events", detection_quality(
                        tb, states.cpu().numpy(),
                        patched.means.cpu().numpy(), plans[:1], [events]))
    print(f"stream_detect: {len(events)} events equal to BurstDetector("
          f"engine='auto') on the monolithic features; {iters} EM "
          f"iterations; launches {flat_counts(counts)}; wall "
          f"{det_wall:.3f} s (init {det.timings['init']:.3f} s on the "
          f"monolithic run) [{card}]")

    phase("path 17 iter_stream and stream_spectrogram over a 10-minute cut")
    m = int(STREAM_CUT_SECONDS * fs)
    cut = x[0, :m]
    Tc = num_frames(m, cfg.nperseg, cfg.hop_)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    blocks = [(p, first) for p, first in streaming.iter_stream(
        (cut[i:i + STREAM_CHUNK] for i in range(0, m, STREAM_CHUNK)), fs,
        cfg, STREAM_CHUNK)]
    torch.cuda.synchronize()
    it_wall = time.perf_counter() - t0
    counts = read_counts()
    n_chunks = math.ceil(m / STREAM_CHUNK)
    require(m % STREAM_CHUNK and counts["stft_psd"]["fft"] == n_chunks,
            f"path 17 iter_stream: {n_chunks} chunks, the last short, one "
            f"launch each; counts {counts}")
    firsts = [first for _, first in blocks]
    cat = torch.cat([p for p, _ in blocks])
    require(torch.equal(cat, mono[0, :Tc]) and firsts[0] == 0 and all(
        b == a + p.shape[0] for a, b, (p, _) in zip(firsts, firsts[1:],
                                                     blocks)),
            "path 17 iter_stream: the blocks are not the monolithic frames")
    print(f"iter_stream: {n_chunks} chunks (the last {m % STREAM_CHUNK} "
          f"samples), one launch each, {Tc} frames bitwise the monolithic "
          f"ones, contiguous indices; {it_wall:.3f} s [{card}]")
    odd = SpecConfig.scipy_default(ODD_NPERSEG)
    reset_counts()
    s_odd = streaming.stream_spectrogram(cut, fs, odd, 8 * odd.hop_)
    counts = read_counts()
    m_odd = power_spectrogram(x_dev[0, :m], fs, odd)
    ulps = ulp_distance(s_odd, m_odd)
    require(s_odd.shape == m_odd.shape and ulps <= STREAM_ULPS
            and counts["stft_psd"]["odd"] >= 1,
            f"path 17 stream_spectrogram at {ODD_NPERSEG}: {ulps} ulps, "
            f"counts {counts}")
    print(f"stream_spectrogram at scipy_default {ODD_NPERSEG} (the odd "
          f"route, a Rader stage): {tuple(s_odd.shape)}, "
          f"{counts['stft_psd']['odd']} launches, largest distance {ulps} "
          f"float32 ulps of the monolithic PSD (limit {STREAM_ULPS})")
    del s_odd, m_odd, cat, blocks

    phase(f"path 17 the STFT kernel on one streamed block ({card})")
    blk = torch.zeros((2, c + L), dtype=torch.float32, device=dev)
    blk[:, c:] = x_dev[:, L:2 * L]
    blk[:, :c] = x_dev[:, L - c:L]
    want = mono[:, fpb - c // cfg.hop_:2 * fpb - c // cfg.hop_]
    got = stft_cuda.stft_psd(blk, fs, cfg)
    err = float((got - want).abs().max())
    require(torch.equal(got, want), "path 17: a block's PSD is not the "
            "monolithic frames")
    consts = stft_cuda.dft_constants(cfg, fs, dev)
    plain = stft_cuda.stft_psd_reference(blk, consts, cfg)
    p_err = psd_err(got, plain)[0]
    require(p_err <= PSD_TOL, f"path 17 block vs plain {p_err:.2e}")
    tm = {"kernel": time_ms(lambda: stft_cuda.stft_psd(blk, fs, cfg),
                            run=RUN),
          "kernel_single": time_ms(lambda: stft_cuda.stft_psd(blk, fs,
                                                              cfg)),
          "plain": time_ms(lambda: stft_cuda.stft_psd_reference(
              blk, consts, cfg)),
          "library": time_ms(lambda: library_psd(blk, cfg, fs=fs))}
    bound = stft_bound(2, c + L, fpb, F, cfg.nperseg)
    for k, (ms, _) in tm.items():
        print(f"block {k}: {ms:.4f} ms [{card}]" + (
            f" (runs of {RUN} launches)" if k == "kernel" else ""))
    print(f"block bound {bound[0]:.4f} ms ({bound[1]}); the kernel against "
          f"the plain version {p_err:.2e} of the PSD max")
    print(json.dumps({"path17": {
        "scan_wall_s": wall, "scan_gb_s": 2 * n * 4 / 1e9 / wall,
        "scan_profile": prof, "detect_wall_s": det_wall,
        "iter_stream_s": it_wall, "odd_ulps": ulps,
        "requested_rise": {f"{k[0]}_{k[1]}": v for k, v in memo.items()},
        "bound_bytes": work, "block_ms": {k: v[0] for k, v in tm.items()},
        "card": card}}))
    del mono, x_dev
    return {"stft_stream": dict(
        launches=scan_launches, err=err, ms=tm["kernel"][0],
        plain_ms=tm["plain"][0], bound=bound,
        library_ms=tm["library"][0])}


def grid_path(dev, card):
    """Path 18 (BASELINE.json config 3): ``default_grid()``'s 16 configs
    over one 10-minute clip at 48 kHz."""
    import numpy as np
    import scipy.signal
    import torch
    from spectral_tpu_torch.core.stft import num_frames, power_spectrogram
    from spectral_tpu_torch.parallel import sweep_grid

    fs = STREAM_FS
    n = int(STREAM_CUT_SECONDS * fs)
    grid = sweep_grid.default_grid()
    x = np.random.RandomState(18).randn(n).astype(np.float32)
    out_bytes = sum(num_frames(n, c.nperseg, c.hop_) * c.n_freqs * 4
                    for c in grid)
    phase(f"path 18, the sweep grid: {len(grid)} configs (nperseg 256-4096, "
          f"hann, hamming, tukey 0.25, blackman, hop nperseg/4) over {n} "
          f"samples at {fs:g} Hz, {out_bytes / 1e9:.3f} GB of PSD")

    def run():
        return sweep_grid.sweep_grid(x, fs, grid)

    run()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    outs = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    require_counts(counts, {"stft_fft": len(grid)}, "path 18")
    launches = counts["stft_psd"]["fft"]
    xd = torch.from_numpy(x).to(dev)
    m = int(GRID_SCIPY_SECONDS * fs)
    worst = 0.0
    for cfg, out in zip(grid, outs):
        require(torch.equal(out, power_spectrogram(xd, fs, cfg)),
                f"path 18 {cfg.nperseg} {cfg.window}: not bitwise "
                "power_spectrogram")
        win = cfg.window if isinstance(cfg.window, str) else tuple(cfg.window)
        _, _, ref = scipy.signal.spectrogram(
            x[:m].astype(np.float64), fs=fs, window=win, nperseg=cfg.nperseg,
            noverlap=cfg.nperseg - cfg.hop_, detrend=False,
            scaling="density", mode="psd")
        got = out[:ref.shape[1]].double().cpu().numpy()
        rel = float(np.abs(got - ref.T).max() / np.abs(ref).max())
        worst = max(worst, rel)
        require(rel <= GRID_REL, f"path 18 {cfg.nperseg} {cfg.window}: "
                f"{rel:.2e} of scipy float64")
    del outs
    print(f"{launches} FFT launches, each result bitwise power_spectrogram "
          f"of its config; a {GRID_SCIPY_SECONDS:g} s cut of each within "
          f"{worst:.2e} of scipy float64 (limit {GRID_REL:g}); wall "
          f"{wall:.3f} s with the upload [{card}]")
    prof = idle_share(run, "path 18 sweep_grid", card, "stft_fft_psd_kernel")
    if prof is not None:
        uploads = sum(v for k, v in prof["events"].items() if "HtoD" in k)
        if prof["events"].get("kernel stft_fft_psd_kernel") == len(grid):
            require(uploads == 1, f"path 18: one upload and {len(grid)} "
                    f"kernels, got {prof['events']}")
        else:
            print(f"path 18: the profile missed device events (the "
                  f"launch counts above show {launches}); its upload "
                  f"count is not read")
    upload = time_ms(lambda: torch.from_numpy(x).to(dev))[0]
    print(f"the signal's upload ({n * 4 / 2**20:.1f} MiB from pageable "
          f"memory): {upload:.4f} ms [{card}]")
    groups = {}
    for cfg in grid:
        groups.setdefault(sweep_grid._shape_key(cfg), []).append(cfg)
    group_ms = {}
    for key, cfgs in groups.items():
        ms, _ = time_ms(lambda: sweep_grid.sweep_grid(xd, fs, cfgs))
        group_ms[key[0]] = ms
        print(f"group nperseg {key[0]}, hop {key[1]}: {len(cfgs)} windows "
              f"{ms:.4f} ms ({ms / len(cfgs):.4f} a config) [{card}]")
    print(f"the grid's kernels {sum(group_ms.values()):.4f} ms summed by "
          f"groups, the upload {upload:.4f} ms, of the call's "
          f"{1e3 * wall:.3f} ms wall [{card}]")
    print(json.dumps({"path18": {"wall_s": wall, "scipy_rel": worst,
                                 "upload_ms": upload,
                                 "group_ms": group_ms, "profile": prof,
                                 "card": card}}))
    return {}


def gui_phase(dev, card="the CPU"):
    """The Qt window over the port's session: the real Qt offscreen where
    the host has PyQt5 and matplotlib, tests/qt_stub.py where it has only
    matplotlib, a line saying so where it has no matplotlib. Plot, detect,
    the CSV and PNG exports on a synthetic sweep; one STFT launch a plot
    on a card."""
    import importlib
    import numpy as np
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("no matplotlib on this host: the window (gui/app.py) cannot "
              "be built here; its session calls (plot, detection, the "
              "exports) are path 16's")
        return
    try:
        import PyQt5  # noqa: F401
        stub = None
        os.environ.setdefault("QT_QPA_PLATFORM", "offscreen")
        from PyQt5 import QtWidgets
        qapp = QtWidgets.QApplication.instance() or QtWidgets.QApplication([])
    except ImportError:
        sys.path.insert(0, os.path.join(HERE, "tests"))
        stub = importlib.import_module("qt_stub")
        stub.install()
        qapp = None
    kind = "the real Qt, offscreen" if stub is None else "tests/qt_stub.py"
    phase(f"the GUI: gui/app.py under {kind}, device {dev}")
    try:
        sys.modules.pop("spectral_tpu_torch.gui.app", None)
        app = importlib.import_module("spectral_tpu_torch.gui.app")
        from spectral_tpu_torch.io.registry import SweepEntry
        from spectral_tpu_torch.ops import stft_cuda
        w = app.build_window(device=str(dev))
        fs = 1000.0
        t = np.arange(int(fs * 120)) / fs
        sweep = (0.05 * np.random.RandomState(3).randn(t.size)
                 + np.where((t % 40 > 10) & (t % 40 < 16),
                            np.sin(2 * np.pi * 6.0 * t), 0.0))
        w.session.registry.register("synth_sweep0", SweepEntry(
            filepath="<synth>", sweep_idx=0, fs=fs, fs_raw=fs,
            raw=sweep.astype(np.float32), processed=None))
        w._add_tree_item("synth_sweep0")
        w.tree.topLevelItem(0).setSelected(True)
        w.chk_raw.setChecked(True)
        w.chk_proc.setChecked(False)
        w.chk_combine.setChecked(False)   # QSettings may hold a user's
        w.combo_raw.setCurrentText("Both")
        w.spin_nperseg.setValue(512)
        w.spin_fmin.setValue(0.0)
        w.spin_fmax.setValue(30.0)
        before = dict(stft_cuda.launches)
        plots = 2
        for _ in range(plots):
            w.plot_selected()
        plotted = w.status.text()
        launched = sum(stft_cuda.launches.values()) - sum(before.values())
        require(plotted.startswith("Plotted single sweep"),
                f"the GUI's plot: {plotted}")
        require(dev.type != "cuda" or launched == plots,
                f"the GUI: {launched} STFT launches for {plots} plots")
        w.detect()
        detected = w.status.text()
        require("HMM detected" in detected
                and w.session.last_detected_events, f"the GUI: {detected}")
        with tempfile.TemporaryDirectory() as tmp:
            csv_path = os.path.join(tmp, "bursts.csv")
            png_path = os.path.join(tmp, "figure.png")
            if stub is not None:
                stub.QFileDialog.next_save_file = csv_path
                w.export_csv()
                csv_status = w.status.text()
                stub.QFileDialog.next_save_file = png_path
                w.export_png()
            else:
                csv_status = w.session.export_csv(csv_path)
                w.status.setText(w.session.export_png(png_path))
            png_status = w.status.text()
            require(csv_status.startswith("Successfully")
                    and png_status.startswith("Successfully")
                    and os.path.getsize(csv_path) > 0
                    and os.path.getsize(png_path) > 0,
                    f"the GUI's exports: {csv_status}; {png_status}")
        print(f"the window under {kind}: {plotted!r}; {plots} plots, "
              f"{launched} STFT launches; {detected!r} "
              f"({len(w.session.last_detected_events)} events); the CSV "
              f"and PNG exports succeeded [{card}]")
        if qapp is not None:
            w.close()
    finally:
        if stub is not None:
            stub.uninstall()
        sys.modules.pop("spectral_tpu_torch.gui.app", None)


# ---------------------------------------------------------------------------
# the command line on the card (cli.py, client.py): path 19
# ---------------------------------------------------------------------------

CLI_CLIPS = 64          # export-specs and render_batch: one batch of clips
CLI_CLIP_FS = 16000.0
CLI_GRID_SECONDS = 60.0
CLI_NFFT = 4096         # render --nfft: the radix-2 kernel at K = 4096 over
                        # nperseg 1024 zero-padded, the GEMM kernel forced


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cli(dev, argv):
    """``spectral_tpu_torch.cli.main(argv)`` in this process (``--cpu``
    first off the card), the launch counts set to 0 just before it:
    (exit code, stdout, counts, wall seconds with the card synchronised)."""
    import contextlib
    import io
    from spectral_tpu_torch import cli
    argv = (["--cpu"] if dev.type == "cpu" else []) + list(argv)
    out = io.StringIO()
    _sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
        out.write(f"SystemExit: {e.code}\n")
    _sync(dev)
    wall = time.perf_counter() - t0
    return rc, out.getvalue(), read_counts(), wall


def timed_call(dev, fn):
    """(fn(), wall seconds with the card synchronised)."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def read_bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def event_lines(events, prefix=""):
    return "".join(f"{prefix}{a:.4f}\t{b:.4f}\n" for a, b in events)


def serve_port(proc, timeout=120.0):
    """The port a ``serve --tcp 0`` child listens on, from its 'serving on
    host:port' line on stderr."""
    import select
    deadline = time.monotonic() + timeout
    seen = []
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stderr], [], [], 1.0)
        if ready:
            line = proc.stderr.readline()
            if not line:
                break
            seen.append(line)
            if line.startswith("serving on "):
                return int(line.rsplit(":", 1)[1])
        elif proc.poll() is not None:
            break
    raise RuntimeError(f"chip_smoke check failed: serve --tcp 0 did not "
                       f"start: {''.join(seen)[-2000:]}")


def cli_path(dev, card):
    """Path 19, the command line (``spectral_tpu_torch/cli.py``) on the
    card: each command through ``cli.main`` in this process, its launch
    counts read (a command that computes and launches no kernel fails),
    its outputs held to the same library calls made in this process and
    its wall time beside theirs; then one ``serve --tcp 0`` child driven
    by ``ServeClient``, its replies held to the commands'. Path 16's hour
    (scipy_default 1024, 0-4000 Hz) carries render (--log, --mels 128,
    --nfft 4096: the radix-2 kernel at K = 4096 over the zero-padded
    frames, timed against the GEMM kernel forced, its plain version, cuFFT
    and its bound, held to scipy float64 on a 10-minute cut), detect --csv
    and bands; path 16's ABF file learn and detect --each --batched; a
    60 s clip the grid; a 10-minute cut stream (npz, --scan png, --bands,
    --detect --csv) and export-batch; 64 clips export-specs."""
    import dataclasses
    import json as _json
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig, ViewSettings
    from spectral_tpu_torch.api.export import (export_batch_signals_png,
                                               export_events_csv)
    from spectral_tpu_torch.api.session import AnalysisSession
    from spectral_tpu_torch.cli import _detect_each_batched
    from spectral_tpu_torch.client import ServeClient
    from spectral_tpu_torch.core.scale import normalize
    from spectral_tpu_torch.core.stft import (band_row_slice, freq_axis,
                                              mask_band_rows, time_axis)
    from spectral_tpu_torch.io.registry import SweepRegistry
    from spectral_tpu_torch.io.wav import write_wav
    from spectral_tpu_torch.ops import stft_cuda
    from spectral_tpu_torch.ops.colormap import (apply_colormap_packed,
                                                 unpack_rgba)
    from spectral_tpu_torch.parallel.pipeline import (export_spectrograms,
                                                      wav_clip_source)
    from spectral_tpu_torch.parallel.streaming import (scan_spectrogram,
                                                       stream_band_powers,
                                                       stream_detect,
                                                       stream_spectrogram)
    from spectral_tpu_torch.parallel.sweep_grid import sweep_grid
    from spectral_tpu_torch.render.png import encode_png
    from torch_precision import log_display, scipy_psd

    on_card = dev.type == "cuda"
    device = "cuda" if on_card else "cpu"
    t_path = time.perf_counter()
    wav, _plans, _ = session_wav(dev)
    abf, plans_a = session_abf(dev)
    fs = SESSION_FS
    phase(f"path 19, the command line: cli.main on path 16's "
          f"{SESSION_SECONDS:g} s at {fs:g} Hz, its ABF file, cuts of it and "
          f"{CLI_CLIPS} clips; then serve --tcp 0 through ServeClient "
          f"[{card}]")
    tmp = os.path.join(shared_dir(), "path19")
    os.makedirs(tmp, exist_ok=True)
    spec = ["--scipy-compat", "--nperseg", "1024", "--fmin", "0", "--fmax",
            "4000"]
    cfg = SpecConfig.scipy_default(1024, fmin=0.0, fmax=4000.0)
    cfg_log = dataclasses.replace(cfg, log_scale=True)
    view = ViewSettings(mode_proc="Spectrogram", mode_raw="Spectrogram")
    rows = []           # (command, CLI s, in-process s, launches)

    def cli_ok(argv, what, want=None, at_least=None, host=False):
        rc, out, counts, wall = run_cli(dev, argv)
        require(rc == 0, f"path 19 {what}: exit {rc}: {out[-2000:]}")
        flat = nonzero_counts(counts)
        if on_card and not host:
            require(flat, f"path 19 {what}: no kernel launched, so it may "
                    "have run on the CPU")
            if want is not None:
                require_counts(counts, want, f"path 19 {what}")
            for k, v in (at_least or {}).items():
                require(flat.get(k, 0) >= v, f"path 19 {what}: {k} "
                        f"launched {flat.get(k, 0)} times, want >= {v}")
        if on_card and host:
            require(not flat, f"path 19 {what}: launched {flat}")
        return out, flat, wall

    def session_call(c, fn):
        def go():
            s = AnalysisSession(warm_detection=False, device=device)
            names = s.load(wav)
            s.plot_sweeps(names[:1], c, view)
            return s, fn(s)
        return timed_call(dev, go)

    # render --log, --mels 128, --nfft 4096: the PNG bytes
    renders = {}
    for label, extra, c, want in (
            ("render --log", ["--log"], cfg_log, {"stft_fft": 1}),
            ("render --mels 128 --log", ["--mels", "128", "--log"],
             dataclasses.replace(cfg_log, n_mels=128),
             {"stft_fft": 1, "mel": 1}),
            (f"render --nfft {CLI_NFFT} --log",
             ["--nfft", str(CLI_NFFT), "--log"],
             dataclasses.replace(cfg_log, nfft=CLI_NFFT),
             {"stft_fft": 1})):
        key = label.replace(" ", "_").replace("-", "")
        png_cli = os.path.join(tmp, f"cli_{key}.png")
        png_lib = os.path.join(tmp, f"lib_{key}.png")
        out, flat, wall = cli_ok(["render", wav, "-o", png_cli, *spec,
                                  *extra], label, want)
        (s_lib, msg), lib_s = session_call(c, lambda s: s.export_png(png_lib))
        require(msg.startswith("Successfully") and out.strip() == msg.replace(
            png_lib, png_cli), f"path 19 {label}: {out!r} vs {msg!r}")
        require(read_bytes(png_cli) == read_bytes(png_lib),
                f"path 19 {label}: the PNG's bytes differ from export_png's")
        renders[label] = (s_lib, png_cli)
        rows.append((label, wall, lib_s, flat))
        print(f"{label}: exit 0, the PNG ({len(read_bytes(png_cli))} bytes) "
              f"bytewise AnalysisSession.export_png's; launches {flat}")

    # the nfft case at full width: the radix-2 kernel at K = 4096 (the
    # render's route, its launch counted above) against its plain version,
    # the GEMM kernel's 128 x 64 tile forced, cuFFT and its bound; a
    # 10-minute cut against scipy float64
    s_n = renders[f"render --nfft {CLI_NFFT} --log"][0]
    cfg_n = dataclasses.replace(cfg, nfft=CLI_NFFT)
    require(stft_cuda.route(cfg_n) == "fft", "nfft route")
    x = torch.as_tensor(s_n.spec_data_source, device=dev)[None]
    n = x.shape[-1]
    T = (n - 1024) // cfg_n.hop_ + 1
    F = cfg_n.n_freqs
    nfft_row = gemm_row = None
    if on_card:
        want = stft_cuda.stft_psd_reference(
            x, stft_cuda.dft_constants(cfg_n, fs, dev), cfg_n)
        errs = {}
        for route, key in (("fft", "stft_fft"), ("gemm", "stft_gemm")):
            reset_counts()
            got = stft_cuda.stft_psd(x, fs, cfg_n, _route=route)
            require_counts(read_counts(), {key: 1}, f"nfft {route} launch")
            rel, abs_ = psd_err(got, want)
            ulps = ulp_distance(got, want)
            require(got.shape == (1, T, F) and rel <= PSD_TOL and ulps <= 1
                    and torch.equal(torch.isfinite(got),
                                    torch.isfinite(want)),
                    f"nfft {route} vs plain: {rel:.2e}, {ulps} ulps")
            errs[route] = (rel, abs_, ulps)
            del got
        del want
        k_ms = time_ms(lambda: stft_cuda.stft_psd(x, fs, cfg_n))[0]
        g_ms = time_ms(lambda: stft_cuda.stft_psd(x, fs, cfg_n,
                                                  _route="gemm"))[0]
        p_ms = time_ms(lambda: stft_cuda.stft_psd_reference(
            x, stft_cuda.dft_constants(cfg_n, fs, dev), cfg_n))[0]
        lib_ms = time_ms(lambda: library_psd(x, cfg_n, fs))[0]
        bound = stft_bound(1, n, T, F, CLI_NFFT)
        dense = dense_dft_bound_ms(1, T, F, 1024)
        torch.cuda.empty_cache()
        nfft_row = {"launches": 1, "err": errs["fft"][1], "ms": k_ms,
                    "plain_ms": p_ms, "bound": bound, "library_ms": lib_ms}
        gemm_row = {"launches": 1, "err": errs["gemm"][1], "ms": g_ms,
                    "plain_ms": p_ms, "bound": bound, "library_ms": lib_ms}
        print(f"nfft {CLI_NFFT} at nperseg 1024, {T} frames x {F} bins: the "
              f"radix-2 kernel at K = {CLI_NFFT} over the zero-padded "
              f"frames vs the plain float64 dense DFT max rel "
              f"{errs['fft'][0]:.2e} ({errs['fft'][1]:.2e} abs, "
              f"{errs['fft'][2]} float32 ulps), the GEMM kernel's 128 x 64 "
              f"tile forced {errs['gemm'][0]:.2e} ({errs['gemm'][2]} ulps); "
              f"radix-2 {k_ms:.3f} ms, GEMM forced {g_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms, cuFFT f64 rfft(n={CLI_NFFT}) then |X|^2 w "
              f"{lib_ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]}; the "
              f"dense design's FP64 ceiling {dense:.3f} ms) [{card}]")
    cut = int(fs * SESSION_CUT_SECONDS)
    xc = x[:, :cut].contiguous()
    f_n = freq_axis(cfg_n, fs)
    lo_n, hi_n = band_row_slice(f_n, 0.0, 4000.0)
    p_cut = stft_cuda.stft_psd(xc, fs, cfg_n)[0]
    img, _ = log_display(p_cut[:, lo_n:hi_n].T.cpu().numpy())
    oracle, rng_db = log_display(scipy_psd(
        xc[0].cpu().numpy().astype(np.float64), cfg_n, fs)[lo_n:hi_n])
    db_err = float(np.max(np.abs(img - oracle)) * rng_db)
    require(db_err <= DB_TOL, f"nfft cut vs scipy: {db_err:.2e} dB")
    print(f"nfft {CLI_NFFT}: the {SESSION_CUT_SECONDS:g} s cut, bins "
          f"{lo_n}-{hi_n - 1}, vs scipy float64 at nfft={CLI_NFFT}: "
          f"{db_err:.2e} dB (limit {DB_TOL:g})")
    del x, xc, p_cut, s_n, renders

    # detect --csv and bands on the hour
    csv_cli = os.path.join(tmp, "cli_detect.csv")
    csv_lib = os.path.join(tmp, "lib_detect.csv")
    out, flat, wall = cli_ok(["detect", wav, *spec, "--csv", csv_cli],
                             "detect --csv",
                             at_least={"stft_fft": 1, "hmm_fit_chunked": 1,
                                       "hmm_viterbi_chunked": 1})
    (s_d, events), lib_s = session_call(cfg, lambda s: (
        s.unsupervised_detect(), s.export_csv(csv_lib))[0])
    require(out == event_lines(events) + f"Successfully exported "
            f"{len(events)} events to cli_detect.csv\n",
            "path 19 detect: stdout")
    require(read_bytes(csv_cli) == read_bytes(csv_lib),
            "path 19 detect: CSV bytes")
    rows.append(("detect --csv", wall, lib_s, flat))
    print(f"detect --csv: {len(events)} events, lines and CSV bytes the "
          f"session's; launches {flat}")
    out, flat, wall = cli_ok(["bands", wav, *spec], "bands",
                             {"stft_fft": 1})
    (s_b, bp), lib_s = session_call(cfg, lambda s: s.calculate_band_powers())
    require(_json.loads(out) == {k: round(v, 6) for k, v in bp.items()},
            f"path 19 bands: {out}")
    rows.append(("bands", wall, lib_s, flat))
    entry = s_b.registry.data[s_b.registry.names()[0]]
    sig = np.asarray(entry.raw, np.float32)
    del s_d, s_b

    # info on the WAV and the ABF: the registry's lines, no launch
    out, flat, wall = cli_ok(["info", wav, abf], "info", host=True)
    r = SweepRegistry()
    lines = []
    for path in (wav, abf):
        for nm in r.load_file(path):
            e = r.data[nm]
            t0s = "" if e.start_seconds is None else f" t0={e.start_seconds:g}s"
            lines.append(f"{nm}: fs={e.fs:g} raw={len(e.raw)} processed="
                         f"{0 if e.processed is None else len(e.processed)}"
                         f"{t0s}\n")
    require(out == "".join(lines), f"path 19 info: {out!r}")
    rows.append(("info", wall, None, flat))

    # learn over the ABF's sweeps combined, two ROIs
    planted = [(k * ABF_SECONDS + a, k * ABF_SECONDS + a + m)
               for k, plan in enumerate(plans_a) for a, m, _, _ in plan]
    require(len(planted) >= 2, f"{len(planted)} ABF bursts planted")
    rois = [(a - 2.0, b + 2.0) for a, b in planted[:2]]
    spec_a = ["--scipy-compat", "--nperseg", "1024", "--fmin", "0", "--fmax",
              "2000"]
    cfg_a = SpecConfig.scipy_default(1024, fmin=0.0, fmax=2000.0)
    out, flat, wall = cli_ok(
        ["learn", abf, "--combine", *spec_a,
         *itertools.chain.from_iterable(("--roi", f"{a!r}:{b!r}")
                                        for a, b in rois)],
        "learn", at_least={"hmm_fit": 1, "hmm_viterbi_chunked": 1})

    def learn():
        s = AnalysisSession(warm_detection=False, device=device)
        names = s.load(abf)
        s.plot_sweeps(names, cfg_a, ViewSettings(
            combine=True, mode_proc="Spectrogram", mode_raw="Spectrogram"))
        return s.learn_and_detect(rois)

    ev_l, lib_s = timed_call(dev, learn)
    require(out == event_lines(ev_l) and len(ev_l) >= 2,
            f"path 19 learn: {out!r}")
    rows.append(("learn --combine, 2 ROIs", wall, lib_s, flat))

    # detect --each --batched over the ABF's sweeps: the fleet flow, and
    # the sequential flow sweep by sweep, the same events
    csv_each = os.path.join(tmp, "cli_each.csv")
    out, flat, wall = cli_ok(["detect", abf, "--each", "--batched", *spec_a,
                              "--csv", csv_each], "detect --each --batched",
                             {"stft_fft": 1, "hmm_fit": 1, "hmm_viterbi": 1})

    def fleet():
        s = AnalysisSession(warm_detection=False, device=device)
        names = s.load(abf)
        return names, _detect_each_batched(s, names, cfg_a, device)

    (names_a, batched), lib_s = timed_call(dev, fleet)
    s_q = AnalysisSession(warm_detection=False, device=device)
    s_q.load(abf)
    want = ""
    for nm in names_a:
        require(not isinstance(batched[nm], Exception), f"{nm}: "
                f"{batched[nm]}")
        s_q.reset_model()
        s_q.plot_sweeps([nm], cfg_a, view)
        require(s_q.unsupervised_detect() == batched[nm],
                f"path 19 detect --each --batched: {nm}'s events are not "
                "the sequential flow's")
        want += event_lines(batched[nm], f"{nm}\t")
    n_ev = sum(len(v) for v in batched.values())
    require(out == want + f"Successfully exported {n_ev} events to "
            f"{csv_each}\n", "path 19 detect --each --batched: stdout")
    rows.append(("detect --each --batched", wall, lib_s, flat))
    print(f"detect --each --batched: {len(names_a)} sweeps, {n_ev} events, "
          f"the fleet flow's in process and the sequential flow's sweep by "
          f"sweep; launches {flat}")
    del s_q

    # grid over a 60 s clip: the npz bitwise sweep_grid's
    npz_grid = os.path.join(tmp, "grid.npz")
    out, flat, wall = cli_ok(["grid", wav, "-o", npz_grid, "--clip-seconds",
                              f"{CLI_GRID_SECONDS:g}"], "grid",
                             {"stft_fft": 16})
    configs = [SpecConfig(nperseg=k, hop=k // 4, window=w, detrend="none")
               for k in (256, 1024, 2048, 4096)
               for w in ("hann", "hamming", "tukey", "blackman")]

    def grid():
        r2 = SweepRegistry()
        xg, _ = r2.get_signal(r2.load_file(wav)[0], processed=True)
        xg = np.asarray(xg, np.float32)[:int(CLI_GRID_SECONDS * fs)]
        return [p.cpu().numpy() for p in sweep_grid(xg, fs, configs,
                                                     device=device)]

    psds, lib_s = timed_call(dev, grid)
    z = np.load(npz_grid)
    for c, p in zip(configs, psds):
        require(np.array_equal(z[f"psd_{c.nperseg}_{c.window}"], p.T),
                f"path 19 grid: {c.nperseg} {c.window}")
    rows.append(("grid (16 configs, 60 s)", wall, lib_s, flat))

    # stream over a 10-minute cut: npz, --scan png, --bands, --detect
    cut_wav = os.path.join(tmp, "cut.wav")
    write_wav(cut_wav, sig[:cut], fs)

    def cut_signal():
        r2 = SweepRegistry()
        x2, _ = r2.get_signal(r2.load_file(cut_wav)[0], processed=True)
        return np.asarray(x2, np.float32)

    xs = cut_signal()
    hop = cfg.hop_
    chunk = max(-(-cfg.nperseg // hop) * hop, int(60.0 * fs) // hop * hop)
    f_ax = freq_axis(cfg, fs)

    def banded(psd):
        return mask_band_rows(f_ax, psd.transpose(-1, -2), 0.0, 4000.0)[1]

    npz_s = os.path.join(tmp, "stream.npz")
    out, flat, wall = cli_ok(["stream", cut_wav, "-o", npz_s, *spec],
                             "stream -o x.npz", at_least={"stft_fft": 1})
    want, lib_s = timed_call(dev, lambda: banded(stream_spectrogram(
        cut_signal(), fs, cfg, chunk, device=device)).cpu().numpy().T)
    z = np.load(npz_s)
    require(np.array_equal(z["psd"], want) and np.array_equal(
        z["t"], time_axis(cfg, fs, len(xs))), "path 19 stream npz")
    rows.append(("stream -o x.npz", wall, lib_s, flat))
    png_s = os.path.join(tmp, "stream.png")
    png_l = os.path.join(tmp, "stream_lib.png")
    out, flat, wall = cli_ok(["stream", cut_wav, "--scan", "-o", png_s,
                              *spec, "--log"], "stream --scan -o x.png",
                             at_least={"stft_fft": 1})

    def scan_png():
        img = normalize(banded(scan_spectrogram(cut_signal(), fs, cfg_log,
                                                chunk, device=device)), True)
        encode_png(unpack_rgba(apply_colormap_packed(img, flip_rows=True)),
                   path=png_l, compress_level=4)

    _, lib_s = timed_call(dev, scan_png)
    require(read_bytes(png_s) == read_bytes(png_l),
            "path 19 stream --scan png bytes")
    rows.append(("stream --scan -o x.png", wall, lib_s, flat))
    out, flat, wall = cli_ok(["stream", cut_wav, "--bands", *spec],
                             "stream --bands", at_least={"stft_fft": 1})
    (bp, total), lib_s = timed_call(dev, lambda: stream_band_powers(
        cut_signal(), fs, cfg, chunk, device=device))
    require(out == _json.dumps({k: round(v, 6) for k, v in bp.items()},
                               ensure_ascii=False, indent=2)
            + f"\nTotal absolute power: {total:.6g}\n",
            f"path 19 stream --bands: {out!r}")
    rows.append(("stream --bands", wall, lib_s, flat))
    csv_s = os.path.join(tmp, "stream.csv")
    csv_sl = os.path.join(tmp, "stream_lib.csv")
    out, flat, wall = cli_ok(["stream", cut_wav, "--detect", "--csv", csv_s,
                              *spec], "stream --detect --csv",
                             at_least={"stft_fft": 1,
                                       "hmm_fit_chunked": 1})
    ev_s, lib_s = timed_call(dev, lambda: stream_detect(
        cut_signal(), fs, cfg, chunk, device=device))
    from types import SimpleNamespace
    msg = export_events_csv(csv_sl, SimpleNamespace(
        last_detected_events=ev_s, segment_map=[],
        currently_plotted_items=["cut.wav"]))
    require(out == event_lines(ev_s) + msg.replace("stream_lib.csv",
                                                   "stream.csv") + "\n"
            and read_bytes(csv_s) == read_bytes(csv_sl),
            "path 19 stream --detect: lines and CSV bytes")
    rows.append(("stream --detect --csv", wall, lib_s, flat))

    # export-batch of the cut: the waveform PNG's bytes
    eb_cli, eb_lib = os.path.join(tmp, "eb_cli"), os.path.join(tmp, "eb_lib")
    out, flat, wall = cli_ok(["export-batch", cut_wav, "-o", eb_cli],
                             "export-batch", host=True)

    def batch_png():
        r2 = SweepRegistry()
        return export_batch_signals_png(eb_lib, r2, r2.load_file(cut_wav),
                                        use_proc=False, use_raw=True,
                                        window_seconds=300.0, device=device)

    msg, lib_s = timed_call(dev, batch_png)
    require(out.strip() == msg.replace(eb_lib, eb_cli) and read_bytes(
        os.path.join(eb_cli, "cut_sweep0.png")) == read_bytes(
            os.path.join(eb_lib, "cut_sweep0.png")), "path 19 export-batch")
    rows.append(("export-batch", wall, lib_s, flat))

    # export-specs of 64 clips with --stats-json: PNG bytes the pipeline's
    gen = np.random.RandomState(19)
    n_clip = int(CLI_CLIP_FS * CLIP_SECONDS)
    clip_dir = os.path.join(tmp, "clips")
    os.makedirs(clip_dir, exist_ok=True)
    clips = []
    for i in range(CLI_CLIPS):
        path = os.path.join(clip_dir, f"c{i:02d}.wav")
        write_wav(path, (0.1 * gen.randn(n_clip)).astype(np.float32),
                  CLI_CLIP_FS)
        clips.append(path)
    cfg_ns = SpecConfig.north_star(1024, 256, log_scale=True)
    spec_cli, spec_lib = (os.path.join(tmp, "specs_cli"),
                          os.path.join(tmp, "specs_lib"))
    stats_json = os.path.join(tmp, "stats.json")
    out, flat, wall = cli_ok(["export-specs", *clips, "-o", spec_cli,
                              "--log", "--stats-json", stats_json],
                             "export-specs",
                             {"stft_fft": 1, "clip_stats": 1, "palette": 1})
    stats, lib_s = timed_call(dev, lambda: export_spectrograms(
        wav_clip_source(clips), CLI_CLIP_FS, cfg_ns, spec_lib,
        clip_samples=n_clip, batch=64, compress_level=1, device=device))
    rep = _json.load(open(stats_json))
    require(rep["pngs_written"] == stats.pngs_written == CLI_CLIPS
            and sorted(os.listdir(spec_cli)) == sorted(os.listdir(spec_lib))
            and all(read_bytes(os.path.join(spec_cli, f)) == read_bytes(
                os.path.join(spec_lib, f)) for f in os.listdir(spec_lib)),
            "path 19 export-specs: PNG bytes and stats")
    rows.append(("export-specs (64 clips)", wall, lib_s, flat))

    # doctor --json --probe-link: one object, the tone through the kernel
    out, flat, wall = cli_ok(["doctor", "--json", "--probe-link"], "doctor",
                             {"stft_fft": 1} if on_card else None)
    rep = _json.loads(out)
    require(rep["ok"] and rep["sanity"] and rep["backend"] == dev.type,
            f"path 19 doctor: {rep}")
    rows.append(("doctor --json --probe-link", wall, None, flat))
    print(f"doctor: {out.strip()}")

    # what this host cannot run: NIX without h5py, --decorated without
    # matplotlib, gui without PyQt5
    try:
        import h5py  # noqa: F401
        from spectral_tpu_torch.io.nix import write_nix_fixture
        nix = os.path.join(tmp, "rec.h5")
        write_nix_fixture(nix, [{"proc_a": sig[:int(60 * fs)]}], fs=fs)
        out, flat, wall = cli_ok(["info", nix], "info (NIX)", host=True)
        require(out.startswith("rec_sweep0: fs=48000"), f"NIX info {out!r}")
        nix_png = os.path.join(tmp, "nix.png")
        out, flat, wall = cli_ok(["render", nix, "-o", nix_png, *spec],
                                 "render (NIX)", {"stft_fft": 1})
        print(f"h5py on this host: a NIX file through info and render "
              f"({len(read_bytes(nix_png))} PNG bytes)")
    except ImportError:
        print("no h5py on this host: NIX files are not loaded here (info "
              "and render of a NIX file run on the CPU in the tests)")
    try:
        import matplotlib  # noqa: F401
        d_png = os.path.join(tmp, "decorated.png")
        cli_ok(["render", cut_wav, "-o", d_png, "--decorated", *spec],
               "render --decorated", {"stft_fft": 1})
        print(f"render --decorated: {len(read_bytes(d_png))} PNG bytes")
    except ImportError:
        print("no matplotlib on this host: render --decorated skipped")
    rc, out, counts, _ = run_cli(dev, ["gui"])
    try:
        import PyQt5  # noqa: F401
        print("PyQt5 on this host: the gui phase drives the window")
    except ImportError:
        require(rc == 2, f"gui without PyQt5: exit {rc}")
        print("no PyQt5 on this host: gui exits 2 with its pointer to the "
              "CLI")

    # serve --tcp 0 in a child process, through the port's ServeClient
    cmd = [sys.executable, "-m", "spectral_tpu_torch.cli"] + (
        [] if on_card else ["--cpu"]) + ["serve", "--tcp", "0"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=HERE, stdin=subprocess.DEVNULL,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    tcp = {}
    try:
        port = serve_port(proc)
        tcp["start_s"] = time.perf_counter() - t0
        as_dict = lambda c: _json.loads(c.to_json())  # noqa: E731
        with ServeClient.tcp(port) as c:
            def req(name, fn):
                t1 = time.perf_counter()
                got = fn()
                tcp[name] = time.perf_counter() - t1
                return got

            require(req("ping", c.ping), "serve ping")
            png_t = os.path.join(tmp, "tcp.png")
            msg = req("render", lambda: c.render([wav], png_t,
                                                 config=as_dict(cfg_log)))
            require(msg.startswith("Successfully") and read_bytes(png_t)
                    == read_bytes(os.path.join(tmp, "cli_render_log.png")),
                    "serve render: PNG bytes")
            ev_t = req("detect", lambda: c.detect([wav], config=as_dict(cfg)))
            require(ev_t == events, "serve detect: events")
            res = req("detect_batch", lambda: c.detect_batch(
                [abf], config=as_dict(cfg_a)))
            require({k: [tuple(e) for e in v["events"]]
                     for k, v in res.items()} == batched,
                    "serve detect_batch: events")
            rb_dir = os.path.join(tmp, "tcp_specs")
            rb = req("render_batch", lambda: c.render_batch(
                clips, rb_dir, clip_seconds=CLIP_SECONDS,
                config=as_dict(cfg_ns)))
            require(rb["written"] == CLI_CLIPS and all(
                read_bytes(os.path.join(rb_dir, f)) == read_bytes(
                    os.path.join(spec_lib, f)) for f in os.listdir(spec_lib)),
                "serve render_batch: PNG bytes")
            sb, stot = req("stream_bands", lambda: c.stream_bands(
                [cut_wav], chunk_seconds=60.0, config=as_dict(cfg)))
            require(sb == bp and stot == total, "serve stream_bands")
            st = req("stats", c.stats)
            # two file sets were cached, unless the RSS backstop (the
            # default --max-rss-mb 8192) dropped them: an hour's sessions
            # hold its samples twice on the host
            require(st["requests"] == 7 and st["errors"] == 0
                    and st["sessions_cached"] <= 2
                    and (st["sessions_cached"] == 2 or st["cache_trims"]),
                    f"serve stats {st}")
            c.close(shutdown=True)
        require(proc.wait(timeout=60) == 0, "serve exit")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()
    print(f"serve --tcp 0: listening after {tcp['start_s']:.2f} s; each "
          f"reply the in-process command's (PNG bytes, events, band "
          f"powers): " + ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in
                                  tcp.items() if k != "start_s")
          + f"; the worker's RSS {st['rss_mb']} MB, {st['cache_trims']} "
          f"cache trims [{card}]")

    print(f"{'command':<28} {'CLI s':>9} {'in process s':>13} {'CLI cost s':>11}"
          f"  launches")
    for name, cli_s, lib_s, flat in rows:
        lib = "" if lib_s is None else f"{lib_s:.3f}"
        cost = "" if lib_s is None else f"{cli_s - lib_s:+.3f}"
        print(f"{name:<28} {cli_s:>9.3f} {lib:>13} {cost:>11}  {flat}")
    print(f"path 19 took {time.perf_counter() - t_path:.1f} s of wall time, "
          "the recordings' writing included")
    print(_json.dumps({"path19": [
        {"command": name, "cli_s": cli_s, "in_process_s": lib_s,
         "launches": flat} for name, cli_s, lib_s, flat in rows],
        "serve_tcp_s": tcp, "card": card}))
    out_rows = {"cli_rows": rows}
    if nfft_row is not None:
        out_rows["stft_nfft"] = nfft_row
        out_rows["stft_gemm_nfft"] = gemm_row
    return out_rows


# path 20: the extended modes. Zero-padded transforms on every FFT family
# at 1024 clips of 10 s: (nperseg, nfft, route)
PADDED_CASES = ((1000, 1536, "mixed"), (1024, 2047, "odd"),
                (2000, 2049, "bluestein"), (24, 64, "fft"),
                (4096, 8190, "mixed"), (8000, 8185, "bluestein"))
# the output modes on each of the five routes (nfft == nperseg for the
# radix-2 and GEMM ones; the Bluestein kernel's pair and split epilogues)
MODE_CASES = ((1024, 1024, "fft"), (1000, 1536, "mixed"),
              (1024, 2047, "odd"), (2000, 2049, "bluestein"),
              (1100, 1126, "bluestein"), (24, 24, "gemm"))
MODE_CLIPS = 256
CENTER_PAD_MODES = ("reflect", "constant", "edge", "symmetric", "wrap")
COMPLEX_TOL = 2.0 ** -22    # a frame's complex error over its max |X|
CUT_REL = 2e-5              # the complex STFT against scipy, of max |X|


def frame_err(got, want):
    """The complex outputs' largest error over each frame's largest |X|
    (a frame of zeros must come out zeros), and the frames past
    COMPLEX_TOL."""
    import torch
    d = (got - want).abs().amax(dim=-1)
    s = want.abs().amax(dim=-1)
    over = torch.where(s > 0, d > COMPLEX_TOL * s, d > 0)
    return float((d / s.clamp_min(1e-300)).amax()), int(over.sum())


def mirrored(z, K):
    """Whether a two-sided (..., K) complex spectrum's bins past K/2 are the
    conjugates of their mirrors bit for bit."""
    import torch
    f = torch.arange(1, (K + 1) // 2, device=z.device)
    return torch.equal(z[..., K - f], z[..., f].conj().resolve_conj())


def ext_modes_path(dev, card):
    """Path 20, the extended modes at full width, each launch counted
    (reset before, read after) and held to its plain version on the card:
    zero-padded transforms on every FFT family (PADDED_CASES, 1024 clips of
    10 s: the PSD within 1 float32 ulp, timed against the GEMM kernel
    forced, cuFFT and the bound); the magnitude (1 ulp, with its partials),
    the complex STFT (one- and two-sided, the full band and a band: each
    frame within COMPLEX_TOL of its max |X|, two-sided bins the conjugates
    of their mirrors bitwise) and the two-sided PSD (1 ulp) on each of the
    five routes (MODE_CASES, MODE_CLIPS clips); centered framing in five
    pad modes through ``batched_spectrogram_fn`` on path 1's batch (words
    against the plain path, the display against scipy float64 on the
    np.pad-padded signal); ``spectrogram`` in magnitude and complex mode
    and ``stft`` on path 16's hour (timed: the magnitude and complex rows)
    against scipy float64 on a 10-minute cut."""
    import dataclasses
    import numpy as np
    import scipy.signal
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core import stft as tstft
    from spectral_tpu_torch.io.wav import read_wav
    from spectral_tpu_torch.ops import display_cuda as disp
    from spectral_tpu_torch.ops import stft_cuda
    from spectral_tpu_torch.parallel.sharding import batched_spectrogram_fn
    from torch_precision import log_display

    t_path = time.perf_counter()
    n = int(FS * CLIP_SECONDS)
    rows = {}
    phase(f"path 20, the extended modes: zero-padded transforms on {BATCH} "
          f"clips x {CLIP_SECONDS:g} s at {FS:g} Hz [{card}]")
    x = torch.randn((BATCH, n), generator=torch.Generator(
        device=dev).manual_seed(20), device=dev)

    def launch(fn, key, what):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        require_counts(read_counts(), {key: 1}, what)
        return out

    for k, nfft, route in PADDED_CASES:
        cfg = dataclasses.replace(SpecConfig.scipy_default(k), nfft=nfft)
        require(stft_cuda.route(cfg) == route, f"{k}/{nfft}: route")
        got = launch(lambda: stft_cuda.stft_psd(x, FS, cfg), f"stft_{route}",
                     f"nperseg {k}, nfft {nfft}")
        want = stft_cuda.stft_psd_reference(
            x, stft_cuda.dft_constants(cfg, FS, dev), cfg)
        rel, abs_ = psd_err(got, want)
        ulps = ulp_distance(got, want)
        require(rel <= PSD_TOL and ulps <= 1 and torch.equal(
            torch.isfinite(got), torch.isfinite(want)),
            f"nperseg {k}, nfft {nfft} [{route}] vs plain: {rel:.2e}, "
            f"{ulps} ulps")
        del got, want
        T, F = tstft.num_frames(n, k, cfg.hop_), cfg.n_freqs
        k_ms = time_ms(lambda: stft_cuda.stft_psd(x, FS, cfg))[0]
        g_ms = time_ms(lambda: stft_cuda.stft_psd(x, FS, cfg,
                                                  _route="gemm"))[0]
        lib_ms = time_ms(lambda: library_psd(x, cfg))[0]
        bound = stft_bound(BATCH, n, T, F, nfft)
        torch.cuda.empty_cache()
        print(f"nperseg {k} zero-padded to nfft {nfft} [{route}], {T} frames "
              f"x {F} bins a clip: vs plain {rel:.2e} of the clip max "
              f"({ulps} float32 ulps); kernel {k_ms:.3f} ms, GEMM forced "
              f"{g_ms:.3f} ms, cuFFT f64 {lib_ms:.3f} ms, bound "
              f"{bound[0]:.3f} ms ({bound[1]}) [{card}]")
    del x
    torch.cuda.empty_cache()

    phase(f"path 20: magnitude, the complex STFT and two-sided spectra on "
          f"each route, {MODE_CLIPS} clips x {CLIP_SECONDS:g} s")
    xm = torch.randn((MODE_CLIPS, n), generator=torch.Generator(
        device=dev).manual_seed(21), device=dev) + 0.5
    for k, nfft, route in MODE_CASES:
        base = dataclasses.replace(SpecConfig.scipy_default(k), nfft=nfft)
        key = f"stft_{route}"
        # magnitude, with its partials
        mag = dataclasses.replace(base, mode="magnitude")
        got, parts = launch(lambda: stft_cuda.stft_psd_partials(xm, FS, mag),
                            key, f"{k}/{nfft} magnitude")
        want = stft_cuda.stft_psd_reference(
            xm, stft_cuda.dft_constants(mag, FS, dev), mag)
        m_ulps = ulp_distance(got, want)
        require(m_ulps <= 1 and bitwise(parts[0, 0], got.amin(-1))
                and bitwise(parts[1, 0], got.amax(-1)),
                f"{k}/{nfft} magnitude: {m_ulps} ulps, partials")
        del got, want, parts
        # the two-sided PSD
        two = dataclasses.replace(base, onesided=False)
        got = launch(lambda: stft_cuda.stft_psd(xm, FS, two), key,
                     f"{k}/{nfft} two-sided PSD")
        want = stft_cuda.stft_psd_reference(
            xm, stft_cuda.dft_constants(two, FS, dev), two)
        t_ulps = ulp_distance(got, want)
        require(t_ulps <= 1 and got.shape[-1] == nfft,
                f"{k}/{nfft} two-sided PSD: {t_ulps} ulps")
        del got, want
        # the complex STFT, one- and two-sided, full band and a band
        worst = 0.0
        for c in (base, two):
            F = c.n_freqs
            for band in (None, (F // 5, F // 2)):
                got = launch(lambda: stft_cuda.stft_complex(xm, FS, c, band),
                             key, f"{k}/{nfft} complex")
                want = stft_cuda.stft_complex_reference(
                    xm, stft_cuda.dft_constants(c, FS, dev, band, "complex"),
                    c)
                err, over = frame_err(got, want)
                require(got.dtype == torch.complex64 and over == 0,
                        f"{k}/{nfft} complex, onesided {c.onesided}, band "
                        f"{band}: {over} frames past {COMPLEX_TOL:.2e} "
                        f"({err:.2e})")
                if band is None and not c.onesided:
                    require(mirrored(got, nfft),
                            f"{k}/{nfft}: two-sided bins not the conjugates "
                            "of their mirrors")
                worst = max(worst, err)
                del got, want
        print(f"nperseg {k}, nfft {nfft} [{route}]: magnitude {m_ulps} ulps "
              f"(partials bitwise), two-sided PSD {t_ulps} ulps, complex "
              f"(one- and two-sided, full band and a band) {worst:.2e} of "
              f"each frame's max |X|, mirrored bins bitwise conjugates")
    del xm
    torch.cuda.empty_cache()

    phase(f"path 20: centered framing through batched_spectrogram_fn on "
          f"path 1's batch, north_star 1024/256, pad modes "
          f"{', '.join(CENTER_PAD_MODES)}")
    x_host = np.random.RandomState(0).randn(BATCH, n).astype(np.float32)
    x = torch.from_numpy(x_host).to(dev)
    for mode in CENTER_PAD_MODES:
        cfg = SpecConfig.north_star(1024, 256, log_scale=True, center=True,
                                    pad_mode=mode)
        fn = batched_spectrogram_fn(FS, cfg, flip_image=True)
        reset_counts()
        out = fn(x)
        torch.cuda.synchronize()
        require_one_call(read_counts(), "fft", 1, f"centered {mode}")
        T = tstft.num_frames(n + 1024, 1024, 256)
        require(tuple(out["psd"].shape) == (BATCH, T, cfg.n_freqs)
                and bool(out["finite"].all()), f"centered {mode}: shapes")
        xp = tstft.center_pad(x[:8], cfg)
        psd_p, pmin_p, pmax_p = stft_cuda.stft_psd_reference(
            xp, stft_cuda.dft_constants(cfg, FS, dev), cfg, with_stats=True)
        ulps = ulp_distance(out["psd"][:8], psd_p)
        _, rgb_p = disp.display_map_reference(
            psd_p, disp.clip_params(pmin_p, pmax_p), log_scale=True,
            flip_image=True)
        same = check_words(out["rgb_packed"][:8], rgb_p,
                           f"centered {mode}, 8 clips")
        x64 = np.pad(x_host[0].astype(np.float64), 512, mode=mode)
        db = db_error_vs_scipy(out["image"][0].flip(0).cpu().numpy(), x64,
                               dataclasses.replace(cfg, center=False))
        require(ulps <= 1 and db <= DB_TOL,
                f"centered {mode}: {ulps} ulps, {db:.2e} dB")
        print(f"center, pad_mode {mode}: {T} frames; psd of 8 clips {ulps} "
              f"ulps from the plain path, words {same:.6f} identical; clip "
              f"0 vs scipy float64 on np.pad(mode={mode!r}): {db:.2e} dB")
        del out, psd_p, rgb_p
    del x
    torch.cuda.empty_cache()

    fs = SESSION_FS
    wav, _plans, _ = session_wav(dev)
    sig, _ = read_wav(wav)
    xh = torch.as_tensor(np.ascontiguousarray(sig, np.float32), device=dev)
    phase(f"path 20: spectrogram(mode=...) and stft on path 16's "
          f"{SESSION_SECONDS:g} s at {fs:g} Hz, scipy_default 1024 [{card}]")
    base = SpecConfig.scipy_default(1024)
    N = xh.shape[-1]
    T, F = tstft.num_frames(N, 1024, base.hop_), base.n_freqs
    cut = int(fs * SESSION_CUT_SECONDS)
    x64 = sig[:cut].astype(np.float64)
    for mode in ("magnitude", "complex"):
        cfg = dataclasses.replace(base, mode=mode)
        reset_counts()
        f, t, sxx = tstft.spectrogram(xh, fs, cfg)
        torch.cuda.synchronize()
        require_counts(read_counts(), {"stft_fft": 1},
                       f"spectrogram(mode={mode!r})")
        require(tuple(sxx.shape) == (F, T) and t.size == T,
                f"{mode}: shape {tuple(sxx.shape)}")
        fr = sxx.T[None]
        if mode == "complex":
            want = stft_cuda.stft_complex_reference(
                xh[None], stft_cuda.dft_constants(cfg, fs, dev), cfg)
            err, over = frame_err(fr, want)
            require(over == 0, f"hour complex: {over} frames ({err:.2e})")
            k_fn = lambda: stft_cuda.stft_complex(xh[None], fs, cfg)  # noqa
            p_fn = lambda: stft_cuda.stft_complex_reference(  # noqa
                xh[None], stft_cuda.dft_constants(cfg, fs, dev), cfg)
            acc = f"{err:.2e} of each frame's max |X|"
        else:
            want = stft_cuda.stft_psd_reference(
                xh[None], stft_cuda.dft_constants(cfg, fs, dev), cfg)
            ulps = ulp_distance(fr, want)
            require(ulps <= 1, f"hour magnitude: {ulps} ulps")
            k_fn = lambda: stft_cuda.stft_psd(xh[None], fs, cfg)  # noqa
            p_fn = lambda: stft_cuda.stft_psd_reference(  # noqa
                xh[None], stft_cuda.dft_constants(cfg, fs, dev), cfg)
            acc = f"{ulps} float32 ulps"
        abs_ = float((fr - want).abs().amax())
        del want
        ref = scipy.signal.spectrogram(
            x64, fs=fs, window=cfg.window, nperseg=1024,
            noverlap=1024 - cfg.hop_, detrend="constant", scaling="density",
            mode=mode)[2]
        got_cut = sxx[:, :ref.shape[1]].cpu().numpy()
        if mode == "complex":
            c_rel = float(np.abs(got_cut - ref).max() / np.abs(ref).max())
            require(c_rel <= CUT_REL, f"hour complex vs scipy: {c_rel:.2e}")
            vs = f"{c_rel:.2e} of max |X|"
        else:
            img, _ = log_display(got_cut ** 2)
            oracle, rng_db = log_display(ref ** 2)
            db = float(np.max(np.abs(img - oracle)) * rng_db)
            require(db <= DB_TOL, f"hour magnitude vs scipy: {db:.2e} dB")
            vs = f"{db:.2e} dB on the magnitude squared"
        del sxx, fr
        k_ms = time_ms(k_fn)[0]
        p_ms = time_ms(p_fn)[0]
        lib_ms = time_ms(lambda: library_psd(xh[None], cfg, fs))[0]
        bound = stft_bound(1, N, T, F, 1024,
                           out_bytes=8 if mode == "complex" else 4)
        rows[f"stft_{mode}"] = {"launches": 1, "err": abs_, "ms": k_ms,
                                "plain_ms": p_ms, "bound": bound,
                                "library_ms": lib_ms}
        torch.cuda.empty_cache()
        print(f"spectrogram(mode={mode!r}) on the hour, {T} frames x {F} "
              f"bins: vs plain {acc}; the {SESSION_CUT_SECONDS:g} s cut vs "
              f"scipy float64 {vs}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} "
              f"ms, cuFFT f64 with the same epilogue {lib_ms:.3f} ms, bound "
              f"{bound[0]:.3f} ms ({bound[1]}) [{card}]")
    reset_counts()
    z = tstft.stft(xh, base)
    torch.cuda.synchronize()
    require_counts(read_counts(), {"stft_fft": 1}, "stft")
    ref = scipy.signal.stft(x64, fs=fs, window=base.window, nperseg=1024,
                            noverlap=1024 - base.hop_, detrend="constant",
                            boundary=None, padded=False, scaling="spectrum"
                            )[2] * np.sum(tstft._window_f64(base))
    got_cut = z[:ref.shape[1]].T.cpu().numpy()
    s_rel = float(np.abs(got_cut - ref).max() / np.abs(ref).max())
    require(z.dtype == torch.complex64 and tuple(z.shape) == (T, F)
            and s_rel <= CUT_REL, f"stft vs scipy: {s_rel:.2e}")
    print(f"stft on the hour: complex64 ({T}, {F}); the cut vs scipy "
          f"float64 (unscaled) {s_rel:.2e} of max |X|")
    del xh, z
    torch.cuda.empty_cache()
    print(f"path 20 took {time.perf_counter() - t_path:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# gradients: the backward kernels (phase grad) and path 21
# ---------------------------------------------------------------------------

GRAD_TOL = 1e-6         # of the clip's largest |gradient|, kernel vs plain
GRAD_STEPS = 3          # SGD steps on path 21's waveforms
GRAD_CLIPS = 8          # clips of path 21 held to the plain backward


def clip_rel(got, want):
    """Largest |Δ| of each clip (leading axis) over the clip's largest
    |want|, the worst clip's; NaN required in the same places."""
    import torch
    require(tuple(got.shape) == tuple(want.shape),
            f"shapes {tuple(got.shape)} vs {tuple(want.shape)}")
    nan = torch.isnan(want)
    require(torch.equal(torch.isnan(got), nan), "NaN in other places")
    B = want.shape[0]
    diff = torch.where(nan, 0.0, (got - want).abs()).reshape(B, -1)
    scale = torch.where(nan, 0.0, want.abs()).reshape(B, -1).amax(dim=1)
    return float((diff.amax(dim=1) / scale.clamp_min(1e-30)).amax()), \
        float(diff.amax())


def grad_counts_moved(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def grad_kernel_cases(dev):
    """Phase grad: the STFT backward through ``loss.backward()`` of the
    kernels' entry points, by ``backward_route``: on the radix-2, mixed,
    odd and Bluestein routes the route's FFT adjoint
    (stft_fft_backward_kernel, stft_mixed_fft_backward_kernel,
    stft_odd_fft_backward_kernel, the latter's PACKED form on the mixed
    route's Rader plans, stft_bluestein_fft_backward_kernel; X recomputed
    inside: no launch of the forward's complex epilogue and no dense
    operands built), on the GEMM route stft_backward_kernel after one
    launch of the route's complex epilogue; overlap_add_kernel after both.
    Each held per clip within GRAD_TOL to the plain dense backward on the
    same card, and each FFT adjoint's case also to the plain FFT adjoint
    and to stft_backward_kernel forced on it. The configs: radix-2 32,
    1024 and 8192, mixed 992, 8032 and 8160, the mixed route's Rader plans
    1006 and 8186, odd 1023, 8191 (Rader) and 33 with T odd, Bluestein
    2049, 1126 (even, two blocks an SM), 8185 (a cluster; also unscaled,
    with no recompute), 2049 over nperseg 2000,
    magnitude at 2049, 563 two-sided complex on a band, 563 with T odd
    and 563 with a NaN in one frame's gradient, GEMM 24, nfft 4096 over
    nperseg 1024, two-sided, magnitude, the complex STFT scaled and
    unscaled, a 0-30 Hz band at 1 kHz, centered (reflect), linear detrend,
    T = 0; then
    the mel backward at path 12's shapes and the display backward at path
    1's and path 12's (log and linear, flipped, share_max, tied extrema)
    and on edge clips (silent frames, a pixel equal to the base, two clips
    tied at the batch's max, dB ranges of 0 and 5.2e-7, a NaN pixel), each
    against its plain version, the display backward also against itself
    run again, bit for bit."""
    import dataclasses
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.mel import mel_filterbank
    from spectral_tpu_torch.core.stft import center_pad, num_frames
    from spectral_tpu_torch.ops import display_cuda as disp
    from spectral_tpu_torch.ops import mel_cuda, stft_cuda

    phase("grad: the backward kernels against their plain versions")
    s1024 = SpecConfig.scipy_default(1024)
    ns = SpecConfig.north_star(1024, 256)
    cases = (
        ("radix-2 1024", ns, FS, "psd", None),
        ("radix-2 32", SpecConfig.scipy_default(32), FS, "psd", None),
        ("radix-2 8192", SpecConfig.scipy_default(8192), FS, "psd", None),
        ("mixed 992", SpecConfig.scipy_default(992), FS, "psd", None),
        ("mixed 8160", SpecConfig.scipy_default(8160), FS, "psd", None),
        ("mixed 8032 (p = 251)", SpecConfig.scipy_default(8032), FS, "psd",
         None),
        ("mixed Rader 1006", SpecConfig.scipy_default(1006), FS, "psd",
         None),
        ("mixed Rader 8186", SpecConfig.scipy_default(8186), FS, "psd",
         None),
        ("odd 1023", SpecConfig.scipy_default(1023), FS, "psd", None),
        ("odd Rader 8191", SpecConfig.scipy_default(8191), FS, "psd", None),
        ("odd 33, T odd", SpecConfig.scipy_default(33), FS, "psd", None),
        ("odd 1023 two-sided magnitude", dataclasses.replace(
            SpecConfig.scipy_default(1023), onesided=False,
            mode="magnitude"), FS, "psd", None),
        ("odd Rader 8191 linear", dataclasses.replace(
            SpecConfig.scipy_default(8191), detrend="linear"), FS, "psd",
         None),
        ("Bluestein 2049", SpecConfig.scipy_default(2049), FS, "psd", None),
        ("Bluestein 8185 (cluster)", SpecConfig.scipy_default(8185), FS,
         "psd", None),
        ("Bluestein 1126 (even, two blocks an SM)",
         SpecConfig.scipy_default(1126), FS, "psd", None),
        ("Bluestein 2049 over nperseg 2000", dataclasses.replace(
            SpecConfig.scipy_default(2000), nfft=2049), FS, "psd", None),
        ("Bluestein magnitude 2049", dataclasses.replace(
            SpecConfig.scipy_default(2049), mode="magnitude"), FS, "psd",
         None),
        ("Bluestein stft (unscaled) 8185 (cluster)",
         SpecConfig.scipy_default(8185), FS, "stft", None),
        ("Bluestein complex two-sided 563, band",
         dataclasses.replace(SpecConfig.scipy_default(563), onesided=False),
         FS, "complex", (10, 500)),
        ("Bluestein 563, T odd", SpecConfig.scipy_default(563), FS, "psd",
         None),
        ("Bluestein 563, NaN in g", SpecConfig.scipy_default(563), FS, "psd",
         None),
        ("GEMM 24", SpecConfig.scipy_default(24), FS, "psd", None),
        ("GEMM 2", SpecConfig.scipy_default(2), FS, "psd", None),
        ("GEMM 13 linear, band", SpecConfig(nperseg=13, hop=4,
                                             detrend="linear"), FS, "psd",
         (1, 5)),
        ("GEMM 31 magnitude", dataclasses.replace(
            SpecConfig.scipy_default(31), mode="magnitude"), FS, "psd",
         None),
        ("GEMM 24 stft (unscaled)", SpecConfig.scipy_default(24), FS,
         "stft", None),
        ("GEMM 12 two-sided (12 bins)", dataclasses.replace(
            SpecConfig.scipy_default(12), onesided=False), FS, "psd", None),
        ("GEMM 24 two-sided, band of 16 bins", dataclasses.replace(
            SpecConfig.scipy_default(24), onesided=False), FS, "psd",
         (4, 20)),
        ("GEMM 24 two-sided (24 bins: B1)", dataclasses.replace(
            SpecConfig.scipy_default(24), onesided=False), FS, "psd", None),
        ("nfft 8200 over 24 (the Bluestein forward, B1)", dataclasses.replace(
            SpecConfig.scipy_default(24), nfft=8200), FS, "psd", None),
        ("nfft 4096 over 1024", dataclasses.replace(s1024, nfft=4096), FS,
         "psd", None),
        ("two-sided 1024", dataclasses.replace(ns, onesided=False), FS,
         "psd", None),
        ("magnitude 1024", dataclasses.replace(s1024, mode="magnitude"), FS,
         "psd", None),
        ("complex 1024", s1024, FS, "complex", None),
        ("stft (unscaled) 1024", s1024, FS, "stft", None),
        ("stft (unscaled) 992", SpecConfig.scipy_default(992), FS, "stft",
         None),
        ("complex two-sided GEMM 24",
         dataclasses.replace(SpecConfig.scipy_default(24), onesided=False),
         FS, "complex", None),
        ("band 0-30 Hz at 1 kHz", s1024, 1000.0, "psd", (0, 31)),
        ("centered reflect 1024", dataclasses.replace(
            ns, center=True, pad_mode="reflect"), FS, "psd", None),
        ("linear 1024", SpecConfig(nperseg=1024, hop=256, detrend="linear"),
         FS, "psd", None),
        ("linear 960", SpecConfig(nperseg=960, hop=240, detrend="linear"),
         FS, "psd", None),
    )
    rs = np.random.RandomState(21)

    def dense_keys():
        return {k for k in stft_cuda._CONSTANTS if k[0] == "dense"}

    def padded_grad(x, xp, dxp, cfg):
        if not cfg.center:
            return dxp
        return torch.autograd.grad(xp, x, dxp, retain_graph=True)[0]

    fft_kinds = stft_cuda.FFT_BACKWARD_ROUTES
    for label, cfg, fs, kind, band in cases:
        k = cfg.nperseg
        n = 6 * k + 123                      # a tail past the last frame
        if "T odd" in label:                 # 7 frames: the last alone
            n = k + 6 * cfg.hop_ + 5
        x = torch.from_numpy(rs.randn(3, n).astype(np.float32)).to(dev)
        x.requires_grad_()
        out = cfg.mode if kind == "psd" else kind
        route = stft_cuda.route(cfg)
        back = stft_cuda.backward_route(cfg, band)
        before, keys = flat_counts(read_counts()), dense_keys()
        if kind == "psd":
            y = stft_cuda.stft_psd(x, fs, cfg, band=band)
        else:
            y = stft_cuda.stft_complex(x, fs, cfg, band,
                                       scaled=kind == "complex")
        gen = torch.Generator(device=dev).manual_seed(len(label))
        g = torch.rand(y.shape, generator=gen, device=dev,
                       dtype=torch.float32)
        if y.is_complex():
            g = torch.complex(g, torch.rand(y.shape, generator=gen,
                                            device=dev) - 0.5)
        if "NaN" in label:                   # stays in frame 1's samples
            g[0, 1, y.shape[2] // 2] = float("nan")
        dx, = torch.autograd.grad(y, x, g)
        torch.cuda.synchronize()
        moved = grad_counts_moved(before, flat_counts(read_counts()))
        if back in fft_kinds:
            # no recompute launch, no dense operands
            want_moved = {f"stft_{route}": 1, f"stft_{back}_backward": 1,
                          "overlap_add": 1}
            require(not dense_keys() - keys,
                    f"grad {label}: the {back} backward built dense "
                    f"operands {dense_keys() - keys}")
        elif back == "small":
            want_moved = {f"stft_{route}": 1, "stft_small_backward": 1,
                          "overlap_add": 1}
        else:
            want_moved = {f"stft_{route}": 2, "stft_backward": 1,
                          "overlap_add": 1}
        require(moved == want_moved, f"grad {label}: launches {moved}")
        consts = stft_cuda.dft_constants(cfg, fs, dev, band, out)
        with torch.enable_grad():
            xp = center_pad(x, cfg)
        xd = xp.detach()
        dxp = stft_cuda.stft_backward_reference(xd, g, consts, cfg, out)
        rel, err = clip_rel(dx, padded_grad(x, xp, dxp, cfg))
        require(rel <= GRAD_TOL, f"grad {label}: {rel:.2e} of the clip's "
                f"largest |gradient|")
        T = num_frames(xp.shape[-1], k, cfg.hop_)
        note = ""
        if back in fft_kinds:
            # the plain FFT adjoint, and stft_backward_kernel forced; with a
            # NaN in g the plain adjoint runs on the host, where each frame
            # is transformed alone (on the card cuFFT's batched c2r
            # transform spreads the NaN past its frame)
            where = torch.device("cpu") if "NaN" in label else dev
            fft_plain = stft_cuda.overlap_add_reference(
                stft_cuda.frames_backward_fft_reference(
                    g.to(where), xd.to(where), cfg, fs, band, out),
                xd.shape[-1], cfg.hop_).to(dev)
            if "NaN" in label:
                on_card = stft_cuda.overlap_add_reference(
                    stft_cuda.frames_backward_fft_reference(
                        g, xd, cfg, fs, band, out), xd.shape[-1], cfg.hop_)
                print(f"{label}: NaN samples of clip 0, the kernel "
                      f"{int(torch.isnan(dx[0]).sum())}, the plain FFT "
                      f"adjoint on the host "
                      f"{int(torch.isnan(fft_plain[0]).sum())}, on the card "
                      f"(cuFFT) {int(torch.isnan(on_card[0]).sum())}; frame 1 "
                      f"spans {k} samples")
            rel_f = clip_rel(dx, padded_grad(x, xp, fft_plain, cfg))[0]
            b1 = stft_cuda.stft_backward(
                xd, g, stft_cuda.GradOp(fs, cfg, band, out, route),
                _backward="dense")
            rel_b = clip_rel(dx, padded_grad(x, xp, b1, cfg))[0]
            require(rel_f <= GRAD_TOL and rel_b <= GRAD_TOL,
                    f"grad {label}: {rel_f:.2e} from the plain FFT adjoint, "
                    f"{rel_b:.2e} from stft_backward_kernel")
            note = (f"; {rel_f:.2e} from the plain FFT adjoint, {rel_b:.2e} "
                    f"from stft_backward_kernel forced")
        if back == "small":
            # its own plain version (X kept in float64), B1 forced, and
            # the same bits in a second run
            small_plain = stft_cuda.overlap_add_reference(
                stft_cuda.frames_backward_small_reference(
                    g, xd, cfg, fs, band, out), xd.shape[-1], cfg.hop_)
            rel_s = clip_rel(dx, padded_grad(x, xp, small_plain, cfg))[0]
            op = stft_cuda.GradOp(fs, cfg, band, out, route)
            b1 = stft_cuda.stft_backward(xd, g, op, _backward="dense")
            rel_b = clip_rel(dx, padded_grad(x, xp, b1, cfg))[0]
            again = stft_cuda.stft_backward(xd, g, op)
            same = torch.equal(padded_grad(x, xp, again, cfg).view(
                torch.int32), dx.view(torch.int32))
            require(rel_s <= GRAD_TOL and rel_b <= GRAD_TOL and same,
                    f"grad {label}: {rel_s:.2e} from B1-small's plain "
                    f"version, {rel_b:.2e} from stft_backward_kernel, the "
                    f"same bits in two runs {same}")
            note = (f"; {rel_s:.2e} from its plain version (X in float64), "
                    f"{rel_b:.2e} from stft_backward_kernel forced, the "
                    f"same bits in two runs")
        print(f"{label} [{route}, backward {back}"
              f"{'' if back in fft_kinds else ': stft_small_backward_kernel'
                 if back == 'small' else ': stft_backward_kernel (B1)'}"
              f"]: "
              f"{rel:.2e} of the clip's largest |gradient| from the plain "
              f"dense backward ({err:.3e} abs){note}, 3 clips x {T} frames; "
              f"launches {moved}")
    # T = 0: no frame, a zero gradient, no backward launch
    x = torch.zeros((2, 500), device=dev, requires_grad=True)
    before = flat_counts(read_counts())
    y = stft_cuda.stft_psd(x, FS, ns)
    dx, = torch.autograd.grad(y, x, torch.zeros_like(y))
    moved = grad_counts_moved(before, flat_counts(read_counts()))
    require(y.shape[1] == 0 and bool((dx == 0).all())
            and not any(k.endswith("backward") for k in moved),
            f"grad T = 0: {moved}")

    # the mel backward at path 12's shapes: 8 clips x 622 frames, 513 bins,
    # 128 mels; an inf gradient of one mel row (NaN outside its span)
    T = num_frames(int(FS * CLIP_SECONDS), 1024, 256)
    F = ns.n_freqs
    spans = mel_cuda.mel_spans(mel_filterbank(128, F, FS), dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    dmel = torch.randn((8, T, 128), generator=gen, device=dev)
    dmel[1, 7, 40] = float("inf")
    got = mel_cuda.mel_backward(dmel, spans)
    torch.cuda.synchronize()
    want = mel_cuda.mel_backward_reference(dmel, spans)
    rel, err = clip_rel(got[2:], want[2:])
    require(rel <= GRAD_TOL and ulp_distance(got, want) <= MEL_ULPS,
            f"mel backward: {rel:.2e}, {ulp_distance(got, want)} ulp")
    require(torch.equal(torch.isnan(got), torch.isnan(want))
            and bool(torch.isnan(got[1, 7]).any()),
            "mel backward: the inf row's NaN bins")
    print(f"mel backward (8 x {T} frames, 128 mels over {F} bins): "
          f"{ulp_distance(got, want)} ulp from the plain version ({err:.3e} "
          f"abs), NaN in its places")
    # the tile layout's edges: a mel band (bins no row covers), 40 mels
    # over 257 bins on a row count not a multiple of the tile's 32, and
    # 64 mels over 4097 bins (the table from global memory, the outputs in
    # chunks of bins); an inf, a -inf and a NaN gradient in each
    for what, fb, shape in (
            ("a mel band, rows 10-99 of 128 over 513 bins",
             mel_filterbank(128, F, FS)[10:100], (3, T)),
            ("40 mels over 257 bins, 4,981 rows",
             mel_filterbank(40, 257, FS), (1, 4981)),
            ("64 mels over 4097 bins", mel_filterbank(64, 4097, FS),
             (2, 50))):
        sp = mel_cuda.mel_spans(fb, dev)
        M_b = len(fb)
        dm = torch.randn(shape + (M_b,), generator=gen, device=dev)
        dm[0, 1, M_b // 3] = float("inf")
        dm[-1, -2, M_b - 1] = -float("inf")
        dm[0, shape[1] // 2, 0] = float("nan")
        before = flat_counts(read_counts())
        got = mel_cuda.mel_backward(dm, sp)
        torch.cuda.synchronize()
        moved = grad_counts_moved(before, flat_counts(read_counts()))
        want = mel_cuda.mel_backward_reference(dm, sp)
        ulps = ulp_distance(got, want)
        rel = clip_rel(got.nan_to_num(0.0, 0.0, 0.0),
                       want.nan_to_num(0.0, 0.0, 0.0))[0]
        require(ulps <= MEL_ULPS and rel <= GRAD_TOL
                and torch.equal(torch.isnan(got), torch.isnan(want))
                and torch.equal(torch.isinf(got), torch.isinf(want))
                and moved == {"mel_backward": 1},
                f"mel backward, {what}: {ulps} ulp, {rel:.2e}, launches "
                f"{moved}")
        print(f"mel backward, {what} ({tuple(dm.shape)} -> "
              f"{tuple(got.shape)}): {ulps} ulp from the plain version, "
              f"NaN and inf in their places; launches {moved}")

    # the display backward at path 1's shapes (PSD rows, log and linear,
    # flipped or not, share_max) and path 12's (mel rows), tied extrema;
    # then edge clips: silent frames (thousands of pixels tied at the min),
    # a pixel equal to the base (u = 1), two clips tied at the batch's max
    # under share_max, a dB range of at most 1e-6, a NaN pixel (the clip's
    # operands from its finite pixels); each within GRAD_TOL of the plain
    # version and the same bits in two runs
    x8 = torch.randn((8, int(FS * CLIP_SECONDS)), generator=gen, device=dev)
    psd, parts = stft_cuda.stft_psd_partials(x8, FS, ns)
    mel, mparts = mel_cuda.mel_project(psd, spans)
    psd_ties = psd.clone()
    psd_ties[0, 10, 3] = psd_ties[0].amax()
    psd_ties[1, 20, :] = psd_ties[1].amin()
    edge = psd.clone()
    edge[0, 40:600] = 0.0                    # 287,280 pixels at the min
    edge[1, 7, 9] = edge[1, 300, 30] = edge[1].amax()   # u = 1 three times
    top = float(edge.amax()) * 2
    edge[2, 5, 5] = edge[3, 600, 500] = edge[3, 9, 0] = top
    edge[4] = 0.25                           # a dB range of 0
    edge[5] = 0.5                            # and one of 5.2e-7 dB
    edge[5, ::2, ::3] = float(np.nextafter(np.float32(0.5), np.float32(1)))
    eparts = stft_cuda.row_partials(edge)
    edge[6, 100, 200] = float("nan")         # after its operands
    for what, rows, prt in (("PSD rows", psd, parts),
                            ("PSD rows, tied extrema", psd_ties,
                             stft_cuda.row_partials(psd_ties)),
                            ("mel rows", mel, mparts),
                            ("edge clips", edge, eparts)):
        for log, flip, share in ((True, True, False), (False, False, False),
                                 (True, False, True), (False, True, True)):
            stats = disp.clip_stats(x8, prt.contiguous(), share)
            if what == "edge clips":
                require(bool((stats.params[:, 0] == stats.params[:, 2])[1])
                        if not share else int((stats.params[:, 2] == top)
                                              .sum()) == 2,
                        f"edge clips: the base and the batch's max "
                        f"{stats.params.tolist()}")
            g = torch.randn((8, rows.shape[2], rows.shape[1]),
                            generator=gen, device=dev)
            before = flat_counts(read_counts())
            got = disp.display_backward(g, rows, stats.params, log_scale=log,
                                        flip_image=flip, share_max=share)
            torch.cuda.synchronize()
            moved = grad_counts_moved(before, flat_counts(read_counts()))
            again = disp.display_backward(g, rows, stats.params,
                                          log_scale=log, flip_image=flip,
                                          share_max=share)
            want = disp.display_backward_reference(
                g, rows, stats.params, log_scale=log, flip_image=flip,
                share_max=share)
            rel, err = clip_rel(got, want)
            same = torch.equal(got.view(torch.int32), again.view(torch.int32))
            require(rel <= GRAD_TOL and moved == {"display_backward": 1}
                    and same,
                    f"display backward, {what}, log {log}, flip {flip}, "
                    f"share_max {share}: {rel:.2e}, launches {moved}, the "
                    f"same bits in two runs {same}")
            print(f"display backward, {what} ({tuple(rows.shape)}), log "
                  f"{log}, flip {flip}, share_max {share}: {rel:.2e} of the "
                  f"clip's largest |gradient| ({err:.3e} abs), the same bits "
                  f"in two runs")
    torch.cuda.empty_cache()


def stft_backward_bound(R, F, L, K, g_bytes=4):
    """Kernel 1: g and X (complex64) read once and d written once, or a
    real FFT's 2.5 K log2 K a frame at the FP64 peak, the larger."""
    t_mem = (R * F * (g_bytes + 8) + R * L * 4) / HBM_RATE
    t_ops = R * 2.5 * K * math.log2(K) / FP64_PEAK
    return (1e3 * max(t_mem, t_ops),
            "operations" if t_ops >= t_mem else "bytes")


def stft_fft_backward_bound(x_elems, R, F, L, K, g_bytes=4):
    """The radix-2 adjoint: the waveform x and g read once and d written
    once, or two real FFTs' 2 x 2.5 K log2 K a frame at the FP64 peak, the
    larger."""
    t_mem = (x_elems * 4 + R * F * g_bytes + R * L * 4) / HBM_RATE
    t_ops = R * 5 * K * math.log2(K) / FP64_PEAK
    return (1e3 * max(t_mem, t_ops),
            "operations" if t_ops >= t_mem else "bytes")


# the port's kernels of path 21's step, by a part of their names
STEP_KERNELS = ("stft_fft_psd_kernel", "clip_stats_kernel",
                "display_map_kernel", "mel_project_kernel",
                "mel_chunked_kernel",
                "stft_fft_backward_kernel", "overlap_add_kernel",
                "mel_backward_kernel", "display_grad_prep_kernel",
                "display_grad_kernel")


def _torch_op(name):
    """A short name for one of torch's own device kernels: its functor or
    reduction (FillFunctor, MeanOps, ...), a copy, a memset."""
    import re
    for word in ("Memset", "Memcpy"):
        if word in name:
            return word.lower()
    m = re.search(r"(\w*Functor\w*|\w*Ops\w*|\w*copy\w*)", name)
    return m.group(1) if m else name.replace("void ", "")[:60]


def step_split(step, what, card):
    """One training step under torch.profiler (after a warm-up): the
    port's kernels' device ms by name, torch's own device kernels' ms by
    op (the loss's reductions, autograd's fills and adds, copies), the
    device's busy ms and the rest of the step's wall time (host clock,
    profiled), the host's gaps; None when the profiler shows no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.5)               # let the device tracing start first
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        print(f"{what}: torch.profiler shows no device time; not measured")
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    ours, theirs = {}, {}
    for e in device:
        ms = 1e-3 * (e.time_range.end - e.time_range.start)
        key = next((k for k in STEP_KERNELS if k in e.name), None)
        if key:
            ours[key] = ours.get(key, 0.0) + ms
        else:
            op = _torch_op(e.name)
            theirs[op] = theirs.get(op, 0.0) + ms
    out = {"wall_ms": wall, "busy_ms": busy / 1e3,
           "host_gaps_ms": wall - busy / 1e3, "kernels_ms": ours,
           "torch_ops_ms": theirs,
           "torch_ops_total_ms": sum(theirs.values())}
    print(f"{what}, split by torch.profiler [{card}]: wall {wall:.3f} ms "
          f"(profiled), device busy {busy / 1e3:.3f}, host gaps "
          f"{wall - busy / 1e3:.3f}; the port's kernels "
          + ", ".join(f"{k} {v:.3f}" for k, v in ours.items())
          + f"; torch's own ops {out['torch_ops_total_ms']:.3f}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
              theirs.items(), key=lambda kv: -kv[1])))
    return out


def grad_path(dev, card):
    """Path 21, gradients on the card: path 1's batch (1024 clips x 10 s at
    16 kHz) as a waveform that requires grad, three SGD steps through
    ``batched_spectrogram_fn`` at north_star 1024/256 log (the loss on the
    image and the PSD), then three at path 12's 128 log mels (on the mel
    rows and the image); each step's loss, gradient norm, wall ms and
    launches printed (the radix-2 backward, stft_fft_backward_kernel), its
    gradient on GRAD_CLIPS clips held within GRAD_TOL of the plain
    backward on the card; then ``power_spectrogram`` and ``stft`` on 10
    minutes at 48 kHz (path 16's config) the same way, and
    ``power_spectrogram`` on 8 clips of 60 s at scipy_default 8160 (path
    4's config, the mixed route: stft_mixed_fft_backward_kernel), 8186
    (path 11's, its Rader plan: the odd kernel's PACKED form), 8191
    (path 7's, the odd route: stft_odd_fft_backward_kernel), 8182 and
    8185 (paths 9's and 8's, the Bluestein route on one block and on a
    cluster: stft_bluestein_fft_backward_kernel), one forward and one
    backward launch each, and 24 (path 10's, the GEMM route: its complex
    epilogue's recompute, then stft_backward_kernel);
    one SGD step at path 4's config on its
    whole batch (256 clips x 60 s, scipy_default 8160 log), checked on
    GRAD_CLIPS clips; each backward kernel timed at path 1's and path
    12's shapes against its plain version, its bound and its library
    call, stft_backward_kernel (B1) forced there and on its own route at
    path 10's shapes, and the mixed, odd and Bluestein adjoints at paths
    4, 7, 11, 8 and 9's shapes against theirs and B1 forced.
    No cache is trimmed first: the device operands' cache is bounded
    (``stft_cuda.CONSTANTS_BUDGET``)."""
    import dataclasses
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.mel import mel_filterbank
    from spectral_tpu_torch.core.stft import (band_row_slice, freq_axis,
                                              num_frames, power_spectrogram,
                                              stft)
    from spectral_tpu_torch.ops import display_cuda as disp
    from spectral_tpu_torch.ops import mel_cuda, stft_cuda
    from spectral_tpu_torch.parallel.sharding import batched_spectrogram_fn

    t_path = time.perf_counter()
    cached = sum(stft_cuda._tensor_bytes(v)
                 for v in stft_cuda._CONSTANTS.values())
    require(cached <= stft_cuda.CONSTANTS_BUDGET,
            f"{cached} bytes of cached operands, past the budget")
    print(f"path 21 starts with {torch.cuda.memory_allocated() / 2 ** 30:.2f}"
          f" GiB allocated, {cached / 2 ** 30:.2f} GiB of it the operand "
          f"cache's ({len(stft_cuda._CONSTANTS)} entries; budget "
          f"{stft_cuda.CONSTANTS_BUDGET / 2 ** 30:.0f} GiB a device)")
    n = int(FS * CLIP_SECONDS)
    T = num_frames(n, 1024, 256)
    plain = SpecConfig.north_star(1024, 256, log_scale=True)
    mels = SpecConfig.north_star(1024, 256, n_mels=128, log_scale=True)
    F, M = plain.n_freqs, 128
    phase(f"path 21, gradients: {BATCH} clips x {CLIP_SECONDS:g} s at "
          f"{FS:g} Hz that require grad, {GRAD_STEPS} SGD steps at "
          f"north_star 1024/256 log and at 128 log mels")
    gen = torch.Generator(device=dev).manual_seed(21)
    x0 = torch.randn((BATCH, n), generator=gen, device=dev)
    spans = mel_cuda.mel_spans(mel_filterbank(128, F, FS), dev)
    consts = stft_cuda.dft_constants(plain, FS, dev, None, "psd")
    reset_counts()
    for label, cfg, keys in (("plain", plain, ("image", "psd")),
                             ("mel", mels, ("image", "mel"))):
        fn = batched_spectrogram_fn(FS, cfg, flip_image=True)
        x = x0.clone().requires_grad_()
        with torch.no_grad():
            scale = float(fn(x)[keys[1]].mean())
        for step in range(GRAD_STEPS):
            before = flat_counts(read_counts())
            t0 = time.perf_counter()
            out = fn(x)
            loss = out[keys[0]].mean() + out[keys[1]].mean() / scale
            loss.backward()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            moved = grad_counts_moved(before, flat_counts(read_counts()))
            want_moved = {"stft_fft": 1, "clip_stats": 1, "rgba": 1,
                          "display_backward": 1, "stft_fft_backward": 1,
                          "overlap_add": 1}
            if cfg.n_mels:
                want_moved.update(mel=1, mel_backward=1)
            require(moved == want_moved, f"path 21 {label} step {step}: "
                    f"launches {moved}, want {want_moved}")
            # the plain backward on GRAD_CLIPS clips, from the same forward
            c = GRAD_CLIPS
            xs = x.detach()[:c]
            shown = out["mel" if cfg.n_mels else "psd"].detach()[:c]
            st = disp.clip_stats_reference(xs, stft_cuda.row_partials(shown))
            g_img = torch.full((c, shown.shape[2], T),
                               1.0 / out["image"].numel(), device=dev)
            g_out = torch.full(out[keys[1]][:c].shape,
                               1.0 / (out[keys[1]].numel() * scale),
                               device=dev)
            d_shown = disp.display_backward_reference(
                g_img, shown, st.params, log_scale=True, flip_image=True)
            d_shown = d_shown + g_out
            d_psd = (mel_cuda.mel_backward_reference(d_shown, spans)
                     if cfg.n_mels else d_shown)
            want = stft_cuda.stft_backward_reference(xs, d_psd, consts, cfg,
                                                     "psd")
            rel, err = clip_rel(x.grad[:c], want)
            require(rel <= GRAD_TOL and bool(torch.isfinite(x.grad).all()),
                    f"path 21 {label} step {step}: {rel:.2e} of the clip's "
                    f"largest |gradient| from the plain backward")
            gnorm = float(x.grad.norm())
            print(f"{label} step {step}: loss {float(loss.detach()):.7f}, |grad| "
                  f"{gnorm:.4e}, {wall * 1e3:.1f} ms forward + backward "
                  f"(host clock, synchronised); {c} clips {rel:.2e} of the "
                  f"clip's largest |gradient| from the plain backward "
                  f"({err:.3e} abs); launches {moved}")
            with torch.no_grad():
                x -= 0.5 * x.grad / x.grad.abs().amax()
            x.grad = None
            del out, loss, want, d_psd, d_shown
        del x
        torch.cuda.empty_cache()

    # power_spectrogram and stft on 10 minutes at 48 kHz (path 16's config)
    fs16 = 48000.0
    cfg16 = SpecConfig.scipy_default(1024, fmin=0.0, fmax=4000.0)
    band = band_row_slice(freq_axis(cfg16, fs16), cfg16.fmin, cfg16.fmax)
    xh = torch.randn((1, int(fs16 * 600)), generator=gen, device=dev)
    for what in ("power_spectrogram", "stft"):
        x = xh.clone().requires_grad_()
        before = flat_counts(read_counts())
        if what == "power_spectrogram":
            y = power_spectrogram(x, fs16, cfg16, band=band)
            g = torch.full(y.shape, 1.0 / y.numel(), device=dev)
            out, cband = "psd", band
        else:
            y = stft(x, cfg16)
            g = torch.complex(torch.full(y.shape, 1.0, device=dev),
                              torch.full(y.shape, -0.5, device=dev))
            out, cband = "stft", None
        y.backward(g)
        torch.cuda.synchronize()
        moved = grad_counts_moved(before, flat_counts(read_counts()))
        require(moved == {"stft_fft": 1, "stft_fft_backward": 1,
                          "overlap_add": 1}, f"path 21 {what}: {moved}")
        want = stft_cuda.stft_backward_reference(
            xh, g, stft_cuda.dft_constants(cfg16, fs16, dev, cband, out),
            cfg16, out)
        rel, err = clip_rel(x.grad, want)
        require(rel <= GRAD_TOL, f"path 21 {what}: {rel:.2e}")
        print(f"{what} on 10 minutes at 48 kHz ({tuple(y.shape)}): the "
              f"gradient {rel:.2e} of its largest from the plain backward "
              f"({err:.3e} abs); launches {moved}")
        del x, y, g, want
    del xh
    # the mixed route, its Rader plan, the odd route and the Bluestein
    # route (one block and a cluster): one forward and one backward launch
    # each, X recomputed inside the backward; the GEMM route at path 10's
    # config: one forward and one launch of B1-small, X recomputed inside;
    # the GEMM route's two-sided spectrum below 32 (24 bins) and nfft past
    # 8192 (8200 over nperseg 24, on 1 clip of 10 s, whose X the Bluestein
    # kernel recomputes): B1 after the recompute of X
    s24 = SpecConfig.scipy_default(GEMM_NPERSEG)
    for k, cfgk, clips, seconds in (
            (MIXED_NPERSEG, None, 8, K2_SECONDS),
            (RADER_NPERSEG, None, 8, K2_SECONDS),
            (ODD_NPERSEG, None, 8, K2_SECONDS),
            (BLUESTEIN_EVEN_NPERSEG, None, 8, K2_SECONDS),
            (BLUESTEIN_NPERSEG, None, 8, K2_SECONDS),
            (GEMM_NPERSEG, None, 8, K2_SECONDS),
            ("24 two-sided", dataclasses.replace(s24, onesided=False), 8,
             K2_SECONDS),
            ("8200 over 24", dataclasses.replace(s24, nfft=8200), 1,
             CLIP_SECONDS)):
        cfgk = cfgk or SpecConfig.scipy_default(k)
        route, back = stft_cuda.route(cfgk), stft_cuda.backward_route(cfgk)
        x = torch.randn((clips, int(FS * seconds)), generator=gen,
                        device=dev).requires_grad_()
        before = flat_counts(read_counts())
        dense = {key for key in stft_cuda._CONSTANTS if key[0] == "dense"}
        t0 = time.perf_counter()
        y = power_spectrogram(x, FS, cfgk)
        g = torch.rand(y.shape, generator=gen, device=dev)
        y.backward(g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = grad_counts_moved(before, flat_counts(read_counts()))
        want_moved = ({f"stft_{route}": 2, "stft_backward": 1,
                       "overlap_add": 1} if back == "dense" else
                      {f"stft_{route}": 1, f"stft_{back}_backward": 1,
                       "overlap_add": 1})
        require(moved == want_moved, f"path 21 {k}: {moved}")
        built = {key for key in stft_cuda._CONSTANTS
                 if key[0] == "dense"} - dense
        require(back in ("dense", "small") or not built,
                f"path 21 {k}: the {back} backward built dense operands")
        if back == "small":
            # its own plain version; B1 forced is held to it after the
            # path's counts are read (gemm_backward_times)
            want = stft_cuda.overlap_add_reference(
                stft_cuda.frames_backward_small_reference(
                    g, x.detach(), cfgk, FS), x.shape[-1], cfgk.hop_)
        else:
            want = stft_cuda.stft_backward_reference(
                x.detach(), g, stft_cuda.dft_constants(cfgk, FS, dev),
                cfgk, "psd")
        rel, err = clip_rel(x.grad, want)
        require(rel <= GRAD_TOL, f"path 21 {k}: {rel:.2e}")
        print(f"power_spectrogram at scipy_default {k} ({route} route, "
              f"backward {back}) on {clips} x {seconds:g} s "
              f"({tuple(y.shape)}): {rel:.2e} of the clip's largest "
              f"|gradient| from the plain backward ({err:.3e} abs); "
              f"{wall * 1e3:.1f} ms forward + backward (host clock, "
              f"synchronised, first call: the operands built); launches "
              f"{moved}")
        del x, y, g, want
        torch.cuda.empty_cache()

    # one SGD step at path 4's config on its whole batch
    cfg4 = SpecConfig.scipy_default(MIXED_NPERSEG, log_scale=True)
    n4 = int(FS * K2_SECONDS)
    T4 = num_frames(n4, MIXED_NPERSEG, cfg4.hop_)
    phase(f"path 21, an SGD step at path 4's config: {K2_CLIPS} clips x "
          f"{K2_SECONDS:g} s, scipy_default {MIXED_NPERSEG} log")
    fn4 = batched_spectrogram_fn(FS, cfg4, flip_image=True)
    x = torch.randn((K2_CLIPS, n4), generator=gen,
                    device=dev).requires_grad_()
    with torch.no_grad():
        scale = float(fn4(x)["psd"].mean())
    before = flat_counts(read_counts())
    t0 = time.perf_counter()
    out = fn4(x)
    loss = out["image"].mean() + out["psd"].mean() / scale
    loss.backward()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moved = grad_counts_moved(before, flat_counts(read_counts()))
    want_moved = {"stft_mixed": 1, "clip_stats": 1, "rgba": 1,
                  "display_backward": 1, "stft_mixed_backward": 1,
                  "overlap_add": 1}
    require(moved == want_moved, f"path 21 path-4 step: launches {moved}, "
            f"want {want_moved}")
    c = GRAD_CLIPS
    shown = out["psd"].detach()[:c]
    st = disp.clip_stats_reference(x.detach()[:c],
                                   stft_cuda.row_partials(shown))
    g_img = torch.full((c, shown.shape[2], T4), 1.0 / out["image"].numel(),
                       device=dev)
    d_shown = disp.display_backward_reference(
        g_img, shown, st.params, log_scale=True, flip_image=True)
    d_shown = d_shown + 1.0 / (out["psd"].numel() * scale)
    want = stft_cuda.stft_backward_reference(
        x.detach()[:c], d_shown, stft_cuda.dft_constants(cfg4, FS, dev),
        cfg4, "psd")
    rel, err = clip_rel(x.grad[:c], want)
    require(rel <= GRAD_TOL and bool(torch.isfinite(x.grad).all()),
            f"path 21 path-4 step: {rel:.2e} of the clip's largest "
            f"|gradient| from the plain backward")
    print(f"path 4's config step: loss {float(loss.detach()):.7f}, |grad| "
          f"{float(x.grad.norm()):.4e}, {wall * 1e3:.1f} ms forward + "
          f"backward (host clock, synchronised); {c} clips {rel:.2e} of the "
          f"clip's largest |gradient| from the plain backward ({err:.3e} "
          f"abs); launches {moved}")
    del x, out, loss, want, d_shown, g_img, shown
    torch.cuda.empty_cache()
    counts = flat_counts(read_counts())
    print(f"launches in this path's run: {counts}")
    t_steps = time.perf_counter() - t_path

    phase(f"path 21 times (CUDA events, median of {REPS} after a warm-up; "
          f"{card})")
    # the step split by torch.profiler at path 1's batch and at 128 mels
    splits = {}
    for label, cfg, keys in (("plain", plain, ("image", "psd")),
                             ("mel", mels, ("image", "mel"))):
        fn = batched_spectrogram_fn(FS, cfg, flip_image=True)
        with torch.no_grad():
            scale = float(fn(x0)[keys[1]].mean())

        def step(fn=fn, keys=keys, scale=scale):
            xs = x0.clone().requires_grad_()
            out = fn(xs)
            (out[keys[0]].mean() + out[keys[1]].mean() / scale).backward()

        splits[label] = step_split(step, f"path 21's {label} step at path "
                                   f"1's batch", card)
        torch.cuda.empty_cache()
    print(json.dumps({"path21_step_split": splits, "card": card}))
    x = x0
    chunks = [slice(i, i + 256) for i in range(0, BATCH, 256)]
    g = torch.rand((BATCH, T, F), generator=gen, device=dev)
    # the radix-2 adjoint against its plain version and forced B1
    d_fft = stft_cuda.frames_backward_fft(g, x, plain, FS)
    t5 = time_ms(lambda: stft_cuda.frames_backward_fft(g, x, plain, FS))
    t5p = time_ms(lambda: [stft_cuda.frames_backward_fft_reference(
        g[c], x[c], plain, FS) for c in chunks])
    rel5, err5 = clip_rel(d_fft[:GRAD_CLIPS],
                          stft_cuda.frames_backward_fft_reference(
                              g[:GRAD_CLIPS], x[:GRAD_CLIPS], plain, FS))
    X = stft_cuda._stft_psd_cuda(x, FS, plain, False, False,
                                 out_mode="stft")
    d = stft_cuda.frames_backward(g, X, consts, "psd")
    rel5b = clip_rel(d_fft, d)[0]
    require(rel5 <= GRAD_TOL and rel5b <= GRAD_TOL,
            f"path 21 stft_fft_backward: {rel5:.2e} from its plain version, "
            f"{rel5b:.2e} from stft_backward_kernel")
    print(f"stft_fft_backward_kernel at path 1's shapes: {rel5:.2e} of the "
          f"clip's largest |d| from the plain FFT adjoint ({GRAD_CLIPS} "
          f"clips), {rel5b:.2e} from stft_backward_kernel (all clips)")
    del d_fft
    d_plain = stft_cuda.frames_backward_reference(g[:GRAD_CLIPS],
                                                  X[:GRAD_CLIPS], consts,
                                                  "psd")
    err1 = clip_rel(d[:GRAD_CLIPS], d_plain)[1]
    dx = stft_cuda.overlap_add(d, n, 256)
    err2 = clip_rel(dx[:GRAD_CLIPS], stft_cuda.overlap_add_reference(
        d[:GRAD_CLIPS], n, 256))[1]
    del d_plain, dx
    t1 = time_ms(lambda: stft_cuda.frames_backward(g, X, consts, "psd"))
    t1p = time_ms(lambda: [stft_cuda.frames_backward_reference(
        g[c], X[c], consts, "psd") for c in chunks])
    t2 = time_ms(lambda: stft_cuda.overlap_add(d, n, 256))
    t2p = time_ms(lambda: stft_cuda.overlap_add_reference(d, n, 256))
    t2l = time_ms(lambda: torch.nn.functional.fold(
        d.transpose(1, 2), (1, n), (1, 1024), stride=(1, 256)))
    del X, d
    torch.cuda.empty_cache()
    # the library: the backward of cuFFT's f64 PSD under autograd
    torch.cuda.reset_peak_memory_stats()
    xl = x.clone().requires_grad_()
    yl = library_psd(xl, plain)
    t1l = time_ms(lambda: torch.autograd.grad(yl, xl, g,
                                              retain_graph=True))[0]
    print(f"the library's backward peaked at "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB allocated")
    del xl, yl
    torch.cuda.empty_cache()
    # the mel backward at path 12's shapes
    dmel = torch.randn((BATCH, T, M), generator=gen, device=dev)
    got = mel_cuda.mel_backward(dmel[:GRAD_CLIPS], spans)
    err3 = clip_rel(got, mel_cuda.mel_backward_reference(
        dmel[:GRAD_CLIPS], spans))[1]
    t3 = time_ms(lambda: mel_cuda.mel_backward(dmel, spans))
    t3p = time_ms(lambda: mel_cuda.mel_backward_reference(dmel, spans))
    t3l = time_ms(lambda: torch.matmul(dmel.double(), spans.rows))
    del dmel, got
    # the display backward at path 1's shapes
    psd, parts = stft_cuda.stft_psd_partials(x, FS, plain)
    stats = disp.clip_stats(x, parts)
    gi = torch.rand((BATCH, F, T), generator=gen, device=dev)
    kw = dict(log_scale=True, flip_image=True)
    got = disp.display_backward(gi[:GRAD_CLIPS], psd[:GRAD_CLIPS],
                                stats.params[:GRAD_CLIPS], **kw)
    err4 = clip_rel(got, disp.display_backward_reference(
        gi[:GRAD_CLIPS], psd[:GRAD_CLIPS], stats.params[:GRAD_CLIPS],
        **kw))[1]
    t4 = time_ms(lambda: disp.display_backward(gi, psd, stats.params, **kw))
    t4p = time_ms(lambda: [disp.display_backward_reference(
        gi[c], psd[c], stats.params[c], **kw) for c in chunks])
    del psd, parts, gi, got
    torch.cuda.empty_cache()
    R = BATCH * T
    b5 = stft_fft_backward_bound(BATCH * n, R, F, 1024, 1024)
    b1 = stft_backward_bound(R, F, 1024, 1024)
    b2 = (1e3 * (R * 1024 * 4 + BATCH * n * 4) / HBM_RATE, "bytes")
    b3 = (1e3 * (R * M * 4 + R * F * 4) / HBM_RATE, "bytes")
    b4 = (1e3 * (3 * R * F * 4 + BATCH * 12) / HBM_RATE, "bytes")
    rows = {}
    for key, name, (ms, reps), (pms, _), lib_ms, bound, err, note in (
            ("stft_fft_backward", "stft_fft_backward_kernel", t5, t5p, t1l,
             b5, err5, "library: the backward of library_psd (cuFFT f64, "
             "autograd) over kernels 1 and 2"),
            (None, "stft_backward_kernel (B1) forced at path 1's shapes",
             t1, t1p, t1l, b1, err1, "library: the backward of library_psd "
             "(cuFFT f64, autograd) over kernels 1 and 2"),
            ("overlap_add", "overlap_add_kernel", t2, t2p, t2l[0], b2, err2,
             "library: torch.nn.functional.fold"),
            ("mel_backward", "mel_backward_kernel", t3, t3p, t3l[0], b3,
             err3, "library: torch.matmul f64"),
            ("display_backward", "display_backward (prep + pass)", t4, t4p,
             None, b4, err4, "no library call")):
        print(f"{name}: {ms:.4f} ms [{card}] reps {reps}; bound "
              f"{bound[0]:.4f} ms ({bound[1]}); plain {pms:.3f} ms; library "
              f"{'none' if lib_ms is None else f'{lib_ms:.3f} ms'} ({note})")
        if key:
            rows[key] = dict(launches=counts[key], err=err, ms=ms,
                             plain_ms=pms, bound=bound, library_ms=lib_ms)
    rows.update(gemm_backward_times(dev, card, gen, counts))
    rows.update(engine_backward_times(dev, card, gen, counts))
    print(json.dumps({"path21_times": {k: {kk: v[kk] for kk in
                                           ("ms", "plain_ms", "library_ms")}
                                       for k, v in rows.items()},
                      "card": card}))
    print(f"path 21 took {time.perf_counter() - t_path:.1f} s (the steps "
          f"and checks {t_steps:.1f} s)")
    return rows


def engine_backward_times(dev, card, gen, counts):
    """The mixed, odd and Bluestein routes' FFT adjoints timed at paths 4,
    7, 11, 8 and 9's shapes (256 clips x 60 s at scipy_default 8160, 8191,
    8186, 8185 and 8182), each against its bound, its plain version
    (``frames_backward_fft_reference`` in chunks of 16 clips),
    stft_backward_kernel (B1) forced on the same g and a recomputed X, and
    the library: the backward of ``library_psd`` (cuFFT f64) under
    autograd, in chunks of 64 clips (one batch's graph does not fit the
    card), the chunks' medians summed. Returns the kernels-line rows of
    the mixed (8160), odd (8191) and Bluestein (8182, one block) adjoints;
    8186 (the PACKED form, counted as the mixed route's) and 8185 (the
    Bluestein cluster) are printed."""
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.stft import num_frames
    from spectral_tpu_torch.ops import stft_cuda

    n = int(FS * K2_SECONDS)
    x = torch.randn((K2_CLIPS, n), generator=gen, device=dev)
    rows = {}
    adjoints = {"mixed": stft_cuda.frames_backward_mixed,
                "odd": stft_cuda.frames_backward_odd,
                "bluestein": stft_cuda.frames_backward_bluestein}
    for key, k, path in (("stft_mixed_backward", MIXED_NPERSEG, 4),
                         ("stft_odd_backward", ODD_NPERSEG, 7),
                         (None, RADER_NPERSEG, 11),
                         (None, BLUESTEIN_NPERSEG, 8),
                         ("stft_bluestein_backward", BLUESTEIN_EVEN_NPERSEG,
                          9)):
        cfg = SpecConfig.scipy_default(k)
        back = stft_cuda.backward_route(cfg)
        frames = adjoints[back]
        T, F = num_frames(n, k, cfg.hop_), cfg.n_freqs
        R = K2_CLIPS * T
        g = torch.rand((K2_CLIPS, T, F), generator=gen, device=dev)
        d = frames(g, x, cfg, FS)
        t = time_ms(lambda: frames(g, x, cfg, FS))
        small = [slice(i, i + 16) for i in range(0, K2_CLIPS, 16)]
        tp = time_ms(lambda: [stft_cuda.frames_backward_fft_reference(
            g[c], x[c], cfg, FS) for c in small], reps=3)
        rel, err = clip_rel(d[:GRAD_CLIPS],
                            stft_cuda.frames_backward_fft_reference(
                                g[:GRAD_CLIPS], x[:GRAD_CLIPS], cfg, FS))
        X = stft_cuda._stft_psd_cuda(x, FS, cfg, False, False,
                                     out_mode="stft")
        consts = stft_cuda.dft_constants(cfg, FS, dev)
        d1 = stft_cuda.frames_backward(g, X, consts, "psd")
        rel1 = clip_rel(d, d1)[0]
        require(rel <= GRAD_TOL and rel1 <= GRAD_TOL,
                f"path {path}'s shapes, the {back} adjoint: {rel:.2e} from "
                f"its plain version, {rel1:.2e} from stft_backward_kernel")
        del d1
        tb1 = time_ms(lambda: stft_cuda.frames_backward(g, X, consts, "psd"),
                      reps=3)
        del X, d
        torch.cuda.empty_cache()
        tl = 0.0
        for c in [slice(i, i + 64) for i in range(0, K2_CLIPS, 64)]:
            xl = x[c].clone().requires_grad_()
            yl = library_psd(xl, cfg)
            gc = g[c]
            tl += time_ms(lambda: torch.autograd.grad(yl, xl, gc,
                                                      retain_graph=True),
                          reps=3)[0]
            del xl, yl
            torch.cuda.empty_cache()
        bound = stft_fft_backward_bound(K2_CLIPS * n, R, F, k, k)
        print(f"the {back} adjoint at path {path}'s shapes (scipy_default "
              f"{k}, {K2_CLIPS} x {K2_SECONDS:g} s, {R} frames): {t[0]:.4f} "
              f"ms [{card}] reps {t[1]}; bound {bound[0]:.4f} ms "
              f"({bound[1]}); plain {tp[0]:.3f} ms; stft_backward_kernel "
              f"(B1) forced {tb1[0]:.3f} ms; library {tl:.3f} ms (the "
              f"backward of library_psd, cuFFT f64, autograd, 4 chunks of "
              f"64 clips); {rel:.2e} of the clip's largest |d| from the "
              f"plain version ({GRAD_CLIPS} clips), {rel1:.2e} from B1 (all "
              f"clips)")
        require(t[0] < tb1[0], f"the {back} adjoint at path {path}'s shapes "
                f"is no faster than B1 forced")
        if key:
            rows[key] = dict(launches=counts[key], err=err, ms=t[0],
                             plain_ms=tp[0], bound=bound, library_ms=tl,
                             b1_ms=tb1[0])
        del g
        stft_cuda._CONSTANTS.clear()
        torch.cuda.empty_cache()
    return rows


def stft_small_backward_bound(x_elems, R, F, L):
    """B1-small: the waveform x and g read once and d written once, or its
    float64 operations, 2 L F multiply-adds for X and 2 L F for d a frame
    (a FLOP two), at the card's FP64 peak, the larger."""
    t_mem = (x_elems * 4 + R * F * 4 + R * L * 4) / HBM_RATE
    t_ops = R * 2 * (4 * L * F) / FP64_PEAK
    return (1e3 * max(t_mem, t_ops),
            "operations" if t_ops >= t_mem else "bytes")


def gemm_backward_times(dev, card, gen, counts):
    """The GEMM route's backward at path 10's shapes (1024 clips x 10 s at
    scipy_default 24): B1-small (stft_small_backward_kernel, X recomputed
    in registers) against its bound (x and g read once, d written once, or
    its float64 operations at the FP64 peak), its plain version
    (``frames_backward_small_reference`` in chunks of 256 clips), the
    same bits in two runs and, per clip within GRAD_TOL, B1 forced on the
    same g; stft_backward_kernel (B1), which the route ran there before,
    alone and after the recompute of X by the GEMM kernel's complex
    epilogue, against its bound (g and X read once, d written once) and
    its plain version (``frames_backward_reference`` in chunks); the
    library, the backward of ``library_psd`` (cuFFT f64) under autograd.
    Returns the kernels-line rows of stft_small_backward and
    stft_backward."""
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.stft import num_frames
    from spectral_tpu_torch.ops import stft_cuda

    cfg = SpecConfig.scipy_default(GEMM_NPERSEG)
    n = int(FS * CLIP_SECONDS)
    T, F, L = num_frames(n, GEMM_NPERSEG, cfg.hop_), cfg.n_freqs, cfg.nperseg
    R = BATCH * T
    x = torch.randn((BATCH, n), generator=gen, device=dev)
    g = torch.rand((BATCH, T, F), generator=gen, device=dev)
    consts = stft_cuda.dft_constants(cfg, FS, dev)
    require(stft_cuda.backward_route(cfg) == "small",
            "scipy_default 24 is off the GEMM route's small-K backward")
    chunks = [slice(i, i + 256) for i in range(0, BATCH, 256)]

    def small():
        return stft_cuda.frames_backward_small(g, x, cfg, FS)

    def recompute():
        return stft_cuda._stft_psd_cuda(x, FS, cfg, False, False,
                                        out_mode="stft")

    ds = small()
    again = small()
    same = torch.equal(ds.view(torch.int32), again.view(torch.int32))
    del again
    rel_s, err_s = clip_rel(ds[:GRAD_CLIPS],
                            stft_cuda.frames_backward_small_reference(
                                g[:GRAD_CLIPS], x[:GRAD_CLIPS], cfg, FS))
    X = recompute()
    d = stft_cuda.frames_backward(g, X, consts, "psd")
    rel_b = clip_rel(ds, d)[0]
    require(rel_s <= GRAD_TOL and rel_b <= GRAD_TOL and same,
            f"B1-small at path 10's shapes: {rel_s:.2e} from its plain "
            f"version, {rel_b:.2e} from stft_backward_kernel, the same bits "
            f"in two runs {same}")
    del ds
    ts = time_ms(small)
    tsp = time_ms(lambda: [stft_cuda.frames_backward_small_reference(
        g[c], x[c], cfg, FS) for c in chunks], reps=3)
    err = clip_rel(d[:GRAD_CLIPS], stft_cuda.frames_backward_reference(
        g[:GRAD_CLIPS], X[:GRAD_CLIPS], consts, "psd"))[1]
    t = time_ms(lambda: stft_cuda.frames_backward(g, X, consts, "psd"))
    tr = time_ms(lambda: stft_cuda.frames_backward(g, recompute(), consts,
                                                   "psd"))
    tp = time_ms(lambda: [stft_cuda.frames_backward_reference(
        g[c], X[c], consts, "psd") for c in chunks], reps=3)
    del X, d
    torch.cuda.empty_cache()
    xl = x.clone().requires_grad_()
    yl = library_psd(xl, cfg)
    tl = time_ms(lambda: torch.autograd.grad(yl, xl, g, retain_graph=True),
                 reps=3)[0]
    del xl, yl
    torch.cuda.empty_cache()
    bound_s = stft_small_backward_bound(BATCH * n, R, F, L)
    bound = stft_backward_bound(R, F, L, cfg.nfft_)
    print(f"stft_small_backward_kernel (B1-small) at path 10's shapes "
          f"(scipy_default {GEMM_NPERSEG}, {BATCH} x {CLIP_SECONDS:g} s, {R} "
          f"frames of {F} bins): {ts[0]:.4f} ms [{card}] reps {ts[1]}; "
          f"bound {bound_s[0]:.4f} ms ({bound_s[1]}); plain {tsp[0]:.3f} "
          f"ms; library {tl:.3f} ms (the backward of library_psd, cuFFT "
          f"f64, autograd); {rel_s:.2e} of the clip's largest |d| from its "
          f"plain version ({GRAD_CLIPS} clips), {rel_b:.2e} from B1 (all "
          f"clips), the same bits in two runs")
    print(f"stft_backward_kernel (B1) on the same shapes, forced: "
          f"{t[0]:.4f} ms [{card}] reps {t[1]}; after the recompute of X "
          f"(the GEMM kernel's complex epilogue) {tr[0]:.4f} ms; bound "
          f"{bound[0]:.4f} ms ({bound[1]}); plain {tp[0]:.3f} ms")
    return {
        "stft_small_backward": dict(
            launches=counts["stft_small_backward"], err=err_s, ms=ts[0],
            plain_ms=tsp[0], bound=bound_s, library_ms=tl,
            extra={"b1_recompute_ms": tr[0]}),
        "stft_backward": dict(
            launches=counts["stft_backward"], err=err, ms=t[0],
            plain_ms=tp[0], bound=bound, library_ms=tl,
            extra={"recompute_ms": tr[0]})}


PHASES = ("kernels", "tail", "dc", "scipy", "band", "mel", "path1", "path2",
          "path3", "path4", "path5", "path6", "path7", "path8", "path9",
          "path10", "path11", "path12", "path13", "hmm", "path14", "path15",
          "path16", "path17", "path18", "gui", "path19", "path20", "grad",
          "path21", "path22")


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
        large_kernel_cases(dev)
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
    if "path16" in phases:
        rows.update(session_path(dev, card))
        torch.cuda.empty_cache()
    if "path17" in phases:
        rows.update(stream_path(dev, card, dfma_peak))
        torch.cuda.empty_cache()
    if "path18" in phases:
        rows.update(grid_path(dev, card))
        torch.cuda.empty_cache()
    if "gui" in phases:
        gui_phase(dev, card)
    if "path19" in phases:
        rows.update(cli_path(dev, card))
        torch.cuda.empty_cache()
    if "path20" in phases:
        rows.update(ext_modes_path(dev, card))
        torch.cuda.empty_cache()
    if "grad" in phases:
        grad_kernel_cases(dev)
        large_grad_refusal(dev)
    if "path21" in phases:
        rows.update(grad_path(dev, card))
        torch.cuda.empty_cache()
    if "path22" in phases:
        rows.update(large_path(dev, card))
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
          f"{rows['hmm_viterbi']['launches']}; path 15 chunked EM loop "
          f"{rows['hmm_fit_chunked']['launches']}, chunked Viterbi "
          f"{rows['hmm_viterbi_chunked']['launches']}; path 16 (the session) "
          f"{rows['session_launches']}; the FFT kernel streamed: path 17 "
          f"{rows['stft_stream']['launches']}; the radix-2 kernel at nfft "
          f"{CLI_NFFT} over nperseg 1024: path 19 "
          f"{rows['stft_nfft']['launches']} (the GEMM kernel forced "
          f"{rows['stft_gemm_nfft']['launches']}); the magnitude and complex "
          f"epilogues: path 20 {rows['stft_magnitude']['launches']}, "
          f"{rows['stft_complex']['launches']}; the backward kernels' on "
          f"path 21: stft_fft_backward "
          f"{rows['stft_fft_backward']['launches']}, stft_mixed_backward "
          f"{rows['stft_mixed_backward']['launches']}, stft_odd_backward "
          f"{rows['stft_odd_backward']['launches']}, "
          f"stft_bluestein_backward "
          f"{rows['stft_bluestein_backward']['launches']}, "
          f"stft_small_backward {rows['stft_small_backward']['launches']}, "
          f"stft_backward {rows['stft_backward']['launches']}, "
          f"overlap_add {rows['overlap_add']['launches']}, mel_backward "
          f"{rows['mel_backward']['launches']}, display_backward "
          f"{rows['display_backward']['launches']}; past 8192 on path 22: "
          + ", ".join(f"{k} {rows[f'stft_large_{k}']['launches']}"
                      for k, _ in LARGE_PATH)
          + f", the mel kernel's chunked form "
          f"{rows['mel_chunked']['launches']}"
          + "; the commands of path 19: "
          + "; ".join(f"{name} {flat}" for name, _, _, flat in
                      rows["cli_rows"]))
    src = "spectral_tpu_torch/ops/csrc/stft_psd.cu"
    tail_src = "spectral_tpu_torch/ops/csrc/display.cu"
    mel_src = "spectral_tpu_torch/ops/csrc/mel.cu"
    hmm_src = "spectral_tpu_torch/ops/csrc/hmm.cu"
    grad_src = "spectral_tpu_torch/ops/csrc/stft_grad.cu"
    grad_mixed_src = "spectral_tpu_torch/ops/csrc/stft_grad_mixed.cu"
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
        "stft_nfft": (
            f"stft_fft_psd<LOG2M 11, 16 values, EXT>, nperseg 1024 "
            f"zero-padded to nfft {CLI_NFFT} (path 19, render --nfft)",
            "cuda", src,
            "spectral_tpu/ops/stft_pallas.py:217"),
        "stft_gemm_nfft": (
            f"stft_psd GEMM, 128 x 64 tile forced, nperseg 1024 zero-padded "
            f"to nfft {CLI_NFFT} (path 19, render --nfft's config)", "cuda",
            src, "spectral_tpu/ops/stft_pallas.py:217"),
        "stft_magnitude": (
            "stft_fft_psd<LOG2M 9, 8 values, EXT>, the magnitude epilogue, "
            "scipy_default 1024 on the hour (path 20)", "cuda", src,
            "spectral_tpu/ops/stft_pallas.py:217"),
        "stft_complex": (
            "stft_fft_psd<LOG2M 9, 8 values, EXT>, the complex STFT "
            "epilogue, "
            "scipy_default 1024 on the hour (path 20)", "cuda", src,
            "spectral_tpu/ops/stft_pallas.py:217"),
        "stft_stream": ("stft_fft_psd<LOG2M 9, 8 values>, nperseg 1024, a "
                        "streamed block of the stereo hour, [carry | block] "
                        "(path 17)", "cuda", src,
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
        "hmm_viterbi": ("hmm_viterbi<KM 4, KC 4>, a block a sequence (the "
                        "chain on warp 0, the emissions beside it, the "
                        "backtrace on the block), "
                        f"{EEG_CLIPS} sweeps x 1071 frames (path 14); ms in "
                        f"runs of {RUN}", "cuda",
                        hmm_src, "spectral_tpu/models/hmm.py:104 (viterbi, "
                        "an XLA lax.scan; no TPU kernel)"),
        "hmm_fit_chunked": (
            f"hmm_fit_chunked<KM 4>, the chunked EM loop on the card "
            f"(transfers, scan, chunk pass, reduce + M-step an iteration), "
            f"{LONG_T} frames in chunks of 256 (path 15); ms and plain_ms "
            f"an iteration", "cuda", hmm_src,
            "spectral_tpu/models/hmm_pscan.py:289 (e_step, an XLA "
            "associative scan, under fit's while_loop, :359; no TPU "
            "kernel)"),
        "stft_fft_backward": (
            "stft_fft_backward_kernel<LOG2M 9, 8 values>, the STFT's adjoint "
            "on the radix-2 route (X recomputed in registers, a c2r "
            "transform), north_star 1024/256 on 1024 x 10 s (path 21)",
            "cuda", grad_src,
            "spectral_tpu/core/stft.py:769 (jax.grad of power_spectrogram, "
            "XLA's transposed DFT; no TPU kernel)"),
        "stft_mixed_backward": (
            "stft_mixed_fft_backward_kernel<RMAX 4>, the STFT's adjoint on "
            "the mixed route (X recomputed on the mixed-radix passes, the "
            "inverse by the passes in frequency), scipy_default 8160 on 256 "
            "x 60 s (path 21, path 4's config; its Rader plans on "
            "stft_odd_fft_backward_kernel<RADER 1, RMAX 1, PACKED>, "
            "counted here)", "cuda", grad_mixed_src,
            "spectral_tpu/core/stft.py:769 (jax.grad of power_spectrogram, "
            "XLA's transposed DFT; no TPU kernel)"),
        "stft_odd_backward": (
            "stft_odd_fft_backward_kernel<RADER 1, RMAX 4>, the STFT's "
            "adjoint on the odd route (two frames a transform where both "
            "guards allow, the Rader transform twice), scipy_default 8191 "
            "on 256 x 60 s (path 21, path 7's config)", "cuda",
            grad_mixed_src,
            "spectral_tpu/core/stft.py:769 (jax.grad of power_spectrogram, "
            "XLA's transposed DFT; no TPU kernel)"),
        "stft_bluestein_backward": (
            "stft_bluestein_fft_backward_kernel<RANKS 1, TWO 0>, the STFT's "
            "adjoint on the Bluestein route (X recomputed on the Bluestein "
            "transform, the inverse by the same transform), scipy_default "
            "8182 on 256 x 60 s (path 21, path 9's config; the cluster "
            "<RANKS 2> at 8185 counted here)", "cuda", grad_mixed_src,
            "spectral_tpu/core/stft.py:769 (jax.grad of power_spectrogram, "
            "XLA's transposed DFT; no TPU kernel)"),
        "stft_small_backward": (
            "stft_small_backward_kernel<NB 7> (B1-small), the STFT's adjoint "
            "on the GEMM route's small-K configs (X recomputed in registers "
            "by the small-K tile's chains, d = H A^T in the same launch): "
            "scipy_default 24 (path 21), timed at path 10's shapes (1024 x "
            "10 s)", "cuda", grad_src,
            "spectral_tpu/core/stft.py:769 (jax.grad of power_spectrogram, "
            "XLA's transposed DFT; no TPU kernel)"),
        "stft_backward": (
            "stft_backward_kernel (B1), the STFT's adjoint (float64 tile) "
            "after the route's complex epilogue's recompute of X: "
            "scipy_default 24 two-sided (the GEMM route past the small-K "
            "configs) and nfft 8200 over 24 (the Bluestein kernel's X) "
            "(path 21), timed forced at path 10's shapes (1024 x 10 s)",
            "cuda", grad_src,
            "spectral_tpu/core/stft.py:769 (jax.grad of power_spectrogram, "
            "XLA's transposed DFT; no TPU kernel)"),
        "overlap_add": (
            "overlap_add_kernel, the framing's adjoint, 1024 x 622 frames "
            "of 1024 (path 21)", "cuda", grad_src,
            "spectral_tpu/core/stft.py:86 (jax.grad of frame_signal; no TPU "
            "kernel)"),
        "mel_backward": (
            "mel_backward_kernel<CC 2>, tiles of 32 rows, a lane a row, "
            "the outputs to the bulk copy engine, 128 mels over 513 bins "
            "(path 21)", "cuda",
            mel_src, "spectral_tpu/parallel/sharding.py:99 (jax.grad of the "
            "mel einsum; no TPU kernel)"),
        "display_backward": (
            "display_grad<LOG> (after display_grad_prep), the image's "
            "adjoint, RGBA path's image (path 21)", "cuda", tail_src,
            "spectral_tpu/core/scale.py:80 (jax.grad of normalize; no TPU "
            "kernel)"),
        **{f"stft_large_{k}": (large_kernel_name(k), "cuda", src,
                                LARGE_REPLACES) for k, _ in LARGE_PATH},
        "mel_chunked": (
            "mel_chunked_kernel, the mel projection's chunked form (tiles "
            "of 32 PSD rows, the bins in chunks of 128), 128 mels over "
            "8,193 bins (path 22, scipy_default 16384)", "cuda", mel_src,
            "spectral_tpu/parallel/sharding.py:99 (an XLA einsum; no TPU "
            "kernel)"),
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
            "bound_by": r["bound"][1], "library_ms": r.get("library_ms"),
            **r.get("extra", {})})
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
