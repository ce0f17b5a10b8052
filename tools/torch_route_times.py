"""Time the PyTorch port's STFT kernel at the display spine's batch, for one
checkout of the port.

    python3 tools/torch_route_times.py [--root DIR] [--route ROUTE]
                                       [--nperseg N ...] [--detrend D]
                                       [--paths [P ...]] [--sweep S]
                                       [--rader S] [--small]
                                       [--frames-alone] [--library]
                                       [--plain] [--ulp]
                                       [--pipelines [P ...]] [--dc]
                                       [--split] [--ptxas [SOURCE ...]]

Imports ``spectral_tpu_torch`` from DIR (default: the checkout holding this
script), builds its STFT kernel from DIR's sources, and times
``stft_psd(x, fs, cfg, with_stats=True)`` on 1024 clips of 10 s at 16 kHz
for scipy_default 1024, north_star 1024/256 and scipy_default 992 (the
mixed-radix route), or scipy_default at each ``--nperseg`` given, under
each config's own detrend or ``--detrend``, with CUDA events, median of 5
after a warm-up. ``--paths`` times instead the STFT/PSD configs of
``chip_smoke.py``'s paths 1-11 at their batches (1024 clips of 10 s at
north_star 1024/256, the export's config too; 256 clips of 60 s at
scipy_default 8192, 8160, 8032, 8160 under linear detrend, 8191, 8185
and 8182; 1024 clips of 10 s at scipy_default 24), or those of the paths
numbered after it (path 11: scipy_default 8186 on 256 clips of 60 s);
``--sweep S`` every S-th nperseg from 32 to 8192 that the odd route takes
and every S-th the Bluestein route takes, at scipy_default; ``--rader S``
every S-th of the mixed route's 405 Rader plans (even nperseg whose half
is a prime past 255; 1 for all); ``--small`` nperseg 2-31, the GEMM
route's small-K tile. ``--nperseg``, ``--paths``, ``--sweep``, ``--rader``
and ``--small`` add up. ``--route`` (gemm,
fft, mixed, odd or bluestein) forces that kernel through ``stft_psd``'s
module-private ``_route`` on the configs that allow it and skips the
others; ``--route mixed`` also takes the
power-of-two configs, whose plan is all radix-2 stages, and reports the
largest difference from the radix-2 kernel's PSD relative to its max.
``--frames-alone`` launches the odd kernel with every frame transformed
alone (its packing off). ``--library`` also times each config's library
yardstick, ``chip_smoke.py::library_psd`` (cuFFT's float64 transform of
the same frames), which the port never calls; ``--plain`` the plain
version, ``stft_psd_reference`` (its float64 DFT matrices built first). ``--ulp`` also reports the
largest distance in float32 ulps of the first 64 clips' PSD from the
plain version, ``stft_psd_reference``, on the same clips. Pointed at an older checkout it times that
checkout's kernels, so one call on one card compares two versions: run it
for the older, this, this and the older again.

``--pipelines`` times instead (or as well) the whole pipeline,
``batched_spectrogram_fn`` as ``chip_smoke.py`` drives it, on the batches
of paths 1-11 (path 3: one export batch, 64 clips of 10 s, palette words
and no image, as ``export_spectrograms`` calls it), or of the paths
numbered: a single call between two events and a run of RUN calls over
the count, median of 5, with digests of the first clips' PSD, words and
flags; path 12's (path 1's batch, 128 log mels) and path 13's (256
sweeps of 16 min at 1 kHz, the 0-30 Hz band) the same way; detection on
paths 14 and 15 (``chip_smoke.py``'s seeded batches with planted bursts:
fleet detection, ``batch_unsupervised_detect`` on 256 sweeps of 16 min;
an hour at 48 kHz through ``BurstDetector(engine='auto')``, 524,288
frames): the stages' host times, H1's ms and ns a step, H3's ms an
iteration and its split over transfers, scan, chunk pass and reduce
(``torch.profiler``'s kernel times), the EM loop's host ms, its
device-to-host reads and the device's idle share over it, and digests
of the fitted model, ll, it, the states and the event lists; and path
21's training steps (with no path named, or 21 named):
the waveform of path 1's batch requiring grad, ``batched_spectrogram_fn``
at north_star 1024/256 log, and of path 4's batch (256 clips of 60 s) at
scipy_default 8160 log (the mixed route's backward), 8182 log and 8185
log (the Bluestein route's, on one block and on a cluster), the loss on
the
image and the PSD as ``chip_smoke.py`` takes it, ``backward()`` and a
synchronise, its wall ms on the host clock (median of 5 after a
warm-up), the launches of a step, and a digest, the norm and the largest
|entry| of the gradient of the first 8 clips (two checkouts whose
backward sums in another order give other digests and norms equal to
about 1e-7); path 12's also digest the partials of its first 8 clips'
mel rows, and every pipeline the image of its first 8 clips.
``--split`` times the display backward (B4) at path 1's shapes in log
and linear mode with each of its kernels' device ms (torch.profiler),
and the mel kernel at path 12's with and without its sums (spans of
length 0), so a parent's split needs no edit of its source. ``--dc``
reports the flags and PSD maxima of pure-DC clips (1e-4, 3e-3, 0.1; 10 s) through
the checkout's ``batched_spectrogram_fn`` at scipy_default 1024 and 8160
(constant detrend).

``--ptxas`` builds the checkout's CUDA sources (``ops/csrc/<SOURCE>.cu``;
every one when none is named) into a temporary directory and reports each
kernel entry's registers and spilled bytes from nvcc's ``-Xptxas -v``
log, by its mangled name less the anonymous namespace's source hash, so
two checkouts' entries compare one to one.

A launch that fails is reported as such for its config, and the others
run on. Needs one CUDA card. Prints one JSON line: the root, the card's name and
power limit, and per config the median, every repeat, the launch counts
the calls added and a SHA-256 of the first 64 clips' PSD bytes (equal
digests in two checkouts: bitwise-equal PSDs).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

CLIPS = 1024
SECONDS = 10.0
FS = 16000.0
REPS = 5
RUN = 10


def path_configs(SpecConfig):
    """(path number, label, config, (clips, seconds)) of chip_smoke.py's
    paths; path 3 is one batch of its export."""
    s8160 = SpecConfig.scipy_default(8160, log_scale=True)
    north = SpecConfig.north_star(1024, 256, log_scale=True)
    long_ = (256, 60.0)
    return [
        (1, "path 1 north_star 1024/256", north, (CLIPS, SECONDS)),
        (2, "path 2 scipy_default 8192",
         SpecConfig.scipy_default(8192, log_scale=True), long_),
        (3, "path 3 export batch north_star 1024/256", north, (64, SECONDS)),
        (4, "path 4 scipy_default 8160", s8160, long_),
        (5, "path 5 scipy_default 8032",
         SpecConfig.scipy_default(8032, log_scale=True), long_),
        (6, "path 6 scipy_default 8160 linear",
         dataclasses.replace(s8160, detrend="linear"), long_),
        (7, "path 7 scipy_default 8191",
         SpecConfig.scipy_default(8191, log_scale=True), long_),
        (8, "path 8 scipy_default 8185",
         SpecConfig.scipy_default(8185, log_scale=True), long_),
        (9, "path 9 scipy_default 8182",
         SpecConfig.scipy_default(8182, log_scale=True), long_),
        (10, "path 10 scipy_default 24",
         SpecConfig.scipy_default(24, log_scale=True), (CLIPS, SECONDS)),
        (11, "path 11 scipy_default 8186",
         SpecConfig.scipy_default(8186, log_scale=True), long_)]


def _digest(t) -> str:
    import torch
    if t.dtype in (torch.uint32, torch.bool):
        t = t.view(torch.uint8) if t.dtype == torch.bool else t.view(
            torch.int32)
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def time_pipelines(paths, report, SpecConfig, batch, dev):
    """batched_spectrogram_fn on each path's batch, as chip_smoke.py
    drives it: flip_image, RGBA words and the image; path 3 palette words
    and no image, as the export calls it; then the detection paths and
    path 21's training steps."""
    import torch
    from spectral_tpu_torch.parallel.sharding import batched_spectrogram_fn
    configs = [(num, name, cfg, FS, shape)
               for num, name, cfg, shape in path_configs(SpecConfig)]
    for num, name, cfg, fs, shape in (configs
                                      + extra_pipeline_configs(SpecConfig)):
        if paths and num not in paths:
            continue
        x = batch(*shape)
        kw = (dict(palette=True, with_image=False, colormap=None)
              if num == 3 else {})
        fn = batched_spectrogram_fn(fs, cfg, flip_image=True, **kw)
        print(f"pipeline {name}", file=sys.stderr, flush=True)
        out = fn(x)
        words = out["index_packed" if num == 3 else "rgb_packed"]
        entry = {"batch": list(shape), "fs": fs,
                 "psd_sha256": _digest(out["psd"][:8]),
                 "words_sha256": _digest(words[:8]),
                 "finite_sha256": _digest(out["finite"])}
        if "mel" in out:
            entry["mel_sha256"] = _digest(out["mel"][:8])
            from spectral_tpu_torch.core.mel import mel_filterbank
            from spectral_tpu_torch.ops import mel_cuda
            spans = mel_cuda.mel_spans(mel_filterbank(
                cfg.n_mels, out["psd"].shape[2], fs), dev)
            entry["mel_parts_sha256"] = _digest(mel_cuda.mel_project(
                out["psd"][:8].contiguous(), spans)[1])
        if out.get("image") is not None:
            entry["image_sha256"] = _digest(out["image"][:8])
        del out, words
        torch.cuda.synchronize()
        for key, run in (("ms", 1), ("run_ms", RUN)):
            reps = []
            for _ in range(REPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(run):
                    fn(x)
                end.record()
                torch.cuda.synchronize()
                reps.append(start.elapsed_time(end) / run)
            entry[key] = sorted(reps)[REPS // 2]
            entry[key.replace("ms", "reps_ms")] = reps
        report[f"pipeline {name}"] = entry
        torch.cuda.empty_cache()
    if not paths or 14 in paths:
        time_fleet_detection(report, dev)
    if not paths or 15 in paths:
        time_long_detection(report, dev)
    if not paths or 21 in paths:
        time_grad_step(report, SpecConfig, batch)
        for k in (8160, 8182, 8185):
            time_grad_step(report, SpecConfig, batch, k)


def extra_pipeline_configs(SpecConfig):
    """(path number, label, config, fs, (clips, seconds at FS)) of
    chip_smoke.py's paths 12 and 13: path 1's batch with 128 log mels; 256
    sweeps of 16 min at 1 kHz (960,000 samples, the batch of 256 x 60 s
    at FS) on the 0-30 Hz band, log."""
    return [
        (12, "path 12 north_star 1024/256 128 log mels",
         SpecConfig.north_star(1024, 256, n_mels=128, log_scale=True),
         FS, (CLIPS, SECONDS)),
        (13, "path 13 scipy_default 1024 0-30 Hz at 1 kHz",
         SpecConfig.scipy_default(1024, fmin=0.0, fmax=30.0,
                                  log_scale=True), 1000.0, (256, 60.0))]


def _smoke():
    """This checkout's chip_smoke.py (its seeded inputs, the same data
    whichever checkout is timed)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


def _digest_obj(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


def _params_digests(params, ll, it) -> dict:
    out = {name: _digest(p) for name, p in zip(
        ("startprob", "transmat", "means", "covars"), params)}
    out.update(ll=_digest(ll), it=_digest(it))
    return out


def time_fleet_detection(report, dev):
    """Path 14: chip_smoke.py's EEG batch with planted bursts (256 sweeps
    of 16 min at 1 kHz, seed 14), scipy_default 1024 on the 0-30 Hz band,
    features_from_psd, batch_unsupervised_detect (host k-means, H1, the
    patch, H2, host scans), 4 states, n_iter 100: the stages' times, H1's
    ms and ns a step, H2's ms, and digests of the fitted model, ll, it,
    the states and the event lists."""
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core import events as ev
    from spectral_tpu_torch.core.stft import (band_row_slice, freq_axis,
                                              power_spectrogram, time_axis)
    from spectral_tpu_torch.models import batch as mbatch, hmm
    from spectral_tpu_torch.ops import hmm_cuda
    smoke = _smoke()
    fs, n = smoke.EEG_FS, int(smoke.EEG_FS * smoke.EEG_SECONDS)
    cfg = SpecConfig.scipy_default(1024)
    f, t = freq_axis(cfg, fs), time_axis(cfg, fs, n)
    band = band_row_slice(f, 0.0, 30.0)
    fb = f[band[0]:band[1]]
    print("detection path 14", file=sys.stderr, flush=True)
    x, _ = smoke.bursty_batch(dev, smoke.EEG_CLIPS, n, fs, 30.0, 3.0, 25.0,
                              14)
    psd = power_spectrogram(x, fs, cfg, band=band)
    feats = ev.features_from_psd(fb, psd, 0.0, 30.0)
    hmm_cuda._library()                  # built before the stages' clocks
    timings = {}
    events = mbatch.batch_unsupervised_detect(t, feats, device=dev,
                                              timings=timings)
    feats_np = feats.cpu().numpy()
    p0 = hmm.HMMParams(*(torch.stack(a).to(dev) for a in zip(*[
        hmm.init_params(feats_np[b], 4, device="cpu")
        for b in range(len(feats_np))])))
    X = feats.to(torch.float64).contiguous()
    params, states, _, ll, it = hmm.unsupervised_fit_decode(p0, X)
    T = X.shape[1]
    fit_ms, fit_reps = smoke.time_ms(lambda: hmm_cuda.fit_seq(
        X, p0, 100, hmm.DEFAULT_TOL), reps=3)
    steps = int(it.max()) * (T - 1)
    entry = {
        "frames": T, "host_s": timings,
        "features_ms": smoke.time_ms(lambda: ev.features_from_psd(
            fb, psd, 0.0, 30.0))[0],
        "fit_kernel_ms": fit_ms, "fit_kernel_reps_ms": fit_reps,
        "fit_ns_a_step": 1e6 * fit_ms / steps,
        "viterbi_kernel_ms": smoke.time_ms(lambda: hmm_cuda.viterbi_seq(
            X, hmm.HMMParams(*(p.contiguous() for p in params))))[0],
        "iterations": [int(it.min()), int(it.cpu().median()), int(it.max())],
        "digests": {**_params_digests(params, ll, it),
                    "states": _digest(states), "events": _digest_obj(events)}}
    report["detection path 14"] = entry
    del x, psd
    torch.cuda.empty_cache()


def time_long_detection(report, dev):
    """Path 15: chip_smoke.py's hour at 48 kHz with planted bursts (seed
    15), north_star 1024/256 on the 0-4000 Hz band (524,288 frames),
    BurstDetector(engine='auto'): the stages' times; the EM loop
    (hmm_pscan.fit) on the host clock, its device idle share and its
    device-to-host reads (torch.profiler); H3's ms an iteration (one
    E-step, CUDA events) and its split over transfers, scan, chunk pass
    and reduce (the profiler's kernel times); H2 chunked's ms; digests of
    the fitted model, ll, it, the states and the event list."""
    import time
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core import events as ev
    from spectral_tpu_torch.core.stft import (band_row_slice, freq_axis,
                                              power_spectrogram, time_axis)
    from spectral_tpu_torch.models import hmm, hmm_pscan
    from spectral_tpu_torch.models.detector import BurstDetector
    from spectral_tpu_torch.ops import hmm_cuda
    smoke = _smoke()
    cfg = SpecConfig.north_star(1024, 256)
    fs = smoke.LONG_FS
    n = cfg.hop_ * (smoke.LONG_T - 1) + cfg.nperseg
    f, t = freq_axis(cfg, fs), time_axis(cfg, fs, n)
    band = band_row_slice(f, 0.0, 4000.0)
    fb = f[band[0]:band[1]]
    print("detection path 15", file=sys.stderr, flush=True)
    x, _ = smoke.bursty_batch(dev, 1, n, fs, 4000.0, 200.0, 3000.0, 15)
    feats = ev.features_from_psd(fb, power_spectrogram(
        x, fs, cfg, band=band), 0.0, 4000.0)[0]
    del x
    det = BurstDetector(engine="auto", device=dev)
    events = det.unsupervised_detect(t, feats)
    feats_np = feats.cpu().numpy()
    p0 = hmm.init_params(feats_np, 4, device=dev)
    X = feats.to(torch.float64)
    params, states, _, ll, it = hmm_pscan.unsupervised_fit_decode(p0, X)
    iters = int(it)

    def em():
        return hmm_pscan.fit(p0, X, n_iter=100)

    em()
    torch.cuda.synchronize()
    loop = []
    for _ in range(3):
        t0 = time.perf_counter()
        em()
        torch.cuda.synchronize()
        loop.append(1e3 * (time.perf_counter() - t0))
    trace = smoke.kernel_split(em, smoke.HMM_STAGES)
    Xb = X[None].contiguous()
    pb = tuple(p[None].contiguous() for p in params)
    L = hmm_cuda.chunk_len(4)
    est_ms, est_reps = smoke.time_ms(lambda: hmm_cuda.estep_chunked(Xb, pb,
                                                                    L))
    split = smoke.kernel_split(lambda: [hmm_cuda.estep_chunked(Xb, pb, L)
                                        for _ in range(REPS)],
                               smoke.HMM_STAGES)
    entry = {
        "frames": int(X.shape[0]), "host_s": det.timings,
        "iterations": iters,
        "em_loop_ms": sorted(loop)[1], "em_loop_reps_ms": loop,
        "em_loop_ms_an_iteration": sorted(loop)[1] / iters,
        "estep_ms": est_ms, "estep_reps_ms": est_reps,
        "viterbi_chunked_ms": smoke.time_ms(lambda: hmm_cuda.viterbi_chunked(
            Xb, pb, L))[0],
        "digests": {**_params_digests(params, ll, it),
                    "states": _digest(states), "events": _digest_obj(events)}}
    if trace is None:
        entry["em_loop_trace"] = "not measured: no device time in the trace"
    else:
        entry["em_loop_trace"] = dict(
            trace, stage_ms_an_iteration={
                k: v / iters for k, v in trace["stage_ms"].items()})
        entry["flag_reads"] = trace["d2h_copies"]
    if split is not None:
        entry["estep_split_ms"] = {k: v / REPS
                                   for k, v in split["stage_ms"].items()}
    report["detection path 15"] = entry
    torch.cuda.empty_cache()


def time_grad_step(report, SpecConfig, batch, nperseg=None):
    """Path 21's training step: on path 1's batch at north_star 1024/256
    log, or with ``nperseg`` on path 4's batch (256 clips of 60 s) at
    scipy_default ``nperseg`` log; the forward and the backward through
    batched_spectrogram_fn, synchronised."""
    import time
    import torch
    from spectral_tpu_torch.ops import stft_cuda
    from spectral_tpu_torch.parallel.sharding import batched_spectrogram_fn
    if nperseg is None:
        cfg = SpecConfig.north_star(1024, 256, log_scale=True)
        shape, name = (CLIPS, SECONDS), "pipeline path 21 training step"
    else:
        cfg = SpecConfig.scipy_default(nperseg, log_scale=True)
        shape = (256, 60.0)
        name = f"pipeline path 21 training step {nperseg}"
    x0 = batch(*shape)
    fn = batched_spectrogram_fn(FS, cfg, flip_image=True)
    with torch.no_grad():
        scale = float(fn(x0)["psd"].mean())

    def step():
        x = x0.clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(x)
        (out["image"].mean() + out["psd"].mean() / scale).backward()
        torch.cuda.synchronize()
        return x.grad, 1e3 * (time.perf_counter() - t0)

    print(name, file=sys.stderr, flush=True)
    counts = (stft_cuda.launches, stft_cuda.grad_launches)
    before = [dict(c) for c in counts]
    grad = step()[0][:8]                         # build, warm up
    launches = {k: c[k] - b.get(k, 0) for c, b in zip(counts, before)
                for k in c if c[k] != b.get(k, 0)}
    entry = {"batch": list(shape), "grad_sha256": _digest(grad),
             "grad_norm": float(grad.double().norm()),
             "grad_absmax": float(grad.abs().amax()), "launches": launches}
    del grad
    reps = [step()[1] for _ in range(REPS)]
    entry["ms"] = sorted(reps)[REPS // 2]
    entry["reps_ms"] = reps
    report[name] = entry
    del x0
    torch.cuda.empty_cache()


SPLIT_STAGES = (("pixel_pass", "display_grad_pixel"),
                ("extrema_pass", "display_grad_extrema"),
                ("prep", "display_grad_prep"), ("pass", "display_grad_kernel"))


def time_split(report, SpecConfig, batch, dev):
    """The display backward (B4) and the mel kernel of the checkout, with
    the parts a split can be read from without editing its source: B4 at
    path 1's shapes (1024 clips x 10 s, north_star 1024/256, the PSD's
    clip_stats operands, a seeded g, flipped as path 21 calls it) in log
    and in linear mode (no log10 and fewer divisions a pixel, the same
    bytes), a call's ms (CUDA events, median of REPS) and each of its
    kernels' device ms (torch.profiler over REPS calls); the mel kernel at
    path 12's shapes (128 mels) with the filterbank's spans and with spans
    of length 0 (no sums: the copies, stores and partials alone)."""
    import torch
    from spectral_tpu_torch.core.mel import mel_filterbank
    from spectral_tpu_torch.ops import display_cuda as disp
    from spectral_tpu_torch.ops import mel_cuda, stft_cuda
    smoke = _smoke()
    print("split B4 and the mel kernel", file=sys.stderr, flush=True)
    x = batch(CLIPS, SECONDS)
    cfg = SpecConfig.north_star(1024, 256)
    psd, parts = stft_cuda.stft_psd_partials(x, FS, cfg)
    params = disp.clip_stats(x, parts).params
    B, T, F = psd.shape
    gen = torch.Generator(device=dev).manual_seed(4)
    g = torch.rand((B, F, T), generator=gen, device=dev)
    entry = {}
    for log in (True, False):
        def call(log=log):
            return disp.display_backward(g, psd, params, log_scale=log,
                                         flip_image=True)
        out = call()
        split = smoke.kernel_split(lambda: [call() for _ in range(REPS)],
                                   SPLIT_STAGES)
        ms, reps = smoke.time_ms(call)
        entry["log" if log else "linear"] = {
            "ms": ms, "reps_ms": reps, "sha256": _digest(out[:8]),
            "kernels_ms": None if split is None else
            {k: v / REPS for k, v in split["stage_ms"].items()}}
        del out
    report["split display_backward path 1"] = entry
    del g
    spans = mel_cuda.mel_spans(mel_filterbank(128, F, FS), dev)
    zero = torch.zeros_like(spans.start)
    none = spans._replace(start=zero, length=zero, offset=zero)
    report["split mel path 12"] = {
        "ms": smoke.time_ms(lambda: mel_cuda.mel_project(psd, spans))[0],
        "no_sums_ms": smoke.time_ms(
            lambda: mel_cuda.mel_project(psd, none))[0]}
    torch.cuda.empty_cache()


def ptxas_report(names):
    """{source: {mangled entry: [registers, spill store bytes, spill load
    bytes]}} of the imported checkout's sources, each built anew into a
    temporary directory."""
    import re
    import tempfile
    from pathlib import Path
    from spectral_tpu_torch.ops import build
    names = names or sorted(p.stem for p in build.CSRC.glob("*.cu"))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        build.BUILD_DIR = Path(tmp)
        for name in names:
            entries, entry, spill = {}, None, (0, 0)
            for line in build.build_library(name)["log"].splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    # the anonymous namespace's name hashes the source:
                    # drop it, so that two checkouts' entries match
                    entry = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}",
                                   "anon", m.group(1))
                    spill = (0, 0)
                elif entry and "spill stores" in line:
                    spill = tuple(int(v) for v in re.findall(
                        r"(\d+) bytes spill", line))
                elif entry and "Used" in line and "registers" in line:
                    regs = int(re.search(r"Used (\d+) registers",
                                         line).group(1))
                    entries[entry] = [regs, *spill]
                    entry = None
            out[name] = entries
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the checkout to time")
    ap.add_argument("--route",
                    choices=("gemm", "fft", "mixed", "odd", "bluestein"),
                    help="force this kernel where the config allows it")
    ap.add_argument("--paths", type=int, nargs="*",
                    help="time chip_smoke.py's paths 1-11 configs and "
                         "batches, or the paths numbered")
    ap.add_argument("--sweep", type=int,
                    help="every S-th nperseg of the odd and Bluestein "
                         "routes")
    ap.add_argument("--rader", type=int,
                    help="every S-th of the mixed route's Rader plans")
    ap.add_argument("--small", action="store_true",
                    help="nperseg 2-31, the GEMM route's small-K tile")
    ap.add_argument("--frames-alone", action="store_true",
                    help="the odd kernel without its packing")
    ap.add_argument("--library", action="store_true",
                    help="time chip_smoke.py's cuFFT yardstick too")
    ap.add_argument("--plain", action="store_true",
                    help="time the plain version too")
    ap.add_argument("--ulp", action="store_true",
                    help="the PSD's float32 ulp distance from the plain "
                         "version")
    ap.add_argument("--nperseg", type=int, nargs="*",
                    help="time scipy_default at these nperseg instead")
    ap.add_argument("--detrend", choices=("none", "constant", "linear"),
                    help="replace each config's detrend")
    ap.add_argument("--pipelines", type=int, nargs="*",
                    help="time batched_spectrogram_fn on paths 1-11's "
                         "batches and path 21's training step, or the "
                         "paths numbered")
    ap.add_argument("--ptxas", nargs="*",
                    help="each kernel's registers and spills, building "
                         "these sources (all when none is named)")
    ap.add_argument("--split", action="store_true",
                    help="the display backward's and the mel kernel's "
                         "times and parts at paths 1 and 12's shapes")
    ap.add_argument("--dc", action="store_true",
                    help="the flags of pure-DC clips at scipy_default 1024 "
                         "and 8160")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_route_times: this needs a CUDA card")
    import spectral_tpu_torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.ops import stft_cuda
    pkg = os.path.dirname(os.path.abspath(spectral_tpu_torch.__file__))
    if pkg != os.path.join(root, "spectral_tpu_torch"):
        raise SystemExit(f"spectral_tpu_torch came from {pkg}, not {root}")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    batches = {}

    if args.library or args.ulp:
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        from chip_smoke import library_psd, ulp_distance

    def batch(clips, seconds):
        """Seeded noise, the same in every checkout and call."""
        if (clips, seconds) not in batches:
            gen = torch.Generator(device=dev).manual_seed(3)
            batches.clear()
            batches[clips, seconds] = torch.randn(
                (clips, int(FS * seconds)), generator=gen, device=dev)
        return batches[clips, seconds]

    report = {"root": root, "card": card, "clips": CLIPS,
              "seconds": SECONDS, "route": args.route,
              "detrend": args.detrend, "frames_alone": args.frames_alone}
    if args.dc:
        from spectral_tpu_torch.parallel.sharding import (
            batched_spectrogram_fn)
        x = torch.stack([torch.full((int(FS * SECONDS),), v, device=dev)
                         for v in (1e-4, 3e-3, 0.1)])
        for k in (1024, 8160):
            out = batched_spectrogram_fn(FS, SpecConfig.scipy_default(
                k, log_scale=True))(x)
            report[f"dc scipy_default {k}"] = {
                "finite": out["finite"].tolist(),
                "psd_max": out["psd"].amax(dim=(1, 2)).tolist()}
    if args.ptxas is not None:
        report["ptxas"] = ptxas_report(args.ptxas)
    if args.split:
        time_split(report, SpecConfig, batch, dev)
    if args.pipelines is not None:
        time_pipelines(args.pipelines, report, SpecConfig, batch, dev)
    nperseg = list(args.nperseg or [])
    if args.sweep:
        for route in ("odd", "bluestein"):
            ks = [k for k in range(32, 8193)
                  if stft_cuda.route(SpecConfig.scipy_default(k)) == route]
            nperseg += ks[::args.sweep]
    if args.rader:
        from spectral_tpu_torch.core.stft import rader_prime
        ks = [k for k in range(32, 8193, 2)
              if stft_cuda.route(SpecConfig.scipy_default(k)) == "mixed"
              and rader_prime(k // 2)]
        nperseg += ks[::args.rader]
    if args.small:
        nperseg += list(range(2, 32))
    configs = [(f"scipy_default {k}", SpecConfig.scipy_default(k))
               for k in nperseg]
    if not configs and args.paths is None and (args.pipelines is not None
                                               or args.dc or args.split
                                               or args.ptxas is not None):
        print(json.dumps(report))
        return
    if not configs and args.paths is None:
        configs = [("scipy_default 1024", SpecConfig.scipy_default(1024)),
                   ("north_star 1024/256", SpecConfig.north_star(1024, 256)),
                   ("scipy_default 992", SpecConfig.scipy_default(992))]
    if args.detrend:
        configs = [(f"{name} {args.detrend}",
                    dataclasses.replace(cfg, detrend=args.detrend))
                   for name, cfg in configs]
    shape = {name: (CLIPS, SECONDS) for name, _ in configs}
    if args.paths is not None:
        paths = [(name, cfg, size) for num, name, cfg, size
                 in path_configs(SpecConfig)
                 if num != 3 and (not args.paths or num in args.paths)]
        shape.update({name: size for name, _, size in paths})
        configs = [(name, cfg) for name, cfg, _ in paths] + configs
    for name, cfg in configs:
        x = batch(*shape[name])

        def call(v, cfg=cfg, route=args.route):
            if args.frames_alone and stft_cuda.route(cfg) == "odd":
                return stft_cuda._stft_psd_cuda(v, FS, cfg, False, True,
                                                "odd", pack=False)
            return stft_cuda.stft_psd(v, FS, cfg, with_stats=True,
                                      _route=route)
        if args.route == "mixed" and stft_cuda.route(cfg) == "fft":
            # route() never gives the mixed kernel a power of two, where its
            # plan is all radix-2 stages: launch it through the wrapper's
            # internal entry, and hold it to the radix-2 kernel's PSD
            def call(v, cfg=cfg):
                return stft_cuda._stft_psd_cuda(v, FS, cfg, False, True,
                                                "mixed")
            want = stft_cuda.stft_psd(x[:64], FS, cfg)
            got = call(x[:64])[0]
            report[f"{name} mixed vs fft"] = float(
                (got - want).abs().amax() / want.abs().amax())
        elif args.route is not None:
            try:
                call(x[:1])
            except ValueError:
                report[name] = f"no {args.route} route"
                continue
        before = json.loads(json.dumps(stft_cuda.launches))
        print(name, file=sys.stderr, flush=True)
        try:
            psd = call(x)[0]                     # build, warm up
        except RuntimeError as err:              # a launch the kernel refused
            report[name] = f"launch failed: {err}"
            continue
        digest = hashlib.sha256(psd[:64].cpu().numpy().tobytes()).hexdigest()
        ulps = None
        if args.ulp:
            want = stft_cuda.stft_psd_reference(
                x[:64], stft_cuda.dft_constants(cfg, FS, dev), cfg)
            ulps = ulp_distance(psd[:64], want)
            del want
        del psd
        torch.cuda.synchronize()

        def timed(fn):
            reps = []
            for _ in range(REPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                reps.append(start.elapsed_time(end))
            return reps
        reps = timed(lambda: call(x))
        after = stft_cuda.launches
        added = ({k: after[k] - before.get(k, 0) for k in after}
                 if isinstance(after, dict) else after - before)
        report[name] = {"ms": sorted(reps)[REPS // 2], "reps_ms": reps,
                        "launches": added, "psd_sha256": digest[:16],
                        "batch": list(shape[name])}
        if ulps is not None:
            report[name]["ulp_from_plain"] = ulps
        if args.library:
            library_psd(x, cfg)                  # warm up
            lib = timed(lambda: library_psd(x, cfg))
            report[name]["library_ms"] = sorted(lib)[REPS // 2]
            torch.cuda.empty_cache()
        if args.plain:
            consts = stft_cuda.dft_constants(cfg, FS, dev)

            def plain(cfg=cfg, consts=consts):
                return stft_cuda.stft_psd_reference(x, consts, cfg,
                                                    with_stats=True)
            plain()                              # warm up
            report[name]["plain_ms"] = sorted(timed(plain))[REPS // 2]
            torch.cuda.empty_cache()
    print(json.dumps(report))


if __name__ == "__main__":
    main()
