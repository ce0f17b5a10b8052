"""End-to-end dataset export: decode -> card compute -> PNG encode.

Counterpart of ``spectral_tpu/parallel/pipeline.py`` (BASELINE.json config
5: "10k-clip dataset end-to-end (decode -> fused STFT -> colormap -> PNG)";
the reference's analog is a serial matplotlib loop, ExportManager.py:146).
The three stages overlap:

  stage 1 (producer thread): batch staging into pinned host buffers, the
                          upload on a copy stream, the batch pipeline's
                          kernels, and the readback into pinned buffers,
                          all enqueued without waiting, so the next batch
                          uploads while the current one computes;
  stage 2 (consumer):     wait for a batch's readback, unpack the packed
                          words, submit one PNG encode per clip;
  stage 3 (host workers): PNG encode (zlib releases the GIL in both the PIL
                          and the stdlib encoders).

Bounded queues and a fixed ring of pinned buffers keep memory flat.

Left out against the JAX package: ``use_pallas`` (the port has one route,
its kernels), ``mesh``/``batch_axis`` (ROADMAP [multi-device]) and the XLA
compile cache.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import logging
import os
import queue
import struct
import threading
import time
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spectral_tpu_torch.config import SpecConfig
from spectral_tpu_torch.core.stft import num_frames
from spectral_tpu_torch.io.registry import SweepRegistry
from spectral_tpu_torch.io.wav import read_wav, read_wav_int16
from spectral_tpu_torch.ops.colormap import unpack_indices, unpack_rgba
from spectral_tpu_torch.parallel.sharding import batched_spectrogram_fn
from spectral_tpu_torch.render.lut import get_lut
from spectral_tpu_torch.render.png import (clean_stale_tmp, encode_png,
                                           encode_png_palette)
from spectral_tpu_torch.utils.device import resolve_device

log = logging.getLogger("spectral_tpu_torch")


@dataclass
class PipelineStats:
    clips: int = 0
    batches: int = 0
    pngs_written: int = 0
    seconds_audio: float = 0.0
    failed: int = 0              # encode failures isolated by on_error="skip"
    nonfinite: int = 0           # clips whose spectrum was NaN/Inf (subset
    #                              of failed): overflowed f32 power or
    #                              non-finite samples — no PNG is written
    skipped: int = 0             # resume=True: outputs that already existed
    tmp_cleaned: int = 0         # stale .tmp.<dead-pid> residue swept at start
    # per-stage breakdown (seconds; encode_s is summed worker CPU-seconds,
    # the others are wall time on their stage's thread)
    stage_s: float = 0.0         # producer: staging + enqueued card work
    d2h_s: float = 0.0           # blocking wait for a batch's readback
    d2h_bytes: int = 0
    unpack_s: float = 0.0        # packed-word -> pixel-array host unpack
    encode_s: float = 0.0        # deflate + file write, summed over workers
    wall_s: float = 0.0

    def breakdown(self) -> dict:
        """Stage seconds + derived rates, for benchmark artifacts."""
        d = {"stage_producer_s": round(self.stage_s, 3),
             "d2h_s": round(self.d2h_s, 3),
             "d2h_mb": round(self.d2h_bytes / 2 ** 20, 1),
             "unpack_s": round(self.unpack_s, 3),
             "encode_cpu_s": round(self.encode_s, 3),
             "wall_s": round(self.wall_s, 3)}
        if self.d2h_s > 0:
            d["d2h_mb_per_s"] = round(self.d2h_bytes / 2 ** 20
                                      / self.d2h_s, 1)
        if self.pngs_written:
            d["encode_ms_per_png"] = round(
                self.encode_s * 1000 / self.pngs_written, 2)
        return d


def _batched(it: Iterator[Tuple[str, np.ndarray]], batch: int, n: int
             ) -> Iterator[Tuple[List[str], List[int], np.ndarray]]:
    """(names, real sample counts, (batch, n) array) per batch. Batches
    preserve int16 inputs (16-bit PCM staged raw: half the upload bytes;
    the card normalizes by 1/32768). A batch mixing dtypes falls back to
    float32; the last batch is zero-padded to full size."""
    names, bufs, secs = [], [], []

    def flush():
        dt = np.int16 if all(b.dtype == np.int16 for b in bufs) else np.float32
        pad = batch - len(bufs)
        out = bufs + [np.zeros(n, dt)] * pad

        def conv(b):
            # mixed batch -> float32: int16 clips are raw PCM and must be
            # normalized here, since the card's /32768 applies only when
            # the whole staged batch is int16
            if dt == np.float32 and b.dtype == np.int16:
                return b.astype(np.float32) / 32768.0
            return np.asarray(b, dt)

        return names, secs, np.stack([conv(b) for b in out])

    for name, x in it:
        x = np.asarray(x)
        if x.dtype != np.int16:
            x = np.asarray(x, np.float32)
        # real audio samples in this clip (zero-padding is not audio: the
        # throughput stats must not count it)
        secs.append(min(x.shape[0], n))
        if x.shape[0] < n:
            x = np.pad(x, (0, n - x.shape[0]))
        names.append(name)
        bufs.append(x[:n])
        if len(names) == batch:
            yield flush()
            names, bufs, secs = [], [], []
    if names:
        yield flush()


class _Slot:
    """Host buffers of one batch in flight: its staged input and its
    readback, pinned on a CUDA device, and the event that marks the
    readback done."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.done = torch.cuda.Event() if self.cuda else None
        self.bufs: dict = {}

    def buffer(self, name: str, shape, dtype: torch.dtype) -> torch.Tensor:
        buf = self.bufs.get(name)
        if buf is None or buf.shape != tuple(shape) or buf.dtype != dtype:
            buf = torch.empty(tuple(shape), dtype=dtype,
                              pin_memory=self.cuda)
            self.bufs[name] = buf
        return buf


def export_spectrograms(clips: Iterable[Tuple[str, np.ndarray]], fs: float,
                        cfg: SpecConfig, out_dir: str, *,
                        clip_samples: int, batch: int = 64,
                        colormap: str = "jet", compress_level: int = 3,
                        encode_workers: Optional[int] = None,
                        prefetch: int = 2,
                        pixel_format: str = "palette",
                        on_error: str = "raise",
                        encode_executor: str = "thread",
                        resume: bool = False,
                        durable: bool = False,
                        device="cuda") -> PipelineStats:
    """Stream (name, signal) pairs through the card's pipeline into PNGs.

    clip_samples fixes the batch shape (shorter clips are zero-padded,
    longer ones truncated). ``device`` is where the pipeline runs: the
    card by default; 'cpu' runs the kernels' plain versions.

    pixel_format: 'palette' (default) reads back one byte per pixel of
    colormap indices, packed four to a word by the display kernel, and
    writes indexed-color (PLTE) PNGs whose palette is the LUT; 'rgb' drops
    only the opaque alpha plane of the RGBA words; 'rgba' writes them all.

    on_error: 'raise' (default) fails the whole export on the first encode
    error or non-finite clip; 'skip' isolates per-clip failures (counted in
    stats.failed) so one bad output path or NaN clip cannot kill a
    10k-clip job. Pair with wav_clip_source(..., on_error='skip') to also
    skip undecodable source files.

    encode_workers: size of the encode pool; None uses one worker per host
    CPU. encode_executor: 'thread' (default; zlib releases the GIL) or
    'process' (sidesteps the GIL for the filter/pack Python overhead at
    the cost of pickling each image).

    resume=True skips clips whose '{name}.png' already exists in out_dir
    (stats.skipped) before they are staged or computed. Every PNG write is
    atomic, so after a killed process a file's presence proves it is
    complete; after a power loss that needs durable=True (fsync before the
    rename).

    Band, mel, magnitude and centered configs export as
    ``batched_spectrogram_fn`` computes them: the fmin/fmax band's rows,
    or the mel rows of the band on the mel-centre axis, one PNG row each;
    a centered config's frames span the padded clip, clip_samples + 2
    (nperseg // 2) samples (the JAX package's unpack width). A config the
    kernels cannot compute (nperseg > 32,768) raises NotImplementedError
    naming its ROADMAP label; an empty band raises ValueError.
    ``cfg.precision == 'fast'`` runs at the contract precision, as the JAX
    package's Pallas kernel does (ROADMAP [fast-tier]).

    The returned stats carry a per-stage breakdown
    (:meth:`PipelineStats.breakdown`)."""
    if pixel_format not in ("palette", "rgb", "rgba"):
        raise ValueError(f"unknown pixel_format: {pixel_format!r}")
    if on_error not in ("raise", "skip"):
        raise ValueError(f"unknown on_error: {on_error!r}")
    if encode_executor not in ("thread", "process"):
        raise ValueError(f"unknown encode_executor: {encode_executor!r}")
    if encode_workers is None:
        encode_workers = max(1, os.cpu_count() or 1)
    elif encode_workers < 1:
        raise ValueError(f"encode_workers must be >= 1: {encode_workers}")
    if prefetch < 0:
        raise ValueError("prefetch must be >= 0")
    palette_mode = pixel_format == "palette"
    palette_arr = get_lut(colormap) if palette_mode else None
    # center=True pads nperseg // 2 a side before framing
    # (core.stft.center_pad): the unpack width is the padded clip's frames
    n_pad = clip_samples + 2 * (cfg.nperseg // 2) if cfg.center \
        else clip_samples
    n_frames = num_frames(n_pad, cfg.nperseg, cfg.hop_)
    dev = resolve_device(device)
    # flip_image puts the PNG row order into the image itself; only the
    # packed words come back, so the float image is never written
    base = batched_spectrogram_fn(
        fs, cfg, flip_image=True, palette=palette_mode, with_image=False,
        device=dev, colormap=None if palette_mode else colormap)
    words_key = "index_packed" if palette_mode else "rgb_packed"

    os.makedirs(out_dir, exist_ok=True)
    t_start = time.time()
    stats = PipelineStats()
    # SIGKILL can leave one in-flight .tmp file per encode worker; sweep
    # residue from dead pids so resume/rerun directories stay clean
    stats.tmp_cleaned = clean_stale_tmp(out_dir)
    # one slot per queued batch, plus the one being produced and the one
    # being consumed; maxsize=0 would be an unbounded queue, so one slot is
    # the least for the handoff
    stage_q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    free_q: "queue.Queue" = queue.Queue()
    for _ in range(max(1, prefetch) + 2):
        free_q.put(_Slot(dev))
    upload = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    producer_error: list = []
    cancel = threading.Event()

    def _put(item) -> bool:
        """Bounded put that gives up once the consumer has cancelled: a
        plain blocking put would wedge this thread forever."""
        while not cancel.is_set():
            try:
                stage_q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _take_slot() -> Optional[_Slot]:
        while not cancel.is_set():
            try:
                return free_q.get(timeout=0.2)
            except queue.Empty:
                continue
        return None

    clip_it = iter(clips)
    if resume:
        def _resume_filter(it):
            for name, x in it:
                if os.path.exists(os.path.join(out_dir, f"{name}.png")):
                    stats.skipped += 1   # single-writer field (producer)
                    continue
                yield name, x
        clip_it = _resume_filter(clip_it)

    def produce(slot: _Slot, xb: np.ndarray) -> None:
        pcm = xb.dtype == np.int16
        host_x = slot.buffer("x", xb.shape,
                             torch.int16 if pcm else torch.float32)
        host_x.numpy()[...] = xb
        if upload is not None:
            with torch.cuda.stream(upload):
                xd = host_x.to(dev, non_blocking=True)
            compute = torch.cuda.current_stream(dev)
            compute.wait_stream(upload)
            xd.record_stream(compute)
        else:
            xd = host_x
        # raw 16-bit PCM: normalize on the card (read_wav's exact scaling)
        out = base(xd.to(torch.float32) * (1.0 / 32768.0) if pcm else xd)
        words = out[words_key].view(torch.int32)
        slot.buffer("words", words.shape, torch.int32).copy_(
            words, non_blocking=True)
        slot.buffer("finite", out["finite"].shape, torch.bool).copy_(
            out["finite"], non_blocking=True)
        if slot.done is not None:
            slot.done.record()

    def producer():
        try:
            for names, lens, xb in _batched(clip_it, batch, clip_samples):
                slot = _take_slot()
                if slot is None:
                    return
                t0 = time.time()
                with (torch.cuda.device(dev) if upload is not None
                      else contextlib.nullcontext()):
                    produce(slot, xb)
                stats.stage_s += time.time() - t0
                if not _put((names, lens, slot)):
                    return
        except BaseException as e:  # re-raised in the consumer
            producer_error.append(e)
        finally:
            _put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    if encode_executor == "process":
        # forkserver, not fork: this process is multi-threaded (the
        # producer and torch's own threads), and a child forked while
        # another thread holds a lock deadlocks
        import multiprocessing as _mp
        method = ("forkserver"
                  if "forkserver" in _mp.get_all_start_methods() else "spawn")
        pool = cf.ProcessPoolExecutor(max_workers=encode_workers,
                                      mp_context=_mp.get_context(method))
    else:
        pool = cf.ThreadPoolExecutor(max_workers=encode_workers)
    # encode backpressure: pending futures pin their batch's host pixels,
    # so without a bound a slow disk lets the card run ahead and memory
    # grows without limit
    max_pending = max(2 * batch, 4 * encode_workers)
    try:
        futures = []
        while True:
            item = stage_q.get()
            if item is None:
                break
            names, lens, slot = item
            t0 = time.time()
            if slot.done is not None:
                slot.done.synchronize()
            raw = slot.bufs["words"].numpy().view(np.uint32).copy()
            finite = slot.bufs["finite"].numpy().copy()
            free_q.put(slot)
            stats.d2h_s += time.time() - t0
            stats.d2h_bytes += raw.nbytes
            t0 = time.time()
            if palette_mode:
                host = unpack_indices(raw, n_frames)
            else:
                host = unpack_rgba(raw)
                if pixel_format == "rgb":
                    host = np.ascontiguousarray(host[..., :3])
            stats.unpack_s += time.time() - t0
            stats.batches += 1
            for i, name in enumerate(names):
                # per-clip health from the card (inf power overflow or NaN
                # samples): never write a garbage PNG that resume would
                # later trust as finished
                if not finite[i]:
                    if on_error == "raise":
                        raise ValueError(
                            f"clip {name!r}: spectrogram contains NaN/Inf "
                            "or totally underflowed float32 (non-finite "
                            "samples, or finite samples whose power "
                            "overflows/underflows float32 — rescale by a "
                            "power of two; the normalized image is "
                            "invariant)")
                    stats.nonfinite += 1
                    stats.failed += 1
                    stats.clips += 1
                    stats.seconds_audio += lens[i] / fs
                    continue
                path = os.path.join(out_dir, f"{name}.png")
                if palette_mode:
                    futures.append(pool.submit(_timed_encode_palette,
                                               host[i], palette_arr, path,
                                               compress_level, durable))
                else:
                    futures.append(pool.submit(_timed_encode, host[i], path,
                                               compress_level, durable))
                stats.clips += 1
                stats.seconds_audio += lens[i] / fs
            for f in list(futures):
                if f.done():
                    futures.remove(f)
                    _resolve(f, stats, on_error)
            while len(futures) > max_pending:   # blocking backpressure
                _resolve(futures.pop(0), stats, on_error)
        for f in futures:
            _resolve(f, stats, on_error)
    finally:
        # unblock the producer before waiting on anything: on a consumer
        # error it would otherwise sit in stage_q.put forever
        cancel.set()
        while True:
            try:
                stage_q.get_nowait()
            except queue.Empty:
                break
        pool.shutdown(wait=True)
        t.join(timeout=30.0)
    if producer_error:
        raise producer_error[0]
    stats.wall_s = time.time() - t_start
    _log_throughput(stats, stats.wall_s)
    return stats


def _log_throughput(stats: PipelineStats, elapsed: float) -> None:
    """Structured completion log in the benchmark's units (audio-h/min)."""
    if elapsed <= 0:
        return
    ahpm = (stats.seconds_audio / 3600.0) / (elapsed / 60.0)
    log.info("export_spectrograms: %d clips, %d PNGs, %d failed, %.1f s "
             "audio in %.1f s (%.2f audio-h/min)", stats.clips,
             stats.pngs_written, stats.failed, stats.seconds_audio, elapsed,
             ahpm)


def _timed_encode(arr, path, compress_level, fsync=False) -> float:
    """Module-level (process-pool picklable) timed RGB(A) encode; returns
    elapsed encode seconds."""
    t0 = time.time()
    encode_png(arr, path, compress_level, fsync=fsync)
    return time.time() - t0


def _timed_encode_palette(indices, palette, path, compress_level,
                          fsync=False) -> float:
    t0 = time.time()
    encode_png_palette(indices, palette, path, compress_level, fsync=fsync)
    return time.time() - t0


def _resolve(future, stats: PipelineStats, on_error: str) -> None:
    try:
        stats.encode_s += future.result()
        stats.pngs_written += 1
    except Exception:
        if on_error == "raise":
            raise
        stats.failed += 1


def wav_clip_source(paths: Sequence[str], on_error: str = "raise",
                    skip_existing_in: "str | None" = None
                    ) -> Iterator[Tuple[str, np.ndarray]]:
    """Decode WAV files into (stem, mono) pairs.

    Mono 16-bit PCM files are yielded as raw int16 (the pipeline stages
    them with half the upload bytes and normalizes on the card); everything
    else decodes to float32. on_error='skip' logs and skips undecodable
    files instead of killing the whole dataset export.

    skip_existing_in: a directory; files whose '{stem}.png' already exists
    there are skipped without decoding (the resume fast path — pair with
    export_spectrograms(resume=True), which re-checks at staging time)."""
    seen = set()
    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        if skip_existing_in is not None and os.path.exists(
                os.path.join(skip_existing_in, stem + ".png")):
            continue
        if stem in seen:
            # same stem in two directories -> same '{stem}.png': the later
            # clip overwrites the earlier one. Keep last-write-wins but say
            # so.
            log.warning("duplicate clip stem %r (from %s): its PNG "
                        "overwrites an earlier clip's output", stem, p)
        try:
            try:
                x, _fs = read_wav_int16(p)
                if x.ndim == 2:      # downmix needs float math
                    raise ValueError
            except (ValueError, struct.error):
                x, _fs = read_wav(p)
                if x.ndim == 2:
                    x = x.mean(axis=1)
        except (OSError, ValueError, struct.error) as e:
            if on_error == "raise":
                raise
            log.warning("skipping undecodable clip %s: %s", p, e)
            continue
        seen.add(stem)
        yield stem, x


def registry_first_fs(path: str) -> float:
    """Sampling rate of the first loadable sweep of `path` (any
    registry-supported format). The export pipeline is single-rate by
    design; this anchors the dataset's rate the way wav_info anchors it
    for WAV datasets."""
    r = SweepRegistry()
    names = r.load_file(path)
    if not names:
        raise ValueError(f"{path}: no loadable sweeps")
    _x, fs = r.get_signal(names[0], processed=True)
    return float(fs)


def registry_clip_source(paths: Sequence[str], fs: float,
                         on_error: str = "raise"
                         ) -> Iterator[Tuple[str, np.ndarray]]:
    """Decode ANY registry-supported recording (ABF / NIX-HDF5 / WAV /
    NPZ) into per-sweep (display_name, float32 signal) clips for
    export_spectrograms — the reference's datasets are .abf/.h5, not WAV
    (SweepManager.py:12-19), so the config-5 pipeline must eat them
    directly. Signals follow the session's source rule
    (processed-over-raw, registry.get_signal). Output PNGs are named
    '{base}_sweep{i}.png'.

    The pipeline is single-rate: sweeps whose rate differs from `fs`
    raise (on_error='raise') or are skipped with a log line
    (on_error='skip'), exactly like undecodable files. One registry per
    FILE keeps host memory bounded on large datasets."""
    seen = set()
    for p in paths:
        r = SweepRegistry()
        try:
            names = r.load_file(p)
        except (OSError, ValueError, KeyError) as e:
            if on_error == "raise":
                raise
            log.warning("skipping undecodable recording %s: %s", p, e)
            continue
        for name in names:
            try:
                x, sweep_fs = r.get_signal(name, processed=True)
            except KeyError as e:
                if on_error == "raise":
                    raise
                log.warning("skipping sweep %s: %s", name, e)
                continue
            if float(sweep_fs) != float(fs):
                if on_error == "raise":
                    raise ValueError(
                        f"{name}: sampling rate {sweep_fs:g} != dataset "
                        f"rate {fs:g} (the export pipeline is single-rate;"
                        f" export mismatched recordings separately)")
                log.warning("skipping sweep %s: fs %g != dataset fs %g",
                            name, sweep_fs, fs)
                continue
            if name in seen:
                # two dataset files with the same stem (e.g. ds.h5 +
                # ds.abf) produce the same '{base}_sweep{i}' names — the
                # later clip's PNG silently overwrites the earlier one.
                # Keep the last-write-wins registry semantics
                # (SweepManager.data is a plain dict) but SAY so.
                log.warning("duplicate sweep name %r (from %s): its PNG "
                            "overwrites an earlier clip's output", name, p)
            seen.add(name)
            yield name, np.asarray(x, np.float32)
