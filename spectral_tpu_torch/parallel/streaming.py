"""Chunked streaming STFT with overlap carry, on the card.

Counterpart of ``spectral_tpu/parallel/streaming.py``. The reference loads
whole recordings into RAM and concatenates sweeps (PlotEngine.py:193); the
long-form workload (BASELINE.json config 4: a 1-hour 48 kHz recording)
instead streams fixed-size chunks from the host to the card with a carry
of trailing samples between chunks, so device memory stays bounded by the
chunk size while frame centers and counts are *identical* to the
monolithic computation (SURVEY.md §5 long-context).

Scheme: with hop h and frame length nperseg, the carry length is
c = (ceil(nperseg/h) - 1) * h  (the smallest multiple of h >= nperseg - h)
and the chunk length m must be a multiple of h. Each step frames
[carry | chunk] at local offsets 0, h, ..., m-h — exactly m/h frames whose
absolute start samples are j*m - c + i*h, i.e. the monolithic hop grid.
Chunk 0's first c/h slots fall before the signal and are masked invalid.

The JAX package runs the block loop as one ``lax.scan``; here it is a host
loop over blocks, laid out as the export pipeline's
(``parallel/pipeline.py``): two device buffers of lead + (c + L,) float32,
the carry's c samples then the block's L, passed to the route's STFT
kernel as they are (one launch a block, a fleet's recordings as its
clips); two pinned host staging buffers; the upload of block j + 1 on a
copy stream while block j's kernel and fold run on the current stream;
the carry moved on the card from the tail of one buffer to the head of the
other; and events that keep a buffer from reuse before its copy or its
kernel is done. The folds hold the blocks in flight and their outputs,
never the recording's PSD. On a CPU tensor the same loop runs the
kernel's plain version.

Left out against the JAX package: ``use_matmul`` and ``ScanStreamer``'s
``unroll`` (they choose XLA programs; a fleet is one launch a block) and
``scan_spectrogram``'s mesh branch (ROADMAP [multi-device]).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from spectral_tpu_torch.config import SpecConfig
from spectral_tpu_torch.core.events import (EEG_BANDS, band_bins, band_power,
                                            features_from_band_power)
from spectral_tpu_torch.core.stft import (freq_axis, num_frames,
                                          power_spectrogram, time_axis)
from spectral_tpu_torch.ops.stft_cuda import check_supported
from spectral_tpu_torch.utils.device import DeviceLike, resolve_device

# elements of the band-power fold's float64 row chunk: the fold's
# temporary stays 8 MiB whatever the block
_SUM_ELEMENTS = 1 << 20


def carry_len(cfg: SpecConfig) -> int:
    h = cfg.hop_
    return (math.ceil(cfg.nperseg / h) - 1) * h


def _validate_chunking(cfg: SpecConfig, size: int, what: str) -> None:
    """Shared entry contract of every streaming driver.

    Off-hop-grid sizes would silently produce a frame grid misaligned with
    the monolithic computation (steps would jump by size % hop). Mel
    configs are refused rather than silently ignored: the streamers emit
    the linear-frequency PSD (mel is a display/pipeline projection — fold
    it over the streamed PSD, or use the export pipeline), and a caller
    who set n_mels would otherwise get full linear rows back with no
    warning."""
    h = cfg.hop_
    if size % h != 0:
        raise ValueError(f"{what} must be a multiple of hop={h}")
    if size < cfg.nperseg:
        raise ValueError(f"{what} must be >= nperseg")
    if cfg.n_mels:
        raise ValueError(
            "streaming drivers emit the linear-frequency PSD and ignore "
            "n_mels; project to mel in a fold over the streamed PSD (or "
            "use the export pipeline) instead of a mel config")


def _stream_config(cfg: SpecConfig) -> SpecConfig:
    """The config every block is computed with: centered framing refused
    with the JAX package's text, the band dropped (the streamers emit the
    full one-sided axis), and a config the kernels cannot compute refused
    on every device, naming its ROADMAP item. The magnitude mode and nfft
    > nperseg stream on the route of their nfft; the complex mode raises
    the JAX package's ValueError at the first block, as its power
    spectrogram does."""
    if cfg.center:
        raise ValueError(
            "streaming drivers require center=False: the overlap carry "
            "reproduces the uncentered (scipy) frame grid; centered "
            "framing pads the WHOLE signal by nperseg//2, which has no "
            "chunked equivalent — compute it monolithically instead")
    stream_cfg = dataclasses.replace(cfg, center=False, fmin=None, fmax=None)
    check_supported(stream_cfg)
    return stream_cfg


def _source(x):
    """x as a tensor that the blocks are sliced from, without copying:
    a tensor as it is, an array through ``torch.from_numpy`` (the blocks
    are converted to float32 as they are staged). Complex and 0-d inputs
    are refused, as ``core.stft.ensure_real_waveform`` refuses them."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if not x.flags.writeable:      # from_numpy warns on a read-only view
            x = x.copy()
        x = torch.from_numpy(x)
    if x.ndim == 0:
        raise ValueError("waveform must have at least one axis (got a "
                         "scalar); pass a 1-D signal or a (..., n) batch")
    if x.is_complex():
        raise ValueError(f"real-valued waveform required, got {x.dtype}")
    return x


def _device_of(x: torch.Tensor, device: DeviceLike) -> torch.device:
    """A CUDA tensor's own device; otherwise the one the caller names."""
    return x.device if x.is_cuda else resolve_device(device)


class _Stager:
    """The host loop's buffers: [carry | block] on the device, twice.

    ``push(block)`` writes block j (lead + (m,), m <= L, host or device)
    behind the carry (the last c samples of the previous buffer, zeros
    after a reset) in buffer j % 2, zero-pads it past m, and returns the
    buffer, ready on the current stream. ``launched()`` marks the buffer's
    kernel enqueued: the next write into it waits for that kernel. On a
    CUDA device a host block goes through a pinned staging buffer, and the
    writes run on a copy stream."""

    def __init__(self, dev: torch.device, lead, c: int, L: int):
        self.dev, self.c, self.L = dev, c, L
        self.cuda = dev.type == "cuda"
        shape = tuple(lead) + (c + L,)
        self.bufs = [torch.empty(shape, dtype=torch.float32, device=dev)
                     for _ in range(2)]
        self.pushes = 0          # buffers written, ever: picks the buffer
        self.fresh = True        # the next block starts a recording
        if self.cuda:
            # every write on the copy stream is waited for by the current
            # stream before the buffer's kernel, so the buffers' memory is
            # free for that stream's allocator once the loop ends
            self.copy = torch.cuda.Stream(dev)
            self.stage = [torch.empty(tuple(lead) + (L,),
                                      dtype=torch.float32, pin_memory=True)
                          for _ in range(2)]
            self.uploaded = [torch.cuda.Event() for _ in range(2)]
            self.read = [torch.cuda.Event() for _ in range(2)]

    def reset(self) -> None:
        self.fresh = True

    def push(self, block: torch.Tensor) -> torch.Tensor:
        c, L = self.c, self.L
        d = self.pushes % 2
        buf, prev = self.bufs[d], self.bufs[1 - d]
        m = block.shape[-1]
        reused = self.pushes >= 2
        ctx = contextlib.nullcontext()
        if self.cuda:
            if block.is_cuda:
                self.copy.wait_stream(torch.cuda.current_stream(self.dev))
            else:
                if reused:     # the staging buffer's last upload is done
                    self.uploaded[d].synchronize()
                stage = self.stage[d][..., :m]
                stage.copy_(block)
                block = stage
            ctx = torch.cuda.stream(self.copy)
        with ctx:
            if self.cuda and reused:   # the buffer's last kernel is done
                self.copy.wait_event(self.read[d])
            if self.fresh:
                buf[..., :c].zero_()
            else:
                buf[..., :c].copy_(prev[..., L:], non_blocking=True)
            buf[..., c:c + m].copy_(block, non_blocking=True)
            if m < L:
                buf[..., c + m:].zero_()
            if self.cuda:
                self.uploaded[d].record(self.copy)
        if self.cuda:
            torch.cuda.current_stream(self.dev).wait_event(self.uploaded[d])
        self.pushes += 1
        self.fresh = False
        return buf

    def launched(self) -> None:
        if self.cuda:
            self.read[(self.pushes - 1) % 2].record(
                torch.cuda.current_stream(self.dev))


class _CarryStreamer:
    """What StreamingSTFT and BlockStreamingSTFT share: blocks of a fixed
    size fed one call at a time, the carry kept on the device between
    calls (the buffers made at the first call, on its device)."""

    _what = "block"

    def __init__(self, fs: float, cfg: SpecConfig, size: int,
                 device: DeviceLike):
        _validate_chunking(cfg, size, "chunk_size")
        self.cfg = cfg
        self.fs = fs
        self.device = device
        self.c = carry_len(cfg)
        self._stream_cfg = _stream_config(cfg)
        self._size = size
        self._frames = size // cfg.hop_
        self._idx = 0
        self._stager: Optional[_Stager] = None

    def reset(self) -> None:
        self._idx = 0
        if self._stager is not None:
            self._stager.reset()

    def _process(self, block, exact: bool = True
                 ) -> Tuple[torch.Tensor, np.ndarray, int]:
        block = _source(block)
        n = block.shape[-1]
        if block.ndim != 1 or n > self._size or (exact and n != self._size):
            raise ValueError(f"expected {self._what} of {self._size}, got "
                             f"{n if block.ndim == 1 else tuple(block.shape)}")
        if self._stager is None:
            self._stager = _Stager(_device_of(block, self.device), (),
                                   self.c, self._size)
        buf = self._stager.push(block)
        psd = power_spectrogram(buf, self.fs, self._stream_cfg)
        self._stager.launched()
        first_abs = self._idx * self._frames - self.c // self.cfg.hop_
        valid = np.arange(self._frames) + first_abs >= 0
        self._idx += 1
        return psd, valid, first_abs


class StreamingSTFT(_CarryStreamer):
    """Stateful chunked STFT. Feed equal-sized chunks (multiple of hop);
    receive (frames, valid_mask, first_abs_frame_index) per chunk.

    The frames are a (m/h, F) tensor on the device (the card unless
    ``device='cpu'``; a CUDA chunk's own), one kernel launch a chunk."""

    _what = "chunk"

    def __init__(self, fs: float, cfg: SpecConfig, chunk_size: int,
                 device: DeviceLike = "cuda"):
        super().__init__(fs, cfg, chunk_size, device)
        self.chunk_size = chunk_size
        self.frames_per_chunk = self._frames

    def process(self, chunk) -> Tuple[torch.Tensor, np.ndarray, int]:
        """One chunk (exactly chunk_size samples) -> (psd (m/h, F), valid
        mask (m/h,), absolute index of this block's first frame slot)."""
        return self._process(chunk)


class BlockStreamingSTFT(_CarryStreamer):
    """Device-efficient streaming: stages B chunks per launch.

    B consecutive chunks are contiguous signal, so the per-chunk
    overlap-carry frame grid of B StreamingSTFT.process calls is *exactly*
    the monolithic hop grid of the staged buffer ``[carry | chunk_0 ...
    chunk_{B-1}]``: with carry c = (ceil(nperseg/hop)-1)*hop and block
    length L = B*chunk_size (both multiples of hop), the buffer yields
    (c + L - nperseg)//hop + 1 == L/hop complete frames at local offsets
    0, hop, 2*hop, ... — the same slots the chunk loop produces one chunk
    at a time. One launch of the route's STFT kernel therefore computes
    L/hop frames instead of B launches, while device memory stays bounded
    by the block size.
    """

    def __init__(self, fs: float, cfg: SpecConfig, chunk_size: int,
                 chunks_per_block: int = 32, device: DeviceLike = "cuda"):
        _validate_chunking(cfg, chunk_size, "chunk_size")
        if chunks_per_block < 1:
            raise ValueError("chunks_per_block must be >= 1")
        super().__init__(fs, cfg, chunk_size * chunks_per_block, device)
        self.chunk_size = chunk_size
        self.chunks_per_block = chunks_per_block
        self.block_size = self._size
        self.frames_per_block = self._frames

    def process_block(self, block) -> Tuple[torch.Tensor, np.ndarray, int]:
        """One block (chunks_per_block * chunk_size samples) ->
        (psd (L/hop, F) device tensor, valid mask, first absolute frame)."""
        return self._process(block)


def stream_spectrogram(x, fs: float, cfg: SpecConfig, chunk_size: int,
                       chunks_per_block: Optional[int] = None,
                       device: DeviceLike = "cuda") -> torch.Tensor:
    """Host driver: stream a full signal through BlockStreamingSTFT and
    return the frame-major PSD (T, F) on the device, identical to
    power_spectrogram(x) on even nperseg (chunked == monolithic).

    chunks_per_block chunks are staged per launch (default: up to 64,
    capped at the actual chunk count); the final partial block is
    zero-padded and the output trimmed to the monolithic frame count
    (scipy drops trailing partial frames)."""
    x = _source(x)
    n = x.shape[-1]
    total_frames = num_frames(n, cfg.nperseg, cfg.hop_)
    n_chunks = max(1, math.ceil(n / chunk_size))
    if chunks_per_block is None:
        chunks_per_block = min(n_chunks, 64)
    s = BlockStreamingSTFT(fs, cfg, chunk_size, chunks_per_block,
                           device=device)
    dev = _device_of(x, device)
    out = torch.empty((total_frames, cfg.n_freqs), dtype=torch.float32,
                      device=dev)
    got = 0
    for j in range(max(1, math.ceil(n / s.block_size))):
        block = x[..., j * s.block_size:(j + 1) * s.block_size]
        psd, _, first_abs = s._process(block, exact=False)
        i0 = max(0, -first_abs)
        i1 = min(s.frames_per_block, total_frames - first_abs)
        if i1 > i0:
            out[got:got + i1 - i0].copy_(psd[i0:i1])
            got += i1 - i0
    return out


class ScanStreamer:
    """Streaming program for a fixed signal length: a host loop over
    staged chunk blocks with the overlap carry kept on the device, one
    launch of the route's STFT kernel a block. fold(acc, psd_block,
    valid_mask) -> (acc, y), valid_mask a (frames_per_block,) bool tensor
    on the device; the ys are stacked along a new first axis.

    batch > 0 streams a FLEET of equal-length recordings together: each
    block is computed for every recording in the same launch (psd_block
    (batch, frames_per_block, F)). ``last_layout`` says which form the
    last call used: "batched" for a fleet, "single" for one recording.
    ``device`` is where it runs: the card unless 'cpu' is named; a CUDA
    input runs on its own device."""

    def __init__(self, fs: float, cfg: SpecConfig, block_size: int, n: int,
                 fold, init, batch: int = 0, device: DeviceLike = "cuda"):
        h = cfg.hop_
        _validate_chunking(cfg, block_size, "block_size")
        self._stream_cfg = _stream_config(cfg)
        self.cfg = cfg
        self.fs = fs
        self.c = carry_len(cfg)
        self.total_frames = num_frames(n, cfg.nperseg, h)
        self.skip = self.c // h
        self.n = n
        self.batch = batch
        self.n_blocks = max(1, math.ceil(n / block_size))
        self.block_size = block_size
        self.padded_len = self.n_blocks * block_size
        self.frames_per_block = block_size // h
        self.device = device
        self._fold = fold
        self._init = init
        self.last_layout: Optional[str] = None

    def _signal(self, x) -> torch.Tensor:
        x = _source(x)
        want = ((self.batch,) if self.batch else ()) + (self.n,)
        if tuple(x.shape) != want:
            raise ValueError(f"expected a signal of shape {want}, got "
                             f"{tuple(x.shape)}")
        return x

    def _run(self, x: torch.Tensor, dev: torch.device, step,
             band: Optional[Tuple[int, int]] = None) -> None:
        """The host loop: step(j, psd, i0, i1) for each block j, psd the
        block's lead + (frames_per_block, F) PSD on dev (only the bins
        band = (lo, hi) when given), [i0, i1) its valid slots."""
        L, fpb = self.block_size, self.frames_per_block
        stager = _Stager(dev, x.shape[:-1], self.c, L)
        self.last_layout = "batched" if self.batch else "single"
        for j in range(self.n_blocks):
            buf = stager.push(x[..., j * L:(j + 1) * L])
            psd = power_spectrogram(buf, self.fs, self._stream_cfg,
                                    band=band)
            stager.launched()
            first_abs = j * fpb - self.skip
            i0 = max(0, -first_abs)
            step(j, psd, i0, max(i0, min(fpb, self.total_frames - first_abs)))

    def __call__(self, x):
        """x: (n,) — or (batch, n) when batch > 0 — numpy or a tensor ->
        (final_acc, stacked_ys)."""
        x = self._signal(x)
        dev = _device_of(x, self.device)
        slots = torch.arange(self.frames_per_block, device=dev)
        state = {"acc": self._init, "ys": []}

        def step(j, psd, i0, i1):
            valid = (slots >= i0) & (slots < i1)
            state["acc"], y = self._fold(state["acc"], psd, valid)
            state["ys"].append(y)

        self._run(x, dev, step)
        return state["acc"], _stack(state["ys"])


def _stack(ys):
    """The folds' per-block outputs stacked along a new first axis (a
    tensor each, or a tuple or list of them)."""
    if isinstance(ys[0], (tuple, list)):
        return type(ys[0])(_stack(list(parts)) for parts in zip(*ys))
    return torch.stack([torch.as_tensor(y) for y in ys])


def _block(chunk_size: int, chunks_per_block: int, n: int) -> int:
    """The block length of scan_spectrogram and stream_features: up to
    chunks_per_block chunks, no more than the signal needs when it fits
    in one block."""
    block = chunk_size * max(1, chunks_per_block)
    if math.ceil(n / block) == 1:
        block = chunk_size * max(1, min(chunks_per_block,
                                        math.ceil(n / chunk_size)))
    return block


def scan_spectrogram(x, fs: float, cfg: SpecConfig, chunk_size: int,
                     chunks_per_block: int = 64, mesh=None,
                     seq_axis: str = "data",
                     device: DeviceLike = "cuda") -> torch.Tensor:
    """Streaming STFT of a whole signal, (n,) or a fleet (B, n) ->
    (T, F) or (B, T, F) on the device, identical to power_spectrogram(x)
    on even nperseg: one launch a block of chunks_per_block chunks, each
    block's valid frames copied into the output on the card. Device
    memory is the output and the blocks in flight.

    ``mesh`` (the JAX package's time-sharded form over a device mesh)
    arrives with ROADMAP [multi-device] and raises NotImplementedError."""
    _validate_chunking(cfg, chunk_size, "chunk_size")
    if mesh is not None:
        raise NotImplementedError(
            "scan_spectrogram over a mesh (the time-sharded form, "
            f"seq_axis={seq_axis!r}) arrives with ROADMAP [multi-device]")
    x = _source(x)
    if x.ndim > 2:
        raise ValueError(f"expected a (n,) or (B, n) signal, got "
                         f"{tuple(x.shape)}")
    n = x.shape[-1]
    s = ScanStreamer(fs, cfg, _block(chunk_size, chunks_per_block, n), n,
                     None, None, batch=x.shape[0] if x.ndim == 2 else 0,
                     device=device)
    dev = _device_of(x, device)
    out = torch.empty(x.shape[:-1] + (s.total_frames, cfg.n_freqs),
                      dtype=torch.float32, device=dev)
    fpb = s.frames_per_block

    def step(j, psd, i0, i1):
        a = j * fpb - s.skip + i0
        out[..., a:a + i1 - i0, :].copy_(psd[..., i0:i1, :])

    s._run(s._signal(x), dev, step)
    return out


def stream_fold(x, fs: float, cfg: SpecConfig, chunk_size: int, fold, init,
                chunks_per_block: int = 64, device: DeviceLike = "cuda"):
    """Streaming *reduction* in bounded device memory — the PSD is folded
    block-by-block into `acc` and never materialized.

    fold(acc, psd_block (frames_per_block, F), valid (frames_per_block,)
    bool tensor) -> acc. Invalid slots (the zero-carry warmup frames of
    block 0 and trailing zero-pad frames) must be masked by the fold using
    `valid`. Long-form analytics (global max for shared normalization,
    band powers, feature statistics — the quantities PlotEngine.py:686-719
    computes from the full in-RAM Sxx) run this way over arbitrarily long
    recordings."""
    _validate_chunking(cfg, chunk_size, "chunk_size")
    x = _source(x)
    s = ScanStreamer(fs, cfg, chunk_size * max(1, chunks_per_block),
                     x.shape[-1],
                     lambda acc, psd, valid: (fold(acc, psd, valid),
                                              torch.zeros(())),
                     init, batch=x.shape[0] if x.ndim == 2 else 0,
                     device=device)
    return s(x)[0]


def _single(x) -> torch.Tensor:
    x = _source(x)
    if x.ndim != 1:
        raise ValueError(f"expected one recording (n,), got "
                         f"{tuple(x.shape)}; stream a fleet with "
                         "ScanStreamer(batch=...)")
    return x


def _column_sums(p: torch.Tensor) -> torch.Tensor:
    """(T, F) float32 -> (F,) float64 sums over the frames, taken in
    float64 a row chunk of at most _SUM_ELEMENTS elements at a time."""
    rows = max(1, _SUM_ELEMENTS // max(1, p.shape[-1]))
    out = torch.zeros(p.shape[-1], dtype=torch.float64, device=p.device)
    for r in range(0, p.shape[0], rows):
        out += p[r:r + rows].sum(dim=0, dtype=torch.float64)
    return out


def stream_band_powers(x, fs: float, cfg: SpecConfig, chunk_size: int,
                       bands=None, chunks_per_block: int = 64,
                       device: DeviceLike = "cuda"):
    """Long-form EEG band powers: the PSD folded into per-bin sums over
    the frames, block by block, in float64 on the device (as
    ``core/events.py::band_powers_device`` sums), one copy to the host at
    the end.

    Reproduces the reference's semantics exactly (PlotEngine.py:692-719 via
    core/events.band_powers): Sxx clamped >= 0, band mask f >= low AND
    f < high (upper edge exclusive), relative power = band/total, all-zero
    result when total < 1e-18 — including the fmin/fmax row pre-mask the
    reference applies before any analysis (PlotEngine.py:114-115). The
    reference computes this from the full in-RAM Sxx; here hour-scale
    recordings never materialize one.

    Returns (dict name -> relative power, total_power).
    """
    if bands is None:
        bands = EEG_BANDS
    _validate_chunking(cfg, chunk_size, "chunk_size")
    x = _single(x)
    f = freq_axis(cfg, fs)
    lo = cfg.fmin if cfg.fmin is not None else -np.inf
    hi = cfg.fmax if cfg.fmax is not None else np.inf
    row = (f >= lo) & (f <= hi)                      # pre-mask rows
    masks = np.stack([row & (f >= b_lo) & (f < b_hi)
                      for b_lo, b_hi in bands.values()] + [row])
    s = ScanStreamer(fs, cfg, chunk_size * max(1, chunks_per_block),
                     x.shape[-1], None, None, device=device)
    dev = _device_of(x, device)
    sums = torch.zeros(f.shape[0], dtype=torch.float64, device=dev)

    def step(j, psd, i0, i1):
        p = psd[i0:i1]
        sums.add_(_column_sums(p.clamp_min_(0.0)))

    s._run(x, dev, step)
    out = (torch.as_tensor(masks.astype(np.float64), device=dev)
           @ sums).cpu().numpy()
    band_sums, total = out[:-1], float(out[-1])
    if total < 1e-18:
        return {name: 0.0 for name in bands}, total
    return ({name: float(np.clip(band_sums[i] / total, 0.0, None))
             for i, name in enumerate(bands)}, total)


def iter_stream(chunks: Iterator[np.ndarray], fs: float, cfg: SpecConfig,
                chunk_size: int, device: DeviceLike = "cuda"
                ) -> Iterator[Tuple[torch.Tensor, int]]:
    """Generator form for true streaming sources: yields (psd_block on the
    device, first_abs_frame_index) with invalid slots already dropped —
    both the leading carry region and, for a short final chunk, trailing
    frames that would extend past the real samples (zero-padding is an
    implementation detail, not signal)."""
    s = StreamingSTFT(fs, cfg, chunk_size, device=device)
    h = cfg.hop_
    n_seen = 0
    ended = False
    for chunk in chunks:
        if ended:
            # a short chunk's zero padding entered the carry; splicing more
            # real samples after it would shift every subsequent frame's
            # content against its reported absolute index with no way for
            # the validity gate to notice — refuse instead of corrupting
            raise ValueError(
                "iter_stream received a chunk after a short (final) chunk; "
                "short reads are only valid as the last chunk of a stream")
        chunk = _source(chunk)
        n_seen += chunk.shape[-1]
        ended = chunk.shape[-1] < chunk_size
        psd, _, first_abs = s._process(chunk, exact=False)
        # frames whose last sample is a real one: abs * h + nperseg <= seen
        complete = (n_seen - cfg.nperseg) // h + 1 if n_seen >= cfg.nperseg \
            else 0
        i0 = max(0, -first_abs)
        i1 = max(i0, min(s.frames_per_chunk, complete - first_abs))
        yield psd[i0:i1], max(first_abs, 0)


def stream_features(x, fs: float, cfg: SpecConfig, chunk_size: int,
                    chunks_per_block: int = 64,
                    device: DeviceLike = "cuda"):
    """Per-frame HMM detection features for an arbitrarily long recording
    in bounded device memory: each block's PSD is computed for the
    session's detection band alone (cfg.fmin..fmax defaulting to the full
    axis — api/session._features semantics, PlotEngine.py:238-242; the
    kernel's band, bitwise the full band's columns) and summed to per-frame
    band power as ``core/events.py::features_from_psd`` sums it (float64,
    rounded to float32); an hour of 48 kHz audio yields a ~1.4 GB PSD but
    only a ~2.7 MB power track.

    Returns (t (T,) host frame times, feats (T, 2) on the device) —
    identical to core/events.features_from_psd of the monolithic PSD."""
    _validate_chunking(cfg, chunk_size, "chunk_size")
    x = _single(x)
    n = x.shape[-1]
    f = freq_axis(cfg, fs)
    fmin = cfg.fmin if cfg.fmin is not None else 0.0
    fmax = cfg.fmax if cfg.fmax is not None else float(f[-1])
    idx = band_bins(f, fmin, fmax)
    band = None
    if cfg.onesided and idx.size and idx[-1] - idx[0] + 1 == idx.size:
        band = (int(idx[0]), int(idx[-1]) + 1)
        f = f[band[0]:band[1]]
    s = ScanStreamer(fs, cfg, _block(chunk_size, chunks_per_block, n), n,
                     None, None, device=device)
    dev = _device_of(x, device)
    power = torch.empty(s.total_frames, dtype=torch.float32, device=dev)
    fpb = s.frames_per_block

    def step(j, psd, i0, i1):
        a = j * fpb - s.skip + i0
        power[a:a + i1 - i0] = band_power(f, psd[i0:i1], fmin, fmax)

    s._run(x, dev, step, band=band)
    return time_axis(cfg, fs, n), features_from_band_power(power)


def stream_detect(x, fs: float, cfg: SpecConfig, chunk_size: int,
                  detector=None, chunks_per_block: int = 64,
                  device: DeviceLike = "cuda"):
    """Hour-scale unsupervised burst detection in bounded memory: streaming
    feature extraction (:func:`stream_features`) into a BurstDetector,
    whose engine='auto' routes long feature sequences to the
    chunked HMM kernels (``models/hmm_pscan.py``). The default detector
    runs where the features do. The reference's equivalent needs the whole
    Sxx in RAM (PlotEngine.py:411-473 after :113's full STFT); here
    neither the PSD nor the display image ever exists.

    Returns merged (start, end) events (same scan + merge semantics as the
    plot-based flow, identical results on the same recording)."""
    from spectral_tpu_torch.models.detector import BurstDetector
    t, feats = stream_features(x, fs, cfg, chunk_size,
                               chunks_per_block=chunks_per_block,
                               device=device)
    det = detector if detector is not None else BurstDetector(
        device=str(feats.device))
    return det.unsupervised_detect(t, feats)
