"""WAV loading (stdlib-only).

The reference loads only ABF and NIX-HDF5 (SweepManager.py:12-19); the
north-star workloads (BASELINE.json configs 1, 2, 5) are WAV audio clips, so a
zero-dependency RIFF/WAVE reader is part of the IO layer. Supports PCM 8/16/
24/32-bit and IEEE float32/64, mono or multi-channel.

The port's own copy of ``spectral_tpu/io/wav.py`` without the registry
hook (``load_wav``), which waits for the port of ``io/registry``.
"""

from __future__ import annotations

import os
import struct
from typing import List, Tuple

import numpy as np


def _is_chunk_sequence(buf: bytes) -> bool:
    """True when buf (possibly empty) parses as a clean RIFF chunk walk:
    printable 4-byte tags, declared sizes that fit, nothing left over."""
    off = 0
    n = len(buf)
    while off < n:
        if off + 8 > n:
            return False
        tag = buf[off:off + 4]
        if not all(0x20 <= b <= 0x7E for b in tag):
            return False
        sz = int.from_bytes(buf[off + 4:off + 8], "little")
        off += 8 + sz + (sz % 2)
        if off > n + 1:    # +1: final pad byte may be absent at EOF
            return False
    return True


def _walk_chunks(buf: bytes):
    """Yield (tag, payload) over a chunk sequence validated by
    :func:`_is_chunk_sequence`."""
    off = 0
    n = len(buf)
    while off + 8 <= n:
        tag = buf[off:off + 4]
        sz = int.from_bytes(buf[off + 4:off + 8], "little")
        yield tag, buf[off + 8:off + 8 + sz]
        off += 8 + sz + (sz % 2)


def _read_riff(filepath: str) -> Tuple[int, int, float, int, bytes]:
    """Shared RIFF/WAVE chunk walk -> (audio_fmt, n_ch, fs, bits, data).
    Resolves WAVE_FORMAT_EXTENSIBLE to the wrapped format code."""
    with open(filepath, "rb") as fh:
        hdr12 = fh.read(12)
        if len(hdr12) < 12:
            raise ValueError(f"{filepath}: not a RIFF/WAVE file (too short)")
        riff, _size, wave = struct.unpack("<4sI4s", hdr12)
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{filepath}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = fh.read(8)
            if len(hdr) < 8:
                break
            tag, sz = struct.unpack("<4sI", hdr)
            if tag == b"data" and sz in (0, 0xFFFFFFFF):
                rest = fh.read()
                # sz is either a streamed-WAV placeholder (writer never
                # seeked back, e.g. piped ffmpeg/sox: audio = rest of the
                # file) or a LEGITIMATELY empty recording possibly followed
                # by metadata chunks (LIST/INFO...). Disambiguate by
                # whether the remaining bytes parse as a clean chunk walk —
                # decoding metadata as PCM would fabricate garbage samples.
                if sz == 0 and _is_chunk_sequence(rest):
                    data = b""
                    for t2, p2 in _walk_chunks(rest):
                        if t2 == b"fmt " and fmt is None:
                            fmt = p2
                    break
                data = rest
                continue
            payload = fh.read(sz)
            if len(payload) < sz:
                # trusting the declared size would silently truncate (or
                # surface later as an unrelated np.frombuffer shape error)
                raise ValueError(
                    f"{filepath}: truncated {tag.decode('ascii', 'replace')!s}"
                    f" chunk (declared {sz} bytes, got {len(payload)})")
            if sz % 2:  # chunks are word-aligned
                fh.read(1)
            if tag == b"fmt ":
                fmt = payload
            elif tag == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"{filepath}: missing fmt/data chunk")
    if len(fmt) < 16:
        raise ValueError(f"{filepath}: fmt chunk too short ({len(fmt)} bytes)")
    (audio_fmt, n_ch, fs, _brate, _balign, bits) = struct.unpack(
        "<HHIIHH", fmt[:16])
    if fs == 0:
        # a zero sampling rate from a corrupt header must reject here:
        # downstream 1/fs (freq_axis, time_axis) raises a bare
        # ZeroDivisionError far from the untrusted-input boundary
        raise ValueError(f"{filepath}: invalid sampling rate 0")
    if audio_fmt == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_fmt = struct.unpack("<H", fmt[24:26])[0]
    return audio_fmt, n_ch, float(fs), bits, data


def wav_info(filepath: str) -> Tuple[int, int, float, int]:
    """Header-only parse -> (audio_fmt, n_channels, fs, bits).

    Seeks past chunk payloads instead of reading them: callers that only
    need the sample rate (e.g. the export pipeline sizing clip_samples)
    must not decode a whole recording for one header field."""
    with open(filepath, "rb") as fh:
        hdr12 = fh.read(12)
        if len(hdr12) < 12:
            raise ValueError(f"{filepath}: not a RIFF/WAVE file (too short)")
        riff, _size, wave = struct.unpack("<4sI4s", hdr12)
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{filepath}: not a RIFF/WAVE file")
        fmt = None
        while fmt is None:
            hdr = fh.read(8)
            if len(hdr) < 8:
                break
            tag, sz = struct.unpack("<4sI", hdr)
            if tag == b"fmt ":
                fmt = fh.read(sz)
            else:
                fh.seek(sz + (sz % 2), os.SEEK_CUR)
        if fmt is None:
            raise ValueError(f"{filepath}: missing fmt chunk")
    if len(fmt) < 16:
        raise ValueError(f"{filepath}: fmt chunk too short ({len(fmt)} bytes)")
    (audio_fmt, n_ch, fs, _brate, _balign, bits) = struct.unpack(
        "<HHIIHH", fmt[:16])
    if fs == 0:
        raise ValueError(f"{filepath}: invalid sampling rate 0")
    if audio_fmt == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_fmt = struct.unpack("<H", fmt[24:26])[0]
    return audio_fmt, n_ch, float(fs), bits


def read_wav(filepath: str) -> Tuple[np.ndarray, float]:
    """Read a WAV file -> (float32 array (n,) or (n, ch) in [-1, 1], fs)."""
    audio_fmt, n_ch, fs, bits, data = _read_riff(filepath)

    if audio_fmt == 1:  # PCM
        if bits == 8:
            x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
            as32 = (raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16))
            as32 = np.where(as32 >= 1 << 23, as32 - (1 << 24), as32)
            x = as32.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    elif audio_fmt == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(data, "<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(data, "<f8").astype(np.float32)
        else:
            raise ValueError(f"unsupported float bit depth: {bits}")
    else:
        raise ValueError(f"unsupported WAV format code: {audio_fmt}")

    if n_ch > 1:
        x = x[: (len(x) // n_ch) * n_ch].reshape(-1, n_ch)
    return x, float(fs)


def read_wav_int16(filepath: str) -> Tuple[np.ndarray, float]:
    """Read a 16-bit PCM WAV as RAW int16 samples -> ((n,) or (n, ch), fs).

    Skips the float conversion so batch pipelines can ship half the bytes
    host->device and normalize on device (x / 32768, identical to
    read_wav's scaling). Raises ValueError for any other encoding."""
    audio_fmt, n_ch, fs, bits, data = _read_riff(filepath)
    if audio_fmt != 1 or bits != 16:
        raise ValueError(f"{filepath}: not 16-bit PCM "
                         f"(fmt={audio_fmt}, bits={bits})")
    x = np.frombuffer(data, "<i2")
    if n_ch > 1:
        x = x[: (len(x) // n_ch) * n_ch].reshape(-1, n_ch)
    return x, float(fs)


def write_wav(filepath: str, x: np.ndarray, fs: float, bits: int = 16) -> None:
    """Write float [-1, 1] (n,) or (n, ch) to 16-bit PCM (test fixture aid)."""
    x = np.asarray(x)
    n_ch = 1 if x.ndim == 1 else x.shape[1]
    if bits != 16:
        raise ValueError("only 16-bit PCM writing is supported")
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
    payload = pcm.tobytes()
    with open(filepath, "wb") as fh:
        fh.write(struct.pack("<4sI4s", b"RIFF", 36 + len(payload), b"WAVE"))
        fh.write(struct.pack("<4sI", b"fmt ", 16))
        fh.write(struct.pack("<HHIIHH", 1, n_ch, int(fs),
                             int(fs) * n_ch * 2, n_ch * 2, 16))
        fh.write(struct.pack("<4sI", b"data", len(payload)))
        fh.write(payload)
