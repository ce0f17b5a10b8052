"""PNG encoding.

The port's own copy of ``spectral_tpu/render/png.py``: the atomic write,
the stale-temp sweep, RGB(A) and indexed-color (PLTE) encoders and the
decode helper. Pixels come from the card as packed words and only need PNG
encoding on the host. Three backends, in the original's order, the first
available wins:

  1. the native C++ encoder (zlib), built from ``spectral_tpu_torch/native``
     (:mod:`spectral_tpu_torch.native.build`), the JAX package's encoder
     byte for byte, so both packages write the same PNG bytes;
  2. PIL (if installed);
  3. pure-Python stdlib-zlib fallback (always available).
"""

from __future__ import annotations

import itertools
import os
import struct
import zlib
from typing import Optional

import numpy as np


_tmp_counter = itertools.count()


def _write_atomic(path: str, data: bytes, fsync: bool = False) -> None:
    """Same-directory temp + os.replace: a process killed mid-export never
    leaves a truncated file that looks like a finished PNG. The temp name
    is unique per (process, call), so encode pool threads handed duplicate
    clip stems never share one temp file (last writer wins, cleanly).

    Durability boundary: without fsync this is atomic against process
    death only. After a power loss the filesystem may commit the rename
    before the data blocks, leaving an empty or partial file under the
    final name that a later resume would trust; fsync=True (the exporter's
    durable=True) closes that."""
    tmp = f"{path}.tmp.{os.getpid()}.{next(_tmp_counter)}"
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
            if fsync:
                fh.flush()
                os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def clean_stale_tmp(dir_path: str) -> int:
    """Remove ``*.tmp.<pid>.<n>`` residue left by a dead process.

    SIGKILL can land between the temp-file open and the ``os.replace`` in
    :func:`_write_atomic`, so atomicity alone cannot promise a
    residue-free directory. Export runs call this on their output
    directory so a restart also cleans the previous run's temps. Temps
    whose embedded pid is still alive on this host are left alone.
    Returns the number of files removed."""
    removed = 0
    try:
        entries = os.listdir(dir_path)
    except OSError:
        return 0
    for name in entries:
        parts = name.rsplit(".tmp.", 1)
        if len(parts) != 2:
            continue
        pid_s = parts[1].split(".", 1)[0]
        # isdigit() alone admits non-ASCII digits that int() rejects
        if not (pid_s.isascii() and pid_s.isdigit()):
            continue
        pid = int(pid_s)
        try:
            os.kill(pid, 0)
            continue                 # alive: ours or another live writer's
        except ProcessLookupError:
            pass                     # dead: its temps are residue
        except OSError:
            continue                 # exists under another owner, or unknown
        try:
            os.unlink(os.path.join(dir_path, name))
            removed += 1
        except OSError:
            pass
    return removed


_native = None
_native_checked = False


def _get_native():
    global _native, _native_checked
    if not _native_checked:
        _native_checked = True
        try:
            from spectral_tpu_torch.native import png_native
            _native = png_native if png_native.available() else None
        except Exception:
            _native = None
    return _native


def _normalize_array(arr: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8:
        raise TypeError(f"expected uint8 pixels, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3 or arr.shape[2] not in (1, 3, 4):
        raise ValueError(f"expected (H, W, {{1,3,4}}) image, got {arr.shape}")
    return arr


def _chunk(tag: bytes, payload: bytes) -> bytes:
    """PNG chunk framing: length + tag + payload + CRC32(tag+payload)."""
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png_pure(arr: np.ndarray, compress_level: int = 6) -> bytes:
    """Stdlib-only PNG encoder (filter 0 scanlines + one zlib stream)."""
    arr = _normalize_array(arr)
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          arr.reshape(h, w * c)], axis=1).tobytes()
    idat = zlib.compress(raw, compress_level)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", idat) + _chunk(b"IEND", b""))


def encode_png(arr, path: Optional[str] = None, compress_level: int = 6,
               fsync: bool = False) -> Optional[bytes]:
    """Encode uint8 (H, W[, C]) pixels to PNG. Writes to ``path`` if given,
    else returns the bytes. Uses the first available backend."""
    arr = _normalize_array(np.asarray(arr))
    native = _get_native()
    if native is not None:
        data = native.encode(arr, compress_level)
    else:
        try:
            import io
            from PIL import Image
            mode = {1: "L", 3: "RGB", 4: "RGBA"}[arr.shape[2]]
            # arr[..., 0], not squeeze(): squeeze also collapses an H == 1
            # or W == 1 axis
            img = Image.fromarray(arr[..., 0] if mode == "L" else arr, mode)
            buf = io.BytesIO()
            img.save(buf, format="PNG", compress_level=compress_level)
            data = buf.getvalue()
        except ImportError:
            data = encode_png_pure(arr, compress_level)
    if path is not None:
        _write_atomic(path, data, fsync)
        return None
    return data


def encode_png_palette(indices: np.ndarray, palette: np.ndarray,
                       path: Optional[str] = None,
                       compress_level: int = 6,
                       fsync: bool = False) -> Optional[bytes]:
    """Encode a uint8 (H, W) index image + (N<=256, 3) RGB palette to an
    indexed-color (PLTE) PNG: a third of the deflate input of RGB at
    identical colors, the export's default for colormapped spectrograms."""
    indices = np.ascontiguousarray(np.asarray(indices), dtype=np.uint8)
    palette = np.ascontiguousarray(np.asarray(palette), dtype=np.uint8)
    if indices.ndim != 2 or palette.ndim != 2 or palette.shape[1] != 3:
        raise ValueError("expected (H, W) indices and (N, 3) palette")
    if palette.shape[0] > 256:
        raise ValueError(
            f"palette has {palette.shape[0]} entries; PNG PLTE max is 256")
    native = _get_native()
    if native is not None:
        data = native.encode_palette(indices, palette, compress_level)
    else:
        try:
            import io
            from PIL import Image
            img = Image.fromarray(indices, "P")
            img.putpalette(palette.reshape(-1).tolist())
            buf = io.BytesIO()
            img.save(buf, format="PNG", compress_level=compress_level)
            data = buf.getvalue()
        except ImportError:
            data = _encode_png_palette_pure(indices, palette, compress_level)
    if path is not None:
        _write_atomic(path, data, fsync)
        return None
    return data


def _encode_png_palette_pure(indices: np.ndarray, palette: np.ndarray,
                             compress_level: int = 6) -> bytes:
    """Stdlib-only indexed-color PNG (IHDR color type 3 + PLTE + IDAT)."""
    h, w = indices.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), indices],
                         axis=1).tobytes()
    # Z_RLE suits colormap-index scanlines: long runs of equal bytes
    co = zlib.compressobj(compress_level, zlib.DEFLATED, 15, 8, zlib.Z_RLE)
    idat = co.compress(raw) + co.flush()
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"PLTE", palette.tobytes())
            + _chunk(b"IDAT", idat)
            + _chunk(b"IEND", b""))


def decode_png(path_or_bytes) -> np.ndarray:
    """Decode a PNG back to a uint8 array (test/round-trip helper);
    indexed-color images come back as RGB."""
    try:
        import io
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("PNG decoding requires PIL") from e
    if isinstance(path_or_bytes, (bytes, bytearray)):
        img = Image.open(io.BytesIO(path_or_bytes))
    else:
        img = Image.open(path_or_bytes)
    if img.mode == "P":
        img = img.convert("RGB")
    return np.asarray(img)
