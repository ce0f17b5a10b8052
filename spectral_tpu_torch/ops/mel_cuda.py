"""The mel projection: a CUDA kernel and its plain version.

The JAX package has no Pallas kernel here: its batch pipeline applies the
mel filterbank as an XLA einsum over the freq-major PSD
(``spectral_tpu/parallel/sharding.py:97-108``) and keeps the mel rows of
the fmin/fmax band on the mel-centre axis (:71-75). The port computes the
same rows with a kernel of its own (``csrc/mel.cu``), launched once per
batch between the STFT kernel and ``ops.display_cuda.clip_stats``:

    psd (B, T, F) f32, full band -> mel (B, T, M) f32, M the band's rows
                                    + partials (2, 1, B, T), each frame's
                                      (min, max) over its M values

so ``clip_stats`` and the display map take the mel rows as they take a
PSD. Each mel row's nonzero weights form one span of bins (a triangle:
2-24 bins of 513 at 128 mels); the kernel sums the span in float64 and
rounds once at the store, and gives a non-finite bin outside the span the
dense product's answer, NaN (0 * inf). A dense product would do 65x the
needed arithmetic there, and need another pass for the partials.

:func:`mel_project` takes the kernel for a CUDA tensor and the plain
version (:func:`mel_project_reference`: ``core.mel.apply_mel``, the
float64 dense product, and ``torch.amin``/``amax``) for a CPU tensor, and
only because that lies on the CPU. On a CUDA tensor it launches or raises.

The gradient: a PSD that requires grad goes through an autograd Function
(:class:`_MelGrad`), whose backward is the projection's adjoint, dpsd =
dmel fb over the spans (``mel_backward_kernel`` in the same source, one
launch; each bin's rows from :func:`bin_table`), or for a CPU tensor its
plain version (:func:`mel_backward_reference`, the float64 dense product
with the band's rows). The partials carry no gradient.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from spectral_tpu_torch.core.mel import apply_mel
from spectral_tpu_torch.ops import build
from spectral_tpu_torch.ops.stft_cuda import row_partials

KERNEL = "mel"

# kernel launches, for run-time proof of the path
launches = {"mel": 0}
# the backward's launches
grad_launches = {"mel_backward": 0}


class MelSpans(NamedTuple):
    """The mel band's filterbank rows on one device: the rows themselves
    (M, F) float64 (the plain version's operand), and each row's span of
    nonzero weights, the kernel's: its first bin, its length (0 for a row
    with no nonzero weight) and its offset into ``weights``, (M,) int32
    each, and the spans' float64 weights packed, zeros inside a span
    kept; and the same table transposed, for the backward."""
    rows: torch.Tensor
    start: torch.Tensor
    length: torch.Tensor
    offset: torch.Tensor
    weights: torch.Tensor
    # the backward's: each bin's rows (:func:`bin_table`)
    bin_start: torch.Tensor
    bin_count: torch.Tensor
    bin_row: torch.Tensor
    bin_weight: torch.Tensor


def span_table(fb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                        np.ndarray]:
    """(start, length, offset, weights) of a (M, F) filterbank's rows: row
    m's weights fb[m, start:start + length], the first to the last
    nonzero, packed at weights[offset:offset + length]."""
    start = np.zeros(len(fb), np.int32)
    length = np.zeros(len(fb), np.int32)
    pieces = []
    for m, row in enumerate(fb):
        nz = np.flatnonzero(row)
        if nz.size:
            start[m], length[m] = nz[0], nz[-1] - nz[0] + 1
            pieces.append(row[nz[0]:nz[-1] + 1])
    offset = np.concatenate([[0], np.cumsum(length)[:-1]]).astype(np.int32)
    weights = (np.concatenate(pieces) if pieces
               else np.zeros(1, np.float64)).astype(np.float64)
    return start, length, offset, weights


def bin_table(fb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                       np.ndarray]:
    """The span table transposed, the backward kernel's: (start, count,
    row, weight), bin f's mel rows m (ascending) whose span (:func:`span_table`)
    holds f at row[start[f]:start[f] + count[f]] and their weights fb[m, f]
    (zeros inside a span kept) at the same places; count 0 for a bin that
    no span holds."""
    start, length, _, _ = span_table(fb)
    F = fb.shape[1]
    cover = [[] for _ in range(F)]
    for m in range(len(fb)):
        for f in range(start[m], start[m] + length[m]):
            cover[f].append(m)
    count = np.array([len(c) for c in cover], np.int32)
    first = np.concatenate([[0], np.cumsum(count)[:-1]]).astype(np.int32)
    row = np.array([m for c in cover for m in c] or [0], np.int32)
    weight = np.array([fb[m, f] for f, c in enumerate(cover) for m in c]
                      or [0.0], np.float64)
    return first, count, row, weight


def mel_spans(fb: np.ndarray, device) -> MelSpans:
    """The operands of the mel band's rows fb (M, F) float64 on device."""
    fb = np.asarray(fb, np.float64)
    start, length, offset, weights = span_table(fb)

    def put(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    b_start, b_count, b_row, b_weight = bin_table(fb)
    return MelSpans(put(fb, torch.float64), put(start, torch.int32),
                    put(length, torch.int32), put(offset, torch.int32),
                    put(weights, torch.float64), put(b_start, torch.int32),
                    put(b_count, torch.int32), put(b_row, torch.int32),
                    put(b_weight, torch.float64))


_LIB: list = []


def _library() -> ctypes.CDLL:
    """The mel kernel's library, built and loaded at first use, then kept
    for the process."""
    if _LIB:
        return _LIB[0]
    lib = build.load_library(KERNEL)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mel_project_launch.argtypes = [ptr] * 5 + [i64, i32, i32] + [
        ptr] * 4
    lib.mel_project_launch.restype = i32
    lib.mel_backward_launch.argtypes = [ptr] * 5 + [i64, i32, i32, ptr,
                                                    ptr]
    lib.mel_backward_launch.restype = i32
    lib.mel_error_string.argtypes = [i32]
    lib.mel_error_string.restype = ctypes.c_char_p
    _LIB.append(lib)
    return lib


def mel_project_reference(psd: torch.Tensor, spans: MelSpans
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`mel_project`: the float64 dense product
    of the band's rows (``core.mel.apply_mel``) and each frame's (min,
    max) over its mel values, NaN-propagating, as (2, 1, B, T)."""
    mel = apply_mel(psd, spans.rows)
    return mel, row_partials(mel)


def _mel_project_cuda(psd, spans):
    lib = _library()
    if psd.device.type != "cuda":
        raise ValueError(f"the mel kernel takes CUDA tensors, got "
                         f"{psd.device}")
    if psd.dtype != torch.float32 or not psd.is_contiguous():
        raise TypeError("the mel kernel takes a contiguous float32 PSD")
    B, T, F = psd.shape
    M = spans.rows.shape[0]
    if spans.rows.shape[1] != F or spans.start.device != psd.device:
        raise ValueError(f"mel spans of {spans.rows.shape[1]} bins on "
                         f"{spans.start.device} for a PSD of {F} bins on "
                         f"{psd.device}")
    mel = torch.empty((B, T, M), dtype=torch.float32, device=psd.device)
    parts = torch.empty((2, 1, B, T), dtype=torch.float32, device=psd.device)
    if B * T:
        with torch.cuda.device(psd.device):
            err = lib.mel_project_launch(
                psd.data_ptr(), spans.start.data_ptr(),
                spans.length.data_ptr(), spans.offset.data_ptr(),
                spans.weights.data_ptr(), B * T, F, M, mel.data_ptr(),
                parts[0].data_ptr(), parts[1].data_ptr(),
                torch.cuda.current_stream(psd.device).cuda_stream)
        if err != 0:
            raise RuntimeError("mel kernel launch failed: "
                               + lib.mel_error_string(err).decode())
        launches["mel"] += 1
    return mel, parts


def _mel_forward(psd, spans):
    if psd.device.type == "cpu":
        return mel_project_reference(psd, spans)
    return _mel_project_cuda(psd, spans)


def mel_backward_reference(dmel: torch.Tensor, spans: MelSpans
                           ) -> torch.Tensor:
    """The plain version of the mel backward kernel: the gradient of the
    PSD (B, T, F) from the mel rows' (B, T, M), the float64 dense product
    dmel fb with the band's rows, rounded once to dmel's dtype."""
    return torch.matmul(dmel.double(), spans.rows).to(dmel.dtype)


def _mel_backward_cuda(dmel, spans):
    lib = _library()
    dmel = dmel.contiguous()
    if dmel.dtype != torch.float32:
        raise TypeError("the mel backward kernel takes a float32 gradient")
    B, T, M = dmel.shape
    M_rows, F = spans.rows.shape
    if M_rows != M or spans.bin_row.device != dmel.device:
        raise ValueError(f"mel spans of {M_rows} rows on "
                         f"{spans.bin_row.device} for a gradient of {M} "
                         f"rows on {dmel.device}")
    dpsd = torch.empty((B, T, F), dtype=torch.float32, device=dmel.device)
    if B * T:
        with torch.cuda.device(dmel.device):
            err = lib.mel_backward_launch(
                dmel.data_ptr(), spans.bin_start.data_ptr(),
                spans.bin_count.data_ptr(), spans.bin_row.data_ptr(),
                spans.bin_weight.data_ptr(), B * T, F, M, dpsd.data_ptr(),
                torch.cuda.current_stream(dmel.device).cuda_stream)
        if err != 0:
            raise RuntimeError("mel backward kernel launch failed: "
                               + lib.mel_error_string(err).decode())
        grad_launches["mel_backward"] += 1
    return dpsd


def mel_backward(dmel: torch.Tensor, spans: MelSpans) -> torch.Tensor:
    """The gradient of the PSD from the mel rows' gradient dmel (B, T, M):
    one launch of the mel backward kernel for a CUDA tensor, the plain
    version (:func:`mel_backward_reference`) for a CPU tensor."""
    if dmel.device.type == "cpu":
        return mel_backward_reference(dmel, spans)
    return _mel_backward_cuda(dmel, spans)


class _MelGrad(torch.autograd.Function):
    """The mel rows as a differentiable function of the PSD; the partials
    carry no gradient."""

    @staticmethod
    def forward(ctx, psd, spans):
        ctx.spans = spans
        mel, parts = _mel_forward(psd, spans)
        ctx.mark_non_differentiable(parts)
        return mel, parts

    @staticmethod
    def backward(ctx, dmel, _):
        return mel_backward(dmel, ctx.spans), None


def mel_project(psd: torch.Tensor, spans: MelSpans
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mel band's rows of a frame-major PSD (B, T, F) float32: (B, T,
    M) float32 and each frame's (min, max) partials (2, 1, B, T), one
    kernel launch for a CUDA tensor (:func:`mel_spans` on the same
    device); see :func:`mel_project_reference`. A PSD that requires grad
    (with grad enabled) gives mel rows with a gradient (:class:`_MelGrad`)."""
    if psd.requires_grad and torch.is_grad_enabled():
        return _MelGrad.apply(psd, spans)
    return _mel_forward(psd, spans)
