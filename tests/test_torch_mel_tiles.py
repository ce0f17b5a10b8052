"""The mel kernel's work mapping (csrc/mel.cu, mel_project_kernel)
transcribed in numpy and held bit for bit, on the CPU, to the kernel
model of tests/test_torch_mel.py (a lane a mel row, the previous
kernel's mapping): the same outputs, NaN and inf included, whichever
thread computes what.

Modelled from the source's constants (MP_ROWS, MP_THREADS, MP_CHAINS,
MP_W_SMEM): a persistent grid walking tiles of ``rows`` PSD rows (the
launcher's rule: 32, halved while the block's shared memory would pass
the card's 227 KB), each tile copied into shared memory at the odd stride
Fs = F | 1 (one flat run when F is odd), each row's first and last
non-finite bin found by a warp, the mel rows summed with lane l on the
tile's row l (warp w the groups of MP_CHAINS consecutive mel rows w, w +
MP_WARPS, ...) into a staging tile of stride Ms = M | 1, and a warp a row
storing the row and folding its partials (lane j the values j, j + 32,
... from +-inf, then the xor butterfly, lane 0's). Every shared-memory
access pattern is checked free of bank conflicts, and the layout's
regions apart and 16-byte aligned.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spectral_tpu_torch.core import mel as tmel  # noqa: E402
from spectral_tpu_torch.ops import mel_cuda  # noqa: E402
from test_torch_mel import _inject, _kernel_model, _psd  # noqa: E402

FS = 16000.0
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "spectral_tpu_torch", "ops", "csrc", "mel.cu")
SMEM_CAP = 232448          # an H100 block's shared memory, opted in
SMS = 3                    # the model's SMs (any count walks every tile)


def _constant(name):
    """A constexpr int of the source: digits and products of digits."""
    with open(SOURCE, encoding="utf-8") as fh:
        expr = re.search(rf"constexpr int {name} = ([\d *]+);",
                         fh.read()).group(1)
    value = 1
    for factor in expr.split("*"):
        value *= int(factor)
    return value


MP_ROWS, MP_THREADS = _constant("MP_ROWS"), _constant("MP_THREADS")
MP_W_SMEM = _constant("MP_W_SMEM")
MP_WARPS = MP_THREADS // 32
MP_CHAINS = _constant("MP_CHAINS")


def _align16(n):
    return (n + 15) & ~15


def mel_smem(rows, F, M):
    """mel.cu::mel_smem: the offsets of the weights, the two tiles (each
    16-byte aligned), the staging tile, the span table and the non-finite
    bins, and the total."""
    tiles = MP_W_SMEM
    out = tiles + 2 * _align16(rows * (F | 1) * 4)
    table = out + _align16(rows * (M | 1) * 4)
    bad = table + _align16(3 * M * 4)
    return dict(w=0, tiles=tiles, out=out, table=table, bad=bad,
                total=bad + 2 * rows * 4)


def tile_rows(F, M):
    """The launcher's rule."""
    rows = MP_ROWS
    while rows > 1 and mel_smem(rows, F, M)["total"] > SMEM_CAP:
        rows >>= 1
    return rows


def _nan_min(a, b):
    return a if (a != a or a < b) else b


def _nan_max(a, b):
    return a if (a != a or a > b) else b


def _butterfly(vals, op):
    """A warp's xor butterfly (offsets 16 .. 1); lane 0's result."""
    v = list(vals)
    for d in (16, 8, 4, 2, 1):
        v = [op(v[j], v[j ^ d]) for j in range(32)]
    return v[0]


def _banks_free(addresses):
    """32 lanes' 4-byte word addresses: no two on one bank unless they are
    the same word."""
    seen = {}
    for a in addresses:
        if seen.setdefault(a % 32, a) != a:
            return False
    return True


def tile_model(psd, fb, check_banks=True):
    """mel.cu's mapping in numpy: mel (.., M) float32 and partials (2, 1,
    ..) as the kernel computes them, its arithmetic that of _kernel_model
    (a product and a sum a step, not fused, as that model takes them)."""
    start, length, offset, weights = mel_cuda.span_table(fb)
    F = psd.shape[-1]
    M = len(fb)
    src = psd.reshape(-1, F)
    R = len(src)
    rows = tile_rows(F, M)
    Fs, Ms = F | 1, M | 1
    wts = weights       # staged in shared memory or not, the same values
    n_tiles = -(-R // rows)
    out = np.full((R, M), np.nan, np.float32)
    pmin = np.full(R, np.nan, np.float32)
    pmax = np.full(R, np.nan, np.float32)
    visits = np.zeros(n_tiles, int)
    for block in range(min(n_tiles, SMS)):
        for tile in range(block, n_tiles, min(n_tiles, SMS)):
            visits[tile] += 1
            r0 = tile * rows
            n = min(rows, R - r0)
            x = np.full(rows * Fs, np.float32(-7.0), np.float32)
            if F & 1:                      # one flat run
                x[:n * F] = src[r0:r0 + n].reshape(-1)
            else:
                for lane in range(n):
                    x[lane * Fs:lane * Fs + F] = src[r0 + lane]
            first, last = np.full(rows, F), np.full(rows, -1)
            for lane in range(n):
                lo, hi = [F] * 32, [-1] * 32
                for f in range(F):
                    if not np.isfinite(x[lane * Fs + f]):
                        lo[f % 32] = min(lo[f % 32], f)
                        hi[f % 32] = f
                first[lane] = _butterfly(lo, min)
                last[lane] = _butterfly(hi, max)
                if check_banks:
                    for p in range(-(-F // 32)):
                        assert _banks_free([lane * Fs + f for f in
                                            range(32 * p, min(F, 32 * p + 32))])
            o = np.full(rows * Ms, np.float32(-7.0), np.float32)
            groups = [range(m0, min(M, m0 + MP_CHAINS))
                      for w in range(MP_WARPS)
                      for m0 in range(w * MP_CHAINS, M, MP_WARPS * MP_CHAINS)]
            assert sorted(m for g in groups for m in g) == list(range(M))
            for m in (m for g in groups for m in g):
                if True:
                    s, k1 = start[m], length[m]
                    if check_banks:
                        for k in range(k1):
                            assert _banks_free([lane * Fs + s + k
                                                for lane in range(n)])
                        assert _banks_free([lane * Ms + m
                                            for lane in range(n)])
                    for lane in range(n):
                        acc = 0.0
                        with np.errstate(invalid="ignore"):
                            for k in range(k1):
                                acc = wts[offset[m] + k] * np.float64(
                                    x[lane * Fs + s + k]) + acc
                        if first[lane] < s or last[lane] >= s + k1:
                            acc = np.nan
                        o[lane * Ms + m] = acc
            for w in range(MP_WARPS):
                for lane_row in range(w, n, MP_WARPS):
                    lo = [np.float32(np.inf)] * 32
                    hi = [np.float32(-np.inf)] * 32
                    for j in range(32):
                        for m in range(j, M, 32):
                            v = o[lane_row * Ms + m]
                            out[r0 + lane_row, m] = v
                            lo[j] = _nan_min(lo[j], v)
                            hi[j] = _nan_max(hi[j], v)
                    pmin[r0 + lane_row] = _butterfly(lo, _nan_min)
                    pmax[r0 + lane_row] = _butterfly(hi, _nan_max)
    assert (visits == 1).all()
    mel = out.reshape(psd.shape[:-1] + (M,))
    parts = np.stack([pmin, pmax]).reshape((2, 1) + psd.shape[:-1])
    return mel, parts


@pytest.mark.parametrize("n_mels,F,band", [(128, 513, None), (40, 257, (5, 33)),
                                           (600, 513, None), (8, 129, (2, 7))])
def test_tile_mapping_is_the_previous_mapping_bit_for_bit(n_mels, F, band):
    """The cases of test_torch_mel.py's kernel model, its PSDs with their
    inf and NaN bins: the mel rows and the partials bit for bit."""
    fb = tmel.mel_filterbank(n_mels, F, FS)
    if band is not None:
        fb = fb[band[0]:band[1]]
    psd = _psd(2, (2, 5), F)
    _inject(psd, fb)
    want, want_parts = _kernel_model(psd, fb)
    got, got_parts = tile_model(psd, fb)
    assert got.shape == want.shape and got_parts.shape == want_parts.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(got_parts.view(np.int32),
                          want_parts.view(np.int32))


def test_ragged_tiles_and_even_bins():
    """More rows than a tile, a ragged last tile, an even F (the padded
    stride): still the previous mapping's bits."""
    fb = tmel.mel_filterbank(24, 130, FS)
    psd = _psd(3, (3, 23), 130)
    _inject(psd, fb)
    want, want_parts = _kernel_model(psd, fb)
    got, got_parts = tile_model(psd, fb, check_banks=False)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(got_parts.view(np.int32),
                          want_parts.view(np.int32))


@pytest.mark.parametrize("F,M,rows", [(513, 128, 32), (513, 600, 32),
                                      (257, 40, 32), (1025, 128, 16),
                                      (2049, 128, 8), (4097, 64, 4),
                                      (8192, 64, 2)])
def test_tile_rows_and_layout(F, M, rows):
    """The launcher's tile: 32 rows up to where two tiles of F floats a row
    fill the block's shared memory (path 12's 513 bins with 600 mels
    included), the regions apart and 16-byte aligned, the strides odd."""
    assert tile_rows(F, M) == rows
    lay = mel_smem(rows, F, M)
    assert lay["total"] <= SMEM_CAP
    keys = ["w", "tiles", "out", "table", "bad"]
    for a, b in zip(keys, keys[1:]):
        assert lay[a] < lay[b] and lay[b] % 16 == 0
    assert lay["tiles"] - lay["w"] == MP_W_SMEM
    assert (F | 1) % 2 == 1 and (M | 1) % 2 == 1


def test_weights_staged_at_path_12():
    """Path 12's 128 mels over 513 bins: 1,009 weights, 8 KB, staged in
    shared memory (the kernel reads the packed length as the last span's
    end)."""
    fb = tmel.mel_filterbank(128, 513, FS)
    start, length, offset, weights = mel_cuda.span_table(fb)
    n_w = int(offset[-1] + length[-1])
    assert n_w == len(weights) == 1009 and n_w * 8 <= MP_W_SMEM
