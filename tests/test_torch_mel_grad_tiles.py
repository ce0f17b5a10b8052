"""The mel backward kernel's work mapping (csrc/mel.cu, mel_backward_kernel)
transcribed in numpy and held on the CPU to the previous kernel's loop (a
warp a gradient row, lane l the bins l, l + 32, ..., each bin's rows from
``ops/mel_cuda.py::bin_table``): every output the same terms in the same
order, the same value bit for bit and the same NaN, whichever thread
computes what; and the port's plain backward held to the JAX package.

Modelled from the source's constants (MB_ROWS, MB_THREADS, MB_OUT_SMEM): the launcher's rule for the tile's rows (32, halved while
the block's shared memory would pass the card's 227 KB) and the chunk of
bins whose outputs are staged; the table as the kernel reads it
(:func:`mel_cuda.bin_records`: C 16-byte slots a bin, its covering rows
in order, then empty slots of row -1); a persistent grid walking tiles,
each tile turned into doubles at stride M | 1 and its rows' non-finite
gradients counted, warp w the w-th run of consecutive bins of the chunk,
lane l the tile's row l walking each bin's slots in order. Shared-memory
reads and writes are checked free of bank conflicts.

Tolerances:
- the walk against the previous loop: the terms of every output equal,
  the value bitwise (both models round each product and sum alike: the
  card's FMA is the same in both kernels), NaN in the same places;
- the walk against the plain version (``mel_backward_reference``, the
  float64 dense product): within chip_smoke.py's MEL_ULPS = 1 float32 ulp
  (numpy rounds the product before the sum where the card fuses them),
  NaN in the same places;
- the plain version against ``jax.vjp`` of the JAX package's mel einsum
  (spectral_tpu/parallel/sharding.py:99-103, float32 at HIGHEST
  precision): 1e-6 of the largest |gradient|, NaN and inf in the same
  places.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectral_tpu_torch.core import mel as tmel  # noqa: E402
from spectral_tpu_torch.ops import mel_cuda  # noqa: E402

FS = 16000.0
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "spectral_tpu_torch", "ops", "csrc", "mel.cu")
SMEM_CAP = 232448          # an H100 block's shared memory, opted in
SMS = 3                    # the model's SMs (any count walks every tile)
JAX_TOL = 1e-6


def _constant(name):
    """A constexpr int of the source: digits and products of digits."""
    with open(SOURCE, encoding="utf-8") as fh:
        expr = re.search(rf"constexpr int {name} = ([\d *]+);",
                         fh.read()).group(1)
    value = 1
    for factor in expr.split("*"):
        value *= int(factor)
    return value


MB_ROWS, MB_THREADS = _constant("MB_ROWS"), _constant("MB_THREADS")
MB_OUT_SMEM = _constant("MB_OUT_SMEM")
MB_WARPS = MB_THREADS // 32

# (n_mels, bins, mel band rows or None): 128, 64 and 40 mels; a band (bins
# below and above it covered by no row); a fmin that leaves the low bins
# uncovered; 4097 bins, the outputs in chunks
CASES = [(128, 513, None), (64, 513, None), (40, 257, None),
         (128, 513, (10, 100)), (40, 257, (5, 33)), (600, 513, None),
         (64, 4097, None)]


def _align16(n):
    return (n + 15) & ~15


def grad_smem(rows, M, fc):
    """mel.cu::mel_grad_smem's total: two tiles of floats, a tile of
    doubles, two output buffers, the counts."""
    xd = 2 * _align16(rows * M * 4)
    out = xd + _align16(rows * (M | 1) * 8)
    bad = out + 2 * _align16(rows * (fc | 1) * 4)
    return bad + 4 * rows


def grad_chunk(rows, F):
    return min(F, MB_OUT_SMEM // (4 * rows) - 1)


def grad_layout(F, M):
    """The launcher's rule: (rows, chunk of bins)."""
    rows = MB_ROWS
    while rows > 1 and grad_smem(rows, M, grad_chunk(rows, F)) > SMEM_CAP:
        rows >>= 1
    fc = grad_chunk(rows, F)
    assert grad_smem(rows, M, fc) <= SMEM_CAP
    return rows, fc


def decode(records):
    """(weight float64, row) of the kernel's slots."""
    rec = np.ascontiguousarray(records, np.int32)
    return rec[:, 0:2].copy().view(np.float64)[:, 0], rec[:, 2]


def _banks_free(addresses):
    """32 lanes' 4-byte word addresses: no two on one bank unless they are
    the same word."""
    seen = {}
    for a in addresses:
        if seen.setdefault(a % 32, a) != a:
            return False
    return True


def parent_model(dmel, fb):
    """The previous kernel's loop: for each row and bin, bin_table's rows
    of the bin in order, acc = w * v + acc from 0.0, NaN when the row holds
    more non-finite gradients than the bin's rows do. Returns (dpsd
    float32, {(r, f): terms})."""
    start, count, brow, bw = mel_cuda.bin_table(fb)
    R, F = len(dmel), fb.shape[1]
    out = np.empty((R, F), np.float32)
    terms = {}
    for r in range(R):
        row = dmel[r]
        bad = int((~np.isfinite(row)).sum())
        for f in range(F):
            acc, inside, seq = 0.0, 0, []
            for e in range(start[f], start[f] + count[f]):
                v = np.float64(row[brow[e]])
                inside += not np.isfinite(v)
                seq.append((int(brow[e]), float(bw[e])))
                with np.errstate(invalid="ignore", over="ignore"):
                    acc = bw[e] * v + acc
            if inside < bad:
                acc = np.nan
            out[r, f] = acc
            terms[r, f] = tuple(seq)
    return out, terms


def tile_model(dmel, fb, check_banks=True):
    """mel_backward_kernel's mapping in numpy: (dpsd float32, {(r, f):
    terms}) as the kernel computes them, each term (mel row, weight) in
    the order the lane meets it."""
    records, C = mel_cuda.bin_records(fb)
    w, row_of = decode(records)
    R, M = dmel.shape
    F = fb.shape[1]
    rows, fc = grad_layout(F, M)
    Ms, Os = M | 1, fc | 1
    n_tiles = -(-R // rows)
    out = np.full((R, F), np.float32(-7.0), np.float32)
    written = np.zeros((R, F), int)
    terms = {}
    visits = np.zeros(n_tiles, int)
    grid = min(n_tiles, SMS)
    for block in range(grid):
        for tile in range(block, n_tiles, grid):
            visits[tile] += 1
            r0 = tile * rows
            n = min(rows, R - r0)
            xf = dmel[r0:r0 + n].reshape(-1)       # the copy, contiguous
            xd = np.full(rows * Ms, -7.0)
            bad = []
            for lane in range(n):                  # doubles at stride Ms
                xd[lane * Ms:lane * Ms + M] = xf[lane * M:(lane + 1) * M]
                bad.append(int((~np.isfinite(xf[lane * M:(lane + 1) * M]))
                               .sum()))
            for f0 in range(0, F, fc):
                nf = min(fc, F - f0)
                o = np.full(rows * Os, np.float32(-7.0), np.float32)
                covered = []
                for warp in range(MB_WARPS):
                    fa = f0 + warp * nf // MB_WARPS
                    fb_ = f0 + (warp + 1) * nf // MB_WARPS
                    covered += list(range(fa, fb_))
                    for f in range(fa, fb_):
                        if check_banks:
                            assert _banks_free([lane * Os + f - f0
                                                for lane in range(n)])
                        for c in range(C):
                            r = int(row_of[f * C + c])
                            if check_banks and r >= 0:
                                # 8-byte words: each half-warp's 16 lanes
                                for half in (range(0, min(n, 16)),
                                             range(16, n)):
                                    assert _banks_free([
                                        2 * (lane * Ms + r) + k
                                        for lane in half for k in (0, 1)])
                        for lane in range(n):
                            acc, inside, seq = 0.0, 0, []
                            for c in range(C):
                                r = int(row_of[f * C + c])
                                if r < 0:
                                    continue
                                v = xd[lane * Ms + r]
                                inside += not np.isfinite(v)
                                seq.append((r, float(w[f * C + c])))
                                with np.errstate(invalid="ignore",
                                                 over="ignore"):
                                    acc = w[f * C + c] * v + acc
                            if inside < bad[lane]:
                                acc = np.nan
                            o[lane * Os + (f - f0)] = acc
                            terms[r0 + lane, f] = tuple(seq)
                assert covered == list(range(f0, f0 + nf))
                for lane in range(n):            # the store of the chunk
                    out[r0 + lane, f0:f0 + nf] = o[lane * Os:lane * Os + nf]
                    written[r0 + lane, f0:f0 + nf] += 1
    assert (visits == 1).all() and (written == 1).all()
    return out, terms


def _dmel(seed, R, M):
    """A seeded gradient with an inf, a -inf and a NaN, and a row holding
    two of them."""
    g = np.random.RandomState(seed).randn(R, M).astype(np.float32)
    g[1, M // 3] = np.inf
    g[R - 2, M - 1] = -np.inf
    g[R // 2, 0] = np.nan
    g[R // 2, M // 2] = np.inf
    return g


def _filterbank(n_mels, F, band):
    fb = tmel.mel_filterbank(n_mels, F, FS)
    return fb[band[0]:band[1]] if band else fb


def _ulps(a, b):
    def ordered(t):
        i = t.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    ok = np.isfinite(a) & np.isfinite(b)
    return int(np.abs(ordered(a) - ordered(b))[ok].max()) if ok.any() else 0


@pytest.mark.parametrize("n_mels,F,band", CASES)
def test_bin_records_are_bin_table(n_mels, F, band):
    """The kernel's table holds bin_table's rows and weights, bin by bin in
    its order, the weights' float64 bits exact, then empty slots (row -1,
    weight 0); C the most rows a bin has, 2 on these filterbanks."""
    fb = _filterbank(n_mels, F, band)
    start, count, row, weight = mel_cuda.bin_table(fb)
    records, C = mel_cuda.bin_records(fb)
    w, r = decode(records)
    assert C == max(1, int(count.max())) == 2
    assert records.shape == (F * C, 4)
    for f in range(F):
        c = int(count[f])
        got = slice(f * C, f * C + c)
        want = slice(start[f], start[f] + c)
        assert r[got].tolist() == row[want].tolist()
        assert np.array_equal(w[got].view(np.int64),
                              weight[want].view(np.int64))
        assert r[f * C + c:(f + 1) * C].tolist() == [-1] * (C - c)
        assert w[f * C + c:(f + 1) * C].tolist() == [0.0] * (C - c)
    if band is not None:
        assert (count == 0).any()          # bins past the band's rows
    spans = mel_cuda.mel_spans(fb, "cpu")
    assert torch.equal(spans.bin_records, torch.from_numpy(records))
    assert spans.bin_slots == C


@pytest.mark.parametrize("n_mels,F,band,R", [
    (128, 513, None, 70), (64, 513, None, 33), (40, 257, None, 97),
    (128, 513, (10, 100), 40), (40, 257, (5, 33), 64), (600, 513, None, 9),
    (64, 4097, None, 5)])
def test_tile_mapping_is_the_previous_loop(n_mels, F, band, R):
    """Every output of the tile walk has the previous loop's terms in its
    order, its value bit for bit and its NaN; R not a multiple of the
    tile, inf, -inf and NaN gradients, bins no row covers."""
    fb = _filterbank(n_mels, F, band)
    dmel = _dmel(R + n_mels, R, len(fb))
    want, want_terms = parent_model(dmel, fb)
    got, got_terms = tile_model(dmel, fb)
    assert got_terms == want_terms
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    plain = mel_cuda.mel_backward_reference(torch.from_numpy(dmel[None]),
                                            mel_cuda.mel_spans(fb, "cpu")
                                            )[0].numpy()
    assert np.array_equal(np.isnan(got), np.isnan(plain))
    assert np.array_equal(np.isinf(got), np.isinf(plain))
    assert _ulps(got, plain) <= 1


@pytest.mark.parametrize("n_mels,F,want", [
    (128, 513, (32, 513)), (40, 257, (32, 257)), (64, 4097, (32, 767)),
    (600, 513, (16, 513))])
def test_launch_layout(n_mels, F, want):
    """Path 21's 128 mels over 513 bins take tiles of 32 rows and one chunk
    of all 513 bins (a contiguous run, to the bulk copy engine), one block
    an SM; 4097 bins chunks of 767 bins; 600 mels halve the tile."""
    rows, fc = grad_layout(F, n_mels)
    assert (rows, fc) == want
    if (n_mels, F) == (128, 513):
        assert 2 * grad_smem(rows, n_mels, fc) > SMEM_CAP


def test_the_prototype_is_the_sources():
    """The ctypes prototype of mel_backward_launch has the C entry's
    parameters: pointers, 32-bit ints and the 64-bit row count."""
    import ctypes
    with open(SOURCE, encoding="utf-8") as fh:
        src = fh.read()
    body = src[src.index("int mel_backward_launch("):]
    params = [p.strip() for p in
              body[body.index("(") + 1:body.index(")")].split(",")]

    class Lib:
        def __getattr__(self, name):
            entry = type("Entry", (), {})()
            setattr(self, name, entry)
            return entry

    from spectral_tpu_torch.ops import build
    saved = (build.load_library, mel_cuda._LIB[:])
    try:
        build.load_library = lambda name: Lib()
        mel_cuda._LIB[:] = []
        types = mel_cuda._library().mel_backward_launch.argtypes
    finally:
        build.load_library, mel_cuda._LIB[:] = saved[0], saved[1]
    assert len(types) == len(params)
    for p, t in zip(params, types):
        if "*" in p:
            assert t is ctypes.c_void_p, p
        elif p.startswith("long long"):
            assert t is ctypes.c_longlong, p
        else:
            assert p.startswith("int ") and t is ctypes.c_int, p


def _jax_mel_vjp(fb, psd, dmel, band):
    """jax.vjp of the JAX package's mel einsum (sharding.py:99-103) over a
    frame-major PSD (B, T, F): the gradient of the PSD from dmel (B, T,
    M)."""
    def mel(p):
        fm = jnp.swapaxes(p, -1, -2)
        out = jnp.einsum("mf,...ft->...mt", jnp.asarray(fb, fm.dtype), fm,
                         precision=jax.lax.Precision.HIGHEST)
        if band is not None:
            out = out[..., band[0]:band[1], :]
        return jnp.swapaxes(out, -1, -2)
    _, vjp = jax.vjp(mel, jnp.asarray(psd))
    return np.asarray(vjp(jnp.asarray(dmel))[0])


@pytest.mark.parametrize("n_mels,F,band", CASES)
def test_plain_backward_matches_jax_grad(n_mels, F, band):
    """The port's plain mel backward (the float64 dense product with the
    band's rows, rounded once) against JAX's float32 vjp: 1e-6 of the
    largest |gradient|, NaN and inf in the same places."""
    full = tmel.mel_filterbank(n_mels, F, FS)
    fb = full[band[0]:band[1]] if band else full
    B, T = 2, 5
    psd = np.random.RandomState(F).exponential(1e-3, (B, T, F)) \
        .astype(np.float32)
    dmel = _dmel(n_mels, B * T, len(fb)).reshape(B, T, len(fb))
    got = mel_cuda.mel_backward_reference(
        torch.from_numpy(dmel), mel_cuda.mel_spans(fb, "cpu")).numpy()
    want = _jax_mel_vjp(full, psd, dmel, band)
    assert got.shape == want.shape == (B, T, F)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(got)
    scale = np.abs(want[ok]).max()
    assert np.abs(got[ok] - want[ok]).max() <= JAX_TOL * scale
