"""The mel kernel's work mapping (csrc/mel.cu, mel_project_kernel, and
its chunked form for wide PSD rows, mel_chunked_kernel) transcribed in
numpy and held bit for bit, on the CPU, to the kernel model of
tests/test_torch_mel.py (a lane a mel row, the previous kernel's
mapping): the same outputs, NaN and inf included, whichever thread
computes what.

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

The chunked form (MC_*: tiles of 32 rows at every F, their bins through
shared memory in chunks of MC_CHUNK in ascending order, each sum carried
from chunk to chunk, the mel rows meeting a chunk paired and dealt to
the warps, each warp scanning its own rows for non-finite bins) is
modelled the same way (``chunk_model``) at F 513, 1025, 4097 and 8193.
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
    """The tile of whole rows: 32 rows up to where two tiles of F floats a
    row fill the block's shared memory (path 12's 513 bins with 600 mels
    included), the regions apart and 16-byte aligned, the strides odd;
    fewer than MP_MIN_ROWS = 16 rows (the previous launcher's halving,
    which the tools' parent form keeps) only where the launcher now takes
    the chunked form."""
    assert tile_rows(F, M) == rows
    assert chunk_form(F, M) == ((True, MC_ROWS) if rows < MP_MIN_ROWS
                                else (False, rows))
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


# ---------------------------------------------------------------------------
# the chunked form (mel_chunked_kernel): wide PSD rows
# ---------------------------------------------------------------------------

MC_CHUNK = _constant("MC_CHUNK")
MC_THREADS, MC_ROWS = _constant("MC_THREADS"), _constant("MC_ROWS")
MC_WARPS = MC_THREADS // 32
MC_CHAINS = _constant("MC_CHAINS")


def mel_chunk_smem(rows, M):
    """mel.cu::mel_chunk_smem: the two chunk buffers, the sums, the warps'
    weight slots, the span table, and the total."""
    acc = 2 * _align16(rows * (MC_CHUNK | 1) * 4)
    w = acc + _align16(8 * M * (rows | 1))
    table = w + 8 * MC_WARPS * MC_CHAINS * MC_CHUNK
    return dict(chunks=0, acc=acc, w=w, table=table,
                total=table + _align16(3 * M * 4))


MP_MIN_ROWS = _constant("MP_MIN_ROWS")


def chunk_form(F, M):
    """The launcher's choice: (True, rows) for the chunked form where a
    tile of whole rows would hold fewer than MP_MIN_ROWS rows (mel.cu's
    mel_chunked), its rows MC_ROWS halved while its layout passes the
    card's; else (False, rows), the tiles of whole rows, MP_ROWS
    halved down to MP_MIN_ROWS."""
    if mel_smem(MP_MIN_ROWS, F, M)["total"] <= SMEM_CAP:
        return False, max(MP_MIN_ROWS, tile_rows(F, M))
    rows = MC_ROWS
    while rows > 1 and mel_chunk_smem(rows, M)["total"] > SMEM_CAP:
        rows >>= 1
    return True, rows


def _banks_free64(words):
    """32 lanes' 8-byte accesses (word addresses, even): each half-warp's
    16 doubles on 32 distinct banks unless the same double."""
    return all(_banks_free([a + h for a in words[half:half + 16]
                            for h in (0, 1)])
               for half in (0, 16))


def chunk_model(psd, fb, rows=None, check_banks=True):
    """mel.cu's chunked form in numpy: a persistent block's tiles of
    ``rows`` PSD rows (the launcher's rule by default), walked chunk by
    chunk of MC_CHUNK bins in ascending order; in each chunk warp w scans
    its rows w, w + MC_WARPS for non-finite bins (a ballot of 32 bins: the
    lowest and highest set bit), the mel rows whose span meets the chunk
    are listed in order and paired, pair p to warp p mod MC_WARPS, which
    stages the pair's weights of the chunk in its slot, loads each sum
    (0.0 where the chunk holds the span's first bin), runs the chains over
    the chunk's bins of the span and stores the sums; after the last chunk
    the warp of each row stores it with the NaN rule and folds its
    partials. The arithmetic of _kernel_model (a product and a sum a
    step), so the bits are that model's if the walk is right."""
    start, length, offset, weights = mel_cuda.span_table(fb)
    F = psd.shape[-1]
    M = len(fb)
    src = psd.reshape(-1, F)
    R = len(src)
    rows = rows or chunk_form(F, M)[1]
    Cs, As = MC_CHUNK | 1, rows | 1
    n_chunks = -(-F // MC_CHUNK)
    n_tiles = -(-R // rows)
    out = np.full((R, M), np.nan, np.float32)
    pmin = np.full(R, np.nan, np.float32)
    pmax = np.full(R, np.nan, np.float32)
    visits = np.zeros(n_tiles, int)
    lanes = np.arange(32)
    for block in range(min(n_tiles, SMS)):
        acc = np.full(M * As, -7.0)          # the block's sums, stale
        for tile in range(block, n_tiles, min(n_tiles, SMS)):
            visits[tile] += 1
            r0 = tile * rows
            n = min(rows, R - r0)
            bad0 = np.full(rows, F)
            bad1 = np.full(rows, -1)
            summed = np.zeros((M, F), int)   # each (mel row, bin) once
            for j in range(n_chunks):
                c0, c1 = j * MC_CHUNK, min(F, (j + 1) * MC_CHUNK)
                x = np.full(rows * Cs, np.float32(-7.0), np.float32)
                for lane in range(n):
                    x[lane * Cs:lane * Cs + c1 - c0] = src[r0 + lane, c0:c1]
                for w in range(MC_WARPS):
                    for lane_row in range(w, n, MC_WARPS):
                        for k0 in range(0, c1 - c0, 32):
                            k = k0 + lanes
                            vals = x[lane_row * Cs + np.minimum(k, c1 - c0
                                                                - 1)]
                            bits = (k < c1 - c0) & ~np.isfinite(vals)
                            if bits.any():
                                set_ = np.flatnonzero(bits)
                                bad0[lane_row] = min(bad0[lane_row],
                                                     c0 + k0 + set_[0])
                                bad1[lane_row] = max(bad1[lane_row],
                                                     c0 + k0 + set_[-1])
                        if check_banks:
                            for k0 in range(0, c1 - c0, 32):
                                assert _banks_free([
                                    lane_row * Cs + k for k in
                                    range(k0, min(c1 - c0, k0 + 32))])
                meets = [m for m in range(M) if length[m] > 0
                         and start[m] < c1 and start[m] + length[m] > c0]
                pairs = [meets[i:i + MC_CHAINS]
                         for i in range(0, len(meets), MC_CHAINS)]
                for p, pair in enumerate(pairs):
                    warp = p % MC_WARPS          # the warp that takes it
                    assert 0 <= warp < MC_WARPS
                    slot = np.full(MC_CHAINS * MC_CHUNK, np.nan)
                    segs = []
                    for c, m in enumerate(pair):
                        s = start[m]
                        k0 = max(0, c0 - s)
                        kn = min(length[m], c1 - s) - k0
                        assert 0 < kn <= MC_CHUNK
                        slot[c * MC_CHUNK:c * MC_CHUNK + kn] = \
                            weights[offset[m] + k0:offset[m] + k0 + kn]
                        segs.append((m, k0, kn, s + k0 - c0))
                    for m, k0, kn, b in segs:
                        summed[m, c0 + b + np.arange(kn)] += 1
                        lane_ix = np.arange(n)
                        a = (acc[m * As + lane_ix].copy() if k0 > 0
                             else np.zeros(n))
                        c = segs.index((m, k0, kn, b))
                        if check_banks:
                            assert _banks_free64([2 * (m * As + lane)
                                                  for lane in range(n)])
                            for k in range(kn):
                                assert _banks_free([lane * Cs + b + k
                                                    for lane in range(n)])
                        with np.errstate(invalid="ignore"):
                            for k in range(kn):
                                a = slot[c * MC_CHUNK + k] * np.float64(
                                    x[lane_ix * Cs + b + k]) + a
                        acc[m * As + lane_ix] = a
            # every span summed once, over its own bins only
            want_cover = np.zeros((M, F), int)
            for m in range(M):
                want_cover[m, start[m]:start[m] + length[m]] = 1
            assert np.array_equal(summed, want_cover)
            for w in range(MC_WARPS):
                for l in range(w, n, MC_WARPS):
                    if check_banks:
                        assert _banks_free64([2 * (m * As + l)
                                              for m in range(min(M, 32))])
                    lo = [np.float32(np.inf)] * 32
                    hi = [np.float32(-np.inf)] * 32
                    for j in range(32):
                        for m in range(j, M, 32):
                            s, k1 = start[m], length[m]
                            a = acc[m * As + l] if k1 > 0 else 0.0
                            if bad0[l] < s or bad1[l] >= s + k1:
                                a = np.nan
                            v = np.float32(a)
                            out[r0 + l, m] = v
                            lo[j] = _nan_min(lo[j], v)
                            hi[j] = _nan_max(hi[j], v)
                    pmin[r0 + l] = _butterfly(lo, _nan_min)
                    pmax[r0 + l] = _butterfly(hi, _nan_max)
    assert (visits == 1).all()
    mel = out.reshape(psd.shape[:-1] + (M,))
    parts = np.stack([pmin, pmax]).reshape((2, 1) + psd.shape[:-1])
    return mel, parts


@pytest.mark.parametrize("F", [513, 1025, 4097, 8193])
def test_chunked_walk_is_the_span_sums_bit_for_bit(F):
    """The chunked form's walk at 128 mels over F bins (path 12's 513, and
    the widths where a tile of whole rows would hold 16 rows or fewer),
    on two tiles (the second ragged), the injected inf and NaN bins of
    test_torch_mel.py plus a NaN bin in the last chunk, an inf bin in a
    span across a chunk's edge and an inf bin past every span: the mel
    rows and the partials bit for bit those of the one-lane-a-mel-row
    model (the span sums of mel_project_reference's contract, NaN
    payloads included), and NaN and inf where the plain version's dense
    product has them."""
    fb = tmel.mel_filterbank(128, F, FS)
    psd = _psd(3, (2, 17), F)
    _inject(psd, fb)
    start, length, _, _ = mel_cuda.span_table(fb)
    edge = next(m for m in range(len(fb))
                if start[m] < MC_CHUNK < start[m] + length[m])
    psd[1, 9, F - 3] = np.nan
    psd[1, 10, MC_CHUNK] = np.inf               # in row `edge`'s span
    psd[1, 11, F - 1] = np.inf                  # past every span
    assert start[edge] + length[edge] <= F
    want, want_parts = _kernel_model(psd, fb)
    got, got_parts = chunk_model(psd, fb, rows=MC_ROWS,
                                 check_banks=F <= 1025)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(got_parts.view(np.int32),
                          want_parts.view(np.int32))
    plain, _ = mel_cuda.mel_project_reference(torch.from_numpy(psd),
                                              mel_cuda.mel_spans(fb, "cpu"))
    plain = plain.numpy()
    assert np.array_equal(np.isnan(got), np.isnan(plain))
    assert np.array_equal(np.isinf(got), np.isinf(plain))
    assert np.isinf(got[1, 10, edge]) and np.isnan(got[1, 11]).all()


def test_chunked_walk_on_narrow_tiles_and_odd_filterbanks():
    """Tiles of 8 rows (the launcher's rows where many mel rows' sums
    pass the card's shared memory), 600 mels over 1025 bins (rows with no
    weight), and a band of the mel rows: the same bits as the
    one-lane-a-mel-row model."""
    for fb, rows in ((tmel.mel_filterbank(600, 1025, FS), 8),
                     (tmel.mel_filterbank(40, 2049, FS)[5:33], MC_ROWS)):
        psd = _psd(4, (3, 7), fb.shape[1])
        _inject(psd, fb)
        want, want_parts = _kernel_model(psd, fb)
        got, got_parts = chunk_model(psd, fb, rows=rows, check_banks=False)
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
        assert np.array_equal(got_parts.view(np.int32),
                              want_parts.view(np.int32))


@pytest.mark.parametrize("F,M,chunked,rows", [
    (513, 128, False, 32), (513, 600, False, 32), (1025, 128, False, 16),
    (1025, 64, False, 16), (1537, 64, False, 16), (1537, 128, False, 16),
    (1609, 128, False, 16), (1611, 128, True, 32), (2049, 128, True, 32),
    (4097, 64, True, 32), (8193, 128, True, 32), (8193, 600, True, 32),
    (8193, 2048, True, 8)])
def test_chunked_form_where_whole_rows_do_not_fit(F, M, chunked, rows):
    """The launcher takes the chunked form wherever tiles of whole rows
    would hold fewer than MP_MIN_ROWS = 16 rows (at 128 mels, F past
    1,609), with MC_ROWS rows while its sums fit (the rule read from
    mel.cu's mel_chunked); its layout's regions apart and 16-byte aligned;
    two blocks an SM at 128 mels (MC_MIN_BLOCKS)."""
    with open(SOURCE, encoding="utf-8") as fh:
        rule = re.search(r"bool mel_chunked\(int F, int M, long long cap\) "
                         r"\{\n  return ([^;]+);", fh.read()).group(1)
    assert " ".join(rule.split()) == (
        "mel_smem(MP_MIN_ROWS, F, M).total > cap"), "chunk_form transcribes it"
    assert chunk_form(F, M) == (chunked, rows)
    if not chunked:
        assert mel_smem(rows, F, M)["total"] <= SMEM_CAP
        return
    lay = mel_chunk_smem(rows, M)
    assert lay["total"] <= SMEM_CAP
    keys = ["chunks", "acc", "w", "table"]
    for a, b in zip(keys, keys[1:]):
        assert lay[a] < lay[b] and lay[b] % 16 == 0
    if M == 128:
        assert 2 * (mel_chunk_smem(MC_ROWS, M)["total"] + 1024) <= 233472
        assert _constant("MC_MIN_BLOCKS") == 2
