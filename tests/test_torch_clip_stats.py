"""The display tail's two kernels, as far as the CPU can hold them
(spectral_tpu_torch.ops.display_cuda; csrc/display.cu runs only on the
card, where chip_smoke.py holds it to these plain versions):

- the plain clip_stats against the JAX package's flag, pmin and pmax, in
  both of its pipelines, on the clips that test the flag's rule: noise,
  NaN, inf, 1e-25 amplitude, silence, pure DC and 1e19 amplitude, at odd
  n, with and without constant detrend;
- the identity the kernel computes the detrended amplitude by,
  max |fl(x - m)| == max(fl(xmax - m), fl(m - xmin)) in float32;
- numpy transcriptions of the kernels' index maps: clip_stats's chunks,
  aligned head, body and tail and the partial rows' split; the display
  map's flat tile load, its swizzled shared-memory tile, the frames a lane
  owns, the four-frame palette word and the flips, held bitwise to
  display_map_reference at odd T and F, every access free of bank
  conflicts.

Tolerances: pmin and pmax within 5e-6 of the clip's PSD max (the JAX
side's float32 DFT against the port's float64); NaN and inf in the same
places; flags and every transcribed index and pixel exact.
"""

import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectral_tpu import config as jconfig  # noqa: E402
from spectral_tpu.ops import stft_pallas  # noqa: E402
from spectral_tpu.parallel import sharding as jsharding  # noqa: E402
from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.core.scale import normalize_with_denominator  # noqa: E402
from spectral_tpu_torch.ops import display_cuda, stft_cuda  # noqa: E402
from spectral_tpu_torch.ops.colormap import lut_index, packed_lut  # noqa: E402

FS = 16000.0
PSD_TOL = 5e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "spectral_tpu_torch", "ops", "csrc",
                      "display.cu")
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch_display_variants as tdv  # noqa: E402
NS_256 = SpecConfig.north_star(256, 64, log_scale=True)
SCIPY_256 = SpecConfig.scipy_default(256, log_scale=True)


def _source_constant(name):
    with open(SOURCE, encoding="utf-8") as fh:
        return int(re.search(rf"constexpr (?:int|long long) {name} = (\d+)",
                             fh.read()).group(1))


def _flag_clips(n):
    """The flag's cases, each a clip of n samples, and the flag the JAX
    package gives each."""
    rs = np.random.RandomState(4)
    nan = rs.randn(n)
    nan[n // 3] = np.nan
    inf = rs.randn(n)
    inf[n // 2] = np.inf
    clips = {"noise": (rs.randn(n), True), "nan": (nan, False),
             "inf": (inf, False), "tiny": (1e-25 * rs.randn(n), False),
             "silent": (np.zeros(n), True)}
    for dc in (0.25, 1e-4, 3e-3, 0.1):
        clips[f"dc {dc:g}"] = (np.full(n, dc), True)
    clips["loud"] = (1e19 * rs.randn(n), False)
    x = np.stack([c for c, _ in clips.values()]).astype(np.float32)
    return list(clips), x, [f for _, f in clips.values()]


def _port_stats(x, cfg, share_max=False):
    xt = torch.from_numpy(x)
    psd, parts = stft_cuda.stft_psd_partials(xt, FS, cfg)
    return psd, parts, display_cuda.clip_stats(xt, parts, share_max)


def _same_extrema(got, want, scale):
    got, want = got.numpy(), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    assert np.all(np.abs(got[ok] - want[ok]) <= PSD_TOL * scale[ok])


@pytest.mark.parametrize("cfg", [NS_256, SCIPY_256],
                         ids=["north_star_256_64", "scipy_256_constant"])
def test_plain_clip_stats_match_both_jax_pipelines(cfg):
    names, x, want = _flag_clips(4097)
    psd, _, stats = _port_stats(x, cfg)
    assert stats.finite.tolist() == want, names
    jcfg = jconfig.SpecConfig.from_json(cfg.to_json())
    for ref in (jsharding.batched_spectrogram_fn(FS, jcfg, use_matmul=True),
                stft_pallas.pallas_pipeline_fn(FS, jcfg)):
        assert np.asarray(jax.jit(ref)(jnp.asarray(x))["finite"]).tolist() \
            == want, names
    _, jmin, jmax = stft_pallas.stft_psd_pallas(jnp.asarray(x), FS, jcfg,
                                                with_stats=True)
    # each clip's largest finite bin
    scale = torch.where(torch.isfinite(psd), psd, 0.0).amax(dim=(1, 2))
    scale = scale.double().numpy()
    dc = np.array([name.startswith("dc") for name in names])
    if cfg.detrend == "constant":
        # detrended pure DC: both PSDs are rounding residue (float32's
        # about 1e-23, float64's below 1e-34 or exactly 0), held to a bound
        # far below the DC's own power, amplitude squared
        amp2 = x[dc, 0].astype(np.float64) ** 2
        for got in (stats.pmin.numpy()[dc], stats.pmax.numpy()[dc],
                    np.asarray(jmin)[dc], np.asarray(jmax)[dc]):
            assert np.all((got >= 0) & (got <= 1e-12 * amp2))
        keep = ~dc
    else:
        keep = np.ones(len(names), bool)
    _same_extrema(stats.pmin[keep], np.asarray(jmin)[keep], scale[keep])
    _same_extrema(stats.pmax[keep], np.asarray(jmax)[keep], scale[keep])
    # the extrema are the PSD's own, and the display operands carry them
    assert torch.equal(torch.isnan(stats.pmax),
                       torch.isnan(psd).any(dim=2).any(dim=1))
    p = stats.params
    assert p.shape == (len(names), 3) and p.dtype == torch.float32
    assert torch.equal(p[:, 1].isnan(), stats.pmin.isnan())
    ok = ~stats.pmin.isnan()
    assert torch.equal(p[ok, 1], stats.pmin[ok])
    assert torch.equal(p[:, 0][ok], (stats.pmax + 1e-20)[ok])


def test_pure_dc_stays_healthy_at_the_driven_configs():
    """10 s of pure DC at 16 kHz under constant detrend: the float64 mean
    is the sample, so the clip is healthy whatever its PSD (the card's
    float64 STFT kernels give exactly 0 there), as in the JAX package."""
    n = 160000
    x = np.stack([np.full(n, v, np.float32) for v in (1e-4, 3e-3, 0.1)])
    for k in (1024, 8160):
        cfg = SpecConfig.scipy_default(k, log_scale=True)
        T = 1 + (n - k) // cfg.hop_
        zero_psd = torch.zeros((2, 1, 3, T))
        stats = display_cuda.clip_stats(torch.from_numpy(x), zero_psd)
        assert stats.finite.tolist() == [True] * 3
        assert stats.pmax.tolist() == [0.0] * 3
    jcfg = jconfig.SpecConfig.from_json(
        SpecConfig.scipy_default(1024, log_scale=True).to_json())
    assert np.asarray(jax.jit(jsharding.batched_spectrogram_fn(
        FS, jcfg, use_matmul=True))(jnp.asarray(x))["finite"]).all()


def test_share_max_base_and_empty_shapes():
    _, x, _ = _flag_clips(1001)
    x = x[[0, 4, 5]]                                 # noise, silent, DC
    _, parts, own = _port_stats(x, NS_256)
    _, _, shared = _port_stats(x, NS_256, share_max=True)
    gm = torch.amax(own.pmax)
    assert torch.equal(shared.params[:, 0],
                       torch.where(gm > 0, gm, own.pmax) + 1e-20)
    assert torch.equal(shared.params[:, 1:], own.params[:, 1:])
    # a NaN max anywhere: every clip keeps its own base
    parts_nan = parts.clone()
    parts_nan[1, 0, 0, 3] = np.nan
    nan = display_cuda.clip_stats(torch.from_numpy(x), parts_nan, True)
    assert torch.isnan(nan.params[0, 0])
    assert torch.equal(nan.params[1:, 0], own.params[1:, 0])
    # T = 0: zero extrema; B = 0: empty results
    zero = display_cuda.clip_stats(torch.from_numpy(x[:, :100]),
                                   torch.zeros((2, 1, 3, 0)))
    assert zero.pmin.tolist() == zero.pmax.tolist() == [0.0] * 3
    assert zero.finite.tolist() == [True, True, True]
    empty = display_cuda.clip_stats(torch.zeros((0, 100)),
                                    torch.zeros((2, 1, 0, 5)))
    assert all(t.shape[0] == 0 for t in empty)


@pytest.mark.parametrize("seed", range(6))
def test_detrended_amplitude_from_the_extrema(seed):
    """max |fl(x - m)| == max(fl(xmax - m), fl(m - xmin)) in float32, with
    m the float64 mean rounded once, and with any m near the data."""
    rs = np.random.RandomState(seed)
    for scale in (1e-12, 1e-6, 1.0, 3e4, 1e30):
        for offset in (0.0, 1.0, -7.5e3):
            x = ((rs.randn(997) * scale) + offset * scale).astype(np.float32)
            x[rs.randint(0, 997, 5)] = x[0]           # repeated values
            ms = [np.float32(x.astype(np.float64).sum() / x.size),
                  x[rs.randint(997)], np.float32(x.max() * 1.5),
                  np.float32(rs.randn() * scale)]
            for m in ms:
                direct = np.abs(x - m).max()
                assert direct.dtype == np.float32
                ident = max(np.float32(x.max() - m), np.float32(m - x.min()))
                assert direct == ident, (scale, offset, m)


def _cs_items(n, T, chunk):
    """clip_stats's items for one clip: each chunk's samples as the head,
    body (float4) and tail it reads, and its share of the partial rows."""
    chunks = -(-n // chunk) if n > chunk else 1
    for c in range(chunks):
        s0 = c * chunk
        length = min(chunk, n - s0)
        yield c, chunks, s0, max(length, 0), T * c // chunks, \
            T * (c + 1) // chunks


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 16383, 16384, 16385, 160000,
                               160003, 960000])
@pytest.mark.parametrize("misalign", [0, 1, 2, 3])
def test_clip_stats_items_cover_every_sample_and_row_once(n, misalign):
    """The chunks' scalar head (up to the first 16-byte aligned sample),
    float4 body and scalar tail read every sample of the clip once, and
    the chunks' spans of partial rows cover every row once, for rows that
    start at any 4-byte offset (clip b of n samples starts at b*n)."""
    chunk = _source_constant("CS_CHUNK")
    threads = _source_constant("CS_THREADS")
    T = 622
    seen = np.zeros(n, int)
    rows = np.zeros(T, int)
    for c, chunks, s0, length, t0, t1 in _cs_items(n, T, chunk):
        addr = 4 * (misalign + s0)
        head = min(((16 - (addr & 15)) & 15) >> 2, length)
        body = (length - head) >> 2
        assert head <= 3 and head < threads
        seen[s0:s0 + head] += 1
        if body:
            assert (addr + 4 * head) % 16 == 0
        seen[s0 + head:s0 + head + 4 * body] += 1
        tail = length - head - 4 * body
        assert 0 <= tail <= 3
        seen[s0 + head + 4 * body:s0 + length] += 1
        rows[t0:t1] += 1
    assert np.all(seen == 1) and np.all(rows == 1)


# ---------------------------------------------------------------------------
# the display map's transcription
# ---------------------------------------------------------------------------

TT, TF, THREADS = 128, 32, 256


def swz(t):
    return (t & 28) | ((t & 3) ^ ((t >> 5) & 3))


def _umulhi(a, b):
    return (np.asarray(a, np.uint64) * np.uint64(b)) >> np.uint64(32)


def _tile_index(e, nf):
    """Frame and bin of the tile's flat element e, as the kernel derives
    them (shift, identity or the ceil(2^32 / nf) product)."""
    e = np.asarray(e, np.int64)
    if nf == TF:
        t = e >> 5
    elif nf == 1:
        t = e
    else:
        magic = (0xFFFFFFFF // nf + 1) & 0xFFFFFFFF
        t = _umulhi(e, magic).astype(np.int64)
    return t, e - t * nf


def test_source_geometry_and_tile_division():
    assert (_source_constant("DM_TT"), _source_constant("DM_TF"),
            _source_constant("DM_THREADS")) == (TT, TF, THREADS)
    e = np.arange(TT * TF)
    for nf in range(1, TF + 1):
        t, f = _tile_index(e, nf)
        assert np.array_equal(t, e // nf) and np.array_equal(f, e % nf)


@pytest.mark.parametrize("name", sorted(tdv.VARIANTS))
def test_display_variant_edits_match_the_source_once(name):
    """tools/torch_display_variants.py's edits each match display.cu
    exactly once (the tool refuses to build one that does not)."""
    with open(SOURCE, encoding="utf-8") as fh:
        src = fh.read()
    what, edits = tdv.VARIANTS[name]
    assert what and edits
    assert tdv.variant_source(src, edits, name) != src


def _banks(addrs):
    return len(set(int(a) % 32 for a in addrs))


def test_shared_tile_is_free_of_bank_conflicts():
    """Writes (32 bins of a frame), RGBA/image reads (frame 32 k + lane of
    a bin) and palette reads (frame 4 lane + j of a bin) each touch 32
    banks a warp; the swizzle keeps every column inside its row."""
    lanes = np.arange(32)
    for t in range(TT):
        assert _banks(t * TF + (lanes ^ swz(t))) == 32
        assert sorted((lanes ^ swz(t)).tolist()) == list(range(32))
    for f in range(TF):
        for k in range(TT // 32):
            t = 32 * k + lanes
            assert _banks(t * TF + (f ^ swz(t))) == 32
        for j in range(4):
            t = 4 * lanes + j
            assert _banks(t * TF + (f ^ swz(t))) == 32


def display_map_model(psd, params, *, log_scale, flip_image, mode,
                      with_image):
    """The kernel's index map in numpy, thread by thread within each item:
    the flat load into the swizzled tile, then the store side's lanes. Each
    value a lane reads back from the tile must be the PSD's at the frame
    and bin the lane owns; its pixel is then the plain map's at that place
    (``pixels``, unflipped (B, F, T))."""
    B, T, F = psd.shape
    p = torch.from_numpy(params)[:, :, None, None]
    pixels = normalize_with_denominator(
        torch.from_numpy(psd).transpose(1, 2), p[:, 0], p[:, 1], p[:, 2],
        log_scale).numpy()

    def read(tile, b, t, f, f0, t0, nt):
        v = tile[t * TF + (f ^ swz(t))]
        ok = t < nt
        assert np.array_equal(v[ok], psd[b, (t0 + t)[ok], f0 + f],
                              equal_nan=True)
        return np.where(ok, pixels[b, f0 + f, np.minimum(t0 + t, T - 1)],
                        0.0).astype(np.float32), ok

    n_tt, n_ft = -(-T // TT), -(-F // TF)
    W4 = -(-T // 4)
    img = np.full((B, F, T), np.nan, np.float32) if with_image else None
    words = (np.full((B, F, W4 if mode == "palette" else T), 0xDEADBEEF,
                     np.uint32) if mode != "none" else None)
    lut = packed_lut("jet").numpy().view(np.uint32)
    flat = psd.reshape(-1)
    for item in range(B * n_tt * n_ft):
        b, r = divmod(item, n_tt * n_ft)
        tt, ft = divmod(r, n_ft)
        t0, f0 = tt * TT, ft * TF
        nt, nf = min(TT, T - t0), min(TF, F - f0)
        tile = np.full(TT * TF, np.nan, np.float32)
        for i in range(TT * TF // THREADS):
            e = np.arange(THREADS) + i * THREADS
            t, f = _tile_index(e, nf)
            ok = e < nt * nf
            src = (b * T + t0) * F + f0 + t * F + f
            tile[(t * TF + (f ^ swz(t)))[ok]] = flat[src[ok]]
        warps, lanes = np.arange(THREADS // 32), np.arange(32)
        for f in range(nf):
            assert f % 8 in warps               # warp f % 8 owns bin f
            bin_ = f0 + f
            row = F - 1 - bin_ if flip_image else bin_
            if mode == "palette":
                word = np.zeros(32, np.uint32)
                for j in range(4):
                    px, ok = read(tile, b, 4 * lanes + j, f, f0, t0, nt)
                    t = 4 * lanes + j
                    idx = lut_index(torch.from_numpy(px)).numpy()
                    word |= np.where(ok, idx, 0).astype(np.uint32) << (8 * j)
                    if with_image:
                        img[b, row, (t0 + t)[ok]] = px[ok]
                live = 4 * lanes < nt
                words[b, F - 1 - bin_, (t0 // 4 + lanes)[live]] = word[live]
            else:
                for k in range(TT // 32):
                    t = 32 * k + lanes
                    px, ok = read(tile, b, t, f, f0, t0, nt)
                    if with_image:
                        img[b, row, (t0 + t)[ok]] = px[ok]
                    if mode == "rgba":
                        idx = lut_index(torch.from_numpy(px)).numpy()
                        words[b, F - 1 - bin_, (t0 + t)[ok]] = lut[idx][ok]
    return img, words


@pytest.mark.parametrize("shape", [(2, 261, 45), (2, 3, 33), (1, 5, 1),
                                   (3, 130, 7), (1, 1, 64)])
@pytest.mark.parametrize("mode", ["rgba", "palette", "none"])
@pytest.mark.parametrize("flip_image", [False, True])
def test_display_map_transcription_matches_plain_version(shape, mode,
                                                         flip_image):
    """Odd T and F, T < 4 and a single bin: the transcription writes every
    pixel and word of display_map_reference's outputs, bitwise, including
    a NaN pixel, a clip of one value (rng 0) and the zero pad of the last
    palette word."""
    B, T, F = shape
    rs = np.random.RandomState(T * F)
    psd = (10.0 ** rs.uniform(-9, -1, shape)).astype(np.float32)
    psd[0, T // 2, F // 2] = np.nan
    if B > 1:
        psd[1] = 2.5e-4
    pmin = np.nanmin(psd, axis=(1, 2))
    pmax = np.nanmax(psd, axis=(1, 2))
    params = display_cuda.clip_params(torch.from_numpy(pmin),
                                      torch.from_numpy(pmax)).numpy()
    for log_scale in (True, False):
        for with_image in (True, False):
            if mode == "none" and not with_image:
                continue
            img, words = display_map_model(
                psd, params, log_scale=log_scale, flip_image=flip_image,
                mode=mode, with_image=with_image)
            want_img, want_words = display_cuda.display_map_reference(
                torch.from_numpy(psd), torch.from_numpy(params),
                log_scale=log_scale, flip_image=flip_image,
                colormap=None if mode == "none" else "jet",
                palette=mode == "palette", with_image=with_image)
            if with_image:
                assert np.array_equal(img, want_img.numpy(), equal_nan=True)
            else:
                assert want_img is None
            if mode == "none":
                assert want_words is None
            else:
                got = words
                want = want_words.view(torch.int32).numpy().view(np.uint32)
                assert got.shape == want.shape and np.array_equal(got, want)
