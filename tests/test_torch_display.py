"""The port's display stage held against the JAX package on the same
inputs: normalization (spectral_tpu_torch.core.scale), the packed jet
colormap (spectral_tpu_torch.ops.colormap) and the display kernel's plain
version (spectral_tpu_torch.ops.display_cuda), given the per-clip operands
that its clip_stats kernel computes (``clip_params``).

Tolerances: normalization within 1e-6 (float32 log10 and division of the
same values in two libraries); colormap words byte-exact (a table lookup
against JAX's hinge arithmetic, both exact by construction).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectral_tpu.core import scale as jscale  # noqa: E402
from spectral_tpu.ops import colormap as jcmap  # noqa: E402
from spectral_tpu_torch.core import scale as tscale  # noqa: E402
from spectral_tpu_torch.ops import colormap as tcmap  # noqa: E402
from spectral_tpu_torch.ops import display_cuda  # noqa: E402

TOL = 1e-6


def _psd_image(seed, shape=(65, 40)):
    """A PSD-like image spanning eight decades."""
    rs = np.random.RandomState(seed)
    return (10.0 ** rs.uniform(-9.0, -1.0, shape)).astype(np.float32)


def _images():
    img = _psd_image(0)
    nan = img.copy()
    nan[3, 7] = np.nan
    return {"psd": img, "nan_pixel": nan,
            "constant": np.full((65, 40), 2.5e-4, np.float32),
            "zeros": np.zeros((65, 40), np.float32)}


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("log_scale", [False, True])
@pytest.mark.parametrize("global_max", [None, 0.5, 0.0, -1.0])
@pytest.mark.parametrize("name", ["psd", "nan_pixel", "constant", "zeros"])
def test_normalize_matches_jax(name, global_max, log_scale):
    img = _images()[name]
    want = jax.jit(jscale.normalize, static_argnums=1)(
        jnp.asarray(img), log_scale, global_max)
    got = tscale.normalize(torch.from_numpy(img), log_scale, global_max)
    _close(got, want)


@pytest.mark.parametrize("log_scale", [False, True])
@pytest.mark.parametrize("global_max", [None, 1e-3, -1.0])
def test_normalize_from_stats_matches_jax(global_max, log_scale):
    img = _psd_image(1)
    lo, hi = img.min(), img.max()
    want = jax.jit(jscale.normalize_from_stats, static_argnums=3)(
        jnp.asarray(img), jnp.float32(lo), jnp.float32(hi), log_scale,
        global_max)
    got = tscale.normalize_from_stats(torch.from_numpy(img),
                                      torch.tensor(lo), torch.tensor(hi),
                                      log_scale, global_max)
    _close(got, want)


@pytest.mark.parametrize("log_scale", [False, True])
@pytest.mark.parametrize("share_max", [False, True])
def test_normalize_batch_matches_jax(share_max, log_scale):
    batch = np.stack([_psd_image(2), 1e-3 * _psd_image(3),
                      _images()["nan_pixel"], _images()["constant"]])
    want = jax.jit(jscale.normalize_batch, static_argnums=(1, 2))(
        jnp.asarray(batch), log_scale, share_max)
    got = tscale.normalize_batch(torch.from_numpy(batch), log_scale,
                                 share_max)
    _close(got, want)


def test_log_image_max_pixel_is_exactly_one():
    got = tscale.normalize(torch.from_numpy(_psd_image(4)), True)
    assert float(got.max()) == 1.0 and float(got.min()) == 0.0


@pytest.mark.parametrize("flip_rows", [False, True])
def test_colormap_all_levels_byte_exact(flip_rows):
    levels = ((np.arange(256) + 0.5) / 256).astype(np.float32)
    img = np.stack([levels, levels[::-1]]).reshape(2, 16, 16)
    want = np.asarray(jcmap.apply_colormap_packed(jnp.asarray(img),
                                                  flip_rows=flip_rows))
    got = tcmap.apply_colormap_packed(torch.from_numpy(img),
                                      flip_rows=flip_rows)
    assert got.dtype == torch.uint32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tcmap.unpack_rgba(got), jcmap.unpack_rgba(want))


def test_colormap_real_image_and_edges_byte_exact():
    img = np.asarray(jscale.normalize(jnp.asarray(_psd_image(5)), True))
    img = np.concatenate([img, np.array([[0.0, 1.0, -0.5, 1.5] * 10],
                                        np.float32)])
    want = np.asarray(jcmap.apply_colormap_packed(jnp.asarray(img),
                                                  method="gather"))
    got = tcmap.apply_colormap_packed(torch.from_numpy(img))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        got.numpy(), np.asarray(jcmap.apply_colormap_packed(jnp.asarray(img))))
    transparent = tcmap.apply_colormap_packed(torch.from_numpy(img),
                                              opaque=False)
    assert np.array_equal(transparent.numpy(), want & 0x00FFFFFF)


def _pallas_tail(psd, pmin, pmax, log_scale):
    """The jnp tail of the JAX package's pallas_pipeline_fn."""
    img = jax.vmap(lambda s, lo, hi: jscale.normalize_from_stats(
        s, lo, hi, log_scale))(jnp.swapaxes(jnp.asarray(psd), -1, -2),
                               jnp.asarray(pmin), jnp.asarray(pmax))
    return np.asarray(img), np.asarray(
        jcmap.apply_colormap_packed(img, flip_rows=True))


def _batch_psd():
    psd = np.stack([_psd_image(6, (40, 65)), 3e-2 * _psd_image(7, (40, 65))])
    return psd, psd.min(axis=(1, 2)), psd.max(axis=(1, 2))


def _params(pmin, pmax, share_max=False):
    return display_cuda.clip_params(torch.as_tensor(pmin),
                                    torch.as_tensor(pmax), share_max)


@pytest.mark.parametrize("log_scale", [False, True])
@pytest.mark.parametrize("flip_image", [False, True])
def test_display_reference_matches_pallas_tail(flip_image, log_scale):
    psd, pmin, pmax = _batch_psd()
    img_j, rgb_j = _pallas_tail(psd, pmin, pmax, log_scale)
    img, rgb = display_cuda.display_map_reference(
        torch.from_numpy(psd), _params(pmin, pmax), log_scale=log_scale,
        flip_image=flip_image)
    assert img.is_contiguous() and img.shape == (2, 65, 40)
    _close(img.flip(1) if flip_image else img, img_j)
    # packed words always put the highest frequency in row 0
    assert np.array_equal(rgb.numpy(), rgb_j)


def test_display_share_max_uses_the_batch_max():
    psd, pmin, pmax = _batch_psd()
    sxx = jnp.swapaxes(jnp.asarray(psd), -1, -2)
    want = jax.vmap(lambda s, lo, hi: jscale.normalize_from_stats(
        s, lo, hi, True, jnp.max(jnp.asarray(pmax))))(
            sxx, jnp.asarray(pmin), jnp.asarray(pmax))
    params = _params(pmin, pmax, True)
    img, _ = display_cuda.display_map_reference(
        torch.from_numpy(psd), params, log_scale=True)
    _close(img, want)
    assert params.shape == (2, 3) and params.dtype == torch.float32
    assert torch.all(params[:, 0] == float(pmax.max()) + 1e-20)
    assert torch.equal(params[:, 1], torch.from_numpy(pmin))


def test_display_wrapper_on_cpu_is_the_plain_version():
    psd, pmin, pmax = _batch_psd()
    psd, params = torch.from_numpy(psd), _params(pmin, pmax)
    kw = dict(log_scale=True, flip_image=True)
    got = display_cuda.display_map(psd, params, **kw)
    want = display_cuda.display_map_reference(psd, params, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    img, rgb = display_cuda.display_map(psd, params, colormap=None,
                                        log_scale=True)
    assert rgb is None and img.shape == (2, 65, 40)


@pytest.mark.parametrize("width", [16, 13])
@pytest.mark.parametrize("flip_rows", [False, True])
def test_index_pack_byte_exact(flip_rows, width):
    """Four LUT indices per word, the width zero-padded to a multiple of 4,
    and the host unpack, against the JAX package for all 256 levels, the
    clip edges and a NaN pixel (index 0)."""
    levels = ((np.arange(256) + 0.5) / 256).astype(np.float32)
    img = np.concatenate([levels, [0.0, 1.0, -0.5, 1.5, np.nan] * 8])
    img = img[:(img.size // width) * width].astype(np.float32)
    img = img.reshape(2, -1, width)
    want = np.asarray(jcmap.colormap_index_packed(jnp.asarray(img),
                                                  flip_rows=flip_rows))
    got = tcmap.colormap_index_packed(torch.from_numpy(img),
                                      flip_rows=flip_rows)
    assert got.dtype == torch.uint32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tcmap.unpack_indices(got, width),
                          jcmap.unpack_indices(want, width))
    # the index behind each RGBA word is the index the pack holds
    rgb = tcmap.apply_colormap_packed(torch.from_numpy(img),
                                      flip_rows=flip_rows)
    lut = tcmap.packed_lut("jet").view(torch.uint32)
    idx = torch.from_numpy(tcmap.unpack_indices(got, width).astype(np.int64))
    assert torch.equal(lut[idx], rgb)


@pytest.mark.parametrize("flip_image", [False, True])
def test_display_palette_reference_matches_pallas_tail(flip_image):
    psd, pmin, pmax = _batch_psd()
    img_j, _ = _pallas_tail(psd, pmin, pmax, True)
    want = np.asarray(jcmap.colormap_index_packed(jnp.asarray(img_j),
                                                  flip_rows=True))
    img, words = display_cuda.display_map(
        torch.from_numpy(psd), _params(pmin, pmax), log_scale=True,
        flip_image=flip_image, palette=True)
    _close(img.flip(1) if flip_image else img, img_j)
    # index words always put the highest frequency in row 0, whatever the
    # colormap
    assert words.shape == (2, 65, 10) and np.array_equal(words.numpy(), want)
    _, none = display_cuda.display_map_reference(
        torch.from_numpy(psd), _params(pmin, pmax), log_scale=True,
        colormap=None, palette=True)
    assert torch.equal(none, words)


@pytest.mark.parametrize("palette", [False, True])
def test_display_without_image_keeps_the_words(palette):
    """with_image=False returns no image and the same words."""
    psd, pmin, pmax = _batch_psd()
    psd, params = torch.from_numpy(psd), _params(pmin, pmax)
    kw = dict(log_scale=True, flip_image=True, palette=palette)
    img, words = display_cuda.display_map(psd, params, **kw)
    none, lean = display_cuda.display_map(psd, params, with_image=False,
                                          **kw)
    assert img is not None and none is None
    assert torch.equal(lean, words)
