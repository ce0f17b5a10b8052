"""The display backward's kernel arithmetic (csrc/display.cu,
display_grad_kernel) transcribed in numpy and held on the CPU to the plain
backward, ``ops/display_cuda.py::display_backward_reference``.

The kernel runs only on the card; here its arithmetic and its order of
sums are modelled:

- the clip's table, once an item: 1/d, DB_SLOPE/d, the dB values and
  slopes at the extrema in the plain version's operations, rng, 1/rng,
  ok;
- a pixel: u = v / d as the correctly rounded quotient (the kernel's
  reciprocal product corrected twice by FMAs, held to the IEEE division
  below with an exact FMA), the same f64 log10, clip_slope(r) read from
  num = db - db_lo against 0 and rng, and reciprocals for the values no
  decision reads (k = h g / rng, r = num / rng, DB_SLOPE / (y d) with 1/y
  from an approximate seed and two Newton steps); u's clip and
  clip_slope(u) read from v against 0 and d, which the IEEE quotient's
  place against 0 and 1 equals (checked below);
- the records: each item (DG_F bins x DG_CHUNKS chunks of DG_T frames,
  the source's constants; warp w its chunks w, w + DG_WARPS, ..., lane l
  on bin l walking their frames) summed a thread at a time in its order,
  the warp's shuffle tree, the warps in order; the clip's records a thread a
  record and the same trees; the batch's sums the same way;
- the extrema step: only the items whose records count a pixel equal to
  the clip's min or max are revisited, the own term rounded to float32
  first and the shares added there.

Each case is held within GRAD_TOL (1e-6 of the clip's largest |entry|,
chip_smoke.py's) of the plain backward, NaN in its places, with the same
clip_slope decisions at every pixel (of u, and of r where the clip's dB
range is past 1e-6), on silent frames, a pixel equal to the base (u = 1),
r exactly 0 and 1, two clips tied at the batch's max under share_max,
clips whose dB range is at most 1e-6, a NaN pixel, mel rows, odd T and F.
"""

import math
import os
import re
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spectral_tpu_torch.ops import display_cuda as disp  # noqa: E402

GRAD_TOL = 1e-6
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "spectral_tpu_torch", "ops", "csrc", "display.cu")


def _constant(name):
    with open(SOURCE, encoding="utf-8") as fh:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             fh.read()).group(1))


DG_F, DG_T = _constant("DG_F"), _constant("DG_T")
DG_CHUNKS, DG_THREADS = _constant("DG_CHUNKS"), _constant("DG_THREADS")
DG_WARPS = DG_THREADS // 32
DB_SLOPE = disp.DB_SLOPE


def _slope(a):
    return np.where((a > 0) & (a < 1), 1.0,
                    np.where((a == 0) | (a == 1), 0.5, 0.0))


def _db_grad(v, d):
    """display.cu::db_grad, the plain version's operations."""
    with np.errstate(all="ignore"):
        u = v / d
        y = np.clip(u, 0.0, 1.0) + 1e-12
        dv = _slope(u) * ((DB_SLOPE / y) / d)
        return 10.0 * np.log10(y), dv, -(dv * u)


def _recip(y):
    """1/y: an approximate seed (the float reciprocal here; the kernel's is
    MUFU's 64-bit one), then two steps r + r (1 - y r)."""
    with np.errstate(all="ignore"):
        r = (np.float32(1.0) / y.astype(np.float32)).astype(np.float64)
        r = r + r * (1.0 - y * r)
        return r + r * (1.0 - y * r)


def _tree(v):
    """A warp's __shfl_down_sync tree over its 32 lanes' values (the last
    axis); lane 0's sum."""
    v = v.copy()
    for off in (16, 8, 4, 2, 1):
        v[..., :32 - off] = v[..., :32 - off] + v[..., off:32]
    return v[..., 0]


def _block_fold(per_thread):
    """display.cu::block_fold: (..., DG_THREADS) values -> thread 0's sum
    (the warps' trees, then warps 1.. added to warp 0's in order)."""
    w = _tree(per_thread.reshape(per_thread.shape[:-1] + (DG_WARPS, 32)))
    out = w[..., 0]
    for i in range(1, DG_WARPS):
        out = out + w[..., i]
    return out


def _thread_pixels(w, lane, t0, f0, T, F):
    """Thread (warp w, lane l)'s pixels of an item in the kernel's order:
    bin f0 + l, its chunks w, w + DG_WARPS, ..., each's frames in order."""
    f = f0 + lane
    if f >= F:
        return []
    return [(t0 + DG_T * c + j, f) for c in range(w, DG_CHUNKS, DG_WARPS)
            for j in range(DG_T) if t0 + DG_T * c + j < T]


def _thread_sums(x, b, t0, f0, T, F):
    """An item's per-thread sums of x (B, T, F) in the kernel's order."""
    out = np.zeros(DG_THREADS)
    for tid in range(DG_THREADS):
        acc = 0.0
        for t, f in _thread_pixels(*divmod(tid, 32), t0, f0, T, F):
            acc = acc + x[b, t, f]
        out[tid] = acc
    return out


def model_backward(g, psd, params, *, log_scale, flip_image=False,
                   share_max=False):
    """The kernel's arithmetic in numpy: (dpsd float32, hu, hr, ok) with
    the pixels' clip_slope decisions of u and of r."""
    g = np.asarray(g, np.float32)
    s32 = np.asarray(psd, np.float32)
    p32 = np.asarray(params, np.float32)
    B, T, F = s32.shape
    G = (g[:, ::-1] if flip_image else g).transpose(0, 2, 1).astype(
        np.float64)
    v = s32.astype(np.float64)
    d = p32[:, 0].astype(np.float64)[:, None, None]
    lo, hi = p32[:, 1][:, None, None], p32[:, 2][:, None, None]
    with np.errstate(all="ignore"):
        inv_d, sd = 1.0 / d, DB_SLOPE / d
        u = v / d                        # the correctly rounded quotient
        hu = _slope(u)
        db_lo, dv_lo, dd_lo = _db_grad(lo.astype(np.float64), d)
        db_hi, dv_hi, dd_hi = _db_grad(hi.astype(np.float64), d)
        rng = db_hi - db_lo
        ok = rng > 1e-6 if log_scale else np.ones_like(rng, bool)
        inv_rng = np.where(ok, 1.0 / rng, 1.0)
        if log_scale:
            y = np.clip(u, 0.0, 1.0) + 1e-12
            num = 10.0 * np.log10(y) - db_lo
            hr = np.where((num > 0) & (num < rng), 1.0,
                          np.where((num == 0) | (num == rng), 0.5, 0.0))
            live = ok & (hr != 0)
            k = hr * (G * inv_rng)
            own = np.where(live, k * (hu * (sd * _recip(y))), 0.0)
            su = np.where(live, own * u, 0.0)
            sk = np.where(live, k, 0.0)
            skr = np.where(live, k * (num * inv_rng), 0.0)
        else:
            hr = np.zeros_like(u)
            live = hu != 0
            own = np.where(live, hu * (G * inv_d), 0.0)
            su = np.where(live, own * u, 0.0)
            sk = skr = np.zeros_like(u)
    out = own.astype(np.float32)
    n_lo = (s32 == lo).astype(np.float64)
    n_hi = (s32 == hi).astype(np.float64)
    n_tc = -(-T // (DG_T * DG_CHUNKS))
    n_ft = -(-F // DG_F)
    per_clip = n_tc * n_ft
    assert per_clip <= DG_THREADS        # a thread a record in the fold
    fields = (su, sk, skr, n_lo, n_hi)
    records = np.zeros((B, per_clip, 5))
    for b in range(B):
        for r in range(per_clip):
            t0, f0 = (r // n_ft) * DG_T * DG_CHUNKS, (r % n_ft) * DG_F
            records[b, r] = [_block_fold(_thread_sums(x, b, t0, f0, T, F))
                             for x in fields]
    padded = np.zeros((B, 5, DG_THREADS))
    padded[:, :, :per_clip] = records.transpose(0, 2, 1)
    S = _block_fold(padded)              # (B, 5): each clip's fold
    top = np.max(p32[:, 2]) if share_max else 0.0   # NaN-propagating
    batch_base = bool(share_max and top > 0)
    amounts, c_ds, holds = [], [], []
    for b in range(B):
        su_b, sk_b, skr_b, nl, nh = S[b]
        c_d, c_lo, c_hi = -su_b, 0.0, 0.0
        if log_scale:
            a = skr_b - sk_b
            c_d = (c_d + dd_lo[b].item() * a) + -(dd_hi[b].item() * skr_b)
            c_lo = dv_lo[b].item() * a
            c_hi = -(dv_hi[b].item() * skr_b)
        hold = batch_base and p32[b, 2] == top
        at_hi = c_hi if batch_base else c_hi + c_d
        at_hi = at_hi / nh if nh > 0 else 0.0
        amounts.append([c_lo / nl if nl > 0 else 0.0, at_hi])
        c_ds.append(c_d)
        holds.append(nh if hold else 0.0)
    if batch_base:
        tot = np.zeros((2, DG_THREADS))
        tot[0, :B], tot[1, :B] = c_ds, holds
        tot_c, tot_n = _block_fold(tot)
        add = tot_c / tot_n if tot_n > 0 else 0.0
        for b in range(B):
            if p32[b, 2] == top:
                amounts[b][1] += add
    # the extrema step: the items whose counts are non-zero, and only those
    for b in range(B):
        a_lo, a_hi = amounts[b]
        if a_lo == 0.0 and a_hi == 0.0:
            continue
        for r in range(per_clip):
            t0, f0 = (r // n_ft) * DG_T * DG_CHUNKS, (r % n_ft) * DG_F
            item = (slice(t0, t0 + DG_T * DG_CHUNKS), slice(f0, f0 + DG_F))
            at_lo = s32[b][item] == lo[b, 0, 0]
            at_hi = s32[b][item] == hi[b, 0, 0]
            hit = records[b, r, 3] > 0 or records[b, r, 4] > 0
            assert hit == bool(at_lo.any() or at_hi.any())
            if not hit:
                continue
            o = out[b][item].astype(np.float64)
            o = np.where(at_lo, o + a_lo, o)
            o = np.where(at_hi, o + a_hi, o)
            out[b][item] = o.astype(np.float32)
    return out, hu, hr, ok


def _clip_rel(got, want):
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), "NaN in other places"
    B = want.shape[0]
    diff = np.where(nan, 0.0, np.abs(got.astype(np.float64)
                                     - want.astype(np.float64)))
    scale = np.where(nan, 0.0, np.abs(want.astype(np.float64)))
    return float((diff.reshape(B, -1).max(axis=1)
                  / np.maximum(scale.reshape(B, -1).max(axis=1),
                               1e-30)).max())


def _plain_decisions(psd, params, log_scale):
    """The plain version's clip_slope decisions: of u = v / d, and of r =
    (db - db_lo) / rng, and its ok."""
    s = torch.from_numpy(psd).double()
    p = torch.from_numpy(params).double()[:, :, None, None]
    d, lo, hi = p[:, 0], p[:, 1], p[:, 2]
    hu = disp._clip_slope(s / d)
    if not log_scale:
        return hu.numpy(), None, None
    db_lo = disp._db_grad(lo, d)[0]
    db_hi = disp._db_grad(hi, d)[0]
    rng = db_hi - db_lo
    r = (disp._db_grad(s, d)[0] - db_lo) / rng
    return hu.numpy(), disp._clip_slope(r).numpy(), (rng > 1e-6).numpy()


def _noise(rs, B, T, F):
    return (10.0 ** rs.uniform(-9, -1, (B, T, F))).astype(np.float32)


def _params(psd, share_max):
    p = torch.from_numpy(psd)
    return disp.clip_params(torch.amin(p, dim=(1, 2)),
                            torch.amax(p, dim=(1, 2)), share_max).numpy()


def _case(name, share_max):
    """(psd, params) of each case; the params from the clip's own extrema
    (clip_stats' operands), the NaN pixel's from the clean clip."""
    rs = np.random.RandomState(sum(map(ord, name)))
    if name == "noise, odd T and F":
        psd = _noise(rs, 3, 37, 33)
    elif name == "silent frames":
        psd = _noise(rs, 2, 300, 45)
        psd[0, 10:290] = 0.0              # 12,600 pixels tied at the min
    elif name == "a pixel equal to the base (u = 1)":
        psd = _noise(rs, 2, 41, 35)
        psd[1, 7, 9] = psd[1, 20, 3] = psd[1].max()
    elif name == "two clips tied at the batch's max":
        psd = _noise(rs, 4, 33, 37)
        top = psd.max() * 2
        psd[1, 3, 4] = psd[2, 30, 36] = psd[2, 1, 2] = top
    elif name == "dB range at most 1e-6":
        psd = _noise(rs, 3, 29, 31)
        psd[0] = 0.25                     # rng 0
        psd[1] = 0.5                      # a range of 5.2e-7 dB
        psd[1, ::2, ::3] = np.nextafter(np.float32(0.5), np.float32(1))
    elif name == "mel rows":
        psd = _noise(rs, 2, 70, 128)
    elif name == "a NaN pixel":
        psd = _noise(rs, 2, 35, 33)
    else:
        raise KeyError(name)
    params = _params(psd, share_max)
    if name == "a NaN pixel":
        psd[1, 7, 3] = np.nan
    return psd, params


CASES = ["noise, odd T and F", "silent frames",
         "a pixel equal to the base (u = 1)",
         "two clips tied at the batch's max", "dB range at most 1e-6",
         "mel rows", "a NaN pixel"]
MODES = [(True, True, False), (False, False, False), (True, False, True),
         (False, True, True)]


@pytest.mark.parametrize("log,flip,share", MODES,
                         ids=[f"{'log' if m[0] else 'linear'}"
                              f"{'-flip' if m[1] else ''}"
                              f"{'-share_max' if m[2] else ''}"
                              for m in MODES])
@pytest.mark.parametrize("name", CASES)
def test_kernel_model_matches_the_plain_backward(name, log, flip, share):
    psd, params = _case(name, share)
    B, T, F = psd.shape
    g = np.random.RandomState(7).randn(B, F, T).astype(np.float32)
    got, hu, hr, ok = model_backward(g, psd, params, log_scale=log,
                                     flip_image=flip, share_max=share)
    want = disp.display_backward_reference(
        torch.from_numpy(g), torch.from_numpy(psd), torch.from_numpy(params),
        log_scale=log, flip_image=flip, share_max=share).numpy()
    assert _clip_rel(got, want) <= GRAD_TOL
    p_hu, p_hr, p_ok = _plain_decisions(psd, params, log)
    assert np.array_equal(hu, p_hu)
    if log:
        assert np.array_equal(ok, p_ok)
        live = np.broadcast_to(ok, hr.shape)
        assert np.array_equal(hr[live], p_hr[live])
        # r exactly 0 at the min and 1 at the max: clip_slope's 0.5
        lo, hi = params[:, 1][:, None, None], params[:, 2][:, None, None]
        assert (hr[live & (psd == lo)] == 0.5).all()
        assert (hr[live & (psd == hi)] == 0.5).all()


def test_the_cases_hold_what_they_name():
    psd, params = _case("silent frames", False)
    assert params[0, 1] == 0.0 and (psd[0] == 0.0).sum() >= 12600
    psd, params = _case("a pixel equal to the base (u = 1)", False)
    assert (params[:, 0] == params[:, 2]).all()
    assert ((psd[1] / np.float64(params[1, 0])) == 1.0).sum() == 3
    psd, params = _case("two clips tied at the batch's max", True)
    assert (params[:, 2] == params[:, 2].max()).sum() == 2
    psd, params = _case("dB range at most 1e-6", False)
    for b, want in ((0, 0.0), (1, 5.2e-7)):
        db = _db_grad(params[b, 1:].astype(np.float64), np.float64(
            params[b, 0]))[0]
        assert db[1] - db[0] <= 1e-6
        assert abs(db[1] - db[0] - want) < 1e-8
    psd, params = _case("a NaN pixel", False)
    assert np.isnan(psd).sum() == 1 and np.isfinite(params).all()


def _fma(a, b, c):
    """a b + c rounded once (Python's float of a Fraction is correctly
    rounded)."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _quotient(v, d):
    """display.cu::quotient's fast path: v (1/d) corrected twice."""
    inv = 1.0 / d
    q = v * inv
    q = _fma(_fma(-q, d, v), inv, q)
    return _fma(_fma(-q, d, v), inv, q)


def test_the_corrected_reciprocal_product_is_the_ieee_quotient():
    """v / d from the reciprocal and two FMA corrections equals the IEEE
    division on float32 operands: random pairs over the float32 range,
    v = d, its neighbours, d's significand all ones, denormal v, v = 0."""
    rs = np.random.RandomState(3)
    f32 = np.float32
    pairs = []
    d = (10.0 ** rs.uniform(-30, 30, 1500)).astype(f32)
    v = (d * rs.rand(1500)).astype(f32)
    pairs += list(zip(v, d))
    for dd in (f32(1e-20), f32(1.0), np.nextafter(f32(2), f32(0)),
               f32(3.4e38), f32(1.17549435e-38), f32(0.7), f32(1e-3)):
        vv = [dd, np.nextafter(dd, f32(0)), np.nextafter(dd, f32(np.inf)),
              f32(0), f32(1.4e-45), f32(dd * f32(0.5)),
              np.nextafter(f32(dd * f32(0.999)), f32(0))]
        pairs += [(x, dd) for x in vv]
    worst = 0
    for x, y in pairs:
        x, y = float(x), float(y)
        want = x / y
        got = _quotient(x, y)
        assert got == want, (x, y, got, want)
        worst = max(worst, abs(x * (1.0 / y) - want) / math.ulp(want)
                    if want else 0)
    assert worst > 0          # the uncorrected product does miss


def test_r_decision_is_the_ieee_quotients():
    """clip_slope(RN(num / rng)) equals the kernel's reading of num against
    0 and rng, for rng > 0 and a quotient past the underflow (num = db -
    db_lo is 0 or at least about 1e-16 in size, db lying in [-120, 4.4e-12]
    with steps of an ulp of its size): num = rng, its neighbours, 0, -0,
    the smallest such and random values around both bounds."""
    rs = np.random.RandomState(5)
    rngs = np.concatenate([10.0 ** rs.uniform(-6, 3, 400),
                           [1e-6 * (1 + 2 ** -52), 1.0, 2.0 - 2 ** -52,
                            120.0]])
    for r in rngs:
        nums = [r, np.nextafter(r, 0), np.nextafter(r, np.inf), 0.0, -0.0,
                4 * np.finfo(np.float64).tiny * r,
                -4 * np.finfo(np.float64).tiny * r,
                r * rs.rand(), r * (1 + rs.rand()), -r * rs.rand()]
        for n in nums:
            want = _slope(np.float64(n) / r)
            got = 1.0 if 0 < n < r else (0.5 if n == 0 or n == r else 0.0)
            assert want == got, (n, r)


def test_the_items_cover_each_pixel_once():
    """The kernel's items (DG_F bins x DG_CHUNKS chunks of DG_T frames) and
    each thread's pixels in them tile a clip: every pixel once."""
    for T, F in ((37, 33), (300, 45), (622, 513), (1, 1), (256, 32)):
        seen = np.zeros((T, F), np.int64)
        n_tc, n_ft = -(-T // (DG_T * DG_CHUNKS)), -(-F // DG_F)
        for r in range(n_tc * n_ft):
            t0, f0 = (r // n_ft) * DG_T * DG_CHUNKS, (r % n_ft) * DG_F
            for tid in range(DG_THREADS):
                for t, f in _thread_pixels(*divmod(tid, 32), t0, f0, T, F):
                    seen[t, f] += 1
        assert (seen == 1).all()


def test_u_decisions_from_float_compares_are_the_quotients():
    """For float32 v and d > 0: v / d's clip and clip_slope equal v's place
    against 0 and d read by float compares (the kernel's fast path)."""
    rs = np.random.RandomState(11)
    f32 = np.float32
    d = (10.0 ** rs.uniform(-30, 30, 400)).astype(f32)
    for dd in d:
        vs = np.array([0.0, -0.0, dd, np.nextafter(dd, f32(0)),
                       np.nextafter(dd, f32(np.inf)), dd * f32(rs.rand()),
                       -dd * f32(rs.rand()), f32(1.4e-45)], f32)
        u = vs.astype(np.float64) / np.float64(dd)
        want_clip = np.clip(u, 0.0, 1.0) + 1e-12
        want_slope = _slope(u)
        got_clip = np.where(vs >= dd, 1.0, np.where(vs <= 0, 0.0, u)) + 1e-12
        got_slope = np.where((vs > 0) & (vs < dd), 1.0,
                             np.where((vs == 0) | (vs == dd), 0.5, 0.0))
        assert np.array_equal(got_clip, want_clip)
        assert np.array_equal(got_slope, want_slope)
