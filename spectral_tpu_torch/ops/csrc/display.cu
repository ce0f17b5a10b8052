// The display tail for NVIDIA Hopper (sm_90a): per-clip statistics and the
// display map.
//
// Replace the jnp tail of spectral_tpu/ops/stft_pallas.py::
// pallas_pipeline_fn (K3, :456-495): the per-clip PSD extrema reduced from
// the STFT kernel's partials (`with_stats`, :447-451), the `finite` health
// flag (:486-490), and normalize_from_stats -> dB -> clip -> colormap pack.
// Two kernels, each launched once per batch on the caller's stream:
//
// clip_stats_kernel (clip_stats_launch)
//   in : x (B, n) f32, the waveform; the STFT kernel's partials,
//        part_min/part_max (n_tiles, B * T) f32 each
//   out: pmin, pmax (B,) f32 (NaN-propagating, like torch.amin/amax of the
//        partials), finite (B,) bool, and the display map's operands
//        params (B, 3) f32 = (base + 1e-20, pmin, pmax), base the clip's
//        pmax or, under share_max, the batch's largest pmax when it is > 0.
//   The flag: finite = isfinite(pmin) & isfinite(pmax) & !underflow, with
//     m         = fl32(sum_f64(x) / n)
//     adet      = max |fl32(x - m)|
//     underflow = (pmax == 0) & (adet > 0) & (adet < 1e-10).
//   adet comes from the clip's sum, min and max alone:
//     max_i |fl(x_i - m)| == max(fl(xmax - m), fl(m - xmin)),
//   because under round-to-nearest fl(a - m) is monotone in a (a <= b gives
//   a - m <= b - m, and rounding preserves <=), and |fl(a - m)| ==
//   fl(|a - m|) (rounding is symmetric about 0). So the largest |fl(x_i -
//   m)| is at x_i = xmax or x_i = xmin: fl(xmax - m) >= fl(x_i - m) and
//   fl(m - xmin) >= fl(m - x_i) = -fl(x_i - m). (A NaN sample makes m, and
//   so adet, NaN on both sides; an inf one makes adet NaN or inf, and the
//   PSD extrema are then not finite either.)
//   The sum is float64: the sum of n copies of one f32 value is exact in
//   f64 for n < 2^29, so a pure-DC clip's m equals its sample and adet is
//   exactly 0, and it stays healthy, as the contract says (a float32 mean,
//   torch.mean's, leaves a few 1e-11 there).
//   Work: grid-stride over (clip, chunk) items of CS_CHUNK samples, plus
//   each chunk's share of the clip's partial rows; one block an item, a
//   block reduction, one record per item in the workspace; the item that
//   completes a clip (an atomic count) folds the clip's records in chunk
//   order and writes its outputs; under share_max the clip that completes
//   the batch writes every base. The counts are zeroed by a memset in the
//   launcher, on the same stream.
//   Bound: bytes, x and the partials read once (0.197 ms at 1024 x 10 s on
//   3.35 TB/s). 16-byte loads from the first aligned sample of each chunk
//   (a row of x is aligned only when n is a multiple of 4).
//
// display_map_kernel<MODE, LOG> (display_map_launch)
//   in : psd (B, T, F) f32 frame-major, params (B, 3), and for RGBA words
//        the packed LUT (256,) u32
//   out: image (B, F, T) f32 freq-major (optional, its rows flipped under
//        flip_image), and either RGBA words (B, F, T) u32 (MODE 1) or
//        palette indices four to a word (B, F, ceil(T / 4)) u32 (MODE 2);
//        the words' row 0 is always the highest frequency
//   The pixel: u = clip(v / (base + 1e-20), 0, 1), NaN kept; with LOG,
//     db(u) = nan_to_num(10 log10(u + 1e-12)), and the pixel
//     (db(u) - db_min) / rng clipped to [0, 1] when rng = db_max - db_min
//     > 1e-6, else 0; db_min and db_max are db() at the clip's pmin and
//     pmax, evaluated once an item with the same log10f and __fdiv_rn as
//     the pixels, so the max pixel lands at exactly 1.0. Every product and
//     sum is __fmul_rn/__fadd_rn/__fsub_rn: nvcc contracts a*b + c into an
//     FMA, which the plain version does not. The LUT index is
//     clip(int(pixel * 256), 0, 255), 0 for a NaN pixel.
//   Work: a block a tile of DM_TT frames x DM_TF bins (clips on grid x,
//   so any B; a grid-stride loop past 2^31 - 1 tiles), copied into shared
//   memory by cp.async, 16 copies a thread in flight at once, and the
//   clip's scale computed while they land. (A persistent grid whose
//   blocks walk many tiles, the next tile's copy in flight during this
//   one's arithmetic, ran 1.6x slower on an H100 at 1024 x 622 x 513.)
//   The arithmetic (two IEEE divisions and a log10f a pixel) hides under
//   the memory traffic at that shape (an ablation without it takes as
//   long), not at a 64-clip palette batch, where it is a third of the
//   time. A tile is
//   copied flat: element e of its nt x nf values
//   is frame e / nf, bin e % nf, so a warp reads 32 consecutive bins of a
//   frame (coalesced; rows of F = 513 or 4097 are not 16-byte aligned, so
//   4-byte copies), and a tile that holds every bin (F <= 32) reads one
//   contiguous span of the clip. It lands at row t, column f ^ swz(t), and
//   is read back along frames:
//   - RGBA words and the image: lane l of a warp owns frame 32 k + l of a
//     bin, so a warp stores 128 consecutive bytes of a row of each output;
//   - palette: lane q owns the four consecutive frames 4q .. 4q + 3 of a
//     bin, their four indices one packed word built in registers, so a
//     warp stores 32 consecutive words of a row (the image, when it is
//     asked for with palette words, is stored as four words a lane).
//   swz(t) = (t & 28) | ((t & 3) ^ ((t >> 5) & 3)) makes the writes (32
//   bins of a frame), both read patterns (32 frames of a bin; frame 4q + j
//   of a bin over q) and so every access free of bank conflicts.
//   Bound: bytes, the PSD read once and the outputs written once (1.170 ms
//   for RGBA and the image at 1024 x 10 s, north_star 1024/256; 0.0305 ms
//   for palette words of 64 clips, no image).
//
// display_grad_pixel_kernel<LOG> and display_grad_extrema_kernel
// (display_backward_launch): the image's adjoint, for the gradient through
// the display (the JAX package's jax.grad of core/scale.py::normalize over
// the displayed rows, sharding.py:115; its Pallas pipeline has none)
//   in : g (B, F, T) f32, the gradient of the image (rows flipped under
//        flip_image, as the map wrote them); psd (B, T, F) f32 and params
//        (B, 3), the map's inputs; share_max
//   out: dpsd (B, T, F) f32, the gradient of the displayed rows, through
//        each pixel and through the clip's operands: the base (d = base +
//        1e-20; the clip's max, or under share_max the batch's when it is >
//        0), its min and its max, which reach the pixels that are the
//        extrema (split evenly among ties, as jax.grad(jnp.max) and
//        torch.amax split them). In float64, with u = v / d:
//          non-log  img = clip(u, 0, 1): d img/dv = h(u) / d,
//                   d img/dd = -h(u) u / d
//          log      db(v) = 10 log10(clip(u, 0, 1) + 1e-12), r = (db(v) -
//                   db(min)) / rng, rng = db(max) - db(min); img = clip(r,
//                   0, 1) where rng > 1e-6, else 0 (and a zero gradient):
//                   with k = h(r) g / rng, d img/dv = k db'(v), d img/d
//                   db(min) = k (r - 1), d img/d db(max) = -k r
//        where h, the clip's derivative, is 1 inside (0, 1), 0 outside and
//        0.5 at 0 and at 1, as jax.grad of jnp.clip gives it (torch.clamp's
//        1 there gives the same gradient wherever the extrema are not tied:
//        the boundary pixel's two terms cancel either way).
//   Work: two launches. The pixel pass takes a tile of DG_T frames x DG_F
//   bins of a clip (its g rows read along frames, coalesced, and turned in
//   shared memory), writes each pixel's own term to dpsd and reduces the
//   tile's sums of g d img/dd, g d img/dmin and g d img/dmax and its counts
//   of pixels equal to the min and to the max, in a fixed order, to a
//   record. The extrema pass, a block a clip, folds the clip's records in
//   order (and under share_max, in the block of the clip that holds the
//   batch's max, every clip's), then reads the clip's pixels again and
//   adds each extremum's share to its dpsd (rounded a second time there).
//   No atomics, so the result is the same in every run.
//   Bound: bytes, g and psd read once and dpsd written once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (no
// -use_fast_math: log10f, the divisions and the roundings must be the ones
// torch's CUDA kernels use, which the plain versions run).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// min/max that propagate NaN like torch.amin/amax (fminf/fmaxf drop it)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// ---------------------------------------------------------------------------
// clip_stats
// ---------------------------------------------------------------------------

constexpr int CS_THREADS = 256;
constexpr int CS_WARPS = CS_THREADS / 32;
constexpr long long CS_CHUNK = 16384;   // samples an item: 64 KB of x

struct Extrema {
  double sum;
  float xmin, xmax, pmin, pmax;
};

__device__ __forceinline__ void fold(Extrema& a, const Extrema& b) {
  a.sum += b.sum;
  a.xmin = nan_min(a.xmin, b.xmin);
  a.xmax = nan_max(a.xmax, b.xmax);
  a.pmin = nan_min(a.pmin, b.pmin);
  a.pmax = nan_max(a.pmax, b.pmax);
}

__device__ __forceinline__ void take_sample(Extrema& e, float v) {
  e.sum += static_cast<double>(v);
  e.xmin = nan_min(e.xmin, v);
  e.xmax = nan_max(e.xmax, v);
}

__device__ __forceinline__ Extrema empty_extrema() {
  return Extrema{0.0, __int_as_float(0x7f800000), __int_as_float(0xff800000),
                 __int_as_float(0x7f800000), __int_as_float(0xff800000)};
}

// The block's fold of every thread's Extrema, in a fixed order (so the f64
// sum is the same in every run); the result is valid in thread 0.
__device__ Extrema block_fold(Extrema e, Extrema* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Extrema o;
    o.sum = __shfl_down_sync(0xffffffffu, e.sum, off);
    o.xmin = __shfl_down_sync(0xffffffffu, e.xmin, off);
    o.xmax = __shfl_down_sync(0xffffffffu, e.xmax, off);
    o.pmin = __shfl_down_sync(0xffffffffu, e.pmin, off);
    o.pmax = __shfl_down_sync(0xffffffffu, e.pmax, off);
    fold(e, o);
  }
  if (lane == 0) red[warp] = e;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < CS_WARPS; ++w) fold(e, red[w]);
  return e;
}

// L1 is not coherent across blocks: read other blocks' records from L2
__device__ __forceinline__ Extrema load_record(const double* sums,
                                               const float4* ext,
                                               long long i) {
  const float4 q = __ldcg(ext + i);
  return Extrema{__ldcg(sums + i), q.x, q.y, q.z, q.w};
}

__global__ void __launch_bounds__(CS_THREADS)
clip_stats_kernel(const float* __restrict__ x,
                  const float* __restrict__ part_min,
                  const float* __restrict__ part_max, long long n, int B,
                  int T, int n_tiles, int chunks, int share_max,
                  double* rec_sum, float4* rec_ext, unsigned* clip_done,
                  unsigned* batch_done, float* __restrict__ pmin_out,
                  float* __restrict__ pmax_out,
                  unsigned char* __restrict__ finite_out,
                  float* __restrict__ params) {
  __shared__ Extrema red[CS_WARPS];
  __shared__ int last;
  const long long items = static_cast<long long>(B) * chunks;
  const long long rows = static_cast<long long>(B) * T;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = static_cast<int>(item / chunks);
    const int c = static_cast<int>(item - static_cast<long long>(b) * chunks);
    Extrema e = empty_extrema();
    // this chunk's samples: a scalar head up to the first 16-byte aligned
    // one, float4 loads, a scalar tail
    const long long s0 = c * CS_CHUNK;
    const long long len = (n - s0 < CS_CHUNK) ? n - s0 : CS_CHUNK;
    if (len > 0) {
      const float* p = x + static_cast<long long>(b) * n + s0;
      long long head = static_cast<long long>(
          ((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) >> 2);
      if (head > len) head = len;
      const long long body = (len - head) >> 2;
      if (threadIdx.x < head) take_sample(e, p[threadIdx.x]);
      const float4* v = reinterpret_cast<const float4*>(p + head);
#pragma unroll 4
      for (long long i = threadIdx.x; i < body; i += CS_THREADS) {
        const float4 q = __ldcs(v + i);
        take_sample(e, q.x);
        take_sample(e, q.y);
        take_sample(e, q.z);
        take_sample(e, q.w);
      }
      const long long tail0 = head + 4 * body;
      if (tail0 + threadIdx.x < len) take_sample(e, p[tail0 + threadIdx.x]);
    }
    // this chunk's share of the clip's partial rows, in every tile
    const long long t0 = static_cast<long long>(T) * c / chunks;
    const long long t1 = static_cast<long long>(T) * (c + 1) / chunks;
    const long long span = t1 - t0;
    for (long long i = threadIdx.x; i < span * n_tiles; i += CS_THREADS) {
      const long long k = i / span;
      const long long at = k * rows + static_cast<long long>(b) * T + t0 +
                           (i - k * span);
      e.pmin = nan_min(e.pmin, part_min[at]);
      e.pmax = nan_max(e.pmax, part_max[at]);
    }
    e = block_fold(e, red);
    if (threadIdx.x == 0) {
      rec_sum[item] = e.sum;
      rec_ext[item] = make_float4(e.xmin, e.xmax, e.pmin, e.pmax);
      __threadfence();
      last = atomicAdd(clip_done + b, 1u) == static_cast<unsigned>(chunks - 1);
    }
    __syncthreads();
    if (threadIdx.x == 0 && last) {
      // the clip is complete: fold its records in chunk order
      const long long first = static_cast<long long>(b) * chunks;
      Extrema a = load_record(rec_sum, rec_ext, first);
      for (int j = 1; j < chunks; ++j)
        fold(a, load_record(rec_sum, rec_ext, first + j));
      if (T == 0 || n_tiles == 0) a.pmin = a.pmax = 0.0f;
      const float m = static_cast<float>(a.sum / static_cast<double>(n));
      const float adet = nan_max(__fsub_rn(a.xmax, m), __fsub_rn(m, a.xmin));
      const bool underflow = a.pmax == 0.0f && adet > 0.0f && adet < 1e-10f;
      pmin_out[b] = a.pmin;
      pmax_out[b] = a.pmax;
      finite_out[b] = isfinite(a.pmin) && isfinite(a.pmax) && !underflow;
      params[3 * b + 1] = a.pmin;
      params[3 * b + 2] = a.pmax;
      if (!share_max) {
        params[3 * b] = __fadd_rn(a.pmax, 1e-20f);
      } else {
        __threadfence();
        last = atomicAdd(batch_done, 1u) == static_cast<unsigned>(B - 1);
      }
    }
    __syncthreads();
    if (share_max && last) {
      // the batch is complete: its largest pmax, NaN-propagating, and every
      // clip's base where(gm > 0, gm, pmax)
      float gm = __int_as_float(0xff800000);
      for (int i = threadIdx.x; i < B; i += CS_THREADS)
        gm = nan_max(gm, __ldcg(pmax_out + i));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        gm = nan_max(gm, __shfl_xor_sync(0xffffffffu, gm, off));
      if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5].pmax = gm;
      __syncthreads();
      gm = red[0].pmax;
      for (int w = 1; w < CS_WARPS; ++w) gm = nan_max(gm, red[w].pmax);
      for (int i = threadIdx.x; i < B; i += CS_THREADS) {
        const float own = __ldcg(pmax_out + i);
        params[3 * i] = __fadd_rn(gm > 0.0f ? gm : own, 1e-20f);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// display map
// ---------------------------------------------------------------------------

constexpr int DM_TT = 128;      // frames a tile: 32 lanes x 4 frames
constexpr int DM_TF = 32;       // bins a tile: one per bank
constexpr int DM_THREADS = 256;
constexpr int DM_WARPS = DM_THREADS / 32;
constexpr int DM_LOADS = DM_TT * DM_TF / DM_THREADS;   // 16 a thread
constexpr int MODE_NONE = 0, MODE_RGBA = 1, MODE_PALETTE = 2;
constexpr long long MAX_BLOCKS = 2147483647LL;   // grid x

__device__ __forceinline__ int swz(int t) {
  return (t & 28) | ((t & 3) ^ ((t >> 5) & 3));
}

// clip(v, 0, 1) keeping NaN, as torch.clamp and jnp.clip do
__device__ __forceinline__ float unit_clip(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// nan_to_num(10 log10(u + 1e-12)); u in [0, 1] or NaN, so never +-inf
__device__ __forceinline__ float db_of(float u) {
  const float d = __fmul_rn(10.0f, log10f(__fadd_rn(u, 1e-12f)));
  return d != d ? 0.0f : d;
}

struct Scale {
  float denom, db_min, rng;
  bool ok;
};

template <bool LOG>
__device__ __forceinline__ float pixel(float v, const Scale& s) {
  const float u = unit_clip(__fdiv_rn(v, s.denom));
  if (!LOG) return u;
  const float r = unit_clip(__fdiv_rn(__fsub_rn(db_of(u), s.db_min),
                                      s.ok ? s.rng : 1.0f));
  return s.ok ? r : 0.0f;
}

// matplotlib's index rule; a NaN pixel takes index 0
__device__ __forceinline__ uint32_t lut_index(float px) {
  const int i = static_cast<int>(__fmul_rn(px != px ? 0.0f : px, 256.0f));
  return static_cast<uint32_t>(i < 0 ? 0 : (i > 255 ? 255 : i));
}

// cp.async of one float from device to shared memory (sm_80 on)
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// An item's place: clip b, frames t0 .. t0 + nt, bins f0 .. f0 + nf.
struct Tile {
  long long b;
  int t0, f0, nt, nf;
};

__device__ __forceinline__ Tile tile_of(long long item, int T, int F,
                                        int n_tt, int n_ft) {
  Tile d;
  const long long per_clip = static_cast<long long>(n_tt) * n_ft;
  d.b = item / per_clip;
  const int r = static_cast<int>(item - d.b * per_clip);
  const int tt = r / n_ft;
  d.t0 = tt * DM_TT;
  d.f0 = (r - tt * n_ft) * DM_TF;
  d.nt = min(DM_TT, T - d.t0);
  d.nf = min(DM_TF, F - d.f0);
  return d;
}

// Copy a tile into shared memory by cp.async, flat: element e of its nt x
// nf values is frame e / nf, bin e % nf (e / nf as a product with
// ceil(2^32 / nf), exact for e * nf < 2^32), at row t, column f ^ swz(t).
__device__ __forceinline__ void stage_tile(const float* psd, const Tile& d,
                                           int T, int F, float* dst) {
  const float* src = psd + (d.b * T + d.t0) * F + d.f0;
  const int count = d.nt * d.nf;
  const unsigned magic =
      d.nf > 1 ? 0xffffffffu / static_cast<unsigned>(d.nf) + 1u : 0u;
#pragma unroll
  for (int i = 0; i < DM_LOADS; ++i) {
    const int e = threadIdx.x + i * DM_THREADS;
    if (e < count) {
      const int t = d.nf == DM_TF ? e >> 5
                    : d.nf == 1   ? e
                                  : static_cast<int>(__umulhi(
                                        static_cast<unsigned>(e), magic));
      const int f = e - t * d.nf;
      cp_async_f32(dst + t * DM_TF + (f ^ swz(t)),
                   src + static_cast<long long>(t) * F + f);
    }
  }
}

template <int MODE, bool LOG>
__global__ void __launch_bounds__(DM_THREADS)
display_map_kernel(const float* __restrict__ psd,
                   const float* __restrict__ params,
                   const uint32_t* __restrict__ lut, float* __restrict__ img,
                   uint32_t* __restrict__ words, long long items, int T,
                   int F, int n_tt, int n_ft, int with_image, int flip) {
  __shared__ float tile[DM_TT * DM_TF];
  __shared__ uint32_t s_lut[256];
  if (MODE == MODE_RGBA) s_lut[threadIdx.x] = lut[threadIdx.x];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long W4 = (T + 3) >> 2;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const Tile d = tile_of(item, T, F, n_tt, n_ft);
    stage_tile(psd, d, T, F, tile);
    cp_async_commit();
    // the clip's scale, once an item, while the copies land
    Scale s;
    s.denom = params[3 * d.b];
    s.db_min = s.rng = 0.0f;
    s.ok = false;
    if (LOG) {
      s.db_min = db_of(unit_clip(__fdiv_rn(params[3 * d.b + 1], s.denom)));
      const float db_max =
          db_of(unit_clip(__fdiv_rn(params[3 * d.b + 2], s.denom)));
      s.rng = __fsub_rn(db_max, s.db_min);
      s.ok = s.rng > 1e-6f;
    }
    cp_async_wait_all();
    __syncthreads();
    const long long clip_rows = d.b * F;
    for (int f = warp; f < d.nf; f += DM_WARPS) {
      const int bin = d.f0 + f;
      float* img_row =
          with_image ? img + (clip_rows + (flip ? F - 1 - bin : bin)) * T +
                           d.t0
                     : nullptr;
      if (MODE == MODE_PALETTE) {
        // lane q owns frames 4q .. 4q + 3 of bin f: one packed word
        const int q = lane;
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = 4 * q + j;
          const float px = pixel<LOG>(tile[t * DM_TF + (f ^ swz(t))], s);
          if (t < d.nt) {
            word |= lut_index(px) << (8 * j);
            if (with_image) img_row[t] = px;
          }
        }
        if (4 * q < d.nt)
          words[(clip_rows + F - 1 - bin) * W4 + (d.t0 >> 2) + q] = word;
      } else {
        // lane l owns frame 32 k + l of bin f: rows stored 128 bytes a warp
        uint32_t* word_row =
            MODE == MODE_RGBA ? words + (clip_rows + F - 1 - bin) * T + d.t0
                              : nullptr;
#pragma unroll
        for (int k = 0; k < DM_TT / 32; ++k) {
          const int t = 32 * k + lane;
          if (t < d.nt) {
            const float px = pixel<LOG>(tile[t * DM_TF + (f ^ swz(t))], s);
            if (with_image) img_row[t] = px;
            if (MODE == MODE_RGBA) word_row[t] = s_lut[lut_index(px)];
          }
        }
      }
    }
    __syncthreads();
  }
}

template <int MODE, bool LOG>
int display_map_run(const float* psd, const float* params,
                    const uint32_t* lut, float* img, uint32_t* words, int B,
                    int T, int F, int n_tt, int n_ft, int with_image,
                    int flip, cudaStream_t s) {
  const long long items = static_cast<long long>(B) * n_tt * n_ft;
  const unsigned blocks =
      static_cast<unsigned>(items < MAX_BLOCKS ? items : MAX_BLOCKS);
  display_map_kernel<MODE, LOG><<<blocks, DM_THREADS, 0, s>>>(
      psd, params, lut, img, words, items, T, F, n_tt, n_ft, with_image,
      flip);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int display_map_mode(const float* psd, const float* params,
                     const uint32_t* lut, float* img, uint32_t* words, int B,
                     int T, int F, int n_tt, int n_ft, int log_scale,
                     int with_image, int flip, cudaStream_t s) {
  return log_scale
             ? display_map_run<MODE, true>(psd, params, lut, img, words, B,
                                           T, F, n_tt, n_ft, with_image, flip,
                                           s)
             : display_map_run<MODE, false>(psd, params, lut, img, words, B,
                                            T, F, n_tt, n_ft, with_image,
                                            flip, s);
}

// ---------------------------------------------------------------------------
// The display map's backward
// ---------------------------------------------------------------------------

constexpr int DG_T = 32;         // frames a tile
constexpr int DG_F = 32;         // bins a tile
constexpr int DG_THREADS = 256;
constexpr int DG_WARPS = DG_THREADS / 32;
constexpr int DG_FIELDS = 5;     // a record: dd, dmin, dmax, n_min, n_max
constexpr double DB_SLOPE = 10.0 / 2.302585092994046;   // 10 / ln 10

// jnp.clip's derivative at a (JAX's 0.5 at either bound)
__device__ __forceinline__ double clip_slope(double a) {
  return (a > 0.0 && a < 1.0) ? 1.0 : ((a == 0.0 || a == 1.0) ? 0.5 : 0.0);
}

// The derivatives of the dB map db(v) at one value: by v (slope) and by
// the denominator d (-slope u), u = v / d, times the clip's derivative.
struct DbGrad {
  double db, dv, dd;
};

__device__ __forceinline__ DbGrad db_grad(double v, double d) {
  const double u = __ddiv_rn(v, d);
  const double c = u < 0.0 ? 0.0 : (u > 1.0 ? 1.0 : u);
  const double y = __dadd_rn(c, 1e-12);
  DbGrad o;
  o.db = __dmul_rn(10.0, log10(y));
  o.dv = __dmul_rn(clip_slope(u), __ddiv_rn(__ddiv_rn(DB_SLOPE, y), d));
  o.dd = -__dmul_rn(o.dv, u);
  return o;
}

// The clip's operands as the backward reads them.
struct ClipGrad {
  double d, lo, hi;        // base + 1e-20, min, max
  DbGrad glo, ghi;         // db at the extrema (LOG)
  double rng;
  bool ok;
};

__device__ __forceinline__ ClipGrad clip_grad(const float* params, int b,
                                              bool log) {
  ClipGrad c;
  c.d = params[3 * b];
  c.lo = params[3 * b + 1];
  c.hi = params[3 * b + 2];
  c.ok = true;
  c.rng = 1.0;
  if (log) {
    c.glo = db_grad(c.lo, c.d);
    c.ghi = db_grad(c.hi, c.d);
    c.rng = __dsub_rn(c.ghi.db, c.glo.db);
    c.ok = c.rng > 1e-6;
  }
  return c;
}

// A pixel's own term and its shares of (dd, dmin, dmax); record[] += them.
template <bool LOG>
__device__ __forceinline__ double pixel_grad(double v, double g,
                                             const ClipGrad& c,
                                             double (&rec)[DG_FIELDS]) {
  rec[3] += v == c.lo ? 1.0 : 0.0;
  rec[4] += v == c.hi ? 1.0 : 0.0;
  if (!LOG) {
    const double u = __ddiv_rn(v, c.d);
    const double h = clip_slope(u);
    if (h == 0.0) return 0.0;
    const double q = __dmul_rn(h, __ddiv_rn(g, c.d));
    rec[0] = __dsub_rn(rec[0], __dmul_rn(q, u));
    return q;
  }
  if (!c.ok) return 0.0;
  const DbGrad p = db_grad(v, c.d);
  const double r = __ddiv_rn(__dsub_rn(p.db, c.glo.db), c.rng);
  const double h = clip_slope(r);
  if (h == 0.0) return 0.0;
  const double k = __dmul_rn(h, __ddiv_rn(g, c.rng));
  const double a_lo = __dmul_rn(k, __dsub_rn(r, 1.0));
  const double a_hi = -__dmul_rn(k, r);
  rec[0] = __dadd_rn(rec[0], __dadd_rn(__dadd_rn(__dmul_rn(k, p.dd),
                                                 __dmul_rn(a_lo, c.glo.dd)),
                                       __dmul_rn(a_hi, c.ghi.dd)));
  rec[1] = __dadd_rn(rec[1], __dmul_rn(a_lo, c.glo.dv));
  rec[2] = __dadd_rn(rec[2], __dmul_rn(a_hi, c.ghi.dv));
  return __dmul_rn(k, p.dv);
}

// The block's sum of each thread's record, in a fixed order; valid in
// thread 0.
__device__ void block_sum(double (&rec)[DG_FIELDS],
                          double (*red)[DG_FIELDS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < DG_FIELDS; ++i)
      rec[i] += __shfl_down_sync(0xffffffffu, rec[i], off);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < DG_FIELDS; ++i) red[warp][i] = rec[i];
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < DG_WARPS; ++w)
#pragma unroll
      for (int i = 0; i < DG_FIELDS; ++i) rec[i] += red[w][i];
  __syncthreads();
}

template <bool LOG>
__global__ void __launch_bounds__(DG_THREADS)
display_grad_pixel_kernel(const float* __restrict__ g,
                          const float* __restrict__ psd,
                          const float* __restrict__ params,
                          float* __restrict__ dpsd, double* records,
                          long long items, int T, int F, int n_tt, int n_ft,
                          int flip) {
  __shared__ float gs[DG_F][DG_T + 1];
  __shared__ double red[DG_WARPS][DG_FIELDS];
  const int lane = threadIdx.x & 31;
  const int row = threadIdx.x >> 5;
  const long long tiles = static_cast<long long>(n_tt) * n_ft;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = static_cast<int>(item / tiles);
    const long long tile = item - b * tiles;
    const int t0 = static_cast<int>(tile / n_ft) * DG_T;
    const int f0 = static_cast<int>(tile % n_ft) * DG_F;
    const ClipGrad c = clip_grad(params, b, LOG);
    // g's rows of these bins, a warp a row along frames
    for (int i = row; i < DG_F; i += DG_WARPS) {
      const int f = f0 + i;
      const int t = t0 + lane;
      float v = 0.0f;
      if (f < F && t < T) {
        const int img_row = flip ? F - 1 - f : f;
        v = g[(static_cast<long long>(b) * F + img_row) * T + t];
      }
      gs[i][lane] = v;
    }
    __syncthreads();
    double rec[DG_FIELDS] = {0.0, 0.0, 0.0, 0.0, 0.0};
    const int f = f0 + lane;
    for (int i = row; i < DG_T; i += DG_WARPS) {
      const int t = t0 + i;
      if (f < F && t < T) {
        const long long at = (static_cast<long long>(b) * T + t) * F + f;
        const double own = pixel_grad<LOG>(psd[at], gs[lane][i], c, rec);
        dpsd[at] = static_cast<float>(own);
      }
    }
    block_sum(rec, red);
    if (threadIdx.x == 0)
#pragma unroll
      for (int i = 0; i < DG_FIELDS; ++i)
        records[item * DG_FIELDS + i] = rec[i];
  }
}

// The sum of records [first, first + count) of field set `fields`
// (dd, dmin, dmax, n_min, n_max), in a fixed order; valid in thread 0.
// With `top` (the batch's max), a record's n_max counts only when its
// clip's max is top, and only dd and n_max are summed.
__device__ void fold_records(const double* records, long long first,
                             long long count, long long per_clip,
                             const float* params, float top, bool batch,
                             double (&sum)[DG_FIELDS],
                             double (*red)[DG_FIELDS]) {
  for (int i = 0; i < DG_FIELDS; ++i) sum[i] = 0.0;
  for (long long j = threadIdx.x; j < count; j += DG_THREADS) {
    const double* rec = records + (first + j) * DG_FIELDS;
    if (!batch) {
#pragma unroll
      for (int i = 0; i < DG_FIELDS; ++i) sum[i] += rec[i];
    } else {
      const long long clip = (first + j) / per_clip;
      sum[0] += rec[0];
      if (params[3 * clip + 2] == top) sum[4] += rec[4];
    }
  }
  block_sum(sum, red);
}

__global__ void __launch_bounds__(DG_THREADS)
display_grad_extrema_kernel(const float* __restrict__ psd,
                            const float* __restrict__ params,
                            const double* __restrict__ records,
                            float* __restrict__ dpsd, int B, int T, int F,
                            long long per_clip, int share_max) {
  __shared__ double red[DG_WARPS][DG_FIELDS];
  __shared__ double amount[2];
  __shared__ float s_top;
  // the batch's largest max, NaN-propagating (clip_stats' share_max base)
  if (share_max) {
    float top = __int_as_float(0xff800000);
    for (int i = threadIdx.x; i < B; i += DG_THREADS)
      top = nan_max(top, params[3 * i + 2]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      top = nan_max(top, __shfl_xor_sync(0xffffffffu, top, off));
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5][0] = top;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < DG_WARPS; ++w)
        top = nan_max(top, static_cast<float>(red[w][0]));
      s_top = top;
    }
    __syncthreads();
  }
  const float top = share_max ? s_top : 0.0f;
  const bool batch_base = share_max && top > 0.0f;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const float lo = params[3 * b + 1];
    const float hi = params[3 * b + 2];
    double sum[DG_FIELDS];
    fold_records(records, b * per_clip, per_clip, per_clip, params, top,
                 false, sum, red);
    double tot[DG_FIELDS] = {0.0, 0.0, 0.0, 0.0, 0.0};
    const bool holds_top = batch_base && hi == top;
    if (holds_top)
      fold_records(records, 0, B * per_clip, per_clip, params, top, true,
                   tot, red);
    if (threadIdx.x == 0) {
      double at_hi = sum[2] + (batch_base ? 0.0 : sum[0]);
      at_hi = sum[4] > 0.0 ? at_hi / sum[4] : 0.0;
      if (holds_top && tot[4] > 0.0) at_hi += tot[0] / tot[4];
      amount[0] = sum[3] > 0.0 ? sum[1] / sum[3] : 0.0;
      amount[1] = at_hi;
    }
    __syncthreads();
    const long long n = static_cast<long long>(T) * F;
    const float* clip = psd + b * n;
    float* out = dpsd + b * n;
    for (long long i = threadIdx.x; i < n; i += DG_THREADS) {
      const float v = clip[i];
      if (v == lo || v == hi) {
        double own = out[i];
        if (v == lo) own += amount[0];
        if (v == hi) own += amount[1];
        out[i] = static_cast<float>(own);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Bytes of the workspace clip_stats_launch takes for B clips of n samples.
long long clip_stats_workspace_bytes(int B, long long n) {
  const long long chunks = n > CS_CHUNK ? (n + CS_CHUNK - 1) / CS_CHUNK : 1;
  const long long items = static_cast<long long>(B) * chunks;
  return items * (8 + 16) + (static_cast<long long>(B) + 1) * 4;
}

// Launch on `stream`; returns the cudaError_t (0 = success), or
// cudaErrorInvalidValue for sizes the kernel does not take. x is (B, n)
// contiguous f32; part_min/part_max are (n_tiles, B * T) f32 (null when T
// is 0); workspace holds clip_stats_workspace_bytes(B, n) bytes, 16-byte
// aligned; pmin/pmax are (B,) f32, finite (B,) bool, params (B, 3) f32.
int clip_stats_launch(const float* x, const float* part_min,
                      const float* part_max, int B, long long n, int T,
                      int n_tiles, int share_max, void* workspace,
                      float* pmin, float* pmax, unsigned char* finite,
                      float* params, void* stream) {
  if (B < 1 || n < 0 || T < 0 || n_tiles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunks = n > CS_CHUNK ? (n + CS_CHUNK - 1) / CS_CHUNK : 1;
  const long long items = static_cast<long long>(B) * chunks;
  char* ws = static_cast<char*>(workspace);
  float4* rec_ext = reinterpret_cast<float4*>(ws);
  double* rec_sum = reinterpret_cast<double*>(ws + items * 16);
  unsigned* counts = reinterpret_cast<unsigned*>(ws + items * 24);
  cudaError_t err = cudaMemsetAsync(
      counts, 0, (static_cast<size_t>(B) + 1) * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>(items < MAX_BLOCKS ? items : MAX_BLOCKS);
  clip_stats_kernel<<<blocks, CS_THREADS, 0, s>>>(
      x, part_min, part_max, n, B, T, n_tiles, static_cast<int>(chunks),
      share_max, rec_sum, rec_ext, counts, counts + B, pmin, pmax, finite,
      params);
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`; returns the cudaError_t (0 = success), or
// cudaErrorInvalidValue for a mode or size the kernel does not take. psd is
// (B, T, F) contiguous f32, params (B, 3) f32; mode 0 writes no words, 1
// RGBA words (B, F, T) from lut (256,) u32, 2 palette words (B, F,
// ceil(T / 4)); img (B, F, T) f32 is written when with_image is 1.
int display_map_launch(const float* psd, const float* params,
                       const uint32_t* lut, float* img, uint32_t* words,
                       int B, int T, int F, int mode, int log_scale,
                       int with_image, int flip, void* stream) {
  if (B < 1 || T < 1 || F < 1 || mode < MODE_NONE || mode > MODE_PALETTE)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tt = (T + DM_TT - 1) / DM_TT;
  const int n_ft = (F + DM_TF - 1) / DM_TF;
  if (mode == MODE_RGBA)
    return display_map_mode<MODE_RGBA>(psd, params, lut, img, words, B, T,
                                       F, n_tt, n_ft, log_scale, with_image,
                                       flip, s);
  if (mode == MODE_PALETTE)
    return display_map_mode<MODE_PALETTE>(psd, params, lut, img, words, B,
                                          T, F, n_tt, n_ft, log_scale,
                                          with_image, flip, s);
  return display_map_mode<MODE_NONE>(psd, params, lut, img, words, B, T, F,
                                     n_tt, n_ft, log_scale, with_image, flip,
                                     s);
}

// Bytes of the workspace display_backward_launch takes: a record of
// DG_FIELDS doubles a tile.
long long display_backward_workspace_bytes(int B, int T, int F) {
  const long long tiles = static_cast<long long>((T + DG_T - 1) / DG_T) *
                          ((F + DG_F - 1) / DG_F);
  return static_cast<long long>(B) * tiles * DG_FIELDS * 8;
}

// Launch both passes on `stream`; returns the cudaError_t (0 = success),
// or cudaErrorInvalidValue for sizes the kernels do not take. g is (B, F,
// T) contiguous f32 (rows flipped when flip is 1), psd (B, T, F) f32,
// params (B, 3) f32, dpsd (B, T, F) f32; workspace holds
// display_backward_workspace_bytes(B, T, F) bytes.
int display_backward_launch(const float* g, const float* psd,
                            const float* params, float* dpsd,
                            void* workspace, int B, int T, int F,
                            int log_scale, int flip, int share_max,
                            void* stream) {
  if (B < 1 || T < 1 || F < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tt = (T + DG_T - 1) / DG_T;
  const int n_ft = (F + DG_F - 1) / DG_F;
  const long long per_clip = static_cast<long long>(n_tt) * n_ft;
  const long long items = static_cast<long long>(B) * per_clip;
  const unsigned blocks =
      static_cast<unsigned>(items < MAX_BLOCKS ? items : MAX_BLOCKS);
  double* records = static_cast<double*>(workspace);
  if (log_scale)
    display_grad_pixel_kernel<true><<<blocks, DG_THREADS, 0, s>>>(
        g, psd, params, dpsd, records, items, T, F, n_tt, n_ft, flip);
  else
    display_grad_pixel_kernel<false><<<blocks, DG_THREADS, 0, s>>>(
        g, psd, params, dpsd, records, items, T, F, n_tt, n_ft, flip);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  display_grad_extrema_kernel<<<static_cast<unsigned>(B), DG_THREADS, 0,
                                s>>>(psd, params, records, dpsd, B, T, F,
                                     per_clip, share_max);
  return static_cast<int>(cudaGetLastError());
}

const char* display_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
