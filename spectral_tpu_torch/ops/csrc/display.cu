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
// display_grad_kernel<LOG> and display_grad_prep_kernel
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
//   Work: one pass over the pixels (display_grad_kernel<LOG>; a small
//   kernel first zeroes its counts and takes the batch's largest max). A
//   block an item: DG_F = 32 bins x 256 frames of a clip, a warp a chunk of
//   32 x 32 pixels on its own (no block barrier a chunk): its g rows copied
//   by cp.async into the warp's tile in shared memory along frames and read
//   turned, lane l on bin l walking the frames with the PSD read straight
//   from global memory along bins (a warp reads 128 consecutive bytes of a
//   row; 4-byte accesses, since rows of F = 513 or T = 622 floats are not
//   16-byte aligned), DG_BATCH pixels a lane in flight. The clip's operands
//   (d, 1/d, DB_SLOPE/d, the dB values and slopes at the extrema, rng,
//   1/rng, ok) are computed once an item while the first copies land, not
//   per tile and thread. A pixel then costs one f64 log10 and no division:
//   u = v / d is the reciprocal's product corrected twice by FMAs (the
//   correctly rounded quotient, so u = 1 at a pixel equal to the base and
//   db is the plain version's bits; u's place against 0 and 1 read from
//   float compares of v against 0 and d), clip_slope(r) is read from db - db_lo
//   against 0 and rng (exactly the IEEE quotient's decision), and the
//   values no decision reads use reciprocals (a few f64 ulps from the
//   plain version, far inside its tolerance). Each item reduces one record
//   (sum own u, sum k, sum k r, and its counts of pixels equal to the min
//   and the max) in a fixed order; the block that completes a clip (an
//   atomic count, as clip_stats) folds the clip's records in index order
//   and revisits only the items whose counts are non-zero to add each
//   extremum's share (rounded a second time there); under share_max with
//   a positive batch max, the block that completes the batch adds the
//   batch's base term at the clips holding that max. Nothing is
//   accumulated by atomics, so the result is the same in every run.
//   Bound: bytes, g and psd read once and dpsd written once (1.170 ms at
//   1024 x 10 s, north_star 1024/256); the per-pixel f64 work (the log10,
//   the quotient's steps, the products and sums) is the second limit.
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

constexpr int DG_F = 32;         // bins a strip: one a lane
constexpr int DG_T = 32;         // frames a chunk: a warp's, 32 x 32 pixels
constexpr int DG_CHUNKS = 8;     // chunks an item: 256 frames
constexpr int DG_BATCH = 2;      // a lane's pixels in flight at once
constexpr int DG_THREADS = 256;
constexpr int DG_MIN_BLOCKS = 5; // blocks an SM: at most 48 registers
constexpr int DG_WARPS = DG_THREADS / 32;
constexpr int DG_FIELDS = 5;     // a record: su, sk, skr, n_lo, n_hi
constexpr int DG_CLIP = 4;       // a clip's fold: c_d, n_hi, at_lo, at_hi
constexpr double DB_SLOPE = 10.0 / 2.302585092994046;   // 10 / ln 10

// jnp.clip's derivative at a (JAX's 0.5 at either bound)
__device__ __forceinline__ double clip_slope(double a) {
  return (a > 0.0 && a < 1.0) ? 1.0 : ((a == 0.0 || a == 1.0) ? 0.5 : 0.0);
}

// The derivatives of the dB map db(v) at one of the clip's extrema, in the
// plain version's operations: by v (slope) and by the denominator d
// (-slope u), u = v / d, times the clip's derivative.
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

// The clip's operands a pixel reads, computed once an item in shared
// memory: d = base + 1e-20, its reciprocal and DB_SLOPE / d, the extrema
// and the min's dB value; fast when d is finite and positive (then v / d
// is the reciprocal's product corrected twice, see quotient()). The max's
// dB value and both extrema's slopes (ClipEnds) only the clip's fold
// reads.
struct ClipOps {
  double d, inv_d, sd, db_lo;
  float df, lo, hi;
  int fast;
};

struct ClipEnds {
  double db_hi, dv_lo, dd_lo, dv_hi, dd_hi;
};


// u = v / d rounded to nearest, as __ddiv_rn gives it, without a
// division, and u's clip and clip_slope(u): q0 = v (1/d) is within 1.5
// ulps; each step q + (v - q d) (1/d), the residual exact in an FMA, lands
// within half an ulp plus a hair, and the second is the correctly rounded
// quotient (Markstein's theorem: 1/d correctly rounded, q within one ulp).
// With f32 operands, d > 0 finite and v finite, no step under- or
// overflows, and u's place against 0 and 1 is v's against 0 and d (float
// compares); otherwise the IEEE division and u's own.
struct Quotient {
  double u, clipped, slope;
};

__device__ __forceinline__ Quotient quotient(float vf, const ClipOps& c) {
  const double v = vf;
  Quotient o;
  if (!c.fast || !isfinite(vf)) {
    o.u = __ddiv_rn(v, c.d);
    o.clipped = o.u < 0.0 ? 0.0 : (o.u > 1.0 ? 1.0 : o.u);
    o.slope = clip_slope(o.u);
    return o;
  }
  double q = __dmul_rn(v, c.inv_d);
  q = __fma_rn(__fma_rn(-q, c.d, v), c.inv_d, q);
  o.u = __fma_rn(__fma_rn(-q, c.d, v), c.inv_d, q);
  o.clipped = vf >= c.df ? 1.0 : (vf <= 0.0f ? 0.0 : o.u);
  o.slope = (vf > 0.0f && vf < c.df)
                ? 1.0
                : ((vf == 0.0f || vf == c.df) ? 0.5 : 0.0);
  return o;
}

// An approximate 1/y (MUFU's 64-bit reciprocal seed).
__device__ __forceinline__ double rcp_approx(double y) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;\n" : "=d"(r) : "d"(y));
  return r;
}

// 1/y for y in [1e-12, 1 + 1e-12]: the seed and two Newton steps (a value
// only: no decision reads it).
__device__ __forceinline__ double recip(double y) {
  double r = rcp_approx(y);
  r = __fma_rn(r, __fma_rn(-y, r, 1.0), r);
  return __fma_rn(r, __fma_rn(-y, r, 1.0), r);
}

// A thread's share of an item's record: su = sum own u, sk = sum k, skr =
// sum k r over the pixels whose term is live (the clip's sums are then
// c_d = -su + dd_lo (skr - sk) - dd_hi skr, c_lo = dv_lo (skr - sk), c_hi
// = -dv_hi skr under LOG, c_d = -su without), and the counts of pixels
// equal to the clip's min and max.
struct Acc {
  double su, sk, skr;
  int n_lo, n_hi;
};

// A pixel's own term; acc += its shares. Every value a decision reads (u,
// its clip, the dB value, r's place against 0 and 1) is the plain
// version's: u the correctly rounded quotient, db the same f64 log10 of
// the same y, and clip_slope(r) read from num = db - db_lo against 0 and
// rng, which is clip_slope(RN(num / rng)) for rng > 0 (num < rng gives a
// quotient at most 1 - 2^-53, num > rng at least 1 + 2^-52; no quotient
// underflows: db lies in [-120, 4.4e-12], so num is 0 or past 1e-16 in
// size). The values no decision reads take reciprocals: k = h g / rng, r =
// num / rng, DB_SLOPE / (y d).
template <bool LOG>
__device__ __forceinline__ float pixel_grad(float vf, float gf,
                                            const ClipOps& c, double rng,
                                            double inv_rng, bool ok,
                                            Acc& acc) {
  acc.n_lo += vf == c.lo;
  acc.n_hi += vf == c.hi;
  if (!ok) return 0.0f;
  const Quotient qu = quotient(vf, c);
  const double u = qu.u, hu = qu.slope;
  if (!LOG) {
    if (hu == 0.0) return 0.0f;
    const double q = __dmul_rn(hu, __dmul_rn(static_cast<double>(gf),
                                             c.inv_d));
    acc.su = __fma_rn(q, u, acc.su);
    return static_cast<float>(q);
  }
  const double y = __dadd_rn(qu.clipped, 1e-12);
  const double num = __dsub_rn(__dmul_rn(10.0, log10(y)), c.db_lo);
  const double hr = (num > 0.0 && num < rng)
                        ? 1.0
                        : ((num == 0.0 || num == rng) ? 0.5 : 0.0);
  if (hr == 0.0) return 0.0f;
  const double k =
      __dmul_rn(hr, __dmul_rn(static_cast<double>(gf), inv_rng));
  const double own = __dmul_rn(k, __dmul_rn(hu, __dmul_rn(c.sd, recip(y))));
  acc.su = __fma_rn(own, u, acc.su);
  acc.sk = __dadd_rn(acc.sk, k);
  acc.skr = __fma_rn(k, __dmul_rn(num, inv_rng), acc.skr);
  return static_cast<float>(own);
}

// The block's sum of each thread's fields, in a fixed order (the same
// bits in every run); valid in thread 0.
__device__ void block_fold(double (&v)[DG_FIELDS],
                           double (*red)[DG_FIELDS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < DG_FIELDS; ++i)
      v[i] += __shfl_down_sync(0xffffffffu, v[i], off);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < DG_FIELDS; ++i) red[warp][i] = v[i];
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < DG_WARPS; ++w)
#pragma unroll
      for (int i = 0; i < DG_FIELDS; ++i) v[i] += red[w][i];
  __syncthreads();
}

// An item's place: clip b, frames t0 .. t0 + DG_CHUNKS DG_T, bins f0 ..
// f0 + DG_F; its record is item - b per_clip within the clip's.
struct GradItem {
  long long b;
  int t0, f0;
};

__device__ __forceinline__ GradItem grad_item(long long item,
                                              long long per_clip, int n_ft) {
  GradItem it;
  it.b = item / per_clip;
  const int r = static_cast<int>(item - it.b * per_clip);
  it.t0 = (r / n_ft) * (DG_T * DG_CHUNKS);
  it.f0 = (r % n_ft) * DG_F;
  return it;
}

// Copy a warp's chunk of g (the item's DG_F bin rows, DG_T frames from t0)
// into its tile in shared memory by cp.async, a row at a time along
// frames (128 bytes a warp), to be read turned: lane l on bin l.
__device__ __forceinline__ void grad_stage(const float* g, long long b,
                                           int T, int F, int t0, int f0,
                                           int flip, float (*gs)[DG_T + 1]) {
  const int lane = threadIdx.x & 31;
  const int t = t0 + lane;
  if (t >= T) return;
#pragma unroll 4
  for (int row = 0; row < DG_F; ++row) {
    const int f = f0 + row;
    if (f < F)
      cp_async_f32(&gs[row][lane],
                   g + (b * F + (flip ? F - 1 - f : f)) * T + t);
  }
}

// The block's indices 0 .. DG_THREADS - 1 whose `hit` is set, in order,
// into list[0 ..); returns their count. list holds DG_LIST ints. The whole
// block; the caller synchronises before the next call.
constexpr int DG_LIST = DG_THREADS + DG_WARPS + 1;

__device__ int block_list(bool hit, int* list) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned mask = __ballot_sync(0xffffffffu, hit);
  if (lane == 0) list[DG_THREADS + warp] = __popc(mask);
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += list[DG_THREADS + w];
  if (hit) list[base + __popc(mask & ((1u << lane) - 1u))] = threadIdx.x;
  if (threadIdx.x == 0) {
    int n = 0;
    for (int w = 0; w < DG_WARPS; ++w) n += list[DG_THREADS + w];
    list[DG_LIST - 1] = n;
  }
  __syncthreads();
  return list[DG_LIST - 1];
}

// Add each extremum's share to the clip's pixels equal to its min or max
// (split evenly among ties: the amounts are already divided by the
// counts), in the items whose records count any, the records read in
// index order; the own term there is rounded a second time. The whole
// block; items are disjoint, so the result does not depend on the order.
__device__ void grad_extrema(const float* psd, float* dpsd,
                             const double* records, long long b,
                             long long per_clip, int n_ft, int T, int F,
                             float lo, float hi, double a_lo, double a_hi,
                             int* list) {
  if (a_lo == 0.0 && a_hi == 0.0) return;   // adds nothing (a NaN adds)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const double* rec = records + b * per_clip * DG_FIELDS;
  for (long long r0 = 0; r0 < per_clip; r0 += DG_THREADS) {
    const long long i = r0 + threadIdx.x;
    const int n = block_list(
        i < per_clip && (__ldcg(rec + i * DG_FIELDS + 3) > 0.0 ||
                         __ldcg(rec + i * DG_FIELDS + 4) > 0.0),
        list);
    for (int k = 0; k < n; ++k) {
      const GradItem it = grad_item(b * per_clip + r0 + list[k], per_clip,
                                    n_ft);
      // a thread's frames warp, warp + DG_WARPS, ... of its bin, eight
      // loaded before any is compared (a round trip for eight frames)
      constexpr int PER = DG_T * DG_CHUNKS / DG_WARPS, BATCH = 8;
      const int f = it.f0 + lane;
      for (int j0 = 0; j0 < PER; j0 += BATCH) {
        float v[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const int t = it.t0 + warp + DG_WARPS * (j0 + j);
          v[j] = (t < T && f < F) ? psd[(b * T + t) * F + f]
                                  : __int_as_float(0x7fc00000);   // NaN
        }
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          if (v[j] == lo || v[j] == hi) {
            const long long at =
                (b * T + it.t0 + warp + DG_WARPS * (j0 + j)) * F + f;
            double own = __ldcg(dpsd + at);
            if (v[j] == lo) own += a_lo;
            if (v[j] == hi) own += a_hi;
            dpsd[at] = static_cast<float>(own);
          }
        }
      }
    }
    __syncthreads();
  }
}

// The workspace: a record a item, a fold a clip, the completion counts (a
// clip's, the batch's) and the batch's largest max.
struct GradWork {
  double* records;   // (items, DG_FIELDS)
  double* clips;     // (B, DG_CLIP)
  unsigned* done;    // (B + 1,): a clip's items done, then the clips'
  float* top;
};

// Zero the counts; block 0 also takes the batch's largest max,
// NaN-propagating (clip_stats' share_max base), under share_max.
__global__ void __launch_bounds__(DG_THREADS)
display_grad_prep_kernel(const float* __restrict__ params, int B,
                         int share_max, GradWork w) {
  for (long long i = blockIdx.x * static_cast<long long>(DG_THREADS) +
                     threadIdx.x;
       i <= B; i += static_cast<long long>(gridDim.x) * DG_THREADS)
    w.done[i] = 0u;
  if (blockIdx.x != 0 || !share_max) return;
  __shared__ float red[DG_WARPS];
  float top = __int_as_float(0xff800000);
  for (int i = threadIdx.x; i < B; i += DG_THREADS)
    top = nan_max(top, params[3 * i + 2]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    top = nan_max(top, __shfl_xor_sync(0xffffffffu, top, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = top;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < DG_WARPS; ++i) top = nan_max(top, red[i]);
    *w.top = top;
  }
}

// The clip's records folded in a fixed order (thread j the records j, j +
// DG_THREADS, ..., then block_fold): its sums c_d, c_lo, c_hi, counts and
// the amounts at its min and max; the extrema step now, or, when it holds
// the batch's max under a batch base, by the block that finishes the
// batch. Then, under a batch base, the batch's count; the block that
// finishes it adds the sum of every clip's c_d over the pixels at the
// batch's max.
template <bool LOG>
__device__ void grad_clip_done(const float* psd, const float* params,
                               float* dpsd, const GradWork& w, long long b,
                               long long per_clip, int n_ft, int B, int T,
                               int F, bool batch_base, float top,
                               const ClipOps& c, const ClipEnds& e,
                               double (*red)[DG_FIELDS],
                               int* list, int* tops, int* flag,
                               double* amount) {
  __threadfence();
  double s[DG_FIELDS] = {0.0, 0.0, 0.0, 0.0, 0.0};
  const double* rec = w.records + b * per_clip * DG_FIELDS;
  for (long long j = threadIdx.x; j < per_clip; j += DG_THREADS)
#pragma unroll
    for (int i = 0; i < DG_FIELDS; ++i)
      s[i] += __ldcg(rec + j * DG_FIELDS + i);
  block_fold(s, red);
  if (threadIdx.x == 0) {
    double c_d = -s[0], c_lo = 0.0, c_hi = 0.0;
    if (LOG) {
      const double a_lo = __dsub_rn(s[2], s[1]);
      c_d = __dadd_rn(__dadd_rn(c_d, __dmul_rn(e.dd_lo, a_lo)),
                      -__dmul_rn(e.dd_hi, s[2]));
      c_lo = __dmul_rn(e.dv_lo, a_lo);
      c_hi = -__dmul_rn(e.dv_hi, s[2]);
    }
    const bool holds = batch_base && c.hi == top;
    double at_hi = batch_base ? c_hi : __dadd_rn(c_hi, c_d);
    at_hi = s[4] > 0.0 ? at_hi / s[4] : 0.0;
    amount[0] = s[3] > 0.0 ? c_lo / s[3] : 0.0;
    amount[1] = at_hi;
    double* out = w.clips + b * DG_CLIP;
    out[0] = c_d;
    out[1] = holds ? s[4] : 0.0;
    out[2] = amount[0];
    out[3] = amount[1];
    *flag = holds;
  }
  __syncthreads();
  if (!*flag)
    grad_extrema(psd, dpsd, w.records, b, per_clip, n_ft, T, F, c.lo, c.hi,
                 amount[0], amount[1], list);
  if (!batch_base) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *flag = atomicAdd(w.done + B, 1u) == static_cast<unsigned>(B - 1);
  __syncthreads();
  if (!*flag) return;
  // the batch is complete: sum c_d over every clip and the counts at the
  // batch's max, in clip order
  double t[DG_FIELDS] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (long long j = threadIdx.x; j < B; j += DG_THREADS) {
    t[0] += __ldcg(w.clips + j * DG_CLIP);
    t[1] += __ldcg(w.clips + j * DG_CLIP + 1);
  }
  block_fold(t, red);
  if (threadIdx.x == 0) amount[2] = t[1] > 0.0 ? t[0] / t[1] : 0.0;
  __syncthreads();
  // the clips that hold the batch's max, DG_THREADS at a time
  for (long long j0 = 0; j0 < B; j0 += DG_THREADS) {
    const long long j = j0 + threadIdx.x;
    const int n = block_list(j < B && params[3 * j + 2] == top, tops);
    for (int k = 0; k < n; ++k) {
      const long long jj = j0 + tops[k];
      const double* cj = w.clips + jj * DG_CLIP;
      grad_extrema(psd, dpsd, w.records, jj, per_clip, n_ft, T, F,
                   params[3 * jj + 1], top, __ldcg(cj + 2),
                   __ldcg(cj + 3) + amount[2], list);
    }
    __syncthreads();
  }
}

// The pass over the pixels: a block an item (DG_F bins x DG_CHUNKS chunks
// of DG_T frames of a clip), warp w its chunks w, w + DG_WARPS, ... on its
// own (no block barrier a chunk): the chunk's g rows copied into the
// warp's tile by cp.async and read turned, lane l on bin l walking the
// chunk's frames, the PSD read straight from global memory along bins
// (coalesced), DG_BATCH pixels a lane in flight with the next batch's
// loads; each pixel's own term stored, the item's record reduced once;
// the block that completes a clip (an atomic count) folds its records
// and adds the extrema's shares.
template <bool LOG>
__global__ void __launch_bounds__(DG_THREADS, DG_MIN_BLOCKS)
display_grad_kernel(const float* __restrict__ g, const float* __restrict__ psd,
                    const float* __restrict__ params, float* dpsd,
                    GradWork w, long long items, int B, int T, int F,
                    int n_ft, int n_tc, int flip, int share_max) {
  __shared__ float gs[DG_WARPS][DG_F][DG_T + 1];
  __shared__ double red[DG_WARPS][DG_FIELDS];
  __shared__ ClipOps s_ops;
  __shared__ ClipEnds s_ends;
  __shared__ int list[DG_LIST];
  __shared__ int tops[DG_LIST];
  __shared__ int flag[1];
  __shared__ double amount[3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long per_clip = static_cast<long long>(n_tc) * n_ft;
  const float top = share_max ? *w.top : 0.0f;
  const bool batch_base = share_max && top > 0.0f;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const GradItem it = grad_item(item, per_clip, n_ft);
    // the warp's first chunk in flight while the clip's operands are made
    grad_stage(g, it.b, T, F, it.t0 + warp * DG_T, it.f0, flip, gs[warp]);
    cp_async_commit();
    if (threadIdx.x == 0) {
      const double d = params[3 * it.b];
      s_ops.d = d;
      s_ops.df = params[3 * it.b];
      s_ops.inv_d = __ddiv_rn(1.0, d);
      s_ops.sd = __ddiv_rn(DB_SLOPE, d);
      s_ops.fast = isfinite(d) && d > 0.0;
      s_ops.lo = params[3 * it.b + 1];
      s_ops.hi = params[3 * it.b + 2];
      if (LOG) {
        const DbGrad lo = db_grad(s_ops.lo, d);
        s_ops.db_lo = lo.db;
        s_ends.dv_lo = lo.dv;
        s_ends.dd_lo = lo.dd;
      }
    }
    if (LOG && threadIdx.x == 32) {
      const DbGrad hi = db_grad(params[3 * it.b + 2], params[3 * it.b]);
      s_ends.db_hi = hi.db;
      s_ends.dv_hi = hi.dv;
      s_ends.dd_hi = hi.dd;
    }
    __syncthreads();           // the clip's operands
    const ClipOps c = s_ops;
    double rng = 1.0, inv_rng = 1.0;
    bool ok = true;
    if (LOG) {
      rng = __dsub_rn(s_ends.db_hi, c.db_lo);
      ok = rng > 1e-6;
      inv_rng = ok ? __ddiv_rn(1.0, rng) : 1.0;
    }
    Acc acc = {0.0, 0.0, 0.0, 0, 0};
    const int f = it.f0 + lane;
    for (int k = warp; k < DG_CHUNKS; k += DG_WARPS) {
      const int t0 = it.t0 + k * DG_T;
      if (k != warp) {         // a later chunk of this warp's
        __syncwarp();          // the tile's reads done
        grad_stage(g, it.b, T, F, t0, it.f0, flip, gs[warp]);
        cp_async_commit();
      }
      cp_async_wait_all();
      __syncwarp();            // the tile staged for every lane
      if (f >= F || t0 >= T) continue;
      const int nt = min(DG_T, T - t0);
      const float* src = psd + (it.b * T + t0) * F + f;
      float* dst = dpsd + (it.b * T + t0) * F + f;
      float v[DG_BATCH], nv[DG_BATCH];
#pragma unroll
      for (int j = 0; j < DG_BATCH; ++j)
        nv[j] = j < nt ? src[static_cast<long long>(j) * F] : 0.0f;
      for (int j0 = 0; j0 < nt; j0 += DG_BATCH) {
#pragma unroll
        for (int j = 0; j < DG_BATCH; ++j) {
          v[j] = nv[j];
          const int jn = j0 + DG_BATCH + j;
          nv[j] = jn < nt ? src[static_cast<long long>(jn) * F] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < DG_BATCH; ++j)
          if (j0 + j < nt)
            dst[static_cast<long long>(j0 + j) * F] = pixel_grad<LOG>(
                v[j], gs[warp][lane][j0 + j], c, rng, inv_rng, ok, acc);
      }
    }
    // the item's record; after the block's barrier thread 0's fence and
    // count release the block's stores too (cumulativity)
    double vals[DG_FIELDS] = {acc.su, acc.sk, acc.skr,
                              static_cast<double>(acc.n_lo),
                              static_cast<double>(acc.n_hi)};
    block_fold(vals, red);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < DG_FIELDS; ++i)
        w.records[item * DG_FIELDS + i] = vals[i];
      __threadfence();
      flag[0] = atomicAdd(w.done + it.b, 1u) ==
                static_cast<unsigned>(per_clip - 1);
    }
    __syncthreads();
    if (flag[0])
      grad_clip_done<LOG>(psd, params, dpsd, w, it.b, per_clip, n_ft, B, T,
                          F, batch_base, top, c, s_ends, red, list, tops,
                          flag, amount);
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
// DG_FIELDS doubles an item, DG_CLIP doubles a clip, B + 1 counts and the
// batch's largest max.
long long display_backward_workspace_bytes(int B, int T, int F) {
  const long long items =
      static_cast<long long>(B) *
      ((T + DG_T * DG_CHUNKS - 1) / (DG_T * DG_CHUNKS)) *
      ((F + DG_F - 1) / DG_F);
  return items * DG_FIELDS * 8 + static_cast<long long>(B) * DG_CLIP * 8 +
         (static_cast<long long>(B) + 1) * 4 + 4;
}

// Launch the backward on `stream` (a kernel that zeroes the counts and
// takes the batch's largest max, then the pass over the pixels); returns
// the cudaError_t (0 = success), or cudaErrorInvalidValue for sizes the
// kernels do not take. g is (B, F, T) contiguous f32 (rows flipped when
// flip is 1), psd (B, T, F) f32, params (B, 3) f32, dpsd (B, T, F) f32;
// workspace holds display_backward_workspace_bytes(B, T, F) bytes,
// 8-byte aligned.
int display_backward_launch(const float* g, const float* psd,
                            const float* params, float* dpsd,
                            void* workspace, int B, int T, int F,
                            int log_scale, int flip, int share_max,
                            void* stream) {
  if (B < 1 || T < 1 || F < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tc = (T + DG_T * DG_CHUNKS - 1) / (DG_T * DG_CHUNKS);
  const int n_ft = (F + DG_F - 1) / DG_F;
  const long long per_clip = static_cast<long long>(n_tc) * n_ft;
  const long long items = static_cast<long long>(B) * per_clip;
  char* ws = static_cast<char*>(workspace);
  GradWork w;
  w.records = reinterpret_cast<double*>(ws);
  w.clips = reinterpret_cast<double*>(ws + items * DG_FIELDS * 8);
  w.done = reinterpret_cast<unsigned*>(
      ws + items * DG_FIELDS * 8 + static_cast<long long>(B) * DG_CLIP * 8);
  w.top = reinterpret_cast<float*>(w.done + B + 1);
  const long long prep = (static_cast<long long>(B) + DG_THREADS) / DG_THREADS;
  display_grad_prep_kernel<<<static_cast<unsigned>(prep < 1024 ? prep : 1024),
                             DG_THREADS, 0, s>>>(params, B, share_max, w);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const unsigned blocks =
      static_cast<unsigned>(items < MAX_BLOCKS ? items : MAX_BLOCKS);
  if (log_scale)
    display_grad_kernel<true><<<blocks, DG_THREADS, 0, s>>>(
        g, psd, params, dpsd, w, items, B, T, F, n_ft, n_tc, flip,
        share_max);
  else
    display_grad_kernel<false><<<blocks, DG_THREADS, 0, s>>>(
        g, psd, params, dpsd, w, items, B, T, F, n_ft, n_tc, flip,
        share_max);
  return static_cast<int>(cudaGetLastError());
}

const char* display_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
