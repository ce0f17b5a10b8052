// The mel projection for NVIDIA Hopper (sm_90a).
//
// The JAX package applies its mel filterbank outside any Pallas kernel, as
// an XLA einsum (spectral_tpu/parallel/sharding.py:99-103): every mel row
// m of the mel band [m_lo, m_hi) (the fmin/fmax mask on the mel-centre
// axis, sharding.py:71-75) is
//
//   mel[b, t, m] = sum_f fb[m, f] * psd[b, t, f]
//
// over all F bins, in float32. Here the same function, in float64:
//
// mel_project_kernel (mel_project_launch)
//   in : psd (R, F) f32, the STFT kernel's frame-major full-band PSD, R =
//        B * T rows; each mel row's span of nonzero weights, from the host
//        (ops/mel_cuda.py::mel_spans): start[m], len[m] and off[m], its
//        len[m] float64 weights at w[off[m]] (the filterbank's columns
//        start[m] .. start[m] + len[m] - 1, zeros inside the span kept)
//   out: mel (R, M) f32, M = m_hi - m_lo rows of the band, and the row's
//        NaN-propagating (min, max) over its M values, part_min / part_max
//        (R,) f32, the STFT kernels' partials layout (2, 1, B, T), so
//        clip_stats and the display map take the mel rows unchanged.
//   The sum: over the span in float64, bin by bin from its first, rounded
//   once to float32 at the store. A triangle holds 2-24 nonzero weights of
//   513 bins at 128 mels (1.5% of the dense product's).
//   Non-finite bins: the dense product multiplies every bin, so a
//   non-finite bin where fb[m, f] == 0 makes row m NaN (0 * inf, 0 * NaN),
//   which the span sum alone would miss. So each PSD row's first and last
//   non-finite bin are found in the staged tile; a mel row whose span does
//   not hold both is NaN. Inside the span the sum carries them as the
//   dense product does (a NaN bin, or an inf one at a zero weight, NaN; an
//   inf one at a positive weight, inf). A row with no nonzero weight is 0,
//   or NaN by the same rule.
//   Work: a persistent grid (a block of 16 warps an SM: two tiles of 32
//   PSD rows of 513 bins take 128 KB), each block walking tiles of up to
//   32 PSD rows. The next tile's rows are copied into shared memory by
//   cp.async (16-byte copies of the tile's contiguous run when F is odd)
//   while this one is scanned for non-finite bins (one flat pass, the
//   exact first and last a row only in a tile that has one) and summed.
//   Warp w sums the groups of MP_CHAINS = 2 consecutive mel rows w, w +
//   16, ..., its two FMA chains side by side, with lane l on the tile's
//   row l: a warp's lanes run one span, so one length and no divergence
//   (a lane a mel row, as before, paced each pass by its widest lane: 43
//   dependent FMAs a row at 128 mels), its weights (8 KB at 128 mels) read
//   as one broadcast from shared memory, where the span table is staged
//   once a block too, and the tile read at an odd stride, free of bank
//   conflicts. The mel values are turned through shared memory,
//   and a warp a row stores them (consecutive) and folds the row's
//   partials exactly as before (lane j the values j, j + 32, ... in order,
//   then the xor butterfly, lane 0's result), so every output keeps its
//   bits, NaN payloads included.
//   Bound: bytes, the PSD read once and the mel rows written once (0.49 ms
//   at 1024 clips x 622 frames x 513 bins, 128 mels, on 3.35 TB/s).
//
// mel_backward_kernel (mel_backward_launch): the projection's adjoint, for
// the gradient through the mel rows (the JAX package's jax.grad of its
// einsum)
//   in : dmel (R, M) f32, the gradient of mel; each bin's mel rows, from
//        the host (ops/mel_cuda.py::bin_table, the span table transposed):
//        bstart[f] and bcount[f], the rows m (ascending) whose span holds
//        bin f at brow[bstart[f] ..] and their weights fb[m, f] at bw[..]
//   out: dpsd (R, F) f32,
//          dpsd[r, f] = sum_m fb[m, f] dmel[r, m]
//        over the mel band's rows whose span holds f, in float64, rounded
//        once; a bin no row covers gets 0. Non-finite gradients as the
//        dense product dmel @ fb gives them: a non-finite dmel[r, m] makes
//        every bin outside row m's span NaN (0 * inf).
//   Work: a warp a row, its M gradients staged in shared memory (and a
//   count of the non-finite ones); lane l sums bins l, l + 32, ..., so a
//   warp's stores of one row are consecutive.
//   Bound: bytes, dmel read once and dpsd written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MEL_MAX_WARPS = 8;     // the backward's rows a block at most
constexpr int MEL_SMEM = 48 * 1024;  // the backward's staging, at most

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

constexpr int MP_THREADS = 512;
constexpr int MP_WARPS = MP_THREADS / 32;
constexpr int MP_CHAINS = 2;         // mel rows a warp sums at once
constexpr int MP_ROWS = 32;          // PSD rows a tile at most: a lane each
constexpr int MP_W_SMEM = 16 * 1024; // the weights staged up to this

// cp.async of 16 or 4 bytes from device to shared memory (sm_80 on)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
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

__host__ __device__ __forceinline__ long long align16(long long n) {
  return (n + 15) & ~15LL;
}

// The shared memory of a block of `rows` rows: MP_W_SMEM bytes for the
// weights, two tiles of rows x Fs floats (each 16-byte aligned), the mel
// rows' staging rows x Ms floats, the span table (3 M ints) and each
// row's first and last non-finite bin; Fs and Ms the odd strides F | 1
// and M | 1.
struct MelSmem {
  long long w, tiles, out, table, bad, total;
};

__host__ __device__ __forceinline__ MelSmem mel_smem(int rows, int F,
                                                     int M) {
  MelSmem s;
  s.w = 0;
  s.tiles = MP_W_SMEM;
  s.out = s.tiles + 2 * align16(static_cast<long long>(rows) * (F | 1) * 4);
  s.table = s.out + align16(static_cast<long long>(rows) * (M | 1) * 4);
  s.bad = s.table + align16(3LL * M * 4);
  s.total = s.bad + 2LL * rows * 4;
  return s;
}

// Copy rows r0 .. r0 + n of the PSD into a tile (row l at l * Fs): one flat
// run of 16-byte copies when the rows are contiguous there (F odd, so Fs =
// F) and aligned, else 4-byte copies a row.
__device__ __forceinline__ void mel_stage(const float* psd, long long r0,
                                          int n, int F, bool vec,
                                          float* tile) {
  const float* src = psd + r0 * F;
  const int Fs = F | 1;
  if (vec) {
    const int count = n * F;
    const int quads = count >> 2;
    for (int i = threadIdx.x; i < quads; i += MP_THREADS)
      cp_async16(tile + 4 * i, src + 4 * i);
    for (int i = 4 * quads + threadIdx.x; i < count; i += MP_THREADS)
      cp_async4(tile + i, src + i);
  } else {
    for (int l = 0; l < n; ++l)
      for (int f = threadIdx.x; f < F; f += MP_THREADS)
        cp_async4(tile + l * Fs + f, src + static_cast<long long>(l) * F + f);
  }
}

// A persistent block walks tiles of `rows` PSD rows: the next tile's copy
// in flight (cp.async, double-buffered) while this one is scanned for
// non-finite bins (one flat pass; a warp a row for the first and last only
// where there is one), summed (warp w the groups of MP_CHAINS consecutive
// mel rows w, w + MP_WARPS, ..., a group's chains side by side; lane l the
// tile's row l, so a warp's lanes run one span, of one length, with its
// weights broadcast from shared memory, and read the tile at stride Fs,
// odd, free of bank conflicts) into a staging tile, then stored (a warp a
// row, its M values consecutive) with the row's partials
// folded as the previous kernel folded them: lane j takes the values j, j
// + 32, ... in order from +-inf, then the xor butterfly, lane 0's result.
// Every mel value is the same f64 FMA chain over its span from the span's
// first bin, rounded once; so the outputs are that kernel's bits.
template <bool WSMEM>
__device__ __forceinline__ void mel_tiles(
    const float* __restrict__ psd, const int* __restrict__ start,
    const int* __restrict__ len, const int* __restrict__ off,
    const double* __restrict__ w, int n_w, long long R, int F, int M,
    int rows, int vec, float* __restrict__ out, float* __restrict__ part_min,
    float* __restrict__ part_max, unsigned char* smem) {
  const MelSmem lay = mel_smem(rows, F, M);
  double* s_w = reinterpret_cast<double*>(smem + lay.w);
  float* tiles = reinterpret_cast<float*>(smem + lay.tiles);
  float* o = reinterpret_cast<float*>(smem + lay.out);
  int* s_start = reinterpret_cast<int*>(smem + lay.table);
  int* s_len = s_start + M;
  int* s_off = s_len + M;
  int* first = reinterpret_cast<int*>(smem + lay.bad);
  int* last = first + rows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Fs = F | 1, Ms = M | 1;
  const long long tile_floats =
      align16(static_cast<long long>(rows) * Fs * 4) / 4;
  const long long n_tiles = (R + rows - 1) / rows;
  for (int m = threadIdx.x; m < M; m += MP_THREADS) {
    s_start[m] = start[m];
    s_len[m] = len[m];
    s_off[m] = off[m];
  }
  if (WSMEM)
    for (int i = threadIdx.x; i < n_w; i += MP_THREADS) s_w[i] = w[i];
  const double* wts = WSMEM ? s_w : w;
  long long tile = blockIdx.x;
  if (tile < n_tiles) {
    mel_stage(psd, tile * rows,
              static_cast<int>(min(static_cast<long long>(rows),
                                   R - tile * rows)),
              F, vec, tiles);
    cp_async_commit();
  }
  for (int buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const long long r0 = tile * rows;
    const int n = static_cast<int>(min(static_cast<long long>(rows), R - r0));
    const float* x = tiles + buf * tile_floats;
    cp_async_wait_all();
    __syncthreads();           // this tile staged; the other buffer free
    const long long next = tile + gridDim.x;
    if (next < n_tiles) {
      mel_stage(psd, next * rows,
                static_cast<int>(min(static_cast<long long>(rows),
                                     R - next * rows)),
                F, vec, tiles + (buf ^ 1) * tile_floats);
      cp_async_commit();
    }
    // a non-finite bin anywhere in the tile? one flat pass of 16-byte
    // reads when F is odd (the rows contiguous); an even F (the padded
    // stride) takes the exact scan below every time
    int bad = !(F & 1);
    if (F & 1) {
      const int count = n * F;
      const float4* x4 = reinterpret_cast<const float4*>(x);
      for (int i = threadIdx.x; i < count / 4; i += MP_THREADS) {
        const float4 q = x4[i];
        bad |= !isfinite(q.x) | !isfinite(q.y) | !isfinite(q.z) |
               !isfinite(q.w);
      }
      for (int i = 4 * (count / 4) + threadIdx.x; i < count; i += MP_THREADS)
        bad |= !isfinite(x[i]);
    }
    const int tile_bad = __syncthreads_or(bad);
    if (tile_bad) {
      // each row's first and last non-finite bin, a warp a row
      for (int l = warp; l < n; l += MP_WARPS) {
        int lo = F, hi = -1;
        for (int f = lane; f < F; f += 32)
          if (!isfinite(x[l * Fs + f])) {
            lo = f < lo ? f : lo;
            hi = f;
          }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          const int a = __shfl_xor_sync(0xffffffffu, lo, d);
          const int b = __shfl_xor_sync(0xffffffffu, hi, d);
          lo = a < lo ? a : lo;
          hi = b > hi ? b : hi;
        }
        if (lane == 0) {
          first[l] = lo;
          last[l] = hi;
        }
      }
      __syncthreads();
    }
    // MP_CHAINS consecutive mel rows at once (spans of about one length,
    // independent FMA chains), each its own chain in its own order
    if (lane < n) {
      const float* row = x + lane * Fs;
      const int bad0 = tile_bad ? first[lane] : F;
      const int bad1 = tile_bad ? last[lane] : -1;
      for (int m0 = warp * MP_CHAINS; m0 < M; m0 += MP_WARPS * MP_CHAINS) {
        int s[MP_CHAINS], k1[MP_CHAINS];
        const double* wc[MP_CHAINS];
        double a[MP_CHAINS];
        int kn = 0;
#pragma unroll
        for (int c = 0; c < MP_CHAINS; ++c) {
          const bool valid = m0 + c < M;
          s[c] = valid ? s_start[m0 + c] : 0;
          k1[c] = valid ? s_len[m0 + c] : 0;
          wc[c] = wts + (valid ? s_off[m0 + c] : 0);
          a[c] = 0.0;
          kn = k1[c] > kn ? k1[c] : kn;
        }
#pragma unroll 2
        for (int k = 0; k < kn; ++k)
#pragma unroll
          for (int c = 0; c < MP_CHAINS; ++c)
            if (k < k1[c])
              a[c] = fma(wc[c][k], static_cast<double>(row[s[c] + k]),
                         a[c]);
#pragma unroll
        for (int c = 0; c < MP_CHAINS; ++c) {
          if (m0 + c >= M) break;
          // a non-finite bin outside the span meets a zero weight
          if (bad0 < s[c] || bad1 >= s[c] + k1[c])
            a[c] = __longlong_as_double(0x7ff8000000000000LL);   // NaN
          o[lane * Ms + m0 + c] = static_cast<float>(a[c]);
        }
      }
    }
    __syncthreads();
    // the mel rows stored and their partials, a warp a row
    for (int l = warp; l < n; l += MP_WARPS) {
      float lo = INFINITY;
      float hi = -INFINITY;
      float* dst = out + (r0 + l) * M;
      for (int m = lane; m < M; m += 32) {
        const float v = o[l * Ms + m];
        dst[m] = v;
        lo = nan_min(lo, v);
        hi = nan_max(hi, v);
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
        hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, d));
      }
      if (lane == 0) {
        part_min[r0 + l] = lo;
        part_max[r0 + l] = hi;
      }
    }
  }
}

// The weights in shared memory when they fit MP_W_SMEM (n_w, the packed
// length, is the last span's end), else read from global memory, where a
// warp's lanes read the same one too.
__global__ void __launch_bounds__(MP_THREADS, 1)
mel_project_kernel(const float* __restrict__ psd, const int* __restrict__ start,
                   const int* __restrict__ len, const int* __restrict__ off,
                   const double* __restrict__ w, long long R, int F, int M,
                   int rows, int vec, float* __restrict__ out,
                   float* __restrict__ part_min,
                   float* __restrict__ part_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_w = off[M - 1] + len[M - 1];
  if (static_cast<long long>(n_w) * 8 <= MP_W_SMEM)
    mel_tiles<true>(psd, start, len, off, w, n_w, R, F, M, rows, vec, out,
                    part_min, part_max, smem);
  else
    mel_tiles<false>(psd, start, len, off, w, n_w, R, F, M, rows, vec, out,
                     part_min, part_max, smem);
}

// Rows a block of the backward takes at F floats a row (its mel
// gradients): as many warps as MEL_SMEM holds rows, at most
// MEL_MAX_WARPS; 0 when one row does not fit.
int mel_rows_per_block(int F) {
  const int rows = F > 0 ? MEL_SMEM / (F * 4) : 0;
  return rows < MEL_MAX_WARPS ? rows : MEL_MAX_WARPS;
}

__global__ void __launch_bounds__(MEL_MAX_WARPS * 32)
mel_backward_kernel(const float* __restrict__ dmel,
                    const int* __restrict__ bstart,
                    const int* __restrict__ bcount,
                    const int* __restrict__ brow,
                    const double* __restrict__ bw, long long R, int F, int M,
                    float* __restrict__ dpsd) {
  extern __shared__ float grads[];         // a row of M floats a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (r >= R) return;                      // the whole warp: no block sync
  float* row = grads + warp * M;
  const float* src = dmel + r * M;
  int bad = 0;                             // non-finite gradients in the row
  for (int m = lane; m < M; m += 32) {
    const float v = src[m];
    row[m] = v;
    bad += !isfinite(v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) bad += __shfl_xor_sync(0xffffffffu, bad, o);
  __syncwarp();
  float* dst = dpsd + r * F;
  for (int f = lane; f < F; f += 32) {
    const int e0 = bstart[f];
    const int e1 = e0 + bcount[f];
    double acc = 0.0;
    int inside = 0;
    for (int e = e0; e < e1; ++e) {
      const float v = row[brow[e]];
      inside += !isfinite(v);
      acc = fma(bw[e], static_cast<double>(v), acc);
    }
    // a non-finite gradient of a row whose span misses this bin
    if (inside < bad) acc = __longlong_as_double(0x7ff8000000000000LL);
    dst[f] = static_cast<float>(acc);
  }
}

// An attribute of the current device (the SM count, the shared memory a
// block may opt in to).
int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t (0 = success), or
// cudaErrorInvalidValue for sizes the kernel does not take. psd is (R, F)
// contiguous f32; start, len and off are (M,) int32 and w the packed
// float64 spans, all on the device; out is (R, M) f32; part_min/part_max
// are (R,) f32. The tile: MP_ROWS rows, or fewer where the block's shared
// memory does not hold two tiles of F floats a row; a persistent grid, as
// many blocks as the SMs hold.
int mel_project_launch(const float* psd, const int* start, const int* len,
                       const int* off, const double* w, long long R, int F,
                       int M, float* out, float* part_min, float* part_max,
                       void* stream) {
  if (R < 0 || M < 1 || F < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const long long cap = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  int rows = MP_ROWS;
  while (rows > 1 && mel_smem(rows, F, M).total > cap) rows >>= 1;
  const long long smem = mel_smem(rows, F, M).total;
  if (smem > cap) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mel_project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mel_project_kernel, MP_THREADS, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_tiles = (R + rows - 1) / rows;
  const long long fill =
      static_cast<long long>(device_attr(cudaDevAttrMultiProcessorCount)) *
      (per_sm > 0 ? per_sm : 1);
  // one flat run of 16-byte copies a tile: F odd (no padding), every
  // tile's first row on a 16-byte boundary
  const int vec = (F & 1) && (static_cast<long long>(rows) * F) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(psd) % 16 == 0;
  mel_project_kernel<<<static_cast<unsigned>(n_tiles < fill ? n_tiles : fill),
                       MP_THREADS, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      psd, start, len, off, w, R, F, M, rows, vec, out, part_min, part_max);
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`; returns the cudaError_t (0 = success), or
// cudaErrorInvalidValue for sizes the kernel does not take. dmel is (R, M)
// contiguous f32; bstart and bcount are (F,) int32, brow the rows (int32)
// and bw their float64 weights, all on the device; dpsd is (R, F) f32.
int mel_backward_launch(const float* dmel, const int* bstart,
                        const int* bcount, const int* brow, const double* bw,
                        long long R, int F, int M, float* dpsd,
                        void* stream) {
  const int rows = mel_rows_per_block(M);
  if (R < 0 || F < 1 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const long long blocks = (R + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  mel_backward_kernel<<<static_cast<unsigned>(blocks), rows * 32,
                        static_cast<size_t>(rows) * M * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(
      dmel, bstart, bcount, brow, bw, R, F, M, dpsd);
  return static_cast<int>(cudaGetLastError());
}

const char* mel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
