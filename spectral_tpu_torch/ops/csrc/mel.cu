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
// mel_chunked_kernel (mel_project_launch, where a tile of whole rows
// would hold fewer than MP_MIN_ROWS = 16 rows: F past 1,609 bins at 128
// mels)
//   The same function, and the same bits, on wide PSD rows. A tile of
//   whole rows shrinks as F grows (two rows of 8,193 bins), and with lanes
//   on rows most lanes of every warp idle. Here a tile keeps MC_ROWS = 32
//   rows
//   at every F and its bins stream through shared memory in chunks of
//   MC_CHUNK bins: the next chunk (of this tile, or the next tile's first)
//   in flight by cp.async while this one is summed. The chunks walk the
//   bins in ascending order, and each (mel row, PSD row) float64 sum is
//   carried from chunk to chunk in shared memory, so every sum is still
//   its span's bins in order from the span's first, one FMA chain, rounded
//   once at the store. In a chunk every warp lists the mel rows whose span
//   meets it (a ballot over the span table), pairs them in order and takes
//   pair p where p mod MC_WARPS is its index: it stages the pair's weights
//   of the chunk in a slot of its own (the weights are read once a chunk
//   and tile from L2, not at every step), loads the two sums, runs the two
//   chains side by side with lane l on the tile's row l (the chunk at the
//   odd stride MC_CHUNK | 1, free of bank conflicts), and stores them.
//   Each warp scans its own PSD rows (l = warp, warp + MC_WARPS) in every
//   chunk for non-finite bins and keeps the first and last in registers;
//   after the last chunk the same warp stores the row, the NaN rule as
//   above, and folds its partials as mel_tiles does.
//   Bound: bytes, as above (0.168 ms at 256 clips x 66 frames x 8,193
//   bins, 128 mels).
//
// mel_backward_kernel (mel_backward_launch): the projection's adjoint, for
// the gradient through the mel rows (the JAX package's jax.grad of its
// einsum)
//   in : dmel (R, M) f32, the gradient of mel; the bin table, from the
//        host (ops/mel_cuda.py::bin_records, the span table transposed): C
//        16-byte slots (w, row) a bin, C the most mel rows any bin has,
//        bin f's rows m (ascending) whose span holds f with w = fb[m, f]
//        in float64 (zeros inside a span kept), then empty slots (row -1)
//   out: dpsd (R, F) f32,
//          dpsd[r, f] = sum_m fb[m, f] dmel[r, m]
//        over the mel band's rows whose span holds f, in float64, rounded
//        once; a bin no row covers gets 0. Non-finite gradients as the
//        dense product dmel @ fb gives them: a non-finite dmel[r, m] makes
//        every bin outside row m's span NaN (0 * inf): a row's non-finite
//        gradients are counted, and a bin whose rows hold fewer of them is
//        NaN.
//   Work: the forward's shape turned around. A persistent grid (a block
//   of 16 warps an SM) walks tiles of up to MB_ROWS = 32 gradient rows,
//   two tiles' copies in flight by cp.async (16-byte copies of a tile's
//   contiguous run). A tile is turned into doubles at the odd stride M |
//   1 (its rows' non-finite gradients counted, a warp a row), then summed:
//   lane l takes the tile's row l and warp w a run of consecutive bins, so
//   every lane of a warp reads the same slot at once (a broadcast, the
//   table read through L1), four bins in flight a lane (the slots a bin
//   fixed, C = 2 at compile time on every filterbank whose triangles
//   overlap in pairs): each bin one float64 FMA chain from 0.0 over its
//   rows, ascending, rounded once, as the previous kernel summed it (a
//   warp a row, lane l the bins l, l + 32, ..., every lane re-reading the
//   table from global memory on every row, its loads through L1 setting
//   the pace). The outputs are staged in shared memory (stride F | 1) in
//   two buffers; with F odd a tile's outputs are one contiguous run,
//   handed to the bulk copy engine (TMA) by one thread while the block
//   sums the next tile; else (chunks of bins where a tile's rows do not
//   fit MB_OUT_SMEM, or F even) the block stores them, a warp a row.
//   Every output is the previous kernel's FMA chain over the same terms
//   in the same order, and the same NaN rule, so its bits.
//   Bound: bytes, dmel read once and dpsd written once (0.49 ms at 1024
//   clips x 622 frames, 128 mels over 513 bins, on 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// the fewest whole rows a tile takes: past them the chunked form runs (on
// the card, 128 mels: tiles of 16 rows of 1,025 bins ran 2.1x faster than
// the chunked form, of 16 rows of 1,537 bins 1.06x faster, of 8 rows of
// 2,049 bins 1.16x slower; NVIDIA H100. At 64 mels the chunked form wins
// from 1,537 bins, 1.17x, and loses at 1,025: the crossing moves with the
// mel count, which this rule does not follow)
constexpr int MP_MIN_ROWS = 16;
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
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
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

// The chunked form's own geometry (the tiles' constants above may vary
// apart from it)
constexpr int MC_THREADS = 512;
constexpr int MC_WARPS = MC_THREADS / 32;
constexpr int MC_ROWS = 32;          // PSD rows a tile at most: a lane each
constexpr int MC_CHAINS = 2;         // mel rows (chains) a warp sums at once
constexpr int MC_CHUNK = 128;        // bins a chunk
constexpr int MC_MIN_BLOCKS = 2;     // blocks an SM (64 registers)
constexpr int MC_ROWS_A_WARP = MC_ROWS / MC_WARPS;   // rows a warp scans
static_assert((MC_CHUNK & (MC_CHUNK - 1)) == 0 && MC_ROWS <= 32 &&
                  MC_ROWS % MC_WARPS == 0 && MC_CHAINS == 2,
              "a chunk of a power of two of bins; rows on lanes; pairs");

// The chunked form's shared memory at `rows` rows: two chunk buffers of
// rows x (MC_CHUNK | 1) floats, each (mel row, PSD row) sum as a double
// at acc[m (rows | 1) + l], each warp's slot for its pair's weights of a
// chunk (MC_CHAINS x MC_CHUNK doubles) and the span table (3 M ints).
struct MelChunkSmem {
  long long chunks, acc, w, table, total;
};

__host__ __device__ __forceinline__ MelChunkSmem mel_chunk_smem(int rows,
                                                                int M) {
  MelChunkSmem s;
  s.chunks = 0;
  s.acc = 2 * align16(static_cast<long long>(rows) * (MC_CHUNK | 1) * 4);
  s.w = s.acc + align16(8LL * M * (rows | 1));
  s.table = s.w + 8LL * MC_WARPS * MC_CHAINS * MC_CHUNK;
  s.total = s.table + align16(3LL * M * 4);
  return s;
}

// Copy bins c0 .. c0 + nc of PSD rows r0 .. r0 + n into a chunk buffer
// (row l at l * (MC_CHUNK | 1)): 4-byte copies, a warp's 32 consecutive
// bins of one row at a time (the rows lie F floats apart, F odd as a rule,
// so no 16-byte copy lines up).
__device__ __forceinline__ void mel_chunk_stage(const float* psd,
                                                long long r0, int n, int F,
                                                int c0, int nc, float* buf) {
  constexpr int Cs = MC_CHUNK | 1;
  for (int i = threadIdx.x; i < n * MC_CHUNK; i += MC_THREADS) {
    const int l = i / MC_CHUNK, k = i & (MC_CHUNK - 1);
    if (k < nc)
      cp_async4(buf + l * Cs + k, psd + (r0 + l) * F + c0 + k);
  }
}

// A persistent block walks its tiles of `rows` PSD rows chunk by chunk,
// the next chunk's copy in flight (cp.async, two buffers) while this one
// is scanned and summed; see the note at the top. Every mel value is the
// FMA chain of mel_tiles over the same terms in the same order, its NaN
// rule the same and its partials folded the same way, so the outputs are
// that kernel's bits.
__global__ void __launch_bounds__(MC_THREADS, MC_MIN_BLOCKS)
mel_chunked_kernel(const float* __restrict__ psd,
                   const int* __restrict__ start, const int* __restrict__ len,
                   const int* __restrict__ off, const double* __restrict__ w,
                   long long R, int F, int M, int rows,
                   float* __restrict__ out, float* __restrict__ part_min,
                   float* __restrict__ part_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int Cs = MC_CHUNK | 1;
  const MelChunkSmem lay = mel_chunk_smem(rows, M);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* chunks = reinterpret_cast<float*>(smem + lay.chunks);
  double* acc = reinterpret_cast<double*>(smem + lay.acc);
  double* ws = reinterpret_cast<double*>(smem + lay.w) +
               warp * (MC_CHAINS * MC_CHUNK);
  int* s_start = reinterpret_cast<int*>(smem + lay.table);
  int* s_len = s_start + M;
  int* s_off = s_len + M;
  const int As = rows | 1;
  const long long buf_floats =
      align16(static_cast<long long>(rows) * Cs * 4) / 4;
  const int n_chunks = (F + MC_CHUNK - 1) / MC_CHUNK;
  const long long n_tiles = (R + rows - 1) / rows;
  for (int m = threadIdx.x; m < M; m += MC_THREADS) {
    s_start[m] = start[m];
    s_len[m] = len[m];
    s_off[m] = off[m];
  }
  const auto stage = [&](long long t, int j, int b) {
    const int c0 = j * MC_CHUNK;
    mel_chunk_stage(psd, t * rows,
                    static_cast<int>(min(static_cast<long long>(rows),
                                         R - t * rows)),
                    F, c0, min(MC_CHUNK, F - c0), chunks + b * buf_floats);
    cp_async_commit();
  };
  long long tile = blockIdx.x;
  if (tile < n_tiles) stage(tile, 0, 0);
  // the first and last non-finite bin of the warp's rows warp + q MC_WARPS
  int bad0[MC_ROWS_A_WARP], bad1[MC_ROWS_A_WARP];
  for (int j = 0, buf = 0; tile < n_tiles; buf ^= 1) {
    const long long r0 = tile * rows;
    const int n = static_cast<int>(min(static_cast<long long>(rows), R - r0));
    const int c0 = j * MC_CHUNK;
    const int c1 = min(F, c0 + MC_CHUNK);
    const float* x = chunks + buf * buf_floats;
    cp_async_wait_all();
    __syncthreads();           // this chunk staged, the last one's sums in
                               // acc, the other buffer free
    const bool last_chunk = j + 1 == n_chunks;
    const long long next = last_chunk ? tile + gridDim.x : tile;
    const int next_j = last_chunk ? 0 : j + 1;
    if (next < n_tiles) stage(next, next_j, buf ^ 1);
    // the warp's rows' non-finite bins in this chunk
#pragma unroll
    for (int q = 0; q < MC_ROWS_A_WARP; ++q) {
      const int l = warp + q * MC_WARPS;
      if (j == 0) {
        bad0[q] = F;
        bad1[q] = -1;
      }
      if (l >= n) continue;
      for (int k0 = 0; k0 < c1 - c0; k0 += 32) {
        const int k = k0 + lane;
        const unsigned b = __ballot_sync(
            0xffffffffu, k < c1 - c0 && !isfinite(x[l * Cs + k]));
        if (b) {
          bad0[q] = min(bad0[q], c0 + k0 + __ffs(b) - 1);
          bad1[q] = max(bad1[q], c0 + k0 + 31 - __clz(b));
        }
      }
    }
    // the sums of one pair of mel rows (mb -1: one row) over this chunk
    const auto pair = [&](int ma, int mb) {
      int m[MC_CHAINS] = {ma, mb};
      int k0[MC_CHAINS], kn[MC_CHAINS], b[MC_CHAINS];
#pragma unroll
      for (int c = 0; c < MC_CHAINS; ++c) {
        k0[c] = kn[c] = b[c] = 0;
        if (m[c] < 0) continue;
        const int s = s_start[m[c]];
        k0[c] = max(0, c0 - s);
        kn[c] = min(s_len[m[c]], c1 - s) - k0[c];
        b[c] = s + k0[c] - c0;
      }
      // the pair's weights of the chunk: every load in flight at once (one
      // round trip to L2), then into the warp's slot
      __syncwarp();            // the last pair's reads of the slot done
#pragma unroll
      for (int c = 0; c < MC_CHAINS; ++c) {
        double t[MC_CHUNK / 32];
#pragma unroll
        for (int q = 0; q < MC_CHUNK / 32; ++q) {
          const int i = lane + 32 * q;
          t[q] = i < kn[c] ? __ldg(w + s_off[m[c]] + k0[c] + i) : 0.0;
        }
#pragma unroll
        for (int q = 0; q < MC_CHUNK / 32; ++q)
          if (lane + 32 * q < kn[c]) ws[c * MC_CHUNK + lane + 32 * q] = t[q];
      }
      __syncwarp();
      if (lane >= n) return;
      const float* row = x + lane * Cs;
      double a[MC_CHAINS];
#pragma unroll
      for (int c = 0; c < MC_CHAINS; ++c)
        a[c] = m[c] >= 0 && k0[c] > 0 ? acc[m[c] * As + lane] : 0.0;
      // the steps both chains take side by side, unpredicated so that the
      // loads run ahead of the FMAs, then the longer chain's own; each
      // chain in its own order
      const int both = min(kn[0], kn[1]);
#pragma unroll 8
      for (int k = 0; k < both; ++k) {
        const double w0 = ws[k], w1 = ws[MC_CHUNK + k];
        const double x0 = row[b[0] + k], x1 = row[b[1] + k];
        a[0] = fma(w0, x0, a[0]);
        a[1] = fma(w1, x1, a[1]);
      }
#pragma unroll
      for (int c = 0; c < MC_CHAINS; ++c) {
#pragma unroll 4
        for (int k = both; k < kn[c]; ++k)
          a[c] = fma(ws[c * MC_CHUNK + k],
                     static_cast<double>(row[b[c] + k]), a[c]);
      }
#pragma unroll
      for (int c = 0; c < MC_CHAINS; ++c)
        if (m[c] >= 0) acc[m[c] * As + lane] = a[c];
    };
    // the mel rows whose span meets the chunk, in order, paired; pair p
    // to warp p mod MC_WARPS
    int seen = 0;
    int held = -1;
    for (int m0 = 0; m0 < M; m0 += 32) {
      const int mm = m0 + lane;
      bool meets = false;
      if (mm < M) {
        const int s = s_start[mm];
        meets = s_len[mm] > 0 && s < c1 && s + s_len[mm] > c0;
      }
      for (unsigned bits = __ballot_sync(0xffffffffu, meets); bits;
           bits &= bits - 1) {
        const int mr = m0 + __ffs(bits) - 1;
        if (held < 0) {
          held = mr;
          continue;
        }
        if ((seen >> 1) % MC_WARPS == warp) pair(held, mr);
        seen += 2;
        held = -1;
      }
    }
    if (held >= 0 && (seen >> 1) % MC_WARPS == warp) pair(held, -1);
    if (last_chunk) {
      __syncthreads();         // every sum of the tile in acc
      // the mel rows stored and their partials, a warp a row
#pragma unroll
      for (int q = 0; q < MC_ROWS_A_WARP; ++q) {
        const int l = warp + q * MC_WARPS;
        if (l >= n) continue;
        float lo = INFINITY;
        float hi = -INFINITY;
        float* dst = out + (r0 + l) * M;
        for (int mm = lane; mm < M; mm += 32) {
          const int s = s_start[mm], k1 = s_len[mm];
          double a = k1 > 0 ? acc[mm * As + l] : 0.0;
          // a non-finite bin outside the span meets a zero weight
          if (bad0[q] < s || bad1[q] >= s + k1)
            a = __longlong_as_double(0x7ff8000000000000LL);   // NaN
          const float v = static_cast<float>(a);
          dst[mm] = v;
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
    tile = next;
    j = next_j;
  }
}

constexpr int MB_THREADS = 512;
constexpr int MB_WARPS = MB_THREADS / 32;
constexpr int MB_ROWS = 32;                   // gradient rows a tile at most
constexpr int MB_OUT_SMEM = 96 * 1024;        // a tile's staged outputs

// A slot of the backward's bin table: 16 bytes, read as one broadcast.
struct __align__(16) BinRec {
  double w;
  int row;       // -1: an empty slot
  int pad;
};

// The bulk copy engine (TMA) from shared to global memory, sm_90: one
// thread issues a copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned), commits it to its group, and later waits until at
// most N of its groups still read shared memory; the writers of the
// source fence it to the engine's view first.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(s), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The backward's shared memory for tiles of `rows` rows and chunks of fc
// bins: two tiles of rows x M floats (the copies' targets), the tile's
// gradients as doubles rows x (M | 1), two buffers of staged outputs rows
// x (fc | 1), and each row's count of non-finite gradients.
struct MelGradSmem {
  long long in_floats, xd, out, out_floats, bad, total;
};

__host__ __device__ __forceinline__ MelGradSmem mel_grad_smem(int rows,
                                                              int M,
                                                              int fc) {
  MelGradSmem s;
  s.in_floats = align16(static_cast<long long>(rows) * M * 4) / 4;
  s.xd = 8 * s.in_floats;
  s.out = s.xd + align16(static_cast<long long>(rows) * (M | 1) * 8);
  s.out_floats = align16(static_cast<long long>(rows) * (fc | 1) * 4) / 4;
  s.bad = s.out + 8 * s.out_floats;
  s.total = s.bad + 4LL * rows;
  return s;
}

// Bins a chunk of the staged outputs at `rows` rows a tile.
__host__ __device__ __forceinline__ int mel_grad_chunk(int rows, int F) {
  const int fit = MB_OUT_SMEM / (4 * rows) - 1;
  return F < fit ? F : fit;
}

// Copy gradient rows r0 .. r0 + n (n M contiguous floats) into the tile:
// 16-byte copies when `vec` (the run 16-byte aligned), 4-byte ones after.
__device__ __forceinline__ void mel_grad_stage(const float* dmel,
                                               long long r0, int n, int M,
                                               bool vec, float* tile) {
  const float* src = dmel + r0 * M;
  const int count = n * M;
  const int quads = vec ? count >> 2 : 0;
  for (int i = threadIdx.x; i < quads; i += MB_THREADS)
    cp_async16(tile + 4 * i, src + 4 * i);
  for (int i = 4 * quads + threadIdx.x; i < count; i += MB_THREADS)
    cp_async4(tile + i, src + i);
}

// A persistent block walks tiles of `rows` gradient rows, two tiles'
// copies (cp.async) in flight: a tile's copy lands while the two tiles
// before it are summed. It is turned into doubles at stride M | 1 with
// each row's non-finite gradients counted (a warp a row), and the copy
// two tiles ahead issued into its buffer; then the tile is summed chunk
// by chunk of fc bins: warp w the w-th run of consecutive bins of the
// chunk, lane l the tile's row l, each bin's C slots in order (its rows
// ascending, empty slots last) one float64 FMA chain from 0.0, rounded
// once into a staged output buffer. With `vec` (one chunk, F odd: the
// tile's outputs one contiguous run) thread 0 hands the buffer to the
// bulk copy engine and the block goes on to the next tile, the two
// buffers taking turns; else the block stores the chunk, a warp a row.
// CC: the slots a bin at compile time (2, every filterbank whose
// triangles overlap in pairs), 0 at run time.
template <int CC>
__global__ void __launch_bounds__(MB_THREADS, 1)
mel_backward_kernel(const float* __restrict__ dmel,
                    const BinRec* __restrict__ rec, int Cr, long long R,
                    int F, int M, int rows, int fc, int vin, int vec,
                    float* __restrict__ dpsd) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = CC ? CC : Cr;
  const MelGradSmem lay = mel_grad_smem(rows, M, fc);
  double* xd = reinterpret_cast<double*>(smem + lay.xd);
  int* bad = reinterpret_cast<int*>(smem + lay.bad);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Ms = M | 1, Os = fc | 1;
  const long long n_tiles = (R + rows - 1) / rows;
  // tile t's copy into buffer `buf`, one commit group a tile (an empty one
  // past the last)
  auto fetch = [&](long long t, int buf) {
    if (t < n_tiles)
      mel_grad_stage(dmel, t * rows,
                     static_cast<int>(min(static_cast<long long>(rows),
                                          R - t * rows)),
                     M, vin, reinterpret_cast<float*>(smem) +
                                 buf * lay.in_floats);
    cp_async_commit();
  };
  fetch(blockIdx.x, 0);
  fetch(blockIdx.x + gridDim.x, 1);
  int ob = 0;                  // the output buffer the next chunk fills
  for (long long tile = blockIdx.x, k = 0; tile < n_tiles;
       tile += gridDim.x, ++k) {
    const long long r0 = tile * rows;
    const int n = static_cast<int>(min(static_cast<long long>(rows), R - r0));
    const float* x = reinterpret_cast<float*>(smem) + (k & 1) * lay.in_floats;
    cp_async_wait_one();       // this tile's copy; the next one in flight
    // the store two chunks back has read the buffer this tile fills
    if (threadIdx.x == 0) bulk_wait_read<1>();
    __syncthreads();           // this tile staged; the doubles free
    // the tile as doubles, and each row's non-finite gradients, a warp a
    // row
    for (int l = warp; l < n; l += MB_WARPS) {
      int count = 0;
      for (int m0 = 0; m0 < M; m0 += 32) {
        const int m = m0 + lane;
        bool nonfinite = false;
        if (m < M) {
          const float v = x[l * M + m];
          xd[l * Ms + m] = static_cast<double>(v);
          nonfinite = !isfinite(v);
        }
        count += __popc(__ballot_sync(0xffffffffu, nonfinite));
      }
      if (lane == 0) bad[l] = count;
    }
    __syncthreads();           // the doubles written; this buffer free
    fetch(tile + 2LL * gridDim.x, k & 1);
    for (int f0 = 0; f0 < F; f0 += fc, ob ^= 1) {
      float* o = reinterpret_cast<float*>(smem + lay.out) +
                 ob * lay.out_floats;
      const int nf = min(fc, F - f0);
      const int fa = f0 + warp * nf / MB_WARPS;
      const int fb = f0 + (warp + 1) * nf / MB_WARPS;
      if (lane < n) {
        const double* row = xd + lane * Ms;
        const int nonfinite = bad[lane];
#pragma unroll 4
        for (int f = fa; f < fb; ++f) {
          const BinRec* slot = rec + f * C;
          double acc = 0.0;
          int inside = 0;
          for (int c = 0; c < C; ++c) {
            const BinRec r = slot[c];
            if (r.row >= 0) {
              const double v = row[r.row];
              inside += !isfinite(v);
              acc = fma(r.w, v, acc);
            }
          }
          // a non-finite gradient of a row whose span misses this bin
          if (inside < nonfinite)
            acc = __longlong_as_double(0x7ff8000000000000LL);   // NaN
          o[lane * Os + (f - f0)] = static_cast<float>(acc);
        }
      }
      if (vec) {
        // one chunk of F bins at stride F: the tile's n F outputs one
        // contiguous run, 16-byte aligned, to the bulk copy engine; the
        // last (n F) % 4 stored by threads
        fence_async_shared();
        __syncthreads();
        const int count = n * F;
        const int head = count & ~3;
        if (threadIdx.x == 0 && head > 0)
          bulk_store(dpsd + r0 * F, o, static_cast<unsigned>(head) * 4);
        if (threadIdx.x < count - head)
          dpsd[r0 * F + head + threadIdx.x] = o[head + threadIdx.x];
      } else {
        __syncthreads();
        for (int l = warp; l < n; l += MB_WARPS) {
          float* dst = dpsd + (r0 + l) * F + f0;
          for (int j = lane; j < nf; j += 32) dst[j] = o[l * Os + j];
        }
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

// An attribute of the current device (the SM count, the shared memory a
// block may opt in to).
int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

// Whether mel_project_launch takes the chunked form for F bins and M mel
// rows under `cap` bytes of shared memory a block: where tiles of
// MP_MIN_ROWS whole rows do not fit (F past 1,609 bins at 128 mels).
bool mel_chunked(int F, int M, long long cap) {
  return mel_smem(MP_MIN_ROWS, F, M).total > cap;
}

// The chunked form's launch (mel_project_launch's; see there).
int mel_chunked_launch(const float* psd, const int* start, const int* len,
                       const int* off, const double* w, long long R, int F,
                       int M, float* out, float* part_min, float* part_max,
                       cudaStream_t stream, long long cap, int* form) {
  int rows = MC_ROWS;
  while (rows > 1 && mel_chunk_smem(rows, M).total > cap) rows >>= 1;
  const long long smem = mel_chunk_smem(rows, M).total;
  if (smem > cap) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mel_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mel_chunked_kernel, MC_THREADS, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_tiles = (R + rows - 1) / rows;
  const long long fill =
      static_cast<long long>(device_attr(cudaDevAttrMultiProcessorCount)) *
      (per_sm > 0 ? per_sm : 1);
  *form = 1;
  mel_chunked_kernel<<<static_cast<unsigned>(n_tiles < fill ? n_tiles
                                                            : fill),
                       MC_THREADS, static_cast<size_t>(smem), stream>>>(
      psd, start, len, off, w, R, F, M, rows, out, part_min, part_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t (0 = success), or
// cudaErrorInvalidValue for sizes the kernel does not take. psd is (R, F)
// contiguous f32; start, len and off are (M,) int32 and w the packed
// float64 spans, all on the device; out is (R, M) f32; part_min/part_max
// are (R,) f32. The form: tiles of MP_ROWS whole rows (mel_project_kernel),
// halved down to MP_MIN_ROWS where the block's shared memory does not
// hold two of them; else the chunked form (mel_chunked_kernel), tiles of
// MC_ROWS rows, or fewer where its sums (M doubles a row) do not fit. A
// persistent grid, as many blocks as the SMs hold. *form is set to the
// form launched, 0 for tiles of whole rows and 1 for the chunked form,
// and left as it was where nothing is launched.
int mel_project_launch(const float* psd, const int* start, const int* len,
                       const int* off, const double* w, long long R, int F,
                       int M, float* out, float* part_min, float* part_max,
                       void* stream, int* form) {
  if (R < 0 || M < 1 || F < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const long long cap = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  if (mel_chunked(F, M, cap))
    return mel_chunked_launch(psd, start, len, off, w, R, F, M, out,
                              part_min, part_max,
                              static_cast<cudaStream_t>(stream), cap, form);
  int rows = MP_ROWS;
  while (rows > MP_MIN_ROWS && mel_smem(rows, F, M).total > cap) rows >>= 1;
  const long long smem = mel_smem(rows, F, M).total;
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
  *form = 0;
  mel_project_kernel<<<static_cast<unsigned>(n_tiles < fill ? n_tiles : fill),
                       MP_THREADS, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      psd, start, len, off, w, R, F, M, rows, vec, out, part_min, part_max);
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`; returns the cudaError_t (0 = success), or
// cudaErrorInvalidValue for sizes the kernel does not take. dmel is (R, M)
// contiguous f32; rec the bin table, C slots a bin (16 bytes each, F C in
// all), on the device, read from global memory (a broadcast a slot: the
// table staged in shared memory measured slower); dpsd is (R, F) f32. The
// tile: MB_ROWS rows, or fewer where the block's shared memory does not
// hold two tiles, their doubles and the staged outputs; a persistent
// grid, as many blocks as the SMs hold.
int mel_backward_launch(const float* dmel, const void* rec, int C,
                        long long R, int F, int M, float* dpsd,
                        void* stream) {
  if (R < 0 || F < 1 || M < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const long long cap = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  int rows = MB_ROWS;
  while (rows > 1 && mel_grad_smem(rows, M, mel_grad_chunk(rows, F)).total >
                         cap)
    rows >>= 1;
  const int fc = mel_grad_chunk(rows, F);
  const long long smem = mel_grad_smem(rows, M, fc).total;
  if (fc < 1 || smem > cap) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = C == 2 ? mel_backward_kernel<2>
                              : mel_backward_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, MB_THREADS, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_tiles = (R + rows - 1) / rows;
  const long long fill =
      static_cast<long long>(device_attr(cudaDevAttrMultiProcessorCount)) *
      (per_sm > 0 ? per_sm : 1);
  // the tiles' copies in 16 bytes: every tile's run 16-byte aligned
  const int vin = (static_cast<long long>(rows) * M) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(dmel) % 16 == 0;
  // one contiguous run a tile to the bulk copy engine: one chunk, F odd
  // (no padding), every tile's first row on a 16-byte boundary
  const int vec = fc == F && (F & 1) &&
                  (static_cast<long long>(rows) * F) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(dpsd) % 16 == 0;
  kernel<<<static_cast<unsigned>(n_tiles < fill ? n_tiles : fill),
           MB_THREADS, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      dmel, static_cast<const BinRec*>(rec), C, R, F, M, rows, fc, vin, vec,
      dpsd);
  return static_cast<int>(cudaGetLastError());
}

const char* mel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
