// Packed sparsification payloads of the top-k / rand-k codecs, for sm_90a.
//
// Replaces the TPU kernels of src/repro/kernels/comm_compress/kernel.py:
//   top_k_pack    <- top_k_pack_fwd   (:67, pallas_call at :74)
//                    vals[i, j] = x[i, idx[i, j]]
//   top_k_unpack  <- top_k_unpack_fwd (:101, pallas_call at :106)
//                    out (N, d) = 0, then out[i, idx[i, j]] += vals[i, j]
//
// The TPU kernels gather and scatter by one-hot contractions on the matrix
// unit over 512-wide d-blocks, because a TPU core has no dynamic loads.
// Hopper has them, so the pack gathers and the unpack sorts its entries by
// output tile.
//
// Bound on the H100 (3.35 TB/s): bytes.  The pack reads each index (4 B)
// and the element it names and writes the value: 12 B per kept fp32
// element, no arithmetic.  The unpack writes the dense N*d output once and
// reads 8 B per kept element.  At N = 8, d = 2^24 + 3, k = ceil(0.1 d):
// pack 161.1 MB -> 0.0481 ms, unpack 644.2 MB -> 0.1923 ms.  Top-k indices
// come in magnitude order, not address order, so each gathered 4 B costs a
// random 64 B fetch from device memory (the L2's default granularity):
// about 81% of x at ratio 0.1, in random order.
//
// Unpack: a counting sort of the kept entries by output tile, then one
// block per tile, so that each output byte is written once and no
// read-modify-write reaches device memory.  Rows are cut into tiles of
// 2^tile_shift elements (16,384 from the wrapper: a 64 KB fp32 accumulator
// in shared memory, three blocks to an SM).
//   * A row of at most one tile (every leaf of the paper's MLP) takes one
//     launch: a block per row adds the row's entries into its accumulator
//     and writes the row.
//   * Longer rows take four kernels after a memset of the counts (one op
//     call, one launch count):
//       count  each block of 8,192 entries builds a histogram of its row's
//              tiles in shared memory and adds it to the global counts;
//       scan   one block turns the counts into bucket starts (cursors);
//       place  each block ranks its entries by tile in shared memory,
//              reserves its run of each bucket with one atomic per (block,
//              tile), sorts the entries by tile in shared memory and writes
//              each run with adjacent threads, as (16-bit in-tile offset,
//              value): 8 B for fp32, 4 B for bf16;
//       tile   one block per tile zeroes its accumulator, adds its bucket
//              and writes the tile once, 16 B stores between the unaligned
//              head and the ragged tail.
//     Rows of more than 4,096 tiles count and place with one global atomic
//     per entry instead of the shared histogram.
//   * The adds are fp32 adds in a compare-and-swap loop on shared memory,
//     IEEE with subnormals kept (on sm_90 a global fp32 atomicAdd is a
//     flushing RED.ADD.F32.FTZ; a shared one compiles to this loop); each
//     tile is rounded once to the output type at the end, as the TPU kernel
//     sums its one-hot product in fp32 and casts once.  For the distinct
//     indices that top-k and rand-k give, each slot is one add into +0, so
//     the result is the plain version's to the bit (a -0 lands as +0).
//     Repeated indices sum in fp32 in an unspecified order: in bf16 that is
//     the Pallas kernel's rounding, where the plain version (and the earlier
//     two-kernel design of this file) added in bf16.
//   Reckoned traffic at the shape above: count 53.7 MB, place 107.4 MB read
//   and 107.4 MB written, tile 107.4 MB read and 536.9 MB written.
//
// Pack: one entry a thread on a grid of (row, window, chunk of k), chunk
// fastest; idx is loaded and vals stored with evict-first hints so the
// streams leave L2 to x.  A row of x above the wrapper's split (20 MB) is
// gathered in two passes, one per half, each re-reading the row's idx and
// gathering only the entries in its half: fewer of the gathers miss L2.
// More entries a thread (all index loads, then all gathers) put more
// random fetches in flight and measured slower.  An index outside [0, d)
// gives 0 (written by the first pass).  The pack copies raw bits, so it is
// exact in every dtype.
//
// Each entry point returns the cudaGetLastError() of its launches (0 when
// they were accepted), or cudaErrorInvalidValue for arguments it does not
// take; top_k_error_string turns it into text.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- pack
constexpr int kPackThreads = 256;

template <typename Word>
__global__ void __launch_bounds__(kPackThreads)
    pack_kernel(const Word* __restrict__ x, const int32_t* __restrict__ idx,
                Word* __restrict__ vals, int64_t d, int64_t k, int64_t window,
                unsigned int windows, unsigned int chunks) {
  const unsigned int chunk = blockIdx.x % chunks;
  const unsigned int rw = blockIdx.x / chunks;
  const unsigned int w = rw % windows;
  const int64_t row = rw / windows;
  const int64_t e = static_cast<int64_t>(chunk) * kPackThreads + threadIdx.x;
  if (e >= k) return;
  const int64_t lo = static_cast<int64_t>(w) * window;
  const int64_t hi = lo + window < d ? lo + window : d;
  const int32_t j = __ldcs(idx + row * k + e);
  if (j >= lo && j < hi) {
    __stcs(vals + row * k + e, __ldg(x + row * d + j));
  } else if (w == 0 && (j < 0 || j >= d)) {
    __stcs(vals + row * k + e, Word(0));
  }
}

// ---------------------------------------------------------------- unpack
constexpr int kSortThreads = 512;
constexpr int kSortPerThread = 16;
constexpr int kSortChunk = kSortThreads * kSortPerThread;
constexpr int kScanThreads = 1024;
constexpr int kScanPerThread = 8;
constexpr int kTileThreads = 512;
constexpr unsigned int kMaxHistTiles = 4096;   // 16 B each in place's shared memory
constexpr int kMaxTileShift = 15;              // a 128 KB fp32 accumulator
constexpr int kMaxSmemBytes = 232448;          // a block's most on sm_90, static included

typedef unsigned long long u64;

template <typename T>
struct Val;

template <>
struct Val<float> {
  typedef uint2 Entry;   // (in-tile offset, fp32 bits)
  static constexpr int kVec = 4;
  __device__ static float load(const float* p) { return __ldcs(p); }
  __device__ static Entry entry(uint32_t off, float v) {
    return make_uint2(off, __float_as_uint(v));
  }
  __device__ static uint32_t offset(Entry e) { return e.x; }
  __device__ static float value(Entry e) { return __uint_as_float(e.y); }
  __device__ static void store(float* p, float a) { *p = a; }
  __device__ static uint4 pack(const float* a) {
    return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]), __float_as_uint(a[2]),
                      __float_as_uint(a[3]));
  }
};

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

template <>
struct Val<__nv_bfloat16> {
  typedef uint32_t Entry;   // in-tile offset << 16 | bf16 bits
  static constexpr int kVec = 8;
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
  }
  __device__ static Entry entry(uint32_t off, float v) {
    return off << 16 | __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static uint32_t offset(Entry e) { return e >> 16; }
  __device__ static float value(Entry e) {
    return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(e & 0xffffu)));
  }
  __device__ static void store(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }
  __device__ static uint4 pack(const float* a) {
    return make_uint4(bf16_pair(a[0], a[1]), bf16_pair(a[2], a[3]), bf16_pair(a[4], a[5]),
                      bf16_pair(a[6], a[7]));
  }
};

// an IEEE fp32 add into shared memory that keeps subnormals
__device__ __forceinline__ void add_exact(float* p, float v) {
  unsigned int* u = reinterpret_cast<unsigned int*>(p);
  unsigned int old = *u, assumed;
  do {
    assumed = old;
    old = atomicCAS(u, assumed, __float_as_uint(__uint_as_float(assumed) + v));
  } while (old != assumed);
}

// per-(row, tile) entry counts; hist_in_smem: a shared histogram of the
// row's tiles, added to counts once a block, else one global atomic an entry
__global__ void __launch_bounds__(kSortThreads)
    count_kernel(const int32_t* __restrict__ idx, uint32_t* __restrict__ counts, int64_t d,
                 int64_t k, int shift, unsigned int tiles, unsigned int chunks,
                 bool hist_in_smem) {
  extern __shared__ uint32_t hist[];
  const int64_t row = blockIdx.x / chunks;
  const unsigned int chunk = blockIdx.x % chunks;
  uint32_t* row_counts = counts + row * tiles;
  if (hist_in_smem) {
    for (unsigned int t = threadIdx.x; t < tiles; t += kSortThreads) hist[t] = 0;
    __syncthreads();
  }
  const int32_t* ir = idx + row * k;
  const int64_t base = static_cast<int64_t>(chunk) * kSortChunk + threadIdx.x;
  int32_t j[kSortPerThread];
#pragma unroll
  for (int r = 0; r < kSortPerThread; ++r) {
    const int64_t e = base + r * kSortThreads;
    j[r] = e < k ? __ldcs(ir + e) : -1;
  }
#pragma unroll
  for (int r = 0; r < kSortPerThread; ++r) {
    if (j[r] < 0 || j[r] >= d) continue;
    if (hist_in_smem) {
      atomicAdd(hist + (j[r] >> shift), 1u);
    } else {
      atomicAdd(row_counts + (j[r] >> shift), 1u);
    }
  }
  if (hist_in_smem) {
    __syncthreads();
    for (unsigned int t = threadIdx.x; t < tiles; t += kSortThreads) {
      if (hist[t]) atomicAdd(row_counts + t, hist[t]);
    }
  }
}

// cursors = exclusive prefix sum of counts (one block)
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const uint32_t* __restrict__ counts, u64* __restrict__ cursors, int64_t nt) {
  __shared__ u64 warp_sums[kScanThreads / 32];
  __shared__ u64 carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  for (int64_t base = 0; base < nt; base += kScanThreads * kScanPerThread) {
    const int64_t first = base + static_cast<int64_t>(threadIdx.x) * kScanPerThread;
    uint32_t c[kScanPerThread];
    u64 sum = 0;
#pragma unroll
    for (int r = 0; r < kScanPerThread; ++r) {
      c[r] = first + r < nt ? counts[first + r] : 0u;
      sum += c[r];
    }
    u64 incl = sum;   // inclusive scan over the warp
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const u64 up = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl += up;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      u64 ws = warp_sums[lane], wincl = ws;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const u64 up = __shfl_up_sync(0xffffffffu, wincl, s);
        if (lane >= s) wincl += up;
      }
      warp_sums[lane] = wincl - ws;   // exclusive, per warp
    }
    __syncthreads();
    u64 run = carry + warp_sums[warp] + incl - sum;
#pragma unroll
    for (int r = 0; r < kScanPerThread; ++r) {
      if (first + r < nt) cursors[first + r] = run;
      run += c[r];
    }
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = run;
    __syncthreads();
  }
}

// block-wide exclusive scan of hist[0, tiles) into excl, in shared memory
// (kSortThreads threads, each over a run of consecutive tiles); returns the
// total, with excl visible to every thread
__device__ uint32_t block_exclusive_scan(const uint32_t* hist, uint32_t* excl,
                                         unsigned int tiles, uint32_t* warp_sums) {
  const unsigned int per = (tiles + kSortThreads - 1) / kSortThreads;
  const unsigned int first = threadIdx.x * per;
  uint32_t sum = 0;
  for (unsigned int t = first; t < first + per && t < tiles; ++t) sum += hist[t];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = sum;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const uint32_t up = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t ws = lane < kSortThreads / 32 ? warp_sums[lane] : 0u;
    uint32_t wincl = ws;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const uint32_t up = __shfl_up_sync(0xffffffffu, wincl, s);
      if (lane >= s) wincl += up;
    }
    if (lane < kSortThreads / 32) warp_sums[lane] = wincl - ws;
    if (lane == kSortThreads / 32 - 1) warp_sums[kSortThreads / 32] = wincl;
  }
  __syncthreads();
  uint32_t run = warp_sums[warp] + incl - sum;
  for (unsigned int t = first; t < first + per && t < tiles; ++t) {
    excl[t] = run;
    run += hist[t];
  }
  const uint32_t total = warp_sums[kSortThreads / 32];
  __syncthreads();
  return total;
}

// each entry to its bucket; afterwards cursors[t] is the end of bucket t.
// hist_in_smem: rank the block's entries by tile in shared memory, reserve
// a run of each (row, tile) bucket with one atomic per block and tile, sort
// the entries by tile in shared memory and write each run with adjacent
// threads; else one global atomic an entry picks its slot
template <typename T>
__global__ void __launch_bounds__(kSortThreads)
    place_kernel(const int32_t* __restrict__ idx, const T* __restrict__ vals,
                 u64* __restrict__ cursors, typename Val<T>::Entry* __restrict__ bucket,
                 int64_t d, int64_t k, int shift, unsigned int tiles, unsigned int chunks,
                 bool hist_in_smem) {
  typedef typename Val<T>::Entry Entry;
  extern __shared__ u64 run_base[];                                  // tiles
  Entry* staged = reinterpret_cast<Entry*>(run_base + tiles);         // kSortChunk
  uint32_t* hist = reinterpret_cast<uint32_t*>(staged + kSortChunk);  // tiles
  uint32_t* first = hist + tiles;                                     // tiles
  uint16_t* staged_tile = reinterpret_cast<uint16_t*>(first + tiles);  // kSortChunk
  __shared__ uint32_t warp_sums[kSortThreads / 32 + 1];
  const int64_t row = blockIdx.x / chunks;
  const unsigned int chunk = blockIdx.x % chunks;
  u64* row_cursors = cursors + row * tiles;
  const int32_t* ir = idx + row * k;
  const T* vr = vals + row * k;
  const int64_t base = static_cast<int64_t>(chunk) * kSortChunk + threadIdx.x;
  const uint32_t mask = (1u << shift) - 1u;
  int32_t j[kSortPerThread];
#pragma unroll
  for (int r = 0; r < kSortPerThread; ++r) {
    const int64_t e = base + r * kSortThreads;
    j[r] = e < k ? __ldcs(ir + e) : -1;
  }
  if (!hist_in_smem) {
#pragma unroll
    for (int r = 0; r < kSortPerThread; ++r) {
      if (j[r] < 0 || j[r] >= d) continue;
      const u64 pos = atomicAdd(row_cursors + (j[r] >> shift), 1ull);
      bucket[pos] = Val<T>::entry(static_cast<uint32_t>(j[r]) & mask,
                                  Val<T>::load(vr + base + r * kSortThreads));
    }
    return;
  }
  for (unsigned int t = threadIdx.x; t < tiles; t += kSortThreads) hist[t] = 0;
  __syncthreads();
  uint32_t rank[kSortPerThread];
#pragma unroll
  for (int r = 0; r < kSortPerThread; ++r) {
    rank[r] = (j[r] >= 0 && j[r] < d) ? atomicAdd(hist + (j[r] >> shift), 1u) : 0u;
  }
  __syncthreads();
  const uint32_t n_valid = block_exclusive_scan(hist, first, tiles, warp_sums);
  for (unsigned int t = threadIdx.x; t < tiles; t += kSortThreads) {
    if (hist[t]) run_base[t] = atomicAdd(row_cursors + t, static_cast<u64>(hist[t]));
  }
  float v[kSortPerThread];
#pragma unroll
  for (int r = 0; r < kSortPerThread; ++r) {
    const int64_t e = base + r * kSortThreads;
    v[r] = (j[r] >= 0 && j[r] < d) ? Val<T>::load(vr + e) : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < kSortPerThread; ++r) {
    if (j[r] < 0 || j[r] >= d) continue;
    const unsigned int t = j[r] >> shift;
    const uint32_t at = first[t] + rank[r];
    staged[at] = Val<T>::entry(static_cast<uint32_t>(j[r]) & mask, v[r]);
    staged_tile[at] = static_cast<uint16_t>(t);
  }
  __syncthreads();
  for (uint32_t i = threadIdx.x; i < n_valid; i += kSortThreads) {
    const unsigned int t = staged_tile[i];
    bucket[run_base[t] + (i - first[t])] = staged[i];
  }
}

// write width fp32 sums from shared memory to dst in T: the bytes before
// dst's first 16 B boundary and after the last one singly, 16 B stores between
template <typename T>
__device__ __forceinline__ void store_tile(T* dst, const float* acc, int width) {
  constexpr int V = Val<T>::kVec;
  int head = static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / sizeof(T));
  if (head > width) head = width;
  const int n_vec = (width - head) / V;
  for (int i = threadIdx.x; i < head; i += kTileThreads) Val<T>::store(dst + i, acc[i]);
  uint4* body = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < n_vec; i += kTileThreads) {
    float a[V];
#pragma unroll
    for (int u = 0; u < V; ++u) a[u] = acc[head + i * V + u];
    body[i] = Val<T>::pack(a);
  }
  for (int i = head + n_vec * V + threadIdx.x; i < width; i += kTileThreads) {
    Val<T>::store(dst + i, acc[i]);
  }
}

// one block per (row, tile): zero the fp32 accumulator, add the tile's
// entries, write the tile once.  kDirect: the row is one tile and its
// entries come straight from idx / vals; else from the tile's bucket
template <typename T, bool kDirect>
__global__ void __launch_bounds__(kTileThreads)
    tile_kernel(const int32_t* __restrict__ idx, const T* __restrict__ vals,
                const uint32_t* __restrict__ counts, const u64* __restrict__ ends,
                const typename Val<T>::Entry* __restrict__ bucket, T* __restrict__ out,
                int64_t d, int64_t k, int shift, unsigned int tiles) {
  extern __shared__ float4 acc4[];
  float* acc = reinterpret_cast<float*>(acc4);
  const int64_t row = blockIdx.x / tiles;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x % tiles) << shift;
  const int width = static_cast<int>(d - col0 < (1 << shift) ? d - col0 : (1 << shift));
  for (int i = threadIdx.x; i < (width + 3) / 4; i += kTileThreads) {
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  constexpr int U = 4;   // entries a thread loads before it adds them
  if (kDirect) {
    const int32_t* ir = idx + row * k;
    const T* vr = vals + row * k;
    for (int64_t e0 = threadIdx.x; e0 < k; e0 += U * kTileThreads) {
      int32_t j[U];
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t e = e0 + u * kTileThreads;
        j[u] = e < k ? __ldcs(ir + e) : -1;
        v[u] = (j[u] >= 0 && j[u] < d) ? Val<T>::load(vr + e) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j[u] >= 0 && j[u] < d) add_exact(acc + j[u], v[u]);
      }
    }
  } else {
    const u64 end = ends[blockIdx.x];
    const u64 start = end - counts[blockIdx.x];
    for (u64 e0 = start + threadIdx.x; e0 < end; e0 += U * kTileThreads) {
      typename Val<T>::Entry en[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const u64 e = e0 + u * kTileThreads;
        if (e < end) en[u] = __ldcs(bucket + e);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (e0 + u * kTileThreads < end) {
          add_exact(acc + Val<T>::offset(en[u]), Val<T>::value(en[u]));
        }
      }
    }
  }
  __syncthreads();
  store_tile(out + row * d + col0, acc, width);
}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

inline int64_t align8(int64_t n) { return (n + 7) & ~int64_t(7); }

// once per kernel and device: opt in to more than 48 KB of dynamic shared memory
template <auto Kernel>
cudaError_t allow_dynamic_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, Kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmemBytes - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T>
int unpack(const int32_t* idx, const T* vals, T* out, int64_t n, int64_t d, int64_t k,
           int shift, unsigned char* scratch, int64_t scratch_bytes, cudaStream_t s) {
  typedef typename Val<T>::Entry Entry;
  const int64_t tiles = cdiv(d, int64_t(1) << shift);
  const int acc_bytes = static_cast<int>((d < (int64_t(1) << shift) ? align8(d) : 1 << shift) * 4);
  if (tiles == 1) {
    cudaError_t err = allow_dynamic_smem<tile_kernel<T, true>>();
    if (err != cudaSuccess) return static_cast<int>(err);
    tile_kernel<T, true><<<static_cast<unsigned int>(n), kTileThreads, acc_bytes, s>>>(
        idx, vals, nullptr, nullptr, nullptr, out, d, k, shift, 1u);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t nt = n * tiles;
  uint32_t* counts = reinterpret_cast<uint32_t*>(scratch);
  u64* cursors = reinterpret_cast<u64*>(scratch + align8(nt * 4));
  Entry* bucket = reinterpret_cast<Entry*>(scratch + align8(nt * 4) + nt * 8);
  const int64_t need = align8(nt * 4) + nt * 8 + n * k * static_cast<int64_t>(sizeof(Entry));
  if (scratch == nullptr || scratch_bytes < need || nt > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(counts, 0, nt * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool hist_in_smem = tiles <= kMaxHistTiles;
  const unsigned int chunks = static_cast<unsigned int>(cdiv(k, kSortChunk));
  const unsigned int sort_blocks = static_cast<unsigned int>(n * chunks);
  const unsigned int t32 = static_cast<unsigned int>(tiles);
  if (sort_blocks > 0) {
    count_kernel<<<sort_blocks, kSortThreads, hist_in_smem ? tiles * 4 : 0, s>>>(
        idx, counts, d, k, shift, t32, chunks, hist_in_smem);
  }
  scan_kernel<<<1, kScanThreads, 0, s>>>(counts, cursors, nt);
  if (sort_blocks > 0) {
    const int place_smem = static_cast<int>(
        tiles * 16 + kSortChunk * (sizeof(Entry) + sizeof(uint16_t)));
    if (hist_in_smem) {
      err = allow_dynamic_smem<place_kernel<T>>();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    place_kernel<T><<<sort_blocks, kSortThreads, hist_in_smem ? place_smem : 0, s>>>(
        idx, vals, cursors, bucket, d, k, shift, t32, chunks, hist_in_smem);
  }
  err = allow_dynamic_smem<tile_kernel<T, false>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_kernel<T, false><<<static_cast<unsigned int>(nt), kTileThreads, acc_bytes, s>>>(
      idx, vals, counts, cursors, bucket, out, d, k, shift, t32);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vals (n, k) = x (n, d) gathered at idx (n, k); elem_bytes 4 or 2; rows of
// x in passes over windows of `window` elements (window >= d: one pass)
int top_k_pack(const void* x, const void* idx, void* vals, int64_t n, int64_t d, int64_t k,
               int elem_bytes, int64_t window, void* stream) {
  if (window <= 0 || n > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (n * k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t windows = d > window ? cdiv(d, window) : 1;
  const int64_t chunks = cdiv(k, kPackThreads);
  const int64_t blocks = n * windows * chunks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const unsigned int w32 = static_cast<unsigned int>(windows);
  const unsigned int c32 = static_cast<unsigned int>(chunks);
  if (elem_bytes == 4) {
    pack_kernel<uint32_t><<<static_cast<unsigned int>(blocks), kPackThreads, 0, s>>>(
        static_cast<const uint32_t*>(x), ix, static_cast<uint32_t*>(vals), d, k, window, w32,
        c32);
  } else if (elem_bytes == 2) {
    pack_kernel<unsigned short><<<static_cast<unsigned int>(blocks), kPackThreads, 0, s>>>(
        static_cast<const unsigned short*>(x), ix, static_cast<unsigned short*>(vals), d, k,
        window, w32, c32);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (n, d) = 0, then out[i, idx[i, j]] += vals[i, j] in fp32; dtype 0
// fp32, 1 bf16; tiles of 2^tile_shift elements.  Rows of more than one
// tile need scratch_bytes >= align8(4 nt) + 8 nt + n k (8 for fp32, 4 for
// bf16), nt = n ceil(d / 2^tile_shift): counts, bucket cursors, entries
int top_k_unpack(const void* idx, const void* vals, void* out, int64_t n, int64_t d, int64_t k,
                 int dtype, int tile_shift, void* scratch, int64_t scratch_bytes,
                 void* stream) {
  if ((dtype != 0 && dtype != 1) || tile_shift < 4 || tile_shift > kMaxTileShift ||
      n > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n * d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  if (dtype == 0) {
    return unpack<float>(ix, static_cast<const float*>(vals), static_cast<float*>(out), n, d, k,
                         tile_shift, sc, scratch_bytes, s);
  }
  return unpack<__nv_bfloat16>(ix, static_cast<const __nv_bfloat16*>(vals),
                               static_cast<__nv_bfloat16*>(out), n, d, k, tile_shift, sc,
                               scratch_bytes, s);
}

const char* top_k_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
