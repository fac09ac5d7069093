// Flash-attention forward (GQA, causal, sliding window, score soft-capping)
// for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
//   flash_attention_fwd (:96, pallas_call at :125) with its body _fa_kernel
//   out[b, s, h] = softmax_t(mask(c * tanh((q . k_t) * scale / c))) . v_t
//   kv head h / (H / K); mask: t <= s when causal, s - t < W with a window;
//   fp32 accumulation, output in the input's dtype.
//
// Layout: the model's (B, S, H, D) for q and out and (B, S, K, D) for k and
// v, read in place (the TPU kernel wants (B, H, S, D) and its ops.py
// transposes; here a tile row is one head's D contiguous elements, strided
// by H*D, so no transpose is needed).  Sq and Skv may be any length: tile
// rows past the end load as zeros, their keys are masked and their rows are
// not stored (the TPU kernel asserts S % 128 == 0).
//
// Bound on the H100: operations.  Per (b, h) the causal prefill touches
// S(S+1)/2 query-key pairs, 4*D flops each (q.k and p.v); at Gemma-2's
// S = 8192, D = 256 that is 550 GFLOP per layer for B = 2, H = 8, 0.556 ms at
// the 989 TFLOP/s dense bf16 rate, against 0.06 ms for the 201 MB of q, k,
// v and out.
//
// Design, simple first.  The TPU kernel runs its kv tiles as a sequential
// fourth grid axis and carries (m, l, acc) in VMEM scratch between grid
// steps (kernel.py:45-49, :86-89).  Blocks on Hopper run in no order, so one
// block owns a (b, h, q-tile) and loops over the kv tiles itself, carrying
// the running state in registers.  As in kernel.py:51-58 it visits only the
// tiles that hold an unmasked pair: none past the causal frontier and none
// wholly older than the window.  Blocks are launched last q-tile first, so
// the longest causal rows start first.
//
// Masking uses -inf with an explicit guard, not the TPU kernel's -2e38
// constant.  With -2e38 a row whose first visited tile is wholly masked for
// it gets p = exp(0) = 1 garbage that a later correction exp(-2e38 - m)
// wipes out; that relies on the tile order.  Here a row whose running max is
// still -inf uses 0 as its max, so exp(-inf) gives p = 0 and no garbage is
// ever summed.
//
// Scores are scaled after the dot in fp32 (as ref.py divides them), not by
// scaling q first (kernel.py:60): in bf16 a scaled q would round.
//
// bf16 (fa_bf16_kernel): 4 warps, 64 query rows, 16 per warp; kv tiles of
// 64 keys (32 at D = 256, which keeps the 16 x 256 fp32 accumulator of a
// warp -- 128 registers a thread -- beside the scores without spilling).
// Q, K and V tiles sit in dynamic shared memory, rows padded by 16 bytes so
// the fragment loads are free of bank conflicts: (64 + 2 x 32) x 264 x 2 B =
// 67.6 KB at D = 256 (52 KB at D = 128), above the 48 KB static limit, so
// the launch opts in with cudaFuncSetAttribute and returns its error.  K
// and V arrive by cp.async in two groups, so V's load overlaps the q.k
// products.  q.k and p.v run on the tensor cores with mma.sync m16n8k16
// (bf16 in, fp32 out).
// The probabilities are fp32; rounding them to bf16 for the p.v product
// would move the output by about a bf16 ulp against the fp32 reference, so
// p is split into a bf16 head and a bf16 remainder (p = hi + lo to 2^-16)
// and both go through the tensor cores: 1.5x the mma work of a single p.v,
// the price of agreeing with the fp32 softmax to within one bf16 rounding.
//
// fp32 (fa_fp32_kernel): plain FMAs, no tensor cores, so no TF32 rounding.
// 8 warps, 32 query rows (4 per warp), kv tiles of 32 keys: lane j scores
// key j for its warp's 4 rows, the row max and sum are warp shuffles, and
// lane j accumulates output columns j, j + 32, ...  Soft-capping uses tanhf
// (tanh.approx.f32 errs by ~2^-11) and exponentials expf, in both kernels.
//
// Each entry point returns the cudaGetLastError() of its launch (0 when it
// was accepted); flash_attention_error_string turns it into text.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, KH, Sq, Skv;
  int causal;   // 0 / 1
  int window;   // 0 = none
  float softcap;  // 0 = none
  float scale;
};

// the kv tiles [x, y) that hold an unmasked pair for q rows [q0, q0 + bq)
__device__ __forceinline__ int2 tile_range(const Params& p, int q0, int bq, int bk) {
  int q_last = min(q0 + bq, p.Sq) - 1;
  int k_end = p.causal ? min(p.Skv, q_last + 1) : p.Skv;
  int first = 0;
  if (p.window > 0) {
    int first_key = q0 - p.window + 1;
    if (first_key > 0) first = first_key / bk;
  }
  return make_int2(first, (k_end + bk - 1) / bk);
}

__device__ __forceinline__ float score(const Params& p, float dot, int row, int col) {
  bool keep = col < p.Skv && (!p.causal || row >= col) && (p.window <= 0 || row - col < p.window);
  if (!keep) return -INFINITY;
  float x = dot * p.scale;
  if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
  return x;
}

// ------------------------------------------------------------------ bf16
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;   // 0 source bytes: the 16 B are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + R) of a (len, row_stride) matrix of D bf16 columns into
// smem rows of LD elements; rows at or past len are zeros
template <int R, int D, int LD, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* g, int r0,
                                          int len, int64_t row_stride) {
  constexpr int CHUNKS = D / 8;   // 16 B each
  for (int c = threadIdx.x; c < R * CHUNKS; c += THREADS) {
    int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    bool valid = r0 + r < len;
    const __nv_bfloat16* src = valid ? g + (r0 + r) * row_stride + col : g;
    cp_async16(smem + r * LD + col, src, valid);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low 16 bits) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

template <int D>
struct Bf16Tiles {
  static constexpr int BQ = 64;
  static constexpr int BK = D >= 256 ? 32 : 64;
  static constexpr int LD = D + 8;   // padded row, bf16 elements
  static constexpr int THREADS = 128;
  static constexpr size_t SMEM = size_t(BQ + 2 * BK) * LD * sizeof(__nv_bfloat16);
};

template <int D>
__global__ void __launch_bounds__(128) fa_bf16_kernel(Params p) {
  using T = Bf16Tiles<D>;
  constexpr int BQ = T::BQ, BK = T::BK, LD = T::LD, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int q0 = q_tile * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t q_stride = int64_t(p.H) * D, kv_stride = int64_t(p.KH) * D;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + (int64_t(b) * p.Sq * p.H + h) * D;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + (int64_t(b) * p.Skv * p.KH + kh) * D;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + (int64_t(b) * p.Skv * p.KH + kh) * D;

  load_tile<BQ, D, LD, T::THREADS>(Qs, qg, q0, p.Sq, q_stride);
  cp_async_commit();

  const int2 tiles = tile_range(p, q0, BQ, BK);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const __nv_bfloat16* qw = Qs + (warp * 16 + g) * LD + 2 * t;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int kt = tiles.x; kt < tiles.y; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // every warp is done with the previous K and V
    load_tile<BK, D, LD, T::THREADS>(Ks, kg, k0, p.Skv, kv_stride);
    cp_async_commit();
    load_tile<BK, D, LD, T::THREADS>(Vs, vg, k0, p.Skv, kv_stride);
    cp_async_commit();
    cp_async_wait<1>();   // Q and K have landed; V may still be in flight
    __syncthreads();

    // s = q . k for this warp's 16 rows and the tile's BK keys; the d loop
    // is unrolled only in pairs, so the q fragments are not all hoisted
    // into registers beside the accumulator
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(qw + kk);
      a[1] = *reinterpret_cast<const uint32_t*>(qw + 8 * LD + kk);
      a[2] = *reinterpret_cast<const uint32_t*>(qw + kk + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(qw + 8 * LD + kk + 8);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const __nv_bfloat16* kr = Ks + (j * 8 + g) * LD + kk + 2 * t;
        mma_bf16(s[j], a, *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale, cap, mask; online softmax over the two rows this thread holds
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row1 : row0;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = score(p, s[j][2 * r + e], row, k0 + j * 8 + 2 * t + e);
          s[j][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[r] - m_use);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float pe = expf(s[j][2 * r + e] - m_use);
          s[j][2 * r + e] = pe;
          sum += pe;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    cp_async_wait<0>();   // V has landed
    __syncthreads();

    // acc += p . v, with p = hi + lo in bf16
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // A fragment i: rows g (i even) / g + 8 (i odd), keys of tile 2kc (i < 2) / 2kc+1
        const float* src = &s[2 * kc + (i >> 1)][2 * (i & 1)];
        __nv_bfloat16 h0 = __float2bfloat16_rn(src[0]), h1 = __float2bfloat16_rn(src[1]);
        hi[i] = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
        lo[i] = pack_bf16(src[0] - __bfloat162float(h0), src[1] - __bfloat162float(h1));
      }
      const __nv_bfloat16* vrow =
          Vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + n * 8);
        mma_bf16(acc[n], hi, bv[0], bv[1]);
        mma_bf16(acc[n], lo, bv[0], bv[1]);
        mma_bf16(acc[n + 1], hi, bv[2], bv[3]);
        mma_bf16(acc[n + 1], lo, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();   // nothing in flight when the block exits (no tile visited)

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + (int64_t(b) * p.Sq * p.H + h) * D;
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f), inv1 = 1.f / fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + row0 * q_stride + col) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (row1 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + row1 * q_stride + col) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// ------------------------------------------------------------------ fp32
template <int D>
struct Fp32Tiles {
  static constexpr int BQ = 32;
  static constexpr int BK = 32;
  static constexpr int THREADS = 256;
  static constexpr size_t SMEM = (size_t(BQ) * D + size_t(BK) * (D + 1) + size_t(BK) * D) * 4;
};

template <int D>
__global__ void __launch_bounds__(256, 1) fa_fp32_kernel(Params p) {
  using T = Fp32Tiles<D>;
  constexpr int BQ = T::BQ, BK = T::BK, NC = D / 32, ROWS = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // BQ x D
  float* Ks = Qs + BQ * D;                           // BK x (D + 1): lane j reads row j
  float* Vs = Ks + BK * (D + 1);                     // BK x D

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int q0 = q_tile * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t q_stride = int64_t(p.H) * D, kv_stride = int64_t(p.KH) * D;
  const float* qg = static_cast<const float*>(p.q) + (int64_t(b) * p.Sq * p.H + h) * D;
  const float* kg = static_cast<const float*>(p.k) + (int64_t(b) * p.Skv * p.KH + kh) * D;
  const float* vg = static_cast<const float*>(p.v) + (int64_t(b) * p.Skv * p.KH + kh) * D;

  for (int i = threadIdx.x; i < BQ * D; i += T::THREADS) {
    int r = i / D, c = i % D;
    Qs[i] = q0 + r < p.Sq ? qg[(q0 + r) * q_stride + c] : 0.f;
  }
  const int2 tiles = tile_range(p, q0, BQ, BK);

  float acc[ROWS][NC], m[ROWS], l[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const float* qw = Qs + warp * ROWS * D;

  for (int kt = tiles.x; kt < tiles.y; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    for (int i = threadIdx.x; i < BK * D; i += T::THREADS) {
      int r = i / D, c = i % D;
      bool valid = k0 + r < p.Skv;
      Ks[r * (D + 1) + c] = valid ? kg[(k0 + r) * kv_stride + c] : 0.f;
      Vs[i] = valid ? vg[(k0 + r) * kv_stride + c] : 0.f;
    }
    __syncthreads();

    float s[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
    const float* kr = Ks + lane * (D + 1);
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) s[i] = fmaf(qw[i * D + d], kd, s[i]);
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float x = score(p, s[i], q0 + warp * ROWS + i, k0 + lane);
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      m[i] = m_new;
      const float pe = expf(x - m_use);
      float sum = pe;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * corr + sum;
      s[i] = pe;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vj[c] = Vs[j * D + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float pj = __shfl_sync(0xffffffffu, s[i], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pj, vj[c], acc[i][c]);
      }
    }
  }

  float* og = static_cast<float*>(p.o) + (int64_t(b) * p.Sq * p.H + h) * D;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + warp * ROWS + i;
    if (row >= p.Sq) continue;
    const float lv = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) og[row * q_stride + lane + 32 * c] = acc[i][c] / lv;
  }
}

// ------------------------------------------------------------------ launch
template <typename Tiles, typename Kernel>
int launch(Kernel kernel, const Params& p, int B, cudaStream_t stream) {
  // one opt-in per kernel and process: above 48 KB dynamic shared memory
  // needs it, and a refused attribute is returned like a refused launch
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Tiles::SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((p.Sq + Tiles::BQ - 1) / Tiles::BQ, p.H, B);
  kernel<<<grid, Tiles::THREADS, Tiles::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const Params& p, int B, int dtype, cudaStream_t s) {
  if (dtype == 1) return launch<Bf16Tiles<D>>(fa_bf16_kernel<D>, p, B, s);
  return launch<Fp32Tiles<D>>(fa_fp32_kernel<D>, p, B, s);
}

}  // namespace

extern "C" {

// o (B, Sq, H, D) from q (B, Sq, H, D), k and v (B, Skv, KH, D); dtype 0
// fp32, 1 bf16; D one of 32, 64, 128, 256; window 0 and softcap 0 mean none
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int KH, int Sq, int Skv, int D, int causal, int window, float softcap,
                        float scale, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || KH <= 0 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  Params p{q, k, v, o, H, KH, Sq, Skv, causal, window, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_d<32>(p, B, dtype, s);
    case 64: return launch_d<64>(p, B, dtype, s);
    case 128: return launch_d<128>(p, B, dtype, s);
    case 256: return launch_d<256>(p, B, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
