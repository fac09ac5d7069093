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
// Design.  The TPU kernel runs its kv tiles as a sequential fourth grid
// axis and carries (m, l, acc) in VMEM scratch between grid steps
// (kernel.py:45-49, :86-89).  Blocks on Hopper run in no order, so one block
// owns a (b, h, q-tile) and loops over the kv tiles itself, carrying the
// running state in registers.  As in kernel.py:51-58 it visits only the
// tiles that hold an unmasked pair: none past the causal frontier and none
// wholly older than the window.  The last (longest) causal q-tiles of every
// head launch first, so the longest blocks start first.
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
// bf16 at D = 128 and 256 (fa_hopper_kernel): warp-specialised, TMA and
// wgmma.  One block of 384 threads owns 128 query rows: warpgroups 0 and 1
// are consumers of 64 rows each, warpgroup 2 the producer, and setmaxnreg
// moves registers from the producer (24) to the consumers (240), which
// keep the 64 x D fp32 accumulator (128 registers a thread at D = 256)
// beside the scores and p.  One elected producer thread loads Q once and
// then K and V tile by tile with cp.async.bulk.tensor into a ring of two
// stages, each tile guarded by a full mbarrier (the TMA's byte count) and
// an empty one (one arrival per consumer warp), so loads run ahead of the
// products.  The tensor maps are encoded on the host for every call over
// the (B, S, H, D) strides with a 128-byte swizzle (boxes of 64 columns,
// so a D = 256 row is four boxes); rows past Sq or Skv load as zeros.
// Kv tiles are 64 keys at D = 256 and 128 at D = 128: shared memory is
// Q 64 KB + 2 x (K 32 KB + V 32 KB) = 192 KB at D = 256, 160 KB at 128.
// s = q.k is wgmma m64nBKk16 with both operands in shared memory (K-major);
// o += p.v is wgmma m64nDk16 with p from registers and V read MN-major
// from shared memory (the transpose bit), so V needs no transpose.  The
// descriptors' 128-byte swizzle is the TMA's.  Each consumer step starts
// s_i = q.k_i and o += p_(i-1).v_(i-1) together and then hands the tensor
// cores to the other warpgroup (named barriers 1 and 2, in turn), so one
// warpgroup's softmax runs while the other's products do; within a step the
// scores of s_i are computed while p_(i-1).v_(i-1) is still running.  Every
// branch around a wgmma operand is uniform over the block (the mask test
// takes the block's 128 rows), else ptxas serialises the wgmmas (C7520).
// The epilogue works in the exp2 domain: scale * log2(e) is one multiplier
// (or scale / softcap in and softcap * log2(e) out), tanh is
// 1 - 2 / (1 + 2^(2|x| log2 e)) with the sign put back -- within a few fp32
// ulps, where tanh.approx.f32 errs by ~2^-11, 0.024 on a score capped at
// 50 -- and the mask compares run only on the tiles that straddle the
// causal diagonal, the window's lower edge or the Skv tail.  The l sums
// stay per thread until the end.
// The probabilities are fp32; rounding them to bf16 for the p.v product
// would move the output by about a bf16 ulp against the fp32 reference, so
// p is split into a bf16 head and a bf16 remainder (p = hi + lo to 2^-16)
// and both go through the tensor cores: 1.5x the mma work of a single p.v,
// the price of agreeing with the fp32 softmax to within one bf16 rounding.
// A tensor-map encode that fails is returned as a negative error code.
//
// bf16 at D = 32 and 64 (fa_bf16_kernel, reduced configs only): the first,
// simple Ampere-style kernel, kept because no full-width config has these
// head dims and a D = 32 row is narrower than a 128-byte swizzle box.
// 4 warps, 64 query rows, 16 per warp; kv tiles of 64 keys; Q, K and V
// in dynamic shared memory, rows padded by 16 bytes against bank conflicts;
// K and V by cp.async in two groups; mma.sync m16n8k16 (bf16 in, fp32 out)
// with the same p = hi + lo split.
//
// fp32 (fa_fp32_kernel): plain FMAs, no tensor cores, so no TF32 rounding.
// 8 warps, 32 query rows (4 per warp), kv tiles of 32 keys: lane j scores
// key j for its warp's 4 rows, the row max and sum are warp shuffles, and
// lane j accumulates output columns j, j + 32, ...  Soft-capping uses tanhf
// and exponentials expf.
//
// Each entry point returns the cudaGetLastError() of its launch (0 when it
// was accepted); flash_attention_error_string turns it into text.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

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
  float scale_log2;   // scale * log2(e): the exponent's base-2 multiplier
  float cap_in;       // scale / softcap
  float cap_out;      // softcap * log2(e)
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
  static constexpr int BK = 64;
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

// ------------------------------------------------------- bf16, Hopper path
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// one arrival that also expects `bytes` from the TMA
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a (64, 1, rows, 1) box at (c0, c1, c2, c3) of a 4-d tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving an accumulator across a wgmma's start or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: 8-row groups 1024 B
// apart (SBO); `lbo` bytes between 64-column boxes of an MN-major operand
// (unused by a K-major one, whose k16 slice lies inside a 128-byte row)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(x) = sign(x) (1 - 2 / (1 + e^(2|x|))), within a few fp32 ulps of 1
__device__ __forceinline__ float tanh_fp32(float x) {
  const float e = ex2(fabsf(x) * 2.8853900817779268f);   // 2 log2(e)
  return copysignf(1.f - 2.f * rcp(1.f + e), x);
}

// wgmma m64nNk16, fp32 += bf16 x bf16.  ss: A and B from shared memory, both
// K-major; rs: A from registers, B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(
    float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n256(
    float (&d)[128], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, scale_d);
  else wgmma_ss_n128(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 128) wgmma_rs_n128(d, a, b, 1);
  else wgmma_rs_n256(d, a, b, 1);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// the named barriers by which the two consumer warpgroups take turns on
// the tensor cores (0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(d[i][r])::"memory");
}

template <int D>
struct HopperTiles {
  static constexpr int BQ = 128;                    // two consumer warpgroups of 64 rows
  static constexpr int BK = D >= 256 ? 64 : 128;    // keys per kv tile
  static constexpr int STAGES = 2;
  static constexpr int NB = D / 64;                 // 128-byte boxes per row
  static constexpr int THREADS = 384;
  static constexpr int Q_WG_BYTES = 64 * D * 2;     // one consumer's 64 rows of Q
  static constexpr int KV_BYTES = BK * D * 2;       // one K or V tile
  static constexpr int BOX_BYTES = BK * 128;        // one 64-column box of a K or V tile
  static constexpr size_t SMEM = size_t(2 * Q_WG_BYTES + 2 * STAGES * KV_BYTES) + 1024;
};

template <int D, bool CAP>
__global__ void __launch_bounds__(384, 1)
    fa_hopper_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, Params p) {
  using T = HopperTiles<D>;
  constexpr int BK = T::BK, NB = T::NB, ST = T::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // q, then full K, full V, empty K, empty V for each stage
  __shared__ __align__(8) uint64_t bars[1 + 4 * ST];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;   // the swizzle's 1024 B atoms
  const uint32_t s_k = s_q + 2 * T::Q_WG_BYTES, s_v = s_k + ST * T::KV_BYTES;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * ST;
  const uint32_t empty_k = full_v + 8 * ST, empty_v = empty_k + 8 * ST;

  const int q_tile = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (p.H / p.KH);
  const int q0 = q_tile * T::BQ;
  const int2 tiles = tile_range(p, q0, T::BQ, BK);
  const int n_tiles = max(tiles.y - tiles.x, 0);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 8);   // one arrival per consumer warp
      mbar_init(empty_v + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------ producer
    setmaxnreg_dec<24>();
    // with no kv tile the consumers never wait on Q, so nothing is loaded:
    // the block must not exit with a bulk copy into its shared memory in flight
    if (threadIdx.x == 256 && n_tiles > 0) {
      mbar_expect_tx(bar_q, 2 * T::Q_WG_BYTES);
      for (int w = 0; w < 2; ++w)
        for (int kb = 0; kb < NB; ++kb)
          tma_load(s_q + (w * NB + kb) * 8192, &tm_q, bar_q, kb * 64, h, q0 + 64 * w, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST, k0 = (tiles.x + i) * BK;
        const uint32_t parity = ((i / ST) & 1) ^ 1;
        mbar_wait(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, T::KV_BYTES);
        for (int kb = 0; kb < NB; ++kb)
          tma_load(s_k + s * T::KV_BYTES + kb * T::BOX_BYTES, &tm_k, full_k + 8 * s, kb * 64,
                   kh, k0, b);
        mbar_wait(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, T::KV_BYTES);
        for (int kb = 0; kb < NB; ++kb)
          tma_load(s_v + s * T::KV_BYTES + kb * T::BOX_BYTES, &tm_v, full_v + 8 * s, kb * 64,
                   kh, k0, b);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    // Each step starts s_i = q . k_i and o += p_(i-1) . v_(i-1) together,
    // then hands the tensor cores to the other warpgroup (named barriers 1
    // and 2) and runs the softmax of s_i while they work: the scores as soon
    // as s_i lands, the rescale of o and the next p once p_(i-1) . v_(i-1)
    // has.  Every branch around a wgmma operand is uniform over the block,
    // so ptxas need not serialise the wgmmas.
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const int row0 = q0 + 64 * wg + warp * 16 + lane / 4, row1 = row0 + 8;
    const uint32_t q_base = s_q + wg * T::Q_WG_BYTES;
    const int my_turn = 1 + wg, other_turn = 2 - wg;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;   // l per thread until the end
    float sc[BK / 2];
    uint32_t ph[BK / 16][4], pl[BK / 16][4];

    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // s = q . k_i^T: D / 16 k-steps, 32 bytes apart inside a box
    auto mma_s = [&](int i) {
      const uint32_t k_base = s_k + (i % ST) * T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<BK>(sc, sw128_desc(q_base + (kk / 4) * 8192 + off, 16),
                     sw128_desc(k_base + (kk / 4) * T::BOX_BYTES + off, 16), kk > 0);
      }
      wgmma_commit();
    };
    // o += p . v_i: BK / 16 k-steps of 16 keys, 2048 bytes apart
    auto mma_pv = [&](int i) {
      const uint32_t v_base = s_v + (i % ST) * T::KV_BYTES;
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        const uint64_t dv = sw128_desc(v_base + kc * 2048, T::BOX_BYTES);
        wgmma_rs<D>(o, ph[kc], dv);
        wgmma_rs<D>(o, pl[kc], dv);
      }
      wgmma_commit();
    };
    // scale (and cap) into the exp2 domain; mask only where the block's
    // rows straddle the tile's diagonal, the window's lower edge or the Skv tail
    auto scores = [&](int i) {
      const int k0 = (tiles.x + i) * BK;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        if constexpr (CAP) sc[j] = tanh_fp32(sc[j] * p.cap_in) * p.cap_out;
        else sc[j] *= p.scale_log2;
      }
      const bool edge = k0 + BK > p.Skv || (p.causal && k0 + BK - 1 > q0) ||
                        (p.window > 0 && q0 + T::BQ - 1 - k0 >= p.window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const int row = (j & 2) ? row1 : row0;
          const int col = k0 + (j / 4) * 8 + 2 * t + (j & 1);
          const bool keep = col < p.Skv && (!p.causal || row >= col) &&
                            (p.window <= 0 || row - col < p.window);
          sc[j] = keep ? sc[j] : -INFINITY;
        }
      }
    };
    // online softmax over the two rows this thread holds; o rescaled; p =
    // hi + lo in bf16, in the wgmma A-fragment order (register r of k-step
    // kc holds the accumulator pair 8 kc + 2 r, 8 kc + 2 r + 1)
    auto softmax = [&]() {
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0, mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float c0 = ex2(m0 - mu0), c1 = ex2(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        sc[4 * j] = ex2(sc[4 * j] - mu0);
        sc[4 * j + 1] = ex2(sc[4 * j + 1] - mu0);
        sc[4 * j + 2] = ex2(sc[4 * j + 2] - mu1);
        sc[4 * j + 3] = ex2(sc[4 * j + 3] - mu1);
        s0 += sc[4 * j] + sc[4 * j + 1];
        s1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * c0 + s0;
      l1 = l1 * c1 + s1;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= c0;
        o[4 * n + 1] *= c0;
        o[4 * n + 2] *= c1;
        o[4 * n + 3] *= c1;
      }
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = sc[8 * kc + 2 * r], c = sc[8 * kc + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
          const float2 hf = __bfloat1622float2(hi);
          ph[kc][r] = bf16x2_bits(hi);
          pl[kc][r] = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, c - hf.y));
        }
      }
    };

    if (n_tiles > 0) {
      if (wg == 1) named_arrive(1);   // warpgroup 0 takes the first turn
      mbar_wait(bar_q, 0);
      // tile 0: scores only
      named_sync(my_turn);
      mbar_wait(full_k, 0);
      fence_regs(sc);
      wgmma_fence();
      mma_s(0);
      named_arrive(other_turn);
      wgmma_wait<0>();
      fence_regs(sc);
      release(empty_k);
      scores(0);
      softmax();
      // tile i's scores beside tile i - 1's p . v
      for (int i = 1; i < n_tiles; ++i) {
        const int s = i % ST, sp = (i - 1) % ST;
        named_sync(my_turn);
        mbar_wait(full_k + 8 * s, (i / ST) & 1);
        mbar_wait(full_v + 8 * sp, ((i - 1) / ST) & 1);
        fence_regs(sc);
        fence_regs(o);
        fence_regs(ph);
        fence_regs(pl);
        wgmma_fence();
        mma_s(i);
        mma_pv(i - 1);
        named_arrive(other_turn);
        wgmma_wait<1>();   // s_i has landed; p_(i-1) . v_(i-1) may still run
        fence_regs(sc);
        release(empty_k + 8 * s);
        scores(i);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(ph);
        fence_regs(pl);
        release(empty_v + 8 * sp);
        softmax();
      }
      // the last tile's p . v
      const int sl = (n_tiles - 1) % ST;
      named_sync(my_turn);
      mbar_wait(full_v + 8 * sl, ((n_tiles - 1) / ST) & 1);
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_fence();
      mma_pv(n_tiles - 1);
      if (wg == 0) named_arrive(2);   // warpgroup 1 takes the last turn
      wgmma_wait<0>();
      fence_regs(o);
      release(empty_v + 8 * sl);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    const int64_t q_stride = int64_t(p.H) * D;
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + (int64_t(b) * p.Sq * p.H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (row0 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(og + row0 * q_stride + col) =
            __floats2bfloat162_rn(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      if (row1 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(og + row1 * q_stride + col) =
            __floats2bfloat162_rn(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
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
// the dynamic shared memory opt-in, once per kernel and process: above
// 48 KB it is needed, and a refused attribute is returned like a refused launch
template <auto Kernel>
cudaError_t smem_opt_in(size_t bytes) {
  static cudaError_t attr = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  return attr;
}

template <typename Tiles, auto Kernel>
int launch(const Params& p, int B, cudaStream_t stream) {
  cudaError_t attr = smem_opt_in<Kernel>(Tiles::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((p.Sq + Tiles::BQ - 1) / Tiles::BQ, p.H, B);
  Kernel<<<grid, Tiles::THREADS, Tiles::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point query so the
// library links against no libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = cached;
  return cudaSuccess;
}

// a (B, S, heads, D) bf16 tensor as a 4-d map of (64, 1, rows, 1) boxes,
// 128-byte swizzle, rows past S read as zeros; a failure is -CUresult
int encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int S, int heads,
               int D, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2, cuuint64_t(heads) * D * 2,
                                 cuuint64_t(S) * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

template <int D>
int launch_hopper(const Params& p, int B, cudaStream_t stream) {
  using T = HopperTiles<D>;
  EncodeTiled encode;
  cudaError_t found = encode_fn(&encode);
  if (found != cudaSuccess) return static_cast<int>(found);
  CUtensorMap tq, tk, tv;
  int err = encode_map(encode, &tq, p.q, B, p.Sq, p.H, D, 64);
  if (err == 0) err = encode_map(encode, &tk, p.k, B, p.Skv, p.KH, D, T::BK);
  if (err == 0) err = encode_map(encode, &tv, p.v, B, p.Skv, p.KH, D, T::BK);
  if (err != 0) return err;
  const bool cap = p.softcap > 0.f;
  cudaError_t attr = cap ? smem_opt_in<fa_hopper_kernel<D, true>>(T::SMEM)
                         : smem_opt_in<fa_hopper_kernel<D, false>>(T::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // the last (longest) causal q-tiles of every head first
  dim3 grid(p.H, B, (p.Sq + T::BQ - 1) / T::BQ);
  if (cap) fa_hopper_kernel<D, true><<<grid, T::THREADS, T::SMEM, stream>>>(tq, tk, tv, p);
  else fa_hopper_kernel<D, false><<<grid, T::THREADS, T::SMEM, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const Params& p, int B, int dtype, cudaStream_t s) {
  if (dtype == 0) return launch<Fp32Tiles<D>, fa_fp32_kernel<D>>(p, B, s);
  if constexpr (D >= 128) return launch_hopper<D>(p, B, s);
  else return launch<Bf16Tiles<D>, fa_bf16_kernel<D>>(p, B, s);
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
  const float log2e = 1.4426950408889634f;
  Params p{q, k, v, o, H, KH, Sq, Skv, causal, window, softcap, scale, scale * log2e,
           softcap > 0.f ? scale / softcap : 0.f, softcap * log2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_d<32>(p, B, dtype, s);
    case 64: return launch_d<64>(p, B, dtype, s);
    case 128: return launch_d<128>(p, B, dtype, s);
    case 256: return launch_d<256>(p, B, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a CUDA error's text, or for a negative code the tensor-map encode's CUresult
const char* flash_attention_error_string(int err) {
  static char text[96];
  if (err < 0) {
    snprintf(text, sizeof(text), "cuTensorMapEncodeTiled failed with CUresult %d", -err);
    return text;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
