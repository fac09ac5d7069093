// Chunked RWKV-6 wkv recurrence (the time-mix's linear attention with
// data-dependent decay) for sm_90a, chunk-parallel.
//
// Replaces the TPU kernel src/repro/kernels/wkv_chunk/kernel.py:
//   wkv_chunk_fwd (:80, pallas_call at :94) with its body _wkv_kernel (:35).
//   Per (b, h) and chunk of L tokens, with the state S (P x P, fp32) carried
//   from chunk to chunk and starting at zero:
//     cum   = inclusive cumsum of logw over the chunk, cex = cum - logw
//     r~    = r * exp(max(cex, -25)),  k~ = k * exp(min(-cum, 25))
//     y     = tril(r~ k~^T, -1) v  +  r~ S
//     S    <- exp(cum_L) (.) S  +  (k * exp(max(cum_L - cum, -25)))^T v
//   y (B, S, H, P) and the final state (B, H, P, P) in fp32.
//
// The clamps are part of the function: where a chunk's log-decay sums past
// -25 this departs from the exact per-token recurrence (the op's plain
// version), as the TPU kernel and the reference's chunked XLA path do.  The
// kernel follows the clamped form, in the reference's order within a chunk:
// the cumsum per channel in token order, the in-chunk product first, then
// the incoming state's term.
//
// Layout: r, k, v, logw in the model's (B, S, H, P), read in place (a
// token's P channels are contiguous, tokens H * P apart); r, k and v fp32
// or bf16, logw fp32 or bf16, all upcast to fp32.  Everything is fp32 on
// FMAs: no tensor cores (no TF32), expf (not __expf).
//
// Bound on the H100: operations, narrowly.  At RWKV-6 3B's layer (B = 2,
// S = 8192, H = 40, P = 64, L = 16) the function needs 12.0 GFLOP (the
// strictly lower scores and their product with v, r~ S and k^T v), 0.179 ms
// at the 67 TFLOP/s fp32 rate, against 589 MB moved, 0.176 ms at 3.35 TB/s.
//
// Design.  The TPU kernel carries S in VMEM scratch across its sequential
// chunk grid axis (kernel.py:38-40).  Of that chain only one step is truly
// sequential, S <- exp(total) (.) S + ds_c, one FMA per state entry per
// chunk; everything else in a chunk depends on that chunk alone.  So each
// (b, h) sequence is cut into groups of G consecutive chunks and one op
// call is three launches:
//   A  (grid groups x H x B) folds each group's chunks into its increment
//      U <- exp(total_c) (.) U + ds_c and decay product D <- D (.)
//      exp(total_c), written to a scratch buffer;
//   B  (one thread per 4 state entries of each (b, h), looping over the
//      groups, 8 groups' loads issued at once) carries S <- D_g (.) S + U_g
//      from zero, writes each group's entering state over its U_g and the
//      last S to s_final;
//   C  (grid groups x H x B) loads its group's entering state into shared
//      memory and replays the group's chunks: cumsum, r~, k~, k_s; the
//      strictly lower scores; y = scores v + r~ S over all P columns; S <-
//      exp(total) (.) S + k_s^T v.
// G = max(1, 256 / L) (kernels/wkv_chunk/kernel.py::group_size): 16 at
// L = 16, so the full-width call has 32 x 40 x 2 = 2,560 blocks in A and C
// (the single-pass design had 320, each walking 512 chunks) and no block's
// chain is longer than 16 chunks.  B's time grows with the number of groups
// it walks, while A's and C's barely move with G, so groups of 256 tokens
// beat groups of 128 on the H100 (PERF.md).  The design's cost: ds_c is
// computed in A and again in C (17.4 GFLOP for the function's 12.0), and
// the inputs are read twice and the 43 MB scratch makes a round trip (about
// 1.1 GB moved for the function's 0.59 GB), which floor it at about 0.33
// ms.  The carry reassociates the decay products across a group's chunks;
// its CPU mirror ``wkv_grouped_ref`` holds the plain chunked form within
// rtol / atol 1e-5 (tests/test_torch_wkv_grouped.py).
//
// Inside A and C: 2P threads (128 at P = 64).  A chunk's raw rows land in
// shared memory by cp.async, the next chunk's copy issued as soon as the
// current one has been converted, so it overlaps the chunk's products.  One
// thread per (channel, parity of token) runs the cumsum in token order and
// the exponentials of its tokens.  The products are register-blocked, with
// float2 / float4 shared loads: a score tile of 2 x 2 (r~ and k~ stored
// channel-major), a y tile of 2 tokens x 4 columns, a state tile of 4 rows
// x P / 8 columns.  C has four barriers a chunk, A two.
//
// wkv_chunk_fwd returns the cudaGetLastError() of its launches (0 when all
// were accepted); wkv_chunk_error_string turns it into text.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int L_MAX = 64;    // longest chunk
constexpr float CLAMP = 25.f;
constexpr int CARRY_THREADS = 256;
constexpr int CARRY_AHEAD = 8;   // groups whose loads pass B issues together
// threads of A and C an SM should hold: caps their registers at 128 a thread
constexpr int CHUNK_BLOCKS_SM = 512;

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  float* y;
  float* s_final;
  float* scratch;   // (B, H, NG, P * P + P): each group's U (P x P), then D (P)
  int S, H, L, G, NG, n_chunks;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// L rows of P elements, H * P apart in global memory, packed into shared
template <int P, typename X>
__device__ __forceinline__ void copy_rows(X* dst, const X* src, int64_t stride, int L) {
  constexpr int SEG = P * int(sizeof(X)) / 16;   // 16-byte pieces a row
  for (int e = threadIdx.x; e < L * SEG; e += blockDim.x) {
    const int l = e / SEG, s = e % SEG;
    cp_async16(reinterpret_cast<char*>(dst + l * P) + s * 16,
               reinterpret_cast<const char*>(src + l * stride) + s * 16);
  }
}

// the shared arrays of the two chunk passes, carved from dynamic shared
// memory: the raw rows first (16-byte aligned), then fp32 arrays whose
// sizes are all multiples of 4 floats
__host__ __device__ constexpr int padded_l(int L) { return ((L + 1) & ~1) + 2; }

template <int P, typename T, typename TW>
__host__ __device__ constexpr size_t raw_bytes(int L, int n_rkv) {
  return size_t(L) * P * (n_rkv * sizeof(T) + sizeof(TW));
}

template <int P, typename T, typename TW>
size_t smem_a(int L) {
  return raw_bytes<P, T, TW>(L, 2) + sizeof(float) * (size_t(2) * L * P + P);
}

template <int P, typename T, typename TW>
size_t smem_c(int L) {
  const size_t lp = padded_l(L);
  return raw_bytes<P, T, TW>(L, 3) +
         sizeof(float) * (size_t(P) * P + size_t(2) * L * P + 2 * P * lp + lp * lp + P);
}

// The state tile a thread owns in A and C: rows 4 * (tid / 8) + i (i < 4)
// and P / 8 columns, in NJ runs of VW consecutive columns 8 * VW apart, so
// the 8 threads of a row group read neighbouring vectors.
template <int P>
struct StateTile {
  static constexpr int CQ = P / 8;
  static constexpr int VW = CQ < 4 ? CQ : 4;
  static constexpr int NJ = CQ / VW;
  __device__ static int row0() { return 4 * (threadIdx.x / 8); }
  __device__ static int col(int jj) { return VW * (threadIdx.x % 8) + 8 * VW * jj; }
};

template <int VW>
__device__ __forceinline__ void ld_vec(float* d, const float* s) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(s);
    d[0] = t.x, d[1] = t.y, d[2] = t.z, d[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(s);
    d[0] = t.x, d[1] = t.y;
  }
}

template <int VW>
__device__ __forceinline__ void st_vec(float* s, const float* d) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(s) = make_float4(d[0], d[1], d[2], d[3]);
  } else {
    *reinterpret_cast<float2*>(s) = make_float2(d[0], d[1]);
  }
}

// ds = k_s^T v for this thread's state tile, from KS and VF (L x P each)
template <int P>
__device__ __forceinline__ void state_increment(float (&acc)[4][P / 8], const float* KS,
                                                const float* VF, int L) {
  using Tile = StateTile<P>;
  const int p0 = Tile::row0();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < Tile::CQ; ++j) acc[i][j] = 0.f;
  for (int l = 0; l < L; ++l) {
    const float4 kk = *reinterpret_cast<const float4*>(KS + l * P + p0);
    const float ks[4] = {kk.x, kk.y, kk.z, kk.w};
    float vv[Tile::CQ];
#pragma unroll
    for (int jj = 0; jj < Tile::NJ; ++jj)
      ld_vec<Tile::VW>(vv + jj * Tile::VW, VF + l * P + Tile::col(jj));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < Tile::CQ; ++j) acc[i][j] = fmaf(ks[i], vv[j], acc[i][j]);
  }
}

template <typename T>
__device__ __forceinline__ const T* at_token(const void* base, const Params& p, int P,
                                             int64_t t) {
  // (b, t, h, 0) of a (B, S, H, P) tensor
  const int64_t off = ((int64_t(blockIdx.z) * p.S + t) * p.H + blockIdx.y) * P;
  return static_cast<const T*>(base) + off;
}

// Pass A: one block per (group, h, b); each group's (D, U) into scratch.
template <int P, typename T, typename TW>
__global__ void __launch_bounds__(2 * P, CHUNK_BLOCKS_SM / (2 * P)) wkv_pass_a(Params p) {
  using Tile = StateTile<P>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = p.L;
  T* Kr = reinterpret_cast<T*>(smem_raw);
  T* Vr = Kr + L * P;
  TW* Wr = reinterpret_cast<TW*>(Vr + L * P);
  float* VF = reinterpret_cast<float*>(smem_raw + raw_bytes<P, T, TW>(L, 2));
  float* KS = VF + L * P;
  float* E = KS + L * P;

  const int tid = threadIdx.x, q = tid % P, hf = tid / P;
  const int64_t stride = int64_t(p.H) * P;
  const int c0 = blockIdx.x * p.G, c1 = min(c0 + p.G, p.n_chunks);
  auto issue = [&](int c) {
    const int64_t t0 = int64_t(c) * L;
    copy_rows<P>(Kr, at_token<T>(p.k, p, P, t0), stride, L);
    copy_rows<P>(Vr, at_token<T>(p.v, p, P, t0), stride, L);
    copy_rows<P>(Wr, at_token<TW>(p.w, p, P, t0), stride, L);
    cp_async_commit();
  };

  float u[4][Tile::CQ], ds[4][Tile::CQ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < Tile::CQ; ++j) u[i][j] = 0.f;
  float d_prod = 1.f;   // channel q's decay product (threads with hf == 0)

  issue(c0);
  for (int c = c0; c < c1; ++c) {
    cp_async_wait_all();
    __syncthreads();
    // cumsum in token order; k_s and v as fp32 for this thread's tokens
    float total = 0.f;
    for (int l = 0; l < L; ++l) total += to_f(Wr[l * P + q]);
    float cum = 0.f;
    for (int l = 0; l < L; ++l) {
      cum += to_f(Wr[l * P + q]);
      if ((l & 1) == hf) {
        KS[l * P + q] = to_f(Kr[l * P + q]) * expf(fmaxf(total - cum, -CLAMP));
        VF[l * P + q] = to_f(Vr[l * P + q]);
      }
    }
    if (hf == 0) {
      const float e = expf(total);
      E[q] = e;
      d_prod *= e;
    }
    __syncthreads();
    if (c + 1 < c1) issue(c + 1);
    state_increment<P>(ds, KS, VF, L);
    const int p0 = Tile::row0();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e = E[p0 + i];
#pragma unroll
      for (int j = 0; j < Tile::CQ; ++j) u[i][j] = e * u[i][j] + ds[i][j];
    }
  }

  float* grp = p.scratch +
               ((int64_t(blockIdx.z) * p.H + blockIdx.y) * p.NG + blockIdx.x) * (P * P + P);
  const int p0 = Tile::row0();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < Tile::NJ; ++jj)
      st_vec<Tile::VW>(grp + (p0 + i) * P + Tile::col(jj), u[i] + jj * Tile::VW);
  if (hf == 0) grp[P * P + q] = d_prod;
}

// Pass B: one thread per 4 neighbouring state entries of a (b, h) (one row
// of S, so one decay); the carry across groups.
template <int P>
__global__ void __launch_bounds__(CARRY_THREADS) wkv_pass_b(Params p, int64_t lanes) {
  const int64_t i = int64_t(blockIdx.x) * CARRY_THREADS + threadIdx.x;
  if (i >= lanes) return;
  const int64_t bh = i / (P * P / 4);
  const int e = 4 * int(i % (P * P / 4)), row = e / P;
  float* base = p.scratch + bh * p.NG * (P * P + P);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int g0 = 0; g0 < p.NG; g0 += CARRY_AHEAD) {
    float4 u[CARRY_AHEAD];
    float d[CARRY_AHEAD];
#pragma unroll
    for (int j = 0; j < CARRY_AHEAD; ++j) {
      if (g0 + j < p.NG) {
        const float* grp = base + int64_t(g0 + j) * (P * P + P);
        u[j] = *reinterpret_cast<const float4*>(grp + e);
        d[j] = grp[P * P + row];
      }
    }
#pragma unroll
    for (int j = 0; j < CARRY_AHEAD; ++j) {
      if (g0 + j < p.NG) {
        // the group's entering state over its increment
        *reinterpret_cast<float4*>(base + int64_t(g0 + j) * (P * P + P) + e) = s;
        s.x = d[j] * s.x + u[j].x;
        s.y = d[j] * s.y + u[j].y;
        s.z = d[j] * s.z + u[j].z;
        s.w = d[j] * s.w + u[j].w;
      }
    }
  }
  *reinterpret_cast<float4*>(p.s_final + 4 * i) = s;
}

// Pass C: one block per (group, h, b); y of the group's chunks.
template <int P, typename T, typename TW>
__global__ void __launch_bounds__(2 * P, CHUNK_BLOCKS_SM / (2 * P)) wkv_pass_c(Params p) {
  using Tile = StateTile<P>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = p.L, LP = padded_l(L);
  T* Rr = reinterpret_cast<T*>(smem_raw);
  T* Kr = Rr + L * P;
  T* Vr = Kr + L * P;
  TW* Wr = reinterpret_cast<TW*>(Vr + L * P);
  float* Sm = reinterpret_cast<float*>(smem_raw + raw_bytes<P, T, TW>(L, 3));  // P x P
  float* VF = Sm + P * P;     // v, L x P
  float* KS = VF + L * P;     // k * exp(max(total - cum, -25)), L x P
  float* RT = KS + L * P;     // r~, channel-major, P x LP
  float* KT = RT + P * LP;    // k~, channel-major, P x LP
  float* ST = KT + P * LP;    // scores, ST[m][l] = r~_l . k~_m (m < l), LP x LP
  float* E = ST + LP * LP;    // exp(total), P

  const int tid = threadIdx.x, q = tid % P, hf = tid / P;
  const int64_t stride = int64_t(p.H) * P;
  const int c0 = blockIdx.x * p.G, c1 = min(c0 + p.G, p.n_chunks);
  auto issue = [&](int c) {
    const int64_t t0 = int64_t(c) * L;
    copy_rows<P>(Rr, at_token<T>(p.r, p, P, t0), stride, L);
    copy_rows<P>(Kr, at_token<T>(p.k, p, P, t0), stride, L);
    copy_rows<P>(Vr, at_token<T>(p.v, p, P, t0), stride, L);
    copy_rows<P>(Wr, at_token<TW>(p.w, p, P, t0), stride, L);
    cp_async_commit();
  };

  issue(c0);
  {   // the group's entering state, written by pass B
    const float* grp = p.scratch +
        ((int64_t(blockIdx.z) * p.H + blockIdx.y) * p.NG + blockIdx.x) * (P * P + P);
    for (int e = 4 * tid; e < P * P; e += 4 * 2 * P)
      *reinterpret_cast<float4*>(Sm + e) = *reinterpret_cast<const float4*>(grp + e);
  }
  const int nl = (L + 1) / 2;            // 2-token row tiles
  const int n_tiles = nl * (nl + 1) / 2;  // score tiles on and below the diagonal
  const int y_q0 = 4 * (tid % (P / 4));   // this thread's y columns
  float* yg = p.y + ((int64_t(blockIdx.z) * p.S) * p.H + blockIdx.y) * P;

  for (int c = c0; c < c1; ++c) {
    cp_async_wait_all();
    __syncthreads();
    // cumsum in token order, then r~, k~, k_s and v as fp32 for this
    // thread's tokens (those of parity hf)
    float total = 0.f;
    for (int l = 0; l < L; ++l) total += to_f(Wr[l * P + q]);
    float cum = 0.f;
    for (int l = 0; l < L; ++l) {
      const float w = to_f(Wr[l * P + q]);
      cum += w;
      if ((l & 1) == hf) {
        const float kk = to_f(Kr[l * P + q]);
        RT[q * LP + l] = to_f(Rr[l * P + q]) * expf(fmaxf(cum - w, -CLAMP));
        KT[q * LP + l] = kk * expf(fminf(-cum, CLAMP));
        KS[l * P + q] = kk * expf(fmaxf(total - cum, -CLAMP));
        VF[l * P + q] = to_f(Vr[l * P + q]);
      }
    }
    if (hf == 0) E[q] = expf(total);
    __syncthreads();
    if (c + 1 < c1) issue(c + 1);

    // strictly lower scores, 2 x 2 tiles on and below the diagonal
    for (int e = tid; e < n_tiles; e += 2 * P) {
      int lt = 0;
      while ((lt + 1) * (lt + 2) / 2 <= e) ++lt;
      const int l0 = 2 * lt, m0 = 2 * (e - lt * (lt + 1) / 2);
      float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
#pragma unroll 8
      for (int x = 0; x < P; ++x) {
        const float2 rr = *reinterpret_cast<const float2*>(RT + x * LP + l0);
        const float2 kk = *reinterpret_cast<const float2*>(KT + x * LP + m0);
        a00 = fmaf(rr.x, kk.x, a00);
        a01 = fmaf(rr.x, kk.y, a01);
        a10 = fmaf(rr.y, kk.x, a10);
        a11 = fmaf(rr.y, kk.y, a11);
      }
      ST[m0 * LP + l0] = m0 < l0 ? a00 : 0.f;
      ST[(m0 + 1) * LP + l0] = m0 + 1 < l0 ? a01 : 0.f;
      ST[m0 * LP + l0 + 1] = m0 < l0 + 1 ? a10 : 0.f;
      ST[(m0 + 1) * LP + l0 + 1] = m0 + 1 < l0 + 1 ? a11 : 0.f;
    }
    __syncthreads();

    // y = scores v + r~ S: 2 tokens x 4 columns a thread
    const int64_t t0 = int64_t(c) * L;
    for (int l0 = 2 * (tid / (P / 4)); l0 < L; l0 += 16) {
      float in0[4] = {0.f, 0.f, 0.f, 0.f}, in1[4] = {0.f, 0.f, 0.f, 0.f};
      float cr0[4] = {0.f, 0.f, 0.f, 0.f}, cr1[4] = {0.f, 0.f, 0.f, 0.f};
      for (int m = 0; m <= l0; ++m) {   // scores vanish from m = l0 + 1 on
        const float2 s = *reinterpret_cast<const float2*>(ST + m * LP + l0);
        float vv[4];
        ld_vec<4>(vv, VF + m * P + y_q0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          in0[j] = fmaf(s.x, vv[j], in0[j]);
          in1[j] = fmaf(s.y, vv[j], in1[j]);
        }
      }
#pragma unroll 8
      for (int x = 0; x < P; ++x) {
        const float2 rr = *reinterpret_cast<const float2*>(RT + x * LP + l0);
        float ss[4];
        ld_vec<4>(ss, Sm + x * P + y_q0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cr0[j] = fmaf(rr.x, ss[j], cr0[j]);
          cr1[j] = fmaf(rr.y, ss[j], cr1[j]);
        }
      }
      float out[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j] = in0[j] + cr0[j];
      st_vec<4>(yg + (t0 + l0) * stride + y_q0, out);
      if (l0 + 1 < L) {
#pragma unroll
        for (int j = 0; j < 4; ++j) out[j] = in1[j] + cr1[j];
        st_vec<4>(yg + (t0 + l0 + 1) * stride + y_q0, out);
      }
    }
    if (c + 1 == c1) break;   // pass B gave the next group its state
    float ds[4][Tile::CQ];
    state_increment<P>(ds, KS, VF, L);
    __syncthreads();   // every y has read S

    // S <- exp(total) (.) S + ds on this thread's tile
    const int p0 = Tile::row0();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e = E[p0 + i];
#pragma unroll
      for (int jj = 0; jj < Tile::NJ; ++jj) {
        float* sp = Sm + (p0 + i) * P + Tile::col(jj);
        float s[Tile::VW];
        ld_vec<Tile::VW>(s, sp);
#pragma unroll
        for (int j = 0; j < Tile::VW; ++j) s[j] = e * s[j] + ds[i][jj * Tile::VW + j];
        st_vec<Tile::VW>(sp, s);
      }
    }
  }
}

// one opt-in per kernel and process for the longest chunk's shared memory
// (above the 48 KB static limit at L = 64); a refused attribute is returned
// like a refused launch
template <typename K>
cudaError_t opt_in(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int P, typename T, typename TW>
int launch(const Params& p, int B, cudaStream_t stream) {
  static const cudaError_t attr_a = opt_in(wkv_pass_a<P, T, TW>, smem_a<P, T, TW>(L_MAX));
  static const cudaError_t attr_c = opt_in(wkv_pass_c<P, T, TW>, smem_c<P, T, TW>(L_MAX));
  if (attr_a != cudaSuccess) return static_cast<int>(attr_a);
  if (attr_c != cudaSuccess) return static_cast<int>(attr_c);
  const dim3 groups(p.NG, p.H, B);
  if (p.NG > 0) {
    wkv_pass_a<P, T, TW><<<groups, 2 * P, smem_a<P, T, TW>(p.L), stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t lanes = int64_t(B) * p.H * P * P / 4;
  wkv_pass_b<P><<<static_cast<unsigned>((lanes + CARRY_THREADS - 1) / CARRY_THREADS),
                  CARRY_THREADS, 0, stream>>>(p, lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.NG == 0) return static_cast<int>(err);
  wkv_pass_c<P, T, TW><<<groups, 2 * P, smem_c<P, T, TW>(p.L), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_p(const Params& p, int B, int rkv_dtype, int w_dtype, cudaStream_t s) {
  if (rkv_dtype == 0 && w_dtype == 0) return launch<P, float, float>(p, B, s);
  if (rkv_dtype == 1 && w_dtype == 0) return launch<P, __nv_bfloat16, float>(p, B, s);
  if (rkv_dtype == 1 && w_dtype == 1) return launch<P, __nv_bfloat16, __nv_bfloat16>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// y (B, S, H, P) and s_final (B, H, P, P), fp32, from r, k, v (B, S, H, P)
// in rkv_dtype and logw (B, S, H, P) in w_dtype (0 fp32, 1 bf16; logw fp32
// or r's dtype), all 16-byte aligned; P one of 16, 32, 64; 1 <= L <= 64 and
// S a multiple of L; groups of G >= 1 chunks; scratch holds B * H *
// ceil(S / L / G) * (P * P + P) floats
int wkv_chunk_fwd(const void* r, const void* k, const void* v, const void* logw, void* y,
                  void* s_final, void* scratch, int B, int S, int H, int P, int L, int G,
                  int rkv_dtype, int w_dtype, void* stream) {
  if (L < 1 || L > L_MAX || S % L != 0 || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const int n_chunks = S / L;
  Params p{r, k, v, logw, static_cast<float*>(y), static_cast<float*>(s_final),
           static_cast<float*>(scratch), S, H, L, G, (n_chunks + G - 1) / G, n_chunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return launch_p<16>(p, B, rkv_dtype, w_dtype, s);
    case 32: return launch_p<32>(p, B, rkv_dtype, w_dtype, s);
    case 64: return launch_p<64>(p, B, rkv_dtype, w_dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* wkv_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
