// Chunked RWKV-6 wkv recurrence (the time-mix's linear attention with
// data-dependent decay) for sm_90a.
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
// kernel follows the clamped form, in the reference's order: the in-chunk
// product first, then the incoming state's term.
//
// Layout: r, k, v, logw in the model's (B, S, H, P), read in place (a
// token's P channels are contiguous, tokens H * P apart); r, k and v fp32
// or bf16, logw fp32 or bf16, all upcast to fp32 in registers.  Everything
// is fp32 on FMAs: no tensor cores (no TF32), expf (not __expf).
//
// Bound on the H100: operations, narrowly.  At RWKV-6 3B's layer (B = 2,
// S = 8192, H = 40, P = 64, L = 16) a call needs 12.0 GFLOP (the strictly
// lower scores and their product with v, r~ S and k^T v), 0.179 ms at the
// 67 TFLOP/s fp32 rate, against 589 MB moved, 0.176 ms at 3.35 TB/s.
//
// Design, simple first.  The TPU kernel carries S in VMEM scratch across
// its sequential chunk grid axis (kernel.py:38-40).  Blocks on Hopper run
// in no order, so one block owns a (b, h, 16-column slice of S and y) and
// loops over the chunks itself: the columns of S and y are independent once
// r~ and k~ are known, so 4 slices at P = 64 give 320 blocks at B = 2 for
// the 132 SMs, each recomputing the (cheap) cumsum, exponentials and
// scores.  Per chunk the block stages r, k, logw (all P channels) and its
// slice of v in shared memory, then in turn: one thread per channel runs
// the cumsum and r~; every thread the k~ and decayed-k terms; the strictly
// lower scores; y for the slice; the state update.  The next chunk's
// inputs are loaded into registers while this chunk computes.  Shared rows
// are padded to P + 1 floats, so the score loop (threads on different rows
// of k~) is free of bank conflicts.  L is a run-time value up to 64, under
// a template bound LT (16 or 64) that sizes the prefetch registers: sized
// for 64 tokens, the P = 64 kernel took 243 registers and one block per SM.
// P is a template argument in {16, 32, 64}.
//
// wkv_chunk_fwd returns the cudaGetLastError() of its launch (0 when it was
// accepted); wkv_chunk_error_string turns it into text.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CS = 16;       // columns of S and y per block
constexpr int L_MAX = 64;    // longest chunk
constexpr float CLAMP = 25.f;

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  float* y;
  float* s_final;
  int S, H, L;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// dynamic shared memory, floats: r~, k~, cum, decayed k (L x (P + 1) each),
// scores (L x (L + 1)), v slice (L x CS), S slice (P x CS), exp(cum_L) (P)
template <int P>
size_t smem_bytes(int L) {
  return sizeof(float) *
         (size_t(4) * L * (P + 1) + size_t(L) * (L + 1) + size_t(L) * CS + P * CS + P);
}

template <int P, int LT, typename T, typename TW>
__global__ void __launch_bounds__(THREADS) wkv_kernel(Params p) {
  constexpr int LD = P + 1;
  constexpr int NX = (LT * P + THREADS - 1) / THREADS;   // r, k, logw elements a
                                                          // thread prefetches
  constexpr int NV = (LT * CS + THREADS - 1) / THREADS;  // v elements a thread prefetches
  constexpr int NS = P * CS / THREADS;                   // state entries a thread updates
  static_assert(NS >= 1 && P % CS == 0, "shape");
  extern __shared__ __align__(16) float smem[];
  const int L = p.L;
  float* R = smem;               // r, then r~
  float* K = R + L * LD;         // k, then k~
  float* W = K + L * LD;         // logw, then cum
  float* KS = W + L * LD;        // k * exp(max(cum_L - cum, -25))
  float* SC = KS + L * LD;       // scores, L x (L + 1)
  float* V = SC + L * (L + 1);   // v slice, L x CS
  float* St = V + L * CS;        // S slice, P x CS
  float* ET = St + P * CS;       // exp(cum_L), P

  const int col0 = blockIdx.x * CS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int64_t row = int64_t(p.H) * P;                  // token stride
  const int64_t base = (int64_t(b) * p.S * p.H + h) * P;  // (b, 0, h, 0)
  const T* rg = static_cast<const T*>(p.r) + base;
  const T* kg = static_cast<const T*>(p.k) + base;
  const T* vg = static_cast<const T*>(p.v) + base + col0;
  const TW* wg = static_cast<const TW*>(p.w) + base;
  float* yg = p.y + base + col0;
  const int n_chunks = p.S / L, nx = L * P, nv = L * CS;

  float xr[NX], xk[NX], xw[NX], xv[NV];
  auto fetch = [&](int chunk) {
    const int64_t t0 = int64_t(chunk) * L;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int e = tid + i * THREADS;
      if (e < nx) {
        const int64_t off = (t0 + e / P) * row + e % P;
        xr[i] = to_f(rg[off]);
        xk[i] = to_f(kg[off]);
        xw[i] = to_f(wg[off]);
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = tid + i * THREADS;
      if (e < nv) xv[i] = to_f(vg[(t0 + e / CS) * row + e % CS]);
    }
  };

  for (int e = tid; e < P * CS; e += THREADS) St[e] = 0.f;
  if (n_chunks > 0) fetch(0);
  const int c = tid % CS;   // this thread's column in the y and state passes

  for (int ci = 0; ci < n_chunks; ++ci) {
    // this chunk's inputs into shared memory, then the next chunk's loads
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int e = tid + i * THREADS;
      if (e < nx) {
        const int s = (e / P) * LD + e % P;
        R[s] = xr[i];
        K[s] = xk[i];
        W[s] = xw[i];
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = tid + i * THREADS;
      if (e < nv) V[e] = xv[i];
    }
    __syncthreads();
    if (ci + 1 < n_chunks) fetch(ci + 1);

    // cumsum per channel (in order, as the reference), cex = cum - w, r~
    if (tid < P) {
      float cum = 0.f;
      for (int l = 0; l < L; ++l) {
        const float w = W[l * LD + tid];
        cum += w;
        W[l * LD + tid] = cum;
        R[l * LD + tid] *= expf(fmaxf(cum - w, -CLAMP));
      }
      ET[tid] = expf(cum);
    }
    __syncthreads();

    // k~ and the decayed k of the state update
    for (int e = tid; e < nx; e += THREADS) {
      const int l = e / P, q = e % P;
      const float cum = W[l * LD + q], total = W[(L - 1) * LD + q], kk = K[l * LD + q];
      KS[l * LD + q] = kk * expf(fmaxf(total - cum, -CLAMP));
      K[l * LD + q] = kk * expf(fminf(-cum, CLAMP));
    }
    __syncthreads();

    // strictly lower scores r~_l . k~_m (zero on and above the diagonal)
    for (int e = tid; e < L * L; e += THREADS) {
      const int l = e / L, m = e % L;
      float s = 0.f;
      if (m < l) {
        const float* rl = R + l * LD;
        const float* km = K + m * LD;
#pragma unroll 16
        for (int q = 0; q < P; ++q) s = fmaf(rl[q], km[q], s);
      }
      SC[l * (L + 1) + m] = s;
    }
    __syncthreads();

    // y = scores . v + r~ . S for this block's columns
    const int64_t t0 = int64_t(ci) * L;
    for (int e = tid; e < nv; e += THREADS) {
      const int l = e / CS;
      float intra = 0.f, cross = 0.f;
      for (int m = 0; m < l; ++m) intra = fmaf(SC[l * (L + 1) + m], V[m * CS + c], intra);
      const float* rl = R + l * LD;
#pragma unroll 16
      for (int q = 0; q < P; ++q) cross = fmaf(rl[q], St[q * CS + c], cross);
      yg[(t0 + l) * row + c] = intra + cross;
    }
    __syncthreads();

    // S <- exp(cum_L) S + (decayed k)^T v; a thread's entries share column c
    float ds[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) ds[i] = 0.f;
    for (int l = 0; l < L; ++l) {
      const float vl = V[l * CS + c];
#pragma unroll
      for (int i = 0; i < NS; ++i) ds[i] = fmaf(KS[l * LD + (tid + i * THREADS) / CS], vl, ds[i]);
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int e = tid + i * THREADS;
      St[e] = ET[e / CS] * St[e] + ds[i];
    }
    __syncthreads();
  }

  float* sg = p.s_final + (int64_t(b) * p.H + h) * P * P + col0;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int e = tid + i * THREADS;
    sg[(e / CS) * P + c] = St[e];
  }
}

template <int P, int LT, typename T, typename TW>
int launch(const Params& p, int B, cudaStream_t stream) {
  auto kernel = wkv_kernel<P, LT, T, TW>;
  // one opt-in per kernel and process for the longest chunk's shared
  // memory (above the 48 KB static limit at L = 64); a refused attribute is
  // returned like a refused launch
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<P>(LT)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(P / CS, p.H, B);
  kernel<<<grid, THREADS, smem_bytes<P>(p.L), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int LT>
int launch_l(const Params& p, int B, int rkv_dtype, int w_dtype, cudaStream_t s) {
  if (rkv_dtype == 0 && w_dtype == 0) return launch<P, LT, float, float>(p, B, s);
  if (rkv_dtype == 1 && w_dtype == 0) return launch<P, LT, __nv_bfloat16, float>(p, B, s);
  if (rkv_dtype == 1 && w_dtype == 1)
    return launch<P, LT, __nv_bfloat16, __nv_bfloat16>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int P>
int launch_p(const Params& p, int B, int rkv_dtype, int w_dtype, cudaStream_t s) {
  if (p.L <= 16) return launch_l<P, 16>(p, B, rkv_dtype, w_dtype, s);
  return launch_l<P, L_MAX>(p, B, rkv_dtype, w_dtype, s);
}

}  // namespace

extern "C" {

// y (B, S, H, P) and s_final (B, H, P, P), fp32, from r, k, v (B, S, H, P)
// in rkv_dtype and logw (B, S, H, P) in w_dtype (0 fp32, 1 bf16; logw fp32
// or r's dtype); P one of 16, 32, 64; 1 <= L <= 64 and S a multiple of L
int wkv_chunk_fwd(const void* r, const void* k, const void* v, const void* logw, void* y,
                  void* s_final, int B, int S, int H, int P, int L, int rkv_dtype,
                  int w_dtype, void* stream) {
  if (L < 1 || L > L_MAX || S % L != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  Params p{r, k, v, logw, static_cast<float*>(y), static_cast<float*>(s_final), S, H, L};
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
