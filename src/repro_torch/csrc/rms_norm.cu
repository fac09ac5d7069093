// Fused RMSNorm for sm_90a: one warp per row, the row held in registers.
//
// Replaces the TPU kernel src/repro/kernels/rms_norm/kernel.py:
//   rms_norm_fwd (:29, pallas_call at :41) with its body _rms_kernel (:18):
//     y = x * rsqrt(mean(x^2) + eps) * (w or w + 1)   per row, fp32 reduction,
//   y in x's dtype.  Any leading dims (the wrapper flattens them to rows).
//
// Bound on the H100: HBM bytes.  One read of x and one write of y (plus the
// d weights once) against 4 operations per element: at Gemma-2's rows of
// d_model = 2304 in bf16, 16,384 rows move 151 MB, 0.045 ms at 3.35 TB/s.
//
// Design.  The TPU kernel tiles 256 rows into VMEM.  Here a warp owns a
// row: each lane loads NV vectors of 16 bytes (8 bf16 or fp16, 4 fp32), so
// a row of 2304 bf16 is 9 vectors a lane with no lane masked (the Triton
// kernel it follows rounded d up to a 4096-lane block, 44% of it masked,
// and reduced over 16 warps through shared memory).  The sum of squares is
// taken in fp32 in registers and reduced by warp shuffles; the row is then
// scaled from the same registers and stored, so x is read once.  A block of
// 8 warps takes 8 rows; it converts the weight (and the + 1) to fp32 in
// shared memory while its rows are in flight, and every row reads it from
// there by float4.  Measured on the H100 at 16,384 x 2304 bf16, this beat
// the two designs tried first, a grid of the blocks that fit at once whose
// warps walk the rows (the last round of rows leaves SMs idle), with the
// weight in registers (72 a lane at d = 2304, so fewer warps fit) or with
// the next row loaded early.  x and y go by evict-first loads and stores,
// since neither is touched again here.  NV is a template argument from a
// short list, the smallest that covers d.
//
// A scalar path (one warp per row, lanes striding over the row, two reads
// of x) takes what the vector path cannot: a d that is not a multiple of
// the vector, x or y not on a 16-byte boundary, or a d above the register
// cap (32 vectors a lane: 8192 bf16 or fp16, 4096 fp32).
//
// rsqrtf is the hardware's approximation (2 ulp), and the sum runs in
// another order than the plain version's, so fp32 outputs differ from it
// by an ulp or two.
//
// rms_norm_fwd returns the cudaGetLastError() of its launch (0 when it was
// accepted); rms_norm_error_string turns it into text.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;          // rows a block
constexpr int THREADS = 32 * WARPS;
constexpr int NV_MAX = 32;        // 16-byte vectors of x a lane holds
constexpr int PRELOAD = 8;        // weight loads a thread issues at once

struct Args {
  const void* x;
  const void* w;
  void* out;
  int64_t rows;
  int d, w_dtype, plus_one;
  float eps;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

// weight element e in fp32, + 1 where asked (w_dtype 0 fp32, 1 bf16, 2 fp16)
__device__ __forceinline__ float weight_at(const Args& a, int64_t e) {
  float v;
  if (a.w_dtype == 0) {
    v = static_cast<const float*>(a.w)[e];
  } else if (a.w_dtype == 1) {
    v = __bfloat162float(static_cast<const __nv_bfloat16*>(a.w)[e]);
  } else {
    v = __half2float(static_cast<const __half*>(a.w)[e]);
  }
  return a.plus_one ? v + 1.f : v;
}

// a 16-byte vector as VEC = 16 / sizeof(T) floats, and back, word by word
__device__ __forceinline__ float lo_f(unsigned w, float) { return __uint_as_float(w); }
__device__ __forceinline__ float lo_f(unsigned w, __nv_bfloat16) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(unsigned w, __nv_bfloat16) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float lo_f(unsigned w, __half) {
  return __low2float(*reinterpret_cast<const __half2*>(&w));
}
__device__ __forceinline__ float hi_f(unsigned w, __half) {
  return __high2float(*reinterpret_cast<const __half2*>(&w));
}
__device__ __forceinline__ unsigned bits16(float v, __nv_bfloat16) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ unsigned bits16(float v, __half) {
  return __half_as_ushort(__float2half_rn(v));
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* f) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = lo_f(w[i], T());
    } else {
      f[2 * i] = lo_f(w[i], T());
      f[2 * i + 1] = hi_f(w[i], T());
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      w[i] = __float_as_uint(f[i]);
    } else {
      w[i] = bits16(f[2 * i], T()) | (bits16(f[2 * i + 1], T()) << 16);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// VEC consecutive fp32 weights from shared memory, by float4
template <int VEC>
__device__ __forceinline__ void weights(float* d, const float* s) {
#pragma unroll
  for (int i = 0; i < VEC; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(s + i);
    d[i] = t.x, d[i + 1] = t.y, d[i + 2] = t.z, d[i + 3] = t.w;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// row's vectors of this lane (zeros past the row or past the last row), by
// evict-first loads: x is read once
template <typename T, int NV>
__device__ __forceinline__ void load_row(uint4 (&raw)[NV], const Args& a, int64_t row,
                                         int nvec, int lane) {
  const uint4* xr = reinterpret_cast<const uint4*>(static_cast<const T*>(a.x) + row * a.d);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * 32 + lane;
    raw[i] = row < a.rows && j < nvec ? __ldcs(xr + j) : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(THREADS) rms_norm_vec(Args a) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) float wsh[];   // d weights, fp32, + 1 applied
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nvec = a.d / VEC;   // vectors in a row
  const int64_t step = int64_t(gridDim.x) * WARPS;
  int64_t row = int64_t(blockIdx.x) * WARPS + warp;
  uint4 raw[NV];
  load_row<T, NV>(raw, a, row, nvec, lane);   // in flight while the weights load

  for (int e0 = threadIdx.x; e0 < a.d; e0 += PRELOAD * THREADS) {
    float v[PRELOAD];
#pragma unroll
    for (int u = 0; u < PRELOAD; ++u) {
      const int e = e0 + u * THREADS;
      v[u] = e < a.d ? weight_at(a, e) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < PRELOAD; ++u) {
      const int e = e0 + u * THREADS;
      if (e < a.d) wsh[e] = v[u];
    }
  }
  __syncthreads();

  for (; row < a.rows; row += step) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float f[VEC];
      unpack<T>(raw[i], f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss = fmaf(f[e], f[e], ss);
    }
    const float r = rsqrtf(warp_sum(ss) / static_cast<float>(a.d) + a.eps);
    uint4* yr = reinterpret_cast<uint4*>(static_cast<T*>(a.out) + row * a.d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = i * 32 + lane;
      if (j < nvec) {
        float f[VEC], wv[VEC];
        unpack<T>(raw[i], f);
        weights<VEC>(wv, wsh + j * VEC);
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = f[e] * r * wv[e];
        __stcs(yr + j, pack<T>(f));   // evict-first: y is not read here again
      }
    }
    load_row<T, NV>(raw, a, row + step, nvec, lane);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rms_norm_scalar(Args a) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int64_t row = int64_t(blockIdx.x) * WARPS + warp; row < a.rows;
       row += int64_t(gridDim.x) * WARPS) {
    const T* xr = static_cast<const T*>(a.x) + row * a.d;
    T* yr = static_cast<T*>(a.out) + row * a.d;
    float ss = 0.f;
    for (int e = lane; e < a.d; e += 32) {
      const float f = to_f(xr[e]);
      ss = fmaf(f, f, ss);
    }
    const float r = rsqrtf(warp_sum(ss) / static_cast<float>(a.d) + a.eps);
    for (int e = lane; e < a.d; e += 32) yr[e] = from_f<T>(to_f(xr[e]) * r * weight_at(a, e));
  }
}

// a warp for every row (the grid strides only past the launch limit)
template <typename K>
int launch(K kernel, const Args& a, size_t smem, cudaStream_t stream) {
  const int64_t blocks = (a.rows + WARPS - 1) / WARPS;
  kernel<<<static_cast<unsigned>(blocks < INT32_MAX ? blocks : INT32_MAX), THREADS, smem,
           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, bool vector_ok, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int need = (a.d / VEC + 31) / 32;   // vectors a lane
  if (!vector_ok || a.d % VEC != 0 || need > NV_MAX)
    return launch(rms_norm_scalar<T>, a, 0, s);
  const size_t smem = sizeof(float) * a.d;
  if (need <= 1) return launch(rms_norm_vec<T, 1>, a, smem, s);
  if (need <= 2) return launch(rms_norm_vec<T, 2>, a, smem, s);
  if (need <= 3) return launch(rms_norm_vec<T, 3>, a, smem, s);
  if (need <= 4) return launch(rms_norm_vec<T, 4>, a, smem, s);
  if (need <= 6) return launch(rms_norm_vec<T, 6>, a, smem, s);
  if (need <= 8) return launch(rms_norm_vec<T, 8>, a, smem, s);
  if (need <= 9) return launch(rms_norm_vec<T, 9>, a, smem, s);
  if (need <= 12) return launch(rms_norm_vec<T, 12>, a, smem, s);
  if (need <= 16) return launch(rms_norm_vec<T, 16>, a, smem, s);
  if (need <= 18) return launch(rms_norm_vec<T, 18>, a, smem, s);
  return launch(rms_norm_vec<T, NV_MAX>, a, smem, s);
}

}  // namespace

extern "C" {

// out (rows, d) in x's dtype from x (rows, d) and w (d,); x_dtype and
// w_dtype 0 fp32, 1 bf16, 2 fp16; plus_one scales by w + 1
int rms_norm_fwd(const void* x, const void* w, void* out, long long rows, int d, int x_dtype,
                 int w_dtype, int plus_one, float eps, void* stream) {
  if (rows < 0 || d < 1 || w_dtype < 0 || w_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const Args a{x, w, out, rows, d, w_dtype, plus_one, eps};
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return dispatch<float>(a, aligned, s);
    case 1: return dispatch<__nv_bfloat16>(a, aligned, s);
    case 2: return dispatch<__half>(a, aligned, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* rms_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
