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
// Hopper has them, so here the pack is a plain gather and the unpack a
// zero-fill followed by a scatter.
//
// Bound on the H100 (3.35 TB/s): bytes.  The pack reads each index (4 B)
// and the element it names, and writes the value: 12 B per kept fp32
// element, no arithmetic.  The unpack writes the dense N*d output once and
// reads 8 B per kept element.  At N = 8, d = 2^24 + 3, k = ceil(0.1 d):
// pack 161.1 MB -> 0.0481 ms, unpack 644.2 MB -> 0.1923 ms.  Top-k indices
// come in magnitude order, not address order, so every gathered or
// scattered 4 B touches its own 32 B sector: the pack's realistic floor is
// about 0.16 ms.
//
// Design, simple first: one thread per (i, j) over a 1-D grid of N*k.
//  * Pack copies raw bits (4-byte words for fp32, 2-byte for bf16/fp16), so
//    it is exact.  An index outside [0, d) is outside the contract; the
//    kernel writes 0 there instead of reading out of bounds (the one-hot
//    TPU kernel also gives 0).
//  * Unpack: blocks run in no order, so the fill must end before the
//    scatter starts.  Two kernels on one stream: a fill that stores 16 B a
//    thread (bytes before the first 16 B boundary and after the last one
//    are stored singly), then the scatter.  The fill is a kernel of its own
//    and not cudaMemsetAsync, because it is part of what the TPU kernel
//    computes.  The fp32 scatter adds by a compare-and-swap loop in IEEE
//    arithmetic: PTX's atom.add.f32 flushes subnormal inputs to zero, and
//    the plain version does not.  bf16 uses atomicAdd, which on sm_90 is
//    atom.add.noftz.bf16.  With the distinct indices that top-k and rand-k
//    produce, each slot receives one add into +0, so the result is exact and
//    deterministic.  With duplicate indices the adds to one slot happen in
//    an unspecified order, so a bf16 or fp32 sum may differ in its last bit
//    from run to run.
//
// Each entry point returns the cudaGetLastError() of its launches (0 when
// they were accepted); top_k_error_string turns it into text.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

template <typename Word>
__global__ void pack_kernel(const Word* __restrict__ x, const int32_t* __restrict__ idx,
                            Word* __restrict__ vals, int64_t nk, int64_t d, int64_t k) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= nk) return;
  int64_t row = t / k;
  int32_t j = idx[t];
  vals[t] = (j >= 0 && j < d) ? x[row * d + j] : Word(0);
}

// zero n_bytes at out: `head` single bytes up to the first 16 B boundary,
// n16 16 B stores, then `tail` single bytes
__global__ void fill_zero_kernel(unsigned char* __restrict__ out, int head, int64_t n16,
                                 int tail) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < n16) reinterpret_cast<uint4*>(out + head)[t] = make_uint4(0u, 0u, 0u, 0u);
  if (t < head) out[t] = 0;
  if (t < tail) out[head + n16 * 16 + t] = 0;
}

__device__ __forceinline__ void add_exact(float* p, float v) {
  unsigned int* u = reinterpret_cast<unsigned int*>(p);
  unsigned int old = *u, assumed;
  do {
    assumed = old;
    old = atomicCAS(u, assumed, __float_as_uint(__uint_as_float(assumed) + v));
  } while (old != assumed);
}

__device__ __forceinline__ void add_exact(__nv_bfloat16* p, __nv_bfloat16 v) {
  atomicAdd(p, v);
}

template <typename T>
__global__ void scatter_add_kernel(const int32_t* __restrict__ idx, const T* __restrict__ vals,
                                   T* __restrict__ out, int64_t nk, int64_t d, int64_t k) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= nk) return;
  int64_t row = t / k;
  int32_t j = idx[t];
  if (j >= 0 && j < d) add_exact(out + row * d + j, vals[t]);
}

}  // namespace

extern "C" {

// vals (n, k) = x (n, d) gathered at idx (n, k); elem_bytes 4 or 2
int top_k_pack(const void* x, const void* idx, void* vals, int64_t n, int64_t d, int64_t k,
               int elem_bytes, void* stream) {
  int64_t nk = n * k;
  if (nk == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  if (elem_bytes == 4) {
    pack_kernel<uint32_t><<<blocks_for(nk), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(x), ix, static_cast<uint32_t*>(vals), nk, d, k);
  } else if (elem_bytes == 2) {
    pack_kernel<uint16_t><<<blocks_for(nk), kThreads, 0, s>>>(
        static_cast<const uint16_t*>(x), ix, static_cast<uint16_t*>(vals), nk, d, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (n, d) = 0, then out[i, idx[i, j]] += vals[i, j]; dtype 0 fp32, 1 bf16
int top_k_unpack(const void* idx, const void* vals, void* out, int64_t n, int64_t d, int64_t k,
                 int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t n_bytes = n * d * (dtype == 0 ? 4 : 2);
  if (n_bytes > 0) {
    unsigned char* base = static_cast<unsigned char*>(out);
    int64_t head = (16 - static_cast<int64_t>(reinterpret_cast<uintptr_t>(base) & 15)) & 15;
    if (head > n_bytes) head = n_bytes;
    int64_t n16 = (n_bytes - head) / 16;
    int64_t tail = n_bytes - head - n16 * 16;
    int64_t threads = n16 > 16 ? n16 : 16;
    fill_zero_kernel<<<blocks_for(threads), kThreads, 0, s>>>(
        base, static_cast<int>(head), n16, static_cast<int>(tail));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int64_t nk = n * k;
  if (nk == 0) return 0;
  const int32_t* ix = static_cast<const int32_t*>(idx);
  if (dtype == 0) {
    scatter_add_kernel<float><<<blocks_for(nk), kThreads, 0, s>>>(
        ix, static_cast<const float*>(vals), static_cast<float*>(out), nk, d, k);
  } else {
    scatter_add_kernel<__nv_bfloat16><<<blocks_for(nk), kThreads, 0, s>>>(
        ix, static_cast<const __nv_bfloat16*>(vals), static_cast<__nv_bfloat16*>(out), nk, d,
        k);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* top_k_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
