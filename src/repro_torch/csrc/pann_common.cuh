// Shared pieces of the two PANN serving matmul kernels
// (pann_matmul.cu, pann_matmul_packed.cu): the in-kernel affine encode and
// the split-K epilogue.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace pann {

constexpr int kThreads = 128;   // threads per block of the main kernels
constexpr int kCols = 4;        // output columns per thread (one 32-bit load)

// q = clip(rint(x / s) + z, 0, n): op for op repro.core.quant.affine_encode.
// IEEE division (no --use_fast_math) and rintf (round half to even).
__device__ __forceinline__ int8_t encode(float x, float s, float z, float n) {
  float q = rintf(x / s) + z;
  q = fminf(fmaxf(q, 0.0f), n);
  return static_cast<int8_t>(static_cast<int>(q));
}

// Encode rows [m0, m0 + MT) x columns [k0, k0 + kc) of x (M, K) into the
// block's shared code panel codes[MT][kchunk]; rows past M encode to 0.
template <int MT>
__device__ __forceinline__ void encode_panel(const float* __restrict__ x,
                                             int8_t* codes, int M, int K,
                                             int m0, int k0, int kc,
                                             int kchunk, float s, float z,
                                             float n) {
  for (int i = threadIdx.x; i < MT * kc; i += blockDim.x) {
    int mm = i / kc, kk = i - mm * kc;
    int m = m0 + mm;
    codes[mm * kchunk + kk] =
        m < M ? encode(x[(size_t)m * K + k0 + kk], s, z, n) : int8_t(0);
  }
}

// Store a thread's MT x 4 int32 partial sums for split ky.
template <int MT>
__device__ __forceinline__ void store_partial(int* __restrict__ partial,
                                              const int (&acc)[MT][kCols],
                                              int M, int N, int m0, int n0,
                                              int ky) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m0 + m < M) {
      int4 v = make_int4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      *reinterpret_cast<int4*>(partial + ((size_t)ky * M + m0 + m) * N + n0) =
          v;
    }
  }
}

// y = ((sum_k partial - zcol) * s) * gamma, in the reference's association.
// The split sums are integers, so their order cannot change the result.
__global__ void epilogue_kernel(const int* __restrict__ partial,
                                const float* __restrict__ qp,
                                const float* __restrict__ gamma,
                                const int* __restrict__ zcol,
                                float* __restrict__ y, int M, int N,
                                int ksplit) {
  size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t mn = (size_t)M * N;
  if (idx >= mn) return;
  int n = static_cast<int>(idx % N);
  int acc = 0;
  for (int k = 0; k < ksplit; ++k) acc += partial[(size_t)k * mn + idx];
  y[idx] = __fmul_rn(__fmul_rn(static_cast<float>(acc - zcol[n]), qp[0]),
                     gamma[n]);
}

inline int launch_epilogue(const int* partial, const float* qp,
                           const float* gamma, const int* zcol, float* y,
                           int M, int N, int ksplit, cudaStream_t stream) {
  size_t mn = (size_t)M * N;
  int threads = 256;
  unsigned blocks = static_cast<unsigned>((mn + threads - 1) / threads);
  epilogue_kernel<<<blocks, threads, 0, stream>>>(partial, qp, gamma, zcol, y,
                                                  M, N, ksplit);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ int live_shift(const float* qp, int P) {
  int shift = static_cast<int>(rintf(qp[3]));
  return shift < 0 ? 0 : (shift > P ? P : shift);
}

}  // namespace pann
