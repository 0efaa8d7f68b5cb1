// Per-row unsigned activation quantization (the paper's App. A.4 half
// range), for Hopper (sm_90a). Replaces repro/kernels/quantize_act.py::
// quantize_act (_quantize_kernel):
//
//   scale[m] = max(amax(relu x[m, :]), 1e-12) / qmax       qmax = 2^(b-1) - 1
//   q[m, k]  = clip(rint(relu(x[m, k]) / scale[m]), 0, qmax)   as int8
//
// x is (M, K) fp32 or bf16 (read through __bfloat162float, exact). The
// scale is an IEEE division by qmax, as in the oracle
// repro.kernels.ref.quantize_act_ref (the jitted TPU kernel lets XLA turn
// it into a multiply by 1/qmax, one ulp off in many rows); the codes are an
// IEEE division and rintf (round half to even, as jnp.round), no
// --use_fast_math.
//
// What bounds it on this card: bytes — 4 (or 2) bytes read and 1 written
// per element against a handful of operations. One block per row: the
// block reduces the row's max (exact in any order) with warp shuffles, then
// encodes the row, which the second pass reads again from L2. Consecutive
// threads read consecutive elements.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    quantize_act_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                        float* __restrict__ scale, int K, int qmax) {
  __shared__ float red[kThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * K;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float amax = 0.0f;  // max(relu x) >= 0, so 0 is the identity
  for (int k = threadIdx.x; k < K; k += kThreads)
    amax = fmaxf(amax, to_float(xr[k]));
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) amax = fmaxf(amax, red[i]);
  const float qm = static_cast<float>(qmax);
  const float s = fmaxf(amax, 1e-12f) / qm;
  if (threadIdx.x == 0) scale[row] = s;
  int8_t* qr = q + row * K;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float v = fmaxf(to_float(xr[k]), 0.0f);
    qr[k] = static_cast<int8_t>(
        static_cast<int>(fminf(fmaxf(rintf(v / s), 0.0f), qm)));
  }
}

}  // namespace

// The wrapper (repro_torch/kernels/quantize_act.py) checks shape, dtype and
// contiguity and allocates q (M, K) int8 and scale (M, 1) f32. Returns
// cudaGetLastError() after the launch.
extern "C" int quantize_act_launch(const void* x, int is_bf16, int8_t* q,
                                   float* scale, int M, int K, int qmax,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    quantize_act_kernel<__nv_bfloat16><<<M, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), q, scale, K, qmax);
  else
    quantize_act_kernel<float><<<M, kThreads, 0, st>>>(
        static_cast<const float*>(x), q, scale, K, qmax);
  return static_cast<int>(cudaGetLastError());
}
