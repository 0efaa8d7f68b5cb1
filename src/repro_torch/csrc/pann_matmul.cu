// PANN bit-plane serving matmul with the fused activation-quant prologue,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pann_matmul.py::pann_matmul_act
// (_pann_matmul_act_kernel), backend 'fused':
//   q = clip(rint(x / s) + z, 0, n)                  (encoded in the kernel)
//   w = sum_{p >= shift} 2^p (pos_p - neg_p)         (planes p < shift unread)
//   y = ((q @ w - zcol) * s) * gamma                 (exact int32 accumulate)
// with x (M, K) f32, pos/neg (P, K, N) int8 in {0, 1}, qp = [s, z, n, shift]
// a 4-float DEVICE tensor (the TPU kernel's SMEM qparams), gamma (N,) f32,
// zcol (N,) int32.
//
// What bounds it on this card: bytes. At decode M is the batch (4), so the
// product does 2*M MACs per weight and reads 2*(P - shift) plane bytes per
// weight — far below the H100's ~295 ops/byte ridge. The design therefore
// only tries to stream the planes at full width: every thread owns 4
// adjacent output columns and reads them with one 32-bit load per plane,
// so a warp reads 128 contiguous bytes; dead low planes are never loaded.
// M = 4 rows give few column tiles for small N, so K is split across
// blocks (grid.y) to fill the 132 SMs; each split writes exact int32
// partial sums and a second small kernel adds them (integer addition, so
// the order cannot change the result) and applies the fp32 epilogue in the
// reference's association with __fmul_rn. The encoded row panel lives in
// shared memory, as the TPU kernel keeps it in VMEM. Tensor cores (int8
// mma/wgmma) and TMA pipelining are later work.
#include "pann_common.cuh"

namespace {

template <int MT>
__global__ void __launch_bounds__(pann::kThreads)
    pann_matmul_act_kernel(const float* __restrict__ x,
                           const int8_t* __restrict__ pos,
                           const int8_t* __restrict__ neg,
                           const float* __restrict__ qp,
                           int* __restrict__ partial, int M, int K, int N,
                           int P, int kchunk) {
  extern __shared__ int8_t codes[];  // [MT][kchunk]
  const float s = qp[0], z = qp[1], nl = qp[2];
  const int shift = pann::live_shift(qp, P);
  const int m0 = blockIdx.z * MT;
  const int k0 = blockIdx.y * kchunk;
  const int kc = min(kchunk, K - k0);
  pann::encode_panel<MT>(x, codes, M, K, m0, k0, kc, kchunk, s, z, nl);
  __syncthreads();

  const int n0 = (blockIdx.x * blockDim.x + threadIdx.x) * pann::kCols;
  if (n0 >= N) return;
  int acc[MT][pann::kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < pann::kCols; ++c) acc[m][c] = 0;

  const size_t plane = (size_t)K * N;
#pragma unroll 2
  for (int kk = 0; kk < kc; ++kk) {
    const size_t off = (size_t)(k0 + kk) * N + n0;
    int w0 = 0, w1 = 0, w2 = 0, w3 = 0;
    for (int p = shift; p < P; ++p) {
      // times 2^p, not << p: the difference may be negative
      const int bit = 1 << p;
      const char4 a = *reinterpret_cast<const char4*>(pos + p * plane + off);
      const char4 b = *reinterpret_cast<const char4*>(neg + p * plane + off);
      w0 += (a.x - b.x) * bit;
      w1 += (a.y - b.y) * bit;
      w2 += (a.z - b.z) * bit;
      w3 += (a.w - b.w) * bit;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int q = codes[m * kchunk + kk];
      acc[m][0] += q * w0;
      acc[m][1] += q * w1;
      acc[m][2] += q * w2;
      acc[m][3] += q * w3;
    }
  }
  pann::store_partial<MT>(partial, acc, M, N, m0, n0, blockIdx.y);
}

template <int MT>
int launch(const float* x, const int8_t* pos, const int8_t* neg,
           const float* qp, int* partial, int M, int K, int N, int P,
           int ksplit, int kchunk, cudaStream_t stream) {
  const int cols = pann::kThreads * pann::kCols;
  dim3 grid((N + cols - 1) / cols, ksplit, (M + MT - 1) / MT);
  pann_matmul_act_kernel<MT><<<grid, pann::kThreads, MT * kchunk, stream>>>(
      x, pos, neg, qp, partial, M, K, N, P, kchunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper (repro_torch/kernels/pann_matmul.py) checks shapes, dtypes,
// contiguity and N % 4 == 0, and allocates y (M, N) and partial
// (ksplit, M, N). Returns cudaGetLastError() after the launches.
extern "C" int pann_matmul_act_launch(const float* x, const int8_t* pos,
                                      const int8_t* neg, const float* qp,
                                      const float* gamma, const int* zcol,
                                      float* y, int* partial, int M, int K,
                                      int N, int P, int ksplit, int kchunk,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = M <= 4 ? launch<4>(x, pos, neg, qp, partial, M, K, N, P, ksplit,
                               kchunk, st)
                   : launch<8>(x, pos, neg, qp, partial, M, K, N, P, ksplit,
                               kchunk, st);
  if (err != 0) return err;
  return pann::launch_epilogue(partial, qp, gamma, zcol, y, M, N, ksplit, st);
}
