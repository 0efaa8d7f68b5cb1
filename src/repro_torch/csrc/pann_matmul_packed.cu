// PANN bit-plane serving matmul on PACKED planes with the fused
// activation-quant prologue, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pann_matmul_packed.py::
// pann_matmul_packed_act (_act_kernel), backend 'packed'. Same function as
// pann_matmul.cu, but the planes are uint8 (P, K/8, N): bit j of byte
// [p, k8, n] is plane p at row 8*k8 + j — the deployment layout, 2*P/8
// bytes per weight for both signs.
//
// What bounds it on this card: bytes, even more than the unpacked kernel —
// 2*(P - shift)/8 bytes per weight against 2*M MACs. Each thread owns 4
// adjacent columns and loads one 32-bit word (4 columns x 8 rows of one
// plane) per live plane per 8 rows of K; dead low planes are never loaded,
// which is a real saving in bytes at the lower rungs. The 8 x 4 weights of
// a word are rebuilt in registers with shifts. K is split across blocks to
// fill the SMs at M = 4; the int32 partials are added and scaled by the
// shared epilogue kernel (pann_common.cuh).
#include "pann_common.cuh"

namespace {

template <int MT>
__global__ void __launch_bounds__(pann::kThreads)
    pann_matmul_packed_act_kernel(const float* __restrict__ x,
                                  const uint8_t* __restrict__ pos,
                                  const uint8_t* __restrict__ neg,
                                  const float* __restrict__ qp,
                                  int* __restrict__ partial, int M, int K,
                                  int N, int P, int kchunk) {
  extern __shared__ int8_t codes[];  // [MT][kchunk]
  const float s = qp[0], z = qp[1], nl = qp[2];
  const int shift = pann::live_shift(qp, P);
  const int m0 = blockIdx.z * MT;
  const int k0 = blockIdx.y * kchunk;  // kchunk % 8 == 0, K % 8 == 0
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

  const size_t plane = (size_t)(K / 8) * N;
  for (int kb = 0; kb < kc; kb += 8) {
    const size_t off = (size_t)((k0 + kb) / 8) * N + n0;
    int w[8][pann::kCols];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < pann::kCols; ++c) w[j][c] = 0;
    for (int p = shift; p < P; ++p) {
      // times 2^p, not << p: the difference may be negative
      const int bit = 1 << p;
      const uchar4 a = *reinterpret_cast<const uchar4*>(pos + p * plane + off);
      const uchar4 b = *reinterpret_cast<const uchar4*>(neg + p * plane + off);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        w[j][0] += (((a.x >> j) & 1) - ((b.x >> j) & 1)) * bit;
        w[j][1] += (((a.y >> j) & 1) - ((b.y >> j) & 1)) * bit;
        w[j][2] += (((a.z >> j) & 1) - ((b.z >> j) & 1)) * bit;
        w[j][3] += (((a.w >> j) & 1) - ((b.w >> j) & 1)) * bit;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int q = codes[m * kchunk + kb + j];
#pragma unroll
        for (int c = 0; c < pann::kCols; ++c) acc[m][c] += q * w[j][c];
      }
    }
  }
  pann::store_partial<MT>(partial, acc, M, N, m0, n0, blockIdx.y);
}

template <int MT>
int launch(const float* x, const uint8_t* pos, const uint8_t* neg,
           const float* qp, int* partial, int M, int K, int N, int P,
           int ksplit, int kchunk, cudaStream_t stream) {
  const int cols = pann::kThreads * pann::kCols;
  dim3 grid((N + cols - 1) / cols, ksplit, (M + MT - 1) / MT);
  pann_matmul_packed_act_kernel<MT>
      <<<grid, pann::kThreads, MT * kchunk, stream>>>(x, pos, neg, qp, partial,
                                                      M, K, N, P, kchunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper (repro_torch/kernels/pann_matmul_packed.py) checks shapes,
// dtypes, contiguity, K % 8 == 0 and N % 4 == 0, and allocates y (M, N) and
// partial (ksplit, M, N). Returns cudaGetLastError() after the launches.
extern "C" int pann_matmul_packed_act_launch(
    const float* x, const uint8_t* pos, const uint8_t* neg, const float* qp,
    const float* gamma, const int* zcol, float* y, int* partial, int M, int K,
    int N, int P, int ksplit, int kchunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = M <= 4 ? launch<4>(x, pos, neg, qp, partial, M, K, N, P, ksplit,
                               kchunk, st)
                   : launch<8>(x, pos, neg, qp, partial, M, K, N, P, ksplit,
                               kchunk, st);
  if (err != 0) return err;
  return pann::launch_epilogue(partial, qp, gamma, zcol, y, M, N, ksplit, st);
}
