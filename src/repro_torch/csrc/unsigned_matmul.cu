// Unsigned-split integer matmul (the paper's Sec. 4, Eq. 5-6), for Hopper
// (sm_90a). Replaces repro/kernels/unsigned_matmul.py::unsigned_matmul
// (_unsigned_matmul_kernel):
//
//   W+ = max(W, 0), W- = max(-W, 0)            (split in registers)
//   y  = ((x_q @ W+ - x_q @ W-) * s_x[m]) * s_w[n]
//
// with x_q (M, K) int8 codes >= 0, w_q (K, N) int8 in [-127, 127], s_x (M,)
// and s_w (N,) f32. The two unsigned products accumulate in two exact int32
// sums, as the TPU kernel's two dot_generals do, and are subtracted once.
//
// What bounds it on this card: at decode (M <= 8) bytes — one byte per
// weight against 2*M MACs — so each thread owns 4 adjacent columns and
// reads them with one 32-bit load per row of K (a warp reads 128
// contiguous bytes), with K split across blocks to fill the SMs; the
// epilogue kernel subtracts the W- sums from the W+ sums after adding the
// splits. Above 8 rows the product runs on the int8 tensor cores:
// pann_tc.cuh's tile kernel in mode kSplit. Its copy warp streams the
// codes and one TMA box of the weight (64 rows x 128 columns) a K step;
// the workers split each 32-bit word into W+ and W- bytes, store both as
// K-major tiles and each warpgroup issues two wgmma a 32-k step, into
// acc_pos and acc_neg; the kernel subtracts once before it writes its
// split's sums, and the epilogue kernel adds the splits and scales. Two
// products a weight, against one for torch._int_mm on the same bytes.
#include "pann_common.cuh"
#include "pann_tc.cuh"

namespace {

using pann::kCols;

__device__ __forceinline__ void split(char4 v, int (&a)[kCols],
                                      int (&b)[kCols]) {
  const int w[kCols] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    a[c] = max(w[c], 0);
    b[c] = max(-w[c], 0);
  }
}

template <int MT>
__global__ void __launch_bounds__(pann::kThreads)
    decode_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                  int* __restrict__ partial, int M, int K, int N,
                  int kchunk) {
  extern __shared__ int8_t codes[];  // [MT][kchunk]
  const int m0 = blockIdx.z * MT;
  const int k0 = blockIdx.y * kchunk;
  const int kc = min(kchunk, K - k0);
  pann::load_panel<MT>(pann::CodeRows{xq, K}, codes, M, m0, k0, kc, kchunk);
  __syncthreads();

  const int n0 = (blockIdx.x * blockDim.x + threadIdx.x) * kCols;
  if (n0 >= N) return;
  int acc_p[MT][kCols] = {}, acc_n[MT][kCols] = {};
#pragma unroll 2
  for (int kk = 0; kk < kc; ++kk) {
    int a[kCols], b[kCols];
    split(*reinterpret_cast<const char4*>(w + (size_t)(k0 + kk) * N + n0), a,
          b);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int q = codes[m * kchunk + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        acc_p[m][c] += q * a[c];
        acc_n[m][c] += q * b[c];
      }
    }
  }
  const size_t neg = (size_t)gridDim.y * M * N;
  pann::store_partial<MT>(partial, acc_p, M, N, m0, n0, blockIdx.y);
  pann::store_partial<MT>(partial + neg, acc_n, M, N, m0, n0, blockIdx.y);
}

struct SignedWeight {  // (K, N) int8 in [-127, 127]
  const int8_t* w;
  int K;
};

}  // namespace

// The wrapper (repro_torch/kernels/unsigned_matmul.py) checks shapes,
// dtypes, contiguity and N % 4 == 0, and allocates y (M, N) and partial:
// up to 8 rows (2, ksplit, M, N), the W+ sums, then the W- sums, with
// kchunk a multiple of 8; above 8 rows (ksplit, M, N), the differences,
// with kchunk a multiple of 64. Returns cudaGetLastError() after the
// launches.
extern "C" int unsigned_matmul_launch(const int8_t* xq, const int8_t* w,
                                      const float* s_x, const float* s_w,
                                      float* y, int* partial, int M, int K,
                                      int N, int ksplit, int kchunk,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > pann::kDecodeRows) {
    int err = pann::tc::launch<pann::CodeRows, pann::tc::Mode::kSplit>(
        pann::CodeRows{xq, K}, SignedWeight{w, K}, partial, M, K, N,
        ksplit, kchunk, st);
    if (err != 0) return err;
    return pann::launch_epilogue(partial, nullptr, s_x, 1, s_w, nullptr, y,
                                 M, N, ksplit, st);
  }
  const int cols = pann::kThreads * kCols;
  const int mt = M <= 4 ? 4 : 8;
  dim3 grid((N + cols - 1) / cols, ksplit, (M + mt - 1) / mt);
  if (mt == 4)
    decode_kernel<4><<<grid, pann::kThreads, 4 * kchunk, st>>>(
        xq, w, partial, M, K, N, kchunk);
  else
    decode_kernel<8><<<grid, pann::kThreads, 8 * kchunk, st>>>(
        xq, w, partial, M, K, N, kchunk);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return pann::launch_epilogue(partial, partial + (size_t)ksplit * M * N, s_x,
                               1, s_w, nullptr, y, M, N, ksplit, st);
}
