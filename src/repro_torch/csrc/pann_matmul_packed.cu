// PANN bit-plane matmuls on PACKED planes, for Hopper (sm_90a):
//
//   pann_matmul_packed_act_launch  replaces repro/kernels/
//       pann_matmul_packed.py::pann_matmul_packed_act (_act_kernel),
//       backend 'packed': fp32 x encoded in the kernel, per-tensor s.
//   pann_matmul_packed_launch      replaces repro/kernels/
//       pann_matmul_packed.py::pann_matmul_packed (_kernel): int8 codes
//       x_q with per-row scales s_x, every plane live.
//
// The same functions as pann_matmul.cu ('fused' mode), but the planes are
// uint8 (P, K/8, N): bit j of byte [p, k8, n] is plane p at row 8*k8 + j —
// the deployment layout, 2*P/8 bytes per weight for both signs.
//
// What bounds it on this card: bytes at decode, even more than the unpacked
// kernel — 2*(P - shift)/8 bytes per weight against 2*M MACs. Each thread
// owns 4 adjacent columns and loads one 32-bit word (4 columns x 8 rows of
// one plane) per live plane per 8 rows of K; dead low planes are never
// loaded, which is a real saving in bytes at the lower rungs. The 8 x 4
// weights of a word are rebuilt in registers with shifts. K is split across
// blocks to fill the SMs at M = 4; the int32 partials are added and scaled
// by the shared epilogue kernel (pann_common.cuh). Above 8 rows the tile
// kernel of pann_common.cuh rebuilds each weight tile once for 64 rows.
#include "pann_common.cuh"

namespace {

using pann::kCols;

struct PackedPlanes {  // (P, K/8, N) uint8
  const uint8_t* pos;
  const uint8_t* neg;
  int K, N, P;

  // w[j][c] = sum_{p >= shift} 2^p (pos_p - neg_p) at row k + j (k % 8 ==
  // 0), column n0 + c
  __device__ __forceinline__ void rebuild8(int k, int n0, int shift,
                                           int (&w)[8][kCols]) const {
    const size_t plane = (size_t)(K / 8) * N;
    const size_t off = (size_t)(k / 8) * N + n0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < kCols; ++c) w[j][c] = 0;
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
  }
};

template <int MT, class Src>
__global__ void __launch_bounds__(pann::kThreads)
    decode_kernel(Src src, PackedPlanes wts, int* __restrict__ partial, int M,
                  int K, int N, int kchunk) {
  extern __shared__ int8_t codes[];  // [MT][kchunk]
  const int shift = src.shift(wts.P);
  const int m0 = blockIdx.z * MT;
  const int k0 = blockIdx.y * kchunk;  // kchunk % 8 == 0, K % 8 == 0
  const int kc = min(kchunk, K - k0);
  pann::load_panel<MT>(src.reader(), codes, M, m0, k0, kc, kchunk);
  __syncthreads();

  const int n0 = (blockIdx.x * blockDim.x + threadIdx.x) * kCols;
  if (n0 >= N) return;
  int acc[MT][kCols] = {};
  for (int kb = 0; kb < kc; kb += 8) {
    int w[8][kCols];
    wts.rebuild8(k0 + kb, n0, shift, w);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int q = codes[m * kchunk + kb + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[m][c] += q * w[j][c];
      }
    }
  }
  pann::store_partial<MT>(partial, acc, M, N, m0, n0, blockIdx.y);
}

template <class Src>
int launch_product(Src src, PackedPlanes wts, int* partial, int M, int K,
                   int N, int ksplit, int kchunk, cudaStream_t st) {
  if (M <= pann::kDecodeRows) {
    const int cols = pann::kThreads * kCols;
    const int mt = M <= 4 ? 4 : 8;
    dim3 grid((N + cols - 1) / cols, ksplit, (M + mt - 1) / mt);
    if (mt == 4)
      decode_kernel<4, Src><<<grid, pann::kThreads, 4 * kchunk, st>>>(
          src, wts, partial, M, K, N, kchunk);
    else
      decode_kernel<8, Src><<<grid, pann::kThreads, 8 * kchunk, st>>>(
          src, wts, partial, M, K, N, kchunk);
  } else {
    dim3 grid((N + pann::kTileN - 1) / pann::kTileN, ksplit,
              (M + pann::kTileM - 1) / pann::kTileM);
    pann::pann_tile_kernel<Src, PackedPlanes>
        <<<grid, pann::kTileThreads, 0, st>>>(src, wts, partial, M, K, N,
                                              kchunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrappers (repro_torch/kernels/pann_matmul_packed.py) check shapes,
// dtypes, contiguity, K % 8 == 0 and N % 4 == 0, and allocate y (M, N) and
// partial (ksplit, M, N); kchunk is a multiple of 8 (of 32 above 8 rows).
// Each returns cudaGetLastError() after its launches.
extern "C" int pann_matmul_packed_act_launch(
    const float* x, const uint8_t* pos, const uint8_t* neg, const float* qp,
    const float* gamma, const int* zcol, float* y, int* partial, int M, int K,
    int N, int P, int ksplit, int kchunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_product(pann::FloatRows{x, qp, K},
                           PackedPlanes{pos, neg, K, N, P}, partial, M, K, N,
                           ksplit, kchunk, st);
  if (err != 0) return err;
  return pann::launch_epilogue(partial, nullptr, qp, 0, gamma, zcol, y, M, N,
                               ksplit, st);
}

extern "C" int pann_matmul_packed_launch(
    const int8_t* xq, const uint8_t* pos, const uint8_t* neg,
    const float* s_x, const float* gamma, const int* zcol, float* y,
    int* partial, int M, int K, int N, int P, int ksplit, int kchunk,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_product(pann::CodeRows{xq, K},
                           PackedPlanes{pos, neg, K, N, P}, partial, M, K, N,
                           ksplit, kchunk, st);
  if (err != 0) return err;
  return pann::launch_epilogue(partial, nullptr, s_x, 1, gamma, zcol, y, M, N,
                               ksplit, st);
}
