// PANN bit-plane matmuls on unpacked planes, for Hopper (sm_90a):
//
//   pann_matmul_act_launch   replaces repro/kernels/pann_matmul.py::
//                            pann_matmul_act (_pann_matmul_act_kernel), the
//                            fused activation-quant prologue (backend
//                            'fused' and ops.pann_matmul):
//       q = clip(rint(x / s) + z, 0, n)              (encoded in the kernel)
//       y = ((q @ w - zcol) * s) * gamma
//   pann_matmul_launch       replaces repro/kernels/pann_matmul.py::
//                            pann_matmul (_pann_matmul_kernel), the product
//                            on int8 codes already quantized per row:
//       y = ((x_q @ w - zcol) * s_x[m]) * gamma
//
// with w = sum_{p >= shift} 2^p (pos_p - neg_p), pos/neg (P, K, N) int8 in
// {0, 1}, gamma (N,) f32, zcol (N,) int32 or null. For the prologue kernel
// qp = [s, z, n, shift] is a 4-float DEVICE tensor (the TPU kernel's SMEM
// qparams) and planes p < shift are never read; the codes kernel has every
// plane live. Both take mode 'fused' (w rebuilt, one product) or 'planes'
// (the literal Eq.-10 dataflow, per live plane p acc += 2^p (x @ pos_p) -
// 2^p (x @ neg_p)); every sum is exact int32, so the modes agree bit for bit.
//
// What bounds it on this card: at decode M is the batch (4), so the product
// does 2*M MACs per weight and reads 2*(P - shift) plane bytes per weight —
// bytes, far below the H100's ~295 ops/byte ridge. The decode kernels only
// try to stream the planes at full width: every thread owns 4 adjacent
// output columns and reads them with one 32-bit load per plane, so a warp
// reads 128 contiguous bytes; dead low planes are never loaded. M = 4 rows
// give few column tiles for small N, so K is split across blocks (grid.y)
// to fill the 132 SMs; each split writes exact int32 partial sums and a
// second small kernel adds them (integer addition, so the order cannot
// change the result) and applies the fp32 epilogue in the reference's
// association with __fmul_rn. The row panel lives in shared memory, as the
// TPU kernel keeps it in VMEM.
//
// Above 8 rows (a prefill chunk) the product runs on the int8 tensor cores,
// as the TPU kernel runs it on the MXU: pann_tc.cuh's warp-specialised
// 128 x 128 tile kernel (wgmma.m64n128k32.s32.s8.s8). A copy warp streams
// the codes and the live planes with TMA; two worker warpgroups rebuild the
// weight SIMD-within-a-register, write it K-major into shared memory and
// run the products. At M = 512 'fused' is bound by its 2P plane bytes per
// weight (the row tiles of a column panel run together, so a plane byte
// comes from device memory once per panel) and 'planes' by its 2 P_live
// tensor-core products per K step.
#include "pann_common.cuh"
#include "pann_tc.cuh"

namespace {

using pann::kCols;

struct Planes {  // (P, K, N) int8 in {0, 1}
  const int8_t* pos;
  const int8_t* neg;
  int K, N, P;

  __device__ size_t plane() const { return (size_t)K * N; }

  // w[c] = sum_{p >= shift} 2^p (pos_p - neg_p) at offset off = k * N + n0
  __device__ __forceinline__ void rebuild(size_t off, int shift,
                                          int (&w)[kCols]) const {
    w[0] = w[1] = w[2] = w[3] = 0;
    for (int p = shift; p < P; ++p) {
      // times 2^p, not << p: the difference may be negative
      const int bit = 1 << p;
      const char4 a = *reinterpret_cast<const char4*>(pos + p * plane() + off);
      const char4 b = *reinterpret_cast<const char4*>(neg + p * plane() + off);
      w[0] += (a.x - b.x) * bit;
      w[1] += (a.y - b.y) * bit;
      w[2] += (a.z - b.z) * bit;
      w[3] += (a.w - b.w) * bit;
    }
  }

  // the 0/1 bits of plane p at offset off
  __device__ __forceinline__ void bits(int p, size_t off, int (&a)[kCols],
                                       int (&b)[kCols]) const {
    const char4 u = *reinterpret_cast<const char4*>(pos + p * plane() + off);
    const char4 v = *reinterpret_cast<const char4*>(neg + p * plane() + off);
    a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
    b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
  }
};

template <int MT, class Src, bool kPlanes>
__global__ void __launch_bounds__(pann::kThreads)
    decode_kernel(Src src, Planes wts, int* __restrict__ partial, int M,
                  int K, int N, int kchunk) {
  extern __shared__ int8_t codes[];  // [MT][kchunk]
  const int shift = src.shift(wts.P);
  const int m0 = blockIdx.z * MT;
  const int k0 = blockIdx.y * kchunk;
  const int kc = min(kchunk, K - k0);
  pann::load_panel<MT>(src.reader(), codes, M, m0, k0, kc, kchunk);
  __syncthreads();

  const int n0 = (blockIdx.x * blockDim.x + threadIdx.x) * kCols;
  if (n0 >= N) return;
  int acc[MT][kCols] = {};
  if constexpr (kPlanes) {
    for (int p = shift; p < wts.P; ++p) {
      int ap[MT][kCols] = {}, an[MT][kCols] = {};
      for (int kk = 0; kk < kc; ++kk) {
        int a[kCols], b[kCols];
        wts.bits(p, (size_t)(k0 + kk) * N + n0, a, b);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int q = codes[m * kchunk + kk];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            ap[m][c] += q * a[c];
            an[m][c] += q * b[c];
          }
        }
      }
      const int bit = 1 << p;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[m][c] += ap[m][c] * bit - an[m][c] * bit;
    }
  } else {
#pragma unroll 2
    for (int kk = 0; kk < kc; ++kk) {
      int w[kCols];
      wts.rebuild((size_t)(k0 + kk) * N + n0, shift, w);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int q = codes[m * kchunk + kk];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[m][c] += q * w[c];
      }
    }
  }
  pann::store_partial<MT>(partial, acc, M, N, m0, n0, blockIdx.y);
}

template <class Src, bool kPlanes>
int launch_product(Src src, Planes wts, int* partial, int M, int K, int N,
                   int ksplit, int kchunk, cudaStream_t st) {
  if (M <= pann::kDecodeRows) {
    const int cols = pann::kThreads * kCols;
    const int mt = M <= 4 ? 4 : 8;
    dim3 grid((N + cols - 1) / cols, ksplit, (M + mt - 1) / mt);
    if (mt == 4)
      decode_kernel<4, Src, kPlanes><<<grid, pann::kThreads, 4 * kchunk, st>>>(
          src, wts, partial, M, K, N, kchunk);
    else
      decode_kernel<8, Src, kPlanes><<<grid, pann::kThreads, 8 * kchunk, st>>>(
          src, wts, partial, M, K, N, kchunk);
    return static_cast<int>(cudaGetLastError());
  }
  return pann::tc::launch<Src, Planes, kPlanes>(src, wts, partial, M, K, N,
                                                ksplit, kchunk, st);
}

template <class Src>
int launch_mode(Src src, Planes wts, int* partial, int M, int K, int N,
                int ksplit, int kchunk, int planes, cudaStream_t st) {
  return planes ? launch_product<Src, true>(src, wts, partial, M, K, N,
                                            ksplit, kchunk, st)
                : launch_product<Src, false>(src, wts, partial, M, K, N,
                                             ksplit, kchunk, st);
}

}  // namespace

// The wrappers (repro_torch/kernels/pann_matmul.py) check shapes, dtypes,
// contiguity and N % 4 == 0, and allocate y (M, N) and partial (ksplit, M,
// N); kchunk is a multiple of 8 (of 64 above 8 rows). ``planes`` selects
// the mode. Each returns cudaGetLastError() after its launches.
extern "C" int pann_matmul_act_launch(const float* x, const int8_t* pos,
                                      const int8_t* neg, const float* qp,
                                      const float* gamma, const int* zcol,
                                      float* y, int* partial, int M, int K,
                                      int N, int P, int ksplit, int kchunk,
                                      int planes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_mode(pann::FloatRows{x, qp, K}, Planes{pos, neg, K, N, P},
                        partial, M, K, N, ksplit, kchunk, planes, st);
  if (err != 0) return err;
  return pann::launch_epilogue(partial, nullptr, qp, 0, gamma, zcol, y, M, N,
                               ksplit, st);
}

extern "C" int pann_matmul_launch(const int8_t* xq, const int8_t* pos,
                                  const int8_t* neg, const float* s_x,
                                  const float* gamma, const int* zcol,
                                  float* y, int* partial, int M, int K, int N,
                                  int P, int ksplit, int kchunk, int planes,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_mode(pann::CodeRows{xq, K}, Planes{pos, neg, K, N, P},
                        partial, M, K, N, ksplit, kchunk, planes, st);
  if (err != 0) return err;
  return pann::launch_epilogue(partial, nullptr, s_x, 1, gamma, zcol, y, M, N,
                               ksplit, st);
}
