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
// What bounds it on this card at decode (M <= 8, the serve's batch): the
// plane bytes. The product does 2 M MACs per weight and reads 2 P_live
// plane bytes per weight, far below the H100's ~295 ops/byte ridge, so the
// design is about keeping enough bytes in flight to cover the memory
// latency (tens of KB per SM at 3.35 TB/s). A decode block is 8 warps over 128
// columns (pann_common.cuh): each lane owns 4 adjacent columns and, for a K
// step of 4 rows, issues every live plane's 32-bit loads of both signs (up
// to 56, past L1, one coalesced 128-byte request per warp each) before it
// uses any; the warps take the K steps of the block's chunk in turn, two
// blocks share an SM, so ~100 KB a SM are in flight. The rebuild is SIMD
// within a register, as the tile kernel's: posw = sum_p pos_p << p over the
// live planes (bytes 0/1, p <= 6: no carry crosses a byte), pos - neg per
// byte without borrow (w's int8 two's complement, |w| <= 127), a
// __byte_perm 4 x 4 transpose to K-major words, and one __dp4a (s8 x s8) per
// row of the batch and 4 weights. 'planes' runs the same loads through one
// __dp4a per live plane and sign on pos_p << p and neg_p << p (the Eq.-10
// products, never folded into one weight). The block's sums meet in shared
// memory; with K split across blocks (to fill the card at narrow N) they
// meet in an int32 buffer through atomics and the last block of a column
// tile applies the epilogue, so a matmul is one launch. Dead low planes are
// never loaded. The row panel lives in shared memory, as the TPU kernel
// keeps it in VMEM.
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

  __host__ __device__ size_t plane() const { return (size_t)K * N; }
};

// One K step of 4 rows at 4 columns: word [p][r] holds plane p at row r
// (byte c = column c), 0 where the plane is dead or the row past kend.
struct Step4 {
  uint32_t pos[pann::kMaxPlanes][4], neg[pann::kMaxPlanes][4];
};

__device__ __forceinline__ void load4(const Planes& wts, int k, int kend,
                                      int n0, int lo, Step4& st) {
  const size_t plane = wts.plane();
#pragma unroll
  for (int p = 0; p < pann::kMaxPlanes; ++p)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool live = p >= lo && p < wts.P && k + r < kend;
      const size_t off = p * plane + (size_t)(k + r) * wts.N + n0;
      st.pos[p][r] = live ? pann::ld_stream(wts.pos + off) : 0u;
      st.neg[p][r] = live ? pann::ld_stream(wts.neg + off) : 0u;
    }
}

// -q per byte, modulo 256, without borrow between bytes (any int8 but
// -128): the per-byte subtraction 0 - q of Hacker's Delight, sec. 2-18.
__device__ __forceinline__ int neg_bytes(int q) {
  const uint32_t h = 0x80808080u, u = static_cast<uint32_t>(q);
  return static_cast<int>((h - (u & ~h)) ^ (~u & h));
}

// acc[m][c] += sum_r codes[m][r] w[r][c] over the step's 4 rows; 'planes'
// takes one product per live plane and sign, on the plane bytes times 2^p
// (<= 64, an s8), the negative side through the negated codes.
template <int MT, bool kPlanes>
__device__ __forceinline__ void step_product(const Step4& st, int lo, int P,
                                             const int8_t* codes, int kchunk,
                                             int (&acc)[MT][kCols]) {
  int q[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
    q[m] = *reinterpret_cast<const int*>(codes + m * kchunk);
  if constexpr (kPlanes) {
#pragma unroll
    for (int p = 0; p < pann::kMaxPlanes; ++p) {
      if (p < lo || p >= P) continue;
      uint32_t cp[4], cn[4];
      pann::transpose4(st.pos[p][0] << p, st.pos[p][1] << p,
                       st.pos[p][2] << p, st.pos[p][3] << p, cp);
      pann::transpose4(st.neg[p][0] << p, st.neg[p][1] << p,
                       st.neg[p][2] << p, st.neg[p][3] << p, cn);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int nq = neg_bytes(q[m]);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc[m][c] = __dp4a(q[m], static_cast<int>(cp[c]), acc[m][c]);
          acc[m][c] = __dp4a(nq, static_cast<int>(cn[c]), acc[m][c]);
        }
      }
    }
  } else {
    uint32_t w[4], col[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t pw = 0, nw = 0;
#pragma unroll
      for (int p = 0; p < pann::kMaxPlanes; ++p) {
        pw += st.pos[p][r] << p;
        nw += st.neg[p][r] << p;
      }
      w[r] = pann::sub_bytes(pw, nw);
    }
    pann::transpose4(w[0], w[1], w[2], w[3], col);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        acc[m][c] = __dp4a(q[m], static_cast<int>(col[c]), acc[m][c]);
  }
}

template <int MT, class Src, bool kPlanes>
__global__ void __launch_bounds__(pann::kStreamThreads, 2)
    planes_decode_kernel(Src src, Planes wts, pann::Finish fin, int M, int K,
                         int N, int kchunk) {
  extern __shared__ __align__(16) int8_t decode_smem[];
  int* red = reinterpret_cast<int*>(decode_smem);  // [MT][kStreamCols]
  int8_t* codes = decode_smem + MT * pann::kStreamCols * 4;  // [MT][kchunk]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = src.shift(wts.P);
  const int m0 = blockIdx.z * MT;
  const int k0 = blockIdx.y * kchunk;  // kchunk % 32 == 0
  const int kc = min(kchunk, K - k0);
  const int steps = (kc + 3) / 4;      // the last one may be ragged
  const int n_blk = blockIdx.x * pann::kStreamCols;
  const int n0 = n_blk + kCols * lane;
  const bool col_ok = n0 < N;

  Step4 st;
  if (col_ok && warp < steps) load4(wts, k0 + 4 * warp, k0 + kc, n0, lo, st);
  for (int i = threadIdx.x; i < MT * pann::kStreamCols; i += blockDim.x)
    red[i] = 0;
  pann::load_stream_panel<MT>(src.reader(), codes, M, m0, k0, kc, 4 * steps,
                              kchunk);
  __syncthreads();

  int acc[MT][kCols] = {};
  if (col_ok) {
    for (int s = warp; s < steps; s += pann::kStreamWarps) {
      if (s != warp) load4(wts, k0 + 4 * s, k0 + kc, n0, lo, st);
      step_product<MT, kPlanes>(st, lo, wts.P, codes + 4 * s, kchunk, acc);
    }
  }
  pann::finish_block<MT>(fin, red, acc, M, N, m0, n_blk);
}

template <class Src, bool kPlanes>
int launch_product(Src src, Planes wts, pann::Finish fin, int* partial,
                   int M, int K, int N, int ksplit, int kchunk,
                   cudaStream_t st) {
  if (M <= pann::kDecodeRows) {
    const int mt = M <= 4 ? 4 : 8;
    dim3 grid((N + pann::kStreamCols - 1) / pann::kStreamCols, ksplit,
              (M + mt - 1) / mt);
    const size_t smem = (size_t)mt * (pann::kStreamCols * 4 + kchunk);
    if (mt == 4)
      planes_decode_kernel<4, Src, kPlanes>
          <<<grid, pann::kStreamThreads, smem, st>>>(src, wts, fin, M, K, N,
                                                     kchunk);
    else
      planes_decode_kernel<8, Src, kPlanes>
          <<<grid, pann::kStreamThreads, smem, st>>>(src, wts, fin, M, K, N,
                                                     kchunk);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr auto kMode = kPlanes ? pann::tc::Mode::kPlanes
                                 : pann::tc::Mode::kFused;
  int err = pann::tc::launch<Src, kMode>(src, wts, partial, M, K, N, ksplit,
                                         kchunk, st);
  if (err != 0) return err;
  return pann::finish_tiles(fin, partial, M, N, ksplit, st);
}

template <class Src>
int launch_mode(Src src, Planes wts, pann::Finish fin, int* partial, int M,
                int K, int N, int ksplit, int kchunk, int planes,
                cudaStream_t st) {
  return planes ? launch_product<Src, true>(src, wts, fin, partial, M, K, N,
                                            ksplit, kchunk, st)
                : launch_product<Src, false>(src, wts, fin, partial, M, K, N,
                                             ksplit, kchunk, st);
}

}  // namespace

// The wrappers (repro_torch/kernels/pann_matmul.py) check shapes, dtypes,
// contiguity and N % 4 == 0, and allocate y (M, N). Up to 8 rows they pass
// acc (M x N int32) and tickets (one per column tile of 128), both zero,
// and partial null, with kchunk a multiple of 32; above 8 rows partial
// (ksplit, M, N), acc and tickets null, and kchunk a multiple of 64.
// ``planes`` selects the mode. Each returns cudaGetLastError() after its
// launches.
extern "C" int pann_matmul_act_launch(const float* x, const int8_t* pos,
                                      const int8_t* neg, const float* qp,
                                      const float* gamma, const int* zcol,
                                      float* y, int* partial, int* acc,
                                      int* tickets, int M, int K, int N,
                                      int P, int ksplit, int kchunk,
                                      int planes, void* stream) {
  return launch_mode(pann::FloatRows{x, qp, K}, Planes{pos, neg, K, N, P},
                     pann::Finish{acc, tickets, qp, 0, gamma, zcol, y, ksplit},
                     partial, M, K, N, ksplit, kchunk, planes,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int pann_matmul_launch(const int8_t* xq, const int8_t* pos,
                                  const int8_t* neg, const float* s_x,
                                  const float* gamma, const int* zcol,
                                  float* y, int* partial, int* acc,
                                  int* tickets, int M, int K, int N, int P,
                                  int ksplit, int kchunk, int planes,
                                  void* stream) {
  return launch_mode(pann::CodeRows{xq, K}, Planes{pos, neg, K, N, P},
                     pann::Finish{acc, tickets, s_x, 1, gamma, zcol, y,
                                  ksplit},
                     partial, M, K, N, ksplit, kchunk, planes,
                     static_cast<cudaStream_t>(stream));
}

// The accumulator mode of pann_matmul_act_launch (a row-parallel
// projection's K shard under a mesh, repro_torch/kernels/dispatch.py): the
// same launches, but the finishing step writes the int32 sums (M, N) of
// this shard into `sums` and applies no epilogue, which waits for the sum
// over every shard (the ranks' int32 all-reduce). gamma, zcol and y are not
// read.
extern "C" int pann_matmul_act_acc_launch(const float* x, const int8_t* pos,
                                          const int8_t* neg, const float* qp,
                                          int* sums, int* partial, int* acc,
                                          int* tickets, int M, int K, int N,
                                          int P, int ksplit, int kchunk,
                                          int planes, void* stream) {
  pann::Finish fin{acc, tickets, qp, 0, nullptr, nullptr, nullptr, ksplit};
  fin.sums = sums;
  return launch_mode(pann::FloatRows{x, qp, K}, Planes{pos, neg, K, N, P},
                     fin, partial, M, K, N, ksplit, kchunk, planes,
                     static_cast<cudaStream_t>(stream));
}

// The epilogue as an entry of its own: y = ((sums - zcol) * qp[0]) * gamma
// in the reference's association (__fmul_rn, no contraction), one (M, N)
// int32 sum in, for the accumulator mode's sums after their all-reduce
// (B1 and B2 alike). Elementwise, so it is bound by its bytes: 4 read and 4
// written an output, plus gamma and zcol.
extern "C" int pann_epilogue_launch(const int* sums, const float* qp,
                                    const float* gamma, const int* zcol,
                                    float* y, int M, int N, void* stream) {
  return pann::launch_epilogue(sums, nullptr, qp, 0, gamma, zcol, y, M, N, 1,
                               static_cast<cudaStream_t>(stream));
}
