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
// What bounds it on this card at decode (M <= 8): the plane bytes, 2 P_live
// / 8 per weight against 2 M MACs, and close behind them the integer work
// of turning 14 bits into a weight: at 3.35 TB/s and 1.75 bytes a weight
// the SMs can issue about 8 integer operations a weight. A block of the
// decode kernel is 8 warps over 128 columns (pann_common.cuh); each lane
// owns 4 columns and holds two K steps of 8 rows in registers, the one it
// works on and the next, whose 32-bit loads (past L1, one coalesced
// 128-byte request per warp, plane and sign) are in flight meanwhile; dead
// low planes are never loaded. Three blocks share an SM at 4 rows. Its
// work per step and 4 columns (32 weights), per sign:
//   the 7 plane words w[p] (byte c = column c, bit j = row j) are an 8 x 8
//   bit matrix in each byte lane; three swap stages (a shift and a lop3
//   for each side of a pair) transpose it, so word j holds in byte c the
//   plane bits of (row j, column c): the magnitude, 0..127;
// then pos - neg per byte without borrow (sub_bytes: w's int8 two's
// complement, |w| <= 127), a __byte_perm 4 x 4 transpose to K-major words
// of 4 rows, and one __dp4a (s8 x s8) per row of the batch and 4 weights:
// about 5 integer operations a weight at M = 4, instead of ~32 for a
// shift, mask and subtract per bit. On the H100 the arithmetic is not what
// holds it: with the arithmetic taken out it was hardly faster, and a
// deeper register ring, a cp.async ring in shared memory, 8- or 16-byte
// loads and other load qualifiers were no faster (tried, not kept); more
// warps a SM helped. What is left is the memory system's pace on these
// scattered 128-byte rows and the fixed cost of a launch: chip_smoke.py's
// [decode] lines put each shape beside a torch.sum over the same bytes
// (stream_ms). The block's sums meet in shared memory; with K split across
// blocks they meet in an int32 buffer through atomics and the last block
// of a column tile applies the epilogue, so a matmul is one launch.
//
// Above 8 rows (a prefill chunk) the product runs on the int8 tensor cores:
// pann_tc.cuh's tile kernel in mode kPacked. A copy warp streams the codes
// (or x) and, per live plane and sign, a TMA box of 8 packed rows x 128
// columns (64 K rows, 1 KB) into a ring deep enough for many K steps; the
// worker warpgroups rebuild the s8 weight tile with the same bit transpose,
// sub_bytes and byte transposes as the decode kernel, store it K-major and
// run one wgmma.m64n128k32.s32.s8.s8 product per 32 k, then the shared
// epilogue kernel applies the scales. Its plane bytes are 2P/8 a weight,
// against 2P for the unpacked planes.
#include "pann_common.cuh"
#include "pann_tc.cuh"

namespace {

using pann::kCols;

// One K step of 8 rows at a lane's 4 columns: the live plane words of each
// sign (byte c = column c, bit j = row j).
struct Step8 {
  uint32_t pos[pann::kMaxPlanes], neg[pann::kMaxPlanes];
};

struct PackedPlanes {  // (P, K/8, N) uint8
  const uint8_t* pos;
  const uint8_t* neg;
  int K, N, P;

  // The plane words of rows 8 k8 .. 8 k8 + 7 at columns n0 .. n0 + 3;
  // planes p < lo and p >= P are 0, unread.
  __device__ __forceinline__ void load8(int k8, int n0, int lo,
                                        Step8& st) const {
    const size_t plane = (size_t)(K / 8) * N;
    const size_t off = (size_t)k8 * N + n0;
#pragma unroll
    for (int p = 0; p < pann::kMaxPlanes; ++p) {
      const bool live = p >= lo && p < P;
      st.pos[p] = live ? pann::ld_stream(pos + p * plane + off) : 0u;
      st.neg[p] = live ? pann::ld_stream(neg + p * plane + off) : 0u;
    }
  }
};

// The magnitudes of one sign: word j, byte c = sum_p 2^p bit (row j,
// column c) of plane p.
__device__ __forceinline__ void magnitudes(
    const uint32_t (&planes)[pann::kMaxPlanes], uint32_t (&w)[8]) {
#pragma unroll
  for (int p = 0; p < pann::kMaxPlanes; ++p) w[p] = planes[p];
  w[7] = 0;
  pann::transpose_bits(w);
}

// acc[m][c] += sum_j codes[m][j] w[j][c] over the step's 8 rows.
template <int MT>
__device__ __forceinline__ void step_product(const Step8& st,
                                             const int8_t* codes, int kchunk,
                                             int (&acc)[MT][kCols]) {
  uint32_t wp[8], wn[8], d[8], lo[4], hi[4];
  magnitudes(st.pos, wp);
  magnitudes(st.neg, wn);
#pragma unroll
  for (int j = 0; j < 8; ++j) d[j] = pann::sub_bytes(wp[j], wn[j]);
  pann::transpose4(d[0], d[1], d[2], d[3], lo);
  pann::transpose4(d[4], d[5], d[6], d[7], hi);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int2 q = *reinterpret_cast<const int2*>(codes + m * kchunk);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      acc[m][c] = __dp4a(q.x, static_cast<int>(lo[c]), acc[m][c]);
      acc[m][c] = __dp4a(q.y, static_cast<int>(hi[c]), acc[m][c]);
    }
  }
}

// K steps a lane holds in registers: the one it works on and the next,
// whose loads are in flight meanwhile. Deeper rings (3-12 steps, in
// registers or in shared memory through cp.async) measured no faster on
// the H100; more warps a SM did (PERF.md).
constexpr int kDepth = 2;

// Blocks a SM: 3 at 4 rows (<= 85 registers a thread), 2 at 8.
template <int MT>
constexpr int min_blocks() {
  return MT == 4 ? 3 : 2;
}

template <int MT, class Src>
__global__ void __launch_bounds__(pann::kStreamThreads, min_blocks<MT>())
    packed_decode_kernel(Src src, PackedPlanes wts, pann::Finish fin, int M,
                         int K, int N, int kchunk) {
  extern __shared__ __align__(16) int8_t decode_smem[];
  int* red = reinterpret_cast<int*>(decode_smem);  // [MT][kStreamCols]
  int8_t* codes = decode_smem + MT * pann::kStreamCols * 4;  // [MT][kchunk]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = src.shift(wts.P);
  const int m0 = blockIdx.z * MT;
  const int k0 = blockIdx.y * kchunk;  // kchunk % 64 == 0, K % 8 == 0
  const int kc = min(kchunk, K - k0);
  const int steps = kc / 8;
  const int n_blk = blockIdx.x * pann::kStreamCols;
  const int n0 = n_blk + kCols * lane;
  const bool col_ok = n0 < N;
  constexpr int kStride = pann::kStreamWarps;

  // the first steps' loads go out before the panel, which they do not need
  Step8 ring[kDepth];
#pragma unroll
  for (int d = 0; d + 1 < kDepth; ++d) {
    const int s = warp + d * kStride;
    if (col_ok && s < steps) wts.load8(k0 / 8 + s, n0, lo, ring[d]);
  }
  for (int i = threadIdx.x; i < MT * pann::kStreamCols; i += blockDim.x)
    red[i] = 0;
  pann::load_stream_panel<MT>(src.reader(), codes, M, m0, k0, kc, kc,
                              kchunk);
  __syncthreads();

  int acc[MT][kCols] = {};
  for (int s = warp; s < steps; s += kDepth * kStride) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int cur = s + d * kStride;
      const int ahead = cur + (kDepth - 1) * kStride;
      if (col_ok && ahead < steps)
        wts.load8(k0 / 8 + ahead, n0, lo, ring[(d + kDepth - 1) % kDepth]);
      if (col_ok && cur < steps)
        step_product<MT>(ring[d], codes + 8 * cur, kchunk, acc);
    }
  }
  pann::finish_block<MT>(fin, red, acc, M, N, m0, n_blk);
}

template <class Src>
int launch_product(Src src, PackedPlanes wts, pann::Finish fin, int* partial,
                   int M, int K, int N, int ksplit, int kchunk,
                   cudaStream_t st) {
  if (M <= pann::kDecodeRows) {
    const int mt = M <= 4 ? 4 : 8;
    dim3 grid((N + pann::kStreamCols - 1) / pann::kStreamCols, ksplit,
              (M + mt - 1) / mt);
    const size_t smem = (size_t)mt * (pann::kStreamCols * 4 + kchunk);
    if (mt == 4)
      packed_decode_kernel<4, Src><<<grid, pann::kStreamThreads, smem, st>>>(
          src, wts, fin, M, K, N, kchunk);
    else
      packed_decode_kernel<8, Src><<<grid, pann::kStreamThreads, smem, st>>>(
          src, wts, fin, M, K, N, kchunk);
    return static_cast<int>(cudaGetLastError());
  }
  int err = pann::tc::launch<Src, pann::tc::Mode::kPacked>(
      src, wts, partial, M, K, N, ksplit, kchunk, st);
  if (err != 0) return err;
  return pann::finish_tiles(fin, partial, M, N, ksplit, st);
}

}  // namespace

// The wrappers (repro_torch/kernels/pann_matmul_packed.py) check shapes,
// dtypes, contiguity, K % 8 == 0 and N % 4 == 0, and allocate y (M, N).
// Up to 8 rows they pass acc (M x N int32) and tickets (one per column tile
// of 128), both zero, and partial null, with kchunk a multiple of 64; above
// 8 rows partial (ksplit, M, N), acc and tickets null, and kchunk a
// multiple of 64. Each returns cudaGetLastError() after its launches.
extern "C" int pann_matmul_packed_act_launch(
    const float* x, const uint8_t* pos, const uint8_t* neg, const float* qp,
    const float* gamma, const int* zcol, float* y, int* partial, int* acc,
    int* tickets, int M, int K, int N, int P, int ksplit, int kchunk,
    void* stream) {
  return launch_product(
      pann::FloatRows{x, qp, K}, PackedPlanes{pos, neg, K, N, P},
      pann::Finish{acc, tickets, qp, 0, gamma, zcol, y, ksplit}, partial, M,
      K, N, ksplit, kchunk, static_cast<cudaStream_t>(stream));
}

extern "C" int pann_matmul_packed_launch(
    const int8_t* xq, const uint8_t* pos, const uint8_t* neg,
    const float* s_x, const float* gamma, const int* zcol, float* y,
    int* partial, int* acc, int* tickets, int M, int K, int N, int P,
    int ksplit, int kchunk, void* stream) {
  return launch_product(
      pann::CodeRows{xq, K}, PackedPlanes{pos, neg, K, N, P},
      pann::Finish{acc, tickets, s_x, 1, gamma, zcol, y, ksplit}, partial, M,
      K, N, ksplit, kchunk, static_cast<cudaStream_t>(stream));
}

// The accumulator mode of pann_matmul_packed_act_launch (a row-parallel
// projection's K shard under a mesh): the int32 sums (M, N) of this shard
// into `sums`, no epilogue; the epilogue entry (pann_matmul.cu) runs after
// the ranks' all-reduce.
extern "C" int pann_matmul_packed_act_acc_launch(
    const float* x, const uint8_t* pos, const uint8_t* neg, const float* qp,
    int* sums, int* partial, int* acc, int* tickets, int M, int K, int N,
    int P, int ksplit, int kchunk, void* stream) {
  pann::Finish fin{acc, tickets, qp, 0, nullptr, nullptr, nullptr, ksplit};
  fin.sums = sums;
  return launch_product(pann::FloatRows{x, qp, K},
                        PackedPlanes{pos, neg, K, N, P}, fin, partial, M, K,
                        N, ksplit, kchunk, static_cast<cudaStream_t>(stream));
}
