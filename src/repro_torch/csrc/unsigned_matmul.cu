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
// At decode (M <= 8) the weight bytes bound it: one byte a weight against
// 2 M MACs. The kernel is the third weight source of pann_common.cuh's
// streaming decode block (B1/B4's unpacked planes and B2/B5's packed planes
// are the other two): 8 warps over 128 columns, lane l owning columns
// n_blk + 4l .. + 3, the warps taking the K steps of 4 rows of the block's
// chunk in turn; decode_split (kernels/pann_matmul.py) sizes the grid so
// the blocks fill the card's slots once, splitting K where the column tiles
// alone do not. A K step is four 32-bit ld_stream loads a lane (rows k ..
// k + 3 at its 4 columns; a warp reads four coalesced 128-byte rows), 512
// bytes a warp.
//
// Depth and occupancy. A lane holds two K steps in registers, the one it
// works on and the next, whose loads are in flight meanwhile (B2's ring).
// Deeper rings (3 to 16 steps, up to 7 steps ahead: 57 KB a SM in flight
// at 2 blocks a SM) were no faster on the H100; more warps a SM were, at
// 3 blocks a SM and more at 4 (tried, not kept). So the 4-row kernel keeps
// to 64 registers a thread (16 accumulators a side) and 4 blocks (32
// warps) share a SM; the 8-row kernel's 64 accumulators allow 2.
//
// Rebuild, per step and lane (16 weights): a __byte_perm 4 x 4 transpose
// (pann::transpose4) turns the 4 row words into 4 K-major words of signed
// bytes, one a column; split_word (pann_tc.cuh) gives each word's W+ and W-
// bytes, |w| where w >= 0 and where w < 0; then two __dp4a a batch row and
// column, u8 x u8 (codes and magnitudes are all in [0, 127], where the u8
// and s8 forms read the same values), into acc_pos and acc_neg: 6 + 20 +
// 2 x 4 MT integer operations a step, ~3.6 a weight at M = 4, against the
// ~10 a weight of a byte split and scalar multiply-adds. Each lane
// subtracts once (acc_pos - acc_neg, the one subtraction of Eq. 6; both
// sums are exact in int32, |x_q| |w| K <= 127^2 K < 2^31). The code panel
// (the block's rows of x_q over its K chunk) enters shared memory as
// 16-byte loads where every row is 16-byte aligned (K % 16 == 0), as bytes
// otherwise. pann::finish_block adds the lanes' sums in shared memory and,
// with K split, the blocks' through an int32 buffer and a ticket a column
// tile, and writes y = (sum * s_x[m]) * s_w[n] with __fmul_rn, the plain
// version's association: one launch, no partial buffer.
//
// Above 8 rows the product runs on the int8 tensor cores: pann_tc.cuh's
// tile kernel in mode kSplit. Its copy warp streams the codes and one TMA
// box of the weight (64 rows x 128 columns) a K step; the workers split
// each 32-bit word into W+ and W- bytes, store both as K-major tiles and
// each warpgroup issues two wgmma a 32-k step, into acc_pos and acc_neg;
// the kernel subtracts once before it writes its split's sums, and the
// epilogue kernel adds the splits and scales. Two products a weight,
// against one for torch._int_mm on the same bytes.
#include "pann_common.cuh"
#include "pann_tc.cuh"

namespace {

using pann::kCols;

struct SignedWeight {  // (K, N) int8 in [-127, 127]
  const int8_t* w;
  int K;
};

constexpr int kDepth = 2;  // K steps a lane holds in registers

// Blocks a SM: 4 at 4 rows (<= 64 registers a thread), 2 at 8.
template <int MT>
constexpr int min_blocks() {
  return MT == 4 ? 4 : 2;
}

// The words of rows k .. k + 3 at columns n0 .. n0 + 3 (byte c = column c),
// 0 at rows past kend.
__device__ __forceinline__ void load_step(const int8_t* w, int N, int k,
                                          int kend, int n0,
                                          uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = k + i < kend ? pann::ld_stream(w + (size_t)(k + i) * N + n0) : 0u;
}

// acc_pos[m][c] += sum_i codes[m][i] W+[i][c], acc_neg likewise with W-,
// over the step's 4 rows.
template <int MT>
__device__ __forceinline__ void step_product(const uint32_t (&r)[4],
                                             const int8_t* codes, int kchunk,
                                             unsigned (&acc_pos)[MT][kCols],
                                             unsigned (&acc_neg)[MT][kCols]) {
  uint32_t col[4], pos[4], neg[4];
  pann::transpose4(r[0], r[1], r[2], r[3], col);
#pragma unroll
  for (int c = 0; c < kCols; ++c) pann::tc::split_word(col[c], pos[c], neg[c]);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const unsigned q = *reinterpret_cast<const unsigned*>(codes + m * kchunk);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      acc_pos[m][c] = __dp4a(q, pos[c], acc_pos[m][c]);
      acc_neg[m][c] = __dp4a(q, neg[c], acc_neg[m][c]);
    }
  }
}

// Rows [m0, m0 + MT) x columns [k0, k0 + kw) of the codes into the block's
// shared panel codes[MT][kchunk]; 0 past M and past kc. With every row
// 16-byte aligned (K % 16 == 0, so kc and kw are multiples of 16 too) in
// 16-byte pieces, else a byte at a time.
template <int MT>
__device__ __forceinline__ void load_code_panel(const int8_t* xq, int K,
                                                int8_t* codes, int M, int m0,
                                                int k0, int kc, int kw,
                                                int kchunk) {
  if (K % 16 != 0 || reinterpret_cast<uintptr_t>(xq) % 16 != 0) {
    pann::load_stream_panel<MT>(pann::CodeRows{xq, K}, codes, M, m0, k0, kc,
                                kw, kchunk);
    return;
  }
  const int pieces = kw / 16;
  for (int i = threadIdx.x; i < MT * pieces; i += blockDim.x) {
    const int mm = i / pieces, j = 16 * (i - mm * pieces);
    const int m = m0 + mm;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m < M && j < kc)
      v = *reinterpret_cast<const uint4*>(xq + (size_t)m * K + k0 + j);
    *reinterpret_cast<uint4*>(codes + mm * kchunk + j) = v;
  }
}

template <int MT>
__global__ void __launch_bounds__(pann::kStreamThreads, min_blocks<MT>())
    signed_decode_kernel(const int8_t* __restrict__ xq,
                         const int8_t* __restrict__ w, pann::Finish fin,
                         int M, int K, int N, int kchunk) {
  extern __shared__ __align__(16) int8_t decode_smem[];
  int* red = reinterpret_cast<int*>(decode_smem);  // [MT][kStreamCols]
  int8_t* codes = decode_smem + MT * pann::kStreamCols * 4;  // [MT][kchunk]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.z * MT;
  const int k0 = blockIdx.y * kchunk;  // kchunk % 32 == 0
  const int kc = min(kchunk, K - k0);
  const int kend = k0 + kc;
  const int steps = (kc + 3) / 4;      // the last one may be ragged
  const int n_blk = blockIdx.x * pann::kStreamCols;
  const int n0 = n_blk + kCols * lane;
  const bool col_ok = n0 < N;
  constexpr int kStride = pann::kStreamWarps;

  // the first step's loads go out before the panel
  uint32_t ring[kDepth][4];
#pragma unroll
  for (int d = 0; d + 1 < kDepth; ++d) {
    const int s = warp + d * kStride;
    if (col_ok && s < steps) load_step(w, N, k0 + 4 * s, kend, n0, ring[d]);
  }
  for (int i = threadIdx.x; i < MT * pann::kStreamCols; i += blockDim.x)
    red[i] = 0;
  load_code_panel<MT>(xq, K, codes, M, m0, k0, kc, 4 * steps, kchunk);
  __syncthreads();

  unsigned acc_pos[MT][kCols] = {}, acc_neg[MT][kCols] = {};
  if (col_ok) {
    for (int s = warp; s < steps; s += kDepth * kStride) {
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const int cur = s + d * kStride;
        const int ahead = cur + (kDepth - 1) * kStride;
        if (ahead < steps)
          load_step(w, N, k0 + 4 * ahead, kend, n0,
                    ring[(d + kDepth - 1) % kDepth]);
        if (cur < steps)
          step_product<MT>(ring[d], codes + 4 * cur, kchunk, acc_pos,
                           acc_neg);
      }
    }
  }
  int acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c)  // the one Eq.-6 subtraction
      acc[m][c] = static_cast<int>(acc_pos[m][c] - acc_neg[m][c]);
  pann::finish_block<MT>(fin, red, acc, M, N, m0, n_blk);
}

}  // namespace

// The wrapper (repro_torch/kernels/unsigned_matmul.py) checks shapes,
// dtypes, contiguity and N % 4 == 0, and allocates y (M, N). Up to 8 rows
// it passes acc (M x N int32) and tickets (one per column tile of 128),
// both zero, and partial null, with kchunk a multiple of 32; above 8 rows
// partial (ksplit, M, N), the tile kernel's differences, acc and tickets
// null, and kchunk a multiple of 64. Returns cudaGetLastError() after the
// launches.
extern "C" int unsigned_matmul_launch(const int8_t* xq, const int8_t* w,
                                      const float* s_x, const float* s_w,
                                      float* y, int* partial, int* acc,
                                      int* tickets, int M, int K, int N,
                                      int ksplit, int kchunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > pann::kDecodeRows) {
    int err = pann::tc::launch<pann::CodeRows, pann::tc::Mode::kSplit>(
        pann::CodeRows{xq, K}, SignedWeight{w, K}, partial, M, K, N,
        ksplit, kchunk, st);
    if (err != 0) return err;
    return pann::launch_epilogue(partial, nullptr, s_x, 1, s_w, nullptr, y,
                                 M, N, ksplit, st);
  }
  const pann::Finish fin{acc, tickets, s_x, 1, s_w, nullptr, y, ksplit};
  const int mt = M <= 4 ? 4 : 8;
  dim3 grid((N + pann::kStreamCols - 1) / pann::kStreamCols, ksplit, 1);
  const size_t smem = (size_t)mt * (pann::kStreamCols * 4 + kchunk);
  if (mt == 4)
    signed_decode_kernel<4><<<grid, pann::kStreamThreads, smem, st>>>(
        xq, w, fin, M, K, N, kchunk);
  else
    signed_decode_kernel<8><<<grid, pann::kStreamThreads, smem, st>>>(
        xq, w, fin, M, K, N, kchunk);
  return static_cast<int>(cudaGetLastError());
}
