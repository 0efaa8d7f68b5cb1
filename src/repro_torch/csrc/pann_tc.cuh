// The tensor-core tile kernel of the integer matmuls above kDecodeRows rows,
// for Hopper (sm_90a). One kernel, four weight sources (Mode):
//
//   kFused, kPlanes  unpacked planes (P, K, N) int8 in {0, 1}: B1
//                    pann_matmul_act and B4 pann_matmul (pann_matmul.cu),
//                    modes 'fused' and 'planes';
//   kPacked          planes packed 8 rows a byte along K, (P, K/8, N) uint8:
//                    B2 pann_matmul_packed_act and B5 pann_matmul_packed
//                    (pann_matmul_packed.cu);
//   kSplit           the signed int8 weight (K, N) of B6 unsigned_matmul
//                    (unsigned_matmul.cu), split into W+ and W- here.
//
// A block computes a kBM x kBN = 128 x 128 tile of exact int32 partial sums
// over one K split, stepping K by kK (32 'planes', 64 otherwise), in two
// roles:
//
//   a copy warp streams everything the block reads with TMA: for each K
//       step the codes (int8 x_q, or fp32 x for B1/B2) into one of two code
//       slots, then the step's weight units into a ring of slots, as many as
//       shared memory holds (up to kMaxRaw). A unit is, for each live plane,
//       one box of pos_p and one of neg_p (kK rows x 128 columns unpacked,
//       kK / 8 packed rows x 128 columns packed), or one box of the int8
//       weight (kK rows x 128 columns). A full and an empty mbarrier guard
//       every slot. Rows or columns that TMA cannot address (a row stride
//       that is no multiple of 16 bytes) the warp's lanes load themselves;
//   two worker warpgroups (256 threads), every K step,
//     1. build the step's stage: the code tile (128 x kK int8; B1/B2 encode
//        x here, once per block and K step) and the weight tile(s), K-major
//        in wgmma's no-swizzle canonical layout (8 x 16-byte core matrices);
//     2. meet at a named barrier, and each warpgroup issues
//        wgmma.m64n128k32.s32.s8.s8 on its 64 rows of the stage, s32
//        accumulators in registers (no .satfinite: the sums wrap exactly as
//        the plain version's int32 do, and cannot overflow: |q| <= 127,
//        |w| <= 127, K < 2^31 / 127^2 = 133,144).
// The product runs asynchronously while the workers build the next stage in
// the other of two stage buffers; a warpgroup retires its product before the
// barrier of the next step, so a buffer is rewritten only after both
// warpgroups have read it.
//
// The weight rebuild is SIMD within a register, one 32-bit word of 4
// weights at a time; dead planes (p < shift, B1/B2's plane_shift) are never
// loaded, and with every plane dead the block writes zeros.
//   kFused: a worker holds 8 columns x 4 rows of each plane, one 8-byte
//     piece a row and side, and forms posw = OR_{p >= shift} (pos_p << p),
//     negw likewise, w = __vsub4(posw, negw) (each byte is 0/1 and p <= 6,
//     so no bit crosses a byte; the per-byte difference is the int8 two's
//     complement of w since |w| <= 127): about one operation per weight and
//     live plane. A 4 x 4 byte transpose (__byte_perm) turns 4 rows x 4
//     columns into 4 K-major words before the store.
//   kPlanes keeps the literal Eq.-10 dataflow: for each live plane p the
//     workers write the pos_p and neg_p tiles pre-scaled by 2^p (<= 64, so
//     the 0/1 bytes shifted by p still fit s8), each warpgroup issues one
//     wgmma per side into acc_pos and acc_neg, and acc = acc_pos - acc_neg
//     once at the end: 2 * P_live products per K step, never folded.
//   kPacked: a worker holds one packed row (8 K rows) x 4 columns, one
//     32-bit word a live plane and side (a warp reads a whole 128-byte
//     row). The 8 plane words of a side are an 8 x 8 bit matrix in each
//     byte lane; three swap stages (pann::transpose_bits) turn them into
//     the magnitudes of rows 0..7, pos - neg per byte without borrow
//     (pann::sub_bytes), two 4 x 4 byte transposes into 8 K-major bytes a
//     column, one 8-byte store each. One product, as 'fused': the JAX
//     kernel folds the planes before its dot.
//   kSplit keeps Eq. 6's two unsigned products: a worker holds 8 columns x
//     4 rows of the int8 weight and splits each word into W+ and W- bytes
//     (split_word), each warpgroup issues one wgmma on the W+ tile into
//     acc_pos and one on the W- tile into acc_neg, and acc = acc_pos -
//     acc_neg once at the end (the one subtraction of Eq. 6; int32 sums of
//     these sizes are exact, so doing it before the split-K sum gives the
//     same bits as after it). Every operand is in [0, 127], where .s8 and
//     .u8 read the same bits as the same values: the products run as
//     .s8.s8, the instruction of every other mode, at the same rate.
//
// What bounds it at M = 512 (phase 6 of chip_smoke.py): 'fused' reads 2P
// plane bytes per weight for 2M MACs, so it is bound by bytes; the grid puts
// the row tiles of one column panel next to each other (blockIdx.x over M
// tiles), so each weight byte comes from device memory once per panel and
// from L2 for the other row tiles. 'planes' does 2 P_live products and
// 'split' 2, bound by tensor-core operations; 'packed' reads 2P/8 bytes a
// weight. What holds them back on the card is the workers' own work per
// step (the rebuild and its shared-memory traffic: every weight byte is
// written by TMA, read once and stored transposed), not waiting on the ring;
// B1/B2 pay about 1.8 ms a pass more than B4/B5 for their fp32 rows, which
// every column panel reads and encodes again (PERF.md). Split-K (grid.z)
// fills the card at narrow N; the partials go to pann::epilogue_kernel
// unchanged.
#pragma once
#include <cuda.h>
#include <cudaTypedefs.h>

#include "pann_common.cuh"

namespace pann {
namespace tc {

constexpr int kBM = 128, kBN = 128;   // output tile of a block
constexpr int kWorkers = 256;         // two warpgroups: 64 rows each
constexpr int kThreads = kWorkers + 32;  // and the copy warp
constexpr int kMaxPlanes = 7;
constexpr int kCodeSlots = 2;         // code slots of the row source
constexpr int kSmemMax = 232448;      // dynamic shared memory of a block

// The weight source of a launch, and how its tile is built (header).
enum class Mode { kFused, kPlanes, kPacked, kSplit };

// kElem: bytes a value of the row source (1: int8 codes, 4: fp32 x).
template <Mode kMode, int kElem>
struct Cfg {
  static constexpr int kK = kMode == Mode::kPlanes ? 32 : 64;  // K step
  static constexpr int kSbo = 8 * kK;           // bytes between 8-row groups
  // rows of a weight box: packed rows hold 8 K rows each
  static constexpr int kBoxRows = kMode == Mode::kPacked ? kK / 8 : kK;
  static constexpr int kSides = kMode == Mode::kSplit ? 1 : 2;  // boxes a unit
  static constexpr int kUnitBytes = kSides * kBoxRows * kBN;
  static constexpr int kCodeBytes = kBM * kK * kElem;  // a code slot
  // ring slots, at most: a packed unit is 8x smaller, so its ring holds
  // more K steps
  static constexpr int kMaxRaw = kMode == Mode::kPacked ? 64 : 16;
  // weight tiles of a stage for P planes
  __host__ __device__ static constexpr int tiles(int P) {
    return kMode == Mode::kPlanes ? 2 * P : kMode == Mode::kSplit ? 2 : 1;
  }
  // shared memory but the ring for P planes: two stage buffers and the code
  // slots with their barriers
  __host__ __device__ static constexpr int fixed(int P) {
    return 2 * kK * (kBM + tiles(P) * kBN) + kCodeSlots * (kCodeBytes + 16);
  }
  // the ring takes what is left (a slot and its two barriers each)
  __host__ __device__ static constexpr int slots(int P) {
    return (kSmemMax - fixed(P)) / (kUnitBytes + 16) < kMaxRaw
               ? (kSmemMax - fixed(P)) / (kUnitBytes + 16)
               : kMaxRaw;
  }
  __host__ __device__ static constexpr int smem(int P) {
    return fixed(P) + slots(P) * (kUnitBytes + 16);
  }
};

// Planes of the weight source: P, or 1 for the split weight (one unit a K
// step, never shifted).
template <Mode kMode, class W>
__host__ __device__ __forceinline__ int planes_of(const W& wts) {
  if constexpr (kMode == Mode::kSplit) {
    return 1;
  } else {
    return wts.P;
  }
}

// Byte (r, k) of a rows x kK K-major tile: core matrices of 8 rows x 16 k,
// K-neighbours 128 B apart (the descriptor's LBO), 8-row groups 8 * kK B
// apart (its SBO).
template <int kK>
__device__ __forceinline__ int tile_off(int r, int k) {
  return ((r >> 3) * (kK / 16) + (k >> 4)) * 128 + (r & 7) * 16 + (k & 15);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, no swizzle: start >> 4, LBO 128 B, SBO.
__device__ __forceinline__ uint64_t desc(const void* p, int sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128 s32) += A (64 x 32 s8) B (32 x 128 s8), both K-major in
// shared memory. Register d[4j + 2i + c] holds row 16 * warp + lane / 4 +
// 8i, column 8j + 2 (lane % 4) + c of the warpgroup's 64 x 128 tile.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// mbarriers of the ring: one full and one empty per slot.
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the (kBN x rows x 1) box of a (N, rows, P) plane tensor at (n, r, p)
// into shared memory, completing on barrier b; out-of-range rows and
// columns are zero-filled.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int n, int r, int p, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(n), "r"(r), "r"(p),
      "r"(smem_u32(b))
      : "memory");
}

// TMA: the box of a 2-D tensor at (c0, c1) (c0 innermost) into shared
// memory, completing on barrier b; out-of-range elements are zero-filled.
__device__ __forceinline__ void tma_box2(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(b))
      : "memory");
}

// The code slots: rows m0.. x columns kb.. of the row source as the copy
// warp lands them. x_q: one box [128 rows][kK bytes]. x (fp32): kK / 32
// boxes [128 rows][32 floats], 128-byte swizzled (16-byte chunk j of row r
// at j ^ (r % 8)), so that 8 workers on 8 rows read 8 distinct banks.
template <class Src>
struct RowBox;
template <>
struct RowBox<CodeRows> {
  static constexpr int kElem = 1;  // bytes a value
};
template <>
struct RowBox<FloatRows> {
  static constexpr int kElem = 4;
};

// Byte offset of value (r, c) in a code slot.
template <class Src, int kK>
__device__ __forceinline__ int code_off(int r, int c) {
  if constexpr (RowBox<Src>::kElem == 4) {
    const int box = c >> 5, j = (c & 31) >> 2;
    return ((box * kBM + r) * 8 + (j ^ (r & 7))) * 16 + (c & 3) * 4;
  } else {
    return r * kK + c;
  }
}

// The copy warp's lanes fill a code slot without TMA (rows not 16-byte
// aligned): the same layout, 0 past M and K.
template <int kK>
__device__ __forceinline__ void fill_codes(const CodeRows& src, uint8_t* dst,
                                           int M, int m0, int kb, int lane) {
  for (int i = lane; i < kBM * kK; i += 32) {
    const int r = i / kK, c = i % kK, m = m0 + r, k = kb + c;
    dst[code_off<CodeRows, kK>(r, c)] =
        m < M && k < src.K ? static_cast<uint8_t>(src.xq[(size_t)m * src.K + k])
                           : 0;
  }
}

template <int kK>
__device__ __forceinline__ void fill_codes(const FloatRows& src, uint8_t* dst,
                                           int M, int m0, int kb, int lane) {
  for (int i = lane; i < kBM * kK; i += 32) {
    const int r = i / kK, c = i % kK, m = m0 + r, k = kb + c;
    *reinterpret_cast<float*>(dst + code_off<FloatRows, kK>(r, c)) =
        m < M && k < src.K ? src.x[(size_t)m * src.K + k] : 0.0f;
  }
}

// rint(x / s) as pann::encode computes it, with one IEEE division per K
// step instead of one per code: y = x * r, r = 1 / s rounded once, is
// within 1.5 * 2^-23 |y| of x / s (two roundings), so rint(y) ==
// rint(x / s) unless a half-integer lies within that distance of y. Such
// near-ties (within 2^-21 |y|) and non-finite y are flagged; the caller
// recomputes them with the IEEE division.
__device__ __forceinline__ float rint_quot(float x, float r, bool& tie) {
  const float y = __fmul_rn(x, r);
  const float q = rintf(y);
  const float gap = fabsf(fabsf(__fsub_rn(y, q)) - 0.5f);
  tie |= !(gap > __fmul_rn(fabsf(y), 0x1p-21f));
  return q;
}

__device__ __noinline__ float rint_div(float x, float s) {
  return rintf(x / s);  // out of line: only near-ties reach the division
}

// The workers' code tile from a code slot. x_q: worker t copies row t / 2,
// chunks (t % 2) kK / 32 + i of 16 codes (zero-filled past M and K). x:
// worker t encodes row t % 128, columns (t / 128) kK / 2.. (kK / 2 of
// them), 0 past M and kend.
template <int kK>
__device__ __forceinline__ void finish_codes(const CodeRows&,
                                             const uint8_t* slot, uint8_t* a,
                                             int, int, int, int, int t) {
#pragma unroll
  for (int i = 0; i < kK / 32; ++i) {
    const int r = t >> 1, c = 16 * ((t & 1) * (kK / 32) + i);
    *reinterpret_cast<uint4*>(a + tile_off<kK>(r, c)) =
        *reinterpret_cast<const uint4*>(slot + code_off<CodeRows, kK>(r, c));
  }
}

template <int kK>
__device__ __forceinline__ void finish_codes(const FloatRows::Reader& rd,
                                             const uint8_t* slot, uint8_t* a,
                                             int M, int m0, int kb, int kend,
                                             int t) {
  const int r = t & 127, f0 = (t >> 7) * (kK / 2);
  const float inv = 1.0f / rd.s;
#pragma unroll
  for (int i = 0; i < kK / 32; ++i) {
    const int f = f0 + 16 * i;
    float v[16], q[16];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v4 = *reinterpret_cast<const float4*>(
          slot + code_off<FloatRows, kK>(r, f + 4 * j));
      v[4 * j] = v4.x; v[4 * j + 1] = v4.y;
      v[4 * j + 2] = v4.z; v[4 * j + 3] = v4.w;
    }
    bool tie = false;  // 16 independent chains, one rare branch
#pragma unroll
    for (int e = 0; e < 16; ++e) q[e] = rint_quot(v[e], inv, tie);
    if (tie) {
#pragma unroll
      for (int e = 0; e < 16; ++e) q[e] = rint_div(v[e], rd.s);
    }
    // codes past M and kend are 0, not z
    const int valid = m0 + r < M ? kend - (kb + f) : 0;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float c = fminf(fmaxf(q[e] + rd.z, 0.0f), rd.n);
      const uint32_t b = static_cast<uint32_t>(static_cast<int>(c)) & 0xFFu;
      w[e >> 2] |= (e < valid ? b : 0u) << (8 * (e & 3));
    }
    *reinterpret_cast<uint4*>(a + tile_off<kK>(r, f)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The copy warp's lanes fill rows [row0, row0 + rows) x columns n_blk.. of
// a (row_end, N) byte matrix into dst[rows][kBN] without TMA (N % 16 != 0),
// 4 bytes a load, 0 past row_end and N.
__device__ __forceinline__ void fill_rows(uint8_t* dst, const uint8_t* src,
                                          int rows, int row0, int row_end,
                                          int n_blk, int N, int lane) {
  for (int i = lane; i < rows * (kBN / 4); i += 32) {
    const int r = i / (kBN / 4), c = i % (kBN / 4);
    const int k = row0 + r, n = n_blk + 4 * c;
    uint32_t v = 0u;
    if (k < row_end && n < N)
      v = *reinterpret_cast<const uint32_t*>(src + (size_t)k * N + n);
    *reinterpret_cast<uint32_t*>(dst + r * kBN + 4 * c) = v;
  }
}

// One unit of the ring without TMA: the TMA boxes' [side][box rows][kBN]
// layout, for plane p and the K step at kb.
template <class C, Mode kMode, class W>
__device__ __forceinline__ void fill_unit(const W& wts, uint8_t* dst, int p,
                                          int kb, int n_blk, int N,
                                          int lane) {
  if constexpr (kMode == Mode::kSplit) {
    fill_rows(dst, reinterpret_cast<const uint8_t*>(wts.w), C::kBoxRows, kb,
              wts.K, n_blk, N, lane);
  } else {
    const int rows = kMode == Mode::kPacked ? wts.K / 8 : wts.K;
    const int row0 = kMode == Mode::kPacked ? kb / 8 : kb;
    const size_t plane = (size_t)p * rows * N;
    fill_rows(dst, reinterpret_cast<const uint8_t*>(wts.pos) + plane,
              C::kBoxRows, row0, rows, n_blk, N, lane);
    fill_rows(dst + C::kBoxRows * kBN,
              reinterpret_cast<const uint8_t*>(wts.neg) + plane, C::kBoxRows,
              row0, rows, n_blk, N, lane);
  }
}

// Worker t reads rows 4kq + i (i < 4) x columns 8nb.. (8 bytes a row) of a
// unit: 'fused' and 'split' (kK 64) kq = t / 16 (and both sides for
// 'fused'), 'planes' (kK 32) kq = t / 16 % 8 and side t / 128. A warp reads
// whole 128-byte rows.
__device__ __forceinline__ uint2 unit_piece(const uint8_t* unit, int kK,
                                            int side, int r, int nb) {
  return *reinterpret_cast<const uint2*>(unit + (side * kK + r) * kBN +
                                         8 * nb);
}

// W+ and W- of a word of 4 int8 weights in [-127, 127]: one = 1 in each
// negative byte, s = 0xFF there, |w| = (w ^ s) + one per byte (no carry
// crosses a byte: each ends at <= 127); W+ keeps |w| where w >= 0, W- where
// w < 0.
__device__ __forceinline__ void split_word(uint32_t w, uint32_t& pos,
                                           uint32_t& neg) {
  const uint32_t one = (w >> 7) & 0x01010101u;
  const uint32_t s = one * 0xFFu;
  const uint32_t mag = (w ^ s) + one;
  pos = mag & ~s;
  neg = mag & s;
}

// Store words w[i][j] (row i = k 4kq + i, columns 8nb + 4j..) transposed
// into the K-major kBN x kK weight tile b. Store s of worker t writes
// column 8nb + (s + nb) % 8: the 16 workers of a half-warp then hit 8
// distinct 16-byte rows of their core matrices (2-way bank conflicts, not
// 16-way); the 8 words are rotated by nb % 8 in registers to match.
template <int kK>
__device__ __forceinline__ void store_block(uint8_t* b, int kq, int nb,
                                            const uint32_t (&w)[4][2]) {
  uint32_t c[8], d[8];
  transpose4(w[0][0], w[1][0], w[2][0], w[3][0], c);
  transpose4(w[0][1], w[1][1], w[2][1], w[3][1], c + 4);
  const int rot = nb & 7;
#pragma unroll
  for (int o = 0; o < 8; ++o) d[o] = (rot & 1) ? c[(o + 1) & 7] : c[o];
#pragma unroll
  for (int o = 0; o < 8; ++o) c[o] = (rot & 2) ? d[(o + 2) & 7] : d[o];
#pragma unroll
  for (int o = 0; o < 8; ++o) d[o] = (rot & 4) ? c[(o + 4) & 7] : c[o];
  uint8_t* base = b + tile_off<kK>(8 * nb, 4 * kq);
#pragma unroll
  for (int s = 0; s < 8; ++s)  // d[s] is column 8nb + (s + rot) % 8
    *reinterpret_cast<uint32_t*>(base + ((s + rot) & 7) * 16) = d[s];
}

// 'packed': store words d[j] (row j = k 8k8 + j, byte c = column 4c4 + c)
// into the K-major tile b, 8 bytes a column. Store s of worker c4 writes
// column 4c4 + (s + c4 / 2) % 4: a warp (one k8, c4 = lane) then hits 8
// distinct 16-byte rows of its core matrices (4 lanes a row, where 16
// would meet without the rotation); the 4 column pairs are rotated by
// (c4 / 2) % 4 in registers to match.
template <int kK>
__device__ __forceinline__ void store_rows8(uint8_t* b, int k8, int c4,
                                            const uint32_t (&d)[8]) {
  uint32_t lo[4], hi[4], l1[4], h1[4];
  transpose4(d[0], d[1], d[2], d[3], lo);  // rows 0-3 of column c
  transpose4(d[4], d[5], d[6], d[7], hi);  // rows 4-7
  const int rot = (c4 >> 1) & 3;
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    l1[o] = (rot & 1) ? lo[(o + 1) & 3] : lo[o];
    h1[o] = (rot & 1) ? hi[(o + 1) & 3] : hi[o];
  }
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    lo[o] = (rot & 2) ? l1[(o + 2) & 3] : l1[o];
    hi[o] = (rot & 2) ? h1[(o + 2) & 3] : h1[o];
  }
  uint8_t* base = b + tile_off<kK>(4 * c4, 8 * k8);
#pragma unroll
  for (int s = 0; s < 4; ++s)  // lo[s], hi[s] are column 4c4 + (s + rot) % 4
    *reinterpret_cast<uint2*>(base + ((s + rot) & 3) * 16) =
        make_uint2(lo[s], hi[s]);
}

// 'planes': acc += A (pos_p tiles), neg += A (neg_p tiles) for L live
// planes, tiles 2j and 2j + 1 of b.
template <int L, int kSbo>
__device__ __forceinline__ void plane_products(int (&acc)[64], int (&neg)[64],
                                               uint64_t da, const uint8_t* b,
                                               int b_bytes) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    wgmma_s8(acc, da, desc(b + (2 * j) * b_bytes, kSbo));
    wgmma_s8(neg, da, desc(b + (2 * j + 1) * b_bytes, kSbo));
  }
}

template <class Src, Mode kMode, class W>
__global__ void __launch_bounds__(kThreads, 1)
    tile_kernel(Src src, W wts, const __grid_constant__ CUtensorMap pos_map,
                const __grid_constant__ CUtensorMap neg_map,
                const __grid_constant__ CUtensorMap row_map,
                int* __restrict__ partial, int M, int K, int N, int kchunk,
                int tma_weights, int tma_rows) {
  constexpr int kElem = RowBox<Src>::kElem;
  using C = Cfg<kMode, kElem>;
  constexpr int kK = C::kK;
  constexpr int kCols = kElem == 4 ? 32 : kK;  // columns a box
  constexpr int kCodeBytes = C::kCodeBytes;
  // two accumulators: Eq. 10's and Eq. 6's positive and negative products
  constexpr bool kTwo = kMode == Mode::kPlanes || kMode == Mode::kSplit;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int t = threadIdx.x, lane = t & 31;
  const int P = planes_of<kMode>(wts);
  const int a_bytes = kBM * kK, b_bytes = kBN * kK;
  const int stage_bytes = a_bytes + C::tiles(P) * b_bytes;
  const int raw_slots = C::slots(P);
  uint8_t* codes = smem + 2 * stage_bytes;
  uint8_t* ring = codes + kCodeSlots * kCodeBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + raw_slots * C::kUnitBytes);
  uint64_t* empty = full + raw_slots;
  uint64_t* code_full = empty + raw_slots;
  uint64_t* code_empty = code_full + kCodeSlots;
  const int m0 = blockIdx.x * kBM, n_blk = blockIdx.y * kBN;
  const int k0 = blockIdx.z * kchunk, kend = min(k0 + kchunk, K);
  const int steps = (kend - k0 + kK - 1) / kK;
  // shift and roles broadcast from lane 0, so the compiler sees them
  // warp-uniform and keeps the products asynchronous
  const int shift = __shfl_sync(0xffffffffu, src.shift(P), 0);
  const int units = P - shift;  // units a K step: the live planes, 0..P
  if (units == 0) {  // every plane dead (shift = P): the product is 0
    for (int i = t; i < kBM * kBN; i += kThreads) {
      const int m = m0 + i / kBN, n = n_blk + i % kBN;
      if (m < M && n < N) partial[((size_t)blockIdx.z * M + m) * N + n] = 0;
    }
    return;
  }
  if (t == 0) {
    for (int s = 0; s < raw_slots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWorkers / 32);
    }
    for (int s = 0; s < kCodeSlots; ++s) {
      mbar_init(&code_full[s], 1);
      mbar_init(&code_empty[s], kWorkers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (__shfl_sync(0xffffffffu, t / kWorkers, 0) != 0) {  // the copy warp
    // the codes of a step go out one step ahead of its weight units
    auto issue_codes = [&](int it) {
      const int kb = k0 + it * kK, cs = it % kCodeSlots;
      uint8_t* cdst = codes + cs * kCodeBytes;
      mbar_wait(&code_empty[cs], ((it / kCodeSlots) & 1) ^ 1);
      if (tma_rows) {
        if (lane == 0) {
          mbar_expect_tx(&code_full[cs], kCodeBytes);
#pragma unroll
          for (int bx = 0; bx < kK / kCols; ++bx)
            tma_box2(cdst + bx * kBM * kCols * kElem, &row_map,
                     kb + bx * kCols, m0, &code_full[cs]);
        }
      } else {
        fill_codes<kK>(src, cdst, M, m0, kb, lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(&code_full[cs]);
      }
    };
    issue_codes(0);
    for (int it = 0; it < steps; ++it) {
      if (it + 1 < steps) issue_codes(it + 1);
      const int kb = k0 + it * kK;
      for (int j = 0; j < units; ++j) {
        const int u = it * units + j, slot = u % raw_slots, p = shift + j;
        uint8_t* dst = ring + slot * C::kUnitBytes;
        mbar_wait(&empty[slot], ((u / raw_slots) & 1) ^ 1);
        if (tma_weights) {
          if (lane == 0) {
            mbar_expect_tx(&full[slot], C::kUnitBytes);
            if constexpr (kMode == Mode::kSplit) {
              tma_box2(dst, &pos_map, n_blk, kb, &full[slot]);
            } else {
              const int r = kMode == Mode::kPacked ? kb / 8 : kb;
              tma_box(dst, &pos_map, n_blk, r, p, &full[slot]);
              tma_box(dst + C::kBoxRows * kBN, &neg_map, n_blk, r, p,
                      &full[slot]);
            }
          }
        } else {
          fill_unit<C, kMode>(wts, dst, p, kb, n_blk, N, lane);
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[slot]);
        }
      }
    }
    return;
  }

  // workers
  const auto rd = src.reader();
  const int nb = t & 15, kq = kMode == Mode::kPlanes ? (t >> 4) & 7 : t >> 4;
  const int side0 = kMode == Mode::kPlanes ? t >> 7 : 0;
  const int wg = __shfl_sync(0xffffffffu, t >> 7, 0), warp = (t >> 5) & 3;
  int acc[64], neg[kTwo ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  if constexpr (kTwo) {
#pragma unroll
    for (int i = 0; i < 64; ++i) neg[i] = 0;
  }
  for (int it = 0; it < steps; ++it) {
    uint8_t* a = smem + (it & 1) * stage_bytes;
    uint8_t* b = a + a_bytes;
    const int cs = it % kCodeSlots;
    mbar_wait(&code_full[cs], (it / kCodeSlots) & 1);
    finish_codes<kK>(rd, codes + cs * kCodeBytes, a, M, m0, k0 + it * kK,
                     kend, t);
    __syncwarp();
    if (lane == 0) mbar_arrive(&code_empty[cs]);
    if constexpr (kMode == Mode::kPacked) {
      // packed row k8 = t / 32 (K rows 8 k8 ..), columns 4 (t % 32) ..
      const int k8 = t >> 5;
      uint32_t pw[8], nw[8], d[8];
#pragma unroll
      for (int p = 0; p < kMaxPlanes; ++p) {
        pw[p] = nw[p] = 0u;
        if (p < shift || p >= P) continue;  // a dead plane: never loaded
        const int u = it * units + p - shift, slot = u % raw_slots;
        const uint8_t* unit = ring + slot * C::kUnitBytes;
        mbar_wait(&full[slot], (u / raw_slots) & 1);
        pw[p] = *reinterpret_cast<const uint32_t*>(unit + k8 * kBN +
                                                   4 * lane);
        nw[p] = *reinterpret_cast<const uint32_t*>(
            unit + (C::kBoxRows + k8) * kBN + 4 * lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
      }
      pw[7] = nw[7] = 0u;
      transpose_bits(pw);  // word j, byte c: |w| of sign at row j, column c
      transpose_bits(nw);
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = sub_bytes(pw[j], nw[j]);
      store_rows8<kK>(b, k8, lane, d);
    } else if constexpr (kMode == Mode::kSplit) {
      const int slot = it % raw_slots;
      const uint8_t* unit = ring + slot * C::kUnitBytes;
      mbar_wait(&full[slot], (it / raw_slots) & 1);
      uint32_t wp[4][2], wn[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint2 v = unit_piece(unit, kK, 0, 4 * kq + i, nb);
        split_word(v.x, wp[i][0], wn[i][0]);
        split_word(v.y, wp[i][1], wn[i][1]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      store_block<kK>(b, kq, nb, wp);
      store_block<kK>(b + b_bytes, kq, nb, wn);
    } else {
      uint32_t pw[4][2] = {}, nw[4][2] = {};
      for (int j = 0; j < units; ++j) {
        const int u = it * units + j, slot = u % raw_slots;
        const int p = shift + j;
        const uint8_t* unit = ring + slot * C::kUnitBytes;
        mbar_wait(&full[slot], (u / raw_slots) & 1);
        if constexpr (kMode == Mode::kPlanes) {
          // pos_p or neg_p pre-scaled by 2^p, its own tile
          uint32_t w[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint2 v = unit_piece(unit, kK, side0, 4 * kq + i, nb);
            w[i][0] = v.x << p;
            w[i][1] = v.y << p;
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[slot]);
          store_block<kK>(b + (2 * j + side0) * b_bytes, kq, nb, w);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint2 x = unit_piece(unit, kK, 0, 4 * kq + i, nb);
            const uint2 y = unit_piece(unit, kK, 1, 4 * kq + i, nb);
            pw[i][0] |= x.x << p; pw[i][1] |= x.y << p;
            nw[i][0] |= y.x << p; nw[i][1] |= y.y << p;
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[slot]);
        }
      }
      if constexpr (kMode == Mode::kFused) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pw[i][0] = __vsub4(pw[i][0], nw[i][0]);
          pw[i][1] = __vsub4(pw[i][1], nw[i][1]);
        }
        store_block<kK>(b, kq, nb, pw);
      }
    }
    // this warpgroup's previous product has read the other buffer; after
    // the barrier both have, and this stage is complete for wgmma's proxy
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWorkers) : "memory");
    const uint8_t* aw = a + wg * 64 * kK;  // this warpgroup's 64 rows
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    fence_acc(acc);
    if constexpr (kMode == Mode::kPlanes) {
      fence_acc(neg);
      const uint64_t da = desc(aw, C::kSbo);
      switch (units) {  // straight-line batches: the products pipeline
        case 1: plane_products<1, C::kSbo>(acc, neg, da, b, b_bytes); break;
        case 2: plane_products<2, C::kSbo>(acc, neg, da, b, b_bytes); break;
        case 3: plane_products<3, C::kSbo>(acc, neg, da, b, b_bytes); break;
        case 4: plane_products<4, C::kSbo>(acc, neg, da, b, b_bytes); break;
        case 5: plane_products<5, C::kSbo>(acc, neg, da, b, b_bytes); break;
        case 6: plane_products<6, C::kSbo>(acc, neg, da, b, b_bytes); break;
        default: plane_products<7, C::kSbo>(acc, neg, da, b, b_bytes);
      }
    } else if constexpr (kMode == Mode::kSplit) {
      fence_acc(neg);
#pragma unroll
      for (int kk = 0; kk < kK / 32; ++kk) {  // 32 k = 2 core matrices
        const uint64_t da = desc(aw + 256 * kk, C::kSbo);
        wgmma_s8(acc, da, desc(b + 256 * kk, C::kSbo));
        wgmma_s8(neg, da, desc(b + b_bytes + 256 * kk, C::kSbo));
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kK / 32; ++kk)  // 32 k = 2 core matrices
        wgmma_s8(acc, desc(aw + 256 * kk, C::kSbo),
                 desc(b + 256 * kk, C::kSbo));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_acc(acc);
    if constexpr (kTwo) fence_acc(neg);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  if constexpr (kTwo) {
    fence_acc(neg);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] -= neg[i];  // the one subtraction
  }
  const int row = m0 + 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n_blk + 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = row + 8 * i;
      if (m < M && n < N)
        *reinterpret_cast<int2*>(
            partial + ((size_t)blockIdx.z * M + m) * N + n) =
            make_int2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* ptr = nullptr;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                      const void* base, const cuuint64_t* dims,
                      const cuuint64_t* strides, const cuuint32_t* box,
                      CUtensorMapSwizzle swizzle) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The (N, rows, P) uint8 view of one side's planes (rows = K unpacked, K/8
// packed), boxes of kBN x box_rows x 1.
inline int plane_map(CUtensorMap* map, const void* planes, int P, int rows,
                     int N, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)rows, (cuuint64_t)P};
  const cuuint64_t strides[2] = {(cuuint64_t)N, (cuuint64_t)rows * N};
  const cuuint32_t box[3] = {kBN, (cuuint32_t)box_rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, planes, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The (N, K) uint8 view of the int8 weight, boxes of kBN x kK.
inline int weight_map(CUtensorMap* map, const void* w, int K, int N,
                      int kK) {
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {kBN, (cuuint32_t)kK};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dims, strides,
                    box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The (K, M) view of the row source, boxes of kK (x_q) or 32 (x, 128-byte
// swizzled) columns x kBM rows.
inline int row_map(CUtensorMap* map, const CodeRows& src, int M, int kK) {
  const cuuint64_t dims[2] = {(cuuint64_t)src.K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)src.K};
  const cuuint32_t box[2] = {(cuuint32_t)kK, kBM};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, src.xq, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

inline int row_map(CUtensorMap* map, const FloatRows& src, int M, int) {
  const cuuint64_t dims[2] = {(cuuint64_t)src.K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)src.K * 4};
  const cuuint32_t box[2] = {32, kBM};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, src.x, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

inline bool rows_tma_ok(const CodeRows& src, int K) {
  return K % 16 == 0 && aligned16(src.xq);
}

inline bool rows_tma_ok(const FloatRows& src, int K) {
  return K % 4 == 0 && aligned16(src.x);
}

// The tensor maps of the weight source (pos_map only for the split
// weight). Returns 0, or the error of an encode.
template <class C, Mode kMode, class W>
int weight_maps(const W& wts, int K, int N, CUtensorMap* pos_map,
                CUtensorMap* neg_map) {
  if constexpr (kMode == Mode::kSplit) {
    return weight_map(pos_map, wts.w, K, N, C::kK);
  } else {
    const int rows = kMode == Mode::kPacked ? K / 8 : K;
    int err = plane_map(pos_map, wts.pos, wts.P, rows, N, C::kBoxRows);
    if (err == 0) err = plane_map(neg_map, wts.neg, wts.P, rows, N,
                                  C::kBoxRows);
    return err;
  }
}

template <Mode kMode, class W>
bool weights_aligned(const W& wts) {
  if constexpr (kMode == Mode::kSplit) {
    return aligned16(wts.w);
  } else {
    return aligned16(wts.pos) && aligned16(wts.neg);
  }
}

// Launch the tile kernel over grid (M tiles, N tiles, ksplit). kchunk is a
// multiple of 64 (split_k in kernels/pann_matmul.py), so only the last K
// step of the last split is partial, and P <= kMaxPlanes (K % 8 == 0 for
// packed planes). TMA moves a tensor whose rows are 16-byte aligned; the
// copy warp loads the others.
template <class Src, Mode kMode, class W>
int launch(Src src, W wts, int* partial, int M, int K, int N, int ksplit,
           int kchunk, cudaStream_t st) {
  using C = Cfg<kMode, RowBox<Src>::kElem>;
  const int P = planes_of<kMode>(wts);
  if (P < 1 || P > kMaxPlanes || (ksplit > 1 && kchunk % 64 != 0) ||
      (kMode == Mode::kPacked && K % 8 != 0))
    return cudaErrorInvalidValue;
  CUtensorMap pos_map{}, neg_map{}, rows{};
  const int tma_weights = N % 16 == 0 && weights_aligned<kMode>(wts);
  int err = 0;
  if (tma_weights) {
    err = weight_maps<C, kMode>(wts, K, N, &pos_map, &neg_map);
    if (err != 0) return err;
  }
  const int tma_rows = rows_tma_ok(src, K);
  if (tma_rows) {
    err = row_map(&rows, src, M, C::kK);
    if (err != 0) return err;
  }
  auto kern = tile_kernel<Src, kMode, W>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err != cudaSuccess) return err;
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, ksplit);
  kern<<<grid, kThreads, C::smem(P), st>>>(src, wts, pos_map, neg_map, rows,
                                           partial, M, K, N, kchunk,
                                           tma_weights, tma_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace pann
