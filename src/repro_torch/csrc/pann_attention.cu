// One-token GQA decode attention read directly off the packed bit-plane KV
// cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pann_attention.py::decode_attention
// (_decode_attention_kernel), which holds a (batch, kv head)'s K and V code
// panels in VMEM and starts the V copies while QK^T runs.
//
// What bounds it on this card: bytes (every live plane row of every cached
// position, K and V, is read once per token: P_live/8 bytes a code) and,
// at decode sizes, launch and memory latency. One launch per call:
//   * grid (C, KH, B): the C blocks of a (batch, kv head) form one thread
//     block cluster, and block `rank` takes the contiguous chunk of
//     positions [rank * chunk, (rank + 1) * chunk). The wrapper picks C in
//     1..8 from S and the card's occupancy (decode_attention_max_clusters)
//     so that the B * KH clusters take as few waves as they can. Only
//     positions inside the causal/window mask [s_lo, s_hi] are read; a
//     block whose chunk is wholly masked still takes part in every cluster
//     exchange with neutral values (max -1e30, sums 0).
//   * The valid positions' v_s / v_z rows are copied into shared memory
//     with cp.async at once; K rows go straight into registers (a 32-bit
//     word of a plane row a lane); right after the first K rows are
//     requested every live V plane row of the chunk is copied into shared
//     memory with cp.async (16-byte rows at hd = 128; at hd = 160 a head's
//     20-byte row sits at a 4-byte-aligned offset, so it goes as five 4-byte
//     copies into a 20-byte shared row), so V's bytes are in flight while
//     QK^T runs: one DRAM round trip, not two. Dead high
//     planes (p >= pact) are never loaded; at pact <= 4 the code is
//     compiled for four planes.
//   * Both products run on the int8 tensor cores (mma.sync m16n8k32, u8,
//     exact int32 sums): the integer dot-product instructions (__dp4a,
//     __dp2a) issue too slowly on this card to keep up with the bytes.
//     QK^T: the 8 x 8 bit transpose of pann_common.cuh turns a lane's K
//     words of the live planes into codes (word i, byte c = code of element
//     8 (4k + c) + i), which are the B fragments of products whose A rows
//     are the query codes in the same order, plus a row of ones whose
//     product is `colsum`. Both zero points are corrected in int32.
//   * The fp32 epilogue of repro_torch/kernels/ref.py::decode_attention_ref
//     (score scale, optional tanh softcap, mask, softmax), every product
//     rounded by __fmul_rn, IEEE divisions, rintf, expf. Each query head
//     has kWarps / G warps. The cluster exchanges (the blocks' maxima, the
//     fp64 partial sums of exp(sc - m), the largest valid V scale, the
//     int32 zero-point corrections and PV partials) go through distributed
//     shared memory, each reduced in a fixed order (lanes by a shuffle
//     tree, warps, then ranks in rank order), so every block uses the same
//     max, denominator and scale and every run gives the same bits. The
//     denominator is summed in fp64 and rounded once to fp32; the plain
//     version does the same, so the two agree although they add in
//     different orders.
//   * Probabilities are rescaled into the largest valid V scale and
//     requantized at 2^14, kept as two bytes (low 7 bits, high bits). PV:
//     a 4 x 4 byte transpose across lanes (two shuffles) puts four cached
//     positions of one head-dim byte in a word, the bit transpose turns the
//     planes into codes, and m16n8k32 products take the low bytes as A rows
//     g and the high bytes as rows 8 + g. The warps' partials meet in
//     shared memory through integer atomics (exact in any order); each
//     rank writes a slice of the output from the sum of all ranks'.
//
// Shared memory per block: the chunk's V rows for P planes, its v_s / v_z
// rows, (G, chunk) fp32 scores and two bytes of probability code; the
// wrapper (repro_torch/kernels/pann_attention.py) states the largest S
// this allows, and past it launches decode_attention_long_kernel (below),
// whose blocks walk their chunks in tiles and keep the scores in a global
// scratch; both kernels run the same device functions for the QK^T step,
// the per-element epilogues, the PV step and the exchanges. The scalars
// q_z, q_scale, k_pact and v_pact are device pointers read here (a null
// pact means every plane is live), so a call launches nothing but this
// kernel.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "pann_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGMax = 8;          // query heads per kv head
constexpr int kCMax = 8;          // blocks per cluster
constexpr int kHDMax = 256;
constexpr int kPlanes = pann::kMaxPlanes;
constexpr float kNegInf = -1e30f;
constexpr float kProbScale = 16384.0f;
constexpr int kTile = 256;        // rows of a long-path tile
constexpr int kLongC = 8;         // blocks a (batch, kv head) on the long path
constexpr int kSteps = 4;         // QK^T steps of 8 rows a warp loads at once
// dynamic shared memory a block may take: the card's 227 KB less the
// kernel's static arrays and a margin (the wrapper's DYN_SMEM_BYTES)
constexpr size_t kDynSmemMax = 232448 - 12 * 1024;

using pann::cluster_barrier;
using pann::gather;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}
__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// a live-plane count from a device scalar: clamped to [1, P], rounded;
// null means all P planes
__device__ __forceinline__ int live_planes(const float* p, int P) {
  if (p == nullptr) return P;
  return static_cast<int>(
      rintf(fminf(fmaxf(*p, 1.0f), static_cast<float>(P))));
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}
// wait for all but the N newest groups of this thread's copies
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

struct Args {
  const int* qq;
  const float* qz;      // q zero point (truncated to int, as the plain version)
  const float* qscale;  // s_q * hd^-0.5
  const float* kpact;   // live K planes, or null
  const float* vpact;   // live V planes, or null
  const int* pos;
  const uint8_t* kpl;
  const float* ks;
  const float* kz;
  const uint8_t* vpl;
  const float* vs;
  const float* vz;
  float* out;
  int P, S, KH, G, chunk, chunk_pad, window;
  float softcap;
};

// Layout of a plane row in shared memory and of a thread's K word: WPR
// 32-bit words a row (hd = 16 pads its 2-byte rows to one word). A head's
// row starts at a multiple of D8 bytes in global memory, so a cp.async
// piece is the largest of 16, 8 and 4 bytes that divides D8 (hd = 160:
// five 4-byte pieces of a 20-byte row).
template <int D8>
struct Rows {
  static_assert(D8 < 4 || D8 % 4 == 0, "hd must be a multiple of 32 above 16");
  static constexpr int kWPR = D8 >= 4 ? D8 / 4 : 1;
  static constexpr int kRS = 4 * kWPR;                // bytes a shared row
  static constexpr int kCopy =                        // bytes a cp.async
      D8 % 16 == 0 ? 16 : D8 % 8 == 0 ? 8 : D8 >= 4 ? 4 : D8;
};

// A score's fp32 epilogue, op for op the plain version's: (i32 * q_scale)
// * k_s, each product rounded, then the optional tanh softcap.
__device__ __forceinline__ float score_of(int i32, float q_scale, float ks,
                                         float softcap) {
  float v = __fmul_rn(__fmul_rn(static_cast<float>(i32), q_scale), ks);
  if (softcap > 0.0f) v = __fmul_rn(softcap, tanhf(v / softcap));
  return v;
}

// A probability's code: exp(sc - m) / denom (the fp64 sum rounded once)
// rescaled into the largest valid V scale and requantized at 2^14.
__device__ __forceinline__ int prob_code(float e, float denom, float vs,
                                         float sv_ref) {
  const float ratio = vs / sv_ref;
  const float pr = e / denom;
  return static_cast<int>(rintf(__fmul_rn(__fmul_rn(pr, ratio), kProbScale)));
}

// c += A * B, one m16n8k32 product of unsigned bytes with int32 sums (the
// PTX fragment layouts: a0/a2 row lane/4, a1/a3 row lane/4 + 8, columns
// 4 (lane % 4) and 16 + 4 (lane % 4); b0/b1 column lane/4, the same rows;
// c0, c1 row lane/4 and c2, c3 row lane/4 + 8, columns 2 (lane % 4) + 0/1).
__device__ __forceinline__ void mma_u8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A 32-bit word of a K plane row (a 16-bit row at hd = 16), through the
// read-only path and not kept in L1.
template <int D8>
__device__ __forceinline__ uint32_t load_k(const uint8_t* src) {
  if constexpr (D8 >= 4) {
    return pann::ld_stream(src);
  } else {
    return __ldg(reinterpret_cast<const unsigned short*>(src));
  }
}

// The maximum over the cluster's ranks of the value at `x` (and `init`),
// and the sum of the ranks' fp64 values in rank order.
__device__ __forceinline__ float rank_max(const cg::cluster_group& cluster,
                                          float* x, int C, float init) {
  float v[kCMax];
  gather(cluster, x, C, v);
  float m = init;
#pragma unroll
  for (int r = 0; r < kCMax; ++r)
    if (r < C) m = fmaxf(m, v[r]);
  return m;
}
__device__ __forceinline__ double rank_sum(const cg::cluster_group& cluster,
                                           double* x, int C) {
  double v[kCMax];
  gather(cluster, x, C, v);
  double s = 0.0;
#pragma unroll
  for (int r = 0; r < kCMax; ++r)
    if (r < C) s += v[r];
  return s;
}

// The query codes qs ([G][HD]) in the order the bit transpose leaves the
// K codes, word (g, k, i) of qw with byte c = q[g][8 (4k + c) + i], and
// the codes' row sums.
template <int D8>
__device__ __forceinline__ void query_words(const int* qs, uint32_t* qw,
                                            int* rowsum_q, int G, int tid) {
  constexpr int HD = D8 * 8;
  constexpr int WPR = Rows<D8>::kWPR;
  for (int w = tid; w < G * WPR * 8; w += kThreads) {
    const int g = w / (WPR * 8), k = (w / 8) % WPR, i = w % 8;
    uint32_t word = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * k + c;
      if (j < D8)
        word |= static_cast<uint32_t>(qs[g * HD + 8 * j + i] & 0xFF)
                << (8 * c);
    }
    qw[w] = word;
  }
  if (tid < G) {
    int r = 0;
    for (int h = 0; h < HD; ++h) r += qs[tid * HD + h];
    rowsum_q[tid] = r;
  }
}

// QK^T, exact int32 on the tensor cores, in warp steps of 8 cached rows.
// Lane (n_l, kq) (n_l = lane / 4, kq = lane % 4) loads word kq (+ 4) of
// row n_l's live K planes, and the bit transpose makes the B fragments of
// m16n8k32 products whose A rows 0..G-1 are the query codes in the same
// order (qa) and row 8 is all ones (colsum). kHalves: K words a lane and
// row (WPR = 5: the second holds word 4 only). NP bounds the live planes
// at compile time (4 or 7), so at 4 the dead rows of the transpose fold.
template <int D8>
constexpr int kHalves = (Rows<D8>::kWPR + 3) / 4;

template <int D8>
using QueryFrags = uint32_t[kHalves<D8>][4][2];

// lane (n_l, kq)'s A fragments of head n_l's query words
template <int D8>
__device__ __forceinline__ void query_fragments(const uint32_t* qw, int G,
                                                int n_l, int kq,
                                                QueryFrags<D8>& qa) {
  constexpr int WPR = Rows<D8>::kWPR;
#pragma unroll
  for (int u = 0; u < kHalves<D8>; ++u)
#pragma unroll
    for (int m2 = 0; m2 < 4; ++m2)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int k = kq + 4 * u;
        qa[u][m2][e2] = n_l < G && k < WPR
                            ? qw[(n_l * WPR + k) * 8 + 2 * m2 + e2]
                            : 0u;
      }
}

// kSteps steps' K words, k_s and rounded k_z, loaded at once: step b2
// takes rows 8 (st0 + b2 kWarps) .. + 7 past the first valid row (whose
// K plane row is k0, whose k_s / k_z are ks0 / kz0); lane (n_l, kq) loads
// its K words of row n_l and the k_s / k_z of its scores' rows 2 kq and
// 2 kq + 1. Rows past nvalid read nothing.
template <int NP, int D8>
struct KSteps {
  uint32_t w[kSteps][kHalves<D8>][NP];
  float ks[kSteps][2];
  int kz[kSteps][2];

  __device__ __forceinline__ void load(const uint8_t* k0, const float* ks0,
                                       const float* kz0, size_t plane_stride,
                                       size_t rowstride, int st0, int nvalid,
                                       int k_pact, int n_l, int kq) {
    constexpr int WPR = Rows<D8>::kWPR;
#pragma unroll
    for (int b2 = 0; b2 < kSteps; ++b2) {
      const int sl = (st0 + b2 * kWarps) * 8 + n_l;  // this lane's row
      const uint8_t* src = k0 + (size_t)sl * rowstride;
#pragma unroll
      for (int u = 0; u < kHalves<D8>; ++u) {
        const int k = kq + 4 * u;
        const bool ok = sl < nvalid && k < WPR;
#pragma unroll
        for (int p2 = 0; p2 < NP; ++p2)
          w[b2][u][p2] = ok && p2 < k_pact
                             ? load_k<D8>(src + p2 * plane_stride + 4 * k)
                             : 0u;
      }
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {  // this lane's scores' rows
        const int so = (st0 + b2 * kWarps) * 8 + 2 * kq + e2;
        const bool ok = so < nvalid;
        ks[b2][e2] = ok ? ks0[so] : 0.0f;
        kz[b2][e2] = ok ? static_cast<int>(rintf(kz0[so])) : 0;
      }
    }
  }

  // The loaded steps' scores: c0, c1 are the dots of head n_l at rows
  // 2 kq, 2 kq + 1, their colsums row 8 of lane kq (its c2, c3); both
  // zero points corrected in int32, then score_of. Each valid row's score
  // goes to sink(g, row past the first valid one, score).
  template <class Sink>
  __device__ __forceinline__ void scores(const QueryFrags<D8>& qa, int st0,
                                         int nvalid, int G, int qz,
                                         const int* rowsum_q, float q_scale,
                                         float softcap, int n_l, int kq,
                                         Sink&& sink) const {
    constexpr int HD = D8 * 8;
    const uint32_t ones = n_l == 0 ? 0x01010101u : 0u;
#pragma unroll
    for (int b2 = 0; b2 < kSteps; ++b2) {
      const int st = st0 + b2 * kWarps;
      if (st * 8 >= nvalid) break;  // warp-uniform
      int c[4] = {0, 0, 0, 0};
#pragma unroll
      for (int u = 0; u < kHalves<D8>; ++u) {
        uint32_t code[8];
#pragma unroll
        for (int p2 = 0; p2 < 8; ++p2) code[p2] = p2 < NP ? w[b2][u][p2] : 0u;
        // word i, byte c = code of element 8 (4k + c) + i
        pann::transpose_bits(code);
#pragma unroll
        for (int m2 = 0; m2 < 4; ++m2)
          mma_u8(c, qa[u][m2][0], ones, qa[u][m2][1], ones, code[2 * m2],
                 code[2 * m2 + 1]);
      }
      const int cs[2] = {__shfl_sync(~0u, c[2], kq),
                         __shfl_sync(~0u, c[3], kq)};
      if (n_l < G) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int so = st * 8 + 2 * kq + e2;
          if (so < nvalid) {
            const int i32 = c[e2] - qz * cs[e2] - kz[b2][e2] * rowsum_q[n_l] +
                            qz * kz[b2][e2] * HD;
            sink(n_l, so, score_of(i32, q_scale, ks[b2][e2], softcap));
          }
        }
      }
    }
  }
};

// Copy n cached rows of a head's live V planes into shared memory with
// cp.async (one commit group): plane p's row s from src + p * plane_stride
// + s * rowstride to dst + (p * rows + s) * RS, in pieces of kCopy bytes.
template <int D8>
__device__ __forceinline__ void copy_v_rows(uint8_t* dst, int rows,
                                            const uint8_t* src,
                                            size_t plane_stride,
                                            size_t rowstride, int n,
                                            int v_pact, int tid) {
  constexpr int RS = Rows<D8>::kRS;
  constexpr int kCopy = Rows<D8>::kCopy;
  constexpr int kPieces = D8 / kCopy > 0 ? D8 / kCopy : 1;
  const int m = n * kPieces;
  for (int p = 0; p < v_pact; ++p) {
    const uint8_t* src0 = src + p * plane_stride;
    uint8_t* dst0 = dst + (size_t)p * rows * RS;
    for (int i = tid; i < m; i += kThreads) {
      const int s = i / kPieces, piece = i - s * kPieces;
      const uint8_t* from = src0 + (size_t)s * rowstride + piece * kCopy;
      uint8_t* to = dst0 + s * RS + piece * kCopy;
      if constexpr (D8 >= 4) {
        cp_async(to, from, kCopy);
      } else {
        *reinterpret_cast<unsigned short*>(to) =
            __ldg(reinterpret_cast<const unsigned short*>(from));
      }
    }
  }
  cp_async_commit();
}

// PV's B fragments: the codes (word i) of head-dim byte j0 + n_l at rows
// r0 + 4 kq .. + 3 of shared V rows vsm ([P][rows][RS]). Lane (4 k' + m',
// kq) reads word wd = 2 oct + k' of row r0 + 4 kq + m'; a 4 x 4 byte
// transpose across the lanes m' (two shuffles) leaves it byte j0 + 4 k' +
// m' of rows 4 kq .. 4 kq + 3, and the bit transpose turns the planes into
// the codes of bit i in word i.
template <int NP, int D8>
__device__ __forceinline__ void pv_codes(const uint8_t* vsm, int rows,
                                         int r0, int kq, int mp, int wd,
                                         int v_pact, uint32_t (&code)[8]) {
  constexpr int WPR = Rows<D8>::kWPR;
  constexpr int RS = Rows<D8>::kRS;
#pragma unroll
  for (int p2 = 0; p2 < 8; ++p2) code[p2] = 0;
#pragma unroll
  for (int p2 = 0; p2 < NP; ++p2) {
    const uint32_t x =
        p2 < v_pact && wd < WPR
            ? *reinterpret_cast<const uint32_t*>(
                  vsm + ((size_t)p2 * rows + r0 + 4 * kq + mp) * RS + 4 * wd)
            : 0u;
    uint32_t y = __shfl_xor_sync(~0u, x, 8);
    const uint32_t z = (mp & 2) ? __byte_perm(y, x, 0x7632)
                                : __byte_perm(x, y, 0x5410);
    y = __shfl_xor_sync(~0u, z, 4);
    code[p2] = (mp & 1) ? __byte_perm(y, z, 0x7351)
                        : __byte_perm(z, y, 0x6240);
  }
  pann::transpose_bits(code);
}

// Exact int32 PV on the tensor cores, one 32-row step: m16n8k32 products
// with K = 32 cached rows r0 .. r0 + 31 of shared V rows vsm ([P][rows]
// [RS]), A rows g the low 7 bits of head g's probability codes (pql,
// [G][rows]) and rows 8 + g their high bits (pqh), B the codes of 8
// head-dim bytes j at one bit i (pv_codes, rows r0 + 4 kq .. and r0 + 16
// + 4 kq ..), summed into acc. Warp w takes byte octet oct = w % n_oct
// (j0 = 8 oct; wd = 2 oct + n_l / 4 the word a lane reads).
template <int NP, int D8>
__device__ __forceinline__ void pv_step(const uint8_t* vsm, const uint8_t* pql,
                                        const uint8_t* pqh, int rows, int r0,
                                        int G, int n_l, int kq, int mp,
                                        int wd, int v_pact,
                                        int (&acc)[8][4]) {
  uint32_t b0[8], b1[8];
  pv_codes<NP, D8>(vsm, rows, r0, kq, mp, wd, v_pact, b0);
  pv_codes<NP, D8>(vsm, rows, r0 + 16, kq, mp, wd, v_pact, b1);
  uint32_t a4[4] = {0u, 0u, 0u, 0u};
  if (n_l < G) {
    const size_t o = (size_t)n_l * rows + r0 + 4 * kq;
    a4[0] = *reinterpret_cast<const uint32_t*>(pql + o);
    a4[1] = *reinterpret_cast<const uint32_t*>(pqh + o);
    a4[2] = *reinterpret_cast<const uint32_t*>(pql + o + 16);
    a4[3] = *reinterpret_cast<const uint32_t*>(pqh + o + 16);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    mma_u8(acc[i], a4[0], a4[1], a4[2], a4[3], b0[i], b1[i]);
}

// A warp's PV sums into the block's partials pv ([G][HD]), through
// integer atomics (exact in any order): lane (n_l, kq) holds head n_l,
// bytes 8 oct + 2 kq + e2 (e2 = 0, 1), bit i, the low part in acc[i][e2]
// and the high part in acc[i][2 + e2].
template <int D8>
__device__ __forceinline__ void add_pv(int* pv, const int (&acc)[8][4],
                                       int oct, int n_l, int kq) {
  constexpr int HD = D8 * 8;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int j = 8 * oct + 2 * kq + e2;
    if (j < D8) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        atomicAdd(&pv[n_l * HD + 8 * j + i], acc[i][e2] + 128 * acc[i][2 + e2]);
    }
  }
}

// Each rank writes a slice of the n = G * HD outputs at dst from every
// rank's PV partials and zero-point corrections: (sum - corr) * scale.
template <int HD>
__device__ __forceinline__ void write_output(
    const cg::cluster_group& cluster, int* pv, int* xcorr, float* dst, int n,
    int rank, int C, int tid, float scale) {
  for (int i = rank * kThreads + tid; i < n; i += C * kThreads) {
    int sums[kCMax], corrs[kCMax], sum = 0, corr = 0;
    gather(cluster, &pv[i], C, sums);
    gather(cluster, &xcorr[i / HD], C, corrs);
#pragma unroll
    for (int r = 0; r < kCMax; ++r) {
      sum += sums[r];
      corr += corrs[r];
    }
    dst[i] = __fmul_rn(static_cast<float>(sum - corr), scale);
  }
}

template <int D8>
__global__ void __launch_bounds__(kThreads, 2)
    decode_attention_kernel(const Args a) {
  constexpr int HD = D8 * 8;
  constexpr int RS = Rows<D8>::kRS;
  cg::cluster_group cluster = cg::this_cluster();
  // values the same in every lane of a warp are passed through a shuffle
  // from lane 0, which tells ptxas so: loops that hold shuffles then need
  // no per-lane convergence handling
  const int C = __shfl_sync(~0u, static_cast<int>(cluster.num_blocks()), 0);
  const int rank =
      __shfl_sync(~0u, static_cast<int>(cluster.block_rank()), 0);
  const int kh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = __shfl_sync(~0u, tid >> 5, 0);
  const int G = a.G, P = a.P, S = a.S, cp = a.chunk_pad;
  // warps per query head in the softmax passes: warp w takes head w / wpg
  const int wpg = kWarps / G;

  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* vsm = smem;                                   // [P][cp][RS]
  float* sc = reinterpret_cast<float*>(smem + (size_t)P * cp * RS);  // [G][cp]
  float* vrow = sc + (size_t)G * cp;                     // [2][cp] v_s, v_z
  // probability codes q = 128 hi + lo as bytes: [G][cp] lo, then [G][cp] hi
  uint8_t* pql = reinterpret_cast<uint8_t*>(vrow + 2 * (size_t)cp);
  uint8_t* pqh = pql + (size_t)G * cp;
  __shared__ __align__(16) uint32_t qw[kGMax * kHDMax / 4];  // [G][WPR][8]
  __shared__ int qpv[kGMax * kHDMax];  // [G][HD] query codes, then PV partials
  int* qs = qpv;
  int* pv = qpv;
  __shared__ int rowsum_q[kGMax];
  __shared__ float wm[kWarps];                 // per-warp partials
  __shared__ double wpart[kWarps];
  __shared__ float wv[kWarps];
  __shared__ float xm[kGMax];                  // exchanged: block max
  __shared__ double xpart[kGMax];              //   fp64 partial sums
  __shared__ int xcorr[kGMax];                 //   zero-point corrections
  __shared__ float xvmax;                      //   largest valid V scale

  const int* qsrc = a.qq + ((size_t)(b * a.KH + kh) * G) * HD;
  for (int i = tid; i < G * HD; i += kThreads) qs[i] = qsrc[i];
  if (tid < kGMax) xcorr[tid] = 0;
  const int qz = static_cast<int>(*a.qz);
  const float q_scale = *a.qscale;
  const int k_pact = __shfl_sync(~0u, live_planes(a.kpact, P), 0);
  const int v_pact = __shfl_sync(~0u, live_planes(a.vpact, P), 0);
  const int pos = __shfl_sync(~0u, *a.pos, 0);
  const int s_lo = a.window > 0 ? max(0, pos - a.window + 1) : 0;
  const int s_hi = min(pos, S - 1);
  const int c0 = rank * a.chunk;
  const int len = max(0, min(a.chunk, S - c0));  // positions of this chunk
  const int v0 = max(c0, s_lo), v1 = min(c0 + len, s_hi + 1);
  const int nvalid = max(0, v1 - v0);            // of them inside the mask
  const size_t plane_stride = (size_t)S * a.KH * D8;
  const size_t rowstride = (size_t)a.KH * D8;
  const size_t head0 = (size_t)b * P * plane_stride + (size_t)kh * D8;

  // the valid positions' v_s and v_z rows (one group) now; every live V
  // plane row (a second group) once the first K rows are requested
  for (int i = tid; i < 2 * nvalid; i += kThreads) {
    const int row = i >= nvalid, s = i - row * nvalid;
    cp_async(vrow + row * cp + (v0 - c0) + s,
             (row ? a.vz : a.vs) + (size_t)b * S + v0 + s, 4);
  }
  cp_async_commit();
  auto copy_v = [&]() {
    copy_v_rows<D8>(vsm + (size_t)(v0 - c0) * RS, cp,
                    a.vpl + head0 + (size_t)v0 * rowstride, plane_stride,
                    rowstride, nvalid, v_pact, tid);
  };

  // the query words and row sums; -1e30 for the chunk's masked positions
  auto prepare = [&]() {
    __syncthreads();
    query_words<D8>(qs, qw, rowsum_q, G, tid);
    for (int i = tid; i < G * len; i += kThreads) {
      const int s = i % len;
      if (c0 + s < v0 || c0 + s >= v1) sc[(i / len) * cp + s] = kNegInf;
    }
    __syncthreads();
  };

  // scores (KSteps) into sc. The first round runs in every warp: its K
  // rows are requested before the V copies are issued and before the
  // query words are built, so their DRAM round trip overlaps both.
  {
    const int n_l = lane >> 2, kq = lane & 3;
    const uint8_t* k0 = a.kpl + head0 + (size_t)v0 * rowstride;
    const float* ks0 = a.ks + (size_t)b * S + v0;
    const float* kz0 = a.kz + (size_t)b * S + v0;
    QueryFrags<D8> qa;
    auto qk_pass = [&](auto np) {
      constexpr int NP = decltype(np)::value;
      for (int st0 = warp, first = 1; first || st0 * 8 < nvalid;
           st0 += kWarps * kSteps) {
        KSteps<NP, D8> k;
        k.load(k0, ks0, kz0, plane_stride, rowstride, st0, nvalid, k_pact,
               n_l, kq);
        if (first) {
          first = 0;
          copy_v();
          prepare();
          query_fragments<D8>(qw, G, n_l, kq, qa);
        }
        k.scores(qa, st0, nvalid, G, qz, rowsum_q, q_scale, a.softcap, n_l,
                 kq, [&](int g, int so, float v) {
                   sc[g * cp + (v0 - c0 + so)] = v;
                 });
      }
    };
    if (k_pact <= 4)
      qk_pass(std::integral_constant<int, 4>{});
    else
      qk_pass(std::integral_constant<int, kPlanes>{});
  }
  for (int i = tid; i < G * HD; i += kThreads) pv[i] = 0;  // qs is read
  cp_async_wait<1>();  // the v_s / v_z rows
  __syncthreads();

  // softmax: warp w takes head g = w / wpg, positions part + wpg * n of
  // each 32. Exchange 1: the blocks' maxima, the largest valid V scale.
  const int g_w = warp / wpg, part = warp - g_w * wpg;
  const bool head_warp = g_w < G;
  {
    float m = kNegInf, vm = 0.0f;
    if (head_warp)
      for (int s = part * 32 + lane; s < len; s += 32 * wpg)
        m = fmaxf(m, sc[g_w * cp + s]);
    for (int s = v0 - c0 + tid; s < v1 - c0; s += kThreads)
      vm = fmaxf(vm, vrow[s]);
    m = warp_max(m);
    vm = warp_max(vm);
    if (lane == 0) {
      wm[warp] = m;
      wv[warp] = vm;
    }
  }
  __syncthreads();
  if (tid < G) {
    float m = kNegInf;
    for (int w = tid * wpg; w < (tid + 1) * wpg; ++w) m = fmaxf(m, wm[w]);
    xm[tid] = m;
  } else if (tid == kGMax) {
    float vm = 0.0f;
    for (int w = 0; w < kWarps; ++w) vm = fmaxf(vm, wv[w]);
    xvmax = vm;
  }
  cluster_barrier(cluster, C);

  // exchange 2: the fp64 partial sums of exp(sc - m), in warp order
  {
    double sum = 0.0;
    if (head_warp) {
      const float m = rank_max(cluster, &xm[g_w], C, kNegInf);
      for (int s = part * 32 + lane; s < len; s += 32 * wpg) {
        const float e = expf(sc[g_w * cp + s] - m);
        sc[g_w * cp + s] = e;
        sum += static_cast<double>(e);
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) wpart[warp] = sum;
  }
  __syncthreads();
  if (tid < G) {
    double sum = 0.0;
    for (int w = tid * wpg; w < (tid + 1) * wpg; ++w) sum += wpart[w];
    xpart[tid] = sum;
  }
  cluster_barrier(cluster, C);

  const float sv_ref = fmaxf(rank_max(cluster, &xvmax, C, 0.0f), 1e-12f);

  // requantize the probabilities in the largest valid V scale; codes
  // <= 2^14 kept as two bytes (lo 7 bits, hi) for the u8 tensor-core PV,
  // 0 outside the mask and past the chunk
  {
    int c = 0;
    if (head_warp) {
      const float denom = static_cast<float>(rank_sum(cluster, &xpart[g_w], C));
      for (int s = part * 32 + lane; s < cp; s += 32 * wpg) {
        int q = 0;
        if (c0 + s >= v0 && c0 + s < v1) {
          q = prob_code(sc[g_w * cp + s], denom, vrow[s], sv_ref);
          c += q * static_cast<int>(rintf(vrow[cp + s]));
        }
        pql[g_w * cp + s] = static_cast<uint8_t>(q & 127);
        pqh[g_w * cp + s] = static_cast<uint8_t>(q >> 7);
      }
    }
    c = warp_sum(c);
    if (head_warp && lane == 0) atomicAdd(&xcorr[g_w], c);
  }
  cp_async_wait<0>();  // the V planes
  __syncthreads();

  // PV (pv_step) over the chunk's 32-row steps: warp w takes byte octet
  // w % n_oct and every wpo-th step. At hd = 160 the three octets (the
  // last one half empty) take two warps each and warps 6 and 7 stay idle.
  {
    constexpr int n_oct = (D8 + 7) / 8;
    constexpr int wpo = kWarps / n_oct;  // warps a byte octet
    const int oct = warp % n_oct, part_w = warp / n_oct;
    const int n_l = lane >> 2, kq = lane & 3, mp = n_l & 3;
    const int wd = 2 * oct + (n_l >> 2);  // the word this lane reads
    int acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2) acc[i][e2] = 0;
    const int lv0 = v0 - c0, lv1 = nvalid > 0 ? v1 - c0 : 0;
    // a warp past an octet's wpo warps takes no step
    const int r_first = part_w < wpo ? (lv0 / 32 + part_w) * 32 : lv1;
    auto pv_pass = [&](auto np) {
      constexpr int NP = decltype(np)::value;
      for (int r0 = r_first; r0 < lv1; r0 += 32 * wpo)
        pv_step<NP, D8>(vsm, pql, pqh, cp, r0, G, n_l, kq, mp, wd, v_pact,
                        acc);
    };
    if (v_pact <= 4)
      pv_pass(std::integral_constant<int, 4>{});
    else
      pv_pass(std::integral_constant<int, kPlanes>{});
    if (r_first < lv1 && n_l < G) add_pv<D8>(pv, acc, oct, n_l, kq);
  }
  cluster_barrier(cluster, C);

  write_output<HD>(cluster, pv, xcorr,
                   a.out + ((size_t)(b * a.KH + kh) * G) * HD, G * HD, rank,
                   C, tid, sv_ref / kProbScale);
  // no block leaves while another may read its partials
  if (C > 1) cluster.sync();
}

// The long path: caches past one cluster's shared memory (S above the
// wrapper's max_seq_len). Grid (kLongC, KH, B) in clusters of kLongC
// blocks; block `rank` takes the chunk [rank * chunk, (rank + 1) * chunk)
// of whole kTile-row tiles (the wrapper's chunk), and no block holds its
// chunk: three passes over its valid positions [v0, v1), each reduced in a
// fixed order, with the cluster kernel's exchanges between them.
//   1. Scores: the cluster kernel's KSteps, written to the global scratch
//      scg (B, KH, G, S) fp32; each lane keeps the maximum of its head's
//      scores, and the block the largest valid V scale. Exchange 1: block
//      maxima through DSMEM.
//   2. exp(sc - m) written back over the scores, fp64 partial sums (warp
//      w: head w / wpg, positions v0 + 32 part + lane, stride 32 wpg; the
//      shuffle tree, the warps of a head, the ranks in rank order).
//      Exchange 2: the partial sums.
//   3. A tile at a time: the tile's live V plane rows copied into shared
//      memory with cp.async while the head warps write the tile's
//      probability codes (prob_code; 0 outside [v0, v1)), then the
//      cluster kernel's pv_step over the tile's 32-row groups that hold
//      valid rows. The int32 accumulators persist across tiles; they meet
//      in shared memory and across ranks as in the cluster kernel.
// Tiles past the window are never visited, so a window costs only the rows
// it keeps. Shared memory: one tile of V rows for P planes and its two code
// bytes a head (61,440 bytes at hd = 256, P = 7).
// The loops whose bounds come from pos stay rolled (#pragma unroll 1), for
// a fault of ptxas (CUDA 12.9, sm_90a): to unroll such a loop, NVVM
// derives its trip count from v1 - s0 - 1 with v1 rebuilt from its parts,
// min(pos, S - 1) + 1 becoming -max(-S, ~pos) in the PTX, and ptxas drops
// that negation when it folds it into a three-way minimum (VIMNMX3). The
// remainder count is then wrong, and the unrolled body, which tests the
// bound only every fourth step, runs up to three steps past v1: the
// largest-V-scale loop read, and the exp loop read and wrote, positions
// of the next block's chunk (wrong outputs on the H100, NaN denominators
// where the scratch held NaN), while the CPU emulation agreed. Rolled, a
// loop tests its bound every step. (The cluster kernel's hd-128 SASS holds
// no VIMNMX3.)
template <int D8>
__global__ void __launch_bounds__(kThreads, 2)
    decode_attention_long_kernel(const Args a, float* scg) {
  constexpr int HD = D8 * 8;
  constexpr int RS = Rows<D8>::kRS;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = __shfl_sync(~0u, static_cast<int>(cluster.num_blocks()), 0);
  const int rank =
      __shfl_sync(~0u, static_cast<int>(cluster.block_rank()), 0);
  const int kh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = __shfl_sync(~0u, tid >> 5, 0);
  const int G = a.G, P = a.P, S = a.S;
  const int wpg = kWarps / G;

  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* vsm = smem;                                  // [P][kTile][RS]
  uint8_t* pql = smem + (size_t)P * kTile * RS;         // [G][kTile]
  uint8_t* pqh = pql + (size_t)G * kTile;
  __shared__ __align__(16) uint32_t qw[kGMax * kHDMax / 4];  // [G][WPR][8]
  __shared__ int qpv[kGMax * kHDMax];  // [G][HD] query codes, then PV partials
  int* qs = qpv;
  int* pv = qpv;
  __shared__ int rowsum_q[kGMax];
  __shared__ float wm[kWarps][kGMax];          // per-warp partials
  __shared__ double wpart[kWarps];
  __shared__ float wv[kWarps];
  __shared__ float xm[kGMax];                  // exchanged: block max
  __shared__ double xpart[kGMax];              //   fp64 partial sums
  __shared__ int xcorr[kGMax];                 //   zero-point corrections
  __shared__ float xvmax;                      //   largest valid V scale

  const int* qsrc = a.qq + ((size_t)(b * a.KH + kh) * G) * HD;
  for (int i = tid; i < G * HD; i += kThreads) qs[i] = qsrc[i];
  if (tid < kGMax) xcorr[tid] = 0;
  const int qz = static_cast<int>(*a.qz);
  const float q_scale = *a.qscale;
  const int k_pact = __shfl_sync(~0u, live_planes(a.kpact, P), 0);
  const int v_pact = __shfl_sync(~0u, live_planes(a.vpact, P), 0);
  const int pos = __shfl_sync(~0u, *a.pos, 0);
  const int s_lo = a.window > 0 ? max(0, pos - a.window + 1) : 0;
  const int s_hi = min(pos, S - 1);
  const int c0 = rank * a.chunk;
  const int v0 = max(c0, s_lo), v1 = min(min(c0 + a.chunk, S), s_hi + 1);
  const int nvalid = max(0, v1 - v0);
  const size_t plane_stride = (size_t)S * a.KH * D8;
  const size_t rowstride = (size_t)a.KH * D8;
  const size_t head0 = (size_t)b * P * plane_stride + (size_t)kh * D8;
  // scg's row of head g of this (batch, kv head)
  float* const sc0 = scg + ((size_t)(b * a.KH + kh) * G) * S;
  __syncthreads();
  query_words<D8>(qs, qw, rowsum_q, G, tid);
  __syncthreads();
  for (int i = tid; i < G * HD; i += kThreads) pv[i] = 0;  // qs is read

  // pass 1: scores into scg, each lane's maximum of head n_l's scores
  const int n_l = lane >> 2, kq = lane & 3;
  float mloc = kNegInf;
  {
    const uint8_t* k0 = a.kpl + head0 + (size_t)v0 * rowstride;
    const float* ks0 = a.ks + (size_t)b * S + v0;
    const float* kz0 = a.kz + (size_t)b * S + v0;
    QueryFrags<D8> qa;
    query_fragments<D8>(qw, G, n_l, kq, qa);
    auto qk_pass = [&](auto np) {
      constexpr int NP = decltype(np)::value;
#pragma unroll 1
      for (int st0 = warp; st0 * 8 < nvalid; st0 += kWarps * kSteps) {
        KSteps<NP, D8> k;
        k.load(k0, ks0, kz0, plane_stride, rowstride, st0, nvalid, k_pact,
               n_l, kq);
        k.scores(qa, st0, nvalid, G, qz, rowsum_q, q_scale, a.softcap, n_l,
                 kq, [&](int g, int so, float v) {
                   sc0[(size_t)g * S + v0 + so] = v;
                   mloc = fmaxf(mloc, v);
                 });
      }
    };
    if (k_pact <= 4)
      qk_pass(std::integral_constant<int, 4>{});
    else
      qk_pass(std::integral_constant<int, kPlanes>{});
  }
  // exchange 1: the block's maxima (lanes 4 g .. 4 g + 3 hold head g) and
  // its largest valid V scale
  {
    mloc = fmaxf(mloc, __shfl_xor_sync(~0u, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(~0u, mloc, 2));
    if (kq == 0 && n_l < G) wm[warp][n_l] = mloc;
    float vm = 0.0f;
#pragma unroll 1
    for (int s = v0 + tid; s < v1; s += kThreads)
      vm = fmaxf(vm, a.vs[(size_t)b * S + s]);
    vm = warp_max(vm);
    if (lane == 0) wv[warp] = vm;
  }
  __syncthreads();
  if (tid < G) {
    float m = kNegInf;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wm[w][tid]);
    xm[tid] = m;
  } else if (tid == kGMax) {
    float vm = 0.0f;
    for (int w = 0; w < kWarps; ++w) vm = fmaxf(vm, wv[w]);
    xvmax = vm;
  }
  cluster_barrier(cluster, C);

  // pass 2: exp(sc - m) over the scores, fp64 partial sums in warp order
  const int g_w = warp / wpg, part = warp - g_w * wpg;
  const bool head_warp = g_w < G;
  float* const scw = sc0 + (size_t)(head_warp ? g_w : 0) * S;
  {
    double sum = 0.0;
    if (head_warp) {
      const float m = rank_max(cluster, &xm[g_w], C, kNegInf);
#pragma unroll 1
      for (int s = v0 + part * 32 + lane; s < v1; s += 32 * wpg) {
        const float e = expf(scw[s] - m);
        scw[s] = e;
        sum += static_cast<double>(e);
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) wpart[warp] = sum;
  }
  __syncthreads();
  if (tid < G) {
    double sum = 0.0;
    for (int w = tid * wpg; w < (tid + 1) * wpg; ++w) sum += wpart[w];
    xpart[tid] = sum;
  }
  cluster_barrier(cluster, C);

  const float sv_ref = fmaxf(rank_max(cluster, &xvmax, C, 0.0f), 1e-12f);
  const float denom =
      head_warp ? static_cast<float>(rank_sum(cluster, &xpart[g_w], C))
                : 1.0f;

  // pass 3: a tile at a time, the probability codes and the exact int32 PV
  constexpr int n_oct = (D8 + 7) / 8;
  constexpr int wpo = kWarps / n_oct;  // warps a byte octet
  const int oct = warp % n_oct, part_w = warp / n_oct;
  const int mp = n_l & 3;
  const int wd = 2 * oct + (n_l >> 2);  // the word this lane reads
  int acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e2 = 0; e2 < 4; ++e2) acc[i][e2] = 0;
  int corr = 0;
  const int t_begin = nvalid > 0 ? v0 / kTile * kTile : v1;
#pragma unroll 1
  for (int t0 = t_begin; t0 < v1; t0 += kTile) {  // block-uniform
    const int a0 = max(t0, v0), a1 = min(t0 + kTile, v1);
    copy_v_rows<D8>(vsm + (size_t)(a0 - t0) * RS, kTile,
                    a.vpl + head0 + (size_t)a0 * rowstride, plane_stride,
                    rowstride, a1 - a0, v_pact, tid);
    if (head_warp) {
#pragma unroll 1
      for (int r = part * 32 + lane; r < kTile; r += 32 * wpg) {
        const int s = t0 + r;
        int q = 0;
        if (s >= a0 && s < a1) {
          q = prob_code(scw[s], denom, a.vs[(size_t)b * S + s], sv_ref);
          corr += q * static_cast<int>(rintf(a.vz[(size_t)b * S + s]));
        }
        pql[g_w * kTile + r] = static_cast<uint8_t>(q & 127);
        pqh[g_w * kTile + r] = static_cast<uint8_t>(q >> 7);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    const int l0 = a0 - t0, l1 = a1 - t0;
    // a warp past an octet's wpo warps takes no step
    const int r_first = part_w < wpo ? (l0 / 32 + part_w) * 32 : l1;
    auto pv_pass = [&](auto np) {
      constexpr int NP = decltype(np)::value;
#pragma unroll 1
      for (int r0 = r_first; r0 < l1; r0 += 32 * wpo)
        pv_step<NP, D8>(vsm, pql, pqh, kTile, r0, G, n_l, kq, mp, wd, v_pact,
                        acc);
    };
    if (v_pact <= 4)
      pv_pass(std::integral_constant<int, 4>{});
    else
      pv_pass(std::integral_constant<int, kPlanes>{});
    __syncthreads();  // the tile's rows and codes are read
  }
  corr = warp_sum(corr);
  if (head_warp && lane == 0) atomicAdd(&xcorr[g_w], corr);
  if (part_w < wpo && nvalid > 0 && n_l < G) add_pv<D8>(pv, acc, oct, n_l, kq);
  cluster_barrier(cluster, C);

  write_output<HD>(cluster, pv, xcorr,
                   a.out + ((size_t)(b * a.KH + kh) * G) * HD, G * HD, rank,
                   C, tid, sv_ref / kProbScale);
  // no block leaves while another may read its partials
  cluster.sync();
}

// The launch of grid (C, KH, B) in clusters of C blocks; given `active`,
// the number of such clusters the card holds at once instead.
template <int D8>
int launch(const Args& a, int B, int C, cudaStream_t stream,
           int* active = nullptr) {
  constexpr int RS = Rows<D8>::kRS;
  const size_t smem = (size_t)a.chunk_pad * (a.P * RS + 6 * a.G + 8);
  if (smem > kDynSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      decode_attention_kernel<D8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, a.KH, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (active != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveClusters(
        active, decode_attention_kernel<D8>, &cfg));
  e = cudaLaunchKernelEx(&cfg, decode_attention_kernel<D8>, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// launch<D8> for HD = 8 * D8
int dispatch(const Args& a, int B, int C, int HD, cudaStream_t st,
             int* active) {
  switch (HD / 8) {
    case 2: return launch<2>(a, B, C, st, active);
    case 4: return launch<4>(a, B, C, st, active);
    case 8: return launch<8>(a, B, C, st, active);
    case 16: return launch<16>(a, B, C, st, active);
    case 20: return launch<20>(a, B, C, st, active);
    case 32: return launch<32>(a, B, C, st, active);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The long path's launch: grid (kLongC, KH, B) in clusters of kLongC
// blocks, one tile of V rows and codes in dynamic shared memory.
template <int D8>
int launch_long(const Args& a, int B, float* scg, cudaStream_t stream) {
  const size_t smem =
      (size_t)kTile * (a.P * Rows<D8>::kRS + 2 * a.G);
  if (smem > kDynSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      decode_attention_long_kernel<D8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kLongC, a.KH, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kLongC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_attention_long_kernel<D8>, a, scg);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_long(const Args& a, int B, int HD, float* scg,
                  cudaStream_t st) {
  switch (HD / 8) {
    case 2: return launch_long<2>(a, B, scg, st);
    case 4: return launch_long<4>(a, B, scg, st);
    case 8: return launch_long<8>(a, B, scg, st);
    case 16: return launch_long<16>(a, B, scg, st);
    case 20: return launch_long<20>(a, B, scg, st);
    case 32: return launch_long<32>(a, B, scg, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Args make_args(int P, int S, int KH, int G, int C, int window,
               float softcap) {
  Args a{};
  a.P = P;
  a.S = S;
  a.KH = KH;
  a.G = G;
  a.chunk = (S + C - 1) / C;
  a.chunk_pad = (a.chunk + 31) / 32 * 32;
  a.window = window;
  a.softcap = softcap;
  return a;
}

bool valid_shape(int P, int S, int G, int C) {
  return C >= 1 && C <= kCMax && G >= 1 && G <= kGMax &&
         P >= 1 && P <= kPlanes && S >= 1;
}

}  // namespace

// q_z, q_scale (f32 scalars), k_pact, v_pact (f32 scalars, or null = all
// planes) and pos (int32) are device pointers. C is the cluster size (1 to
// 8). The wrapper (repro_torch/kernels/pann_attention.py) checks
// shapes, dtypes, contiguity, alignment, hd in {16, 32, 64, 128, 160, 256},
// G <= 8 and the shared-memory bound on S; a refused launch returns its
// CUDA error and the wrapper raises.
extern "C" int decode_attention_launch(
    const int* qq, const float* qz, const float* qscale, const float* kpact,
    const float* vpact, const int* pos, const uint8_t* kpl, const float* ks,
    const float* kz, const uint8_t* vpl, const float* vs, const float* vz,
    float* out, int B, int P, int S, int KH, int G, int HD, int C,
    int window, float softcap, void* stream) {
  if (!valid_shape(P, S, G, C)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(P, S, KH, G, C, window, softcap);
  a.qq = qq;
  a.qz = qz;
  a.qscale = qscale;
  a.kpact = kpact;
  a.vpact = vpact;
  a.pos = pos;
  a.kpl = kpl;
  a.ks = ks;
  a.kz = kz;
  a.vpl = vpl;
  a.vs = vs;
  a.vz = vz;
  a.out = out;
  return dispatch(a, B, C, HD, static_cast<cudaStream_t>(stream), nullptr);
}

// How many clusters of C blocks of this launch the card holds at once
// (cudaOccupancyMaxActiveClusters), into *active; the wrapper picks C so
// that its B * KH clusters take as few waves as it can.
extern "C" int decode_attention_max_clusters(int P, int S, int KH, int G,
                                             int HD, int C, int* active) {
  if (!valid_shape(P, S, G, C)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(make_args(P, S, KH, G, C, -1, 0.0f), 1, C, HD, nullptr,
                  active);
}

// The long path (S past one cluster's shared memory): arguments as
// decode_attention_launch, plus `chunk` (positions a block walks, whole
// kTile-row tiles; the wrapper's long_chunk) and the (B, KH, G, S) fp32
// scratch the scores and their exps pass through.
extern "C" int decode_attention_long_launch(
    const int* qq, const float* qz, const float* qscale, const float* kpact,
    const float* vpact, const int* pos, const uint8_t* kpl, const float* ks,
    const float* kz, const uint8_t* vpl, const float* vs, const float* vz,
    float* out, float* scratch, int B, int P, int S, int KH, int G, int HD,
    int chunk, int window, float softcap, void* stream) {
  if (!valid_shape(P, S, G, kLongC) || chunk < kTile || chunk % kTile ||
      (size_t)chunk * kLongC < (size_t)S)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(P, S, KH, G, kLongC, window, softcap);
  a.chunk = chunk;
  a.chunk_pad = chunk;
  a.qq = qq;
  a.qz = qz;
  a.qscale = qscale;
  a.kpact = kpact;
  a.vpact = vpact;
  a.pos = pos;
  a.kpl = kpl;
  a.ks = ks;
  a.kz = kz;
  a.vpl = vpl;
  a.vs = vs;
  a.vz = vz;
  a.out = out;
  return dispatch_long(a, B, HD, scratch, static_cast<cudaStream_t>(stream));
}
