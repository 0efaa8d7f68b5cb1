// Shared pieces of the integer matmul kernels (pann_matmul.cu,
// pann_matmul_packed.cu, unsigned_matmul.cu): the row sources (fp32
// activations encoded in the kernel, or int8 codes loaded as they are), the
// decode batch's code panel, the streaming decode blocks of the bit-plane
// matmuls (M <= kDecodeRows: plane loads that skip L1, byte arithmetic, and
// the split-K sum and epilogue folded into the same launch), the 64 x 128
// CUDA-core output tile of the packed and unsigned kernels above
// kDecodeRows rows, and the split-K epilogue kernel of the launches that
// keep two kernels. Above kDecodeRows rows the unpacked-plane kernels (B1,
// B4) run on the int8 tensor cores instead (pann_tc.cuh).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace pann {

constexpr int kThreads = 128;   // threads per block of the decode kernels
constexpr int kCols = 4;        // output columns per thread (one 32-bit load)
constexpr int kDecodeRows = 8;  // M above this takes the tile kernels

// CUDA-core tile kernels (B5 pann_matmul_packed, B6 unsigned_matmul): a
// block computes kTileM x kTileN outputs, stepping K by kTileK; each of its
// threads owns an 8 x 4 sub-tile, one int32 multiply-add per weight and row. At M = 512 a weight
// tile in shared memory serves 64 rows, where the decode kernels (4 or 8
// rows a block) would read every plane 64 times.
constexpr int kTileM = 64, kTileN = 128, kTileK = 32;
constexpr int kTileWords = kTileN / kCols;                 // 32
constexpr int kTileThreads = (kTileM / 8) * kTileWords;    // 256

// q = clip(rint(x / s) + z, 0, n): op for op repro.core.quant.affine_encode.
// IEEE division (no --use_fast_math) and rintf (round half to even).
__device__ __forceinline__ int8_t encode(float x, float s, float z, float n) {
  float q = rintf(x / s) + z;
  q = fminf(fmaxf(q, 0.0f), n);
  return static_cast<int8_t>(static_cast<int>(q));
}

__device__ __forceinline__ int live_shift(const float* qp, int P) {
  int shift = static_cast<int>(rintf(qp[3]));
  return shift < 0 ? 0 : (shift > P ? P : shift);
}

// Row sources: a kernel reads the activation code q[m, k] through reader(),
// made once per block on the device, and its first live plane from shift().
struct FloatRows {  // fp32 x, encoded in the kernel; qp = [s, z, n, shift]
  const float* x;
  const float* qp;
  int K;
  struct Reader {
    const float* x;
    int K;
    float s, z, n;
    __device__ int8_t operator()(int m, int k) const {
      return encode(x[(size_t)m * K + k], s, z, n);
    }
  };
  __device__ Reader reader() const { return {x, K, qp[0], qp[1], qp[2]}; }
  __device__ int shift(int P) const { return live_shift(qp, P); }
};

struct CodeRows {  // int8 codes x_q; every plane is live
  const int8_t* xq;
  int K;
  __device__ CodeRows reader() const { return *this; }
  __device__ int8_t operator()(int m, int k) const {
    return xq[(size_t)m * K + k];
  }
  __device__ int shift(int) const { return 0; }
};

// unsigned_matmul.cu's decode kernel: rows [m0, m0 + MT) x columns [k0, k0 +
// kc) of the codes into the block's shared panel codes[MT][kchunk]; rows
// past M are 0.
template <int MT, class Rd>
__device__ __forceinline__ void load_panel(const Rd& rd, int8_t* codes, int M,
                                           int m0, int k0, int kc,
                                           int kchunk) {
  for (int i = threadIdx.x; i < MT * kc; i += blockDim.x) {
    int mm = i / kc, kk = i - mm * kc;
    int m = m0 + mm;
    codes[mm * kchunk + kk] = m < M ? rd(m, k0 + kk) : int8_t(0);
  }
}

// ---------------------------------------------------------------------------
// Streaming decode blocks of the bit-plane matmuls (B1/B4 in pann_matmul.cu,
// B2/B5 in pann_matmul_packed.cu) at M <= kDecodeRows.
//
// A block is kStreamWarps warps over kStreamCols adjacent columns: lane l
// owns columns n_blk + 4l .. + 3, so each warp load of a plane row is one
// coalesced 128-byte request. The warps of a block take the K steps of the
// block's chunk in turn (warp w: steps w, w + 8, ...), so all eight stream
// planes at once; their sums meet in shared memory at the end.
constexpr int kStreamWarps = 8;
constexpr int kStreamThreads = 32 * kStreamWarps;
constexpr int kStreamCols = 32 * kCols;
constexpr int kMaxPlanes = 7;

// A 32-bit load of plane bytes that are read once: through the read-only
// path, not kept in L1.
__device__ __forceinline__ uint32_t ld_stream(const void* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// a - b per byte, modulo 256, for bytes a, b in [0, 127]: adding 128 to
// each byte of a first keeps every byte difference in [1, 255], so no
// borrow crosses a byte; the xor takes the 128 off again. The result is the
// int8 two's complement of a - b in each byte.
__device__ __forceinline__ uint32_t sub_bytes(uint32_t a, uint32_t b) {
  return ((a | 0x80808080u) - b) ^ 0x80808080u;
}

// Exchange bit j of each byte of a with bit j + S of the same byte of b,
// for the bits j that Mask selects (one swap stage of the bit transpose).
template <int S, uint32_t Mask>
__device__ __forceinline__ void swap_bits(uint32_t& a, uint32_t& b) {
  const uint32_t na = (a & ~(Mask << S)) | ((b << S) & (Mask << S));
  const uint32_t nb = (b & ~Mask) | ((a >> S) & Mask);
  a = na;
  b = nb;
}

// In each byte lane, bit j of w[p] -> bit p of w[j] (w[7] enters as 0).
__device__ __forceinline__ void transpose_bits(uint32_t (&w)[8]) {
#pragma unroll
  for (int p = 0; p < 4; ++p) swap_bits<4, 0x0F0F0F0Fu>(w[p], w[p + 4]);
#pragma unroll
  for (int p = 0; p < 8; p += 4) {
    swap_bits<2, 0x33333333u>(w[p], w[p + 2]);
    swap_bits<2, 0x33333333u>(w[p + 1], w[p + 3]);
  }
#pragma unroll
  for (int p = 0; p < 8; p += 2) swap_bits<1, 0x55555555u>(w[p], w[p + 1]);
}

// 4 rows x 4 columns of bytes (a_i = row i) -> 4 columns x 4 rows (c_j =
// column j, byte i = row i).
__device__ __forceinline__ void transpose4(uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3,
                                           uint32_t* c) {
  const uint32_t t0 = __byte_perm(a0, a1, 0x5140);
  const uint32_t t1 = __byte_perm(a0, a1, 0x7362);
  const uint32_t t2 = __byte_perm(a2, a3, 0x5140);
  const uint32_t t3 = __byte_perm(a2, a3, 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// Rows [m0, m0 + MT) x columns [k0, k0 + kw) of the codes into the block's
// shared panel codes[MT][kchunk] (kw <= kchunk); rows past M and columns
// past kc are 0, so a K step that runs past the chunk adds nothing.
template <int MT, class Rd>
__device__ __forceinline__ void load_stream_panel(const Rd& rd, int8_t* codes,
                                                  int M, int m0, int k0,
                                                  int kc, int kw,
                                                  int kchunk) {
  for (int i = threadIdx.x; i < MT * kw; i += blockDim.x) {
    const int mm = i / kw, kk = i - mm * kw;
    const int m = m0 + mm;
    codes[mm * kchunk + kk] = (m < M && kk < kc) ? rd(m, k0 + kk) : int8_t(0);
  }
}

// The end of a decode block, in the same launch as its product. acc is an
// M x N int32 buffer and tickets one int per column tile, both 0 between
// calls (the wrapper allocates them zeroed, once per device and stream).
// With ksplit > 1 every block adds its sums into acc (integer atomics: the
// order cannot change the sum), then takes a ticket; the block that draws
// the last one reads the sums back with atomicExch(.., 0), which leaves acc
// 0 again, resets the ticket and writes y. y = ((sum - zcol) * s) * gamma
// with __fmul_rn, in the reference's association; zcol may be null, and
// s_stride is 0 for a per-tensor scale and 1 for per-row scales.
struct Finish {
  int* acc;
  int* tickets;
  const float* s;
  int s_stride;
  const float* gamma;
  const int* zcol;
  float* y;
  int ksplit;

  __device__ float value(int sum, int m, int n) const {
    if (zcol != nullptr) sum -= zcol[n];
    return __fmul_rn(__fmul_rn(static_cast<float>(sum), s[m * s_stride]),
                     gamma[n]);
  }
};

// red: the block's MT x kStreamCols shared sums, 0 on entry; a lane's sums
// acc[m][c] are column n_blk + 4 lane + c. Every thread adds its sums, then
// the block finishes as Finish says. Call from every thread of the block.
template <int MT>
__device__ __forceinline__ void finish_block(const Finish& f, int* red,
                                             const int (&acc)[MT][kCols],
                                             int M, int N, int m0,
                                             int n_blk) {
  constexpr int kBN = kStreamCols;
  const int n = kCols * (threadIdx.x % 32);
  if (n_blk + n < N) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        atomicAdd(&red[m * kBN + n + c], acc[m][c]);
  }
  __syncthreads();
  const int rows = min(MT, M - m0);
  const int cols = min(kBN, N - n_blk);
  if (f.ksplit == 1) {
    for (int i = threadIdx.x; i < rows * kBN; i += blockDim.x) {
      const int m = i / kBN, c = i - m * kBN;
      if (c < cols)
        f.y[(size_t)(m0 + m) * N + n_blk + c] =
            f.value(red[i], m0 + m, n_blk + c);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * kBN; i += blockDim.x) {
    const int m = i / kBN, c = i - m * kBN;
    if (c < cols) atomicAdd(&f.acc[(size_t)(m0 + m) * N + n_blk + c], red[i]);
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0)
    last = atomicAdd(&f.tickets[tile], 1) == f.ksplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < rows * kBN; i += blockDim.x) {
    const int m = i / kBN, c = i - m * kBN;
    if (c < cols) {
      const size_t at = (size_t)(m0 + m) * N + n_blk + c;
      f.y[at] = f.value(atomicExch(&f.acc[at], 0), m0 + m, n_blk + c);
    }
  }
  if (threadIdx.x == 0) f.tickets[tile] = 0;
}

// Store a thread's MT x 4 int32 partial sums for split ky.
template <int MT>
__device__ __forceinline__ void store_partial(int* __restrict__ partial,
                                              const int (&acc)[MT][kCols],
                                              int M, int N, int m0, int n0,
                                              int ky) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m0 + m < M) {
      int4 v = make_int4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      *reinterpret_cast<int4*>(partial + ((size_t)ky * M + m0 + m) * N + n0) =
          v;
    }
  }
}

// Tile kernels: the block's kTileM x kTileK codes at rows m0.., columns
// kb.. into shared memory as int32, so that one 16-byte load gives a thread
// 4 k of a row. Rows past M and columns past kend are 0, so weights read
// there (rows of the next split) add nothing.
template <class Rd>
__device__ __forceinline__ void load_code_tile(const Rd& rd,
                                               int (*codes)[kTileK], int M,
                                               int m0, int kb, int kend) {
  for (int i = threadIdx.x; i < kTileM * kTileK; i += blockDim.x) {
    int mm = i / kTileK, kk = i - mm * kTileK;
    int m = m0 + mm, k = kb + kk;
    codes[mm][kk] = (m < M && k < kend) ? static_cast<int>(rd(m, k)) : 0;
  }
}

// Fill the kTileK x kTileN weight tile(s) at rows kb.., columns n_blk.. in
// shared memory. ``get(k, n0, a, b)`` gives the weights of rows k..k+7 and
// columns n0..n0+3 (b only when kTwo); it is called for k < K and n0 < N
// only, and the rest of the tile is 0.
template <bool kTwo, class Get>
__device__ __forceinline__ void fill_tile(int4 (*wa)[kTileWords],
                                          int4 (*wb)[kTileWords], int kb,
                                          int n_blk, int K, int N, Get get) {
  for (int i = threadIdx.x; i < (kTileK / 8) * kTileWords; i += blockDim.x) {
    const int g = i / kTileWords, c4 = i - g * kTileWords;
    const int k = kb + 8 * g, n0 = n_blk + c4 * kCols;
    int a[8][kCols] = {}, b[8][kCols] = {};
    if (k < K && n0 < N) get(k, n0, a, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      wa[8 * g + j][c4] = make_int4(a[j][0], a[j][1], a[j][2], a[j][3]);
      if constexpr (kTwo)
        wb[8 * g + j][c4] = make_int4(b[j][0], b[j][1], b[j][2], b[j][3]);
    }
  }
}

// acc[i][c] += sum_kk codes[r0 + i][kk] * w[kk][cw].c over one K step. A
// warp shares r0 (its code loads are broadcasts) and reads 32 adjacent
// int4 weight words.
__device__ __forceinline__ void tile_mac(int (*codes)[kTileK],
                                         int4 (*w)[kTileWords], int r0,
                                         int cw, int (&acc)[8][kCols]) {
#pragma unroll 2
  for (int kk = 0; kk < kTileK; kk += 4) {
    int4 q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      q[i] = *reinterpret_cast<int4*>(&codes[r0 + i][kk]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int4 wv = w[kk + j][cw];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qv = j == 0 ? q[i].x : j == 1 ? q[i].y : j == 2 ? q[i].z
                                                                  : q[i].w;
        acc[i][0] += qv * wv.x;
        acc[i][1] += qv * wv.y;
        acc[i][2] += qv * wv.z;
        acc[i][3] += qv * wv.w;
      }
    }
  }
}

// The bit-plane product on a 64 x 128 tile, for M > kDecodeRows (B5): W
// gives W::P and W::rebuild8 (w = sum_{p >= shift} 2^p (pos_p - neg_p) of 8
// rows x 4 columns); the weight tile is rebuilt once and multiplied once,
// exact in int32.
template <class Src, class W>
__global__ void __launch_bounds__(kTileThreads)
    pann_tile_kernel(Src src, W wts, int* __restrict__ partial, int M, int K,
                     int N, int kchunk) {
  __shared__ __align__(16) int codes[kTileM][kTileK];
  __shared__ int4 wa[kTileK][kTileWords];
  const auto rd = src.reader();
  const int shift = src.shift(wts.P);
  const int m0 = blockIdx.z * kTileM, n_blk = blockIdx.x * kTileN;
  const int k0 = blockIdx.y * kchunk, kend = min(k0 + kchunk, K);
  const int r0 = (threadIdx.x / kTileWords) * 8;
  const int cw = threadIdx.x % kTileWords;
  int acc[8][kCols] = {};
  for (int kb = k0; kb < kend; kb += kTileK) {
    load_code_tile(rd, codes, M, m0, kb, kend);
    fill_tile<false>(wa, wa, kb, n_blk, K, N,
                     [&](int k, int n0, int (&a)[8][kCols],
                         int (&)[8][kCols]) { wts.rebuild8(k, n0, shift, a); });
    __syncthreads();
    tile_mac(codes, wa, r0, cw, acc);
    __syncthreads();
  }
  if (n_blk + cw * kCols < N)
    store_partial<8>(partial, acc, M, N, m0 + r0, n_blk + cw * kCols,
                     blockIdx.y);
}

// y = ((sum_k partial - sum_k partial_neg - zcol) * s[m * s_stride]) * gamma
// in the reference's association; partial_neg and zcol may be null, and
// s_stride is 0 for a per-tensor scale (B1/B2's qparams[0]) and 1 for
// per-row scales. The split sums are integers, so their order cannot change
// the result.
__global__ void epilogue_kernel(const int* __restrict__ partial,
                                const int* __restrict__ partial_neg,
                                const float* __restrict__ s, int s_stride,
                                const float* __restrict__ gamma,
                                const int* __restrict__ zcol,
                                float* __restrict__ y, int M, int N,
                                int ksplit) {
  size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t mn = (size_t)M * N;
  if (idx >= mn) return;
  int n = static_cast<int>(idx % N);
  int m = static_cast<int>(idx / N);
  int acc = 0;
  for (int k = 0; k < ksplit; ++k) acc += partial[(size_t)k * mn + idx];
  if (partial_neg != nullptr) {
    int neg = 0;
    for (int k = 0; k < ksplit; ++k) neg += partial_neg[(size_t)k * mn + idx];
    acc -= neg;  // the one Eq.-6 subtraction
  }
  if (zcol != nullptr) acc -= zcol[n];
  y[idx] = __fmul_rn(__fmul_rn(static_cast<float>(acc), s[m * s_stride]),
                     gamma[n]);
}

inline int launch_epilogue(const int* partial, const int* partial_neg,
                           const float* s, int s_stride, const float* gamma,
                           const int* zcol, float* y, int M, int N,
                           int ksplit, cudaStream_t stream) {
  size_t mn = (size_t)M * N;
  int threads = 256;
  unsigned blocks = static_cast<unsigned>((mn + threads - 1) / threads);
  epilogue_kernel<<<blocks, threads, 0, stream>>>(
      partial, partial_neg, s, s_stride, gamma, zcol, y, M, N, ksplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pann
