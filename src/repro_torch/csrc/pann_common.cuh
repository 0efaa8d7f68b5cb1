// Shared pieces of the integer kernels (pann_matmul.cu,
// pann_matmul_packed.cu, unsigned_matmul.cu, and the cluster exchanges of
// pann_attention.cu and quantize_act.cu): the row sources (fp32
// activations encoded in the kernel, or int8 codes loaded as they are), the
// streaming decode blocks of the matmuls (M <= kDecodeRows: weight loads
// that skip L1, byte arithmetic, and the split-K sum and epilogue folded
// into the same launch), the split-K epilogue kernel of the tile launches,
// and the thread block cluster's barrier and shared-memory gather. Above
// kDecodeRows rows every matmul runs on the int8 tensor cores
// (pann_tc.cuh).
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pann {

constexpr int kThreads = 128;   // threads per block of the decode kernels
constexpr int kCols = 4;        // output columns per thread (one 32-bit load)
constexpr int kDecodeRows = 8;  // M above this takes the tile kernels

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

// ---------------------------------------------------------------------------
// Streaming decode blocks of the integer matmuls at M <= kDecodeRows: B1/B4
// (unpacked planes, pann_matmul.cu), B2/B5 (packed planes,
// pann_matmul_packed.cu) and B6 (the signed int8 weight, unsigned_matmul.cu).
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
// s_stride is 0 for a per-tensor scale and 1 for per-row scales. In the
// accumulator mode (sums set; y, gamma and zcol unused) the finishing block
// stores the int32 sum itself and applies no epilogue: a row-parallel
// projection adds the sums of its K shards across ranks first, then runs
// the epilogue entry (pann_matmul.cu) on the whole sum.
struct Finish {
  int* acc;
  int* tickets;
  const float* s;
  int s_stride;
  const float* gamma;
  const int* zcol;
  float* y;
  int ksplit;
  int* sums = nullptr;

  __device__ float value(int sum, int m, int n) const {
    if (zcol != nullptr) sum -= zcol[n];
    return __fmul_rn(__fmul_rn(static_cast<float>(sum), s[m * s_stride]),
                     gamma[n]);
  }

  __device__ void store(size_t at, int sum, int m, int n) const {
    if (sums != nullptr)
      sums[at] = sum;
    else
      y[at] = value(sum, m, n);
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
        f.store((size_t)(m0 + m) * N + n_blk + c, red[i], m0 + m, n_blk + c);
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
      f.store(at, atomicExch(&f.acc[at], 0), m0 + m, n_blk + c);
    }
  }
  if (threadIdx.x == 0) f.tickets[tile] = 0;
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

// sums = sum_k partial[k]: the accumulator mode's end of a tile launch (the
// split sums of pann_tc.cuh added, no epilogue). Integer sums, so the order
// of the splits cannot change them.
__global__ void sum_splits_kernel(const int* __restrict__ partial,
                                  int* __restrict__ sums, size_t mn,
                                  int ksplit) {
  size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  int acc = 0;
  for (int k = 0; k < ksplit; ++k) acc += partial[(size_t)k * mn + idx];
  sums[idx] = acc;
}

inline int launch_sum_splits(const int* partial, int* sums, int M, int N,
                             int ksplit, cudaStream_t stream) {
  size_t mn = (size_t)M * N;
  int threads = 256;
  unsigned blocks = static_cast<unsigned>((mn + threads - 1) / threads);
  sum_splits_kernel<<<blocks, threads, 0, stream>>>(partial, sums, mn,
                                                    ksplit);
  return static_cast<int>(cudaGetLastError());
}

// The end of a tile launch (M > kDecodeRows): the epilogue kernel, or in
// the accumulator mode the split sums alone.
inline int finish_tiles(const Finish& fin, const int* partial, int M, int N,
                        int ksplit, cudaStream_t stream) {
  if (fin.sums != nullptr)
    return launch_sum_splits(partial, fin.sums, M, N, ksplit, stream);
  return launch_epilogue(partial, nullptr, fin.s, fin.s_stride, fin.gamma,
                         fin.zcol, fin.y, M, N, ksplit, stream);
}

// ---------------------------------------------------------------------------
// Thread block clusters (B3 in pann_attention.cu, B7 in quantize_act.cu).

// The cluster barrier; a one-block cluster needs only the block's.
__device__ __forceinline__ void cluster_barrier(
    const cooperative_groups::cluster_group& cl, int C) {
  if (C == 1)
    __syncthreads();
  else
    cl.sync();
}

// The value at `local`'s place in the shared memory of each of the C
// blocks of the cluster, in rank order; the loads are issued together.
template <class T, int N>
__device__ __forceinline__ void gather(
    const cooperative_groups::cluster_group& cluster, T* local, int C,
    T (&v)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r)
    v[r] = r < C ? *cluster.map_shared_rank(local, r) : T(0);
}

}  // namespace pann
