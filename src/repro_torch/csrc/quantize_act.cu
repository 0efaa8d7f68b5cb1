// Per-row unsigned activation quantization (the paper's App. A.4 half
// range), for Hopper (sm_90a). Replaces repro/kernels/quantize_act.py::
// quantize_act (_quantize_kernel):
//
//   scale[m] = max(amax(relu x[m, :]), 1e-12) / qmax       qmax = 2^(b-1) - 1
//   q[m, k]  = clip(rint(relu(x[m, k]) / scale[m]), 0, qmax)   as int8
//
// x is (M, K) fp32 or bf16 (bf16 -> fp32 is exact: the bf16 bits are the
// top half of the fp32's). The scale is an IEEE division by qmax, as in the
// oracle repro.kernels.ref.quantize_act_ref (the jitted TPU kernel lets XLA
// turn it into a multiply by 1/qmax, one ulp off in many rows); the codes
// are an IEEE division and rintf (round half to even, as jnp.round), no
// --use_fast_math and no multiply by a reciprocal.
//
// What bounds it on this card: bytes (4 or 2 read and 1 written an element,
// a handful of operations) at a prefill's M, the latency of one round trip
// to memory and one launch at a decode batch's. The TPU kernel holds a
// block of whole rows in VMEM; here a row is split over a thread block
// cluster of C = 1..8 blocks of 256 threads. The wrapper picks C and V, the
// 16-byte vectors a thread holds, from M and K (cluster_plan: M * C blocks
// cover the SMs about once, C = 1 where M alone fills the card; V <= 4
// while 8 blocks of 4 cover a row, so a block keeps few registers and many
// fit a SM), and each block:
//   1. loads its chunk of the row once, into registers: V 16-byte loads a
//      thread past L1 (ld.global.nc, 4 fp32 or 8 bf16 elements each),
//      issued together, consecutive threads on consecutive vectors. The
//      row's vectors start at its first 16-byte aligned element; the few
//      elements before it (the head) and after its last whole vector (the
//      tail), fewer than one vector each, are scalar loads by rank 0;
//   2. reduces the chunk's max with warp shuffles and one shared-memory
//      step (max is exact in any order; 0 is its identity, since
//      max(relu x) >= 0);
//   3. exchanges the blocks' maxima through distributed shared memory (a
//      cluster barrier, then every thread reads the C maxima: pann_common's
//      cluster_barrier and gather, which B3 uses too);
//   4. forms the same amax in every block and the same s = fmaxf(amax,
//      1e-12f) / qm;
//   5. encodes its chunk from the registers with rintf(v / s);
//   6. stores 4 codes (fp32) or 8 (bf16) a 16-byte vector in one 32- or
//      64-bit store, so a warp writes 128 or 256 contiguous bytes a store;
//      rank 0 writes the scale.
// x is read once. A block leaves the cluster only after every block has
// read its maximum (a barrier arrive after the reads, its wait at the
// end). Triton has no exchange through shared memory between blocks; a
// Triton version would take two launches or atomics.
//
// Tried on the H100 and not kept: clusters that loop over rows, with or
// without the next row's loads in flight, gained a few per cent on one
// launch of the pass and nothing on the others. A build without the IEEE
// division showed it to be the largest single part of an M = 512 launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pann_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;

// Elements of kEsz bytes (4: fp32, 2: bf16) as fp32.
template <int kEsz>
struct Elems {
  static constexpr int kVec = 16 / kEsz;  // elements a 16-byte vector

  __device__ static float scalar(const char* row, int e) {
    if constexpr (kEsz == 4)
      return reinterpret_cast<const float*>(row)[e];
    else
      return __uint_as_float(
          static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(row)[e])
          << 16);
  }
  __device__ static float at(const uint4& v, int i) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    if constexpr (kEsz == 4)
      return __uint_as_float(w[i]);
    else
      return __uint_as_float((i & 1) ? (w[i / 2] & 0xFFFF0000u)
                                     : (w[i / 2] << 16));
  }
};

// A 16-byte load of bytes read once: through the read-only path, not kept
// in L1.
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t encode(float x, float s, float qm) {
  const float v = fmaxf(x, 0.0f);
  return static_cast<uint32_t>(
      static_cast<int>(fminf(fmaxf(rintf(v / s), 0.0f), qm)));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

template <int kEsz, int V>
__global__ void __launch_bounds__(kThreads)
    quantize_act_kernel(const char* __restrict__ x, int8_t* __restrict__ q,
                        float* __restrict__ scale, int K, int qmax) {
  using E = Elems<kEsz>;
  constexpr int kVec = E::kVec;
  __shared__ float red[kWarps];
  __shared__ float block_max;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = __shfl_sync(~0u, static_cast<int>(cluster.num_blocks()), 0);
  const int rank =
      __shfl_sync(~0u, static_cast<int>(cluster.block_rank()), 0);
  const size_t row = blockIdx.x / C;
  const char* xr = x + row * K * kEsz;
  int8_t* qr = q + row * K;
  // the row's vectors start at element h, its first 16-byte aligned one
  const int head = static_cast<int>(
      ((16 - reinterpret_cast<uintptr_t>(xr) % 16) % 16) / kEsz);
  const int h = min(K, head);
  const int nv = (K - h) / kVec;
  const int tail = K - h - nv * kVec;
  const int g0 = rank * kThreads * V + threadIdx.x;

  uint4 v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int g = g0 + i * kThreads;
    if (g < nv) v[i] = ld_stream16(xr + (size_t)(h + g * kVec) * kEsz);
  }
  // one scalar element: rank 0's threads t < h take head element t,
  // threads 32 <= t < 32 + tail the tail's
  int e1 = -1;
  if (rank == 0) {
    if (threadIdx.x < h)
      e1 = threadIdx.x;
    else if (threadIdx.x >= 32 && threadIdx.x < 32 + tail)
      e1 = h + nv * kVec + threadIdx.x - 32;
  }
  const float x1 = e1 >= 0 ? E::scalar(xr, e1) : 0.0f;

  float amax = fmaxf(x1, 0.0f);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (g0 + i * kThreads < nv) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) amax = fmaxf(amax, E::at(v[i], j));
    }
  }
  amax = warp_max(amax);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) b = fmaxf(b, red[w]);
    block_max = b;
  }
  pann::cluster_barrier(cluster, C);
  float maxima[kMaxCluster];
  pann::gather(cluster, &block_max, C, maxima);
  amax = maxima[0];
#pragma unroll
  for (int r = 1; r < kMaxCluster; ++r)
    if (r < C) amax = fmaxf(amax, maxima[r]);
  if (C > 1) asm volatile("barrier.cluster.arrive;" ::: "memory");

  const float qm = static_cast<float>(qmax);
  const float s = fmaxf(amax, 1e-12f) / qm;
  if (rank == 0 && threadIdx.x == 0) scale[row] = s;
  // vector g's codes go to qr + h + g kVec, 4- (fp32) or 8-byte (bf16)
  // aligned when x and q are 16-byte aligned
  const bool aligned = reinterpret_cast<uintptr_t>(qr + h) % kVec == 0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int g = g0 + i * kThreads;
    if (g >= nv) continue;
    uint32_t c[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) c[j] = encode(E::at(v[i], j), s, qm);
    int8_t* dst = qr + h + g * kVec;
    if (aligned) {
      if constexpr (kVec == 4) {
        *reinterpret_cast<uint32_t*>(dst) =
            c[0] | c[1] << 8 | c[2] << 16 | c[3] << 24;
      } else {
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(c[0] | c[1] << 8 | c[2] << 16 | c[3] << 24,
                       c[4] | c[5] << 8 | c[6] << 16 | c[7] << 24);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[j] = static_cast<int8_t>(c[j]);
    }
  }
  if (e1 >= 0) qr[e1] = static_cast<int8_t>(encode(x1, s, qm));
  if (C > 1) asm volatile("barrier.cluster.wait;" ::: "memory");
}

template <int kEsz, int V>
int launch(const void* x, int8_t* q, float* scale, int M, int K, int qmax,
           int C, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(M) * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, quantize_act_kernel<kEsz, V>,
                                     static_cast<const char*>(x), q, scale,
                                     K, qmax);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int kEsz>
int dispatch(const void* x, int8_t* q, float* scale, int M, int K, int qmax,
             int C, int V, cudaStream_t st) {
  switch (V) {
    case 1: return launch<kEsz, 1>(x, q, scale, M, K, qmax, C, st);
    case 2: return launch<kEsz, 2>(x, q, scale, M, K, qmax, C, st);
    case 4: return launch<kEsz, 4>(x, q, scale, M, K, qmax, C, st);
    case 8: return launch<kEsz, 8>(x, q, scale, M, K, qmax, C, st);
    case 16: return launch<kEsz, 16>(x, q, scale, M, K, qmax, C, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The wrapper (repro_torch/kernels/quantize_act.py) checks shape, dtype and
// contiguity, allocates q (M, K) int8 and scale (M, 1) f32, and picks the
// cluster size C (1..8) and the vectors a thread holds V (1, 2, 4, 8 or
// 16) so that C * 256 * V vectors cover a row (cluster_plan). Returns
// cudaGetLastError() after the launch.
extern "C" int quantize_act_launch(const void* x, int is_bf16, int8_t* q,
                                   float* scale, int M, int K, int qmax,
                                   int C, int V, void* stream) {
  if (C < 1 || C > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<2>(x, q, scale, M, K, qmax, C, V, st)
                 : dispatch<4>(x, q, scale, M, K, qmax, C, V, st);
}
