// One-token GQA decode attention read directly off the packed bit-plane KV
// cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pann_attention.py::decode_attention
// (_decode_attention_kernel). One block per (batch, kv head), as the TPU
// grid has one cell per (batch, kv head):
//   * exact int32 QK^T on the unpacked K codes, both zero points corrected
//     in the accumulator: (qq - z_q).(kq - z_k);
//   * the fp32 epilogue of repro_torch/kernels/ref.py::decode_attention_ref
//     — score scale, optional tanh softcap, causal/window mask, softmax —
//     with every product rounded by __fmul_rn;
//   * probabilities rescaled into the largest valid V scale and requantized
//     at 2^14, then exact int32 PV with the V zero point subtracted.
//
// What bounds it on this card: bytes (each cached position is read once per
// token, P_live/8 bytes per code) and, at decode batch sizes, launch and
// latency. The TPU kernel holds two (S, hd) int32 code panels in VMEM
// (2 MiB each at S = 4096); 227 KB of shared memory cannot. So K and V are
// streamed from device memory position by position and unpacked in
// registers, and only the (G, S) fp32 scores stay in shared memory (64 KB
// at G = 4, S = 4096); the wrapper states the largest S it takes. Only the
// live low planes (k_pact / v_pact, device scalars derived from the rung's
// cache level counts) and only positions inside the causal/window mask are
// read: masked positions score -1e30 and get probability 0 exactly, as in
// the plain version. The softmax denominator is summed in fp64 and rounded
// once to fp32; the plain version does the same, so the two agree although
// they add in different orders.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGMax = 8;          // query heads per kv head
constexpr float kNegInf = -1e30f;
constexpr float kProbScale = 16384.0f;

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

// Block-wide reductions; every thread gets the result. The leading barrier
// keeps a previous reduction's readers off the scratch slots.
__device__ float block_max(float v, float* scratch) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, scratch[w]);
  return r;
}
__device__ double block_sum(double v, double* scratch) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  double r = scratch[0];
  for (int w = 1; w < kWarps; ++w) r += scratch[w];
  return r;
}
__device__ int block_sum(int v, int* scratch) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = scratch[0];
  for (int w = 1; w < kWarps; ++w) r += scratch[w];
  return r;
}

// codes of 8 consecutive head-dim elements (byte j of a plane row) from the
// live low planes: code[i] = sum_p bit_i(plane_p[j]) << p
__device__ __forceinline__ void unpack8(const uint8_t* __restrict__ row,
                                        size_t plane_stride, int pact,
                                        int (&code)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) code[i] = 0;
  for (int p = 0; p < pact; ++p) {
    const unsigned v = row[p * plane_stride];
#pragma unroll
    for (int i = 0; i < 8; ++i) code[i] |= ((v >> i) & 1u) << p;
  }
}

template <int D8>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const int* __restrict__ qq, const float* __restrict__ qp,
    const int* __restrict__ pos_ptr, const uint8_t* __restrict__ kpl,
    const float* __restrict__ ks, const float* __restrict__ kz,
    const uint8_t* __restrict__ vpl, const float* __restrict__ vs,
    const float* __restrict__ vz, float* __restrict__ out, int P, int S,
    int KH, int G, int window, float softcap) {
  constexpr int HD = D8 * 8;
  const int kh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  extern __shared__ float smem[];
  float* sc = smem;                                // [G][S] scores -> probs
  int* pq = reinterpret_cast<int*>(smem);          // [G][S] requantized probs
  int* qs = reinterpret_cast<int*>(smem + G * S);  // [G][HD] q codes
  int* oacc = qs + G * HD;                         // [G][HD] PV accumulators
  __shared__ float red_f[kWarps];
  __shared__ double red_d[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int rowsum_q[kGMax];
  __shared__ int corr[kGMax];

  const int qz = static_cast<int>(qp[0]);
  const float q_scale = qp[1];
  const int k_pact = static_cast<int>(rintf(qp[2]));
  const int v_pact = static_cast<int>(rintf(qp[3]));
  const int pos = *pos_ptr;
  const int s_lo = window > 0 ? max(0, pos - window + 1) : 0;
  const int s_hi = min(pos, S - 1);
  const size_t plane_stride = (size_t)S * KH * D8;
  const size_t row0 = (size_t)b * P * plane_stride + (size_t)kh * D8;
  const size_t rowstride = (size_t)KH * D8;

  const int* qsrc = qq + ((size_t)(b * KH + kh) * G) * HD;
  for (int i = tid; i < G * HD; i += kThreads) {
    qs[i] = qsrc[i];
    oacc[i] = 0;
  }
  __syncthreads();
  if (tid < G) {
    int r = 0;
    for (int h = 0; h < HD; ++h) r += qs[tid * HD + h];
    rowsum_q[tid] = r;
  }
  __syncthreads();

  // scores: exact int32 QK^T, fp32 epilogue
  for (int s = tid; s < S; s += kThreads) {
    if (s < s_lo || s > s_hi) {
      for (int g = 0; g < G; ++g) sc[g * S + s] = kNegInf;
      continue;
    }
    int dot[kGMax];
#pragma unroll
    for (int g = 0; g < kGMax; ++g) dot[g] = 0;
    int colsum = 0;
    const uint8_t* row = kpl + row0 + (size_t)s * rowstride;
#pragma unroll 2
    for (int j = 0; j < D8; ++j) {
      int code[8];
      unpack8(row + j, plane_stride, k_pact, code);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        colsum += code[i];
#pragma unroll
        for (int g = 0; g < kGMax; ++g)
          if (g < G) dot[g] += qs[g * HD + j * 8 + i] * code[i];
      }
    }
    const int kzi = static_cast<int>(rintf(kz[(size_t)b * S + s]));
    const float kss = ks[(size_t)b * S + s];
    for (int g = 0; g < G; ++g) {
      const int i32 = dot[g] - qz * colsum - kzi * rowsum_q[g] + qz * kzi * HD;
      float v = __fmul_rn(__fmul_rn(static_cast<float>(i32), q_scale), kss);
      if (softcap > 0.0f) v = __fmul_rn(softcap, tanhf(v / softcap));
      sc[g * S + s] = v;
    }
  }
  __syncthreads();

  // softmax per query head; the denominator is summed in fp64
  for (int g = 0; g < G; ++g) {
    float m = kNegInf;
    for (int s = tid; s < S; s += kThreads) m = fmaxf(m, sc[g * S + s]);
    m = block_max(m, red_f);
    double part = 0.0;
    for (int s = tid; s < S; s += kThreads) {
      const float e = expf(sc[g * S + s] - m);
      sc[g * S + s] = e;
      part += static_cast<double>(e);
    }
    const double tot = block_sum(part, red_d);
    const float denom = static_cast<float>(tot);
    for (int s = tid; s < S; s += kThreads) sc[g * S + s] = sc[g * S + s] / denom;
  }

  // requantize the probabilities in the largest valid V scale
  float vmax = 0.0f;
  for (int s = s_lo + tid; s <= s_hi; s += kThreads)
    vmax = fmaxf(vmax, vs[(size_t)b * S + s]);
  const float sv_ref = fmaxf(block_max(vmax, red_f), 1e-12f);
  for (int g = 0; g < G; ++g) {
    int c = 0;
    for (int s = tid; s < S; s += kThreads) {
      int q = 0;
      if (s >= s_lo && s <= s_hi) {
        const float ratio = vs[(size_t)b * S + s] / sv_ref;
        q = static_cast<int>(
            rintf(__fmul_rn(__fmul_rn(sc[g * S + s], ratio), kProbScale)));
        c += q * static_cast<int>(rintf(vz[(size_t)b * S + s]));
      }
      pq[g * S + s] = q;  // same slot as the score it replaces
    }
    c = block_sum(c, red_i);
    if (tid == 0) corr[g] = c;
  }
  __syncthreads();

  // exact int32 PV: thread (lane, j) sums byte column j over its positions
  const int j = tid % D8, lane = tid / D8, lanes = kThreads / D8;
  int acc[kGMax][8];
#pragma unroll
  for (int g = 0; g < kGMax; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0;
  for (int s = s_lo + lane; s <= s_hi; s += lanes) {
    int code[8];
    unpack8(vpl + row0 + (size_t)s * rowstride + j, plane_stride, v_pact,
            code);
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      if (g < G) {
        const int w = pq[g * S + s];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] += w * code[i];
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kGMax; ++g)
    if (g < G)
#pragma unroll
      for (int i = 0; i < 8; ++i) atomicAdd(&oacc[g * HD + j * 8 + i], acc[g][i]);
  __syncthreads();

  const float scale = sv_ref / kProbScale;
  float* dst = out + ((size_t)(b * KH + kh) * G) * HD;
  for (int i = tid; i < G * HD; i += kThreads)
    dst[i] = __fmul_rn(static_cast<float>(oacc[i] - corr[i / HD]), scale);
}

template <int D8>
int launch(const int* qq, const float* qp, const int* pos, const uint8_t* kpl,
           const float* ks, const float* kz, const uint8_t* vpl,
           const float* vs, const float* vz, float* out, int B, int P, int S,
           int KH, int G, int window, float softcap, size_t smem,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      decode_attention_kernel<D8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(KH, B);
  decode_attention_kernel<D8><<<grid, kThreads, smem, stream>>>(
      qq, qp, pos, kpl, ks, kz, vpl, vs, vz, out, P, S, KH, G, window,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qp = [q_z, q_scale, k_pact, v_pact] (device, f32), pos a device int32.
// The wrapper (repro_torch/kernels/pann_attention.py) checks shapes,
// dtypes, contiguity, hd in {16, 32, 64, 128, 256}, G <= 8 and the shared
// memory bound on S, and clamps the pact counts to [1, P].
extern "C" int decode_attention_launch(
    const int* qq, const float* qp, const int* pos, const uint8_t* kpl,
    const float* ks, const float* kz, const uint8_t* vpl, const float* vs,
    const float* vz, float* out, int B, int P, int S, int KH, int G, int HD,
    int window, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * ((size_t)G * S + 2 * (size_t)G * HD);
  switch (HD / 8) {
    case 2: return launch<2>(qq, qp, pos, kpl, ks, kz, vpl, vs, vz, out, B, P,
                             S, KH, G, window, softcap, smem, st);
    case 4: return launch<4>(qq, qp, pos, kpl, ks, kz, vpl, vs, vz, out, B, P,
                             S, KH, G, window, softcap, smem, st);
    case 8: return launch<8>(qq, qp, pos, kpl, ks, kz, vpl, vs, vz, out, B, P,
                             S, KH, G, window, softcap, smem, st);
    case 16: return launch<16>(qq, qp, pos, kpl, ks, kz, vpl, vs, vz, out, B,
                               P, S, KH, G, window, softcap, smem, st);
    case 32: return launch<32>(qq, qp, pos, kpl, ks, kz, vpl, vs, vz, out, B,
                               P, S, KH, G, window, softcap, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
