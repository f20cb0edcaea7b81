// K1: forward, non-causal flash attention for the ViT backbone.
//
// Replaces wild_visual_navigation_tpu/ops/flash_attention.py::flash_attention
// (Pallas body _flash_kernel).  Computes softmax(q k^T * scale) v over
// (B*H, S, D) with an online softmax, so the (S, S) score matrix never
// reaches device memory.
//
// What bounds it on an H100: at the main path's shape (B*H = 6, S = 785,
// D = 64) the work is 2 * 6 * 785^2 * 64 * 2 = 0.47 GFLOP per call and the
// operands are 1.8 MB, so it is compute-bound. This first version runs the
// two products on the fp32 SIMT pipes out of shared memory (no tensor
// cores): every FMA takes one shared-memory read, so shared-memory
// bandwidth is the limit. The design keeps that read broadcast-friendly and
// bank-conflict free (rows padded to 65 floats) and keeps the running max,
// sum and output accumulator in registers, in fp32. Moving QK^T and PV onto
// mma.sync / wgmma is later work.
//
// Layout: one block per (batch*head, 64-row query tile); 256 threads, four
// per query row. The loop over 32-row kv tiles replaces the TPU kernel's
// sequential grid axis. Thread c of a row owns score columns c, c+4, ...
// of each kv tile and output features c, c+4, ..., c+60.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int kD = 64;         // head dim (the only one this version takes)
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // kv rows per tile
constexpr int kTPR = 4;        // threads per query row
constexpr int kThreads = kBQ * kTPR;
constexpr int kCols = kBK / kTPR;  // score columns per thread per tile
constexpr int kOut = kD / kTPR;    // output features per thread
constexpr int kPad = kD + 1;
// Same finite mask value as the TPU kernel: exp() of it never gives NaN.
constexpr float kMask = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// Rounds p to the value dtype before PV, as the reference does with
// p.astype(v.dtype); a no-op for fp32 inputs.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, float scale) {
  __shared__ float qs[kBQ][kPad];
  __shared__ float ks[kBK][kPad];
  __shared__ float vs[kBK][kPad];
  __shared__ float ps[kBQ][kBK + 1];

  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int c = tid % kTPR;
  const int q0 = blockIdx.x * kBQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * kD;

  for (int i = tid; i < kBQ * kD; i += kThreads) {
    const int row = i / kD, d = i % kD;
    qs[row][d] = (q0 + row < S) ? to_f32(q[base + static_cast<size_t>(q0 + row) * kD + d]) : 0.f;
  }

  float m = -INFINITY;
  float l = 0.f;
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;

  for (int kv0 = 0; kv0 < S; kv0 += kBK) {
    __syncthreads();  // the previous tile's ks / vs / ps are no longer read
    for (int i = tid; i < kBK * kD; i += kThreads) {
      const int row = i / kD, d = i % kD;
      const bool in = kv0 + row < S;
      const size_t off = base + static_cast<size_t>(kv0 + row) * kD + d;
      ks[row][d] = in ? to_f32(k[off]) : 0.f;
      vs[row][d] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      const float qd = qs[r][d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[j] += qd * ks[c + kTPR * j][d];
    }
    float tile_max = kMask;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      s[j] = (kv0 + c + kTPR * j < S) ? s[j] * scale : kMask;
      tile_max = fmaxf(tile_max, s[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_next = fmaxf(m, tile_max);
    const float alpha = expf(m - m_next);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float p = expf(s[j] - m_next);
      psum += p;
      ps[r][c + kTPR * j] = round_to<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = alpha * l + psum;
    m = m_next;
#pragma unroll
    for (int i = 0; i < kOut; ++i) acc[i] *= alpha;
    __syncthreads();  // ps complete for every row

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float pj = ps[r][j];
#pragma unroll
      for (int i = 0; i < kOut; ++i) acc[i] += pj * vs[j][c + kTPR * i];
    }
  }

  const int row = q0 + r;
  if (row < S) {
    const float l_inv = (l == 0.f) ? 1.f : 1.f / l;
    T* out = o + base + static_cast<size_t>(row) * kD;
#pragma unroll
    for (int i = 0; i < kOut; ++i) out[c + kTPR * i] = from_f32<T>(acc[i] * l_inv);
  }
}

}  // namespace

// q, k, v, o: contiguous (BH, S, D); dtype 0 = float32, 1 = bfloat16.
extern "C" int wvn_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int BH, int S,
                                       int D, int dtype, float scale, void* stream) {
  if (D != kD || BH <= 0 || S <= 0 || BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    flash_fwd_kernel<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                       static_cast<const float*>(v), static_cast<float*>(o), S,
                                                       scale);
  } else if (dtype == 1) {
    flash_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wvn_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
