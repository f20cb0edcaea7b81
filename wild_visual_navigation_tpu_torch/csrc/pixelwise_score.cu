// K2: fused per-pixel traversability + reconstruction-error scorer.
//
// Replaces wild_visual_navigation_tpu/ops/pixelwise_fused.py::
// pixelwise_score_fused (Pallas body _score_kernel).  For each output pixel
// (y, x) of a SimpleMLP [D -> K1 -> K -> 1 + D] reconstruction head:
//   h    = relu(c0 * hw[st] + c1 * hw[st + 1])            (2-tap H lerp, bf16)
//   x1   = relu(W1^T h + b1)
//   trav = sigmoid(w . x1 + b)                             (row 0 of GT)
//   reco = max(0, (x1^T M x1 + 2 x1 . (v - z) + c - 2 s + |x_up|^2) / D)
// where hw, z, s and the |x_up|^2 Gram terms were upsampled along W at
// patch-row resolution by the torch precompute (ops/pixelwise_fused.py::
// fused_precompute), and GT = [w ; M] with M = Wr Wr^T.  Only the two
// (B, H, W) maps are written.
//
// What bounds it on an H100: the K x K1 = 32 x 256 product per pixel
// (8192 FMAs, 0.8 GFLOP per 224x224 frame) on the SIMT pipes.  W1^T lives
// in shared memory (16 KB bf16) and is read as 16-byte broadcasts, one per
// eight FMAs; the hidden vector of a pixel is contiguous in the
// channels-last hw layout, so a thread reads it with 16-byte loads, and
// the 224 output rows of a frame reuse the 28 patch rows of hw from L2.
// Running the product on tensor cores (mma.sync with bf16 h) is later work.
//
// Layout: one thread per output pixel, 128 pixels of one output row per
// block, grid (ceil(W / 128), H, B).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 32;  // hidden width of the second layer
constexpr int kThreads = 128;
constexpr int kMaxK1 = 512;

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// The H lerp of hw runs in bf16 arithmetic, as the reference's kernel
// does: each product and the sum are rounded to bf16 (computed in fp32,
// where a bf16 x bf16 product is exact).
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__global__ void __launch_bounds__(kThreads)
pixelwise_score_kernel(const __nv_bfloat16* __restrict__ hw, const float* __restrict__ zsts,
                       const int* __restrict__ starts, const float* __restrict__ coef,
                       const __nv_bfloat16* __restrict__ w1t, const float* __restrict__ b1,
                       const float* __restrict__ gt, const float* __restrict__ v, const float* __restrict__ consts,
                       float* __restrict__ trav, float* __restrict__ reco, int Hp, int H, int W, int K1, float D) {
  extern __shared__ uint4 w1s_raw[];  // (kK, K1) bf16
  __shared__ float gts[(1 + kK) * kK];
  __shared__ float b1s[kK];
  __shared__ float vs[kK];

  const int tid = threadIdx.x;
  const int n_vec = kK * K1 / 8;
  const uint4* w1_src = reinterpret_cast<const uint4*>(w1t);
  for (int i = tid; i < n_vec; i += kThreads) w1s_raw[i] = w1_src[i];
  for (int i = tid; i < (1 + kK) * kK; i += kThreads) gts[i] = gt[i];
  if (tid < kK) {
    b1s[tid] = b1[tid];
    vs[tid] = v[tid];
  }
  __syncthreads();

  const int x = blockIdx.x * kThreads + tid;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;

  const int st = starts[y];
  const float c0 = coef[y * 8 + 0];
  const float c1 = coef[y * 8 + 1];
  const float c0b = round_bf16(c0);
  const float c1b = round_bf16(c1);
  const float q0 = coef[y * 8 + 2];
  const float q1 = coef[y * 8 + 3];
  const float x0 = coef[y * 8 + 4];

  const size_t row0 = (static_cast<size_t>(b) * Hp + st) * W + x;
  const size_t row1 = row0 + W;
  const uint4* h0 = reinterpret_cast<const uint4*>(hw + row0 * K1);
  const uint4* h1 = reinterpret_cast<const uint4*>(hw + row1 * K1);
  const int k1_vec = K1 / 8;

  float acc[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) acc[k] = 0.f;

  for (int j = 0; j < k1_vec; ++j) {
    float a[8], bb[8], h[8];
    unpack8(h0[j], a);
    unpack8(h1[j], bb);
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = fmaxf(round_bf16(round_bf16(c0b * a[e]) + round_bf16(c1b * bb[e])), 0.f);
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float w[8];
      unpack8(w1s_raw[k * k1_vec + j], w);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[k] += w[e] * h[e];
    }
  }

  float x1[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) x1[k] = fmaxf(acc[k] + b1s[k], 0.f);

  float logit = 0.f;
#pragma unroll
  for (int l = 0; l < kK; ++l) logit += gts[l] * x1[l];

  const int C = kK + 3;
  const float* z0 = zsts + row0 * C;
  const float* z1 = zsts + row1 * C;
  float quad = 0.f;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    float lin = 0.f;
#pragma unroll
    for (int l = 0; l < kK; ++l) lin += gts[(1 + k) * kK + l] * x1[l];
    const float z = c0 * z0[k] + c1 * z1[k];
    lin += 2.f * (vs[k] - z);
    quad += x1[k] * lin;
  }
  const float s = c0 * z0[kK] + c1 * z1[kK];
  const float nsq = q0 * z0[kK + 1] + q1 * z1[kK + 1] + x0 * z0[kK + 2];
  const float r = (quad + consts[1] - 2.f * s + nsq) / D;

  const size_t out = (static_cast<size_t>(b) * H + y) * W + x;
  trav[out] = 1.f / (1.f + expf(-(logit + consts[0])));
  reco[out] = fmaxf(r, 0.f);
}

}  // namespace

extern "C" int wvn_pixelwise_hidden_width() { return kK; }

// hw (B, Hp, W, K1) bf16, zsts (B, Hp, W, K + 3) fp32, starts (H,) int32,
// coef (H, 8) fp32, w1t (K, K1) bf16, b1 (K,), gt (1 + K, K), v (K,),
// consts (2,) = [b, c] fp32 -> trav, reco (B, H, W) fp32.  K is 32.
extern "C" int wvn_pixelwise_score(const void* hw, const void* zsts, const void* starts, const void* coef,
                                   const void* w1t, const void* b1, const void* gt, const void* v,
                                   const void* consts, void* trav, void* reco, int B, int Hp, int H, int W, int K1,
                                   float D, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || W <= 0 || Hp < 2 || K1 <= 0 || K1 % 8 != 0 || K1 > kMaxK1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kThreads - 1) / kThreads, H, B);
  const size_t smem = static_cast<size_t>(kK) * K1 * sizeof(__nv_bfloat16);
  pixelwise_score_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(hw), static_cast<const float*>(zsts), static_cast<const int*>(starts),
      static_cast<const float*>(coef), static_cast<const __nv_bfloat16*>(w1t), static_cast<const float*>(b1),
      static_cast<const float*>(gt), static_cast<const float*>(v), static_cast<const float*>(consts),
      static_cast<float*>(trav), static_cast<float*>(reco), Hp, H, W, K1, D);
  return static_cast<int>(cudaGetLastError());
}
