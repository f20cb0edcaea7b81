// K3: one SLIC Lloyd step (assign + per-block cluster sums).
//
// Replaces wild_visual_navigation_tpu/ops/slic_fused.py::_slic_step (Pallas
// body _kernel), driven by slic_batch_fused.  Per pixel: the squared 5-d
// distance (L, a, b, y*ws, x*ws) to every centre whose unscaled spatial
// distance is within the 2S window, first-index argmin, and the orphan
// fallback to the spatially nearest centre.  Then the block's pixels are
// summed per cluster (five feature sums and a count) into its own slot of
// partials (B, nblocks, K, 6); the caller sums the block axis in a fixed
// order, so no fp32 atomics reorder the sums between runs.
//
// What bounds it on an H100: the dense search over all K centres, about
// 20 flops per (pixel, centre) pair -- 0.1 GFLOP per 224x224 image with
// K = 100 -- on the SIMT pipes, with the centres held in shared memory and
// read as broadcasts.  Device-memory traffic is one read of the 5-channel
// features (1 MB per image) and the ids.  One pixel per thread and 256
// pixels per block give 196 blocks per image, enough to cover the card's
// 132 SMs at batch 1.
//
// Exactness: the distance is computed in the expression order of the plain
// version (ops/slic.py::_assign_plain) with the _rn intrinsics, which the
// compiler never contracts into FMAs, so single-step ids are bit-identical
// to the plain version on the same centres.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // = pixels per block
constexpr int kMaxK = 512;
constexpr float kBig = 1e30f;

__global__ void __launch_bounds__(kThreads)
slic_step_kernel(const float* __restrict__ feats, const float* __restrict__ centers, int* __restrict__ ids,
                 float* __restrict__ partials, int HW, int W, int K, float ws, float win2) {
  extern __shared__ float smem[];
  float* cen = smem;                // (K, 5)
  float* c2 = cen + 5 * K;          // (K,)  |c|^2
  float* cy = c2 + K;               // (K,)  unscaled centre y
  float* cx = cy + K;               // (K,)  unscaled centre x
  float* cyx2 = cx + K;             // (K,)
  float* pf = cyx2 + K;             // (5, kThreads) this block's features
  int* pid = reinterpret_cast<int*>(pf + 5 * kThreads);  // (kThreads,)

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int nblk = gridDim.x;
  const float* cb = centers + static_cast<size_t>(b) * K * 5;
  for (int i = tid; i < 5 * K; i += kThreads) cen[i] = cb[i];
  __syncthreads();
  for (int k = tid; k < K; k += kThreads) {
    const float* ck = cen + 5 * k;
    float s = __fmul_rn(ck[0], ck[0]);
    s = __fadd_rn(s, __fmul_rn(ck[1], ck[1]));
    s = __fadd_rn(s, __fmul_rn(ck[2], ck[2]));
    s = __fadd_rn(s, __fmul_rn(ck[3], ck[3]));
    s = __fadd_rn(s, __fmul_rn(ck[4], ck[4]));
    c2[k] = s;
    const float y = __fdiv_rn(ck[3], ws);
    const float x = __fdiv_rn(ck[4], ws);
    cy[k] = y;
    cx[k] = x;
    cyx2[k] = __fadd_rn(__fmul_rn(y, y), __fmul_rn(x, x));
  }
  __syncthreads();

  const int p = blockIdx.x * kThreads + tid;
  const bool valid = p < HW;
  float f[5];
  const float* fb = feats + static_cast<size_t>(b) * 5 * HW;
#pragma unroll
  for (int ch = 0; ch < 5; ++ch) f[ch] = valid ? fb[static_cast<size_t>(ch) * HW + p] : 0.f;

  float p2 = __fmul_rn(f[0], f[0]);
#pragma unroll
  for (int ch = 1; ch < 5; ++ch) p2 = __fadd_rn(p2, __fmul_rn(f[ch], f[ch]));
  const float py = static_cast<float>(p / W);
  const float px = static_cast<float>(p % W);
  const float yx2 = __fadd_rn(__fmul_rn(py, py), __fmul_rn(px, px));

  float best = INFINITY, best_s = INFINITY;
  int best_k = 0, best_sk = 0;
  for (int k = 0; k < K; ++k) {
    const float* ck = cen + 5 * k;
    float dots = __fmul_rn(f[0], ck[0]);
#pragma unroll
    for (int ch = 1; ch < 5; ++ch) dots = __fadd_rn(dots, __fmul_rn(f[ch], ck[ch]));
    const float d2 = __fadd_rn(__fsub_rn(p2, __fmul_rn(2.f, dots)), c2[k]);
    const float sd = __fadd_rn(__fmul_rn(py, cy[k]), __fmul_rn(px, cx[k]));
    const float d2s = __fadd_rn(__fsub_rn(yx2, __fmul_rn(2.f, sd)), cyx2[k]);
    const float masked = (d2s <= win2) ? d2 : kBig;
    if (masked < best) {
      best = masked;
      best_k = k;
    }
    if (d2s < best_s) {
      best_s = d2s;
      best_sk = k;
    }
  }
  const int id = (best_s > win2) ? best_sk : best_k;
  if (valid) ids[static_cast<size_t>(b) * HW + p] = id;

#pragma unroll
  for (int ch = 0; ch < 5; ++ch) pf[ch * kThreads + tid] = f[ch];
  pid[tid] = valid ? id : -1;
  __syncthreads();

  // Per-cluster sums over this block's pixels, in pixel order.
  float* out = partials + (static_cast<size_t>(b) * nblk + blockIdx.x) * K * 6;
  for (int k = tid; k < K; k += kThreads) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f, n = 0.f;
    for (int i = 0; i < kThreads; ++i) {
      if (pid[i] == k) {
        s0 += pf[i];
        s1 += pf[kThreads + i];
        s2 += pf[2 * kThreads + i];
        s3 += pf[3 * kThreads + i];
        s4 += pf[4 * kThreads + i];
        n += 1.f;
      }
    }
    float* o = out + 6 * k;
    o[0] = s0;
    o[1] = s1;
    o[2] = s2;
    o[3] = s3;
    o[4] = s4;
    o[5] = n;
  }
}

}  // namespace

// feats (B, 5, HW) fp32, centers (B, K, 5) fp32 -> ids (B, HW) int32 and
// partials (B, ceil(HW / 256), K, 6) fp32.
extern "C" int wvn_slic_step(const void* feats, const void* centers, void* ids, void* partials, int B, int HW,
                             int W, int K, float ws, float win2, void* stream) {
  if (B <= 0 || B > 65535 || HW <= 0 || W <= 0 || K <= 0 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = (HW + kThreads - 1) / kThreads;
  const size_t smem = (9 * static_cast<size_t>(K) + 5 * kThreads) * sizeof(float) + kThreads * sizeof(int);
  slic_step_kernel<<<dim3(nblk, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feats), static_cast<const float*>(centers), static_cast<int*>(ids),
      static_cast<float*>(partials), HW, W, K, ws, win2);
  return static_cast<int>(cudaGetLastError());
}
