// K4: convex-polygon fill of B hulls into (B, H, W) boolean masks.
//
// Replaces wild_visual_navigation_tpu/ops/rasterize_pallas.py::fill_hulls_pallas
// (Pallas body _fill_kernel), which the supervision reprojection runs once
// per footprint update over its fan-out of B mission nodes.  The wrapper
// (ops/rasterize_fill.py) builds each hull's E+1 edge lines (a, b, c) -- the
// hull's edges in march order and one gate edge that is always violated for
// a hull of fewer than 3 valid vertices -- and this kernel writes, per pixel
// (x, y) at integer coordinates,
//
//     inside = min_e(a_e * x + b_e * y + c_e) >= -1e-6.
//
// What bounds it on an H100: the edge loop.  At the product shape (B = 32,
// 224 x 224, E + 1 = 33) the kernel writes 1.6 MB of mask bytes and reads
// 13 KB of edges, about 0.5 us at 3.35 TB/s; it does 5 fp32 operations per
// edge and pixel (two products, two sums, the minimum): 0.26 GFLOP, about
// 4 us on the SIMT pipes at 67 TFLOP/s.  One
// thread per pixel, 256 pixels per block, grid (ceil(H*W / 256), B): 196
// blocks per hull, 6,272 at the product shape.  The block's edge lines sit
// in shared memory and are read as broadcasts; each thread writes one byte,
// neighbouring threads to neighbouring addresses.
//
// Exactness: a*x + b*y + c is computed as ((a*x) + (b*y)) + c with the _rn
// intrinsics, which the compiler never contracts into FMAs, so each term is
// rounded exactly as the plain version (separate torch ops) rounds it; and
// the running minimum propagates NaN like torch.minimum, where fminf would
// drop it.  The masks are therefore identical to fill_hulls_plain's.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // = pixels per block
constexpr int kMaxEdges = 65;  // 64 hull vertices + the gate edge
constexpr float kBig = 1e30f;
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float min_nan(float acc, float v) {
  // torch.minimum semantics: NaN in either operand gives NaN.
  return (v < acc || v != v) ? v : acc;
}

__global__ void __launch_bounds__(kThreads)
fill_hulls_kernel(const float* __restrict__ edges, bool* __restrict__ out, int num_edges, int H, int W) {
  __shared__ float e[kMaxEdges * 3];
  const int b = blockIdx.y;
  const float* eb = edges + static_cast<size_t>(b) * num_edges * 3;
  for (int i = threadIdx.x; i < num_edges * 3; i += kThreads) e[i] = eb[i];
  __syncthreads();

  const int HW = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const float y = static_cast<float>(p / W);
  const float x = static_cast<float>(p % W);
  float acc = kBig;
  for (int k = 0; k < num_edges; ++k) {
    const float v = __fadd_rn(__fadd_rn(__fmul_rn(e[3 * k], x), __fmul_rn(e[3 * k + 1], y)), e[3 * k + 2]);
    acc = min_nan(acc, v);
  }
  out[static_cast<size_t>(b) * HW + p] = acc >= -kEps;
}

}  // namespace

// edges (B, num_edges, 3) fp32 -> out (B, H, W) bool (one byte each).
extern "C" int wvn_fill_hulls(const void* edges, void* out, int B, int num_edges, int H, int W, void* stream) {
  if (B <= 0 || B > 65535 || num_edges <= 0 || num_edges > kMaxEdges || H <= 0 || W <= 0 ||
      static_cast<long long>(H) * W > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int HW = H * W;
  const int nblk = (HW + kThreads - 1) / kThreads;
  fill_hulls_kernel<<<dim3(nblk, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(edges), static_cast<bool*>(out), num_edges, H, W);
  return static_cast<int>(cudaGetLastError());
}
