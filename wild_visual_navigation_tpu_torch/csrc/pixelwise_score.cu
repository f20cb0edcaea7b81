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
// What bounds it on an H100.  Per 224 x 224 frame the bytes (hw at 28 patch
// rows, zsts, the weights, the two maps) are 4.5 MB, 1.35 us at 3.35 TB/s,
// and they set the bound.  The 256 -> 32 product is 0.82 GFLOP in bf16,
// 0.83 us on the tensor cores; the fp32 epilogue (the Gram-form quadratic
// form x1^T M x1 over M's upper triangle, the head, the z lerp) 0.070
// GFLOP, 1.04 us on the SIMT pipes; the H lerp 0.039 GFLOP in bf16x2, 0.29 us.
//
// Design.  Output rows that share one pair of patch rows (a run of equal
// starts[y], 8 or 9 rows at 224 from 28) are one block's work, over a tile
// of 32 columns: the host cuts the rows into such runs of at most 8, one
// per warp (`runs`, ops/pixelwise_fused.py::_row_runs; a 9-row run becomes
// 8 + 1, so no warp waits on another's second row), and the grid is
// (ceil(W / 32), runs, B), 245 blocks at 224 from 28, B = 1: two blocks fit
// on each of the 132 SMs, so all run at once.  A block loads its two hw
// rows (32 x K1 bf16 each), their zsts rows and W1^T (16 KB) into shared
// memory once, and every output row of the run is served from there, so
// each hw row pair is read from L2 once per tile instead of once per
// output row.  The loads are cp.async copies, all issued before the block
// waits once (some 61 KB a block, 15 MB from L2 in all).  Each warp takes
// one output row:
//   * the H lerp runs in bf16x2 arithmetic (mul.rn, add.rn, max), two
//     channels per instruction, straight into the A fragments.  It
//     gives the bits of the reference's lerp, round_bf16(round_bf16(c0*a) +
//     round_bf16(c1*b)) computed in fp32: a bf16 x bf16 product is exact in
//     fp32, so both forms round it once; and the fp32 sum of two bf16 values
//     is inexact only when their exponents lie more than 16 apart, where the
//     sum lies within a 2^-16 relative distance of the larger value, which
//     is a bf16 value, and so far from any bf16 tie: rounding it to bf16
//     once or twice gives the same value;
//   * x1 = relu(h W1 + b1) runs on the tensor cores, mma.sync m16n8k16 with
//     bf16 inputs and fp32 accumulation (the reference's kernel runs this
//     product on the MXU in bf16 with fp32 accumulation too): a 32-pixel x
//     32 tile is 2 x 4 MMA tiles, K1 / 16 steps deep;
//   * x1 goes through shared memory (padded rows, no bank conflicts), one
//     lane per pixel then runs the fp32 epilogue, GT, v and the zsts rows
//     read from shared memory.  The quadratic form takes the upper triangle
//     of the symmetric M (528 FMAs per pixel instead of 1,024).  TF32 or
//     bf16 would be wrong there: the Gram form cancels large terms.
// Shared-memory rows are padded by 8 bf16 (16 bytes), so the fragment loads
// of the 8 lane groups fall in distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kK = 32;  // hidden width of the second layer
constexpr int kC = kK + 3;  // zsts channels
constexpr int kTile = 32;   // output columns per block (one per lane in the epilogue)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxK1 = 512;
constexpr int kPad = 8;  // bf16 of padding per shared-memory row

__device__ __forceinline__ uint32_t ld_bf2(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// relu(c0 * a + c1 * b) in bf16x2, each operation rounded to bf16.  The
// explicit .rn matters: a bf16x2 mul or add without a rounding modifier may
// be contracted into fma.bf16x2, which rounds c1 * b + (c0 * a) once.
__device__ __forceinline__ uint32_t lerp2(uint32_t c0, uint32_t c1, const __nv_bfloat16* a, const __nv_bfloat16* b) {
  uint32_t p, q, s, h;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(p) : "r"(c0), "r"(ld_bf2(a)));
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(q) : "r"(c1), "r"(ld_bf2(b)));
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(s) : "r"(p), "r"(q));
  asm("max.bf16x2 %0, %1, %2;" : "=r"(h) : "r"(s), "r"(0u));
  return h;
}

__device__ __forceinline__ uint32_t bf16x2_of(float c) {
  const __nv_bfloat162 v = __float2bfloat162_rn(c);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Asynchronous global -> shared copies (zero-filled when !valid): a thread
// issues all of its copies before the block waits once.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr int round16(int k) { return (k + 15) / 16 * 16; }

__host__ __device__ constexpr size_t smem_bytes(int K1) {
  return static_cast<size_t>(kK + 2 * kTile) * (round16(K1) + kPad) * 2  // W1^T and the two hw rows, bf16
         + (2 * kTile * kC + kWarps * kTile * (kK + 1)) * 4;  // the zsts rows and x1, fp32
}

__global__ void __launch_bounds__(kThreads, 2)
pixelwise_score_kernel(const __nv_bfloat16* __restrict__ hw, const float* __restrict__ zsts,
                       const int* __restrict__ starts, const int* __restrict__ runs,
                       const float* __restrict__ coef, const __nv_bfloat16* __restrict__ w1t,
                       const float* __restrict__ b1, const float* __restrict__ gt, const float* __restrict__ v,
                       const float* __restrict__ consts, float* __restrict__ trav, float* __restrict__ reco, int Hp,
                       int H, int W, int K1, float D) {
  extern __shared__ uint4 smem_raw[];
  __shared__ __align__(16) float gts[(1 + kK) * kK];  // static: 16-byte broadcasts in the epilogue
  __shared__ __align__(16) float b1s[kK];
  __shared__ __align__(16) float vs[kK];
  const int K1p = round16(K1), ld = K1p + kPad;
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (kK, ld)
  __nv_bfloat16* hs = w1s + kK * ld;                                // (2, kTile, ld)
  float* zs = reinterpret_cast<float*>(hs + 2 * kTile * ld);        // (2, kTile, kC)
  float* x1s = zs + 2 * kTile * kC;                                 // (kWarps, kTile, kK + 1)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = blockIdx.x * kTile, b = blockIdx.z;
  const int y_begin = runs[blockIdx.y], y_end = runs[blockIdx.y + 1];
  const int st = starts[y_begin];  // the same for every row of the run
  const size_t row0 = (static_cast<size_t>(b) * Hp + st) * W;  // pixel index of (b, st, 0)

  // W1^T, the two hw rows, their zsts rows, GT, b1 and v into shared memory
  // (zeros past K1 and past W): every thread issues all of its copies
  // before the block waits once
  const int cv = K1p / 8;  // 16-byte chunks per padded row
  for (int i = tid; i < kK * cv; i += kThreads) {
    const int n = i / cv, c = i - n * cv;
    const bool ok = c * 8 < K1;
    cp_async<16>(w1s + n * ld + c * 8, ok ? w1t + static_cast<size_t>(n) * K1 + c * 8 : w1t, ok);
  }
  for (int i = tid; i < 2 * kTile * cv; i += kThreads) {
    const int rp = i / cv, c = i - rp * cv, r = rp / kTile, x = x0 + rp - r * kTile;
    const bool ok = x < W && c * 8 < K1;
    cp_async<16>(hs + rp * ld + c * 8, ok ? hw + (row0 + static_cast<size_t>(r) * W + x) * K1 + c * 8 : hw, ok);
  }
  for (int i = tid; i < 2 * kTile * kC; i += kThreads) {
    const int r = i / (kTile * kC), rem = i - r * kTile * kC;
    const bool ok = x0 + rem / kC < W;
    cp_async<4>(zs + i, ok ? zsts + (row0 + static_cast<size_t>(r) * W + x0) * kC + rem : zsts, ok);
  }
  for (int i = tid; i < (1 + kK) * kK; i += kThreads) cp_async<4>(gts + i, gt + i, true);
  if (tid < kK) {
    cp_async<4>(b1s + tid, b1 + tid, true);
    cp_async<4>(vs + tid, v + tid, true);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* h0 = hs;
  const __nv_bfloat16* h1 = hs + kTile * ld;
  float* xw = x1s + warp * kTile * (kK + 1);
  const float* z0 = zs + lane * kC;
  const float* z1 = zs + (kTile + lane) * kC;
  const int x = x0 + lane;

  for (int y = y_begin + warp; y < y_end; y += kWarps) {
    const float c0 = coef[y * 8 + 0], c1 = coef[y * 8 + 1];
    const uint32_t c0b = bf16x2_of(c0), c1b = bf16x2_of(c1);

    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    for (int k0 = 0; k0 < K1p; k0 += 16) {
      const int k = k0 + 2 * t;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int pa = (mt * 16 + g) * ld + k, pb = pa + 8 * ld;
        a[mt][0] = lerp2(c0b, c1b, h0 + pa, h1 + pa);
        a[mt][1] = lerp2(c0b, c1b, h0 + pb, h1 + pb);
        a[mt][2] = lerp2(c0b, c1b, h0 + pa + 8, h1 + pa + 8);
        a[mt][3] = lerp2(c0b, c1b, h0 + pb + 8, h1 + pb + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* wb = w1s + (nt * 8 + g) * ld + k;
        const uint32_t b0 = ld_bf2(wb), b1v = ld_bf2(wb + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1v);
      }
    }

    // x1 = relu(acc + b1) -> shared memory, one row of kK per pixel
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int px = mt * 16 + g + (e >> 1) * 8, n = nt * 8 + 2 * t + (e & 1);
          xw[px * (kK + 1) + n] = fmaxf(acc[mt][nt][e] + b1s[n], 0.f);
        }
    __syncwarp();

    // the fp32 epilogue, one lane per pixel
    float x1[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) x1[k] = xw[lane * (kK + 1) + k];
    __syncwarp();  // the next row overwrites xw
    if (x < W) {
      float logit = 0.f;
#pragma unroll
      for (int l = 0; l < kK; ++l) logit += gts[l] * x1[l];
      // x1^T M x1 + 2 x1 . (v - z) over the upper triangle of the symmetric M:
      // sum_k x1_k (M_kk x1_k + 2 (sum_{l > k} M_kl x1_l + v_k - z_k)), half the FMAs
      float quad = 0.f;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        float off = 0.f;
#pragma unroll
        for (int l = k + 1; l < kK; ++l) off += gts[(1 + k) * kK + l] * x1[l];
        const float z = c0 * z0[k] + c1 * z1[k];
        quad += x1[k] * (gts[(1 + k) * kK + k] * x1[k] + 2.f * (off + vs[k] - z));
      }
      const float q0 = coef[y * 8 + 2], q1 = coef[y * 8 + 3], xq = coef[y * 8 + 4];
      const float s = c0 * z0[kK] + c1 * z1[kK];
      const float nsq = q0 * z0[kK + 1] + q1 * z1[kK + 1] + xq * z0[kK + 2];
      const float r = (quad + consts[1] - 2.f * s + nsq) / D;
      const size_t out = (static_cast<size_t>(b) * H + y) * W + x;
      trav[out] = 1.f / (1.f + expf(-(logit + consts[0])));
      reco[out] = fmaxf(r, 0.f);
    }
  }
}

// Lets pixelwise_score_kernel take the dynamic shared memory of the largest
// K1 on the current device.  The attribute is per device, and is set once
// for each.
cudaError_t allow_shared_memory() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))) return err;
  err = cudaFuncSetAttribute(pixelwise_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(kMaxK1)));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

extern "C" int wvn_pixelwise_hidden_width() { return kK; }

extern "C" int wvn_pixelwise_score_smem_bytes(int K1) { return static_cast<int>(smem_bytes(K1)); }

// hw (B, Hp, W, K1) bf16, zsts (B, Hp, W, K + 3) fp32, starts (H,) int32,
// runs (R + 1,) int32 (row boundaries of runs of equal starts), coef (H, 8)
// fp32, w1t (K, K1) bf16, b1 (K,), gt (1 + K, K), v (K,), consts (2,) =
// [b, c] fp32 -> trav, reco (B, H, W) fp32.  K is 32.
extern "C" int wvn_pixelwise_score(const void* hw, const void* zsts, const void* starts, const void* runs,
                                   const void* coef, const void* w1t, const void* b1, const void* gt, const void* v,
                                   const void* consts, void* trav, void* reco, int B, int Hp, int H, int W, int K1,
                                   int R, float D, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || Hp < 2 || K1 <= 0 || K1 % 8 != 0 || K1 > kMaxK1 || R <= 0 ||
      R > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(K1);
  const cudaError_t err = allow_shared_memory();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTile - 1) / kTile, R, B);
  pixelwise_score_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(hw), static_cast<const float*>(zsts), static_cast<const int*>(starts),
      static_cast<const int*>(runs), static_cast<const float*>(coef), static_cast<const __nv_bfloat16*>(w1t),
      static_cast<const float*>(b1), static_cast<const float*>(gt), static_cast<const float*>(v),
      static_cast<const float*>(consts), static_cast<float*>(trav), static_cast<float*>(reco), Hp, H, W, K1, D);
  return static_cast<int>(cudaGetLastError());
}
