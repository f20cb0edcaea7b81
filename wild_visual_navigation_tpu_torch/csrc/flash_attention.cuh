// K1: forward, non-causal flash attention for the ViT backbone.
//
// Replaces wild_visual_navigation_tpu/ops/flash_attention.py::flash_attention
// (Pallas body _flash_kernel).  Computes softmax(q k^T * scale) v for q, k,
// v of shape (B, H, S, D) with an online softmax, so the (S, S) score matrix
// never reaches device memory.  q, k, v and o may have any strides for B, H
// and S (a contiguous D axis), so the ViT passes views of its qkv product
// and reads o as a view of a (B, S, H, D) buffer with no copies.
//
// The bodies are templates on the head dim D (32, 64, 128, 256: every D the
// TPU kernel takes, the wrapper zero-pads any other D <= 256 to the next
// one) and, for bf16, on the tile (BQ query rows per block, BK kv rows per
// tile).  Each head dim is instantiated in its own translation unit
// (flash_attention.cu for D = 64, flash_attention_d{32,128,256}.cu), so the
// build compiles them in parallel.  WVN_K1_DEFINE_D(D) defines the entry a
// unit exports, `wvn_k1_d<D>`; flash_attention.cu dispatches on D.
//
// What bounds it on an H100: at the main path's shape (B*H = 6, S = 785,
// D = 64) the work is 4 * 6 * 785^2 * 64 = 0.95 GFLOP per call against
// 2.4 MB of operands, so it is bound by the tensor cores' operations
// (0.96 us at 989 TFLOP/s bf16).  Below that, what a block can overlap
// bounds it: one block owns BQ query rows of one (batch, head), so B=1 and
// the default BQ = 64 give 13 x 6 = 78 blocks on 132 SMs.
//
// bf16: one warpgroup of 128 threads per 64 query rows (BQ = 128: two
// warpgroups sharing one K/V ring, each with its own 64 rows of Q).
//  * S = Q K^T with wgmma m64nBKk16 (bf16 in, fp32 accumulators), Q and the
//    K tile both read from shared memory, both K-major (D is contiguous).
//  * The online softmax runs in registers on the accumulator fragment, with
//    a fp32 running max and sum; a row's four lanes reduce with shuffles.
//    Columns beyond S take the TPU kernel's finite mask -0.7 * FLT_MAX.
//  * O += P V with a second wgmma, m64nDk16: P rounded to bf16 in registers
//    (where the reference rounds p.astype(v.dtype)) is the A operand,
//    reusing the accumulator layout; V is the B operand from shared memory,
//    MN-major.
//  * Q is loaded once; BK-row K and V tiles go through two-stage rings in
//    shared memory, all by TMA (cp.async.bulk.tensor) with mbarrier
//    completion, loaded a tile or two ahead.  A tile is stored as panels of
//    64 columns (128 bytes a row, 128-byte swizzle), one TMA box each; at
//    D = 32 a row is 64 bytes, one panel with the 64-byte swizzle.  The copy
//    zero-fills rows beyond S (785 = 12 * 64 + 17), and the scores mask them.
//  * The kv loop issues S_t = Q K_t^T and O += P_{t-1} V_{t-1} back to
//    back, one softmax per tile between such pairs.  Both warpgroups of a
//    BQ = 128 block release a ring stage at the same __syncthreads, after
//    which thread 0 refills it, so every mbarrier still counts one arrival
//    (thread 0's expect_tx) and the TMA bytes.
//  * The tensor maps are built on the host per call with
//    cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so the
//    library needs no -lcuda, and passed as __grid_constant__ parameters.
//  * Registers: each thread holds D/2 fp32 of O, BK/2 of S and BK/4 of P.
//    At D = 256 and BK = 64 that is 176 before addresses; BK = 128 at
//    D = 256 would need 224 and 288 KB of shared memory, so it is not
//    instantiated (the wrapper names the tiles each D takes).
// fp32: a SIMT body (fp32 FMAs from shared memory, 256 threads per 64 query
// rows, 32-row kv tiles), which keeps fp32 accuracy; TF32 tensor cores would
// not.  Its tiles live in dynamic shared memory: at D = 256 they take 140 KB.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

// What one call passes from the host entry to the unit of its head dim.
struct K1Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long st[12];  // the (B, H, S) strides, in elements, of q, k, v and o
  int B, H, S;
  float scale;
  cudaStream_t stream;
};

namespace {

// Same finite mask value as the TPU kernel: exp() of it never gives NaN.
constexpr float kMask = -0.7f * FLT_MAX;

// ------------------------------------------------------------------ fp32 SIMT body

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // kv rows per tile
constexpr int kTPR = 4;        // threads per query row
constexpr int kThreads = kBQ * kTPR;
constexpr int kCols = kBK / kTPR;  // score columns per thread per tile

// (B, H, S) strides, in elements, of q, k, v and o.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * ((kBQ + 2 * kBK) * (D + 1) + kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, Strides st, int H, int S, float scale) {
  constexpr int kOut = D / kTPR;  // output features per thread
  constexpr int kPad = D + 1;
  extern __shared__ float f32_smem[];
  float(*qs)[kPad] = reinterpret_cast<float(*)[kPad]>(f32_smem);
  float(*ks)[kPad] = qs + kBQ;
  float(*vs)[kPad] = ks + kBK;
  float(*ps)[kBK + 1] = reinterpret_cast<float(*)[kBK + 1]>(vs + kBK);

  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int c = tid % kTPR;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int row = i / D, d = i % D;
    qs[row][d] = (q0 + row < S) ? qb[(q0 + row) * st.q[2] + d] : 0.f;
  }

  float m = -INFINITY;
  float l = 0.f;
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;

  for (int kv0 = 0; kv0 < S; kv0 += kBK) {
    __syncthreads();  // the previous tile's ks / vs / ps are no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int row = i / D, d = i % D;
      const bool in = kv0 + row < S;
      ks[row][d] = in ? kb[(kv0 + row) * st.k[2] + d] : 0.f;
      vs[row][d] = in ? vb[(kv0 + row) * st.v[2] + d] : 0.f;
    }
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
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
      ps[r][c + kTPR * j] = p;
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
    float* out = o + b * st.o[0] + h * st.o[1] + row * st.o[2];
#pragma unroll
    for (int i = 0; i < kOut; ++i) out[c + kTPR * i] = acc[i] * l_inv;
  }
}

// ------------------------------------------------------------------ bf16 wgmma body

// The geometry of a (D, BQ, BK) instantiation.
template <int D, int BQ, int BK>
struct Tile {
  static constexpr int kPanelCols = D == 32 ? 32 : 64;  // bf16 columns of one swizzled row
  static constexpr int kRowBytes = kPanelCols * 2;       // 64 or 128
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kStepsPerPanel = kPanelCols / 16;  // k16 steps of QK^T in one panel
  static constexpr int kWarpgroups = BQ / 64;
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr uint32_t kQBytes = BQ * D * 2;
  static constexpr uint32_t kTileBytes = BK * D * 2;
  static constexpr uint64_t kLayout = D == 32 ? 2 : 1;  // wgmma descriptor layout: 1 = 128-byte, 2 = 64-byte swizzle
  static constexpr uint64_t kSBO = 8 * kRowBytes / 16;   // bytes between 8-row groups, in 16-byte units
  // V as the MN-major B operand of PV: bytes between its 64-column panels (unused with one panel)
  static constexpr uint64_t kVLBO = kPanels > 1 ? BK * kRowBytes / 16 : 1;
  static_assert(D % kPanelCols == 0 && (BQ == 64 || BQ == 128) && (BK == 64 || BK == 128), "K1 tile");
};

template <int D, int BQ, int BK>
struct alignas(1024) TileSmem {
  __nv_bfloat16 q[BQ * D];
  __nv_bfloat16 k[2][BK * D];
  __nv_bfloat16 v[2][BK * D];
  uint64_t bar_q;
  uint64_t bar_k[2];
  uint64_t bar_v[2];
};
template <int D, int BQ, int BK>
constexpr size_t bf16_smem_bytes() {
  return sizeof(TileSmem<D, BQ, BK>) + 1024;  // + room to align the dynamic base to 1024 B
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(phase)
      : "memory");
}

// One box of a 4-d tensor map (d, then the three outer axes in the map's
// order) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, const int (&c)[4]) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3])
      : "memory");
}

// wgmma shared-memory descriptor of a swizzled tile: start address, leading
// byte offset, stride between 8-row groups (SBO) and the swizzle layout, the
// last three in the units and codes the descriptor takes.
template <int D, int BQ, int BK>
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint64_t lbo) {
  using T = Tile<D, BQ, BK>;
  return (static_cast<uint64_t>(smem_u32(p) & 0x3FFFF) >> 4) | (lbo << 16) | (T::kSBO << 32) | (T::kLayout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define WVN_ACC8(d, o)                                                                                              \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), \
      "+f"(d[o + 7])
#define WVN_ACC16(d) WVN_ACC8(d, 0), WVN_ACC8(d, 8)
#define WVN_ACC32(d) WVN_ACC8(d, 0), WVN_ACC8(d, 8), WVN_ACC8(d, 16), WVN_ACC8(d, 24)
#define WVN_ACC64(d)                                                                                          \
  WVN_ACC8(d, 0), WVN_ACC8(d, 8), WVN_ACC8(d, 16), WVN_ACC8(d, 24), WVN_ACC8(d, 32), WVN_ACC8(d, 40),         \
      WVN_ACC8(d, 48), WVN_ACC8(d, 56)
#define WVN_ACC128(d)                                                                                         \
  WVN_ACC8(d, 0), WVN_ACC8(d, 8), WVN_ACC8(d, 16), WVN_ACC8(d, 24), WVN_ACC8(d, 32), WVN_ACC8(d, 40),         \
      WVN_ACC8(d, 48), WVN_ACC8(d, 56), WVN_ACC8(d, 64), WVN_ACC8(d, 72), WVN_ACC8(d, 80), WVN_ACC8(d, 88),   \
      WVN_ACC8(d, 96), WVN_ACC8(d, 104), WVN_ACC8(d, 112), WVN_ACC8(d, 120)

#define WVN_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WVN_REGS32                                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WVN_REGS64                                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WVN_REGS128                                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, "  \
  "%65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, " \
  "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "     \
  "%123, %124, %125, %126, %127}"

// d (+)= A B, m64nNk16, A and B from shared memory, both K-major (QK^T).
// NR = N / 2 accumulators per thread; IA, IB, IP: the operand numbers after them.
#define WVN_WGMMA_SS(N, NR, IA, IB, IP)                                                                      \
  __device__ __forceinline__ void wgmma_ss(float(&d)[NR], uint64_t da, uint64_t db, int accumulate) {       \
    asm volatile(                                                                                            \
        "{\n"                                                                                                \
        ".reg .pred p;\n"                                                                                    \
        "setp.ne.b32 p, %" #IP ", 0;\n"                                                                      \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " WVN_REGS##NR ", %" #IA ", %" #IB         \
        ", p, 1, 1, 0, 0;\n"                                                                                 \
        "}\n"                                                                                                \
        : WVN_ACC##NR(d)                                                                                     \
        : "l"(da), "l"(db), "r"(accumulate));                                                                \
  }
WVN_WGMMA_SS(64, 32, 32, 33, 34)
WVN_WGMMA_SS(128, 64, 64, 65, 66)

// d += A B, m64nNk16, A (four bf16 pairs per thread) from registers, B from
// shared memory MN-major (transposed) (PV).
#define WVN_WGMMA_RS(N, NR, IA0, IA1, IA2, IA3, IB, IP)                                                      \
  __device__ __forceinline__ void wgmma_rs(float(&d)[NR], const uint32_t(&a)[4], uint64_t db) {             \
    asm volatile(                                                                                            \
        "{\n"                                                                                                \
        ".reg .pred p;\n"                                                                                    \
        "setp.ne.b32 p, %" #IP ", 0;\n"                                                                      \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " WVN_REGS##NR ", {%" #IA0 ", %" #IA1      \
        ", %" #IA2 ", %" #IA3 "}, %" #IB ", p, 1, 1, 1;\n"                                                   \
        "}\n"                                                                                                \
        : WVN_ACC##NR(d)                                                                                     \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));                                      \
  }
WVN_WGMMA_RS(32, 16, 16, 17, 18, 19, 20, 21)
WVN_WGMMA_RS(64, 32, 32, 33, 34, 35, 36, 37)
WVN_WGMMA_RS(128, 64, 64, 65, 66, 67, 68, 69)
WVN_WGMMA_RS(256, 128, 128, 129, 130, 131, 132, 133)

// Pins the registers' definitions before a wgmma pipeline stage starts (and
// their uses after it ends), so the compiler moves no plain instruction on
// them into the stage, which would make ptxas serialize the wgmmas.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// pos[i]: which of the map's outer axes (0, 1, 2 after d) holds S, H and B.
struct AxisPos {
  int s, h, b;
};

__device__ __forceinline__ void box_coords(int (&c)[4], AxisPos pos, int col, int row, int h, int b) {
  c[0] = col;
  c[1] = pos.s == 0 ? row : pos.h == 0 ? h : b;
  c[2] = pos.s == 1 ? row : pos.h == 1 ? h : b;
  c[3] = pos.s == 2 ? row : pos.h == 2 ? h : b;
}

// Accumulator fragment of m64nNk16 (fp32): thread t of the warpgroup holds
// rows 16 * (t / 32) + (t % 32) / 4 + 8 i, columns 8 j + 2 (t % 4) + c, in
// register 4 j + 2 i + c.
//
// One online-softmax step (log2 domain) on the scores of the BK-row kv tile
// at kv0: masks columns beyond S, updates the running max m and this
// thread's share of the row sums l, returns each row's rescale alpha and P
// rounded to bf16 as the A fragments of PV (k-step ks covers columns 16 ks ..
// 16 ks + 15).
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], int kv0, int S, float scale_log2, float (&m)[2],
                                             float (&l)[2], float (&alpha)[2], uint32_t (&p)[BK / 16][4]) {
  const int lane = threadIdx.x % 32;
  float mx[2] = {kMask, kMask};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = 4 * j + 2 * i + c;
        s[r] = (kv0 + 8 * j + 2 * (lane % 4) + c < S) ? s[r] * scale_log2 : kMask;
        mx[i] = fmaxf(mx[i], s[r]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_next = fmaxf(m[i], mx[i]);
    alpha[i] = exp2f(m[i] - m_next);
    m[i] = m_next;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int r = 0; r < BK / 2; ++r) {
    s[r] = exp2f(s[r] - m[(r / 2) % 2]);
    l[(r / 2) % 2] += s[r];
  }
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
#pragma unroll
    for (int h = 0; h < 4; ++h) p[ks][h] = pack_bf16(s[8 * ks + 2 * h], s[8 * ks + 2 * h + 1]);
  }
}

// One BK-row tile of K or V, one TMA box per panel, by thread 0.
template <int D, int BQ, int BK>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const CUtensorMap* map, uint64_t* bar, AxisPos pos,
                                          int row, int h, int b) {
  using T = Tile<D, BQ, BK>;
  int c[4];
  mbar_expect_tx(bar, T::kTileBytes);
#pragma unroll
  for (int p = 0; p < T::kPanels; ++p) {
    box_coords(c, pos, p * T::kPanelCols, row, h, b);
    tma_load(dst + p * BK * T::kPanelCols, map, bar, c);
  }
}

// QK^T of this warpgroup's 64 query rows against one K tile: D / 16 k-steps,
// each reading 32 bytes of a row of both operands' panels.
template <int D, int BQ, int BK>
__device__ __forceinline__ void qk_product(float (&s)[BK / 2], uint64_t dq, uint64_t dk) {
  using T = Tile<D, BQ, BK>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int panel = kk / T::kStepsPerPanel, step = kk % T::kStepsPerPanel;
    wgmma_ss(s, dq + (panel * BQ * T::kRowBytes + step * 32) / 16, dk + (panel * BK * T::kRowBytes + step * 32) / 16,
             kk > 0);
  }
}

// O += P V over one V tile: BK / 16 k-steps of 16 kv rows each.
template <int D, int BQ, int BK>
__device__ __forceinline__ void pv_product(float (&oacc)[D / 2], const uint32_t (&pa)[BK / 16][4], uint64_t dv) {
  using T = Tile<D, BQ, BK>;
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) wgmma_rs(oacc, pa[ks], dv + 16 * T::kRowBytes / 16 * ks);
}

// Iteration t issues S_t = Q K_t^T and O += P_{t-1} V_{t-1} back to back, so
// the tensor cores run both without a softmax between them, then waits for
// both and computes P_t.  (Waiting for S_t alone, to run the softmax while
// PV is in flight as FlashAttention-3 does, made ptxas serialize the wgmmas
// (C7513) and measured no faster.)  K and V have their own two-stage
// rings: K_{t+2} and V_{t+1} are loaded once the iteration's products have
// released their stages.
template <int D, int BQ, int BK>
__global__ void __launch_bounds__(Tile<D, BQ, BK>::kThreads)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, AxisPos pq, AxisPos pk, AxisPos pv,
                      __nv_bfloat16* __restrict__ o, long long so_b, long long so_h, long long so_s, int H, int S,
                      float scale_log2) {
  using T = Tile<D, BQ, BK>;
  using Smem = TileSmem<D, BQ, BK>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x;
  // this thread's warpgroup and its warp in it
  const int wg = T::kWarpgroups == 1 ? 0 : tid / 128;
  const int warp = T::kWarpgroups == 1 ? tid / 32 : (tid / 32) % 4, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int ntiles = (S + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(&sm.bar_q, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.bar_k[i], 1);
      mbar_init(&sm.bar_v[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    int c[4];
    mbar_expect_tx(&sm.bar_q, T::kQBytes);
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p) {
      box_coords(c, pq, p * T::kPanelCols, q0, h, b);
      tma_load(sm.q + p * BQ * T::kPanelCols, &tq, &sm.bar_q, c);
    }
    for (int t = 0; t < 2 && t < ntiles; ++t) {
      load_tile<D, BQ, BK>(sm.k[t], &tk, &sm.bar_k[t], pk, t * BK, h, b);
      load_tile<D, BQ, BK>(sm.v[t], &tv, &sm.bar_v[t], pv, t * BK, h, b);
    }
  }

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float alpha[2];
  float s[BK / 2];
  uint32_t pa[BK / 16][4];
  const uint64_t dq = smem_desc<D, BQ, BK>(sm.q + wg * 64 * T::kPanelCols, 1);
  mbar_wait(&sm.bar_q, 0);

  // tile 0: S_0 and its softmax
  const uint64_t dk0 = smem_desc<D, BQ, BK>(sm.k[0], 1);
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  mbar_wait(&sm.bar_k[0], 0);
  fence_regs(s);
  __syncwarp();
  wgmma_fence();
  qk_product<D, BQ, BK>(s, dq, dk0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile<BK>(s, 0, S, scale_log2, m, l, alpha, pa);
  __syncthreads();  // K stage 0 is free
  if (tid == 0 && ntiles > 2) load_tile<D, BQ, BK>(sm.k[0], &tk, &sm.bar_k[0], pk, 2 * BK, h, b);

  for (int t = 1; t < ntiles; ++t) {
    const int st = t & 1, sp = st ^ 1;  // stages of K_t and of V_{t-1}
    const uint64_t dk = smem_desc<D, BQ, BK>(sm.k[st], 1), dv = smem_desc<D, BQ, BK>(sm.v[sp], T::kVLBO);
    mbar_wait(&sm.bar_k[st], (t >> 1) & 1);
    mbar_wait(&sm.bar_v[sp], ((t - 1) >> 1) & 1);
    fence_regs(s);
    fence_regs(oacc);
    fence_regs(pa);
    __syncwarp();
    wgmma_fence();
    qk_product<D, BQ, BK>(s, dq, dk);
    wgmma_commit();
    pv_product<D, BQ, BK>(oacc, pa, dv);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(oacc);
    fence_regs(pa);
    softmax_tile<BK>(s, t * BK, S, scale_log2, m, l, alpha, pa);
#pragma unroll
    for (int r = 0; r < D / 2; ++r) oacc[r] *= alpha[(r / 2) % 2];
    __syncthreads();  // every warp is done with K_t's and V_{t-1}'s stages
    if (tid == 0) {
      if (t + 2 < ntiles) load_tile<D, BQ, BK>(sm.k[st], &tk, &sm.bar_k[st], pk, (t + 2) * BK, h, b);
      if (t + 1 < ntiles) load_tile<D, BQ, BK>(sm.v[sp], &tv, &sm.bar_v[sp], pv, (t + 1) * BK, h, b);
    }
  }

  // the last tile's PV
  const int last = ntiles - 1;
  const uint64_t dv = smem_desc<D, BQ, BK>(sm.v[last & 1], T::kVLBO);
  mbar_wait(&sm.bar_v[last & 1], (last >> 1) & 1);
  fence_regs(oacc);
  fence_regs(pa);
  __syncwarp();
  wgmma_fence();
  pv_product<D, BQ, BK>(oacc, pa, dv);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(oacc);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  __nv_bfloat16* ob = o + b * so_b + h * so_h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 64 * wg + 16 * warp + lane / 4 + 8 * i;
    if (row >= S) continue;
    const float inv = (l[i] == 0.f) ? 1.f : 1.f / l[i];
    __nv_bfloat16* orow = ob + row * so_s + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(oacc[4 * j + 2 * i] * inv, oacc[4 * j + 2 * i + 1] * inv);
    }
  }
}

// ------------------------------------------------------------------ host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                           &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d map of one bf16 tensor: d innermost, then its B, H and S axes in the
// order of increasing stride; a box is `cols` along d (one swizzled panel:
// 128 B, or 64 B at D = 32) and `rows` along S (1 along the others), and rows
// beyond S are zero-filled.
bool make_map(CUtensorMap* map, AxisPos* pos, const void* ptr, const long long* stride, int B, int H, int S, int D,
              int cols, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const long long sizes[3] = {B, H, S};  // the (B, H, S) axes of `stride`
  int order[3] = {2, 1, 0};              // map axis -> (B, H, S) axis; S first among equal strides
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j) {
      const int tmp = order[j];
      order[j] = order[j - 1];
      order[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, 1, 1};
  int* axis_pos[3] = {&pos->b, &pos->h, &pos->s};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(sizes[order[i]]);
    strides[i] = static_cast<cuuint64_t>(stride[order[i]]) * 2;
    *axis_pos[order[i]] = i;
    if (order[i] == 2) box[i + 1] = static_cast<cuuint32_t>(rows);
  }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = cols * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

template <int D, int BQ, int BK>
int launch_bf16(const K1Args& a) {
  using T = Tile<D, BQ, BK>;
  CUtensorMap tq, tk, tv;
  AxisPos pq, pk, pv;
  if (!make_map(&tq, &pq, a.q, a.st, a.B, a.H, a.S, D, T::kPanelCols, BQ) ||
      !make_map(&tk, &pk, a.k, a.st + 3, a.B, a.H, a.S, D, T::kPanelCols, BK) ||
      !make_map(&tv, &pv, a.v, a.st + 6, a.B, a.H, a.S, D, T::kPanelCols, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = bf16_smem_bytes<D, BQ, BK>();
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D, BQ, BK>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const dim3 grid((a.S + BQ - 1) / BQ, a.B * a.H);
  flash_fwd_bf16_kernel<D, BQ, BK><<<grid, T::kThreads, smem, a.stream>>>(
      tq, tk, tv, pq, pk, pv, static_cast<__nv_bfloat16*>(a.o), a.st[9], a.st[10], a.st[11], a.H, a.S,
      a.scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const K1Args& a) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = a.st[i];
    st.k[i] = a.st[3 + i];
    st.v[i] = a.st[6 + i];
    st.o[i] = a.st[9 + i];
  }
  constexpr size_t smem = f32_smem_bytes<D>();
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.B * a.H);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, a.stream>>>(static_cast<const float*>(a.q),
                                                              static_cast<const float*>(a.k),
                                                              static_cast<const float*>(a.v),
                                                              static_cast<float*>(a.o), st, a.H, a.S, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 tiles (BQ, BK) instantiated at head dim D: all four up to
// D = 128; at D = 256 only BK = 64 (BK = 128 needs 288 KB of shared memory).
// ops/flash_attention.py::TILES holds the same table.
template <int D>
constexpr bool has_tile(int bq, int bk) {
  return (bq == 64 || bq == 128) && (bk == 64 || (bk == 128 && D <= 128));
}

// dtype 0 = float32 (its own tile: bq = bk = 0), 1 = bfloat16 at (bq, bk).
template <int D>
int dispatch(const K1Args& a, int dtype, int bq, int bk) {
  if (dtype == 0) return bq == 0 && bk == 0 ? launch_f32<D>(a) : static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 1 || !has_tile<D>(bq, bk)) return static_cast<int>(cudaErrorInvalidValue);
  if (bq == 64 && bk == 64) return launch_bf16<D, 64, 64>(a);
  if (bq == 128 && bk == 64) return launch_bf16<D, 128, 64>(a);
  if constexpr (D <= 128) {
    if (bq == 64) return launch_bf16<D, 64, 128>(a);
    return launch_bf16<D, 128, 128>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int smem_bytes(int dtype, int bq, int bk) {
  if (dtype == 0) return static_cast<int>(f32_smem_bytes<D>());
  if (!has_tile<D>(bq, bk)) return -1;
  if (bq == 64 && bk == 64) return static_cast<int>(bf16_smem_bytes<D, 64, 64>());
  if (bq == 128 && bk == 64) return static_cast<int>(bf16_smem_bytes<D, 128, 64>());
  if constexpr (D <= 128) return static_cast<int>(bq == 64 ? bf16_smem_bytes<D, 64, 128>() : bf16_smem_bytes<D, 128, 128>());
  return -1;
}

}  // namespace

// The entry of head dim D's unit, and its dynamic shared memory per tile.
#define WVN_K1_DEFINE_D(D)                                                                      \
  int wvn_k1_d##D(const K1Args& a, int dtype, int bq, int bk) { return dispatch<D>(a, dtype, bq, bk); } \
  int wvn_k1_smem_d##D(int dtype, int bq, int bk) { return smem_bytes<D>(dtype, bq, bk); }

#define WVN_K1_DECLARE_D(D)                                  \
  int wvn_k1_d##D(const K1Args& a, int dtype, int bq, int bk); \
  int wvn_k1_smem_d##D(int dtype, int bq, int bk);
