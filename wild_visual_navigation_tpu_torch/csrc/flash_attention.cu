// K1: forward, non-causal flash attention for the ViT backbone.
//
// Replaces wild_visual_navigation_tpu/ops/flash_attention.py::flash_attention
// (Pallas body _flash_kernel).  Computes softmax(q k^T * scale) v for q, k,
// v of shape (B, H, S, D = 64) with an online softmax, so the (S, S) score
// matrix never reaches device memory.  q, k, v and o may have any strides
// for B, H and S (a contiguous D axis), so the ViT passes views of its qkv
// product and reads o as a view of a (B, S, H, D) buffer with no copies.
//
// What bounds it on an H100: at the main path's shape (B*H = 6, S = 785,
// D = 64) the work is 4 * 6 * 785^2 * 64 = 0.95 GFLOP per call against
// 2.4 MB of operands, so it is bound by the tensor cores' operations
// (0.96 us at 989 TFLOP/s bf16).  Below that, what a block can overlap
// bounds it: one block owns 64 query rows of one (batch, head), so B=1
// gives 13 x 6 = 78 blocks on 132 SMs.
//
// bf16 (the main path): one warpgroup of 128 threads per block.
//  * S = Q K^T with wgmma m64n64k16 (bf16 in, fp32 accumulators), Q and the
//    K tile both read from shared memory, both K-major (D is contiguous).
//  * The online softmax runs in registers on the accumulator fragment, with
//    a fp32 running max and sum; a row's four lanes reduce with shuffles.
//    Columns beyond S take the TPU kernel's finite mask -0.7 * FLT_MAX.
//  * O += P V with a second wgmma: P rounded to bf16 in registers (where the
//    reference rounds p.astype(v.dtype)) is the A operand, reusing the
//    accumulator layout; V is the B operand from shared memory, MN-major.
//  * Q is loaded once; 64-row K and V tiles go through two-stage rings in
//    shared memory, all by TMA (cp.async.bulk.tensor, 128-byte swizzle: one
//    64-wide bf16 row is 128 B) with mbarrier completion, loaded a tile or
//    two ahead.  The copy zero-fills rows beyond S (785 = 12 * 64 + 17),
//    and the scores mask them.
//  * The kv loop issues S_t = Q K_t^T and O += P_{t-1} V_{t-1} back to
//    back, one softmax per tile between such pairs.
//  * The tensor maps are built on the host per call with
//    cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so the
//    library needs no -lcuda, and passed as __grid_constant__ parameters.
// fp32: the SIMT body of the first version (fp32 FMAs from shared memory,
// 256 threads per 64 query rows, 32-row kv tiles), which keeps fp32 accuracy;
// TF32 tensor cores would not.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;  // head dim (the only one either body takes)
// Same finite mask value as the TPU kernel: exp() of it never gives NaN.
constexpr float kMask = -0.7f * FLT_MAX;

// (B, H, S) strides, in elements, of q, k, v and o.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// ------------------------------------------------------------------ fp32 SIMT body

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // kv rows per tile
constexpr int kTPR = 4;        // threads per query row
constexpr int kThreads = kBQ * kTPR;
constexpr int kCols = kBK / kTPR;  // score columns per thread per tile
constexpr int kOut = kD / kTPR;    // output features per thread
constexpr int kPad = kD + 1;

__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, Strides st, int H, int S, float scale) {
  __shared__ float qs[kBQ][kPad];
  __shared__ float ks[kBK][kPad];
  __shared__ float vs[kBK][kPad];
  __shared__ float ps[kBQ][kBK + 1];

  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int c = tid % kTPR;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];

  for (int i = tid; i < kBQ * kD; i += kThreads) {
    const int row = i / kD, d = i % kD;
    qs[row][d] = (q0 + row < S) ? qb[(q0 + row) * st.q[2] + d] : 0.f;
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
      ks[row][d] = in ? kb[(kv0 + row) * st.k[2] + d] : 0.f;
      vs[row][d] = in ? vb[(kv0 + row) * st.v[2] + d] : 0.f;
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

constexpr int kRows = 64;                      // query rows per block = kv rows per tile
constexpr int kTileBytes = kRows * kD * 2;     // one 64 x 64 bf16 tile: 8 KB
constexpr int kWgThreads = 128;                // one warpgroup

struct alignas(1024) TileSmem {
  __nv_bfloat16 q[kRows * kD];
  __nv_bfloat16 k[2][kRows * kD];
  __nv_bfloat16 v[2][kRows * kD];
  uint64_t bar_q;
  uint64_t bar_k[2];
  uint64_t bar_v[2];
};
constexpr size_t kWgSmem = sizeof(TileSmem) + 1024;  // + room to align the dynamic base to 1024 B

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

// One 64 x 64 bf16 box of a 4-d tensor map (d, then the three outer axes in
// the map's order) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, const int (&c)[4]) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3])
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile whose rows are
// 128 B: stride between 8-row groups (SBO) 1024 B, leading offset unused (1).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (static_cast<uint64_t>(smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define WVN_ACC32(d)                                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),  \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),  \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WVN_REGS32                                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B, m64n64k16, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WVN_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WVN_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n64k16, A (four bf16 pairs per thread) from registers, B from
// shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WVN_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WVN_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Pins the registers' definitions before a wgmma pipeline stage starts (and
// their uses after it ends), so the compiler moves no plain instruction on
// them into the stage, which would make ptxas serialize the wgmmas.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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

__device__ __forceinline__ void box_coords(int (&c)[4], AxisPos pos, int row, int h, int b) {
  c[0] = 0;
  c[1] = pos.s == 0 ? row : pos.h == 0 ? h : b;
  c[2] = pos.s == 1 ? row : pos.h == 1 ? h : b;
  c[3] = pos.s == 2 ? row : pos.h == 2 ? h : b;
}

// Accumulator fragment of m64nNk16 (fp32): thread t of the warpgroup holds
// rows 16 * (t / 32) + (t % 32) / 4 + 8 i, columns 8 j + 2 (t % 4) + c, in
// register 4 j + 2 i + c.
//
// One online-softmax step (log2 domain) on the scores of the kv tile at
// kv0: masks columns beyond S, updates the running max m and this thread's
// share of the row sums l, returns each row's rescale alpha and P rounded to
// bf16 as the A fragments of PV (k-step ks covers columns 16 ks .. 16 ks + 15).
__device__ __forceinline__ void softmax_tile(float (&s)[32], int kv0, int S, float scale_log2, float (&m)[2],
                                             float (&l)[2], float (&alpha)[2], uint32_t (&p)[4][4]) {
  const int lane = threadIdx.x % 32;
  float mx[2] = {kMask, kMask};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
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
  for (int r = 0; r < 32; ++r) {
    s[r] = exp2f(s[r] - m[(r / 2) % 2]);
    l[(r / 2) % 2] += s[r];
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int h = 0; h < 4; ++h) p[ks][h] = pack_bf16(s[8 * ks + 2 * h], s[8 * ks + 2 * h + 1]);
  }
}

// One 64-row tile of K or V, by thread 0.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const CUtensorMap* map, uint64_t* bar, AxisPos pos,
                                          int row, int h, int b) {
  int c[4];
  mbar_expect_tx(bar, kTileBytes);
  box_coords(c, pos, row, h, b);
  tma_load(dst, map, bar, c);
}

// Iteration t issues S_t = Q K_t^T and O += P_{t-1} V_{t-1} back to back, so
// the tensor cores run both without a softmax between them, then waits for
// both and computes P_t.  (Waiting for S_t alone, to run the softmax while
// PV is in flight as FlashAttention-3 does, made ptxas serialize the wgmmas
// (C7513) and measured no faster.)  K and V have their own two-stage
// rings: K_{t+2} and V_{t+1} are loaded once the iteration's products have
// released their stages.
__global__ void __launch_bounds__(kWgThreads)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, AxisPos pq, AxisPos pk, AxisPos pv,
                      __nv_bfloat16* __restrict__ o, long long so_b, long long so_h, long long so_s, int H, int S,
                      float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  TileSmem& sm = *reinterpret_cast<TileSmem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kRows;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int ntiles = (S + kRows - 1) / kRows;

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
    mbar_expect_tx(&sm.bar_q, kTileBytes);
    box_coords(c, pq, q0, h, b);
    tma_load(sm.q, &tq, &sm.bar_q, c);
    for (int t = 0; t < 2 && t < ntiles; ++t) {
      load_tile(sm.k[t], &tk, &sm.bar_k[t], pk, t * kRows, h, b);
      load_tile(sm.v[t], &tv, &sm.bar_v[t], pv, t * kRows, h, b);
    }
  }

  float oacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float alpha[2];
  float s[32];
  uint32_t pa[4][4];
  const uint64_t dq = sw128_desc(sm.q);
  mbar_wait(&sm.bar_q, 0);

  // tile 0: S_0 and its softmax
  const uint64_t dk0 = sw128_desc(sm.k[0]);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  mbar_wait(&sm.bar_k[0], 0);
  fence_regs(s);
  __syncwarp();
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, dq + 2 * kk, dk0 + 2 * kk, kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile(s, 0, S, scale_log2, m, l, alpha, pa);
  __syncthreads();  // K stage 0 is free
  if (tid == 0 && ntiles > 2) load_tile(sm.k[0], &tk, &sm.bar_k[0], pk, 2 * kRows, h, b);

  for (int t = 1; t < ntiles; ++t) {
    const int st = t & 1, sp = st ^ 1;  // stages of K_t and of V_{t-1}
    const uint64_t dk = sw128_desc(sm.k[st]), dv = sw128_desc(sm.v[sp]);
    mbar_wait(&sm.bar_k[st], (t >> 1) & 1);
    mbar_wait(&sm.bar_v[sp], ((t - 1) >> 1) & 1);
    fence_regs(s);
    fence_regs(oacc);
    fence_regs(pa);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs(oacc, pa[ks], dv + 128 * ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(oacc);
    fence_regs(pa);
    softmax_tile(s, t * kRows, S, scale_log2, m, l, alpha, pa);
#pragma unroll
    for (int r = 0; r < 32; ++r) oacc[r] *= alpha[(r / 2) % 2];
    __syncthreads();  // every warp is done with K_t's and V_{t-1}'s stages
    if (tid == 0) {
      if (t + 2 < ntiles) load_tile(sm.k[st], &tk, &sm.bar_k[st], pk, (t + 2) * kRows, h, b);
      if (t + 1 < ntiles) load_tile(sm.v[sp], &tv, &sm.bar_v[sp], pv, (t + 1) * kRows, h, b);
    }
  }

  // the last tile's PV
  const int last = ntiles - 1;
  const uint64_t dv = sw128_desc(sm.v[last & 1]);
  mbar_wait(&sm.bar_v[last & 1], (last >> 1) & 1);
  fence_regs(oacc);
  fence_regs(pa);
  __syncwarp();
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_rs(oacc, pa[ks], dv + 128 * ks);
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
    const int row = q0 + 16 * warp + lane / 4 + 8 * i;
    if (row >= S) continue;
    const float inv = (l[i] == 0.f) ? 1.f : 1.f / l[i];
    __nv_bfloat16* orow = ob + row * so_s + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
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
// order of increasing stride; a box is 64 along d and 64 along S (1 along
// the others), so in shared memory it is always a 64 x 128 B tile, with the
// 128-byte swizzle, and rows beyond S are zero-filled.
bool make_map(CUtensorMap* map, AxisPos* pos, const void* ptr, const long long (&stride)[3], int B, int H, int S) {
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
  cuuint64_t dims[4] = {kD, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {kD, 1, 1, 1};
  int* axis_pos[3] = {&pos->b, &pos->h, &pos->s};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(sizes[order[i]]);
    strides[i] = static_cast<cuuint64_t>(stride[order[i]]) * 2;
    *axis_pos[order[i]] = i;
    if (order[i] == 2) box[i + 1] = kRows;
  }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

}  // namespace

// q, k, v, o: (B, H, S, D = 64) with a contiguous D axis; strides points to
// 12 int64 on the host, the (B, H, S) strides in elements of q, k, v and o.
// dtype 0 = float32, 1 = bfloat16. bf16 needs 16-byte aligned bases and
// strides (the wrapper checks).
extern "C" int wvn_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, const void* strides,
                                       int B, int H, int S, int D, int dtype, float scale, void* stream) {
  if (D != kD || B <= 0 || H <= 0 || S <= 0 || static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  const long long* sp = static_cast<const long long*>(strides);
  for (int i = 0; i < 3; ++i) {
    st.q[i] = sp[i];
    st.k[i] = sp[3 + i];
    st.v[i] = sp[6 + i];
    st.o[i] = sp[9 + i];
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((S + kBQ - 1) / kBQ, B * H);
    flash_fwd_f32_kernel<<<grid, kThreads, 0, cs>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                    static_cast<const float*>(v), static_cast<float*>(o), st, H, S,
                                                    scale);
  } else if (dtype == 1) {
    CUtensorMap tq, tk, tv;
    AxisPos pq, pk, pv;
    if (!make_map(&tq, &pq, q, st.q, B, H, S) || !make_map(&tk, &pk, k, st.k, B, H, S) ||
        !make_map(&tv, &pv, v, st.v, B, H, S))
      return static_cast<int>(cudaErrorInvalidValue);
    static bool smem_set = false;
    if (!smem_set) {
      const cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(kWgSmem));
      if (e != cudaSuccess) return static_cast<int>(e);
      smem_set = true;
    }
    const dim3 grid((S + kRows - 1) / kRows, B * H);
    flash_fwd_bf16_kernel<<<grid, kWgThreads, kWgSmem, cs>>>(
        tq, tk, tv, pq, pk, pv, static_cast<__nv_bfloat16*>(o), st.o[0], st.o[1], st.o[2], H, S,
        scale * 1.4426950408889634f);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wvn_flash_attention_smem_bytes() { return static_cast<int>(kWgSmem); }

extern "C" const char* wvn_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
