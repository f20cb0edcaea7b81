// K3: one SLIC Lloyd step -- assignment, per-cluster sums and the centre
// update -- in one launch, the sums joined on chip inside thread-block
// clusters.
//
// Replaces wild_visual_navigation_tpu/ops/slic_fused.py::_slic_step (Pallas
// body _kernel) together with the division of its host loop, driven by
// ops/slic_fused.py::slic_batch_fused.  Per pixel: the squared 5-d distance
// (L, a, b, y*ws, x*ws) to every centre whose unscaled spatial distance is
// within the 2S window, first-index argmin, and the orphan fallback to the
// spatially nearest centre.  Then per-cluster sums (five features and a
// count), and new centres = sums / count, an empty cluster keeping its
// centre.
//
// Layout (ops/slic_fused.py::step_layout picks it from the image's shape,
// K and the clusters of 16 CTAs the card holds at once, never from the
// batch): an image's 16 x 16 tiles (row-major, ragged ones at the right
// and bottom masked) are split evenly over `clusters` thread-block clusters
// of `cluster_size` CTAs, grid (clusters * cluster_size, B).  A CTA takes
// `tiles` tiles with `parts` (8, 4, 2 or 1) warps each: warp g of a tile
// takes its rows 16 g / parts .. 16 (g + 1) / parts - 1, its lanes laid
// 4 x 8 over them (2 x 16 at 8 parts), each lane kR rows x kC columns, 4
// (2) rows and 8 (16) columns apart.  The lanes' i-th pixels form a block,
// a "set".  On an H100 one 224 x 224 image spreads over the 7 clusters of
// 16 CTAs the card holds at once, 2 tiles of 8 warps to a CTA, each with a
// short serial chain.
//
// Exact per-tile candidates.  Before the assignment, the CTA lists for each
// tile, in increasing k, the centres whose spatial position (cy, cx) lies
// within sqrt(win2) of the tile's bounding box, with a margin:
//
//   candidate  <=>  dy^2 + dx^2 <= win2 + 2^-18 * (P + 2Q + C + win2)
//
// where (dy, dx) is the distance from (cy, cx) to the box,
// P = y1^2 + x1^2 for the box's far corner (y1, x1), Q = y1*|cy| + x1*|cx|
// and C = cy^2 + cx^2.  The pixel's window test evaluates the expanded form
// d2s = yx2 - 2*(py*cy + px*cx) + cyx2 in fp32 with six roundings; its
// absolute error is below 8u (P + Q + C) with u = 2^-24, which the margin
// (64u (P + 2Q + C + win2)) covers together with the rounding of the
// candidate test itself.  A centre that passes d2s <= win2 at any pixel of
// the tile is therefore on its list, the windowed first-index argmin over
// the list equals the one over all K, and a pixel with no passing candidate
// is exactly a pixel with no passing centre at all: an orphan, which alone
// scans all K for the spatially nearest centre.  Single-step ids stay
// bit-identical to ops/slic.py::_assign_plain, whose expression order the
// _rn intrinsics (never contracted into FMAs) follow; p2 - 2*dots is one
// fmaf, exact because 2*dots is.  The rule is written once more in torch as
// ops/slic_fused.py::tile_candidates_plain.
//
// Deterministic sums with no fp32 atomics.  A warp adds its pixels into its
// own row of each cluster in shared memory (zero where it saw no pixel of
// it), one set at a time, a masked xor butterfly for each cluster the set
// holds, kept by the cluster's lowest lane.  The CTA adds its warps' rows
// in warp order and sends each row to the cluster's CTA that owns the
// centre (CTA r owns centres [r K / size, (r + 1) K / size)), into that
// CTA's inbox through distributed shared memory (cluster.map_shared_rank).
// After one cluster barrier an owner adds its inbox in rank order and
// writes its slice's sums to `partials` once; the last CTA of its rank to
// take the image's ticket (an acquire-release fence and an atomic; at once
// where one cluster holds the image) adds the clusters' sums in cluster
// order, divides with __fdiv_rn (an empty cluster keeps its centre), writes
// the new centres and resets the ticket.  The same inputs give bitwise the
// same ids and centres on every run.
//
// Consecutive steps overlap a little (programmatic dependent launch): once
// a step's CTAs are past the cluster barrier, the next launch on the stream
// may take SMs beside them; it zeroes its rows and waits at
// griddepcontrol.wait for the step to finish before it reads device memory.
//
// What bounds it on an H100: the (pixel, candidate) pairs, 19-20 fp32
// instructions each -- 15 candidates per pixel at 224 x 224 with K = 100 on
// grid-initialised centres, against the dense 100 -- plus K for each orphan
// pixel; device memory sees one read of the features (1 MB per image) and
// the ids.  Spread over the card, that is well under a microsecond; what a
// launch takes is its chains of dependent reads -- the centres, each warp's
// candidates, the sums' shuffles, the cluster barrier and the global level
// (tools/profile_torch_k3.py splits it).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 16;
constexpr int kMaxK = 512;
constexpr int kMaxWarps = 16;
constexpr int kMaxCluster = 16;
constexpr int kRow = 6;  // a cluster's sums: five features and the count
constexpr float kTolScale = 3.814697265625e-06f;  // 2^-18
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemLimit = 232448 - 16;  // 227 KB less the kernel's static shared memory

// Whether this block is the last of `count` to take a ticket.  The block's
// writes are ordered before its ticket, and the other blocks' writes before
// the last block's reads, by one thread's acquire-release fences between
// block barriers; the other threads need no fence.
__device__ __forceinline__ bool last_to_finish(unsigned* ticket, int count, int* last_s) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    *last_s = atomicAdd(ticket, 1u) == static_cast<unsigned>(count - 1);
    if (*last_s) asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  }
  __syncthreads();
  return *last_s != 0;
}

__device__ __forceinline__ void cluster_arrive_relaxed() { asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

// d2 = p2 - 2 * (f . c) + |c|^2 in _assign_plain's order
__device__ __forceinline__ float feature_d2(const float* f, float p2, float4 a, float c4, float c2) {
  float dots = __fmul_rn(f[0], a.x);
  dots = __fadd_rn(dots, __fmul_rn(f[1], a.y));
  dots = __fadd_rn(dots, __fmul_rn(f[2], a.z));
  dots = __fadd_rn(dots, __fmul_rn(f[3], a.w));
  dots = __fadd_rn(dots, __fmul_rn(f[4], c4));
  return __fadd_rn(__fmaf_rn(-2.f, dots, p2), c2);
}

// Whether centre (cy, cx) is a candidate of the tile [fy0, fy1] x
// [fx0, fx1]: dy^2 + dx^2 <= win2 + 2^-18 (P + 2Q + C + win2), in
// tile_candidates_plain's order.
__device__ __forceinline__ bool tile_candidate(float cy, float cx, float cyx2, float fy0, float fy1, float fx0,
                                               float fx1, float win2) {
  const float dy = fmaxf(fmaxf(__fsub_rn(fy0, cy), __fsub_rn(cy, fy1)), 0.f);
  const float dx = fmaxf(fmaxf(__fsub_rn(fx0, cx), __fsub_rn(cx, fx1)), 0.f);
  const float near2 = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
  const float far2 = __fadd_rn(__fmul_rn(fy1, fy1), __fmul_rn(fx1, fx1));
  const float q = __fadd_rn(__fmul_rn(fy1, fabsf(cy)), __fmul_rn(fx1, fabsf(cx)));
  float t = __fadd_rn(far2, __fmul_rn(2.f, q));
  t = __fadd_rn(t, cyx2);
  t = __fadd_rn(t, win2);
  return near2 <= __fadd_rn(win2, __fmul_rn(t, kTolScale));
}

// A lane takes kR rows x kC columns of its warp's part of a tile: the lanes
// lie kGy x kGx (4 x 8 for kC = 2, 2 x 16 for kC = 1) over the part, and a
// lane's pixels are kGy rows and kGx columns apart.
template <int kR, int kC>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
slic_step_kernel(const float* __restrict__ feats, const float* __restrict__ centers, int* __restrict__ ids,
                 float* __restrict__ new_centers, float* __restrict__ partials, unsigned* __restrict__ tickets, int H,
                 int W, int K, int tiles, float ws, float win2) {
  constexpr int kGx = kTile / kC, kGy = 32 / kGx, kPartRows = kGy * kR, kParts = kTile / kPartRows, kPx = kR * kC;
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nwarps = blockDim.x >> 5;
  const int size = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int k_begin = rank * K / size, n_own = (rank + 1) * K / size - k_begin;
  const int owned_max = (K + size - 1) / size, nchunks = (K + 31) / 32;
  float4* cd = smem4;                                 // (K, 3): c0..c3 | c4, |c|^2, cy, cx | cyx2, -, -, -
  float* cyv = reinterpret_cast<float*>(cd + 3 * K);  // (K,) unscaled centre y
  float* cxv = cyv + K;                               // (K,) unscaled centre x
  float* cyx2v = cxv + K;                             // (K,) cy^2 + cx^2
  float* acc = cyx2v + K;                             // (nwarps, K, 6) each warp's cluster rows
  float* inbox = acc + static_cast<size_t>(nwarps) * K * kRow;  // (size, owned_max, 6) the peers' rows of the slice
  int* lists = reinterpret_cast<int*>(inbox + static_cast<size_t>(size) * owned_max * kRow);  // (tiles, nchunks, 32)
  int* counts = reinterpret_cast<int*>(lists + tiles * nchunks * 32);  // (tiles, nchunks)
  __shared__ int last_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int HW = H * W;
  const int ntx = (W + kTile - 1) / kTile, ntiles = ntx * ((H + kTile - 1) / kTile);
  const int t_begin = static_cast<int>(static_cast<long long>(blockIdx.x) * ntiles / gridDim.x);
  const int n_tiles = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * ntiles / gridDim.x) - t_begin;
  const float* cb = centers + static_cast<size_t>(b) * K * 5;

  // Each warp zeroes its rows, then waits for the launch before it on the
  // stream to finish (programmatic dependent launch: this grid may start
  // while that one ends) before it reads anything from device memory.  The
  // CTA's arrival here, and its wait before step 5, make sure every peer of
  // the cluster runs before one writes into another's shared memory.
  float* aw = acc + static_cast<size_t>(warp) * K * kRow;
  for (int i = lane; i < K * kRow; i += 32) aw[i] = 0.f;
  cluster_arrive_relaxed();
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // this warp's tile and part, and its pixels' features (in flight while
  // the centres are prepared and the candidates listed)
  const int slot = warp / kParts, part = warp % kParts;
  const bool working = slot < n_tiles;
  const int t = t_begin + slot;
  const int ty0 = (t / ntx) * kTile, tx0 = (t % ntx) * kTile;
  const int py0 = ty0 + kPartRows * part + lane / kGx, px0 = tx0 + lane % kGx;
  float f[kPx][5];
  bool valid[kPx];
#pragma unroll
  for (int i = 0; i < kPx; ++i) {
    const int y = py0 + kGy * (i / kC), x = px0 + kGx * (i % kC);
    valid[i] = working && y < H && x < W;
#pragma unroll
    for (int ch = 0; ch < 5; ++ch)
      f[i][ch] = valid[i] ? __ldg(feats + (static_cast<size_t>(b) * 5 + ch) * HW + y * W + x) : 0.f;
  }

  // 1. the centres and their derived terms, in the plain version's order
  for (int k = tid; k < K; k += blockDim.x) {
    float c[5];
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) c[ch] = cb[5 * k + ch];
    float s = __fmul_rn(c[0], c[0]);
#pragma unroll
    for (int ch = 1; ch < 5; ++ch) s = __fadd_rn(s, __fmul_rn(c[ch], c[ch]));
    const float y = __fdiv_rn(c[3], ws), x = __fdiv_rn(c[4], ws);
    const float yx2 = __fadd_rn(__fmul_rn(y, y), __fmul_rn(x, x));
    cd[3 * k] = make_float4(c[0], c[1], c[2], c[3]);
    cd[3 * k + 1] = make_float4(c[4], s, y, x);
    cd[3 * k + 2] = make_float4(yx2, 0.f, 0.f, 0.f);
    cyv[k] = y;
    cxv[k] = x;
    cyx2v[k] = yx2;
  }
  __syncthreads();

  // 2. each tile's candidates, 32 centres to a warp's task, in increasing k
  for (int task = warp; task < n_tiles * nchunks; task += nwarps) {
    const int tt = t_begin + task / nchunks, k = 32 * (task % nchunks) + lane;
    const int y0 = (tt / ntx) * kTile, x0 = (tt % ntx) * kTile;
    const bool cand = k < K && tile_candidate(cyv[k], cxv[k], cyx2v[k], static_cast<float>(y0),
                                              static_cast<float>(min(y0 + kTile - 1, H - 1)), static_cast<float>(x0),
                                              static_cast<float>(min(x0 + kTile - 1, W - 1)), win2);
    const unsigned bal = __ballot_sync(kFull, cand);
    if (cand) lists[task * 32 + __popc(bal & ((1u << lane) - 1u))] = k;
    if (lane == 0) counts[task] = __popc(bal);
  }
  __syncthreads();

  if (working) {
    // 3. assignment: windowed first-index argmin over the tile's candidates
    float py[kR], px[kC];
#pragma unroll
    for (int r = 0; r < kR; ++r) py[r] = static_cast<float>(py0 + kGy * r);
#pragma unroll
    for (int c = 0; c < kC; ++c) px[c] = static_cast<float>(px0 + kGx * c);
    float p2[kPx], yx2[kPx], best[kPx];
    int id[kPx];
#pragma unroll
    for (int i = 0; i < kPx; ++i) {
      float s = __fmul_rn(f[i][0], f[i][0]);
#pragma unroll
      for (int ch = 1; ch < 5; ++ch) s = __fadd_rn(s, __fmul_rn(f[i][ch], f[i][ch]));
      p2[i] = s;
      yx2[i] = __fadd_rn(__fmul_rn(py[i / kC], py[i / kC]), __fmul_rn(px[i % kC], px[i % kC]));
      best[i] = INFINITY;
      id[i] = -1;
    }
    const int* tl = lists + slot * nchunks * 32;
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      const int n = counts[slot * nchunks + chunk];
      for (int j = 0; j < n; ++j) {
        const int k = tl[chunk * 32 + j];  // the same for the whole warp
        const float4 ca = cd[3 * k], cq = cd[3 * k + 1];
        const float cz = cd[3 * k + 2].x;
        float ycy[kR], xcx[kC];
#pragma unroll
        for (int r = 0; r < kR; ++r) ycy[r] = __fmul_rn(py[r], cq.z);
#pragma unroll
        for (int c = 0; c < kC; ++c) xcx[c] = __fmul_rn(px[c], cq.w);
#pragma unroll
        for (int i = 0; i < kPx; ++i) {
          const float sd = __fadd_rn(ycy[i / kC], xcx[i % kC]);
          const float d2s = __fadd_rn(__fmaf_rn(-2.f, sd, yx2[i]), cz);
          const float d2 = feature_d2(f[i], p2[i], ca, cq.x, cq.y);
          if (d2s <= win2 && d2 < best[i]) {
            best[i] = d2;
            id[i] = k;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPx; ++i) {
      if (valid[i] && id[i] < 0) {  // orphan: no centre at all within the window; the spatially nearest of all K
        float best_s = INFINITY;
        id[i] = 0;
        for (int k = 0; k < K; ++k) {
          const float sd = __fadd_rn(__fmul_rn(py[i / kC], cyv[k]), __fmul_rn(px[i % kC], cxv[k]));
          const float d2s = __fadd_rn(__fmaf_rn(-2.f, sd, yx2[i]), cyx2v[k]);
          if (d2s < best_s) {
            best_s = d2s;
            id[i] = k;
          }
        }
      }
      if (valid[i]) ids[static_cast<size_t>(b) * HW + (py0 + kGy * (i / kC)) * W + px0 + kGx * (i % kC)] = id[i];
    }

    // 4. the part's sums, one set of 32 pixels (the lanes' i-th, a kGy x kGx
    // block) at a time: a masked xor butterfly for each cluster of the set,
    // kept by its lowest lane and added into the warp's row
#pragma unroll
    for (int i = 0; i < kPx; ++i) {
      const int key = valid[i] ? id[i] : -1;
      const unsigned same = __match_any_sync(kFull, key);
      const bool lead = key >= 0 && lane == __ffs(same) - 1;
      float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
      for (unsigned m = __ballot_sync(kFull, lead); m; m &= m - 1u) {
        const int src = __ffs(m) - 1;
        const int d = __shfl_sync(kFull, key, src);
        float v[5];
#pragma unroll
        for (int ch = 0; ch < 5; ++ch) v[ch] = key == d ? f[i][ch] : 0.f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int ch = 0; ch < 5; ++ch) v[ch] = __fadd_rn(v[ch], __shfl_xor_sync(kFull, v[ch], o));
        }
        if (lane == src) {
#pragma unroll
          for (int ch = 0; ch < 5; ++ch) s[ch] = v[ch];
        }
      }
      if (lead) {
        float* row = aw + key * kRow;
#pragma unroll
        for (int ch = 0; ch < 5; ++ch) row[ch] = __fadd_rn(row[ch], s[ch]);
        row[5] = __fadd_rn(row[5], static_cast<float>(__popc(same)));
      }
      __syncwarp();
    }
  }

  // 5. the CTA's rows (its warps' rows added in warp order), each sent to
  // the inbox of the cluster's CTA that owns the centre
  __syncthreads();
  cluster_wait();  // every peer of the cluster has started
  for (int k = tid; k < K; k += blockDim.x) {
    float s[kRow];
#pragma unroll
    for (int c = 0; c < kRow; ++c) s[c] = acc[k * kRow + c];
#pragma unroll 4
    for (int w = 1; w < nwarps; ++w) {
#pragma unroll
      for (int c = 0; c < kRow; ++c) s[c] = __fadd_rn(s[c], acc[(w * K + k) * kRow + c]);
    }
    const int owner = ((k + 1) * size - 1) / K;
    float* box = cluster.map_shared_rank(inbox + (rank * owned_max + k - owner * K / size) * kRow, owner);
#pragma unroll
    for (int c = 0; c < kRow; ++c) box[c] = s[c];
  }
  cluster_arrive();
  cluster_wait();  // every peer's rows are in this CTA's inbox, and no peer writes to it again
  // What is left is a few microseconds of dependent reads on a few
  // threads: the next launch on the stream may take its SMs now.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // 6. the owned centres' sums, the peers' rows added in rank order,
  // written once as this cluster's sums of the slice
  const int nclusters = gridDim.x / size;
  const size_t img = static_cast<size_t>(b) * nclusters * K * kRow;
  for (int j = tid; j < n_own; j += blockDim.x) {
    float tot[kRow];
#pragma unroll
    for (int c = 0; c < kRow; ++c) tot[c] = inbox[j * kRow + c];
#pragma unroll 4
    for (int q = 1; q < size; ++q) {
#pragma unroll
      for (int c = 0; c < kRow; ++c) tot[c] = __fadd_rn(tot[c], inbox[(q * owned_max + j) * kRow + c]);
    }
    float* row = partials + img + (static_cast<size_t>(blockIdx.x / size) * K + k_begin + j) * kRow;
#pragma unroll
    for (int c = 0; c < kRow; ++c) row[c] = tot[c];
  }

  // 7. the last CTA of each rank to finish (at once where one cluster holds
  // the image) adds the clusters' sums of its slice in cluster order,
  // divides (an empty cluster keeps its centre) and resets its ticket
  unsigned* ticket = tickets + static_cast<size_t>(b) * kMaxCluster + rank;
  if (!last_to_finish(ticket, nclusters, &last_s)) return;
  const float* cen = reinterpret_cast<const float*>(cd);
  for (int j = tid; j < n_own; j += blockDim.x) {
    const int k = k_begin + j;
    const float* p0 = partials + img + static_cast<size_t>(k) * kRow;
    float tot[kRow];
#pragma unroll
    for (int c = 0; c < kRow; ++c) tot[c] = __ldcg(p0 + c);
#pragma unroll 4
    for (int m = 1; m < nclusters; ++m) {
#pragma unroll
      for (int c = 0; c < kRow; ++c) tot[c] = __fadd_rn(tot[c], __ldcg(p0 + static_cast<size_t>(m) * K * kRow + c));
    }
#pragma unroll
    for (int ch = 0; ch < 5; ++ch)
      new_centers[(static_cast<size_t>(b) * K + k) * 5 + ch] = tot[5] > 0.f ? __fdiv_rn(tot[ch], tot[5]) : cen[12 * k + ch];
  }
  if (tid == 0) *ticket = 0u;
}

size_t smem_bytes(int K, int warps, int cluster_size, int tiles) {
  const size_t inbox = static_cast<size_t>(cluster_size) * ((K + cluster_size - 1) / cluster_size) * kRow;
  const size_t lists = static_cast<size_t>(tiles) * ((K + 31) / 32) * 33;
  return (static_cast<size_t>(15) * K + static_cast<size_t>(warps) * K * kRow + inbox + lists) * sizeof(float);
}

// A kernel's attributes: the most dynamic shared memory any launch takes,
// and clusters of up to 16 CTAs (16 is non-portable: the H100's largest).
cudaError_t set_attributes(const void* kernel) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemLimit));
  return e != cudaSuccess ? e : cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// The launch: clusters of `cluster_size` CTAs along x, and programmatic
// dependent launch (the grid may start once the launch before it on the
// stream lets it, and waits for that launch at griddepcontrol.wait).
cudaLaunchConfig_t launch_config(dim3 grid, int warps, size_t smem, int cluster_size, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
}

}  // namespace

// feats (B, 5, H*W) fp32, centers (B, K, 5) fp32 -> ids (B, H*W) int32 and
// new_centers (B, K, 5) fp32.  The layout: `clusters` clusters of
// `cluster_size` CTAs per image, each CTA `tiles` tiles of `parts` warps
// (K <= 512, cluster_size <= 16 -- the H100's largest, non-portable --,
// parts 1, 2, 4 or 8, tiles * parts <= 16 warps, shared memory within 227 KB,
// clusters * cluster_size * tiles covering the image's tiles).  Scratch:
// partials (B, clusters, K, 6) fp32, read only when clusters > 1, and
// tickets (B, 16) uint32, zero before the first launch (each launch leaves
// them zero).
extern "C" int wvn_slic_step(const void* feats, const void* centers, void* ids, void* new_centers, void* partials,
                             void* tickets, int B, int H, int W, int K, int clusters, int cluster_size, int tiles,
                             int parts, float ws, float win2, void* stream) {
  const long long ntiles = static_cast<long long>((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile);
  const int warps = tiles * parts;
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || K <= 0 || K > kMaxK || clusters <= 0 || cluster_size <= 0 ||
      cluster_size > kMaxCluster || tiles <= 0 || warps > kMaxWarps ||
      (parts != 1 && parts != 2 && parts != 4 && parts != 8) ||
      static_cast<long long>(clusters) * cluster_size * tiles < ntiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(K, warps, cluster_size, tiles);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg =
      launch_config(dim3(clusters * cluster_size, B), warps, smem, cluster_size, static_cast<cudaStream_t>(stream), attr);
  auto launch = [&](auto kernel) {
    const cudaError_t e = set_attributes(reinterpret_cast<const void*>(kernel));
    return e != cudaSuccess ? e
                            : cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(feats),
                                                 static_cast<const float*>(centers), static_cast<int*>(ids),
                                                 static_cast<float*>(new_centers), static_cast<float*>(partials),
                                                 static_cast<unsigned*>(tickets), H, W, K, tiles, ws, win2);
  };
  const cudaError_t e = parts == 8 ? launch(slic_step_kernel<1, 1>)
      : parts == 4 ? launch(slic_step_kernel<1, 2>)
      : parts == 2 ? launch(slic_step_kernel<2, 2>)
                   : launch(slic_step_kernel<4, 2>);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wvn_slic_step_smem_bytes(int K, int warps, int cluster_size, int tiles) {
  return static_cast<int>(smem_bytes(K, warps, cluster_size, tiles));
}

// How many clusters of 16 CTAs the card holds at once with one CTA on each
// SM (cudaOccupancyMaxActiveClusters at a CTA's full shared memory);
// negative: the CUDA error.
extern "C" int wvn_slic_step_cluster_slots() {
  const void* kernel = reinterpret_cast<const void*>(slic_step_kernel<4, 2>);
  cudaError_t e = set_attributes(kernel);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = launch_config(dim3(kMaxCluster), kMaxWarps, kSmemLimit, kMaxCluster, nullptr, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
