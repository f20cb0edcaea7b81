// K3: one SLIC Lloyd step -- assignment, per-cluster sums and the centre
// update -- in one launch.
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
// Layout: one block of 256 threads per 16 x 16 pixel tile (ragged tiles at
// the right and bottom edges are masked), grid (tiles, B).
//
// Exact per-tile candidates.  Before the assignment, a block lists, in
// increasing k, the centres whose spatial position (cy, cx) lies within
// sqrt(win2) of the tile's bounding box, with a margin:
//
//   candidate  <=>  dy^2 + dx^2 <= win2 + 2^-18 * (P + 2Q + C + win2)
//
// where (dy, dx) is the distance from (cy, cx) to the box, P = y1^2 + x1^2
// for the box's far corner (y1, x1), Q = y1*|cy| + x1*|cx| and
// C = cy^2 + cx^2.  The pixel's window test evaluates the expanded form
// d2s = yx2 - 2*(py*cy + px*cx) + cyx2 in fp32 with six roundings; its
// absolute error is below 8u (P + Q + C) with u = 2^-24, which the margin
// (64u (P + 2Q + C + win2)) covers together with the rounding of the
// candidate test itself.  A centre that passes d2s <= win2 at any pixel of
// the tile is therefore on the list, the windowed first-index argmin over
// the list equals the one over all K, and a pixel with no passing candidate
// is exactly a pixel with no passing centre at all: an orphan, which alone
// scans all K for the spatially nearest centre.  Single-step ids stay
// bit-identical to ops/slic.py::_assign_plain, whose expression order the
// _rn intrinsics (never contracted into FMAs) follow.  The candidate rule
// is written once more in torch as ops/slic_fused.py::tile_candidates_plain.
//
// Deterministic sums with no fp32 atomics: the lanes of a warp group by
// cluster slot (__match_any_sync); the lowest lane of each group sums the
// group in lane order into the warp's shared row for that slot; the eight
// warp rows are added in warp order into the block's partial row, written
// only for the block's slots (its candidates and any orphan's centre), with
// a bit mask of which rows were written.  Then two levels of "last block
// to finish" (a __threadfence and an atomic ticket): the last block of each
// tile row adds that row's written rows in tile order into the row's sums
// and publishes the row's cluster mask; the last row of the image adds the
// row sums that exist in row order, divides with __fdiv_rn, writes the new
// centres and resets the tickets.  Both levels stage their masks in shared
// memory and load only rows that were written, several per thread at once:
// these reads of what other SMs just wrote are the launch's serial tail,
// and one SM keeps only so many of them in flight.  The same inputs give
// bitwise the same ids and centres on every run.
//
// What bounds it on an H100: the (pixel, candidate) pairs, about 20 fp32
// operations each on the SIMT pipes -- 15 candidates per pixel at 224 x 224
// with K = 100 on grid-initialised centres, against the dense 100 -- plus K
// for each orphan pixel; device memory sees one read of the features
// (1 MB per image) and the ids.  That bound is well under a microsecond;
// what the launch takes is the per-tile work's barriers and the update's
// two levels of cross-block reads (tools/profile_torch_k3.py splits it).
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;  // one pixel each
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 512;
constexpr float kTolScale = 3.814697265625e-06f;  // 2^-18

__device__ __forceinline__ bool tile_candidate(float cy, float cx, float y0, float y1, float x0, float x1,
                                               float far2, float win2) {
  const float dy = fmaxf(fmaxf(__fsub_rn(y0, cy), __fsub_rn(cy, y1)), 0.f);
  const float dx = fmaxf(fmaxf(__fsub_rn(x0, cx), __fsub_rn(cx, x1)), 0.f);
  const float d2 = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
  const float q = __fadd_rn(__fmul_rn(y1, fabsf(cy)), __fmul_rn(x1, fabsf(cx)));
  float t = __fadd_rn(far2, __fmul_rn(2.f, q));
  t = __fadd_rn(t, __fadd_rn(__fmul_rn(cy, cy), __fmul_rn(cx, cx)));
  t = __fadd_rn(t, win2);
  return d2 <= __fadd_rn(win2, __fmul_rn(t, kTolScale));
}

// Warp 0 appends, in increasing k, every k with flag(k) to list[n..] and
// records its position in slot_of; returns the new length (on lane 0 and all
// other lanes alike).
template <typename Flag>
__device__ __forceinline__ int append_in_order(int K, int n, int* list, int* slot_of, Flag flag) {
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    const bool in = k < K && flag(k);
    const unsigned bal = __ballot_sync(0xffffffffu, in);
    if (in) {
      const int j = n + __popc(bal & ((1u << lane) - 1u));
      list[j] = k;
      slot_of[k] = j;
    }
    n += __popc(bal);
  }
  return n;
}

// Whether this block is the last of `count` to take a ticket.  The block's
// writes are ordered before its ticket, and the other blocks' writes before
// the last block's reads, by one thread's fences between block barriers (as
// cooperative groups' grid sync does); the other threads need no fence.
__device__ __forceinline__ bool last_to_finish(unsigned* ticket, int count, int* last_s) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *last_s = atomicAdd(ticket, 1u) == static_cast<unsigned>(count - 1);
    if (*last_s) __threadfence();
  }
  __syncthreads();
  return *last_s != 0;
}

// out[item] = the sum over j < n, in increasing j, of the values at
// src + j * stride + item that keep(item, j) accepts (from shared memory),
// for item < n_items.  Only accepted values are loaded, and each thread
// has up to 3 items x 8 loads in flight before it adds any.
constexpr int kItems = 3;
template <typename Keep>
__device__ __forceinline__ void sum_in_order(const float* src, size_t stride, int n, int n_items, float* out,
                                             Keep keep) {
  for (int base = 0; base < n_items; base += kItems * kThreads) {
    float s[kItems];
#pragma unroll
    for (int a = 0; a < kItems; ++a) s[a] = 0.f;
    for (int j0 = 0; j0 < n; j0 += 8) {
      float v[kItems][8];
#pragma unroll
      for (int a = 0; a < kItems; ++a) {
        const int item = base + a * kThreads + threadIdx.x;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = j0 + u;
          v[a][u] = (item < n_items && j < n && keep(item, j)) ? __ldcg(src + j * stride + item) : 0.f;
        }
      }
#pragma unroll
      for (int a = 0; a < kItems; ++a) {
#pragma unroll
        for (int u = 0; u < 8; ++u) s[a] = __fadd_rn(s[a], v[a][u]);
      }
    }
#pragma unroll
    for (int a = 0; a < kItems; ++a) {
      const int item = base + a * kThreads + threadIdx.x;
      if (item < n_items) out[item] = s[a];
    }
  }
}

// Three blocks per SM: without the cap the update's batched loads take so
// many registers that one block fits per SM, and the per-tile work then
// runs in several waves.
__global__ void __launch_bounds__(kThreads, 3)
slic_step_kernel(const float* __restrict__ feats, const float* __restrict__ centers, int* __restrict__ ids,
                 float* __restrict__ new_centers, float* __restrict__ partials, unsigned* __restrict__ mask,
                 float* __restrict__ rowsums, unsigned* __restrict__ rowmask, unsigned* __restrict__ tickets, int H,
                 int W, int K, float ws, float win2) {
  extern __shared__ float smem[];
  float* cen = smem;               // (K, 5) current centres
  float* c2 = cen + 5 * K;         // (K,) |c|^2
  float* cy = c2 + K;              // (K,) unscaled centre y
  float* cx = cy + K;              // (K,) unscaled centre x
  float* cyx2 = cx + K;            // (K,)
  float* cd = cyx2 + K;            // (K, 9) candidates packed: c0..c4, c2, cy, cx, cyx2
  float* pf = cd + 9 * K;          // (5, kThreads) this tile's features
  float* wsum = pf + 5 * kThreads;  // (kWarps, K, 6) per-warp slot sums
  int* slots = reinterpret_cast<int*>(wsum + kWarps * K * 6);  // (K,) slot -> cluster, candidates first
  int* slot_of = slots + K;        // (K,) cluster -> slot or -1
  int* need = slot_of + K;         // (K,) an orphan's centre outside the candidates
  unsigned* rmask = reinterpret_cast<unsigned*>(need + K);  // (max(tiles across, down), ceil(K / 32)) bit masks
  __shared__ int n_cand_s, n_slot_s, last_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int nblk = gridDim.x;
  const int ntx = (W + kTile - 1) / kTile;
  const int y0 = (blockIdx.x / ntx) * kTile, x0 = (blockIdx.x % ntx) * kTile;
  const int y1 = min(y0 + kTile - 1, H - 1), x1 = min(x0 + kTile - 1, W - 1);
  const int HW = H * W;
  const int nwords = (K + 31) / 32;

  // 1. the centres and their derived terms, in the plain version's order
  const float* cb = centers + static_cast<size_t>(b) * K * 5;
  for (int i = tid; i < 5 * K; i += kThreads) cen[i] = cb[i];
  for (int i = tid; i < kWarps * K * 6; i += kThreads) wsum[i] = 0.f;
  for (int k = tid; k < K; k += kThreads) {
    slot_of[k] = -1;
    need[k] = 0;
  }
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

  // 2. the tile's candidates, in increasing k
  if (warp == 0) {
    const float fy0 = static_cast<float>(y0), fy1 = static_cast<float>(y1);
    const float fx0 = static_cast<float>(x0), fx1 = static_cast<float>(x1);
    const float far2 = __fadd_rn(__fmul_rn(fy1, fy1), __fmul_rn(fx1, fx1));
    const int n = append_in_order(K, 0, slots, slot_of, [&](int k) {
      return tile_candidate(cy[k], cx[k], fy0, fy1, fx0, fx1, far2, win2);
    });
    if (lane == 0) n_cand_s = n;
  }
  __syncthreads();
  const int nc = n_cand_s;
  for (int i = tid; i < 9 * nc; i += kThreads) {
    const int j = i / 9, f = i % 9, k = slots[j];
    cd[i] = f < 5 ? cen[5 * k + f] : f == 5 ? c2[k] : f == 6 ? cy[k] : f == 7 ? cx[k] : cyx2[k];
  }
  __syncthreads();

  // 3. assignment: windowed first-index argmin over the candidates
  const int py_i = y0 + tid / kTile, px_i = x0 + tid % kTile;
  const bool valid = py_i < H && px_i < W;
  const int p = py_i * W + px_i;
  float f[5];
  const float* fb = feats + static_cast<size_t>(b) * 5 * HW;
#pragma unroll
  for (int ch = 0; ch < 5; ++ch) f[ch] = valid ? fb[static_cast<size_t>(ch) * HW + p] : 0.f;
  float p2 = __fmul_rn(f[0], f[0]);
#pragma unroll
  for (int ch = 1; ch < 5; ++ch) p2 = __fadd_rn(p2, __fmul_rn(f[ch], f[ch]));
  const float py = static_cast<float>(py_i);
  const float px = static_cast<float>(px_i);
  const float yx2 = __fadd_rn(__fmul_rn(py, py), __fmul_rn(px, px));

  float best = INFINITY;
  int best_j = -1;
  for (int j = 0; j < nc; ++j) {
    const float* c = cd + 9 * j;
    float dots = __fmul_rn(f[0], c[0]);
#pragma unroll
    for (int ch = 1; ch < 5; ++ch) dots = __fadd_rn(dots, __fmul_rn(f[ch], c[ch]));
    const float d2 = __fadd_rn(__fsub_rn(p2, __fmul_rn(2.f, dots)), c[5]);
    const float sd = __fadd_rn(__fmul_rn(py, c[6]), __fmul_rn(px, c[7]));
    const float d2s = __fadd_rn(__fsub_rn(yx2, __fmul_rn(2.f, sd)), c[8]);
    if (d2s <= win2 && d2 < best) {
      best = d2;
      best_j = j;
    }
  }
  int id;
  if (best_j >= 0) {
    id = slots[best_j];
  } else {  // orphan: no centre at all within the window; the spatially nearest of all K
    float best_s = INFINITY;
    id = 0;
    for (int k = 0; k < K; ++k) {
      const float sd = __fadd_rn(__fmul_rn(py, cy[k]), __fmul_rn(px, cx[k]));
      const float d2s = __fadd_rn(__fsub_rn(yx2, __fmul_rn(2.f, sd)), cyx2[k]);
      if (d2s < best_s) {
        best_s = d2s;
        id = k;
      }
    }
  }
  if (valid) ids[static_cast<size_t>(b) * HW + p] = id;

  // 4. slots for orphans' centres that are not candidates, in increasing k
  const bool extra = valid && best_j < 0 && slot_of[id] < 0;
  if (extra) need[id] = 1;
#pragma unroll
  for (int ch = 0; ch < 5; ++ch) pf[ch * kThreads + tid] = f[ch];
  const bool any_extra = __syncthreads_or(extra);
  if (warp == 0) {
    const int n = any_extra ? append_in_order(K, nc, slots, slot_of, [&](int k) { return need[k] != 0; }) : nc;
    if (lane == 0) n_slot_s = n;
  }
  __syncthreads();

  // 5. per-warp sums by slot, each group of lanes in lane order
  const int slot = valid ? slot_of[id] : -1;
  const unsigned group = __match_any_sync(0xffffffffu, slot);
  const int leader = __ffs(group) - 1;
  if (slot >= 0 && lane == leader) {
    const int base = warp * 32;
    float s[5];
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) s[ch] = pf[ch * kThreads + base + leader];
    for (unsigned m = group & (group - 1u); m; m &= m - 1u) {
      const int l = __ffs(m) - 1;
#pragma unroll
      for (int ch = 0; ch < 5; ++ch) s[ch] = __fadd_rn(s[ch], pf[ch * kThreads + base + l]);
    }
    float* o = wsum + (warp * K + slot) * 6;
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) o[ch] = s[ch];
    o[5] = static_cast<float>(__popc(group));
  }
  __syncthreads();

  // 6. the block's partial rows (warps added in order) and its row mask
  const int ns = n_slot_s;
  const size_t blk = static_cast<size_t>(b) * nblk + blockIdx.x;
  float* pb = partials + blk * K * 6;
  for (int i = tid; i < 6 * ns; i += kThreads) {
    const int s = i / 6, c = i % 6;
    float acc = wsum[s * 6 + c];
    for (int w = 1; w < kWarps; ++w) acc = __fadd_rn(acc, wsum[(w * K + s) * 6 + c]);
    pb[slots[s] * 6 + c] = acc;
  }
  if (warp == 0) {
    for (int w = 0; w < nwords; ++w) {
      const int k = 32 * w + lane;
      const unsigned bits = __ballot_sync(0xffffffffu, k < K && slot_of[k] >= 0);
      if (lane == 0) mask[blk * nwords + w] = bits;
    }
  }

  // 7. the last block of each tile row to finish adds the row's written
  // partial rows, in tile order, into the row's sums, and publishes which
  // clusters the row holds
  const int tyi = blockIdx.x / ntx, nty = nblk / ntx;
  unsigned* img_tickets = tickets + static_cast<size_t>(b) * (1 + nty);  // image, then one per tile row
  if (!last_to_finish(img_tickets + 1 + tyi, ntx, &last_s)) return;
  const size_t row0 = static_cast<size_t>(b) * nblk + static_cast<size_t>(tyi) * ntx;
  for (int i = tid; i < ntx * nwords; i += kThreads) rmask[i] = __ldcg(mask + row0 * nwords + i);
  __syncthreads();
  unsigned* img_rowmask = rowmask + static_cast<size_t>(b) * nty * nwords;
  for (int w = tid; w < nwords; w += kThreads) {
    unsigned u = 0u;
    for (int tx = 0; tx < ntx; ++tx) u |= rmask[tx * nwords + w];
    img_rowmask[tyi * nwords + w] = u;
  }
  sum_in_order(partials + row0 * K * 6, static_cast<size_t>(K) * 6, ntx, 6 * K,
               rowsums + (static_cast<size_t>(b) * nty + tyi) * K * 6, [&](int item, int tx) {
                 const int k = item / 6;
                 return ((rmask[tx * nwords + (k >> 5)] >> (k & 31)) & 1u) != 0u;
               });

  // 8. the last tile row of the image to finish adds the row sums that
  // exist in row order, divides and writes the new centres; it leaves the
  // tickets at zero
  if (!last_to_finish(img_tickets, nty, &last_s)) return;
  for (int i = tid; i < nty * nwords; i += kThreads) rmask[i] = __ldcg(img_rowmask + i);
  __syncthreads();
  float* tot = wsum;  // (K, 6), reusing the per-warp sums
  sum_in_order(rowsums + static_cast<size_t>(b) * nty * K * 6, static_cast<size_t>(K) * 6, nty, 6 * K, tot,
               [&](int item, int r) {
                 const int k = item / 6;
                 return ((rmask[r * nwords + (k >> 5)] >> (k & 31)) & 1u) != 0u;
               });
  __syncthreads();
  float* ob = new_centers + static_cast<size_t>(b) * K * 5;
  for (int item = tid; item < 5 * K; item += kThreads) {
    const int k = item / 5, c = item % 5;
    const float n = tot[6 * k + 5];
    ob[item] = n > 0.f ? __fdiv_rn(tot[6 * k + c], n) : cen[item];
  }
  for (int i = tid; i <= nty; i += kThreads) img_tickets[i] = 0u;
}

size_t smem_bytes(int K, int H, int W) {
  const size_t nwords = (K + 31) / 32, tiles_across = (W + kTile - 1) / kTile, tiles_down = (H + kTile - 1) / kTile;
  const size_t tiles_max = tiles_across > tiles_down ? tiles_across : tiles_down;
  return (static_cast<size_t>(18 + 6 * kWarps) * K + 5 * kThreads) * sizeof(float) +
         3 * static_cast<size_t>(K) * sizeof(int) + tiles_max * nwords * sizeof(unsigned);
}

}  // namespace

// feats (B, 5, H*W) fp32, centers (B, K, 5) fp32 -> ids (B, H*W) int32 and
// new_centers (B, K, 5) fp32.  Scratch: partials (B, tiles, K, 6) fp32,
// mask (B, tiles, ceil(K / 32)) uint32, rowsums (B, ceil(H / 16), K, 6)
// fp32, rowmask (B, ceil(H / 16), ceil(K / 32)) uint32, and tickets
// (B, 1 + ceil(H / 16)) uint32, zero before the first launch (each launch
// leaves them zero).  tiles = ceil(H / 16) * ceil(W / 16).
extern "C" int wvn_slic_step(const void* feats, const void* centers, void* ids, void* new_centers, void* partials,
                             void* mask, void* rowsums, void* rowmask, void* tickets, int B, int H, int W, int K,
                             float ws, float win2, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || K <= 0 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile);
  const size_t smem = smem_bytes(K, H, W);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(slic_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  slic_step_kernel<<<dim3(tiles, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feats), static_cast<const float*>(centers), static_cast<int*>(ids),
      static_cast<float*>(new_centers), static_cast<float*>(partials), static_cast<unsigned*>(mask),
      static_cast<float*>(rowsums), static_cast<unsigned*>(rowmask), static_cast<unsigned*>(tickets), H, W, K, ws,
      win2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wvn_slic_step_smem_bytes(int K, int H, int W) { return static_cast<int>(smem_bytes(K, H, W)); }
