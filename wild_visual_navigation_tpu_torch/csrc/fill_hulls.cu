// K4: convex hull (gift wrap) and convex-polygon fill of B point sets into
// (B, H, W) boolean masks, in one launch.
//
// Replaces wild_visual_navigation_tpu/ops/rasterize_pallas.py::fill_hulls_pallas
// (Pallas body _fill_kernel), which the supervision reprojection runs once
// per footprint update over its fan-out of B mission nodes, and takes in the
// gift wrap that the JAX package runs in XLA before it
// (wild_visual_navigation_tpu/ops/rasterize.py::convex_hull; the port's
// plain version is ops/rasterize.py::convex_hull).  Two entry points share
// the fill stage:
//   wvn_hull_fill   points (B, N, 2), valid (B, N) -> hulls, hull_valid, masks
//   wvn_fill_hulls  hulls (B, E, 2), hull_valid (B, E) -> masks (the fill alone)
//
// What bounds it on an H100.  The masks are 1.6 MB at the reprojection's
// shape (B = 32, 224 x 224): 0.5 us at 3.35 TB/s.  Evaluating every edge at
// every pixel, as the first form of this kernel did, is 0.26 GFLOP; the fill
// here needs only where each row of a convex polygon starts and ends.  The
// gift wrap is a serial chain of march steps (one per hull vertex, 4 on
// average for the reprojection's footprints, at most max_hull - 1), each
// N^2 cross products and two block-wide reductions: a chain of barriers,
// not arithmetic, sets its time.
//
// Shape.  A grid of (S, B) blocks of 256 threads: S blocks per hull, each
// running the same march (bitwise the same result) and filling its own
// band of rows; block 0 writes the hull out when the caller asks for it.
// S is chosen so that the B x S blocks cover the card about twice; a
// cluster sharing one march would save the redundant march, but the march
// is latency and not throughput bound, so it would not shorten the launch.
//
// The march (bitwise equal to convex_hull on the same tensors).  Each
// quantity is computed by the same fp32 operations as the torch ops of
// convex_hull, each rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fsqrt_rn are never contracted into FMAs): the start key y * 1e6 + x
// (invalid points at 1e30), d = p - cur, dist = sqrt(dx*dx + dy*dy),
// C[j,k] = dx_j*dy_k - dy_j*dx_k, min over k of (cand_k ? C : 1e30) with NaN
// propagating as in torch.amin, the test min_cross >= -1e-6 * (1 + dist^2),
// with 1e-6 and 1e30 rounded to fp32 as torch rounds a Python scalar, and
// first-index ties in both the argmin and the argmax.  Once the march has
// closed, every later vertex repeats the start and is invalid, so the loop
// stops there and writes those.
//
// The fill, exact row spans.  Each edge e of the hull (and the gate edge)
// gives f_e(x, y) = ((a*x) + (b*y)) + c, rounded after every operation, and
// a pixel is inside when min_e f_e >= -1e-6, exactly as fill_hulls_plain.
// Premise: for a fixed row y and finite a, b, c whose terms cannot overflow,
// f_e is monotone in the integer x.  Proof: x -> a*x is non-decreasing for
// a > 0 and non-increasing for a < 0; round-to-nearest is a non-decreasing
// map, so fl(a*x) keeps that direction; s -> fl(s + t) is non-decreasing
// for fixed t, twice (t = fl(b*y), then t = c).  For a = 0 (either sign)
// f_e does not depend on x.  Hence each edge's test passes on a suffix of
// the row (a > 0), a prefix (a < 0), or all or none of it (a = 0), and the
// minimum over edges passes on the intersection, one span [lo, hi].  Each
// threshold is found by a binary search over x that evaluates f_e exactly
// as above, so the span reproduces the per-pixel test bit for bit.
// NaN and Inf break the premise (a NaN term makes the minimum NaN, and
// inf - inf is NaN): a hull with any edge for which
// |a|*(W-1) + |b|*(H-1) + |c| is not below 1e38 (NaN, Inf or near overflow)
// takes the per-pixel evaluation with a NaN-propagating minimum instead.
// A warp takes a row, a lane an edge (its binary search), and the row's
// span is a warp-wide max of the starts and min of the ends.  Rows are
// written with 16-byte stores between the band's unaligned ends.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHull = 64;
constexpr int kMaxEdges = kMaxHull + 1;  // hull edges + the gate edge
constexpr int kMaxPoints = kThreads;     // one point per thread in the march
constexpr int kRowBatch = 128;           // rows whose spans sit in shared memory at once
constexpr float kBig = 1e30f;
constexpr float kEps = 1e-6f;

struct Smem {
  float px[kMaxPoints], py[kMaxPoints];
  float dx[kMaxPoints], dy[kMaxPoints], dist[kMaxPoints];
  unsigned char valid[kMaxPoints], cand[kMaxPoints];
  float hx[kMaxHull], hy[kMaxHull];
  unsigned char hv[kMaxHull];
  float ea[kMaxEdges], eb[kMaxEdges], ec[kMaxEdges];
  int lo[kRowBatch], hi[kRowBatch];
  float best_v[kWarps];
  int best_i[kWarps];
  int start_idx, cur_idx, done;
  float curx, cury;
};

__device__ __forceinline__ float min_nan(float acc, float v) {
  // torch.minimum / torch.amin semantics: NaN in either operand gives NaN.
  return (v < acc || v != v) ? v : acc;
}

// Non-NaN floats as unsigned integers in the same order (both zeros equal).
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// The warp's best (value, index) in every lane, by two redux.sync: the best
// value, then the first index holding it.
template <bool kMax>
__device__ __forceinline__ void warp_best(float& v, int& i) {
  const unsigned o = ordered(v);
  const unsigned m = kMax ? __reduce_max_sync(0xffffffffu, o) : __reduce_min_sync(0xffffffffu, o);
  i = static_cast<int>(__reduce_min_sync(0xffffffffu, o == m ? static_cast<unsigned>(i) : 0xffffffffu));
  v = from_ordered(m);
}

// The block's best over the kWarps warps' bests in s.best_v / s.best_i, in
// every lane of the calling warp.
template <bool kMax>
__device__ __forceinline__ void block_best(const float* best_v, const int* best_i, float& v, int& i) {
  const int lane = threadIdx.x & 31;
  v = lane < kWarps ? best_v[lane] : (kMax ? -1.0f : 1.0f) * __int_as_float(0x7f800000);
  i = lane < kWarps ? best_i[lane] : kMaxPoints;
  warp_best<kMax>(v, i);
}

// The gift wrap of one point set into s.hx, s.hy, s.hv (E vertices).
__device__ void gift_wrap(const float* __restrict__ pts, const bool* __restrict__ valid, int N, int E, Smem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // valid & finite, and the start key of every point
  float key = __int_as_float(0x7f800000);  // +inf: never below a real key
  int kidx = kMaxPoints;
  bool v = false;
  if (tid < N) {
    const float x = pts[2 * tid], y = pts[2 * tid + 1];
    v = valid[tid] && isfinite(x) && isfinite(y);
    s.px[tid] = x;
    s.py[tid] = y;
    s.valid[tid] = v;
    key = v ? __fadd_rn(__fmul_rn(y, 1e6f), x) : __fadd_rn(__fmul_rn(kBig, 1e6f), kBig);
    kidx = tid;
  }
  warp_best<false>(key, kidx);
  if (lane == 0) {
    s.best_v[warp] = key;
    s.best_i[warp] = kidx;
  }
  const int num_valid = __syncthreads_count(v);
  if (warp == 0) {
    float bv;
    int bi;
    block_best<false>(s.best_v, s.best_i, bv, bi);
    if (lane == 0) {
      s.start_idx = s.cur_idx = bi;
      s.curx = s.px[bi];
      s.cury = s.py[bi];
      s.done = num_valid < 3;
    }
  }
  __syncthreads();
  const int start_idx = s.start_idx;
  const float sx = s.px[start_idx], sy = s.py[start_idx];
  if (tid == 0) {
    s.hx[0] = sx;
    s.hy[0] = sy;
    s.hv[0] = num_valid >= 3;
  }
  int step = 0;
  for (; step < E - 1 && !s.done; ++step) {
    // d, dist and the candidates from the current vertex
    const float cx = s.curx, cy = s.cury;
    if (tid < N) {
      const float dx = __fsub_rn(s.px[tid], cx), dy = __fsub_rn(s.py[tid], cy);
      const float dist = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      s.dx[tid] = dx;
      s.dy[tid] = dy;
      s.dist[tid] = dist;
      s.cand[tid] = s.valid[tid] && dist > kEps;
    }
    __syncthreads();
    // four lanes per candidate j take a quarter of the k each; the lane
    // with q == 0 keeps the best (dist, j) over the hull directions it saw
    const int q = tid & 3;
    float bv = -__int_as_float(0x7f800000);
    int bi = kMaxPoints;
    for (int jb = 0; jb < N; jb += kThreads / 4) {
      const int j = jb + (tid >> 2);
      const int jj = j < N ? j : N - 1;
      const float djx = s.dx[jj], djy = s.dy[jj];
      float m = __int_as_float(0x7f800000);
#pragma unroll 4
      for (int k = q; k < N; k += 4) {
        const float c = s.cand[k] ? __fsub_rn(__fmul_rn(djx, s.dy[k]), __fmul_rn(djy, s.dx[k])) : kBig;
        m = min_nan(m, c);
      }
      m = min_nan(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = min_nan(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (q == 0 && j < N) {
        const float dj = s.dist[j];
        const bool hull_dir = s.cand[j] && m >= __fmul_rn(-kEps, __fadd_rn(1.0f, __fmul_rn(dj, dj)));
        const float score = hull_dir ? dj : -1.0f;
        if (score > bv) {  // a lane sees its j in increasing order: a tie keeps the first
          bv = score;
          bi = j;
        }
      }
    }
    warp_best<true>(bv, bi);
    if (lane == 0) {
      s.best_v[warp] = bv;
      s.best_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) block_best<true>(s.best_v, s.best_i, bv, bi);
    if (tid == 0) {
      // a hull direction has dist > 1e-6; without one the march stays put
      const bool any_cand = bv > 0.0f;
      const int nxt = any_cand ? bi : s.cur_idx;
      const bool closed = nxt == start_idx || !any_cand;
      s.hx[step + 1] = closed ? sx : s.px[nxt];  // the closing vertex repeats the start
      s.hy[step + 1] = closed ? sy : s.py[nxt];
      s.hv[step + 1] = !closed;
      s.cur_idx = nxt;
      s.curx = s.px[nxt];
      s.cury = s.py[nxt];
      s.done = closed;
    }
    __syncthreads();
  }
  // after the march has closed (or never started), every vertex repeats the start
  for (int i = step + 1 + tid; i < E; i += kThreads) {
    s.hx[i] = sx;
    s.hy[i] = sy;
    s.hv[i] = 0;
  }
}

// f_e(x, y) >= -1e-6 in the plain version's rounding.
__device__ __forceinline__ float edge_value(float a, float b, float c, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

__device__ __forceinline__ bool edge_pass(float a, float b, float c, int x, float y) {
  return edge_value(a, b, c, static_cast<float>(x), y) >= -kEps;
}

// Edge lines of the hull in s.hx/hy/hv (E vertices) and the gate, exactly
// as ops/rasterize_fill.py::hull_edges builds them; returns whether the
// exact-span premise holds for every edge (see the header).
__device__ bool build_edges(int E, int H, int W, Smem& s) {
  const int tid = threadIdx.x;
  const int n_ok = __syncthreads_count(tid < E && s.hv[tid]);
  bool finite = true;
  if (tid < E) {
    const int n = tid + 1 == E ? 0 : tid + 1;
    const float v0x = s.hx[tid], v0y = s.hy[tid];
    const float ex = __fsub_rn(s.hx[n], v0x), ey = __fsub_rn(s.hy[n], v0y);
    const float a = -ey, b = ex, c = __fsub_rn(__fmul_rn(ey, v0x), __fmul_rn(ex, v0y));
    s.ea[tid] = a;
    s.eb[tid] = b;
    s.ec[tid] = c;
    finite = fabsf(a) * static_cast<float>(W - 1) + fabsf(b) * static_cast<float>(H - 1) + fabsf(c) < 1e38f;
  } else if (tid == E) {
    s.ea[E] = 0.f;
    s.eb[E] = 0.f;
    s.ec[E] = n_ok >= 3 ? kBig : -kBig;
  }
  return __syncthreads_and(finite);
}

// Pixel x of row y: the exact span when `spans`, else the per-pixel minimum.
__device__ __forceinline__ bool inside(int x, int y, int r0, bool spans, int ne, const Smem& s) {
  if (spans) return x >= s.lo[y - r0] && x <= s.hi[y - r0];
  const float fx = static_cast<float>(x), fy = static_cast<float>(y);
  float acc = kBig;
  for (int e = 0; e < ne; ++e) acc = min_nan(acc, edge_value(s.ea[e], s.eb[e], s.ec[e], fx, fy));
  return acc >= -kEps;
}

// The part [lo, hi] of row y on which edge (a, b, c) passes, by binary
// search over x (see the header); lo > hi when it passes nowhere.
__device__ __forceinline__ void edge_span(float a, float b, float c, float y, int W, int& lo, int& hi) {
  if (a == 0.f) {  // constant along the row
    if (!edge_pass(a, b, c, 0, y)) lo = W;
  } else if (a > 0.f) {  // passes on a suffix: its first x
    if (!edge_pass(a, b, c, W - 1, y)) {
      lo = W;
    } else {
      int l = 0, h = W - 1;
      while (l < h) {
        const int mid = (l + h) >> 1;
        if (edge_pass(a, b, c, mid, y)) h = mid; else l = mid + 1;
      }
      lo = max(lo, h);
    }
  } else {  // passes on a prefix: its last x
    if (!edge_pass(a, b, c, 0, y)) {
      hi = -1;
    } else {
      int l = 0, h = W - 1;
      while (l < h) {
        const int mid = (l + h + 1) >> 1;
        if (edge_pass(a, b, c, mid, y)) l = mid; else h = mid - 1;
      }
      hi = min(hi, l);
    }
  }
}

// Rows [y0, y1) of one hull's mask (`mask` is the hull's (H, W) plane).
__device__ void fill_rows(bool* __restrict__ mask, int y0, int y1, int W, int ne, bool spans, Smem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int r0 = y0; r0 < y1; r0 += kRowBatch) {
    const int nr = min(kRowBatch, y1 - r0);
    if (spans) {  // a warp per row, a lane per edge, the span by warp reductions
      for (int r = warp; r < nr; r += kWarps) {
        const float y = static_cast<float>(r0 + r);
        int lo = 0, hi = W - 1;
        for (int e = lane; e < ne; e += 32) edge_span(s.ea[e], s.eb[e], s.ec[e], y, W, lo, hi);
        lo = __reduce_max_sync(0xffffffffu, lo);
        hi = __reduce_min_sync(0xffffffffu, hi);
        if (lane == 0) {
          s.lo[r] = lo;
          s.hi[r] = hi;
        }
      }
      __syncthreads();
    }
    // bytes [r0 * W, (r0 + nr) * W) of the plane (below 2^31: checked on
    // the host): single bytes up to the first 16-byte boundary and after
    // the last, 16-byte stores between
    const int p0 = r0 * W, p1 = p0 + nr * W;
    const uintptr_t base = reinterpret_cast<uintptr_t>(mask);
    int a0 = static_cast<int>(((base + p0 + 15) & ~uintptr_t(15)) - base);
    int a1 = static_cast<int>(((base + p1) & ~uintptr_t(15)) - base);
    if (a0 > p1) a0 = p1;
    if (a1 < a0) a1 = a0;
    for (int p = p0 + tid; p < a0; p += kThreads) mask[p] = inside(p % W, p / W, r0, spans, ne, s);
    for (int p = a1 + tid; p < p1; p += kThreads) mask[p] = inside(p % W, p / W, r0, spans, ne, s);
    for (int p = a0 + 16 * tid; p < a1; p += 16 * kThreads) {
      int y = p / W;
      int x = p - y * W;
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t word = 0;
#pragma unroll
        for (int byte = 0; byte < 4; ++byte) {
          word |= static_cast<uint32_t>(inside(x, y, r0, spans, ne, s)) << (8 * byte);
          if (++x == W) {
            x = 0;
            ++y;
          }
        }
        w[k] = word;
      }
      *reinterpret_cast<uint4*>(mask + p) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();  // the spans of this batch are read before the next batch writes them
  }
}

// kMarch: points (B, N, 2) and valid (B, N) -> the hull (written by block 0
// of each hull when hulls_out is not null) and its fill.  Otherwise the
// points are the hulls (B, E, 2) and valid their hull_valid (B, E).
template <bool kMarch>
__global__ void __launch_bounds__(kThreads)
hull_fill_kernel(const float* __restrict__ pts, const bool* __restrict__ valid, int N, float* __restrict__ hulls_out,
                 bool* __restrict__ hv_out, int E, bool* __restrict__ out, int H, int W) {
  __shared__ Smem s;
  const int b = blockIdx.y, tid = threadIdx.x;
  if (kMarch) {
    gift_wrap(pts + static_cast<size_t>(b) * N * 2, valid + static_cast<size_t>(b) * N, N, E, s);
    __syncthreads();
    if (blockIdx.x == 0 && hulls_out != nullptr) {
      for (int i = tid; i < E; i += kThreads) {
        hulls_out[(static_cast<size_t>(b) * E + i) * 2] = s.hx[i];
        hulls_out[(static_cast<size_t>(b) * E + i) * 2 + 1] = s.hy[i];
        hv_out[static_cast<size_t>(b) * E + i] = s.hv[i];
      }
    }
  } else {
    for (int i = tid; i < E; i += kThreads) {
      s.hx[i] = pts[(static_cast<size_t>(b) * E + i) * 2];
      s.hy[i] = pts[(static_cast<size_t>(b) * E + i) * 2 + 1];
      s.hv[i] = valid[static_cast<size_t>(b) * E + i];
    }
    __syncthreads();
  }
  const bool spans = build_edges(E, H, W, s);
  const int y0 = static_cast<int>(static_cast<long long>(H) * blockIdx.x / gridDim.x);
  const int y1 = static_cast<int>(static_cast<long long>(H) * (blockIdx.x + 1) / gridDim.x);
  fill_rows(out + static_cast<size_t>(b) * H * W, y0, y1, W, E + 1, spans, s);
}

// The current device's SM count, read once for each device.
int sm_count() {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> sms[kMaxDevices];
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) != cudaSuccess) return n;
  const int known = dev < kMaxDevices ? sms[dev].load(std::memory_order_relaxed) : 0;
  if (known > 0) return known;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess && dev < kMaxDevices)
    sms[dev].store(n, std::memory_order_relaxed);
  return n;
}

// Blocks per hull: the B x S grid covers the card about twice.
int bands(int B, int H) {
  const int s = (2 * sm_count() + B - 1) / B;
  return s < 1 ? 1 : (s > H ? H : s);
}

bool bad_shape(int B, int E, int H, int W) {
  return B <= 0 || B > 65535 || E <= 0 || E > kMaxHull || H <= 0 || W <= 0 ||
         static_cast<long long>(H) * W > 0x7fffffffLL - 16 * kThreads;  // 32-bit pixel offsets in a plane
}

}  // namespace

// hulls (B, E, 2) fp32, hull_valid (B, E) bool -> out (B, H, W) bool.
extern "C" int wvn_fill_hulls(const void* hulls, const void* hull_valid, void* out, int B, int E, int H, int W,
                              void* stream) {
  if (bad_shape(B, E, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  hull_fill_kernel<false><<<dim3(bands(B, H), B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hulls), static_cast<const bool*>(hull_valid), E, nullptr, nullptr, E,
      static_cast<bool*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}

// points (B, N, 2) fp32, valid (B, N) bool -> hulls (B, E, 2) fp32,
// hull_valid (B, E) bool (E = max_hull) and out (B, H, W) bool.  hulls and
// hull_valid may both be null: the hulls are then not written.
extern "C" int wvn_hull_fill(const void* points, const void* valid, void* hulls, void* hull_valid, void* out, int B,
                             int N, int E, int H, int W, void* stream) {
  if (bad_shape(B, E, H, W) || N <= 0 || N > kMaxPoints) return static_cast<int>(cudaErrorInvalidValue);
  hull_fill_kernel<true><<<dim3(bands(B, H), B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const bool*>(valid), N, static_cast<float*>(hulls),
      static_cast<bool*>(hull_valid), E, static_cast<bool*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}
