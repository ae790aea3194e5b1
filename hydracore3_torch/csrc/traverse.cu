// Ray queries for Hopper: the streamed scenes' two queries, the two-level and
// the cluster-BVH query, and one round of the cell wavefront.
//
// Five kernels, one ray per thread, 128 threads per block.  Four of them walk
// wide BVHs with small leaves and live in traverse_wide.cuh, with its own
// note on their design:
//
//  * intersect_stream_kernel<ANY_HIT> (K2) replaces the Pallas kernel
//    hydracore3_tpu/accel/traverse_stream.py:_kernel (wrapper
//    intersect_stream): nearest hit (t, tri, u, v) or any-hit (tri = 0,
//    t = tmin on occlusion) of the streamed scenes, by a near-first walk from
//    node 0 of accel/wide_bvh.py's pack_wide_stream table.
//  * intersect_march_kernel (K3) replaces hydracore3_tpu/accel/
//    traverse_dda.py:_march_kernel (wrapper intersect_march): the outlier
//    clusters first, then an integer 3D-DDA march of the grid front to back
//    (a jump over the empty-space radius the grid stores per cell where it
//    is 2 or more); at each cluster of a cell whose box the ray enters before
//    its best t, a near-first walk of that cluster's subtree of the same
//    table; it stops once the best hit lies before the current cell's exit
//    or the ray leaves the grid.  Every lane is marched to its end; a lane
//    still live at the iteration cap is reported unresolved (none is
//    expected).
//  * intersect_tlas_kernel<ANY_HIT> (K4) and intersect_clusters_kernel
//    <ANY_HIT> (K5): the two-level and the cluster-BVH query.
//
// Here, beside the helpers they share (Ray, slab, Best, the counting
// macros):
//
//  * cell_pass_kernel<ANY_HIT> (K6) replaces hydracore3_tpu/accel/
//    traverse_dda.py:_cell_kernel (one round of intersect_dda).  Each lane
//    keeps its state on the card between rounds (accel/traverse_dda.py
//    DdaState: its cell, the t where it entered it, a done flag and its
//    best hit); one launch visits each live lane's cell, retires the lane
//    once its best hit lies before the cell's exit (any-hit: once occluded),
//    else takes one integer step across the nearest exit plane, and adds
//    the lanes still live to a count the host reads, so the host does
//    nothing between rounds but launch and read that count.  Every launch
//    runs over all lanes; a lane already done returns at once.  The first
//    launch computes each lane's entry into the grid.  At a cluster of
//    the cell it runs K3's visit (visit_cluster: the widened cluster box,
//    then the cluster's subtree of pack_wide_stream's table), so a lane
//    makes a few Woop tests where the TPU kernel tested 64 rows a cluster.
//    The entry and the stepping are written with __fmul_rn/__fadd_rn in the
//    order of the plain torch round (traverse_dda.cell_pass_plain), so the
//    kernel's cell, t and done equal the plain round's on every lane.
//
// Semantics follow the JAX kernels: slab test with inv = 1/d where
// |d| > 1e-20 else 1e30, tn = max(mins, tmin), tf = min(maxs, best_t), hit
// if tn <= tf; Woop test t = -po_z/pd_z, u = po_x + t pd_x,
// v = po_y + t pd_y, accepted when u >= 0, v >= 0, u + v <= 1,
// tmin < t < best_t (all-zero padding rows give NaN and are rejected); among
// equal t the lowest padded index wins, by comparison (K6: across rounds
// too, since the lane's best rides in its state).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;       // threads per block

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin, tmax;
};

__device__ __forceinline__ float safe_inv(float d) {
  return fabsf(d) > 1e-20f ? 1.0f / d : 1e30f;
}

// box = (min.xyz, max.x), (max.yz, pad, pad)
__device__ __forceinline__ bool slab(const Ray& r, float4 a, float4 b,
                                     float best_t) {
  float t0x = (a.x - r.ox) * r.ix, t1x = (a.w - r.ox) * r.ix;
  float t0y = (a.y - r.oy) * r.iy, t1y = (b.x - r.oy) * r.iy;
  float t0z = (a.z - r.oz) * r.iz, t1z = (b.y - r.oz) * r.iz;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                   fmaxf(fminf(t0z, t1z), r.tmin));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                   fminf(fmaxf(t0z, t1z), best_t));
  return tn <= tf;
}

struct Best {
  float t, u, v;
  int tri;
};

// What a lane did: box tests, triangle tests, instances entered, grid cells
// visited.  Only a build with -DHC3_COUNT counts: it is a second library of
// this source for measuring a query's operations (a roofline's numerator),
// with the same C interface plus hc3_counts_reset / hc3_counts_read.  In
// the shipped build every HC3_ macro below expands to nothing, so no
// counter, argument or store exists there.
#ifdef HC3_COUNT
struct Counts {
  unsigned long long slab = 0, tri = 0, inst = 0, cell = 0;
};
__device__ unsigned long long g_counts[4];
#define HC3_COUNTS Counts cnt
#define HC3_COUNTS_PARAM , Counts& cnt
#define HC3_COUNTS_ARG , cnt
#define HC3_TICK(field) (++cnt.field)
#define HC3_FLUSH                                                            \
  do {                                                                        \
    atomicAdd(g_counts + 0, cnt.slab);                                        \
    atomicAdd(g_counts + 1, cnt.tri);                                         \
    atomicAdd(g_counts + 2, cnt.inst);                                        \
    atomicAdd(g_counts + 3, cnt.cell);                                        \
  } while (0)
#else
#define HC3_COUNTS
#define HC3_COUNTS_PARAM
#define HC3_COUNTS_ARG
#define HC3_TICK(field)
#define HC3_FLUSH
#endif

// (a*x + b*y) + c*z with each product and sum rounded on its own, as the
// plain torch versions compute it: __fmul_rn/__fadd_rn are never contracted
// into FMAs, whatever nvcc's -fmad setting
__device__ __forceinline__ float dot3_rn(float4 m, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m.x, x), __fmul_rn(m.y, y)),
                   __fmul_rn(m.z, z));
}

// t, u, v of ray r against one triangle's Woop rows w[0..2], op for op the
// arithmetic of traverse_stream.intersect_plain (po = M o + w, pd = M d,
// t = -po_z / pd_z, u = po_x + t pd_x, v = po_y + t pd_y), so a kernel's t
// has the plain version's bits and equal t compare equal.  An all-zero row
// gives t = NaN.
__device__ __forceinline__ void woop_tuv(const Ray& r,
                                         const float4* __restrict__ w,
                                         float& t, float& u, float& v) {
  float4 wx = w[0], wy = w[1], wz = w[2];
  float po_z = __fadd_rn(dot3_rn(wz, r.ox, r.oy, r.oz), wz.w);
  t = -po_z / dot3_rn(wz, r.dx, r.dy, r.dz);
  u = __fadd_rn(__fadd_rn(dot3_rn(wx, r.ox, r.oy, r.oz), wx.w),
                __fmul_rn(t, dot3_rn(wx, r.dx, r.dy, r.dz)));
  v = __fadd_rn(__fadd_rn(dot3_rn(wy, r.ox, r.oy, r.oz), wy.w),
                __fmul_rn(t, dot3_rn(wy, r.dx, r.dy, r.dz)));
}

// ---- the queries over wide BVHs: K2, K3, K4, K5 ---------------------------

#include "traverse_wide.cuh"

// ---- K6: one round of the cell wavefront ---------------------------------

// What a lane carries from round to round (traverse_dda.DdaState).
struct LaneState {
  int* __restrict__ cell;          // [n, 3] the grid cell it stands in
  float* __restrict__ t_cur;       // [n] where it entered that cell
  int* __restrict__ done;          // [n] 1 once retired
  float* __restrict__ best_t;
  long long* __restrict__ best_i;
  float* __restrict__ best_u;
  float* __restrict__ best_v;
};

// The grid's frame: origin, cell size, cells per axis.
struct GridFrame {
  float lo[3], h[3];
  int d[3];
};

// The cell on axis k holding o + d t, clamped into the grid, as the plain
// entry computes it: floor(((o + d t) - lo) / h), each step rounded alone.
__device__ __forceinline__ int locate_rn(const GridFrame& g, int k, float o,
                                         float d, float t) {
  float p = __fadd_rn(o, __fmul_rn(d, t));
  float c = floorf(__fdiv_rn(__fsub_rn(p, g.lo[k]), g.h[k]));
  return static_cast<int>(fminf(fmaxf(c, 0.0f), (float)(g.d[k] - 1)));
}

// t at which the ray crosses the plane lo + c h of axis k, 1e30 where it
// runs parallel to it: (lo + c h - o) * inv, each step rounded alone.
__device__ __forceinline__ float plane_rn(const GridFrame& g, int k, int c,
                                          float o, float d, float inv) {
  return fabsf(d) > 1e-20f
             ? __fmul_rn(__fsub_rn(__fadd_rn(g.lo[k],
                                             __fmul_rn((float)c, g.h[k])),
                                   o),
                         inv)
             : 1e30f;
}

// One round of lane i: on the first, its entry into the grid; then its
// cell's clusters, the retire rule and one integer step.  Returns whether
// the lane is still live.
template <bool ANY_HIT>
__device__ __forceinline__ bool cell_round(
    const int4* __restrict__ cell_tab, const int4* __restrict__ cell_cl,
    const ClusterWalk& cw, const GridFrame& g, const Ray& r, bool first,
    const LaneState& s, int i HC3_COUNTS_PARAM) {
  int cx, cy, cz;
  float t_cur;
  Best best;
  if (first) {
    // the grid box's slab and the cell of the entry point
    float tn = -INFINITY, tf = INFINITY;
    const float o[3] = {r.ox, r.oy, r.oz}, inv[3] = {r.ix, r.iy, r.iz};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float hi = __fadd_rn(g.lo[k], __fmul_rn(g.h[k], (float)g.d[k]));
      float t0 = __fmul_rn(__fsub_rn(g.lo[k], o[k]), inv[k]);
      float t1 = __fmul_rn(__fsub_rn(hi, o[k]), inv[k]);
      tn = fmaxf(tn, fminf(t0, t1));
      tf = fminf(tf, fmaxf(t0, t1));
    }
    t_cur = fmaxf(tn, r.tmin);
    bool out = tn > tf || tf < r.tmin || r.tmax <= r.tmin;
    float te = out ? 0.0f : t_cur;
    cx = locate_rn(g, 0, r.ox, r.dx, te);
    cy = locate_rn(g, 1, r.oy, r.dy, te);
    cz = locate_rn(g, 2, r.oz, r.dz, te);
    best = Best{r.tmax, 0.0f, 0.0f, -1};
    if (out) {
      s.cell[3 * i] = cx; s.cell[3 * i + 1] = cy; s.cell[3 * i + 2] = cz;
      s.t_cur[i] = t_cur;
      s.done[i] = 1;
      s.best_t[i] = best.t; s.best_i[i] = -1;
      s.best_u[i] = 0.0f; s.best_v[i] = 0.0f;
      return false;
    }
  } else {
    cx = s.cell[3 * i]; cy = s.cell[3 * i + 1]; cz = s.cell[3 * i + 2];
    t_cur = s.t_cur[i];
    best = Best{s.best_t[i], s.best_u[i], s.best_v[i],
                static_cast<int>(s.best_i[i])};
  }
  HC3_TICK(cell);
  int4 ct = cell_tab[(cx * g.d[1] + cy) * g.d[2] + cz];
  Entry stack[MARCH_STACK];
  for (int k = 0; k < ct.y; ++k)
    if (visit_cluster<ANY_HIT>(cw, r, cell_cl[ct.x + k].x, best,
                               stack HC3_COUNTS_ARG))
      break;
  // the exit plane of each axis; retire, or step across the nearest (x
  // before y before z among equal planes)
  const float tx = plane_rn(g, 0, cx + (r.dx > 0.0f), r.ox, r.dx, r.ix);
  const float ty = plane_rn(g, 1, cy + (r.dy > 0.0f), r.oy, r.dy, r.iy);
  const float tz = plane_rn(g, 2, cz + (r.dz > 0.0f), r.oz, r.dz, r.iz);
  const float t_exit = fminf(fminf(tx, ty), tz);
  bool done = ANY_HIT ? best.tri >= 0 : best.t <= t_exit;
  if (!done) {
    bool out;
    if (tx <= ty && tx <= tz) {
      cx += r.dx > 0.0f ? 1 : -1;
      out = cx < 0 || cx >= g.d[0];
    } else if (ty <= tz) {
      cy += r.dy > 0.0f ? 1 : -1;
      out = cy < 0 || cy >= g.d[1];
    } else {
      cz += r.dz > 0.0f ? 1 : -1;
      out = cz < 0 || cz >= g.d[2];
    }
    t_cur = fmaxf(t_exit, t_cur);
    done = out || t_cur >= r.tmax;
  }
  s.cell[3 * i] = cx; s.cell[3 * i + 1] = cy; s.cell[3 * i + 2] = cz;
  s.t_cur[i] = t_cur;
  s.done[i] = done ? 1 : 0;
  s.best_t[i] = best.t;
  s.best_i[i] = best.tri;
  s.best_u[i] = best.u;
  s.best_v[i] = best.v;
  return !done;
}

// One round over all n lanes (those done return at once).  The lanes still
// live after it are added to *n_live, one atomic per warp.
template <bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK)
cell_pass_kernel(const int4* __restrict__ cell_tab,
                 const int4* __restrict__ cell_cl, ClusterWalk cw,
                 GridFrame g, const float* __restrict__ pos,
                 const float* __restrict__ dir,
                 const float* __restrict__ tmin,
                 const float* __restrict__ tmax, float tmax_cap, int n,
                 int first, LaneState s, int* __restrict__ n_live) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  bool live = false;
  if (i < n && (first || !s.done[i])) {
    HC3_COUNTS;
    Ray r = load_ray_soa(pos, dir, tmin, tmax, tmax_cap, i);
    live = cell_round<ANY_HIT>(cell_tab, cell_cl, cw, g, r, first != 0, s,
                               i HC3_COUNTS_ARG);
    HC3_FLUSH;
  }
  unsigned m = __ballot_sync(0xffffffffu, live);
  if (m != 0u && (threadIdx.x & 31) == __ffs(m) - 1)
    atomicAdd(n_live, __popc(m));
}

inline int blocks(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

// Launch KERNEL<ANY_HIT> on `threads` threads, the flag chosen at run time.
#define HC3_LAUNCH(KERNEL, any_hit, threads, ...)                             \
  do {                                                                        \
    if ((threads) > 0) {                                                      \
      if (any_hit)                                                            \
        KERNEL<true><<<blocks(threads), BLOCK, 0, s>>>(__VA_ARGS__);          \
      else                                                                    \
        KERNEL<false><<<blocks(threads), BLOCK, 0, s>>>(__VA_ARGS__);         \
    }                                                                         \
  } while (0)

#ifdef HC3_COUNT
extern "C" int hc3_counts_reset() {
  unsigned long long zero[4] = {0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_counts, zero, sizeof(zero)));
}

// out: 4 x u64 on the host (box tests, triangle tests, instances, cells);
// waits for the launches before it
extern "C" int hc3_counts_read(void* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_counts, 4 * sizeof(unsigned long long)));
}
#endif

// Registers per thread (out[0]) and local, i.e. spill, bytes (out[1]) of
// kernel k as loaded: 0/1 stream nearest/any-hit, 2 march, 3/4 two-level,
// 5/6 clusters, 7/8 cell pass.
extern "C" int hc3_traverse_attrs(int k, int* out) {
  const void* f[] = {
      (const void*)intersect_stream_kernel<false>,
      (const void*)intersect_stream_kernel<true>,
      (const void*)intersect_march_kernel,
      (const void*)intersect_tlas_kernel<false>,
      (const void*)intersect_tlas_kernel<true>,
      (const void*)intersect_clusters_kernel<false>,
      (const void*)intersect_clusters_kernel<true>,
      (const void*)cell_pass_kernel<false>,
      (const void*)cell_pass_kernel<true>};
  if (k < 0 || k >= 9) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, f[k]);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  return 0;
}

// nodes / rows / index: accel/wide_bvh.py's pack_wide_stream table, whose
// walk from node 0 needs `stack` entries per ray (refused beyond WIDE_STACK);
// the rays as the caller holds them (pos [n, 3], dir [n, 3], tmin [n],
// tmax [n], f32), tmax capped at tmax_cap; out_tri is int64
extern "C" int hc3_intersect_stream(
    const void* nodes, const void* rows, const void* index, const void* pos,
    const void* dir, const void* tmin, const void* tmax, float tmax_cap,
    int n, int any_hit, int stack, void* out_t, void* out_tri, void* out_u,
    void* out_v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stack < 0 || stack > WIDE_STACK)
    return static_cast<int>(cudaErrorInvalidValue);
  HC3_LAUNCH(intersect_stream_kernel, any_hit, n,
             static_cast<const float4*>(nodes),
             static_cast<const float4*>(rows), static_cast<const int*>(index),
             static_cast<const float*>(pos), static_cast<const float*>(dir),
             static_cast<const float*>(tmin), static_cast<const float*>(tmax),
             tmax_cap, n, static_cast<float*>(out_t),
             static_cast<long long*>(out_tri), static_cast<float*>(out_u),
             static_cast<float*>(out_v));
  return static_cast<int>(cudaGetLastError());
}

// the grid tables (cell_tab, cell_cl, cl_aabb, outliers) of
// accel/traverse_dda.py's GridPack; nodes / rows / index / cl_root: the
// pack_wide_stream table, whose walk from a cluster's root needs `cl_stack`
// entries (refused beyond MARCH_STACK) and whose boxes are widened by
// `margin` (the cluster boxes are widened by it too); the rays as
// hc3_intersect_stream takes them; out_tri is int64, out_un int32
extern "C" int hc3_intersect_march(
    const void* cell_tab, const void* cell_cl, const void* cl_aabb,
    const void* outliers, int n_outliers, const void* nodes,
    const void* rows, const void* index, const void* cl_root, int cl_stack,
    float margin, const void* pos, const void* dir, const void* tmin,
    const void* tmax, float tmax_cap, int n, float lo0, float lo1, float lo2,
    float h0,
    float h1, float h2, int d0, int d1, int d2, int max_iter, void* out_t,
    void* out_tri, void* out_u, void* out_v, void* out_un, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cl_stack < 0 || cl_stack > MARCH_STACK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    intersect_march_kernel<<<blocks(n), BLOCK, 0, s>>>(
        static_cast<const int4*>(cell_tab), static_cast<const int4*>(cell_cl),
        static_cast<const float4*>(cl_aabb),
        static_cast<const int4*>(outliers), n_outliers,
        static_cast<const float4*>(nodes), static_cast<const float4*>(rows),
        static_cast<const int*>(index), static_cast<const int*>(cl_root),
        margin, static_cast<const float*>(pos),
        static_cast<const float*>(dir),
        static_cast<const float*>(tmin), static_cast<const float*>(tmax),
        tmax_cap, n, lo0, lo1, lo2, h0, h1, h2, d0, d1, d2, max_iter,
        static_cast<float*>(out_t), static_cast<long long*>(out_tri),
        static_cast<float*>(out_u), static_cast<float*>(out_v),
        static_cast<int*>(out_un));
  }
  return static_cast<int>(cudaGetLastError());
}

// nodes / rows / index (/ inst_f / inst_i): accel/wide_bvh.py's WidePack,
// whose tree needs `stack` entries of stack per ray (refused beyond
// WIDE_STACK); the rays as the caller holds them (pos [n, 3], dir [n, 3],
// tmin [n], tmax [n], f32), tmax capped at tmax_cap; out_tri (and out_inst)
// are int64
extern "C" int hc3_intersect_tlas(
    const void* nodes, const void* rows, const void* index,
    const void* inst_f, const void* inst_i, const void* pos, const void* dir,
    const void* tmin, const void* tmax, float tmax_cap, int n, int any_hit,
    int stack, void* out_t, void* out_tri, void* out_u, void* out_v,
    void* out_inst, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stack < 0 || stack > WIDE_STACK)
    return static_cast<int>(cudaErrorInvalidValue);
  HC3_LAUNCH(intersect_tlas_kernel, any_hit, n,
             static_cast<const float4*>(nodes),
             static_cast<const float4*>(rows), static_cast<const int*>(index),
             static_cast<const float4*>(inst_f),
             static_cast<const int4*>(inst_i), static_cast<const float*>(pos),
             static_cast<const float*>(dir), static_cast<const float*>(tmin),
             static_cast<const float*>(tmax), tmax_cap, n,
             static_cast<float*>(out_t), static_cast<long long*>(out_tri),
             static_cast<float*>(out_u), static_cast<float*>(out_v),
             static_cast<long long*>(out_inst));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hc3_intersect_clusters(
    const void* nodes, const void* rows, const void* index, const void* pos,
    const void* dir, const void* tmin, const void* tmax, float tmax_cap,
    int n, int any_hit, int stack, void* out_t, void* out_tri, void* out_u,
    void* out_v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stack < 0 || stack > WIDE_STACK)
    return static_cast<int>(cudaErrorInvalidValue);
  HC3_LAUNCH(intersect_clusters_kernel, any_hit, n,
             static_cast<const float4*>(nodes),
             static_cast<const float4*>(rows), static_cast<const int*>(index),
             static_cast<const float*>(pos), static_cast<const float*>(dir),
             static_cast<const float*>(tmin), static_cast<const float*>(tmax),
             tmax_cap, n, static_cast<float*>(out_t),
             static_cast<long long*>(out_tri), static_cast<float*>(out_u),
             static_cast<float*>(out_v));
  return static_cast<int>(cudaGetLastError());
}

// One round of K6.  The grid tables (cell_tab, cell_cl, cl_aabb) of a
// GridPack without outliers and its frame (lo, h, dims); nodes / rows /
// index / cl_root / margin: the pack_wide_stream table as
// hc3_intersect_march takes it (cl_stack refused beyond MARCH_STACK); the
// rays as hc3_intersect_stream takes them; the lane state (cell [n, 3] i32,
// t_cur f32, done i32, best t f32, tri i64, u, v f32), which the first round
// (first != 0) writes from the rays.  Every lane is advanced; those still
// live are added to n_live (one i32 on the card).
extern "C" int hc3_cell_pass(
    const void* cell_tab, const void* cell_cl, const void* cl_aabb,
    const void* nodes, const void* rows, const void* index,
    const void* cl_root, int cl_stack, float margin, const void* pos,
    const void* dir, const void* tmin, const void* tmax, float tmax_cap,
    int n, float lo0, float lo1, float lo2, float h0, float h1, float h2,
    int d0, int d1, int d2, int any_hit, int first, void* cell, void* t_cur,
    void* done, void* best_t, void* best_i, void* best_u, void* best_v,
    void* n_live, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cl_stack < 0 || cl_stack > MARCH_STACK || n_live == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const ClusterWalk cw{static_cast<const float4*>(cl_aabb),
                       static_cast<const float4*>(nodes),
                       static_cast<const float4*>(rows),
                       static_cast<const int*>(index),
                       static_cast<const int*>(cl_root), margin};
  const GridFrame g{{lo0, lo1, lo2}, {h0, h1, h2}, {d0, d1, d2}};
  const LaneState ls{static_cast<int*>(cell), static_cast<float*>(t_cur),
                     static_cast<int*>(done), static_cast<float*>(best_t),
                     static_cast<long long*>(best_i),
                     static_cast<float*>(best_u), static_cast<float*>(best_v)};
  HC3_LAUNCH(cell_pass_kernel, any_hit, n,
             static_cast<const int4*>(cell_tab),
             static_cast<const int4*>(cell_cl), cw, g,
             static_cast<const float*>(pos), static_cast<const float*>(dir),
             static_cast<const float*>(tmin), static_cast<const float*>(tmax),
             tmax_cap, n, first, ls, static_cast<int*>(n_live));
  return static_cast<int>(cudaGetLastError());
}
