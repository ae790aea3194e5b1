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
//    traverse_dda.py:_cell_kernel (one round of intersect_dda): each lane
//    brings the id of the grid cell it stands in (BIG_I = idle) and its
//    running best; the kernel tests that cell's clusters (box against the
//    best t, then their 64-row Woop tiles of the contract table one by one,
//    rays packed as [n, 8] rows), updates the best in place and flags the
//    lane processed.  A lane's cell is always taken whole, so the TPU
//    kernel's per-tile cell cap and cluster queue are gone.  It has not been
//    redesigned yet: its clusters could be walked as K3 walks them.
//
// Semantics follow the JAX kernels: slab test with inv = 1/d where
// |d| > 1e-20 else 1e30, tn = max(mins, tmin), tf = min(maxs, best_t), hit
// if tn <= tf; Woop test t = -po_z/pd_z, u = po_x + t pd_x,
// v = po_y + t pd_y, accepted when u >= 0, v >= 0, u + v <= 1,
// tmin < t < best_t (all-zero padding rows give NaN and are rejected); among
// equal t the lowest padded index wins (K2, K3: by comparison; K6: the
// first cluster visited, the lowest index within a cluster).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TBK = 64;          // triangles per cluster
constexpr int BLOCK = 128;       // threads per block

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin, tmax;
};

__device__ __forceinline__ float safe_inv(float d) {
  return fabsf(d) > 1e-20f ? 1.0f / d : 1e30f;
}

__device__ __forceinline__ Ray load_ray(const float4* __restrict__ rays,
                                        int i) {
  float4 a = rays[2 * i];
  float4 b = rays[2 * i + 1];
  Ray r;
  r.ox = a.x; r.oy = a.y; r.oz = a.z;
  r.dx = a.w; r.dy = b.x; r.dz = b.y;
  r.tmin = b.z; r.tmax = b.w;
  r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);
  return r;
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

// Woop test of triangles [base, base + count) (rows of 3 float4), for K6.
// Returns true on the first valid triangle under ANY_HIT.
template <bool ANY_HIT>
__device__ __forceinline__ bool cluster(const Ray& r,
                                        const float4* __restrict__ woop,
                                        int base, int count,
                                        Best& best HC3_COUNTS_PARAM) {
  for (int k = 0; k < count; ++k) {
    HC3_TICK(tri);
    float t, u, v;
    woop_tuv(r, woop + 3 * (base + k), t, u, v);
    bool valid = (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                 (t > r.tmin) && (t < best.t);
    if (valid) {
      if (ANY_HIT) {
        best.t = r.tmin;
        best.tri = 0;
        return true;
      }
      best.t = t;
      best.u = u;
      best.v = v;
      best.tri = base + k;
    }
  }
  return false;
}

// ---- the queries over wide BVHs: K2, K3, K4, K5 ---------------------------

#include "traverse_wide.cuh"

// ---- one round of the cell-rebinned wavefront ---------------------------------

constexpr int BIG_I = 0x7FFFFFF0;    // idle lane

template <bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK)
cell_pass_kernel(const int4* __restrict__ cell_tab,
                 const int4* __restrict__ cell_cl,
                 const float4* __restrict__ cl_aabb,
                 const int* __restrict__ cl_count,
                 const float4* __restrict__ woop,
                 const float4* __restrict__ rays,
                 const int* __restrict__ cell, int n,
                 float* __restrict__ best_t, int* __restrict__ best_i,
                 float* __restrict__ best_u, float* __restrict__ best_v,
                 int* __restrict__ processed) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  int c = cell[i];
  if (c >= BIG_I) {
    processed[i] = 0;
    return;
  }
  Ray r = load_ray(rays, i);
  Best best{best_t[i], best_u[i], best_v[i], best_i[i]};
  HC3_COUNTS;
  int4 ct = cell_tab[c];
  HC3_TICK(cell);
  for (int j = 0; j < ct.y; ++j) {
    int slot = cell_cl[ct.x + j].x;
    HC3_TICK(slab);
    if (slab(r, cl_aabb[2 * slot], cl_aabb[2 * slot + 1], best.t) &&
        cluster<ANY_HIT>(r, woop, slot * TBK, cl_count[slot],
                         best HC3_COUNTS_ARG))
      break;
  }
  best_t[i] = best.t;
  best_i[i] = best.tri;
  best_u[i] = best.u;
  best_v[i] = best.v;
  processed[i] = 1;
  HC3_FLUSH;
}

inline int blocks(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

// Launch KERNEL<ANY_HIT> with the flag chosen at run time.
#define HC3_LAUNCH(KERNEL, any_hit, ...)                                      \
  do {                                                                        \
    if (n > 0) {                                                              \
      if (any_hit)                                                            \
        KERNEL<true><<<blocks(n), BLOCK, 0, s>>>(__VA_ARGS__);                \
      else                                                                    \
        KERNEL<false><<<blocks(n), BLOCK, 0, s>>>(__VA_ARGS__);               \
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
  HC3_LAUNCH(intersect_stream_kernel, any_hit,
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
  HC3_LAUNCH(intersect_tlas_kernel, any_hit,
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
  HC3_LAUNCH(intersect_clusters_kernel, any_hit,
             static_cast<const float4*>(nodes),
             static_cast<const float4*>(rows), static_cast<const int*>(index),
             static_cast<const float*>(pos), static_cast<const float*>(dir),
             static_cast<const float*>(tmin), static_cast<const float*>(tmax),
             tmax_cap, n, static_cast<float*>(out_t),
             static_cast<long long*>(out_tri), static_cast<float*>(out_u),
             static_cast<float*>(out_v));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hc3_cell_pass(const void* cell_tab, const void* cell_cl,
                             const void* cl_aabb, const void* cl_count,
                             const void* woop, const void* rays,
                             const void* cell, int n, int any_hit,
                             void* best_t, void* best_i, void* best_u,
                             void* best_v, void* processed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HC3_LAUNCH(cell_pass_kernel, any_hit,
             static_cast<const int4*>(cell_tab),
             static_cast<const int4*>(cell_cl),
             static_cast<const float4*>(cl_aabb),
             static_cast<const int*>(cl_count),
             static_cast<const float4*>(woop),
             static_cast<const float4*>(rays), static_cast<const int*>(cell),
             n, static_cast<float*>(best_t), static_cast<int*>(best_i),
             static_cast<float*>(best_u), static_cast<float*>(best_v),
             static_cast<int*>(processed));
  return static_cast<int>(cudaGetLastError());
}
