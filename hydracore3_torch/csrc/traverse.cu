// Ray queries over the streamed cluster BVH and its uniform grid, for Hopper.
//
// Two kernels, one ray per thread, 128 threads per block:
//
//  * intersect_stream_kernel<ANY_HIT> replaces the Pallas kernel
//    hydracore3_tpu/accel/traverse_stream.py:_kernel (wrapper
//    intersect_stream).  It walks the skip-pointer BVH in DFS pre-order with
//    no stack: on an AABB hit at an internal node go to i+1, otherwise (or
//    after a leaf) go to skip.  Leaves are clusters of up to 64 triangles in
//    Woop form.  Nearest-hit (t, tri, u, v) or any-hit (tri = 0, t = tmin
//    on occlusion) in one kernel, chosen by the template flag.
//  * intersect_march_kernel replaces hydracore3_tpu/accel/traverse_dda.py:
//    _march_kernel (wrapper intersect_march).  It tests the outlier clusters
//    first, then 3D-DDA-marches the grid front to back (integer cell steps
//    across the nearest face, or a jump over the empty-space radius the grid
//    stores per cell), testing each cell's clusters (AABB against the
//    current best t, then their triangles), and stops once the best hit lies
//    before the current cell's exit or the ray leaves the grid.  Every lane
//    is marched to its end; a lane still live after the iteration cap is
//    reported unresolved (none is expected).
//
// What bounds them on the card: each step is a dependent load (node, cell
// list, cluster box, then 48 bytes per triangle) whose address comes from
// the previous one, and the lanes of a warp diverge in path length.  The
// scene's Woop rows (~12 MB for 215k triangles) fit the 50 MB L2, so the
// loads are L2 latency rather than DRAM bandwidth.  The simple design keeps
// every load a 16-byte vector load (nodes, boxes and triangle rows are
// float4/int4 rows), culls a cluster by its box before touching its
// triangles, loops over the real triangles of a leaf only, and relies on
// the integrator's per-bounce coherence sort to keep neighbouring lanes on
// similar paths.  No shared memory, tiles or queues.
//
// Semantics follow the JAX kernels: slab test with inv = 1/d where
// |d| > 1e-20 else 1e30, tn = max(mins, tmin), tf = min(maxs, best_t), hit
// if tn <= tf; Woop test t = -po_z/pd_z, u = po_x + t pd_x,
// v = po_y + t pd_y, accepted when u >= 0, v >= 0, u + v <= 1,
// tmin < t < best_t (all-zero padding rows give NaN and are rejected); ties
// keep the lowest index within a cluster and the first cluster visited.

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

// Woop test of triangles [base, base + count) (rows of 3 float4).
// Returns true on the first valid triangle under ANY_HIT.
template <bool ANY_HIT>
__device__ __forceinline__ bool cluster(const Ray& r,
                                        const float4* __restrict__ woop,
                                        int base, int count, Best& best) {
  for (int k = 0; k < count; ++k) {
    const float4* w = woop + 3 * (base + k);
    float4 wx = w[0], wy = w[1], wz = w[2];
    float po_z = wz.x * r.ox + wz.y * r.oy + wz.z * r.oz + wz.w;
    float pd_z = wz.x * r.dx + wz.y * r.dy + wz.z * r.dz;
    float t = -po_z / pd_z;
    float u = (wx.x * r.ox + wx.y * r.oy + wx.z * r.oz + wx.w)
              + t * (wx.x * r.dx + wx.y * r.dy + wx.z * r.dz);
    float v = (wy.x * r.ox + wy.y * r.oy + wy.z * r.oz + wy.w)
              + t * (wy.x * r.dx + wy.y * r.dy + wy.z * r.dz);
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

template <bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK)
intersect_stream_kernel(const float4* __restrict__ nodes_f,
                        const int4* __restrict__ nodes_i,
                        const float4* __restrict__ woop,
                        const float4* __restrict__ rays, int n,
                        float* __restrict__ out_t, int* __restrict__ out_tri,
                        float* __restrict__ out_u, float* __restrict__ out_v) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(rays, i);
  Best best{r.tmax, 0.0f, 0.0f, -1};
  int node = 0;
  while (node >= 0) {
    int4 ni = nodes_i[node];
    bool hit = slab(r, nodes_f[2 * node], nodes_f[2 * node + 1], best.t);
    if (hit && ni.y >= 0) {
      if (cluster<ANY_HIT>(r, woop, ni.y * TBK, ni.z, best)) break;
    }
    node = (hit && ni.y < 0) ? node + 1 : ni.x;
  }
  out_t[i] = best.t;
  out_tri[i] = best.tri;
  out_u[i] = best.u;
  out_v[i] = best.v;
}

__global__ void __launch_bounds__(BLOCK)
intersect_march_kernel(const int4* __restrict__ cell_tab,
                       const int4* __restrict__ cell_cl,
                       const float4* __restrict__ cl_aabb,
                       const int* __restrict__ cl_count,
                       const int4* __restrict__ outliers, int n_outliers,
                       const float4* __restrict__ woop,
                       const float4* __restrict__ rays, int n,
                       float lo0, float lo1, float lo2,
                       float h0, float h1, float h2,
                       int d0, int d1, int d2, int max_iter,
                       float* __restrict__ out_t, int* __restrict__ out_tri,
                       float* __restrict__ out_u, float* __restrict__ out_v,
                       int* __restrict__ out_un) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(rays, i);
  Best best{r.tmax, 0.0f, 0.0f, -1};

  auto visit = [&](int slot) {
    if (slab(r, cl_aabb[2 * slot], cl_aabb[2 * slot + 1], best.t))
      cluster<false>(r, woop, slot * TBK, cl_count[slot], best);
  };
  for (int k = 0; k < n_outliers; ++k) visit(outliers[k].x);

  // entry into the grid box lo + h * dims
  float ax0 = (lo0 - r.ox) * r.ix, bx0 = (lo0 + h0 * d0 - r.ox) * r.ix;
  float ay0 = (lo1 - r.oy) * r.iy, by0 = (lo1 + h1 * d1 - r.oy) * r.iy;
  float az0 = (lo2 - r.oz) * r.iz, bz0 = (lo2 + h2 * d2 - r.oz) * r.iz;
  float tn_box = fmaxf(fmaxf(fminf(ax0, bx0), fminf(ay0, by0)),
                       fmaxf(fminf(az0, bz0), r.tmin));
  float tf_box = fminf(fminf(fmaxf(ax0, bx0), fmaxf(ay0, by0)),
                       fmaxf(az0, bz0));
  bool done = (tn_box > tf_box) || (tf_box < r.tmin) || !(r.tmax > r.tmin);
  float t_cell_min = fminf(fminf(h0 * fabsf(r.ix), h1 * fabsf(r.iy)),
                           h2 * fabsf(r.iz));
  float t_cur = tn_box;
  int cx = 0, cy = 0, cz = 0;
  // the cell holding the point at t, clamped into the grid
  auto locate = [&](float t) {
    cx = min(max((int)floorf((r.ox + r.dx * t - lo0) / h0), 0), d0 - 1);
    cy = min(max((int)floorf((r.oy + r.dy * t - lo1) / h1), 0), d1 - 1);
    cz = min(max((int)floorf((r.oz + r.dz * t - lo2) / h2), 0), d2 - 1);
  };
  if (!done) locate(t_cur);
  for (int it = 0; !done && it < max_iter; ++it) {
    int4 ct = cell_tab[(cx * d1 + cy) * d2 + cz];
    for (int j = 0; j < ct.y; ++j) visit(cell_cl[ct.x + j].x);
    float tx = fabsf(r.dx) > 1e-20f
                   ? (lo0 + (float)(cx + (r.dx > 0.0f)) * h0 - r.ox) * r.ix
                   : 1e30f;
    float ty = fabsf(r.dy) > 1e-20f
                   ? (lo1 + (float)(cy + (r.dy > 0.0f)) * h1 - r.oy) * r.iy
                   : 1e30f;
    float tz = fabsf(r.dz) > 1e-20f
                   ? (lo2 + (float)(cz + (r.dz > 0.0f)) * h2 - r.oz) * r.iz
                   : 1e30f;
    float t_exit = fminf(fminf(tx, ty), tz);
    if (best.t <= t_exit) {          // the hit lies in the visited prefix
      done = true;
      break;
    }
    // empty-space skip over the cell's chebyshev-r empty ball (r >= 2),
    // else one integer DDA step across the nearest cell face.  The integer
    // step always advances, even where rounding puts a face behind t_cur
    // (a ray starting on a cell boundary).
    float t_skip = t_cur + (float)(ct.z - 1) * t_cell_min;
    if (ct.z > 1 && t_skip > t_exit) {
      t_cur = t_skip;
      if (t_cur >= tf_box) {
        done = true;
        break;
      }
      locate(t_cur);
    } else {
      t_cur = fmaxf(t_exit, t_cur);
      bool out;
      if (tx <= ty && tx <= tz) {
        cx += r.dx > 0.0f ? 1 : -1;
        out = cx < 0 || cx >= d0;
      } else if (ty <= tz) {
        cy += r.dy > 0.0f ? 1 : -1;
        out = cy < 0 || cy >= d1;
      } else {
        cz += r.dz > 0.0f ? 1 : -1;
        out = cz < 0 || cz >= d2;
      }
      if (out) {                      // left the grid
        done = true;
        break;
      }
    }
    if (t_cur >= r.tmax) done = true;
  }
  out_t[i] = best.t;
  out_tri[i] = best.tri;
  out_u[i] = best.u;
  out_v[i] = best.v;
  out_un[i] = done ? 0 : 1;
}

inline int blocks(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

extern "C" int hc3_intersect_stream(const void* nodes_f, const void* nodes_i,
                                    const void* woop, const void* rays, int n,
                                    int any_hit, void* out_t, void* out_tri,
                                    void* out_u, void* out_v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto nf = static_cast<const float4*>(nodes_f);
  auto ni = static_cast<const int4*>(nodes_i);
  auto w = static_cast<const float4*>(woop);
  auto r = static_cast<const float4*>(rays);
  auto t = static_cast<float*>(out_t);
  auto tri = static_cast<int*>(out_tri);
  auto u = static_cast<float*>(out_u);
  auto v = static_cast<float*>(out_v);
  if (n > 0 && any_hit)
    intersect_stream_kernel<true><<<blocks(n), BLOCK, 0, s>>>(
        nf, ni, w, r, n, t, tri, u, v);
  else if (n > 0)
    intersect_stream_kernel<false><<<blocks(n), BLOCK, 0, s>>>(
        nf, ni, w, r, n, t, tri, u, v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hc3_intersect_march(
    const void* cell_tab, const void* cell_cl, const void* cl_aabb,
    const void* cl_count, const void* outliers, int n_outliers,
    const void* woop, const void* rays, int n, float lo0, float lo1, float lo2,
    float h0, float h1, float h2, int d0, int d1, int d2, int max_iter,
    void* out_t, void* out_tri, void* out_u, void* out_v,
    void* out_un, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    intersect_march_kernel<<<blocks(n), BLOCK, 0, s>>>(
        static_cast<const int4*>(cell_tab), static_cast<const int4*>(cell_cl),
        static_cast<const float4*>(cl_aabb), static_cast<const int*>(cl_count),
        static_cast<const int4*>(outliers), n_outliers,
        static_cast<const float4*>(woop), static_cast<const float4*>(rays), n,
        lo0, lo1, lo2, h0, h1, h2, d0, d1, d2, max_iter,
        static_cast<float*>(out_t), static_cast<int*>(out_tri),
        static_cast<float*>(out_u), static_cast<float*>(out_v),
        static_cast<int*>(out_un));
  }
  return static_cast<int>(cudaGetLastError());
}
