// Ray queries over wide BVHs with small leaves, designed for Hopper: the
// streamed scenes' any-hit / nearest walk (K2) and grid march (K3), the
// cluster-BVH query (K5) and the two-level (TLAS) query (K4), and the
// cluster visit that K3 and the cell pass K6 share (visit_cluster).
// Included by traverse.cu, whose Ray, safe_inv, slab, Best, BLOCK and
// counting macros it uses.
//
//  * intersect_stream_kernel<ANY_HIT> replaces the Pallas kernel
//    hydracore3_tpu/accel/traverse_stream.py:_kernel (wrapper
//    intersect_stream): nearest hit (t, tri, u, v) or any-hit over Woop rows,
//    walking accel/wide_bvh.py's pack_wide_stream table from node 0 (the
//    collapsed stream BVH, whose leaves lead to each cluster's own subtree).
//    tri is the contract's padded leaf-order slot; any-hit ends the walk at
//    the first valid triangle with tri = 0, t = tmin.
//  * intersect_march_kernel replaces hydracore3_tpu/accel/traverse_dda.py:
//    _march_kernel (wrapper intersect_march): outliers first, then the
//    integer 3D-DDA over the grid; at a cluster whose box (inclusive, against
//    the best t) the ray enters, a walk of that cluster's subtree of the same
//    table from cl_root[slot], with a stack of MARCH_STACK entries.  The
//    cluster boxes are widened by the table's margin, as its own boxes are
//    (accel/wide_bvh.py MARGIN_REL), so no rounding of a box test settles a
//    tie on a box's face.
//  * intersect_clusters_kernel<ANY_HIT> replaces hydracore3_tpu/accel/
//    traverse_pallas.py:_kernel (wrapper intersect_clusters): nearest hit
//    (t, tri, u, v) or any-hit over (v0, e1, e2) rows tested with
//    Moller-Trumbore (pvec = d x e2, det = pvec . e1, |det| > 1e-12; t_max is
//    not clamped here).  tri is the contract's unpadded leaf-order index,
//    read from the fine order's map.
//  * intersect_tlas_kernel<ANY_HIT> replaces hydracore3_tpu/accel/
//    traverse_tlas.py:_kernel (wrapper intersect_stream_tlas): the world-space
//    ray walks a TLAS over instance boxes; at an instance it is taken into
//    object space by the inverse matrix WITHOUT renormalizing the direction,
//    so object t equals world t and one best t culls across instances; the
//    transform is written with __fmul_rn/__fadd_rn in the order of the plain
//    torch version so both feed the same object-space ray to the Woop test.
//    tri is the contract's global padded slot.  Any-hit ends the whole walk at
//    the first valid triangle (tri = 0, t = tmin, inst = -1).
//
// What bounds them on the card.  A ray query has no matrix product and its
// loads are 16-128-byte records at data-dependent addresses, so tensor cores
// and TMA have no work here; the tables fit L2 (7.3 MB of triangle rows for a
// 152k-triangle city, 10.3 MB of Woop rows and 4.1 MB of nodes for the
// 215k-triangle bench city), so it is not DRAM bandwidth either.  Time goes to
// the latency of dependent L2 loads, to tests that a better order would not
// have made and, once those are gone, to the arithmetic of the tests that
// remain.  The TPU kernels test a 64-triangle tile at once, and a thread
// walking their tables in the fixed order of a stackless skip-pointer walk,
// or testing every row of each 64-row cluster the march met, did 399 triangle
// and 88 box tests per camera ray on the 152k-triangle city (two-level: 176,
// 65 and 4.8 instances entered; the bench city's march: 159 and 21); these
// walks do a few triangle tests a ray, counted by the -DHC3_COUNT build.  The
// design, one ray per thread:
//  * nodes of 4 children over leaves of at most 4 triangles (accel/
//    wide_bvh.py builds them from the contract tables).  A node is one aligned
//    128-byte record, children's boxes as six float4 rows and one int4 of
//    references, so a visit is one cache line and four box tests, not a chain
//    of dependent visits;
//  * near-first order: the hit children are sorted by entry distance, the
//    nearest is entered, the others wait on a per-thread stack of (reference,
//    entry distance) pairs in local memory, and a popped entry whose entry
//    distance lies beyond the best t is dropped without a load.  The fixed
//    order met the far child first for half the rays;
//  * "while-while" (Aila and Laine, Understanding the Efficiency of Ray
//    Traversal on GPUs, HPG 2009): a lane loops over inner nodes until it
//    holds a leaf and only then tests triangles, so a warp's lanes do like
//    work together;
//  * visiting order no longer settles ties, a comparison does: among equal t
//    the lower contract index wins, and in the two-level walk first the
//    instance that the contract TLAS's DFS meets first.  Boxes are entered
//    inclusively (tn <= min(tf, best t)) and an entry at the best t is kept,
//    so every candidate of a tie is reached;
//  * the kernels read the caller's ray arrays and write int64 indices, so
//    the wrapper launches nothing else (packing the rays and widening the
//    indices took as long as the walk itself).

constexpr int WIDE_EMPTY = static_cast<int>(0x80000000u);  // no child
constexpr int WIDE_STACK = 64;   // entries per ray at most
constexpr int MARCH_STACK = 16;  // entries per ray in one cluster's subtree

struct __align__(8) Entry {
  int ref;
  float t;
};

// A walk's stack is a per-thread array in local memory: interleaved by the
// hardware so a warp's accesses coalesce, and served by L1.  (Kept in shared
// memory it measured 1-10% slower on every query on an H100: 8 bytes x
// entries x 128 threads a block cut the blocks per SM.)

// The ray of lane i straight from the caller's arrays (pos [n, 3], dir
// [n, 3], tmin [n], tmax [n]; tmax capped at tmax_cap), so the wrapper packs
// nothing.
__device__ __forceinline__ Ray load_ray_soa(const float* __restrict__ pos,
                                            const float* __restrict__ dir,
                                            const float* __restrict__ tmin,
                                            const float* __restrict__ tmax,
                                            float tmax_cap, int i) {
  Ray r;
  r.ox = pos[3 * i]; r.oy = pos[3 * i + 1]; r.oz = pos[3 * i + 2];
  r.dx = dir[3 * i]; r.dy = dir[3 * i + 1]; r.dz = dir[3 * i + 2];
  r.tmin = tmin[i];
  r.tmax = fminf(tmax[i], tmax_cap);
  r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);
  return r;
}

// entry distance into one child's box, +inf on a miss (slab()'s arithmetic)
__device__ __forceinline__ float slab_entry(const Ray& r, float lx, float ly,
                                            float lz, float hx, float hy,
                                            float hz, float best_t) {
  float t0x = (lx - r.ox) * r.ix, t1x = (hx - r.ox) * r.ix;
  float t0y = (ly - r.oy) * r.iy, t1y = (hy - r.oy) * r.iy;
  float t0z = (lz - r.oz) * r.iz, t1z = (hz - r.oz) * r.iz;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                   fmaxf(fminf(t0z, t1z), r.tmin));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                   fminf(fmaxf(t0z, t1z), best_t));
  return tn <= tf ? tn : INFINITY;
}

// compare-exchange of two (entry distance, reference) pairs; the pair moves
// only when the later distance is strictly smaller
#define WIDE_CE(a, b)                                                         \
  if (t##b < t##a) {                                                          \
    float tt = t##a; t##a = t##b; t##b = tt;                                  \
    int cc = c##a; c##a = c##b; c##b = cc;                                    \
  }

// Walk the subtree under reference `cur` near-first.  `leaf(ref)` handles a
// leaf reference and returns true to end the whole query.  The stack above
// `sp` is this walk's; it returns with sp where it found it.
template <class Leaf>
__device__ __forceinline__ bool walk_wide(const float4* __restrict__ nodes,
                                          const Ray& r, int cur, int& sp,
                                          const Best& best, Leaf leaf,
                                          Entry* wide_stack HC3_COUNTS_PARAM) {
  const int base = sp;
  while (true) {
    while (cur >= 0) {
      const float4* nd = nodes + 8 * cur;
      float4 lx = nd[0], ly = nd[1], lz = nd[2];
      float4 hx = nd[3], hy = nd[4], hz = nd[5];
      int4 c = reinterpret_cast<const int4*>(nd)[6];
      int c0 = c.x, c1 = c.y, c2 = c.z, c3 = c.w;
      float t0 = slab_entry(r, lx.x, ly.x, lz.x, hx.x, hy.x, hz.x, best.t);
      float t1 = slab_entry(r, lx.y, ly.y, lz.y, hx.y, hy.y, hz.y, best.t);
      float t2 = slab_entry(r, lx.z, ly.z, lz.z, hx.z, hy.z, hz.z, best.t);
      float t3 = slab_entry(r, lx.w, ly.w, lz.w, hx.w, hy.w, hz.w, best.t);
      if (c0 == WIDE_EMPTY) t0 = INFINITY; else HC3_TICK(slab);
      if (c1 == WIDE_EMPTY) t1 = INFINITY; else HC3_TICK(slab);
      if (c2 == WIDE_EMPTY) t2 = INFINITY; else HC3_TICK(slab);
      if (c3 == WIDE_EMPTY) t3 = INFINITY; else HC3_TICK(slab);
      WIDE_CE(0, 1) WIDE_CE(2, 3) WIDE_CE(0, 2) WIDE_CE(1, 3) WIDE_CE(1, 2)
      // far to near, so the nearest waiting child is popped first
      if (t3 < INFINITY) wide_stack[sp++] = Entry{c3, t3};
      if (t2 < INFINITY) wide_stack[sp++] = Entry{c2, t2};
      if (t1 < INFINITY) wide_stack[sp++] = Entry{c1, t1};
      cur = t0 < INFINITY ? c0 : WIDE_EMPTY;
    }
    if (cur != WIDE_EMPTY && leaf(cur)) {
      sp = base;
      return true;
    }
    cur = WIDE_EMPTY;
    while (sp > base) {
      Entry e = wide_stack[--sp];
      if (e.t <= best.t) {
        cur = e.ref;
        break;
      }
    }
    if (cur == WIDE_EMPTY) return false;
  }
}

// ---- Woop rows: the test, and the streamed scenes' leaf ---------------------

// t, u, v of ray r against one triangle's Woop rows w[0..2] (woop_tuv, the
// plain version's rounding); true when the hit lies inside the triangle
// (u >= 0, v >= 0, u + v <= 1) beyond r.tmin.  An all-zero row gives
// t = NaN and is rejected.
__device__ __forceinline__ bool woop_test(const Ray& r,
                                          const float4* __restrict__ w,
                                          float& t, float& u, float& v) {
  woop_tuv(r, w, t, u, v);
  return (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > r.tmin);
}

// A leaf of pack_wide_stream's table (K2, K3).  Nearest: a hit is taken when
// t < best t, or at equal t with the lower padded slot.  Any-hit: the first
// valid triangle ends the query with tri = 0, t = tmin (returns true).
template <bool ANY_HIT>
__device__ __forceinline__ bool woop_leaf(const Ray& r,
                                          const float4* __restrict__ rows,
                                          const int* __restrict__ index,
                                          int ref, Best& best HC3_COUNTS_PARAM) {
  int code = ~ref;
  int off = code >> 3, count = code & 7;
  for (int k = 0; k < count; ++k) {
    HC3_TICK(tri);
    float t, u, v;
    if (!woop_test(r, rows + 3 * (off + k), t, u, v)) continue;
    if (ANY_HIT) {
      if (t < best.t) {
        best.t = r.tmin;
        best.tri = 0;
        return true;
      }
      continue;
    }
    if (!(t <= best.t)) continue;
    int tri = index[off + k];
    if (t < best.t || (best.tri >= 0 && tri < best.tri)) {
      best.t = t;
      best.tri = tri;
      best.u = u;
      best.v = v;
    }
  }
  return false;
}

// The streamed table at one cluster of the grid (K3, K6): the grid's cluster
// boxes (accel/traverse_dda.py GridPack.cl_aabb, by slot) and each
// cluster's subtree of pack_wide_stream's table, rooted at cl_root[slot],
// whose boxes are widened by `margin`.
struct ClusterWalk {
  const float4* __restrict__ cl_aabb;
  const float4* __restrict__ nodes;
  const float4* __restrict__ rows;
  const int* __restrict__ index;
  const int* __restrict__ cl_root;
  float margin;
};

// One cluster: its box, widened by the table's margin as its subtree's boxes
// are, inclusively against the best t, then its subtree near-first with the
// streamed leaf.  The stack holds MARCH_STACK entries.  Under ANY_HIT it
// returns true at the first occluder.
template <bool ANY_HIT>
__device__ __forceinline__ bool visit_cluster(const ClusterWalk& cw,
                                              const Ray& r, int slot,
                                              Best& best, Entry* stack
                                              HC3_COUNTS_PARAM) {
  HC3_TICK(slab);
  float4 a = cw.cl_aabb[2 * slot], b = cw.cl_aabb[2 * slot + 1];
  a.x -= cw.margin; a.y -= cw.margin; a.z -= cw.margin;
  a.w += cw.margin; b.x += cw.margin; b.y += cw.margin;
  if (!slab(r, a, b, best.t)) return false;
  auto leaf = [&](int ref) -> bool {
    return woop_leaf<ANY_HIT>(r, cw.rows, cw.index, ref, best HC3_COUNTS_ARG);
  };
  int sp = 0;
  return walk_wide(cw.nodes, r, cw.cl_root[slot], sp, best, leaf,
                   stack HC3_COUNTS_ARG);
}

// ---- the streamed scenes: any-hit / nearest from the root (K2) ------------

template <bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK)
intersect_stream_kernel(const float4* __restrict__ nodes,
                        const float4* __restrict__ rows,
                        const int* __restrict__ index,
                        const float* __restrict__ pos,
                        const float* __restrict__ dir,
                        const float* __restrict__ tmin,
                        const float* __restrict__ tmax, float tmax_cap,
                        int n, float* __restrict__ out_t,
                        long long* __restrict__ out_tri,
                        float* __restrict__ out_u,
                        float* __restrict__ out_v) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray_soa(pos, dir, tmin, tmax, tmax_cap, i);
  Best best{r.tmax, 0.0f, 0.0f, -1};
  HC3_COUNTS;
  Entry wide_stack[WIDE_STACK];
  auto leaf = [&](int ref) -> bool {
    return woop_leaf<ANY_HIT>(r, rows, index, ref, best HC3_COUNTS_ARG);
  };
  int sp = 0;
  if (r.tmax > r.tmin)
    walk_wide(nodes, r, 0, sp, best, leaf, wide_stack HC3_COUNTS_ARG);
  out_t[i] = best.t;
  out_tri[i] = best.tri;
  out_u[i] = best.u;
  out_v[i] = best.v;
  HC3_FLUSH;
}

// ---- the streamed scenes' nearest hit by grid march (K3) ------------------

__global__ void __launch_bounds__(BLOCK)
intersect_march_kernel(const int4* __restrict__ cell_tab,
                       const int4* __restrict__ cell_cl,
                       const float4* __restrict__ cl_aabb,
                       const int4* __restrict__ outliers, int n_outliers,
                       const float4* __restrict__ nodes,
                       const float4* __restrict__ rows,
                       const int* __restrict__ index,
                       const int* __restrict__ cl_root, float margin,
                       const float* __restrict__ pos,
                       const float* __restrict__ dir,
                       const float* __restrict__ tmin,
                       const float* __restrict__ tmax, float tmax_cap, int n,
                       float lo0, float lo1, float lo2,
                       float h0, float h1, float h2,
                       int d0, int d1, int d2, int max_iter,
                       float* __restrict__ out_t,
                       long long* __restrict__ out_tri,
                       float* __restrict__ out_u, float* __restrict__ out_v,
                       int* __restrict__ out_un) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray_soa(pos, dir, tmin, tmax, tmax_cap, i);
  Best best{r.tmax, 0.0f, 0.0f, -1};
  HC3_COUNTS;
  Entry march_stack[MARCH_STACK];
  const ClusterWalk cw{cl_aabb, nodes, rows, index, cl_root, margin};
  auto visit = [&](int slot) {
    visit_cluster<false>(cw, r, slot, best, march_stack HC3_COUNTS_ARG);
  };
  bool live = r.tmax > r.tmin;
  if (live)
    for (int k = 0; k < n_outliers; ++k) visit(outliers[k].x);

  // entry into the grid box lo + h * dims
  float ax0 = (lo0 - r.ox) * r.ix, bx0 = (lo0 + h0 * d0 - r.ox) * r.ix;
  float ay0 = (lo1 - r.oy) * r.iy, by0 = (lo1 + h1 * d1 - r.oy) * r.iy;
  float az0 = (lo2 - r.oz) * r.iz, bz0 = (lo2 + h2 * d2 - r.oz) * r.iz;
  float tn_box = fmaxf(fmaxf(fminf(ax0, bx0), fminf(ay0, by0)),
                       fmaxf(fminf(az0, bz0), r.tmin));
  float tf_box = fminf(fminf(fmaxf(ax0, bx0), fmaxf(ay0, by0)),
                       fmaxf(az0, bz0));
  bool done = (tn_box > tf_box) || (tf_box < r.tmin) || !live;
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
    HC3_TICK(cell);
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
  HC3_FLUSH;
}

// ---- cluster BVH: (v0, e1, e2) rows, Moller-Trumbore ----------------------

template <bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK)
intersect_clusters_kernel(const float4* __restrict__ nodes,
                          const float4* __restrict__ rows,
                          const int* __restrict__ index,
                          const float* __restrict__ pos,
                          const float* __restrict__ dir,
                          const float* __restrict__ tmin,
                          const float* __restrict__ tmax, float tmax_cap,
                          int n, float* __restrict__ out_t,
                          long long* __restrict__ out_tri,
                          float* __restrict__ out_u,
                          float* __restrict__ out_v) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray_soa(pos, dir, tmin, tmax, tmax_cap, i);
  Best best{r.tmax, 0.0f, 0.0f, -1};
  HC3_COUNTS;
  Entry wide_stack[WIDE_STACK];
  auto leaf = [&](int ref) -> bool {
    int code = ~ref;
    int off = code >> 3, count = code & 7;
    for (int k = 0; k < count; ++k) {
      HC3_TICK(tri);
      const float4* tr = rows + 3 * (off + k);
      float4 a = tr[0], b = tr[1], c = tr[2];
      float v0x = a.x, v0y = a.y, v0z = a.z;
      float e1x = a.w, e1y = b.x, e1z = b.y;
      float e2x = b.z, e2y = b.w, e2z = c.x;
      float pvx = r.dy * e2z - r.dz * e2y;
      float pvy = r.dz * e2x - r.dx * e2z;
      float pvz = r.dx * e2y - r.dy * e2x;
      float det = pvx * e1x + pvy * e1y + pvz * e1z;
      bool nondeg = fabsf(det) > 1e-12f;
      float inv = nondeg ? 1.0f / det : 0.0f;
      float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
      float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
      float qvx = tvy * e1z - tvz * e1y;
      float qvy = tvz * e1x - tvx * e1z;
      float qvz = tvx * e1y - tvy * e1x;
      float v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv;
      float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
      bool ok = nondeg && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                (t > r.tmin) && (ANY_HIT ? t < best.t : t <= best.t);
      if (ok) {
        int tri = index[off + k];
        if (ANY_HIT) {
          best.t = r.tmin;
          best.tri = tri;
          return true;
        }
        // among equal t the lower contract index wins
        if (t < best.t || (best.tri >= 0 && tri < best.tri)) {
          best.t = t;
          best.tri = tri;
          best.u = u;
          best.v = v;
        }
      }
    }
    return false;
  };
  int sp = 0;
  if (r.tmax > r.tmin)
    walk_wide(nodes, r, 0, sp, best, leaf, wide_stack HC3_COUNTS_ARG);
  out_t[i] = best.t;
  out_tri[i] = best.tri;
  out_u[i] = best.u;
  out_v[i] = best.v;
  HC3_FLUSH;
}

// ---- two-level: a TLAS over instances, per-mesh trees, Woop rows ----------

template <bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK)
intersect_tlas_kernel(const float4* __restrict__ nodes,
                      const float4* __restrict__ rows,
                      const int* __restrict__ index,
                      const float4* __restrict__ inst_f,
                      const int4* __restrict__ inst_i,
                      const float* __restrict__ pos,
                      const float* __restrict__ dir,
                      const float* __restrict__ tmin,
                      const float* __restrict__ tmax, float tmax_cap, int n,
                      float* __restrict__ out_t,
                      long long* __restrict__ out_tri,
                      float* __restrict__ out_u, float* __restrict__ out_v,
                      long long* __restrict__ out_inst) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray_soa(pos, dir, tmin, tmax, tmax_cap, i);
  Best best{r.tmax, 0.0f, 0.0f, -1};
  HC3_COUNTS;
  Entry wide_stack[WIDE_STACK];
  int best_inst = -1, best_rank = -1;
  int sp = 0;
  // a TLAS leaf: take the ray into the instance and walk its mesh
  auto instance = [&](int ref) -> bool {
    int inst = (~ref) >> 3;
    HC3_TICK(inst);
    float4 m0 = inst_f[4 * inst], m1 = inst_f[4 * inst + 1],
           m2 = inst_f[4 * inst + 2];
    int4 ii = inst_i[inst];            // (mesh root node, DFS rank, 0, 0)
    Ray o;
    o.ox = __fadd_rn(dot3_rn(m0, r.ox, r.oy, r.oz), m0.w);
    o.oy = __fadd_rn(dot3_rn(m1, r.ox, r.oy, r.oz), m1.w);
    o.oz = __fadd_rn(dot3_rn(m2, r.ox, r.oy, r.oz), m2.w);
    o.dx = dot3_rn(m0, r.dx, r.dy, r.dz);
    o.dy = dot3_rn(m1, r.dx, r.dy, r.dz);
    o.dz = dot3_rn(m2, r.dx, r.dy, r.dz);
    o.ix = safe_inv(o.dx); o.iy = safe_inv(o.dy); o.iz = safe_inv(o.dz);
    o.tmin = r.tmin; o.tmax = r.tmax;
    auto leaf = [&](int lref) -> bool {
      int code = ~lref;
      int off = code >> 3, count = code & 7;
      for (int k = 0; k < count; ++k) {
        HC3_TICK(tri);
        float t, u, v;
        bool ok = woop_test(o, rows + 3 * (off + k), t, u, v) &&
                  (ANY_HIT ? t < best.t : t <= best.t);
        if (ok) {
          if (ANY_HIT) {
            best.t = r.tmin;
            best.tri = 0;
            return true;
          }
          int tri = index[off + k];
          // among equal t the instance the contract TLAS's DFS meets first
          // wins, then the lower contract index
          if (t < best.t ||
              (best.tri >= 0 &&
               (ii.y < best_rank ||
                (ii.y == best_rank && tri < best.tri)))) {
            best.t = t;
            best.u = u;
            best.v = v;
            best.tri = tri;
            best_inst = inst;
            best_rank = ii.y;
          }
        }
      }
      return false;
    };
    return walk_wide(nodes, o, ii.x, sp, best, leaf,
                     wide_stack HC3_COUNTS_ARG);
  };
  if (r.tmax > r.tmin)
    walk_wide(nodes, r, 0, sp, best, instance, wide_stack HC3_COUNTS_ARG);
  out_t[i] = best.t;
  out_tri[i] = best.tri;
  out_u[i] = best.u;
  out_v[i] = best.v;
  out_inst[i] = best_inst;
  HC3_FLUSH;
}

#undef WIDE_CE
