// The path-tracing megakernel for small scenes, for Hopper (sm_90a).
//
// Replaces the Pallas megakernel of hydracore3_tpu/models/megakernel.py:
// _build_kernels (whole_kernel and the make_kernel per-bounce chain) and
// _build_regen_kernels (make_rfirst, make_rmid).  Two entry points share the
// __device__ stage functions below, one lane per thread, 128 threads per
// block:
//
//  * mega_sample_kernel: the fixed chain.  A whole MIS sample per lane:
//    camera ray, `depth` x (nearest hit, texture tap, NEE with a shadow
//    any-hit, material sample, next ray), flat environment, contribution.
//    Texture taps run inside the kernel (four f32 texel reads), so the TPU's
//    split of the chain around between-kernel texture gathers is gone.
//  * mega_regen_kernel: `k` persistent-lane iterations per launch (rfirst,
//    then rmid): a lane whose path dies flushes the sample into its own
//    accumulator and restarts its pixel's next sample at once.  Lane state
//    lives in registers and goes to global memory ([30, N] f32 and
//    [5, N] int64, component-major so loads coalesce) between launches.
//
// The arithmetic is the plain version's (models/megakernel.py), op for op
// and in its order.  The source is built with -fmad=false so nvcc contracts
// nothing into FMAs: every product and sum rounds as the plain torch ops
// round, and the Woop test takes the same decisions.  rsqrtf, sinf, cosf
// and IEEE division are the card's, as in torch's own CUDA ops, so on the
// card the kernel equals the plain version on every lane.
//
// The trace.  The plain version (and the TPU kernel) tests every triangle
// on every bounce, <= 4,096 of them.  The kernel walks instead the pack's
// wide BVH (accel/wide_bvh.py, models/megakernel.wide_table): 128-byte
// nodes of 4 children's boxes over leaves of at most 4 of the pack's Woop
// rows, near-first with a per-lane stack of MEGA_STACK entries in local
// memory; the leaf test is the brute trace's own woop(), so t, u and v are
// its bits.  Ties are settled by comparison (the lower contract index wins
// among equal t), boxes are entered and stack entries kept at t == best,
// and any-hit returns at the first valid triangle, so the walk returns the
// brute trace's hit whenever it reaches the winner's leaf; the pack widens
// every box by a margin that covers the slab test's and the Woop test's
// rounding.  On the 16-triangle box a trace makes ~6 Woop tests instead of
// 16; on the box with its walls cut into 20 x 20 grids (4,006 triangles),
// ~4 instead of 4,096.
//
// What bounds it: per-lane arithmetic and divergence.  The tables (nodes,
// rows, shade rows, material, light and texture-slot rows, consts) are a
// few KB to a few hundred KB and stay in L1/L2; the per-lane memory traffic
// is the lane state in and out.  A shade (texture tap, NEE with its light
// sample and GLTF eval, the GLTF sample) is ~1,100 separate operations with
// no FMA, so the attainable rate is half the card's f32 peak.  Lanes of a
// warp die at different bounces (the fixed chain idles them to the end;
// regen refills them).  Material and light rows are padded to whole float4s
// and read as float4s, and a lane whose hit is a light draws NEE's random
// numbers and skips the rest of NEE, whose result its bounce discards.  No
// shared memory.  Registers and local bytes are reported by hc3_mega_attrs
// (chip_smoke.py prints them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
// Blocks an SM must hold: caps the registers at 80 a thread (the walk and
// the shading state together want 122-128, 4 blocks); measured faster on
// the box and on the tessellated box than 4, 5, 7 or 8 (PERF.md, PR 6).
constexpr int MIN_BLOCKS = 6;

// Python-float constants rounded to f32, as torch and JAX round them
#define F(x) static_cast<float>(x)

// table layouts (models/megakernel.py)
enum { MF_MTYPE = 0, MF_CFLAGS = 1, MF_C0 = 2, MF_C1 = 6, MF_C2 = 10,
       MF_DATA = 14, MF_TEXID = 22, MF_TEXC = 23, MF_ROW0 = 27, MF_ROW1 = 31,
       MF_NROWS = 40 };             // whole float4s
enum { LF_POS = 0, LF_NORM = 3, LF_INT = 6, LF_MAT = 10, LF_SIZE = 19,
       LF_PDFA = 21, LF_MULT = 22, LF_GEOM = 23, LF_DIST = 24, LF_NROWS = 28 };
enum { TF_NROWS = 6 };
enum { CN_PROJ_INV = 0, CN_WVI = 16, CN_CAM_RESP = 32, CN_ENV_COLOR = 36,
       CN_NUM_LIGHTS = 40, CN_WIDTH = 41, CN_HEIGHT = 42, CN_EXPOSURE = 43 };
constexpr int RF_NROWS = 30;
constexpr int RU_NROWS = 5;

// material / light / texture codes
constexpr float MAT_GLTF = 1.0f;
constexpr float MTYPE_SMALL_LIGHT = 9.0f;
constexpr float GLTF_COMPONENT_METAL = 4.0f;
enum { GLTF_FLOAT_MI_FDR_INT = 0, GLTF_FLOAT_ALPHA = 3,
       GLTF_FLOAT_GLOSINESS = 4, GLTF_FLOAT_IOR = 5,
       GLTF_FLOAT_REFL_COAT = 7 };
constexpr int LIGHT_GEOM_SPHERE = 3;
constexpr int LIGHT_GEOM_POINT = 5;
constexpr int LIGHT_DIST_LAMBERT = 0;
constexpr int LIGHT_DIST_OMNI = 1;
constexpr float ADDR_WRAP = 0.0f;
constexpr float ADDR_MIRROR = 2.0f;
constexpr float FILTER_LINEAR = 1.0f;

// ray flags (cglobals.h)
constexpr uint32_t RAY_EVENT_S = 1u;
constexpr uint32_t FLAG_IS_DEAD = 0x80000000u;
constexpr uint32_t FLAG_OUT_OF_SCENE = 0x40000000u;
constexpr uint32_t FLAG_HIT_LIGHT = 0x20000000u;
constexpr uint32_t FLAG_HAS_NON_SPEC = 0x10000000u;
constexpr uint32_t FLAG_HAS_INV_NORMAL = 0x08000000u;
constexpr uint32_t FLAG_PRIME_RAY_MISS = 0x02000000u;
constexpr uint32_t FLAG_FIRST_NON_SPEC = 0x01000000u;

#define M_PI_F F(3.141592653589793)
#define INV_PI_F F(0.3183098861837907)
#define TWOPI_F F(6.283185307179586)
#define FLT_MAX_F F(3.4e38)

struct V3 { float x, y, z; };
struct V4 { float x, y, z, w; };

__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
// NaN-propagating max / min (jnp.maximum, torch.clamp)
__device__ __forceinline__ float maxn(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float minn(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float clampn(float x, float lo, float hi) {
  return minn(maxn(x, lo), hi);
}
__device__ __forceinline__ V3 normalize3(V3 a) {
  float s = rsqrtf(maxn(dot3(a, a), F(1e-30)));
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ float safe_sqrt(float x) {
  return sqrtf(maxn(x, 0.0f));
}
__device__ __forceinline__ bool is_fin(float x) { return isfinite(x); }

struct Tables {
  const float4* __restrict__ nodes;   // [M, 8] float4: wide node records
  const float4* __restrict__ rows;    // [T, 3] float4: Woop rows, fine order
  const int* __restrict__ index;      // [T]: fine position -> contract index
  const float* __restrict__ shade;    // [Tpad, 32]
  const float4* __restrict__ mat;     // [128, MF_NROWS / 4]
  const float4* __restrict__ light;   // [128, LF_NROWS / 4]
  const float* __restrict__ tex;      // [128, TF_NROWS]
  const float* __restrict__ consts;   // [56]
  const float4* __restrict__ texels;  // [P] float4
  int n_texels, textured;
};

// What a lane did: Woop tests, child-box tests and shades.  Only a build
// with -DHC3_COUNT counts: a second library of this source, loaded by
// chip_smoke.py alone to measure a pass's operations (a bound's numerator),
// with hc3_mega_counts_reset / hc3_mega_counts_read besides the entry
// points.  In the shipped build the HC3_ macros expand to nothing.
#ifdef HC3_COUNT
struct Counts {
  unsigned long long woop = 0, slab = 0, shade = 0;
};
__device__ unsigned long long g_counts[3];
#define HC3_COUNTS_FIELD Counts cnt;
#define HC3_TICK(s, field) (++(s).cnt.field)
#define HC3_FLUSH(s)                                                          \
  do {                                                                        \
    atomicAdd(g_counts + 0, (s).cnt.woop);                                    \
    atomicAdd(g_counts + 1, (s).cnt.slab);                                    \
    atomicAdd(g_counts + 2, (s).cnt.shade);                                   \
  } while (0)
#define HC3_ZERO(s) ((s).cnt = Counts{})
#else
#define HC3_COUNTS_FIELD
#define HC3_TICK(s, field)
#define HC3_FLUSH(s)
#define HC3_ZERO(s)
#endif

__device__ __forceinline__ float ld(const float* p, int i) {
  return __ldg(p + i);
}

// ---- RNG (crandom.h) ------------------------------------------------------

__device__ __forceinline__ uint32_t rng_next(uint32_t& sx, uint32_t& sy) {
  uint32_t x = sx * 17u + sy * 13123u;
  uint32_t nx = (x << 13) ^ x;
  sy = sy ^ (x << 7);
  sx = nx;
  return x;
}
__device__ __forceinline__ uint32_t poly(uint32_t x, uint32_t a, uint32_t b,
                                         uint32_t c) {
  return x * (x * x * a + b) + c;
}
__device__ __forceinline__ float u01(uint32_t u) {
  return __uint2float_rn(u) * F(1.0 / 4294967296.0);
}
__device__ __forceinline__ void rnd4(uint32_t& sx, uint32_t& sy, float r[4]) {
  uint32_t x = rng_next(sx, sy);
  r[0] = u01(poly(x, 15731u, 74323u, 871483u));
  r[1] = u01(poly(x, 13734u, 37828u, 234234u));
  r[2] = u01(poly(x, 11687u, 26461u, 137589u));
  r[3] = u01(poly(x, 15707u, 789221u, 1376312589u));
}
__device__ __forceinline__ float rnd1(uint32_t& sx, uint32_t& sy) {
  return u01(poly(rng_next(sx, sy), 15731u, 74323u, 871483u));
}

// ---- lane state -----------------------------------------------------------

struct St {
  V3 o, d;
  V4 accum, thr;
  float mis_pdf, mis_ior;
  V3 hit_pos, hit_norm;
  float hit_u, hit_v, hit_dist, hit_lgt;
  uint32_t rngx, rngy, flags;
  HC3_COUNTS_FIELD
};

__device__ __forceinline__ bool dead(const St& s) {
  return (s.flags & FLAG_IS_DEAD) != 0;
}

__device__ __forceinline__ V3 mul4x3(const float* m, V3 v) {
  return {ld(m, 0) * v.x + ld(m, 1) * v.y + ld(m, 2) * v.z + ld(m, 3),
          ld(m, 4) * v.x + ld(m, 5) * v.y + ld(m, 6) * v.z + ld(m, 7),
          ld(m, 8) * v.x + ld(m, 9) * v.y + ld(m, 10) * v.z + ld(m, 11)};
}

// kernel_InitEyeRay2: the pixel's next camera ray (advances the RNG)
__device__ void stage_init(const Tables& tb, float xs, float ys, St& s) {
  float r[4];
  rnd4(s.rngx, s.rngy, r);
  const float* c = tb.consts;
  float xn = (xs + r[0]) / ld(c, CN_WIDTH);
  float yn = (ys + r[1]) / ld(c, CN_HEIGHT);
  const float* p = c + CN_PROJ_INV;
  float nx = 2.0f * xn - 1.0f;
  float ny = 2.0f * yn - 1.0f;
  float px = ld(p, 0) * nx + ld(p, 1) * ny + ld(p, 3);
  float py = ld(p, 4) * nx + ld(p, 5) * ny + ld(p, 7);
  float pz = ld(p, 8) * nx + ld(p, 9) * ny + ld(p, 11);
  float pw = ld(p, 12) * nx + ld(p, 13) * ny + ld(p, 15);
  float inv_w = 1.0f / (pw == 0.0f ? 1.0f : pw);
  V3 d = normalize3({px * inv_w, py * inv_w, pz * inv_w});
  V3 o = mul4x3(c + CN_WVI, {0.0f, 0.0f, 0.0f});
  V3 p2 = mul4x3(c + CN_WVI, scale(d, 100.0f));
  s.o = o;
  s.d = normalize3(sub(p2, o));
  s.flags = 0u;
  s.accum = {0.0f, 0.0f, 0.0f, 0.0f};
  s.thr = {1.0f, 1.0f, 1.0f, 1.0f};
  s.mis_pdf = 1.0f;
  s.mis_ior = 1.0f;
  s.hit_pos = {0.0f, 0.0f, 0.0f};
  s.hit_norm = {0.0f, 0.0f, 0.0f};
  s.hit_u = s.hit_v = s.hit_dist = 0.0f;
  s.hit_lgt = -1.0f;
}

// ---- the trace: a near-first walk of the pack's wide BVH -----------------

struct Hit {
  float t, u, v;
  int tri;
};

constexpr int MEGA_STACK = 32;          // entries per lane at most
constexpr int WIDE_EMPTY = static_cast<int>(0x80000000u);  // no child

struct __align__(8) Entry {
  int ref;
  float t;
};

// The Woop test of the plain version's _trace_blocks, op for op (under
// -fmad=false nothing is contracted), on one triangle's rows w[0..2]
__device__ __forceinline__ void woop(const float4* __restrict__ w, V3 o, V3 d,
                                     float& t, float& u, float& v) {
  float4 a = __ldg(w), b = __ldg(w + 1), c = __ldg(w + 2);
  float po_x = a.x * o.x + a.y * o.y + a.z * o.z + a.w * 1.0f;
  float pd_x = a.x * d.x + a.y * d.y + a.z * d.z + a.w * 0.0f;
  float po_y = b.x * o.x + b.y * o.y + b.z * o.z + b.w * 1.0f;
  float pd_y = b.x * d.x + b.y * d.y + b.z * d.z + b.w * 0.0f;
  float po_z = c.x * o.x + c.y * o.y + c.z * o.z + c.w * 1.0f;
  float pd_z = c.x * d.x + c.y * d.y + c.z * d.z + c.w * 0.0f;
  t = -po_z / pd_z;      // degenerate rows: 0/0 = NaN, rejected
  u = po_x + t * pd_x;
  v = po_y + t * pd_y;
}

__device__ __forceinline__ float safe_inv(float d) {
  return fabsf(d) > F(1e-20) ? 1.0f / d : F(1e30);
}

// entry distance of the ray into one child's box (t >= 0), +inf on a miss;
// inclusive against the best t, so a box at the best t is still entered
__device__ __forceinline__ float slab_entry(V3 o, V3 inv, float lx, float ly,
                                            float lz, float hx, float hy,
                                            float hz, float best_t) {
  float t0x = (lx - o.x) * inv.x, t1x = (hx - o.x) * inv.x;
  float t0y = (ly - o.y) * inv.y, t1y = (hy - o.y) * inv.y;
  float t0z = (lz - o.z) * inv.z, t1z = (hz - o.z) * inv.z;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                   fmaxf(fminf(t0z, t1z), 0.0f));
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

// Nearest hit in (0, tmax), or (ANY_HIT) whether any triangle is hit there
// (tri 0).  The walk visits a node's children nearest first and keeps the
// others on the lane's stack; a popped entry beyond the best t is dropped.
// Every triangle whose leaf the walk reaches gets the brute trace's test, so
// the result is the brute trace's bit for bit whenever the winner's leaf is
// reached: ties go to the lower contract index by comparison, and boxes are
// entered, and entries kept, at t == best (the pack widens every box by a
// margin that covers the Woop test's rounding, models/megakernel.py).
template <bool ANY_HIT>
__device__ Hit trace(const Tables& tb, V3 o, V3 d, float tmax, St& s,
                     Entry* __restrict__ stack) {
  Hit h{tmax, 0.0f, 0.0f, -1};
  V3 inv = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  int sp = 0, cur = 0;
  while (true) {
    while (cur >= 0) {
      const float4* nd = tb.nodes + 8 * cur;
      float4 lx = __ldg(nd), ly = __ldg(nd + 1), lz = __ldg(nd + 2);
      float4 hx = __ldg(nd + 3), hy = __ldg(nd + 4), hz = __ldg(nd + 5);
      int4 c = __ldg(reinterpret_cast<const int4*>(nd) + 6);
      int c0 = c.x, c1 = c.y, c2 = c.z, c3 = c.w;
      float t0 = slab_entry(o, inv, lx.x, ly.x, lz.x, hx.x, hy.x, hz.x, h.t);
      float t1 = slab_entry(o, inv, lx.y, ly.y, lz.y, hx.y, hy.y, hz.y, h.t);
      float t2 = slab_entry(o, inv, lx.z, ly.z, lz.z, hx.z, hy.z, hz.z, h.t);
      float t3 = slab_entry(o, inv, lx.w, ly.w, lz.w, hx.w, hy.w, hz.w, h.t);
      if (c0 == WIDE_EMPTY) t0 = INFINITY; else HC3_TICK(s, slab);
      if (c1 == WIDE_EMPTY) t1 = INFINITY; else HC3_TICK(s, slab);
      if (c2 == WIDE_EMPTY) t2 = INFINITY; else HC3_TICK(s, slab);
      if (c3 == WIDE_EMPTY) t3 = INFINITY; else HC3_TICK(s, slab);
      // far to near, so the nearest waiting child is popped first (any-hit
      // takes the first occluder wherever it lies: unsorted measured faster)
      if (!ANY_HIT) {
        WIDE_CE(0, 1) WIDE_CE(2, 3) WIDE_CE(0, 2) WIDE_CE(1, 3) WIDE_CE(1, 2)
      }
      if (t3 < INFINITY) stack[sp++] = Entry{c3, t3};
      if (t2 < INFINITY) stack[sp++] = Entry{c2, t2};
      if (t1 < INFINITY) stack[sp++] = Entry{c1, t1};
      cur = t0 < INFINITY ? c0 : WIDE_EMPTY;
    }
    if (cur != WIDE_EMPTY) {            // a leaf: count <= 4 rows from off
      int code = ~cur;
      int off = code >> 3, count = code & 7;
      for (int k = 0; k < count; ++k) {
        HC3_TICK(s, woop);
        float t, u, v;
        woop(tb.rows + 3 * (off + k), o, d, t, u, v);
        if (!(u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f &&
              t < tmax))
          continue;
        if (ANY_HIT) return Hit{0.0f, 0.0f, 0.0f, 0};
        int tri = __ldg(tb.index + off + k);
        if (t < h.t || (t == h.t && tri < h.tri)) h = Hit{t, u, v, tri};
      }
    }
    cur = WIDE_EMPTY;
    while (sp > 0) {
      Entry e = stack[--sp];
      if (e.t <= h.t) {
        cur = e.ref;
        break;
      }
    }
    if (cur == WIDE_EMPTY) return h;
  }
}

#undef WIDE_CE

// kernel_RayTrace2: nearest hit, shade-row lerp, normal flip, flags
__device__ void stage_trace(const Tables& tb, St& s, bool prim,
                            Entry* __restrict__ stack) {
  if (dead(s)) return;
  Hit h = trace<false>(tb, s.o, s.d, FLT_MAX_F, s, stack);
  if (!(h.t < F(3.4e38 * 0.5))) {
    s.flags |= FLAG_IS_DEAD | FLAG_OUT_OF_SCENE |
               (prim ? FLAG_PRIME_RAY_MISS : 0u);
    return;
  }
  const float* sr = tb.shade + 32 * h.tri;
  float wa = 1.0f - h.u - h.v;
  float data[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    data[j] = wa * ld(sr, j) + h.u * ld(sr, 8 + j) + h.v * ld(sr, 16 + j);
  V3 n = normalize3({data[0], data[1], data[2]});
  uint32_t mid = (uint32_t)(int)floorf(ld(sr, 24) + 0.5f);
  float lgt = floorf(ld(sr, 25) + 0.5f);
  float flip = dot3(s.d, n) > F(0.001) ? -1.0f : 1.0f;
  uint32_t flags = flip < 0.0f ? (s.flags | FLAG_HAS_INV_NORMAL)
                               : (s.flags & ~FLAG_HAS_INV_NORMAL);
  s.flags = (flags & 0xFF000000u) | (mid & 0x00FFFFFFu);
  s.hit_pos = add(s.o, scale(s.d, h.t * F(1.0 - 1e-6)));
  s.hit_norm = scale(n, flip);
  s.hit_u = data[3];
  s.hit_v = data[7];
  s.hit_dist = h.t;
  s.hit_lgt = lgt;
}

// ---- materials --------------------------------------------------------------

struct Mat {
  float mtype, cflags, texid;
  V4 c0, c1, c2, texc;
  float data[8], row0[4], row1[4];
};

// columns c0..c0+n of a row held as float4s, read as whole float4s
template <int N>
__device__ __forceinline__ void ld_row(const float4* __restrict__ row,
                                       float (&out)[N]) {
#pragma unroll
  for (int q = 0; q < (N + 3) / 4; ++q) {
    float4 x = __ldg(row + q);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * q + j < N) out[4 * q + j] = xs[j];
  }
}

__device__ __forceinline__ V4 v4(const float* r, int c) {
  return {r[c], r[c + 1], r[c + 2], r[c + 3]};
}

__device__ Mat fetch_mat(const Tables& tb, uint32_t mid) {
  float r[MF_ROW1 + 4];
  ld_row(tb.mat + (mid < 127u ? mid : 127u) * (MF_NROWS / 4), r);
  Mat m;
  m.mtype = r[MF_MTYPE];
  m.cflags = r[MF_CFLAGS];
  m.texid = r[MF_TEXID];
  m.c0 = v4(r, MF_C0);
  m.c1 = v4(r, MF_C1);
  m.c2 = v4(r, MF_C2);
  m.texc = v4(r, MF_TEXC);
#pragma unroll
  for (int j = 0; j < 8; ++j) m.data[j] = r[MF_DATA + j];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m.row0[j] = r[MF_ROW0 + j];
    m.row1[j] = r[MF_ROW1 + j];
  }
  return m;
}

__device__ __forceinline__ float norm_coord(float uc, float mode) {
  float wrapped = uc - floorf(uc);
  float clamped = clampn(uc, 0.0f, 1.0f);
  float half = 0.5f * uc;
  float m2 = 2.0f * (half - floorf(half));
  float mirrored = m2 < 1.0f ? m2 : 2.0f - m2;
  return mode == ADDR_WRAP ? wrapped
                           : (mode == ADDR_MIRROR ? mirrored : clamped);
}

__device__ __forceinline__ float4 texel(const Tables& tb, int i) {
  i = i < 0 ? 0 : (i >= tb.n_texels ? tb.n_texels - 1 : i);
  return __ldg(tb.texels + i);
}

// slot-0 texture color at the hit: the JAX stage_tap_prep / _uv_to_quad /
// tex_from_rows, with the quad's four corners read from the f32 pool
__device__ V4 tex_tap(const Tables& tb, const Mat& m, const St& s) {
  if (!tb.textured) return m.texc;
  int texid = (int)m.texid;
  texid = texid < 0 ? 0 : (texid > 127 ? 127 : texid);
  float tcx = m.row0[0] * s.hit_u + m.row0[1] * s.hit_v + m.row0[3];
  float tcy = m.row1[0] * s.hit_u + m.row1[1] * s.hit_v + m.row1[3];
  const float* tr = tb.tex + texid * TF_NROWS;
  float off = ld(tr, 0), wf = ld(tr, 1), hf = ld(tr, 2), filt = ld(tr, 3);
  float au = ld(tr, 4), av = ld(tr, 5);
  float ffx = norm_coord(tcx, au) * wf - 0.5f;
  float ffy = norm_coord(tcy, av) * hf - 0.5f;
  bool wrap_u = au == ADDR_WRAP, wrap_v = av == ADDR_WRAP;
  if (!wrap_u) ffx = minn(maxn(ffx, 0.0f), wf - 1.0f);
  if (!wrap_v) ffy = minn(maxn(ffy, 0.0f), hf - 1.0f);
  float px = floorf(ffx), py = floorf(ffy);
  float fx = ffx - px, fy = ffy - py;
  float wx = px < 0.0f ? wf - 1.0f : px;
  float wy = py < 0.0f ? hf - 1.0f : py;
  float w00, w10, w01, w11;
  if (filt == FILTER_LINEAR) {
    w00 = (1.0f - fx) * (1.0f - fy);
    w10 = fx * (1.0f - fy);
    w01 = (1.0f - fx) * fy;
    w11 = fx * fy;
  } else {  // nearest: the quad corner int(u * w) falls on
    float right = fx >= 0.5f ? 1.0f : 0.0f;
    float down = fy >= 0.5f ? 1.0f : 0.0f;
    w00 = (1.0f - right) * (1.0f - down);
    w10 = right * (1.0f - down);
    w01 = (1.0f - right) * down;
    w11 = right * down;
  }
  int x = (int)wx, y = (int)wy, w = (int)wf, h = (int)hf, o = (int)off;
  int x1 = wrap_u ? (x + 1 >= w ? 0 : x + 1) : min(x + 1, w - 1);
  int y1 = wrap_v ? (y + 1 >= h ? 0 : y + 1) : min(y + 1, h - 1);
  float4 c00 = texel(tb, o + y * w + x), c10 = texel(tb, o + y * w + x1);
  float4 c01 = texel(tb, o + y1 * w + x), c11 = texel(tb, o + y1 * w + x1);
  return {c00.x * w00 + c10.x * w10 + c01.x * w01 + c11.x * w11,
          c00.y * w00 + c10.y * w10 + c01.y * w01 + c11.y * w11,
          c00.z * w00 + c10.z * w10 + c01.z * w01 + c11.z * w11,
          c00.w * w00 + c10.w * w10 + c01.w * w01 + c11.w * w11};
}

// cglobals.h:120-132
__device__ __forceinline__ void coordinate_system_v2(V3 n, V3& s, V3& t) {
  bool pos = n.z >= 0.0f;
  float sign = pos ? 1.0f : -1.0f;
  float a = -1.0f / (sign + n.z);
  float b = n.x * n.y * a;
  s = {(pos ? n.x * n.x * a : -n.x * n.x * a) + 1.0f, pos ? b : -b,
       pos ? -n.x : n.x};
  t = {b, n.y * n.y * a + sign, -n.y};
}

__device__ V3 map_sample_to_cosine(float r1, float r2, V3 dir, V3 hit_norm) {
  float sin_phi = sinf(TWOPI_F * r1), cos_phi = cosf(TWOPI_F * r1);
  float cos_theta = sqrtf(maxn(1.0f - r2, F(1e-20)));
  float sin_theta = safe_sqrt(1.0f - cos_theta * cos_theta);
  float dx = sin_theta * cos_phi, dy = sin_theta * sin_phi, dz = cos_theta;
  V3 nx, ny;
  coordinate_system_v2(dir, nx, ny);
  V3 nz = dir;
  V3 res = {nx.x * dx + ny.x * dy + nz.x * dz, nx.y * dx + ny.y * dy + nz.y * dz,
            nx.z * dx + ny.z * dy + nz.z * dz};
  float inv_sign = dot3(dir, hit_norm) > 0.0f ? 1.0f : -1.0f;
  if (inv_sign * dot3(res, hit_norm) < 0.0f)
    res = {-nx.x * dx + ny.x * dy - nz.x * dz,
           -nx.y * dx + ny.y * dy - nz.y * dz,
           -nx.z * dx + ny.z * dy - nz.z * dz};
  return res;
}

__device__ __forceinline__ float fresnel_slick(float c) {
  float tmp = 1.0f - fabsf(c);
  float t2 = tmp * tmp;
  return t2 * t2 * tmp;
}

__device__ float fr_dielectric_pbrt(float cos_i, float eta_i, float eta_t) {
  cos_i = clampn(cos_i, -1.0f, 1.0f);
  bool entering = cos_i > 0.0f;
  float ei = entering ? eta_i : eta_t;
  float et = entering ? eta_t : eta_i;
  float et_s = fabsf(et) < F(1e-12) ? 1.0f : et;
  float ei_s = fabsf(ei) < F(1e-12) ? 1.0f : ei;
  float ci = fabsf(cos_i);
  float sin_i = safe_sqrt(1.0f - ci * ci);
  float sin_t = ei_s / et_s * sin_i;
  float ct = safe_sqrt(1.0f - sin_t * sin_t);
  float d1 = et_s * ci + ei_s * ct;
  float d2 = ei_s * ci + et_s * ct;
  float r_parl = (et_s * ci - ei_s * ct) / (fabsf(d1) < F(1e-12) ? 1.0f : d1);
  float r_perp = (ei_s * ci - et_s * ct) / (fabsf(d2) < F(1e-12) ? 1.0f : d2);
  float r = 0.5f * (r_parl * r_parl + r_perp * r_perp);
  return sin_t >= 1.0f ? 1.0f : r;
}

__device__ __forceinline__ float ggx_distribution(float cos_nh, float alpha) {
  float a2 = alpha * alpha;
  float nh2 = clampn(cos_nh * cos_nh, 0.0f, 1.0f);
  float den = nh2 * a2 + (1.0f - nh2);
  return a2 / maxn(M_PI_F * den * den, F(1e-6));
}

__device__ __forceinline__ float ggx_geom_shad_mask(float cos_n, float alpha) {
  float c2 = clampn(cos_n * cos_n, 0.0f, 1.0f);
  float tan2 = (1.0f - c2) / maxn(c2, F(1e-6));
  return 2.0f / (1.0f + safe_sqrt(1.0f + alpha * alpha * tan2));
}

__device__ V3 ggx_sample(float r1, float r2, V3 v, V3 n, float roughness) {
  float rough2 = roughness * roughness;
  V3 nx, ny;
  coordinate_system_v2(n, nx, ny);
  V3 nz = n;
  float wox = dot3(v, nx), woy = dot3(v, ny), woz = dot3(v, nz);
  float phi = r1 * TWOPI_F;
  float cos_t = clampn(
      safe_sqrt((1.0f - r2) / (1.0f + rough2 * rough2 * r2 - r2)), 0.0f, 1.0f);
  float sin_t = safe_sqrt(1.0f - cos_t * cos_t);
  float whx = sin_t * cosf(phi), why = sin_t * sinf(phi), whz = cos_t;
  float dwh = wox * whx + woy * why + woz * whz;
  float wix = 2.0f * dwh * whx - wox;
  float wiy = 2.0f * dwh * why - woy;
  float wiz = 2.0f * dwh * whz - woz;
  return normalize3({nx.x * wix + ny.x * wiy + nz.x * wiz,
                     nx.y * wix + ny.y * wiy + nz.y * wiz,
                     nx.z * wix + ny.z * wiy + nz.z * wiz});
}

__device__ float ggx_eval_pdf(V3 l, V3 v, V3 n, float roughness) {
  float dot_nv = dot3(n, v), dot_nl = dot3(n, l);
  float rough2 = roughness * roughness;
  V3 h = normalize3(add(v, l));
  float dot_nh = dot3(n, h), dot_hv = dot3(h, v);
  float d = ggx_distribution(dot_nh, rough2);
  float pdf = d * dot_nh / (4.0f * maxn(dot_hv, F(1e-6)));
  return (dot_nv < F(1e-6) || dot_nl < F(1e-6)) ? 1.0f : pdf;
}

__device__ float ggx_eval_bsdf(V3 l, V3 v, V3 n, float roughness) {
  float dot_nv = dot3(n, v), dot_nl = dot3(n, l);
  float rough2 = roughness * roughness;
  V3 h = normalize3(add(v, l));
  float d = ggx_distribution(dot3(n, h), rough2);
  float g = ggx_geom_shad_mask(dot_nv, rough2) *
            ggx_geom_shad_mask(dot_nl, rough2);
  float val = d * g / maxn(4.0f * dot_nv * dot_nl, F(1e-6));
  bool bad = fabsf(dot3(l, n)) < F(1e-5) || dot_nv < F(1e-6) ||
             dot_nl < F(1e-6);
  return bad ? 0.0f : val;
}

__device__ __forceinline__ V4 fresnel_cond(V4 f0, float v_dot_h, float ior) {
  if (ior == 0.0f) return f0;
  float fs = fresnel_slick(v_dot_h);
  return {f0.x + (1.0f - f0.x) * fs, f0.y + (1.0f - f0.y) * fs,
          f0.z + (1.0f - f0.z) * fs, f0.w + (1.0f - f0.w) * fs};
}

struct Gltf {
  V4 base, metal_col, coat_col;
  float roughness, metalness, coat, ior;
};

__device__ __forceinline__ Gltf gltf_params(const Mat& m, V4 tex) {
  Gltf g;
  g.base = {m.c0.x * tex.x, m.c0.y * tex.y, m.c0.z * tex.z, m.c0.w * tex.w};
  g.metal_col = {m.c2.x * g.base.x, m.c2.y * g.base.y, m.c2.z * g.base.z,
                 m.c2.w * g.base.w};
  g.coat_col = m.c1;
  g.roughness = clampn(1.0f - m.data[GLTF_FLOAT_GLOSINESS], 0.0f, 1.0f);
  g.metalness = m.cflags == GLTF_COMPONENT_METAL ? 1.0f
                                                  : m.data[GLTF_FLOAT_ALPHA];
  g.coat = m.data[GLTF_FLOAT_REFL_COAT];
  g.ior = m.data[GLTF_FLOAT_IOR];
  return g;
}

// MaterialEval, GLTF (cmat_gltf.h:94-147); other materials give 0
__device__ V4 mat_eval(const Mat& m, V4 tex, V3 l, V3 v, V3 n, float& pdf) {
  pdf = 0.0f;
  if (m.mtype != MAT_GLTF) return {0.0f, 0.0f, 0.0f, 0.0f};
  Gltf g = gltf_params(m, tex);
  float lam_val = INV_PI_F;
  float lam_pdf = fabsf(dot3(l, n)) * INV_PI_F;
  bool rough = g.roughness != 0.0f;
  float ggx_val = rough ? ggx_eval_bsdf(l, v, n, g.roughness) : 0.0f;
  float ggx_pdf = rough ? ggx_eval_pdf(l, v, n, g.roughness) : 0.0f;
  float v_dot_h = rough ? dot3(v, normalize3(add(v, l))) : dot3(v, n);
  bool plastic = g.coat > 0.0f && g.metalness < 1.0f && g.ior > 0.0f;
  float f_i_c = fr_dielectric_pbrt(fabsf(dot3(v, n)), 1.0f, g.ior);
  float f_o = fr_dielectric_pbrt(fabsf(dot3(l, n)), 1.0f, g.ior);
  float fdr = m.data[GLTF_FLOAT_MI_FDR_INT];
  float x = (1.0f - f_i_c) * (1.0f - f_o) /
            maxn(g.ior * g.ior * (1.0f - fdr), F(1e-12));
  float coeff = 1.0f + (x - 1.0f) * g.coat;
  float lam_val_g = plastic ? lam_val * coeff : lam_val;
  float f_i = plastic ? f_i_c : 1.0f;
  V4 fc = fresnel_cond(g.metal_col, v_dot_h, g.ior);
  float prob_spec = 0.5f * g.coat;
  float prob_diff = 1.0f - prob_spec;
  float cw = ggx_val * f_i * g.coat;
  float mt = g.metalness, im = 1.0f - g.metalness;
  V4 val = {mt * (ggx_val * fc.x) + im * (lam_val_g * g.base.x + cw * g.coat_col.x),
            mt * (ggx_val * fc.y) + im * (lam_val_g * g.base.y + cw * g.coat_col.y),
            mt * (ggx_val * fc.z) + im * (lam_val_g * g.base.z + cw * g.coat_col.z),
            mt * (ggx_val * fc.w) + im * (lam_val_g * g.base.w + cw * g.coat_col.w)};
  float diel_pdf = lam_pdf * prob_diff + ggx_pdf * prob_spec;
  pdf = mt * ggx_pdf + im * diel_pdf;
  return val;
}

struct Sample {
  V4 val;
  V3 dir;
  float pdf;
  uint32_t flags;
};

// MaterialSampleAndEval, GLTF (cmat_gltf.h:6-91)
__device__ Sample mat_sample(const Mat& m, V4 tex, const float r[4], V3 v,
                             V3 n) {
  Sample out{{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f}, 1.0f, 0u};
  if (m.mtype != MAT_GLTF) return out;
  V3 lam_dir = map_sample_to_cosine(r[0], r[1], n, n);
  float lam_pdf = fabsf(dot3(lam_dir, n)) * INV_PI_F;
  float lam_val = INV_PI_F;
  Gltf g = gltf_params(m, tex);
  bool smooth = g.roughness == 0.0f;
  V3 mv = neg(v);
  V3 perf_refl = sub(mv, scale(n, 2.0f * dot3(mv, n)));
  float cos_out = dot3(perf_refl, n);
  float mirror_val = cos_out <= F(1e-6) ? 0.0f : 1.0f / maxn(cos_out, F(1e-6));
  V3 ggx_dir;
  float ggx_pdf, ggx_val;
  if (smooth) {
    ggx_dir = perf_refl;
    ggx_pdf = 1.0f;
    ggx_val = mirror_val;
  } else {
    ggx_dir = ggx_sample(r[0], r[1], v, n, g.roughness);
    ggx_pdf = ggx_eval_pdf(ggx_dir, v, n, g.roughness);
    ggx_val = ggx_eval_bsdf(ggx_dir, v, n, g.roughness);
  }
  float mt = g.metalness;
  bool pick_metal = r[2] < mt;
  float prob_spec = 0.5f * g.coat;
  float prob_diff = 1.0f - prob_spec;
  bool pick_spec = r[3] < prob_spec;
  uint32_t spec_flags = smooth ? RAY_EVENT_S : FLAG_HAS_NON_SPEC;
  if (pick_metal) {
    float v_dot_h = dot3(v, normalize3(add(v, ggx_dir)));
    V4 fc = fresnel_cond(g.metal_col, v_dot_h, g.ior);
    float s = ggx_val * mt;
    out.val = {s * fc.x, s * fc.y, s * fc.z, s * fc.w};
    out.dir = ggx_dir;
    out.pdf = ggx_pdf * mt;
    out.flags = spec_flags;
    return out;
  }
  float f_i = fr_dielectric_pbrt(fabsf(dot3(v, n)), 1.0f, g.ior);
  float im = 1.0f - mt;
  if (pick_spec) {
    float s = ggx_val * im * f_i * g.coat;
    out.val = {s * g.coat_col.x, s * g.coat_col.y, s * g.coat_col.z,
               s * g.coat_col.w};
    out.dir = ggx_dir;
    out.pdf = ggx_pdf * (im * prob_spec);
    out.flags = spec_flags;
    return out;
  }
  float s = lam_val * im;
  V4 lam_bsdf = {s * g.base.x, s * g.base.y, s * g.base.z, s * g.base.w};
  if (g.coat > 0.0f && g.ior > 0.0f) {
    float fdr = m.data[GLTF_FLOAT_MI_FDR_INT];
    float f_o = fr_dielectric_pbrt(fabsf(dot3(lam_dir, n)), 1.0f, g.ior);
    float x = (1.0f - f_i) * (1.0f - f_o) /
              maxn(g.ior * g.ior * (1.0f - fdr), F(1e-12));
    float coeff = 1.0f + (x - 1.0f) * g.coat;
    lam_bsdf = {lam_bsdf.x * coeff, lam_bsdf.y * coeff, lam_bsdf.z * coeff,
                lam_bsdf.w * coeff};
  }
  out.val = lam_bsdf;
  out.dir = lam_dir;
  out.pdf = lam_pdf * (im * prob_diff);
  out.flags = FLAG_HAS_NON_SPEC;
  return out;
}

// ---- lights -------------------------------------------------------------------

struct Lgt {
  V3 pos, norm;
  V4 inten;
  float m[9];
  float size0, size1, pdf_a, mult;
  int geom, dist;
};

__device__ Lgt fetch_light(const Tables& tb, int lid) {
  lid = lid < 0 ? 0 : (lid > 127 ? 127 : lid);
  float r[LF_DIST + 1];
  ld_row(tb.light + lid * (LF_NROWS / 4), r);
  Lgt L;
  L.pos = {r[LF_POS], r[LF_POS + 1], r[LF_POS + 2]};
  L.norm = {r[LF_NORM], r[LF_NORM + 1], r[LF_NORM + 2]};
  L.inten = v4(r, LF_INT);
#pragma unroll
  for (int j = 0; j < 9; ++j) L.m[j] = r[LF_MAT + j];
  L.size0 = r[LF_SIZE];
  L.size1 = r[LF_SIZE + 1];
  L.pdf_a = r[LF_PDFA];
  L.mult = r[LF_MULT];
  L.geom = (int)r[LF_GEOM];
  L.dist = (int)r[LF_DIST];
  return L;
}

__device__ __forceinline__ float epsilon_of_pos(V3 p) {
  float m = maxn(maxn(fabsf(p.x), maxn(fabsf(p.y), fabsf(p.z))), F(2e-5));
  return m * F(1e-5);
}

__device__ __forceinline__ float acos_poly(float x) {
  float ax = clampn(fabsf(x), 0.0f, 1.0f);
  float p = F(-0.0012624911);
  p = p * ax + F(0.0066700901);
  p = p * ax + F(-0.0170881256);
  p = p * ax + F(0.0308918810);
  p = p * ax + F(-0.0501743046);
  p = p * ax + F(0.0889789874);
  p = p * ax + F(-0.2145988016);
  p = p * ax + F(1.5707963050);
  float r = p * sqrtf(1.0f - ax);
  return x < 0.0f ? M_PI_F - r : r;
}

// LightSampleRev for rect / sphere / point (clight.h:67-126)
__device__ void light_sample_rev(const Lgt& L, float r0, float r1, V3& pos,
                                 V3& norm, bool& omni) {
  omni = L.geom == LIGHT_GEOM_POINT && L.dist == LIGHT_DIST_OMNI;
  if (L.geom == LIGHT_GEOM_SPHERE) {
    float theta = TWOPI_F * r0;
    float phi = acos_poly(clampn(1.0f - 2.0f * r1, -1.0f, 1.0f));
    V3 dir = {sinf(phi) * cosf(theta), sinf(phi) * sinf(theta), cosf(phi)};
    pos = add(L.pos, scale(dir, L.size0 * F(1.000001)));
    norm = normalize3(sub(pos, L.pos));
    return;
  }
  norm = L.norm;
  if (L.geom == LIGHT_GEOM_POINT) {
    pos = L.pos;
    return;
  }
  float off_x = 2.0f * (r0 - 0.5f) * L.size0;
  float off_z = 2.0f * (r1 - 0.5f) * L.size1;
  V3 rot = {L.m[0] * off_x + L.m[1] * 0.0f + L.m[2] * off_z,
            L.m[3] * off_x + L.m[4] * 0.0f + L.m[5] * off_z,
            L.m[6] * off_x + L.m[7] * 0.0f + L.m[8] * off_z};
  pos = add(add(rot, L.pos), scale(L.norm, epsilon_of_pos(L.pos)));
}

// LightEvalPDF (integrator_pt_lgt.cpp:71-107)
__device__ float light_eval_pdf(const Lgt& L, V3 illum, V3 dir, V3 lpos,
                                V3 lnorm) {
  V3 diff = sub(illum, lpos);
  float dist = sqrtf(dot3(diff, diff));
  float cos_tmp = dot3(dir, neg(lnorm));
  float cos_val;
  if (L.geom == LIGHT_GEOM_SPHERE)
    cos_val = fabsf(dot3(normalize3(sub(lpos, illum)), lnorm));
  else if (L.geom == LIGHT_GEOM_POINT)
    cos_val = L.dist == LIGHT_DIST_LAMBERT ? maxn(cos_tmp, 0.0f) : 1.0f;
  else
    cos_val = maxn(cos_tmp, 0.0f);
  return (L.pdf_a * dist * dist) / maxn(cos_val, F(1e-30));
}

__device__ __forceinline__ float mis_weight(float a, float b) {
  float pa = is_fin(a) ? fabsf(a) : 0.0f;
  float pb = is_fin(b) ? fabsf(b) : 0.0f;
  float w = pa / maxn(pa + pb, F(1e-30));
  return is_fin(w) ? w : 0.0f;
}

// kernel_SampleLightSource, MIS (integrator_pt.cpp:350-424)
__device__ V4 stage_nee(const Tables& tb, const Mat& m, V4 tex, St& s,
                        Entry* __restrict__ stack) {
  const V4 zero = {0.0f, 0.0f, 0.0f, 0.0f};
  float rnd_id = rnd1(s.rngx, s.rngy);
  float r[4];
  rnd4(s.rngx, s.rngy, r);
  float nl = ld(tb.consts, CN_NUM_LIGHTS);
  Lgt L = fetch_light(tb, (int)minn(floorf(rnd_id * nl), nl - 1.0f));
  V3 lpos, lnorm;
  bool omni;
  light_sample_rev(L, r[0], r[1], lpos, lnorm, omni);
  V3 hp = s.hit_pos;
  V3 dd = sub(hp, lpos);
  float dist = sqrtf(dot3(dd, dd));
  V3 sdir = normalize3(sub(lpos, hp));
  float offs = maxn(maxn(hp.x, maxn(hp.y, hp.z)), 1.0f) * F(5e-6);
  V3 spos = add(hp, scale(s.hit_norm, offs));
  if (!(dot3(sdir, lnorm) < 0.0f || omni)) return zero;
  if (trace<true>(tb, spos, sdir, dist * F(0.9995), s, stack).tri >= 0)
    return zero;
  float bsdf_pdf;
  V4 val = mat_eval(m, tex, sdir, neg(s.d), s.hit_norm, bsdf_pdf);
  float cos_out = maxn(dot3(sdir, s.hit_norm), 0.0f);
  float lgt_pdf_w = (1.0f / maxn(nl, 1.0f)) *
                    light_eval_pdf(L, spos, sdir, lpos, lnorm);
  float mis = L.geom == LIGHT_GEOM_POINT ? 1.0f
                                         : mis_weight(lgt_pdf_w, bsdf_pdf);
  float den = maxn(lgt_pdf_w, F(1e-30));
  float cm = cos_out * mis;
  return {L.inten.x * L.mult * val.x / den * cm,
          L.inten.y * L.mult * val.y / den * cm,
          L.inten.z * L.mult * val.z / den * cm,
          L.inten.w * L.mult * val.w / den * cm};
}

// kernel_NextBounce, MIS (integrator_pt.cpp:426-548)
__device__ void stage_next_bounce(const Tables& tb, const Mat& m, V4 tex,
                                  St& s, V4 shade, bool prim) {
  if (m.mtype == MTYPE_SMALL_LIGHT) {     // light hit
    int lgt_id = (int)s.hit_lgt;
    V4 li;
    float mw = 1.0f;
    if (lgt_id >= 0) {
      Lgt L = fetch_light(tb, lgt_id);
      float light_cos = dot3(s.d, L.norm);
      float atten =
          (light_cos < 0.0f || L.geom == LIGHT_GEOM_SPHERE) ? 1.0f : 0.0f;
      li = {L.inten.x * L.mult * atten, L.inten.y * L.mult * atten,
            L.inten.z * L.mult * atten, L.inten.w * L.mult * atten};
      if (!prim) {
        float nl = ld(tb.consts, CN_NUM_LIGHTS);
        float lgt_pdf = (1.0f / maxn(nl, 1.0f)) *
                        light_eval_pdf(L, s.o, s.d, s.hit_pos, s.hit_norm);
        mw = s.mis_pdf <= 0.0f ? 1.0f : mis_weight(s.mis_pdf, lgt_pdf);
      }
    } else {
      li = {m.c0.x * tex.x, m.c0.y * tex.y, m.c0.z * tex.z, m.c0.w * tex.w};
    }
    s.accum = {s.accum.x + s.thr.x * li.x * mw, s.accum.y + s.thr.y * li.y * mw,
               s.accum.z + s.thr.z * li.z * mw, s.accum.w + s.thr.w * li.w * mw};
    s.flags |= FLAG_IS_DEAD | FLAG_HIT_LIGHT;
    return;
  }
  float r[4];
  rnd4(s.rngx, s.rngy, r);
  Sample smp = mat_sample(m, tex, r, neg(s.d), s.hit_norm);
  float den = maxn(smp.pdf, F(1e-20));
  float cos_theta = fabsf(dot3(smp.dir, s.hit_norm));
  s.accum = {s.accum.x + s.thr.x * shade.x, s.accum.y + s.thr.y * shade.y,
             s.accum.z + s.thr.z * shade.z, s.accum.w + s.thr.w * shade.w};
  s.thr = {s.thr.x * cos_theta * (smp.val.x / den),
           s.thr.y * cos_theta * (smp.val.y / den),
           s.thr.z * cos_theta * (smp.val.z / den),
           s.thr.w * cos_theta * (smp.val.w / den)};
  float sign = dot3(smp.dir, s.hit_norm) < 0.0f ? -1.0f : 1.0f;
  s.o = add(s.hit_pos, scale(s.hit_norm, sign * epsilon_of_pos(s.hit_pos)));
  s.d = smp.dir;
  s.mis_pdf = (smp.flags & RAY_EVENT_S) ? -1.0f : smp.pdf;
  uint32_t next = (s.flags & ~FLAG_FIRST_NON_SPEC) | smp.flags;
  if (!(s.flags & FLAG_HAS_NON_SPEC) && (next & FLAG_HAS_NON_SPEC))
    next |= FLAG_FIRST_NON_SPEC;
  s.flags = next;
}

// NEE and the next bounce at a live lane's hit.  At a light-source material
// the bounce ends the path and takes no NEE result, so NEE only advances the
// RNG as the plain version's does (rnd1, rnd4) and skips the light sample,
// the shadow trace and the eval.
__device__ void shade_hit(const Tables& tb, St& s, bool prim,
                          Entry* __restrict__ stack) {
  HC3_TICK(s, shade);
  Mat m = fetch_mat(tb, s.flags & 0x00FFFFFFu);
  V4 tex = tex_tap(tb, m, s);
  V4 sc = {0.0f, 0.0f, 0.0f, 0.0f};
  if (m.mtype == MTYPE_SMALL_LIGHT) {
    float r[4];
    rnd1(s.rngx, s.rngy);
    rnd4(s.rngx, s.rngy, r);
  } else {
    sc = stage_nee(tb, m, tex, s, stack);
  }
  stage_next_bounce(tb, m, tex, s, sc, prim);
}

// kernel_HitEnvironment (flat color) + contribution
__device__ V4 env_contribute(const Tables& tb, const St& s) {
  const float* c = tb.consts;
  V4 a = s.accum;
  if (s.flags & FLAG_OUT_OF_SCENE)
    a = {a.x + s.thr.x * ld(c, CN_ENV_COLOR), a.y + s.thr.y * ld(c, CN_ENV_COLOR + 1),
         a.z + s.thr.z * ld(c, CN_ENV_COLOR + 2),
         a.w + s.thr.w * ld(c, CN_ENV_COLOR + 3)};
  float e = ld(c, CN_EXPOSURE);
  return {a.x * ld(c, CN_CAM_RESP) * e, a.y * ld(c, CN_CAM_RESP + 1) * e,
          a.z * ld(c, CN_CAM_RESP + 2) * e, a.w * ld(c, CN_CAM_RESP + 3) * e};
}

// ---- the two kernels ---------------------------------------------------------

__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
mega_sample_kernel(Tables tb, const float* __restrict__ xy,
                   const long long* __restrict__ su_in, int depth, int n,
                   float* __restrict__ contrib, long long* __restrict__ su_out) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  Entry stack[MEGA_STACK];
  St s;
  HC3_ZERO(s);
  s.rngx = (uint32_t)su_in[i];
  s.rngy = (uint32_t)su_in[n + i];
  stage_init(tb, xy[i], xy[n + i], s);
  for (int b = 0; b < depth && !dead(s); ++b) {
    stage_trace(tb, s, b == 0, stack);
    if (!dead(s)) shade_hit(tb, s, b == 0, stack);
  }
  V4 c = env_contribute(tb, s);
  contrib[i] = c.x;
  contrib[n + i] = c.y;
  contrib[2 * n + i] = c.z;
  contrib[3 * n + i] = c.w;
  su_out[i] = s.rngx;
  su_out[n + i] = s.rngy;
  su_out[2 * n + i] = s.flags;
  HC3_FLUSH(s);
}

__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
mega_regen_kernel(Tables tb, const float* __restrict__ xy,
                  const float* __restrict__ sf, const long long* __restrict__ su,
                  int first, int k, int depth, int n,
                  float* __restrict__ sf_out, long long* __restrict__ su_out) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  Entry stack[MEGA_STACK];
  float xs = xy[i], ys = xy[n + i];
  St s;
  HC3_ZERO(s);
  V4 acc;
  uint32_t ndone, bcnt;
  if (first) {                          // rfirst
    s.rngx = (uint32_t)su[i];
    s.rngy = (uint32_t)su[n + i];
    stage_init(tb, xs, ys, s);
    stage_trace(tb, s, true, stack);
    acc = {0.0f, 0.0f, 0.0f, 0.0f};
    ndone = bcnt = 0u;
    --k;
  } else {
    const float* f = sf + i;
#define R(j) f[(size_t)(j) * n]
    s.o = {R(0), R(1), R(2)};
    s.d = {R(3), R(4), R(5)};
    s.accum = {R(6), R(7), R(8), R(9)};
    s.thr = {R(10), R(11), R(12), R(13)};
    s.mis_pdf = R(14);
    s.mis_ior = R(15);
    s.hit_pos = {R(16), R(17), R(18)};
    s.hit_norm = {R(19), R(20), R(21)};
    s.hit_u = R(22);
    s.hit_v = R(23);
    s.hit_dist = R(24);
    s.hit_lgt = R(25);
    acc = {R(26), R(27), R(28), R(29)};
#undef R
    s.rngx = (uint32_t)su[i];
    s.rngy = (uint32_t)su[n + i];
    s.flags = (uint32_t)su[2 * n + i];
    ndone = (uint32_t)su[3 * n + i];
    bcnt = (uint32_t)su[4 * n + i];
  }
  for (int it = 0; it < k; ++it) {      // rmid
    // 1. flush a lane that missed at the last trace, restart its pixel
    bool act = !dead(s);
    if (!act) {
      V4 c = env_contribute(tb, s);
      acc = {acc.x + c.x, acc.y + c.y, acc.z + c.z, acc.w + c.w};
      ++ndone;
      stage_init(tb, xs, ys, s);
      bcnt = 0u;
    } else {
      // 2. shade; truncate at the depth; 3. flush a path that died
      shade_hit(tb, s, bcnt == 0u, stack);
      ++bcnt;
      if (bcnt >= (uint32_t)depth) s.flags |= FLAG_IS_DEAD;
      if (dead(s)) {
        V4 c = env_contribute(tb, s);
        acc = {acc.x + c.x, acc.y + c.y, acc.z + c.z, acc.w + c.w};
        ++ndone;
        stage_init(tb, xs, ys, s);
        bcnt = 0u;
      }
    }
    // 4. trace every lane
    stage_trace(tb, s, bcnt == 0u, stack);
  }
  float* f = sf_out + i;
  const float vals[RF_NROWS] = {
      s.o.x, s.o.y, s.o.z, s.d.x, s.d.y, s.d.z,
      s.accum.x, s.accum.y, s.accum.z, s.accum.w,
      s.thr.x, s.thr.y, s.thr.z, s.thr.w, s.mis_pdf, s.mis_ior,
      s.hit_pos.x, s.hit_pos.y, s.hit_pos.z,
      s.hit_norm.x, s.hit_norm.y, s.hit_norm.z,
      s.hit_u, s.hit_v, s.hit_dist, s.hit_lgt, acc.x, acc.y, acc.z, acc.w};
#pragma unroll
  for (int j = 0; j < RF_NROWS; ++j) f[(size_t)j * n] = vals[j];
  const uint32_t uvals[RU_NROWS] = {s.rngx, s.rngy, s.flags, ndone, bcnt};
#pragma unroll
  for (int j = 0; j < RU_NROWS; ++j) su_out[(size_t)j * n + i] = uvals[j];
  HC3_FLUSH(s);
}

inline int blocks(int n) { return (n + BLOCK - 1) / BLOCK; }

inline Tables tables(const void* const* t, int n_texels, int textured) {
  return Tables{static_cast<const float4*>(t[0]),
                static_cast<const float4*>(t[1]),
                static_cast<const int*>(t[2]),
                static_cast<const float*>(t[3]),
                static_cast<const float4*>(t[4]),
                static_cast<const float4*>(t[5]),
                static_cast<const float*>(t[6]),
                static_cast<const float*>(t[7]),
                static_cast<const float4*>(t[8]), n_texels, textured};
}

}  // namespace

// The tables, in this order: nodes, rows, index (the pack's wide BVH,
// accel/wide_bvh.py, whose walk needs `stack` entries per lane: refused
// beyond MEGA_STACK), shade, mat, light, tex, consts, texels (the pack's
// other tables, models/megakernel.py).
extern "C" int hc3_mega_sample(const void* const* tabs, int stack,
                               int n_texels, int textured, const void* xy,
                               const void* su_in, int depth, int n,
                               void* contrib, void* su_out, void* stream) {
  if (stack < 0 || stack > MEGA_STACK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0)
    mega_sample_kernel<<<blocks(n), BLOCK, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        tables(tabs, n_texels, textured), static_cast<const float*>(xy),
        static_cast<const long long*>(su_in), depth, n,
        static_cast<float*>(contrib), static_cast<long long*>(su_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hc3_mega_regen(const void* const* tabs, int stack,
                              int n_texels, int textured, const void* xy,
                              const void* sf_in, const void* su_in, int first,
                              int k, int depth, int n, void* sf_out,
                              void* su_out, void* stream) {
  if (stack < 0 || stack > MEGA_STACK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0)
    mega_regen_kernel<<<blocks(n), BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        tables(tabs, n_texels, textured), static_cast<const float*>(xy),
        static_cast<const float*>(sf_in), static_cast<const long long*>(su_in),
        first, k, depth, n, static_cast<float*>(sf_out),
        static_cast<long long*>(su_out));
  return static_cast<int>(cudaGetLastError());
}

#ifdef HC3_COUNT
extern "C" int hc3_mega_counts_reset() {
  unsigned long long zero[3] = {0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_counts, zero, sizeof(zero)));
}

// out: 3 x u64 on the host (Woop tests, child-box tests, shades); waits for
// the launches before it
extern "C" int hc3_mega_counts_read(void* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_counts, 3 * sizeof(unsigned long long)));
}
#endif

// registers per thread and local (spill and stack) bytes of kernel `which`
// (0: mega_sample_kernel, 1: mega_regen_kernel)
extern "C" int hc3_mega_attrs(int which, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = which == 0
                      ? cudaFuncGetAttributes(&a, mega_sample_kernel)
                      : cudaFuncGetAttributes(&a, mega_regen_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  return 0;
}
