// The path-tracing megakernel for small scenes, for Hopper (sm_90a).
//
// Replaces the Pallas megakernel of hydracore3_tpu/models/megakernel.py:
// _build_kernels (whole_kernel and the make_kernel per-bounce chain) and
// _build_regen_kernels (make_rfirst, make_rmid).  Two entry points share the
// __device__ stage functions below, 128 threads per block, each thread
// running the lanes a phase lists for it (below, "What bounds it"):
//
//  * mega_sample_kernel: the fixed chain.  A whole sample per lane: camera
//    ray, `depth` x (nearest hit, texture tap, NEE with a shadow any-hit,
//    material sample, next ray), environment, contribution.
//    Texture taps run inside the kernel (four f32 texel reads), so the TPU's
//    split of the chain around between-kernel texture gathers is gone.
//  * mega_regen_kernel: `k` persistent-lane iterations per launch (rfirst,
//    then rmid): a lane whose path dies flushes the sample into its own
//    accumulator and restarts its pixel's next sample at once.  Lane state
//    lives in shared memory during a launch and goes to global memory
//    ([30, N] f32 and [5, N] int64, component-major so loads coalesce)
//    between launches.
//
// One library holds one variant, chosen at build time as the JAX package
// builds one kernel per (integrator, present material types, env tap):
// HC3_INTEGRATOR (0 naive, 1 shadow, 2 MIS), HC3_MTYPES (a bitmask of the
// shaded material types, MT_* below, and of disc lights, MT_DISC) and
// HC3_ENV (the env lat-long map tapped on a miss) and HC3_SPECTRAL (hero-
// wavelength spectral mode).  Every stage takes the first three as template
// arguments, and the branches a variant lacks are compiled out, so the
// GLTF-only MIS build is the kernel it was before the other materials came;
// the spectral code sits in #if HC3_SPECTRAL blocks, so an RGB build's
// source is the one it was before spectral mode came.
//
// Spectral mode (the plain version's spectral stages): the lane draws 4
// hero wavelengths after its pixel offsets and keeps them in registers
// (St::lam; the regen state's rows 26-29, its accumulator at 30-33).  A
// diffuse's reflectance, a conductor's eta and k, a light's emission and
// the sky are their SPDs at those wavelengths where they name one, read by
// plain indexing from one flat f32 table of the spectra's 1 nm values with
// a row offset per spectrum (where the TPU kernel gathered [NS, 4, 128]
// chunk rows through a static candidate loop per fetch site); the CIE
// curves are a [471] float4 table.  The contribution converts to RGB as
// spectrum_to_xyz + xyz_to_rgb with the terminated-waves rule.
//
// The arithmetic is the plain version's (models/megakernel.py), op for op
// and in its order.  The source is built with -fmad=false so nvcc contracts
// nothing into FMAs: every product and sum rounds as the plain torch ops
// round, and the Woop test takes the same decisions.  rsqrtf, sinf, cosf,
// atan2f, sqrtf and IEEE division are the card's, as in torch's own CUDA
// ops, so on the card the kernel equals the plain version on every lane.
//
// The trace.  The plain version (and the TPU kernel) tests every triangle
// on every bounce, <= 4,096 of them.  The kernel walks instead the pack's
// wide BVH (accel/wide_bvh.py, models/megakernel.wide_table): 128-byte
// nodes of 4 children's boxes over leaves of at most 4 of the pack's Woop
// rows, near-first with a per-lane stack of at most MEGA_STACK entries;
// the leaf test is the brute trace's own woop(), so t, u and v are its
// bits.  Ties are settled by comparison (the lower contract index wins
// among equal t), boxes are entered and stack entries kept at t == best,
// and any-hit returns at the first valid triangle, so the walk returns the
// brute trace's hit whenever it reaches the winner's leaf; the pack widens
// every box by a margin that covers the slab test's and the Woop test's
// rounding.  On the 16-triangle box a trace makes ~6 Woop tests instead of
// 16; on the box with its walls cut into 20 x 20 grids (4,006 triangles),
// ~4 instead of 4,096.
//
// What bounds it.  A shade (texture tap, NEE with its light sample and
// material eval, the material sample) is ~500-1,150 separate operations
// with no FMA (chip_smoke.py SHADE_OPS, per material kind), and a trace
// ~20-40 box and Woop tests: scalar f32 per lane, so the attainable rate
// is half the card's f32 peak, and the per-lane memory traffic is the lane
// state in and out.  There is no matrix product: wgmma and the tensor
// cores have nothing to do, and thread block clusters nothing to share.
// What keeps K1 above that bound is its divergence and its latency:
//
//  * Lanes regrouped by stage and material (the core).  Blocks are
//    persistent (as many as the card holds at once), each owns a
//    contiguous range of lanes and works through it in pools of
//    SAMPLE_POOL / REGEN_POOL lanes whose state sits in shared memory (the
//    regen state's rows, component-major).  A regen iteration runs as
//    phases between barriers: the live lanes are listed by the material
//    kind of their hit (warp votes and shared counters, build_lists) and
//    shaded class by class, so a warp runs one material's branch; the dead
//    lanes (dead at the last trace or by this shade) are listed and
//    flushed and restarted together; then every lane traces.  In the fixed
//    chain each bounce lists the live lanes to trace and then the hit ones
//    by class, so a dead lane leaves the lists instead of idling to the
//    end of the frame.  Which thread runs a lane changes, not what the
//    lane computes: its arithmetic and its RNG draws are its own and in
//    the plain version's order, and the regen launch still runs exactly `k`
//    iterations a lane.  A variant with one material kind (the GLTF box's)
//    has nothing to regroup by, and measured slower pooled: there a
//    thread runs a lane's whole sample, or its `k` regen iterations, in
//    registers, with the geometry and its stack where the layout puts them.
//  * The layout, chosen by the pack's bytes (Layout::chip): a pack whose
//    geometry (nodes, Woop rows, shade rows, index) fits GEOM_CHIP_BYTES
//    and whose walk needs at most STACK_CHIP_MAX stack entries, as the
//    small boxes' do (a few KB, 4-9 entries), has both on chip, copied
//    once per block by cp.async (a node padded to 9 float4s and a shade
//    row to 27 floats, so lanes at different nodes or triangles read
//    different banks), and each thread's stack a slice of the block's in
//    shared memory (interleaved, so a warp's pushes fall in consecutive
//    words), where it was 256 local bytes a thread.  A larger pack (the
//    tessellated box: ~700 KB, 19 entries) keeps its geometry in device
//    memory, read through the read-only path, and a local stack, as
//    before.  Each entry point is built for both (Ctx<true>, Ctx<false>),
//    so the walk's strides and memory spaces are constants.
//  * The small tables (consts, material, light and texture-slot rows),
//    the texels and the spectra stay in device memory, read through the
//    read-only path: copied on chip they measured slower.
//  * Registers: SAMPLE_MIN_BLOCKS / REGEN_MIN_BLOCKS cap them; the dynamic
//    shared memory a block takes is allowed in the C entry points, and the
//    grid is what the occupancy calculator says the card holds.
//    hc3_mega_attrs reports registers, local bytes and, per pack, shared
//    bytes a block, blocks an SM and the layout (chip_smoke.py prints
//    them).

// Material and light rows are padded to whole float4s and read as float4s,
// and a lane whose hit is a light draws NEE's random numbers and skips the
// rest of NEE, whose result its bounce discards.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#ifndef HC3_INTEGRATOR
#define HC3_INTEGRATOR 2
#endif
#ifndef HC3_MTYPES
#define HC3_MTYPES 1
#endif
#ifndef HC3_ENV
#define HC3_ENV 0
#endif
#ifndef HC3_SPECTRAL
#define HC3_SPECTRAL 0
#endif
// the tables and wavelengths a spectral stage takes (nothing in RGB builds)
#if HC3_SPECTRAL
#define SPEC_PARAM , const Tables& tb, const float* __restrict__ lam
#define SPEC_ARG(tb, s) , tb, (s).lam
#else
#define SPEC_PARAM
#define SPEC_ARG(tb, s)
#endif

namespace {

// integrators (models/megakernel.py INTEGRATOR_*)
constexpr int INTEGRATOR_NAIVE = 0;
constexpr int INTEGRATOR_SHADOW = 1;
constexpr int INTEGRATOR_MIS = 2;
// material-set bits (models/megakernel.py MT_BITS, DISC_BIT)
constexpr int MT_GLTF = 1, MT_DIFFUSE = 2, MT_CONDUCTOR = 4,
              MT_DIELECTRIC = 8, MT_GLASS = 16, MT_DISC = 32;

constexpr int BLOCK = 128;
// the material kinds the variant shades (GLTF, diffuse, conductor,
// dielectric, glass)
constexpr int N_KINDS = (HC3_MTYPES & 1) + ((HC3_MTYPES >> 1) & 1) +
                        ((HC3_MTYPES >> 2) & 1) + ((HC3_MTYPES >> 3) & 1) +
                        ((HC3_MTYPES >> 4) & 1);
// Per entry point, the lanes a block's pool holds in shared memory (a
// multiple of BLOCK) and the blocks an SM must hold (capping the registers
// at 65,536 / (BLOCK x MIN_BLOCKS) a thread), chosen by measurement
// (scripts/k1_measure.py): with several material kinds big pools, so each
// kind fills whole warps; a variant with one material kind takes no pool
// (one lane a thread) and more blocks an SM.
constexpr int SAMPLE_POOL = 4 * BLOCK;
constexpr int SAMPLE_MIN_BLOCKS = N_KINDS > 1 ? 3 : 6;
constexpr int REGEN_POOL = 4 * BLOCK;
constexpr int REGEN_MIN_BLOCKS = N_KINDS > 1 ? 3 : 6;
// The layout is on chip (the geometry: wide nodes, Woop rows, shade rows,
// index; and the walk's stack) when the geometry takes at most
// GEOM_CHIP_BYTES and the walk needs at most STACK_CHIP_MAX stack entries;
// else the geometry stays in device memory and the stack is a local array
// of MEGA_STACK entries a thread.
constexpr int STACK_CHIP_MAX = 12;
constexpr int GEOM_CHIP_BYTES = 16384;

// Python-float constants rounded to f32, as torch and JAX round them
#define F(x) static_cast<float>(x)

// table layouts (models/megakernel.py)
enum { MF_MTYPE = 0, MF_CFLAGS = 1, MF_C0 = 2, MF_C1 = 6, MF_C2 = 10,
       MF_DATA = 14, MF_TEXID = 22, MF_TEXC = 23, MF_ROW0 = 27, MF_ROW1 = 31,
       MF_SPD0 = 35, MF_SPD1 = 36, MF_NROWS = 40 };   // whole float4s
enum { LF_POS = 0, LF_NORM = 3, LF_INT = 6, LF_MAT = 10, LF_SIZE = 19,
       LF_PDFA = 21, LF_MULT = 22, LF_GEOM = 23, LF_DIST = 24, LF_SPD = 25,
       LF_NROWS = 28 };
enum { TF_NROWS = 6 };
enum { CN_PROJ_INV = 0, CN_WVI = 16, CN_CAM_RESP = 32, CN_ENV_COLOR = 36,
       CN_NUM_LIGHTS = 40, CN_WIDTH = 41, CN_HEIGHT = 42, CN_EXPOSURE = 43,
       CN_ENV_SROW0 = 44, CN_ENV_SROW1 = 48, CN_ENV_TEXID = 52,
       CN_ENV_SPD = 53, CN_ENV_SMULT = 54, CN_NSPD = 55 };
// the columns a material or light fetch reads
constexpr int MF_NREAD = HC3_SPECTRAL ? MF_SPD1 + 1 : MF_ROW1 + 4;
constexpr int LF_NREAD = HC3_SPECTRAL ? LF_SPD + 1 : LF_DIST + 1;
// the regen state's f32 rows: 4 more in spectral mode (the wavelengths)
constexpr int RF_NROWS = HC3_SPECTRAL ? 34 : 30;
constexpr int RU_NROWS = 5;

// material / light / texture codes
constexpr float MAT_GLTF = 1.0f;
constexpr float MAT_GLASS = 2.0f;
constexpr float MAT_CONDUCTOR = 3.0f;
constexpr float MAT_DIFFUSE = 4.0f;
constexpr float MAT_DIELECTRIC = 7.0f;
constexpr float MTYPE_SMALL_LIGHT = 9.0f;
constexpr float GLTF_COMPONENT_METAL = 4.0f;
constexpr int GLTF_COMPONENT_ORENNAYAR = 16;
enum { GLTF_FLOAT_MI_FDR_INT = 0, GLTF_FLOAT_ALPHA = 3,
       GLTF_FLOAT_GLOSINESS = 4, GLTF_FLOAT_IOR = 5,
       GLTF_FLOAT_REFL_COAT = 7 };
// data slots of the other materials (scene/build.py)
enum { DIFFUSE_ROUGHNESS = 0, CONDUCTOR_ROUGH_U = 0, CONDUCTOR_ROUGH_V = 1,
       CONDUCTOR_ETA = 2, CONDUCTOR_K = 3, DIELECTRIC_ETA_EXT = 0,
       DIELECTRIC_ETA_INT = 1, GLASS_FLOAT_IOR = 2 };
constexpr int LIGHT_GEOM_DISC = 2;
constexpr int LIGHT_GEOM_SPHERE = 3;
constexpr int LIGHT_GEOM_POINT = 5;
constexpr int LIGHT_DIST_LAMBERT = 0;
constexpr int LIGHT_DIST_OMNI = 1;
constexpr float ADDR_WRAP = 0.0f;
constexpr float ADDR_MIRROR = 2.0f;
constexpr float FILTER_LINEAR = 1.0f;

// ray flags (cglobals.h)
constexpr uint32_t RAY_EVENT_S = 1u;
constexpr uint32_t RAY_EVENT_T = 8u;
constexpr uint32_t FLAG_IS_DEAD = 0x80000000u;
constexpr uint32_t FLAG_OUT_OF_SCENE = 0x40000000u;
constexpr uint32_t FLAG_HIT_LIGHT = 0x20000000u;
constexpr uint32_t FLAG_HAS_NON_SPEC = 0x10000000u;
constexpr uint32_t FLAG_HAS_INV_NORMAL = 0x08000000u;
constexpr uint32_t FLAG_WAVES_DIVERGED = 0x04000000u;
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

// The pack's tables as a kernel reads them.  The small ones (consts,
// material, light and texture-slot rows) stay in device memory, read
// through the read-only path (on chip they measured slower).  The
// geometry (wide nodes, Woop rows, index, shade rows) sits in shared
// memory when the layout is on chip (Ctx<true>: a node padded to 9 float4s
// and a shade row to SHADE_CHIP_W floats, so lanes at different nodes or
// triangles read different banks), else in device memory as the pack
// holds it (Ctx<false>, read through __ldg).
struct Tables {
  const float4* nodes;                // a wide node's 8 float4s
  const float4* rows;                 // [T, 3] float4: Woop rows
  const int* index;                   // fine position -> contract index
  const float* shade;                 // shade rows
  const float4* mat;                  // [128, MF_NROWS / 4], device memory
  const float4* light;                // [128, LF_NROWS / 4]
  const float* tex;                   // [128, TF_NROWS]
  const float* consts;                // [56], device memory
  const float4* __restrict__ texels;  // [P] float4, device memory
  int n_texels, textured;
#if HC3_SPECTRAL
  const float* __restrict__ spd;      // the spectra's 1 nm values
  const int* __restrict__ spd_off;    // [S]: each spectrum's first value
  const float4* __restrict__ cie;     // [471]: CIE 1931 (x, y, z, 0)
#endif
};

// the columns of a shade row the trace reads: 24 lerped, material, light;
// on chip a row takes SHADE_CHIP_W floats (odd: conflict-free banks)
constexpr int SHADE_COLS = 26;
constexpr int SHADE_CHIP_W = 27;

// What a lane did: Woop tests, child-box tests and shades by the hit's
// material kind (GLTF, diffuse, conductor, dielectric, glass, light
// source).  Only a build with -DHC3_COUNT counts: a second library of this
// source, loaded by chip_smoke.py alone to measure a pass's operations (a
// bound's numerator), with hc3_mega_counts_reset / hc3_mega_counts_read
// besides the entry points.  A thread sums the lanes it runs and flushes
// once.  In the shipped build the HC3_ macros expand to nothing.
#ifdef HC3_COUNT
constexpr int N_COUNTS = 8;
struct Counts {
  unsigned long long woop = 0, slab = 0, shade[6] = {0, 0, 0, 0, 0, 0};
};
__device__ unsigned long long g_counts[N_COUNTS];
#define HC3_COUNTS_FIELD Counts cnt;
#define HC3_TICK(c, field) (++(c).cnt.field)
#define HC3_TICK_SHADE(c, mtype) (++(c).cnt.shade[mat_class(mtype)])
#define HC3_FLUSH(c)                                                          \
  do {                                                                        \
    atomicAdd(g_counts + 0, (c).cnt.woop);                                    \
    atomicAdd(g_counts + 1, (c).cnt.slab);                                    \
    for (int k_ = 0; k_ < 6; ++k_)                                            \
      atomicAdd(g_counts + 2 + k_, (c).cnt.shade[k_]);                        \
  } while (0)
#else
#define HC3_COUNTS_FIELD
#define HC3_TICK(c, field)
#define HC3_TICK_SHADE(c, mtype)
#define HC3_FLUSH(c)
#endif

// a material kind's class (the counters' index, and the groups a pool's
// lanes are shaded in): GLTF, diffuse, conductor, dielectric, glass, then
// light sources (and any other type)
constexpr int N_CLASSES = 6;
__device__ __forceinline__ int mat_class(float mtype) {
  return mtype == MAT_GLTF ? 0 : mtype == MAT_DIFFUSE ? 1
       : mtype == MAT_CONDUCTOR ? 2 : mtype == MAT_DIELECTRIC ? 3
       : mtype == MAT_GLASS ? 4 : 5;
}

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
#if HC3_SPECTRAL
  float lam[4];                       // the hero wavelengths
#endif
};

__device__ __forceinline__ bool dead(const St& s) {
  return (s.flags & FLAG_IS_DEAD) != 0;
}

__device__ __forceinline__ V3 mul4x3(const float* m, V3 v) {
  return {ld(m, 0) * v.x + ld(m, 1) * v.y + ld(m, 2) * v.z + ld(m, 3),
          ld(m, 4) * v.x + ld(m, 5) * v.y + ld(m, 6) * v.z + ld(m, 7),
          ld(m, 8) * v.x + ld(m, 9) * v.y + ld(m, 10) * v.z + ld(m, 11)};
}

// kernel_InitEyeRay2: the pixel's next camera ray (advances the RNG); in
// spectral mode the hero wavelengths are drawn after the pixel offsets,
// stratified over [360, 830] (sample_wavelengths)
__device__ void stage_init(const Tables& tb, float xs, float ys, St& s) {
  float r[4];
  rnd4(s.rngx, s.rngy, r);
#if HC3_SPECTRAL
  s.lam[0] = 360.0f + 470.0f * rnd1(s.rngx, s.rngy);
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    float nxt = s.lam[j - 1] + 117.5f;
    s.lam[j] = nxt > 830.0f ? 360.0f + (nxt - 830.0f) : nxt;
  }
#endif
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

// What a thread carries from lane to lane: its walk stack (entry j at
// stack[j * stride]: with CHIP its slice of the block's stack in shared
// memory, stride BLOCK so a warp's entries are consecutive, else its local
// array) and, in the counting build, its counts; and the geometry's layout
// the walk reads (CHIP: in shared memory, padded; else the pack's own in
// device memory, through the read-only path).
template <bool CHIP>
struct Ctx {
  static constexpr int stride = CHIP ? BLOCK : 1;
  static constexpr int node_f4 = CHIP ? 9 : 8;
  static constexpr int shade_w = CHIP ? SHADE_CHIP_W : 32;
  template <class T>
  static __device__ __forceinline__ T ld(const T* p) {
    if constexpr (CHIP)
      return *p;
    else
      return __ldg(p);
  }
  Entry* stack;
  HC3_COUNTS_FIELD
};

// The Woop test of the plain version's _trace_blocks, op for op (under
// -fmad=false nothing is contracted), on one triangle's rows w[0..2]
template <class C>
__device__ __forceinline__ void woop(const float4* w, V3 o, V3 d, float& t,
                                     float& u, float& v) {
  float4 a = C::ld(w), b = C::ld(w + 1), c = C::ld(w + 2);
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
template <bool ANY_HIT, class C>
__device__ Hit trace(const Tables& tb, V3 o, V3 d, float tmax, C& cx) {
  Entry* const stack = cx.stack;
  constexpr int stride = C::stride;
  Hit h{tmax, 0.0f, 0.0f, -1};
  V3 inv = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  int sp = 0, cur = 0;
  while (true) {
    while (cur >= 0) {
      const float4* nd = tb.nodes + C::node_f4 * cur;
      float4 lx = C::ld(nd), ly = C::ld(nd + 1), lz = C::ld(nd + 2);
      float4 hx = C::ld(nd + 3), hy = C::ld(nd + 4), hz = C::ld(nd + 5);
      int4 c = C::ld(reinterpret_cast<const int4*>(nd) + 6);
      int c0 = c.x, c1 = c.y, c2 = c.z, c3 = c.w;
      float t0 = slab_entry(o, inv, lx.x, ly.x, lz.x, hx.x, hy.x, hz.x, h.t);
      float t1 = slab_entry(o, inv, lx.y, ly.y, lz.y, hx.y, hy.y, hz.y, h.t);
      float t2 = slab_entry(o, inv, lx.z, ly.z, lz.z, hx.z, hy.z, hz.z, h.t);
      float t3 = slab_entry(o, inv, lx.w, ly.w, lz.w, hx.w, hy.w, hz.w, h.t);
      if (c0 == WIDE_EMPTY) t0 = INFINITY; else HC3_TICK(cx, slab);
      if (c1 == WIDE_EMPTY) t1 = INFINITY; else HC3_TICK(cx, slab);
      if (c2 == WIDE_EMPTY) t2 = INFINITY; else HC3_TICK(cx, slab);
      if (c3 == WIDE_EMPTY) t3 = INFINITY; else HC3_TICK(cx, slab);
      // far to near, so the nearest waiting child is popped first (any-hit
      // takes the first occluder wherever it lies: unsorted measured faster)
      if (!ANY_HIT) {
        WIDE_CE(0, 1) WIDE_CE(2, 3) WIDE_CE(0, 2) WIDE_CE(1, 3) WIDE_CE(1, 2)
      }
      if (t3 < INFINITY) stack[stride * sp++] = Entry{c3, t3};
      if (t2 < INFINITY) stack[stride * sp++] = Entry{c2, t2};
      if (t1 < INFINITY) stack[stride * sp++] = Entry{c1, t1};
      cur = t0 < INFINITY ? c0 : WIDE_EMPTY;
    }
    if (cur != WIDE_EMPTY) {            // a leaf: count <= 4 rows from off
      int code = ~cur;
      int off = code >> 3, count = code & 7;
      for (int k = 0; k < count; ++k) {
        HC3_TICK(cx, woop);
        float t, u, v;
        woop<C>(tb.rows + 3 * (off + k), o, d, t, u, v);
        if (!(u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f &&
              t < tmax))
          continue;
        if (ANY_HIT) return Hit{0.0f, 0.0f, 0.0f, 0};
        int tri = C::ld(tb.index + off + k);
        if (t < h.t || (t == h.t && tri < h.tri)) h = Hit{t, u, v, tri};
      }
    }
    cur = WIDE_EMPTY;
    while (sp > 0) {
      Entry e = stack[stride * --sp];
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
template <class C>
__device__ void stage_trace(const Tables& tb, St& s, bool prim, C& cx) {
  if (dead(s)) return;
  Hit h = trace<false>(tb, s.o, s.d, FLT_MAX_F, cx);
  if (!(h.t < F(3.4e38 * 0.5))) {
    s.flags |= FLAG_IS_DEAD | FLAG_OUT_OF_SCENE |
               (prim ? FLAG_PRIME_RAY_MISS : 0u);
    return;
  }
  const float* sr = tb.shade + C::shade_w * h.tri;
  float wa = 1.0f - h.u - h.v;
  float data[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    data[j] = wa * C::ld(sr + j) + h.u * C::ld(sr + 8 + j) +
              h.v * C::ld(sr + 16 + j);
  V3 n = normalize3({data[0], data[1], data[2]});
  uint32_t mid = (uint32_t)(int)floorf(C::ld(sr + 24) + 0.5f);
  float lgt = floorf(C::ld(sr + 25) + 0.5f);
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
#if HC3_SPECTRAL
  float spd0, spd1;                   // the SPD ids (-1: none)
#endif
};

// columns c0..c0+n of a row held as float4s, read as whole float4s
template <int N>
__device__ __forceinline__ void ld_row(const float4* row, float (&out)[N]) {
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
  float r[MF_NREAD];
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
#if HC3_SPECTRAL
  m.spd0 = r[MF_SPD0];
  m.spd1 = r[MF_SPD1];
#endif
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

// a bilinear (or nearest) tap of slot `texid` at (tcx, tcy): the JAX
// _uv_to_quad / tex_from_rows, the quad's four corners read from the f32 pool
__device__ V4 tap(const Tables& tb, int texid, float tcx, float tcy) {
  texid = texid < 0 ? 0 : (texid > 127 ? 127 : texid);
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

// slot-0 texture color at the hit (the JAX stage_tap_prep)
__device__ V4 tex_tap(const Tables& tb, const Mat& m, const St& s) {
  if (!tb.textured) return m.texc;
  float tcx = m.row0[0] * s.hit_u + m.row0[1] * s.hit_v + m.row0[3];
  float tcy = m.row1[0] * s.hit_u + m.row1[1] * s.hit_v + m.row1[3];
  return tap(tb, (int)m.texid, tcx, tcy);
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

// MaterialEval, GLTF (cmat_gltf.h:94-147)
__device__ __forceinline__ V4 gltf_eval(const Mat& m, V4 tex, V3 l, V3 v,
                                        V3 n, float& pdf) {
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
  float ior;
};

// MaterialSampleAndEval, GLTF (cmat_gltf.h:6-91); `out` holds the
// defaults the other fields keep
__device__ __forceinline__ Sample gltf_sample(const Mat& m, V4 tex,
                                              const float r[4], V3 v, V3 n,
                                              Sample out) {
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

__device__ __forceinline__ V3 reflect3(V3 d, V3 n) {
  return sub(d, scale(n, 2.0f * dot3(d, n)));
}
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V4 scale4(V4 a, float s) {
  return {a.x * s, a.y * s, a.z * s, a.w * s};
}
__device__ __forceinline__ V4 mul4(V4 a, V4 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w};
}
__device__ __forceinline__ float sqr(float x) { return x * x; }

// cmaterial.h:254-312
__device__ float orennayar_func(V3 l, V3 v, V3 n, float roughness) {
  float cos_wi = dot3(l, n), cos_wo = dot3(v, n);
  float sin_wi = safe_sqrt(1.0f - cos_wi * cos_wi);
  float sin_wo = safe_sqrt(1.0f - cos_wo * cos_wo);
  float sigma = roughness * M_PI_F * 0.5f;
  float sigma2 = sigma * sigma;
  float A = 1.0f - sigma2 / (2.0f * (sigma2 + F(0.33)));
  float B = F(0.45) * sigma2 / (sigma2 + F(0.09));
  V3 nx, ny;
  coordinate_system_v2(n, nx, ny);
  float wo0 = -dot3(v, nx), wo1 = -dot3(v, ny);
  float wi0 = -dot3(l, nx), wi1 = -dot3(l, ny);
  float si = sin_wi == 0.0f ? 1.0f : sin_wi;
  float so = sin_wo == 0.0f ? 1.0f : sin_wo;
  float cphi_i = sin_wi == 0.0f ? 1.0f : clampn(wi0 / si, -1.0f, 1.0f);
  float cphi_o = sin_wo == 0.0f ? 1.0f : clampn(wo0 / so, -1.0f, 1.0f);
  float sphi_i = sin_wi == 0.0f ? 0.0f : clampn(wi1 / si, -1.0f, 1.0f);
  float sphi_o = sin_wo == 0.0f ? 0.0f : clampn(wo1 / so, -1.0f, 1.0f);
  float dcos = cphi_i * cphi_o + sphi_i * sphi_o;
  float maxcos = (sin_wi > F(1e-4) && sin_wo > F(1e-4)) ? maxn(dcos, 0.0f)
                                                       : 0.0f;
  bool wi_big = fabsf(cos_wi) > fabsf(cos_wo);
  float sinalpha = wi_big ? sin_wo : sin_wi;
  float tanbeta = wi_big ? sin_wi / maxn(fabsf(cos_wi), F(1e-20))
                         : sin_wo / maxn(fabsf(cos_wo), F(1e-20));
  return A + B * maxcos * sinalpha * tanbeta;
}

// the diffuse material's scalar: 1/pi, times Oren-Nayar where it has one
__device__ __forceinline__ float diffuse_scale(const Mat& m, V3 l, V3 v,
                                               V3 n) {
  if ((int)m.cflags & GLTF_COMPONENT_ORENNAYAR)
    return INV_PI_F * orennayar_func(l, v, n, m.data[DIFFUSE_ROUGHNESS]);
  return INV_PI_F;
}

// ---- Trowbridge-Reitz and the complex Fresnel (cmaterial.h:405-694) on
// local-frame vectors

__device__ __forceinline__ float sin2_l(V3 w) {
  return maxn(1.0f - w.z * w.z, 0.0f);
}
__device__ __forceinline__ void cossin_phi_l(V3 w, float& cp, float& sp) {
  float st = safe_sqrt(sin2_l(w));
  float safe = st == 0.0f ? 1.0f : st;
  cp = st == 0.0f ? 1.0f : clampn(w.x / safe, -1.0f, 1.0f);
  sp = st == 0.0f ? 0.0f : clampn(w.y / safe, -1.0f, 1.0f);
}
__device__ float tr_d(V3 wm, float a0, float a1) {
  float tan2 = sin2_l(wm) / (wm.z * wm.z);     // inf where cos == 0
  float cos4 = sqr(wm.z * wm.z);
  float cp, sp;
  cossin_phi_l(wm, cp, sp);
  float e = tan2 * (sqr(cp / a0) + sqr(sp / a1));
  float val = 1.0f / (M_PI_F * a0 * a1 * cos4 * (1.0f + e) * (1.0f + e));
  return (cos4 < F(1e-16) || !is_fin(tan2)) ? 0.0f : val;
}
__device__ float tr_lambda(V3 w, float a0, float a1) {
  float tan2 = sin2_l(w) / maxn(w.z * w.z, F(1e-20));
  float cp, sp;
  cossin_phi_l(w, cp, sp);
  float a2 = sqr(cp * a0) + sqr(sp * a1);
  float val = (safe_sqrt(1.0f + a2 * tan2) - 1.0f) / 2.0f;
  return is_fin(tan2) ? val : 0.0f;
}
__device__ __forceinline__ float tr_g(V3 wo, V3 wi, float a0, float a1) {
  return 1.0f / (1.0f + tr_lambda(wo, a0, a1) + tr_lambda(wi, a0, a1));
}
__device__ __forceinline__ float tr_pdf(V3 w, V3 wm, float a0, float a1) {
  float g1 = 1.0f / (1.0f + tr_lambda(w, a0, a1));
  return g1 / maxn(fabsf(w.z), F(1e-20)) * tr_d(wm, a0, a1) *
         fabsf(dot3(w, wm));
}
// trSample, VNDF sampling (cmaterial.h:506-530)
__device__ V3 tr_sample(V3 wo, float r0, float r1, float a0, float a1) {
  V3 wh = normalize3({a0 * wo.x, a1 * wo.y, wo.z});
  if (wh.z < 0.0f) wh = neg(wh);
  V3 t1n = normalize3({-wh.y, wh.x, 0.0f});
  V3 t1 = wh.z >= F(0.99999) ? V3{1.0f, 0.0f, 0.0f} : V3{t1n.x, t1n.y, 0.0f};
  V3 t2 = cross3(wh, t1);
  float pr = safe_sqrt(r0);
  float th = TWOPI_F * r1;
  float px = pr * cosf(th);
  float py0 = pr * sinf(th);
  float h = safe_sqrt(1.0f - px * px);
  float py = h + (py0 - h) * ((1.0f + wh.z) / 2.0f);
  float pz = safe_sqrt(maxn(1.0f - px * px - py * py, 0.0f));
  V3 nh = add(add(scale(t1, px), scale(t2, py)), scale(wh, pz));
  return normalize3({a0 * nh.x, a1 * nh.y, maxn(nh.z, F(1e-6))});
}

// complex division (ar + i ai) / (br + i bi)
__device__ __forceinline__ void cdiv(float ar, float ai, float br, float bi,
                                     float& qr, float& qi) {
  float d = br * br + bi * bi;
  d = d == 0.0f ? F(1e-30) : d;
  qr = (ar * br + ai * bi) / d;
  qi = (ai * br - ar * bi) / d;
}
// FrComplexConductor (cmaterial.h:685-694) in real arithmetic, the JAX
// megakernel's fr_complex_cond; eta_c = eta + i k
__device__ float fr_complex_cond(float cos_i, float eta, float k) {
  float sin2 = 1.0f - cos_i * cos_i;
  float e2r = eta * eta - k * k, e2i = 2.0f * eta * k;
  float str, sti;
  cdiv(sin2, 0.0f, e2r, e2i, str, sti);
  float xr = 1.0f - str, xi = -sti;          // csqrt(1 - sin2 / eta_c^2)
  float mm = sqrtf(xr * xr + xi * xi);
  float ctr = sqrtf(maxn((mm + xr) * 0.5f, 0.0f));
  float vv = sqrtf(maxn((mm - xr) * 0.5f, 0.0f));
  float cti = xi < 0.0f ? -vv : vv;
  float ecr = eta * cos_i, eci = k * cos_i;
  float pr_r, pr_i, sr_r, sr_i;
  cdiv(ecr - ctr, eci - cti, ecr + ctr, eci + cti, pr_r, pr_i);
  cdiv(cos_i - (eta * ctr - k * cti), -(eta * cti + k * ctr),
       cos_i + (eta * ctr - k * cti), (eta * cti + k * ctr), sr_r, sr_i);
  return 0.5f * (pr_r * pr_r + pr_i * pr_i + sr_r * sr_r + sr_i * sr_i);
}

// conductorSmooth/RoughSampleAndEval (cmat_conductor.h:7-103)
__device__ Sample conductor_sample(const Mat& m, V4 tex, float r0, float r1,
                                   V3 v, V3 n, Sample out) {
  float eta = m.data[CONDUCTOR_ETA], kk = m.data[CONDUCTOR_K];
  bool smooth = maxn(m.data[CONDUCTOR_ROUGH_V], m.data[CONDUCTOR_ROUGH_U]) <
                F(1e-3);
  if (smooth) {
    V3 perf = reflect3(neg(v), n);
    float cos_out = dot3(perf, n);
    float fr = fr_complex_cond(clampn(cos_out, -1.0f, 1.0f), eta, kk);
    float sv = cos_out <= F(1e-6) ? 0.0f : fr / maxn(cos_out, F(1e-6));
    out.val = scale4(m.c0, sv);
    out.dir = perf;
    out.pdf = 1.0f;
    out.flags = RAY_EVENT_S;
    return out;
  }
  float a0 = minn(m.data[CONDUCTOR_ROUGH_U], tex.x);
  float a1 = minn(m.data[CONDUCTOR_ROUGH_V], tex.y);
  V3 nx, ny;
  coordinate_system_v2(n, nx, ny);
  V3 wo = {dot3(v, nx), dot3(v, ny), dot3(v, n)};
  V3 wm = tr_sample(wo, r0, r1, a0, a1);
  V3 wi = reflect3(neg(wo), wm);
  float cos_o = fabsf(wo.z), cos_i = fabsf(wi.z);
  out.flags = FLAG_HAS_NON_SPEC;
  if (!(wo.z * wi.z >= 0.0f) || cos_i == 0.0f || cos_o == 0.0f ||
      wo.z == 0.0f) {         // a dead sample: val 0, pdf 1, dir (0, 1, 0)
    out.val = {0.0f, 0.0f, 0.0f, 0.0f};
    out.dir = {0.0f, 1.0f, 0.0f};
    out.pdf = 1.0f;
    return out;
  }
  float fr_m = fr_complex_cond(clampn(fabsf(dot3(wo, wm)), -1.0f, 1.0f), eta,
                               kk);
  float val = fr_m * tr_d(wm, a0, a1) * tr_g(wo, wi, a0, a1) /
              maxn(4.0f * cos_i * cos_o, F(1e-20));
  out.val = scale4(m.c0, val);
  out.dir = normalize3(add(add(scale(nx, wi.x), scale(ny, wi.y)),
                           scale(n, wi.z)));
  out.pdf = tr_pdf(wo, wm, a0, a1) / maxn(4.0f * fabsf(dot3(wo, wm)),
                                          F(1e-20));
  return out;
}

// conductorRoughEval (cmat_conductor.h:105-137); a smooth one gives 0
__device__ V4 conductor_eval(const Mat& m, V4 tex, V3 l, V3 v, V3 n,
                             float& pdf) {
  const V4 zero = {0.0f, 0.0f, 0.0f, 0.0f};
  pdf = 0.0f;
  if (maxn(m.data[CONDUCTOR_ROUGH_V], m.data[CONDUCTOR_ROUGH_U]) < F(1e-3))
    return zero;
  float a0 = minn(m.data[CONDUCTOR_ROUGH_U], tex.x);
  float a1 = minn(m.data[CONDUCTOR_ROUGH_V], tex.y);
  V3 nx, ny;
  coordinate_system_v2(n, nx, ny);
  V3 wo = {dot3(v, nx), dot3(v, ny), dot3(v, n)};
  V3 wi = {dot3(l, nx), dot3(l, ny), dot3(l, n)};
  V3 wm0 = add(wo, wi);
  float cos_o = fabsf(wo.z), cos_i = fabsf(wi.z);
  if (!(wo.z * wi.z >= 0.0f) || !(dot3(wm0, wm0) > 0.0f) || cos_i == 0.0f ||
      cos_o == 0.0f)
    return zero;
  V3 wm = normalize3(wm0);
  float fr_m = fr_complex_cond(clampn(fabsf(dot3(wo, wm)), -1.0f, 1.0f),
                               m.data[CONDUCTOR_ETA], m.data[CONDUCTOR_K]);
  float val = fr_m * tr_d(wm, a0, a1) * tr_g(wo, wi, a0, a1) /
              maxn(4.0f * cos_i * cos_o, F(1e-20));
  V3 wm_ff = wm.z < 0.0f ? neg(wm) : wm;
  pdf = tr_pdf(wo, wm_ff, a0, a1) / maxn(4.0f * fabsf(dot3(wo, wm_ff)),
                                         F(1e-20));
  return scale4(m.c0, val);
}

#if HC3_SPECTRAL
// ---- spectral fetches (the plain version's spd_sample, spd_or_color,
// cie_fetch) --------------------------------------------------------------

// spectrum `sid` at wavelength `lam`: the 1 nm grid index clamped to
// [0, 469] and lerped (sample_uniform_spectrum)
__device__ __forceinline__ float spd_sample(const Tables& tb, float sid,
                                            float lam) {
  int idx1 = (int)clampn(lam - 360.0f, 0.0f, 469.0f);
  int idx2 = idx1 + 1 < 469 ? idx1 + 1 : 469;
  float x1 = 360.0f + (float)idx1;
  int ns = (int)ld(tb.consts, CN_NSPD);
  int sp = (int)sid;
  sp = sp < 0 ? 0 : (sp > ns - 1 ? ns - 1 : sp);
  int off = __ldg(tb.spd_off + sp);
  float y1 = __ldg(tb.spd + off + idx1), y2 = __ldg(tb.spd + off + idx2);
  return y1 + (lam - x1) * (y2 - y1);
}

// each wavelength's SPD sample where sid >= 0, else the color as it is
__device__ __forceinline__ V4 spd_or_color(const Tables& tb, float sid,
                                           const float* lam, V4 c) {
  if (!(sid >= 0.0f)) return c;
  return {spd_sample(tb, sid, lam[0]), spd_sample(tb, sid, lam[1]),
          spd_sample(tb, sid, lam[2]), spd_sample(tb, sid, lam[3])};
}

// the CIE curves at round(lam); 0 outside the table
__device__ __forceinline__ float4 cie_fetch(const Tables& tb, float lam) {
  int off = (int)(floorf(lam + 0.5f) - 360.0f);
  if (off < 0 || off >= 471) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return __ldg(tb.cie + off);
}

// FrComplexConductor per wavelength
__device__ __forceinline__ V4 fr_cond4(float cos_i, V4 eta, V4 kk) {
  return {fr_complex_cond(cos_i, eta.x, kk.x),
          fr_complex_cond(cos_i, eta.y, kk.y),
          fr_complex_cond(cos_i, eta.z, kk.z),
          fr_complex_cond(cos_i, eta.w, kk.w)};
}

// a conductor's eta and k per wavelength: its SPDs, else its scalars
__device__ __forceinline__ void cond_eta_k(const Tables& tb, const Mat& m,
                                           const float* lam, V4& eta,
                                           V4& kk) {
  float e = m.data[CONDUCTOR_ETA], k = m.data[CONDUCTOR_K];
  eta = spd_or_color(tb, m.spd0, lam, {e, e, e, e});
  kk = spd_or_color(tb, m.spd1, lam, {k, k, k, k});
}

// conductorSmooth/RoughSampleAndEval with eta and k per wavelength
__device__ Sample conductor_sample_spec(const Mat& m, V4 tex, float r0,
                                        float r1, V3 v, V3 n, V4 eta, V4 kk,
                                        Sample out) {
  bool smooth = maxn(m.data[CONDUCTOR_ROUGH_V], m.data[CONDUCTOR_ROUGH_U]) <
                F(1e-3);
  if (smooth) {
    V3 perf = reflect3(neg(v), n);
    float cos_out = dot3(perf, n);
    V4 fr = fr_cond4(clampn(cos_out, -1.0f, 1.0f), eta, kk);
    float den = maxn(cos_out, F(1e-6));
    bool zero = cos_out <= F(1e-6);
    out.val = {(zero ? 0.0f : fr.x / den) * m.c0.x,
               (zero ? 0.0f : fr.y / den) * m.c0.y,
               (zero ? 0.0f : fr.z / den) * m.c0.z,
               (zero ? 0.0f : fr.w / den) * m.c0.w};
    out.dir = perf;
    out.pdf = 1.0f;
    out.flags = RAY_EVENT_S;
    return out;
  }
  float a0 = minn(m.data[CONDUCTOR_ROUGH_U], tex.x);
  float a1 = minn(m.data[CONDUCTOR_ROUGH_V], tex.y);
  V3 nx, ny;
  coordinate_system_v2(n, nx, ny);
  V3 wo = {dot3(v, nx), dot3(v, ny), dot3(v, n)};
  V3 wm = tr_sample(wo, r0, r1, a0, a1);
  V3 wi = reflect3(neg(wo), wm);
  float cos_o = fabsf(wo.z), cos_i = fabsf(wi.z);
  out.flags = FLAG_HAS_NON_SPEC;
  if (!(wo.z * wi.z >= 0.0f) || cos_i == 0.0f || cos_o == 0.0f ||
      wo.z == 0.0f) {         // a dead sample: val 0, pdf 1, dir (0, 1, 0)
    out.val = {0.0f, 0.0f, 0.0f, 0.0f};
    out.dir = {0.0f, 1.0f, 0.0f};
    out.pdf = 1.0f;
    return out;
  }
  V4 fr = fr_cond4(clampn(fabsf(dot3(wo, wm)), -1.0f, 1.0f), eta, kk);
  float d = tr_d(wm, a0, a1), g = tr_g(wo, wi, a0, a1);
  float den = maxn(4.0f * cos_i * cos_o, F(1e-20));
  out.val = {fr.x * d * g / den * m.c0.x, fr.y * d * g / den * m.c0.y,
             fr.z * d * g / den * m.c0.z, fr.w * d * g / den * m.c0.w};
  out.dir = normalize3(add(add(scale(nx, wi.x), scale(ny, wi.y)),
                           scale(n, wi.z)));
  out.pdf = tr_pdf(wo, wm, a0, a1) / maxn(4.0f * fabsf(dot3(wo, wm)),
                                          F(1e-20));
  return out;
}

// conductorRoughEval with eta and k per wavelength
__device__ V4 conductor_eval_spec(const Mat& m, V4 tex, V3 l, V3 v, V3 n,
                                  V4 eta, V4 kk, float& pdf) {
  const V4 zero = {0.0f, 0.0f, 0.0f, 0.0f};
  pdf = 0.0f;
  if (maxn(m.data[CONDUCTOR_ROUGH_V], m.data[CONDUCTOR_ROUGH_U]) < F(1e-3))
    return zero;
  float a0 = minn(m.data[CONDUCTOR_ROUGH_U], tex.x);
  float a1 = minn(m.data[CONDUCTOR_ROUGH_V], tex.y);
  V3 nx, ny;
  coordinate_system_v2(n, nx, ny);
  V3 wo = {dot3(v, nx), dot3(v, ny), dot3(v, n)};
  V3 wi = {dot3(l, nx), dot3(l, ny), dot3(l, n)};
  V3 wm0 = add(wo, wi);
  float cos_o = fabsf(wo.z), cos_i = fabsf(wi.z);
  if (!(wo.z * wi.z >= 0.0f) || !(dot3(wm0, wm0) > 0.0f) || cos_i == 0.0f ||
      cos_o == 0.0f)
    return zero;
  V3 wm = normalize3(wm0);
  V4 fr = fr_cond4(clampn(fabsf(dot3(wo, wm)), -1.0f, 1.0f), eta, kk);
  float d = tr_d(wm, a0, a1), g = tr_g(wo, wi, a0, a1);
  float den = maxn(4.0f * cos_i * cos_o, F(1e-20));
  V3 wm_ff = wm.z < 0.0f ? neg(wm) : wm;
  pdf = tr_pdf(wo, wm_ff, a0, a1) / maxn(4.0f * fabsf(dot3(wo, wm_ff)),
                                         F(1e-20));
  return {fr.x * d * g / den * m.c0.x, fr.y * d * g / den * m.c0.y,
          fr.z * d * g / den * m.c0.z, fr.w * d * g / den * m.c0.w};
}
#endif

// dielectricSmoothSampleAndEval (cmat_dielectric.h:8-57)
__device__ Sample dielectric_sample(const Mat& m, float r0, V3 v, V3 n,
                                    uint32_t flags, float mis_ior,
                                    Sample out) {
  float ext_ior = m.data[DIELECTRIC_ETA_EXT];
  float eta_int = m.data[DIELECTRIC_ETA_INT];
  V3 nf = (flags & FLAG_HAS_INV_NORMAL) ? neg(n) : n;
  V3 s, t;
  coordinate_system_v2(nf, s, t);
  V3 wi = {dot3(v, s), dot3(v, t), dot3(v, nf)};
  float eta = eta_int / ext_ior;
  // FrDielectricDetailedV2 (cmaterial.h:646-683)
  float ci = clampn(wi.z, -1.0f, 1.0f);
  bool outside = ci >= 0.0f;
  float eta_it = outside ? eta : 1.0f / eta;
  float eta_ti = outside ? 1.0f / eta : eta;
  float cos_t_sqr = 1.0f - (1.0f - ci * ci) * eta_ti * eta_ti;
  float ci_abs = fabsf(ci);
  float ct_abs = safe_sqrt(cos_t_sqr);
  float a_s = (-eta_it * ct_abs + ci_abs) /
              maxn(eta_it * ct_abs + ci_abs, F(1e-12));
  float a_p = (-eta_it * ci_abs + ct_abs) /
              maxn(eta_it * ci_abs + ct_abs, F(1e-12));
  float r = 0.5f * (a_s * a_s + a_p * a_p);
  if (eta == 1.0f || ci_abs == 0.0f) r = eta == 1.0f ? 0.0f : 1.0f;
  float cos_theta_t = ci >= 0.0f ? -ct_abs : ct_abs;
  float t_coef = 1.0f - r;
  bool pick = r0 < r;
  V3 wo = pick ? V3{-wi.x, -wi.y, wi.z}
               : V3{-eta_ti * wi.x, -eta_ti * wi.y, cos_theta_t};
  out.dir = normalize3(add(add(scale(s, wo.x), scale(t, wo.y)),
                           scale(nf, wo.z)));
  float val = (pick ? r : (eta_ti * eta_ti) * t_coef) /
              maxn(fabsf(dot3(out.dir, nf)), F(1e-6));
  out.val = {val, val, val, val};
  out.pdf = pick ? r : t_coef;
  out.flags = pick ? RAY_EVENT_S : (RAY_EVENT_S | RAY_EVENT_T);
  out.ior = pick ? mis_ior : (mis_ior == eta_int ? ext_ior : eta_int);
  return out;
}

// glassSampleAndEval (cmat_glass.h:234-275); r3 picks reflection
__device__ Sample glass_sample(const Mat& m, float r3, V3 v, V3 n,
                               uint32_t flags, float mis_ior, Sample out) {
  float ior = m.data[GLASS_FLOAT_IOR];
  V3 ray_dir = neg(v);
  bool exiting = (flags & FLAG_HAS_INV_NORMAL) && mis_ior == ior;
  float rel = exiting ? 1.0f / ior : ior / mis_ior;
  // fresnel2
  float cosi = dot3(v, n);
  float sint = safe_sqrt(1.0f - cosi * cosi) / rel;
  float cost = safe_sqrt(1.0f - sint * sint);
  float rp = (rel * cosi - cost) / maxn(rel * cosi + cost, F(1e-12));
  float rs = (cosi - rel * cost) / maxn(cosi + rel * cost, F(1e-12));
  float fres = sint > 1.0f ? 1.0f : 0.5f * (rp * rp + rs * rs);
  bool pick = r3 < fres;
  V3 dir_refl = normalize3(sub(ray_dir, scale(n, 2.0f * dot3(ray_dir, n))));
  V3 dir = dir_refl;
  if (!pick) {              // refract2: total internal reflection reflects
    float cosi_d = dot3(ray_dir, n);
    float eta2 = 1.0f / rel;
    float k = 1.0f - eta2 * eta2 * (1.0f - cosi_d * cosi_d);
    if (!(k < 0.0f))
      dir = normalize3(sub(scale(ray_dir, eta2),
                           scale(n, eta2 * cosi_d + safe_sqrt(k))));
  }
  float inv = maxn(fabsf(dot3(dir, n)), F(1e-6));
  V4 c = pick ? m.c0 : m.c1;
  out.val = {c.x / inv, c.y / inv, c.z / inv, c.w / inv};
  out.dir = dir;
  out.pdf = 1.0f;
  out.flags = pick ? RAY_EVENT_S : (RAY_EVENT_S | RAY_EVENT_T);
  out.ior = pick ? mis_ior : ior;
  return out;
}

// MaterialEval (integrator_pt_mat.cpp:308-528) for the variant's types: the
// delta materials and light sources give 0
// (spectral mode: a diffuse's reflectance is its SPD, else its color
// without the texture; a conductor's eta and k are its SPDs')
template <int MT>
__device__ V4 mat_eval(const Mat& m, V4 tex, V3 l, V3 v, V3 n,
                       float& pdf SPEC_PARAM) {
  pdf = 0.0f;
  if constexpr ((MT & MT_GLTF) != 0)
    if (m.mtype == MAT_GLTF) return gltf_eval(m, tex, l, v, n, pdf);
  if constexpr ((MT & MT_DIFFUSE) != 0)
    if (m.mtype == MAT_DIFFUSE) {
      pdf = fabsf(dot3(l, n)) * INV_PI_F;
#if HC3_SPECTRAL
      return scale4(spd_or_color(tb, m.spd0, lam, m.c0),
                    diffuse_scale(m, l, v, n));
#else
      return scale4(mul4(m.c0, tex), diffuse_scale(m, l, v, n));
#endif
    }
  if constexpr ((MT & MT_CONDUCTOR) != 0)
    if (m.mtype == MAT_CONDUCTOR) {
#if HC3_SPECTRAL
      V4 eta, kk;
      cond_eta_k(tb, m, lam, eta, kk);
      return conductor_eval_spec(m, tex, l, v, n, eta, kk, pdf);
#else
      return conductor_eval(m, tex, l, v, n, pdf);
#endif
    }
  return {0.0f, 0.0f, 0.0f, 0.0f};
}

// MaterialSampleAndEval (integrator_pt_mat.cpp:109-306) for the variant's
// types; a light source samples val 0, dir (0, 1, 0), pdf 1, flags 0
template <int MT>
__device__ Sample mat_sample(const Mat& m, V4 tex, const float r[4], V3 v,
                             V3 n, uint32_t flags, float mis_ior SPEC_PARAM) {
  Sample out{{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f}, 1.0f, 0u, mis_ior};
  if constexpr ((MT & MT_GLTF) != 0)
    if (m.mtype == MAT_GLTF) return gltf_sample(m, tex, r, v, n, out);
  if constexpr ((MT & MT_DIFFUSE) != 0)
    if (m.mtype == MAT_DIFFUSE) {   // the Oren-Nayar factor takes -v
      V3 lam_dir = map_sample_to_cosine(r[0], r[1], n, n);
#if HC3_SPECTRAL
      out.val = scale4(spd_or_color(tb, m.spd0, lam, m.c0),
                       diffuse_scale(m, lam_dir, neg(v), n));
#else
      out.val = scale4(mul4(m.c0, tex), diffuse_scale(m, lam_dir, neg(v), n));
#endif
      out.dir = lam_dir;
      out.pdf = fabsf(dot3(lam_dir, n)) * INV_PI_F;
      out.flags = FLAG_HAS_NON_SPEC;
      return out;
    }
  if constexpr ((MT & MT_CONDUCTOR) != 0)
    if (m.mtype == MAT_CONDUCTOR) {
#if HC3_SPECTRAL
      V4 eta, kk;
      cond_eta_k(tb, m, lam, eta, kk);
      return conductor_sample_spec(m, tex, r[0], r[1], v, n, eta, kk, out);
#else
      return conductor_sample(m, tex, r[0], r[1], v, n, out);
#endif
    }
  if constexpr ((MT & MT_DIELECTRIC) != 0)
    if (m.mtype == MAT_DIELECTRIC)
      return dielectric_sample(m, r[0], v, n, flags, mis_ior, out);
  if constexpr ((MT & MT_GLASS) != 0)
    if (m.mtype == MAT_GLASS)
      return glass_sample(m, r[3], v, n, flags, mis_ior, out);
  return out;
}

// ---- lights -------------------------------------------------------------------

struct Lgt {
  V3 pos, norm;
  V4 inten;
  float m[9];
  float size0, size1, pdf_a, mult;
  int geom, dist;
#if HC3_SPECTRAL
  float spd;                          // the emission's SPD id (-1: none)
#endif
};

__device__ Lgt fetch_light(const Tables& tb, int lid) {
  lid = lid < 0 ? 0 : (lid > 127 ? 127 : lid);
  float r[LF_NREAD];
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
#if HC3_SPECTRAL
  L.spd = r[LF_SPD];
#endif
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

// cglobals.h:188-231 ([-1, 1]^2 -> the disc, with the reference's sin/cos
// swap), in the JAX megakernel's form
__device__ void map_samples_to_disc(float x, float y, float& px, float& py) {
  bool zero = x == 0.0f && y == 0.0f;
  bool case_x = fabsf(x) > fabsf(y);
  float sx = x == 0.0f ? 1.0f : x, sy = y == 0.0f ? 1.0f : y;
  float r = case_x ? x : y;
  float phi = case_x ? F(3.141592653589793 / 4.0) * (y / sx)
                     : F(3.141592653589793 / 2.0) -
                           (x / sy) * F(3.141592653589793 / 4.0);
  if (zero) r = phi = 0.0f;
  px = r * sinf(phi);
  py = r * cosf(phi);
}

// LightSampleRev for rect / disc / sphere / point (clight.h:67-126); the
// disc only in variants whose scene has one
template <int MT>
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
  float off_x, off_z;
  if ((MT & MT_DISC) != 0 && L.geom == LIGHT_GEOM_DISC) {
    map_samples_to_disc(r0 * 2.0f - 1.0f, r1 * 2.0f - 1.0f, off_x, off_z);
    off_x = off_x * L.size0;
    off_z = off_z * L.size0;
  } else {
    off_x = 2.0f * (r0 - 0.5f) * L.size0;
    off_z = 2.0f * (r1 - 0.5f) * L.size1;
  }
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

// kernel_SampleLightSource (integrator_pt.cpp:350-424); MIS weights for the
// MIS integrator only
template <int IT, int MT, class C>
__device__ V4 stage_nee(const Tables& tb, const Mat& m, V4 tex, St& s,
                        C& cx) {
  const V4 zero = {0.0f, 0.0f, 0.0f, 0.0f};
  float rnd_id = rnd1(s.rngx, s.rngy);
  float r[4];
  rnd4(s.rngx, s.rngy, r);
  float nl = ld(tb.consts, CN_NUM_LIGHTS);
  Lgt L = fetch_light(tb, (int)minn(floorf(rnd_id * nl), nl - 1.0f));
  V3 lpos, lnorm;
  bool omni;
  light_sample_rev<MT>(L, r[0], r[1], lpos, lnorm, omni);
  V3 hp = s.hit_pos;
  V3 dd = sub(hp, lpos);
  float dist = sqrtf(dot3(dd, dd));
  V3 sdir = normalize3(sub(lpos, hp));
  float offs = maxn(maxn(hp.x, maxn(hp.y, hp.z)), 1.0f) * F(5e-6);
  V3 spos = add(hp, scale(s.hit_norm, offs));
  if (!(dot3(sdir, lnorm) < 0.0f || omni)) return zero;
  if (trace<true>(tb, spos, sdir, dist * F(0.9995), cx).tri >= 0)
    return zero;
  float bsdf_pdf;
  V4 val = mat_eval<MT>(m, tex, sdir, neg(s.d), s.hit_norm,
                        bsdf_pdf SPEC_ARG(tb, s));
  float cos_out = maxn(dot3(sdir, s.hit_norm), 0.0f);
  float lgt_pdf_w = (1.0f / maxn(nl, 1.0f)) *
                    light_eval_pdf(L, spos, sdir, lpos, lnorm);
  float mis = 1.0f;
  if constexpr (IT == INTEGRATOR_MIS)
    if (L.geom != LIGHT_GEOM_POINT) mis = mis_weight(lgt_pdf_w, bsdf_pdf);
  float den = maxn(lgt_pdf_w, F(1e-30));
  float cm = cos_out * mis;
#if HC3_SPECTRAL
  V4 li = spd_or_color(tb, L.spd, s.lam, L.inten);
#else
  V4 li = L.inten;
#endif
  return {li.x * L.mult * val.x / den * cm, li.y * L.mult * val.y / den * cm,
          li.z * L.mult * val.z / den * cm, li.w * L.mult * val.w / den * cm};
}

// kernel_NextBounce (integrator_pt.cpp:426-548).  A light hit takes MIS
// weights under MIS, counts only before the first non-specular bounce
// under the shadow integrator and whole under the naive one, which adds no
// NEE.
template <int IT, int MT>
__device__ void stage_next_bounce(const Tables& tb, const Mat& m, V4 tex,
                                  St& s, V4 shade, bool prim) {
  if (m.mtype == MTYPE_SMALL_LIGHT) {     // light hit
    int lgt_id = (int)s.hit_lgt;
    V4 li;
    float mw = 1.0f;
    if constexpr (IT == INTEGRATOR_SHADOW)
      mw = (s.flags & FLAG_HAS_NON_SPEC) ? 0.0f : 1.0f;
    if (lgt_id >= 0) {
      Lgt L = fetch_light(tb, lgt_id);
      float light_cos = dot3(s.d, L.norm);
      float atten =
          (light_cos < 0.0f || L.geom == LIGHT_GEOM_SPHERE) ? 1.0f : 0.0f;
#if HC3_SPECTRAL
      V4 c = spd_or_color(tb, L.spd, s.lam, L.inten);
#else
      V4 c = L.inten;
#endif
      li = {c.x * L.mult * atten, c.y * L.mult * atten, c.z * L.mult * atten,
            c.w * L.mult * atten};
      if (IT == INTEGRATOR_MIS && !prim) {
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
  Sample smp = mat_sample<MT>(m, tex, r, neg(s.d), s.hit_norm, s.flags,
                             s.mis_ior SPEC_ARG(tb, s));
  float den = maxn(smp.pdf, F(1e-20));
  float cos_theta = fabsf(dot3(smp.dir, s.hit_norm));
  if constexpr (IT != INTEGRATOR_NAIVE)
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
  // only a dielectric or a glass changes the medium
  if constexpr ((MT & (MT_DIELECTRIC | MT_GLASS)) != 0) s.mis_ior = smp.ior;
  uint32_t next = (s.flags & ~FLAG_FIRST_NON_SPEC) | smp.flags;
  if (!(s.flags & FLAG_HAS_NON_SPEC) && (next & FLAG_HAS_NON_SPEC))
    next |= FLAG_FIRST_NON_SPEC;
  s.flags = next;
}

// NEE (none under the naive integrator) and the next bounce at a live
// lane's hit.  At a light-source material the bounce ends the path and takes
// no NEE result, so NEE only advances the RNG as the plain version's does
// (rnd1, rnd4) and skips the light sample, the shadow trace and the eval.
template <int IT, int MT, class C>
__device__ void shade_hit(const Tables& tb, St& s, bool prim, C& cx) {
  Mat m = fetch_mat(tb, s.flags & 0x00FFFFFFu);
  HC3_TICK_SHADE(cx, m.mtype);
  V4 tex = tex_tap(tb, m, s);
  V4 sc = {0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (IT != INTEGRATOR_NAIVE) {
    if (m.mtype == MTYPE_SMALL_LIGHT) {
      float r[4];
      rnd1(s.rngx, s.rngy);
      rnd4(s.rngx, s.rngy, r);
    } else {
      sc = stage_nee<IT, MT>(tb, m, tex, s, cx);
    }
  }
  stage_next_bounce<IT, MT>(tb, m, tex, s, sc, prim);
}

// the env lat-long map at the miss direction d: the JAX stage_env_tap_prep
// (sphereMapTo2DTexCoord and the env sampler matrix)
__device__ V4 env_tap(const Tables& tb, V3 d) {
  const float* c = tb.consts;
  float theta = acos_poly(clampn(-d.y, -1.0f, 1.0f));
  float phi = atan2f(d.x, d.z);
  phi = phi < 0.0f ? phi + TWOPI_F : phi;
  float u = clampn(phi * 0.5f * INV_PI_F, 0.0f, 1.0f);
  float v = clampn(theta * INV_PI_F, 0.0f, 1.0f);
  float tcx = ld(c, CN_ENV_SROW0) * u + ld(c, CN_ENV_SROW0 + 1) * v +
              ld(c, CN_ENV_SROW0 + 3);
  float tcy = ld(c, CN_ENV_SROW1) * u + ld(c, CN_ENV_SROW1 + 1) * v +
              ld(c, CN_ENV_SROW1 + 3);
  return tap(tb, (int)ld(c, CN_ENV_TEXID), tcx, tcy);
}

// kernel_HitEnvironment (the flat color, times the env map when the variant
// taps one; the naive integrator's miss overwrites the accumulator) +
// contribution
#if HC3_SPECTRAL
// spectrum_to_xyz + xyz_to_rgb on the lane's radiance per hero wavelength:
// RGB and alpha 1.  Where the waves diverged only lane 0 counts, at a
// quarter of the pdf.
__device__ V4 spectral_contrib(const Tables& tb, const St& s, V4 a) {
  const float pdf0 = F(1.0 / 470.0);
  const bool tw = (s.flags & FLAG_WAVES_DIVERGED) != 0;
  const float av[4] = {a.x, a.y, a.z, a.w};
  float x = 0.0f, y = 0.0f, z = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float pdf = tw ? (j == 0 ? pdf0 / 4.0f : 0.0f) : pdf0;
    float specp = pdf != 0.0f ? av[j] / pdf : 0.0f;
    float4 w = cie_fetch(tb, s.lam[j]);
    x = x + w.x * specp;
    y = y + w.y * specp;
    z = z + w.z * specp;
  }
  const float q = F(0.25 / 106.856895);
  x = x * q;
  y = y * q;
  z = z * q;
  return {F(3.240479) * x + F(-1.537150) * y + F(-0.498535) * z,
          F(-0.969256) * x + F(1.875991) * y + F(0.041556) * z,
          F(0.055648) * x + F(-0.204043) * y + F(1.057311) * z, 1.0f};
}
#endif

template <int IT, bool ENV>
__device__ V4 env_contribute(const Tables& tb, const St& s) {
  const float* c = tb.consts;
  V4 a = s.accum;
  if (s.flags & FLAG_OUT_OF_SCENE) {
    V4 env = {ld(c, CN_ENV_COLOR), ld(c, CN_ENV_COLOR + 1),
              ld(c, CN_ENV_COLOR + 2), ld(c, CN_ENV_COLOR + 3)};
#if HC3_SPECTRAL
    float sid = ld(c, CN_ENV_SPD);
    if (sid >= 0.0f) {                // the sky's SPD
      float sm = ld(c, CN_ENV_SMULT);
      env = {spd_sample(tb, sid, s.lam[0]) * sm,
             spd_sample(tb, sid, s.lam[1]) * sm,
             spd_sample(tb, sid, s.lam[2]) * sm,
             spd_sample(tb, sid, s.lam[3]) * sm};
    }
#endif
    if constexpr (ENV) env = mul4(env, env_tap(tb, s.d));
    V4 te = mul4(s.thr, env);
    if constexpr (IT == INTEGRATOR_NAIVE)
      a = te;
    else
      a = {a.x + te.x, a.y + te.y, a.z + te.z, a.w + te.w};
  }
  float e = ld(c, CN_EXPOSURE);
#if HC3_SPECTRAL
  V4 rgb = spectral_contrib(tb, s, a);
  return {rgb.x * e, rgb.y * e, rgb.z * e, rgb.w};
#else
  return {a.x * ld(c, CN_CAM_RESP) * e, a.y * ld(c, CN_CAM_RESP + 1) * e,
          a.z * ld(c, CN_CAM_RESP + 2) * e, a.w * ld(c, CN_CAM_RESP + 3) * e};
#endif
}

// ---- the two kernels ---------------------------------------------------------

// bounces a sample takes: one more under the naive integrator
template <int IT>
__device__ __forceinline__ int n_bounces(int depth) {
  return depth + (IT == INTEGRATOR_NAIVE ? 1 : 0);
}

// Where a block's shared memory holds what (byte offsets, each 16-aligned)
// for one pack and entry point: when the layout is on chip (the geometry
// fits GEOM_CHIP_BYTES and the walk's stack need STACK_CHIP_MAX) the
// geometry and the walk stacks (BLOCK x stack_n entries); then the pool of
// `pool` lanes (0: one lane a thread): its f32 and u32 state rows
// (component-major), the class lists, each lane's class and rank, the
// class counts.
struct Layout {
  int nodes, rows, shade, index, stack, pf, pu, list, rank, cls, hist;
  int n_nodes, n_tris, stack_n, chip, pool, bytes;
};

inline int up16(int b) { return (b + 15) & ~15; }

// dims: the walk's stack need, texels, textured, wide nodes, real
// triangles; nf / nu: the pool's f32 / u32 rows
inline Layout layout_of(const int* dims, int nf, int nu, int pool) {
  Layout L{};
  L.stack_n = dims[0] > 0 ? dims[0] : 1;
  L.n_nodes = dims[3];
  L.n_tris = dims[4];
  int b = 0;
  L.chip = L.n_nodes * 144 + L.n_tris * (48 + 4 * SHADE_CHIP_W + 4) <=
               GEOM_CHIP_BYTES &&
           L.stack_n <= STACK_CHIP_MAX;
  if (L.chip) {
    L.nodes = b;
    b += L.n_nodes * 144;
    L.rows = b;
    b += L.n_tris * 48;
    L.shade = b;
    b += up16(L.n_tris * SHADE_CHIP_W * 4);
    L.index = b;
    b += up16(L.n_tris * 4);
    L.stack = b;
    b += BLOCK * L.stack_n * 8;
  }
  L.pool = pool;
  L.pf = b;
  b += nf * pool * 4;
  L.pu = b;
  b += nu * pool * 4;
  L.list = b;
  b += pool * 2;
  L.rank = b;
  b += pool * 2;
  L.cls = b;
  b += pool;
  L.hist = b;
  b += up16((2 * N_CLASSES + 1) * 4);
  L.bytes = b;
  return L;
}

// one element from device to shared memory without a register stop
// (cp.async; 16 or 4 bytes), and the wait for every copy this thread issued
__device__ __forceinline__ void copy16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  memcpy(dst, src, 16);
#endif
}
__device__ __forceinline__ void copy4(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  memcpy(dst, src, 4);
#endif
}
__device__ __forceinline__ void copies_done() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
#endif
  __syncthreads();
}

// The block's tables: the geometry copied on chip when the layout holds it
// (nodes and shade rows padded); once per block.
__device__ Tables tables_on_chip(Tables tb, const Layout& L, char* sm) {
  const int tid = threadIdx.x;
  if (L.chip) {
    const int M = L.n_nodes, T = L.n_tris;
    float4* ns = reinterpret_cast<float4*>(sm + L.nodes);
    for (int i = tid; i < M * 8; i += BLOCK)
      copy16(ns + 9 * (i >> 3) + (i & 7), tb.nodes + i);
    float4* rs = reinterpret_cast<float4*>(sm + L.rows);
    for (int i = tid; i < T * 3; i += BLOCK) copy16(rs + i, tb.rows + i);
    float* ss = reinterpret_cast<float*>(sm + L.shade);
    for (int i = tid; i < T * SHADE_COLS; i += BLOCK) {
      const int t = i / SHADE_COLS, c = i % SHADE_COLS;
      copy4(ss + SHADE_CHIP_W * t + c, tb.shade + 32 * t + c);
    }
    int* is = reinterpret_cast<int*>(sm + L.index);
    for (int i = tid; i < T; i += BLOCK) copy4(is + i, tb.index + i);
    tb.nodes = ns;
    tb.rows = rs;
    tb.shade = ss;
    tb.index = is;
  }
  copies_done();
  return tb;
}

// A block's pool: P lanes' state in shared memory, row j of lane l at
// f[j * P + l] (the regen state's rows: RF_NROWS f32, then rngx, rngy,
// flags, ndone, bcnt), and the lists one phase's lanes are taken from.
struct Pool {
  float* f;
  uint32_t* u;
  unsigned short* list;               // lanes, class by class
  unsigned short* rank;               // each lane's place in its class
  signed char* cls;                   // each lane's class (-1: none)
  int* hist;                          // [N_CLASSES] lanes a class
  int* off;                           // [N_CLASSES + 1] where a class starts
  int P;                              // lanes a pool (the entry point's)
};

__device__ __forceinline__ Pool pool_of(const Layout& L, char* sm, int P) {
  Pool p;
  p.f = reinterpret_cast<float*>(sm + L.pf);
  p.u = reinterpret_cast<uint32_t*>(sm + L.pu);
  p.list = reinterpret_cast<unsigned short*>(sm + L.list);
  p.rank = reinterpret_cast<unsigned short*>(sm + L.rank);
  p.cls = reinterpret_cast<signed char*>(sm + L.cls);
  p.hist = reinterpret_cast<int*>(sm + L.hist);
  p.off = p.hist + N_CLASSES;
  p.P = P;
  return p;
}

enum { U_RNGX = 0, U_RNGY = 1, U_FLAGS = 2, U_NDONE = 3, U_BCNT = 4 };

__device__ __forceinline__ uint32_t& pu(const Pool& p, int j, int l) {
  return p.u[j * p.P + l];
}
__device__ __forceinline__ float& pf(const Pool& p, int j, int l) {
  return p.f[j * p.P + l];
}

__device__ __forceinline__ void get_st(const Pool& p, int l, St& s) {
  s.o = {pf(p, 0, l), pf(p, 1, l), pf(p, 2, l)};
  s.d = {pf(p, 3, l), pf(p, 4, l), pf(p, 5, l)};
  s.accum = {pf(p, 6, l), pf(p, 7, l), pf(p, 8, l), pf(p, 9, l)};
  s.thr = {pf(p, 10, l), pf(p, 11, l), pf(p, 12, l), pf(p, 13, l)};
  s.mis_pdf = pf(p, 14, l);
  s.mis_ior = pf(p, 15, l);
  s.hit_pos = {pf(p, 16, l), pf(p, 17, l), pf(p, 18, l)};
  s.hit_norm = {pf(p, 19, l), pf(p, 20, l), pf(p, 21, l)};
  s.hit_u = pf(p, 22, l);
  s.hit_v = pf(p, 23, l);
  s.hit_dist = pf(p, 24, l);
  s.hit_lgt = pf(p, 25, l);
#if HC3_SPECTRAL
#pragma unroll
  for (int j = 0; j < 4; ++j) s.lam[j] = pf(p, 26 + j, l);
#endif
  s.rngx = pu(p, U_RNGX, l);
  s.rngy = pu(p, U_RNGY, l);
  s.flags = pu(p, U_FLAGS, l);
}

__device__ __forceinline__ void put_hit_rows(const Pool& p, int l,
                                             const St& s) {
  const float f[] = {s.hit_pos.x, s.hit_pos.y, s.hit_pos.z, s.hit_norm.x,
                     s.hit_norm.y, s.hit_norm.z, s.hit_u, s.hit_v,
                     s.hit_dist, s.hit_lgt};
#pragma unroll
  for (int j = 0; j < 10; ++j) pf(p, 16 + j, l) = f[j];
}

// every row, or (HIT false: after a shade, which only reads the hit) all
// but the hit's
template <bool HIT = true>
__device__ __forceinline__ void put_st(const Pool& p, int l, const St& s) {
  const float f[] = {s.o.x, s.o.y, s.o.z, s.d.x, s.d.y, s.d.z,
                     s.accum.x, s.accum.y, s.accum.z, s.accum.w,
                     s.thr.x, s.thr.y, s.thr.z, s.thr.w, s.mis_pdf,
                     s.mis_ior};
#pragma unroll
  for (int j = 0; j < 16; ++j) pf(p, j, l) = f[j];
#if HC3_SPECTRAL
#pragma unroll
  for (int j = 0; j < 4; ++j) pf(p, 26 + j, l) = s.lam[j];
#endif
  if (HIT) put_hit_rows(p, l, s);
  pu(p, U_RNGX, l) = s.rngx;
  pu(p, U_RNGY, l) = s.rngy;
  pu(p, U_FLAGS, l) = s.flags;
}

// the trace phase's lane: it reads the ray and writes the flags, and the
// hit where it found one (a miss keeps the last hit, as the plain
// version's)
template <class C>
__device__ __forceinline__ void trace_lane(const Tables& tb, const Pool& p,
                                           int l, bool prim, C& cx) {
  St s;
  s.o = {pf(p, 0, l), pf(p, 1, l), pf(p, 2, l)};
  s.d = {pf(p, 3, l), pf(p, 4, l), pf(p, 5, l)};
  s.flags = pu(p, U_FLAGS, l);
  stage_trace(tb, s, prim, cx);
  pu(p, U_FLAGS, l) = s.flags;
  if (!dead(s)) put_hit_rows(p, l, s);
}

// The lanes [0, m) of the pool sorted by class (cls_of(l), -1 for none)
// into p.list, class by class, by warp vote and shared counters; returns
// how many were listed.  Every thread of the block calls it (it holds
// barriers), and every warp runs the same trip count (P % BLOCK == 0).
template <class F>
__device__ int build_lists(const Pool& p, int m, F cls_of) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < N_CLASSES) p.hist[tid] = 0;
  __syncthreads();
  for (int l = tid; l < p.P; l += BLOCK) {
    const int c = l < m ? cls_of(l) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, c);
    const int leader = __ffs(peers) - 1;
    int first = 0;
    if (c >= 0 && lane == leader) first = atomicAdd(p.hist + c, __popc(peers));
    first = __shfl_sync(0xffffffffu, first, leader);
    p.cls[l] = static_cast<signed char>(c);
    p.rank[l] = static_cast<unsigned short>(
        first + __popc(peers & ((1u << lane) - 1u)));
  }
  __syncthreads();
  if (tid == 0) {
    int a = 0;
    for (int c = 0; c < N_CLASSES; ++c) {
      p.off[c] = a;
      a += p.hist[c];
    }
    p.off[N_CLASSES] = a;
  }
  __syncthreads();
  for (int l = tid; l < m; l += BLOCK) {
    const int c = p.cls[l];
    if (c >= 0)
      p.list[p.off[c] + p.rank[l]] = static_cast<unsigned short>(l);
  }
  __syncthreads();
  return p.off[N_CLASSES];
}

__device__ __forceinline__ bool dead_at(const Pool& p, int l) {
  return (pu(p, U_FLAGS, l) & FLAG_IS_DEAD) != 0;
}

// a live lane's class: the material kind of its hit
__device__ __forceinline__ int shade_class(const Tables& tb, const Pool& p,
                                           int l) {
  const uint32_t flags = pu(p, U_FLAGS, l);
  if (flags & FLAG_IS_DEAD) return -1;
  const uint32_t mid = flags & 0x00FFFFFFu;
  return mat_class(
      __ldg(tb.mat + (mid < 127u ? mid : 127u) * (MF_NROWS / 4)).x);
}

// this block's pools: a contiguous range, balanced to within one pool
__device__ __forceinline__ void pool_range(int n, int P, int& p0, int& p1) {
  const long long pools = (n + P - 1) / P;
  p0 = static_cast<int>(pools * blockIdx.x / gridDim.x);
  p1 = static_cast<int>(pools * (blockIdx.x + 1) / gridDim.x);
}

// a thread's walk stack: its slice of the block's in shared memory
// (CHIP), or `local`
template <bool CHIP>
__device__ __forceinline__ Ctx<CHIP> ctx_of(const Layout& L, char* sm,
                                           Entry* local) {
  Ctx<CHIP> cx;
  cx.stack =
      CHIP ? reinterpret_cast<Entry*>(sm + L.stack) + threadIdx.x : local;
  return cx;
}

// The fixed chain.  With several material kinds it runs over a block's
// pools: every lane starts its sample, then each bounce traces the live
// lanes and shades the hit ones class by class (a dead lane leaves the
// lists), then every lane contributes.  A variant with one material kind
// (the GLTF box's) has nothing to regroup, and measured slower pooled
// (scripts/k1_measure.py, variant `pooled`): there one thread runs one
// lane's whole sample in registers, one lane a thread of a full grid.
template <int IT, int MT, bool ENV, bool CHIP>
__global__ void __launch_bounds__(BLOCK, SAMPLE_MIN_BLOCKS)
mega_sample_kernel(Tables tg, Layout lay, const float* __restrict__ xy,
                   const long long* __restrict__ su_in, int depth, int n,
                   float* __restrict__ contrib, long long* __restrict__ su_out) {
  extern __shared__ float4 smem[];
  char* sm = reinterpret_cast<char*>(smem);
  const Tables tb = tables_on_chip(tg, lay, sm);
  Entry local[CHIP ? 1 : MEGA_STACK];
  auto cx = ctx_of<CHIP>(lay, sm, local);
  const int nb = n_bounces<IT>(depth);
  if constexpr (N_KINDS <= 1) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i < n) {
      St s;
      s.rngx = (uint32_t)su_in[i];
      s.rngy = (uint32_t)su_in[n + i];
      stage_init(tb, xy[i], xy[n + i], s);
      for (int b = 0; b < nb && !dead(s); ++b) {
        stage_trace(tb, s, b == 0, cx);
        if (!dead(s)) shade_hit<IT, MT>(tb, s, b == 0, cx);
      }
      V4 c = env_contribute<IT, ENV>(tb, s);
      contrib[i] = c.x;
      contrib[n + i] = c.y;
      contrib[2 * n + i] = c.z;
      contrib[3 * n + i] = c.w;
      su_out[i] = s.rngx;
      su_out[n + i] = s.rngy;
      su_out[2 * n + i] = s.flags;
    }
  } else {
    const Pool pl = pool_of(lay, sm, SAMPLE_POOL);
    int p0, p1;
    pool_range(n, SAMPLE_POOL, p0, p1);
    for (int p = p0; p < p1; ++p) {
      const int base = p * SAMPLE_POOL, m = min(SAMPLE_POOL, n - base);
      for (int l = threadIdx.x; l < m; l += BLOCK) {
        const int i = base + l;
        St s;
        s.rngx = (uint32_t)su_in[i];
        s.rngy = (uint32_t)su_in[n + i];
        stage_init(tb, xy[i], xy[n + i], s);
        put_st(pl, l, s);
      }
      __syncthreads();
      for (int b = 0; b < nb; ++b) {
        // every lane lives at the first bounce: no list
        const int live = b == 0 ? m : build_lists(pl, m, [&](int l) {
          return dead_at(pl, l) ? -1 : 0;
        });
        if (live == 0) break;
        for (int j = threadIdx.x; j < live; j += BLOCK)
          trace_lane(tb, pl, b == 0 ? j : pl.list[j], b == 0, cx);
        __syncthreads();
        const int hits =
            build_lists(pl, m, [&](int l) { return shade_class(tb, pl, l); });
        for (int j = threadIdx.x; j < hits; j += BLOCK) {
          const int l = pl.list[j];
          St s;
          get_st(pl, l, s);
          shade_hit<IT, MT>(tb, s, b == 0, cx);
          put_st<false>(pl, l, s);
        }
        __syncthreads();
      }
      for (int l = threadIdx.x; l < m; l += BLOCK) {
        const int i = base + l;
        St s;
        get_st(pl, l, s);
        V4 c = env_contribute<IT, ENV>(tb, s);
        contrib[i] = c.x;
        contrib[n + i] = c.y;
        contrib[2 * n + i] = c.z;
        contrib[3 * n + i] = c.w;
        su_out[i] = s.rngx;
        su_out[n + i] = s.rngy;
        su_out[2 * n + i] = s.flags;
      }
      __syncthreads();
    }
  }
  HC3_FLUSH(cx);
}

// `k` regen iterations of one lane a thread, the lane in registers: a
// variant with one material kind, which has nothing to regroup (pooled,
// scripts/k1_measure.py variant `pooled`, it measured slower: the walk
// takes a third of the time, and the barriers around it cost more than
// the stages' regrouping saves)
template <int IT, int MT, bool ENV, class C>
__device__ __forceinline__ void regen_lane(
    const Tables& tb, const float* __restrict__ xy,
    const float* __restrict__ sf, const long long* __restrict__ su,
    int first, int k, uint32_t nb, int n, float* __restrict__ sf_out,
    long long* __restrict__ su_out, C& cx) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const float xs = xy[i], ys = xy[n + i];
  constexpr int A = RF_NROWS - 4;
  St s;
  V4 acc;
  uint32_t ndone, bcnt;
  if (first) {                          // rfirst
    s.rngx = (uint32_t)su[i];
    s.rngy = (uint32_t)su[n + i];
    stage_init(tb, xs, ys, s);
    stage_trace(tb, s, true, cx);
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
#if HC3_SPECTRAL
#pragma unroll
    for (int j = 0; j < 4; ++j) s.lam[j] = R(26 + j);
#endif
    acc = {R(A), R(A + 1), R(A + 2), R(A + 3)};
#undef R
    s.rngx = (uint32_t)su[i];
    s.rngy = (uint32_t)su[n + i];
    s.flags = (uint32_t)su[2 * n + i];
    ndone = (uint32_t)su[3 * n + i];
    bcnt = (uint32_t)su[4 * n + i];
  }
  for (int it = 0; it < k; ++it) {
    // flush a lane dead at the last trace and restart its pixel, or shade,
    // truncate at the depth and flush a path that died; then trace
    bool flush = dead(s);
    if (!flush) {
      shade_hit<IT, MT>(tb, s, bcnt == 0u, cx);
      ++bcnt;
      if (bcnt >= nb) s.flags |= FLAG_IS_DEAD;
      flush = dead(s);
    }
    if (flush) {
      V4 c = env_contribute<IT, ENV>(tb, s);
      acc = {acc.x + c.x, acc.y + c.y, acc.z + c.z, acc.w + c.w};
      ++ndone;
      stage_init(tb, xs, ys, s);
      bcnt = 0u;
    }
    stage_trace(tb, s, bcnt == 0u, cx);
  }
  const float vals[RF_NROWS] = {
      s.o.x, s.o.y, s.o.z, s.d.x, s.d.y, s.d.z,
      s.accum.x, s.accum.y, s.accum.z, s.accum.w,
      s.thr.x, s.thr.y, s.thr.z, s.thr.w, s.mis_pdf, s.mis_ior,
      s.hit_pos.x, s.hit_pos.y, s.hit_pos.z,
      s.hit_norm.x, s.hit_norm.y, s.hit_norm.z,
      s.hit_u, s.hit_v, s.hit_dist, s.hit_lgt,
#if HC3_SPECTRAL
      s.lam[0], s.lam[1], s.lam[2], s.lam[3],
#endif
      acc.x, acc.y, acc.z, acc.w};
#pragma unroll
  for (int j = 0; j < RF_NROWS; ++j) sf_out[(size_t)j * n + i] = vals[j];
  const uint32_t uvals[RU_NROWS] = {s.rngx, s.rngy, s.flags, ndone, bcnt};
#pragma unroll
  for (int j = 0; j < RU_NROWS; ++j) su_out[(size_t)j * n + i] = uvals[j];
}

// `k` regen iterations over a block's pools.  Each iteration shades the
// live lanes class by class (truncating at the depth), then flushes and
// restarts the dead ones (dead at the last trace, or by this shade), then
// traces every lane: a lane's own steps in the plain version's order.  (A
// lane's trace run at once after its shade or restart, in the same phase,
// measured 10-20% slower.)
template <int IT, int MT, bool ENV, bool CHIP>
__global__ void __launch_bounds__(BLOCK, REGEN_MIN_BLOCKS)
mega_regen_kernel(Tables tg, Layout lay, const float* __restrict__ xy,
                  const float* __restrict__ sf, const long long* __restrict__ su,
                  int first, int k, int depth, int n,
                  float* __restrict__ sf_out, long long* __restrict__ su_out) {
  extern __shared__ float4 smem[];
  char* sm = reinterpret_cast<char*>(smem);
  const Tables tb = tables_on_chip(tg, lay, sm);
  Entry local[CHIP ? 1 : MEGA_STACK];
  auto cx = ctx_of<CHIP>(lay, sm, local);
  constexpr int A = RF_NROWS - 4;       // the accumulator's first row
  const uint32_t nb = (uint32_t)n_bounces<IT>(depth);
  if constexpr (N_KINDS <= 1) {
    regen_lane<IT, MT, ENV>(tb, xy, sf, su, first, k, nb, n, sf_out, su_out,
                            cx);
    HC3_FLUSH(cx);
    return;
  }
  const Pool pl = pool_of(lay, sm, REGEN_POOL);
  int p0, p1;
  pool_range(n, REGEN_POOL, p0, p1);
  for (int p = p0; p < p1; ++p) {
    const int base = p * REGEN_POOL, m = min(REGEN_POOL, n - base);
    for (int l = threadIdx.x; l < m; l += BLOCK) {
      const int i = base + l;
      if (first) {                      // rfirst: start, then trace below
        St s;
        s.rngx = (uint32_t)su[i];
        s.rngy = (uint32_t)su[n + i];
        stage_init(tb, xy[i], xy[n + i], s);
        put_st(pl, l, s);
#pragma unroll
        for (int j = 0; j < 4; ++j) pf(pl, A + j, l) = 0.0f;
        pu(pl, U_NDONE, l) = 0u;
        pu(pl, U_BCNT, l) = 0u;
      } else {
#pragma unroll
        for (int j = 0; j < RF_NROWS; ++j)
          pf(pl, j, l) = sf[(size_t)j * n + i];
#pragma unroll
        for (int j = 0; j < RU_NROWS; ++j)
          pu(pl, j, l) = (uint32_t)su[(size_t)j * n + i];
      }
    }
    __syncthreads();
    for (int it = first ? -1 : 0; it < k - (first ? 1 : 0); ++it) {
      if (it >= 0) {
        // 1. shade the live lanes by class; truncate at the depth
        const int hits =
            build_lists(pl, m, [&](int l) { return shade_class(tb, pl, l); });
        for (int j = threadIdx.x; j < hits; j += BLOCK) {
          const int l = pl.list[j];
          St s;
          get_st(pl, l, s);
          const uint32_t bc = pu(pl, U_BCNT, l);
          shade_hit<IT, MT>(tb, s, bc == 0u, cx);
          if (bc + 1u >= nb) s.flags |= FLAG_IS_DEAD;
          put_st<false>(pl, l, s);
          pu(pl, U_BCNT, l) = bc + 1u;
        }
        __syncthreads();
        // 2. flush every dead lane's sample and restart its pixel
        const int dead_n =
            build_lists(pl, m, [&](int l) { return dead_at(pl, l) ? 0 : -1; });
        for (int j = threadIdx.x; j < dead_n; j += BLOCK) {
          const int l = pl.list[j], i = base + l;
          St s;
          get_st(pl, l, s);
          V4 c = env_contribute<IT, ENV>(tb, s);
          pf(pl, A, l) = pf(pl, A, l) + c.x;
          pf(pl, A + 1, l) = pf(pl, A + 1, l) + c.y;
          pf(pl, A + 2, l) = pf(pl, A + 2, l) + c.z;
          pf(pl, A + 3, l) = pf(pl, A + 3, l) + c.w;
          pu(pl, U_NDONE, l) = pu(pl, U_NDONE, l) + 1u;
          stage_init(tb, xy[i], xy[n + i], s);
          put_st(pl, l, s);
          pu(pl, U_BCNT, l) = 0u;
        }
        __syncthreads();
      }
      // 3. trace every lane (all live now)
      for (int l = threadIdx.x; l < m; l += BLOCK)
        trace_lane(tb, pl, l, pu(pl, U_BCNT, l) == 0u, cx);
      __syncthreads();
    }
    for (int l = threadIdx.x; l < m; l += BLOCK) {
      const int i = base + l;
#pragma unroll
      for (int j = 0; j < RF_NROWS; ++j)
        sf_out[(size_t)j * n + i] = pf(pl, j, l);
#pragma unroll
      for (int j = 0; j < RU_NROWS; ++j)
        su_out[(size_t)j * n + i] = pu(pl, j, l);
    }
    __syncthreads();
  }
  HC3_FLUSH(cx);
}

// the pack's tables as the kernels take them, in device memory (the kernels
// copy what fits on chip)
inline Tables tables(const void* const* t, const int* dims) {
  Tables tb{};
  tb.nodes = static_cast<const float4*>(t[0]);
  tb.rows = static_cast<const float4*>(t[1]);
  tb.index = static_cast<const int*>(t[2]);
  tb.shade = static_cast<const float*>(t[3]);
  tb.mat = static_cast<const float4*>(t[4]);
  tb.light = static_cast<const float4*>(t[5]);
  tb.tex = static_cast<const float*>(t[6]);
  tb.consts = static_cast<const float*>(t[7]);
  tb.texels = static_cast<const float4*>(t[8]);
  tb.n_texels = dims[1];
  tb.textured = dims[2];
#if HC3_SPECTRAL
  tb.spd = static_cast<const float*>(t[9]);
  tb.spd_off = static_cast<const int*>(t[10]);
  tb.cie = static_cast<const float4*>(t[11]);
#endif
  return tb;
}

// the variant this library holds
constexpr int V_IT = HC3_INTEGRATOR, V_MT = HC3_MTYPES;
constexpr bool V_ENV = HC3_ENV != 0;
static_assert(V_IT >= INTEGRATOR_NAIVE && V_IT <= INTEGRATOR_MIS,
              "HC3_INTEGRATOR: 0, 1 or 2");
static_assert(SAMPLE_POOL % BLOCK == 0 && SAMPLE_POOL <= 65535 &&
                  REGEN_POOL % BLOCK == 0 && REGEN_POOL <= 65535,
              "a pool holds a multiple of BLOCK lanes");

// the pool rows of each entry point: the fixed chain keeps no accumulator,
// sample count or bounce count; a variant with one material kind no pool
constexpr int SAMPLE_NF = RF_NROWS - 4, SAMPLE_NU = 3;

inline Layout sample_layout(const int* dims) {
  return layout_of(dims, SAMPLE_NF, SAMPLE_NU, N_KINDS > 1 ? SAMPLE_POOL : 0);
}
inline Layout regen_layout(const int* dims) {
  return layout_of(dims, RF_NROWS, RU_NROWS, N_KINDS > 1 ? REGEN_POOL : 0);
}

// Blocks the card holds at once of `kernel` at `bytes` of shared memory
// a block (after allowing them), and the persistent grid: that many blocks
// on every SM, at most one a pool.
template <class K>
cudaError_t occupancy(K kernel, int bytes, int& per_sm, int& sms) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  int dev;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK,
                                                       bytes);
}

// (a layout without a pool: one lane a thread, every lane its thread)
template <class K>
cudaError_t grid_of(K kernel, const Layout& L, int n, int& grid) {
  int per_sm = 0, sms = 0;
  cudaError_t e = occupancy(kernel, L.bytes, per_sm, sms);
  if (e != cudaSuccess) return e;
  if (L.pool == 0) {
    grid = (n + BLOCK - 1) / BLOCK;
    return cudaSuccess;
  }
  const int pools = (n + L.pool - 1) / L.pool;
  const int resident = (per_sm > 1 ? per_sm : 1) * sms;
  grid = pools < resident ? pools : resident;
  return cudaSuccess;
}

// the launch of `kernel` (the on-chip instantiation K or the device-memory
// one KL, by the layout) with `args`
template <class K, class KL, class... A>
int launch(K kernel, KL kernel_local, const Layout& L, int n, void* stream,
           A... args) {
  int grid = 0;
  cudaError_t e = L.chip ? grid_of(kernel, L, n, grid)
                               : grid_of(kernel_local, L, n, grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (L.chip)
    kernel<<<grid, BLOCK, L.bytes, static_cast<cudaStream_t>(stream)>>>(
        args...);
  else
    kernel_local<<<grid, BLOCK, L.bytes, static_cast<cudaStream_t>(stream)>>>(
        args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tables, in this order: nodes, rows, index (the pack's wide BVH,
// accel/wide_bvh.py, whose walk needs dims[0] entries of stack a lane:
// refused beyond MEGA_STACK), shade, mat, light, tex, consts, texels (the
// pack's other tables, models/megakernel.py); a spectral build's then spd,
// spd_off, cie.  dims: that stack need, the texel count, textured, the wide
// nodes, the real triangles (layout_of).  A launch the card refuses (too
// much shared memory) returns its error and runs nothing.
extern "C" int hc3_mega_sample(const void* const* tabs, const int* dims,
                               const void* xy, const void* su_in, int depth,
                               int n, void* contrib, void* su_out,
                               void* stream) {
  if (dims[0] < 0 || dims[0] > MEGA_STACK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Layout L = sample_layout(dims);
  return launch(mega_sample_kernel<V_IT, V_MT, V_ENV, true>,
                mega_sample_kernel<V_IT, V_MT, V_ENV, false>, L, n, stream,
                tables(tabs, dims), L, static_cast<const float*>(xy),
                static_cast<const long long*>(su_in), depth, n,
                static_cast<float*>(contrib),
                static_cast<long long*>(su_out));
}

extern "C" int hc3_mega_regen(const void* const* tabs, const int* dims,
                              const void* xy, const void* sf_in,
                              const void* su_in, int first, int k, int depth,
                              int n, void* sf_out, void* su_out,
                              void* stream) {
  if (dims[0] < 0 || dims[0] > MEGA_STACK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Layout L = regen_layout(dims);
  return launch(mega_regen_kernel<V_IT, V_MT, V_ENV, true>,
                mega_regen_kernel<V_IT, V_MT, V_ENV, false>, L, n, stream,
                tables(tabs, dims), L, static_cast<const float*>(xy),
                static_cast<const float*>(sf_in),
                static_cast<const long long*>(su_in), first, k, depth, n,
                static_cast<float*>(sf_out), static_cast<long long*>(su_out));
}

#ifdef HC3_COUNT
extern "C" int hc3_mega_counts_reset() {
  unsigned long long zero[N_COUNTS] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_counts, zero, sizeof(zero)));
}

// out: N_COUNTS x u64 on the host (Woop tests, child-box tests, then shades
// of GLTF, diffuse, conductor, dielectric, glass and light-source hits);
// waits for the launches before it
extern "C" int hc3_mega_counts_read(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_counts, N_COUNTS * sizeof(unsigned long long)));
}
#endif

// what hc3_mega_attrs reports of one instantiation
template <class K>
int attrs_of(K kernel, const Layout* L, int pool, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = out[5] = 0;
  out[4] = pool;
  if (L != nullptr) {
    int sms = 0;
    e = occupancy(kernel, L->bytes, out[3], sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[2] += L->bytes;
    out[5] = L->chip;
  }
  return 0;
}

// Kernel `which` (0: mega_sample_kernel, 1: mega_regen_kernel): out[0]
// registers a thread, out[1] local bytes a thread (spills, and the walk's
// stack where a pack's goes to local memory), out[4] lanes a pool, and for
// the pack of `dims` (none: the static figures only) out[2] shared bytes a
// block, out[3] blocks an SM holds, out[5] 1 when its layout is on chip
// (geometry and walk stacks in shared memory)
extern "C" int hc3_mega_attrs(int which, const int* dims, int* out) {
  Layout L{};
  L.chip = 1;
  L.pool = N_KINDS <= 1 ? 0 : which == 0 ? SAMPLE_POOL : REGEN_POOL;
  if (dims != nullptr)
    L = which == 0 ? sample_layout(dims) : regen_layout(dims);
  const Layout* lp = dims != nullptr ? &L : nullptr;
  if (which == 0)
    return L.chip
               ? attrs_of(mega_sample_kernel<V_IT, V_MT, V_ENV, true>, lp,
                          L.pool, out)
               : attrs_of(mega_sample_kernel<V_IT, V_MT, V_ENV, false>, lp,
                          L.pool, out);
  return L.chip
             ? attrs_of(mega_regen_kernel<V_IT, V_MT, V_ENV, true>, lp,
                        L.pool, out)
             : attrs_of(mega_regen_kernel<V_IT, V_MT, V_ENV, false>, lp,
                        L.pool, out);
}
