// Fused per-bounce kernels for Hopper: the hit record, shading plus the
// path-carry update, and the VJP of each.
//
// Replace the TPU kernels _hitrec_kernel (sexy_raytracer_tpu/ops/fused.py:442,
// math hitrec_math :141), _shade_kernel (fused.py:501, math shade_carry_math
// :271), _hitrec_bwd_kernel (fused.py:446) and _shade_bwd_kernel
// (fused.py:505). The row maps (NHF/NHO, SF_*/NSI/NSO) are the JAX package's;
// a stack is [K, R] row-major with rays contiguous, the TPU's [K, RB, 128]
// flattened. Every row read and written is a coalesced 4-byte access across
// a warp.
//
// What bounds each on an H100 80GB HBM3 at 700 W, beside a kernel that only
// streams the same stacks in the first kernels' launch shape
// (stack_copy_kernel, the copy floor; PERF.md):
//  * The hit record (hitrec_kernel) is bound by device memory, 34 rows read
//    and 16 written a ray. The TPU kernel computes the triangle and the
//    sphere branch on every lane and selects, as a vector machine must;
//    here each lane computes only the branch it keeps (hit_out), with the
//    same operations, so the bits are the select's. One thread a ray runs
//    at the copy floor; kernel 4's staged ring was no faster.
//  * Shading (shade_staged_kernel) is bound by device memory: 81 rows read
//    and 16 written a ray against a few hundred float32 operations. One
//    thread a ray took 0.081 ms on the frame chunk, where the copy floor
//    takes 0.068: at 94 registers a quarter of the warps were resident,
//    and each load waited in its ray's chain of sin, exp2 and divides. The
//    staged kernel takes the loads out of that chain: persistent blocks, a
//    producer lane that bulk-copies a tile's row segments into a ring of
//    shared-memory stages (the copy engine, no registers), and consumer
//    threads that shade one ray each from shared memory while the next
//    tile lands; it runs at the copy floor.
//  * The shade VJP (shade_bwd_kernel) is bound by its chain of dependent
//    operations, a few thousand a ray: one thread a ray at 168 registers
//    (one 256-thread block an SM, its 75 sums in local memory) took 1.7x
//    the copy floor. Each one-warp block now stages its 32-ray tile in
//    shared memory with one bulk copy, sums in its rays' columns there,
//    and is capped at 128 registers, so 16 warps fit on an SM; a ray with
//    no hit skips the forward (shade_bwd_pass): at the last bounce nearly
//    every warp holds no hit.
//  * The hit record's VJP (hitrec_bwd_kernel) runs one thread a ray within
//    15% of the copy floor.
//
// Forward. hit_fwd and shade_fwd are line-by-line transcriptions of the JAX
// math, in the same evaluation order. The library is built with -fmad=false
// and without fast math, so with the same inputs a kernel matches its plain
// PyTorch version (sexy_raytracer_tpu_torch/ops/fused.py) up to the last bit
// of sinf, exp2f and powf, which both call from the same CUDA math library.
//
// Backward. The TPU kernels run jax.vjp inside the kernel body and save no
// intermediates. The backward kernels here do the same by hand: each thread
// re-runs hit_fwd / shade_fwd for its ray (the forward intermediates stay in
// registers; both read their rows through a Plane, device or shared
// memory), then walks the adjoint in reverse, summing each input's
// cotangent in a fixed order. The adjoint keeps JAX's derivative
// conventions:
//   * a select sends its cotangent to the branch that was taken only, so the
//     sphere solve on a triangle lane never leaks into the result;
//   * jnp.maximum/minimum/clip split a tie half and half (dmaxn, dminn);
//   * the guards keep their derivatives: safe_sqrt's clamp, the 1e-20 floor
//     of the inverse distances, vunit's zero-length pass-through, inv_f's
//     f == 0 guard, the GGX 1e-12 denominator;
//   * stop-gradient rows (the triangle uv outputs; alive, front, hit and the
//     random draws of the shade stack; the 0/1 flags) get a zero cotangent.
//
// max/min/clip below propagate NaN like jnp.maximum/minimum/clip, not like
// fmaxf/fminf, so that a NaN produced upstream is not silently hidden.

#include <cuda_runtime.h>

#include <cstdint>

#include "pipeline.cuh"

namespace {

constexpr float EPS = 1.1920928955078125e-07f;  // FLT_EPSILON
constexpr double PI_D = 3.1415926535897932385;
constexpr float PI_F = (float)PI_D;
constexpr float LN2_F = 0.693147180559945309f;
constexpr int MAT_PBR = 0, MAT_METAL = 1, MAT_DIELECTRIC = 2, MAT_LIGHT = 3;
constexpr int NHF = 34, NHO = 16, NSF = 75, NSI = 6, NSO = 16;
constexpr int GF = 27, PK = 57;  // shade-stack rows of gf[0] and pack[0]
// threads a block of the kernels that run one thread a ray
constexpr int THREADS = 256;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ float vdot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 vadd(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 vscale(float s, V3 v) {
  return {s * v.x, s * v.y, s * v.z};
}
__device__ __forceinline__ V3 vmul(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 vneg(V3 v) { return {-v.x, -v.y, -v.z}; }
__device__ __forceinline__ V3 vcross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 vwhere(bool m, V3 a, V3 b) { return m ? a : b; }

// NaN-propagating max/min/clip (jnp semantics)
__device__ __forceinline__ float maxn(float x, float c) { return x < c ? c : x; }
__device__ __forceinline__ float minn(float x, float c) { return x > c ? c : x; }
__device__ __forceinline__ float clipn(float x, float lo, float hi) {
  return minn(maxn(x, lo), hi);
}
// their derivatives in x, with jnp's tie rule: half the cotangent each
__device__ __forceinline__ float dmaxn(float x, float c) {
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}
__device__ __forceinline__ float dminn(float x, float c) {
  return x < c ? 1.0f : (x == c ? 0.5f : 0.0f);
}
__device__ __forceinline__ float dclipn(float x, float lo, float hi) {
  return dmaxn(x, lo) * dminn(maxn(x, lo), hi);
}

__device__ __forceinline__ float safe_sqrt(float x) {
  return sqrtf(maxn(x, (float)1e-24));
}
// mathx.unit_vector semantics: zero length passes through unchanged
__device__ __forceinline__ V3 vunit(V3 v) {
  float len2 = vdot(v, v);
  float inv = 1.0f / safe_sqrt(len2);
  return len2 == 0.0f ? v : vscale(inv, v);
}
__device__ __forceinline__ V3 vreflect(V3 v, V3 n) {
  return vsub(v, vscale(2.0f * vdot(v, n), n));
}
__device__ __forceinline__ V3 vrefract(V3 uv, V3 n, float ratio) {
  float cos_theta = minn(vdot(n, vneg(uv)), 1.0f);
  V3 perp = vscale(ratio, vadd(uv, vscale(cos_theta, n)));
  V3 par = vscale(-safe_sqrt(fabsf(1.0f - vdot(perp, perp))), n);
  return vadd(perp, par);
}

// ---- adjoints of the helpers: cotangents of the inputs given g ----------

// d safe_sqrt(x) / dx
__device__ __forceinline__ float dsafe_sqrt(float x) {
  return (0.5f / safe_sqrt(x)) * dmaxn(x, (float)1e-24);
}
__device__ __forceinline__ V3 vunit_bwd(V3 v, V3 g) {
  float len2 = vdot(v, v);
  if (len2 == 0.0f) return g;
  float s = safe_sqrt(len2);
  float inv = 1.0f / s;
  float g_len2 = (-vdot(g, v) / (s * s)) * dsafe_sqrt(len2);
  return vadd(vscale(inv, g), vscale(2.0f * g_len2, v));
}
// c = a x b: a gets b x g, b gets g x a
__device__ __forceinline__ void vcross_bwd(V3 a, V3 b, V3 g, V3& ga, V3& gb) {
  ga = vadd(ga, vcross(b, g));
  gb = vadd(gb, vcross(g, a));
}
__device__ __forceinline__ void vreflect_bwd(V3 v, V3 n, V3 g, V3& gv,
                                             V3& gn) {
  float k = 2.0f * vdot(v, n);
  float gk = -vdot(g, n);
  gv = vadd(gv, vadd(g, vscale(2.0f * gk, n)));
  gn = vadd(gn, vsub(vscale(2.0f * gk, v), vscale(k, g)));
}
// returns the cotangent of ratio
__device__ __forceinline__ float vrefract_bwd(V3 uv, V3 n, float ratio, V3 g,
                                              V3& guv, V3& gn) {
  float x = vdot(n, vneg(uv));
  float cos_theta = minn(x, 1.0f);
  V3 w = vadd(uv, vscale(cos_theta, n));
  V3 perp = vscale(ratio, w);
  float one_pp = 1.0f - vdot(perp, perp);
  float sq = safe_sqrt(fabsf(one_pp));
  // out = perp - sq n
  gn = vsub(gn, vscale(sq, g));
  float g_abs = -vdot(g, n) * dsafe_sqrt(fabsf(one_pp));
  float sgn = one_pp > 0.0f ? 1.0f : (one_pp < 0.0f ? -1.0f : 0.0f);
  V3 g_perp = vadd(g, vscale(-2.0f * g_abs * sgn, perp));
  float g_ratio = vdot(g_perp, w);
  V3 g_w = vscale(ratio, g_perp);
  float g_x = vdot(g_w, n) * dminn(x, 1.0f);
  guv = vadd(guv, vsub(g_w, vscale(g_x, n)));
  gn = vadd(gn, vsub(vscale(cos_theta, g_w), vscale(g_x, uv)));
  return g_ratio;
}

// Row k, ray r of a [K, n] stack: device memory, or a stage of it in
// shared memory. Not __restrict__: the shade VJP sums into the shared rows
// it reads (the kernels' own pointer arguments carry __restrict__)
template <typename T>
struct Plane {
  const T* p;
  int n;
  __device__ __forceinline__ T operator()(int k, int r) const {
    return p[(size_t)k * n + r];
  }
};
using Rows = Plane<float>;
using IRows = Plane<int>;

__device__ __forceinline__ V3 row3(const Rows& F, int k, int r) {
  return v3(F(k, r), F(k + 1, r), F(k + 2, r));
}

// ---------------------------------------------------------------------------
// hit record
// ---------------------------------------------------------------------------

// hitrec_math (fused.py:141-246) for one ray, with the intermediates the
// adjoint reads
struct HitFwd {
  V3 org, dr, v0, v1, v2, c0, c1;
  float time, uv0x, uv0y, uv1x, uv1y, uv2x, uv2y, st0, st1, srad, t_min;
  bool is_tri;
  // triangle
  V3 e0, e1, n3, p_t, outward_t, tan_in, bit_in, tangent_t, bitangent_t;
  float ndir, d, safe, num, t_t, u_t, v_t, duv0x, duv0y, duv1x, duv1y, f,
      inv_f;
  bool front_t;
  // sphere
  bool moving, first;
  V3 center, oc, p_s, q, outward_s, bpole, tc, tangent_s, bc, bitangent_s;
  float sdenom, frac, a, half_b, cterm, disc, sqrtd, safe_a, root0, root1,
      t_s;
  bool front_s;
};

// The ray, its triangle's rows and whether the lane keeps the triangle
__device__ __forceinline__ void hit_rows_tri(const Rows& F, int r,
                                             HitFwd& h) {
  h.org = row3(F, 0, r);
  h.dr = row3(F, 3, r);
  h.v0 = row3(F, 7, r);
  h.v1 = row3(F, 10, r);
  h.v2 = row3(F, 13, r);
  h.uv0x = F(16, r); h.uv0y = F(17, r);
  h.uv1x = F(18, r); h.uv1y = F(19, r);
  h.uv2x = F(20, r); h.uv2y = F(21, r);
  h.is_tri = F(32, r) > 0.5f;
}

// The ray's time and t_min and its sphere's rows
__device__ __forceinline__ void hit_rows_sphere(const Rows& F, int r,
                                                HitFwd& h) {
  h.time = F(6, r);
  h.c0 = row3(F, 22, r);
  h.c1 = row3(F, 25, r);
  h.st0 = F(28, r); h.st1 = F(29, r); h.srad = F(30, r);
  h.t_min = F(31, r);
}

// The triangle's plane hit, point and interpolated uv: what every lane
// needs (the record's rows 12-13 are the triangle's uv on every lane)
__device__ __forceinline__ void hit_tri_point(HitFwd& h) {
  h.e0 = vsub(h.v1, h.v0);
  h.e1 = vsub(h.v2, h.v0);
  h.n3 = vcross(h.e0, h.e1);
  h.ndir = vdot(h.n3, h.dr);
  h.d = -vdot(h.n3, h.v0);
  h.safe = h.ndir == 0.0f ? -1.0f : h.ndir;
  h.num = vdot(h.n3, h.org) + h.d;
  h.t_t = -h.num / h.safe;
  h.p_t = vadd(h.org, vscale(h.t_t, h.dr));

  auto invdist = [&](V3 v) {
    V3 w = vsub(h.p_t, v);
    float dist = safe_sqrt(vdot(w, w));
    return 1.0f / maxn(dist, (float)1e-20);
  };
  float r0 = invdist(h.v0), r1 = invdist(h.v1), r2 = invdist(h.v2);
  float denom = r0 + r1 + r2;
  r0 = r0 / denom;
  r1 = r1 / denom;
  r2 = r2 / denom;
  h.u_t = r0 * h.uv0x + r1 * h.uv1x + r2 * h.uv2x;
  h.v_t = 1.0f - (r0 * h.uv0y + r1 * h.uv1y + r2 * h.uv2y);
}

// the triangle's normal, facing and tangent frame (after hit_tri_point)
__device__ __forceinline__ void hit_tri_frame(HitFwd& h) {
  h.outward_t = vunit(h.n3);
  h.front_t = vdot(h.dr, h.outward_t) < 0.0f;

  h.duv0x = h.uv1x - h.uv0x; h.duv0y = h.uv1y - h.uv0y;
  h.duv1x = h.uv2x - h.uv0x; h.duv1y = h.uv2y - h.uv0y;
  h.f = h.duv0x * h.duv1y - h.duv1x * h.duv0y;
  h.inv_f = 1.0f / (h.f == 0.0f ? EPS : h.f);
  h.tan_in = vscale(h.inv_f, vsub(vscale(h.duv1y, h.e0), vscale(h.duv0y, h.e1)));
  h.bit_in =
      vscale(h.inv_f, vadd(vscale(-h.duv1x, h.e0), vscale(h.duv0x, h.e1)));
  h.tangent_t = vunit(h.tan_in);
  h.bitangent_t = vunit(h.bit_in);
}

// the sphere's solve, point, normal, facing and tangent frame
__device__ __forceinline__ void hit_sphere(HitFwd& h) {
  h.moving = (h.c0.x != h.c1.x) || (h.c0.y != h.c1.y) || (h.c0.z != h.c1.z);
  h.sdenom = h.st1 == h.st0 ? 1.0f : h.st1 - h.st0;
  h.frac = (h.time - h.st0) / h.sdenom;
  h.center =
      vwhere(h.moving, vadd(h.c0, vscale(h.frac, vsub(h.c1, h.c0))), h.c0);
  h.oc = vsub(h.org, h.center);
  h.a = vdot(h.dr, h.dr);
  h.half_b = vdot(h.oc, h.dr);
  h.cterm = vdot(h.oc, h.oc) - h.srad * h.srad;
  h.disc = h.half_b * h.half_b - h.a * h.cterm;
  h.sqrtd = safe_sqrt(h.disc);
  h.safe_a = h.a == 0.0f ? 1.0f : h.a;
  h.root0 = (-h.half_b - h.sqrtd) / h.safe_a;
  h.root1 = (-h.half_b + h.sqrtd) / h.safe_a;
  h.first = h.root0 >= h.t_min;
  h.t_s = h.first ? h.root0 : h.root1;
  h.p_s = vadd(h.org, vscale(h.t_s, h.dr));
  h.q = vsub(h.p_s, h.center);
  h.outward_s = vunit(h.q);  // no /radius (sphere.h:76)
  h.front_s = vdot(h.dr, h.outward_s) < 0.0f;

  bool near_pole = (1.0f - fabsf(h.outward_s.y)) < EPS;
  h.bpole = near_pole ? v3(0.0f, 0.0f, -1.0f) : v3(0.0f, 1.0f, 0.0f);
  h.tc = vcross(h.bpole, h.outward_s);
  h.tangent_s = vunit(h.tc);
  h.bc = vcross(h.outward_s, h.tangent_s);
  h.bitangent_s = vunit(h.bc);
}

// both branches, for the adjoint (kernel 5)
__device__ __forceinline__ HitFwd hit_fwd(const Rows& F, int r) {
  HitFwd h;
  hit_rows_tri(F, r, h);
  hit_rows_sphere(F, r, h);
  hit_tri_point(h);
  hit_tri_frame(h);
  hit_sphere(h);
  return h;
}

// The hit record of one ray, its [NHO] values: the branch its lane keeps,
// and the triangle's uv. Each value goes through the same operations as in
// hit_fwd, so it has the bits that hitrec_math's select keeps
__device__ __forceinline__ void hit_out(const Rows& F, int r, float* vals) {
  HitFwd h;
  hit_rows_tri(F, r, h);
  hit_tri_point(h);
  V3 p, outward, tangent, bitangent;
  float t;
  bool front;
  if (h.is_tri) {
    hit_tri_frame(h);
    p = h.p_t;
    outward = h.outward_t;
    tangent = h.tangent_t;
    bitangent = h.bitangent_t;
    t = h.t_t;
    front = h.front_t;
  } else {
    hit_rows_sphere(F, r, h);
    hit_sphere(h);
    p = h.p_s;
    outward = h.outward_s;
    tangent = h.tangent_s;
    bitangent = h.bitangent_s;
    t = h.t_s;
    front = h.front_s;
  }
  const V3 normal = vwhere(front, outward, vneg(outward));
  const float v[NHO] = {p.x, p.y, p.z,
                        normal.x, normal.y, normal.z,
                        tangent.x, tangent.y, tangent.z,
                        bitangent.x, bitangent.y, bitangent.z,
                        h.u_t, h.v_t, t, front ? 1.0f : 0.0f};
#pragma unroll
  for (int k = 0; k < NHO; ++k) vals[k] = v[k];
}

// VJP of hitrec_math: [NHF, R] forward stack + [NHO, R] cotangent -> [NHF, R]
__global__ void hitrec_bwd_kernel(const float* __restrict__ hf,
                                  const float* __restrict__ gout, int n,
                                  float* __restrict__ dout) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const HitFwd h = hit_fwd(Rows{hf, n}, r);
  const Rows G{gout, n};
  // rows 12-13 (triangle uv) are stop-gradient, row 15 (front) is a flag
  const V3 gp = row3(G, 0, r), gn = row3(G, 3, r), gtan = row3(G, 6, r),
           gbit = row3(G, 9, r);
  const float gt = G(14, r);
  const V3 z = v3(0.0f, 0.0f, 0.0f);
  V3 g_org = z, g_dr = z, g_v0 = z, g_v1 = z, g_v2 = z, g_c0 = z, g_c1 = z;
  float g_uv0x = 0.0f, g_uv0y = 0.0f, g_uv1x = 0.0f, g_uv1y = 0.0f,
        g_uv2x = 0.0f, g_uv2y = 0.0f, g_time = 0.0f, g_st0 = 0.0f,
        g_st1 = 0.0f, g_srad = 0.0f;

  if (h.is_tri) {
    // p = org + t dr
    g_org = gp;
    float g_t = gt + vdot(gp, h.dr);
    g_dr = vscale(h.t_t, gp);
    // t = -num / safe; safe = ndir unless ndir == 0
    float g_num = -g_t / h.safe;
    float g_safe = g_t * h.num / (h.safe * h.safe);
    float g_ndir = h.ndir == 0.0f ? 0.0f : g_safe;
    // num = n.org + d, d = -n.v0, ndir = n.dr
    V3 g_n = vadd(vsub(vscale(g_num, h.org), vscale(g_num, h.v0)),
                  vscale(g_ndir, h.dr));
    g_org = vadd(g_org, vscale(g_num, h.n3));
    g_v0 = vscale(-g_num, h.n3);
    g_dr = vadd(g_dr, vscale(g_ndir, h.n3));
    // normal = +-vunit(n)
    g_n = vadd(g_n, vunit_bwd(h.n3, h.front_t ? gn : vneg(gn)));
    // tangent = vunit(inv_f A), bitangent = vunit(inv_f B)
    V3 gA = vunit_bwd(h.tan_in, gtan);
    V3 gB = vunit_bwd(h.bit_in, gbit);
    V3 A = vsub(vscale(h.duv1y, h.e0), vscale(h.duv0y, h.e1));
    V3 B = vadd(vscale(-h.duv1x, h.e0), vscale(h.duv0x, h.e1));
    float g_inv_f = vdot(gA, A) + vdot(gB, B);
    gA = vscale(h.inv_f, gA);
    gB = vscale(h.inv_f, gB);
    V3 g_e0 = vsub(vscale(h.duv1y, gA), vscale(h.duv1x, gB));
    V3 g_e1 = vsub(vscale(h.duv0x, gB), vscale(h.duv0y, gA));
    vcross_bwd(h.e0, h.e1, g_n, g_e0, g_e1);  // n = e0 x e1
    float g_duv1y = vdot(gA, h.e0), g_duv0y = -vdot(gA, h.e1);
    float g_duv1x = -vdot(gB, h.e0), g_duv0x = vdot(gB, h.e1);
    // inv_f = 1 / f, unless f == 0 (then the constant EPS)
    float g_f = h.f == 0.0f ? 0.0f : -g_inv_f / (h.f * h.f);
    g_duv0x += g_f * h.duv1y;
    g_duv1y += g_f * h.duv0x;
    g_duv1x -= g_f * h.duv0y;
    g_duv0y -= g_f * h.duv1x;
    g_uv1x = g_duv0x; g_uv1y = g_duv0y;
    g_uv2x = g_duv1x; g_uv2y = g_duv1y;
    g_uv0x = -(g_duv0x + g_duv1x);
    g_uv0y = -(g_duv0y + g_duv1y);
    // e0 = v1 - v0, e1 = v2 - v0
    g_v1 = g_e0;
    g_v2 = g_e1;
    g_v0 = vsub(g_v0, vadd(g_e0, g_e1));
  } else {
    // bitangent = vunit(outward x tangent), tangent = vunit(bpole x outward)
    V3 g_bc = vunit_bwd(h.bc, gbit);
    V3 g_out = h.front_s ? gn : vneg(gn);
    V3 g_tan = gtan;
    vcross_bwd(h.outward_s, h.tangent_s, g_bc, g_out, g_tan);
    V3 g_tc = vunit_bwd(h.tc, g_tan);
    V3 g_bpole = z;
    vcross_bwd(h.bpole, h.outward_s, g_tc, g_bpole, g_out);
    // outward = vunit(p - center), p = org + t dr
    V3 g_q = vunit_bwd(h.q, g_out);
    V3 g_ps = vadd(gp, g_q);
    V3 g_center = vneg(g_q);
    g_org = g_ps;
    float g_ts = gt + vdot(g_ps, h.dr);
    g_dr = vscale(h.t_s, g_ps);
    // t = root0 if root0 >= t_min else root1; roots = (-half_b -+ sqrtd) / a
    float g_r0 = h.first ? g_ts : 0.0f;
    float g_r1 = h.first ? 0.0f : g_ts;
    float g_hb = -(g_r0 + g_r1) / h.safe_a;
    float g_sq = (g_r1 - g_r0) / h.safe_a;
    float g_sa = -(g_r0 * h.root0 + g_r1 * h.root1) / h.safe_a;
    float g_a = h.a == 0.0f ? 0.0f : g_sa;
    // disc = half_b^2 - a cterm
    float g_disc = g_sq * dsafe_sqrt(h.disc);
    g_hb += 2.0f * h.half_b * g_disc;
    g_a -= h.cterm * g_disc;
    float g_ct = -h.a * g_disc;
    // cterm = oc.oc - srad^2, half_b = oc.dr, a = dr.dr
    V3 g_oc = vadd(vscale(2.0f * g_ct, h.oc), vscale(g_hb, h.dr));
    g_srad = -2.0f * h.srad * g_ct;
    g_dr = vadd(g_dr, vadd(vscale(g_hb, h.oc), vscale(2.0f * g_a, h.dr)));
    // oc = org - center
    g_org = vadd(g_org, g_oc);
    g_center = vsub(g_center, g_oc);
    if (h.moving) {
      // center = c0 + frac (c1 - c0), frac = (time - st0) / sdenom
      g_c0 = vsub(g_center, vscale(h.frac, g_center));
      g_c1 = vscale(h.frac, g_center);
      float g_frac = vdot(g_center, vsub(h.c1, h.c0));
      g_time = g_frac / h.sdenom;
      g_st0 = -g_frac / h.sdenom;
      if (h.st1 != h.st0) {
        float g_sden = -g_frac * h.frac / h.sdenom;
        g_st1 = g_sden;
        g_st0 -= g_sden;
      }
    } else {
      g_c0 = g_center;
    }
  }

  const float vals[NHF] = {
      g_org.x, g_org.y, g_org.z, g_dr.x, g_dr.y, g_dr.z, g_time,
      g_v0.x, g_v0.y, g_v0.z, g_v1.x, g_v1.y, g_v1.z, g_v2.x, g_v2.y, g_v2.z,
      g_uv0x, g_uv0y, g_uv1x, g_uv1y, g_uv2x, g_uv2y,
      g_c0.x, g_c0.y, g_c0.z, g_c1.x, g_c1.y, g_c1.z, g_st0, g_st1, g_srad,
      0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < NHF; ++k) dout[(size_t)k * n + r] = vals[k];
}

// ---------------------------------------------------------------------------
// shade + carry update
// ---------------------------------------------------------------------------

// shade_carry_math (fused.py:271-429) for one ray, with the intermediates
// the adjoint reads
struct ShadeFwd {
  V3 org, dr, thr, rad, p, nrm, tan_, bit, ruv, rball, bg;
  bool alive, front, hit, odd;
  int mtype, ak, nk, mk, rk, ek;
  // PBR
  V3 base_rgb, attenuation, nm, world_nm, normal, scatter_in, scatter, view,
      hsum, half, f0, fres, diffuse, spec, pbr_att;
  float m2, m, r2, rr, n_dot_l, n_dot_h, h_dot_v, n_dot_v, alpha2, q, den,
      dterm, hv_lin, power, rp1, k, gaf_l, gaf_v, gterm, sden, sc;
  // metal and dielectric
  V3 ud, met_dir, die_dir;
  float ior, ratio;
  bool do_reflect;
  // result
  V3 emitted, att, sdir;
  bool miss, takes, alive_next;
};

__device__ __forceinline__ ShadeFwd shade_fwd(const Rows& F, const IRows& I,
                                              int r) {
  ShadeFwd s;
  s.org = row3(F, 0, r);
  s.dr = row3(F, 3, r);
  s.thr = row3(F, 6, r);
  s.rad = row3(F, 9, r);
  s.alive = F(12, r) > 0.5f;
  s.p = row3(F, 13, r);
  s.nrm = row3(F, 16, r);
  s.tan_ = row3(F, 19, r);
  s.bit = row3(F, 22, r);
  s.front = F(25, r) > 0.5f;
  s.hit = F(26, r) > 0.5f;
  auto g = [&](int k) { return F(GF + k, r); };
  auto pk = [&](int k) { return F(PK + k, r); };
  s.ruv = row3(F, 65, r);
  s.rball = row3(F, 68, r);
  float runi = F(71, r);
  s.bg = row3(F, 72, r);
  s.mtype = I(0, r); s.ak = I(1, r); s.nk = I(2, r);
  s.mk = I(3, r); s.rk = I(4, r); s.ek = I(5, r);

  s.base_rgb = v3(g(0), g(1), g(2));
  V3 albedo_c0 = v3(g(8), g(9), g(10));
  V3 albedo_c1 = v3(g(11), g(12), g(13));
  V3 emit_rgb = v3(g(14), g(15), g(16));
  V3 emit_c1 = v3(g(17), g(18), g(19));
  V3 normal_c0 = v3(g(24), g(25), g(26));
  V3 normal_c1 = v3(g(27), g(28), g(29));
  const V3 zero3 = v3(0.0f, 0.0f, 0.0f);
  const V3 one3 = v3(1.0f, 1.0f, 1.0f);

  // checker parity shared by every procedural slot (texture.h:42-48)
  s.odd = (sinf(10.0f * s.p.x) * sinf(10.0f * s.p.y) * sinf(10.0f * s.p.z)) <
          0.0f;

  // ---- PBR ----
  V3 checker = vscale(255.0f, vwhere(s.odd, albedo_c1, albedo_c0));
  V3 map_val = vwhere(s.ak == 1, albedo_c0, v3(pk(0), pk(1), pk(2)));
  map_val = vwhere(s.ak == 2, checker, map_val);
  s.attenuation =
      vwhere(s.ak == 0, s.base_rgb, vscale((float)(1.0 / 255.0), map_val));

  V3 nm_val = vwhere(s.nk == 2, vwhere(s.odd, normal_c1, normal_c0),
                     v3(pk(3), pk(4), pk(5)));
  s.nm = vscale(1.0f / 128.0f, vsub(nm_val, v3(128.0f, 128.0f, 128.0f)));
  s.world_nm = vadd(vadd(vscale(s.nm.x, s.tan_), vscale(s.nm.y, s.bit)),
                    vscale(s.nm.z, s.nrm));
  s.normal = vwhere(s.nk != 0, vunit(s.world_nm), s.nrm);

  float metallic = g(4), roughness = g(5);
  float m_ck = s.odd ? g(21) : g(20);
  float m1 = s.mk == 3 ? pk(6) / 255.0f : metallic;
  s.m2 = s.mk == 2 ? m_ck : m1;
  s.m = s.mk == 0 ? metallic : clipn(s.m2, 0.0f, 1.0f);
  float r_ck = s.odd ? g(23) : g(22);
  float r1 = s.rk == 3 ? pk(7) / 255.0f : roughness;
  s.r2 = s.rk == 2 ? r_ck : r1;
  s.rr = s.rk == 0 ? roughness : clipn(s.r2, 0.0f, 1.0f);

  V3 scatter = vadd(s.normal, s.ruv);
  bool degen = (fabsf(scatter.x) < (float)1e-8) &&
               (fabsf(scatter.y) < (float)1e-8) &&
               (fabsf(scatter.z) < (float)1e-8);
  s.scatter_in = vwhere(degen, s.normal, scatter);
  s.scatter = vunit(s.scatter_in);

  s.ud = vunit(s.dr);
  s.view = vneg(s.ud);
  s.hsum = vadd(s.scatter, s.view);
  s.half = vunit(s.hsum);
  s.n_dot_l = maxn(vdot(s.normal, s.scatter), 0.0f);
  s.n_dot_h = maxn(vdot(s.normal, s.half), 0.0f);
  s.h_dot_v = maxn(vdot(s.half, s.view), 0.0f);
  s.n_dot_v = maxn(vdot(s.normal, s.view), 0.0f);

  s.f0 = vadd(vscale(1.0f - s.m, v3((float)0.4, (float)0.4, (float)0.4)),
              vscale(s.m, s.base_rgb));
  s.alpha2 = (s.rr * s.rr) * (s.rr * s.rr);
  s.q = s.n_dot_h * s.n_dot_h * (s.alpha2 - 1.0f) + 1.0f;
  s.den = maxn(PI_F * (s.q * s.q), (float)1e-12);
  s.dterm = s.alpha2 / s.den;
  s.hv_lin = (float)-5.55473 * s.h_dot_v - (float)6.98316;
  s.power = exp2f(s.hv_lin * s.h_dot_v);
  s.fres = vadd(s.f0, vscale(s.power, vsub(one3, s.f0)));
  s.rp1 = s.rr + 1.0f;
  s.k = (s.rp1 * s.rp1) / 8.0f;
  s.gaf_l = s.n_dot_l / (s.n_dot_l * (1.0f - s.k) + s.k);
  s.gaf_v = s.n_dot_v / (s.n_dot_v * (1.0f - s.k) + s.k);
  s.gterm = s.gaf_l * s.gaf_v;

  s.diffuse = vmul(vmul(vscale((float)(1.0 / PI_D), s.attenuation),
                        vsub(one3, s.fres)),
                   vscale(1.0f - s.m, s.base_rgb));
  s.sden = 4.0f * s.n_dot_v * s.n_dot_l + EPS;
  s.sc = s.dterm * s.gterm / s.sden;
  s.spec = vscale(s.sc, s.fres);
  s.pbr_att = vscale(s.n_dot_l, vadd(s.diffuse, s.spec));

  // ---- metal ----
  float fuzz = g(6);
  s.met_dir = vadd(vreflect(s.ud, s.nrm), vscale(fuzz, s.rball));
  bool met_ok = vdot(s.met_dir, s.nrm) > 0.0f;

  // ---- dielectric ----
  s.ior = g(7);
  s.ratio = s.front ? 1.0f / s.ior : s.ior;
  float cos_t = minn(vdot(s.nrm, vneg(s.ud)), 1.0f);
  float sin_t = sqrtf(maxn(1.0f - cos_t * cos_t, 0.0f));
  bool cannot = s.ratio * sin_t > 1.0f;
  float r0q = (1.0f - s.ratio) / (1.0f + s.ratio);
  float r0c = r0q * r0q;
  float x = 1.0f - cos_t;
  float x5 = x * ((x * x) * (x * x));  // lax.integer_pow(x, 5)
  float reflectance = r0c + (1.0f - r0c) * x5;
  s.do_reflect = cannot || (reflectance > runi);
  s.die_dir = vwhere(s.do_reflect, vreflect(s.ud, s.nrm),
                     vrefract(s.ud, s.nrm, s.ratio));

  // ---- diffuseLight emitted ----
  V3 emit_val = vwhere(s.ek == 2, vwhere(s.odd, emit_c1, emit_rgb),
                       vwhere(s.ek == 3, v3(pk(0), pk(1), pk(2)), emit_rgb));
  s.emitted = vwhere(s.mtype == MAT_LIGHT, emit_val, zero3);

  // ---- select by material ----
  V3 att = vwhere(s.mtype == MAT_PBR, s.pbr_att, zero3);
  att = vwhere(s.mtype == MAT_METAL, s.base_rgb, att);
  s.att = vwhere(s.mtype == MAT_DIELECTRIC, one3, att);
  V3 sdir = vwhere(s.mtype == MAT_PBR, s.scatter, s.dr);
  sdir = vwhere(s.mtype == MAT_METAL, s.met_dir, sdir);
  s.sdir = vwhere(s.mtype == MAT_DIELECTRIC, s.die_dir, sdir);
  bool scattered = ((s.mtype == MAT_PBR) || ((s.mtype == MAT_METAL) && met_ok) ||
                    (s.mtype == MAT_DIELECTRIC)) &&
                   s.hit;

  s.miss = s.alive && !s.hit;
  s.takes = s.alive && s.hit;
  s.alive_next = s.alive && s.hit && scattered;
  return s;
}

// the carry update of one ray's shading: its [NSO] output column
__device__ __forceinline__ void shade_out(const ShadeFwd& s, float* vals) {
  const V3 zero3 = v3(0.0f, 0.0f, 0.0f);
  V3 rad = vadd(s.rad, vwhere(s.miss, vmul(s.thr, s.bg), zero3));
  rad = vadd(rad, vwhere(s.takes, vmul(s.thr, s.emitted), zero3));
  V3 thr = vwhere(s.alive_next, vmul(s.thr, s.att), s.thr);
  V3 org = vwhere(s.alive_next, s.p, s.org);
  V3 dr = vwhere(s.alive_next, s.sdir, s.dr);
  const float v[NSO] = {org.x, org.y, org.z, dr.x, dr.y, dr.z,
                        thr.x, thr.y, thr.z, rad.x, rad.y, rad.z,
                        s.alive_next ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < NSO; ++k) vals[k] = v[k];
}

template <int NO>
__device__ __forceinline__ void store_column(const float* vals, float* out,
                                             int n, int r) {
#pragma unroll
  for (int k = 0; k < NO; ++k) out[(size_t)k * n + r] = vals[k];
}

// [NHF, R] -> [NHO, R], one thread a ray, each reading the rows of and
// computing the branch it keeps; at most 64 registers, so that four blocks
// fit on an SM and the train step's 131,072 rays run in one wave
__global__ void __launch_bounds__(THREADS, 4)
hitrec_kernel(const float* __restrict__ hf, int n, float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float vals[NHO];
  hit_out(Rows{hf, n}, r, vals);
  store_column<NHO>(vals, out, n, r);
}

// ---------------------------------------------------------------------------
// staged kernels
// ---------------------------------------------------------------------------

// Bulk-copy tile t's segments (TR words each) of the `rows` rows of a
// [rows, n] stack of 4-byte words into dst, [rows][TR] words of shared
// memory; the bytes complete on bar
template <int TR>
__device__ __forceinline__ void load_rows(void* dst, const void* src,
                                          int rows, int n, int t,
                                          unsigned long long* bar) {
  constexpr unsigned ROW = TR * 4;
  for (int k = 0; k < rows; ++k)
    bulk_load(static_cast<char*>(dst) + (size_t)k * ROW,
              static_cast<const char*>(src) +
                  ((size_t)k * n + (size_t)t * TR) * 4,
              ROW, bar);
}

// Tiles of the staged shade kernel: SHADE_TR rays, SHADE_STAGES stages in
// the ring (on an H100 80GB HBM3 at 700 W tiles of 64 to 256 rays and two
// or three stages ran within 5% of each other, PERF.md; 64 x 3 was the
// fastest)
constexpr int SHADE_TR = 64;
constexpr int SHADE_STAGES = 3;

// [NSF = 75, R] f32 + [NSI = 6, R] i32 -> [NSO = 16, R], staged: persistent
// blocks walk tiles of SHADE_TR rays; one lane of a producer warp copies a
// tile's 75 f32 and 6 i32 row segments (SHADE_TR x 4 bytes each) into a
// ring of SHADE_STAGES shared-memory stages with bulk copies whose bytes
// complete the stage's "full" mbarrier, while the SHADE_TR consumer
// threads shade the tile before, one ray each, from shared memory
// (consecutive lanes read consecutive words of a row: no bank conflicts),
// release the stage on its "empty" mbarrier and write their columns,
// coalesced. A tile past the last whole one, and every tile where the
// stacks' rows are not 16-byte aligned (R not a multiple of 4), is read by
// the consumers straight from device memory: bulk_tiles counts the tiles
// that go through the ring.
__global__ void __launch_bounds__(SHADE_TR + 32)
shade_staged_kernel(const float* __restrict__ sf, const int* __restrict__ si,
                    int n, float* __restrict__ out, int n_tiles,
                    int bulk_tiles) {
  extern __shared__ __align__(128) float smem[];
  // [SHADE_STAGES][NSF][SHADE_TR] f32 rows, then [SHADE_STAGES][NSI]
  // [SHADE_TR] int rows
  float* fs = smem;
  int* is = reinterpret_cast<int*>(smem + SHADE_STAGES * NSF * SHADE_TR);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(
      is + SHADE_STAGES * NSI * SHADE_TR);
  unsigned long long* empty = full + SHADE_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SHADE_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], SHADE_TR / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= SHADE_TR) {
    if (threadIdx.x == SHADE_TR) {
      for (int t = blockIdx.x, i = 0; t < bulk_tiles; t += gridDim.x, ++i) {
        const int s = i % SHADE_STAGES;
        if (i >= SHADE_STAGES)
          mbar_wait(&empty[s], ((i / SHADE_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], (NSF + NSI) * SHADE_TR * 4);
        load_rows<SHADE_TR>(fs + (size_t)s * NSF * SHADE_TR, sf, NSF, n, t,
                            &full[s]);
        load_rows<SHADE_TR>(is + (size_t)s * NSI * SHADE_TR, si, NSI, n, t,
                            &full[s]);
      }
    }
    return;
  }
  const int j = threadIdx.x;
  float vals[NSO];
  for (int t = blockIdx.x, i = 0; t < n_tiles; t += gridDim.x) {
    const int r = t * SHADE_TR + j;
    if (t < bulk_tiles) {
      const int s = i % SHADE_STAGES;
      mbar_wait(&full[s], (i / SHADE_STAGES) & 1);
      shade_out(shade_fwd(Rows{fs + (size_t)s * NSF * SHADE_TR, SHADE_TR},
                          IRows{is + (size_t)s * NSI * SHADE_TR, SHADE_TR}, j),
                vals);
      __syncwarp();
      if ((j & 31) == 0) mbar_arrive(&empty[s]);
      ++i;
      store_column<NSO>(vals, out, n, r);
    } else if (r < n) {
      shade_out(shade_fwd(Rows{sf, n}, IRows{si, n}, r), vals);
      store_column<NSO>(vals, out, n, r);
    }
  }
}

// A ray's accumulators in the shade VJP: row k at p[k * stride], the ray's
// column of a tile in shared memory
struct Acc {
  float* p;
  int stride;
  __device__ __forceinline__ float& operator[](int k) const {
    return p[k * stride];
  }
};

__device__ __forceinline__ void add3(const Acc& d, int row, V3 v) {
  d[row] += v.x;
  d[row + 1] += v.y;
  d[row + 2] += v.z;
}

// VJP of shade_carry_math in its f32 rows for one ray with a hit: its
// [NSF] forward column, [NSI] int column and [NSO] cotangent column (F, I,
// G) -> its [NSF] cotangent column, summed into d from zero in a fixed
// order. d may lie where F's column was: F and G are read first
__device__ __forceinline__ void shade_bwd_hit(const Rows& F, const IRows& I,
                                              const Rows& G, int r,
                                              const Acc& d) {
  const ShadeFwd s = shade_fwd(F, I, r);
  const V3 z = v3(0.0f, 0.0f, 0.0f);
  const V3 G_org = row3(G, 0, r), G_dr = row3(G, 3, r),
           G_thr = row3(G, 6, r), G_rad = row3(G, 9, r);
#pragma unroll
  for (int kk = 0; kk < NSF; ++kk) d[kk] = 0.0f;

  // ---- carry update ----
  V3 g_org = s.alive_next ? z : G_org;
  V3 g_p = s.alive_next ? G_org : z;
  V3 g_dr = s.alive_next ? z : G_dr;
  V3 g_sdir = s.alive_next ? G_dr : z;
  V3 g_thr = s.alive_next ? vmul(G_thr, s.att) : G_thr;
  V3 g_att = s.alive_next ? vmul(G_thr, s.thr) : z;
  V3 g_emitted = z, g_bg = z;
  if (s.miss) {
    g_thr = vadd(g_thr, vmul(G_rad, s.bg));
    g_bg = vmul(G_rad, s.thr);
  }
  if (s.takes) {
    g_thr = vadd(g_thr, vmul(G_rad, s.emitted));
    g_emitted = vmul(G_rad, s.thr);
  }

  // ---- select by material ----
  V3 g_base = z, g_ud = z, g_nrm = z;
  if (s.mtype == MAT_LIGHT) {
    if (s.ek == 2) add3(d, GF + (s.odd ? 17 : 14), g_emitted);
    else if (s.ek == 3) add3(d, PK, g_emitted);
    else add3(d, GF + 14, g_emitted);
  }
  if (s.mtype == MAT_METAL) {
    // att = base_rgb, sdir = reflect(ud, nrm) + fuzz rball
    g_base = g_att;
    vreflect_bwd(s.ud, s.nrm, g_sdir, g_ud, g_nrm);
    d[GF + 6] += vdot(g_sdir, s.rball);
  } else if (s.mtype == MAT_DIELECTRIC) {
    if (s.do_reflect) {
      vreflect_bwd(s.ud, s.nrm, g_sdir, g_ud, g_nrm);
    } else {
      float g_ratio = vrefract_bwd(s.ud, s.nrm, s.ratio, g_sdir, g_ud, g_nrm);
      d[GF + 7] += s.front ? -g_ratio / (s.ior * s.ior) : g_ratio;
    }
  } else if (s.mtype != MAT_PBR) {
    g_dr = vadd(g_dr, g_sdir);  // sdir = dr
  }

  if (s.mtype == MAT_PBR) {
    const V3 one3 = v3(1.0f, 1.0f, 1.0f);
    // pbr_att = n_dot_l (diffuse + spec)
    float g_ndl = vdot(g_att, vadd(s.diffuse, s.spec));
    V3 g_S = vscale(s.n_dot_l, g_att);
    // spec = sc fres, sc = (dterm gterm) / sden, sden = (4 ndv) ndl + EPS
    float g_sc = vdot(g_S, s.fres);
    V3 g_fres = vscale(s.sc, g_S);
    float g_dg = g_sc / s.sden;
    float g_sden = -g_sc * s.sc / s.sden;
    float g_dterm = g_dg * s.gterm;
    float g_gterm = g_dg * s.dterm;
    float g_ndv = g_sden * 4.0f * s.n_dot_l;
    g_ndl += g_sden * (4.0f * s.n_dot_v);
    // diffuse = ((1/pi) attenuation) (1 - fres) ((1 - m) base)
    V3 A1 = vscale((float)(1.0 / PI_D), s.attenuation);
    V3 B1 = vsub(one3, s.fres);
    V3 C1 = vscale(1.0f - s.m, s.base_rgb);
    V3 g_atten = vscale((float)(1.0 / PI_D), vmul(g_S, vmul(B1, C1)));
    g_fres = vsub(g_fres, vmul(g_S, vmul(A1, C1)));
    V3 g_C1 = vmul(g_S, vmul(A1, B1));
    float g_m = -vdot(g_C1, s.base_rgb);
    g_base = vadd(g_base, vscale(1.0f - s.m, g_C1));
    // gterm = gaf_l gaf_v, gaf = x / (x (1 - k) + k)
    float g_gl = g_gterm * s.gaf_v, g_gv = g_gterm * s.gaf_l;
    float den_l = s.n_dot_l * (1.0f - s.k) + s.k;
    float den_v = s.n_dot_v * (1.0f - s.k) + s.k;
    float g_dl = -g_gl * s.gaf_l / den_l;
    float g_dv = -g_gv * s.gaf_v / den_v;
    g_ndl += g_gl / den_l + g_dl * (1.0f - s.k);
    g_ndv += g_gv / den_v + g_dv * (1.0f - s.k);
    float g_k = g_dl * (1.0f - s.n_dot_l) + g_dv * (1.0f - s.n_dot_v);
    float g_rr = g_k * s.rp1 / 4.0f;  // k = rp1^2 / 8
    // fres = f0 + power (1 - f0), power = 2^((a h + b) h)
    V3 g_f0 = vscale(1.0f - s.power, g_fres);
    float g_power = vdot(g_fres, vsub(one3, s.f0));
    float g_ex = g_power * s.power * LN2_F;
    float g_hdv = g_ex * s.hv_lin + g_ex * s.h_dot_v * (float)-5.55473;
    // dterm = alpha2 / max(pi q^2, 1e-12), q = ndh^2 (alpha2 - 1) + 1
    float g_alpha2 = g_dterm / s.den;
    float g_den = -g_dterm * s.dterm / s.den;
    float g_q = g_den * PI_F * dmaxn(PI_F * (s.q * s.q), (float)1e-12) *
                (2.0f * s.q);
    float g_ndh = g_q * 2.0f * s.n_dot_h * (s.alpha2 - 1.0f);
    g_alpha2 += g_q * s.n_dot_h * s.n_dot_h;
    g_rr += g_alpha2 * 4.0f * (s.rr * s.rr * s.rr);
    // f0 = (1 - m) 0.4 + m base
    g_m += vdot(g_f0, vsub(s.base_rgb, v3((float)0.4, (float)0.4, (float)0.4)));
    g_base = vadd(g_base, vscale(s.m, g_f0));
    // the four clamped dot products
    g_ndl *= dmaxn(vdot(s.normal, s.scatter), 0.0f);
    g_ndh *= dmaxn(vdot(s.normal, s.half), 0.0f);
    g_hdv *= dmaxn(vdot(s.half, s.view), 0.0f);
    g_ndv *= dmaxn(vdot(s.normal, s.view), 0.0f);
    V3 g_normal = vadd(vadd(vscale(g_ndl, s.scatter), vscale(g_ndh, s.half)),
                       vscale(g_ndv, s.view));
    V3 g_scatter = vadd(g_sdir, vscale(g_ndl, s.normal));
    V3 g_half = vadd(vscale(g_ndh, s.normal), vscale(g_hdv, s.view));
    V3 g_view = vadd(vscale(g_hdv, s.half), vscale(g_ndv, s.normal));
    // half = vunit(scatter + view), view = -ud, scatter = vunit(scatter_in)
    V3 g_hsum = vunit_bwd(s.hsum, g_half);
    g_scatter = vadd(g_scatter, g_hsum);
    g_view = vadd(g_view, g_hsum);
    g_ud = vsub(g_ud, g_view);
    // scatter_in = normal (+ ruv, a stop-gradient draw)
    g_normal = vadd(g_normal, vunit_bwd(s.scatter_in, g_scatter));
    // normal = vunit(world_nm) where a normal map is set, else nrm
    if (s.nk != 0) {
      V3 g_wn = vunit_bwd(s.world_nm, g_normal);
      add3(d, 19, vscale(s.nm.x, g_wn));
      add3(d, 22, vscale(s.nm.y, g_wn));
      g_nrm = vadd(g_nrm, vscale(s.nm.z, g_wn));
      V3 g_nmval = vscale(1.0f / 128.0f,
                          v3(vdot(g_wn, s.tan_), vdot(g_wn, s.bit),
                             vdot(g_wn, s.nrm)));
      if (s.nk == 2) add3(d, GF + (s.odd ? 27 : 24), g_nmval);
      else add3(d, PK + 3, g_nmval);
    } else {
      g_nrm = vadd(g_nrm, g_normal);
    }
    // metallic and roughness: the factor, a checker pair or a map channel,
    // clipped to [0, 1] unless the factor
    if (s.mk == 0) {
      d[GF + 4] += g_m;
    } else {
      float g2 = g_m * dclipn(s.m2, 0.0f, 1.0f);
      if (s.mk == 2) d[GF + (s.odd ? 21 : 20)] += g2;
      else if (s.mk == 3) d[PK + 6] += g2 / 255.0f;
      else d[GF + 4] += g2;
    }
    if (s.rk == 0) {
      d[GF + 5] += g_rr;
    } else {
      float g2 = g_rr * dclipn(s.r2, 0.0f, 1.0f);
      if (s.rk == 2) d[GF + (s.odd ? 23 : 22)] += g2;
      else if (s.rk == 3) d[PK + 7] += g2 / 255.0f;
      else d[GF + 5] += g2;
    }
    // attenuation: base, or (1/255) x (albedo c0 | 255 x checker | texel)
    if (s.ak == 0) {
      g_base = vadd(g_base, g_atten);
    } else {
      V3 g_map = vscale((float)(1.0 / 255.0), g_atten);
      if (s.ak == 2) add3(d, GF + (s.odd ? 11 : 8), vscale(255.0f, g_map));
      else if (s.ak == 1) add3(d, GF + 8, g_map);
      else add3(d, PK, g_map);
    }
  }

  g_dr = vadd(g_dr, vunit_bwd(s.dr, g_ud));  // ud = vunit(dr)
  add3(d, 0, g_org);
  add3(d, 3, g_dr);
  add3(d, 6, g_thr);
  add3(d, 9, G_rad);
  add3(d, 13, g_p);
  add3(d, 16, g_nrm);
  add3(d, GF, g_base);
  add3(d, 72, g_bg);
}

// The same for a ray with no hit (a miss, or a ray that died before): its
// carry passes through, so org, dir and thr take their cotangents, rad's
// goes to rad and, on a miss, also to thr and the background. Every other
// term of the adjoint is a product with a zero cotangent, +0 or -0, and
// leaves its sum at +0: the bits are shade_bwd_hit's wherever the forward's
// intermediates are finite, without the forward. Where the forward of such
// a ray is not finite, the full adjoint, like the plain VJP and the TPU
// kernel's jax.vjp, spreads a NaN that the pass does not
__device__ __forceinline__ void shade_bwd_pass(const Rows& F, const Rows& G,
                                               int r, const Acc& d) {
  const V3 z = v3(0.0f, 0.0f, 0.0f);
  const V3 G_org = row3(G, 0, r), G_dr = row3(G, 3, r),
           G_thr = row3(G, 6, r), G_rad = row3(G, 9, r);
  V3 g_thr = G_thr, g_bg = z;
  if (F(12, r) > 0.5f) {  // alive: a miss
    g_thr = vadd(g_thr, vmul(G_rad, row3(F, 72, r)));
    g_bg = vmul(G_rad, row3(F, 6, r));
  }
#pragma unroll
  for (int kk = 0; kk < NSF; ++kk) d[kk] = 0.0f;
  add3(d, 0, G_org);
  add3(d, 3, G_dr);
  add3(d, 6, g_thr);
  add3(d, 9, G_rad);
  add3(d, 72, g_bg);
}

__device__ __forceinline__ void shade_bwd_ray(const Rows& F, const IRows& I,
                                              const Rows& G, int r,
                                              const Acc& d) {
  if (F(26, r) > 0.5f)
    shade_bwd_hit(F, I, G, r, d);
  else
    shade_bwd_pass(F, G, r, d);
}

// Tiles of the shade VJP: SHADE_BWD_TR rays, one warp a block, its
// registers capped so that 16 blocks fit on an SM
constexpr int SHADE_BWD_TR = 32, SHADE_BWD_REGISTERS = 128;

// [NSF, R] f32 forward stack, [NSI, R] i32 and [NSO, R] cotangent ->
// [NSF, R], one warp a tile of SHADE_BWD_TR rays: lane 0 bulk-copies the
// tile's 75 f32, 16 cotangent and 6 int row segments into the block's
// shared memory, completing its mbarrier; every lane re-runs the forward
// of its ray from there (a ray with no hit needs none) and walks the
// adjoint, summing its cotangent in its own column of the f32 rows once
// they are read, and writes that column out, coalesced. A ragged last
// tile, and every tile of stacks whose rows are not 16-byte aligned
// (bulk_tiles 0), is read straight from device memory, its sums in the
// same columns. Blocks are not persistent: the card starts each as one
// ends, which balances tiles of cheap and costly rays.
__global__ void __launch_bounds__(
    SHADE_BWD_TR, 65536 / (SHADE_BWD_TR * SHADE_BWD_REGISTERS))
shade_bwd_kernel(const float* __restrict__ sf, const int* __restrict__ si,
                 const float* __restrict__ gout, int n,
                 float* __restrict__ dout, int bulk_tiles) {
  constexpr int TR = SHADE_BWD_TR;
  // the tile: [NSF][TR] f32 rows, [NSO][TR] cotangent rows, [NSI][TR] int
  // rows
  constexpr int ROWS = NSF + NSO + NSI;
  __shared__ __align__(128) float st[ROWS * TR];
  __shared__ unsigned long long full;
  const int t = blockIdx.x, j = threadIdx.x, r = t * TR + j;
  const Acc d{st + j, TR};
  if (t < bulk_tiles) {
    if (j == 0) {
      mbar_init(&full, 1);
      mbar_init_fence();
      mbar_arrive_expect_tx(&full, ROWS * TR * sizeof(float));
      load_rows<TR>(st, sf, NSF, n, t, &full);
      load_rows<TR>(st + NSF * TR, gout, NSO, n, t, &full);
      load_rows<TR>(st + (NSF + NSO) * TR, si, NSI, n, t, &full);
    }
    __syncwarp();
    mbar_wait(&full, 0);
    shade_bwd_ray(
        Rows{st, TR},
        IRows{reinterpret_cast<const int*>(st + (NSF + NSO) * TR), TR},
        Rows{st + NSF * TR, TR}, j, d);
  } else {
    if (r >= n) return;
    shade_bwd_ray(Rows{sf, n}, IRows{si, n}, Rows{gout, n}, r, d);
  }
#pragma unroll
  for (int k = 0; k < NSF; ++k) dout[(size_t)k * n + r] = d[k];
}

inline int blocks(int n) { return (n + THREADS - 1) / THREADS; }

// Stacks whose row segments a bulk copy can read: R a multiple of 4 (rows
// 16-byte aligned) and 16-byte aligned bases (a null base: no stack)
inline bool bulk_aligned(int n, const void* a, const void* b = nullptr,
                         const void* c = nullptr) {
  return n % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(c) % 16 == 0;
}

// Launch the staged shade kernel: as many persistent blocks as fit on the
// card at once (found once per device), no more than there are tiles.
cudaError_t launch_staged(const float* sf, const int* si, int n, float* out,
                          cudaStream_t stream) {
  constexpr size_t smem =
      (size_t)SHADE_STAGES * (NSF + NSI) * SHADE_TR * sizeof(float) +
      2 * SHADE_STAGES * sizeof(unsigned long long);
  static int grid[64];  // per device; 0 until found
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (grid[dev] == 0) {
    auto kernel = shade_staged_kernel;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          SHADE_TR + 32, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    grid[dev] = sms * per_sm;
  }
  const int n_tiles = (n + SHADE_TR - 1) / SHADE_TR;
  const int bulk_tiles = bulk_aligned(n, sf, si) ? n / SHADE_TR : 0;
  const int n_blocks = n_tiles < grid[dev] ? n_tiles : grid[dev];
  shade_staged_kernel<<<n_blocks, SHADE_TR + 32, smem, stream>>>(
      sf, si, n, out, n_tiles, bulk_tiles);
  return cudaGetLastError();
}

// The copy floor of the shade-family kernels, for measurement only (no
// path launches it): one thread per ray in blocks of THREADS, as the first
// hit-record and shade kernels ran, reading NF f32 and NI i32 rows and
// writing NO rows, row k the sum of the f32 rows k, k + NO, ... and of the
// int rows k, k + NO, ... Its time is what streaming a kernel's stacks
// allows on the card, apart from the math: kernel 3 (34 -> 16), kernel 4
// (75 + 6 -> 16), kernel 5 (34 + 16 -> 34) and kernel 6 (75 + 16 + 6 ->
// 75), each f32 input stacked into one.
template <int NF, int NI, int NO>
__global__ void stack_copy_kernel(const float* __restrict__ f,
                                  const int* __restrict__ si, int n,
                                  float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float acc[NO];
#pragma unroll
  for (int k = 0; k < NO; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < NF; ++k) acc[k % NO] += f[(size_t)k * n + r];
#pragma unroll
  for (int k = 0; k < NI; ++k) acc[k % NO] += (float)si[(size_t)k * n + r];
#pragma unroll
  for (int k = 0; k < NO; ++k) out[(size_t)k * n + r] = acc[k];
}

template <int NF, int NI, int NO>
bool stack_copy_as(int nf, int ni, int no, const float* f, const int* si,
                   int n, float* out, cudaStream_t stream) {
  if (nf != NF || ni != NI || no != NO) return false;
  stack_copy_kernel<NF, NI, NO><<<blocks(n), THREADS, 0, stream>>>(f, si, n,
                                                                   out);
  return true;
}

}  // namespace

extern "C" {

int srt_hitrec(const float* hf, int n, float* out, void* stream) {
  if (n > 0)
    hitrec_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(hf, n, out);
  return static_cast<int>(cudaGetLastError());
}

int srt_shade(const float* sf, const int* si, int n, float* out,
              void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(
      launch_staged(sf, si, n, out, (cudaStream_t)stream));
}

int srt_stack_copy(const float* f, int nf, const int* si, int ni, int n,
                   float* out, int no, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = (cudaStream_t)stream;
  if (!stack_copy_as<NHF, 0, NHO>(nf, ni, no, f, si, n, out, st) &&
      !stack_copy_as<NSF, NSI, NSO>(nf, ni, no, f, si, n, out, st) &&
      !stack_copy_as<NHF + NHO, 0, NHF>(nf, ni, no, f, si, n, out, st) &&
      !stack_copy_as<NSF + NSO, NSI, NSF>(nf, ni, no, f, si, n, out, st))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int srt_hitrec_bwd(const float* hf, const float* gout, int n, float* dout,
                   void* stream) {
  if (n > 0) {
    hitrec_bwd_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
        hf, gout, n, dout);
  }
  return static_cast<int>(cudaGetLastError());
}

int srt_shade_bwd(const float* sf, const int* si, const float* gout, int n,
                  float* dout, void* stream) {
  if (n > 0) {
    const int n_tiles = (n + SHADE_BWD_TR - 1) / SHADE_BWD_TR;
    const bool aligned = bulk_aligned(n, sf, si, gout);
    shade_bwd_kernel<<<n_tiles, SHADE_BWD_TR, 0, (cudaStream_t)stream>>>(
        sf, si, gout, n, dout, aligned ? n / SHADE_BWD_TR : 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
