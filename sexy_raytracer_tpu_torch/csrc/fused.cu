// Fused per-bounce kernels for Hopper: the hit record, and shading plus the
// path-carry update.
//
// Replace the TPU kernels _hitrec_kernel (sexy_raytracer_tpu/ops/fused.py:442,
// math hitrec_math :141) and _shade_kernel (fused.py:501, math
// shade_carry_math :271). The row maps (NHF/NHO, SF_*/NSI/NSO) are the JAX
// package's; a stack is [K, R] row-major with rays contiguous, the TPU's
// [K, RB, 128] flattened. One thread per ray: every row read and written is
// a coalesced 4-byte access across a warp.
//
// Each kernel is a line-by-line transcription of its JAX math, in the same
// evaluation order. The library is built with -fmad=false and without fast
// math, so with the same inputs a kernel matches its plain PyTorch version
// (sexy_raytracer_tpu_torch/ops/fused.py) up to the last bit of sinf, exp2f
// and powf, which both call from the same CUDA math library.
//
// max/min/clip below propagate NaN like jnp.maximum/minimum/clip, not like
// fmaxf/fminf, so that a NaN produced upstream is not silently hidden.

#include <cuda_runtime.h>

namespace {

constexpr float EPS = 1.1920928955078125e-07f;  // FLT_EPSILON
constexpr double PI_D = 3.1415926535897932385;
constexpr float PI_F = (float)PI_D;
constexpr int MAT_PBR = 0, MAT_METAL = 1, MAT_DIELECTRIC = 2, MAT_LIGHT = 3;

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

struct Rows {
  const float* __restrict__ p;
  int n;
  __device__ __forceinline__ float operator()(int k, int r) const {
    return p[(size_t)k * n + r];
  }
};

// hitrec_math (fused.py:141-246): [NHF = 34, R] -> [NHO = 16, R]
__global__ void hitrec_kernel(const float* __restrict__ hf, int n,
                              float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  Rows F{hf, n};
  V3 org = v3(F(0, r), F(1, r), F(2, r));
  V3 dr = v3(F(3, r), F(4, r), F(5, r));
  float time = F(6, r);
  V3 v0 = v3(F(7, r), F(8, r), F(9, r));
  V3 v1 = v3(F(10, r), F(11, r), F(12, r));
  V3 v2 = v3(F(13, r), F(14, r), F(15, r));
  float uv0x = F(16, r), uv0y = F(17, r);
  float uv1x = F(18, r), uv1y = F(19, r);
  float uv2x = F(20, r), uv2y = F(21, r);
  V3 c0 = v3(F(22, r), F(23, r), F(24, r));
  V3 c1 = v3(F(25, r), F(26, r), F(27, r));
  float st0 = F(28, r), st1 = F(29, r), srad = F(30, r);
  float t_min = F(31, r);
  bool is_tri = F(32, r) > 0.5f;

  // --- triangle ---
  V3 n3 = vcross(vsub(v1, v0), vsub(v2, v0));
  float ndir = vdot(n3, dr);
  float d = -vdot(n3, v0);
  float safe = ndir == 0.0f ? -1.0f : ndir;
  float t_t = -(vdot(n3, org) + d) / safe;
  V3 p_t = vadd(org, vscale(t_t, dr));

  auto invdist = [&](V3 v) {
    V3 w = vsub(p_t, v);
    float dist = safe_sqrt(vdot(w, w));
    return 1.0f / maxn(dist, (float)1e-20);
  };
  float r0 = invdist(v0), r1 = invdist(v1), r2 = invdist(v2);
  float denom = r0 + r1 + r2;
  r0 = r0 / denom;
  r1 = r1 / denom;
  r2 = r2 / denom;
  float u_t = r0 * uv0x + r1 * uv1x + r2 * uv2x;
  float v_t = 1.0f - (r0 * uv0y + r1 * uv1y + r2 * uv2y);

  V3 outward_t = vunit(n3);
  bool front_t = vdot(dr, outward_t) < 0.0f;
  V3 normal_t = vwhere(front_t, outward_t, vneg(outward_t));

  V3 e0 = vsub(v1, v0);
  V3 e1 = vsub(v2, v0);
  float duv0x = uv1x - uv0x, duv0y = uv1y - uv0y;
  float duv1x = uv2x - uv0x, duv1y = uv2y - uv0y;
  float f = duv0x * duv1y - duv1x * duv0y;
  float inv_f = 1.0f / (f == 0.0f ? EPS : f);
  V3 tangent_t = vunit(vscale(inv_f, vsub(vscale(duv1y, e0), vscale(duv0y, e1))));
  V3 bitangent_t =
      vunit(vscale(inv_f, vadd(vscale(-duv1x, e0), vscale(duv0x, e1))));

  // --- sphere ---
  bool moving = (c0.x != c1.x) || (c0.y != c1.y) || (c0.z != c1.z);
  float sdenom = st1 == st0 ? 1.0f : st1 - st0;
  float frac = (time - st0) / sdenom;
  V3 center = vwhere(moving, vadd(c0, vscale(frac, vsub(c1, c0))), c0);
  V3 oc = vsub(org, center);
  float a = vdot(dr, dr);
  float half_b = vdot(oc, dr);
  float cterm = vdot(oc, oc) - srad * srad;
  float disc = half_b * half_b - a * cterm;
  float sqrtd = safe_sqrt(disc);
  float safe_a = a == 0.0f ? 1.0f : a;
  float root0 = (-half_b - sqrtd) / safe_a;
  float root1 = (-half_b + sqrtd) / safe_a;
  float t_s = root0 >= t_min ? root0 : root1;
  V3 p_s = vadd(org, vscale(t_s, dr));
  V3 outward_s = vunit(vsub(p_s, center));
  bool front_s = vdot(dr, outward_s) < 0.0f;
  V3 normal_s = vwhere(front_s, outward_s, vneg(outward_s));

  bool near_pole = (1.0f - fabsf(outward_s.y)) < EPS;
  V3 bpole = near_pole ? v3(0.0f, 0.0f, -1.0f) : v3(0.0f, 1.0f, 0.0f);
  V3 tangent_s = vunit(vcross(bpole, outward_s));
  V3 bitangent_s = vunit(vcross(outward_s, tangent_s));

  // --- select ---
  V3 p = vwhere(is_tri, p_t, p_s);
  V3 normal = vwhere(is_tri, normal_t, normal_s);
  V3 tangent = vwhere(is_tri, tangent_t, tangent_s);
  V3 bitangent = vwhere(is_tri, bitangent_t, bitangent_s);
  float t = is_tri ? t_t : t_s;
  bool front = is_tri ? front_t : front_s;

  const float vals[16] = {p.x, p.y, p.z,
                          normal.x, normal.y, normal.z,
                          tangent.x, tangent.y, tangent.z,
                          bitangent.x, bitangent.y, bitangent.z,
                          u_t, v_t, t, front ? 1.0f : 0.0f};
#pragma unroll
  for (int k = 0; k < 16; ++k) out[(size_t)k * n + r] = vals[k];
}

// shade_carry_math (fused.py:271-429): [NSF = 75, R] f32 + [NSI = 6, R] i32
// -> [NSO = 16, R]
__global__ void shade_kernel(const float* __restrict__ sf,
                             const int* __restrict__ si, int n,
                             float* __restrict__ out) {
  constexpr int GF = 27, PK = 57;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  Rows F{sf, n};
  V3 org = v3(F(0, r), F(1, r), F(2, r));
  V3 dr = v3(F(3, r), F(4, r), F(5, r));
  V3 thr = v3(F(6, r), F(7, r), F(8, r));
  V3 rad = v3(F(9, r), F(10, r), F(11, r));
  bool alive = F(12, r) > 0.5f;
  V3 p = v3(F(13, r), F(14, r), F(15, r));
  V3 nrm = v3(F(16, r), F(17, r), F(18, r));
  V3 tan_ = v3(F(19, r), F(20, r), F(21, r));
  V3 bit = v3(F(22, r), F(23, r), F(24, r));
  bool front = F(25, r) > 0.5f;
  bool hit = F(26, r) > 0.5f;
  auto g = [&](int k) { return F(GF + k, r); };
  auto pk = [&](int k) { return F(PK + k, r); };
  V3 ruv = v3(F(65, r), F(66, r), F(67, r));
  V3 rball = v3(F(68, r), F(69, r), F(70, r));
  float runi = F(71, r);
  V3 bg = v3(F(72, r), F(73, r), F(74, r));
  const int mtype = si[r], ak = si[n + r], nk = si[2 * n + r];
  const int mk = si[3 * n + r], rk = si[4 * n + r], ek = si[5 * n + r];

  V3 base_rgb = v3(g(0), g(1), g(2));
  V3 albedo_c0 = v3(g(8), g(9), g(10));
  V3 albedo_c1 = v3(g(11), g(12), g(13));
  V3 emit_rgb = v3(g(14), g(15), g(16));
  V3 emit_c1 = v3(g(17), g(18), g(19));
  V3 normal_c0 = v3(g(24), g(25), g(26));
  V3 normal_c1 = v3(g(27), g(28), g(29));
  const V3 zero3 = v3(0.0f, 0.0f, 0.0f);
  const V3 one3 = v3(1.0f, 1.0f, 1.0f);

  // checker parity shared by every procedural slot (texture.h:42-48)
  bool odd = (sinf(10.0f * p.x) * sinf(10.0f * p.y) * sinf(10.0f * p.z)) < 0.0f;

  // ---- PBR ----
  V3 checker = vscale(255.0f, vwhere(odd, albedo_c1, albedo_c0));
  V3 map_val = vwhere(ak == 1, albedo_c0, v3(pk(0), pk(1), pk(2)));
  map_val = vwhere(ak == 2, checker, map_val);
  V3 attenuation =
      vwhere(ak == 0, base_rgb, vscale((float)(1.0 / 255.0), map_val));

  V3 nm_val = vwhere(nk == 2, vwhere(odd, normal_c1, normal_c0),
                     v3(pk(3), pk(4), pk(5)));
  V3 nm = vscale(1.0f / 128.0f, vsub(nm_val, v3(128.0f, 128.0f, 128.0f)));
  V3 world_nm = vadd(vadd(vscale(nm.x, tan_), vscale(nm.y, bit)),
                     vscale(nm.z, nrm));
  V3 normal = vwhere(nk != 0, vunit(world_nm), nrm);

  float metallic = g(4), roughness = g(5);
  float m_ck = odd ? g(21) : g(20);
  float m = mk == 3 ? pk(6) / 255.0f : metallic;
  m = clipn(mk == 2 ? m_ck : m, 0.0f, 1.0f);
  m = mk == 0 ? metallic : m;
  float r_ck = odd ? g(23) : g(22);
  float rr = rk == 3 ? pk(7) / 255.0f : roughness;
  rr = clipn(rk == 2 ? r_ck : rr, 0.0f, 1.0f);
  rr = rk == 0 ? roughness : rr;

  V3 scatter = vadd(normal, ruv);
  bool degen = (fabsf(scatter.x) < (float)1e-8) && (fabsf(scatter.y) < (float)1e-8) &&
               (fabsf(scatter.z) < (float)1e-8);
  scatter = vunit(vwhere(degen, normal, scatter));

  V3 view = vneg(vunit(dr));
  V3 half = vunit(vadd(scatter, view));
  float n_dot_l = maxn(vdot(normal, scatter), 0.0f);
  float n_dot_h = maxn(vdot(normal, half), 0.0f);
  float h_dot_v = maxn(vdot(half, view), 0.0f);
  float n_dot_v = maxn(vdot(normal, view), 0.0f);

  V3 f0 = vadd(vscale(1.0f - m, v3((float)0.4, (float)0.4, (float)0.4)), vscale(m, base_rgb));
  float alpha2 = (rr * rr) * (rr * rr);
  float q = n_dot_h * n_dot_h * (alpha2 - 1.0f) + 1.0f;
  float dterm = alpha2 / maxn(PI_F * (q * q), (float)1e-12);
  float power = exp2f(((float)-5.55473 * h_dot_v - (float)6.98316) * h_dot_v);
  V3 fres = vadd(f0, vscale(power, vsub(one3, f0)));
  float rp1 = rr + 1.0f;
  float k = (rp1 * rp1) / 8.0f;
  float gaf_l = n_dot_l / (n_dot_l * (1.0f - k) + k);
  float gaf_v = n_dot_v / (n_dot_v * (1.0f - k) + k);
  float gterm = gaf_l * gaf_v;

  V3 diffuse = vmul(vmul(vscale((float)(1.0 / PI_D), attenuation),
                         vsub(one3, fres)),
                    vscale(1.0f - m, base_rgb));
  V3 spec = vscale(dterm * gterm / (4.0f * n_dot_v * n_dot_l + EPS), fres);
  V3 pbr_att = vscale(n_dot_l, vadd(diffuse, spec));
  V3 pbr_dir = scatter;

  // ---- metal ----
  float fuzz = g(6);
  V3 reflected = vreflect(vunit(dr), nrm);
  V3 met_dir = vadd(reflected, vscale(fuzz, rball));
  bool met_ok = vdot(met_dir, nrm) > 0.0f;
  V3 met_att = base_rgb;

  // ---- dielectric ----
  float ior = g(7);
  float ratio = front ? 1.0f / ior : ior;
  V3 ud = vunit(dr);
  float cos_t = minn(vdot(nrm, vneg(ud)), 1.0f);
  float sin_t = sqrtf(maxn(1.0f - cos_t * cos_t, 0.0f));
  bool cannot = ratio * sin_t > 1.0f;
  float r0q = (1.0f - ratio) / (1.0f + ratio);
  float r0c = r0q * r0q;
  float x = 1.0f - cos_t;
  float x5 = x * ((x * x) * (x * x));  // lax.integer_pow(x, 5)
  float reflectance = r0c + (1.0f - r0c) * x5;
  bool do_reflect = cannot || (reflectance > runi);
  V3 die_dir = vwhere(do_reflect, vreflect(ud, nrm), vrefract(ud, nrm, ratio));

  // ---- diffuseLight emitted ----
  V3 emit_val = vwhere(ek == 2, vwhere(odd, emit_c1, emit_rgb),
                       vwhere(ek == 3, v3(pk(0), pk(1), pk(2)), emit_rgb));
  V3 emitted = vwhere(mtype == MAT_LIGHT, emit_val, zero3);

  // ---- select by material ----
  V3 att = vwhere(mtype == MAT_PBR, pbr_att, zero3);
  att = vwhere(mtype == MAT_METAL, met_att, att);
  att = vwhere(mtype == MAT_DIELECTRIC, one3, att);
  V3 sdir = vwhere(mtype == MAT_PBR, pbr_dir, dr);
  sdir = vwhere(mtype == MAT_METAL, met_dir, sdir);
  sdir = vwhere(mtype == MAT_DIELECTRIC, die_dir, sdir);
  bool scattered = ((mtype == MAT_PBR) || ((mtype == MAT_METAL) && met_ok) ||
                    (mtype == MAT_DIELECTRIC)) &&
                   hit;

  // ---- carry update ----
  bool miss = alive && !hit;
  bool takes = alive && hit;
  rad = vadd(rad, vwhere(miss, vmul(thr, bg), zero3));
  rad = vadd(rad, vwhere(takes, vmul(thr, emitted), zero3));
  bool alive_next = alive && hit && scattered;
  thr = vwhere(alive_next, vmul(thr, att), thr);
  org = vwhere(alive_next, p, org);
  dr = vwhere(alive_next, sdir, dr);

  const float vals[16] = {org.x, org.y, org.z, dr.x, dr.y, dr.z,
                          thr.x, thr.y, thr.z, rad.x, rad.y, rad.z,
                          alive_next ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) out[(size_t)kk * n + r] = vals[kk];
}

constexpr int THREADS = 256;

}  // namespace

extern "C" {

int srt_hitrec(const float* hf, int n, float* out, void* stream) {
  if (n > 0) {
    hitrec_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                    (cudaStream_t)stream>>>(hf, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int srt_shade(const float* sf, const int* si, int n, float* out,
              void* stream) {
  if (n > 0) {
    shade_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                   (cudaStream_t)stream>>>(sf, si, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
