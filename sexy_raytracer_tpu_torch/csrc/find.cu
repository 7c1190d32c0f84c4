// Cluster-culled ray queries for Hopper: closest hit and any hit.
//
// Replaces the TPU kernels _find_kernel (sexy_raytracer_tpu/ops/pallas_find.py:170)
// and _occluded_kernel (pallas_find.py:681). Layouts are documented in
// sexy_raytracer_tpu_torch/ops/find.py; the plain PyTorch versions there are
// the specification. Both kernels:
//
//   * run one block of RAY_BLOCK threads per worklist row, one thread per ray;
//     the block reads its own worklist row (the TPU prefetched it to SMEM);
//   * stage each active cluster's [16, CK] plane/edge tile in shared memory,
//     loaded by the whole block with float4 loads, and let every thread test
//     its ray against the CK triangles (all threads read the same word:
//     broadcast, no bank conflicts);
//   * stop the worklist early, block-wide, once no remaining cluster's entry
//     distance lies below any lane's current best t (or bound), with
//     __syncthreads_or on the order-preserving int bits the worklist carries.
//
// The arithmetic keeps the JAX package's formulas and evaluation order. The
// library is built with -fmad=false and without fast math, so nothing is
// contracted into an FMA, and '/' and sqrtf round as IEEE: a kernel returns
// the same prim ids and t bits as its plain version.

#include <cuda_runtime.h>

namespace {

constexpr int RAY_BLOCK = 128;
constexpr int MAX_CK = 512;
constexpr float BIG = (float)3.0e38;  // rounded from the double, as torch
constexpr float EPS = 1.1920928955078125e-07f;  // FLT_EPSILON

struct Ray {
  float ox, oy, oz, dx, dy, dz, tm, t_min;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int r,
                                        int cols) {
  const float* p = rays + (size_t)r * cols;
  Ray ray;
  ray.ox = p[0]; ray.oy = p[1]; ray.oz = p[2];
  ray.dx = p[3]; ray.dy = p[4]; ray.dz = p[5];
  ray.tm = p[6]; ray.t_min = p[7];
  return ray;
}

// Nearest valid root of sphere row s (base xyz, delta xyz, radius, valid),
// else BIG (pallas_find.py:94-129).
__device__ __forceinline__ float sphere_tc(const float* __restrict__ s,
                                           const Ray& ray, float a) {
  float cx = __ldg(s + 0) + __ldg(s + 3) * ray.tm;
  float cy = __ldg(s + 1) + __ldg(s + 4) * ray.tm;
  float cz = __ldg(s + 2) + __ldg(s + 5) * ray.tm;
  float rad = __ldg(s + 6);
  bool s_valid = __ldg(s + 7) > 0.0f;
  float ocx = ray.ox - cx, ocy = ray.oy - cy, ocz = ray.oz - cz;
  float half_b = ocx * ray.dx + ocy * ray.dy + ocz * ray.dz;
  float cterm = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  float disc = half_b * half_b - a * cterm;
  bool has = disc >= 0.0f;
  float sq = sqrtf(has ? disc : 0.0f);
  float safe_a = a == 0.0f ? 1.0f : a;
  float root0 = (-half_b - sq) / safe_a;
  float root1 = (-half_b + sq) / safe_a;
  bool ok0 = has && (root0 >= ray.t_min) && s_valid;
  bool ok1 = has && (root1 >= ray.t_min) && s_valid;
  return ok0 ? root0 : (ok1 ? root1 : BIG);
}

// Triangle j of a shared-memory tile: t, and whether the hit is valid
// (pallas_find.py:136-157).
__device__ __forceinline__ bool tri_hit(const float* tile, int ck, int j,
                                        const Ray& ray, float* t_out) {
  const float* r = tile + j;
  float ndir = ray.dx * r[0] + ray.dy * r[ck] + ray.dz * r[2 * ck];
  float a_n = ray.ox * r[0] + ray.oy * r[ck] + ray.oz * r[2 * ck] + r[3 * ck];
  bool plane_ok = ndir <= -EPS;
  float t = -a_n / (plane_ok ? ndir : -1.0f);
  float px = ray.ox + t * ray.dx;
  float py = ray.oy + t * ray.dy;
  float pz = ray.oz + t * ray.dz;
  float e0 = r[4 * ck] * px + r[5 * ck] * py + r[6 * ck] * pz - r[7 * ck];
  float e1 = r[8 * ck] * px + r[9 * ck] * py + r[10 * ck] * pz - r[11 * ck];
  float e2 = r[12 * ck] * px + r[13 * ck] * py + r[14 * ck] * pz - r[15 * ck];
  *t_out = t;
  return plane_ok && (e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f) &&
         (t >= ray.t_min);
}

// Copy cluster c's [16, ck] tile into shared memory (ck is a multiple of 4).
__device__ __forceinline__ void load_tile(float* tile,
                                          const float* __restrict__ tri_pack,
                                          int c, int ck) {
  const float4* src =
      reinterpret_cast<const float4*>(tri_pack + (size_t)c * 16 * ck);
  float4* dst = reinterpret_cast<float4*>(tile);
  for (int i = threadIdx.x; i < 4 * ck; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(RAY_BLOCK)
find_closest_kernel(const int* __restrict__ lists, int list_stride,
                    const float* __restrict__ rays,
                    const float* __restrict__ tri_pack, int n_clusters, int ck,
                    const float* __restrict__ sph_pack, int n_sph_pad,
                    int n_tris, float* __restrict__ out_t,
                    int* __restrict__ out_i) {
  __shared__ __align__(16) float tile[16 * MAX_CK];
  const int b = blockIdx.x;
  const int r = b * RAY_BLOCK + threadIdx.x;
  const Ray ray = load_ray(rays, r, 8);
  const float a = ray.dx * ray.dx + ray.dy * ray.dy + ray.dz * ray.dz;

  // spheres: the lowest index among the nearest roots
  float best_t = BIG;
  int best_s = 0;
  for (int s = 0; s < n_sph_pad; ++s) {
    float tc = sphere_tc(sph_pack + 8 * s, ray, a);
    if (tc < best_t) { best_t = tc; best_s = s; }
  }
  int best_i = best_t < BIG ? n_tris + best_s : -1;

  if (n_tris > 0 && n_clusters > 0) {
    const int* row = lists + (size_t)b * list_stride;
    const int count = row[0];
    for (int k = 0; k < count; ++k) {
      // early out: continue while some lane's best t lies beyond this
      // cluster's entry distance (barrier: the last tile is consumed)
      if (!__syncthreads_or(__float_as_int(best_t) > row[1 + n_clusters + k]))
        break;
      const int c = row[1 + k];
      load_tile(tile, tri_pack, c, ck);
      __syncthreads();
      // strict '<' in lane order: the lowest id wins a tie in a tile,
      // the earlier tile wins a tie across tiles
      for (int j = 0; j < ck; ++j) {
        float t;
        if (tri_hit(tile, ck, j, ray, &t) && t < best_t) {
          best_t = t;
          best_i = c * ck + j;
        }
      }
    }
  }
  out_t[r] = best_t;
  out_i[r] = best_t < BIG ? best_i : -1;
}

__global__ void __launch_bounds__(RAY_BLOCK)
find_any_kernel(const int* __restrict__ lists, int list_stride,
                const float* __restrict__ rays,
                const float* __restrict__ tri_pack, int n_clusters, int ck,
                const float* __restrict__ sph_pack, int n_sph_pad, int n_tris,
                int* __restrict__ out) {
  __shared__ __align__(16) float tile[16 * MAX_CK];
  const int b = blockIdx.x;
  const int r = b * RAY_BLOCK + threadIdx.x;
  const Ray ray = load_ray(rays, r, 9);
  float bound = rays[(size_t)r * 9 + 8];
  const float a = ray.dx * ray.dx + ray.dy * ray.dy + ray.dz * ray.dz;

  // occluder spheres (valid column): any nearest root before the bound
  bool occ0 = false;
  for (int s = 0; s < n_sph_pad; ++s) {
    float tc = sphere_tc(sph_pack + 8 * s, ray, a);
    float v = tc < bound ? tc : BIG;
    occ0 = occ0 || (v < BIG);
  }
  if (occ0) bound = -BIG;

  if (n_tris > 0 && n_clusters > 0) {
    const int* row = lists + (size_t)b * list_stride;
    const int count = row[0];
    for (int k = 0; k < count; ++k) {
      // resolved lanes hold -BIG, whose int bits are negative
      if (!__syncthreads_or(__float_as_int(bound) > row[1 + n_clusters + k]))
        break;
      const int c = row[1 + k];
      load_tile(tile, tri_pack, c, ck);
      __syncthreads();
      if (bound > -BIG) {
        for (int j = 0; j < ck; ++j) {
          float t;
          if (tri_hit(tile, ck, j, ray, &t) && t < bound) {
            bound = -BIG;
            break;
          }
        }
      }
    }
  }
  out[r] = bound < 0.0f ? 1 : 0;
}

}  // namespace

extern "C" {

const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int srt_find_closest(const int* lists, int list_stride, const float* rays,
                     const float* tri_pack, int n_clusters, int ck,
                     const float* sph_pack, int n_sph_pad, int n_tris,
                     int ray_block, int n_blocks, float* out_t, int* out_i,
                     void* stream) {
  if (ray_block != RAY_BLOCK || ck > MAX_CK || ck % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks > 0) {
    find_closest_kernel<<<n_blocks, RAY_BLOCK, 0, (cudaStream_t)stream>>>(
        lists, list_stride, rays, tri_pack, n_clusters, ck, sph_pack,
        n_sph_pad, n_tris, out_t, out_i);
  }
  return static_cast<int>(cudaGetLastError());
}

int srt_find_any(const int* lists, int list_stride, const float* rays,
                 const float* tri_pack, int n_clusters, int ck,
                 const float* sph_pack, int n_sph_pad, int n_tris,
                 int ray_block, int n_blocks, int* out, void* stream) {
  if (ray_block != RAY_BLOCK || ck > MAX_CK || ck % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks > 0) {
    find_any_kernel<<<n_blocks, RAY_BLOCK, 0, (cudaStream_t)stream>>>(
        lists, list_stride, rays, tri_pack, n_clusters, ck, sph_pack,
        n_sph_pad, n_tris, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
