// Ray queries for Hopper: cluster-culled closest hit and any hit, the
// streamed big-scene closest hit, and the brute-force triangle search.
//
// Replaces the TPU kernels _find_kernel (sexy_raytracer_tpu/ops/pallas_find.py:170),
// _occluded_kernel (pallas_find.py:681), _find_streamed_kernel
// (pallas_find.py:893) and _tri_kernel (ops/pallas_intersect.py:53). Layouts
// are documented in sexy_raytracer_tpu_torch/ops/find.py and ops/brute.py;
// the plain PyTorch versions there are the specification. The three
// worklist kernels:
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
constexpr int STREAM_BLOCK = 512;    // rays per block of the streamed find
constexpr int BRUTE_BLOCK = 256;     // rays per block of the brute search
constexpr int TRI_TILE = 512;        // triangles per tile of its weights
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


// --- streamed closest hit (big scenes) ---------------------------------------
//
// The worklist row of block b lists superclusters (sc consecutive clusters).
// The block walks their tiles j = 0 .. count*sc - 1 in order through two
// shared-memory buffers: cp.async copies tile j+1 while tile j is tested.

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Issue the copy of tile j of the block's worklist into buf.
__device__ __forceinline__ void fetch_tile(float* buf,
                                           const float* __restrict__ slabs,
                                           const int* row, int j, int sc,
                                           int ck) {
  const int cid = row[1 + j / sc] * sc + j % sc;
  const float* src = slabs + (size_t)cid * 16 * ck;
  for (int i = threadIdx.x; i < 4 * ck; i += blockDim.x)
    cp_async16(buf + 4 * i, src + 4 * i);
}

__global__ void __launch_bounds__(STREAM_BLOCK)
find_streamed_kernel(const int* __restrict__ lists, int list_stride,
                     const float* __restrict__ rays,
                     const float* __restrict__ slabs, int n_supers, int sc,
                     int ck, const float* __restrict__ sph_pack,
                     int n_sph_pad, int n_tris, float* __restrict__ out_t,
                     int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];  // two [16, ck] tiles
  const int b = blockIdx.x;
  const int r = b * STREAM_BLOCK + threadIdx.x;
  const Ray ray = load_ray(rays, r, 8);
  const float a = ray.dx * ray.dx + ray.dy * ray.dy + ray.dz * ray.dz;

  // spheres first (pallas_find.py:94-133): the lowest index among the
  // nearest roots; a triangle must be strictly nearer to replace it
  float best_t = BIG;
  int best_s = 0;
  for (int s = 0; s < n_sph_pad; ++s) {
    float tc = sphere_tc(sph_pack + 8 * s, ray, a);
    if (tc < best_t) { best_t = tc; best_s = s; }
  }
  int best_i = best_t < BIG ? n_tris + best_s : -1;

  if (n_tris > 0 && n_supers > 0) {
    const int* row = lists + (size_t)b * list_stride;
    const int n_tiles = row[0] * sc;
    if (n_tiles > 0) fetch_tile(smem, slabs, row, 0, sc, ck);
    cp_async_commit();
    for (int j = 0; j < n_tiles; ++j) {
      const int k = j / sc, c = j % sc;
      // early out at a supercluster: continue while some lane's best t
      // lies beyond its block-min entry distance (also the barrier after
      // which the buffer of tile j-1 may be refilled)
      if (c == 0 &&
          !__syncthreads_or(__float_as_int(best_t) > row[1 + n_supers + k]))
        break;
      float* cur = smem + (j & 1) * 16 * ck;
      if (j + 1 < n_tiles)
        fetch_tile(smem + ((j + 1) & 1) * 16 * ck, slabs, row, j + 1, sc, ck);
      cp_async_commit();
      cp_async_wait_prior();  // tile j has landed (for this thread's copies)
      __syncthreads();        // ... and for every thread's
      const int base = (row[1 + k] * sc + c) * ck;
      for (int jj = 0; jj < ck; ++jj) {
        float t;
        if (tri_hit(cur, ck, jj, ray, &t) && t < best_t) {
          best_t = t;
          best_i = base + jj;
        }
      }
      __syncthreads();  // every thread is done with cur before its refill
    }
    cp_async_wait_all();  // no copy outlives the block
  }
  out_t[r] = best_t;
  out_i[r] = best_t < BIG ? best_i : -1;
}

// --- brute-force closest triangle (pallas_intersect.py:53-95) ----------------
//
// w is [4, 4 Tpad], each TRI_TILE-triangle tile's columns grouped as
// [n | q0 | q1 | q2]. One thread per ray; the block stages one tile's
// [4, 4 TRI_TILE] weights (32 KB) at a time.

__global__ void __launch_bounds__(BRUTE_BLOCK)
tri_brute_kernel(const float* __restrict__ org4,
                 const float* __restrict__ dir4, const float* __restrict__ w,
                 int n_tiles, float t_min, float* __restrict__ out_t,
                 int* __restrict__ out_i) {
  __shared__ __align__(16) float ws[4 * 4 * TRI_TILE];
  const int r = blockIdx.x * BRUTE_BLOCK + threadIdx.x;
  const float ox = org4[4 * r], oy = org4[4 * r + 1], oz = org4[4 * r + 2],
              ow = org4[4 * r + 3];
  const float dx = dir4[4 * r], dy = dir4[4 * r + 1], dz = dir4[4 * r + 2],
              dw = dir4[4 * r + 3];
  const size_t width = (size_t)n_tiles * 4 * TRI_TILE;
  constexpr int TW = 4 * TRI_TILE;  // columns of one tile

  float best_t = BIG;
  int best_i = -1;
  for (int k = 0; k < n_tiles; ++k) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < TW; i += BRUTE_BLOCK) {  // float4 columns
      const int row = i / (TW / 4), col = 4 * (i % (TW / 4));
      *reinterpret_cast<float4*>(ws + row * TW + col) =
          *reinterpret_cast<const float4*>(w + row * width +
                                           (size_t)k * TW + col);
    }
    __syncthreads();
    // strict '<' in column order: the lowest index wins a tie in a tile,
    // the earlier tile wins a tie across tiles
    for (int j = 0; j < TRI_TILE; ++j) {
      float av[4], bv[4];
      for (int g = 0; g < 4; ++g) {
        const int col = g * TRI_TILE + j;
        const float w0 = ws[col], w1 = ws[TW + col], w2 = ws[2 * TW + col],
                    w3 = ws[3 * TW + col];
        av[g] = ox * w0 + oy * w1 + oz * w2 + ow * w3;
        bv[g] = dx * w0 + dy * w1 + dz * w2 + dw * w3;
      }
      const bool plane_ok = bv[0] <= -EPS;
      const float t = -av[0] / (plane_ok ? bv[0] : 1.0f);
      const bool valid = plane_ok && (av[1] + t * bv[1] >= 0.0f) &&
                         (av[2] + t * bv[2] >= 0.0f) &&
                         (av[3] + t * bv[3] >= 0.0f) && (t >= t_min);
      if (valid && t < best_t) {
        best_t = t;
        best_i = k * TRI_TILE + j;
      }
    }
  }
  out_t[r] = best_t;
  out_i[r] = best_t < BIG ? best_i : -1;
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

int srt_find_streamed(const int* lists, int list_stride, const float* rays,
                      const float* slabs, int n_supers, int sc, int ck,
                      const float* sph_pack, int n_sph_pad, int n_tris,
                      int ray_block, int n_blocks, float* out_t, int* out_i,
                      void* stream) {
  if (ray_block != STREAM_BLOCK || ck > MAX_CK || ck % 4 != 0 || sc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * 16 * ck * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        find_streamed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_blocks > 0) {
    find_streamed_kernel<<<n_blocks, STREAM_BLOCK, smem,
                           (cudaStream_t)stream>>>(
        lists, list_stride, rays, slabs, n_supers, sc, ck, sph_pack,
        n_sph_pad, n_tris, out_t, out_i);
  }
  return static_cast<int>(cudaGetLastError());
}

int srt_tri_brute(const float* org4, const float* dir4, const float* w,
                  int n_tiles, float t_min, int ray_block, int n_blocks,
                  float* out_t, int* out_i, void* stream) {
  if (ray_block != BRUTE_BLOCK || n_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks > 0) {
    tri_brute_kernel<<<n_blocks, BRUTE_BLOCK, 0, (cudaStream_t)stream>>>(
        org4, dir4, w, n_tiles, t_min, out_t, out_i);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
