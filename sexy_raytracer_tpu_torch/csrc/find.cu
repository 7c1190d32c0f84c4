// Ray queries for Hopper: the closest hit and the any hit over culled
// cluster worklists (one cluster walk). The brute-force triangle search
// (kernel 9) is csrc/brute.cu.
//
// Replaces the TPU kernels _find_kernel (sexy_raytracer_tpu/ops/pallas_find.py:170),
// _occluded_kernel (pallas_find.py:681) and _find_streamed_kernel
// (pallas_find.py:893). Layouts are documented in
// sexy_raytracer_tpu_torch/ops/find.py; the plain PyTorch versions there
// are the specification.
//
// The resident closest hit (kernel 1, 128-ray blocks over the per-ray
// cull's lists), the streamed closest hit (kernel 8, 256-ray blocks over the
// interval cull's lists) and the any hit (kernel 2) run one cluster walk,
// below. What bounds them is the test loop (~37 float32 operations per
// ray-triangle test, built without FMA) times the tests the walk makes, and
// the latency of that loop's chain of dependent operations. The first
// ports tested every lane of a block on every tile the block visited, with
// one scalar load per plane/edge value and test: kernel 1 listed 3.3x and
// 16x the tests its rays need at bounces 1 and 2 of the frame, kernel 8
// 830x at the big frame's bounce 1. The walk tests a tile for a ray only
// where the ray's own slab test enters the cluster's padded box before its
// best t, skips what no ray of a warp needs, reads a triangle as four
// 16-byte words, and keeps the tiles coming through a ring of shared-memory
// stages that the copy engine fills, one bulk copy a tile. Kernels 8 and 2
// give each lane two rays, so that one triangle read serves two tests;
// kernel 1 gives each lane one ray and a 128-ray block four consumer warps
// and a two-stage ring, so that more warps hide the loop's latency (on the
// H100 that beat two rays a lane by 16-30% and 256-ray blocks at every
// bounce, PERF.md).
//
// Kernel 1 on the walk returns what the first kernel 1 returned: it visits
// the same tiles in the same order, and a ray skips a tile only where its
// best t lies at or below the block's entry distance into the (unpadded)
// cluster box, which the first kernel's block-wide early out also obeyed
// once every lane was there, or where the ray enters the padded box at or
// beyond its best t, where no hit in the box can be strictly nearer. What
// can differ is a hit within float32 rounding of a box face and of the
// best t at once: a near tie.
//
// Kernel 2 takes the live rays only, regrouped into dense blocks: a pass
// before the cull (srt_any_regroup) tests the occluder spheres and moves
// the rays they, or a negative bound, resolve behind the live ones.
//
// The arithmetic keeps the JAX package's formulas and evaluation order. The
// library is built with -fmad=false and without fast math, so nothing is
// contracted into an FMA, and '/' and sqrtf round as IEEE: a kernel returns
// the same prim ids and t bits as its plain version.

#include <cuda_runtime.h>

#include "pipeline.cuh"

namespace {

constexpr int RAY_BLOCK = 128;
constexpr int MAX_CK = 512;
constexpr float BIG = (float)3.0e38;  // rounded from the double, as torch
constexpr float EPS = 1.1920928955078125e-07f;  // FLT_EPSILON

struct Ray {
  float ox, oy, oz, dx, dy, dz, tm, t_min;
};

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

// --- the cluster walk of kernels 1, 8 and 2 ---------------------------------
//
// One block per worklist row of CW * 32 * R rays: CW consumer warps, each
// lane holding R rays in registers, and one producer warp. The row lists
// 256-triangle clusters front to back by block-min entry distance. The
// triangle pack is [NC, CK, 16], a triangle's 16 floats (n d | q0 c0 | q1
// c1 | q2 c2) four float4 words; one lane of the producer warp copies a
// cluster's 16 KB tile into a ring of STAGES shared-memory stages with one
// bulk copy, whose bytes complete the stage's "full" mbarrier; each consumer
// warp waits on it, tests, and releases the stage on its "empty" mbarrier.
// Warps do not wait for each other except through the ring.
//
// At every tile a ray is live when its best t (its any-hit bound) lies
// beyond the tile's entry distance and its own slab test enters the
// cluster's padded box before that t. Before the walk the consumer warps
// mark the tiles that some ray of the block is live for at its first best
// t (a bit per list entry in shared memory); the bests only fall, so no
// other tile can ever be live, and the producer copies only marked tiles.
// A warp with no live ray skips a tile; a warp with no ray beyond the
// entry distance is done (the entries ascend), and once every warp is done
// the producer stops. Inside a tile a warp skips a triangle that no live
// ray faces (a warp vote on the plane test), and an any-hit ray that finds
// an occluder stops being live (a predicate, not a break).

// stages of the ring and rays a consumer lane: kernels 8 and 2 run three
// stages and two rays a lane; kernel 1 two stages and one ray a lane
constexpr int WALK_STAGES = 3;
constexpr int RPT = 2;
constexpr int CLOSEST_STAGES = 2;
constexpr int CLOSEST_RPT = 1;
// consumer warps of the 128-ray blocks (kernels 2 and 1) and of kernel 8's
constexpr int ANY_WARPS = RAY_BLOCK / (32 * RPT);
constexpr int CLOSEST_WARPS = RAY_BLOCK / (32 * CLOSEST_RPT);
constexpr int STREAM_WARPS = 4;
constexpr unsigned FULL_MASK = 0xffffffffu;

struct LaneRay {
  float o[3], d[3], inv[3], t_min;
};

__device__ __forceinline__ LaneRay lane_ray(const float* __restrict__ p) {
  LaneRay r;
  for (int a = 0; a < 3; ++a) {
    r.o[a] = p[a];
    r.d[a] = p[3 + a];
    r.inv[a] = 1.0f / (r.d[a] == 0.0f ? 1.0f : r.d[a]);
  }
  r.t_min = p[7];
  return r;
}

// The ray's slab test against a padded cluster box (lo xyz, -, hi xyz, -),
// in the per-ray cull's formulas (ops/find.py _lane_enters): does it enter
// the box before `best`?
__device__ __forceinline__ bool lane_enters(const LaneRay& r,
                                            const float* box, float best) {
  float t_near = r.t_min, t_far = BIG;
  for (int a = 0; a < 3; ++a) {
    const float lo = box[a], hi = box[4 + a];
    const float near = (lo - r.o[a]) * r.inv[a];
    const float far = (hi - r.o[a]) * r.inv[a];
    float lo_t = fminf(near, far), hi_t = fmaxf(near, far);
    if (r.d[a] == 0.0f) {
      const bool inside = (r.o[a] >= lo) && (r.o[a] <= hi);
      lo_t = inside ? -BIG : BIG;
      hi_t = inside ? BIG : -BIG;
    }
    t_near = fmaxf(t_near, lo_t);
    t_far = fminf(t_far, hi_t);
  }
  return (t_far > t_near) && (t_near < best);
}

__device__ __forceinline__ bool marked(const unsigned* need, int k) {
  return (need[k >> 5] >> (k & 31)) & 1u;
}

// Producer lane: the marked tiles of `row` into the ring, one bulk copy
// each, stopping where every consumer warp is done (then it completes that
// stage's full barrier with no data and leaves `stop` for the consumers).
template <int STAGES>
__device__ __forceinline__ void walk_produce(
    const int* row, int count, const unsigned* need,
    const float* __restrict__ tri_pack, int ck, float* stages,
    unsigned long long* full, unsigned long long* empty,
    volatile int* live_warps, volatile int* stop) {
  const unsigned bytes = 16u * ck * sizeof(float);
  for (int k = 0, i = 0; k < count; ++k) {
    if (!marked(need, k)) continue;
    // the i-th copied tile goes to stage i % STAGES
    const int s = i % STAGES;
    const unsigned ph = (i / STAGES) & 1;
    if (i >= STAGES) mbar_wait(&empty[s], ph ^ 1);
    if (*live_warps == 0) {
      *stop = i;
      mbar_arrive(&full[s]);
      return;
    }
    mbar_arrive_expect_tx(&full[s], bytes);
    bulk_load(stages + (size_t)s * 16 * ck,
              tri_pack + (size_t)row[1 + k] * 16 * ck, bytes, &full[s]);
    ++i;
  }
}

// Consumer warps, before the walk: mark the list entries that some ray of
// the warp is live for at its first best t (R rays a lane).
template <int R>
__device__ __forceinline__ void walk_mark(const int* row, int count,
                                          int n_clusters,
                                          const float* __restrict__ boxes,
                                          const LaneRay* ray,
                                          const float* best,
                                          unsigned* need) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < count; ++k) {
    const int entry = row[1 + n_clusters + k];
    const float4* b4 = reinterpret_cast<const float4*>(boxes) + 2 * row[1 + k];
    const float4 b0 = __ldg(b4), b1 = __ldg(b4 + 1);
    const float box[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    bool live = false;
    for (int q = 0; q < R; ++q)
      live |= __float_as_int(best[q]) > entry &&
              lane_enters(ray[q], box, best[q]);
    if (__any_sync(FULL_MASK, live) && lane == 0)
      atomicOr(&need[k >> 5], 1u << (k & 31));
  }
}

// Consumer warp: R rays a lane. best[] holds each ray's best t (ANY: its
// bound, negative once resolved), besti[] its prim id (closest hit).
template <bool ANY, int STAGES, int R>
__device__ __forceinline__ void walk_consume(
    const int* row, int count, const unsigned* need, int n_clusters, int ck,
    const float* __restrict__ boxes, const float* stages,
    unsigned long long* full, unsigned long long* empty,
    volatile int* live_warps, volatile int* stop, const LaneRay* ray,
    float* best, int* besti) {
  const int lane = threadIdx.x & 31;
  bool done = false;
  for (int k = 0, i = 0; k < count; ++k) {
    if (!marked(need, k)) continue;
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    if (*stop == i) break;
    if (!done) {
      const int entry = row[1 + n_clusters + k];
      bool cand[R], any_cand = false;
      for (int q = 0; q < R; ++q) {
        cand[q] = __float_as_int(best[q]) > entry;
        any_cand |= cand[q];
      }
      if (!__any_sync(FULL_MASK, any_cand)) {
        done = true;
        if (lane == 0) atomicSub((int*)live_warps, 1);
      } else {
        const int c = row[1 + k];
        float box[8];
        const float4 b0 = __ldg(reinterpret_cast<const float4*>(boxes) + 2 * c);
        const float4 b1 =
            __ldg(reinterpret_cast<const float4*>(boxes) + 2 * c + 1);
        box[0] = b0.x; box[1] = b0.y; box[2] = b0.z; box[3] = b0.w;
        box[4] = b1.x; box[5] = b1.y; box[6] = b1.z; box[7] = b1.w;
        bool live[R], any_live = false;
        for (int q = 0; q < R; ++q) {
          live[q] = cand[q] && lane_enters(ray[q], box, best[q]);
          any_live |= live[q];
        }
        if (__any_sync(FULL_MASK, any_live)) {
          const float4* tile =
              reinterpret_cast<const float4*>(stages + (size_t)s * 16 * ck);
          const int base = c * ck;
#pragma unroll 2
          for (int j = 0; j < ck; ++j) {
            const float4 nd = tile[4 * j], q0 = tile[4 * j + 1],
                         q1 = tile[4 * j + 2], q2 = tile[4 * j + 3];
            float ndir[R];
            bool facing = false;
            for (int q = 0; q < R; ++q) {
              ndir[q] = ray[q].d[0] * nd.x + ray[q].d[1] * nd.y +
                        ray[q].d[2] * nd.z;
              facing |= live[q] && (ndir[q] <= -EPS);
            }
            if (!__any_sync(FULL_MASK, facing)) continue;
            for (int q = 0; q < R; ++q) {
              const LaneRay& r = ray[q];
              const float a_n =
                  r.o[0] * nd.x + r.o[1] * nd.y + r.o[2] * nd.z + nd.w;
              const bool plane_ok = ndir[q] <= -EPS;
              const float t = -a_n / (plane_ok ? ndir[q] : -1.0f);
              const float px = r.o[0] + t * r.d[0];
              const float py = r.o[1] + t * r.d[1];
              const float pz = r.o[2] + t * r.d[2];
              const float e0 = q0.x * px + q0.y * py + q0.z * pz - q0.w;
              const float e1 = q1.x * px + q1.y * py + q1.z * pz - q1.w;
              const float e2 = q2.x * px + q2.y * py + q2.z * pz - q2.w;
              const bool valid = live[q] && plane_ok && (e0 >= 0.0f) &&
                                 (e1 >= 0.0f) && (e2 >= 0.0f) &&
                                 (t >= r.t_min) && (t < best[q]);
              if (valid) {
                if (ANY) {
                  best[q] = -BIG;
                  live[q] = false;
                } else {
                  // strict '<' in triangle order: the lowest id wins a
                  // tie in a tile, the earlier tile across tiles
                  best[q] = t;
                  besti[q] = base + j;
                }
              }
            }
            if (ANY) {
              bool still = false;
              for (int q = 0; q < R; ++q) still |= live[q];
              if (!__any_sync(FULL_MASK, still)) break;
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    ++i;
  }
}

// Shared memory of a walk block: the ring, then its barriers and flags.
struct WalkShared {
  float* stages;
  unsigned long long* full;
  unsigned long long* empty;
  int* live_warps;
  int* stop;
  unsigned* need;  // a bit per list entry: copy this tile
};

template <int STAGES>
__device__ __forceinline__ WalkShared walk_shared(float* smem, int ck,
                                                  int consumers,
                                                  int n_clusters) {
  WalkShared w;
  w.stages = smem;
  w.full = reinterpret_cast<unsigned long long*>(
      smem + (size_t)STAGES * 16 * ck);
  w.empty = w.full + STAGES;
  w.live_warps = reinterpret_cast<int*>(w.empty + STAGES);
  w.stop = w.live_warps + 1;
  w.need = reinterpret_cast<unsigned*>(w.stop + 1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&w.full[s], 1);
      mbar_init(&w.empty[s], consumers);
    }
    mbar_init_fence();
    *w.live_warps = consumers;
    *w.stop = -1;
  }
  for (int i = threadIdx.x; i < (n_clusters + 31) / 32; i += blockDim.x)
    w.need[i] = 0u;
  __syncthreads();
  return w;
}

// The closest hit, CW consumer warps of R rays a lane: kernel 1 (CW = 4,
// R = 1, two stages) and kernel 8 (CW = 4, R = 2, three stages).
template <int CW, int STAGES, int R>
__global__ void __launch_bounds__((CW + 1) * 32)
find_closest_kernel(const int* __restrict__ lists, int list_stride,
                    const float* __restrict__ rays,
                    const float* __restrict__ tri_pack, int n_clusters,
                    int ck, const float* __restrict__ boxes,
                    const float* __restrict__ sph_pack, int n_sph_pad,
                    int n_tris, float* __restrict__ out_t,
                    int* __restrict__ out_i) {
  extern __shared__ __align__(128) float smem[];
  const WalkShared w = walk_shared<STAGES>(smem, ck, CW, n_clusters);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* row = lists + (size_t)blockIdx.x * list_stride;
  const int count = n_tris > 0 ? row[0] : 0;
  LaneRay ray[R];
  float best[R];
  int besti[R], rid[R];
  for (int q = 0; q < R && warp < CW; ++q) {
    rid[q] = blockIdx.x * (CW * 32 * R) + warp * 32 * R + q * 32 + lane;
    const float* p = rays + (size_t)rid[q] * 8;
    ray[q] = lane_ray(p);
    // spheres first (pallas_find.py:94-133): the lowest index among the
    // nearest roots; a triangle must be strictly nearer to replace it
    Ray sr;
    sr.ox = ray[q].o[0]; sr.oy = ray[q].o[1]; sr.oz = ray[q].o[2];
    sr.dx = ray[q].d[0]; sr.dy = ray[q].d[1]; sr.dz = ray[q].d[2];
    sr.tm = p[6]; sr.t_min = ray[q].t_min;
    const float a = sr.dx * sr.dx + sr.dy * sr.dy + sr.dz * sr.dz;
    float bt = BIG;
    int bs = 0;
    for (int s = 0; s < n_sph_pad; ++s) {
      const float tc = sphere_tc(sph_pack + 8 * s, sr, a);
      if (tc < bt) { bt = tc; bs = s; }
    }
    best[q] = bt;
    besti[q] = bt < BIG ? n_tris + bs : -1;
  }
  if (warp < CW)
    walk_mark<R>(row, count, n_clusters, boxes, ray, best, w.need);
  __syncthreads();
  if (warp == CW) {
    if (lane == 0)
      walk_produce<STAGES>(row, count, w.need, tri_pack, ck, w.stages, w.full,
                           w.empty, w.live_warps, w.stop);
    return;
  }
  walk_consume<false, STAGES, R>(row, count, w.need, n_clusters, ck, boxes,
                              w.stages, w.full, w.empty, w.live_warps, w.stop,
                              ray, best, besti);
  for (int q = 0; q < R; ++q) {
    out_t[rid[q]] = best[q];
    out_i[rid[q]] = best[q] < BIG ? besti[q] : -1;
  }
}

// rays [Rpad, 9]: the wavefront regrouped so that live rays come first (in
// wavefront order); column 8 is the bound, negative for a ray resolved
// before any triangle work (dead, or occluded by a sphere). perm[r] is the
// wavefront index of regrouped ray r, where its flag goes.
template <int CW>
__global__ void __launch_bounds__((CW + 1) * 32)
find_any_kernel(const int* __restrict__ lists, int list_stride,
                const float* __restrict__ rays, const int* __restrict__ perm,
                const float* __restrict__ tri_pack, int n_clusters, int ck,
                const float* __restrict__ boxes, int n_tris,
                int* __restrict__ out) {
  extern __shared__ __align__(128) float smem[];
  const WalkShared w = walk_shared<WALK_STAGES>(smem, ck, CW, n_clusters);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* row = lists + (size_t)blockIdx.x * list_stride;
  // a block of resolved rays has an empty list and leaves at once
  const int count = n_tris > 0 ? row[0] : 0;
  LaneRay ray[RPT];
  float bound[RPT];
  int unused[RPT], rid[RPT];
  for (int q = 0; q < RPT && warp < CW; ++q) {
    rid[q] = blockIdx.x * (CW * 32 * RPT) + warp * 32 * RPT + q * 32 + lane;
    const float* p = rays + (size_t)rid[q] * 9;
    ray[q] = lane_ray(p);
    bound[q] = p[8];
  }
  if (warp < CW)
    walk_mark<RPT>(row, count, n_clusters, boxes, ray, bound, w.need);
  __syncthreads();
  if (warp == CW) {
    if (lane == 0)
      walk_produce<WALK_STAGES>(row, count, w.need, tri_pack, ck, w.stages,
                                w.full, w.empty, w.live_warps, w.stop);
    return;
  }
  walk_consume<true, WALK_STAGES, RPT>(row, count, w.need, n_clusters, ck,
                                       boxes, w.stages, w.full, w.empty,
                                       w.live_warps, w.stop, ray, bound,
                                       unused);
  for (int q = 0; q < RPT; ++q) out[perm[rid[q]]] = bound[q] < 0.0f ? 1 : 0;
}

size_t walk_smem_bytes(int stages, int ck, int n_clusters) {
  return (size_t)stages * 16 * ck * sizeof(float) +
         2 * stages * sizeof(unsigned long long) + 2 * sizeof(int) +
         (size_t)(n_clusters + 31) / 32 * sizeof(unsigned);
}

// Raise a walk kernel's dynamic shared memory limit to `bytes` on the
// current device. The attribute is per device, so it is set at every
// launch (a host call of about a microsecond).
template <typename F>
cudaError_t walk_smem_limit(F kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Launch the closest-hit walk: CW consumer warps of R rays a lane, STAGES
// stages.
template <int CW, int STAGES, int R>
cudaError_t launch_closest(const int* lists, int list_stride,
                           const float* rays, const float* tri_pack,
                           int n_clusters, int ck, const float* boxes,
                           const float* sph_pack, int n_sph_pad, int n_tris,
                           int n_blocks, float* out_t, int* out_i,
                           cudaStream_t stream) {
  const size_t smem = walk_smem_bytes(STAGES, ck, n_clusters);
  cudaError_t err =
      walk_smem_limit(find_closest_kernel<CW, STAGES, R>, smem);
  if (err != cudaSuccess) return err;
  if (n_blocks > 0) {
    find_closest_kernel<CW, STAGES, R>
        <<<n_blocks, (CW + 1) * 32, smem, stream>>>(
        lists, list_stride, rays, tri_pack, n_clusters, ck, boxes, sph_pack,
        n_sph_pad, n_tris, out_t, out_i);
  }
  return cudaGetLastError();
}

// --- kernel 2's regrouping pass ----------------------------------------------
//
// The occluder-sphere test of _occluded_kernel (pallas_find.py:689-728) and
// a stable partition of the wavefront, live rays first, each part in
// wavefront order: a flag-and-count pass over blocks of REGROUP_BLOCK rays,
// a one-block scan of the block counts and a scatter, launched from one C
// call. Written out: the padded [Rpad, 9] ray table regrouped (column 8
// -3e38 for a resolved ray), perm (the wavefront index of each regrouped
// ray) and the cull's t_min and t_max (3e38 and 0 for a resolved ray).

constexpr int REGROUP_BLOCK = 256;
constexpr int SCAN_THREADS = 1024;

// the ray's bound stays (it is live) unless it is negative, or an occluder
// sphere's nearest valid root lies before it
__device__ __forceinline__ bool ray_live(const float* __restrict__ org,
                                         const float* __restrict__ dir,
                                         const float* __restrict__ time,
                                         const float* __restrict__ t_min,
                                         float bound, int i,
                                         const float* __restrict__ sph_pack,
                                         int n_sph_pad) {
  if (bound < 0.0f) return false;
  Ray ray;
  ray.ox = org[3 * i]; ray.oy = org[3 * i + 1]; ray.oz = org[3 * i + 2];
  ray.dx = dir[3 * i]; ray.dy = dir[3 * i + 1]; ray.dz = dir[3 * i + 2];
  ray.tm = time[i];
  ray.t_min = t_min[i];
  const float a = ray.dx * ray.dx + ray.dy * ray.dy + ray.dz * ray.dz;
  for (int s = 0; s < n_sph_pad; ++s) {
    const float tc = sphere_tc(sph_pack + 8 * s, ray, a);
    if (tc < bound && tc < BIG) return false;
  }
  return true;
}

// the live rays of each thread's warp before it, and of the block's warps
// before its warp (every thread of the block calls this)
__device__ __forceinline__ int block_rank(bool live, int* warp_live) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(FULL_MASK, live);
  if (lane == 0) warp_live[warp] = __popc(bal);
  __syncthreads();
  int before = __popc(bal & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) before += warp_live[w];
  return before;
}

__global__ void __launch_bounds__(REGROUP_BLOCK)
regroup_flag_kernel(const float* __restrict__ org,
                    const float* __restrict__ dir,
                    const float* __restrict__ time,
                    const float* __restrict__ t_min,
                    const float* __restrict__ t_bound, int n_rays,
                    const float* __restrict__ sph_pack, int n_sph_pad,
                    int n_pad, int* __restrict__ live,
                    int* __restrict__ block_live) {
  __shared__ int warp_live[REGROUP_BLOCK / 32];
  const int i = blockIdx.x * REGROUP_BLOCK + threadIdx.x;
  const bool is_live = i < n_rays && ray_live(org, dir, time, t_min,
                                              t_bound[i], i, sph_pack,
                                              n_sph_pad);
  if (i < n_pad) live[i] = is_live ? 1 : 0;
  const int before = block_rank(is_live, warp_live);
  if (threadIdx.x == REGROUP_BLOCK - 1)
    block_live[blockIdx.x] = before + (is_live ? 1 : 0);
}

// block_off[b]: the live rays of blocks before b; block_off[n_blocks]: all
__global__ void __launch_bounds__(SCAN_THREADS)
regroup_scan_kernel(const int* __restrict__ block_live, int n_blocks,
                    int* __restrict__ block_off) {
  __shared__ int sums[SCAN_THREADS];
  const int tid = threadIdx.x;
  const int per = (n_blocks + SCAN_THREADS - 1) / SCAN_THREADS;
  const int b0 = min(tid * per, n_blocks);
  const int b1 = min(b0 + per, n_blocks);
  int s = 0;
  for (int b = b0; b < b1; ++b) s += block_live[b];
  sums[tid] = s;
  __syncthreads();
  for (int off = 1; off < SCAN_THREADS; off <<= 1) {
    const int v = tid >= off ? sums[tid - off] : 0;
    __syncthreads();
    sums[tid] += v;
    __syncthreads();
  }
  int run = tid > 0 ? sums[tid - 1] : 0;
  for (int b = b0; b < b1; ++b) {
    block_off[b] = run;
    run += block_live[b];
  }
  if (tid == SCAN_THREADS - 1) block_off[n_blocks] = sums[tid];
}

__global__ void __launch_bounds__(REGROUP_BLOCK)
regroup_scatter_kernel(const float* __restrict__ org,
                       const float* __restrict__ dir,
                       const float* __restrict__ time,
                       const float* __restrict__ t_min,
                       const float* __restrict__ t_bound, int n_rays,
                       int n_pad, const int* __restrict__ live,
                       const int* __restrict__ block_off, int n_blocks,
                       float* __restrict__ rays_out, int* __restrict__ perm,
                       float* __restrict__ cull_t_min,
                       float* __restrict__ cull_t_max) {
  __shared__ int warp_live[REGROUP_BLOCK / 32];
  const int i = blockIdx.x * REGROUP_BLOCK + threadIdx.x;
  const bool is_live = i < n_pad && live[i] != 0;
  const int before = block_off[blockIdx.x] + block_rank(is_live, warp_live);
  if (i >= n_pad) return;
  // live rays in wavefront order, then the resolved ones in theirs
  const int dst = is_live ? before : block_off[n_blocks] + (i - before);
  // a pad ray (past n_rays) is dead: t_min 3e38, bound -3e38
  float v[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, BIG, -BIG};
  if (i < n_rays) {
    for (int a = 0; a < 3; ++a) {
      v[a] = org[3 * i + a];
      v[3 + a] = dir[3 * i + a];
    }
    v[6] = time[i];
    v[7] = t_min[i];
    v[8] = is_live ? t_bound[i] : -BIG;
  }
  float* out = rays_out + (size_t)dst * 9;
  for (int c = 0; c < 9; ++c) out[c] = v[c];
  perm[dst] = i;
  cull_t_min[dst] = is_live ? v[7] : BIG;
  cull_t_max[dst] = is_live ? v[8] : 0.0f;
}

}  // namespace

extern "C" {

const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Kernel 1: rows of 128 rays, four consumer warps of one ray a lane, a
// two-stage ring.
int srt_find_closest(const int* lists, int list_stride, const float* rays,
                     const float* tri_pack, int n_clusters, int ck,
                     const float* boxes, const float* sph_pack, int n_sph_pad,
                     int n_tris, int ray_block, int n_blocks, float* out_t,
                     int* out_i, void* stream) {
  if (ray_block != RAY_BLOCK || ck > MAX_CK || ck % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_closest<CLOSEST_WARPS, CLOSEST_STAGES, CLOSEST_RPT>(
          lists, list_stride, rays, tri_pack, n_clusters, ck, boxes, sph_pack,
          n_sph_pad, n_tris, n_blocks, out_t, out_i, (cudaStream_t)stream));
}

// Kernel 2 takes rows of 128 rays (two consumer warps), kernel 8 rows of
// 256 (four).
int srt_find_any(const int* lists, int list_stride, const float* rays,
                 const int* perm, const float* tri_pack, int n_clusters,
                 int ck, const float* boxes, int n_tris, int ray_block,
                 int n_blocks, int* out, void* stream) {
  if (ray_block != RAY_BLOCK || ck > MAX_CK || ck % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = walk_smem_bytes(WALK_STAGES, ck, n_clusters);
  cudaError_t err = walk_smem_limit(find_any_kernel<ANY_WARPS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks > 0) {
    find_any_kernel<ANY_WARPS>
        <<<n_blocks, (ANY_WARPS + 1) * 32, smem, (cudaStream_t)stream>>>(
            lists, list_stride, rays, perm, tri_pack, n_clusters, ck, boxes,
            n_tris, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel 2's regrouping pass; scratch holds n_pad + 2 ceil(n_pad / 256) + 1
// ints.
int srt_any_regroup(const float* org, const float* dir, const float* time,
                    const float* t_min, const float* t_bound, int n_rays,
                    const float* sph_pack, int n_sph_pad, int n_pad,
                    int* scratch, float* rays_out, int* perm,
                    float* cull_t_min, float* cull_t_max, void* stream) {
  if (n_rays < 0 || n_pad < n_rays || n_sph_pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = (n_pad + REGROUP_BLOCK - 1) / REGROUP_BLOCK;
  int* live = scratch;
  int* block_live = scratch + n_pad;
  int* block_off = block_live + n_blocks;  // n_blocks + 1
  if (n_blocks > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    regroup_flag_kernel<<<n_blocks, REGROUP_BLOCK, 0, s>>>(
        org, dir, time, t_min, t_bound, n_rays, sph_pack, n_sph_pad, n_pad,
        live, block_live);
    regroup_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(block_live, n_blocks,
                                                   block_off);
    regroup_scatter_kernel<<<n_blocks, REGROUP_BLOCK, 0, s>>>(
        org, dir, time, t_min, t_bound, n_rays, n_pad, live, block_off,
        n_blocks, rays_out, perm, cull_t_min, cull_t_max);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel 8: rows of 256 rays, three stages.
int srt_find_streamed(const int* lists, int list_stride, const float* rays,
                      const float* tri_pack, int n_clusters, int ck,
                      const float* boxes, const float* sph_pack,
                      int n_sph_pad, int n_tris, int ray_block, int n_blocks,
                      float* out_t, int* out_i, void* stream) {
  if (ray_block != STREAM_WARPS * 32 * RPT || ck > MAX_CK || ck % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_closest<STREAM_WARPS, WALK_STAGES, RPT>(
      lists, list_stride, rays, tri_pack, n_clusters, ck, boxes, sph_pack,
      n_sph_pad, n_tris, n_blocks, out_t, out_i, (cudaStream_t)stream));
}

}  // extern "C"
