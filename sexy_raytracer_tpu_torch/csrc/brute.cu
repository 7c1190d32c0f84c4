// Kernel 9: the brute-force closest triangle over a plane/edge weight stack,
// for Hopper. Replaces _tri_kernel
// (sexy_raytracer_tpu/ops/pallas_intersect.py:53); the plain PyTorch
// version, ops/brute.py tri_brute_plain, is the specification.
//
// Every ray tests every triangle: per (ray, triangle) pair two 4-deep
// products for each of the four column groups (the plane n|d and the three
// edges q_i|-c_i), the divide t = -a_n / b_n and the three edge sums, at
// most 64 float32 operations, rounded one at a time (-fmad=false: no FMA
// contraction; IEEE divide). The products are 4 deep and must round as
// float32, so they run on the FP32 pipes, not the tensor cores (no float32
// wgmma; TF32 rounds the inputs). What bounds the kernel is the issue rate
// of those instructions and of what surrounds them, so the design cuts the
// instructions a test, and fills the card when the rays are few:
//
// * A triangle's 16 weights lie together (the wrapper packs the JAX layout
//   [4, 4 Tpad] into [Tpad, 16], ops/brute.py pack_weights), so a consumer
//   warp reads them as four broadcast 16-byte shared loads, the three edge
//   groups only when it needs them.
// * Each lane holds RPT rays, so that one triangle's registers serve RPT
//   tests.
// * The plane group first: a_n, b_n, then a range test with no divide
//   (range_maybe, proof in ops/brute.py range_maybe_plain) that fails only
//   where the exact test cannot take the triangle. Only where some lane of
//   the warp passes does the warp run the divide and the exact test, in
//   the first kernel's order of operations, an edge group at a time, each
//   behind a vote of its own (test_stage): no bit changes.
// * Where every ray of a warp is [o, 1], [d, 0] (as ray4 makes them) and a
//   stage's w3 words are all finite, the products drop the w x w3 multiply
//   and the d.w x w3 term: 12 of the 56 product operations, exactly
//   (dot_o, dot_d).
// * The triangle axis splits into `slices` runs of whole TRI_TILE tiles
//   (grid y) when the ray blocks alone would not fill the card; a second
//   kernel from the same C call merges each ray's partial (t, id) pairs in
//   slice order with the scan's strict '<', which is what one scan in index
//   order returns (the smallest t, the lowest id on an equal t).
// * One producer lane bulk-copies each stage of STAGE_TRIS packed triangles
//   into a ring of STAGES shared-memory stages (pipeline.cuh); the consumer
//   warps wait on a stage's full barrier and release it on its empty one.
//   Three stages beat one by ~2% with the unit products (the seven blocks
//   an SM hide most of a one-stage ring's waits; PERF.md).

#include <cuda_runtime.h>

#include <cstring>

#include "pipeline.cuh"

namespace {

constexpr int BRUTE_BLOCK = 256;   // rays a block (ops/brute.py RAY_BLOCK)
constexpr int TRI_TILE = 512;      // triangles a tile; a slice is whole tiles
constexpr int RPT = 2;             // rays a consumer lane
constexpr int WARPS = BRUTE_BLOCK / (32 * RPT);  // consumer warps
constexpr int STAGES = 3;          // stages of the ring
constexpr int STAGE_TRIS = 128;    // triangles a stage (8 KB)
constexpr int MIN_BLOCKS = 4;      // resident an SM at the least
constexpr int MERGE_BLOCK = 256;
constexpr float BIG = (float)3.0e38;  // rounded from the double, as torch
constexpr float EPS = 1.1920928955078125e-07f;  // FLT_EPSILON
constexpr float RANGE_TINY = 0x1p-100f;
constexpr unsigned FULL_MASK = 0xffffffffu;

static_assert(WARPS * 32 * RPT == BRUTE_BLOCK, "whole warps of rays");
static_assert(TRI_TILE % STAGE_TRIS == 0, "a tile is whole stages");

__host__ __device__ __forceinline__ float from_bits(unsigned u) {
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}

__host__ __device__ __forceinline__ unsigned to_bits(float f) {
  unsigned u;
  memcpy(&u, &f, sizeof u);
  return u;
}

// The range test's bounds (ops/brute.py far_bound, near_bound): best t two
// ulps up, else +inf; t_min three ulps down, else NaN.
__host__ __device__ __forceinline__ float far_bound(float best_t) {
  return best_t >= RANGE_TINY ? from_bits(to_bits(best_t) + 2u)
                              : from_bits(0x7f800000u);
}

__host__ __device__ __forceinline__ float near_bound(float t_min) {
  return t_min >= RANGE_TINY ? from_bits(to_bits(t_min) - 3u)
                             : from_bits(0x7fffffffu);
}

// 4-deep products in the first kernel's order: ((x w0 + y w1) + z w2) +
// w w3. UNIT: the ray's w is 1 (org) or 0 (dir) and w3 is finite, so the
// last term is w3 itself (1 x w3 = w3) or +-0 (0 x w3), which changes no
// outcome: x + +-0 = x but for the sign of a zero, and a zero b is never
// divided by (plane_ok needs b_n <= -EPS) and leaves a + t b at a, whose
// test (>= 0) takes either zero.
template <bool UNIT>
__device__ __forceinline__ float dot_o(const float4& o, const float4& w) {
  return UNIT ? o.x * w.x + o.y * w.y + o.z * w.z + w.w
              : o.x * w.x + o.y * w.y + o.z * w.z + o.w * w.w;
}

template <bool UNIT>
__device__ __forceinline__ float dot_d(const float4& d, const float4& w) {
  return UNIT ? d.x * w.x + d.y * w.y + d.z * w.z
              : d.x * w.x + d.y * w.y + d.z * w.z + d.w * w.w;
}

// One stage of STAGE_TRIS triangles (their first id `base`) for a warp's
// RPT rays a lane. The exact test is the first kernel's AND of plane_ok,
// the three edges, t >= t_min and t < best t, each operand computed as
// there; a warp evaluates its operands in turns, each behind a vote that
// ends the triangle once no lane can still be taken: the range test
// (before the divide), then the plane, t and edge 0, edge 1, edge 2.
template <bool UNIT>
__device__ __forceinline__ void test_stage(const float4* tile, int base,
                                           const float4* o, const float4* d,
                                           float t_min, float lo,
                                           const float* hi, float* best,
                                           int* besti) {
#pragma unroll 2
  for (int j = 0; j < STAGE_TRIS; ++j) {
    const float4 wn = tile[4 * j];
    float an[RPT], bn[RPT];
    bool live = false;
    for (int q = 0; q < RPT; ++q) {
      an[q] = dot_o<UNIT>(o[q], wn);
      bn[q] = dot_d<UNIT>(d[q], wn);
      // range_maybe: plane_ok and a_n strictly inside (lo B, hi B)
      const float nb = -bn[q];
      live |= (bn[q] <= -EPS) && (an[q] < hi[q] * nb) &&
              !(an[q] <= lo * nb);
    }
    if (!__any_sync(FULL_MASK, live)) continue;
    float t[RPT];
    bool ok[RPT];
    const float4 w1 = tile[4 * j + 1];
    live = false;
    for (int q = 0; q < RPT; ++q) {
      const bool plane_ok = bn[q] <= -EPS;
      t[q] = -an[q] / (plane_ok ? bn[q] : 1.0f);
      const float a1 = dot_o<UNIT>(o[q], w1), b1 = dot_d<UNIT>(d[q], w1);
      ok[q] = plane_ok && (t[q] >= t_min) && (t[q] < best[q]) &&
              (a1 + t[q] * b1 >= 0.0f);
      live |= ok[q];
    }
    if (!__any_sync(FULL_MASK, live)) continue;
    const float4 w2 = tile[4 * j + 2];
    live = false;
    for (int q = 0; q < RPT; ++q) {
      const float a2 = dot_o<UNIT>(o[q], w2), b2 = dot_d<UNIT>(d[q], w2);
      ok[q] = ok[q] && (a2 + t[q] * b2 >= 0.0f);
      live |= ok[q];
    }
    if (!__any_sync(FULL_MASK, live)) continue;
    const float4 w3 = tile[4 * j + 3];
    for (int q = 0; q < RPT; ++q) {
      const float a3 = dot_o<UNIT>(o[q], w3), b3 = dot_d<UNIT>(d[q], w3);
      // strict '<' in index order: the lowest id wins a tie
      if (ok[q] && a3 + t[q] * b3 >= 0.0f) {
        best[q] = t[q];
        besti[q] = base + j;
      }
    }
  }
}

// pack [Tpad, 16]: triangle j's float4 words n|d, q0|-c0, q1|-c1, q2|-c2 at
// 4j..4j+3; lo = near_bound(t_min). Block (x, y) takes rays
// x * BRUTE_BLOCK.. and slice y's tiles; it writes its (t, id) pairs to
// out_t/out_i + y * gridDim.x * BRUTE_BLOCK.
__global__ void __launch_bounds__((WARPS + 1) * 32, MIN_BLOCKS)
tri_brute_kernel(const float4* __restrict__ org4,
                 const float4* __restrict__ dir4,
                 const float4* __restrict__ pack, int n_tiles, float t_min,
                 float lo, float* __restrict__ out_t,
                 int* __restrict__ out_i) {
  __shared__ __align__(128) float4 ring[STAGES][4 * STAGE_TRIS];
  __shared__ __align__(8) unsigned long long full[STAGES], empty[STAGES];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slices = gridDim.y, s = blockIdx.y;
  const int k0 = (int)((long long)s * n_tiles / slices);
  const int k1 = (int)((long long)(s + 1) * n_tiles / slices);
  const int first = k0 * TRI_TILE;
  const int n_stages = (k1 - k0) * (TRI_TILE / STAGE_TRIS);
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == WARPS) {  // the producer lane
    if (lane == 0) {
      constexpr unsigned bytes = STAGE_TRIS * 4 * sizeof(float4);
      for (int i = 0; i < n_stages; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], bytes);
        bulk_load(ring[st], pack + (size_t)(first + i * STAGE_TRIS) * 4,
                  bytes, &full[st]);
      }
    }
    return;
  }

  float4 o[RPT], d[RPT];
  float best[RPT], hi[RPT];
  int besti[RPT], rid[RPT];
  bool unit = true;
  for (int q = 0; q < RPT; ++q) {
    rid[q] = blockIdx.x * BRUTE_BLOCK + warp * 32 * RPT + q * 32 + lane;
    o[q] = org4[rid[q]];
    d[q] = dir4[rid[q]];
    best[q] = BIG;
    besti[q] = -1;
    // a ray of ray4 ([o, 1], [d, 0]), or a pad ray (a zero direction:
    // b is +-0 or NaN, never plane_ok, whatever the weights)
    unit &= (o[q].w == 1.0f && d[q].w == 0.0f) ||
            (d[q].x == 0.0f && d[q].y == 0.0f && d[q].z == 0.0f &&
             d[q].w == 0.0f);
  }
  unit = __all_sync(FULL_MASK, unit);

  for (int i = 0; i < n_stages; ++i) {
    const int st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    const float4* tile = ring[st];
    // the far bound from each best t at the stage's start: the bests only
    // fall, so a bound from an earlier best lies above, and stays sound
    for (int q = 0; q < RPT; ++q) hi[q] = far_bound(best[q]);
    // the stage's w3 all finite (each lane looks at STAGE_TRIS / 32
    // triangles' four words)
    bool finite = true;
    for (int k = lane; k < 4 * STAGE_TRIS; k += 32)
      finite &= fabsf(tile[k].w) < from_bits(0x7f800000u);
    const int base = first + i * STAGE_TRIS;
    if (__all_sync(FULL_MASK, finite) && unit)
      test_stage<true>(tile, base, o, d, t_min, lo, hi, best, besti);
    else
      test_stage<false>(tile, base, o, d, t_min, lo, hi, best, besti);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  const size_t off = (size_t)s * gridDim.x * BRUTE_BLOCK;
  for (int q = 0; q < RPT; ++q) {
    out_t[off + rid[q]] = best[q];
    out_i[off + rid[q]] = best[q] < BIG ? besti[q] : -1;
  }
}

// Each ray's partials [slices, n] in slice order, strict '<' (a slice with
// no hit holds BIG and -1, which never replaces anything).
__global__ void __launch_bounds__(MERGE_BLOCK)
tri_brute_merge_kernel(const float* __restrict__ part_t,
                       const int* __restrict__ part_i, int slices, int n,
                       float* __restrict__ out_t, int* __restrict__ out_i) {
  const int r = blockIdx.x * MERGE_BLOCK + threadIdx.x;
  if (r >= n) return;
  float bt = part_t[r];
  int bi = part_i[r];
  for (int s = 1; s < slices; ++s) {
    const float t = part_t[(size_t)s * n + r];
    if (t < bt) {
      bt = t;
      bi = part_i[(size_t)s * n + r];
    }
  }
  out_t[r] = bt;
  out_i[r] = bi;
}

}  // namespace

extern "C" {

// Kernel 9: n_blocks blocks of 256 rays x `slices` runs of the n_tiles
// tiles; for slices > 1 the partials go to part_t/part_i [slices, n_blocks
// * 256] and the merge writes out_t/out_i.
int srt_tri_brute(const float* org4, const float* dir4, const float* pack,
                  int n_tiles, int slices, float t_min, int ray_block,
                  int n_blocks, float* part_t, int* part_i, float* out_t,
                  int* out_i, void* stream) {
  if (ray_block != BRUTE_BLOCK || n_tiles < 1 || slices < 1 ||
      slices > n_tiles || slices > 65535 || n_blocks < 0 ||
      (reinterpret_cast<size_t>(pack) & 15) ||
      (slices > 1 && (part_t == nullptr || part_i == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = (cudaStream_t)stream;
  const bool split = slices > 1;
  tri_brute_kernel<<<dim3(n_blocks, slices), (WARPS + 1) * 32, 0, st>>>(
      reinterpret_cast<const float4*>(org4),
      reinterpret_cast<const float4*>(dir4),
      reinterpret_cast<const float4*>(pack), n_tiles, t_min,
      near_bound(t_min), split ? part_t : out_t, split ? part_i : out_i);
  if (split) {
    const int n = n_blocks * BRUTE_BLOCK;
    tri_brute_merge_kernel<<<(n + MERGE_BLOCK - 1) / MERGE_BLOCK, MERGE_BLOCK,
                             0, st>>>(part_t, part_i, slices, n, out_t, out_i);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
