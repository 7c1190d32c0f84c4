// The integrator's random numbers for Hopper: threefry2x32 (20 rounds) in
// uint32 registers, bit for bit with jax.random and with the plain int64
// versions in utils/rng.py. Two entries, one launch each:
//
//   srt_rng_keys: one thread a path. keys[i] = fold_in(fold_in(base_key,
//     pid[i]), sid[i]) and ucam[i, j] = uniforms_from_bits(bits(keys[i],
//     5))[j]: 7 threefries (rng.ray_keys_and_camera, render_pixels' keys
//     and camera draws).
//   srt_rng_bounce: one thread a (path, bounce). out[i, b, j] =
//     uniforms_from_bits(bits(fold_in(keys[i], 100 + b), 6))[j]: 7
//     threefries (rng.bounce_draws, integrator.bounce_uniforms).
//
// Replaces no TPU kernel: the JAX package draws through jax.random, whose
// threefry XLA fused into its own loops on the TPU. Here the plain version
// ran each of the 20 rounds as separate int64 PyTorch ops over the whole
// batch (about 170 launches a threefry call, 8-byte words read and written
// by each), which made the RNG the largest device cost of a frame.
//
// Bound: integer operations, not bytes. A path needs 35 threefries of
// about 75 instructions each (a round is an add, a funnel-shift rotate and
// a xor; the key injections are three-input adds) against under 160 bytes
// of output; at the card's 64 INT32 lanes an SM that is about 0.1 ms for a
// 524,288-path batch, several times its write time. So the words stay in
// registers from the first add to the float conversion: no shared memory,
// no scratch, nothing written between rounds, each rotate one
// __funnelshift_l. The int64 words and data are read as their low 32 bits,
// as the plain version masks them, so negative data and 64-bit seeds give
// the same words; (w >> 8) * 2^-24 is exact in float32, so the draws are
// the plain version's bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float INV_2_24 = 1.0f / 16777216.0f;

struct Words {
  uint32_t x0, x1;
};

__device__ __forceinline__ void round_(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// threefry2x32 of the counter (x0, x1) under the key (k0, k1); the rounds
// and injections of utils/rng.py threefry2x32, unrolled.
__device__ __forceinline__ Words threefry(uint32_t k0, uint32_t k1,
                                          uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  round_(x0, x1, 13); round_(x0, x1, 15); round_(x0, x1, 26);
  round_(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  round_(x0, x1, 17); round_(x0, x1, 29); round_(x0, x1, 16);
  round_(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  round_(x0, x1, 13); round_(x0, x1, 15); round_(x0, x1, 26);
  round_(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  round_(x0, x1, 17); round_(x0, x1, 29); round_(x0, x1, 16);
  round_(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  round_(x0, x1, 13); round_(x0, x1, 15); round_(x0, x1, 26);
  round_(x0, x1, 6);
  x0 += k2; x1 += k0 + 5u;
  return Words{x0, x1};
}

// fold_in(k, d): threefry of the counter (0, d)
__device__ __forceinline__ Words fold_in(Words k, uint32_t d) {
  return threefry(k.x0, k.x1, 0u, d);
}

// the j-th word of bits(k, n) as a U[0, 1) float of 24 bits
__device__ __forceinline__ float draw(Words k, uint32_t j) {
  const Words y = threefry(k.x0, k.x1, 0u, j);
  return __uint2float_rn((y.x0 ^ y.x1) >> 8) * INV_2_24;
}

__device__ __forceinline__ uint32_t low_word(const void* p, int is64,
                                             long long i) {
  return is64 ? (uint32_t)static_cast<const long long*>(p)[i]
              : (uint32_t)static_cast<const int*>(p)[i];
}

__global__ void __launch_bounds__(THREADS)
    ray_keys_kernel(const long long* __restrict__ base_key,
                    const void* __restrict__ pid, int pid64,
                    const void* __restrict__ sid, int sid64, int R,
                    longlong2* __restrict__ keys, float* __restrict__ ucam) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= R) return;
  const Words base{(uint32_t)base_key[0], (uint32_t)base_key[1]};
  const Words k = fold_in(fold_in(base, low_word(pid, pid64, i)),
                          low_word(sid, sid64, i));
  keys[i] = make_longlong2((long long)k.x0, (long long)k.x1);
  float* u = ucam + i * 5;
#pragma unroll
  for (uint32_t j = 0; j < 5; ++j) u[j] = draw(k, j);
}

__global__ void __launch_bounds__(THREADS)
    bounce_kernel(const long long* __restrict__ keys, unsigned n,
                  unsigned B, float2* __restrict__ out) {
  const unsigned t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  const unsigned i = t / B;
  const uint32_t b = t - i * B;
  const Words k = fold_in(Words{(uint32_t)keys[2 * (long long)i],
                                (uint32_t)keys[2 * (long long)i + 1]},
                          100u + b);
  float2* o = out + (long long)t * 3;
#pragma unroll
  for (uint32_t j = 0; j < 3; ++j)
    o[j] = make_float2(draw(k, 2 * j), draw(k, 2 * j + 1));
}

}  // namespace

extern "C" {

// base_key [2] int64; pid, sid [R] int32 (flag 0) or int64 (flag 1); keys
// [R, 2] int64 and ucam [R, 5] float32 out, all contiguous.
int srt_rng_keys(const long long* base_key, const void* pid, int pid64,
                 const void* sid, int sid64, int R, long long* keys,
                 float* ucam, void* stream) {
  if (R < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = (unsigned)(((long long)R + THREADS - 1) / THREADS);
  ray_keys_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      base_key, pid, pid64, sid, sid64, R,
      reinterpret_cast<longlong2*>(keys), ucam);
  return static_cast<int>(cudaGetLastError());
}

// keys [R, 2] int64 in, out [R, B, 6] float32, both contiguous; R B below
// 2^31.
int srt_rng_bounce(const long long* keys, int R, int B, float* out,
                   void* stream) {
  const long long n = (long long)R * B;
  if (R < 0 || B < 0 || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  bounce_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      keys, (unsigned)n, (unsigned)B, reinterpret_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
