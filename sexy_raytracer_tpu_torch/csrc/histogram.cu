// Dense weighted histogram for Hopper: out[i, c] = sum of vals[r, c] over the
// entries r with idx[r] == i, summed in ascending r.
//
// Replaces the TPU kernel _direct_kernel (sexy_raytracer_tpu/ops/histogram.py:122,
// wrapper _dense_histogram_direct :161), the backward of the atlas gather and
// of the large packed-row tables (ops/lookup.py). The TPU kernel builds
// per-window chunk worklists and accumulates one-hot MXU products window by
// window, summing chunks in ascending order, so it is deterministic. Here
// the wrapper (sexy_raytracer_tpu_torch/ops/histogram.py) does the glue the
// JAX prologue does: it drops out-of-range ids and all-zero rows, stable-sorts
// the rest by bin and finds each bin's segment [starts[i], starts[i + 1]) of
// the sorted order. The kernel then gives one thread to each (bin, channel):
// the thread walks its segment in ascending entry order and writes its sum.
// No atomics, so two launches on the same inputs give the same bits, and the
// plain version, which adds in the same order, gives them too (the library
// is built with -fmad=false).
//
// Bound: device memory, reading idx and vals once and writing the table once;
// a bin's C channel threads are neighbours, so each gathered row of vals is
// one contiguous read. A bin with a long segment serialises its thread: the
// kernel is fast where entries spread over many bins (the atlas backward) and
// launch-bound at small tables.

#include <cuda_runtime.h>

namespace {

__global__ void histogram_kernel(const int* __restrict__ starts,
                                 const int* __restrict__ order,
                                 const float* __restrict__ vals, int n_bins,
                                 int C, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_bins * C) return;
  const int bin = (int)(t / C), c = (int)(t % C);
  const int s = starts[bin], e = starts[bin + 1];
  float acc = 0.0f;
  for (int j = s; j < e; ++j) acc += vals[(size_t)order[j] * C + c];
  out[t] = acc;
}

constexpr int THREADS = 256;

}  // namespace

extern "C" {

int srt_histogram(const int* starts, const int* order, const float* vals,
                  int n_bins, int C, float* out, void* stream) {
  const long long n = (long long)n_bins * C;
  if (n > 0) {
    histogram_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                       (cudaStream_t)stream>>>(starts, order, vals, n_bins, C,
                                               out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
