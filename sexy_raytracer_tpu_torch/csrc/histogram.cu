// Dense weighted histogram for Hopper: out[i, c] = sum of vals[r, c] over the
// entries r with idx[r] == i, summed in ascending r; and, further down, the
// placement kernel of the sort-based histogram (place_kernel).
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

constexpr int THREADS = 256;
// output bins per placement window (ops/histogram.py WIN)
constexpr long long PLACE_WIN = 2048;
constexpr int PLACE_THREADS = 512;

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

// Placement of the sorted histogram's segment sums: out[tex_u[e], c] =
// seg[e, c], every other row 0.
//
// Replaces the TPU kernel _place_kernel (sexy_raytracer_tpu/ops/histogram.py:59,
// wrapper _dense_histogram :270, reached through dense_histogram_sorted). The
// wrapper's glue (ops/histogram.py sorted_segments) does what the JAX
// prologue does: out-of-range ids to a sentinel, a stable sort by id, a
// float32 cumsum, one entry per unique id holding the cumsum at its segment's
// end, and the segment sums as differences of neighbouring entries. The TPU
// kernel then places each 2048-bin window with a one-hot MXU product over a
// regular [windows, 2048] gather of the entries; that layout only fed its
// BlockSpecs. Here the window bounds come from searchsorted on tex_u
// (win_starts, [n_windows + 1]), and one block owns one window: it zero-fills
// its [min(2048, n_bins - w 2048), C] slab of out, then writes the window's
// entries to their rows. tex_u is sorted and unique, so each entry owns one
// row of one window: no two threads write one address, no atomics, no sums,
// and the result is bit-equal to the plain version (zeros + index_copy_).
//
// Bound: device memory, writing the table once and reading tex_u and seg
// once. The zero fill is coalesced 16-byte stores, 512 threads a block; the
// placement reads seg coalesced and writes a row's C channels from
// neighbouring threads. Offsets are 64-bit (n_bins C reaches 6.3 M at the
// atlas shapes, and more past it).
__global__ void place_kernel(const int* __restrict__ tex_u,
                             const float* __restrict__ seg,
                             const int* __restrict__ win_starts, int n_bins,
                             int C, float* __restrict__ out) {
  const long long w = blockIdx.x;
  const long long row0 = w * PLACE_WIN;
  const long long left = (long long)n_bins - row0;
  const long long rows = left < PLACE_WIN ? left : PLACE_WIN;
  // the slab starts at a multiple of 2048 C floats: 16-byte aligned
  float* slab = out + row0 * C;
  const long long n = rows * C, n4 = n / 4;
  float4* slab4 = reinterpret_cast<float4*>(slab);
  for (long long i = threadIdx.x; i < n4; i += blockDim.x)
    slab4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long i = n4 * 4 + threadIdx.x; i < n; i += blockDim.x) slab[i] = 0.0f;
  __syncthreads();
  const long long e0 = win_starts[w], e1 = win_starts[w + 1];
  for (long long i = e0 * C + threadIdx.x; i < e1 * C; i += blockDim.x) {
    const long long e = i / C, c = i - e * C;
    out[(long long)tex_u[e] * C + c] = seg[i];
  }
}

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

int srt_place(const int* tex_u, const float* seg, const int* win_starts,
              int n_bins, int C, float* out, void* stream) {
  const long long n_windows = ((long long)n_bins + PLACE_WIN - 1) / PLACE_WIN;
  if (n_windows > 0 && C > 0) {
    place_kernel<<<(unsigned)n_windows, PLACE_THREADS, 0,
                   (cudaStream_t)stream>>>(
        tex_u, seg, win_starts, n_bins, C, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
