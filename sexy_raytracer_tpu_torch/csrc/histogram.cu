// Dense weighted histogram for Hopper: out[i, c] = sum of vals[r, c] over the
// entries r with idx[r] == i, dropping out-of-range ids and all-zero rows;
// and, further down, the placement kernel of the sort-based histogram
// (place_kernel).
//
// Replaces the TPU kernel _direct_kernel (sexy_raytracer_tpu/ops/histogram.py:122,
// wrapper _dense_histogram_direct :161), the backward of the atlas gather and
// of the large packed-row tables (ops/lookup.py). The TPU kernel cuts the
// entries into chunks, gives each 2048-bin window the ascending list of the
// chunks that touch it (a [windows, chunks] worklist), and adds one chunk's
// one-hot MXU product after the other. Here the same structure runs in three
// passes, launched by one C entry (srt_histogram) on the caller's stream,
// with no torch op around them:
//
//   A. chunk_reduce_kernel, one block per chunk of CHUNK entries: the block
//      stages its rows in shared memory, keeps the entries in range and not
//      all zero, sorts their (bin, entry) keys (a bitonic sort in registers
//      and warp shuffles; the keys are unique, so the order is the stable
//      one), and sums each run of one bin in ascending entry order, one
//      thread per (run, channel). It writes its ascending unique bins and
//      their partial sums at its own offset, and its column of the window
//      directory: its first run at or past each window's first bin (the
//      worklist's counterpart, written without a scatter).
//   B. window_combine_kernel, grid (windows, slices): block (w, s) reads
//      each chunk's part of window w from the directory, compacts the
//      chunks that touch it in ascending order, and adds their partials into
//      a shared [win, C] accumulator chunk by chunk, with the next DEPTH
//      chunks' loads in flight (a chunk's bins are unique: no atomics; a
//      barrier per chunk keeps the order). It writes every bin of its
//      window, zeros included: into out with one slice, else into slice s
//      of scratch.
//   C. slice_sum_kernel (only with more than one slice): one thread per
//      (bin, channel) adds the slices in ascending order.
//
// A bin's sum is therefore: its chunk's entries in ascending entry order,
// then those partials in ascending chunk order within a slice, then the
// slices in ascending order, each fold starting from +0. The plan (window,
// slices, chunks per slice) comes from ops/histogram.py plan(), which
// depends on the shapes alone, and dense_histogram_plain folds in the same
// order, so the two agree bit for bit (the library is built with
// -fmad=false) and two launches give the same bits. The window width does
// not enter the order.
//
// Why three passes: one thread per bin (the first port of this kernel)
// serialised a hot bin's whole segment on one thread and needed a torch sort
// and searchsorted around it. Here no thread's serial work grows with the
// entry count: pass A's longest loop is one chunk (CHUNK entries), pass B's
// one slice's chunks, pass C's the slice count, whatever the skew. Slices
// split the chunk range when there are too few windows to fill the card
// (the train step's atlas is one window).
//
// Bound: device memory, reading idx and vals once and writing out once. The
// scratch adds the partials' write and read (at most the input's size), the
// directory ((windows + 1) x chunks ints) and, with slices, slices x n_bins x
// C floats, which the plan keeps under 16 MiB. At the main path's sizes the
// passes are latency-bound instead: a block's steps are dependent (the
// sort's, a run's adds, pass B's barrier per touching chunk).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// entries per chunk (ops/histogram.py CHUNK); a power of two for the sort
constexpr int CHUNK = 1024;
constexpr int ITEMS = CHUNK / THREADS;
static_assert(ITEMS == 4, "bitonic_sort swaps 4 registers a thread");
// shared accumulator of one window (ops/histogram.py ACC_BYTES)
constexpr int ACC_BYTES = 64 * 1024;
// a chunk's rows staged in shared memory up to this size (C <= 16)
constexpr long long STAGE_BYTES = 64 * 1024;
// dynamic shared memory past this asks for more than the default 48 KB a
// block (the kernels' static arrays take up to 17 KB of it)
constexpr long long OPT_IN_BYTES = 31 * 1024;
// chunks whose loads the combine pass keeps in flight at once
constexpr int DEPTH = 16;
// output bins per placement window (ops/histogram.py WIN)
constexpr long long PLACE_WIN = 2048;
constexpr int PLACE_THREADS = 512;

// One chunk's values: staged rows in shared memory, or the strided input.
template <bool STAGED>
__device__ __forceinline__ float value(const float* __restrict__ rows,
                                       const float* __restrict__ vals,
                                       long long base, int j, int c, int C,
                                       int vs0, int vs1) {
  if (STAGED) return rows[j * C + c];
  return vals[(base + j) * vs0 + (long long)c * vs1];
}

template <typename Key>
__device__ __forceinline__ void compare_swap(Key& x, Key& y, bool asc) {
  const Key lo = x < y ? x : y, hi = x < y ? y : x;
  x = asc ? lo : hi;
  y = asc ? hi : lo;
}

// No load above moves below this point: the loads issued before it are in
// flight together, whatever the compiler's register heuristics. pin(x) also
// ties a loaded value to the point (without pins, pass B's loads were sunk
// toward their uses, one round trip per chunk).
__device__ __forceinline__ void issued() { asm volatile("" ::: "memory"); }
__device__ __forceinline__ void pin(int x) {
  asm volatile("" ::"r"(x) : "memory");
}
__device__ __forceinline__ void pin(float x) {
  asm volatile("" ::"f"(x) : "memory");
}

// Bitonic sort of the block's CHUNK keys, ascending; thread t holds
// positions [t ITEMS, (t + 1) ITEMS) in v. Strides within a thread swap
// registers, strides within a warp shuffle, the rest (6 of the 55 steps)
// go through sm with a barrier on each side.
template <typename Key>
__device__ void bitonic_sort(Key (&v)[ITEMS], Key* sm) {
  const int p0 = threadIdx.x * ITEMS;
#pragma unroll
  for (int size = 2; size <= CHUNK; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride < ITEMS) {  // ITEMS == 4: stride 1 or 2, fixed registers
        if (stride == 1) {
          compare_swap(v[0], v[1], (p0 & size) == 0);
          compare_swap(v[2], v[3], ((p0 + 2) & size) == 0);
        } else {
          compare_swap(v[0], v[2], (p0 & size) == 0);
          compare_swap(v[1], v[3], ((p0 + 1) & size) == 0);
        }
      } else {
        Key w[ITEMS];
        if (stride < 32 * ITEMS) {
#pragma unroll
          for (int u = 0; u < ITEMS; ++u)
            w[u] = __shfl_xor_sync(FULL, v[u], stride / ITEMS);
        } else {
#pragma unroll
          for (int u = 0; u < ITEMS; ++u) sm[p0 + u] = v[u];
          __syncthreads();
#pragma unroll
          for (int u = 0; u < ITEMS; ++u) w[u] = sm[(p0 + u) ^ stride];
          __syncthreads();
        }
#pragma unroll
        for (int u = 0; u < ITEMS; ++u) {
          const int p = p0 + u;
          const bool keep_low = (((p & stride) == 0) == ((p & size) == 0));
          const Key lo = v[u] < w[u] ? v[u] : w[u];
          const Key hi = v[u] < w[u] ? w[u] : v[u];
          v[u] = keep_low ? lo : hi;
        }
      }
    }
  }
}

// Pass A. Key: (bin << SHIFT) | entry, 32 bits while bins fit 22 bits.
template <typename Id, typename Key, bool STAGED>
__global__ void __launch_bounds__(THREADS)
    chunk_reduce_kernel(const Id* __restrict__ idx, int is0,
                        const float* __restrict__ vals, int vs0, int vs1,
                        int R, int n_bins, int C, int win, int n_windows,
                        int* __restrict__ bins, int* __restrict__ dir,
                        float* __restrict__ part) {
  constexpr int SHIFT = sizeof(Key) == 8 ? 32 : 10;
  constexpr Key DROP = ~Key(0);
  extern __shared__ __align__(16) float rows[];  // [CHUNK, C] when STAGED
  __shared__ Key key[CHUNK];
  __shared__ int start[CHUNK + 1];
  __shared__ int run_bin[CHUNK];
  __shared__ int warp_n[ITEMS][WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * CHUNK;
  const int n_here = (int)min((long long)CHUNK, (long long)R - base);

  // this thread's entries j = tid + u THREADS: their ids, then the chunk's
  // rows, every load of a loop in flight together
  long long b[ITEMS];
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int j = tid + u * THREADS;
    b[u] = j < n_here ? (long long)idx[(base + j) * is0] : -1;
  }
  if (STAGED) {
    const int n = n_here * C;
    if (vs1 == 1 && vs0 == C &&
        (reinterpret_cast<unsigned long long>(vals) & 15) == 0) {
      // contiguous rows: the chunk is one span of 16-byte aligned floats
      const float4* src = reinterpret_cast<const float4*>(vals + base * C);
      float4* dst = reinterpret_cast<float4*>(rows);
#pragma unroll 8
      for (int i = tid; i < n / 4; i += THREADS) dst[i] = src[i];
      for (int i = n / 4 * 4 + tid; i < n; i += THREADS)
        rows[i] = vals[base * C + i];
    } else if (vs0 <= vs1) {
      // channels apart (a transposed stack): neighbouring threads read
      // neighbouring entries of one channel
#pragma unroll 16
      for (int i = tid; i < n; i += THREADS) {
        const int c = i / n_here, j = i - c * n_here;
        rows[j * C + c] = vals[(base + j) * vs0 + (long long)c * vs1];
      }
    } else {
#pragma unroll 8
      for (int i = tid; i < n; i += THREADS) {
        const int j = i / C, c = i - j * C;
        rows[i] = vals[(base + j) * vs0 + (long long)c * vs1];
      }
    }
    __syncthreads();
  }

  // the kept entries' keys, compacted in entry order; the rest DROP
  bool live[ITEMS];
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int j = tid + u * THREADS;
    live[u] = false;
    if (b[u] >= 0 && b[u] < n_bins)
      for (int c = 0; c < C; ++c)
        live[u] |= value<STAGED>(rows, vals, base, j, c, C, vs0, vs1) != 0.0f;
  }
  unsigned mask[ITEMS];
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    mask[u] = __ballot_sync(FULL, live[u]);
    if (lane == 0) warp_n[u][warp] = __popc(mask[u]);
  }
  __syncthreads();
  int K = 0;
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    int pos = K + __popc(mask[u] & ((1u << lane) - 1u));
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) pos += warp_n[u][w];
      K += warp_n[u][w];
    }
    if (live[u])
      key[pos] = (Key(b[u]) << SHIFT) | Key(tid + u * THREADS);
  }
  for (int j = K + tid; j < CHUNK; j += THREADS) key[j] = DROP;
  __syncthreads();
  if (K > 1) {
    Key v[ITEMS];
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) v[u] = key[tid * ITEMS + u];
    bitonic_sort(v, key);
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) key[tid * ITEMS + u] = v[u];
    __syncthreads();
  }

  // runs of one bin in key[0, K): thread tid owns positions
  // [j0, j0 + ITEMS)
  const int j0 = tid * ITEMS;
  int heads = 0, n_head = 0;
  for (int u = 0; u < ITEMS; ++u) {
    const int j = j0 + u;
    if (j < K && (j == 0 || (key[j - 1] >> SHIFT) != (key[j] >> SHIFT))) {
      heads |= 1 << u;
      ++n_head;
    }
  }
  int incl = n_head;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_n[0][warp] = incl;
  __syncthreads();
  int run = incl - n_head, n_runs = 0;
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) run += warp_n[0][w];
    n_runs += warp_n[0][w];
  }
  for (int u = 0; u < ITEMS; ++u)
    if (heads >> u & 1) start[run++] = j0 + u;
  if (tid == 0) start[n_runs] = K;
  __syncthreads();

  const long long row = (long long)blockIdx.x * CHUNK;
  for (int q = tid; q < n_runs; q += THREADS) {
    const int bq = (int)(key[start[q]] >> SHIFT);
    bins[row + q] = bq;
    run_bin[q] = bq;
  }
  __syncthreads();
  // the chunk's column of the window directory: dir[w][k] is its first run
  // at or past bin w win, for every window boundary w <= n_windows
  for (int w = tid; w <= n_windows; w += THREADS) {
    const long long x = (long long)w * win;
    int lo = 0, hi = n_runs;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((long long)run_bin[mid] < x)
        lo = mid + 1;
      else
        hi = mid;
    }
    dir[(long long)w * gridDim.x + blockIdx.x] = lo;
  }
  for (int t = tid; t < n_runs * C; t += THREADS) {
    const int q = t / C, c = t - q * C;
    const int e = start[q + 1];
    int j = start[q];
    float acc = 0.0f;
    // 16 values in flight ahead of their adds; the adds stay in ascending
    // entry order
    if (e - j >= 16) {
      float cur[16];
#pragma unroll
      for (int u = 0; u < 16; ++u)
        cur[u] = value<STAGED>(rows, vals, base,
                               (int)(key[j + u] & (CHUNK - 1)), c, C, vs0,
                               vs1);
      issued();
      for (;;) {
        j += 16;
        const bool more = e - j >= 16;
        float nxt[16];
        if (more) {
#pragma unroll
          for (int u = 0; u < 16; ++u)
            nxt[u] = value<STAGED>(rows, vals, base,
                                   (int)(key[j + u] & (CHUNK - 1)), c, C,
                                   vs0, vs1);
          issued();
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) acc += cur[u];
        if (!more) break;
#pragma unroll
        for (int u = 0; u < 16; ++u) cur[u] = nxt[u];
      }
    }
    for (; j < e; ++j)
      acc += value<STAGED>(rows, vals, base, (int)(key[j] & (CHUNK - 1)), c,
                           C, vs0, vs1);
    part[(row + q) * C + c] = acc;
  }
}

template <typename Id, typename Key, bool STAGED>
cudaError_t chunk_reduce(int n_chunks, size_t smem, cudaStream_t st,
                         const void* idx, int is0, const float* vals,
                         int vs0, int vs1, int R, int n_bins, int C, int win,
                         int n_windows, int* bins, int* dir, float* part) {
  if (smem > OPT_IN_BYTES) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_reduce_kernel<Id, Key, STAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  chunk_reduce_kernel<Id, Key, STAGED><<<n_chunks, THREADS, smem, st>>>(
      static_cast<const Id*>(idx), is0, vals, vs0, vs1, R, n_bins, C, win,
      n_windows, bins, dir, part);
  return cudaSuccess;
}

template <typename Id, typename Key>
cudaError_t launch_chunk_reduce(bool staged, int n_chunks, size_t smem,
                                cudaStream_t st, const void* idx, int is0,
                                const float* vals, int vs0, int vs1, int R,
                                int n_bins, int C, int win, int n_windows,
                                int* bins, int* dir, float* part) {
  return staged ? chunk_reduce<Id, Key, true>(
                      n_chunks, smem, st, idx, is0, vals, vs0, vs1, R, n_bins,
                      C, win, n_windows, bins, dir, part)
                : chunk_reduce<Id, Key, false>(
                      n_chunks, 0, st, idx, is0, vals, vs0, vs1, R, n_bins, C,
                      win, n_windows, bins, dir, part);
}

__global__ void __launch_bounds__(THREADS)
    window_combine_kernel(const int* __restrict__ bins,
                          const int* __restrict__ dir,
                          const float* __restrict__ part, int n_chunks,
                          int per_slice, int n_bins, int C, int win,
                          float* __restrict__ dst) {
  extern __shared__ float acc[];  // [rows, C]
  // this batch's chunks that touch the window, ascending, and their parts
  __shared__ int t_chunk[THREADS], t_lo[THREADS], t_hi[THREADS];
  __shared__ int warp_n[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b0 = (long long)blockIdx.x * win;
  const int rows = (int)min((long long)win, (long long)n_bins - b0);
  const int n = rows * C;
  for (int i = tid; i < n; i += THREADS) acc[i] = 0.0f;
  const int k0 = blockIdx.y * per_slice;
  const int k1 = min(n_chunks, k0 + per_slice);
  // the element of a touching chunk's part that this thread adds first
  const int e_of = tid / C, c_of = tid - (tid / C) * C;
  for (int kb = k0; kb < k1; kb += THREADS) {
    __syncthreads();  // the zero fill, or the last batch's lists, are done
    const int k = kb + tid;
    int lo = 0, hi = 0;
    if (k < k1) {  // the chunk's part in this window, from the directory
      lo = dir[(long long)blockIdx.x * n_chunks + k];
      hi = dir[(long long)(blockIdx.x + 1) * n_chunks + k];
    }
    const unsigned touch = __ballot_sync(FULL, lo < hi);
    if (lane == 0) warp_n[warp] = __popc(touch);
    __syncthreads();
    int pos = __popc(touch & ((1u << lane) - 1u)), n_touch = 0;
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) pos += warp_n[w];
      n_touch += warp_n[w];
    }
    if (lo < hi) {
      t_chunk[pos] = k;
      t_lo[pos] = lo;
      t_hi[pos] = hi;
    }
    __syncthreads();
    // DEPTH chunks' first loads in flight at once, then their adds one
    // chunk after the other, a barrier each: a chunk's bins are unique, so
    // within a chunk no two threads add to one address
    for (int g = 0; g < n_touch; g += DEPTH) {
      int bv[DEPTH];
      float v[DEPTH];
#pragma unroll
      for (int p = 0; p < DEPTH; ++p) {
        const int t = min(g + p, n_touch - 1);
        const int e = min(t_lo[t] + e_of, t_hi[t] - 1);
        const long long row = (long long)t_chunk[t] * CHUNK;
        bv[p] = bins[row + e];
        v[p] = part[(row + e) * C + c_of];
      }
#pragma unroll
      for (int p = 0; p < DEPTH; ++p) {
        pin(bv[p]);
        pin(v[p]);
      }
#pragma unroll
      for (int p = 0; p < DEPTH; ++p) {
        if (g + p >= n_touch) break;  // the same for every thread
        const int t = g + p, lo_t = t_lo[t];
        const int n_t = (t_hi[t] - lo_t) * C;
        if (tid < n_t) acc[(bv[p] - b0) * C + c_of] += v[p];
        const long long row = (long long)t_chunk[t] * CHUNK;
        for (int i = tid + THREADS; i < n_t; i += THREADS) {
          const int e = lo_t + i / C, c = i - (i / C) * C;
          acc[(bins[row + e] - b0) * C + c] += part[(row + e) * C + c];
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();
  float* o = dst + ((long long)blockIdx.y * n_bins + b0) * C;
  for (int i = tid; i < n; i += THREADS) o[i] = acc[i];
}

__global__ void __launch_bounds__(THREADS)
    slice_sum_kernel(const float* __restrict__ slices, int n_slices,
                     long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  int s = 0;
  for (; s + 8 <= n_slices; s += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = slices[(s + u) * n + i];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += v[u];
  }
  for (; s < n_slices; ++s) acc += slices[s * n + i];
  out[i] = acc;
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

// scratch (float32 words): part [n_chunks, CHUNK, C], then with slices > 1
// the slice sums [slices, n_bins, C], then as int32 bins [n_chunks, CHUNK]
// and the window directory [n_windows + 1, n_chunks] (ops/histogram.py
// scratch_words). idx and vals are read through their strides (is0; vs0,
// vs1), in elements.
int srt_histogram(const void* idx, int id64, int is0, const float* vals,
                  int vs0, int vs1, int R, int n_bins, int C, int win,
                  int slices, int per_slice, float* scratch,
                  float* out, void* stream) {
  const int n_chunks = (int)(((long long)R + CHUNK - 1) / CHUNK);
  const long long acc_bytes = (long long)win * C * (long long)sizeof(float);
  if (R < 0 || win < 1 || slices < 1 || slices > 65535 ||
      per_slice < 1 || (long long)slices * per_slice < n_chunks ||
      acc_bytes > ACC_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_bins <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n_windows = ((long long)n_bins + win - 1) / win;
  float* part = scratch;
  float* slice_sums = part + (long long)n_chunks * CHUNK * C;
  int* bins = reinterpret_cast<int*>(
      slice_sums + (slices > 1 ? (long long)slices * n_bins * C : 0));
  int* dir = bins + (long long)n_chunks * CHUNK;
  if (n_chunks > 0) {
    // rows of up to STAGE_BYTES / CHUNK bytes are staged in shared memory
    const long long stage = (long long)CHUNK * C * (long long)sizeof(float);
    const bool staged = stage <= STAGE_BYTES;
    const size_t smem = staged ? (size_t)stage : 0;
    const bool key32 = n_bins <= (1 << 22);
    const cudaError_t err =
        id64 ? (key32 ? launch_chunk_reduce<long long, unsigned>(
                            staged, n_chunks, smem, st, idx, is0, vals, vs0,
                            vs1, R, n_bins, C, win, (int)n_windows, bins, dir, part)
                      : launch_chunk_reduce<long long, unsigned long long>(
                            staged, n_chunks, smem, st, idx, is0, vals, vs0,
                            vs1, R, n_bins, C, win, (int)n_windows, bins, dir, part))
             : (key32 ? launch_chunk_reduce<int, unsigned>(
                            staged, n_chunks, smem, st, idx, is0, vals, vs0,
                            vs1, R, n_bins, C, win, (int)n_windows, bins, dir, part)
                      : launch_chunk_reduce<int, unsigned long long>(
                            staged, n_chunks, smem, st, idx, is0, vals, vs0,
                            vs1, R, n_bins, C, win, (int)n_windows, bins, dir, part));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (acc_bytes > OPT_IN_BYTES) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)acc_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  window_combine_kernel<<<dim3((unsigned)n_windows, (unsigned)slices),
                          THREADS, (size_t)acc_bytes, st>>>(
      bins, dir, part, n_chunks, per_slice, n_bins, C, win,
      slices > 1 ? slice_sums : out);
  if (slices > 1) {
    const long long n = (long long)n_bins * C;
    slice_sum_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                       st>>>(slice_sums, slices, n, out);
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
