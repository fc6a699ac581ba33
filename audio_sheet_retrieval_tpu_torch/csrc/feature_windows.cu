// Feature-window gather of the fullconv sheet-DB build: from the
// dense-pooled block-1 feature plane [C, H4, Wq] and N half-res window
// starts, build block 2's inputs [N, C, H4, n_cols] from the columns
// s, s+2, ..., s+2*(n_cols-1).
//
// Replaces: audio_sheet_retrieval_tpu/ops/windows.py,
// gather_feature_windows_pallas (its inner `kernel`: one HBM->HBM DMA per
// window over even/odd parity planes).
//
// What bounds it on the H100: pure data movement, so device-memory bytes:
// the plane read once and the windows written once (34 MB at the serving
// geometry, 24 x 40 x 3019 f32 and 117 windows of 50 columns: 10 us at
// 3.35 TB/s). Neighbouring windows overlap about fourfold and a window
// uses every second column, so a gather that reads the plane from each
// output element pulls it through L2 about eight times over.
//
// Design (gather_staged_kernel). The plane is R = C * H4 rows of Wq
// columns and a window's output is R rows of n_cols, so C and H4 never
// appear: output rows of neighbouring plane rows are adjacent.
//   * A CTA owns a tile of `ht` plane rows, one segment of 2^seg_log2
//     columns and one slice of at most `cap` windows. It first lists, in
//     shared memory, the windows of its slice whose start falls in its
//     segment (one pass over the slice's starts; a CTA without a window
//     returns), with the least and the largest start among them.
//   * It stages columns [least start, largest start + 2 (n_cols - 1)] of
//     its rows in shared memory once: 16-byte cp.async copies for the
//     16-byte-aligned middle of each row and element copies for the head
//     and tail (Wq is odd at the serving geometry, so rows begin at any
//     element offset; each row sits in shared memory at its global
//     address's offset within 16 bytes). The plane is so read once,
//     densely, plus a halo of 2 n_cols - 1 columns a segment; the stride-2
//     pick and the windows' overlap happen in shared memory.
//   * A window's output for the tile is one run of ht * n_cols contiguous
//     elements. A warp takes a window, its lanes the run's 16-byte-aligned
//     vectors: every vector inside the run is one 16-byte store, and only
//     the elements of a vector that crosses an end of the run are stored
//     one by one (the run starts at any element offset: 200-byte output
//     rows).
//   * A lane's 4 (f32) or 8 (bf16) elements lie 2 columns apart in shared
//     memory and neighbouring lanes' 8 or 16 columns apart, so a plain
//     read order would put 8 lanes on one bank. Lane l reads its elements
//     in the order rotated by l / 4, which spreads a warp's read over
//     every second bank in f32 (two-way, the least a stride-2 word read
//     allows) and over all 32 in bf16, and rotates them back in registers.
//   * No division in the loops: the run offset -> (row, column) split
//     multiplies by a 33-bit reciprocal of n_cols (exact while
//     ht * n_cols^2 < 2^32, which the wrapper's plan checks).
// The tile height, segment width and slice length come from the wrapper's
// plan (ops/windows.py::gather_plan), which keeps a CTA's shared memory
// small enough for several CTAs a SM: while some stage, others store.
//
// The TPU kernel's parity split, int32 lane packing and 24 -> 32 channel
// padding were Mosaic DMA constraints and are not carried over. The layout
// is NCHW because block 2's convolution consumes it directly. The kernel
// moves bits only, so one kernel serves f32 (4-byte) and bf16 (2-byte)
// planes and is bit-exact. A column outside [0, Wq) reads as the element
// type's all-ones pattern (a NaN in both f32 and bf16) instead of reading
// out of bounds; callers check the starts on the host.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint4 pack16(const uint32_t (&v)[4]) {
  return make_uint4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint4 pack16(const uint16_t (&v)[8]) {
  return make_uint4(v[0] | ((uint32_t)v[1] << 16),
                    v[2] | ((uint32_t)v[3] << 16),
                    v[4] | ((uint32_t)v[5] << 16),
                    v[6] | ((uint32_t)v[7] << 16));
}

// Shared memory: list_n[cap], list_s[cap], 4 ints (count, least start,
// largest start, pad), then, 16-byte aligned, ht rows of row_stride bytes.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_staged_kernel(const T* __restrict__ plane,
                     const int* __restrict__ starts, int N, int R, int Wq,
                     int n_cols, int ht, int seg_log2, int cap,
                     int row_stride, T* __restrict__ out) {
  constexpr int VEC = 16 / (int)sizeof(T);  // elements a 16-byte vector
  constexpr int LOG_VEC = sizeof(T) == 4 ? 2 : 3;
  extern __shared__ __align__(16) unsigned char smem[];
  int* list_n = reinterpret_cast<int*>(smem);
  int* list_s = list_n + cap;
  int* head = list_s + cap;
  T* rows_sm = reinterpret_cast<T*>(
      smem + (((size_t)(2 * cap + 4) * sizeof(int) + 15) & ~(size_t)15));

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * ht;
  const int rows = min(ht, R - r0);
  const int seg = blockIdx.y;
  const int n_begin = blockIdx.z * cap;
  const int n_end = min(N, n_begin + cap);

  // 1. this slice's windows whose start falls in this segment. A start
  // beyond either clamp has every column out of range already.
  if (tid == 0) {
    head[0] = 0;
    head[1] = INT_MAX;
    head[2] = INT_MIN;
  }
  __syncthreads();
  for (int n = n_begin + tid; n < n_end; n += THREADS) {
    const int s = max(-2 * n_cols, min(starts[n], Wq));
    if ((min(max(s, 0), Wq - 1) >> seg_log2) == seg) {
      const int p = atomicAdd(&head[0], 1);
      list_n[p] = n;
      list_s[p] = s;
      atomicMin(&head[1], s);
      atomicMax(&head[2], s);
    }
  }
  __syncthreads();
  const int n_list = head[0];
  if (n_list == 0) return;

  // 2. stage columns [lo, hi) of the tile's rows
  const int lo = max(head[1], 0);
  const int hi = min(Wq, head[2] + 2 * (n_cols - 1) + 1);
  const int rs = row_stride / (int)sizeof(T);  // row stride in elements
  // a row's offset within 16 bytes, in elements: (a0 + rr * wq_mod) % VEC
  const int a0 = (int)(((uintptr_t)(plane + ((long long)r0 * Wq + lo)) &
                        15) / sizeof(T));
  const int wq_mod = Wq & (VEC - 1);
  if (hi > lo) {
    const int width = hi - lo;
    for (int rr = 0; rr < rows; ++rr) {
      const T* src = plane + ((long long)(r0 + rr) * Wq + lo);
      const int shift = (a0 + rr * wq_mod) & (VEC - 1);
      T* dst = rows_sm + rr * rs + shift;
      const int n_head = min(width, (VEC - shift) & (VEC - 1));
      const int n_vec = (width - n_head) / VEC;
      const int tail0 = n_head + n_vec * VEC;
      for (int i = tid; i < n_vec; i += THREADS)
        cp_async16(dst + n_head + i * VEC, src + n_head + i * VEC);
      if (tid < n_head) dst[tid] = src[tid];
      if (tid < width - tail0) dst[tail0 + tid] = src[tail0 + tid];
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. a warp a window, a lane a 16-byte vector of the window's run
  const int run = rows * n_cols;  // elements of one window's run
  const unsigned long long recip = (1ull << 32) / (unsigned)n_cols + 1;
  const int lane = tid & 31;
  const int rot = (lane >> 2) & (VEC - 1);
  const T ones = (T) ~(T)0;
  auto element = [&](int e, int s) -> T {  // run offset e of a start s
    const int hl = (int)(((unsigned)e * recip) >> 32);  // e / n_cols
    const int col = s + 2 * (e - hl * n_cols);
    if ((unsigned)col >= (unsigned)Wq) return ones;
    return rows_sm[hl * rs + ((a0 + hl * wq_mod) & (VEC - 1)) + (col - lo)];
  };
  for (int w = tid >> 5; w < n_list; w += THREADS / 32) {
    const int s = list_s[w];
    const long long e0 = ((long long)list_n[w] * R + r0) * n_cols;
    const int mis = (int)(e0 & (VEC - 1));  // the run's offset in a vector
    T* dst = out + e0;
    const int n_vec = (mis + run + VEC - 1) / VEC;
    for (int v = lane; v < n_vec; v += 32) {
      const int e = v * VEC - mis;
      if (e >= 0 && e + VEC <= run) {
        T t[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          t[i] = element(e + ((i + rot) & (VEC - 1)), s);
        // t[i] holds element (i + rot) % VEC: rotate right by rot
#pragma unroll
        for (int b = 0; b < LOG_VEC; ++b) {
          const bool on = (rot >> b) & 1;
          T u[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            u[k] = on ? t[(k - (1 << b)) & (VEC - 1)] : t[k];
#pragma unroll
          for (int k = 0; k < VEC; ++k) t[k] = u[k];
        }
        *reinterpret_cast<uint4*>(dst + e) = pack16(t);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          if (e + i >= 0 && e + i < run) dst[e + i] = element(e + i, s);
      }
    }
  }
}

template <typename T>
int launch_staged(const void* plane, const void* starts, int N, int R, int Wq,
                  int n_cols, int ht, int seg_log2, int cap, int row_stride,
                  int smem_bytes, void* out, void* stream) {
  auto kernel = gather_staged_kernel<T>;
  if (smem_bytes > 48 * 1024) {  // only a very wide window needs this much
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((R + ht - 1) / ht),
                  (unsigned)(((Wq - 1) >> seg_log2) + 1),
                  (unsigned)((N + cap - 1) / cap));
  kernel<<<grid, THREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(plane), static_cast<const int*>(starts), N, R, Wq,
      n_cols, ht, seg_log2, cap, row_stride, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// plane [R, Wq] contiguous (R = C * H4), starts [N] int32, out
// [N, R, n_cols] 16-byte aligned; N >= 1. elem_bytes: 4 (float32) or 2
// (bfloat16). ht, seg_log2, cap, row_stride and smem_bytes are the
// wrapper's plan. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// another element size.
int gather_feature_windows(const void* plane, const void* starts, int N,
                           int R, int Wq, int n_cols, int elem_bytes, int ht,
                           int seg_log2, int cap, int row_stride,
                           int smem_bytes, void* out, void* stream) {
  if (elem_bytes == 4)
    return launch_staged<uint32_t>(plane, starts, N, R, Wq, n_cols, ht,
                                   seg_log2, cap, row_stride, smem_bytes, out,
                                   stream);
  if (elem_bytes == 2)
    return launch_staged<uint16_t>(plane, starts, N, R, Wq, n_cols, ht,
                                   seg_log2, cap, row_stride, smem_bytes, out,
                                   stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
