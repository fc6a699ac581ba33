// Feature-window gather of the fullconv sheet-DB build: from the
// dense-pooled block-1 feature plane [C, H4, Wq] and N half-res window
// starts, build block 2's inputs [N, C, H4, n_cols] from the columns
// s, s+2, ..., s+2*(n_cols-1).
//
// Replaces: audio_sheet_retrieval_tpu/ops/windows.py,
// gather_feature_windows_pallas (its inner `kernel`: one HBM->HBM DMA per
// window over even/odd parity planes).
//
// What bounds it on the H100: pure data movement, so device-memory bytes.
// Writes are N*C*H4*n_cols elements; the stride-2 column reads touch twice
// the bytes they use, and overlapping windows re-read columns through L2
// (the plane, 24 x 40 x 3019 f32 = 11.6 MB at the serving geometry, fits
// in the 50 MB L2).
//
// Design: a direct strided gather, one thread per output element, in
// output order, so the writes are fully coalesced and neighbouring threads
// read neighbouring even columns. The TPU kernel's parity split, int32
// lane packing and 24 -> 32 channel padding were Mosaic DMA constraints
// and are not carried over. The layout is NCHW because block 2's
// convolution consumes it directly. The kernel moves bits only, so one
// kernel serves f32 (4-byte) and bf16 (2-byte) planes and is bit-exact.
// A start outside [0, Wq - 2*(n_cols-1)) writes the element type's all-ones
// pattern (a NaN in both f32 and bf16) instead of reading out of bounds;
// callers check the starts on the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void gather_feature_windows_kernel(const T* __restrict__ plane,
                                              const int* __restrict__ starts,
                                              int C, int H4, int Wq,
                                              int n_cols, long long total,
                                              T* __restrict__ out) {
  const long long rows_per_window = (long long)C * H4;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(e % n_cols);
    const long long row = e / n_cols;             // (n, c, h) flattened
    const long long n = row / rows_per_window;
    const long long ch = row - n * rows_per_window;  // c * H4 + h
    const int col = starts[n] + 2 * j;
    T v;
    if (col >= 0 && col < Wq) {
      v = plane[ch * Wq + col];
    } else {
      v = (T)~(T)0;
    }
    out[e] = v;
  }
}

template <typename T>
int launch(const void* plane, const void* starts, int N, int C, int H4,
           int Wq, int n_cols, void* out, void* stream) {
  const long long total = (long long)N * C * H4 * n_cols;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  gather_feature_windows_kernel<T><<<(unsigned)blocks, threads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(plane), static_cast<const int*>(starts), C, H4,
      Wq, n_cols, total, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// plane [C, H4, Wq] contiguous, starts [N] int32, out [N, C, H4, n_cols];
// N >= 1. elem_bytes: 4 (float32) or 2 (bfloat16). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another element size.
int gather_feature_windows(const void* plane, const void* starts, int N,
                           int C, int H4, int Wq, int n_cols, int elem_bytes,
                           void* out, void* stream) {
  if (elem_bytes == 4)
    return launch<uint32_t>(plane, starts, N, C, H4, Wq, n_cols, out, stream);
  if (elem_bytes == 2)
    return launch<uint16_t>(plane, starts, N, C, H4, Wq, n_cols, out, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
