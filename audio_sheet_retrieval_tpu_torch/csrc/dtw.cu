// Dynamic time warping over a precomputed float32 distance matrix: the
// accumulated costs in one launch, the traceback in another.
//
// Replaces two lax.scan loops of the JAX package (not Pallas kernels):
//   audio_sheet_retrieval_tpu/ops/dtw.py, _dtw_accumulate_diagonals (a scan
//   over the R + C - 1 anti-diagonals) and _traceback_device (a scan of
//   R + C - 2 scalar steps). XLA compiles each into one device loop; a
//   PyTorch transcription would be several launches a diagonal and a host
//   round trip a traceback step.
//
// Layout: the diagonal layout of the JAX scan. The wrapper shears the
// [R, C] distances into skew [D, C], D = R + C - 1, row d holding
// anti-diagonal d (skew[d, j] = dist[d - j, j], +inf outside the matrix:
// ops/dtw.py::skew_to_diagonals), and the kernel writes the accumulated
// costs in the same layout. A diagonal is then one contiguous row, read
// and written coalesced; in row-major [R, C] its cells lie C - 1 elements
// apart and every access is a sector of its own, which one SM's load/store
// path serialises.
//
// dtw_acc_ring / dtw_acc_global compute, for every diagonal d and column j,
//   acc[d, j] = skew[d, j] + min(acc[d-1, j], acc[d-1, j-1], acc[d-2, j-1])
// (up, left and diag of cell (d - j, j); +inf before diagonal 0 and left of
// column 0; acc[0, 0] = skew[0, 0]) in float32: the JAX scan's step, cell
// for cell, +inf riding through the cells outside the matrix. Each cell is
// one min and one float32 add, so the result does not depend on the order
// of evaluation: bit-identical to the plain loop
// (ops/dtw.py::dtw_accumulate_plain) and to JAX's scan.
//
// What bounds it on the H100. Bytes: the distances read once and the
// accumulated costs written once, 8 R C bytes (192 MB at 6,000 x 4,000:
// 57 us at 3.35 TB/s). Latency: the D diagonals depend one on the next and
// a CTA-wide barrier separates them, so D barrier rounds (dtw_barrier_rounds
// measures one) are a floor of their own, and at alignment sizes the
// higher one.
//
// Design. One CTA of up to 1,024 threads walks the diagonals; thread t owns
// columns j = t, t + T, ..., t + (K-1) T (K = ceil(C / T), at most 16). The
// last three diagonals live in shared memory (3 C floats, a ring), so a
// cell reads its three neighbours from shared memory and one __syncthreads
// a diagonal suffices: the slot a diagonal writes was last read two
// diagonals before. The next diagonal's distances are loaded into
// registers before the current one is computed, so their latency overlaps
// a diagonal's work. Wider than 16,384 columns (the ring would pass
// 227 KB), dtw_acc_global reads the neighbours from acc itself:
// __syncthreads makes a block's global writes visible to the block, and
// the loads bypass L1 (__ldcg).
//
// dtw_traceback_kernel walks from (R-1, C-1) to (0, 0) on one thread with
// the JAX traceback's rule: the argmin over (diag, up, left), the first
// winning on ties, +inf outside the matrix and 0 at (-1, -1). It writes the
// positions after each step, the step count and the final cost's bits into
// one int32 buffer, so the host downloads that buffer and nothing of acc.
// It is R + C - 2 dependent steps of three loads each: latency-bound.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float min3(float up, float left, float diag) {
  return fminf(fminf(up, left), diag);
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
    dtw_acc_ring(const float* __restrict__ skew, float* __restrict__ acc,
                 int D, int C) {
  extern __shared__ float ring[];  // 3 diagonals of C floats
  const int t = threadIdx.x, T = blockDim.x;
  for (int x = t; x < 3 * C; x += T) ring[x] = CUDART_INF_F;
  float nxt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = t + k * T;
    nxt[k] = j < C ? __ldg(skew + j) : 0.f;
  }
  __syncthreads();
  for (int d = 0; d < D; ++d) {
    float cur[K];
#pragma unroll
    for (int k = 0; k < K; ++k) cur[k] = nxt[k];
    if (d + 1 < D) {  // the next diagonal's distances, in flight meanwhile
      const float* row = skew + (size_t)(d + 1) * C;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = t + k * T;
        if (j < C) nxt[k] = __ldg(row + j);
      }
    }
    float* now = ring + (d % 3) * C;
    const float* p1 = ring + ((d + 2) % 3) * C;  // diagonal d - 1
    const float* p2 = ring + ((d + 1) % 3) * C;  // diagonal d - 2
    float* out = acc + (size_t)d * C;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = t + k * T;
      if (j < C) {
        float best = min3(p1[j], j > 0 ? p1[j - 1] : CUDART_INF_F,
                          j > 0 ? p2[j - 1] : CUDART_INF_F);
        if (d == 0 && j == 0) best = 0.f;  // cell (0, 0) adds nothing
        const float v = __fadd_rn(cur[k], best);
        now[j] = v;
        out[j] = v;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    dtw_acc_global(const float* __restrict__ skew, float* acc, int D, int C) {
  const int t = threadIdx.x, T = blockDim.x;
  for (int d = 0; d < D; ++d) {
    const size_t row = (size_t)d * C;
    for (int j = t; j < C; j += T) {
      const float up = d > 0 ? __ldcg(acc + row - C + j) : CUDART_INF_F;
      const float left =
          (d > 0 && j > 0) ? __ldcg(acc + row - C + j - 1) : CUDART_INF_F;
      const float diag =
          (d > 1 && j > 0) ? __ldcg(acc + row - 2 * C + j - 1) : CUDART_INF_F;
      float best = min3(up, left, diag);
      if (d == 0 && j == 0) best = 0.f;
      acc[row + j] = __fadd_rn(__ldg(skew + row + j), best);
    }
    __syncthreads();
  }
}

// cell (a, b) of the diagonal-layout acc [D, C], with the traceback's
// border: +inf outside the matrix, 0 at (-1, -1)
__device__ __forceinline__ float tb_read(const float* acc, int C, int a,
                                         int b) {
  if (a == -1 && b == -1) return 0.f;
  if (a < 0 || b < 0) return CUDART_INF_F;
  return __ldcg(acc + (size_t)(a + b) * C + b);
}

__global__ void dtw_traceback_kernel(const float* acc, int R, int C,
                                     int* out) {
  const int L = R + C - 1;  // path capacity
  int i = R - 1, j = C - 1, n = 0;
  while (i > 0 || j > 0) {
    const float dg = tb_read(acc, C, i - 1, j - 1);
    const float up = tb_read(acc, C, i - 1, j);
    const float lf = tb_read(acc, C, i, j - 1);
    int tb = 0;
    float best = dg;
    if (up < best) { tb = 1; best = up; }
    if (lf < best) tb = 2;
    if (tb != 2) --i;
    if (tb != 1) --j;
    out[2 + n] = i;
    out[2 + L + n] = j;
    ++n;
  }
  out[0] = n;
  out[1] = __float_as_int(tb_read(acc, C, R - 1, C - 1));
}

// `rounds` CTA-wide barriers of `blockDim.x` threads, each after a shared
// store and before a neighbour's load: one diagonal's synchronisation with
// no work in it (the accumulation's latency floor per diagonal)
__global__ void __launch_bounds__(kMaxThreads)
    barrier_rounds_kernel(int rounds, int* out) {
  __shared__ int s[2 * kMaxThreads];
  const int t = threadIdx.x, T = blockDim.x;
  int x = t;
  for (int r = 0; r < rounds; ++r) {
    s[(r & 1) * T + t] = x;
    __syncthreads();
    x ^= s[(r & 1) * T + (t + 1) % T];
  }
  out[t] = x;
}

template <int K>
int launch_ring(const float* skew, float* acc, int D, int C, int threads,
                int smem_bytes, cudaStream_t s) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dtw_acc_ring<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dtw_acc_ring<K><<<1, threads, smem_bytes, s>>>(skew, acc, D, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// skew, acc: [D, C] float32 contiguous, D, C >= 1. threads: a multiple of
// 32 up to 1,024. k: columns a thread owns (1, 2, 4, 8 or 16) with the
// ring in smem_bytes = 12 C bytes of shared memory, or 0 for the
// global-memory path. The wrapper's plan (ops/dtw.py::acc_plan) picks
// them. Returns cudaGetLastError(), or cudaErrorInvalidValue for another k.
int dtw_accumulate(const void* skew, int D, int C, int threads, int k,
                   int smem_bytes, void* acc, void* stream) {
  const float* x = static_cast<const float*>(skew);
  float* a = static_cast<float*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_ring<1>(x, a, D, C, threads, smem_bytes, s);
    case 2: return launch_ring<2>(x, a, D, C, threads, smem_bytes, s);
    case 4: return launch_ring<4>(x, a, D, C, threads, smem_bytes, s);
    case 8: return launch_ring<8>(x, a, D, C, threads, smem_bytes, s);
    case 16: return launch_ring<16>(x, a, D, C, threads, smem_bytes, s);
    case 0:
      dtw_acc_global<<<1, threads, 0, s>>>(x, a, D, C);
      return (int)cudaGetLastError();
    default: return (int)cudaErrorInvalidValue;
  }
}

// acc: [R + C - 1, C] float32 contiguous, diagonal layout; out: int32
// [2 + 2 (R + C - 1)]. Writes out[0] = n steps, out[1] = the bits of
// cell (R-1, C-1), out[2 + s] and out[2 + R + C - 1 + s] = the row and
// column after step s.
int dtw_traceback(const void* acc, int R, int C, void* out, void* stream) {
  dtw_traceback_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), R, C, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

// out: int32 [threads]
int dtw_barrier_rounds(int rounds, int threads, void* out, void* stream) {
  barrier_rounds_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      rounds, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
