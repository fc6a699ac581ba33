// The system detector's geometry on the card (omr/geometry.py): connected
// components of the closed foreground with their statistics, Otsu's
// threshold, and the loops of numpy and scipy whose rounding the host
// geometry depends on, each in the host library's own order so that the
// card gives the same bits.
//
// * omr_label: 8-connected components of a u8 mask by union-find
//   (Playne and Hawick's merge: each pixel hooks the larger of two roots
//   under the smaller with atomicMin, retrying until the two trees share a
//   root). Every foreground pixel ends labelled with the smallest linear
//   index of its component, whatever order the threads ran in; background
//   is -1. A pixel unites only with the neighbours that its left one does
//   not already reach (W, else N, else NW and NE; NE where W is set and N
//   is not), and a find halves the paths it walks (it writes only to
//   pixels that are not roots, so no hook is lost). The flatten pass also
//   counts each component's statistics at its root: the area, the largest
//   row, the smallest and largest column and the smallest cv2 block key
//   ((row / 2) * ((w + 1) / 2) + col / 2), one atomic a warp and a root.
//   Three launches: init, merge (one thread a pixel), flatten.
// * omr_otsu: Otsu's threshold of float32 values, np.histogram's 256
//   uniform bins over [lo, hi] (its float64 index rule and edge fix-ups;
//   one launch counts them in shared memory) and numpy's cumulative sums
//   and products in order (one thread); lo where lo == hi.
// * omr_row_sums: numpy's pairwise float32 sum of each row (add.reduce
//   over a contiguous axis: blocks of at most 128 with 8 accumulators,
//   halves at multiples of 8 above that).
// * omr_col_means: numpy's mean over axis 0 of rows [r0, r1) of a float32
//   image, for each slot: a sequential float32 sum down each column, then
//   divided in float64 and rounded to float32; an empty range is NaN.
// * omr_box3: scipy's uniform_filter1d of size 3, mode "mirror", along
//   lines of a float32 image: the window's running sum in float64 (the
//   entering value less the leaving one added at each step), divided by 3
//   and rounded to float32 at each output.
//
// Every float operation whose rounding matters is an _rn intrinsic, so
// that nvcc cannot contract a multiply and an add into one FMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOtsuBins = 256;

constexpr int kIntMax = 0x7fffffff;

__global__ void omr_label_init(const uint8_t* __restrict__ mask, int* lab,
                               int* stats, int n) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  lab[p] = mask[p] ? p : -1;
  stats[p] = 0;                  // area
  stats[n + p] = -1;             // largest row
  stats[2 * n + p] = kIntMax;    // smallest column
  stats[3 * n + p] = -1;         // largest column
  stats[4 * n + p] = kIntMax;    // smallest cv2 block key
}

// the root of x; every pixel on the way that is not a root is pointed two
// steps up (path halving)
__device__ __forceinline__ int find_halve(int* lab, int x) {
  volatile int* vl = lab;
  while (true) {
    int y = vl[x];
    if (y == x) return x;
    int z = vl[y];
    if (z == y) return y;
    vl[x] = z;                   // x is not a root: only finds write it
    x = z;
  }
}

__device__ __forceinline__ int find_root(const volatile int* lab, int x) {
  int y = lab[x];
  while (y != x) {
    x = y;
    y = lab[x];
  }
  return x;
}

__device__ void unite(int* lab, int a, int b) {
  while (true) {
    a = find_halve(lab, a);
    b = find_halve(lab, b);
    if (a == b) return;
    if (a > b) {
      int t = a;
      a = b;
      b = t;
    }
    int old = atomicMin(lab + b, a);
    if (old == b) return;
    b = old;
  }
}

__global__ void omr_label_merge(const uint8_t* __restrict__ mask, int* lab,
                                int h, int w) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  int r = blockIdx.y;
  if (c >= w || r >= h) return;
  int p = r * w + c;
  if (!mask[p]) return;
  bool west = c > 0 && mask[p - 1];
  bool north = r > 0 && mask[p - w];
  bool nw = r > 0 && c > 0 && mask[p - w - 1];
  bool ne = r > 0 && c + 1 < w && mask[p - w + 1];
  // W reaches NW and N (its N and NE); N reaches NW and NE (its W and E)
  if (west) {
    unite(lab, p, p - 1);
    if (!north && ne) unite(lab, p, p - w + 1);
  } else if (north) {
    unite(lab, p, p - w);
  } else {
    if (nw) unite(lab, p, p - w - 1);
    if (ne) unite(lab, p, p - w + 1);
  }
}

__global__ void omr_label_flatten(int* lab, int* stats, int n, int w) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  bool on = p < n && lab[p] >= 0;
  int root = on ? find_root(lab, p) : -1;
  unsigned active = __ballot_sync(0xffffffffu, on);
  if (!on) return;
  lab[p] = root;
  unsigned peers = __match_any_sync(active, root);
  int r = p / w, c = p - r * w;
  int key = (r / 2) * ((w + 1) / 2) + c / 2;
  int rmax = __reduce_max_sync(peers, r);
  int cmin = __reduce_min_sync(peers, c);
  int cmax = __reduce_max_sync(peers, c);
  int kmin = __reduce_min_sync(peers, key);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(stats + root, __popc(peers));
    atomicMax(stats + n + root, rmax);
    atomicMin(stats + 2 * n + root, cmin);
    atomicMax(stats + 3 * n + root, cmax);
    atomicMin(stats + 4 * n + root, kmin);
  }
}

// np.histogram's uniform edge i over [lo, hi] (linspace: i * step + lo,
// the last edge hi)
__device__ __forceinline__ double edge(int i, double lo, double hi,
                                       double step) {
  return i == kOtsuBins ? hi : __dadd_rn(__dmul_rn((double)i, step), lo);
}

__global__ void omr_hist_kernel(const float* __restrict__ x, long long n,
                                const float* __restrict__ lohi, int* hist) {
  __shared__ int local[kOtsuBins];
  for (int i = threadIdx.x; i < kOtsuBins; i += blockDim.x) local[i] = 0;
  __syncthreads();
  double lo = (double)lohi[0], hi = (double)lohi[1];
  double span = __dsub_rn(hi, lo);
  double step = __ddiv_rn(span, (double)kOtsuBins);
  if (span > 0.0) {
    for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         j < n; j += (long long)gridDim.x * blockDim.x) {
      double v = (double)x[j];
      double f = __dmul_rn(__ddiv_rn(__dsub_rn(v, lo), span),
                           (double)kOtsuBins);
      int i = (int)f;
      if (i >= kOtsuBins) i = kOtsuBins - 1;
      if (i > 0 && v < edge(i, lo, hi, step)) i -= 1;
      if (i < kOtsuBins - 1 && v >= edge(i + 1, lo, hi, step)) i += 1;
      atomicAdd(local + i, 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kOtsuBins; i += blockDim.x)
    if (local[i]) atomicAdd(hist + i, local[i]);
}

__global__ void omr_otsu_kernel(const int* __restrict__ hist,
                                const float* __restrict__ lohi,
                                double* out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  double lo = (double)lohi[0], hi = (double)lohi[1];
  if (lo == hi) {
    out[0] = lo;
    return;
  }
  double step = __ddiv_rn(__dsub_rn(hi, lo), (double)kOtsuBins);
  double centers[kOtsuBins];
  for (int i = 0; i < kOtsuBins; ++i)
    centers[i] = __ddiv_rn(__dadd_rn(edge(i, lo, hi, step),
                                     edge(i + 1, lo, hi, step)), 2.0);
  double w1[kOtsuBins], s1[kOtsuBins], w2[kOtsuBins], s2[kOtsuBins];
  double acc_w = 0.0, acc_s = 0.0;
  for (int i = 0; i < kOtsuBins; ++i) {
    double h = (double)hist[i];
    acc_w = __dadd_rn(acc_w, h);
    acc_s = __dadd_rn(acc_s, __dmul_rn(h, centers[i]));
    w1[i] = acc_w;
    s1[i] = acc_s;
  }
  acc_w = 0.0;
  acc_s = 0.0;
  for (int i = kOtsuBins - 1; i >= 0; --i) {
    double h = (double)hist[i];
    acc_w = __dadd_rn(acc_w, h);
    acc_s = __dadd_rn(acc_s, __dmul_rn(h, centers[i]));
    w2[i] = acc_w;
    s2[i] = acc_s;
  }
  int best = 0;
  double best_v = 0.0;
  for (int i = 0; i < kOtsuBins - 1; ++i) {
    double m1 = __ddiv_rn(s1[i], fmax(w1[i], 1e-12));
    double m2 = __ddiv_rn(s2[i + 1], fmax(w2[i + 1], 1e-12));
    double d = __dsub_rn(m1, m2);
    double v = __dmul_rn(__dmul_rn(w1[i], w2[i + 1]), __dmul_rn(d, d));
    if (i == 0 || v > best_v || (isnan(v) && !isnan(best_v))) {
      best = i;
      best_v = v;
    }
  }
  out[0] = centers[best];
}

__device__ float pairwise_sum(const float* a, int n) {
  if (n < 8) {
    float res = 0.f;
    for (int i = 0; i < n; ++i) res = __fadd_rn(res, a[i]);
    return res;
  }
  if (n <= 128) {
    float r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = a[j];
    int i = 8;
    for (; i < n - (n % 8); i += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) r[j] = __fadd_rn(r[j], a[i + j]);
    }
    float res = __fadd_rn(__fadd_rn(__fadd_rn(r[0], r[1]),
                                    __fadd_rn(r[2], r[3])),
                          __fadd_rn(__fadd_rn(r[4], r[5]),
                                    __fadd_rn(r[6], r[7])));
    for (; i < n; ++i) res = __fadd_rn(res, a[i]);
    return res;
  }
  int n2 = n / 2;
  n2 -= n2 % 8;
  return __fadd_rn(pairwise_sum(a, n2), pairwise_sum(a + n2, n - n2));
}

__global__ void omr_row_sums_kernel(const float* __restrict__ x, int rows,
                                    int n, int ld, float* out) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < rows) out[r] = pairwise_sum(x + (size_t)r * ld, n);
}

__global__ void omr_col_means_kernel(const float* __restrict__ x, int h,
                                     int w, const int* __restrict__ r0,
                                     const int* __restrict__ r1, int slots,
                                     float* out) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  int s = blockIdx.y;
  if (c >= w || s >= slots) return;
  int a = max(r0[s], 0);
  int b = min(r1[s], h);
  float res;
  if (b <= a) {
    res = nanf("");
  } else {
    float acc = x[(size_t)a * w + c];
    for (int r = a + 1; r < b; ++r) acc = __fadd_rn(acc, x[(size_t)r * w + c]);
    res = (float)__ddiv_rn((double)acc, (double)(b - a));
  }
  out[(size_t)s * w + c] = res;
}

// x(i) of a line of `len` elements `step` apart, mirrored about each end
__device__ __forceinline__ double mirrored(const float* line, int i, int len,
                                           int step) {
  if (i < 0) i = -i;
  if (i >= len) i = 2 * len - 2 - i;
  return (double)line[(size_t)i * step];
}

__global__ void omr_box3_kernel(const float* __restrict__ in, float* out,
                                int lines, int len, int line_stride,
                                int step) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lines) return;
  const float* src = in + (size_t)l * line_stride;
  float* dst = out + (size_t)l * line_stride;
  double sum = 0.0;
  for (int k = -1; k <= 1; ++k) sum = __dadd_rn(sum, mirrored(src, k, len, step));
  dst[0] = (float)__ddiv_rn(sum, 3.0);
  for (int i = 1; i < len; ++i) {
    double d = __dsub_rn(mirrored(src, i + 1, len, step),
                         mirrored(src, i - 2, len, step));
    sum = __dadd_rn(sum, d);
    dst[(size_t)i * step] = (float)__ddiv_rn(sum, 3.0);
  }
}

}  // namespace

extern "C" {

int omr_label(const void* mask, int h, int w, void* labels, void* stats,
              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int n = h * w;
  const uint8_t* m = (const uint8_t*)mask;
  int* lab = (int*)labels;
  int blocks = (n + kThreads - 1) / kThreads;
  omr_label_init<<<blocks, kThreads, 0, s>>>(m, lab, (int*)stats, n);
  dim3 grid((w + kThreads - 1) / kThreads, h);
  omr_label_merge<<<grid, kThreads, 0, s>>>(m, lab, h, w);
  omr_label_flatten<<<blocks, kThreads, 0, s>>>(lab, (int*)stats, n, w);
  return (int)cudaGetLastError();
}

int omr_row_sums(const void* x, int rows, int n, int ld, void* out,
                 void* stream) {
  int blocks = (rows + kThreads - 1) / kThreads;
  omr_row_sums_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, rows, n, ld, (float*)out);
  return (int)cudaGetLastError();
}

int omr_col_means(const void* x, int h, int w, const void* r0,
                  const void* r1, int slots, void* out, void* stream) {
  dim3 grid((w + kThreads - 1) / kThreads, slots);
  omr_col_means_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, h, w, (const int*)r0, (const int*)r1, slots,
      (float*)out);
  return (int)cudaGetLastError();
}

int omr_box3(const void* in, void* out, int lines, int len, int line_stride,
             int step, void* stream) {
  int blocks = (lines + kThreads - 1) / kThreads;
  omr_box3_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, lines, len, line_stride, step);
  return (int)cudaGetLastError();
}

int omr_otsu(const void* x, long long n, const void* lohi, void* hist,
             void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(hist, 0, kOtsuBins * sizeof(int), s);
  long long want = (n + kThreads - 1) / kThreads;
  int blocks = (int)(want < 264 ? (want > 0 ? want : 1) : 264);
  omr_hist_kernel<<<blocks, kThreads, 0, s>>>((const float*)x, n,
                                              (const float*)lohi,
                                              (int*)hist);
  omr_otsu_kernel<<<1, 1, 0, s>>>((const int*)hist, (const float*)lohi,
                                  (double*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
