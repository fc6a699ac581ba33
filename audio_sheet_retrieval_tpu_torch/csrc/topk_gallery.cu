// Exact top-k inner-product search of queries over a gallery, without
// materialising the [Q, N] score matrix in device memory.
//
// Replaces: audio_sheet_retrieval_tpu/ops/topk_gallery.py, _topk_kernel
// (launched by _topk_pallas, wrapped by topk_gallery).
//
// What bounds it on the H100: at serving shapes (Q ~ 100 queries, d = 32,
// k = 25, N up to 1e6 rows) the gallery is read once per query block
// (128 B per row at d = 32; 128 MB at N = 1e6, more than the 50 MB L2), and
// the score FMAs (Q*N*d) are fed from shared memory. The k-best bookkeeping
// costs little once a query's k-th best score is high: most rows fail the
// threshold test.
//
// Design: the TPU kernel walks gallery tiles in sequence per 128-query
// block, which on this card would keep one SM busy. Here the gallery is
// split into chunks across CTAs:
//   pass 1 (topk_chunk_kernel): a CTA takes QB = 8 queries x one gallery
//     chunk. Each 256-row tile is staged in shared memory with coalesced
//     loads (row stride padded to an odd word count: conflict-free), every
//     thread scores one row against the 8 queries (broadcast reads), and
//     warp w keeps query w's sorted k-best list: lanes whose score beats
//     the current k-th best are inserted one at a time by the whole warp
//     (ballot + shuffle). The chunk's list ends in a scratch buffer
//     [Q, n_chunks, kp], kp = min(k, chunk): a chunk has no more rows.
//   pass 2 (topk_merge_kernel): one CTA per query; each of its 8 warps
//     merges every 8th chunk's list into a list of its own (the first one
//     copied, the others offered the same way), then warp 0 merges the 8
//     lists and writes the k best, descending. A sorted list is offered 32
//     entries at a time and the rest of it is skipped as soon as the worst
//     of a group of 32 fails the threshold. (With one warp a query, the
//     merge walked up to 489 lists in turn at Q = 1, N = 1e6, and took
//     longer than the plain version.)
// Where the lists live: lists of at most KSMEM entries (slots rounded up
// to 32) sit in shared memory (8 bytes a slot, so pass 1 fits the 227 KB
// a block may use). Longer ones stay in global memory: pass 1 builds each
// list in place in its part_s / part_i slot, pass 2 in a scratch buffer
// [Q, 8, k]. warp_insert / warp_offer take plain pointers, and __syncwarp()
// orders the warp's global accesses as it orders its shared ones; each
// kernel is instantiated once per place (template argument kSmem), so the
// shared-memory lists are never reached through generic addressing. So any
// 0 <= k <= N is served; a list in global memory costs L1/L2 latency on
// every insertion, which is slow at large k but exact.
// Query blocks are the fastest grid dimension, so the CTAs that read the
// same chunk run close together and share it through L2.
//
// Semantics (those of the JAX kernel and of the plain PyTorch version):
// descending scores; among equal scores the lower gallery index first;
// a NaN score counts as -inf; rows past N are never returned. k may exceed
// the Pallas kernel's 128 and is bounded only by N.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QB = 8;          // queries per CTA (one warp each)
constexpr int TILE = 256;      // gallery rows per shared-memory tile
constexpr int THREADS = 256;   // pass 1: one thread per tile row
constexpr int MERGE_WARPS = 8; // pass 2: warps per query
constexpr int KSMEM = 1024;    // largest k whose lists sit in shared memory
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Warp-cooperative insertion of (s, i) into the sorted list ls/li holding
// `cnt` entries (at most k). Every argument is warp-uniform.
__device__ __forceinline__ void warp_insert(float* ls, int* li, int& cnt,
                                            int k, float s, int i, int lane) {
  if (cnt == k && !better(s, i, ls[k - 1], li[k - 1])) return;
  int pos = 0;  // entries that stay ahead of (s, i)
  for (int base = 0; base < cnt; base += 32) {
    int j = base + lane;
    bool ahead = j < cnt && better(ls[j], li[j], s, i);
    pos += __popc(__ballot_sync(FULL, ahead));
  }
  // entries [pos, last) move up by one, 32 at a time from the top, so no
  // step overwrites an entry a later step still has to read
  int last = cnt < k ? cnt : k - 1;
  for (int top = last - 1; top >= pos; top -= 32) {
    int j = top - lane;
    bool move = j >= pos;
    float vs = 0.f;
    int vi = 0;
    if (move) { vs = ls[j]; vi = li[j]; }
    __syncwarp();
    if (move) { ls[j + 1] = vs; li[j + 1] = vi; }
    __syncwarp();
  }
  if (lane == 0) { ls[pos] = s; li[pos] = i; }
  __syncwarp();
  cnt = cnt < k ? cnt + 1 : k;
}

// Offer each lane's candidate (valid lanes only) to the warp's list.
__device__ __forceinline__ void warp_offer(float* ls, int* li, int& cnt, int k,
                                           bool valid, float s, int i,
                                           int lane) {
  bool want = valid && (cnt < k || better(s, i, ls[k - 1], li[k - 1]));
  unsigned mask = __ballot_sync(FULL, want);
  while (mask) {
    int src = __ffs(mask) - 1;
    mask &= mask - 1;
    float cs = __shfl_sync(FULL, s, src);
    int ci = __shfl_sync(FULL, i, src);
    warp_insert(ls, li, cnt, k, cs, ci, lane);
  }
}

template <bool kSmem>
__global__ void __launch_bounds__(THREADS)
topk_chunk_kernel(const float* __restrict__ queries,
                  const float* __restrict__ gallery, int Q, int N, int d,
                  int k, int kcap, int chunk, int n_chunks,
                  float* __restrict__ part_s, int* __restrict__ part_i) {
  // k: the list width (kp of the entry point below);
  // kSmem: the lists sit in shared memory, kcap slots each; otherwise each
  // list is built in place in its part_s / part_i slot. (A template
  // argument, not a run-time branch: the shared lists' pointers then stay
  // shared-space pointers, and the insertions use shared loads and stores
  // instead of generic ones.)
  extern __shared__ float smem[];
  const int stride = d | 1;                  // odd row stride: no conflicts
  float* gs = smem;                          // [TILE][stride]
  float* qs = gs + TILE * stride;            // [d][QB] (transposed)
  float* sc = qs + d * QB;                   // [QB][TILE] scores

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int q0 = blockIdx.x * QB;
  const int c = blockIdx.y;
  const long long base = ((long long)(q0 + w) * n_chunks + c) * k;
  float* ls;  // warp w's list
  int* li;
  if constexpr (kSmem) {
    ls = sc + QB * TILE + w * kcap;                        // [QB][kcap]
    li = reinterpret_cast<int*>(sc + QB * TILE + QB * kcap) + w * kcap;
  } else {
    ls = part_s + base;
    li = part_i + base;
  }
  const long long row_begin = (long long)c * chunk;
  const long long row_end_ll = row_begin + chunk < N ? row_begin + chunk : N;
  const int row_end = (int)row_end_ll;

  for (int e = tid; e < QB * d; e += THREADS) {
    int qq = e / d, j = e - qq * d;
    qs[j * QB + qq] = (q0 + qq < Q) ? queries[(long long)(q0 + qq) * d + j]
                                    : 0.f;
  }
  int cnt = 0;  // entries in warp w's list (warp-uniform)

  for (int t0 = (int)row_begin; t0 < row_end; t0 += TILE) {
    const int rows = row_end - t0 < TILE ? row_end - t0 : TILE;
    __syncthreads();  // previous tile's gs / sc no longer read
    const float* src = gallery + (long long)t0 * d;
    for (int e = tid; e < rows * d; e += THREADS) {
      int r = e / d;
      gs[r * stride + (e - r * d)] = src[e];
    }
    __syncthreads();
    if (tid < rows) {
      float acc[QB];
#pragma unroll
      for (int qq = 0; qq < QB; ++qq) acc[qq] = 0.f;
      const float* g = gs + tid * stride;
      for (int j = 0; j < d; ++j) {
        float gv = g[j];
        const float4 qa = *reinterpret_cast<const float4*>(qs + j * QB);
        const float4 qb = *reinterpret_cast<const float4*>(qs + j * QB + 4);
        acc[0] = fmaf(qa.x, gv, acc[0]);
        acc[1] = fmaf(qa.y, gv, acc[1]);
        acc[2] = fmaf(qa.z, gv, acc[2]);
        acc[3] = fmaf(qa.w, gv, acc[3]);
        acc[4] = fmaf(qb.x, gv, acc[4]);
        acc[5] = fmaf(qb.y, gv, acc[5]);
        acc[6] = fmaf(qb.z, gv, acc[6]);
        acc[7] = fmaf(qb.w, gv, acc[7]);
      }
#pragma unroll
      for (int qq = 0; qq < QB; ++qq)
        sc[qq * TILE + tid] = isnan(acc[qq]) ? -INFINITY : acc[qq];
    }
    __syncthreads();
    if (q0 + w < Q) {
      for (int r0 = 0; r0 < rows; r0 += 32) {
        int r = r0 + lane;
        bool valid = r < rows;
        float s = valid ? sc[w * TILE + r] : -INFINITY;
        warp_offer(ls, li, cnt, k, valid, s, t0 + r, lane);
      }
    }
  }

  if (q0 + w < Q) {  // (in place when the list is part_s / part_i itself)
    for (int j = lane; j < k; j += 32) {
      part_s[base + j] = j < cnt ? ls[j] : -INFINITY;
      part_i[base + j] = j < cnt ? li[j] : -1;  // -1: empty slot
    }
  }
}

// Merge the sorted list (src_s, src_i)[0, len) into the warp's sorted list
// ls/li (cnt entries, at most k). An entry with a negative index is empty,
// and only empty entries follow it. Every argument is warp-uniform.
__device__ __forceinline__ void warp_merge(const float* src_s,
                                           const int* src_i, int len,
                                           float* ls, int* li, int& cnt,
                                           int k, int lane) {
  if (cnt == 0) {  // an empty list takes the filled prefix as it is
    const int n = len < k ? len : k;
    for (int j0 = 0; j0 < n; j0 += 32) {
      int j = j0 + lane;
      int i = j < n ? src_i[j] : -1;
      if (i >= 0) { ls[j] = src_s[j]; li[j] = i; }
      int filled = __popc(__ballot_sync(FULL, i >= 0));
      cnt += filled;
      if (filled < 32) break;
    }
    __syncwarp();
    return;
  }
  for (int j0 = 0; j0 < len; j0 += 32) {
    int j = j0 + lane;
    int i = j < len ? src_i[j] : -1;
    float s = j < len ? src_s[j] : -INFINITY;
    // the group's worst entry (its last one) failing the threshold means
    // every later entry of this sorted list fails too
    bool want = i >= 0 && (cnt < k || better(s, i, ls[k - 1], li[k - 1]));
    unsigned filled = __ballot_sync(FULL, i >= 0);
    bool last_wanted = (__ballot_sync(FULL, want) >> 31) & 1u;
    warp_offer(ls, li, cnt, k, i >= 0, s, i, lane);
    if (filled != FULL || !last_wanted) break;
  }
}

template <bool kSmem>
__global__ void __launch_bounds__(32 * MERGE_WARPS)
topk_merge_kernel(const float* __restrict__ part_s,
                  const int* __restrict__ part_i, int Q, int k, int kp,
                  int kcap, int n_chunks, float* __restrict__ out_s,
                  int64_t* __restrict__ out_i, float* __restrict__ scr_s,
                  int* __restrict__ scr_i) {
  // one CTA per query; warp w merges chunks w, w + MERGE_WARPS, ... into
  // its own list, then warp 0 merges the other warps' lists into its own.
  // kSmem: the lists sit in shared memory ([MERGE_WARPS][kcap] scores,
  // then ids); otherwise in scr_s / scr_i [Q, MERGE_WARPS, k]
  extern __shared__ float msmem[];
  __shared__ int counts[MERGE_WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int q = blockIdx.x;
  float* ls0;
  int* li0;
  long long stride;  // between two warps' lists
  if constexpr (kSmem) {
    ls0 = msmem;
    li0 = reinterpret_cast<int*>(msmem + MERGE_WARPS * kcap);
    stride = kcap;
  } else {
    ls0 = scr_s + (long long)q * MERGE_WARPS * k;
    li0 = scr_i + (long long)q * MERGE_WARPS * k;
    stride = k;
  }
  float* ls = ls0 + w * stride;
  int* li = li0 + w * stride;
  const float* ps = part_s + (long long)q * n_chunks * kp;
  const int* pi = part_i + (long long)q * n_chunks * kp;
  int cnt = 0;
  for (int c = w; c < n_chunks; c += MERGE_WARPS)
    warp_merge(ps + (long long)c * kp, pi + (long long)c * kp, kp, ls, li,
               cnt, k, lane);
  if (lane == 0) counts[w] = cnt;
  __syncthreads();
  if (w != 0) return;
  for (int v = 1; v < MERGE_WARPS; ++v)
    warp_merge(ls0 + v * stride, li0 + v * stride, counts[v], ls, li, cnt, k,
               lane);
  for (int j = lane; j < k; j += 32) {
    out_s[(long long)q * k + j] = j < cnt ? ls[j] : -INFINITY;
    out_i[(long long)q * k + j] = j < cnt ? (int64_t)li[j] : -1;
  }
}

// Bytes of dynamic shared memory pass 1 needs for embedding width d and
// list width kcap (k rounded up to a multiple of 32; 0: lists in global
// memory).
int chunk_smem_bytes(int d, int kcap) {
  return (int)(sizeof(float) * (TILE * (d | 1) + d * QB + QB * TILE
                                + QB * kcap)
               + sizeof(int) * QB * kcap);
}

}  // namespace

extern "C" {

// queries [Q, d] f32, gallery [N, d] f32 (both contiguous, on the device);
// part_s / part_i: scratch [Q, n_chunks, min(k, chunk)]; out_s [Q, k] f32,
// out_i [Q, k] int64; scr_s / scr_i: f32 / int32 scratch
// [Q, MERGE_WARPS, k], read only when k > KSMEM (may be null otherwise).
// n_chunks = ceil(N / chunk), 1 <= k <= N.
// Returns cudaGetLastError().
int topk_gallery_f32(const void* queries, const void* gallery, int Q, int N,
                     int d, int k, int chunk, int n_chunks, void* part_s,
                     void* part_i, void* out_s, void* out_i, void* scr_s,
                     void* scr_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kp = k < chunk ? k : chunk;  // a chunk's list: at most its rows
  const int kcap1 = kp <= KSMEM ? (kp + 31) / 32 * 32 : 0;
  const int kcap = k <= KSMEM ? (k + 31) / 32 * 32 : 0;
  const int smem1 = chunk_smem_bytes(d, kcap1);
  auto chunk_kernel =
      kcap1 > 0 ? topk_chunk_kernel<true> : topk_chunk_kernel<false>;
  cudaFuncSetAttribute(chunk_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  dim3 grid1((Q + QB - 1) / QB, n_chunks);
  chunk_kernel<<<grid1, THREADS, smem1, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(gallery),
      Q, N, d, kp, kcap1, chunk, n_chunks, static_cast<float*>(part_s),
      static_cast<int*>(part_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem2 = (int)((sizeof(float) + sizeof(int)) * MERGE_WARPS * kcap);
  auto merge_kernel =
      kcap > 0 ? topk_merge_kernel<true> : topk_merge_kernel<false>;
  cudaFuncSetAttribute(merge_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  merge_kernel<<<Q, 32 * MERGE_WARPS, smem2, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i), Q,
      k, kp, kcap, n_chunks, static_cast<float*>(out_s),
      static_cast<int64_t*>(out_i), static_cast<float*>(scr_s),
      static_cast<int*>(scr_i));
  return (int)cudaGetLastError();
}

}  // extern "C"
