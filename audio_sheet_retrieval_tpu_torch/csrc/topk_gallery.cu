// Exact top-k inner-product search of queries over a gallery, without
// materialising the [Q, N] score matrix in device memory.
//
// Replaces: audio_sheet_retrieval_tpu/ops/topk_gallery.py, _topk_kernel
// (launched by _topk_pallas, wrapped by topk_gallery).
//
// What bounds it on the H100: the gallery must be read once (N d 4 bytes,
// 128 MB at N = 1e6, d = 32: 38 us at 3.35 TB/s) and scored Q N d times in
// float32 FMAs (the port keeps f32 with TF32 off: 2 Q N d flops at the
// 67 TFLOP/s of the CUDA cores, 95 us at Q = 100, N = 1e6). Below Q of
// about 40 the bytes bound it, above it the FMAs. Keeping the k best costs
// little at k = 25 once a query's k-th best score is known, because most
// rows fail it; at large k it is the selection that costs. In practice the
// scoring loop reaches 10-20 % of the FMA rate (PERF.md: its limit is not
// yet known), and at k of 1,024 and more, where one CTA fills a SM, the
// selection about as much again.
//
// Design (the launch plan, sizes included, is computed in Python by
// ops/topk_gallery.py::plan and passed in):
//   pass 1: a CTA takes QBW queries (1, 8 or 32, the narrowest that holds
//     Q, so that at Q = 100 four CTAs share each gallery chunk, one after
//     another in the grid so that L2 serves the re-reads, and at Q = 1 no
//     accumulator is idle) and one chunk of gallery rows. Tiles of
//     TR = 128 rows arrive in a ring of STAGES tiles in shared memory
//     through cp.async 16-byte copies, STAGES - 1 tiles ahead of the one
//     being scored (tile_loop). Each thread owns RM rows x RQ queries of
//     register accumulators and reads float4s, each of which feeds
//     4 RM RQ / (RM + RQ) FMAs (Shape for k <= 32: 1 x 1, 2 x 2, 4 x 4 for
//     the three widths; ShapeK above: 1 x 1, 2 x 1, 4 x 2, with twice the
//     threads at QBW 8 and 32); the row stride is d + 4 floats, so a warp's
//     16-byte row loads are free of bank conflicts and its query loads
//     broadcast.
//   selection for k <= 32 (the serving k = 25; topk_chunk_warp_kernel):
//     each query's list of its 32 best is held in a warp's registers, one
//     entry a lane, sorted. A score that beats the list's k-th entry (the
//     threshold, kept in shared memory) goes to the query's buffer; after
//     each tile the owning warp takes the buffer: a few candidates by
//     ballot + shuffle insertion, more as a batch sorted by a 32-lane
//     bitonic network and merged into the list in one bitonic merge.
//   selection for k > 32 (topk_chunk_kernel): the CTA keeps every score of
//     its chunk, then for each query a radix select (8 bits a pass, a
//     256-bin histogram in shared memory) finds the key of the kp-th best
//     score, and a second radix select over the row indices of the scores
//     equal to it settles the tie rule; the kp best go to the part list
//     unsorted. The CTA's threads form up to 8 teams (two warps each at
//     QBW 8, synchronised by named barriers) that select side by side, and
//     each thread reads 8 entries before it counts them, so that one CTA a
//     SM still hides the latency of its loads. No entry is ever inserted
//     into a long list one at a time, which costs O(k) an entry. The plan
//     keeps blocks of 8 queries where it can (shortening the chunk to as
//     few as 2 k rows), so that the gallery is not read once per query.
//   pass 2: one CTA per query merges the n_chunks part lists the same way:
//     for k <= 32 each warp keeps a register list over a strided share of
//     the entries and warp 0 merges the eight lists; above, 1,024 threads
//     copy the lists' keys into shared memory once (where they fit), run
//     the radix select there, and sort the k best with a bitonic network
//     whose steps within a warp's 64 slots need no block barrier.
// Where the data lives: in shared memory when it fits the 227 KB a CTA may
// use; otherwise pass 1's chunk scores and pass 2's sort area go to global
// scratch, with the same code instantiated for it (template argument
// kSmem, so shared-memory arrays are never reached through generic
// addressing). So any 0 <= k <= N is served.
// Tried on the card and dropped (PERF.md): a 64-query block, a 3- and
// 4-tile ring, 4 x 8 register tiles, a thread mapping whose row loads are
// broadcasts, per-thread counters for the two most frequent histogram
// bins, a warp vote that counts a whole warp's bin at once, gathering the
// keys that share T's top two bytes before the last two radix passes, and
// deeper unrolling of the selection's or the scoring's loops.
// Tensor cores are not used: single-pass TF32 changes the scores by more
// than the 1e-4 the port's checks allow, and a 3xTF32 mma.sync path is left
// for a later change (ROADMAP Queue 2).
//
// Semantics (those of the JAX kernel and of the plain PyTorch version):
// descending scores; among equal scores the lower gallery index first;
// a NaN score counts as -inf; rows past N are never returned. An empty
// slot is (-inf, INT_MAX), which sorts after every real entry.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TR = 128;         // gallery rows per tile
constexpr int STAGES = 2;       // tiles in flight in shared memory
constexpr int MERGE_THREADS = 256;   // pass 2 for k <= WARP_K
constexpr int MERGE_THREADS_K = 1024; // pass 2 above: one CTA a query
constexpr int UNROLL = 8;           // entries a thread reads at once
constexpr int EMPTY = 0x7fffffff;
constexpr int WARP_K = 32;      // k up to this: lists in a warp's registers
constexpr int INSERT_MAX = 6;   // fewer candidates than this: insert each
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Sort a[0, n) better-first (n a power of two) with all NT threads: a
// bitonic network. Thread e's pairs lie in the 64 slots from 64 (e / 32)
// (and 64 NT / 32 further on) while the stride is at most 32, so a warp
// keeps its own slots between two such steps and needs only __syncwarp;
// the other steps end in a block barrier.
template <int NT>
__device__ __forceinline__ void block_sort(float* as, int* ai, int n) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int e = threadIdx.x; e < n / 2; e += NT) {
        const int lo = 2 * e - (e & (stride - 1));  // stride: a power of 2
        const int hi = lo + stride;
        const float s0 = as[lo], s1 = as[hi];
        const int i0 = ai[lo], i1 = ai[hi];
        const bool first_up = (lo & size) == 0;  // block sorts better-first
        if (first_up ? better(s1, i1, s0, i0) : better(s0, i0, s1, i1)) {
          as[lo] = s1; ai[lo] = i1;
          as[hi] = s0; ai[hi] = i0;
        }
      }
      const int next = stride > 1 ? stride >> 1 : size;  // the next stride
      if (stride <= 32 && next <= 32) __syncwarp();
      else __syncthreads();
    }
  __syncthreads();
}

// Order-preserving key of a score: a better score has a larger key, and
// equal scores have equal keys (s + 0 turns -0 into +0).
__device__ __forceinline__ unsigned key_of(float s) {
  const unsigned u = __float_as_uint(s + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Shared scratch of one team's selection.
struct SelectScratch {
  unsigned hist[256];
  int digit, above, in_digit, n_out;
};

// A team of TEAM consecutive threads (whole warps) selects together. Its
// rank and its barrier: __syncwarp for one warp, else the named barrier
// 1 + the team's number (at most 8 teams a CTA; barrier 0 is
// __syncthreads').
template <int TEAM>
__device__ __forceinline__ int team_rank() {
  return (int)threadIdx.x % TEAM;
}
template <int TEAM>
__device__ __forceinline__ void team_sync() {
  if constexpr (TEAM == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + (int)threadIdx.x / TEAM),
                 "n"(TEAM)
                 : "memory");
  }
}

// Radix select, 8 bits a pass from the top, with a team of TEAM threads:
// of the entries e in [0, n) for which key_at(e, &key) is true, the r-th
// largest key T (1 <= r <= their number). -> T, `take` = how many of the r
// largest equal T, and n_eq = how many entries equal T. Each thread reads
// UNROLL entries before it counts any, so that their loads overlap.
template <int TEAM, class KeyAt>
__device__ __forceinline__ void radix_kth(KeyAt key_at, int n, int r,
                                          SelectScratch& x, unsigned& T,
                                          int& take, int& n_eq) {
  const int tid = team_rank<TEAM>(), lane = tid & 31, warp = tid >> 5;
  unsigned prefix = 0, mask = 0;
  int remaining = r;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += TEAM) x.hist[b] = 0;
    team_sync<TEAM>();
    for (int base = tid; base < n; base += TEAM * UNROLL) {
      unsigned key[UNROLL];
      bool v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = base + u * TEAM;
        v[u] = e < n && key_at(e, key[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (v[u] && (key[u] & mask) == prefix)
          atomicAdd(&x.hist[(key[u] >> shift) & 255u], 1u);
    }
    team_sync<TEAM>();
    if (warp == 0) {  // lane l scans bins 255 - 8 l down to 248 - 8 l
      int c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = (int)x.hist[255 - 8 * lane - j];
        sum += c[j];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
      }
      int acc = incl - sum;
      if (acc < remaining && incl >= remaining) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (acc + c[j] >= remaining) {
            x.digit = 255 - 8 * lane - j;
            x.above = acc;
            x.in_digit = c[j];
            break;
          }
          acc += c[j];
        }
      }
    }
    team_sync<TEAM>();
    prefix |= (unsigned)x.digit << shift;
    mask |= 0xffu << shift;
    remaining -= x.above;
    n_eq = x.in_digit;
    team_sync<TEAM>();  // x read before the next pass writes it
  }
  T = prefix;
  take = remaining;
}

// The k best entries, by (score descending, index ascending), of the n
// entries that key_at(e, &key) reports as valid (at least k of them; key =
// key_of(score)), appended in no order to out_s / out_i [0, k) as item(e,
// &s, &i) gives them: a radix select finds T, the key of the k-th best
// score; when only some of the entries whose key is T belong to the k
// best, a second radix select over their indices finds the largest index
// that does.
template <int TEAM, class KeyAt, class Item>
__device__ __forceinline__ void select_k(KeyAt key_at, Item item, int n,
                                         int k, float* out_s, int* out_i,
                                         SelectScratch& x) {
  unsigned T;
  int take, n_eq;
  radix_kth<TEAM>(key_at, n, k, x, T, take, n_eq);
  int i_max = EMPTY;  // ties with an index up to this belong to the k best
  if (take < n_eq) {
    unsigned T2;
    int take2, n_eq2;
    radix_kth<TEAM>(
        [&](int e, unsigned& key) {
          unsigned ke;
          if (!key_at(e, ke) || ke != T) return false;
          float s;
          int i;
          item(e, s, i);
          key = ~(unsigned)i;  // the smaller index, the larger key
          return true;
        },
        n, take, x, T2, take2, n_eq2);
    i_max = (int)~T2;
  }
  const int tid = team_rank<TEAM>(), lane = tid & 31;
  if (tid == 0) x.n_out = 0;
  team_sync<TEAM>();
  for (int base = tid - lane; base < n; base += TEAM * UNROLL) {
    unsigned key[UNROLL];
    bool v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = base + u * TEAM + lane;
      v[u] = e < n && key_at(e, key[u]) && key[u] >= T;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float s = 0.f;
      int i = 0;
      bool want = false;
      if (v[u]) {
        item(base + u * TEAM + lane, s, i);
        want = key[u] > T || i <= i_max;
      }
      const unsigned m = __ballot_sync(FULL, want);
      int pos = 0;
      if (lane == 0 && m) pos = atomicAdd(&x.n_out, __popc(m));
      pos = __shfl_sync(FULL, pos, 0) + __popc(m & ((1u << lane) - 1u));
      if (want) {
        out_s[pos] = s;
        out_i[pos] = i;
      }
    }
  }
  team_sync<TEAM>();
}

// Micro-tile of each pass-1 instance: RQ queries x RM rows a thread; for
// k <= WARP_K (Shape), and for k above (ShapeK: twice the threads where a
// block holds several queries, so that the one CTA that fits a SM next to
// its chunk's scores still has 16 warps to hide latency).
template <int QBW> struct Shape;
template <> struct Shape<1> { static constexpr int RQ = 1, RM = 1; };
template <> struct Shape<8> { static constexpr int RQ = 2, RM = 2; };
template <> struct Shape<32> { static constexpr int RQ = 4, RM = 4; };
template <int QBW> struct ShapeK;
template <> struct ShapeK<1> { static constexpr int RQ = 1, RM = 1; };
template <> struct ShapeK<8> { static constexpr int RQ = 1, RM = 2; };
template <> struct ShapeK<32> { static constexpr int RQ = 2, RM = 4; };

template <int QBW, class Sh = Shape<QBW>>
__host__ __device__ constexpr int chunk_threads() {
  return (QBW / Sh::RQ) * (TR / Sh::RM);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage gallery rows [t0, t0 + rows) into a tile (row stride d + 4).
__device__ __forceinline__ void load_tile(float* tile,
                                          const float* __restrict__ gallery,
                                          int t0, int rows, int d, int tid,
                                          int nthreads) {
  const int dq = d >> 2;
  const float* src = gallery + (long long)t0 * d;
  for (int e = tid; e < rows * dq; e += nthreads) {
    const int r = e / dq, c = e - r * dq;
    cp_async16(tile + r * (d + 4) + 4 * c, src + (long long)r * d + 4 * c);
  }
}


// --- lists of up to 32 entries in a warp's registers (k <= WARP_K) -------
// Lane j holds entry j; entries are sorted better-first across the lanes.

// Compare-exchange of the lane pair (lane, lane ^ stride) within blocks
// that sort better-first when `up`, worse-first otherwise.
__device__ __forceinline__ void cx(float& s, int& i, int stride, bool up,
                                   int lane) {
  const float os = __shfl_xor_sync(FULL, s, stride);
  const int oi = __shfl_xor_sync(FULL, i, stride);
  const bool lower = (lane & stride) == 0;
  const bool take = (lower == up) ? better(os, oi, s, i) : better(s, i, os, oi);
  if (take) { s = os; i = oi; }
}

// Sort one entry a lane across the warp, better-first.
__device__ __forceinline__ void warp_sort32(float& s, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      cx(s, i, stride, (lane & size) == 0, lane);
}

// The 32 best of the sorted list (s, i) and the sorted batch (cs, ci),
// sorted: the better of list[j] and batch[31 - j] is a bitonic sequence
// holding them, and one bitonic merge sorts it.
__device__ __forceinline__ void warp_merge32(float& s, int& i, float cs,
                                             int ci, int lane) {
  const float rs = __shfl_sync(FULL, cs, 31 - lane);
  const int ri = __shfl_sync(FULL, ci, 31 - lane);
  if (better(rs, ri, s, i)) { s = rs; i = ri; }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) cx(s, i, stride, true, lane);
}

// Insert (cs, ci) into the sorted list; the 32nd entry falls off.
__device__ __forceinline__ void warp_insert32(float& s, int& i, float cs,
                                              int ci, int lane) {
  const int pos = __popc(__ballot_sync(FULL, better(s, i, cs, ci)));
  const float us = __shfl_up_sync(FULL, s, 1);
  const int ui = __shfl_up_sync(FULL, i, 1);
  if (lane > pos) { s = us; i = ui; }
  else if (lane == pos) { s = cs; i = ci; }
}

// Offer n candidates (src_s, src_i)[0, n) to the warp's list, 32 at a
// time; only those that beat the list's kth entry count. A few are
// inserted one by one, more are sorted and merged as a batch.
__device__ __forceinline__ void warp_take(const float* src_s,
                                          const int* src_i, int n, int kth,
                                          float& s, int& i, int lane) {
  for (int b = 0; b < n; b += 32) {
    const int j = b + lane;
    float cs = j < n ? src_s[j] : -INFINITY;
    int ci = j < n ? src_i[j] : EMPTY;
    const float ts = __shfl_sync(FULL, s, kth - 1);
    const int ti = __shfl_sync(FULL, i, kth - 1);
    const bool want = j < n && better(cs, ci, ts, ti);
    unsigned m = __ballot_sync(FULL, want);
    if (__popc(m) < INSERT_MAX) {
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        warp_insert32(s, i, __shfl_sync(FULL, cs, src),
                      __shfl_sync(FULL, ci, src), lane);
      }
    } else {
      if (!want) { cs = -INFINITY; ci = EMPTY; }
      warp_sort32(cs, ci, lane);
      warp_merge32(s, i, cs, ci, lane);
    }
  }
}

// --- pass 1: the tile loop both selections share ----------------------------
// Streams gallery rows [row_begin, row_end) through the cp.async ring, scores
// each tile against the block's queries qs [QBW][d + 4] in registers, and
// appends each score that beats its query's threshold (thr_s, thr_i) to that
// query's buffer (buf_s / buf_i + qq * bstride + pos, count cnt[qq]); with
// kAll it stores every score instead, at buf_s + qq * bstride + (row -
// row_begin). After each tile every thread calls select() (not with kAll),
// between barriers.
template <int QBW, class Sh, bool kAll, class Select>
__device__ __forceinline__ void tile_loop(
    const float* __restrict__ gallery, float* tiles, const float* qs, int d,
    int row_begin, int row_end, int nq, int* cnt, const float* thr_s,
    const int* thr_i, float* buf_s, int* buf_i, int bstride,
    Select select) {
  constexpr int RQ = Sh::RQ, RM = Sh::RM;
  constexpr int RG = TR / RM;                    // row groups
  constexpr int NT = chunk_threads<QBW, Sh>();
  const int ds = d + 4;
  const int tid = threadIdx.x, rg = tid % RG, qg = tid / RG;
  const int n_tiles = (row_end - row_begin + TR - 1) / TR;
  // tile u goes to stage u % STAGES, STAGES - 1 tiles ahead of the one
  // scored; one commit group per tile (empty past the last), so waiting
  // until STAGES - 1 groups are pending means tile t has arrived
  auto fetch = [&](int u) {
    if (u < n_tiles) {
      const int u0 = row_begin + u * TR;
      load_tile(tiles + (u % STAGES) * TR * ds, gallery, u0,
                min(TR, row_end - u0), d, tid, NT);
    }
    cp_async_commit();
  };
  for (int u = 0; u < STAGES - 1; ++u) fetch(u);
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = row_begin + t * TR;
    fetch(t + STAGES - 1);  // its stage was last read in tile t - 1
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // tile t (and, at t = 0, the caller's set-up) in place

    const float* tile = tiles + (t % STAGES) * TR * ds;
    float acc[RM][RQ];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int k4 = 0; k4 < d; k4 += 4) {
      float4 g[RM], q[RQ];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        g[i] = *reinterpret_cast<const float4*>(tile + (rg + RG * i) * ds +
                                                k4);
#pragma unroll
      for (int j = 0; j < RQ; ++j)
        q[j] = *reinterpret_cast<const float4*>(qs + (qg * RQ + j) * ds + k4);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RQ; ++j) {
          acc[i][j] = fmaf(g[i].x, q[j].x, acc[i][j]);
          acc[i][j] = fmaf(g[i].y, q[j].y, acc[i][j]);
          acc[i][j] = fmaf(g[i].z, q[j].z, acc[i][j]);
          acc[i][j] = fmaf(g[i].w, q[j].w, acc[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < RQ; ++j) {
      const int qq = qg * RQ + j;
      if (qq >= nq) continue;
      float ts = 0.f;
      int ti = 0;
      if constexpr (!kAll) {
        ts = thr_s[qq];
        ti = thr_i[qq];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int row = t0 + rg + RG * i;
        const float s = isnan(acc[i][j]) ? -INFINITY : acc[i][j];
        if (row >= row_end) continue;
        if constexpr (kAll) {
          buf_s[(long long)qq * bstride + (row - row_begin)] = s;
        } else if (better(s, row, ts, ti)) {
          const int pos = atomicAdd(&cnt[qq], 1);
          buf_s[qq * bstride + pos] = s;
          buf_i[qq * bstride + pos] = row;
        }
      }
    }
    __syncthreads();  // buffers complete; tile t no longer read
    if constexpr (!kAll) {
      select();
      __syncthreads();
    }
  }
}

// Pass 1 for k <= WARP_K. Shared memory: STAGES tiles [TR][d + 4]; queries
// [QBW][d + 4]; per query a count, a threshold score and row, and a buffer
// of TR candidates (scores, then rows). Warp w keeps the lists of queries
// w, w + NW, ... in registers and empties their buffers after every tile.
template <int QBW>
__global__ void __launch_bounds__(chunk_threads<QBW>())
topk_chunk_warp_kernel(const float* __restrict__ queries,
                       const float* __restrict__ gallery, int Q, int N,
                       int d, int kp, int chunk, float* __restrict__ part_s,
                       int* __restrict__ part_i) {
  constexpr int NT = chunk_threads<QBW>();
  constexpr int NW = NT / 32;
  constexpr int LQ = (QBW + NW - 1) / NW;      // lists a warp keeps
  extern __shared__ __align__(16) float smem[];
  const int ds = d + 4;
  float* tiles = smem;                           // [STAGES][TR][ds]
  float* qs = tiles + STAGES * TR * ds;          // [QBW][ds]
  int* cnt = reinterpret_cast<int*>(qs + QBW * ds);  // [QBW]
  float* thr_s = reinterpret_cast<float*>(cnt + QBW);
  int* thr_i = reinterpret_cast<int*>(thr_s + QBW);
  float* buf_s = reinterpret_cast<float*>(thr_i + QBW);  // [QBW][TR]
  int* buf_i = reinterpret_cast<int*>(buf_s + QBW * TR);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QBW;
  const int c = blockIdx.y;
  const int row_begin = c * chunk;
  const int row_end = min(row_begin + chunk, N);
  const int nq = min(QBW, Q - q0);
  for (int e = tid; e < QBW * ds; e += NT) {
    const int qq = e / ds, j = e - qq * ds;
    qs[e] = (qq < nq && j < d) ? queries[(long long)(q0 + qq) * d + j] : 0.f;
  }
  for (int qq = tid; qq < QBW; qq += NT) {
    cnt[qq] = 0;
    thr_s[qq] = -INFINITY;
    thr_i[qq] = EMPTY;
  }
  float ls[LQ];
  int li[LQ];
#pragma unroll
  for (int l = 0; l < LQ; ++l) { ls[l] = -INFINITY; li[l] = EMPTY; }

  tile_loop<QBW, Shape<QBW>, false>(gallery, tiles, qs, d, row_begin, row_end, nq, cnt,
                        thr_s, thr_i, buf_s, buf_i, TR, [&]() {
#pragma unroll
    for (int l = 0; l < LQ; ++l) {
      const int qq = warp + NW * l;
      if (qq >= nq) continue;
      const int n = cnt[qq];
      if (n == 0) continue;
      warp_take(buf_s + qq * TR, buf_i + qq * TR, n, kp, ls[l], li[l], lane);
      const float ts = __shfl_sync(FULL, ls[l], kp - 1);
      const int ti = __shfl_sync(FULL, li[l], kp - 1);
      if (lane == 0) {
        cnt[qq] = 0;
        thr_s[qq] = ts;
        thr_i[qq] = ti;
      }
    }
  });

#pragma unroll
  for (int l = 0; l < LQ; ++l) {
    const int qq = warp + NW * l;
    if (qq < nq && lane < kp) {
      const long long o = ((long long)(q0 + qq) * gridDim.y + c) * kp + lane;
      part_s[o] = ls[l];
      part_i[o] = li[l];
    }
  }
}

// Pass 1 for k > WARP_K. Shared memory: STAGES tiles [TR][d + 4] and the
// queries [QBW][d + 4] (as for k <= WARP_K, counts and thresholds unused),
// then with kSmem every score of the chunk [QBW][chunk]; without kSmem the
// scores are in lists_s [gridDim.y][gridDim.x][QBW][chunk]. Then each query
// selects the chunk's kp best (select_k) straight into the part list,
// unsorted (the merge sorts): the CTA's threads form up to 8 teams that
// select side by side, team t taking queries t, t + 8, ... (in a one-query
// block the whole CTA is one team).
template <int QBW, bool kSmem>
__global__ void __launch_bounds__(chunk_threads<QBW, ShapeK<QBW>>(), 1)
topk_chunk_kernel(const float* __restrict__ queries,
                  const float* __restrict__ gallery, int Q, int N, int d,
                  int kp, int chunk, float* __restrict__ part_s,
                  int* __restrict__ part_i, float* __restrict__ lists_s) {
  constexpr int NT = chunk_threads<QBW, ShapeK<QBW>>();
  constexpr int TEAMS = QBW < 8 ? QBW : 8;
  constexpr int TEAM = NT / TEAMS;
  extern __shared__ __align__(16) float smem[];
  __shared__ SelectScratch x[TEAMS];
  const int ds = d + 4;
  float* tiles = smem;                           // [STAGES][TR][ds]
  float* qs = tiles + STAGES * TR * ds;          // [QBW][ds]
  int* cnt = reinterpret_cast<int*>(qs + QBW * ds);  // [QBW] (unused)
  float* sc;                                     // [QBW][chunk]
  if constexpr (kSmem) {
    sc = reinterpret_cast<float*>(cnt + 3 * QBW);
  } else {
    const long long cta = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    sc = lists_s + cta * QBW * (long long)chunk;
  }

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QBW;
  const int c = blockIdx.y;
  const int row_begin = c * chunk;
  const int row_end = min(row_begin + chunk, N);
  const int rows = row_end - row_begin;
  const int nq = min(QBW, Q - q0);               // live queries
  for (int e = tid; e < QBW * ds; e += NT) {
    const int qq = e / ds, j = e - qq * ds;
    qs[e] = (qq < nq && j < d) ? queries[(long long)(q0 + qq) * d + j] : 0.f;
  }
  tile_loop<QBW, ShapeK<QBW>, true>(gallery, tiles, qs, d, row_begin,
                                    row_end, nq, cnt, nullptr, nullptr, sc,
                                    nullptr, chunk, [] {});

  const int kr = min(kp, rows);  // a short last chunk: every row
  const int team = tid / TEAM;
  for (int qq = team; qq < nq; qq += TEAMS) {
    const long long o = ((long long)(q0 + qq) * gridDim.y + c) * kp;
    for (int j = kr + team_rank<TEAM>(); j < kp; j += TEAM) {
      part_s[o + j] = -INFINITY;
      part_i[o + j] = EMPTY;
    }
    const float* row_s = sc + (long long)qq * chunk;
    select_k<TEAM>(
        [&](int e, unsigned& key) {
          key = key_of(row_s[e]);
          return true;
        },
        [&](int e, float& s, int& i) {
          s = row_s[e];
          i = row_begin + e;
        },
        rows, kr, part_s + o, part_i + o, x[team]);
  }
}

// Pass 2 for k > WARP_K: one CTA per query selects the k best of its
// n_chunks lists (select_k; empty slots skipped), sorts them (block_sort)
// and writes them. Shared memory: with kSmem a sort area of P = pow2(k)
// slots, otherwise the area is lists_s / lists_i [Q][P]; with kKeys (and
// kSmem) then the keys of all n_chunks * kp entries (0 for an empty slot,
// which no score's key equals), read from global memory once, so that the
// radix passes read shared memory and only the chosen entries are read
// again.
template <bool kSmem, bool kKeys>
__global__ void __launch_bounds__(MERGE_THREADS_K, 1)
topk_merge_kernel(const float* __restrict__ part_s,
                  const int* __restrict__ part_i, int k, int kp, int n_chunks,
                  int P, float* __restrict__ out_s,
                  int64_t* __restrict__ out_i, float* __restrict__ lists_s,
                  int* __restrict__ lists_i) {
  extern __shared__ __align__(16) float msmem[];
  __shared__ SelectScratch x;
  const int q = blockIdx.x, tid = threadIdx.x;
  float* area_s;
  int* area_i;
  if constexpr (kSmem) {
    area_s = msmem;
    area_i = reinterpret_cast<int*>(msmem + P);
  } else {
    area_s = lists_s + (long long)q * P;
    area_i = lists_i + (long long)q * P;
  }
  for (int j = k + tid; j < P; j += MERGE_THREADS_K) {
    area_s[j] = -INFINITY;
    area_i[j] = EMPTY;
  }
  const int total = n_chunks * kp;
  const float* ps = part_s + (long long)q * total;
  const int* pi = part_i + (long long)q * total;
  auto item = [&](int e, float& s, int& i) {
    s = ps[e];
    i = pi[e];
  };
  if constexpr (kKeys) {
    unsigned* keys = reinterpret_cast<unsigned*>(msmem + 2 * P);
    for (int base = tid; base < total; base += MERGE_THREADS_K * UNROLL) {
      float sv[UNROLL];
      int iv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = base + u * MERGE_THREADS_K;
        iv[u] = e < total ? pi[e] : EMPTY;
        sv[u] = e < total ? ps[e] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = base + u * MERGE_THREADS_K;
        if (e < total) keys[e] = iv[u] == EMPTY ? 0u : key_of(sv[u]);
      }
    }
    __syncthreads();
    select_k<MERGE_THREADS_K>(
        [&](int e, unsigned& key) {
          key = keys[e];
          return key != 0u;
        },
        item, total, k, area_s, area_i, x);
  } else {
    select_k<MERGE_THREADS_K>(
        [&](int e, unsigned& key) {
          if (pi[e] == EMPTY) return false;
          key = key_of(ps[e]);
          return true;
        },
        item, total, k, area_s, area_i, x);
  }
  __syncthreads();
  block_sort<MERGE_THREADS_K>(area_s, area_i, P);
  for (int j = tid; j < k; j += MERGE_THREADS_K) {
    out_s[(long long)q * k + j] = area_s[j];
    out_i[(long long)q * k + j] = (int64_t)area_i[j];
  }
}

// Pass 2 for k <= WARP_K: one CTA of MERGE_THREADS per query; warp w offers
// every (MERGE_THREADS / 32)th group of 32 chunk-list entries to a list in
// its registers, then warp 0 merges the warps' lists.
__global__ void __launch_bounds__(MERGE_THREADS)
topk_merge_warp_kernel(const float* __restrict__ part_s,
                       const int* __restrict__ part_i, int k, int kp,
                       int n_chunks, float* __restrict__ out_s,
                       int64_t* __restrict__ out_i) {
  constexpr int NW = MERGE_THREADS / 32;
  __shared__ float ws[NW][32];
  __shared__ int wi[NW][32];
  const int q = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int total = n_chunks * kp;
  const float* ps = part_s + (long long)q * total;
  const int* pi = part_i + (long long)q * total;
  float s = -INFINITY;
  int i = EMPTY;
  for (int b = warp * 32; b < total; b += NW * 32)
    warp_take(ps + b, pi + b, min(32, total - b), k, s, i, lane);
  ws[warp][lane] = s;
  wi[warp][lane] = i;
  __syncthreads();
  if (warp != 0) return;
  for (int v = 1; v < NW; ++v) warp_merge32(s, i, ws[v][lane], wi[v][lane], lane);
  if (lane < k) {
    out_s[(long long)q * k + lane] = s;
    out_i[(long long)q * k + lane] = (int64_t)i;
  }
}

// Allow `kernel` `smem` dynamic shared bytes on the current device; only a
// larger size than before calls the runtime again.
template <auto kernel>
void allow_smem(int smem) {
  constexpr int MAX_DEVICES = 64;
  static int allowed[MAX_DEVICES];  // 0: never set
  int dev = 0;
  cudaGetDevice(&dev);
  const bool known = dev >= 0 && dev < MAX_DEVICES;
  if (!known || smem > allowed[dev]) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    if (known) allowed[dev] = smem;
  }
}

template <bool kSmem, bool kKeys>
int launch_merge(const float* part_s, const int* part_i, int k, int kp,
                 int n_chunks, int Q, int P, int smem, float* out_s,
                 int64_t* out_i, float* lists_s, int* lists_i,
                 cudaStream_t st) {
  allow_smem<topk_merge_kernel<kSmem, kKeys>>(smem);
  topk_merge_kernel<kSmem, kKeys><<<Q, MERGE_THREADS_K, smem, st>>>(
      part_s, part_i, k, kp, n_chunks, P, out_s, out_i, lists_s, lists_i);
  return (int)cudaGetLastError();
}

template <int QBW>
int launch_chunk(const float* queries, const float* gallery, int Q, int N,
                 int d, int k, int kp, int chunk, int n_chunks, int smem,
                 float* part_s, int* part_i, float* scores,
                 cudaStream_t st) {
  dim3 grid((Q + QBW - 1) / QBW, n_chunks);
  constexpr int NT = chunk_threads<QBW>();
  constexpr int NTK = chunk_threads<QBW, ShapeK<QBW>>();
  if (k <= WARP_K) {
    allow_smem<topk_chunk_warp_kernel<QBW>>(smem);
    topk_chunk_warp_kernel<QBW><<<grid, NT, smem, st>>>(
        queries, gallery, Q, N, d, kp, chunk, part_s, part_i);
  } else if (scores) {
    allow_smem<topk_chunk_kernel<QBW, false>>(smem);
    topk_chunk_kernel<QBW, false><<<grid, NTK, smem, st>>>(
        queries, gallery, Q, N, d, kp, chunk, part_s, part_i, scores);
  } else {
    allow_smem<topk_chunk_kernel<QBW, true>>(smem);
    topk_chunk_kernel<QBW, true><<<grid, NTK, smem, st>>>(
        queries, gallery, Q, N, d, kp, chunk, part_s, part_i, scores);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// queries [Q, d] f32, gallery [N, d] f32 (contiguous, on the device, d a
// multiple of 4); the plan (ops/topk_gallery.py::plan): qbw, chunk rows,
// n_chunks, kp = min(k, chunk), pass-1 shared bytes smem1, the pass-2
// sort area's slots s2, whether pass 2 stages the part lists' keys in
// shared memory (keys2) and its shared bytes smem2. part_s / part_i:
// [Q, n_chunks, kp]; scores1: null, or the pass-1 scores
// [n_chunks, ceil(Q / qbw), qbw, chunk] when they do not fit shared
// memory; lists2_s / lists2_i: null, or the pass-2 sort areas [Q, s2].
// out_s [Q, k] f32, out_i [Q, k] int64; 1 <= k <= N.
// Returns the first CUDA error of the two launches, or 0.
int topk_gallery_f32(const void* queries, const void* gallery, int Q, int N,
                     int d, int k, int qbw, int chunk, int n_chunks, int kp,
                     int smem1, int s2, int keys2, int smem2,
                     void* part_s, void* part_i, void* scores1,
                     void* lists2_s, void* lists2_i, void* out_s,
                     void* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(queries);
  const float* gp = static_cast<const float*>(gallery);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  float* sc = static_cast<float*>(scores1);
  int err;
  switch (qbw) {
    case 1:
      err = launch_chunk<1>(qp, gp, Q, N, d, k, kp, chunk, n_chunks, smem1,
                            ps, pi, sc, st);
      break;
    case 8:
      err = launch_chunk<8>(qp, gp, Q, N, d, k, kp, chunk, n_chunks, smem1,
                            ps, pi, sc, st);
      break;
    case 32:
      err = launch_chunk<32>(qp, gp, Q, N, d, k, kp, chunk, n_chunks, smem1,
                             ps, pi, sc, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  if (k <= WARP_K) {
    topk_merge_warp_kernel<<<Q, MERGE_THREADS, 0, st>>>(
        ps, pi, k, kp, n_chunks, static_cast<float*>(out_s),
        static_cast<int64_t*>(out_i));
    return (int)cudaGetLastError();
  }
  float* os = static_cast<float*>(out_s);
  int64_t* oi = static_cast<int64_t*>(out_i);
  float* ls = static_cast<float*>(lists2_s);
  int* li = static_cast<int*>(lists2_i);
  if (ls)
    return launch_merge<false, false>(ps, pi, k, kp, n_chunks, Q, s2, smem2,
                                      os, oi, ls, li, st);
  if (keys2)
    return launch_merge<true, true>(ps, pi, k, kp, n_chunks, Q, s2, smem2,
                                    os, oi, ls, li, st);
  return launch_merge<true, false>(ps, pi, k, kp, n_chunks, Q, s2, smem2,
                                   os, oi, ls, li, st);
}

}  // extern "C"
