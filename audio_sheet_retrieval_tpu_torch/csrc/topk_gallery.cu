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
// rows fail it; at large k it is the selection that costs. The chunked
// pass 1 reaches 10-20 % of the FMA rate: its 4 x 4 tiles of lane-distinct
// rows spend 20 shared-memory wavefronts on 64 FMAs. At a catalogue's size
// (N = 4,194,304, Q = 100, k = 25) the streaming pass 1 below reaches 29 %
// (1.39 ms against 1.97; PERF.md): its scoring alone (the selection cut out)
// reaches 42 % at Q = 100 and 53 % at Q = 128, and the selection (about
// 1,700 survivors a warp, each an atomic, a queue slot and a share of a
// warp_take drain) and the warps' wait for each other at the shared ring
// take a third of its time. At k of 1,024 and more, where one CTA fills a
// SM, the selection costs about as much as the scoring.
//
// Design (the launch plan, sizes included, is computed in Python by
// ops/topk_gallery.py::plan and passed in):
//   pass 1 at a catalogue's size (k <= 32, 48 <= Q <= 128, d <= 32, N >=
//     1,000,000): topk_chunk_stream_kernel, one CTA a SM reading its chunk
//     once for every query (the section of that name below).
//   pass 1 otherwise: a CTA takes QBW queries (1, 8 or 32, the narrowest that holds
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
// deeper unrolling of the selection's or the scoring's loops. For the
// streaming pass 1 (a dozen variants, each bit-identical): queries held in
// registers (register-bound, slower), 8 x 8 tiles of 16 queries a warp
// (faster scoring, costlier selection), a producer warp, selection by
// per-query heaps, by lanes' private lists, by shuffle-scan rounds alone,
// and deeper rings or faster threshold refreshes (no gain).
// Tensor cores are not used: single-pass TF32 changes the scores by more
// than the 1e-4 the port's checks allow, and a 3xTF32 mma.sync path is left
// for a later change (ROADMAP Queue 2).
//
// Semantics (those of the JAX kernel and of the plain PyTorch version):
// descending scores; among equal scores the lower gallery index first;
// a NaN score counts as -inf; rows past N are never returned. An empty
// slot is (-inf, INT_MAX), which sorts after every real entry.

#include <cuda.h>
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

// Offer one candidate a lane (cs, ci) to the warp's list; only those that
// beat the list's kth entry count. A few are inserted one by one, more are
// sorted and merged as a batch.
__device__ __forceinline__ void warp_offer(float cs, int ci, int kth,
                                           float& s, int& i, int lane) {
  const float ts = __shfl_sync(FULL, s, kth - 1);
  const int ti = __shfl_sync(FULL, i, kth - 1);
  const bool want = better(cs, ci, ts, ti);
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

// Offer n candidates (src_s, src_i)[0, n) to the warp's list, 32 at a
// time (warp_offer).
__device__ __forceinline__ void warp_take(const float* src_s,
                                          const int* src_i, int n, int kth,
                                          float& s, int& i, int lane) {
  for (int b = 0; b < n; b += 32) {
    const int j = b + lane;
    warp_offer(j < n ? src_s[j] : -INFINITY, j < n ? src_i[j] : EMPTY, kth,
               s, i, lane);
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

// --- pass 1 for k <= WARP_K at a catalogue's size: the streaming kernel -----
// One CTA a SM walks a chunk of the gallery once for every query (Q <= 128,
// d <= 32), so the gallery leaves device memory once a search. The ring
// holds `stages` stages of SR = 128 rows x 32 floats, each one TMA box
// (cp.async.bulk.tensor, 128-byte swizzled; columns past d and rows past N
// read as zeros) completing on the stage's `full` mbarrier; the last warp
// to finish scoring a stage (a shared counter) asks for the stage's next
// tile, so no warp only copies. Warp w owns the SQ = 8 queries 8 (w / rs_n)
// ... + 7 and every rs_n-th tile. Lane 16 kappa + rho scores rows rho + 16 i
// (i < 8) of a tile against queries kappa + 2 j (j < 4) of its warp: per
// 16-byte column c, 8 row loads and 4 query loads feed 128 FMAs (10.7 a
// load); the swizzle puts the 8 rows a quarter-warp reads (rho & 7 = 0 ...
// 7) in 8 bank groups. The rows of a tile's first column are loaded before
// the previous tile's survivors are handled. Each score is the fmaf chain
// over columns 0 ... d - 1, as in tile_loop, so scores and answers are
// those of the chunked pass 1 bit for bit.
// Selection: each query's list of its 32 best (a warp's registers while it
// is changed, shared memory between) and its threshold, the list's kp-th
// entry, in shared memory and in the registers of the lanes that score the
// query. Before the first tile's survivors count, the threshold rises to a
// bound from the tile itself (first_thresholds). A tile whose scores all
// fall below their thresholds (a NaN-propagating max a query) costs a vote.
// Otherwise the warp counts the scores at or above their thresholds: when
// the queues can take them, each survivor goes to its query's queue by a
// shared atomic; when they are many (the first tiles), in 8 rounds (query
// j; rows 0-3 or 4-7), each a warp-aggregated append by ballots. Before a
// queue could overflow, and when the rows end, the warp drains every queue
// into its list (stream_drain, warp_take) and reloads the thresholds. A
// drain also offers each full list's kp-th entry to the query's key in
// gthr, the best such entry of any CTA: every CTA's kp best are at least as
// good, so a row worse than it is in no list's k best; every REFRESH tiles
// a warp takes gthr's keys where they beat its own. No block barrier runs
// between the set-up and the end; at the end the rs_n warps of a query
// block merge their lists into its part list.
constexpr int QT = 4;              // queries a lane scores
constexpr int SQ = 2 * QT;         // queries a warp owns
constexpr int SR = 128;            // gallery rows of a tile (a ring stage)
constexpr int BOX = 32;            // floats of a box row: the swizzle's span
constexpr int QCAP = 96;           // a query's queue
constexpr int ROUND_MAX = 64;      // entries a round adds to a queue:
                                   // 16 lanes x 4 rows
constexpr int REFRESH = 8;         // tiles between reads of gthr
constexpr int STREAM_WARPS = 16;   // warps a CTA at most
constexpr int STREAM_MAX_Q = 128;
constexpr int STAGEF = SR * BOX;   // floats of a stage
// a warp's lists [SQ][32] and queues [SQ][QCAP] (scores, then rows),
// thresholds [2][QT] (query kappa + 2 j at QT kappa + j; scores, then
// rows) and queue counts [SQ], in 32-bit words
constexpr int WARPF = 2 * SQ * (32 + QCAP) + 3 * SQ;
constexpr uint64_t DEADLINE_NS = 4000000000ull;  // a wait this long: trap

// Dynamic shared bytes (ops/topk_gallery.py::stream_smem_bytes): 1,024 to
// align the ring, the ring, an mbarrier and a counter a stage, the queries
// [SQ nqw][32], and each warp's WARPF words.
__host__ __device__ constexpr int stream_smem_bytes(int Q, int rs_n,
                                                    int stages) {
  const int nqw = (Q + SQ - 1) / SQ;
  return 1024 + stages * (STAGEF * 4 + 16) + nqw * SQ * BOX * 4 +
         nqw * rs_n * WARPF * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t a, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(a), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ uint64_t wall_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// wait until the phase of parity `parity` of *bar has completed; a wait of
// DEADLINE_NS traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try(a, parity)) return;
  const uint64_t t0 = wall_ns();
  uint32_t tries = 0;
  while (!mbar_try(a, parity)) {
    if ((++tries & 63u) == 0 && wall_ns() - t0 > DEADLINE_NS) __trap();
  }
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
// A list entry as one 64-bit key: the better entry has the larger key, and
// 0 lies below every entry
__device__ __forceinline__ unsigned long long entry_key(float s, int i) {
  return (unsigned long long)key_of(s) << 32 | (unsigned)(EMPTY - i);
}
__device__ __forceinline__ void key_entry(unsigned long long key, float& s,
                                          int& i) {
  const unsigned k = (unsigned)(key >> 32);
  s = __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
  i = EMPTY - (int)(unsigned)key;
}

// tile y0 / SR of the tensor map into a stage, completing on *bar
__device__ __forceinline__ void stage_load(float* dst, const CUtensorMap* map,
                                           int y0, uint64_t* bar) {
  mbar_arrive_tx(bar, STAGEF * 4);
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(y0),
      "r"(smem_u32(bar))
      : "memory");
}

// Drain a warp's queues into its lists: query l's qcnt[l] entries (Bs /
// Bi + l QCAP) through warp_take into its list (Ls / Li + 32 l). Each full
// list's kp-th entry goes to the query's key in gthr (nq: the warp's real
// queries) and, where better, becomes its threshold (thr_s / thr_i [QT (l
// & 1) + (l >> 1)]). Out of line: one copy for every call.
__device__ __noinline__ void stream_drain(float* Ls, int* Li,
                                          const float* Bs, const int* Bi,
                                          float* thr_s, int* thr_i,
                                          int* qcnt,
                                          unsigned long long* gthr, int nq,
                                          int kp, int lane) {
  __syncwarp();  // the queues and counts written
  for (int l = 0; l < nq; ++l) {
    const int n = qcnt[l];
    if (n == 0) continue;
    float s = Ls[l * 32 + lane];
    int i = Li[l * 32 + lane];
    warp_take(Bs + l * QCAP, Bi + l * QCAP, n, kp, s, i, lane);
    Ls[l * 32 + lane] = s;
    Li[l * 32 + lane] = i;
    if (lane == kp - 1) {
      const int t = QT * (l & 1) + (l >> 1);
      const unsigned long long key = entry_key(s, i);
      if (key > entry_key(thr_s[t], thr_i[t])) {
        thr_s[t] = s;
        thr_i[t] = i;
      }
      if (i != EMPTY) atomicMax(gthr + l, key);
    }
  }
  __syncwarp();  // the counts read
  if (lane < SQ) qcnt[lane] = 0;
  __syncwarp();
}

// a[i][j] for i < 8, j < QT known only at run time: a tree of selects, so
// that the registers are never indexed
__device__ __forceinline__ float pick(const float (&a)[8][QT], int i, int j) {
  float w[QT];
#pragma unroll
  for (int jj = 0; jj < QT; ++jj) {
    const float t0 = i & 1 ? a[1][jj] : a[0][jj];
    const float t1 = i & 1 ? a[3][jj] : a[2][jj];
    const float t2 = i & 1 ? a[5][jj] : a[4][jj];
    const float t3 = i & 1 ? a[7][jj] : a[6][jj];
    const float u0 = i & 2 ? t1 : t0, u1 = i & 2 ? t3 : t2;
    w[jj] = i & 4 ? u1 : u0;
  }
#pragma unroll
  for (int span = 1; span < QT; span <<= 1)
#pragma unroll
    for (int jj = 0; jj + span < QT; jj += 2 * span)
      w[jj] = j & span ? w[jj + span] : w[jj];
  return w[0];
}

// kFull: d == 32 (else d < 32 and columns past d are skipped)
template <bool kFull>
__global__ void __launch_bounds__(32 * STREAM_WARPS, 1)
topk_chunk_stream_kernel(const __grid_constant__ CUtensorMap tmap,
                         const float* __restrict__ queries, int Q, int N,
                         int d, int kp, int chunk, int rs_n, int stages,
                         float* __restrict__ part_s,
                         int* __restrict__ part_i,
                         unsigned long long* __restrict__ gthr) {
  extern __shared__ __align__(16) unsigned char sraw[];
  float* ring = reinterpret_cast<float*>(
      sraw + ((1024u - (smem_u32(sraw) & 1023u)) & 1023u));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * STAGEF);
  int* done = reinterpret_cast<int*>(full + stages);  // warps done a stage
  float* qs = reinterpret_cast<float*>(done + 2 * stages);  // [nqw SQ][BOX]
  const int nqw = (Q + SQ - 1) / SQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row_begin = blockIdx.x * chunk;
  const int row_end = min(row_begin + chunk, N);
  const int n_tiles = (row_end - row_begin + SR - 1) / SR;

  for (int e = threadIdx.x; e < nqw * SQ * BOX; e += blockDim.x) {
    const int qq = e / BOX, j = e - qq * BOX;
    qs[e] = (qq < Q && j < d) ? queries[(long long)qq * d + j] : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < stages && t < n_tiles; ++t)
      stage_load(ring + t * STAGEF, &tmap, row_begin + t * SR, &full[t]);
  }
  __syncthreads();  // the only CTA-wide barrier

  const int qw = warp / rs_n, rs = warp - qw * rs_n;
  const int rho = lane & 15, kap = lane >> 4;
  const int nq = min(SQ, Q - qw * SQ);  // the warp's real queries
  unsigned long long* gq = gthr + qw * SQ;
  float* Ls = qs + nqw * SQ * BOX + warp * WARPF;         // [SQ][32]
  int* Li = reinterpret_cast<int*>(Ls + SQ * 32);
  float* Bs = Ls + 2 * SQ * 32;                           // [SQ][QCAP]
  int* Bi = reinterpret_cast<int*>(Bs + SQ * QCAP);
  float* thr_s = Ls + 2 * SQ * (32 + QCAP);               // [2][QT]
  int* thr_i = reinterpret_cast<int*>(thr_s + SQ);
  int* qcnt = thr_i + SQ;                                 // [SQ]
  for (int e = lane; e < SQ * 32; e += 32) {
    Ls[e] = -INFINITY;
    Li[e] = EMPTY;
  }
  if (lane < SQ) {  // a padding query's threshold is +inf: no score beats it
    const int l = QT * (lane & 1) + (lane >> 1);
    thr_s[l] = lane < nq ? -INFINITY : INFINITY;
    thr_i[l] = EMPTY;
    qcnt[lane] = 0;
  }
  __syncwarp();
  float ts[QT];
  int ti[QT];
  auto load_thresholds = [&]() {
#pragma unroll
    for (int j = 0; j < QT; j += 4) {
      const float4 a = *reinterpret_cast<const float4*>(thr_s + QT * kap + j);
      const int4 b = *reinterpret_cast<const int4*>(thr_i + QT * kap + j);
      ts[j] = a.x; ts[j + 1] = a.y; ts[j + 2] = a.z; ts[j + 3] = a.w;
      ti[j] = b.x; ti[j + 1] = b.y; ti[j + 2] = b.z; ti[j + 3] = b.w;
    }
  };
  load_thresholds();
  int fill = 0;  // the fullest queue's entries
  auto drain = [&]() {
    stream_drain(Ls, Li, Bs, Bi, thr_s, thr_i, qcnt, gq, nq, kp, lane);
    fill = 0;
    load_thresholds();
  };
  const float* qrow = qs + (qw * SQ + kap) * BOX;  // + 2 j BOX: query kap + 2 j
  const int nc = d >> 2;
  // Before the first tile's survivors are queued, each query's threshold
  // rises to the 13th best of its 16 lanes' second-best scores: at least 13
  // x 2 >= kp rows score as high, so every row below it falls out of the
  // kp best (NaN as -inf; rows past the chunk count as -inf).
  auto first_thresholds = [&](const float (&a)[8][QT]) {
    float m2[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      float m1 = -INFINITY;
      m2[j] = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v = isnan(a[i][j]) || row_begin + rs * SR + rho + 16 * i >=
                                              row_end
                            ? -INFINITY
                            : a[i][j];
        m2[j] = fmaxf(m2[j], fminf(m1, v));
        m1 = fmaxf(m1, v);
      }
    }
    // sort each query's 16 values descending across its 16 lanes (bitonic)
#pragma unroll
    for (int size = 2; size <= 16; size <<= 1)
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const bool up = ((rho & size) == 0) == ((rho & stride) == 0);
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          const float o = __shfl_xor_sync(FULL, m2[j], stride);
          m2[j] = up ? fmaxf(m2[j], o) : fminf(m2[j], o);
        }
      }
#pragma unroll
    for (int j = 0; j < QT; ++j) m2[j] = __shfl_sync(FULL, m2[j], 12, 16);
    if (kp <= 26 && rho == 0) {
#pragma unroll
      for (int j = 0; j < QT; ++j)
        if (thr_s[QT * kap + j] < m2[j]) {  // a padding query keeps +inf
          thr_s[QT * kap + j] = m2[j];
          thr_i[QT * kap + j] = EMPTY;
        }
    }
    __syncwarp();
    load_thresholds();
  };

  // the rows of a tile's column 0, loaded before the previous tile's
  // survivors are handled
  float4 g0[8];
  auto first_column = [&](int t) {
    mbar_wait(&full[t % stages], (t / stages) & 1);
    const float* grow = ring + (t % stages) * STAGEF + rho * BOX;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      g0[i] = *reinterpret_cast<const float4*>(grow + 16 * i * BOX +
                                               ((rho & 7) << 2));
  };
  if (rs < n_tiles) first_column(rs);
  for (int t = rs, it = 1; t < n_tiles; t += rs_n, ++it) {
    const int s = t % stages;
    const float* grow = ring + s * STAGEF + rho * BOX;  // + 16 i BOX
    const int row0 = row_begin + t * SR + rho;          // + 16 i
    float acc[8][QT];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < QT; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (kFull || c < nc) {
        const int sw = (c ^ (rho & 7)) << 2;
        float4 g[8], q[QT];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          g[i] = c == 0 ? g0[i]
                        : *reinterpret_cast<const float4*>(grow +
                                                           16 * i * BOX + sw);
#pragma unroll
        for (int j = 0; j < QT; ++j)
          q[j] = *reinterpret_cast<const float4*>(qrow + 2 * j * BOX + 4 * c);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < QT; ++j) {
            acc[i][j] = fmaf(g[i].x, q[j].x, acc[i][j]);
            acc[i][j] = fmaf(g[i].y, q[j].y, acc[i][j]);
            acc[i][j] = fmaf(g[i].z, q[j].z, acc[i][j]);
            acc[i][j] = fmaf(g[i].w, q[j].w, acc[i][j]);
          }
      }
    }
    // the tile is in registers: the stage's last warp asks for its next
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&done[s], 1) == nqw - 1) {
        done[s] = 0;
        if (t + stages < n_tiles) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          stage_load(ring + s * STAGEF, &tmap, row_begin + (t + stages) * SR,
                     &full[s]);
        }
      }
    }
    if (t + rs_n < n_tiles) first_column(t + rs_n);
    if (it % REFRESH == 0) {  // gthr's keys, where better than the warp's
      if (lane < nq) {
        const int l = QT * (lane & 1) + (lane >> 1);
        const unsigned long long g =
            *(volatile unsigned long long*)(gq + lane);
        if (g > entry_key(thr_s[l], thr_i[l]))
          key_entry(g, thr_s[l], thr_i[l]);
      }
      __syncwarp();
      load_thresholds();
    }
    if (it == 1) first_thresholds(acc);
    // a score at or above its query's threshold, or NaN (a NaN-propagating
    // max a query)
    bool any = false;
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      float mx = acc[0][j];
#pragma unroll
      for (int i = 1; i < 8; ++i) mx = max_nan(mx, acc[i][j]);
      any |= !(mx < ts[j]);
    }
    if (!__any_sync(FULL, any)) continue;
    // bit 8 i + j: score (i, j) at or above its query's threshold, or NaN
    unsigned long long hit = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < QT; ++j)
        hit |= (unsigned long long)!(acc[i][j] < ts[j]) << (8 * i + j);
    const int n = __reduce_add_sync(FULL, __popcll(hit));  // >= survivors
    if (n == 0) continue;
    if (fill + n > QCAP && fill > 0) drain();
    if (n <= QCAP) {  // few: each survivor by a shared atomic
      for (unsigned long long m = hit; m; m &= m - 1) {
        const int b = __ffsll(m) - 1, i = b >> 3, j = b & 7;
        float v = pick(acc, i, j);
        v = isnan(v) ? -INFINITY : v;
        const int row = row0 + 16 * i;
        if (row < row_end && better(v, row, thr_s[QT * kap + j],
                                    thr_i[QT * kap + j])) {
          const int qq = kap + 2 * j;
          const int o = qq * QCAP + atomicAdd(&qcnt[qq], 1);
          Bs[o] = v;
          Bi[o] = row;
        }
      }
      __syncwarp();
      fill = __reduce_max_sync(FULL, lane < SQ ? qcnt[lane] : 0);
      continue;
    }
    // many: rounds of (query j, rows 4 h ... 4 h + 3), a ballot a row
    const unsigned half = kap ? 0xffff0000u : 0x0000ffffu;  // a query's lanes
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < QT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bool keep[4];
        float v[4];
        unsigned b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * h + r;
          v[r] = isnan(acc[i][j]) ? -INFINITY : acc[i][j];
          keep[r] = (hit >> (8 * i + j) & 1ull) && row0 + 16 * i < row_end &&
                    better(v[r], row0 + 16 * i, ts[j], ti[j]);
          b[r] = __ballot_sync(FULL, keep[r]);
        }
        const int total = __popc(b[0]) + __popc(b[1]) + __popc(b[2]) +
                          __popc(b[3]);
        if (total == 0) continue;
        if (fill > QCAP - ROUND_MAX) drain();
        const int qq = kap + 2 * j;
        int pos = qcnt[qq];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (keep[r]) {
            const int o = qq * QCAP + pos + __popc(b[r] & half & below);
            Bs[o] = v[r];
            Bi[o] = row0 + 16 * (4 * h + r);
          }
          pos += __popc(b[r] & half);
        }
        __syncwarp();  // every lane read its base
        if (rho == 0) qcnt[qq] = pos;
        __syncwarp();
        fill = max(fill, __reduce_max_sync(FULL, pos));
      }
  }
  if (__any_sync(FULL, fill > 0)) drain();

  if (rs_n > 1)  // the lists of the query block complete (named barrier 1)
    asm volatile("bar.sync 1, %0;\n" ::"r"((int)blockDim.x) : "memory");
  if (rs != 0) return;
  for (int l = 0; l < nq; ++l) {
    float s = Ls[l * 32 + lane];
    int i = Li[l * 32 + lane];
    for (int r = 1; r < rs_n; ++r) {
      const float* os = Ls + r * WARPF;
      const int* oi = Li + r * WARPF;
      warp_merge32(s, i, os[l * 32 + lane], oi[l * 32 + lane], lane);
    }
    if (lane < kp) {
      const long long o =
          ((long long)(qw * SQ + l) * gridDim.x + blockIdx.x) * kp + lane;
      part_s[o] = s;
      part_i[o] = i;
    }
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

// cuTensorMapEncodeTiled, found through the runtime's entry-point query
// (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <bool kFull>
int launch_stream(const float* queries, const float* gallery, int Q, int N,
                  int d, int kp, int chunk, int n_chunks, int rs_n,
                  int stages, int smem, float* part_s, int* part_i,
                  unsigned long long* gthr, cudaStream_t st) {
  // the gallery as a [N, d] tensor in boxes of SR rows x 32 floats (columns
  // past d and rows past N read as zeros), 128-byte swizzled
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tmap;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
  const cuuint32_t box[2] = {(cuuint32_t)BOX, (cuuint32_t)SR};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(gallery), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  allow_smem<topk_chunk_stream_kernel<kFull>>(smem);
  const int threads = 32 * ((Q + SQ - 1) / SQ * rs_n);
  topk_chunk_stream_kernel<kFull><<<n_chunks, threads, smem, st>>>(
      tmap, queries, Q, N, d, kp, chunk, rs_n, stages, part_s, part_i, gthr);
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

// The same search through the streaming pass 1 (topk_chunk_stream_kernel)
// and the k <= 32 merge: queries [Q, d], gallery [N, d] f32 (contiguous,
// the gallery 16-byte aligned, d a multiple of 4 up to 32), Q <= 128,
// 1 <= k <= 32; the plan (ops/topk_gallery.py::stream_plan): chunk rows (a
// multiple of 128), n_chunks CTAs, kp = min(k, chunk), rs_n warps a query
// block, stages, and smem, which must equal stream_smem_bytes. part_s /
// part_i: [Q, n_chunks, kp]; gthr: [Q] 64-bit keys, zero. Returns the
// first CUDA error of the two launches, cudaErrorInvalidValue for
// arguments outside these, or 0.
int topk_gallery_stream_f32(const void* queries, const void* gallery, int Q,
                            int N, int d, int k, int chunk, int n_chunks,
                            int kp, int rs_n, int stages, int smem,
                            void* part_s, void* part_i, void* gthr,
                            void* out_s, void* out_i, void* stream) {
  if (Q < 1 || Q > STREAM_MAX_Q || k < 1 || k > WARP_K || d < 4 || d % 4 ||
      d > BOX || chunk < SR || chunk % SR || kp != (k < chunk ? k : chunk) ||
      n_chunks != (N + chunk - 1) / chunk || rs_n < 1 ||
      (Q + SQ - 1) / SQ * rs_n > STREAM_WARPS || stages < 2 ||
      stages % rs_n ||
      smem != stream_smem_bytes(Q, rs_n, stages) ||
      ((uintptr_t)gallery & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(queries);
  const float* gp = static_cast<const float*>(gallery);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  unsigned long long* g = static_cast<unsigned long long*>(gthr);
  const int err =
      d == BOX ? launch_stream<true>(qp, gp, Q, N, d, kp, chunk, n_chunks,
                                     rs_n, stages, smem, ps, pi, g, st)
               : launch_stream<false>(qp, gp, Q, N, d, kp, chunk, n_chunks,
                                      rs_n, stages, smem, ps, pi, g, st);
  if (err != 0) return err;
  topk_merge_warp_kernel<<<Q, MERGE_THREADS, 0, st>>>(
      ps, pi, k, kp, n_chunks, static_cast<float*>(out_s),
      static_cast<int64_t*>(out_i));
  return (int)cudaGetLastError();
}

}  // extern "C"
