// Interleaved-stream rANS on the card: the decode of P payloads and the
// encode of one payload against a static table.
//
// Replaces two lax.scan loops of the JAX package (not Pallas kernels):
//   audio_sheet_retrieval_tpu/ops/rans.py, _decode_batch_jit (a scan of
//   K = ceil(n/S) steps over [P, S] lanes, :411) and _encode_device_jit (a
//   reversed scan of K steps over [S] lanes, then a sort of the candidate
//   words by emission rank, :549). A PyTorch transcription would be a
//   dozen launches a step, about 10^4 a page.
//
// The wire (ops/rans.py): S lanes share one stream of 16-bit words; a step
// decodes one symbol a lane and a lane consumes at most one word a step,
// in (step-ascending, lane-ascending) order, so a lane's word index is the
// row's base plus the exclusive prefix of the consume flags over the
// lanes. Frequencies have 12 bits of precision (they sum to 4,096), the
// state's lower bound is 2^16.
//
// What bounds it on the H100. Bytes: the words read once, the symbols
// written once (decode) or the data read once and the words written once
// (encode): a few hundred kB to a few MB, under a microsecond at 3.35
// TB/s. Latency: one payload is one serial chain of K dependent steps (a
// word's index depends on every lane's consume flag of its step), so a
// payload runs on one SM and its time is K times a step. A step's floor
// is one CTA-wide barrier round (27-57 ns by the CTA's width). Before
// this design a step also waited on two barriers and on a dependent word
// load from device memory, with G lanes in series; with it (PERF.md §6,
// an H100) a step takes 0.25-0.29 us at one lane a thread and 0.66 us at
// four lanes and 512 threads: the latency of its chain (table load, vote,
// barrier, the warps' sums, word load) and, at 512 threads, the issue of
// about 200 instructions a warp. The encode is no such chain: its lanes
// are independent, so it is the step loop of one lane (a 32-bit division
// a step) plus a scan and a scatter of the words.
//
// Design of the decode (one CTA a payload; thread t owns the CONTIGUOUS
// lanes [t G, t G + G), G and the CTA's width from
// ops/rans.py::decode_plan; states in registers for all K steps):
//   * One barrier a step (cta_scan). A thread's consume count (0..G) is
//     scanned inside its warp by one ballot per bit of the count; lane 0
//     posts the warp's total to sums[step parity][warp]; after the one
//     __syncthreads lane i of every warp reads warp i's total and two warp
//     reductions (__reduce_add_sync) give the earlier warps' sum and the
//     CTA's. The parity buffer makes the next step's posts safe without a
//     second barrier: step t+1 posts into the other buffer, and no warp
//     can post step t+2's total into this one before every warp has
//     passed step t+1's barrier, which each reaches only after its reads
//     of step t.
//   * No branches in the lane loops: a thread's G table lookups, G state
//     updates and G word reads issue together instead of one lane after
//     another; lanes past S run on padding with their consume flags
//     masked off. Shared memory sits at fixed offsets, so the step's
//     addresses are an index plus a constant.
//   * The 4,096-slot table lives in shared memory, one 32-bit entry a
//     slot, sym << 24 | (freq - 1) << 12 | (slot - cum), so a state update
//     is x' = freq (x >> 12) + (slot - cum): a frequency of 4,096 (a
//     single-symbol table) fits as 4,095. Its cumulative frequencies come
//     from one warp's scan (8 symbols a lane), its slots from a binary
//     search a slot over them.
//   * The word stream is staged in a shared-memory ring ahead of the
//     chain, so a step's word reads are shared-memory reads. The ring is
//     kRingChunks chunks of `chunk` >= S (and >= 2,048) words; thread 0
//     fills a chunk with one cp.async.bulk (global -> shared, completing
//     on the chunk's mbarrier) as soon as the chunk it replaces is
//     consumed (the words before the step's base), so the ring runs up to
//     kRingChunks - 2 chunks ahead of the words a step may read. A
//     consumer waits on a chunk's mbarrier once (the CTA-uniform count
//     `ready`), the step it first needs it. Bulk copies need 16-byte
//     addresses and sizes, and a row starts at 2 (p W) bytes: the ring
//     holds a row's words from the 16-byte boundary at or below its start
//     (`o` words earlier: the tail of the row before), and the words past
//     the tensor's last 16-byte boundary (at most 7, last row only) are
//     loaded by thread 0 with plain loads, a step ahead of their first use
//     (the plan guarantees that: decode_plan's chunk >= S), so a barrier
//     orders them.
//     JAX's per-row clip of the word index, clamp(base + prefix, 0, W -
//     1) (:437), reads the row's last word, which lies in its last chunk,
//     which nothing replaces.
//   * A thread writes its G symbols as one vector store where the row
//     offset allows it (G = 8: 8 bytes).
//   encode:
//   * A lane's chain needs no other lane: whether it emits a word at a
//     step depends on its own state and symbol, and only the word's
//     POSITION depends on the emissions before it in (step, lane) order.
//     So there is no barrier a step: one thread a lane runs steps t = K-1
//     .. 0 (a lane whose state reaches freq << 20 emits its low 16 bits
//     and shifts; the state update divides x // f exactly, in 32 bits;
//     the test is x >> 20 >= f, exact for f = 4,096) with its symbols
//     loaded kSymBlock steps ahead, and stores each step's candidate word
//     and, a warp, the ballot of the lanes that emitted. A one-CTA scan of
//     the ballots' popcounts gives every warp-step its first position and
//     n_words; a grid-wide launch places each emitted word below w_budget
//     and zero-fills words to w_budget. Three launches, no host sync, no
//     sort (JAX sorts all K S candidates).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kProbBits = 12;
constexpr uint32_t kProbMask = (1u << kProbBits) - 1;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kMaxWarps = 32;
// The sizes that ops/rans.py's plans also use: the launches below take
// the plan's values and refuse any that differ from these.
constexpr int kRingChunks = 8;     // the decode ring's chunks
constexpr int kEncThreads = 128;   // the encode's lanes a CTA
constexpr int kSymBlock = 16;      // steps of symbols it loads ahead
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;      // masks a scan thread takes a tile
constexpr int kPlaceThreads = 256;

// the most threads a CTA of G lanes a thread may have (S <= 4,096)
template <int G>
__host__ __device__ constexpr int max_threads() {
  return G <= 4 ? 1024 : 4096 / G;
}

// bits of a consume count 0..G
template <int G>
__host__ __device__ constexpr int count_bits() {
  return G == 1 ? 1 : G == 2 ? 2 : G == 4 ? 3 : G == 8 ? 4 : 5;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the phase of parity `parity` of *bar has completed; a wait
// that never ends (a chunk never issued) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0, spins = 0;
  do {
    if (++spins > (1u << 26)) __trap();  // about a second of test_waits
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// one bulk copy of `bytes` (a multiple of 16) global -> shared, completing
// on *bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// CTA-wide exclusive sum of v (0 <= v < 2^kBits) with ONE barrier; *total
// gets the sum over the CTA. sums: [2][kMaxWarps] shared ints, zero past
// the CTA's warps; parity alternates by step (see the header note for why
// one barrier is enough). After the barrier lane i of every warp reads
// warp i's total and two warp reductions give the earlier warps' sum and
// the CTA's.
template <int kBits>
__device__ __forceinline__ int cta_scan(int v, int* sums, int parity,
                                        int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t lower = (1u << lane) - 1u;
  int before = 0, warp_sum = 0;
#pragma unroll
  for (int b = 0; b < kBits; ++b) {
    const uint32_t m = __ballot_sync(0xffffffffu, (v >> b) & 1);
    before += __popc(m & lower) << b;
    warp_sum += __popc(m) << b;
  }
  int* buf = sums + parity * kMaxWarps;
  if (lane == 0) buf[warp] = warp_sum;
  __syncthreads();
  const int w = buf[lane];
  *total = __reduce_add_sync(0xffffffffu, w);
  return before + __reduce_add_sync(0xffffffffu, lane < warp ? w : 0);
}

// cum[0..256] of a [256] u16 frequency row (f[s] < 2^16): warp 0 alone,
// 8 symbols a lane. Callers __syncthreads before reading cum.
__device__ __forceinline__ void warp_cumsum(const uint16_t* f,
                                            uint32_t* cum) {
  const int lane = threadIdx.x & 31;
  uint32_t fs[8], local = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    fs[k] = f[8 * lane + k];
    local += fs[k];
  }
  uint32_t incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  uint32_t c = incl - local;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    cum[8 * lane + k] = c;
    c += fs[k];
  }
  if (lane == 31) cum[256] = c;
}

// G packed bytes <-> ceil(G / 4) 32-bit words
template <int G>
struct Bytes {
  static constexpr int kWords = (G + 3) / 4;
  uint32_t w[kWords];
};

// store b's G bytes at dst: one vector store when all G are in range and
// dst is G-aligned (`aligned`), else byte by byte the first `valid`
template <int G>
__device__ __forceinline__ void store_bytes(uint8_t* dst, const Bytes<G>& b,
                                            int valid, bool aligned) {
  if (valid >= G && aligned) {
    if constexpr (G == 1) {
      *dst = (uint8_t)b.w[0];
    } else if constexpr (G == 2) {
      *reinterpret_cast<uint16_t*>(dst) = (uint16_t)b.w[0];
    } else if constexpr (G == 4) {
      *reinterpret_cast<uint32_t*>(dst) = b.w[0];
    } else if constexpr (G == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(b.w[0], b.w[1]);
    } else {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(b.w[0], b.w[1], b.w[2], b.w[3]);
    }
    return;
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
    if (g < valid) dst[g] = (uint8_t)(b.w[g >> 2] >> (8 * (g & 3)));
}

// decode shared memory (dynamic), at fixed offsets so that every address
// in the step loop is an index plus a constant: the slot table [4096] u32,
// cum [257] u32 (padded to 1,040 bytes), the warp sums [2][32] i32, the
// chunks' mbarriers [kRingChunks] u64, then (from a 128-byte boundary)
// the word ring [kRingChunks chunks] u16
constexpr int kDecCum = 4 * 4096;
constexpr int kDecSums = kDecCum + 1040;
constexpr int kDecBars = kDecSums + 4 * 2 * kMaxWarps;
constexpr int kDecodeFixedSmem =
    (kDecBars + 8 * kRingChunks + 127) / 128 * 128;

template <int G>
__global__ void __launch_bounds__(max_threads<G>())
    rans_decode_kernel(const uint16_t* __restrict__ freqs,
                       const uint32_t* __restrict__ states,
                       const uint16_t* __restrict__ words, int P, int S,
                       int W, int n, int K, int shift,
                       uint8_t* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* table = reinterpret_cast<uint32_t*>(smem);
  uint32_t* cum = reinterpret_cast<uint32_t*>(smem + kDecCum);
  int* sums = reinterpret_cast<int*>(smem + kDecSums);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kDecBars);
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem + kDecodeFixedSmem);
  const int chunk = 1 << shift;  // words a chunk
  const int ring_mask = kRingChunks * chunk - 1;

  const int p = blockIdx.x, tid = threadIdx.x;
  const uint16_t* f = freqs + (size_t)p * 256;
  // the row in the ring's coordinates: virtual word v is flat word
  // row0 + v of the words tensor, the row's word j is v = j + o
  const long long flat = (long long)p * W;
  const long long row0 = flat & ~7LL;
  const int o = (int)(flat - row0);
  const int v_end = o + W;                         // the row ends here
  const int n_chunks = (v_end + chunk - 1) >> shift;
  // bulk copies reach the tensor's last 16-byte boundary, at most
  const long long flat16 = ((long long)P * W) & ~7LL;
  const int v_bulk =
      (int)min((long long)((v_end + 7) & ~7), flat16 - row0);

  // the states first: their loads overlap the table's build
  const int lane0 = tid * G;
  const int lanes = max(0, min(G, S - lane0));  // this thread's real lanes
  const uint32_t* st = states + (size_t)p * S + lane0;
  uint32_t x[G];
#pragma unroll
  for (int g = 0; g < G; ++g) x[g] = g < lanes ? st[g] : kRansL;
  for (int i = tid; i < 2 * kMaxWarps; i += blockDim.x) sums[i] = 0;
  if (tid == 0) {
    for (int c = 0; c < kRingChunks; ++c) mbar_init(&bars[c]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 32) warp_cumsum(f, cum);
  __syncthreads();

  // thread 0 stages chunk q into its slot: one bulk copy, then the words
  // past the last 16-byte boundary (the last row only) by plain loads
  auto issue = [&](int q) {
    const int slot = q & (kRingChunks - 1);
    const int v0 = q * chunk;
    uint16_t* dst = ring + slot * chunk;
    const int v1 = min(v0 + chunk, v_bulk);
    if (v1 > v0) {
      const uint32_t bytes = 2u * (uint32_t)(v1 - v0);
      mbar_arrive_tx(&bars[slot], bytes);
      bulk_load(dst, words + row0 + v0, bytes, &bars[slot]);
    } else {
      mbar_arrive(&bars[slot]);
    }
    for (int v = max(v0, v_bulk); v < min(v0 + chunk, v_end); ++v)
      dst[v - v0] = words[row0 + v];
  };
  // thread 0 has staged chunks [0, issued); the next may go once a step's
  // base reaches issue_at (the chunk it replaces is then consumed)
  int issued = 0, issue_at = 0;
  auto issue_more = [&](int base) {
    while (issued < n_chunks && base >= issue_at) {
      issue(issued++);
      issue_at = (issued - kRingChunks + 1) * chunk - o;
    }
    if (issued == n_chunks) issue_at = INT_MAX;
  };
  if (tid == 0) issue_more(0);

  // slot -> sym << 24 | (freq - 1) << 12 | (slot - cum): the symbol whose
  // [cum, cum + freq) holds the slot (searchsorted of the ends, side
  // right: zero-frequency symbols hold no slot). A frequency of 4,096 (a
  // single-symbol table) fits as 4,095.
#pragma unroll 4
  for (int slot = tid; slot < (1 << kProbBits); slot += blockDim.x) {
    int lo = 0, hi = 256;  // the first s with cum[s + 1] > slot
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cum[mid + 1] > (uint32_t)slot) hi = mid; else lo = mid + 1;
    }
    const int s = lo < 256 ? lo : 255;
    const uint32_t fs = cum[s + 1] - cum[s];
    table[slot] = ((uint32_t)s << 24) | (((fs - 1) & kProbMask) << 12) |
                  ((slot - cum[s]) & kProbMask);
  }
  __syncthreads();

  // ready: chunks known to have landed, the row's words below ready_end
  // (CTA-uniform)
  int base = 0, ready = 0, ready_end = -o;
  uint8_t* o_ptr = out + (size_t)p * n + lane0;  // this thread's symbols
  int o_left = n - lane0;                        // of the row, from o_ptr
  const bool vec_ok = S % G == 0 && ((uintptr_t)o_ptr & (G - 1)) == 0;
  const int last = W - 1 + o;  // the row's last word, where reads clip
  // the lane loops have no branches, so a thread's G lookups and G word
  // reads issue together: a lane past S runs on garbage and its consume
  // flag is masked off (its symbols are never stored)
  const uint32_t real = (1u << lanes) - 1u;  // lanes <= 16
  for (int t = 0; t < K; ++t, o_ptr += S, o_left -= S) {
    uint32_t e[G];
#pragma unroll
    for (int g = 0; g < G; ++g) e[g] = table[x[g] & kProbMask];
    uint32_t consume = 0;
    Bytes<G> sym;
#pragma unroll
    for (int k = 0; k < Bytes<G>::kWords; ++k) sym.w[k] = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const uint32_t fs = ((e[g] >> 12) & kProbMask) + 1;
      x[g] = fs * (x[g] >> kProbBits) + (e[g] & kProbMask);
      sym.w[g >> 2] |= (e[g] >> 24) << (8 * (g & 3));
      consume |= (uint32_t)(x[g] < kRansL) << g;
    }
    consume &= real;
    store_bytes<G>(o_ptr, sym, min(lanes, o_left), vec_ok);
    int total;
    const int before =
        cta_scan<count_bits<G>()>(__popc(consume), sums, t & 1, &total);
    // every read of the steps before t is done: the chunks wholly below
    // this step's base are free for the chunks kRingChunks further on
    if (tid == 0 && base >= issue_at) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue_more(base);
    }
    // this step reads the row's words [base, base + total), clipped
    const int hi = min(base + total, W);
    if (hi > ready_end) {
      const int need = ((hi - 1 + o) >> shift) + 1;
      for (; ready < need; ++ready)
        mbar_wait(&bars[ready & (kRingChunks - 1)],
                  (ready / kRingChunks) & 1);
      ready_end = ready * chunk - o;
    }
    // lane g's word: the step's base, the earlier threads' words and this
    // thread's consuming lanes below g (a lane that does not consume reads
    // a word it drops)
    const int v = base + before + o;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = min(v + __popc(consume & ((1u << g) - 1u)), last);
      const uint32_t w = ring[j & ring_mask];
      x[g] = (consume >> g) & 1u ? (x[g] << 16) | w : x[g];
    }
    base += total;
  }
  // no bulk copy may still be writing when the CTA exits
  if (tid == 0) {
    for (; ready < issued; ++ready)
      mbar_wait(&bars[ready & (kRingChunks - 1)],
                (ready / kRingChunks) & 1);
  }
}

// The encode's lanes are independent chains: a lane's emissions depend on
// its own state and symbols alone, and only a word's POSITION in the stream
// depends on the other lanes (the emissions before it in (step, lane)
// order). So the encode runs in three grid-wide launches, none with a
// barrier a step: every lane's K steps at once (one thread a lane), a scan
// of the emission masks, and the placement of each word.

// 1. A thread runs one lane's steps t = K-1 .. 0 and stores, for every
// step, its candidate word cand[t][lane] and (every lane of a warp, the
// same value) the warp's emission mask masks[t][warp]; n_warps counts the
// grid's warps, so a warp of padding lanes stores a zero mask and no step
// branches. Symbols are loaded kSymBlock steps ahead of the chain, and a
// block of steps has no branch, so a step's table load and the
// reciprocal of its divisor overlap the chain of the step before.
__global__ void __launch_bounds__(kEncThreads)
    rans_encode_lanes_kernel(const uint8_t* __restrict__ data,
                             const uint16_t* __restrict__ freqs, int n,
                             int S, int K, int pad_sym, int n_warps,
                             uint16_t* __restrict__ cand,
                             uint32_t* __restrict__ masks,
                             uint32_t* __restrict__ states) {
  __shared__ uint32_t tab[256];  // max(freq, 1) << 16 | cum
  __shared__ uint32_t cum[257];
  if (threadIdx.x < 32) {
    warp_cumsum(freqs, cum);
    __syncwarp();
    for (int s = threadIdx.x; s < 256; s += 32) {
      const uint32_t fs = freqs[s];
      tab[s] = ((fs ? fs : 1u) << 16) | cum[s];  // an unencodable symbol
    }                                            // codes as freq 1
  }
  __syncthreads();
  const int l = blockIdx.x * kEncThreads + threadIdx.x;  // this lane
  const bool real = l < S;
  const size_t row = (size_t)n_warps * 32;  // a step's candidates
  uint16_t* c_ptr = cand + (size_t)(K - 1) * row + l;
  uint32_t* m_ptr = masks + (size_t)(K - 1) * n_warps + (l >> 5);
  // the symbol of step t (pad_sym past n, and in lanes past S)
  auto sym_at = [&](int t) -> uint32_t {
    const long long i = (long long)t * S + l;
    return real && t >= 0 && i < n ? (uint32_t)data[i] : (uint32_t)pad_sym;
  };
  uint32_t x = kRansL;
  auto step = [&](uint32_t sym) {
    const uint32_t e = tab[sym];
    const uint32_t fs = e >> 16;
    const bool emit = (x >> 20) >= fs;  // x >= fs << 20, exact at 4,096
    const uint32_t word = x & 0xFFFF;
    const uint32_t xs = emit ? x >> 16 : x;
    x = ((xs / fs) << kProbBits) + (e & 0xFFFF) + xs % fs;
    *m_ptr = __ballot_sync(0xffffffffu, emit && real);
    *c_ptr = (uint16_t)word;
    c_ptr -= row;
    m_ptr -= n_warps;
  };
  uint32_t cur[kSymBlock], nxt[kSymBlock];
#pragma unroll
  for (int k = 0; k < kSymBlock; ++k) cur[k] = sym_at(K - 1 - k);
  int t0 = K - 1;  // the next step to code
  for (; t0 >= kSymBlock - 1; t0 -= kSymBlock) {  // whole blocks
#pragma unroll
    for (int k = 0; k < kSymBlock; ++k) nxt[k] = sym_at(t0 - kSymBlock - k);
#pragma unroll
    for (int k = 0; k < kSymBlock; ++k) step(cur[k]);
#pragma unroll
    for (int k = 0; k < kSymBlock; ++k) cur[k] = nxt[k];
  }
#pragma unroll
  for (int k = 0; k < kSymBlock - 1; ++k)  // steps t0 .. 0, fewer than a
    if (k <= t0) step(cur[k]);             // block
  if (real) states[l] = x;
}

// 2. One CTA: offsets[i] = the emissions before mask i (an exclusive scan
// of the masks' popcounts, in (step, warp) order, the decoder's order);
// *n_words = the total. A thread takes kScanItems masks a tile, so a
// tile (three barriers) covers kScanThreads kScanItems masks.
__global__ void __launch_bounds__(kScanThreads)
    rans_encode_scan_kernel(const uint32_t* __restrict__ masks, int M,
                            int* __restrict__ offsets,
                            int* __restrict__ n_words) {
  __shared__ int warp_incl[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry = 0;
  for (int base = 0; base < M; base += kScanThreads * kScanItems) {
    const int i0 = base + tid * kScanItems;
    int c[kScanItems], sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      c[k] = i0 + k < M ? __popc(masks[i0 + k]) : 0;
      sum += c[k];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_incl[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_incl[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_incl[lane] = w;
    }
    __syncthreads();
    int run = carry + (warp ? warp_incl[warp - 1] : 0) + incl - sum;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      if (i0 + k < M) offsets[i0 + k] = run;
      run += c[k];
    }
    carry += warp_incl[kScanThreads / 32 - 1];
    __syncthreads();  // warp_incl is rewritten by the next tile
  }
  if (tid == 0) *n_words = carry;
}

// 3. Words: warp g of the grid places mask g's words at their offsets
// (those below w_budget); thread j zero-fills words [8 j, 8 j + 8) past
// the stream, so words is exactly w_budget long either way.
__global__ void __launch_bounds__(kPlaceThreads)
    rans_encode_place_kernel(const uint16_t* __restrict__ cand,
                             const uint32_t* __restrict__ masks,
                             const int* __restrict__ offsets, int M,
                             const int* __restrict__ n_words, int w_budget,
                             uint16_t* __restrict__ words) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * (kPlaceThreads / 32) + (threadIdx.x >> 5);
  if (g < M) {
    const uint32_t m = masks[g];
    if ((m >> lane) & 1u) {
      const int pos = offsets[g] + __popc(m & ((1u << lane) - 1u));
      if (pos < w_budget) words[pos] = cand[(size_t)g * 32 + lane];
    }
  }
  const int i0 = 8 * (blockIdx.x * kPlaceThreads + threadIdx.x);
  if (i0 < w_budget) {
    const int nw = *n_words;
    if (i0 >= nw && i0 + 8 <= w_budget) {
      *reinterpret_cast<uint4*>(words + i0) = make_uint4(0, 0, 0, 0);
    } else {
      for (int i = max(i0, nw); i < min(i0 + 8, w_budget); ++i) words[i] = 0;
    }
  }
}

// raise the kernel's dynamic shared memory cap to `bytes` once a device
// (cap: the caps set so far, by device ordinal)
constexpr int kMaxDevices = 64;
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* cap) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= 48 * 1024 + cap[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) cap[dev] = bytes - 48 * 1024;
  return err;
}

template <int G>
int decode_launch(int P, int threads, int smem_bytes, cudaStream_t stream,
                  const uint16_t* freqs, const uint32_t* states,
                  const uint16_t* words, int S, int W, int n, int K,
                  int chunk, uint8_t* out) {
  static int cap[kMaxDevices];  // bytes above 48 KB, zero-initialised
  if (threads > max_threads<G>()) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(rans_decode_kernel<G>, smem_bytes, cap);
  if (err != cudaSuccess) return (int)err;
  int shift = 0;
  while ((1 << shift) < chunk) ++shift;
  rans_decode_kernel<G><<<P, threads, smem_bytes, stream>>>(
      freqs, states, words, P, S, W, n, K, shift, out);
  return 0;
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

extern "C" {

// freqs [P, 256] u16, states [P, S] u32, words [P, W] u16 (W >= 1, the
// tensor 16-byte aligned), out [P, n] u8; K = ceil(n / S); g lanes a
// thread, threads a CTA, the ring's words, its chunk (words, a power of
// two >= S and >= 8) and the dynamic shared bytes from
// ops/rans.py::decode_plan, which must agree with this file's layout.
int rans_decode(const void* freqs, const void* states, const void* words,
                int P, int S, int W, int n, int K, int g, int threads,
                int ring_words, int chunk, int smem_bytes, void* out,
                void* stream) {
  if (!pow2(chunk) || chunk < 8 || chunk < S || threads % 32 ||
      threads * g < S || ring_words != kRingChunks * chunk ||
      smem_bytes != 2 * ring_words + kDecodeFixedSmem ||
      ((uintptr_t)words & 15))
    return (int)cudaErrorInvalidValue;
  int err;
#define ASR_RANS_DECODE(GG)                                                 \
  err = decode_launch<GG>(P, threads, smem_bytes, (cudaStream_t)stream,     \
                          (const uint16_t*)freqs, (const uint32_t*)states,  \
                          (const uint16_t*)words, S, W, n, K, chunk,        \
                          (uint8_t*)out)
  switch (g) {
    case 1: ASR_RANS_DECODE(1); break;
    case 2: ASR_RANS_DECODE(2); break;
    case 4: ASR_RANS_DECODE(4); break;
    case 8: ASR_RANS_DECODE(8); break;
    case 16: ASR_RANS_DECODE(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ASR_RANS_DECODE
  if (err) return err;
  return (int)cudaGetLastError();
}

// data [n] u8, freqs [256] u16 (the static table), K = ceil(n / S) ->
// states [S] u32, words [w_budget] u16 (16-byte aligned; the stream's
// first words, zero past it), n_words [1] i32 (the stream's length, also
// past w_budget). Scratch from ops/rans.py::encode_plan (its threads a
// CTA and scan tile must agree with this file's): cand [K][32 W'] u16,
// masks and offsets [K][W'] (W': the warps of ceil(S / threads) CTAs,
// padding lanes included). Three launches on the stream, no host sync;
// w_budget = 0 launches the first two only (the scripts time the step
// loop so).
int rans_encode(const void* data, const void* freqs, int n, int S, int K,
                int pad_sym, int w_budget, int threads, int scan_tile,
                void* cand, void* masks, void* offsets, void* states,
                void* words, void* n_words, void* stream) {
  if (S < 1 || K < 1 || w_budget < 0 || threads != kEncThreads ||
      scan_tile != kScanThreads * kScanItems || ((uintptr_t)words & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int ctas = (S + kEncThreads - 1) / kEncThreads;
  const int n_warps = ctas * (kEncThreads / 32);  // the grid's warps
  const int M = K * n_warps;  // masks
  rans_encode_lanes_kernel<<<ctas, kEncThreads, 0, s>>>(
      (const uint8_t*)data, (const uint16_t*)freqs, n, S, K, pad_sym,
      n_warps, (uint16_t*)cand, (uint32_t*)masks, (uint32_t*)states);
  rans_encode_scan_kernel<<<1, kScanThreads, 0, s>>>(
      (const uint32_t*)masks, M, (int*)offsets, (int*)n_words);
  if (w_budget > 0) {
    const int masks_a_cta = kPlaceThreads / 32;
    const int words_a_cta = 8 * kPlaceThreads;
    const int place = max((M + masks_a_cta - 1) / masks_a_cta,
                          (w_budget + words_a_cta - 1) / words_a_cta);
    rans_encode_place_kernel<<<place, kPlaceThreads, 0, s>>>(
        (const uint16_t*)cand, (const uint32_t*)masks, (const int*)offsets,
        M, (const int*)n_words, w_budget, (uint16_t*)words);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
