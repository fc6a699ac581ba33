// Dynamic time warping over a precomputed float32 distance matrix: the
// accumulated costs and one direction code a cell in one launch, the walk
// back over the codes in another.
//
// Replaces two lax.scan loops of the JAX package (not Pallas kernels):
//   audio_sheet_retrieval_tpu/ops/dtw.py, _dtw_accumulate_diagonals (a scan
//   over the R + C - 1 anti-diagonals) and _traceback_device (a scan of
//   R + C - 2 scalar steps).
//
// What they compute. With a +inf border and acc(0, 0) = dist(0, 0),
//   acc(i, j) = dist(i, j) + min(acc(i-1, j), acc(i, j-1), acc(i-1, j-1))
// in float32, the min propagating NaN (min.NaN.f32, as jnp.minimum; fminf
// would drop it). Each cell is one min and one add, so any order of
// evaluation gives the same bits: bit-identical to the plain loop
// (ops/dtw.py::dtw_accumulate_plain) and to JAX's scan. The code of a cell
// is the traceback's move from it, the argmin over (diag, up, left) of the
// three values the cell's min already holds: the first NaN, else the first
// least (jnp.argmin's rule); row 0 moves left, column 0 up
// (ops/dtw.py::direction_codes). A byte a cell: the walk's dependent load
// is then one byte load with no shift or mask, and 1 byte a cell is 24 MB
// at 6,000 x 4,000, 7 us of device memory against a chain of 0.2 ms.
//
// What bounds it on the H100. Bytes: the distances read once (4 B a cell),
// the codes written once (1 B), the accumulated costs only when the caller
// asks: 0.036 ms at 6,000 x 4,000. Latency: the recurrence's longest
// dependency chain is R + C - 1 cells of one NaN-propagating min and one
// add each (dtw_cell_probe measures one), and the walk n_path dependent
// steps of one shared-memory byte load (dtw_walk_probe). The chain is the
// higher limit at every alignment shape.
//
// dtw_acc_kernel: a wavefront inside each warp, with no CTA-wide barrier
// after the start.
//  - Lane l of a warp owns K consecutive columns of the warp's 32 K-column
//    strip and computes row t - l at step t. `up` is the lane's own
//    registers; left and diag of its first column are lane l - 1's last
//    column at rows r and r - 1, which that lane computed one and two steps
//    before: one rotating shuffle a step (diag is the previous step's
//    left). Lane 0 takes its left column from lane 31 in the same shuffle:
//    lane 31 holds the block's B values of it in registers (its own last
//    column goes right through shared memory).
//  - Steps run in blocks of B (the plan's chunk: 4, 8 or 16), unrolled:
//    the waits, the hand-offs, the code stores and the refills happen once
//    a block, and a step is a shuffle, K cells, a shared load of the
//    distances and two shared stores (the codes, the last column), with
//    no branch. One warp a scheduler runs a warp's steps in series, so
//    every instruction's latency adds to the chain.
//  - Between warps of a CTA the left column goes through a ring of
//    kBndRows rows in shared memory: chunk m is lane 31's rows of the
//    producer's block m, written at the block's end, with a full and an
//    empty mbarrier a slot (phase parity a use); the consumer waits for
//    chunks and frees them in order. A warp runs about 31 + B steps
//    behind its left neighbour. Between CTAs through L2: the last warp of
//    a CTA stores (row + 1, value) pairs, 64 bits at once, into `bnd`; the
//    next CTA's first warp copies them kL2Rows rows ahead into shared
//    memory with cp.async and reads a pair again from L2 only when its tag
//    says it was not yet written (no flag, no fence). A CTA takes its
//    strip from a ticket (an atomic counter), so it waits only on a CTA
//    that started before it: no order of scheduling can deadlock, whatever
//    the grid.
//  - Each warp stages the rows of its strip in a shared-memory ring of
//    ring_rows rows ahead of use: stages of B rows, each one TMA tile
//    (B rows x the warp's strip, zeros outside the matrix) issued by one
//    lane and completing on the stage's mbarrier. A row slot is 32 K
//    floats, a multiple of 32 words, so the lane-skewed reads (row t - l,
//    lane l's columns) hit 32 different banks. A stage is refilled as
//    soon as lane 31 is past its last row, about ring_rows - 48 steps
//    ahead of use.
//  - Codes go into a per-warp ring of kCodeRows rows (bank-conflict-free
//    byte stores at every K) and out to global memory B complete rows a
//    block, in 16-byte stores by the whole warp. The accumulated costs,
//    when asked, go straight from registers (a second instantiation).
//  - Waits use mbarrier.try_wait, which suspends a thread instead of
//    polling shared memory (test_wait polling slowed every warp's shared
//    loads and shuffles).
//  - Why many CTAs and no cluster: each SM holds only a few hundred
//    columns of the ring (32 + ahead rows a column), so wide matrices need
//    tens of SMs; a cluster of 8 (DSMEM handoff) would not cover 16,400
//    columns.
//  - Where its time goes (scripts/torch_dtw_ab.py, PERF.md): a step costs
//    about 170 cycles at K = 2 in the kernel against 89 for the same
//    instructions alone in a loop and 36 for the chain of a shuffle and a
//    min-add; each shared-memory instruction there issues in 15-25 cycles,
//    and a block's bookkeeping adds about 850 cycles.
//
// dtw_walk_kernel: one warp walks the codes from (R-1, C-1) to (0, 0). It
// keeps a 2 x 2 window of 64 x 64 code tiles in shared memory (slot by the
// tiles' index parities): the walk's tile and the tiles above, left and
// above-left. When the walk enters a neighbour, the warp waits for the
// copies in flight (the tile it enters was issued a tile's walk before),
// then issues cp.async copies of the two or three tiles that enter the
// window. A step is one dependent shared-memory byte load at a running
// offset; while the walk is kRun steps or more from the tile's edges it
// takes kRun steps with no check between them. The positions after each
// step, the step count and the final cost's bits go into one int32
// buffer, so the host downloads that buffer and nothing else.
//
// Every wait spins with a deadline of a few seconds of wall time and traps
// past it, so a fault fails the launch instead of hanging the card.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = 16;   // the accumulation's CTA, 128 registers a thread
constexpr int kCodeRows = 64;   // code rows a warp stages
constexpr int kBndRows = 64;    // a warp's ring of its left neighbour's column
constexpr int kL2Rows = 32;     // boundary rows a CTA reads ahead from L2
constexpr int kTile = 64;       // the walk's code tiles, kTile x kTile
constexpr int kRun = 8;         // walk steps taken with no tile check
constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint64_t kDeadlineNs = 4000000000ull;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t wall_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
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

// true once the phase of parity `parity` of the mbarrier at shared address
// `a` has completed. try_wait, not test_wait: a thread whose phase is not
// complete is suspended in hardware for a while instead of polling shared
// memory, which would slow every other warp's shared loads and shuffles.
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

// wait until the phase of parity `parity` of *bar has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try(a, parity)) return;
  const uint64_t t0 = wall_ns();
  uint32_t tries = 0;
  while (!mbar_try(a, parity)) {
    if ((++tries & 63u) == 0 && wall_ns() - t0 > kDeadlineNs) __trap();
  }
}

// one TMA copy of the 2-D tile at (column x, row y) of the tensor map
// global -> shared, completing on *bar; rows and columns outside the
// tensor are filled with zeros
__device__ __forceinline__ void tile_load(void* dst, const CUtensorMap* map,
                                          int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// K floats from 4 K-byte-aligned shared memory
template <int K>
__device__ __forceinline__ void load_k(float (&d)[K], const float* p) {
  if constexpr (K == 1) {
    d[0] = *p;
  } else if constexpr (K == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    d[0] = v.x;
    d[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < K; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + q);
      d[q] = v.x;
      d[q + 1] = v.y;
      d[q + 2] = v.z;
      d[q + 3] = v.w;
    }
  }
}

// K code bytes (byte q of `bits` is column q's) into K-byte-aligned shared
template <int K>
__device__ __forceinline__ void store_codes(uint8_t* p, uint32_t bits) {
  if constexpr (K == 1) {
    *p = static_cast<uint8_t>(bits);
  } else if constexpr (K == 2) {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(bits);
  } else {
    *reinterpret_cast<uint32_t*>(p) = static_cast<uint32_t>(bits);
  }
}

// 64-bit stores / loads at gpu scope: a (value, tag) pair lands or is seen
// whole
__device__ __forceinline__ void st_pair(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_pair(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct AccArgs {
  const float* dist;  // [R, ld], ld % 4 == 0, 16-byte aligned
  uint8_t* codes;     // [R, cld], cld % 16 == 0, 16-byte aligned
  float* acc;         // [R, C] or null
  float* cost;        // [1]: acc(R-1, C-1)
  unsigned long long* bnd;  // [ctas, Rp], zero: CTA s's last column for
                            // CTA s + 1, (row + 1) << 32 | value bits
  int* ticket;        // zero
  int R, C, ld, cld, Rp;
  int warps, ctas, ring_rows;
};

// byte offsets of a CTA's shared memory (ops/dtw.py::acc_smem_bytes)
struct Layout {
  size_t codes, l2, bnd, last, inf, l2f, bars, ticket, total;
};

__host__ __device__ inline Layout layout(int K, int B, int W, int ring_rows) {
  const size_t sw = 32 * (size_t)K;
  Layout L;
  L.codes = (size_t)W * ring_rows * sw * 4;
  L.l2 = L.codes + (size_t)W * kCodeRows * sw;
  L.bnd = L.l2 + 8 * (size_t)kL2Rows;
  L.last = L.bnd + (size_t)W * kBndRows * 4;
  L.inf = L.last + (size_t)W * B * 32 * 4;
  L.l2f = L.inf + 4 * (size_t)B;
  L.bars = (L.l2f + 4 * (size_t)B + 7) & ~(size_t)7;
  L.ticket = L.bars + 8 * (size_t)W * (ring_rows / B + 2 * (kBndRows / B));
  L.total = L.ticket + 16;
  return L;
}

// K columns a lane, blocks of B steps, the accumulated costs stored or not
template <int K, int B, bool ACC>
__global__ void __launch_bounds__(32 * kMaxWarps)
    dtw_acc_kernel(const AccArgs a, const __grid_constant__ CUtensorMap tmap) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int SW = 32 * K;            // a warp's strip, columns
  constexpr int kFree = (31 + B - 1) / B;  // blocks until lane 31 is past a stage
  constexpr int kAhead = kL2Rows / B;   // boundary chunks read ahead from L2
  constexpr int kS = kBndRows / B;      // boundary chunks a warp's ring holds
  const int W = a.warps, R = a.R, C = a.C;
  const int RR = a.ring_rows, NS = RR / B, ns_log2 = __ffs(NS) - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Layout L = layout(K, B, W, RR);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  int* ticket = reinterpret_cast<int*>(smem + L.ticket);
  float* inf_row = reinterpret_cast<float*>(smem + L.inf);
  float* l2_vals = reinterpret_cast<float*>(smem + L.l2f);
  if (threadIdx.x == 0) {
    *ticket = atomicAdd(a.ticket, 1);
    for (int b = 0; b < W * (NS + 2 * kS); ++b) mbar_init(&bars[b]);
    for (int u = 0; u < B; ++u) inf_row[u] = CUDART_INF_F;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the only CTA-wide barrier: the barriers and the ticket
  const int cta = *ticket;
  const int n_strips = (C + SW - 1) / SW;
  const int gw = cta * W + warp;  // this warp's strip
  if (gw >= n_strips) return;
  const int c0 = gw * SW;

  float* ring = reinterpret_cast<float*>(smem) + (size_t)warp * RR * SW;
  uint8_t* code_ring = smem + L.codes + (size_t)warp * kCodeRows * SW;
  unsigned long long* l2_ring =
      reinterpret_cast<unsigned long long*>(smem + L.l2);
  float* bnd_rings = reinterpret_cast<float*>(smem + L.bnd);
  uint64_t* stage_bar = bars + warp * NS;
  uint64_t* full_bars = bars + W * NS;  // [W][kS]: warp w's left ring
  uint64_t* empty_bars = full_bars + W * kS;
  float* last_col = reinterpret_cast<float*>(smem + L.last) + warp * B * 32;

  // where lane 0's left column comes from, where lane 31's goes
  const bool from_ring = warp > 0;
  const bool from_l2 = warp == 0 && gw > 0;
  const bool to_right = gw + 1 < n_strips;
  const bool to_ring = to_right && warp + 1 < W;
  const bool to_l2 = to_right && warp + 1 == W;
  const int lw = from_ring ? warp : 0, rw = to_ring ? warp + 1 : 0;
  const float* lring = bnd_rings + lw * kBndRows;
  float* rring = bnd_rings + rw * kBndRows;
  const unsigned long long* gleft =
      a.bnd + (size_t)(from_l2 ? cta - 1 : 0) * a.Rp;
  unsigned long long* gright = a.bnd + (size_t)cta * a.Rp;

  // the distance ring: lane 0 stages stage q (rows [B q, B q + B) of the
  // strip) into slot q % NS, one TMA tile
  const int n_stages = (R + B - 1) / B;
  auto issue = [&](int q) {
    const int s = q & (NS - 1);
    mbar_arrive_tx(&stage_bar[s], (uint32_t)(B * SW * 4));
    tile_load(ring + s * B * SW, &tmap, c0, q * B, &stage_bar[s]);
  };
  if (lane == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tmap))
                 : "memory");
    for (int q = 0; q < min(NS, n_stages); ++q) issue(q);
  }

  // the left column from L2 (row r's pair at r + 31): chunk n's B pairs
  // into slot n % kAhead, one 8-byte cp.async a lane; one commit group a
  // chunk, so chunk n has landed once kAhead - 1 later groups are pending
  auto l2_fetch = [&](int n) {
    if (lane < B && n * B < R)
      cp_async8(l2_ring + (n & (kAhead - 1)) * B + lane,
                gleft + n * B + 31 + lane);
    cp_async_commit();
  };
  if (from_l2)
    for (int n = 0; n < kAhead; ++n) l2_fetch(n);

  const int code_bytes = min(SW, a.cld - c0);  // a multiple of 16
  const float* dl = ring + lane * K;            // this lane's columns
  uint8_t* cl = code_ring + lane * K;
  float up[K];
#pragma unroll
  for (int q = 0; q < K; ++q) up[q] = CUDART_INF_F;  // row -1
  float dg0 = CUDART_INF_F;  // acc(r - 1, first column - 1)
  const int my_col = c0 + lane * K;   // this lane's first column
  const bool col0 = my_col == 0;      // column 0 is this lane's first
  const int last_q = C - 1 - my_col;  // column C - 1's index here, if any
  float cost = 0.f;
  // the left ring: chunk m is lane 31's rows of the producer's block m,
  // [B m - 31, B m - 31 + B), row r at r % kBndRows; the consumer waits for
  // chunks and frees them in order
  int waited = 0, freed = 0;
  const int n_blocks = (R + 31 + B - 1) / B;
  for (int nb = 0; nb < n_blocks; ++nb) {
    const int t0 = nb * B;  // lane l computes rows t0 - l + [0, B)
    const float* lsrc = inf_row;  // lane 0's left column, B rows, aligned
    if (t0 < R) {
      mbar_wait(&stage_bar[nb & (NS - 1)], (uint32_t)(nb >> ns_log2) & 1u);
      if (from_ring) {
        const int need = (min(t0 + B, R) + 30) / B;  // chunk of the last row
        for (; waited <= need; ++waited)
          mbar_wait(&full_bars[lw * kS + (waited & (kS - 1))],
                    (uint32_t)(waited / kS) & 1u);
        lsrc = lring + (t0 & (kBndRows - 1));
      } else if (from_l2) {
        cp_async_wait<kAhead - 1>();
        __syncwarp();  // the copies of every lane have landed
        // a pair not yet written when it was copied: read it again from L2
        const unsigned long long* slot = l2_ring + (nb & (kAhead - 1)) * B;
        const int row = t0 + lane;
        if (lane < B) {
          unsigned long long v = slot[lane];
          if (row < R && (uint32_t)(v >> 32) != (uint32_t)(row + 1)) {
            const uint64_t w0 = wall_ns();
            while ((uint32_t)((v = ld_pair(gleft + row + 31)) >> 32) !=
                   (uint32_t)(row + 1)) {
              __nanosleep(32);
              if (wall_ns() - w0 > kDeadlineNs) __trap();
            }
          }
          l2_vals[lane] = __uint_as_float((uint32_t)v);
        }
        __syncwarp();
        lsrc = l2_vals;
      }
    }
    // lane 31 holds the block's left column: its value is what lane 0 takes
    // from the rotating shuffle (lane 31's own last column goes right
    // through shared memory, not through the shuffle)
    float bv[B];
#pragma unroll
    for (int u = 0; u < B; u += 4) {
      const float4 w = *reinterpret_cast<const float4*>(lsrc + u);
      bv[u] = w.x;
      bv[u + 1] = w.y;
      bv[u + 2] = w.z;
      bv[u + 3] = w.w;
    }
    // this block's rows of lane 31 go on as chunk nb: is its slot free?
    if (to_ring && nb >= kS)
      mbar_wait(&empty_bars[rw * kS + (nb & (kS - 1))],
                (uint32_t)(nb / kS - 1) & 1u);
    const int rb = t0 - lane;
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int r = rb + u;
      // the step's inputs: distances (garbage off the matrix), lane 0's
      // left neighbour, lane l - 1's last column
      float d[K];
      load_k<K>(d, dl + (r & (RR - 1)) * SW);
      const float lf = __shfl_sync(kFullMask, lane == 31 ? bv[u] : up[K - 1],
                                   (lane + 31) & 31);
      const bool row0 = r == 0;
      float left = lf, diag = dg0, v[K];
      uint32_t bits = 0;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const float uq = up[q];
        const float m = min_nan(min_nan(diag, uq), left);
        // the first NaN of (diag, up, left), else the first least: with
        // no NaN in, m is no NaN and x == m finds the least; with one, m
        // is NaN and only x != x holds
        const bool pd = diag == m || diag != diag;
        const bool pu = uq == m || uq != uq;
        uint32_t code = pd ? 0u : pu ? 1u : 2u;
        const bool c0q = q == 0 && col0;
        if (c0q) code = row0 ? 0u : 1u;
        else if (row0) code = 2u;
        v[q] = __fadd_rn(d[q], row0 && c0q ? 0.f : m);  // (0, 0) adds nothing
        bits |= code << (8 * q);
        diag = uq;
        left = v[q];
      }
      // rows off the matrix store their codes too: the slot is one no row
      // in flight uses
      store_codes<K>(cl + (r & (kCodeRows - 1)) * SW, bits);
      if constexpr (ACC) {
        if ((unsigned)r < (unsigned)R) {
#pragma unroll
          for (int q = 0; q < K; ++q)
            if (my_col + q < C) a.acc[(size_t)r * C + my_col + q] = v[q];
        }
      }
#pragma unroll
      for (int q = 0; q < K; ++q)
        if (q == last_q && r == R - 1) cost = v[q];
      // every lane's last column; lane 31's goes on at the block's end
      last_col[u * 32 + lane] = v[K - 1];
#pragma unroll
      for (int q = 0; q < K; ++q) up[q] = r < 0 ? CUDART_INF_F : v[q];
      dg0 = lf;
    }
    // lane 31's rows [t0 - 31, t0 - 31 + B) go right: chunk nb of the next
    // warp's ring, or (row + 1, value) pairs in L2 at row + 31
    if (to_right) {
      __syncwarp();
      if (lane < B) {
        const float hv = last_col[lane * 32 + 31];
        const int row = t0 - 31 + lane;
        if (to_ring) {
          rring[(row + kBndRows) & (kBndRows - 1)] = hv;
        } else if (row >= 0 && row < R) {
          st_pair(gright + t0 + lane,
                  (unsigned long long)(uint32_t)(row + 1) << 32 |
                      __float_as_uint(hv));
        }
      }
      __syncwarp();
      if (to_ring && lane == 0)
        mbar_arrive(&full_bars[rw * kS + (nb & (kS - 1))]);
    }
    // lane 0 is done with the chunks wholly above row t0 + B
    if (t0 < R) {
      if (from_ring && lane == 0)
        for (const int done = (t0 + 31) / B; freed <= done; ++freed)
          mbar_arrive(&empty_bars[lw * kS + (freed & (kS - 1))]);
      if (from_l2) {
        __syncwarp();
        l2_fetch(nb + kAhead);
      }
    }
    // rows [t0 - 31, t0 - 31 + B) are complete: their codes go out
    __syncwarp();
    const int f0 = t0 - 31;
    for (int x = lane; x < B * 2 * K; x += 32) {
      const int i = x / (2 * K), ch = x % (2 * K), r = f0 + i;
      if (r >= 0 && r < R && ch * 16 < code_bytes)
        *reinterpret_cast<uint4*>(a.codes + (size_t)r * a.cld + c0 + ch * 16) =
            *reinterpret_cast<const uint4*>(
                code_ring + (r & (kCodeRows - 1)) * SW + ch * 16);
    }
    __syncwarp();
    // lane 31 is past stage nb - kFree: refill its slot. Every read of it
    // has returned (its values fed this block's cells), so no proxy fence:
    // one here would wait for the code stores just issued
    const int q = nb - kFree + NS;
    if (nb >= kFree && q < n_stages && lane == 0) issue(q);
  }
  if (last_q >= 0 && last_q < K) *a.cost = cost;  // cell (R-1, C-1)'s lane
}

__global__ void __launch_bounds__(32)
    dtw_walk_kernel(const uint8_t* __restrict__ codes, int R, int C, int cld,
                    const float* cost, int* out) {
  __shared__ __align__(16) uint8_t tiles[4][kTile * kTile];
  const int lane = threadIdx.x;
  const int L = R + C - 1;  // path capacity
  // the warp copies tile (ti, tj) into the slot of its index parities
  auto load = [&](int ti, int tj) {
    if (ti < 0 || tj < 0) return;
    uint8_t* dst = tiles[((ti & 1) << 1) | (tj & 1)];
    const int rows = min(kTile, R - ti * kTile);
    const int per_row = min(kTile, cld - tj * kTile) >> 4;
    const uint8_t* s = codes + (size_t)ti * kTile * cld + tj * kTile;
    for (int x = lane; x < rows * per_row; x += 32) {
      const int r = x / per_row, ch = x - r * per_row;
      cp_async16(dst + r * kTile + ch * 16, s + (size_t)r * cld + ch * 16);
    }
  };
  int i = R - 1, j = C - 1, n = 0;
  int ti = i / kTile, tj = j / kTile;
  load(ti, tj);
  load(ti - 1, tj);
  load(ti, tj - 1);
  load(ti - 1, tj - 1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  // the walk's byte in shared memory: a move up takes kTile from it, left
  // 1, diag both; a move into another tile starts it afresh
  auto at = [&](int ti_, int tj_) {
    return smem_u32(tiles[((ti_ & 1) << 1) | (tj_ & 1)]) +
           (uint32_t)((i & (kTile - 1)) * kTile + (j & (kTile - 1)));
  };
  uint32_t off = at(ti, tj);
  while ((i | j) != 0 && n < L) {
    if (min(i & (kTile - 1), j & (kTile - 1)) >= kRun) {
      // the next kRun steps stay inside this tile and short of (0, 0):
      // no check between them
      int* po = out + 2 + n;
      int* qo = out + 2 + L + n;
#pragma unroll
      for (int s = 0; s < kRun; ++s) {
        uint32_t c;
        asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(c) : "r"(off));
        const int di = c != 2u, dj = c != 1u;
        i -= di;
        j -= dj;
        off -= (uint32_t)(di * kTile + dj);
        if (lane == 0) {
          po[s] = i;
          qo[s] = j;
        }
      }
      n += kRun;
      continue;
    }
    uint32_t c;
    asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(c) : "r"(off));
    const int di = c != 2u, dj = c != 1u;
    const int ni = i - di, nj = j - dj;
    off -= (uint32_t)(di * kTile + dj);
    if (lane == 0) {
      out[2 + n] = ni;
      out[2 + L + n] = nj;
    }
    ++n;
    if (((ni ^ i) | (nj ^ j)) >= kTile) {  // another tile
      const int nti = ni / kTile, ntj = nj / kTile;
      // every copy so far has landed, the tile moved into among them, and
      // every lane is done with the tiles that leave: a slot never takes a
      // second copy while one is in flight into it
      cp_async_wait<0>();
      __syncwarp();
      if (nti != ti && ntj != tj) {  // the tiles entering the window
        load(ti - 2, tj - 1);
        load(ti - 2, tj - 2);
        load(ti - 1, tj - 2);
      } else if (nti != ti) {
        load(ti - 2, tj - 1);
        load(ti - 2, tj);
      } else {
        load(ti - 1, tj - 2);
        load(ti, tj - 2);
      }
      cp_async_commit();
      ti = nti;
      tj = ntj;
      i = ni;
      j = nj;
      off = at(ti, tj);
      continue;
    }
    i = ni;
    j = nj;
  }
  if (lane == 0) {
    out[0] = n;
    out[1] = __float_as_int(*cost);
  }
}

// `rounds` CTA-wide barriers of `blockDim.x` threads, each after a shared
// store and before a neighbour's load: a diagonal-barrier design's floor a
// diagonal (and chip_smoke.py's rANS bound's round)
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

// one thread, `steps` dependent cells: a NaN-propagating min and an add
__global__ void cell_probe_kernel(int steps, float y, float d, float* out) {
  float x = y;
#pragma unroll 8
  for (int s = 0; s < steps; ++s) x = __fadd_rn(min_nan(x, y), d);
  *out = x;
}

// one thread, `steps` dependent walk steps over a 64 x 64 code tile in
// shared memory: the byte load, the move, the next address
__global__ void walk_probe_kernel(int steps, int* out) {
  __shared__ uint8_t s[kTile * kTile];
  for (int x = threadIdx.x; x < kTile * kTile; x += blockDim.x)
    s[x] = (uint8_t)((x * 7 + x / kTile) % 3);
  __syncthreads();
  if (threadIdx.x != 0) return;
  int i = kTile - 1, j = kTile - 1;
#pragma unroll 8
  for (int n = 0; n < steps; ++n) {
    const uint32_t c = s[(i & (kTile - 1)) * kTile + (j & (kTile - 1))];
    i -= c != 2u;
    j -= c != 1u;
  }
  out[0] = i + j;
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

template <int K, int B, bool ACC>
int launch_acc(const AccArgs& a, int smem_bytes, cudaStream_t s) {
  const Layout L = layout(K, B, a.warps, a.ring_rows);
  const int strips = (a.C + 32 * K - 1) / (32 * K);
  if ((size_t)smem_bytes != L.total ||
      a.ctas != (strips + a.warps - 1) / a.warps || a.ring_rows % B)
    return (int)cudaErrorInvalidValue;
  // the distances as a [R, C] tensor of rows ld floats apart, in tiles of
  // B rows x one warp's strip
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tmap;
  const cuuint64_t dims[2] = {(cuuint64_t)a.C, (cuuint64_t)a.R};
  const cuuint64_t strides[1] = {(cuuint64_t)a.ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)(32 * K), (cuuint32_t)B};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(a.dist), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dtw_acc_kernel<K, B, ACC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dtw_acc_kernel<K, B, ACC><<<a.ctas, 32 * a.warps, smem_bytes, s>>>(a,
                                                                    tmap);
  return (int)cudaGetLastError();
}

template <int K>
int launch_acc_k(const AccArgs& a, int chunk, int smem_bytes,
                 cudaStream_t s) {
  const bool acc = a.acc != nullptr;
  switch (chunk) {
    case 4: return acc ? launch_acc<K, 4, true>(a, smem_bytes, s)
                       : launch_acc<K, 4, false>(a, smem_bytes, s);
    case 8: return acc ? launch_acc<K, 8, true>(a, smem_bytes, s)
                       : launch_acc<K, 8, false>(a, smem_bytes, s);
    case 16: return acc ? launch_acc<K, 16, true>(a, smem_bytes, s)
                        : launch_acc<K, 16, false>(a, smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dist: [R, ld] float32, ld % 4 == 0 (columns C..ld-1 unread); codes:
// uint8 [R, cld], cld % 16 == 0; acc: [R, C] float32 or null; cost:
// float32 [1]; bnd: uint64 [ctas, Rp] and ticket: int32 [1], both zero, Rp
// a multiple of 8 and >= R + 31. k (1, 2, 4), warps a CTA (1..16), ctas,
// ring_rows (64 or 128) and chunk (4, 8, 16) from ops/dtw.py::acc_plan,
// whose smem_bytes must equal this file's layout. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments outside these.
int dtw_accumulate(const void* dist, int R, int C, int ld, void* codes,
                   int cld, void* acc, void* cost, void* bnd, int Rp,
                   void* ticket, int k, int warps, int ctas, int ring_rows,
                   int chunk, int smem_bytes, void* stream) {
  if (R < 1 || C < 1 || ld < C || ld % 4 || cld < C || cld % 16 ||
      Rp < R + 31 || Rp % 8 || warps < 1 || warps > kMaxWarps ||
      !(ring_rows == 64 || ring_rows == 128) || ((uintptr_t)dist & 15) ||
      ((uintptr_t)codes & 15) || ((uintptr_t)bnd & 15))
    return (int)cudaErrorInvalidValue;
  AccArgs a{static_cast<const float*>(dist), static_cast<uint8_t*>(codes),
            static_cast<float*>(acc), static_cast<float*>(cost),
            static_cast<unsigned long long*>(bnd), static_cast<int*>(ticket),
            R, C, ld, cld, Rp, warps, ctas, ring_rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_acc_k<1>(a, chunk, smem_bytes, s);
    case 2: return launch_acc_k<2>(a, chunk, smem_bytes, s);
    case 4: return launch_acc_k<4>(a, chunk, smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// codes: uint8 [R, cld] (dtw_accumulate's), cld % 16 == 0; cost: float32
// [1]; out: int32 [2 + 2 (R + C - 1)]. Writes out[0] = n steps, out[1] =
// the bits of *cost, out[2 + s] and out[2 + R + C - 1 + s] = the row and
// column after step s.
int dtw_traceback(const void* codes, int R, int C, int cld, const void* cost,
                  void* out, void* stream) {
  if (R < 1 || C < 1 || cld < C || cld % 16 || ((uintptr_t)codes & 15))
    return (int)cudaErrorInvalidValue;
  dtw_walk_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), R, C, cld,
      static_cast<const float*>(cost), static_cast<int*>(out));
  return (int)cudaGetLastError();
}

// out: int32 [threads]
int dtw_barrier_rounds(int rounds, int threads, void* out, void* stream) {
  barrier_rounds_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      rounds, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

// out: float32 [1]
int dtw_cell_probe(int steps, void* out, void* stream) {
  cell_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, 0.5f, 0.25f, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// out: int32 [1]
int dtw_walk_probe(int steps, void* out, void* stream) {
  walk_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
