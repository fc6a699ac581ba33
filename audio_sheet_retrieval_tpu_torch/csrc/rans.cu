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
// Design. One CTA a payload: the word stream is one serial chain shared by
// the lanes, so a payload never spans SMs (the format's own limit; P
// payloads fill P SMs). Thread t owns the CONTIGUOUS lanes [t G, t G + G),
// G in {1, 2, 4, 8, 16}, so its count of consuming lanes plus a CTA-wide
// exclusive scan (warp shuffles, then one warp over the warp sums: two
// barriers a step, the warp sums double-buffered by step parity) gives
// each of its lanes its position in lane-ascending order. States stay in
// registers for all K steps.
//   decode: the 4,096-slot table lives in shared memory, one 32-bit entry
//   a slot, sym << 24 | (freq - 1) << 12 | cum: a frequency of 4,096 (a
//   single-symbol table) fits as 4,095 (JAX's packed table stores freq
//   itself and cannot hold 4,096). A step: look the slot up, update the
//   state, write the symbol to out[p, t S + lane] (lanes past n decode
//   padding and are not written), scan, then the consuming lanes read
//   words[p, clamp(base + prefix, 0, W - 1)] (JAX's per-row clip, :437).
//   encode: steps t = K-1 .. 0; a lane whose state reaches freq << 20
//   emits its low 16 bits and shifts; the CTA writes each step's words
//   into a scratch row [K S] from the END backwards, lanes ascending within
//   the step, so the stream reads forward in the decoder's order with no
//   sort, and words[i] = scratch[pos + i] (zero past n_words, up to
//   w_budget: JAX's slice is short when K S < w_budget, :582). The state
//   update divides x // f in 32 bits (x < 2^32 after renormalisation;
//   the renormalisation test is 64-bit, freq << 20 reaches 2^32 at 4,096).
//
// What bounds it on the H100. Bytes: the words read once, the symbols
// written once (decode) or the data read once and the words written once
// (encode) -- a few hundred kB at the serving shapes, 0.1 us at 3.35
// TB/s. Latency: K dependent steps of two barrier rounds and one dependent
// load from device memory (a word) each; at the serving shapes (K = 121
// to 619) that is the bound, as for the DTW wavefront.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kProbBits = 12;
constexpr uint32_t kProbMask = (1u << kProbBits) - 1;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kMaxWarps = 32;

// CTA-wide exclusive sum of v; *total gets the sum over the CTA. sums is
// [2][kMaxWarps] shared ints; parity alternates between calls so that a
// call's writes never race the previous call's reads (two barriers).
__device__ __forceinline__ int block_exclusive_scan(int v, int* sums,
                                                    int parity, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int* buf = sums + parity * kMaxWarps;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? buf[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < n_warps) buf[lane] = s;
  }
  __syncthreads();
  *total = buf[n_warps - 1];
  return (warp > 0 ? buf[warp - 1] : 0) + x - v;
}

template <int G>
__global__ void __launch_bounds__(256)
    rans_decode_kernel(const uint16_t* __restrict__ freqs,
                       const uint32_t* __restrict__ states,
                       const uint16_t* __restrict__ words, int S, int W,
                       int n, int K, uint8_t* __restrict__ out) {
  __shared__ uint32_t table[1 << kProbBits];
  __shared__ uint32_t cum[257];
  __shared__ int sums[2 * kMaxWarps];
  const int p = blockIdx.x, tid = threadIdx.x;
  const uint16_t* f = freqs + (size_t)p * 256;
  if (tid == 0) {
    uint32_t c = 0;
    for (int s = 0; s < 256; ++s) {
      cum[s] = c;
      c += f[s];
    }
    cum[256] = c;
  }
  __syncthreads();
  // slot -> the symbol whose [cum, cum + freq) holds it (searchsorted of
  // the ends, side right: zero-frequency symbols hold no slot)
  for (int slot = tid; slot < (1 << kProbBits); slot += blockDim.x) {
    int lo = 0, hi = 256;  // the first s with cum[s + 1] > slot
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cum[mid + 1] > (uint32_t)slot) hi = mid; else lo = mid + 1;
    }
    const int s = lo < 256 ? lo : 255;
    const uint32_t fs = f[s];
    table[slot] = ((uint32_t)s << 24) | (((fs - 1) & kProbMask) << 12) |
                  (cum[s] & kProbMask);
  }
  const uint32_t* st = states + (size_t)p * S;
  const uint16_t* wr = words + (size_t)p * W;
  uint8_t* o = out + (size_t)p * n;
  const int lane0 = tid * G;
  uint32_t x[G];
#pragma unroll
  for (int g = 0; g < G; ++g) x[g] = lane0 + g < S ? st[lane0 + g] : kRansL;
  __syncthreads();
  int base = 0;
  for (int t = 0; t < K; ++t) {
    const int i0 = t * S + lane0;
    int cnt = 0;
    uint32_t consume = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane0 + g < S) {
        const uint32_t slot = x[g] & kProbMask;
        const uint32_t e = table[slot];
        const uint32_t fs = ((e >> 12) & kProbMask) + 1;
        x[g] = fs * (x[g] >> kProbBits) + slot - (e & kProbMask);
        if (i0 + g < n) o[i0 + g] = (uint8_t)(e >> 24);
        if (x[g] < kRansL) {
          consume |= 1u << g;
          ++cnt;
        }
      }
    }
    int total;
    int idx = base + block_exclusive_scan(cnt, sums, t & 1, &total);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (consume & (1u << g)) {
        const int j = idx < 0 ? 0 : (idx >= W ? W - 1 : idx);
        x[g] = (x[g] << 16) | __ldg(wr + j);
        ++idx;
      }
    }
    base += total;
  }
}

template <int G>
__global__ void __launch_bounds__(256)
    rans_encode_kernel(const uint8_t* __restrict__ data,
                       const uint16_t* __restrict__ freqs, int n, int S,
                       int K, int pad_sym, int w_budget,
                       uint16_t* scratch, uint32_t* __restrict__ states,
                       uint16_t* __restrict__ words,
                       int* __restrict__ n_words) {
  __shared__ uint32_t fq[256];
  __shared__ uint32_t cum[256];
  __shared__ int sums[2 * kMaxWarps];
  const int tid = threadIdx.x;
  if (tid == 0) {
    uint32_t c = 0;
    for (int s = 0; s < 256; ++s) {
      const uint32_t fs = freqs[s];
      cum[s] = c;
      fq[s] = fs ? fs : 1;  // an unencodable symbol codes as freq 1
      c += fs;
    }
  }
  __syncthreads();
  const int lane0 = tid * G;
  uint32_t x[G];
#pragma unroll
  for (int g = 0; g < G; ++g) x[g] = kRansL;
  int pos = K * S;  // the stream so far is scratch[pos, K S)
  for (int t = K - 1; t >= 0; --t) {
    const int i0 = t * S + lane0;
    int cnt = 0;
    uint32_t need = 0;
    uint16_t cand[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane0 + g < S) {
        const int i = i0 + g;
        const int sym = i < n ? data[i] : pad_sym;
        const uint32_t fs = fq[sym];
        uint32_t xs = x[g];
        if ((uint64_t)xs >= ((uint64_t)fs << 20)) {
          cand[g] = (uint16_t)(xs & 0xFFFF);
          xs >>= 16;
          need |= 1u << g;
          ++cnt;
        }
        x[g] = ((xs / fs) << kProbBits) + cum[sym] + xs % fs;
      }
    }
    int total;
    const int prefix = block_exclusive_scan(cnt, sums, t & 1, &total);
    int dst = pos - total + prefix;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (need & (1u << g)) scratch[dst++] = cand[g];
    }
    pos -= total;
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
    if (lane0 + g < S) states[lane0 + g] = x[g];
  if (tid == 0) *n_words = K * S - pos;
  __syncthreads();  // the scratch writes of every thread, visible to all
  const int nw = K * S - pos;
  for (int i = tid; i < w_budget; i += blockDim.x)
    words[i] = i < nw ? scratch[pos + i] : (uint16_t)0;
}

int decode_launch(int g, dim3 grid, int threads, cudaStream_t stream,
                  const uint16_t* freqs, const uint32_t* states,
                  const uint16_t* words, int S, int W, int n, int K,
                  uint8_t* out) {
#define ASR_RANS_DECODE(GG)                                              \
  rans_decode_kernel<GG><<<grid, threads, 0, stream>>>(freqs, states,    \
                                                       words, S, W, n, K, \
                                                       out)
  switch (g) {
    case 1: ASR_RANS_DECODE(1); break;
    case 2: ASR_RANS_DECODE(2); break;
    case 4: ASR_RANS_DECODE(4); break;
    case 8: ASR_RANS_DECODE(8); break;
    case 16: ASR_RANS_DECODE(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ASR_RANS_DECODE
  return 0;
}

int encode_launch(int g, int threads, cudaStream_t stream,
                  const uint8_t* data, const uint16_t* freqs, int n, int S,
                  int K, int pad_sym, int w_budget, uint16_t* scratch,
                  uint32_t* states, uint16_t* words, int* n_words) {
#define ASR_RANS_ENCODE(GG)                                             \
  rans_encode_kernel<GG><<<1, threads, 0, stream>>>(                    \
      data, freqs, n, S, K, pad_sym, w_budget, scratch, states, words,  \
      n_words)
  switch (g) {
    case 1: ASR_RANS_ENCODE(1); break;
    case 2: ASR_RANS_ENCODE(2); break;
    case 4: ASR_RANS_ENCODE(4); break;
    case 8: ASR_RANS_ENCODE(8); break;
    case 16: ASR_RANS_ENCODE(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ASR_RANS_ENCODE
  return 0;
}

}  // namespace

extern "C" {

// freqs [P, 256] u16, states [P, S] u32, words [P, W] u16 (W >= 1),
// out [P, n] u8; K = ceil(n / S); g lanes a thread, threads a CTA
// (ops/rans.py::lane_groups).
int rans_decode(const void* freqs, const void* states, const void* words,
                int P, int S, int W, int n, int K, int g, int threads,
                void* out, void* stream) {
  const int err = decode_launch(
      g, dim3(P), threads, (cudaStream_t)stream, (const uint16_t*)freqs,
      (const uint32_t*)states, (const uint16_t*)words, S, W, n, K,
      (uint8_t*)out);
  if (err) return err;
  return (int)cudaGetLastError();
}

// data [n] u8, freqs [256] u16 (the static table), scratch [K S] u16,
// states out [S] u32, words out [w_budget] u16, n_words out [1] i32.
int rans_encode(const void* data, const void* freqs, int n, int S, int K,
                int g, int threads, int pad_sym, int w_budget,
                void* scratch, void* states, void* words, void* n_words,
                void* stream) {
  const int err = encode_launch(
      g, threads, (cudaStream_t)stream, (const uint8_t*)data,
      (const uint16_t*)freqs, n, S, K, pad_sym, w_budget,
      (uint16_t*)scratch, (uint32_t*)states, (uint16_t*)words,
      (int*)n_words);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
