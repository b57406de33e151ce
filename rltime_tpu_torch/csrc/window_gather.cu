// Replay window gather for Hopper (sm_90a): every field of one learner
// update in one launch.
//
// Replaces the Pallas TPU kernel
// rltime_tpu/ops/pallas_gather.py:window_gather.
//
// A launch serves up to 8 segments that share the sampled (env, col).
// Segment s computes
//
//   out_s[b, w, :] = storage_s[env[b], (col[b] - lead_s + w) mod T_s, :]
//
// for b < B, w < window_s <= T_s. storage_s is a contiguous
// (E, T_s, row_bytes_s) byte view of a replay ring field (any dtype: the
// kernel copies bytes); out_s is a contiguous (B, window_s, row_bytes_s)
// buffer the caller allocated. col - lead may be negative (the R2D2
// learner gathers frames from col - (F-1) and done flags from col - D)
// and is wrapped to [0, T_s) here. The single window gather is the
// one-segment case.
//
// What it is: because the ring is time-minor inside an env, one
// sample's window is ONE contiguous byte span of window * row_bytes in
// env e's ring, or two when it crosses the seam at T: [c0, T) and then
// [0, window - (T - c0)). The TPU kernel issued one DMA per span.
//
// What bounds it: device-memory bytes at the frame shapes, the launch
// itself at the strips. It does no arithmetic; it reads
// B * window * row_bytes bytes per segment and writes as many. At the
// R2D2 learner's frame shape (B=64, window=128, 84x84 uint8 rows) a
// sample's span is 903,168 B and the segment moves 57.8 MB each way,
// computed from the shapes; its strips (125 rows of 1 or 4 bytes) move
// 8 to 32 KB, which the card moves in a hundredth of the time a launch
// takes. An update gathers 4 to 7 fields from the same (env, col), so
// what the design does about the launch floor is to pay it once: the
// segments travel by value in the kernel's parameters (no table is
// copied to the device, nothing waits on the host), and the 1-D grid
// runs over the work units of all segments laid end to end, so a block
// finds its segment by comparing blockIdx.x with at most 8 offsets.
// A work unit of a long span (frames) is one 16 KB chunk of one
// sample's span, a sample's chunks in neighbouring blocks: with only 64
// samples, one block per sample would fill 64 of the card's 132 SMs. A
// work unit of a short span (up to 2 KB: the strips, single columns,
// the stored carry) is 8 samples, one per warp, so that a strip of 256
// samples is 32 blocks and not 256 that each wait a round trip for
// their indices to move 3 bytes. Each block (or warp)
// copies its chunk with coalesced 16-byte loads and stores where the
// source and destination share their alignment mod 16 (frame rows are
// 7,056 = 16 * 441 bytes, so frame spans are vector copies end to end),
// 4-byte words where they share it mod 4 (a 4-byte strip from a column
// c % 4 != 0), bytes otherwise; a byte head and tail fill the unaligned
// ends. A chunk that straddles the seam is copied as two pieces. Offsets
// are int64: the R2D2 obs ring is 1.85e9 bytes and each rnn ring 0.54e9.
//
// Blocks are independent and nothing carries between them; each block
// reads its own env[b] and col[b] (the TPU kernel's scalar prefetch).
//
// Measured on one NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase
// 2, torch.profiler device time, medians over fresh index sets; PERF.md
// section 6 has the runs): the frame segment alone (B=64, window=128,
// 84x84 uint8) 0.0409-0.0421 ms beside a bound of 0.03451 ms and
// index_select at 0.0439-0.0445 ms; the config-#4 update's 7 segments
// (frames, done flags, three 125-row strips, two 2 KB carries) in one
// launch 0.0412-0.0425 ms beside 0.0633-0.0643 ms for a launch each;
// the strip sets of the other updates (4 to 7 segments) 0.0024-0.0038
// ms beside 0.0089-0.0189 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSegments = 8;
constexpr int64_t kChunk = 16384;     // bytes of one sample's span per block
constexpr int64_t kWarpSpan = 2048;   // spans up to this: a warp per sample
constexpr int64_t kMaxBlocks = 0x7fffffff;  // gridDim.x limit

}  // namespace

// One field of the launch; the caller fills an array of these (the
// layout is mirrored by ops/gather.py's ctypes structure).
struct WindowGatherSegment {
  void* out;            // (B, window, row_bytes)
  const void* storage;  // (E, T, row_bytes)
  int64_t row_bytes;
  int64_t T;
  int64_t window;
  int64_t lead;
};

namespace {

struct Params {
  WindowGatherSegment seg[kMaxSegments];
  uint32_t first_block[kMaxSegments];  // blockIdx.x of a segment's block 0
  uint32_t chunks[kMaxSegments];       // 16 KB chunks of a sample's span
  int32_t num;
};

// `count` threads, this one the `tid`-th, copy n bytes together.
template <typename V>
__device__ __forceinline__ void copy_words(uint8_t* __restrict__ dst,
                                           const uint8_t* __restrict__ src,
                                           int64_t n, int tid, int count) {
  // dst and src agree mod sizeof(V): bytes up to dst's V boundary,
  // then whole words, then a byte tail.
  constexpr int64_t kV = sizeof(V);
  int64_t head = (kV - static_cast<int64_t>(
                           reinterpret_cast<uintptr_t>(dst) % kV)) % kV;
  if (head > n) head = n;
  for (int64_t i = tid; i < head; i += count) dst[i] = src[i];
  dst += head;
  src += head;
  n -= head;
  const int64_t nw = n / kV;
  V* d = reinterpret_cast<V*>(dst);
  const V* s = reinterpret_cast<const V*>(src);
  for (int64_t i = tid; i < nw; i += count) d[i] = s[i];
  for (int64_t i = nw * kV + tid; i < n; i += count) dst[i] = src[i];
}

__device__ __forceinline__ void copy_bytes(uint8_t* __restrict__ dst,
                                           const uint8_t* __restrict__ src,
                                           int64_t n, int tid, int count) {
  if (n <= 0) return;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(dst) ^
                        reinterpret_cast<uintptr_t>(src);
  if ((mis & 15) == 0) {
    copy_words<int4>(dst, src, n, tid, count);
  } else if ((mis & 3) == 0) {
    copy_words<uint32_t>(dst, src, n, tid, count);
  } else {
    for (int64_t i = tid; i < n; i += count) dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const __grid_constant__ Params p,
                     const int32_t* __restrict__ env,
                     const int32_t* __restrict__ col, int64_t B) {
  int s = 0;
#pragma unroll
  for (int i = 1; i < kMaxSegments; ++i) {
    if (i < p.num && blockIdx.x >= p.first_block[i]) s = i;
  }
  const WindowGatherSegment& g = p.seg[s];
  const int64_t T = g.T;
  const int64_t row_bytes = g.row_bytes;
  const int64_t window = g.window;
  const uint8_t* storage = static_cast<const uint8_t*>(g.storage);
  const int64_t span = window * row_bytes;       // bytes per sample
  const uint32_t unit = blockIdx.x - p.first_block[s];
  // Long spans: the block copies chunk `unit % chunks` of sample
  // `unit / chunks`. Short spans: warp w copies all of sample
  // `unit * kWarps + w`.
  const bool by_warp = span <= kWarpSpan;
  const int64_t b = by_warp ? static_cast<int64_t>(unit) * kWarps +
                                  (threadIdx.x >> 5)
                            : unit / p.chunks[s];
  if (b >= B) return;
  const int tid = by_warp ? threadIdx.x & 31 : threadIdx.x;
  const int count = by_warp ? 32 : kThreads;
  // output bytes [lo, hi) of the sample's span
  const int64_t lo = by_warp ? 0 : (unit % p.chunks[s]) * kChunk;
  const int64_t hi = lo + kChunk < span ? lo + kChunk : span;
  const int64_t e = env[b];
  int64_t c0 = (static_cast<int64_t>(col[b]) - g.lead) % T;
  if (c0 < 0) c0 += T;  // C's % keeps the dividend's sign
  const int64_t n_first = (T - c0 < window ? T - c0 : window) * row_bytes;
  const uint8_t* ring = storage + e * T * row_bytes;
  const uint8_t* src1 = ring + c0 * row_bytes;   // [c0, c0 + n_first)
  uint8_t* dst = static_cast<uint8_t*>(g.out) + b * span;
  // piece before the seam: output bytes [lo, min(hi, n_first))
  if (lo < n_first) {
    const int64_t end = hi < n_first ? hi : n_first;
    copy_bytes(dst + lo, src1 + lo, end - lo, tid, count);
  }
  // piece after the seam: output bytes [max(lo, n_first), hi) come
  // from the ring start
  if (hi > n_first) {
    const int64_t start = lo > n_first ? lo : n_first;
    copy_bytes(dst + start, ring + (start - n_first), hi - start, tid, count);
  }
}

}  // namespace

// Launches on `stream` and returns the CUDA error (0 on success).
// `segments` points to `num` (1..8) host structs. The caller guarantees
// B > 0, 0 < window <= T, row_bytes > 0 for every segment, env[b] in
// [0, E) of every ring, and pointers to device memory of the sizes
// above.
extern "C" int window_gather_multi(const WindowGatherSegment* segments,
                                   int64_t num, const void* env,
                                   const void* col, int64_t B, void* stream) {
  if (num < 1 || num > kMaxSegments) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  int64_t blocks = 0;
  for (int64_t s = 0; s < kMaxSegments; ++s) {
    p.seg[s] = segments[s < num ? s : 0];
    p.first_block[s] = static_cast<uint32_t>(blocks);
    const int64_t span = p.seg[s].window * p.seg[s].row_bytes;
    const int64_t chunks = (span + kChunk - 1) / kChunk;
    p.chunks[s] = static_cast<uint32_t>(chunks);
    if (s < num) {
      blocks += span <= kWarpSpan ? (B + kWarps - 1) / kWarps : chunks * B;
      if (chunks > kMaxBlocks || blocks > kMaxBlocks) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
  }
  p.num = static_cast<int32_t>(num);
  const unsigned int grid = static_cast<unsigned int>(blocks);
  window_gather_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int32_t*>(env), static_cast<const int32_t*>(col),
      B);
  return static_cast<int>(cudaGetLastError());
}
