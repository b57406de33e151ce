// Replay window gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// rltime_tpu/ops/pallas_gather.py:window_gather.
//
//   out[b, w, :] = storage[env[b], (col[b] + w) mod T, :]
//
// for b < B, w < window <= T. storage is a contiguous (E, T, row_bytes)
// byte view of a replay ring field (any dtype: the kernel copies
// bytes); out is a contiguous (B, window, row_bytes) buffer the caller
// allocated. col may be negative (the R2D2 learner gathers from
// col - 1 and col - (F-1)) and is wrapped to [0, T) here.
//
// What it is: because the ring is time-minor inside an env, one
// sample's window is ONE contiguous byte span of window * row_bytes in
// env e's ring, or two when it crosses the seam at T: [c0, T) and then
// [0, window - (T - c0)). The TPU kernel issued one DMA per span.
//
// What bounds it: device-memory bytes. It does no arithmetic; it reads
// B * window * row_bytes bytes and writes as many. At the R2D2 learner's
// frame shape (B=64, window=128, 84x84 uint8 rows) a sample's span is
// 903,168 B and one gather moves 57.8 MB each way, computed from the
// shapes. With only 64 samples, one block per sample would fill 64 of
// the card's 132 SMs, so the grid is 2-D: (chunks of kChunk bytes of a
// sample's span, B). Each block copies its chunk with coalesced 16-byte
// loads and stores where the source and destination share their
// alignment mod 16 (frame rows are 7,056 = 16 * 441 bytes, so frame
// spans are vector copies end to end), 4-byte words where they share it
// mod 4 (a 4-byte strip from a column c % 4 != 0), bytes otherwise; a
// byte head and tail fill the unaligned ends. A chunk that straddles the
// seam is copied as two pieces. Offsets are int64: the R2D2 obs ring is
// 1.85e9 bytes and each rnn ring 0.54e9.
//
// Blocks are independent and nothing carries between them; each block
// reads its own env[b] and col[b] (the TPU kernel's scalar prefetch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 16384;     // bytes of one sample's span per block
constexpr int64_t kMaxChunks = 1 << 20;
constexpr int64_t kMaxSamples = 65535;  // gridDim.y limit

template <typename V>
__device__ __forceinline__ void copy_words(uint8_t* __restrict__ dst,
                                           const uint8_t* __restrict__ src,
                                           int64_t n) {
  // dst and src agree mod sizeof(V): bytes up to dst's V boundary,
  // then whole words, then a byte tail.
  constexpr int64_t kV = sizeof(V);
  int64_t head = (kV - static_cast<int64_t>(
                           reinterpret_cast<uintptr_t>(dst) % kV)) % kV;
  if (head > n) head = n;
  for (int64_t i = threadIdx.x; i < head; i += kThreads) dst[i] = src[i];
  dst += head;
  src += head;
  n -= head;
  const int64_t nw = n / kV;
  V* d = reinterpret_cast<V*>(dst);
  const V* s = reinterpret_cast<const V*>(src);
  for (int64_t i = threadIdx.x; i < nw; i += kThreads) d[i] = s[i];
  for (int64_t i = nw * kV + threadIdx.x; i < n; i += kThreads) {
    dst[i] = src[i];
  }
}

__device__ __forceinline__ void copy_bytes(uint8_t* __restrict__ dst,
                                           const uint8_t* __restrict__ src,
                                           int64_t n) {
  if (n <= 0) return;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(dst) ^
                        reinterpret_cast<uintptr_t>(src);
  if ((mis & 15) == 0) {
    copy_words<int4>(dst, src, n);
  } else if ((mis & 3) == 0) {
    copy_words<uint32_t>(dst, src, n);
  } else {
    for (int64_t i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kThreads)
window_gather_kernel(uint8_t* __restrict__ out,
                     const uint8_t* __restrict__ storage,
                     const int32_t* __restrict__ env,
                     const int32_t* __restrict__ col, int64_t B,
                     int64_t window, int64_t T, int64_t row_bytes) {
  const int64_t span = window * row_bytes;       // bytes per sample
  const int64_t chunks = (span + kChunk - 1) / kChunk;
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    const int64_t e = env[b];
    int64_t c0 = static_cast<int64_t>(col[b]) % T;
    if (c0 < 0) c0 += T;  // C's % keeps the dividend's sign
    const int64_t n_first = (T - c0 < window ? T - c0 : window) * row_bytes;
    const uint8_t* ring = storage + e * T * row_bytes;
    const uint8_t* src1 = ring + c0 * row_bytes;   // [c0, c0 + n_first)
    uint8_t* dst = out + b * span;
    for (int64_t k = blockIdx.x; k < chunks; k += gridDim.x) {
      const int64_t lo = k * kChunk;
      const int64_t hi = lo + kChunk < span ? lo + kChunk : span;
      // piece before the seam: output bytes [lo, min(hi, n_first))
      if (lo < n_first) {
        const int64_t end = hi < n_first ? hi : n_first;
        copy_bytes(dst + lo, src1 + lo, end - lo);
      }
      // piece after the seam: output bytes [max(lo, n_first), hi) come
      // from the ring start
      if (hi > n_first) {
        const int64_t start = lo > n_first ? lo : n_first;
        copy_bytes(dst + start, ring + (start - n_first), hi - start);
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller guarantees B > 0, 0 < window <= T, row_bytes > 0,
// env[b] in [0, E) and pointers to device memory of the sizes above.
extern "C" int window_gather(void* out, const void* storage, const void* env,
                             const void* col, int64_t B, int64_t window,
                             int64_t T, int64_t row_bytes, void* stream) {
  const int64_t chunks = (window * row_bytes + kChunk - 1) / kChunk;
  const dim3 grid(static_cast<unsigned int>(chunks < kMaxChunks ? chunks
                                                                : kMaxChunks),
                  static_cast<unsigned int>(B < kMaxSamples ? B
                                                            : kMaxSamples));
  window_gather_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), static_cast<const uint8_t*>(storage),
      static_cast<const int32_t*>(env), static_cast<const int32_t*>(col), B,
      window, T, row_bytes);
  return static_cast<int>(cudaGetLastError());
}
