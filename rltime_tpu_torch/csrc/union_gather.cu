// Replay union-window gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// rltime_tpu/ops/pallas_gather.py:fused_union_gather.
//
//   out[b, w, :] = storage[env[b], (col0[b] + w) mod T, :]
//
// for b < B, w < window. storage is a contiguous (E, T, row_bytes) byte
// view of the replay ring (any dtype: the kernel copies bytes); out is
// a contiguous (B, window, row_bytes) byte buffer the caller allocated.
// col0 may be negative (the frame-stack lookback reaches behind the
// sampled column) and is wrapped to [0, T) here.
//
// What bounds it: device-memory bytes. It does no arithmetic; it reads
// B * window * row_bytes bytes and writes as many (at the config-#2
// learner shapes B=256, window=7, 84x84 uint8 rows, that is 12.6 MB each
// way per gather, computed from the shapes). The design for now is
// coalesced 16-byte loads and stores: one block per (b, w) row,
// consecutive threads on consecutive 16-byte vectors of the row. At 84x84 the row is 7056 = 16 * 441 bytes, so the
// vector path covers the whole row; a row whose byte count or base is
// not 16-byte aligned finishes with a scalar byte tail (or copies by
// bytes throughout when its base is misaligned).
//
// On the TPU the sample indices arrived by scalar prefetch; here each
// block reads its own env[b] and col0[b]. Blocks are independent and
// nothing carries between them. Offsets are int64: E * T * row_bytes is
// 1.85e9 bytes at config #2's ring shape, one step from int32 overflow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int64_t kMaxBlocks = 1 << 20;

__global__ void __launch_bounds__(kThreads)
union_gather_kernel(uint8_t* __restrict__ out,
                    const uint8_t* __restrict__ storage,
                    const int32_t* __restrict__ env,
                    const int32_t* __restrict__ col0,
                    int64_t num_rows, int64_t window, int64_t T,
                    int64_t row_bytes) {
  for (int64_t r = blockIdx.x; r < num_rows; r += gridDim.x) {
    const int64_t b = r / window;
    const int64_t w = r - b * window;
    const int64_t e = env[b];
    int64_t c = (static_cast<int64_t>(col0[b]) + w) % T;
    if (c < 0) c += T;  // C's % keeps the dividend's sign
    const uint8_t* src = storage + (e * T + c) * row_bytes;
    uint8_t* dst = out + r * row_bytes;

    int64_t done = 0;
    if (((reinterpret_cast<uintptr_t>(src) |
          reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
      const int64_t n16 = row_bytes >> 4;
      const int4* s4 = reinterpret_cast<const int4*>(src);
      int4* d4 = reinterpret_cast<int4*>(dst);
      for (int64_t i = threadIdx.x; i < n16; i += kThreads) {
        d4[i] = __ldg(s4 + i);
      }
      done = n16 << 4;
    }
    for (int64_t i = done + threadIdx.x; i < row_bytes; i += kThreads) {
      dst[i] = src[i];
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller guarantees B, window, T, row_bytes > 0, env[b] in [0, E)
// and pointers to device memory of the sizes above.
extern "C" int union_gather(void* out, const void* storage, const void* env,
                            const void* col0, int64_t B, int64_t window,
                            int64_t T, int64_t row_bytes, void* stream) {
  const int64_t num_rows = B * window;
  const int64_t blocks = num_rows < kMaxBlocks ? num_rows : kMaxBlocks;
  union_gather_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), static_cast<const uint8_t*>(storage),
      static_cast<const int32_t*>(env), static_cast<const int32_t*>(col0),
      num_rows, window, T, row_bytes);
  return static_cast<int>(cudaGetLastError());
}
