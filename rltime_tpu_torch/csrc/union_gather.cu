// Fused frame-stack union gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// rltime_tpu/ops/pallas_gather.py:fused_union_gather, together with the
// split_union slicing and the done-mask frame validity that follow it in
// rltime_tpu/history/replay.py:frame_stack_union_gather.
//
// For sample b, c0 = (col[b] - lead) mod T is the first column of its
// union window of W = F + n ring rows. Union row j is
// storage[env[b], (c0 + j) mod T]. The two outputs are the frame stacks
//
//   out_t [b, i] = row i       if v_t [b, i] else 0      (i < F)
//   out_tn[b, i] = row n + i   if v_tn[b, i] else 0
//   v_t [b, i] = no done[env[b], (c0 + j) mod T]     for j in [i, F-1)
//   v_tn[b, i] = no done[env[b], (c0 + n + j) mod T] for j in [i, F-1)
//
// (a frame older than an episode end inside its stack is zeroed; the
// newest frame of a stack is always valid). The raw union gather is the
// same kernel with one output, no done ring, F = W, n = 0, lead = 0:
// out[b, w] = storage[env[b], (col0[b] + w) mod T]. storage is a
// contiguous (E, T, row_bytes) byte view of the replay ring (any dtype:
// the kernel copies bytes and writes zero bytes), done a contiguous
// (E, T) byte ring, the outputs contiguous (B, F, row_bytes) buffers the
// caller allocated.
//
// What bounds it: device-memory bytes. It does no arithmetic. At config
// #2 (B=256, F=4, n=3, 84x84 uint8 rows of 7,056 bytes) the fused call
// reads each of the 7 union rows once (12.64 MB) and writes 8 stack rows
// (14.45 MB), computed from the shapes; rows n..F-1 of the union go to
// both stacks, read from device memory once and written twice. The whole
// call lasts under ten microseconds, of which the launch ramp and the
// dependent round trips (the sample's indices, then its rows) are a
// third, so what decides beside the bytes is how soon every load of the
// call is in flight.
//
// Design. One block owns one union row of one sample (1,792 blocks of
// 256 threads at config #2, a sample's rows in neighbouring blocks;
// fewer warps for rows under 8 KB).
// Every thread reads env[b] and col[b], wraps the column with 32-bit
// arithmetic, and issues its (at most two) 16-byte loads of the row at
// once, before anything waits: a 7,056-byte row is 441 vectors, so one
// round of loads covers it and no thread loops. Only then does each
// warp read the window's W-1 done bytes, one per lane, gathered by a
// ballot: the row loads and the done loads come back in one round trip,
// not two. The row is loaded before its validity is known; a row that a
// done flag cuts off from its stack's newest frame is stored as zeros.
// A row goes to slot j of out_t (j < F) and to slot j - n of out_tn
// (j >= n). Rows or bases that are not multiples of 16 bytes (5x7 uint8
// rows) are copied by bytes in the same kernel.
//
// What was tried and measured on one NVIDIA H100 80GB HBM3 at 700.00 W
// (chip_smoke.py phase 2, torch.profiler device time, medians over fresh
// index sets; PERF.md section 6 has the runs):
//   * this kernel: raw B=256, W=7, 84x84 uint8 0.0085 ms beside
//     index_select 0.0084-0.0085 ms and a bound of 0.00755 ms; fused
//     0.0091-0.0094 ms beside a bound of 0.00808 ms and 0.084-0.086 ms
//     for the composition it replaced (index_select, the validity
//     chain, two multiplies);
//   * Hopper's bulk asynchronous copy (cp.async.bulk global -> shared on
//     a per-row mbarrier, then shared -> global, one CTA per sample;
//     not kept): fused 0.0108-0.0110 ms. A row has to arrive whole
//     before its store can start, and with one or two CTAs on an SM
//     nothing overlaps that wait;
//   * the previous kernel (one 128-thread block per row, a loop of
//     single loads, two int64 divisions first): raw 0.0095-0.0096 ms.
// One sample per CTA with threads copying (a warp per row, or the
// window flat over 512 threads with 8 loads in flight each) fell
// between the two.
//
// Offsets are int64: E * T * row_bytes is 1.85e9 bytes at config #2's
// ring shape, one step from int32 overflow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // at most; fewer for rows under 8 KB
constexpr int kUnroll = 2;     // 16-byte loads in flight per thread
constexpr int64_t kMaxBlocks = 2147483647;  // gridDim.x

struct Params {
  uint8_t* out_t;          // (B, F, row_bytes)
  uint8_t* out_tn;         // (B, F, row_bytes), or null: one output
  const uint8_t* storage;  // (E, T, row_bytes)
  const uint8_t* done;     // (E, T) bytes, or null: every row valid
  const int32_t* env;      // (B,)
  const int32_t* col;      // (B,)
  int64_t row_bytes;
  int32_t T;
  int32_t F;
  int32_t n;
  int32_t lead;            // already wrapped to [0, T)
  int32_t vec;             // rows and bases are multiples of 16 bytes
};

__global__ void __launch_bounds__(kThreads)
union_gather_kernel(const __grid_constant__ Params p) {
  const int F = p.F;
  const int n = p.n;
  const int W = F + n;
  const int T = p.T;
  const int64_t row = p.row_bytes;
  // union row j of sample b; a sample's rows are neighbouring blocks
  const int64_t b = blockIdx.x / W;
  const int j = blockIdx.x % W;
  const int64_t e = p.env[b];
  int c0 = p.col[b] % T - p.lead;  // in (-2T, T): C's % keeps the sign
  if (c0 < 0) c0 += T;
  if (c0 < 0) c0 += T;
  const int c = (c0 + j) % T;
  const uint8_t* src = p.storage + (e * T + c) * row;
  // slot j of out_t and slot i = j - n of out_tn hold this row
  const int i = j - n;
  const bool to_t = j < F;
  const bool to_tn = p.out_tn != nullptr && i >= 0;
  uint8_t* dst_t = p.out_t + (b * F + j) * row;
  uint8_t* dst_tn = p.out_tn + (b * F + i) * row;

  // The first loads of the row go out before anything waits for the
  // done flags: both come back in one round trip.
  const int64_t n16 = p.vec ? row >> 4 : 0;
  const int4* src4 = reinterpret_cast<const int4*>(src);
  int4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t o = u * blockDim.x + threadIdx.x;
    if (o < n16) v[u] = __ldg(src4 + o);
  }

  // The window's done flags, one per lane: bit k = done above union row
  // k (the host keeps W - 1 <= 31 where there is a done ring). A row is
  // kept iff no flag lies between it and its stack's newest row.
  bool ok_t = true;
  bool ok_tn = true;
  if (p.done != nullptr) {
    const int lane = threadIdx.x & 31;
    uint8_t d = 0;
    if (lane < W - 1) d = p.done[e * T + (c0 + lane) % T];
    const uint32_t dones = __ballot_sync(0xffffffffu, d != 0);
    const uint32_t stack_bits = (1u << (F - 1)) - 1u;
    ok_t = (dones & stack_bits & ~((1u << j) - 1u)) == 0;
    ok_tn = to_tn && ((dones >> n) & stack_bits & ~((1u << i) - 1u)) == 0;
  }

  const int4 zero4 = make_int4(0, 0, 0, 0);
  int4* dst_t4 = reinterpret_cast<int4*>(dst_t);
  int4* dst_tn4 = reinterpret_cast<int4*>(dst_tn);
  for (int64_t base = 0; base < n16; base += kUnroll * blockDim.x) {
    if (base > 0) {  // rows above 8 KB: further rounds of loads
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t o = base + u * blockDim.x + threadIdx.x;
        if (o < n16) v[u] = __ldg(src4 + o);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t o = base + u * blockDim.x + threadIdx.x;
      if (o < n16) {
        if (to_t) dst_t4[o] = ok_t ? v[u] : zero4;
        if (to_tn) dst_tn4[o] = ok_tn ? v[u] : zero4;
      }
    }
  }
  // rows or bases off the 16-byte grid: the whole row by bytes
  for (int64_t o = (n16 << 4) + threadIdx.x; o < row; o += blockDim.x) {
    const uint8_t x = src[o];
    if (to_t) dst_t[o] = ok_t ? x : 0;
    if (to_tn) dst_tn[o] = ok_tn ? x : 0;
  }
}

}  // namespace

// Launches on `stream` and returns the CUDA error (0 on success).
// out_tn and done may be null (the raw union gather: one output, every
// row valid). The caller guarantees B, F, row_bytes > 0, n >= 0,
// 0 < T < 2^31, env[b] in [0, E) and pointers to device memory of the
// sizes above. Returns cudaErrorInvalidValue where B * (F + n) exceeds
// the grid's 2^31 - 1 blocks, or F + n exceeds the 32 done flags of one
// ballot where done is given.
extern "C" int union_stack_gather(void* out_t, void* out_tn,
                                  const void* storage, const void* done,
                                  const void* env, const void* col, int64_t B,
                                  int64_t F, int64_t n, int64_t lead,
                                  int64_t T, int64_t row_bytes,
                                  void* stream) {
  if (B * (F + n) > kMaxBlocks || (done != nullptr && F + n > 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.out_t = static_cast<uint8_t*>(out_t);
  p.out_tn = static_cast<uint8_t*>(out_tn);
  p.storage = static_cast<const uint8_t*>(storage);
  p.done = static_cast<const uint8_t*>(done);
  p.env = static_cast<const int32_t*>(env);
  p.col = static_cast<const int32_t*>(col);
  p.row_bytes = row_bytes;
  p.T = static_cast<int32_t>(T);
  p.F = static_cast<int32_t>(F);
  p.n = static_cast<int32_t>(n);
  p.lead = static_cast<int32_t>(((lead % T) + T) % T);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(out_t) |
                          reinterpret_cast<uintptr_t>(out_tn) |
                          reinterpret_cast<uintptr_t>(storage);
  p.vec = ((bases | static_cast<uintptr_t>(row_bytes)) & 15) == 0;
  // enough warps to cover the row in one round of loads (or, by bytes,
  // in a few), a block of 256 threads at most
  const int64_t per_thread = p.vec ? 16 * kUnroll : 4;
  int64_t warps = (row_bytes + 32 * per_thread - 1) / (32 * per_thread);
  if (warps > kThreads / 32) warps = kThreads / 32;
  union_gather_kernel<<<static_cast<unsigned int>(B * (F + n)),
                              static_cast<unsigned int>(32 * warps), 0,
                              static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
