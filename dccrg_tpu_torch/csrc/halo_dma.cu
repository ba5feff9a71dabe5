// The halo's ring-step payload copy, behind a plain C interface (the
// launcher returns the launch's cudaError_t).
//
//   ring_copy  <- ring_copy / ring_dma_start  (dccrg_tpu/parallel/halo_dma.py)
//
// On the TPU each ring distance k is one kernel issuing an asynchronous
// remote DMA of a device's packed [S_k, ...] payload to device (d + k) % D.
// Here the D device slots are the leading axis of one tensor on one card,
// so the remote copy becomes an in-device gather: for every ring distance,
// every receiving slot d and every i < S_k,
//
//   payload_k[d, i, ...] = x[(d - k) % D, send_k[(d - k) % D, i], ...]
//
// One launch covers every ring distance of one field: the caller passes the
// concatenated table of flat source rows ((d - k) % D) * R + send row,
// k-major, then d, then i, and cuts the output at the per-k offsets.  The
// kernel moves bits and does no arithmetic, so it equals its plain PyTorch
// twin (parallel/halo_dma.py::ring_copy_plain) bitwise for every dtype.
//
// Design: a thread per word of the output, each row copied as a run of
// 16-, 8-, 4-, 2- or 1-byte words (the widest that divides the row's bytes
// and both base pointers' alignment), neighbouring threads on neighbouring
// words of a row, so a wide row (a Vlasov f block of 2 KiB) is read and
// written in coalesced 16-byte transactions and a narrow one (a scalar
// field, 4 bytes a row; a uint8 flag, 1 byte) one word a thread.  The index
// table is read once a word through the read-only path.
//
// Bound on this card: device-memory bytes (rows read once, written once,
// plus the 4-byte index a row), with no arithmetic.  A halo payload is
// small (a few thousand rows), so in practice one launch's fixed cost
// dominates: the kernel is launch-bound, not bandwidth-bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRingThreads = 256;
constexpr long long kRingMaxBlocks = 4096;

template <typename W>
__global__ void __launch_bounds__(kRingThreads)
ring_copy_kernel(const W* __restrict__ src, W* __restrict__ dst,
                 const int32_t* __restrict__ index, int rows, int words) {
  // 32-bit output index: the launcher refuses payloads of 2^31 words
  const int n = rows * words;
  const int stride = gridDim.x * blockDim.x;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n; t += stride) {
    const int r = t / words;
    const int c = t - r * words;
    dst[t] = src[(long long)__ldg(index + r) * words + c];
  }
}

template <typename W>
cudaError_t launch(const void* src, void* dst, const int32_t* index, int rows,
                   int row_bytes, cudaStream_t stream) {
  const int words = row_bytes / (int)sizeof(W);
  const long long n = (long long)rows * words;
  // 32-bit output index in the kernel
  if (n >= (1LL << 31)) return cudaErrorInvalidValue;
  long long blocks = (n + kRingThreads - 1) / kRingThreads;
  if (blocks > kRingMaxBlocks) blocks = kRingMaxBlocks;
  ring_copy_kernel<W><<<(unsigned)blocks, kRingThreads, 0, stream>>>(
      static_cast<const W*>(src), static_cast<W*>(dst), index, rows, words);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// src: the field [D, R, ...] (n_src_rows = D * R rows of row_bytes bytes);
// dst: the payload [rows, ...]; index: rows int32 flat source rows, each in
// [0, n_src_rows) (the halo schedule builds them so; reading them back to
// check would sync the stream).  Any element type: row_bytes is any
// positive byte count; rows * row_bytes / word must be below 2^31, word the
// width the alignment picks.
int ring_copy(const void* src, void* dst, const int32_t* index, int rows,
              int row_bytes, void* stream) {
  if (rows < 1 || row_bytes < 1) return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)src | (uintptr_t)dst | (uintptr_t)row_bytes;
  cudaStream_t s = (cudaStream_t)stream;
  if (align % 16 == 0) return (int)launch<uint4>(src, dst, index, rows, row_bytes, s);
  if (align % 8 == 0) return (int)launch<uint2>(src, dst, index, rows, row_bytes, s);
  if (align % 4 == 0) return (int)launch<uint32_t>(src, dst, index, rows, row_bytes, s);
  if (align % 2 == 0) return (int)launch<uint16_t>(src, dst, index, rows, row_bytes, s);
  return (int)launch<uint8_t>(src, dst, index, rows, row_bytes, s);
}

}  // extern "C"
