// The ring transport's receive arenas and cross-process events, behind a
// plain C interface (each function returns its cudaError_t).
//
//   the arena  <- the remote DMA target of ring_copy / make_async_remote_copy
//                 (dccrg_tpu/parallel/halo_dma.py) and its DMA semaphores
//
// On the TPU, kernel B9 writes a ring step's packed payload straight into
// the receiving chip's buffer and both sides wait on DMA semaphores.  Between
// the port's controllers (processes sharing a card, or one card each on one
// node) the same shape is: each controller owns a receive arena in device
// memory that its peers map through CUDA IPC, B9's pack writes every peer's
// rows into that peer's arena (parallel/halo_dma.py::ring_put), and
// interprocess events order the writes and reads; the small tokens that
// say which generation an event stands for travel between the processes on
// the host (parallel/ipc.py).
//
// The arena is a cudaMalloc of its own, never the caching allocator's: a
// handle of a pooled block would name its whole segment.  Peers open it with
// cudaIpcMemLazyEnablePeerAccess, so a controller on another card of the
// node maps it over peer access.  No kernel lives here: the writes are B9's
// (csrc/halo_dma.cu) or a device-to-device copy.

#include <cuda_runtime.h>
#include <string.h>

extern "C" {

// Bytes of a memory or event handle (cudaIpcMemHandle_t, cudaIpcEventHandle_t).
int ipc_handle_bytes(void) {
  return (int)(sizeof(cudaIpcMemHandle_t) > sizeof(cudaIpcEventHandle_t)
                   ? sizeof(cudaIpcMemHandle_t) : sizeof(cudaIpcEventHandle_t));
}

// A zeroed arena of nbytes on card dev and its handle (ipc_handle_bytes).
int ipc_alloc(int dev, long long nbytes, void** ptr, void* handle) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  *ptr = nullptr;
  e = cudaMalloc(ptr, (size_t)nbytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemset(*ptr, 0, (size_t)nbytes);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  e = cudaIpcGetMemHandle(&h, *ptr);
  if (e != cudaSuccess) return (int)e;
  memcpy(handle, &h, sizeof(h));
  return (int)cudaSuccess;
}

int ipc_free(int dev, void* ptr) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFree(ptr);
}

// Maps a peer's arena on card dev (peer access where it lies on another card).
int ipc_open(int dev, const void* handle, void** ptr) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  *ptr = nullptr;
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int ipc_close(int dev, void* ptr) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaIpcCloseMemHandle(ptr);
}

// An interprocess event (no timing) on card dev and its handle.
int ipc_event_create(int dev, void** ev, void* handle) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaEvent_t x;
  e = cudaEventCreateWithFlags(&x, cudaEventInterprocess | cudaEventDisableTiming);
  if (e != cudaSuccess) return (int)e;
  cudaIpcEventHandle_t h;
  e = cudaIpcGetEventHandle(&h, x);
  if (e != cudaSuccess) {
    cudaEventDestroy(x);
    return (int)e;
  }
  memcpy(handle, &h, sizeof(h));
  *ev = (void*)x;
  return (int)cudaSuccess;
}

// A peer's interprocess event, opened on card dev.
int ipc_event_open(int dev, const void* handle, void** ev) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaIpcEventHandle_t h;
  memcpy(&h, handle, sizeof(h));
  cudaEvent_t x;
  e = cudaIpcOpenEventHandle(&x, h);
  if (e != cudaSuccess) return (int)e;
  *ev = (void*)x;
  return (int)cudaSuccess;
}

int ipc_event_destroy(int dev, void* ev) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaEventDestroy((cudaEvent_t)ev);
}

// Records ev on stream (the work queued there so far).
int ipc_record(void* ev, void* stream) {
  return (int)cudaEventRecord((cudaEvent_t)ev, (cudaStream_t)stream);
}

// Makes stream wait for ev's last record (own or a peer's).
int ipc_wait(void* ev, void* stream) {
  return (int)cudaStreamWaitEvent((cudaStream_t)stream, (cudaEvent_t)ev, 0);
}

// Blocks the calling thread until ev's last record (own or a peer's) has
// completed on the card.
int ipc_event_sync(void* ev) {
  return (int)cudaEventSynchronize((cudaEvent_t)ev);
}

// Waits for all work on card dev: an arena grows or is freed only after its
// writers and readers are done.
int ipc_sync(int dev) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}

}  // extern "C"
