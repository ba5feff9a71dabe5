// Whole-run Game of Life on one float32 0/1 board, behind a plain C
// interface (the launcher returns the launch's cudaError_t).
//
//   gol_run  <- make_gol_run  (dccrg_tpu/ops/gol_kernel.py)
//
// One cooperative launch runs every turn: each turn reads the source board
// and writes the other one (ping-pong out / scr), with a grid-wide barrier
// between turns; an odd turn count ends with the copy scr -> out.  Only the
// last turn writes its neighbour counts (the count output is the last
// turn's); turns == 0 returns the input and zero counts.
//
// The count is the TPU kernel's, op for op and in its order, so the result
// equals the plain PyTorch twin (ops/gol_kernel.py::gol_run_plain) bitwise
// for any float input, not only 0/1:
//   up = a[y+1] * vyh,  dn = a[y-1] * vyl,  c = up + dn,
//   then for band in (up, a, dn): c += band[x+1] * vxh; c += band[x-1] * vxl
//   new = c == 3 ? 1 : (c != 2 ? 0 : a)
// where a validity mask is 1 on a periodic axis and 0 where the neighbour
// would wrap across an open one.  Every product and sum goes through
// __fmul_rn / __fadd_rn (the build also passes -fmad=false).
//
// Bound on this card: the compulsory bytes are one board in and the board
// and counts out (12 bytes a cell: 3 MB at 500x500), and the Game of Life
// needs ~10 operations a cell a turn (7 adds, 2 compares, a select; this
// kernel does 21 in the TPU kernel's form), so the operation count bounds a
// long run (0.75 ms for 20000 turns at 500x500 over 67 TFLOP/s).  What a
// turn really pays is the grid barrier:
// the board (1 MB, f32) stays in L2 and each SM updates ~1900 cells a turn,
// a fraction of a microsecond of work.  The design therefore launches one
// 1024-thread block per SM (at most), which keeps the barrier's arrival
// count at its least; the redesign — the bit-packed board (31 KB) in one
// SM's shared memory, no grid barrier at all — is queued (ROADMAP P7).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

constexpr int kGolThreads = 1024;

__global__ void __launch_bounds__(kGolThreads)
gol_run_kernel(const float* __restrict__ alive, float* out, float* __restrict__ cnt,
               float* scr, int ny, int nx, int turns, int px, int py) {
  cg::grid_group grid = cg::this_grid();
  // 32-bit index arithmetic: the launcher refuses boards of 2^31 cells
  const int N = ny * nx;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;

  for (int c = first; c < N; c += stride) {
    out[c] = alive[c];
    if (turns == 0) cnt[c] = 0.f;
  }
  grid.sync();

  for (int i = 0; i < turns; ++i) {
    const float* src = (i & 1) ? scr : out;
    float* dst = (i & 1) ? out : scr;
    const bool last = i == turns - 1;
    for (int c = first; c < N; c += stride) {
      const int y = c / nx;
      const int x = c - y * nx;
      const int xp = x + 1 == nx ? 0 : x + 1;
      const int xm = x == 0 ? nx - 1 : x - 1;
      const int rc = y * nx;
      const int rp = (y + 1 == ny ? 0 : y + 1) * nx;
      const int rm = (y == 0 ? ny - 1 : y - 1) * nx;
      const float vxh = (px || x != nx - 1) ? 1.f : 0.f;
      const float vxl = (px || x != 0) ? 1.f : 0.f;
      const float vyh = (py || y != ny - 1) ? 1.f : 0.f;
      const float vyl = (py || y != 0) ? 1.f : 0.f;
      const float a = src[rc + x];
      float k = add(mul(src[rp + x], vyh), mul(src[rm + x], vyl));
      // band y+1, band y, band y-1: the x+1 then the x-1 neighbour
      k = add(k, mul(mul(src[rp + xp], vyh), vxh));
      k = add(k, mul(mul(src[rp + xm], vyh), vxl));
      k = add(k, mul(src[rc + xp], vxh));
      k = add(k, mul(src[rc + xm], vxl));
      k = add(k, mul(mul(src[rm + xp], vyl), vxh));
      k = add(k, mul(mul(src[rm + xm], vyl), vxl));
      dst[c] = k == 3.f ? 1.f : (k != 2.f ? 0.f : a);
      if (last) cnt[c] = k;
    }
    grid.sync();
  }

  if (turns & 1) {
    for (int c = first; c < N; c += stride) out[c] = scr[c];
  }
}

}  // namespace

extern "C" {

// alive, out, cnt, scr: ny*nx floats each (scr is scratch, allocated by the
// caller).  The grid is at most one block per SM and never more blocks than
// can be co-resident; a refused cooperative launch returns its error and
// runs nothing.
int gol_run(const float* alive, float* out, float* cnt, float* scr, int ny,
            int nx, int turns, int px, int py, void* stream) {
  if (ny < 1 || nx < 1 || turns < 0 || (long long)ny * nx >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gol_run_kernel,
                                                        kGolThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long N = (long long)ny * nx;
  long long blocks = (N + kGolThreads - 1) / kGolThreads;
  if (blocks > sms) blocks = sms;
  void* args[] = {&alive, &out, &cnt, &scr, &ny, &nx, &turns, &px, &py};
  err = cudaLaunchCooperativeKernel((const void*)gol_run_kernel,
                                    dim3((unsigned)blocks), dim3(kGolThreads),
                                    args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
