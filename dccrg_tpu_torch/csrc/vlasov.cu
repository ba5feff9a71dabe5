// One dimension-split upwind Vlasov step on the dense phase-space layout,
// behind a plain C interface (the launcher returns the launch's
// cudaError_t).
//
//   vlasov_step  <- make_vlasov_step_blocked  (dccrg_tpu/ops/vlasov_kernel.py)
//
// f is [D, nzl, ny, nx, B] float32 (B = nv^3 velocity bins, minor); the
// device-edge planes e_lo / e_hi are [D, 1, ny, nx, B] (the slab ring's
// received planes, zeroed by the caller on an open z boundary); vx, vy, vz
// are the per-bin velocities [B].  Each split is the XLA body's
//   flux_hi = (v >= 0 ? f : hi) * v,  flux_lo = (v >= 0 ? lo : f) * v
//   f' = f - s * (flux_hi - flux_lo),  s = dt * inv_d (rounded once, f32)
// applied x, then y (plane-local; on an open axis the wrapped neighbour is
// replaced by 0), then z, whose z-1 / z+1 values are the x-then-y split of
// the neighbouring planes — recomputed, never stored.  Every product and
// sum goes through __fmul_rn / __fsub_rn (the build also passes
// -fmad=false), so the kernel equals its plain PyTorch twin
// (ops/vlasov_kernel.py::vlasov_step_blocked_plain) bitwise.
//
// Design: a thread per (y, x, bin) column of one z block (block planes,
// the TPU kernel's tile), marching up in z with the xy-split values of
// planes z-1, z and z+1 in registers; each xy-split value is recomputed
// from f at y-1..y+1 and x-1..x+1 of its plane.  Neighbouring threads hold
// neighbouring bins, so every read is coalesced; the x and y neighbours of
// a plane are re-read through L1/L2.  D slab slots are one launch
// (blockIdx.z), z blocks blockIdx.y.
//
// Bound on this card: device-memory bytes.  f is read once and written
// once a step (8 bytes a phase-space cell, 134 MB at 32^3 x 512), against
// 15 flops a cell; at the bench's size f (64 MiB) exceeds the 50 MB L2, so
// each step streams from HBM.  The design reads f (1 + 2/block) times from
// HBM (the two halo planes of each z block) plus the x/y neighbour re-reads
// that L1/L2 catch.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float split(float f, float lo, float hi, float v,
                                       float s) {
  const bool pos = v >= 0.f;
  const float flux_hi = mul(pos ? f : hi, v);
  const float flux_lo = mul(pos ? lo : f, v);
  return sub(f, mul(s, sub(flux_hi, flux_lo)));
}

constexpr int kVlasovThreads = 256;

struct Column {
  int y, x, b, B, nx;
  int ym, yp, xm, xp;
  bool ylo, yhi, xlo, xhi;  // the neighbour exists (periodic or interior)
  float vx, vy, sx, sy;

  // x split of row yy of a plane at this column's x and bin
  __device__ __forceinline__ float xs(const float* plane, int yy) const {
    const float* row = plane + (long long)yy * nx * B;
    const float f = row[x * B + b];
    const float lo = xlo ? row[xm * B + b] : 0.f;
    const float hi = xhi ? row[xp * B + b] : 0.f;
    return split(f, lo, hi, vx, sx);
  }

  // x then y split of a plane at this column
  __device__ __forceinline__ float xy(const float* plane) const {
    const float f1 = xs(plane, y);
    const float lo = ylo ? xs(plane, ym) : 0.f;
    const float hi = yhi ? xs(plane, yp) : 0.f;
    return split(f1, lo, hi, vy, sy);
  }
};

__global__ void __launch_bounds__(kVlasovThreads)
vlasov_step_kernel(const float* __restrict__ f, const float* __restrict__ e_lo,
                   const float* __restrict__ e_hi, const float* __restrict__ vx,
                   const float* __restrict__ vy, const float* __restrict__ vz,
                   float* __restrict__ out, int nzl, int ny, int nx, int B,
                   int block, int px, int py, float sx, float sy, float sz) {
  const int PB = ny * nx * B;  // elements a plane (< 2^31, launcher-checked)
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= PB) return;
  const int d = blockIdx.z;
  const int z0 = blockIdx.y * block;
  const int z1 = z0 + block;

  Column c;
  c.B = B;
  c.nx = nx;
  c.b = idx % B;
  const int col = idx / B;
  c.x = col % nx;
  c.y = col / nx;
  c.xm = c.x == 0 ? nx - 1 : c.x - 1;
  c.xp = c.x + 1 == nx ? 0 : c.x + 1;
  c.ym = c.y == 0 ? ny - 1 : c.y - 1;
  c.yp = c.y + 1 == ny ? 0 : c.y + 1;
  c.xlo = px || c.x != 0;
  c.xhi = px || c.x != nx - 1;
  c.ylo = py || c.y != 0;
  c.yhi = py || c.y != ny - 1;
  c.vx = vx[c.b];
  c.vy = vy[c.b];
  c.sx = sx;
  c.sy = sy;
  const float v_z = vz[c.b];

  const float* F = f + (long long)d * nzl * PB;
  float* O = out + (long long)d * nzl * PB;
  auto plane = [&](int z) -> const float* {
    if (z < 0) return e_lo + (long long)d * PB;
    if (z >= nzl) return e_hi + (long long)d * PB;
    return F + (long long)z * PB;
  };

  float g_dn = c.xy(plane(z0 - 1));
  float g_c = c.xy(plane(z0));
  for (int z = z0; z < z1; ++z) {
    const float g_up = c.xy(plane(z + 1));
    O[(long long)z * PB + idx] = split(g_c, g_dn, g_up, v_z, sz);
    g_dn = g_c;
    g_c = g_up;
  }
}

}  // namespace

extern "C" {

// One step over D slab slots; `block` (the z-tile height) divides nzl.
// sx, sy, sz are dt * inv_dx per axis, rounded to float32 by the caller.
int vlasov_step(const float* f, const float* e_lo, const float* e_hi,
                const float* vx, const float* vy, const float* vz, float* out,
                int n_dev, int nzl, int ny, int nx, int B, int block, int px,
                int py, float sx, float sy, float sz, void* stream) {
  if (n_dev < 1 || n_dev > 65535 || nzl < 1 || ny < 1 || nx < 1 || B < 1 ||
      block < 1 || nzl % block != 0 || nzl / block > 65535 ||
      (long long)ny * nx * B >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long PB = (long long)ny * nx * B;
  const dim3 grid((unsigned)((PB + kVlasovThreads - 1) / kVlasovThreads),
                  (unsigned)(nzl / block), (unsigned)n_dev);
  vlasov_step_kernel<<<grid, kVlasovThreads, 0, (cudaStream_t)stream>>>(
      f, e_lo, e_hi, vx, vy, vz, out, nzl, ny, nx, B, block, px, py, sx, sy,
      sz);
  return (int)cudaGetLastError();
}

}  // extern "C"
