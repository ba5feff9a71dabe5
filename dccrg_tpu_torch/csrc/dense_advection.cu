// Dense 3-D upwind advection on a uniform z-slab layout: three kernels that
// replace the Pallas kernels of dccrg_tpu/ops/dense_advection.py, behind a
// plain C interface (each launcher returns the launch's cudaError_t).
//
//   dense_step_blocked  <- make_flux_update_blocked_direct  (one step)
//   dense_step_plane    <- make_flux_update                 (one step)
//   dense_fused_run     <- make_fused_run                   (a whole run)
//
// Arithmetic order is part of the contract: every product and sum goes
// through __fmul_rn/__fadd_rn/__fsub_rn (never contracted into an FMA, and
// the build passes -fmad=false as well), in the reference order
//   face flux  = where(vf >= 0, r_c, r_n) * ((dt * vf) * area) * mask,
//                vf = (v_c + v_n) * 0.5
//   cell flux  = z- + y- + x- - x+ - y+ - z+   (left to right)
//   new rho    = r + flux * inv_vol
// so each kernel equals its plain PyTorch twin (ops/dense_advection.py)
// bitwise.  The fused run folds the face mask into a hoisted weight,
// ((dt * vf) * area) * mask, exactly as make_fused_run does.
//
// Periodic wraps are explicit index arithmetic ((i+1) % n, (i-1+n) % n),
// matching jnp.roll(x, -1) / jnp.roll(x, 1); non-periodic faces carry a
// zero mask.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// flux through the face between cell c and its + neighbor n along one axis
__device__ __forceinline__ float face_flux(float r_c, float r_n, float v_c,
                                           float v_n, float dt, float area,
                                           float mask) {
  const float vf = mul(add(v_c, v_n), 0.5f);
  const float up = vf >= 0.f ? r_c : r_n;
  return mul(mul(up, mul(mul(dt, vf), area)), mask);
}

constexpr int kStepThreads = 256;
constexpr int kFusedThreads = 256;

// One advection step, one thread per (x, y) column marching over a chunk of
// `zchunk` z planes and carrying the z-1 / z / z+1 density and vz values in
// registers.
//
// Replaces make_flux_update_blocked_direct (EXT = false) and
// make_flux_update (EXT = true).
//   EXT = false: rho / vz are [D, nzl, ny, nx]; the planes below z = 0 and
//     above z = nzl-1 come from the device-edge inputs e_lo / e_hi (and
//     ve_lo / ve_hi), each [D, 1, ny, nx] — the ring's received planes.
//   EXT = true:  rho / vz are the halo-extended [D, nzl+2, ny, nx] arrays,
//     read at z offsets 0 / 1 / 2; the edge pointers are unused.
// vx, vy, out are [D, nzl, ny, nx]; mx [nx], my [ny]; mzu, mzd [D, nzl].
//
// Bound on this card: device-memory bytes.  A step must read rho, vx, vy,
// vz and write the new rho: 5 arrays (20 bytes a cell) against ~31 flops a
// cell.  The design reads every array once from device memory: the z
// neighbors live in registers along the march, and the x / y neighbor
// reads of a plane hit L1/L2 lines that neighbouring threads (x fastest)
// have just loaded.  Each thread recomputes its - faces' flux (the + face
// flux of its - neighbours) rather than exchanging it, which costs flops,
// not bytes.
template <bool EXT>
__global__ void __launch_bounds__(kStepThreads)
dense_step_kernel(const float* __restrict__ rho, const float* __restrict__ e_lo,
                  const float* __restrict__ e_hi, const float* __restrict__ vx,
                  const float* __restrict__ vy, const float* __restrict__ vz,
                  const float* __restrict__ ve_lo, const float* __restrict__ ve_hi,
                  const float* __restrict__ mx, const float* __restrict__ my,
                  const float* __restrict__ mzu, const float* __restrict__ mzd,
                  float* __restrict__ out, int nzl, int ny, int nx, int zchunk,
                  float dt, float ax, float ay, float az, float inv_vol) {
  const long long P = (long long)ny * nx;
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= P) return;
  const int d = blockIdx.z;
  const int z0 = blockIdx.y * zchunk;
  const int z1 = min(z0 + zchunk, nzl);
  const int x = (int)(col % nx);
  const int y = (int)(col / nx);
  const int xm = (x - 1 + nx) % nx, xp = (x + 1) % nx;
  const int ym = (y - 1 + ny) % ny, yp = (y + 1) % ny;
  const long long o_xm = (long long)y * nx + xm, o_xp = (long long)y * nx + xp;
  const long long o_ym = (long long)ym * nx + x, o_yp = (long long)yp * nx + x;

  const long long zext = EXT ? nzl + 2 : nzl;
  // plane z of the centre block sits at R + z * P (z may be -1 or nzl when
  // EXT: the halo planes of the extended array)
  const float* R = rho + d * zext * P + (EXT ? P : 0);
  const float* VZ = vz + d * zext * P + (EXT ? P : 0);
  const float* VX = vx + d * (long long)nzl * P;
  const float* VY = vy + d * (long long)nzl * P;
  float* O = out + d * (long long)nzl * P;
  const float* mzu_d = mzu + (long long)d * nzl;
  const float* mzd_d = mzd + (long long)d * nzl;
  const float mx_c = mx[x], mx_m = mx[xm], my_c = my[y], my_m = my[ym];

  auto r_at = [&](int z) -> float {
    if (!EXT) {
      if (z < 0) return e_lo[d * P + col];
      if (z >= nzl) return e_hi[d * P + col];
    }
    return R[z * P + col];
  };
  auto vz_at = [&](int z) -> float {
    if (!EXT) {
      if (z < 0) return ve_lo[d * P + col];
      if (z >= nzl) return ve_hi[d * P + col];
    }
    return VZ[z * P + col];
  };

  float r_dn = r_at(z0 - 1), r_c = r_at(z0);
  float v_dn = vz_at(z0 - 1), v_c = vz_at(z0);
  for (int z = z0; z < z1; ++z) {
    const float r_up = r_at(z + 1), v_up = vz_at(z + 1);
    const float* Rz = R + z * P;
    const float* VXz = VX + z * P;
    const float* VYz = VY + z * P;
    const float fx = face_flux(r_c, Rz[o_xp], VXz[col], VXz[o_xp], dt, ax, mx_c);
    const float fx_m = face_flux(Rz[o_xm], r_c, VXz[o_xm], VXz[col], dt, ax, mx_m);
    const float fy = face_flux(r_c, Rz[o_yp], VYz[col], VYz[o_yp], dt, ay, my_c);
    const float fy_m = face_flux(Rz[o_ym], r_c, VYz[o_ym], VYz[col], dt, ay, my_m);
    const float fz = face_flux(r_c, r_up, v_c, v_up, dt, az, mzu_d[z]);
    const float fz_m = face_flux(r_dn, r_c, v_dn, v_c, dt, az, mzd_d[z]);
    // slot order z-, y-, x-, x+, y+, z+
    float flux = fz_m;
    flux = add(flux, fy_m);
    flux = add(flux, fx_m);
    flux = sub(flux, fx);
    flux = sub(flux, fy);
    flux = sub(flux, fz);
    O[z * P + col] = add(r_c, mul(flux, inv_vol));
    r_dn = r_c;
    r_c = r_up;
    v_dn = v_c;
    v_c = v_up;
  }
}

// A whole run of `steps` advection steps on one device's [nzl, ny, nx]
// block in one cooperative launch.  Replaces make_fused_run.
//
// Pass 0 hoists the loop invariants (make_fused_run's hoists): the four
// face weights ((dt * vf) * area) * mask and the four upwind selects,
// packed as bits of one byte, and copies rho into `out`.  Then each step
// reads the source buffer and writes the other one (ping-pong out / scr),
// with a grid-wide barrier between steps; an odd step count ends with the
// copy scr -> out.  Every pass is grid-stride over cells, x fastest.
//
// Bound on this card: the run's compulsory bytes are tiny (rho, vx, vy, vz
// in and rho out, once), so the least time is the operation count, ~11
// flops a cell a step.  What it really pays per step is traffic between
// the SMs and L2: the working set (two density buffers, four weights, the
// selects: ~21 bytes a cell, 22 MB at 128x128x64) stays resident in the
// 50 MB L2 across steps, so steps stream from L2, not device memory, plus
// one grid barrier per step.  Index arithmetic is 32-bit: 64-bit division
// and modulo are emulated on the card and would dominate the step.
// Keeping whole z-slab tiles in shared memory
// over several steps (temporal blocking) is the next step for speed.
__global__ void __launch_bounds__(kFusedThreads)
dense_fused_run_kernel(const float* __restrict__ rho, const float* __restrict__ vx,
                       const float* __restrict__ vy, const float* __restrict__ vz,
                       const float* __restrict__ mx, const float* __restrict__ my,
                       const float* __restrict__ mzu, const float* __restrict__ mzd,
                       float* out, float* scr, float* __restrict__ wx,
                       float* __restrict__ wy, float* __restrict__ wzu,
                       float* __restrict__ wzd, unsigned char* __restrict__ sel,
                       int nzl, int ny, int nx, int steps, float dt, float ax,
                       float ay, float az, float inv_vol) {
  cg::grid_group grid = cg::this_grid();
  // 32-bit index arithmetic: the launcher refuses blocks of 2^31 cells or
  // more (a block this kernel takes is far smaller)
  const int P = ny * nx;
  const int N = nzl * P;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;

  for (int c = first; c < N; c += stride) {
    const int x = c % nx;
    const int y = (c / nx) % ny;
    const int z = c / P;
    const int in_plane = c - z * P;
    const int c_xp = c - x + (x + 1) % nx;
    const int c_yp = c + ((y + 1) % ny - y) * nx;
    const int c_zp = ((z + 1) % nzl) * P + in_plane;
    const int c_zm = ((z - 1 + nzl) % nzl) * P + in_plane;
    const float vfx = mul(add(vx[c], vx[c_xp]), 0.5f);
    const float vfy = mul(add(vy[c], vy[c_yp]), 0.5f);
    const float vfz_hi = mul(add(vz[c], vz[c_zp]), 0.5f);
    const float vfz_lo = mul(add(vz[c_zm], vz[c]), 0.5f);
    wx[c] = mul(mul(mul(dt, vfx), ax), mx[x]);
    wy[c] = mul(mul(mul(dt, vfy), ay), my[y]);
    wzu[c] = mul(mul(mul(dt, vfz_hi), az), mzu[z]);
    wzd[c] = mul(mul(mul(dt, vfz_lo), az), mzd[z]);
    sel[c] = (unsigned char)((vfx >= 0.f) | ((vfy >= 0.f) << 1) |
                             ((vfz_hi >= 0.f) << 2) | ((vfz_lo >= 0.f) << 3));
    out[c] = rho[c];
  }
  grid.sync();

  for (int i = 0; i < steps; ++i) {
    const float* src = (i & 1) ? scr : out;
    float* dst = (i & 1) ? out : scr;
    for (int c = first; c < N; c += stride) {
      const int x = c % nx;
      const int y = (c / nx) % ny;
      const int z = c / P;
      const int in_plane = c - z * P;
      const int c_xp = c - x + (x + 1) % nx;
      const int c_xm = c - x + (x - 1 + nx) % nx;
      const int c_yp = c + ((y + 1) % ny - y) * nx;
      const int c_ym = c + ((y - 1 + ny) % ny - y) * nx;
      const int c_zp = ((z + 1) % nzl) * P + in_plane;
      const int c_zm = ((z - 1 + nzl) % nzl) * P + in_plane;
      const float r = src[c];
      const unsigned s = sel[c];
      const float fx = mul((s & 1u) ? r : src[c_xp], wx[c]);
      const float fy = mul((s & 2u) ? r : src[c_yp], wy[c]);
      const float fz = mul((s & 4u) ? r : src[c_zp], wzu[c]);
      const float fz_m = mul((s & 8u) ? src[c_zm] : r, wzd[c]);
      // the - faces are the + faces of the x-1 / y-1 neighbours
      const float fy_m = mul((sel[c_ym] & 2u) ? src[c_ym] : r, wy[c_ym]);
      const float fx_m = mul((sel[c_xm] & 1u) ? src[c_xm] : r, wx[c_xm]);
      float flux = fz_m;
      flux = add(flux, fy_m);
      flux = add(flux, fx_m);
      flux = sub(flux, fx);
      flux = sub(flux, fy);
      flux = sub(flux, fz);
      dst[c] = add(r, mul(flux, inv_vol));
    }
    grid.sync();
  }

  if (steps & 1) {
    for (int c = first; c < N; c += stride) out[c] = scr[c];
  }
}

template <bool EXT>
int launch_step(const float* rho, const float* e_lo, const float* e_hi,
                const float* vx, const float* vy, const float* vz,
                const float* ve_lo, const float* ve_hi, const float* mx,
                const float* my, const float* mzu, const float* mzd, float* out,
                int n_dev, int nzl, int ny, int nx, int zchunk, float dt,
                float ax, float ay, float az, float inv_vol, void* stream) {
  const long long P = (long long)ny * nx;
  if (n_dev < 1 || nzl < 1 || ny < 1 || nx < 1 || zchunk < 1 || n_dev > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((P + kStepThreads - 1) / kStepThreads),
                  (unsigned)((nzl + zchunk - 1) / zchunk), (unsigned)n_dev);
  dense_step_kernel<EXT><<<grid, kStepThreads, 0, (cudaStream_t)stream>>>(
      rho, e_lo, e_hi, vx, vy, vz, ve_lo, ve_hi, mx, my, mzu, mzd, out, nzl, ny,
      nx, zchunk, dt, ax, ay, az, inv_vol);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dense_step_blocked(const float* rho, const float* e_lo, const float* e_hi,
                       const float* vx, const float* vy, const float* vz,
                       const float* ve_lo, const float* ve_hi, const float* mx,
                       const float* my, const float* mzu, const float* mzd,
                       float* out, int n_dev, int nzl, int ny, int nx,
                       int block, float dt, float ax, float ay, float az,
                       float inv_vol, void* stream) {
  return launch_step<false>(rho, e_lo, e_hi, vx, vy, vz, ve_lo, ve_hi, mx, my,
                            mzu, mzd, out, n_dev, nzl, ny, nx, block, dt, ax,
                            ay, az, inv_vol, stream);
}

int dense_step_plane(const float* rho_ext, const float* vx, const float* vy,
                     const float* vz_ext, const float* mx, const float* my,
                     const float* mzu, const float* mzd, float* out, int n_dev,
                     int nzl, int ny, int nx, int zchunk, float dt, float ax,
                     float ay, float az, float inv_vol, void* stream) {
  return launch_step<true>(rho_ext, nullptr, nullptr, vx, vy, vz_ext, nullptr,
                           nullptr, mx, my, mzu, mzd, out, n_dev, nzl, ny, nx,
                           zchunk, dt, ax, ay, az, inv_vol, stream);
}

// Scratch (scr, wx, wy, wzu, wzd: nzl*ny*nx floats each; sel: as many
// bytes) is allocated by the caller.  The grid is as many blocks as can be
// co-resident (occupancy x SMs, at most one cell per thread); a refused
// cooperative launch returns its error and runs nothing.
int dense_fused_run(const float* rho, const float* vx, const float* vy,
                    const float* vz, const float* mx, const float* my,
                    const float* mzu, const float* mzd, float* out, float* scr,
                    float* wx, float* wy, float* wzu, float* wzd,
                    unsigned char* sel, int nzl, int ny, int nx, int steps,
                    float dt, float ax, float ay, float az, float inv_vol,
                    void* stream) {
  if (nzl < 1 || ny < 1 || nx < 1 || steps < 0 ||
      (long long)nzl * ny * nx >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dense_fused_run_kernel, kFusedThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long N = (long long)nzl * ny * nx;
  long long blocks = (N + kFusedThreads - 1) / kFusedThreads;
  const long long resident = (long long)per_sm * sms;
  if (blocks > resident) blocks = resident;
  void* args[] = {&rho, &vx, &vy, &vz, &mx, &my, &mzu, &mzd, &out, &scr,
                  &wx, &wy, &wzu, &wzd, &sel, &nzl, &ny, &nx, &steps, &dt,
                  &ax, &ay, &az, &inv_vol};
  err = cudaLaunchCooperativeKernel((const void*)dense_fused_run_kernel,
                                    dim3((unsigned)blocks), dim3(kFusedThreads),
                                    args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
