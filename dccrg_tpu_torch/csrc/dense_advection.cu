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
// bitwise.  The whole run hoists the x and y weights with the face mask
// folded in, ((dt * vf) * area) * mask, exactly as make_fused_run does, and
// the z product (dt * vf) * area, whose mask it applies at use: the same
// product in the same order.
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
// Member axis (MEMBERS): the launch covers n_slots = W * D slots, W members
// of D z-slab slots each, stacked [W, D, ...] (blockIdx.z is the slot).
// Member w's time step is dts[w], read on the card, so every member advances
// by its own dt in the one launch; the z masks are a member's, read at slot
// blockIdx.z % D; the edge planes are [W * D, 1, ny, nx], each member's from
// its own slab ring.  Without MEMBERS (one scenario given a scalar dt) the
// slot is the z slab and dt the argument: the member instantiation's load
// and division cost the 512x512x128 step 11.6% on an H100 (chip_smoke.py's
// phase 20 shape), so one scenario keeps the scalar form.  The two
// instantiations do the same arithmetic, so they agree bitwise.
//
// Bound on this card: device-memory bytes.  A step must read rho, vx, vy,
// vz and write the new rho: 5 arrays (20 bytes a cell) against ~31 flops a
// cell.  The design reads every array once from device memory: the z
// neighbors live in registers along the march, and the x / y neighbor
// reads of a plane hit L1/L2 lines that neighbouring threads (x fastest)
// have just loaded.  Each thread recomputes its - faces' flux (the + face
// flux of its - neighbours) rather than exchanging it, which costs flops,
// not bytes.
template <bool EXT, bool MEMBERS>
__global__ void __launch_bounds__(kStepThreads)
dense_step_kernel(const float* __restrict__ rho, const float* __restrict__ e_lo,
                  const float* __restrict__ e_hi, const float* __restrict__ vx,
                  const float* __restrict__ vy, const float* __restrict__ vz,
                  const float* __restrict__ ve_lo, const float* __restrict__ ve_hi,
                  const float* __restrict__ mx, const float* __restrict__ my,
                  const float* __restrict__ mzu, const float* __restrict__ mzd,
                  float* __restrict__ out, int n_dev, int nzl, int ny, int nx,
                  int zchunk, const float* __restrict__ dts, float dt0, float ax,
                  float ay, float az, float inv_vol) {
  const long long P = (long long)ny * nx;
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= P) return;
  // slot d of the W * D stacked slots: member d / n_dev, z slab d % n_dev
  const int d = blockIdx.z;
  const int dz = MEMBERS ? d % n_dev : d;
  const float dt = MEMBERS ? dts[d / n_dev] : dt0;
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
  const float* mzu_d = mzu + (long long)dz * nzl;
  const float* mzd_d = mzd + (long long)dz * nzl;
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

// ---------------------------------------------------------- whole run

// part i of n cells cut into p parts: the first n % p parts hold one more
__device__ __forceinline__ void part(int n, int p, int i, int& start, int& len) {
  const int q = n / p, r = n % p;
  start = i * q + (i < r ? i : r);
  len = q + (i < r ? 1 : 0);
}

// v mod n for v >= -n
__device__ __forceinline__ int wrap(int v, int n) { return (v % n + n) % n; }

// boundary cells a thread of the whole run exchanges a step at most
// (fused_run_plan keeps a brick's halo within kSlots x threads)
constexpr int kSlots = 8;

// A whole run of `steps` advection steps on one device's [nzl, ny, nx]
// block in one cooperative launch, the block held on chip for the whole
// run.  Replaces make_fused_run.
//
// The block is cut into pz x py x px bricks, one per CTA (at most one CTA
// per SM); the plan (ops/dense_advection.py::fused_run_plan) picks the cut
// and the launcher takes it as given.  Part i of n cells into p parts
// starts at i*(n/p) + min(i, n%p) and holds n/p (+1 for i < n%p) cells.
// Each CTA keeps in shared memory, for all steps:
//   A, D    this step's and the next step's density of its brick, each with
//           a one-cell halo on every split axis (ping-pong);
//   Wx, Wy  the masked face weights ((dt * vf) * area) * mask;
//   Wz      the unmasked z product (dt * vf) * area, the z+ and z- masks
//           applied at use: mul(Wz, mzu[z]) is the reference's z+ weight and
//           mul(Wz of the cell below, mzd[z]) its z- weight (vfz_lo of a
//           cell is vfz_hi of the cell below, bit for bit);
//   S       the three upwind selects (vf >= 0 on x, y, z+), bits of a byte;
//   the weights and selects over the brick and a one-cell halo on the minus
//   side of each split axis (the x-, y-, z- faces use the neighbour's).
// An axis that is not split (one part) has no halo: its neighbours wrap
// inside the brick.  A thread owns columns (y, x) of the brick and marches
// each over z, carrying the density, z product and select of the cell below
// in registers.  A step computes D from A; writes the edge planes of split
// axes to a global face buffer (double-buffered by step parity, written and
// read around L1, each thread's cells of the exchange fixed for the run so
// a warp's stores and loads are contiguous); waits at the grid barrier;
// reads the neighbours' planes into D's halo; and swaps A and D.  There is
// no integer division in the step loop.
//
// Bound on this card: the run's compulsory bytes are tiny (rho, vx, vy, vz
// in and rho out, once), so the least time is the operation count, ~11
// flops a cell a step.  What a step pays is the shared-memory work of
// ~1/128 of the block on each SM (~8k cells, 13 loads a cell: the issue
// rate of the SM), the grid barrier, and the face exchange through L2
// (~2.5k floats a CTA each way); nothing else leaves the SM.
__global__ void __launch_bounds__(512, 1)
dense_fused_run_kernel(const float* __restrict__ rho, const float* __restrict__ vx,
                       const float* __restrict__ vy, const float* __restrict__ vz,
                       const float* __restrict__ mx, const float* __restrict__ my,
                       const float* __restrict__ mzu, const float* __restrict__ mzd,
                       float* __restrict__ out, float* faces, int nzl,
                       int ny, int nx, int steps, float dt, float ax, float ay,
                       float az, float inv_vol, int pz, int py, int px, int fs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cta = blockIdx.x, ctas = gridDim.x;
  const int bi = cta % px, bj = (cta / px) % py, bk = cta / (px * py);
  int x0, tx, y0, ty, z0, tz;
  part(nx, px, bi, x0, tx);
  part(ny, py, bj, y0, ty);
  part(nzl, pz, bk, z0, tz);
  const int sx = px > 1, sy = py > 1, sz = pz > 1;
  // A: [AZ][AY][AX], interior (z, y, x) at (z+sz, y+sy, x+sx)
  const int AX = tx + 2 * sx, AY = ty + 2 * sy, AZ = tz + 2 * sz, AXY = AX * AY;
  // weights and selects: [VZ][VY][VX], interior at (z+sz, y+sy, x+sx)
  const int VX = tx + sx, VY = ty + sy, VZ = tz + sz, VXY = VX * VY;
  const int nA = AXY * AZ, nV = VXY * VZ;
  float* A = reinterpret_cast<float*>(smem);  // this step's density
  float* D = A + nA;                           // the next step's
  float* Wx = D + nA;
  float* Wy = Wx + nV;
  float* Wz = Wy + nV;
  unsigned char* S = reinterpret_cast<unsigned char*>(Wz + nV);

  const int bx = blockDim.x, by = blockDim.y;
  const int tid = threadIdx.y * bx + threadIdx.x, nth = bx * by;

  // ---- pass 0: load the brick and its halo, hoist weights and selects
  for (int i = tid; i < nA; i += nth) {
    const int gx = wrap(x0 + i % AX - sx, nx);
    const int gy = wrap(y0 + (i / AX) % AY - sy, ny);
    const int gz = wrap(z0 + i / AXY - sz, nzl);
    A[i] = rho[(gz * ny + gy) * nx + gx];
  }
  for (int i = tid; i < nV; i += nth) {
    const int gx = wrap(x0 + i % VX - sx, nx);
    const int gy = wrap(y0 + (i / VX) % VY - sy, ny);
    const int gz = wrap(z0 + i / VXY - sz, nzl);
    const int c = (gz * ny + gy) * nx + gx;
    const int c_xp = c - gx + (gx + 1 == nx ? 0 : gx + 1);
    const int c_yp = c + ((gy + 1 == ny ? 0 : gy + 1) - gy) * nx;
    const int c_zp = c + ((gz + 1 == nzl ? 0 : gz + 1) - gz) * ny * nx;
    const float vfx = mul(add(vx[c], vx[c_xp]), 0.5f);
    const float vfy = mul(add(vy[c], vy[c_yp]), 0.5f);
    const float vfz = mul(add(vz[c], vz[c_zp]), 0.5f);
    Wx[i] = mul(mul(mul(dt, vfx), ax), mx[gx]);
    Wy[i] = mul(mul(mul(dt, vfy), ay), my[gy]);
    Wz[i] = mul(mul(dt, vfz), az);
    S[i] = (unsigned char)((vfx >= 0.f) | ((vfy >= 0.f) << 1) | ((vfz >= 0.f) << 2));
  }
  __syncthreads();

  // neighbours' CTA indices on split axes: x-, x+, y-, y+, z-, z+
  const int row_cta = (bk * py + bj) * px;
  const int nb[6] = {row_cta + (bi == 0 ? px - 1 : bi - 1),
                     row_cta + (bi + 1 == px ? 0 : bi + 1),
                     (bk * py + (bj == 0 ? py - 1 : bj - 1)) * px + bi,
                     (bk * py + (bj + 1 == py ? 0 : bj + 1)) * px + bi,
                     ((bk == 0 ? pz - 1 : bk - 1) * py + bj) * px + bi,
                     ((bk + 1 == pz ? 0 : bk + 1) * py + bj) * px + bi};
  // The boundary exchange: items tid + m * nth of the split axes' planes
  // (x, then y, then z; each minus side then plus side, in the order of the
  // plane in the face buffer), at most kSlots a thread (the plan keeps the
  // count so).  Item m writes A[out_a[m]], a cell of the brick's own edge
  // plane, to the face buffer at out_f[m], and fills A[in_a[m]], a halo
  // cell, from the facing plane of the neighbour at in_f[m] (face buffer
  // offsets within one step parity).
  int out_a[kSlots], out_f[kSlots], in_a[kSlots], in_f[kSlots];
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    int i = tid + m * nth;
    in_a[m] = -1;
    out_a[m] = out_f[m] = in_f[m] = 0;
    const int nxf = sx * 2 * tz * ty, nyf = sy * 2 * tz * tx, nzf = sz * 2 * ty * tx;
    if (i < nxf) {
      const int side = i / (tz * ty), z = (i / ty) % tz, y = i % ty;
      const int row = ((z + sz) * AY + y + sy) * AX;
      in_a[m] = row + (side ? AX - 1 : 0);
      in_f[m] = (nb[side] * 6 + 1 - side) * fs + z * ty + y;
      out_a[m] = row + (side ? tx : 1);
      out_f[m] = (cta * 6 + side) * fs + z * ty + y;
    } else if ((i -= nxf) < nyf) {
      const int side = i / (tz * tx), z = (i / tx) % tz, x = i % tx;
      const int col = (z + sz) * AY * AX + x + sx;
      in_a[m] = col + (side ? AY - 1 : 0) * AX;
      in_f[m] = (nb[2 + side] * 6 + 3 - side) * fs + z * tx + x;
      out_a[m] = col + (side ? ty : 1) * AX;
      out_f[m] = (cta * 6 + 2 + side) * fs + z * tx + x;
    } else if ((i -= nyf) < nzf) {
      const int side = i / (ty * tx), y = (i / tx) % ty, x = i % tx;
      const int col = (y + sy) * AX + x + sx;
      in_a[m] = col + (side ? AZ - 1 : 0) * AXY;
      in_f[m] = (nb[4 + side] * 6 + 5 - side) * fs + y * tx + x;
      out_a[m] = col + (side ? tz : 1) * AXY;
      out_f[m] = (cta * 6 + 4 + side) * fs + y * tx + x;
    }
  }
  // A thread owns the columns (y, x) = (threadIdx.y + j by, threadIdx.x +
  // i bx) of the brick and marches each over z, carrying the density and
  // the z product and select of the cell below in registers.
  const int zm0 = sz ? -1 : tz - 1;  // plane 0's z- neighbour, in planes
  for (int step = 0; step < steps; ++step) {
    // ---- the next density from this one, in the reference's slot order
    const float* __restrict__ src = A;
    float* __restrict__ dst = D;
    for (int y = threadIdx.y; y < ty; y += by) {
      const int ay_ = y + sy;
      const int a_yp = (ay_ + 1 == AY ? -ay_ : 1) * AX;
      const int a_ym = (ay_ == 0 ? AY - 1 : -1) * AX;
      const int v_ym = (ay_ == 0 ? VY - 1 : -1) * VX;
      for (int x = threadIdx.x; x < tx; x += bx) {
        const int ax_ = x + sx;
        const int a_xp = ax_ + 1 == AX ? -ax_ : 1;
        const int a_xm = ax_ == 0 ? AX - 1 : -1;
        const int v_xm = ax_ == 0 ? VX - 1 : -1;
        int a = (sz * AY + ay_) * AX + ax_, v = (sz * VY + ay_) * VX + ax_;
        float r_dn = src[a + zm0 * AXY], r = src[a];
        float wz_dn = Wz[v + zm0 * VXY];
        unsigned s_dn = S[v + zm0 * VXY];
        for (int z = 0; z < tz; ++z, a += AXY, v += VXY) {
          // plane z+1: the next plane, the halo above the last (split) or
          // plane 0 (not split)
          const float r_up = src[z + 1 == tz && !sz ? a - z * AXY : a + AXY];
          const unsigned s = S[v];
          const float wz = Wz[v];
          const float mu = __ldg(mzu + z0 + z), md = __ldg(mzd + z0 + z);
          const float fx = mul((s & 1u) ? r : src[a + a_xp], Wx[v]);
          const float fy = mul((s & 2u) ? r : src[a + a_yp], Wy[v]);
          const float fz = mul((s & 4u) ? r : r_up, mul(wz, mu));
          const float fz_m = mul((s_dn & 4u) ? r_dn : r, mul(wz_dn, md));
          const int vym = v + v_ym, vxm = v + v_xm;
          const float fy_m = mul((S[vym] & 2u) ? src[a + a_ym] : r, Wy[vym]);
          const float fx_m = mul((S[vxm] & 1u) ? src[a + a_xm] : r, Wx[vxm]);
          float flux = fz_m;
          flux = add(flux, fy_m);
          flux = add(flux, fx_m);
          flux = sub(flux, fx);
          flux = sub(flux, fy);
          flux = sub(flux, fz);
          dst[a] = add(r, mul(flux, inv_vol));
          r_dn = r;
          r = r_up;
          wz_dn = wz;
          s_dn = s;
        }
      }
    }
    __syncthreads();
    if (step + 1 == steps) {
      A = D;
      break;
    }

    // ---- the edge planes of split axes out to the face buffer, the grid
    // barrier, the neighbours' planes into the halo (each pass's loads
    // issued before its first store)
    float* G = faces + (size_t)(step & 1) * ctas * 6 * fs;
    float val[kSlots];
#pragma unroll
    for (int m = 0; m < kSlots; ++m)
      if (in_a[m] >= 0) val[m] = D[out_a[m]];
#pragma unroll
    for (int m = 0; m < kSlots; ++m)
      if (in_a[m] >= 0) __stcg(G + out_f[m], val[m]);
    cg::this_grid().sync();
#pragma unroll
    for (int m = 0; m < kSlots; ++m)
      if (in_a[m] >= 0) val[m] = __ldcg(G + in_f[m]);
#pragma unroll
    for (int m = 0; m < kSlots; ++m)
      if (in_a[m] >= 0) D[in_a[m]] = val[m];
    __syncthreads();
    float* t = A;
    A = D;
    D = t;
  }

  // ---- the brick's density out
  for (int y = threadIdx.y; y < ty; y += by)
    for (int x = threadIdx.x; x < tx; x += bx)
      for (int z = 0; z < tz; ++z)
        out[((z0 + z) * ny + y0 + y) * nx + x0 + x] =
            A[((z + sz) * AY + y + sy) * AX + x + sx];
}

// Opts `kernel` into `smem` bytes of dynamic shared memory and checks that
// `ctas` blocks of `threads` threads can all be resident at once.
cudaError_t cooperative_fits(const void* kernel, int ctas, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                        (size_t)smem);
  if (err != cudaSuccess) return err;
  if ((long long)per_sm * sms < ctas) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

template <bool EXT>
int launch_step(const float* rho, const float* e_lo, const float* e_hi,
                const float* vx, const float* vy, const float* vz,
                const float* ve_lo, const float* ve_hi, const float* mx,
                const float* my, const float* mzu, const float* mzd, float* out,
                int n_slots, int n_dev, int nzl, int ny, int nx, int zchunk,
                const float* dts, float dt, float ax, float ay, float az,
                float inv_vol, void* stream) {
  const long long P = (long long)ny * nx;
  if (n_slots < 1 || n_dev < 1 || n_slots % n_dev != 0 || nzl < 1 || ny < 1 ||
      nx < 1 || zchunk < 1 || n_slots > 65535 ||
      (dts == nullptr && n_slots != n_dev))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((P + kStepThreads - 1) / kStepThreads),
                  (unsigned)((nzl + zchunk - 1) / zchunk), (unsigned)n_slots);
  if (dts != nullptr)
    dense_step_kernel<EXT, true><<<grid, kStepThreads, 0, (cudaStream_t)stream>>>(
        rho, e_lo, e_hi, vx, vy, vz, ve_lo, ve_hi, mx, my, mzu, mzd, out, n_dev,
        nzl, ny, nx, zchunk, dts, dt, ax, ay, az, inv_vol);
  else
    dense_step_kernel<EXT, false><<<grid, kStepThreads, 0, (cudaStream_t)stream>>>(
        rho, e_lo, e_hi, vx, vy, vz, ve_lo, ve_hi, mx, my, mzu, mzd, out, n_dev,
        nzl, ny, nx, zchunk, dts, dt, ax, ay, az, inv_vol);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dense_step_blocked(const float* rho, const float* e_lo, const float* e_hi,
                       const float* vx, const float* vy, const float* vz,
                       const float* ve_lo, const float* ve_hi, const float* mx,
                       const float* my, const float* mzu, const float* mzd,
                       float* out, int n_slots, int n_dev, int nzl, int ny,
                       int nx, int block, const float* dts, float dt, float ax,
                       float ay, float az, float inv_vol, void* stream) {
  return launch_step<false>(rho, e_lo, e_hi, vx, vy, vz, ve_lo, ve_hi, mx, my,
                            mzu, mzd, out, n_slots, n_dev, nzl, ny, nx, block,
                            dts, dt, ax, ay, az, inv_vol, stream);
}

int dense_step_plane(const float* rho_ext, const float* vx, const float* vy,
                     const float* vz_ext, const float* mx, const float* my,
                     const float* mzu, const float* mzd, float* out,
                     int n_slots, int n_dev, int nzl, int ny, int nx, int zchunk,
                     const float* dts, float dt, float ax, float ay, float az,
                     float inv_vol, void* stream) {
  return launch_step<true>(rho_ext, nullptr, nullptr, vx, vy, vz_ext, nullptr,
                           nullptr, mx, my, mzu, mzd, out, n_slots, n_dev, nzl,
                           ny, nx, zchunk, dts, dt, ax, ay, az, inv_vol, stream);
}

// The whole run on the plan's pz x py x px bricks (ops/dense_advection.py::
// fused_run_plan): one CTA of bx x by threads a brick, `smem` bytes of
// dynamic shared memory each.  `faces` holds 2 x CTAs x 6 x fs floats of
// scratch, allocated by the caller.  A plan that does not fit the block
// (its largest brick over `smem` bytes or its faces over `fs` floats, a
// halo over kSlots cells a thread) is refused with cudaErrorInvalidValue,
// and one the card cannot hold (more CTAs than can be co-resident, more
// shared memory than a block may opt into) with its error; either runs
// nothing.
int dense_fused_run(const float* rho, const float* vx, const float* vy,
                    const float* vz, const float* mx, const float* my,
                    const float* mzu, const float* mzd, float* out, float* faces,
                    int nzl, int ny, int nx, int steps, float dt, float ax,
                    float ay, float az, float inv_vol, int pz, int py, int px,
                    int bx, int by, int smem, int fs, void* stream) {
  if (nzl < 1 || ny < 1 || nx < 1 || steps < 0 ||
      (long long)nzl * ny * nx >= (1LL << 31) || pz < 1 || py < 1 || px < 1 ||
      pz > nzl || py > ny || px > nx || bx < 1 || by < 1 || bx * by > 512 ||
      smem < 1 || fs < 0 || (long long)2 * pz * py * px * 6 * fs >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  // the plan's needs, recomputed from the block (ops/dense_advection.py::
  // fused_smem_bytes, fused_halo_cells)
  const long long sx = px > 1, sy = py > 1, sz = pz > 1;
  const long long tx = (nx + px - 1) / px, ty = (ny + py - 1) / py,
                  tz = (nzl + pz - 1) / pz;
  const long long need = 8 * (tz + 2 * sz) * (ty + 2 * sy) * (tx + 2 * sx) +
                         13 * (tz + sz) * (ty + sy) * (tx + sx);
  long long face = tz * ty;
  if (tz * tx > face) face = tz * tx;
  if (ty * tx > face) face = ty * tx;
  if (need > smem || fs < face ||
      2 * (sx * tz * ty + sy * tz * tx + sz * ty * tx) > (long long)kSlots * bx * by)
    return (int)cudaErrorInvalidValue;
  const int ctas = pz * py * px;
  cudaError_t err = cooperative_fits((const void*)dense_fused_run_kernel, ctas,
                                     bx * by, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&rho, &vx, &vy, &vz, &mx, &my, &mzu, &mzd, &out, &faces,
                  &nzl, &ny, &nx, &steps, &dt, &ax, &ay, &az, &inv_vol,
                  &pz, &py, &px, &fs};
  err = cudaLaunchCooperativeKernel((const void*)dense_fused_run_kernel,
                                    dim3((unsigned)ctas), dim3((unsigned)bx, (unsigned)by),
                                    args, (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
