// Flat inflated-voxel AMR advection: two whole-run kernels that replace the
// Pallas kernels of dccrg_tpu/ops/flat_amr.py, behind a plain C interface
// (each launcher returns the launch's cudaError_t).
//
//   flat_amr_run  <- make_flat_amr_run        (leaf levels {0, 1})
//   flat_ml_run   <- make_flat_ml_run_pallas  (3 or more leaf levels)
//
// Both advance a dense voxel array V [nz, ny, nx] (x fastest) a whole run of
// steps in one cooperative launch: V is copied to `out`, then each step reads
// one buffer and writes the other (out -> scr, scr -> out, ...) with a grid
// barrier between steps, and an odd step count ends with the copy scr -> out.
// Every axis wraps: the array covers the whole domain, and non-periodic wrap
// faces already carry weight 0.  The face weights arrive premultiplied by dt.
//
// Arithmetic order is part of the contract: every product and sum goes
// through __fmul_rn / __fadd_rn / __fsub_rn (the build also passes
// -fmad=false), in the order of the JAX kernel bodies, so each kernel equals
// its plain PyTorch twin (ops/flat_amr.py) bitwise, up to the sign of zero:
//   f      = v[p] * wp[p] + v[p+1] * wn[p]          per axis x, y, z
//   delta  = ((((f_x[p-1] - f_x[p]) + f_y[p-1]) - f_y[p]) + f_z[p-1]) - f_z[p]
//   pool   = the roll-chain tree at an aligned origin o of an edge-2h cube:
//            x pairs (a[o] + a[o+h_x]) first, then y pairs, then z
// The JAX kernels broadcast an origin's pooled value over its block by
// adding shifted copies of an array that is zero away from origins; that
// adds only zeros to the origin value, so reading the origin's value
// directly gives the same number.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// the six face weights, x / y / z, + then - side
struct Weights {
  const float* px;
  const float* nx;
  const float* py;
  const float* ny;
  const float* pz;
  const float* nz;
};

// delta of voxel (z, y, x): the flux divergence of one step.
// 32-bit index arithmetic; wraps are compares, not divisions.
__device__ __forceinline__ float voxel_delta(const float* __restrict__ src,
                                             const Weights& w, int z, int y,
                                             int x, int nz, int ny, int nx) {
  const int P = ny * nx;
  const int c = z * P + y * nx + x;
  const int c_xm = c + (x == 0 ? nx - 1 : -1);
  const int c_xp = c + (x == nx - 1 ? 1 - nx : 1);
  const int c_ym = c + (y == 0 ? (ny - 1) * nx : -nx);
  const int c_yp = c + (y == ny - 1 ? (1 - ny) * nx : nx);
  const int c_zm = c + (z == 0 ? (nz - 1) * P : -P);
  const int c_zp = c + (z == nz - 1 ? (1 - nz) * P : P);
  const float v = src[c];
  const float fx = add(mul(v, w.px[c]), mul(src[c_xp], w.nx[c]));
  const float fx_m = add(mul(src[c_xm], w.px[c_xm]), mul(v, w.nx[c_xm]));
  const float fy = add(mul(v, w.py[c]), mul(src[c_yp], w.ny[c]));
  const float fy_m = add(mul(src[c_ym], w.py[c_ym]), mul(v, w.ny[c_ym]));
  const float fz = add(mul(v, w.pz[c]), mul(src[c_zp], w.nz[c]));
  const float fz_m = add(mul(src[c_zm], w.pz[c_zm]), mul(v, w.nz[c_zm]));
  float delta = sub(fx_m, fx);
  delta = sub(add(delta, fy_m), fy);
  delta = sub(add(delta, fz_m), fz);
  return delta;
}

__device__ __forceinline__ void copy_all(float* __restrict__ dst,
                                         const float* __restrict__ src, int n) {
  const int stride = gridDim.x * blockDim.x;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < n; c += stride)
    dst[c] = src[c];
}

constexpr int kAmrThreads = 256;

// Two-level run.  One thread owns one even-aligned 2x2x2 block: it computes
// the block's 8 deltas, the pooled sum of its coarse deltas (the x / y / z
// roll-chain tree at the block origin) and the 8 results
//   res = (v + delta * upd_f) + pooled * upd_c,
// so the JAX kernel's pool and broadcast passes need no second sweep.  The
// pool mask is (upd_c != 0); a block is either one coarse leaf or eight
// fine leaves, so a fine block pools zeros and upd_c = 0 drops them.
//
// Bound on this card: operations (26 f32 operations a voxel a step in the
// JAX body's form).  The working set (two density buffers, six weights, two
// update masks: ~40 bytes a voxel, 35 MB at 96^3) stays in the 50 MB L2
// across steps, so steps stream from L2, plus one grid barrier a step.
__global__ void __launch_bounds__(kAmrThreads)
flat_amr_run_kernel(const float* __restrict__ V, Weights w,
                    const float* __restrict__ updf,
                    const float* __restrict__ updc, float* out, float* scr,
                    int nz, int ny, int nx, int steps) {
  cg::grid_group grid = cg::this_grid();
  const int N = nz * ny * nx;
  const int bx = nx / 2, by = ny / 2;
  const int nb = (nz / 2) * by * bx;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;

  copy_all(out, V, N);
  grid.sync();

  for (int i = 0; i < steps; ++i) {
    const float* src = (i & 1) ? scr : out;
    float* dst = (i & 1) ? out : scr;
    for (int b = first; b < nb; b += stride) {
      const int x0 = 2 * (b % bx);
      const int y0 = 2 * ((b / bx) % by);
      const int z0 = 2 * (b / (bx * by));
      float d[8], s[8];
      // e = dz * 4 + dy * 2 + dx
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int x = x0 + (e & 1), y = y0 + ((e >> 1) & 1), z = z0 + (e >> 2);
        const int c = (z * ny + y) * nx + x;
        d[e] = voxel_delta(src, w, z, y, x, nz, ny, nx);
        s[e] = mul(d[e], updc[c] != 0.f ? 1.f : 0.f);
      }
      // roll-chain tree at the origin: x pairs, then y, then z
      const float sy0 = add(add(s[0], s[1]), add(s[2], s[3]));
      const float sy1 = add(add(s[4], s[5]), add(s[6], s[7]));
      const float pooled = add(sy0, sy1);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int x = x0 + (e & 1), y = y0 + ((e >> 1) & 1), z = z0 + (e >> 2);
        const int c = (z * ny + y) * nx + x;
        dst[c] = add(add(src[c], mul(d[e], updf[c])), mul(pooled, updc[c]));
      }
    }
    grid.sync();
  }
  if (steps & 1) copy_all(out, scr, N);
}

// Multi-level run.  The pooled sums reach over aligned cubes of edge
// E = 2^(kmax+1); one thread block owns one such cube at a time (blocks
// stride over the cubes), holding the cube's pooled values `s` and the
// per-voxel update `r` in shared memory:
//   r = delta * updf,  s = delta * pool            (every voxel)
//   for k = 0..kmax (h = 2^k): at each origin o aligned to 2h,
//     s[o] = tree of s at o + {0,h}^3 (x pairs, then y, then z)
//     if level k is active: r[q] += s[o_k(q)] * caps[k][o_k(q)]
//   out = v + r
// where o_k(q) is the 2h-aligned origin of q's cube.  In-place pooling is
// safe: a level-k origin reads only positions of its own cube, and the
// positions it overwrites are read again only at level k+1, after a
// barrier.  caps[k] is zero away from the origins of level vl-1-k leaves,
// so r gains exactly one nonzero capture per coarse voxel.
//
// Bound on this card: operations (36 f32 operations a voxel a step in the
// JAX body's form at kmax = 1).  The working set (~13 arrays, 13 MB at
// 64^3) stays in L2.
__global__ void flat_ml_run_kernel(const float* __restrict__ V, Weights w,
                                   const float* __restrict__ updf,
                                   const float* __restrict__ pool,
                                   const float* __restrict__ caps, float* out,
                                   float* scr, int nz, int ny, int nx,
                                   int steps, int kmax, int active) {
  extern __shared__ float shm[];
  cg::grid_group grid = cg::this_grid();
  const int N = nz * ny * nx;
  const int le = kmax + 1;  // log2 of the cube edge
  const int E = 1 << le;
  const int E3 = E * E * E;
  float* s_sh = shm;
  float* r_sh = shm + E3;
  const int cx = nx >> le, cy = ny >> le;
  const int n_cubes = (nz >> le) * cy * cx;
  const int emask = E - 1;

  copy_all(out, V, N);
  grid.sync();

  for (int i = 0; i < steps; ++i) {
    const float* src = (i & 1) ? scr : out;
    float* dst = (i & 1) ? out : scr;
    for (int cube = blockIdx.x; cube < n_cubes; cube += gridDim.x) {
      const int ox = (cube % cx) << le;
      const int oy = ((cube / cx) % cy) << le;
      const int oz = (cube / (cx * cy)) << le;
      for (int li = threadIdx.x; li < E3; li += blockDim.x) {
        const int lx = li & emask, ly = (li >> le) & emask, lz = li >> (2 * le);
        const int c = ((oz + lz) * ny + (oy + ly)) * nx + (ox + lx);
        const float delta =
            voxel_delta(src, w, oz + lz, oy + ly, ox + lx, nz, ny, nx);
        r_sh[li] = mul(delta, updf[c]);
        s_sh[li] = mul(delta, pool[c]);
      }
      __syncthreads();
      for (int k = 0; k <= kmax; ++k) {
        const int h = 1 << k;
        const int lo = le - k - 1;  // log2 of the origins per axis
        const int n_orig = 1 << (3 * lo);
        for (int oi = threadIdx.x; oi < n_orig; oi += blockDim.x) {
          const int ax = (oi & ((1 << lo) - 1)) << (k + 1);
          const int ay = ((oi >> lo) & ((1 << lo) - 1)) << (k + 1);
          const int az = (oi >> (2 * lo)) << (k + 1);
          const int o = (az * E + ay) * E + ax;
          const int hx = h, hy = h * E, hz = h * E * E;
          const float t00 = add(s_sh[o], s_sh[o + hx]);
          const float t01 = add(s_sh[o + hy], s_sh[o + hy + hx]);
          const float t10 = add(s_sh[o + hz], s_sh[o + hz + hx]);
          const float t11 = add(s_sh[o + hz + hy], s_sh[o + hz + hy + hx]);
          s_sh[o] = add(add(t00, t01), add(t10, t11));
        }
        __syncthreads();
        if ((active >> k) & 1) {
          const float* cap = caps + (size_t)k * N;
          const int amask = ~((2 << k) - 1);
          for (int li = threadIdx.x; li < E3; li += blockDim.x) {
            const int lx = (li & emask) & amask;
            const int ly = ((li >> le) & emask) & amask;
            const int lz = (li >> (2 * le)) & amask;
            const int o = (lz * E + ly) * E + lx;
            const int c = ((oz + lz) * ny + (oy + ly)) * nx + (ox + lx);
            r_sh[li] = add(r_sh[li], mul(s_sh[o], cap[c]));
          }
          __syncthreads();
        }
      }
      for (int li = threadIdx.x; li < E3; li += blockDim.x) {
        const int lx = li & emask, ly = (li >> le) & emask, lz = li >> (2 * le);
        const int c = ((oz + lz) * ny + (oy + ly)) * nx + (ox + lx);
        dst[c] = add(src[c], r_sh[li]);
      }
      __syncthreads();
    }
    grid.sync();
  }
  if (steps & 1) copy_all(out, scr, N);
}

// Blocks of a cooperative launch: at most what can be co-resident, and no
// more than there is work for.
cudaError_t resident_blocks(const void* kernel, int threads, size_t smem,
                            long long want, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  long long b = (long long)per_sm * sms;
  if (want < b) b = want;
  *blocks = (int)(b < 1 ? 1 : b);
  return cudaSuccess;
}

bool bad_extent(int nz, int ny, int nx, int steps) {
  return nz < 1 || ny < 1 || nx < 1 || steps < 0 ||
         (long long)nz * ny * nx >= (1LL << 31);
}

}  // namespace

extern "C" {

// V, the six dt-premultiplied weights, upd_f, upd_c: [nz, ny, nx] float32
// with even extents; out and scr are caller-allocated arrays of that shape.
int flat_amr_run(const float* V, const float* wpx, const float* wnx,
                 const float* wpy, const float* wny, const float* wpz,
                 const float* wnz, const float* updf, const float* updc,
                 float* out, float* scr, int nz, int ny, int nx, int steps,
                 void* stream) {
  if (bad_extent(nz, ny, nx, steps) || (nz | ny | nx) & 1)
    return (int)cudaErrorInvalidValue;
  Weights w{wpx, wnx, wpy, wny, wpz, wnz};
  const long long nb = (long long)(nz / 2) * (ny / 2) * (nx / 2);
  int blocks = 0;
  cudaError_t err = resident_blocks((const void*)flat_amr_run_kernel,
                                    kAmrThreads, 0,
                                    (nb + kAmrThreads - 1) / kAmrThreads,
                                    &blocks);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&V, &w, &updf, &updc, &out, &scr, &nz, &ny, &nx, &steps};
  err = cudaLaunchCooperativeKernel((const void*)flat_amr_run_kernel,
                                    dim3((unsigned)blocks), dim3(kAmrThreads),
                                    args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// V, the six dt-premultiplied weights, updf, pool: [nz, ny, nx] float32;
// caps: [kmax + 1, nz, ny, nx] (capture masks of doublings 0..kmax); every
// extent a multiple of 2^(kmax+1).  `active` has bit k set when doubling k
// captures.  out and scr are caller-allocated arrays of V's shape.
int flat_ml_run(const float* V, const float* wpx, const float* wnx,
                const float* wpy, const float* wny, const float* wpz,
                const float* wnz, const float* updf, const float* pool,
                const float* caps, float* out, float* scr, int nz, int ny,
                int nx, int steps, int kmax, int active, void* stream) {
  if (bad_extent(nz, ny, nx, steps) || kmax < -1 || kmax > 3)
    return (int)cudaErrorInvalidValue;
  const int E = 1 << (kmax + 1);
  if (nz % E || ny % E || nx % E) return (int)cudaErrorInvalidValue;
  Weights w{wpx, wnx, wpy, wny, wpz, wnz};
  const int E3 = E * E * E;
  // one thread a voxel of the cube, at least a warp, at most 256
  int threads = E3 < 32 ? 32 : (E3 > 256 ? 256 : E3);
  const size_t smem = 2 * (size_t)E3 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)flat_ml_run_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_cubes = (long long)(nz / E) * (ny / E) * (nx / E);
  int blocks = 0;
  cudaError_t err = resident_blocks((const void*)flat_ml_run_kernel, threads,
                                    smem, n_cubes, &blocks);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&V,   &w,  &updf, &pool,  &caps, &out,  &scr,
                  &nz,  &ny, &nx,   &steps, &kmax, &active};
  err = cudaLaunchCooperativeKernel((const void*)flat_ml_run_kernel,
                                    dim3((unsigned)blocks), dim3(threads),
                                    args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
