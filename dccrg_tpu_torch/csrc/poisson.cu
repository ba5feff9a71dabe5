// Whole-solve BiCG on the flat voxel grid: the kernel that replaces the
// Pallas kernel of dccrg_tpu/ops/poisson_kernel.py (make_bicg_solve), behind
// a plain C interface (the launcher returns the launch's cudaError_t).
//
// One cooperative launch runs a whole masked BiCG solve of the flat Poisson
// operator (ops/flat_poisson.py) on float32 voxel arrays [nz, ny, nx]
// (x fastest): the six-roll matvec A·p0 and its transpose Aᵀ·p1, the
// even-parity 2x2x2 pool/broadcast of coarse rows when `has_coarse`, the
// three dots of an iteration, and the reference's stopping rules (residual
// target, dot_r breakdown, best-solution tracking and the semi-convergence
// stop; tests/poisson/poisson_solve.hpp:246-250, 655-683).  Every axis
// wraps: the arrays cover the whole domain and non-periodic wrap faces carry
// weight 0.
//
// Work items: one thread a 2x2x2 block when `has_coarse` (extents even), so
// the pool and broadcast of a coarse leaf stay in registers; one thread a
// voxel otherwise (any extents).  A tile is 256 consecutive items, owned by
// one thread block; blocks stride over tiles.
//
// Barriers: three grid barriers an iteration, one after each phase, because
// each phase needs a global result of the one before it:
//   A  Ap0 = A·p0, ATp1 = Aᵀ·p1 (masked to solve rows), partials of
//      dot(p1, Ap0)              -- needs every p of the last iteration
//   B  x += a·p0, r0 -= a·Ap0, r1 -= a·ATp1, partials of dot(r0, r1) and
//      dot(r0, r0)               -- needs alpha, i.e. the global dot(p1, Ap0)
//   C  p0 = r0 + b·p0, p1 = r1 + b·p1, best x  -- needs beta and the residual
// Every block reduces the partials itself after a barrier, so every block
// holds the same scalars and leaves the loop at the same iteration: the
// kernel stops at the first inactive iteration, where the TPU kernel runs
// frozen iterations up to max_iter; the outputs are the same.
//
// Arithmetic and order are part of the contract: every product and sum goes
// through __fmul_rn / __fadd_rn / __fsub_rn (the build also passes
// -fmad=false), divisions and the square root are correctly rounded, and
// each expression keeps the JAX kernel body's association.  Every dot is
// reduced in one order that depends on the shape alone (blocked_sum in
// ops/poisson_kernel.py): a coarse item's 8 products as the tree
// (w[e] + w[e+4]) ... at strides 4, 2, 1 (e = dz*4 + dy*2 + dx), the 256
// items of a tile as the tree at strides 128 ... 1, and the tile partials
// again in tiles of 256, level by level, zeros padding each level.  So the
// kernel equals its plain twin (bicg_solve_plain) bitwise, up to the sign
// of zero.
//
// Bound on this card: operations.  The masked solve needs 48 f32 operations
// a voxel an iteration: the matvec and its transpose 13 each, their solve
// masks 2, three masked dots 3 each, the x / r0 / r1 / p0 / p1 updates 2
// each and the best-x copy 1.  Coarse rows add 4 to each matvec (the coarse
// mask 1, the block pool 7/8 and origin product 1/8, the fine product 1, the
// final sum 1): 56.  At 64^3 voxels and 60 iterations that is ~0.013 ms
// (0.011 ms uniform) at 67 TFLOP/s, against ~0.005 ms to read the 14 input
// arrays and write the solution once.  The working set (14 inputs,
// 7 state arrays and the output: ~22 MB at 64^3) stays in the 50 MB L2, so
// an iteration streams from L2; its three grid barriers set the pace.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// a value this kernel writes and other threads read after a grid barrier:
// through L2, never a stale L1 line
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

constexpr int kThreads = 256;     // threads a block = items a tile
constexpr int kMaxLevel2 = 64;    // second-level partials a block holds

struct Args {
  const float* rhs;
  const float* x0;
  const float* wpx;
  const float* wnx;
  const float* wpy;
  const float* wny;
  const float* wpz;
  const float* wnz;
  const float* scaling;
  const float* fine;
  const float* coarse;
  const float* orig;
  const float* solve;
  const float* dotm;
  float* out;      // best x
  float* res_out;  // [1] best residual
  int* it_out;     // [1] iterations run
  float* x;        // the iterate
  float* r0;
  float* r1;
  float* p0;
  float* p1;
  float* ap;       // solve-masked A·p0
  float* atp;      // solve-masked Aᵀ·p1
  float* part;     // [3, n_tiles] tile partials of the three dots
  int nz, ny, nx, max_iter;
  float stop_res, stop_inc;
};

// flat indices of the six wrapped face neighbours of voxel (z, y, x)
struct Nbr {
  int xm, xp, ym, yp, zm, zp;
};

__device__ __forceinline__ Nbr neighbours(int c, int z, int y, int x, int nz,
                                          int ny, int nx) {
  const int P = ny * nx;
  Nbr n;
  n.xm = c + (x == 0 ? nx - 1 : -1);
  n.xp = c + (x == nx - 1 ? 1 - nx : 1);
  n.ym = c + (y == 0 ? (ny - 1) * nx : -nx);
  n.yp = c + (y == ny - 1 ? (1 - ny) * nx : nx);
  n.zm = c + (z == 0 ? (nz - 1) * P : -P);
  n.zp = c + (z == nz - 1 ? (1 - nz) * P : P);
  return n;
}

// face part C of A·v at voxel c (the JAX body's apply_fwd):
//   C = (wpx v[x+1] + wnx v[x-1]) + wpy v[y+1] + wny v[y-1] + wpz ... + wnz ...
__device__ __forceinline__ float face_fwd(const Args& a, const float* v, int c,
                                          const Nbr& n) {
  float C = add(mul(__ldg(a.wpx + c), ld(v + n.xp)),
                mul(__ldg(a.wnx + c), ld(v + n.xm)));
  C = add(add(C, mul(__ldg(a.wpy + c), ld(v + n.yp))),
          mul(__ldg(a.wny + c), ld(v + n.ym)));
  C = add(add(C, mul(__ldg(a.wpz + c), ld(v + n.zp))),
          mul(__ldg(a.wnz + c), ld(v + n.zm)));
  return C;
}

// face part of Aᵀ·v (apply_rev): the same weights with reversed rolls,
//   C = (wpx v)[x-1] + (wnx v)[x+1] + (wpy v)[y-1] + ... + (wnz v)[z+1]
__device__ __forceinline__ float face_rev(const Args& a, const float* v, int c,
                                          const Nbr& n) {
  float C = add(mul(__ldg(a.wpx + n.xm), ld(v + n.xm)),
                mul(__ldg(a.wnx + n.xp), ld(v + n.xp)));
  C = add(add(C, mul(__ldg(a.wpy + n.ym), ld(v + n.ym))),
          mul(__ldg(a.wny + n.yp), ld(v + n.yp)));
  C = add(add(C, mul(__ldg(a.wpz + n.zm), ld(v + n.zm))),
          mul(__ldg(a.wnz + n.zp), ld(v + n.zp)));
  return C;
}

// the voxels of work item b: a 2x2x2 block (element e = dz*4 + dy*2 + dx)
// or one voxel
template <bool kCoarse>
struct Item {
  static constexpr int E = kCoarse ? 8 : 1;
  int c[E], z[E], y[E], x[E];

  __device__ __forceinline__ Item(int b, int nz, int ny, int nx) {
    if constexpr (kCoarse) {
      const int bx = nx / 2, by = ny / 2;
      const int x0 = 2 * (b % bx), y0 = 2 * ((b / bx) % by), z0 = 2 * (b / (bx * by));
#pragma unroll
      for (int e = 0; e < E; ++e) {
        x[e] = x0 + (e & 1);
        y[e] = y0 + ((e >> 1) & 1);
        z[e] = z0 + (e >> 2);
        c[e] = (z[e] * ny + y[e]) * nx + x[e];
      }
    } else {
      c[0] = b;
      x[0] = b % nx;
      y[0] = (b / nx) % ny;
      z[0] = b / (nx * ny);
    }
  }
};

// unmasked A·v (or Aᵀ·v) at the item's voxels:
//   scaling v + (fine C + pooled coarse C at the block origin)   coarse
//   scaling v + C                                                otherwise
// pooled = the roll-chain tree at the origin (x pairs, then y, then z) times
// orig[origin]; the TPU kernel's broadcast adds only zeros to it.
template <bool kCoarse>
__device__ __forceinline__ void matvec(const Args& a, const float* v,
                                       bool transpose, const Item<kCoarse>& it,
                                       float* y) {
  constexpr int E = Item<kCoarse>::E;
  float C[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const Nbr n = neighbours(it.c[e], it.z[e], it.y[e], it.x[e], a.nz, a.ny, a.nx);
    C[e] = transpose ? face_rev(a, v, it.c[e], n) : face_fwd(a, v, it.c[e], n);
  }
  if constexpr (kCoarse) {
    float s[E];
#pragma unroll
    for (int e = 0; e < E; ++e) s[e] = mul(C[e], __ldg(a.coarse + it.c[e]));
    float pooled = add(add(add(s[0], s[1]), add(s[2], s[3])),
                       add(add(s[4], s[5]), add(s[6], s[7])));
    pooled = mul(pooled, __ldg(a.orig + it.c[0]));
#pragma unroll
    for (int e = 0; e < E; ++e)
      C[e] = add(mul(__ldg(a.fine + it.c[e]), C[e]), pooled);
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
    y[e] = add(mul(__ldg(a.scaling + it.c[e]), ld(v + it.c[e])), C[e]);
}

// an item's share of a dot: its masked products, a coarse item's 8 as the
// tree at strides 4, 2, 1
template <int E>
__device__ __forceinline__ float item_sum(const float* w) {
  if constexpr (E == 1) {
    return w[0];
  } else {
    const float a0 = add(w[0], w[4]), a1 = add(w[1], w[5]);
    const float a2 = add(w[2], w[6]), a3 = add(w[3], w[7]);
    return add(add(a0, a2), add(a1, a3));
  }
}

// the tree of one tile's 256 values at strides 128, 64, ..., 1; the total
// lands in thread 0
__device__ __forceinline__ float block_tree(float v, float* sh) {
  const int t = threadIdx.x;
  __syncthreads();
  sh[t] = v;
  __syncthreads();
#pragma unroll
  for (int h = kThreads / 2; h >= 32; h >>= 1) {
    if (t < h) sh[t] = add(sh[t], sh[t + h]);
    __syncthreads();
  }
  float r = 0.f;
  if (t < 32) {
    r = sh[t];
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) r = add(r, __shfl_down_sync(0xffffffffu, r, h));
  }
  return r;
}

// the total of n tile partials, in every thread: further tile levels of 256
// (zeros past the end) until one value is left
__device__ float grid_total(const float* part, int n, float* sh, float* lvl) {
  if (n == 1) return ld(part);
  const float* src = part;
  bool global_src = true;
  for (;;) {
    const int m = (n + kThreads - 1) / kThreads;
    for (int j = 0; j < m; ++j) {
      const int i = j * kThreads + threadIdx.x;
      float v = 0.f;
      if (i < n) v = global_src ? ld(src + i) : src[i];
      const float r = block_tree(v, sh);
      __syncthreads();  // tile j's inputs are read before lvl[j] is written
      if (threadIdx.x == 0) lvl[j] = r;
    }
    __syncthreads();
    if (m == 1) return lvl[0];
    src = lvl;
    global_src = false;
    n = m;
  }
}

__device__ __forceinline__ float masked(const float* mask, int c, float v) {
  return __ldg(mask + c) != 0.f ? v : 0.f;
}

template <bool kCoarse>
__global__ void __launch_bounds__(kThreads) bicg_kernel(Args a) {
  constexpr int E = Item<kCoarse>::E;
  __shared__ float sh[kThreads];
  __shared__ float lvl[kMaxLevel2];
  cg::grid_group grid = cg::this_grid();
  const int n_items = a.nz * a.ny * a.nx / E;
  const int n_tiles = (n_items + kThreads - 1) / kThreads;
  float* part0 = a.part;
  float* part1 = a.part + n_tiles;
  float* part2 = a.part + 2 * n_tiles;

  // x = best x = x0; r0 = r1 = p0 = p1 = solve ? rhs - A x0 : 0;
  // partials of dot(r0, r0)
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile * kThreads + threadIdx.x;
    float w = 0.f;
    if (b < n_items) {
      const Item<kCoarse> it(b, a.nz, a.ny, a.nx);
      float Ax[E], wd[E];
      matvec<kCoarse>(a, a.x0, false, it, Ax);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = it.c[e];
        const float xv = __ldg(a.x0 + c);
        const float r = masked(a.solve, c, sub(__ldg(a.rhs + c), Ax[e]));
        a.x[c] = xv;
        a.out[c] = xv;
        a.r0[c] = r;
        a.r1[c] = r;
        a.p0[c] = r;
        a.p1[c] = r;
        wd[e] = masked(a.dotm, c, mul(r, r));
      }
      w = item_sum<E>(wd);
    }
    const float r = block_tree(w, sh);
    if (threadIdx.x == 0) part2[tile] = r;
  }
  grid.sync();

  float dot_r = grid_total(part2, n_tiles, sh, lvl);
  float res = __fsqrt_rn(fabsf(dot_r));
  float best_res = res;
  int iters = 0;
  while (iters < a.max_iter && res > a.stop_res && dot_r != 0.f &&
         res <= mul(best_res, a.stop_inc)) {
    // A: Ap0, ATp1, partials of dot(p1, Ap0)
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int b = tile * kThreads + threadIdx.x;
      float w = 0.f;
      if (b < n_items) {
        const Item<kCoarse> it(b, a.nz, a.ny, a.nx);
        float Ap[E], ATp[E], wd[E];
        matvec<kCoarse>(a, a.p0, false, it, Ap);
        matvec<kCoarse>(a, a.p1, true, it, ATp);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int c = it.c[e];
          const float ap = masked(a.solve, c, Ap[e]);
          a.ap[c] = ap;
          a.atp[c] = masked(a.solve, c, ATp[e]);
          wd[e] = masked(a.dotm, c, mul(ld(a.p1 + c), ap));
        }
        w = item_sum<E>(wd);
      }
      const float r = block_tree(w, sh);
      if (threadIdx.x == 0) part0[tile] = r;
    }
    grid.sync();

    // B: the iterate and the residuals, partials of dot(r0, r1), dot(r0, r0)
    const float dot_p = grid_total(part0, n_tiles, sh, lvl);
    const float alpha = dot_p != 0.f ? div(dot_r, dot_p) : 0.f;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int b = tile * kThreads + threadIdx.x;
      float w1 = 0.f, w2 = 0.f;
      if (b < n_items) {
        const Item<kCoarse> it(b, a.nz, a.ny, a.nx);
        float wa[E], wb[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int c = it.c[e];
          a.x[c] = add(ld(a.x + c), mul(alpha, ld(a.p0 + c)));
          const float r0 = sub(ld(a.r0 + c), mul(alpha, ld(a.ap + c)));
          const float r1 = sub(ld(a.r1 + c), mul(alpha, ld(a.atp + c)));
          a.r0[c] = r0;
          a.r1[c] = r1;
          wa[e] = masked(a.dotm, c, mul(r0, r1));
          wb[e] = masked(a.dotm, c, mul(r0, r0));
        }
        w1 = item_sum<E>(wa);
        w2 = item_sum<E>(wb);
      }
      const float t1 = block_tree(w1, sh);
      if (threadIdx.x == 0) part1[tile] = t1;
      const float t2 = block_tree(w2, sh);
      if (threadIdx.x == 0) part2[tile] = t2;
    }
    grid.sync();

    // C: search directions and the best solution so far
    const float new_dot_r = grid_total(part1, n_tiles, sh, lvl);
    const float rr = grid_total(part2, n_tiles, sh, lvl);
    const float beta = dot_r != 0.f ? div(new_dot_r, dot_r) : 0.f;
    const float res_new = __fsqrt_rn(fabsf(rr));
    const bool better = res_new < best_res;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int b = tile * kThreads + threadIdx.x;
      if (b >= n_items) continue;
      const Item<kCoarse> it(b, a.nz, a.ny, a.nx);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = it.c[e];
        a.p0[c] = add(ld(a.r0 + c), mul(beta, ld(a.p0 + c)));
        a.p1[c] = add(ld(a.r1 + c), mul(beta, ld(a.p1 + c)));
        if (better) a.out[c] = ld(a.x + c);
      }
    }
    if (better) best_res = res_new;
    dot_r = new_dot_r;
    res = res_new;
    ++iters;
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.res_out[0] = best_res;
    a.it_out[0] = iters;
  }
}

// Blocks of a cooperative launch: at most what can be co-resident, and no
// more than there are tiles.
cudaError_t resident_blocks(const void* kernel, long long want, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  long long b = (long long)per_sm * sms;
  if (want < b) b = want;
  *blocks = (int)(b < 1 ? 1 : b);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// rhs, x0, the six face weights, scaling and the masks fine, coarse, orig,
// solve, dot: [nz, ny, nx] float32 (the masks 0/1; orig the even-parity
// origin mask).  out: [nz, ny, nx]; res: [1]; iters: [1] int32; scratch:
// [7, nz, ny, nx]; part: [3, n_tiles] with n_tiles = ceil(items / 256),
// items = voxels / 8 when has_coarse (extents even), else voxels; n_tiles
// at most 256 * 64.
int bicg_solve(const float* rhs, const float* x0, const float* wpx,
               const float* wnx, const float* wpy, const float* wny,
               const float* wpz, const float* wnz, const float* scaling,
               const float* fine, const float* coarse, const float* orig,
               const float* solve, const float* dotm, float* out, float* res,
               int* iters, float* scratch, float* part, int nz, int ny, int nx,
               int has_coarse, int max_iter, float stop_res, float stop_inc,
               void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || (long long)nz * ny * nx >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (has_coarse && ((nz | ny | nx) & 1)) return (int)cudaErrorInvalidValue;
  const long long n = (long long)nz * ny * nx;
  const long long items = has_coarse ? n / 8 : n;
  const long long n_tiles = (items + kThreads - 1) / kThreads;
  if (n_tiles > (long long)kThreads * kMaxLevel2) return (int)cudaErrorInvalidValue;
  Args a{rhs,    x0,          wpx,         wnx,         wpy,         wny,
         wpz,    wnz,         scaling,     fine,        coarse,      orig,
         solve,  dotm,        out,         res,         iters,       scratch,
         scratch + n, scratch + 2 * n, scratch + 3 * n, scratch + 4 * n,
         scratch + 5 * n, scratch + 6 * n, part, nz, ny, nx, max_iter,
         stop_res, stop_inc};
  const void* kernel = has_coarse ? (const void*)bicg_kernel<true>
                                  : (const void*)bicg_kernel<false>;
  int blocks = 0;
  cudaError_t err = resident_blocks(kernel, n_tiles, &blocks);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)blocks),
                                    dim3(kThreads), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
