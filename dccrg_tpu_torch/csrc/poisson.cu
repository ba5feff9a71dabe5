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
// weight 0.  The masks fine, coarse and orig multiply as 0/1 (a nonzero
// entry is read as 1); solve and dot select.
//
// Work items: one thread a 2x2x2 block when `has_coarse` (extents even), so
// the pool and broadcast of a coarse leaf stay in registers; one thread a
// voxel otherwise (any extents).  A tile is 256 consecutive items (thread t
// of a CTA takes item t of each of its tiles); a CTA owns its tiles for the
// whole solve, cut by the launch plan (ops/poisson_kernel.py::
// bicg_solve_plan), at most one CTA an SM.
//
// Two barriers an iteration:
//   A  Ap0 = A·p0, ATp1 = Aᵀ·p1 (masked to solve rows), partials of
//      dot(p1, Ap0)
//   B  alpha; x += a·p0, r0 -= a·Ap0, r1 -= a·ATp1, partials of dot(r0, r1)
//      and dot(r0, r0); the new r0 and r1 published for the neighbours
// and after B's barrier every CTA has beta and forms p = r + beta·p itself,
// for its own voxels and for every neighbour value its next matvec reads,
// from the published r and the old p: the same arithmetic as a third phase,
// so the same bits, without its barrier.
//
// Two forms (the plan's `form`):
//   box  the CTA's tiles form a box of voxels (a brick): whole tiles (whole
//        planes, rows or row segments of items) stacked in z, y and x, or
//        the whole grid in one CTA.  p0 and p1 live in
//        shared memory with a one-voxel halo on every face; x, r0, r1, the
//        best x, Ap0, Aᵀp1, the diagonal and the masks (as bits) of a
//        thread's at most 8 voxels in registers; the six face weights in
//        shared memory (each axis's pair with one plane on the side its
//        transpose reads).  Only the
//        bricks' face voxels of r0 and r1 go through global memory (L2) each
//        iteration; the halo's p is folded from them.
//   l2   any other cut (shapes whose tiles form no box, grids too large
//        to hold, bricks whose weights do not fit beside the p boxes): the
//        state lives in global memory, p in two parity
//        buffers a vector, and a neighbour's p is folded on the fly from its
//        published r and old p.
//
// Reductions: each CTA reduces its own tiles' partials once (one warp a
// tile and dot, in registers); after a barrier every CTA reduces the tile
// partials to the totals, one warp a group of 256, so every CTA holds the
// same scalars and leaves the loop at the same iteration: the kernel stops
// at the first inactive iteration, where the TPU kernel runs frozen
// iterations up to max_iter; the outputs are the same.
//
// Arithmetic and order are part of the contract: every product and sum goes
// through __fmul_rn / __fadd_rn / __fsub_rn (the build also passes
// -fmad=false), divisions and the square root are correctly rounded, and
// each expression keeps the JAX kernel body's association.  Every dot is
// reduced in one order that depends on the shape alone (blocked_sum in
// ops/poisson_kernel.py), never on the cut: a coarse item's 8 products as
// the tree (w[e] + w[e+4]) ... at strides 4, 2, 1 (e = dz*4 + dy*2 + dx), the
// 256 items of a tile as the tree at strides 128 ... 1, and the tile
// partials again in tiles of 256, level by level, zeros padding each level.
// So the kernel equals its plain twin (bicg_solve_plain) bitwise, up to the
// sign of zero, on any card.
//
// Bound on this card: operations.  The masked solve needs 48 f32 operations
// a voxel an iteration: the matvec and its transpose 13 each, their solve
// masks 2, three masked dots 3 each, the x / r0 / r1 / p0 / p1 updates 2
// each and the best-x copy 1.  Coarse rows add 4 to each matvec (the coarse
// mask 1, the block pool 7/8 and origin product 1/8, the fine product 1, the
// final sum 1): 56.  At 64^3 voxels and 60 iterations that is ~0.013 ms
// (0.011 ms uniform) at 67 TFLOP/s, against ~0.005 ms to read the 14 input
// arrays and write the solution once.  What sets the pace is the two grid
// barriers an iteration and the in-SM latency of the matvecs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// a value this kernel writes and other CTAs read after a grid barrier:
// through L2, never a stale L1 line
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

constexpr int kThreads = 256;   // threads a CTA = items a tile
constexpr int kMaxLevel2 = 64;  // second-level partials a dot at most
constexpr int kMaxVoxels = 8;   // voxels a thread holds in the box form
constexpr int kDots = 3;        // partial slots: dot(p1,Ap0), (r0,r1), (r0,r0)
// a brick's extents at most (z, y, x): a voxel's local coordinates pack
// into 10 / 11 / 11 bits
constexpr int kMaxBrick[3] = {1024, 2048, 2048};

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
  float* r0;       // published residuals (box: face voxels only)
  float* r1;
  float* x;        // l2 form: the iterate, p in parity pairs, Ap0, Aᵀp1
  float* p0[2];
  float* p1[2];
  float* ap;
  float* atp;
  float* part;     // [3, n_tiles] tile partials of the three dots
  int nz, ny, nx, max_iter;
  float stop_res, stop_inc;
  int n_items, n_tiles;
  int tiles_per_cta;            // box: k tiles a CTA
  int bz, by, bx;               // box: a brick's extents in voxels
  int tp, tr, tw;               // box: a tile's extents in items (0: runs)
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

// The six weights the matvec at one voxel reads: its own (fwd) and its
// neighbours' on the side each transpose term comes from (rev).
struct Wts {
  float px, nx, py, ny, pz, nz;
};

// face part of A·v (the JAX body's apply_fwd), or of Aᵀ·v (apply_rev) with
// the neighbours' weights; v[0..5] = v at x+1, x-1, y+1, y-1, z+1, z-1:
//   fwd  C = (wpx v[x+1] + wnx v[x-1]) + wpy v[y+1] + wny v[y-1] + ...
//   rev  C = (wpx[x-1] v[x-1] + wnx[x+1] v[x+1]) + wpy[y-1] v[y-1] + ...
__device__ __forceinline__ float face(const Wts& w, const float* v, bool rev) {
  float C;
  if (!rev) {
    C = add(mul(w.px, v[0]), mul(w.nx, v[1]));
    C = add(add(C, mul(w.py, v[2])), mul(w.ny, v[3]));
    C = add(add(C, mul(w.pz, v[4])), mul(w.nz, v[5]));
  } else {
    C = add(mul(w.px, v[1]), mul(w.nx, v[0]));
    C = add(add(C, mul(w.py, v[3])), mul(w.ny, v[2]));
    C = add(add(C, mul(w.pz, v[5])), mul(w.nz, v[4]));
  }
  return C;
}

// the global weights at voxel c (fwd) or at its neighbours (rev)
__device__ __forceinline__ Wts global_wts(const Args& a, int c, const Nbr& n,
                                          bool rev) {
  Wts w;
  w.px = __ldg(a.wpx + (rev ? n.xm : c));
  w.nx = __ldg(a.wnx + (rev ? n.xp : c));
  w.py = __ldg(a.wpy + (rev ? n.ym : c));
  w.ny = __ldg(a.wny + (rev ? n.yp : c));
  w.pz = __ldg(a.wpz + (rev ? n.zm : c));
  w.nz = __ldg(a.wnz + (rev ? n.zp : c));
  return w;
}

// the coarse pool and broadcast of one item's face parts C[8], in place:
//   pooled = the roll-chain tree at the origin (x pairs, then y, then z)
//   times orig[origin]; C[e] = fine C[e] + pooled
// (the TPU kernel's broadcast adds only zeros to pooled)
__device__ __forceinline__ void pool(float* C, const float* coarse,
                                     const float* fine, float orig) {
  float s[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = mul(C[e], coarse[e]);
  float pooled = add(add(add(s[0], s[1]), add(s[2], s[3])),
                     add(add(s[4], s[5]), add(s[6], s[7])));
  pooled = mul(pooled, orig);
#pragma unroll
  for (int e = 0; e < 8; ++e) C[e] = add(mul(fine[e], C[e]), pooled);
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

// the tree of 256 values at strides 128, 64, ..., 1 in one warp: lane l
// loads values l, l+32, ..., l+224; the total lands in lane 0
template <class Load>
__device__ __forceinline__ float warp_tree(Load load) {
  const int lane = threadIdx.x & 31;
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = load(lane + 32 * k);
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = add(v[k], v[k + 4]);
  v[0] = add(v[0], v[2]);
  v[1] = add(v[1], v[3]);
  float r = add(v[0], v[1]);
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) r = add(r, __shfl_down_sync(0xffffffffu, r, h));
  return r;
}

// Shared scratch of the reductions: staged item values (nd dots x up to k
// tiles x 256), the second level (kDots x kMaxLevel2) and the totals.
struct Red {
  float* stage;
  float* lvl;
  float* tot;
};

// The tile partials of `nd` dots over `nt` tiles whose item values each
// thread staged at stage[(d * nt + j) * 256 + t]: one warp a tile and dot;
// written to part[slot[d] * n_tiles + tid[j]].
__device__ __forceinline__ void tile_partials(const Args& a, const Red& red,
                                              int nd, const int* slot,
                                              const int* tid, int nt) {
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  for (int g = warp; g < nd * nt; g += kThreads / 32) {
    const float* src = red.stage + g * kThreads;
    const float r = warp_tree([&](int i) { return src[i]; });
    if ((threadIdx.x & 31) == 0)
      a.part[slot[g / nt] * a.n_tiles + tid[g % nt]] = r;
  }
}

// The totals of `nd` dots from their tile partials (slots slot[d]), in
// every thread: the tiles' level, then the tree of the second-level
// partials (zeros past the end) until one value is left.
__device__ __forceinline__ void totals(const Args& a, const Red& red, int nd,
                                       const int* slot, float* out) {
  const int n = a.n_tiles;
  if (n == 1) {
    for (int d = 0; d < nd; ++d) out[d] = ld(a.part + slot[d] * n);
    return;
  }
  const int m = (n + kThreads - 1) / kThreads;
  const int warp = threadIdx.x >> 5;
  for (int g = warp; g < nd * m; g += kThreads / 32) {
    const int d = g / m, j = g % m;
    const float* src = a.part + slot[d] * n + j * kThreads;
    const int left = n - j * kThreads;
    const float r = warp_tree([&](int i) { return i < left ? ld(src + i) : 0.f; });
    if ((threadIdx.x & 31) == 0) red.lvl[d * kMaxLevel2 + j] = r;
  }
  __syncthreads();
  if (m == 1) {
    for (int d = 0; d < nd; ++d) out[d] = red.lvl[d * kMaxLevel2];
    return;
  }
  if (warp < nd) {
    const float* src = red.lvl + warp * kMaxLevel2;
    const float r = warp_tree([&](int i) { return i < m ? src[i] : 0.f; });
    if ((threadIdx.x & 31) == 0) red.tot[warp] = r;
  }
  __syncthreads();
  for (int d = 0; d < nd; ++d) out[d] = red.tot[d];
}

__device__ __forceinline__ float as01(const float* m, int c) {
  return __ldg(m + c) != 0.f ? 1.f : 0.f;
}

// ------------------------------------------------------------ box form

// floats of shared memory the box form needs: p0 and p1 boxes, the six
// weights (each axis's pair with one plane more), the halo table (two ints
// a halo cell), the reduction scratch
__host__ __device__ __forceinline__ long long box_floats(int bz, int by, int bx,
                                                        int k) {
  long long n = 2LL * (bz + 2) * (by + 2) * (bx + 2);
  n += 2LL * ((long long)bz * by * (bx + 1) + (long long)bz * (by + 1) * bx +
              (long long)(bz + 1) * by * bx);
  n += 4LL * ((long long)bz * by + (long long)bz * bx + (long long)by * bx);
  return n + 2LL * k * kThreads + kDots * kMaxLevel2 + 4;
}

// halo cells a thread loads at once
constexpr int kHaloBatch = 8;

template <bool kCoarse>
__global__ void __launch_bounds__(kThreads, 1) bicg_box_kernel(Args a) {
  constexpr int E = Item<kCoarse>::E;
  constexpr int K = kMaxVoxels / E;  // items a thread at most
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x;
  const int k = a.tiles_per_cta;
  const int nz = a.nz, ny = a.ny, nx = a.nx;
  const int BZ = a.bz, BY = a.by, BX = a.bx;
  const int SX = BX + 2, SY = BY + 2;  // box strides
  const int nbox = (BZ + 2) * SY * SX;
  float* P0 = smem;
  float* P1 = P0 + nbox;
  const int nwx = BZ * BY * (BX + 1), nwy = BZ * (BY + 1) * BX,
            nwz = (BZ + 1) * BY * BX;
  float* WPX = P1 + nbox;
  float* WNX = WPX + nwx;
  float* WPY = WNX + nwx;
  float* WNY = WPY + nwy;
  float* WPZ = WNY + nwy;
  float* WNZ = WPZ + nwz;
  // the halo of the p boxes: the six faces (no edges or corners), as box
  // indices HB and global voxels HG
  const int hx = BZ * BY, hy = BZ * BX, hz = BY * BX;
  const int n_halo = 2 * (hx + hy + hz);
  int* HB = reinterpret_cast<int*>(WNZ + nwz);
  int* HG = HB + n_halo;
  Red red;
  red.stage = reinterpret_cast<float*>(HG + n_halo);
  red.lvl = red.stage + 2 * k * kThreads;
  red.tot = red.lvl + kDots * kMaxLevel2;

  // the brick's origin (items), and item t of the CTA's tile j: the whole
  // grid's consecutive runs (tp = 0), or tile j of the brick's tiles in
  // z, y, x order, its items in the grid's order
  constexpr int sh = kCoarse ? 1 : 0;
  const int Zi = nz >> sh, Yi = ny >> sh, Xi = nx >> sh;
  const int bzi = BZ >> sh, byi = BY >> sh, bxi = BX >> sh;
  const bool runs = a.tp == 0;
  int ozi = 0, oyi = 0, oxi = 0;
  if (!runs) {
    const int nbx = Xi / bxi, nby = Yi / byi;
    oxi = blockIdx.x % nbx * bxi;
    oyi = blockIdx.x / nbx % nby * byi;
    ozi = blockIdx.x / (nbx * nby) * bzi;
  }
  const int oz = ozi << sh, oy = oyi << sh, ox = oxi << sh;
  auto item = [&](int j, int tt) {
    if (runs) return j * kThreads + tt;
    const int ntx = bxi / a.tw, nty = byi / a.tr;
    const int jx = j % ntx, jy = j / ntx % nty, jz = j / (ntx * nty);
    const int iz = jz * a.tp + tt / (a.tr * a.tw);
    const int iy = jy * a.tr + tt / a.tw % a.tr;
    const int ix = jx * a.tw + tt % a.tw;
    return ((ozi + iz) * Yi + oyi + iy) * Xi + oxi + ix;
  };
  __shared__ int TID[kMaxVoxels];  // the global index of each tile
  if (t < k) TID[t] = item(t, 0) / kThreads;
  auto wrap = [](int v, int n) { return v < 0 ? v + n : (v >= n ? v - n : v); };
  auto gidx = [&](int lz, int ly, int lx) {
    return (wrap(oz + lz, nz) * ny + wrap(oy + ly, ny)) * nx + wrap(ox + lx, nx);
  };
  auto bidx = [&](int lz, int ly, int lx) {
    return ((lz + 1) * SY + ly + 1) * SX + lx + 1;
  };

  // weights: wpx / wpy / wpz with a plane on the minus side, wnx / wny /
  // wnz with one on the plus side (what the transpose reads)
  for (int i = t; i < nwx; i += kThreads) {
    const int jx = i % (BX + 1), q = i / (BX + 1), ly = q % BY, lz = q / BY;
    WPX[i] = __ldg(a.wpx + gidx(lz, ly, jx - 1));
    WNX[i] = __ldg(a.wnx + gidx(lz, ly, jx));
  }
  for (int i = t; i < nwy; i += kThreads) {
    const int lx = i % BX, q = i / BX, jy = q % (BY + 1), lz = q / (BY + 1);
    WPY[i] = __ldg(a.wpy + gidx(lz, jy - 1, lx));
    WNY[i] = __ldg(a.wny + gidx(lz, jy, lx));
  }
  for (int i = t; i < nwz; i += kThreads) {
    const int lx = i % BX, q = i / BX, ly = q % BY, jz = q / BY;
    WPZ[i] = __ldg(a.wpz + gidx(jz - 1, ly, lx));
    WNZ[i] = __ldg(a.wnz + gidx(jz, ly, lx));
  }
  for (int i = t; i < n_halo; i += kThreads) {
    int lz, ly, lx, r = i;
    if (r < 2 * hx) {
      const int q = r % hx;
      lz = q / BY, ly = q % BY, lx = r < hx ? -1 : BX;
    } else if ((r -= 2 * hx) < 2 * hy) {
      const int q = r % hy;
      lz = q / BX, lx = q % BX, ly = r < hy ? -1 : BY;
    } else {
      r -= 2 * hy;
      const int q = r % hz;
      ly = q / BX, lx = q % BX, lz = r < hz ? -1 : BZ;
    }
    HB[i] = bidx(lz, ly, lx);
    HG[i] = gidx(lz, ly, lx);
  }

  // this thread's voxels: item t of each of the CTA's tiles, each as its
  // local (lz, ly, lx) packed 10 / 11 / 11 bits
  float X[kMaxVoxels], R0[kMaxVoxels], R1[kMaxVoxels], BEST[kMaxVoxels],
      SC[kMaxVoxels];
  unsigned L[kMaxVoxels];
  unsigned m_fine = 0, m_coarse = 0, m_solve = 0, m_dot = 0, m_orig = 0,
           m_face = 0, m_item = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j >= k) continue;
    const int b = item(j, t);
    if (b >= a.n_items) continue;
    m_item |= 1u << j;
    const Item<kCoarse> it(b, nz, ny, nx);
    if (__ldg(a.orig + it.c[0]) != 0.f) m_orig |= 1u << j;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int v = j * E + e, c = it.c[e];
      const int lz = it.z[e] - oz, ly = it.y[e] - oy, lx = it.x[e] - ox;
      L[v] = ((unsigned)lz << 22) | ((unsigned)ly << 11) | (unsigned)lx;
      if (lz == 0 || lz == BZ - 1 || ly == 0 || ly == BY - 1 || lx == 0 ||
          lx == BX - 1)
        m_face |= 1u << v;
      X[v] = BEST[v] = __ldg(a.x0 + c);
      SC[v] = __ldg(a.scaling + c);
      if (__ldg(a.fine + c) != 0.f) m_fine |= 1u << v;
      if (__ldg(a.coarse + c) != 0.f) m_coarse |= 1u << v;
      if (__ldg(a.solve + c) != 0.f) m_solve |= 1u << v;
      if (__ldg(a.dotm + c) != 0.f) m_dot |= 1u << v;
    }
  }
  auto bit = [](unsigned m, int v) { return (m >> v) & 1u; };
  auto f01 = [](unsigned m, int v) { return ((m >> v) & 1u) ? 1.f : 0.f; };
  auto lz_of = [&](int v) { return (int)(L[v] >> 22); };
  auto ly_of = [&](int v) { return (int)((L[v] >> 11) & 2047u); };
  auto lx_of = [&](int v) { return (int)(L[v] & 2047u); };
  auto box_of = [&](int v) { return bidx(lz_of(v), ly_of(v), lx_of(v)); };
  auto glob_of = [&](int v) {
    return ((oz + lz_of(v)) * ny + oy + ly_of(v)) * nx + ox + lx_of(v);
  };

  // the matvec (or its transpose) of the box `Pv` at item j's voxels
  auto matvec = [&](const float* Pv, bool rev, int j, float* y) {
    float Cf[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int v = j * E + e;
      const int lz = lz_of(v), ly = ly_of(v), lx = lx_of(v);
      const int bi = bidx(lz, ly, lx);
      const float nb[6] = {Pv[bi + 1], Pv[bi - 1], Pv[bi + SX], Pv[bi - SX],
                           Pv[bi + SX * SY], Pv[bi - SX * SY]};
      const int ix = (lz * BY + ly) * (BX + 1) + lx;
      const int iy = (lz * (BY + 1) + ly) * BX + lx;
      const int iz = (lz * BY + ly) * BX + lx;
      Wts w;
      w.px = WPX[ix + (rev ? 0 : 1)];
      w.nx = WNX[ix + (rev ? 1 : 0)];
      w.py = WPY[iy + (rev ? 0 : BX)];
      w.ny = WNY[iy + (rev ? BX : 0)];
      w.pz = WPZ[iz + (rev ? 0 : BY * BX)];
      w.nz = WNZ[iz + (rev ? BY * BX : 0)];
      Cf[e] = face(w, nb, rev);
    }
    if constexpr (kCoarse) {
      float cm[8], fm[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        cm[e] = f01(m_coarse, j * 8 + e);
        fm[e] = f01(m_fine, j * 8 + e);
      }
      pool(Cf, cm, fm, f01(m_orig, j));
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int v = j * E + e;
      y[e] = add(mul(SC[v], Pv[box_of(v)]), Cf[e]);
    }
  };

  // initial residual r = solve ? rhs - A x0 : 0, from x0 in global memory;
  // p0 = p1 = r0 = r1 = r; partials of dot(r0, r0)
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float w[E];
    if (bit(m_item, j)) {
      float Cf[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int v = j * E + e, c = glob_of(v);
        const Nbr n = neighbours(c, oz + lz_of(v), oy + ly_of(v), ox + lx_of(v),
                                 nz, ny, nx);
        const float nb[6] = {__ldg(a.x0 + n.xp), __ldg(a.x0 + n.xm),
                             __ldg(a.x0 + n.yp), __ldg(a.x0 + n.ym),
                             __ldg(a.x0 + n.zp), __ldg(a.x0 + n.zm)};
        Cf[e] = face(global_wts(a, c, n, false), nb, false);
      }
      if constexpr (kCoarse) {
        float cm[8], fm[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          cm[e] = f01(m_coarse, j * 8 + e);
          fm[e] = f01(m_fine, j * 8 + e);
        }
        pool(Cf, cm, fm, f01(m_orig, j));
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int v = j * E + e, c = glob_of(v);
        const float Ax = add(mul(SC[v], X[v]), Cf[e]);
        const float r = bit(m_solve, v) ? sub(__ldg(a.rhs + c), Ax) : 0.f;
        R0[v] = R1[v] = r;
        P0[box_of(v)] = P1[box_of(v)] = r;
        if (bit(m_face, v)) {
          a.r0[c] = r;
          a.r1[c] = r;
        }
        w[e] = bit(m_dot, v) ? mul(r, r) : 0.f;
      }
    }
    if (j < k) red.stage[j * kThreads + t] = bit(m_item, j) ? item_sum<E>(w) : 0.f;
  }
  const int s2[1] = {2}, s0[1] = {0}, s12[2] = {1, 2};
  tile_partials(a, red, 1, s2, TID, k);

  // the published r of kHaloBatch halo cells from `base` (their loads all
  // in flight at once), and p = r + beta p over them (beta = 0 and p = r at
  // the start)
  float h0[kHaloBatch], h1[kHaloBatch];
  auto halo_load = [&](int base) {
#pragma unroll
    for (int u = 0; u < kHaloBatch; ++u) {
      const int i = base + u * kThreads + t;
      if (i < n_halo) {
        const int g = HG[i];
        h0[u] = ld(a.r0 + g);
        h1[u] = ld(a.r1 + g);
      }
    }
  };
  auto halo_fold = [&](int base, bool fresh, float beta) {
#pragma unroll
    for (int u = 0; u < kHaloBatch; ++u) {
      const int i = base + u * kThreads + t;
      if (i < n_halo) {
        const int bi = HB[i];
        P0[bi] = fresh ? h0[u] : add(h0[u], mul(beta, P0[bi]));
        P1[bi] = fresh ? h1[u] : add(h1[u], mul(beta, P1[bi]));
      }
    }
  };
  auto halo = [&](bool fresh, float beta) {
    // the first batch is already loaded
    for (int base = 0; base < n_halo; base += kHaloBatch * kThreads) {
      if (base) halo_load(base);
      halo_fold(base, fresh, beta);
    }
  };

  grid.sync();
  halo_load(0);
  float tot[2];
  totals(a, red, 1, s2, tot);
  float dot_r = tot[0];
  float res = __fsqrt_rn(fabsf(dot_r));
  float best_res = res;
  halo(true, 0.f);
  __syncthreads();

  int iters = 0;
  while (iters < a.max_iter && res > a.stop_res && dot_r != 0.f &&
         res <= mul(best_res, a.stop_inc)) {
    // A: Ap0, ATp1, partials of dot(p1, Ap0)
    float AP[kMaxVoxels], ATP[kMaxVoxels];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float w[E];
      if (bit(m_item, j)) {
        float y0[E], y1[E];
        matvec(P0, false, j, y0);
        matvec(P1, true, j, y1);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int v = j * E + e;
          AP[v] = bit(m_solve, v) ? y0[e] : 0.f;
          ATP[v] = bit(m_solve, v) ? y1[e] : 0.f;
          w[e] = bit(m_dot, v) ? mul(P1[box_of(v)], AP[v]) : 0.f;
        }
      }
      if (j < k) red.stage[j * kThreads + t] = bit(m_item, j) ? item_sum<E>(w) : 0.f;
    }
    tile_partials(a, red, 1, s0, TID, k);
    grid.sync();

    // B: the iterate and the residuals, partials of dot(r0, r1), dot(r0, r0)
    totals(a, red, 1, s0, tot);
    const float dot_p = tot[0];
    const float alpha = dot_p != 0.f ? div(dot_r, dot_p) : 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float wa[E], wb[E];
      if (bit(m_item, j)) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int v = j * E + e;
          X[v] = add(X[v], mul(alpha, P0[box_of(v)]));
          R0[v] = sub(R0[v], mul(alpha, AP[v]));
          R1[v] = sub(R1[v], mul(alpha, ATP[v]));
          if (bit(m_face, v)) {
            const int c = glob_of(v);
            a.r0[c] = R0[v];
            a.r1[c] = R1[v];
          }
          wa[e] = bit(m_dot, v) ? mul(R0[v], R1[v]) : 0.f;
          wb[e] = bit(m_dot, v) ? mul(R0[v], R0[v]) : 0.f;
        }
      }
      if (j < k) {
        red.stage[j * kThreads + t] = bit(m_item, j) ? item_sum<E>(wa) : 0.f;
        red.stage[(k + j) * kThreads + t] = bit(m_item, j) ? item_sum<E>(wb) : 0.f;
      }
    }
    tile_partials(a, red, 2, s12, TID, k);
    grid.sync();

    // the search directions (own voxels, and the halo from the published
    // r, its first batch loaded beside the totals) and the best solution
    halo_load(0);
    totals(a, red, 2, s12, tot);
    const float new_dot_r = tot[0];
    const float beta = dot_r != 0.f ? div(new_dot_r, dot_r) : 0.f;
    const float res_new = __fsqrt_rn(fabsf(tot[1]));
    const bool better = res_new < best_res;
#pragma unroll
    for (int v = 0; v < K * E; ++v) {
      if (!bit(m_item, v / E)) continue;
      const int bi = box_of(v);
      P0[bi] = add(R0[v], mul(beta, P0[bi]));
      P1[bi] = add(R1[v], mul(beta, P1[bi]));
      if (better) BEST[v] = X[v];
    }
    halo(false, beta);
    __syncthreads();
    if (better) best_res = res_new;
    dot_r = new_dot_r;
    res = res_new;
    ++iters;
  }
#pragma unroll
  for (int v = 0; v < K * E; ++v)
    if (bit(m_item, v / E)) a.out[glob_of(v)] = BEST[v];
  if (blockIdx.x == 0 && t == 0) {
    a.res_out[0] = best_res;
    a.it_out[0] = iters;
  }
}

// ------------------------------------------------------------- l2 form

template <bool kCoarse>
__global__ void __launch_bounds__(kThreads, 1) bicg_l2_kernel(Args a) {
  constexpr int E = Item<kCoarse>::E;
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x;
  const int nz = a.nz, ny = a.ny, nx = a.nx;
  Red red;
  red.stage = smem;
  red.lvl = smem + 2 * kThreads;
  red.tot = red.lvl + kDots * kMaxLevel2;
  // this CTA's tiles: part blockIdx.x of n_tiles cut into gridDim.x parts
  const int q = a.n_tiles / gridDim.x, rm = a.n_tiles % gridDim.x;
  const int tile0 = blockIdx.x * q + min((int)blockIdx.x, rm);
  const int nt = q + ((int)blockIdx.x < rm ? 1 : 0);
  const int s2[1] = {2}, s0[1] = {0}, s12[2] = {1, 2};

  // the matvec at item `it` with v(c) the p value of voxel c
  auto matvec = [&](const Item<kCoarse>& it, bool rev, auto v, float* y) {
    float Cf[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const Nbr n = neighbours(it.c[e], it.z[e], it.y[e], it.x[e], nz, ny, nx);
      const float nb[6] = {v(n.xp), v(n.xm), v(n.yp), v(n.ym), v(n.zp), v(n.zm)};
      Cf[e] = face(global_wts(a, it.c[e], n, rev), nb, rev);
    }
    if constexpr (kCoarse) {
      float cm[8], fm[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        cm[e] = as01(a.coarse, it.c[e]);
        fm[e] = as01(a.fine, it.c[e]);
      }
      pool(Cf, cm, fm, as01(a.orig, it.c[0]));
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      y[e] = add(mul(__ldg(a.scaling + it.c[e]), v(it.c[e])), Cf[e]);
  };
  auto masked = [](const float* m, int c, float v) {
    return __ldg(m + c) != 0.f ? v : 0.f;
  };

  // x = best x = x0; r0 = r1 = p0 = p1 = solve ? rhs - A x0 : 0
  for (int j = 0; j < nt; ++j) {
    const int b = (tile0 + j) * kThreads + t;
    float w[E];
    if (b < a.n_items) {
      const Item<kCoarse> it(b, nz, ny, nx);
      float Ax[E];
      matvec(it, false, [&](int c) { return __ldg(a.x0 + c); }, Ax);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = it.c[e];
        const float xv = __ldg(a.x0 + c);
        const float r = masked(a.solve, c, sub(__ldg(a.rhs + c), Ax[e]));
        a.x[c] = xv;
        a.out[c] = xv;
        a.r0[c] = a.r1[c] = a.p0[0][c] = a.p1[0][c] = r;
        w[e] = masked(a.dotm, c, mul(r, r));
      }
    }
    red.stage[t] = b < a.n_items ? item_sum<E>(w) : 0.f;
    const int tid[1] = {tile0 + j};
    tile_partials(a, red, 1, s2, tid, 1);
    __syncthreads();
  }
  grid.sync();

  float tot[2];
  totals(a, red, 1, s2, tot);
  float dot_r = tot[0];
  float res = __fsqrt_rn(fabsf(dot_r));
  float best_res = res;
  float beta = 0.f;
  int iters = 0;
  while (iters < a.max_iter && res > a.stop_res && dot_r != 0.f &&
         res <= mul(best_res, a.stop_inc)) {
    // p of this iteration in parity `cur`: the first is r itself; later
    // ones are r + beta·p_old, folded wherever a value is read
    const int cur = iters & 1;
    const bool fresh = iters == 0;
    const float* q0 = a.p0[cur ^ 1];
    const float* q1 = a.p1[cur ^ 1];
    auto pv0 = [&](int c) {
      return fresh ? ld(a.p0[0] + c) : add(ld(a.r0 + c), mul(beta, ld(q0 + c)));
    };
    auto pv1 = [&](int c) {
      return fresh ? ld(a.p1[0] + c) : add(ld(a.r1 + c), mul(beta, ld(q1 + c)));
    };
    // A: Ap0, ATp1, partials of dot(p1, Ap0); this iteration's own p stored
    for (int j = 0; j < nt; ++j) {
      const int b = (tile0 + j) * kThreads + t;
      float w[E];
      if (b < a.n_items) {
        const Item<kCoarse> it(b, nz, ny, nx);
        float y0[E], y1[E];
        matvec(it, false, pv0, y0);
        matvec(it, true, pv1, y1);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int c = it.c[e];
          const float p0 = pv0(c), p1 = pv1(c);
          if (!fresh) {
            a.p0[cur][c] = p0;
            a.p1[cur][c] = p1;
          }
          const float ap = masked(a.solve, c, y0[e]);
          a.ap[c] = ap;
          a.atp[c] = masked(a.solve, c, y1[e]);
          w[e] = masked(a.dotm, c, mul(p1, ap));
        }
      }
      red.stage[t] = b < a.n_items ? item_sum<E>(w) : 0.f;
      const int tid[1] = {tile0 + j};
      tile_partials(a, red, 1, s0, tid, 1);
      __syncthreads();
    }
    grid.sync();

    // B: the iterate and the residuals, partials of dot(r0, r1), dot(r0, r0)
    totals(a, red, 1, s0, tot);
    const float dot_p = tot[0];
    const float alpha = dot_p != 0.f ? div(dot_r, dot_p) : 0.f;
    for (int j = 0; j < nt; ++j) {
      const int b = (tile0 + j) * kThreads + t;
      float wa[E], wb[E];
      if (b < a.n_items) {
        const Item<kCoarse> it(b, nz, ny, nx);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int c = it.c[e];
          a.x[c] = add(ld(a.x + c), mul(alpha, ld(a.p0[cur] + c)));
          const float r0 = sub(ld(a.r0 + c), mul(alpha, ld(a.ap + c)));
          const float r1 = sub(ld(a.r1 + c), mul(alpha, ld(a.atp + c)));
          a.r0[c] = r0;
          a.r1[c] = r1;
          wa[e] = masked(a.dotm, c, mul(r0, r1));
          wb[e] = masked(a.dotm, c, mul(r0, r0));
        }
      }
      red.stage[t] = b < a.n_items ? item_sum<E>(wa) : 0.f;
      red.stage[kThreads + t] = b < a.n_items ? item_sum<E>(wb) : 0.f;
      const int tid[1] = {tile0 + j};
      tile_partials(a, red, 2, s12, tid, 1);
      __syncthreads();
    }
    grid.sync();

    // beta and the best solution so far
    totals(a, red, 2, s12, tot);
    const float new_dot_r = tot[0];
    beta = dot_r != 0.f ? div(new_dot_r, dot_r) : 0.f;
    const float res_new = __fsqrt_rn(fabsf(tot[1]));
    if (res_new < best_res) {
      for (int j = 0; j < nt; ++j) {
        const int b = (tile0 + j) * kThreads + t;
        if (b >= a.n_items) continue;
        const Item<kCoarse> it(b, nz, ny, nx);
#pragma unroll
        for (int e = 0; e < E; ++e) a.out[it.c[e]] = ld(a.x + it.c[e]);
      }
      best_res = res_new;
    }
    dot_r = new_dot_r;
    res = res_new;
    ++iters;
  }
  if (blockIdx.x == 0 && t == 0) {
    a.res_out[0] = best_res;
    a.it_out[0] = iters;
  }
}

// Whether the brick (bz, by, bx) items with tiles of (tp, tr, tw) items is
// one the plan may take for k tiles a CTA of a Z x Y x X item grid
// (ops/poisson_kernel.py::bricks), and its CTAs: the whole grid as one
// brick of consecutive tiles (tp = tr = tw = 0), or boxes of whole tiles
// that cut the grid evenly, the tiles whole planes, whole rows or 256
// items of a row as the grid's extents decide.
bool box_ok(long long k, int Z, int Y, int X, int bz, int by, int bx, int tp,
            int tr, int tw, long long* ctas) {
  const long long L = k * kThreads, n = (long long)Z * Y * X;
  if (tp == 0 && tr == 0 && tw == 0) {
    *ctas = 1;
    return L - kThreads < n && n <= L && bz == Z && by == Y && bx == X;
  }
  int sp, sr, sw;  // the grid's tile shape
  if (kThreads % (X * Y) == 0 && Z % (kThreads / (X * Y)) == 0)
    sp = kThreads / (X * Y), sr = Y, sw = X;
  else if (kThreads % X == 0 && Y % (kThreads / X) == 0)
    sp = 1, sr = kThreads / X, sw = X;
  else if (X % kThreads == 0)
    sp = 1, sr = 1, sw = kThreads;
  else
    return false;
  if (tp != sp || tr != sr || tw != sw || n % L || bz < 1 || by < 1 || bx < 1 ||
      bz % tp || by % tr || bx % tw || Z % bz || Y % by || X % bx ||
      (long long)bz * by * bx != L)
    return false;
  *ctas = n / L;
  return true;
}

}  // namespace

extern "C" {

// rhs, x0, the six face weights, scaling and the masks fine, coarse, orig,
// solve, dot: [nz, ny, nx] float32 (fine / coarse / orig 0 or 1; orig the
// even-parity origin mask).  out: [nz, ny, nx]; res: [1]; iters: [1] int32;
// scratch: [9, nz, ny, nx] (r0, r1, x, p0 x2, p1 x2, Ap0, Aᵀp1; the box form
// uses the first two); part: [3, n_tiles] with n_tiles = ceil(items / 256),
// items = voxels / 8 when has_coarse (extents even), else voxels; n_tiles
// at most 256 * 64.  The plan (bicg_solve_plan): form 1 = box with k tiles
// a CTA, the brick (bz, by, bx) voxels and its tiles' (tp, tr, tw) items;
// form 0 = l2 with `ctas` CTAs; smem_bytes of dynamic shared memory.  The launcher recomputes
// the cut and what it needs and returns cudaErrorInvalidValue for a plan
// made for another shape or short of it.
int bicg_solve(const float* rhs, const float* x0, const float* wpx,
               const float* wnx, const float* wpy, const float* wny,
               const float* wpz, const float* wnz, const float* scaling,
               const float* fine, const float* coarse, const float* orig,
               const float* solve, const float* dotm, float* out, float* res,
               int* iters, float* scratch, float* part, int nz, int ny, int nx,
               int has_coarse, int max_iter, float stop_res, float stop_inc,
               int form, int k, int ctas, int bz, int by, int bx, int tp,
               int tr, int tw, int smem_bytes, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || (long long)nz * ny * nx >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (has_coarse && ((nz | ny | nx) & 1)) return (int)cudaErrorInvalidValue;
  const long long n = (long long)nz * ny * nx;
  const int E = has_coarse ? 8 : 1;
  const long long items = n / E;
  const long long n_tiles = (items + kThreads - 1) / kThreads;
  if (n_tiles > (long long)kThreads * kMaxLevel2 || ctas < 1 || ctas > n_tiles)
    return (int)cudaErrorInvalidValue;
  Args a{rhs,    x0,   wpx,     wnx,  wpy,     wny,   wpz,   wnz,
         scaling, fine, coarse, orig, solve,   dotm,  out,   res,
         iters,  scratch, scratch + n, scratch + 2 * n,
         {scratch + 3 * n, scratch + 4 * n}, {scratch + 5 * n, scratch + 6 * n},
         scratch + 7 * n, scratch + 8 * n, part, nz, ny, nx, max_iter,
         stop_res, stop_inc, (int)items, (int)n_tiles, k, bz, by, bx, tp, tr, tw};
  const void* kernel;
  long long need;
  if (form == 1) {
    const int sh = has_coarse ? 1 : 0;
    long long want = 0;
    if (k < 1 || k * E > kMaxVoxels || bz > kMaxBrick[0] || by > kMaxBrick[1] ||
        bx > kMaxBrick[2] || ((bz | by | bx) & sh) ||
        !box_ok(k, nz >> sh, ny >> sh, nx >> sh, bz >> sh, by >> sh, bx >> sh,
                tp, tr, tw, &want) ||
        ctas != want)
      return (int)cudaErrorInvalidValue;
    need = 4 * box_floats(bz, by, bx, k);
    kernel = has_coarse ? (const void*)bicg_box_kernel<true>
                        : (const void*)bicg_box_kernel<false>;
  } else if (form == 0) {
    need = 4LL * (2 * kThreads + kDots * kMaxLevel2 + 4);
    kernel = has_coarse ? (const void*)bicg_l2_kernel<true>
                        : (const void*)bicg_l2_kernel<false>;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (need > smem_bytes) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                        smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if ((long long)per_sm * sms < ctas) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)ctas), dim3(kThreads),
                                    args, (size_t)smem_bytes,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
