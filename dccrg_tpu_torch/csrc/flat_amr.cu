// Flat inflated-voxel AMR advection: two whole-run kernels that replace the
// Pallas kernels of dccrg_tpu/ops/flat_amr.py, behind a plain C interface
// (each launcher returns the launch's cudaError_t).
//
//   flat_amr_run  <- make_flat_amr_run        (leaf levels {0, 1})
//   flat_ml_run   <- make_flat_ml_run_pallas  (3 or more leaf levels)
//
// Both advance a dense voxel array V [nz, ny, nx] (x fastest) a whole run of
// steps in one cooperative launch and write the result to `out`.  Every axis
// wraps: the array covers the whole domain, and non-periodic wrap faces
// already carry weight 0.  The face weights arrive premultiplied by dt.
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
//
// Layout on chip (both kernels).  The grid is cut into pz x py x px bricks,
// one CTA each (at most one CTA an SM); brick boundaries are aligned to the
// kernel's pooling cube (2 voxels for flat_amr_run, E = 2^(kmax+1) for
// flat_ml_run), so no pooled block straddles two CTAs.  Part i of n cells
// into p parts starts at i*(n/p) + min(i, n%p) and holds n/p (+1 for
// i < n%p) cells.  The plan (ops/flat_amr.py: flat_amr_run_plan,
// flat_ml_run_plan) picks the cut and the placement; the launcher checks it
// against the shape and takes it as given.  A CTA keeps in shared memory
// for the whole run:
//   A        its brick's density with a one-voxel halo on every face,
//            [tz+2][ty+2][tx+2] (one box, or two for ping-pong, below);
//   Wx, Wy, Wz  when the plan puts the weights on chip: each axis's (wp, wn)
//            pair over the brick and one plane on that axis's minus side,
//            [tz][ty][tx+2] (one pad a row), [tz][ty+1][tx], [tz+1][ty][tx]:
//            the minus-face flux reads the weights of the voxel below,
//            which for the brick's first plane belong to the neighbour
//            brick and never change.  Otherwise the weights are read from
//            L2 each step;
//   T        the halo exchange's table (below).
// Only density crosses bricks: after a step each CTA writes the edge planes
// of split axes to a global face buffer (double-buffered by step parity,
// written and read around L1, each cell's place fixed for the run), waits
// at the grid barrier and reads its neighbours' planes into A's halo; an axis
// cut into one part fills its halo from the brick's own opposite plane.
//
// A thread owns up to kMaxUnits "units" (2x2x2 blocks) of the brick for the
// whole run and keeps their per-voxel masks (upd_f / upd_c, or updf / pool
// and the captured origins' cap values) in registers; a step computes the
// units' new values into registers, waits for the CTA, and writes them into
// the one box A.  flat_ml_run with no capturing level (a plain update of any
// extents) instead owns single voxels, keeps two boxes and reads updf from
// L2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// halo cells a thread moves in one pass of the exchange (all loads of a
// pass issued before its first store)
constexpr int kSlots = 6;
// threads a CTA at most (the single-voxel kernel)
constexpr int kThreads = 512;
// 2x2x2 units a thread holds in registers at most
constexpr int kMaxUnits = 4;

// halo cells a thread of a unit kernel holds in registers: one unit leaves
// registers to spare, more do not
__host__ __device__ constexpr int held_slots(int kb) { return kb == 1 ? kSlots : 0; }

// threads a CTA at most of a unit kernel whose threads hold kb units each:
// fewer threads leave each more of the SM's 64K registers (255, 144, 168)
__host__ __device__ constexpr int unit_threads(int kb) {
  return kb == 1 ? 256 : kb == 2 ? 448 : 384;
}

// the six face weights, x / y / z, + then - side
struct Weights {
  const float* px;
  const float* nx;
  const float* py;
  const float* ny;
  const float* pz;
  const float* nz;
};

// part i of n cells cut into p parts: the first n % p parts hold one more
__host__ __device__ __forceinline__ void part(int n, int p, int i, int& start,
                                              int& len) {
  const int q = n / p, r = n % p;
  start = i * q + (i < r ? i : r);
  len = q + (i < r ? 1 : 0);
}

// v mod n for v >= -n
__device__ __forceinline__ int wrap(int v, int n) { return (v % n + n) % n; }

// floats of the on-chip layout of a brick (tz, ty, tx): one pad float, the
// density box (`boxes` of them), the weights when `wsm` (x rows padded to
// tx + 2, one pad float), `pool` floats of pooling scratch, and the halo
// exchange's table of `halo` items and 12 face entries
// (ops/flat_amr.py::flat_smem_bytes is 4 x this).  The pads put every
// even-x voxel pair of a unit kernel's box and layouts on 8 bytes.
__host__ __device__ inline long long layout_floats(long long tz, long long ty,
                                                   long long tx, int boxes,
                                                   bool wsm, long long pool,
                                                   long long halo) {
  long long n = 1 + boxes * (tz + 2) * (ty + 2) * (tx + 2) + pool + halo + 12;
  if (wsm) n += 1 + 2 * (tz * ty * (tx + 2) + tz * (ty + 1) * tx + (tz + 1) * ty * tx);
  return n;
}

// halo cells a brick (tz, ty, tx) exchanges a step: two planes on each
// split axis
__host__ __device__ inline long long halo_cells(long long tz, long long ty,
                                                long long tx, bool sz, bool sy,
                                                bool sx) {
  return 2 * (sx * tz * ty + sy * tz * tx + sz * ty * tx);
}

// floats of pooling scratch a brick of `tvox` voxels needs at kmax: one
// value a 4-cube for doubling 2, one an 8-cube for doubling 3
__host__ __device__ inline long long pool_floats(long long tvox, int kmax) {
  return (kmax >= 2 ? tvox / 64 : 0) + (kmax >= 3 ? tvox / 512 : 0);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// This CTA's brick and its on-chip layout.
struct Brick {
  int nz, ny, nx;          // the grid
  int x0, y0, z0;          // the brick's origin (voxels)
  int tx, ty, tz;          // its extent
  int sx, sy, sz;          // axes cut into more than one part
  int AX, AXY, nA;         // the density box: strides, size
  int XR, XP, YR, YP, ZP;  // weight layouts' strides (z rows are tx)
  int nWx, nWy, nWz;       // weight layouts' sizes
  int bi, bj, bk, px, py, pz;
  int cta, fs;

  __device__ __forceinline__ void init(int nz_, int ny_, int nx_, int pz_, int py_,
                                       int px_, int align, int fs_) {
    nz = nz_, ny = ny_, nx = nx_, pz = pz_, py = py_, px = px_, fs = fs_;
    cta = blockIdx.x;
    bi = cta % px, bj = (cta / px) % py, bk = cta / (px * py);
    part(nx / align, px, bi, x0, tx);
    part(ny / align, py, bj, y0, ty);
    part(nz / align, pz, bk, z0, tz);
    x0 *= align, tx *= align, y0 *= align, ty *= align, z0 *= align, tz *= align;
    sx = px > 1, sy = py > 1, sz = pz > 1;
    AX = tx + 2, AXY = AX * (ty + 2), nA = AXY * (tz + 2);
    XR = tx + 2, XP = ty * XR, YR = tx, YP = (ty + 1) * tx, ZP = ty * tx;
    nWx = tz * XP, nWy = tz * YP, nWz = (tz + 1) * ZP;
  }
  // the neighbour CTA on side f: x-, x+, y-, y+, z-, z+
  __device__ __forceinline__ int neighbour(int f) const {
    int i = bi, j = bj, k = bk;
    if (f == 0) i = i == 0 ? px - 1 : i - 1;
    if (f == 1) i = i + 1 == px ? 0 : i + 1;
    if (f == 2) j = j == 0 ? py - 1 : j - 1;
    if (f == 3) j = j + 1 == py ? 0 : j + 1;
    if (f == 4) k = k == 0 ? pz - 1 : k - 1;
    if (f == 5) k = k + 1 == pz ? 0 : k + 1;
    return (k * py + j) * px + i;
  }
  __device__ __forceinline__ int box(int lz, int ly, int lx) const {
    return (lz + 1) * AXY + (ly + 1) * AX + lx + 1;
  }
  __device__ __forceinline__ int glob(int gz, int gy, int gx) const {
    return (gz * ny + gy) * nx + gx;
  }
  // global index of brick-local (lz, ly, lx), each at least -1, wrapped
  __device__ __forceinline__ int glob_wrapped(int lz, int ly, int lx) const {
    return glob(wrap(z0 + lz, nz), wrap(y0 + ly, ny), wrap(x0 + lx, nx));
  }
  __device__ __forceinline__ int tvox() const { return tz * ty * tx; }
};

// Where a CTA's arrays sit in its dynamic shared memory (layout_floats).
struct Layout {
  float *A, *D, *Wx, *Wy, *Wz, *P;
  int* T;  // the exchange's table

  __device__ __forceinline__ void init(const Brick& b, float* shm, int boxes,
                                       bool wsm, int pool) {
    A = shm + 1;
    D = boxes == 2 ? A + b.nA : A;
    Wx = A + boxes * b.nA;
    Wy = Wx + 2 * b.nWx + 1;
    Wz = Wy + 2 * b.nWy;
    P = wsm ? Wz + 2 * b.nWz : Wx;
    T = reinterpret_cast<int*>(P + pool);
  }
};

// The density box from V, halo included (wrapped), and the weight layouts
// (each of a pair followed by the other) when they live on chip.
__device__ __forceinline__ void load_brick(const Brick& b, const Layout& L,
                                           const float* V, const Weights& w,
                                           bool wsm) {
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int i = tid; i < b.nA; i += nth) {
    const int lx = i % b.AX - 1, ly = (i / b.AX) % (b.ty + 2) - 1, lz = i / b.AXY - 1;
    L.A[i] = V[b.glob_wrapped(lz, ly, lx)];
  }
  if (!wsm) return;
  for (int i = tid; i < b.nWx; i += nth) {
    const int c = b.glob_wrapped(i / b.XP, (i / b.XR) % b.ty, i % b.XR - 1);
    L.Wx[i] = w.px[c];
    L.Wx[b.nWx + i] = w.nx[c];
  }
  for (int i = tid; i < b.nWy; i += nth) {
    const int c = b.glob_wrapped(i / b.YP, (i / b.YR) % (b.ty + 1) - 1, i % b.YR);
    L.Wy[i] = w.py[c];
    L.Wy[b.nWy + i] = w.ny[c];
  }
  for (int i = tid; i < b.nWz; i += nth) {
    const int c = b.glob_wrapped(i / b.ZP - 1, (i / b.tx) % b.ty, i % b.tx);
    L.Wz[i] = w.pz[c];
    L.Wz[b.nWz + i] = w.nz[c];
  }
}

// The split-axis halo exchange: item i of the split axes' planes (x, then
// y, then z; each minus side then plus side; face f = 2 * axis + side)
// fills a halo cell of the box, in_a, from the facing plane of the
// neighbour, and writes the cell of the brick's own edge plane beside it,
// out_a = in_a -/+ the axis's stride, to face slot f of the face buffer at
// offset i - first[f].  The table in shared memory holds, for the run, each
// item as in_a | f << 16, then first[f] and the neighbour's facing slot
// (nb(f) * 6 + (f ^ 1)) * fs for f = 0..5; a box index fits 16 bits, as the
// box fits the 227 KB a CTA may hold.  A thread also holds its first
// HELD items (tid + m * nth) in registers, their box indices packed in
// box[m] (out_a low 16 bits, in_a high; -1: none), their buffer offsets in
// out_f[m] / in_f[m]: a kernel with registers to spare skips the table's
// dependent loads for them.
template <int HELD>
struct Exchange {
  const int* T;
  int items;
  int box[HELD > 0 ? HELD : 1], out_f[HELD > 0 ? HELD : 1], in_f[HELD > 0 ? HELD : 1];

  __device__ __forceinline__ void init(const Brick& b, int* table) {
    const int tz = b.tz, ty = b.ty, tx = b.tx;
    const int nxf = b.sx * 2 * tz * ty, nyf = b.sy * 2 * tz * tx, nzf = b.sz * 2 * ty * tx;
    items = nxf + nyf + nzf;
    T = table;
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      int j = i, f, in_a;
      if (j < nxf) {
        const int side = j / (tz * ty);
        f = side, in_a = b.box((j / ty) % tz, j % ty, -1) + (side ? tx + 1 : 0);
      } else if ((j -= nxf) < nyf) {
        const int side = j / (tz * tx);
        f = 2 + side, in_a = b.box((j / tx) % tz, -1, j % tx) + (side ? ty + 1 : 0) * b.AX;
      } else {
        j -= nyf;
        const int side = j / (ty * tx);
        f = 4 + side, in_a = b.box(-1, (j / tx) % ty, j % tx) + (side ? tz + 1 : 0) * b.AXY;
      }
      table[i] = in_a | (f << 16);
    }
    if (threadIdx.x < 6) {
      const int f = threadIdx.x, plane = f < 2 ? tz * ty : f < 4 ? tz * tx : ty * tx;
      table[items + f] = (f >= 2 ? nxf : 0) + (f >= 4 ? nyf : 0) + (f & 1) * plane;
      table[items + 6 + f] = (b.neighbour(f) * 6 + (f ^ 1)) * b.fs;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < HELD; ++m) {
      const int i = threadIdx.x + m * blockDim.x;
      box[m] = -1, out_f[m] = in_f[m] = 0;
      if (i < items) {
        const int p = T[i], f = p >> 16, in_a = p & 0xffff, idx = i - T[items + f];
        box[m] = (in_a + out_step(b, f)) | (in_a << 16);
        out_f[m] = (b.cta * 6 + f) * b.fs + idx;
        in_f[m] = T[items + 6 + f] + idx;
      }
    }
  }

  // out_a - in_a of face f
  __device__ __forceinline__ static int out_step(const Brick& b, int f) {
    return ((f & 1) ? -1 : 1) * (f < 2 ? 1 : f < 4 ? b.AX : b.AXY);
  }

  // A's halo from this step's interior: an axis in one part wraps onto the
  // brick's own opposite plane, split axes through the face buffer G (this
  // step's parity) and the grid barrier.  Loads of each pass are issued
  // before its first store.  Ends with the CTA synchronised.
  __device__ __forceinline__ void run(const Brick& b, float* A, float* G) const {
    const int tid = threadIdx.x, nth = blockDim.x;
    const int tz = b.tz, ty = b.ty, tx = b.tx;
    const int nx_ = (1 - b.sx) * 2 * tz * ty, ny_ = (1 - b.sy) * 2 * tz * tx,
              nz_ = (1 - b.sz) * 2 * ty * tx;
    for (int i = tid; i < nx_ + ny_ + nz_; i += nth) {
      int j = i, dst, src;
      if (j < nx_) {
        const int side = j / (tz * ty), row = b.box((j / ty) % tz, j % ty, -1);
        dst = row + (side ? tx + 1 : 0);
        src = row + (side ? 1 : tx);
      } else if ((j -= nx_) < ny_) {
        const int side = j / (tz * tx), col = b.box((j / tx) % tz, -1, j % tx);
        dst = col + (side ? ty + 1 : 0) * b.AX;
        src = col + (side ? 1 : ty) * b.AX;
      } else {
        j -= ny_;
        const int side = j / (ty * tx), col = b.box(-1, (j / tx) % ty, j % tx);
        dst = col + (side ? tz + 1 : 0) * b.AXY;
        src = col + (side ? 1 : tz) * b.AXY;
      }
      A[dst] = A[src];
    }
    const int own = b.cta * 6 * b.fs;
    const int* first = T + items;
    const int* facing = first + 6;
    float held[HELD > 0 ? HELD : 1], val[kSlots];
#pragma unroll
    for (int m = 0; m < HELD; ++m)
      if (box[m] >= 0) held[m] = A[box[m] & 0xffff];
#pragma unroll
    for (int m = 0; m < HELD; ++m)
      if (box[m] >= 0) __stcg(G + out_f[m], held[m]);
    for (int i0 = tid + HELD * nth; i0 < items; i0 += kSlots * nth) {
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const int i = i0 + m * nth;
        if (i < items) {
          const int p = T[i];
          val[m] = A[(p & 0xffff) + out_step(b, p >> 16)];
        }
      }
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const int i = i0 + m * nth;
        if (i < items) {
          const int f = T[i] >> 16;
          __stcg(G + own + f * b.fs + i - first[f], val[m]);
        }
      }
    }
    cg::this_grid().sync();
#pragma unroll
    for (int m = 0; m < HELD; ++m)
      if (box[m] >= 0) held[m] = __ldcg(G + in_f[m]);
#pragma unroll
    for (int m = 0; m < HELD; ++m)
      if (box[m] >= 0) A[box[m] >> 16] = held[m];
    for (int i0 = tid + HELD * nth; i0 < items; i0 += kSlots * nth) {
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const int i = i0 + m * nth;
        if (i < items) {
          const int f = T[i] >> 16;
          val[m] = __ldcg(G + facing[f] + i - first[f]);
        }
      }
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const int i = i0 + m * nth;
        if (i < items) A[T[i] & 0xffff] = val[m];
      }
    }
    __syncthreads();
  }
};

// The face weights of a unit kernel: the on-chip layouts (WSM; each pair of
// arrays one after the other) or the global arrays (!WSM, read from L2).
struct Faces {
  const float *x, *y, *z;  // WSM: the layouts, p at x[i] and n at x[nWx + i]
  Weights w;               // !WSM
  int nWx, nWy, nWz;
};

// A unit a thread owns for the run: a 2x2x2 block at brick-local (lz, ly,
// lx), all even, or none (a < 0).  a is its origin's box index; i0, i1, i2
// its origin's weight-layout indices (WSM), or its global index and a bit
// set of the axes on which the block sits at the grid's first plane (!WSM).
struct Unit {
  int a, i0, i1, i2;

  __device__ __forceinline__ void init(const Brick& b, bool wsm, int lz, int ly,
                                       int lx) {
    a = b.box(lz, ly, lx);
    if (wsm) {
      i0 = lz * b.XP + ly * b.XR + lx + 1;
      i1 = lz * b.YP + (ly + 1) * b.YR + lx;
      i2 = (lz + 1) * b.ZP + ly * b.tx + lx;
    } else {
      const int gz = b.z0 + lz, gy = b.y0 + ly, gx = b.x0 + lx;
      i0 = b.glob(gz, gy, gx);
      i1 = (gx == 0) | ((gy == 0) << 1) | ((gz == 0) << 2);
    }
  }

  // The 8 deltas d[e], e = dz * 4 + dy * 2 + dx, from A (its pairs read
  // 8 bytes at a time).  Along each axis a pair of voxels has three faces:
  // the minus face of the first, the face between them, the plus face of
  // the second; each flux is computed once.
  template <bool WSM>
  __device__ __forceinline__ void deltas(const Brick& b, const float* A,
                                         const Faces& W, float (&d)[8]) const {
    const int AX = b.AX, AXY = b.AXY;
    float v[8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 p = ld2(A + a + (r & 1) * AX + (r >> 1) * AXY);
      v[2 * r] = p.x, v[2 * r + 1] = p.y;
    }
    const int P = b.ny * b.nx;
    // x: rows r = dz * 2 + dy
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int dy = r & 1, dz = r >> 1, ar = a + dy * AX + dz * AXY;
      float p0, p1, n0, n1, pm, nm;
      if (WSM) {
        const int i = i0 + dy * b.XR + dz * b.XP;
        const float2 p = ld2(W.x + i), n = ld2(W.x + W.nWx + i);
        p0 = p.x, p1 = p.y, n0 = n.x, n1 = n.y;
        pm = W.x[i - 1], nm = W.x[W.nWx + i - 1];
      } else {
        const int c = i0 + dy * b.nx + dz * P, cm = c + ((i1 & 1) ? b.nx - 1 : -1);
        p0 = __ldg(W.w.px + c), p1 = __ldg(W.w.px + c + 1);
        n0 = __ldg(W.w.nx + c), n1 = __ldg(W.w.nx + c + 1);
        pm = __ldg(W.w.px + cm), nm = __ldg(W.w.nx + cm);
      }
      const float v0 = v[2 * r], v1 = v[2 * r + 1];
      const float fm = add(mul(A[ar - 1], pm), mul(v0, nm));
      const float f = add(mul(v0, p0), mul(v1, n0));
      const float fp = add(mul(v1, p1), mul(A[ar + 2], n1));
      d[2 * r] = sub(fm, f);
      d[2 * r + 1] = sub(f, fp);
    }
    // y: columns (dz, dx), the pair dy = 0, 1
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      const float2 vm = ld2(A + a + dz * AXY - AX), vp = ld2(A + a + dz * AXY + 2 * AX);
      float p0[2], p1[2], n0[2], n1[2], pm[2], nm[2];
      if (WSM) {
        const int i = i1 + dz * b.YP;
        const float2 a0 = ld2(W.y + i), a1 = ld2(W.y + i + b.YR), am = ld2(W.y + i - b.YR);
        const float2 c0 = ld2(W.y + W.nWy + i), c1 = ld2(W.y + W.nWy + i + b.YR),
                     cm = ld2(W.y + W.nWy + i - b.YR);
        p0[0] = a0.x, p0[1] = a0.y, p1[0] = a1.x, p1[1] = a1.y, pm[0] = am.x, pm[1] = am.y;
        n0[0] = c0.x, n0[1] = c0.y, n1[0] = c1.x, n1[1] = c1.y, nm[0] = cm.x, nm[1] = cm.y;
      } else {
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int c = i0 + dx + dz * P, cm = c + ((i1 & 2) ? (b.ny - 1) * b.nx : -b.nx);
          p0[dx] = __ldg(W.w.py + c), p1[dx] = __ldg(W.w.py + c + b.nx);
          n0[dx] = __ldg(W.w.ny + c), n1[dx] = __ldg(W.w.ny + c + b.nx);
          pm[dx] = __ldg(W.w.py + cm), nm[dx] = __ldg(W.w.ny + cm);
        }
      }
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int e0 = dz * 4 + dx, e1 = e0 + 2;
        const float ym = dx ? vm.y : vm.x, yp = dx ? vp.y : vp.x;
        const float fm = add(mul(ym, pm[dx]), mul(v[e0], nm[dx]));
        const float f = add(mul(v[e0], p0[dx]), mul(v[e1], n0[dx]));
        const float fp = add(mul(v[e1], p1[dx]), mul(yp, n1[dx]));
        d[e0] = sub(add(d[e0], fm), f);
        d[e1] = sub(add(d[e1], f), fp);
      }
    }
    // z: columns (dy, dx), the pair dz = 0, 1
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float2 vm = ld2(A + a + dy * AX - AXY), vp = ld2(A + a + dy * AX + 2 * AXY);
      float p0[2], p1[2], n0[2], n1[2], pm[2], nm[2];
      if (WSM) {
        const int i = i2 + dy * b.tx;
        const float2 a0 = ld2(W.z + i), a1 = ld2(W.z + i + b.ZP), am = ld2(W.z + i - b.ZP);
        const float2 c0 = ld2(W.z + W.nWz + i), c1 = ld2(W.z + W.nWz + i + b.ZP),
                     cm = ld2(W.z + W.nWz + i - b.ZP);
        p0[0] = a0.x, p0[1] = a0.y, p1[0] = a1.x, p1[1] = a1.y, pm[0] = am.x, pm[1] = am.y;
        n0[0] = c0.x, n0[1] = c0.y, n1[0] = c1.x, n1[1] = c1.y, nm[0] = cm.x, nm[1] = cm.y;
      } else {
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int c = i0 + dx + dy * b.nx, cm = c + ((i1 & 4) ? (b.nz - 1) * P : -P);
          p0[dx] = __ldg(W.w.pz + c), p1[dx] = __ldg(W.w.pz + c + P);
          n0[dx] = __ldg(W.w.nz + c), n1[dx] = __ldg(W.w.nz + c + P);
          pm[dx] = __ldg(W.w.pz + cm), nm[dx] = __ldg(W.w.nz + cm);
        }
      }
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int e0 = dy * 2 + dx, e1 = e0 + 4;
        const float zm = dx ? vm.y : vm.x, zp = dx ? vp.y : vp.x;
        const float fm = add(mul(zm, pm[dx]), mul(v[e0], nm[dx]));
        const float f = add(mul(v[e0], p0[dx]), mul(v[e1], n0[dx]));
        const float fp = add(mul(v[e1], p1[dx]), mul(zp, n1[dx]));
        d[e0] = sub(add(d[e0], fm), f);
        d[e1] = sub(add(d[e1], f), fp);
      }
    }
  }

  // the unit's 8 densities in A
  __device__ __forceinline__ void values(const Brick& b, const float* A,
                                         float (&v)[8]) const {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 p = ld2(A + a + (r & 1) * b.AX + (r >> 1) * b.AXY);
      v[2 * r] = p.x, v[2 * r + 1] = p.y;
    }
  }

  // global index of voxel e
  __device__ __forceinline__ int glob(const Brick& b, int e) const {
    const int lz = a / b.AXY - 1, ly = (a / b.AX) % (b.ty + 2) - 1, lx = a % b.AX - 1;
    return b.glob(b.z0 + lz + (e >> 2), b.y0 + ly + ((e >> 1) & 1), b.x0 + lx + (e & 1));
  }
};

__device__ __forceinline__ Faces faces_of(const Brick& b, const Layout& L,
                                         const Weights& w) {
  Faces f;
  f.x = L.Wx, f.y = L.Wy, f.z = L.Wz, f.w = w;
  f.nWx = b.nWx, f.nWy = b.nWy, f.nWz = b.nWz;
  return f;
}

// Brick-local coordinates (in voxels) of unit j of the brick: x fastest over
// the brick's 2-blocks, or, `grouped`, the 8 units of each 4-cube on 8
// consecutive j (bit 0 x, bit 1 y, bit 2 z) and the 4-cubes x fastest.
__device__ __forceinline__ void unit_coords(const Brick& b, int j, bool grouped,
                                            int& lz, int& ly, int& lx) {
  if (grouped) {
    const int w = j & 7, c = j >> 3, cx = b.tx >> 2, cy = b.ty >> 2;
    lx = 4 * (c % cx) + 2 * (w & 1);
    ly = 4 * ((c / cx) % cy) + 2 * ((w >> 1) & 1);
    lz = 4 * (c / (cx * cy)) + 2 * (w >> 2);
  } else {
    const int ux = b.tx >> 1, uy = b.ty >> 1;
    lx = 2 * (j % ux);
    ly = 2 * ((j / ux) % uy);
    lz = 2 * (j / (ux * uy));
  }
}

// The pooled tree of a unit's 8 values at its origin: x pairs, y, then z.
__device__ __forceinline__ float tree8(const float* s) {
  return add(add(add(s[0], s[1]), add(s[2], s[3])), add(add(s[4], s[5]), add(s[6], s[7])));
}

// Every unit's new values written into A, the halo exchanged.  `nv` are
// this thread's units' new values.
template <int KB, int HELD>
__device__ __forceinline__ void commit(const Brick& b, const Exchange<HELD>& ex,
                                       const Unit (&u)[KB], const float (&nv)[KB][8],
                                       float* A, float* G) {
  __syncthreads();
#pragma unroll
  for (int m = 0; m < KB; ++m)
    if (u[m].a >= 0)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float2*>(A + u[m].a + (r & 1) * b.AX + (r >> 1) * b.AXY) =
            make_float2(nv[m][2 * r], nv[m][2 * r + 1]);
  __syncthreads();
  ex.run(b, A, G);
}

template <int KB>
__device__ __forceinline__ void store_out(const Brick& b, const Unit (&u)[KB],
                                          const float (&nv)[KB][8], float* out) {
#pragma unroll
  for (int m = 0; m < KB; ++m)
    if (u[m].a >= 0)
#pragma unroll
      for (int e = 0; e < 8; ++e) out[u[m].glob(b, e)] = nv[m][e];
}

// The brick's interior of A to out (a run of 0 steps).
__device__ __forceinline__ void box_out(const Brick& b, const float* A, float* out) {
  for (int i = threadIdx.x; i < b.tvox(); i += blockDim.x) {
    const int lx = i % b.tx, ly = (i / b.tx) % b.ty, lz = i / (b.tx * b.ty);
    out[b.glob(b.z0 + lz, b.y0 + ly, b.x0 + lx)] = A[b.box(lz, ly, lx)];
  }
}

// Two-level run.  Replaces make_flat_amr_run.
//
// A unit computes its 8 deltas, the pooled sum of its coarse deltas (the
// x / y / z roll-chain tree at the block origin) and the 8 results
//   res = (v + delta * upd_f) + pooled * upd_c,
// so the JAX kernel's pool and broadcast passes need no second sweep.  The
// pool mask is (upd_c != 0); a block is either one coarse leaf or eight
// fine leaves, so a fine block pools zeros and upd_c = 0 drops them.
//
// Bound on this card: operations (26 f32 operations a voxel a step in the
// JAX body's form); the run's compulsory bytes (V, six weights and two
// masks in, V out, once) are ~40 bytes a voxel.  The streaming form this
// replaces re-read those ~40 bytes a voxel from L2 every step (35 MB at
// 96^3, ~10 us a step) with one thread a block at 114 registers.  Here
// nothing but the face planes leaves the SM within a run: at 96^3 a brick
// of 24x12x24 voxels holds its box (38 KB) and weights (177 KB) in shared
// memory and each of 448 threads two units' masks and new values in
// registers; a step reads a unit's pairs 8 bytes at a time (60 shared load
// instructions a unit), computes each face flux once, and pays one grid
// barrier and the face exchange.
template <int KB, bool WSM>
__global__ void __launch_bounds__(unit_threads(KB), 1)
flat_amr_run_kernel(const float* __restrict__ V, Weights w,
                    const float* __restrict__ updf, const float* __restrict__ updc,
                    float* __restrict__ out, float* faces, int nz, int ny, int nx,
                    int steps, int pz, int py, int px, int fs) {
  extern __shared__ __align__(16) float shm[];
  Brick b;
  b.init(nz, ny, nx, pz, py, px, 2, fs);
  Layout L;
  L.init(b, shm, 1, WSM, 0);
  load_brick(b, L, V, w, WSM);
  const Faces W = faces_of(b, L, w);
  Exchange<held_slots(KB)> ex;
  ex.init(b, L.T);
  const int units = b.tvox() / 8;
  Unit u[KB];
  float uf[KB][8], uc[KB][8];
#pragma unroll
  for (int m = 0; m < KB; ++m) {
    const int j = threadIdx.x + m * blockDim.x;
    u[m].a = -1;
    if (j < units) {
      int lz, ly, lx;
      unit_coords(b, j, false, lz, ly, lx);
      u[m].init(b, WSM, lz, ly, lx);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = u[m].glob(b, e);
        uf[m][e] = updf[c];
        uc[m][e] = updc[c];
      }
    }
  }
  __syncthreads();
  if (steps == 0) {
    box_out(b, L.A, out);
    return;
  }

  const int ctas = gridDim.x;
  for (int step = 0;; ++step) {
    float nv[KB][8];
#pragma unroll
    for (int m = 0; m < KB; ++m) {
      if (u[m].a < 0) continue;
      float d[8], s[8], v[8];
      u[m].template deltas<WSM>(b, L.A, W, d);
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = mul(d[e], uc[m][e] != 0.f ? 1.f : 0.f);
      const float pooled = tree8(s);
      u[m].values(b, L.A, v);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        nv[m][e] = add(add(v[e], mul(d[e], uf[m][e])), mul(pooled, uc[m][e]));
    }
    if (step + 1 == steps) {
      store_out(b, u, nv, out);
      return;
    }
    commit(b, ex, u, nv, L.A, faces + (size_t)(step & 1) * ctas * 6 * fs);
  }
}

// Multi-level run.  Replaces make_flat_ml_run_pallas.
//
// Per voxel r = delta * updf and s = delta * pool; for doubling k = 0..kmax
// (h = 2^k) the origin o of each aligned 2h-cube takes the tree of s at
// o + {0,h}^3 (x pairs, then y, then z), and, where doubling k captures,
// every voxel q of the cube gains r[q] += s[o] * caps[k][o]; then
// out = v + r.  caps[k] is zero away from the origins of level vl-1-k
// leaves and is read only there, so a unit keeps only its origins' values.
//
// Doubling 0 is the unit's own tree in registers; doubling 1 is a tree over
// the 8 units of a 4-cube, which sit on 8 consecutive lanes of a warp
// (grouped units), by three xor shuffles (x, y, z pairs; each sum is the
// same in both lanes, the two operands swapped); doublings 2 and 3 go
// through a few floats of shared memory, one CTA barrier each.  Bricks are
// aligned to E = 2^(kmax+1), so no tree leaves its CTA.
//
// Bound on this card: operations (36 f32 operations a voxel a step in the
// JAX body's form at kmax = 1).  The streaming form this replaces ran one
// 64-thread CTA a 4-cube over 4,096 CTAs at 64^3, re-read ~12 arrays from
// L2 each step and paid a CTA barrier after each pass and level and a grid
// barrier over all 4,096 CTAs (17 us a step).  Here a 16x8x16 brick holds
// its box and weights on chip (66 KB), a thread one unit, and a step pays
// no CTA barrier in its compute at kmax <= 1 and one grid barrier over the
// plan's CTAs.
template <int KB, bool WSM>
__global__ void __launch_bounds__(unit_threads(KB), 1)
flat_ml_run_kernel(const float* __restrict__ V, Weights w,
                   const float* __restrict__ updf, const float* __restrict__ pool,
                   const float* __restrict__ caps, float* __restrict__ out,
                   float* faces, int nz, int ny, int nx, int steps, int kmax,
                   int active, int pz, int py, int px, int fs) {
  extern __shared__ __align__(16) float shm[];
  Brick b;
  b.init(nz, ny, nx, pz, py, px, 1 << (kmax + 1), fs);
  Layout L;
  L.init(b, shm, 1, WSM, (int)pool_floats(b.tvox(), kmax));
  float* P1 = L.P;
  float* P2 = P1 + b.tvox() / 64;
  load_brick(b, L, V, w, WSM);
  const Faces W = faces_of(b, L, w);
  Exchange<held_slots(KB)> ex;
  ex.init(b, L.T);
  const bool grouped = kmax >= 1;
  const size_t N = (size_t)nz * ny * nx;
  const int units = b.tvox() / 8;
  const int c4x = b.tx >> 2, c4y = b.ty >> 2;  // 4-cubes a row, a plane
  const int c8x = b.tx >> 3, c8y = b.ty >> 3;  // 8-cubes
  Unit u[KB];
  float uf[KB][8], up[KB][8], cap[KB][4];
#pragma unroll
  for (int m = 0; m < KB; ++m) {
    const int j = threadIdx.x + m * blockDim.x;
    u[m].a = -1;
    if (j < units) {
      int lz, ly, lx;
      unit_coords(b, j, grouped, lz, ly, lx);
      u[m].init(b, WSM, lz, ly, lx);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = u[m].glob(b, e);
        uf[m][e] = updf[c];
        up[m][e] = pool[c];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cap[m][k] = 0.f;
        if (k <= kmax) {
          const int amask = ~((2 << k) - 1);
          cap[m][k] = caps[(size_t)k * N +
                           b.glob(b.z0 + (lz & amask), b.y0 + (ly & amask),
                                  b.x0 + (lx & amask))];
        }
      }
    }
  }
  __syncthreads();
  if (steps == 0) {
    box_out(b, L.A, out);
    return;
  }

  const int ctas = gridDim.x;
  const unsigned full = 0xffffffffu;
  for (int step = 0;; ++step) {
    float r[KB][8];
#pragma unroll
    for (int m = 0; m < KB; ++m) {
      const bool live = u[m].a >= 0;
      float p = 0.f;
      if (live) {
        float d[8], s[8];
        u[m].template deltas<WSM>(b, L.A, W, d);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          r[m][e] = mul(d[e], uf[m][e]);
          s[e] = mul(d[e], up[m][e]);
        }
        p = tree8(s);
        if (kmax >= 0 && (active & 1))
#pragma unroll
          for (int e = 0; e < 8; ++e) r[m][e] = add(r[m][e], mul(p, cap[m][0]));
      }
      if (kmax >= 1) {  // every lane of the warp takes part
        p = add(p, __shfl_xor_sync(full, p, 1));
        p = add(p, __shfl_xor_sync(full, p, 2));
        p = add(p, __shfl_xor_sync(full, p, 4));
        if (live) {
          if (active & 2)
#pragma unroll
            for (int e = 0; e < 8; ++e) r[m][e] = add(r[m][e], mul(p, cap[m][1]));
          const int j = threadIdx.x + m * blockDim.x;
          if (kmax >= 2 && (j & 7) == 0) P1[j >> 3] = p;
        }
      }
    }
    // doublings 2 and 3: the tree over a cube's 8 sub-cube values in P1 / P2
#pragma unroll
    for (int k = 2; k <= 3; ++k) {
      if (k > kmax) break;
      __syncthreads();
      const float* src = k == 2 ? P1 : P2;
      const int rx = k == 2 ? c4x : c8x, ry = k == 2 ? c4y : c8y;
#pragma unroll
      for (int m = 0; m < KB; ++m) {
        if (u[m].a < 0) continue;
        const int j = threadIdx.x + m * blockDim.x, c = j >> 3;
        // this unit's sub-cube (4-cube for k = 2, 8-cube for k = 3)
        int cx = c % c4x, cy = (c / c4x) % c4y, cz = c / (c4x * c4y);
        if (k == 3) cx >>= 1, cy >>= 1, cz >>= 1;
        const int o = ((cz & ~1) * ry + (cy & ~1)) * rx + (cx & ~1);
        const int hy = rx, hz = rx * ry;
        const float t00 = add(src[o], src[o + 1]);
        const float t01 = add(src[o + hy], src[o + hy + 1]);
        const float t10 = add(src[o + hz], src[o + hz + 1]);
        const float t11 = add(src[o + hz + hy], src[o + hz + hy + 1]);
        const float p = add(add(t00, t01), add(t10, t11));
        if ((active >> k) & 1)
#pragma unroll
          for (int e = 0; e < 8; ++e) r[m][e] = add(r[m][e], mul(p, cap[m][k]));
        if (k == 2 && kmax >= 3 && (j & 7) == 0 && !((cx | cy | cz) & 1))
          P2[((cz >> 1) * c8y + (cy >> 1)) * c8x + (cx >> 1)] = p;
      }
    }
#pragma unroll
    for (int m = 0; m < KB; ++m)
      if (u[m].a >= 0) {
        float v[8];
        u[m].values(b, L.A, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) r[m][e] = add(v[e], r[m][e]);
      }
    if (step + 1 == steps) {
      store_out(b, u, r, out);
      return;
    }
    commit(b, ex, u, r, L.A, faces + (size_t)(step & 1) * ctas * 6 * fs);
  }
}

// Multi-level run with no capturing doubling (kmax = -1), any extents:
// out = v + delta * updf each step.  A thread takes single voxels, two boxes
// ping-pong in shared memory, and updf is read from L2 each step.
template <bool WSM>
__global__ void __launch_bounds__(kThreads, 1)
flat_ml_plain_run_kernel(const float* __restrict__ V, Weights w,
                         const float* __restrict__ updf, float* __restrict__ out,
                         float* faces, int nz, int ny, int nx, int steps, int pz,
                         int py, int px, int fs) {
  extern __shared__ __align__(16) float shm[];
  Brick b;
  b.init(nz, ny, nx, pz, py, px, 1, fs);
  Layout L;
  L.init(b, shm, 2, WSM, 0);
  load_brick(b, L, V, w, WSM);
  Exchange<0> ex;
  ex.init(b, L.T);
  __syncthreads();
  if (steps == 0) {
    box_out(b, L.A, out);
    return;
  }
  const int ctas = gridDim.x, P = ny * nx;
  float *A = L.A, *D = L.D;
  for (int step = 0;; ++step) {
    const bool last = step + 1 == steps;
    for (int i = threadIdx.x; i < b.tvox(); i += blockDim.x) {
      const int lx = i % b.tx, ly = (i / b.tx) % b.ty, lz = i / (b.tx * b.ty);
      const int a = b.box(lz, ly, lx);
      const int gx = b.x0 + lx, gy = b.y0 + ly, gz = b.z0 + lz;
      const int c = b.glob(gz, gy, gx);
      // each axis's (p, n) own and minus-side weights
      float wo[6], wm[6];
      if (WSM) {
        const int ix = lz * b.XP + ly * b.XR + lx + 1;
        const int iy = lz * b.YP + (ly + 1) * b.YR + lx;
        const int iz = (lz + 1) * b.ZP + ly * b.tx + lx;
        wo[0] = L.Wx[ix], wo[1] = L.Wx[b.nWx + ix];
        wm[0] = L.Wx[ix - 1], wm[1] = L.Wx[b.nWx + ix - 1];
        wo[2] = L.Wy[iy], wo[3] = L.Wy[b.nWy + iy];
        wm[2] = L.Wy[iy - b.YR], wm[3] = L.Wy[b.nWy + iy - b.YR];
        wo[4] = L.Wz[iz], wo[5] = L.Wz[b.nWz + iz];
        wm[4] = L.Wz[iz - b.ZP], wm[5] = L.Wz[b.nWz + iz - b.ZP];
      } else {
        const int mx = gx == 0 ? nx - 1 : -1, my = gy == 0 ? (ny - 1) * nx : -nx,
                  mz = gz == 0 ? (nz - 1) * P : -P;
        const float* g[6] = {w.px, w.nx, w.py, w.ny, w.pz, w.nz};
        const int mo[3] = {mx, my, mz};
#pragma unroll
        for (int q = 0; q < 6; ++q) wo[q] = __ldg(g[q] + c), wm[q] = __ldg(g[q] + c + mo[q / 2]);
      }
      const float v = A[a];
      const float fx = add(mul(v, wo[0]), mul(A[a + 1], wo[1]));
      const float fx_m = add(mul(A[a - 1], wm[0]), mul(v, wm[1]));
      const float fy = add(mul(v, wo[2]), mul(A[a + b.AX], wo[3]));
      const float fy_m = add(mul(A[a - b.AX], wm[2]), mul(v, wm[3]));
      const float fz = add(mul(v, wo[4]), mul(A[a + b.AXY], wo[5]));
      const float fz_m = add(mul(A[a - b.AXY], wm[4]), mul(v, wm[5]));
      float d = sub(fx_m, fx);
      d = sub(add(d, fy_m), fy);
      d = sub(add(d, fz_m), fz);
      const float nv = add(v, mul(d, __ldg(updf + c)));
      if (last) out[c] = nv; else D[a] = nv;
    }
    if (last) return;
    __syncthreads();
    ex.run(b, D, faces + (size_t)(step & 1) * ctas * 6 * fs);
    float* t = A;
    A = D;
    D = t;
  }
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

// The plan's cut checked against the grid: every axis of `align`-aligned
// cells cut into at most its cell count of parts, the largest brick's
// layout within `smem` bytes, its faces within `fs` floats, and (kb > 0)
// its 2x2x2 units within kb a thread.  kb = 0: single voxels, two boxes.
bool plan_fits(int nz, int ny, int nx, int steps, int align, int kmax, int pz,
               int py, int px, int threads, int kb, int wsm, int smem, int fs) {
  if (nz < 1 || ny < 1 || nx < 1 || steps < 0 ||
      (long long)nz * ny * nx >= (1LL << 31) || nz % align || ny % align ||
      nx % align || pz < 1 || py < 1 || px < 1 || pz > nz / align ||
      py > ny / align || px > nx / align || threads < 32 ||
      threads > (kb ? unit_threads(kb) : kThreads) ||
      threads % 32 || kb < 0 || kb > kMaxUnits || (wsm != 0 && wsm != 1) ||
      smem < 1 || fs < 1 || (long long)2 * pz * py * px * 6 * fs >= (1LL << 31))
    return false;
  const long long tz = (long long)(nz / align + pz - 1) / pz * align,
                  ty = (long long)(ny / align + py - 1) / py * align,
                  tx = (long long)(nx / align + px - 1) / px * align;
  const long long tvox = tz * ty * tx;
  const long long need =
      4 * layout_floats(tz, ty, tx, kb ? 1 : 2, wsm, pool_floats(tvox, kmax),
                        halo_cells(tz, ty, tx, pz > 1, py > 1, px > 1));
  long long face = tz * ty;
  if (tz * tx > face) face = tz * tx;
  if (ty * tx > face) face = ty * tx;
  return need <= smem && face <= fs && (kb == 0 || tvox / 8 <= (long long)kb * threads);
}

cudaError_t launch(const void* kernel, void** args, int ctas, int threads, int smem,
                   void* stream) {
  cudaError_t err = cooperative_fits(kernel, ctas, threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)ctas), dim3((unsigned)threads),
                                    args, (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the instantiation of a (kb, wsm) kernel template
template <bool WSM>
const void* amr_kernel(int kb) {
  if (kb == 1) return (const void*)flat_amr_run_kernel<1, WSM>;
  if (kb == 2) return (const void*)flat_amr_run_kernel<2, WSM>;
  if (kb == 3) return (const void*)flat_amr_run_kernel<3, WSM>;
  return (const void*)flat_amr_run_kernel<4, WSM>;
}
template <bool WSM>
const void* ml_kernel(int kb) {
  if (kb == 1) return (const void*)flat_ml_run_kernel<1, WSM>;
  if (kb == 2) return (const void*)flat_ml_run_kernel<2, WSM>;
  if (kb == 3) return (const void*)flat_ml_run_kernel<3, WSM>;
  return (const void*)flat_ml_run_kernel<4, WSM>;
}

}  // namespace

extern "C" {

// V, the six dt-premultiplied weights, upd_f, upd_c: [nz, ny, nx] float32
// with even extents; out is a caller-allocated array of that shape, faces
// 2 x CTAs x 6 x fs floats of scratch.  The plan (ops/flat_amr.py::
// flat_amr_run_plan): pz x py x px bricks, one CTA of `threads` threads
// each, kb units a thread, the weights on chip when wsm, `smem` bytes of
// dynamic shared memory a CTA.  A plan that does not fit the grid is
// refused with cudaErrorInvalidValue, one the card cannot hold with its
// error; either runs nothing.
int flat_amr_run(const float* V, const float* wpx, const float* wnx,
                 const float* wpy, const float* wny, const float* wpz,
                 const float* wnz, const float* updf, const float* updc,
                 float* out, float* faces, int nz, int ny, int nx, int steps,
                 int pz, int py, int px, int threads, int kb, int wsm, int smem,
                 int fs, void* stream) {
  if (kb < 1 || !plan_fits(nz, ny, nx, steps, 2, 0, pz, py, px, threads, kb, wsm,
                           smem, fs))
    return (int)cudaErrorInvalidValue;
  Weights w{wpx, wnx, wpy, wny, wpz, wnz};
  void* args[] = {&V, &w, &updf, &updc, &out, &faces, &nz, &ny, &nx,
                  &steps, &pz, &py, &px, &fs};
  const void* k = wsm ? amr_kernel<true>(kb) : amr_kernel<false>(kb);
  return (int)launch(k, args, pz * py * px, threads, smem, stream);
}

// V, the six dt-premultiplied weights, updf, pool: [nz, ny, nx] float32;
// caps: [kmax + 1, nz, ny, nx] (capture masks of doublings 0..kmax, zero
// away from their cubes' origins); every extent a multiple of 2^(kmax+1).
// `active` has bit k set when doubling k captures.  out, faces and the plan
// as flat_amr_run's (ops/flat_amr.py::flat_ml_run_plan); kb = 0 for
// kmax = -1.
int flat_ml_run(const float* V, const float* wpx, const float* wnx,
                const float* wpy, const float* wny, const float* wpz,
                const float* wnz, const float* updf, const float* pool,
                const float* caps, float* out, float* faces, int nz, int ny,
                int nx, int steps, int kmax, int active, int pz, int py, int px,
                int threads, int kb, int wsm, int smem, int fs, void* stream) {
  if (kmax < -1 || kmax > 3 || (kb == 0) != (kmax == -1) ||
      !plan_fits(nz, ny, nx, steps, 1 << (kmax + 1), kmax, pz, py, px, threads, kb,
                 wsm, smem, fs))
    return (int)cudaErrorInvalidValue;
  Weights w{wpx, wnx, wpy, wny, wpz, wnz};
  const int ctas = pz * py * px;
  if (kb == 0) {
    void* args[] = {&V, &w, &updf, &out, &faces, &nz, &ny, &nx, &steps, &pz, &py, &px, &fs};
    const void* k = wsm ? (const void*)flat_ml_plain_run_kernel<true>
                        : (const void*)flat_ml_plain_run_kernel<false>;
    return (int)launch(k, args, ctas, threads, smem, stream);
  }
  void* args[] = {&V,   &w,    &updf,  &pool, &caps, &out, &faces, &nz, &ny,
                  &nx,  &steps, &kmax, &active, &pz, &py,  &px,    &fs};
  const void* k = wsm ? ml_kernel<true>(kb) : ml_kernel<false>(kb);
  return (int)launch(k, args, ctas, threads, smem, stream);
}

}  // extern "C"
