// Whole-run Game of Life on one float32 0/1 board, behind a plain C
// interface (the launcher returns the launch's cudaError_t).
//
//   gol_run  <- make_gol_run  (dccrg_tpu/ops/gol_kernel.py)
//
// One cooperative launch runs every turn.  Only the last turn writes its
// neighbour counts (the count output is the last turn's); turns == 0
// returns the input and zero counts.
//
// The count is the TPU kernel's, op for op and in its order, so the result
// equals the plain PyTorch twin (ops/gol_kernel.py::gol_run_plain) bitwise
// for any float input, not only 0/1:
//   up = a[y+1] * vyh,  dn = a[y-1] * vyl,  c = up + dn,
//   then for band in (up, a, dn): c += band[x+1] * vxh; c += band[x-1] * vxl
//   new = c == 3 ? 1 : (c != 2 ? 0 : a)
// where a validity mask is 1 on a periodic axis and 0 where the neighbour
// would wrap across an open one; the wrapped neighbour itself is still read
// (0 * x, as the twin's roll does).  Every product and sum goes through
// __fmul_rn / __fadd_rn (the build also passes -fmad=false).
//
// Bound on this card: the compulsory bytes are one board in and the board
// and counts out (12 bytes a cell: 3 MB at 500x500), and the Game of Life
// needs ~10 operations a cell a turn (7 adds, 2 compares, a select; this
// kernel does 21 in the TPU kernel's form), so the operation count bounds a
// long run (0.75 ms for 20000 turns at 500x500 over 67 TFLOP/s).  A turn's
// work is a fraction of a microsecond an SM, and a grid barrier costs about
// a microsecond, so the design holds the board on chip and synchronises
// once every k turns.  The plan (ops/gol_kernel.py::gol_run_plan) cuts the
// board into py x px tiles, one CTA a tile (at most one an SM), each
// holding its tile and a k-deep halo (on split axes only) in shared memory,
// ping-pong.  A round runs k turns in shared memory, the computed region
// shrinking by one cell a turn, with a block barrier between turns; then
// the CTA writes its tile to a global board (double-buffered by round
// parity, around L1), waits at the grid barrier, and reads its halo back
// from that board (each thread's halo cells fixed for the run, all loads
// issued before the first store).  Halo cells hold the cells at their
// wrapped board coordinates with their own validity masks, so a recomputed
// halo cell computes exactly what its owner computes.  An axis that is not
// split wraps inside the tile; a board in one tile runs every turn in one
// round.  Within a turn a thread walks two adjacent columns down a strip of
// rows, their 3 x 4 neighbourhood carried in registers (4 loads a row for
// two cells, two independent add chains).  The masks multiply on every
// cell, as in the reference: a branch to skip them where they are 1 costs
// more on the tiles at an open edge than it saves elsewhere.  There is no
// integer division in the turn loop.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// part i of n cells cut into p parts: the first n % p parts hold one more
__device__ __forceinline__ void part(int n, int p, int i, int& start, int& len) {
  const int q = n / p, r = n % p;
  start = i * q + (i < r ? i : r);
  len = q + (i < r ? 1 : 0);
}

// halo cells a thread reloads after a round at most (gol_run_plan keeps a
// tile's halo within kGolHaloSlots x threads)
constexpr int kGolHaloSlots = 8;

// The count of one cell from its 3 x 3 neighbourhood (d: row y-1, a: its
// own row, u: row y+1; m, c, p: columns x-1, x, x+1) with the
// validity masks of its row (yh, yl) and column (xh, xl), in the
// reference's order.
__device__ __forceinline__ float gol_count(float d_m, float d_c, float d_p, float a_m,
                                           float a_p, float u_m, float u_c, float u_p,
                                           float yh, float yl, float xh, float xl) {
  float s = add(mul(u_c, yh), mul(d_c, yl));
  // band y+1, band y, band y-1: the x+1 then the x-1 neighbour
  s = add(s, mul(mul(u_p, yh), xh));
  s = add(s, mul(mul(u_m, yh), xl));
  s = add(s, mul(a_p, xh));
  s = add(s, mul(a_m, xl));
  s = add(s, mul(mul(d_p, yl), xh));
  return add(s, mul(mul(d_m, yl), xl));
}

// The columns of one thread in a turn: c0 and c0 + 1 (the second where
// two), rows [lo, hi) (gr the board row of lo).  Their 3 x 4 neighbourhood
// is carried down the columns in registers (rows lo-1 and lo first,
// columns col[0..3] = c0-1 .. c0+2, wrapped); the two counts are
// independent chains.  kCount: the last turn, which also writes the counts
// of rows [n_lo[i], n_hi[i]) of column i.
template <bool kCount>
__device__ __forceinline__ void gol_rows(
    const float* __restrict__ src, float* __restrict__ dst, float* __restrict__ cnt,
    int W, int H, int c0, bool two, const int (&col)[4], int lo, int hi, int gr,
    int ny, int nx, int per_y, const float (&xh)[2], const float (&xl)[2],
    const int (&gc)[2], const int (&n_lo)[2], const int (&n_hi)[2]) {
  const float* row = src + (lo == 0 ? H - 1 : lo - 1) * W;
  float d0 = row[col[0]], d1 = row[col[1]], d2 = row[col[2]], d3 = row[col[3]];
  row = src + lo * W;
  float a0 = row[col[0]], a1 = row[col[1]], a2 = row[col[2]], a3 = row[col[3]];
  // not unrolled: an unrolled walk measured slower on the card (more
  // registers, fewer warps in flight)
#pragma unroll 1
  for (int r = lo; r < hi; ++r) {
    row = src + (r + 1 == H ? 0 : r + 1) * W;
    const float u0 = row[col[0]], u1 = row[col[1]], u2 = row[col[2]], u3 = row[col[3]];
    const float yh = (per_y || gr != ny - 1) ? 1.f : 0.f;
    const float yl = (per_y || gr != 0) ? 1.f : 0.f;
    const float s0 = gol_count(d0, d1, d2, a0, a2, u0, u1, u2, yh, yl, xh[0], xl[0]);
    const float s1 = gol_count(d1, d2, d3, a1, a3, u1, u2, u3, yh, yl, xh[1], xl[1]);
    dst[r * W + c0] = s0 == 3.f ? 1.f : (s0 != 2.f ? 0.f : a1);
    if (two) dst[r * W + c0 + 1] = s1 == 3.f ? 1.f : (s1 != 2.f ? 0.f : a2);
    if (kCount) {
      if (r >= n_lo[0] && r < n_hi[0]) cnt[gr * nx + gc[0]] = s0;
      if (r >= n_lo[1] && r < n_hi[1]) cnt[gr * nx + gc[1]] = s1;
    }
    d0 = a0;
    d1 = a1;
    d2 = a2;
    d3 = a3;
    a0 = u0;
    a1 = u1;
    a2 = u2;
    a3 = u3;
    gr = gr + 1 == ny ? 0 : gr + 1;
  }
}

__global__ void __launch_bounds__(512, 1)
gol_run_kernel(const float* __restrict__ alive, float* __restrict__ out,
               float* __restrict__ cnt, float* board, int ny, int nx, int turns,
               int per_x, int per_y, int py, int px, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cta = blockIdx.x;
  int y0, th, x0, tw;
  part(ny, py, cta / px, y0, th);
  part(nx, px, cta % px, x0, tw);
  const int hy = py > 1 ? k : 0, hx = px > 1 ? k : 0;
  const int H = th + 2 * hy, W = tw + 2 * hx;
  float* cur = reinterpret_cast<float*>(smem);
  float* nxt = cur + H * W;
  const int bx = blockDim.x, by = blockDim.y;
  // board row / column of a tile row / column (a halo wraps at most once:
  // the plan keeps k at most a tile's extent)
  const auto board_y = [&](int r) {
    const int g = y0 - hy + r;
    return g < 0 ? g + ny : (g >= ny ? g - ny : g);
  };
  const auto board_x = [&](int c) {
    const int g = x0 - hx + c;
    return g < 0 ? g + nx : (g >= nx ? g - nx : g);
  };

  if (turns == 0) {
    for (int r = threadIdx.y; r < th; r += by)
      for (int c = threadIdx.x; c < tw; c += bx) {
        const int g = (y0 + r) * nx + x0 + c;
        out[g] = alive[g];
        cnt[g] = 0.f;
      }
    return;
  }
  for (int r = threadIdx.y; r < H; r += by) {
    const int gr = board_y(r) * nx;
    for (int c = threadIdx.x; c < W; c += bx) cur[r * W + c] = alive[gr + board_x(c)];
  }
  __syncthreads();

  // The halo cells this thread reloads after a round: items tid + m * nth
  // of the ring (the hy rows above and below, then the hx columns left and
  // right of the tile's rows), at most kGolHaloSlots of them (the plan
  // keeps the count so).  hd: the cell in the tile; hs: its board offset.
  const int tid = threadIdx.y * bx + threadIdx.x, nth = bx * by;
  int hd[kGolHaloSlots], hs[kGolHaloSlots];
#pragma unroll
  for (int m = 0; m < kGolHaloSlots; ++m) {
    int i = tid + m * nth, r = -1, c = 0;
    if (i < 2 * hy * W) {
      r = i / W;
      c = i % W;
      if (r >= hy) r += th;
    } else if ((i -= 2 * hy * W) < 2 * hx * th) {
      r = hy + i / (2 * hx);
      c = i % (2 * hx);
      if (c >= hx) c += tw;
    }
    hd[m] = r < 0 ? -1 : r * W + c;
    hs[m] = r < 0 ? 0 : board_y(r) * nx + board_x(c);
  }
  // thread (x, y) owns the column pairs 2 (threadIdx.x + i bx) (and the
  // column after) of the strip of rows [r_lo, r_hi) and walks them down
  // its strip, their neighbourhood in registers
  const int strip = (H + by - 1) / by;
  const int r_lo = threadIdx.y * strip, r_hi = min(H, r_lo + strip);

  const int per_round = (py == 1 && px == 1) ? turns : k;
  for (int done = 0, round = 0;; ++round) {
    const int n = turns - done < per_round ? turns - done : per_round;
    for (int j = 0; j < n; ++j) {
      // the region still valid after this turn: one cell less on each side
      // of a split axis
      const int lo = max(r_lo, hy ? j + 1 : 0), hi = min(r_hi, hy ? H - j - 1 : H);
      const int xlo = hx ? j + 1 : 0, xhi = hx ? W - j - 1 : W;
      const bool last = done + j + 1 == turns;
      // the two boards never overlap: loads of the next rows may pass the
      // stores of this one
      const float* __restrict__ src = cur;
      float* __restrict__ dst = nxt;
      for (int c0 = 2 * threadIdx.x; lo < hi && c0 < W; c0 += 2 * bx) {
        // a pair past the region computes cells nothing valid reads
        if (c0 + 1 < xlo || c0 >= xhi) continue;
        const bool two = c0 + 1 < W;
        const int c1 = c0 + 1 == W ? 0 : c0 + 1;
        const int col[4] = {c0 == 0 ? W - 1 : c0 - 1, c0, c1, c1 + 1 == W ? 0 : c1 + 1};
        int gc[2], n_lo[2], n_hi[2];
        float xh[2], xl[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = c0 + i;
          gc[i] = board_x(c == W ? 0 : c);
          xh[i] = (per_x || gc[i] != nx - 1) ? 1.f : 0.f;
          xl[i] = (per_x || gc[i] != 0) ? 1.f : 0.f;
          const bool in = c >= hx && c < hx + tw;
          n_lo[i] = in ? hy : 0;
          n_hi[i] = in ? hy + th : 0;
        }
        if (last)
          gol_rows<true>(src, dst, cnt, W, H, c0, two, col, lo, hi, board_y(lo),
                         ny, nx, per_y, xh, xl, gc, n_lo, n_hi);
        else
          gol_rows<false>(src, dst, cnt, W, H, c0, two, col, lo, hi, board_y(lo),
                          ny, nx, per_y, xh, xl, gc, n_lo, n_hi);
      }
      float* t = cur;
      cur = nxt;
      nxt = t;
      __syncthreads();
    }
    done += n;
    if (done == turns) break;

    // exchange: the tile out to this round's board, the halo back in (all
    // loads issued before the first store)
    float* G = board + (size_t)(round & 1) * ny * nx;
    for (int r = threadIdx.y; r < th; r += by)
      for (int c = threadIdx.x; c < tw; c += bx)
        __stcg(G + (y0 + r) * nx + x0 + c, cur[(r + hy) * W + c + hx]);
    cg::this_grid().sync();
    float hv[kGolHaloSlots];
#pragma unroll
    for (int m = 0; m < kGolHaloSlots; ++m)
      if (hd[m] >= 0) hv[m] = __ldcg(G + hs[m]);
#pragma unroll
    for (int m = 0; m < kGolHaloSlots; ++m)
      if (hd[m] >= 0) cur[hd[m]] = hv[m];
    __syncthreads();
  }

  for (int r = threadIdx.y; r < th; r += by)
    for (int c = threadIdx.x; c < tw; c += bx)
      out[(y0 + r) * nx + x0 + c] = cur[(r + hy) * W + c + hx];
}

}  // namespace

extern "C" {

// The whole run on the plan's py x px tiles (ops/gol_kernel.py::
// gol_run_plan), k turns a round: one CTA of bx x by threads a tile, `smem`
// bytes of dynamic shared memory each.  alive, out, cnt: ny*nx floats;
// board: 2*ny*nx floats of scratch, allocated by the caller.  A plan that
// does not fit the board (its largest tile and halo over `smem` bytes, k
// over its smallest tile's extent on a split axis, a halo over
// kGolHaloSlots cells a thread) is refused with cudaErrorInvalidValue, and
// one the card cannot hold (more CTAs than can be co-resident, more shared
// memory than a block may opt into) with its error; either runs nothing.
int gol_run(const float* alive, float* out, float* cnt, float* board, int ny,
            int nx, int turns, int per_x, int per_y, int py, int px, int k,
            int bx, int by, int smem, void* stream) {
  if (ny < 1 || nx < 1 || turns < 0 || (long long)ny * nx >= (1LL << 31) ||
      py < 1 || px < 1 || py > ny || px > nx || k < 1 || bx < 1 || by < 1 ||
      bx * by > 512 || smem < 1)
    return (int)cudaErrorInvalidValue;
  // the plan's needs, recomputed from the board (ops/gol_kernel.py::
  // gol_smem_bytes, gol_halo_cells)
  const long long hy = py > 1 ? k : 0, hx = px > 1 ? k : 0;
  const long long th = (ny + py - 1) / py, tw = (nx + px - 1) / px;
  const long long H = th + 2 * hy, W = tw + 2 * hx;
  if (8 * H * W > smem || (hy && ny / py < k) || (hx && nx / px < k) ||
      2 * hy * W + 2 * hx * th > (long long)kGolHaloSlots * bx * by)
    return (int)cudaErrorInvalidValue;
  const int ctas = py * px;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute((const void*)gol_run_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gol_run_kernel,
                                                        bx * by, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if ((long long)per_sm * sms < ctas) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&alive, &out, &cnt, &board, &ny, &nx, &turns, &per_x,
                  &per_y, &py, &px, &k};
  err = cudaLaunchCooperativeKernel((const void*)gol_run_kernel, dim3((unsigned)ctas),
                                    dim3((unsigned)bx, (unsigned)by), args,
                                    (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
