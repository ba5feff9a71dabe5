// One dimension-split upwind Vlasov step on the dense phase-space layout,
// behind a plain C interface (the launcher returns the launch's
// cudaError_t).
//
//   vlasov_step  <- make_vlasov_step_blocked  (dccrg_tpu/ops/vlasov_kernel.py)
//
// f is [D, nzl, ny, nx, B] float32 (B = nv^3 velocity bins, minor); the
// device-edge planes below and above each slab are the slab ring's: read
// from the neighbouring slabs of f (vacuum past an open z end), or given
// as e_lo / e_hi [D, 1, ny, nx, B]; vx, vy, vz are the per-bin velocities
// [B].  Each split is the XLA body's
//   flux_hi = (v >= 0 ? f : hi) * v,  flux_lo = (v >= 0 ? lo : f) * v
//   f' = f - s * (flux_hi - flux_lo),  s = dt * inv_d (rounded once, f32)
// applied x, then y (plane-local; on an open axis the wrapped neighbour is
// replaced by 0), then z, whose z-1 / z+1 values are the x-then-y split of
// the neighbouring planes.  Every product and sum goes through __fmul_rn /
// __fsub_rn (the build also passes -fmad=false), so the kernel equals its
// plain PyTorch twin (ops/vlasov_kernel.py::vlasov_step_blocked_plain)
// bitwise.
//
// Bound on this card: device-memory bytes.  f is read once and written
// once a step (8 bytes a phase-space cell, 134 MB at 32^3 x 512), against
// 15 flops a cell; at the bench's size f (64 MiB) exceeds the 50 MB L2, so
// each step streams from HBM.
//
// Design: a CTA owns a ty x tx spatial tile of one chunk of C bins over a
// run of zl planes (the launch plan, ops/vlasov_kernel.py::
// vlasov_step_plan, picks the tile, the chunk and the z run; the results do
// not depend on them).  It marches up in z.  For each plane it stages the
// (ty+2) x (tx+2) x C window in shared memory with cp.async (16-byte copies
// along the bins where B allows), kStages buffers deep so the next planes
// land while this one computes, one CTA barrier a plane.  A thread owns one
// (x, bin) column of the tile: it computes the x split of the ty+2 window
// rows at its column and the y split of its ty cells in registers, marching
// in y, and keeps the xy-split values of planes z-1 and z for its cells, so
// the z split needs no second pass.  A split reads only its upwind
// neighbour (the other flux term is the cell's own value), whose side a
// thread's bin fixes.  Each f value is read from global memory
// (ty+2)(tx+2)/(ty tx) times a plane visit, and each plane (zl+2)/zl times.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// the split with only the upwind neighbour `up` (lo where v >= 0, else hi):
// the other flux term is the cell's own, so these are the XLA body's
// products, difference and rounding
__device__ __forceinline__ float split_up(float f, float up, bool pos, float v,
                                          float s) {
  const float ff = mul(f, v), fu = mul(up, v);
  return sub(f, mul(s, pos ? sub(ff, fu) : sub(fu, ff)));
}

constexpr int kThreads = 256;  // threads a CTA at most (C x tx)
constexpr int kMaxRows = 16;   // tile rows, a thread's cells a plane, at most
constexpr int kStages = 3;     // window buffers (planes in flight + 1)
constexpr int kMinCtas = 2;    // CTAs an SM the register budget allows

// (start, length) of part i of n cut into p parts, the first n % p longer
__host__ __device__ __forceinline__ void part(int n, int p, int i, int* s,
                                              int* len) {
  const int q = n / p, r = n % p;
  *s = i * q + (i < r ? i : r);
  *len = q + (i < r ? 1 : 0);
}

// copy `bytes` (16 or 4) from global to shared memory asynchronously, or
// zeros where `zero` (the source is then not read)
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes, bool zero) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = zero ? 0 : bytes;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Plan {
  int ty, tx;        // the largest tile
  int chunk;         // C bins a CTA
  int vec;           // floats a copy (4: 16 bytes, or 1)
  int z_parts;       // z runs a slab
  int n_ty, n_tx;    // tiles along y, x
  int n_ch;          // bin chunks
};

// floats of dynamic shared memory the plan's largest tile needs
__host__ __device__ __forceinline__ long long smem_floats(const Plan& p) {
  return (long long)kStages * (p.ty + 2) * (p.tx + 2) * p.chunk;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, kMinCtas)
vlasov_tile_kernel(const float* __restrict__ f, const float* __restrict__ e_lo,
                   const float* __restrict__ e_hi, const float* __restrict__ vx,
                   const float* __restrict__ vy, const float* __restrict__ vz,
                   float* __restrict__ out, int D, int nzl, int ny, int nx,
                   int B, int px, int py, int pz, int ring, float sx, float sy,
                   float sz, Plan p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.chunk;
  // the CTA's chunk, tile, z run and slab: chunk fastest
  int idx = blockIdx.x;
  const int ch = idx % p.n_ch;
  idx /= p.n_ch;
  const int tix = idx % p.n_tx;
  idx /= p.n_tx;
  const int tiy = idx % p.n_ty;
  idx /= p.n_ty;
  const int zp = idx % p.z_parts;
  const int d = idx / p.z_parts;
  int y0, h, x0, w, z0, zl;
  part(ny, p.n_ty, tiy, &y0, &h);
  part(nx, p.n_tx, tix, &x0, &w);
  part(nzl, p.z_parts, zp, &z0, &zl);
  const int b0 = ch * C;
  const int cw = min(C, B - b0);  // bins in this chunk

  const long long PB = (long long)ny * nx * B;
  const float* F = f + (long long)d * nzl * PB;
  float* O = out + (long long)d * nzl * PB;
  // plane z of the slab; below 0 and above nzl - 1 the edge planes given,
  // or (ring) the neighbouring slabs' end planes on the slab ring, vacuum
  // past an open z end
  auto plane = [&](int z, bool* vacuum) -> const float* {
    *vacuum = false;
    if (z >= 0 && z < nzl) return F + (long long)z * PB;
    if (!ring) return (z < 0 ? e_lo : e_hi) + (long long)d * PB;
    const bool below = z < 0;
    const int dn = below ? (d == 0 ? D - 1 : d - 1) : (d == D - 1 ? 0 : d + 1);
    *vacuum = !pz && (below ? d == 0 : d == D - 1);
    return f + ((long long)dn * nzl + (below ? nzl - 1 : 0)) * PB;
  };

  const int wrow = (w + 2) * C;  // floats a window row
  const int win_floats = (p.ty + 2) * (p.tx + 2) * C;

  // stage plane z's window (wrapped rows and columns) into buffer s: thread
  // t copies slot t % slots of window positions t / slots, t / slots + Q, ...
  const int slots = C / VEC;       // copies a full chunk's position
  const int units = cw / VEC;      // copies this chunk's position
  const int Q = blockDim.x / slots;
  const int u = threadIdx.x % slots;
  const int npos = (h + 2) * (w + 2);
  auto stage = [&](int z, int s) {
    bool vacuum;
    const float* src = plane(z, &vacuum) + b0 + u * VEC;
    float* dst = smem + s * win_floats + u * VEC;
    if (u < units) {
      int q = threadIdx.x / slots;
      int wx = q % (w + 2), wy = q / (w + 2);
      const int dx = Q % (w + 2), dy = Q / (w + 2);
      for (; q < npos; q += Q) {
        int gy = y0 - 1 + wy, gx = x0 - 1 + wx;
        gy = gy < 0 ? gy + ny : (gy >= ny ? gy - ny : gy);
        gx = gx < 0 ? gx + nx : (gx >= nx ? gx - nx : gx);
        cp_async(dst + q * C, src + ((long long)gy * nx + gx) * B, 4 * VEC, vacuum);
        wx += dx;
        wy += dy;
        if (wx >= w + 2) wx -= w + 2, ++wy;
      }
    }
    cp_commit();
  };

  // this thread's column: bin b of the chunk at tile column x
  const int t = threadIdx.x;
  const int b = t % C, x = t / C;
  const bool active = b < cw && x < w;
  const float v_x = active ? vx[b0 + b] : 0.f;
  const float v_y = active ? vy[b0 + b] : 0.f;
  const float v_z = active ? vz[b0 + b] : 0.f;
  const bool pos_x = v_x >= 0.f, pos_y = v_y >= 0.f, pos_z = v_z >= 0.f;
  // the upwind x neighbour: its offset in a window row, and whether it
  // exists (an open x axis has vacuum outside)
  const int up_x = pos_x ? -C : C;
  const bool has_x = px || (pos_x ? x0 + x != 0 : x0 + x != nx - 1);
  const int col = (x + 1) * C + b;
  const long long row_stride = (long long)nx * B;
  const long long out0 = ((long long)y0 * nx + x0 + x) * B + b0 + b;

  float g_dn[kMaxRows], g_c[kMaxRows];
  const int n_planes = zl + 2;  // z0-1 .. z0+zl
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    if (s < n_planes) stage(z0 - 1 + s, s);
  for (int j = 0; j < n_planes; ++j) {
    // plane j landed: later planes may still be in flight
    if (j + kStages - 1 <= n_planes)
      cp_wait<kStages - 2>();
    else
      cp_wait<0>();
    __syncthreads();  // plane j landed everywhere; window j-1 is consumed
    if (j + kStages - 1 < n_planes)
      stage(z0 - 1 + j + kStages - 1, (j + kStages - 1) % kStages);
    if (!active) continue;
    const float* win = smem + (j % kStages) * win_floats + col;
    // x split of window row r at this column
    auto xsplit = [&](int r) {
      const float* f = win + r * wrow;
      return split_up(f[0], has_x ? f[up_x] : 0.f, pos_x, v_x, sx);
    };
    // y split marching down the column, then the z split of plane
    // z0 - 2 + j
    const int zo = z0 - 2 + j;
    float* O_z = O + (long long)zo * PB + out0;
    float xm = xsplit(0), xc = xsplit(1);
#pragma unroll
    for (int y = 0; y < kMaxRows; ++y) {
      if (y >= h) break;
      const float xp = xsplit(y + 2);
      const bool has = py || (pos_y ? y0 + y != 0 : y0 + y != ny - 1);
      const float g = split_up(xc, has ? (pos_y ? xm : xp) : 0.f, pos_y, v_y, sy);
      if (j >= 2)
        O_z[y * row_stride] = split_up(g_c[y], pos_z ? g_dn[y] : g, pos_z, v_z, sz);
      g_dn[y] = g_c[y];
      g_c[y] = g;
      xm = xc;
      xc = xp;
    }
  }
}

}  // namespace

extern "C" {

// One step over D slab slots under a launch plan (vlasov_step_plan): tiles
// of at most ty x tx cells (n_ty x n_tx of them, cut as `part` cuts), bin
// chunks of `chunk` (n_ch of them), `vec` floats a copy, z_parts runs a
// slab, `threads` a CTA, smem_bytes of dynamic shared memory.  The launcher
// recomputes what the largest tile needs and returns cudaErrorInvalidValue
// for a plan that does not cover this shape or falls short of it.  sx, sy,
// sz are dt * inv_dx per axis, rounded to float32 by the caller.  With
// `ring` the planes beyond each slab's ends are read from the neighbouring
// slabs of f (vacuum past an open z end, pz = 0) and e_lo / e_hi are not
// read; otherwise they are [n_dev, 1, ny, nx, B].
int vlasov_step(const float* f, const float* e_lo, const float* e_hi,
                const float* vx, const float* vy, const float* vz, float* out,
                int n_dev, int nzl, int ny, int nx, int B, int px, int py,
                int pz, int ring, float sx, float sy, float sz, int ty, int tx,
                int chunk,
                int vec, int z_parts, int threads, int smem_bytes,
                void* stream) {
  if (n_dev < 1 || nzl < 1 || ny < 1 || nx < 1 || B < 1 ||
      (!ring && (e_lo == nullptr || e_hi == nullptr)))
    return (int)cudaErrorInvalidValue;
  Plan p{ty, tx, chunk, vec, z_parts, 0, 0, 0};
  if (ty < 1 || ty > ny || ty > kMaxRows || tx < 1 || tx > nx || chunk < 1 ||
      chunk > B || z_parts < 1 || z_parts > nzl || (vec != 1 && vec != 4) ||
      B % vec != 0 || chunk % vec != 0 || threads != chunk * tx ||
      threads > kThreads)
    return (int)cudaErrorInvalidValue;
  p.n_ty = (ny + ty - 1) / ty;
  p.n_tx = (nx + tx - 1) / tx;
  p.n_ch = (B + chunk - 1) / chunk;
  // every tile within the plan's largest: the first parts are the longest
  int s, ly, lx;
  part(ny, p.n_ty, 0, &s, &ly);
  part(nx, p.n_tx, 0, &s, &lx);
  if (ly > ty || lx > tx || 4 * smem_floats(p) > (long long)smem_bytes)
    return (int)cudaErrorInvalidValue;
  const long long ctas = (long long)n_dev * z_parts * p.n_ty * p.n_tx * p.n_ch;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const void* kernel = vec == 4 ? (const void*)vlasov_tile_kernel<4>
                                : (const void*)vlasov_tile_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (vec == 4)
    vlasov_tile_kernel<4><<<(unsigned)ctas, threads, smem_bytes,
                            (cudaStream_t)stream>>>(
        f, e_lo, e_hi, vx, vy, vz, out, n_dev, nzl, ny, nx, B, px, py, pz, ring,
        sx, sy, sz, p);
  else
    vlasov_tile_kernel<1><<<(unsigned)ctas, threads, smem_bytes,
                            (cudaStream_t)stream>>>(
        f, e_lo, e_hi, vx, vy, vz, out, n_dev, nzl, ny, nx, B, px, py, pz, ring,
        sx, sy, sz, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
