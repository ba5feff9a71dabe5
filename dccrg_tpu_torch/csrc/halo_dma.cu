// The halo exchange's grouped row gather, behind a plain C interface (the
// launcher returns the launch's cudaError_t).
//
//   ring_gather  <- ring_copy / ring_dma_start  (dccrg_tpu/parallel/halo_dma.py)
//                   and the merge blk.at[rr].set(p)  (dccrg_tpu/parallel/halo.py)
//
// On the TPU each ring distance k is one kernel issuing an asynchronous
// remote DMA of a device's packed [S_k, ...] payload to device (d + k) % D,
// and the receiver scatters the payload into its ghost rows outside the
// kernel.  Here the D device slots are the leading axis of one tensor on one
// card, so both halves are gathers of rows, and one launch carries every
// field of an exchange.  For each field f of the launch and each row i of
// its output,
//
//   dst_f[i] = second_f[table_f[i]]   where table_f[i] >= 0,
//              first_f[i]             where table_f[i] <  0,
//
// which the exchange uses three ways (parallel/halo.py builds the tables
// once per epoch and field schedule):
//
//   payload   second = the field [D * R rows], table = the ring's flat send
//             rows (the JAX ring layout, pads included): B9's own function;
//   blocking  first = second = the field, table = `full` over all D * R
//             rows (r itself, or the owner's flat row on a ghost row the
//             schedule refreshes): the whole exchange in one gather;
//   merge     first = the field, second = the payload, table = `merge` (the
//             payload slot of a refreshed ghost row, else -1).
//
// The kernel moves bits and does no arithmetic, so it equals its plain
// PyTorch twin (parallel/halo_dma.py::ring_gather_plain) bitwise for every
// dtype.
//
// Bound on this card: device-memory bytes (each row read once and written
// once, plus the 4-byte table entry a row), with no arithmetic.  A halo is
// small (tens of thousands of rows of 4 bytes at the density exchange), so
// one launch's fixed cost and a thread's chain of dependent loads (table,
// then row) dominate: the design spends few launches and keeps many
// independent loads in flight.
//
// Design:
// - Field descriptors travel by value in the launch's parameter block
//   (pointers, rows, row bytes, and the CTA range each field owns, as
//   prefix sums): an exchange costs no host-to-device copy.  At most
//   kMaxFields fields a launch; the wrapper splits a larger state into
//   several launches of this kernel.
// - A CTA finds its field from the CTA starts (uniform per CTA); the grid
//   is one wave (the SMs times the CTAs that fit on one, or fewer where
//   the fields need fewer), shared among the fields in proportion to their
//   threads; CTAs stride over their field's rows.
// - Words of 16, 8, 4, 2 or 1 bytes, the widest that divides the row's bytes
//   and every base pointer of the field, picked per field inside the kernel
//   (a branch uniform across the CTA).
// - A row of one word takes a thread per run of consecutive rows (kRowsPayload
//   in a payload, kRowsOwn where the field has a `first`, at most kRunBytes
//   of them): their table entries come in one vector load (int4 for 4 and 8
//   rows), their words go out in one vector store, and every gather is
//   issued before the store.
// - A wider row takes a group of `lanes` threads (a power of two, kLaneWords
//   words a lane a column pass), so a 2 KiB Vlasov row is read and written
//   in coalesced 16-byte words.  Row and column come from the thread and
//   the group: no division per word.
// - Where a field has a `first`, its rows are read beside the table entries
//   (a vector load, for one-word rows), so a row that keeps its own value
//   (a negative entry, or entry i of a blocking table where first and
//   second are one tensor) costs one round trip to memory, not two.
// - One-word rows are read through the read-only path; wider rows with
//   streaming (evict-first) loads, so the rows a launch passes through
//   leave the L2 to its output and tables (kernel_probe.py ring-sweep on an
//   H100: streaming loads ran the 2 KiB Vlasov payload 4-8% faster than the
//   read-only path; at the one-word density payload they won only with the
//   tables cold, and tied or lost with the index warm, as the main path has
//   it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRingThreads = 256;
constexpr int kMaxFields = 8;
constexpr int kLaneWords = 4;
// bytes of one-word rows a thread moves a pass at most (sets the rows)
constexpr int kRunBytes = 32;
// rows a thread of one-word rows (1, 2, 4 or 8) in a payload, and where the
// field has a `first` (a blocking exchange, a merge): the fastest or tied
// at the main path's shapes (kernel_probe.py ring-sweep on an H100)
constexpr int kRowsPayload = 2;
constexpr int kRowsOwn = 8;
// CTAs of a launch at most; 0: one wave (the SMs times the CTAs that fit on
// one)
constexpr int kMaxCtas = 0;
// rows a field at most: a thread's row index plus a grid stride stays an int
constexpr long long kMaxRows = 1LL << 30;

struct Field {
  const char* first;     // row i read where entry i is < 0 (merge), or null
  const char* second;    // the rows the entries index
  char* dst;             // `rows` output rows
  const int32_t* table;  // `rows` int32 entries
  int rows;
  int words;             // words a row
  int wlog;              // log2 of a word's bytes
  int lanes_log;         // log2 of the threads a row (rows of several words)
  int cta_begin;         // first CTA of this field
  int ctas;              // CTAs of this field
};

struct Fields {
  Field f[kMaxFields];
  int n;
};

// how the words of a one-word row are read
template <typename T>
__device__ __forceinline__ T load_narrow(const T* p) { return __ldg(p); }
// how the words of a wider row are read
template <typename T>
__device__ __forceinline__ T load_wide(const T* p) { return __ldcs(p); }

template <int B> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<2> { using T = uint16_t; };

// N consecutive elements at s, of which `valid` exist, as whole vectors of
// up to 16 bytes where all N exist and s is aligned to the vector; table
// entries (TABLE) through the read-only path, rows as load_narrow reads them
template <bool TABLE, typename T, int N>
__device__ __forceinline__ void load_run(const T* s, int valid, T (&v)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kVec = kBytes >= 16 ? 16 : kBytes;
  if constexpr (kVec > (int)sizeof(T)) {
    using V = typename Vec<kVec>::T;
    if (valid >= N && ((uintptr_t)s & (kVec - 1)) == 0) {
      union {
        T w[N];
        V q[kBytes / kVec];
      } u;
#pragma unroll
      for (int i = 0; i < kBytes / kVec; ++i)
        u.q[i] = TABLE ? __ldg(reinterpret_cast<const V*>(s) + i)
                       : load_narrow(reinterpret_cast<const V*>(s) + i);
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = u.w[i];
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < valid) v[i] = TABLE ? __ldg(s + i) : load_narrow(s + i);
}

template <typename T, int N>
__device__ __forceinline__ void store_run(T* d, int valid, const T (&v)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kVec = kBytes >= 16 ? 16 : kBytes;
  if constexpr (kVec > (int)sizeof(T)) {
    using V = typename Vec<kVec>::T;
    if (valid >= N && ((uintptr_t)d & (kVec - 1)) == 0) {
      union {
        T w[N];
        V q[kBytes / kVec];
      } u;
#pragma unroll
      for (int i = 0; i < N; ++i) u.w[i] = v[i];
#pragma unroll
      for (int i = 0; i < kBytes / kVec; ++i) reinterpret_cast<V*>(d)[i] = u.q[i];
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < valid) d[i] = v[i];
}

// rows of one word: a thread a run of RPT consecutive rows
template <typename W, int RPT>
__device__ __forceinline__ void gather_narrow(const Field& g) {
  const W* first = reinterpret_cast<const W*>(g.first);
  const W* second = reinterpret_cast<const W*>(g.second);
  W* dst = reinterpret_cast<W*>(g.dst);
  const bool same = g.first == g.second;
  const int step = g.ctas * kRingThreads * RPT;
  for (int r0 = ((int)(blockIdx.x - g.cta_begin) * kRingThreads + (int)threadIdx.x) * RPT;
       r0 < g.rows; r0 += step) {
    const int valid = g.rows - r0;
    int idx[RPT];
    W own[RPT], v[RPT];
    load_run<true>(g.table + r0, valid, idx);
    if (first != nullptr) load_run<false>(first + r0, valid, own);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      if (i < valid)
        v[i] = idx[i] < 0 || (same && idx[i] == r0 + i) ? own[i]
                                                         : load_narrow(second + idx[i]);
    store_run<W, RPT>(dst + r0, valid, v);
  }
}

// rows of several words: a group of lanes a row
template <typename W>
__device__ __forceinline__ void gather_wide(const Field& g) {
  const W* first = reinterpret_cast<const W*>(g.first);
  const W* second = reinterpret_cast<const W*>(g.second);
  W* dst = reinterpret_cast<W*>(g.dst);
  const bool same = g.first == g.second;
  const int words = g.words, lanes = 1 << g.lanes_log;
  const int lane = threadIdx.x & (lanes - 1);
  const int groups = kRingThreads >> g.lanes_log;
  for (int r = (int)(blockIdx.x - g.cta_begin) * groups + ((int)threadIdx.x >> g.lanes_log);
       r < g.rows; r += g.ctas * groups) {
    const int t = __ldg(g.table + r);
    const long long at = (long long)r * words;
    const bool keep = t < 0 || (same && t == r);
    const W* src = second + (long long)t * words;
    for (int c0 = lane; c0 < words; c0 += lanes * kLaneWords) {
      W own[kLaneWords], v[kLaneWords];
      if (first != nullptr) {
#pragma unroll
        for (int j = 0; j < kLaneWords; ++j) {
          const int c = c0 + j * lanes;
          if (c < words) own[j] = load_wide(first + at + c);
        }
      }
#pragma unroll
      for (int j = 0; j < kLaneWords; ++j) {
        const int c = c0 + j * lanes;
        if (c < words) v[j] = keep ? own[j] : load_wide(src + c);
      }
#pragma unroll
      for (int j = 0; j < kLaneWords; ++j) {
        const int c = c0 + j * lanes;
        if (c < words) dst[at + c] = v[j];
      }
    }
  }
}

// rows a thread for one-word rows of `word` bytes: `rows`, at most
// kRunBytes of them
__host__ __device__ constexpr int run_rows(int rows, int word) {
  return rows * word <= kRunBytes ? rows : kRunBytes / word;
}

template <typename W>
__device__ __forceinline__ void gather_field(const Field& g) {
  if (g.words != 1)
    gather_wide<W>(g);
  else if (g.first != nullptr)
    gather_narrow<W, run_rows(kRowsOwn, sizeof(W))>(g);
  else
    gather_narrow<W, run_rows(kRowsPayload, sizeof(W))>(g);
}

__global__ void __launch_bounds__(kRingThreads)
ring_gather_kernel(const __grid_constant__ Fields p) {
  int s = 0;
  while (s + 1 < p.n && (int)blockIdx.x >= p.f[s + 1].cta_begin) ++s;
  const Field& g = p.f[s];
  switch (g.wlog) {
    case 4: gather_field<uint4>(g); break;
    case 3: gather_field<uint2>(g); break;
    case 2: gather_field<uint32_t>(g); break;
    case 1: gather_field<uint16_t>(g); break;
    default: gather_field<uint8_t>(g); break;
  }
}

// CTAs of a launch: kMaxCtas, or one wave on the current device (cached a
// device)
int grid_ctas() {
  if (kMaxCtas > 0) return kMaxCtas;
  static int cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_gather_kernel,
                                                      kRingThreads, 0) != cudaSuccess)
      return 0;
    cache[dev] = sms * per_sm;
  }
  return cache[dev];
}

// Fills p from n descriptors of six int64 each (first, second, dst, table,
// rows, row bytes) and shares the grid's CTAs among the fields in
// proportion to their threads; returns the CTAs to launch, or 0 for a
// descriptor or count the kernel does not take.
long long plan(const long long* desc, int n, Fields& p) {
  const int max_ctas = grid_ctas();
  if (n < 1 || n > kMaxFields || max_ctas < 1) return 0;
  long long need[kMaxFields], total = 0;
  p.n = n;
  for (int i = 0; i < n; ++i) {
    const long long* d = desc + 6 * i;
    const long long rows = d[4], row_bytes = d[5];
    if (d[1] == 0 || d[2] == 0 || d[3] == 0 || rows < 1 || rows > kMaxRows || row_bytes < 1)
      return 0;
    const uintptr_t align = (uintptr_t)d[0] | (uintptr_t)d[1] | (uintptr_t)d[2] |
                            (uintptr_t)row_bytes;
    const int wlog = align % 16 == 0 ? 4 : align % 8 == 0 ? 3 : align % 4 == 0 ? 2
                   : align % 2 == 0 ? 1 : 0;
    const long long words = row_bytes >> wlog;
    if (words >= (1LL << 31)) return 0;
    Field& f = p.f[i];
    f.first = reinterpret_cast<const char*>(d[0]);
    f.second = reinterpret_cast<const char*>(d[1]);
    f.dst = reinterpret_cast<char*>(d[2]);
    f.table = reinterpret_cast<const int32_t*>(d[3]);
    f.rows = (int)rows;
    f.words = (int)words;
    f.wlog = wlog;
    f.lanes_log = 0;
    long long threads;
    if (words == 1) {
      const int r = run_rows(d[0] != 0 ? kRowsOwn : kRowsPayload, 1 << wlog);
      threads = (rows + r - 1) / r;
    } else {
      while ((1LL << f.lanes_log) * kLaneWords < words && (1 << f.lanes_log) < kRingThreads)
        ++f.lanes_log;
      threads = rows << f.lanes_log;
    }
    need[i] = (threads + kRingThreads - 1) / kRingThreads;
    total += need[i];
  }
  long long begin = 0;
  for (int i = 0; i < n; ++i) {
    long long c = need[i];
    if (total > max_ctas) {
      c = need[i] * max_ctas / total;
      if (c < 1) c = 1;
    }
    p.f[i].cta_begin = (int)begin;
    p.f[i].ctas = (int)c;
    begin += c;
  }
  return begin;
}

}  // namespace

extern "C" {

// One launch over n <= kMaxFields fields.  desc: n x 6 int64 in host memory
// (first or 0, second, dst, table, rows, row bytes); the table's entries are
// rows of second (or negative: the row of first) that the halo schedule
// builds in range (reading them back to check would sync the stream).  Any
// element type: row bytes is any positive count.
int ring_gather(const long long* desc, int n, void* stream) {
  Fields p;
  const long long ctas = plan(desc, n, p);
  if (ctas < 1) return (int)cudaErrorInvalidValue;
  ring_gather_kernel<<<(unsigned)ctas, kRingThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The split ring_gather would launch, without launching: for each field its
// word bytes, threads a row, rows a thread, first CTA and CTAs (out: n x 5
// ints).
int ring_gather_plan(const long long* desc, int n, int* out) {
  Fields p;
  if (plan(desc, n, p) < 1) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) {
    const Field& f = p.f[i];
    const int rows = f.words == 1 ? run_rows(f.first != nullptr ? kRowsOwn : kRowsPayload,
                                             1 << f.wlog) : 1;
    const int row[5] = {1 << f.wlog, 1 << f.lanes_log, rows, f.cta_begin, f.ctas};
    for (int k = 0; k < 5; ++k) out[5 * i + k] = row[k];
  }
  return 0;
}

}  // extern "C"
