// Native neighbor-list construction: the hot host-side kernel behind
// find_all_neighbors (core/neighbors.py), whose semantics mirror the
// reference's find_neighbors_of walk (dccrg.hpp:4339-4680) re-derived as
// direct index arithmetic + binary search over the sorted leaf directory.
//
// The Python/numpy implementation is the semantic source of truth and the
// fallback; this kernel exists because epoch rebuilds after AMR/load
// balancing are O(cells * slots) host work — the main scaling risk of the
// host-orchestrated design — and a compiled, OpenMP-parallel version keeps
// rebuild cost negligible against device compute.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC
//        -o libneighbor_kernels.so neighbor_kernels.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#include <parallel/algorithm>
#endif

namespace {

struct MappingParams {
    uint64_t len[3];     // grid length in level-0 cells
    int max_ref;         // maximum refinement level
    uint64_t level_offset[32];  // first id of each level block (1-based)
    uint64_t last_cell;
};

inline void init_mapping(MappingParams& m) {
    uint64_t n0 = m.len[0] * m.len[1] * m.len[2];
    uint64_t off = 1;
    for (int l = 0; l <= m.max_ref + 1 && l < 32; l++) {
        m.level_offset[l] = off;
        off += n0 << (3 * l);
    }
    m.last_cell = m.level_offset[m.max_ref + 1] - 1;
}

inline int refinement_level(const MappingParams& m, uint64_t cell) {
    if (cell == 0 || cell > m.last_cell) return -1;
    for (int l = 0; l <= m.max_ref; l++) {
        if (cell < m.level_offset[l + 1]) return l;
    }
    return -1;
}

// indices at max-refinement resolution (cell min corner)
inline void get_indices(const MappingParams& m, uint64_t cell, int lvl,
                        int64_t out[3]) {
    uint64_t local = cell - m.level_offset[lvl];
    uint64_t lx = m.len[0] << lvl, ly = m.len[1] << lvl;
    uint64_t scale = uint64_t(1) << (m.max_ref - lvl);
    out[0] = int64_t((local % lx) * scale);
    out[1] = int64_t(((local / lx) % ly) * scale);
    out[2] = int64_t((local / (lx * ly)) * scale);
}

inline uint64_t cell_from_indices(const MappingParams& m, const int64_t ind[3],
                                  int lvl) {
    uint64_t scale = uint64_t(1) << (m.max_ref - lvl);
    uint64_t ix = uint64_t(ind[0]) / scale;
    uint64_t iy = uint64_t(ind[1]) / scale;
    uint64_t iz = uint64_t(ind[2]) / scale;
    uint64_t lx = m.len[0] << lvl, ly = m.len[1] << lvl;
    return m.level_offset[lvl] + ix + iy * lx + iz * lx * ly;
}

// binary search in sorted leaf array; -1 if absent
inline int64_t leaf_position(const uint64_t* leaves, int64_t n, uint64_t id) {
    int64_t lo = 0, hi = n - 1;
    while (lo <= hi) {
        int64_t mid = (lo + hi) >> 1;
        if (leaves[mid] < id) lo = mid + 1;
        else if (leaves[mid] > id) hi = mid - 1;
        else return mid;
    }
    return -1;
}

// uniform level-0 grid: the sorted unique leaf array is exactly [1..n],
// so position(id) = id - 1 — no search
inline int64_t leaf_position_any(const uint64_t* leaves, int64_t n,
                                 uint64_t id, int uniform) {
    if (uniform) return (id >= 1 && id <= uint64_t(n)) ? int64_t(id) - 1 : -1;
    return leaf_position(leaves, n, id);
}

}  // namespace

extern "C" {

// Phase 1: count entries per source cell (fills counts[n_src]).
// Phase 2 (emit != 0): fill CSR outputs; out_start must already hold the
// exclusive prefix sum of counts (n_src + 1 entries).
// Returns 0 on success, 1 on inconsistent grid (strict mode), where
// bad_cell/bad_slot identify the offender.
int find_neighbors(
    const uint64_t* leaves, int64_t n_leaves,
    const uint64_t* grid_len, int max_ref,
    const uint8_t* periodic,
    const int64_t* hood, int64_t n_hood,           // (K, 3) flattened
    const uint64_t* src_cells, int64_t n_src,
    int uniform,                                   // leaves == [1..n0] level-0
    int strict,
    int emit,
    int64_t* counts,                               // n_src
    const int64_t* out_start,                      // n_src + 1 (phase 2)
    uint64_t* out_nbr,                             // E
    int64_t* out_pos,                              // E
    int64_t* out_offset,                           // (E, 3) flattened
    int32_t* out_slot,                             // E
    uint64_t* bad_cell, int64_t* bad_slot
) {
    MappingParams m;
    m.len[0] = grid_len[0]; m.len[1] = grid_len[1]; m.len[2] = grid_len[2];
    m.max_ref = max_ref;
    init_mapping(m);

    const int64_t L[3] = {
        int64_t(m.len[0]) << max_ref,
        int64_t(m.len[1]) << max_ref,
        int64_t(m.len[2]) << max_ref,
    };

    int error = 0;

#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_src; i++) {
        if (error) continue;
        const uint64_t cell = src_cells[i];
        const int lvl = refinement_level(m, cell);
        int64_t idx[3];
        get_indices(m, cell, lvl, idx);
        const int64_t s = int64_t(1) << (max_ref - lvl);

        int64_t n_entries = 0;
        int64_t cursor = emit ? out_start[i] : 0;

        for (int64_t k = 0; k < n_hood; k++) {
            int64_t t[3], t_mod[3];
            bool valid = true;
            for (int d = 0; d < 3; d++) {
                t[d] = idx[d] + hood[3 * k + d] * s;
                if (t[d] < 0 || t[d] >= L[d]) {
                    if (!periodic[d]) { valid = false; break; }
                }
                int64_t w = t[d] % L[d];
                t_mod[d] = w < 0 ? w + L[d] : w;
            }
            if (!valid) continue;

            // same level?
            uint64_t cand = cell_from_indices(m, t_mod, lvl);
            int64_t pos = leaf_position_any(leaves, n_leaves, cand, uniform);
            if (pos >= 0) {
                n_entries += 1;
                if (emit) {
                    out_nbr[cursor] = cand;
                    out_pos[cursor] = pos;
                    for (int d = 0; d < 3; d++)
                        out_offset[3 * cursor + d] = hood[3 * k + d] * s;
                    out_slot[cursor] = int32_t(k);
                    cursor++;
                }
                continue;
            }
            // coarser?
            if (lvl > 0) {
                uint64_t coarse = cell_from_indices(m, t_mod, lvl - 1);
                int64_t cpos = leaf_position_any(leaves, n_leaves, coarse, uniform);
                if (cpos >= 0) {
                    n_entries += 1;
                    if (emit) {
                        int64_t c_ind[3];
                        get_indices(m, coarse, lvl - 1, c_ind);
                        out_nbr[cursor] = coarse;
                        out_pos[cursor] = cpos;
                        for (int d = 0; d < 3; d++)
                            out_offset[3 * cursor + d] =
                                hood[3 * k + d] * s - (t_mod[d] - c_ind[d]);
                        out_slot[cursor] = int32_t(k);
                        cursor++;
                    }
                    continue;
                }
            }
            // finer: all 8 children of the slot's same-level candidate
            if (lvl < max_ref) {
                n_entries += 8;
                if (emit) {
                    const int64_t half = s >> 1;
                    int sib = 0;
                    for (int dz = 0; dz < 2; dz++)
                    for (int dy = 0; dy < 2; dy++)
                    for (int dx = 0; dx < 2; dx++, sib++) {
                        int64_t ci[3] = {
                            t_mod[0] + dx * half,
                            t_mod[1] + dy * half,
                            t_mod[2] + dz * half,
                        };
                        uint64_t child = cell_from_indices(m, ci, lvl + 1);
                        int64_t ppos = leaf_position_any(leaves, n_leaves, child, uniform);
                        if (ppos < 0 && strict) {
#pragma omp critical
                            { error = 1; *bad_cell = cell; *bad_slot = k; }
                        }
                        out_nbr[cursor] = child;
                        out_pos[cursor] = ppos;
                        out_offset[3 * cursor + 0] = hood[3 * k + 0] * s + dx * half;
                        out_offset[3 * cursor + 1] = hood[3 * k + 1] * s + dy * half;
                        out_offset[3 * cursor + 2] = hood[3 * k + 2] * s + dz * half;
                        out_slot[cursor] = int32_t(k);
                        cursor++;
                    }
                }
                continue;
            }
            // unresolved slot
            if (strict) {
#pragma omp critical
                { error = 1; *bad_cell = cell; *bad_slot = k; }
            }
        }
        counts[i] = n_entries;
    }
    return error;
}

// In-place parallel sort + dedupe of uint64 keys; returns the unique
// count.  Backs the packed-pair set operations (utils/setops.py) that
// dominate epoch rebuilds after AMR/load balancing — np.unique's serial
// sort is the equivalent fallback.
int64_t sort_unique_u64(uint64_t* keys, int64_t n) {
#ifdef _OPENMP
    __gnu_parallel::sort(keys, keys + n);
#else
    std::sort(keys, keys + n);
#endif
    return std::unique(keys, keys + n) - keys;
}

// Fused inverse-CSR + ghost-pair + inner/outer pass over the neighbor
// lists — one cache-friendly sweep replacing ~8 full-E numpy passes
// (invert_neighbors' packed-pair sort, the remote-edge masks, and the
// ghost (device, position) dedupe in epoch.py's _build_hood).
//
// The inverse relation uses counting buckets instead of an E log E sort:
// edges are emitted in ascending source order, so each target's bucket
// receives its sources already sorted and duplicate (src, nbr) edges
// (a coarse neighbor reached via several slots) are adjacent.
//
// Inputs: CSR (start, nbr_pos) over N sources with E edges; owner[N];
// D devices.  Outputs (caller-allocated):
//   to_start[N+1], to_src[E]   — unique inverse CSR (count returned)
//   is_outer[N]                — local cell with any remote of/to edge
//                                (caller-zeroed)
//   pair_bitmap[ceil(D*N/64)]  — bit d*N+p set iff device d needs a ghost
//                                of leaf p (caller-zeroed)
//   n_pairs                    — number of set bits
//   tmp[N]                     — scratch for the per-bucket write cursors
// Single-threaded: every step is memory-bound scatter/gather.
int64_t hood_invert_and_pairs(
    const int64_t* start, const int64_t* nbr_pos,
    int64_t N, int64_t E,
    const int64_t* owner, int64_t D,
    int64_t* to_start, int64_t* to_src,
    uint8_t* is_outer,
    uint64_t* pair_bitmap, int64_t* n_pairs,
    int64_t* tmp
) {
    // pass 1: bucket counts + remote-edge side effects
    for (int64_t p = 0; p <= N; p++) to_start[p] = 0;
    int64_t pairs = 0;
    for (int64_t i = 0; i < N; i++) {
        const int64_t oi = owner[i];
        for (int64_t e = start[i]; e < start[i + 1]; e++) {
            const int64_t p = nbr_pos[e];
            to_start[p + 1]++;
            const int64_t op = owner[p];
            if (op != oi) {
                is_outer[i] = 1;
                is_outer[p] = 1;
                const uint64_t b1 = uint64_t(oi) * N + p;  // oi needs ghost p
                const uint64_t b2 = uint64_t(op) * N + i;  // op needs ghost i
                uint64_t w, m;
                w = b1 >> 6; m = uint64_t(1) << (b1 & 63);
                if (!(pair_bitmap[w] & m)) { pair_bitmap[w] |= m; pairs++; }
                w = b2 >> 6; m = uint64_t(1) << (b2 & 63);
                if (!(pair_bitmap[w] & m)) { pair_bitmap[w] |= m; pairs++; }
            }
        }
    }
    *n_pairs = pairs;
    for (int64_t p = 0; p < N; p++) to_start[p + 1] += to_start[p];
    // pass 2: scatter sources into buckets.  Sources arrive in ascending
    // order per bucket (edges iterate src ascending), so duplicates are
    // adjacent and dedupe is a last-element check.  Raw buckets are
    // written into to_src at their un-deduped offsets; tmp[N] holds the
    // per-bucket write cursors, initialized to the bucket starts.
    std::memcpy(tmp, to_start, sizeof(int64_t) * N);
    int64_t* cursor = tmp;
    int64_t* raw = to_src;  // compacted in place below
    for (int64_t i = 0; i < N; i++) {
        for (int64_t e = start[i]; e < start[i + 1]; e++) {
            const int64_t p = nbr_pos[e];
            int64_t c = cursor[p];
            if (c > to_start[p] && raw[c - 1] == i) continue;  // duplicate
            raw[c] = i;
            cursor[p] = c + 1;
        }
    }
    // pass 3: compact buckets in place (ascending, so left-moves are safe)
    int64_t w = 0;
    int64_t prev_start = to_start[0];
    for (int64_t p = 0; p < N; p++) {
        const int64_t b0 = prev_start, b1 = cursor[p];
        prev_start = to_start[p + 1];
        to_start[p] = w;
        for (int64_t c = b0; c < b1; c++) raw[w++] = raw[c];
    }
    to_start[N] = w;
    return w;
}

// Extract the set bits of the ghost-pair bitmap in ascending (device,
// position) order.  Returns the number written.
int64_t extract_pairs(
    const uint64_t* pair_bitmap, int64_t D, int64_t N,
    int64_t* out_dev, int64_t* out_pos
) {
    const uint64_t total = uint64_t(D) * N;
    const int64_t words = int64_t((total + 63) / 64);
    int64_t k = 0;
    for (int64_t wi = 0; wi < words; wi++) {
        uint64_t w = pair_bitmap[wi];
        while (w) {
            const int b = __builtin_ctzll(w);
            w &= w - 1;
            const uint64_t bit = uint64_t(wi) * 64 + b;
            out_dev[k] = int64_t(bit / N);
            out_pos[k] = int64_t(bit % N);
            k++;
        }
    }
    return k;
}

// Fused gather-table fill: one sweep over the neighbor CSR writing the
// five per-device tables (row, valid, offset, length, slot) that epoch.py's
// _finish_hood builds with ~10 full-E numpy passes.  Ghost rows resolve by
// binary search in the owner's sorted ghost list.
// Tables are caller-allocated and pre-filled with their pad values.
void hood_fill_tables(
    const int64_t* start, const int64_t* nbr_pos,
    const int64_t* offset3, const int32_t* slot,
    int64_t N, int64_t E,
    const int64_t* owner, const int64_t* row_of, const int64_t* len_all,
    const int64_t* ghost_concat, const int64_t* ghost_start,  // D+1
    const int64_t* n_local,
    int64_t D, int64_t R, int64_t Kmax,
    int32_t* nbr_rows, uint8_t* nbr_valid, int32_t* nbr_offset,
    int32_t* nbr_len, int32_t* nbr_slot
) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < N; i++) {
        const int64_t d = owner[i];
        const int64_t* gl = ghost_concat + ghost_start[d];
        const int64_t gn = ghost_start[d + 1] - ghost_start[d];
        int64_t base = (d * R + row_of[i]) * Kmax;
        for (int64_t e = start[i]; e < start[i + 1]; e++) {
            const int64_t k = e - start[i];
            const int64_t p = nbr_pos[e];
            int64_t row;
            if (owner[p] == d) {
                row = row_of[p];
            } else {
                int64_t lo = 0, hi = gn - 1;
                row = R - 1;  // scratch if absent (cannot happen)
                while (lo <= hi) {
                    const int64_t mid = (lo + hi) >> 1;
                    if (gl[mid] < p) lo = mid + 1;
                    else if (gl[mid] > p) hi = mid - 1;
                    else { row = n_local[d] + mid; break; }
                }
            }
            const int64_t t = base + k;
            nbr_rows[t] = int32_t(row);
            nbr_valid[t] = 1;
            nbr_offset[3 * t + 0] = int32_t(offset3[3 * e + 0]);
            nbr_offset[3 * t + 1] = int32_t(offset3[3 * e + 1]);
            nbr_offset[3 * t + 2] = int32_t(offset3[3 * e + 2]);
            nbr_len[t] = int32_t(len_all[p]);
            nbr_slot[t] = slot[e];
        }
    }
}

// Incremental-epoch table patch (one device's hood): copy every reused
// row src_rows[i] -> dst_rows[i] across all five gather tables in a
// single fused sweep, pushing nbr_rows values through the old-row ->
// new-row map.  Old tables are [R_old, Kold(,3)], new tables
// [R_new, Kmax(,3)] pre-filled with their pad values; only the first
// Kmin columns can carry data for a reused row.
void delta_patch_tables(
    const int32_t* o_rows, const uint8_t* o_valid, const int32_t* o_off,
    const int32_t* o_len, const int32_t* o_slot,
    const int64_t* dst_rows, const int64_t* src_rows,
    const int64_t* row_counts, int64_t n_reuse,
    const int32_t* rowmap,
    int64_t Kold, int64_t Kmin, int64_t Kmax,
    int32_t* n_rows, uint8_t* n_valid, int32_t* n_off, int32_t* n_len,
    int32_t* n_slot
) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_reuse; i++) {
        const int64_t sb = src_rows[i] * Kold;
        const int64_t db = dst_rows[i] * Kmax;
        const int64_t k_row =
            row_counts[i] < Kmin ? row_counts[i] : Kmin;
        for (int64_t k = 0; k < k_row; k++) {
            n_rows[db + k] = rowmap[o_rows[sb + k]];
        }
        memcpy(n_valid + db, o_valid + sb, size_t(k_row));
        memcpy(n_off + 3 * db, o_off + 3 * sb, size_t(3 * k_row) * 4);
        memcpy(n_len + db, o_len + sb, size_t(k_row) * 4);
        memcpy(n_slot + db, o_slot + sb, size_t(k_row) * 4);
    }
}

}  // extern "C"
