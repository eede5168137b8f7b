// Native runtime components for tinyknn_tpu.
//
// The accelerator owns the compute path (XLA/Pallas); these are the host-side
// runtime pieces that the reference implements natively or in hot
// Python loops:
//
//   * build_inverted_lists: counting-sort construction of the padded
//     inverted-list id grid from a (N, p) assignment matrix — the
//     native replacement for the argsort-based grouping
//     (reference: tinyknn/utils.py:95-162). O(N*p), cache-friendly,
//     no comparison sort.
//   * read_fvecs: parse the .fvecs format used by SIFT-1M
//     (reference: examples/sift/convert.py:10-58) straight into a
//     caller-allocated float32 buffer.
//
// Built as a plain C-ABI shared library, loaded via ctypes
// (no pybind11 dependency). All buffers are caller-allocated NumPy
// arrays; sizes are validated on the Python side.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// assignments: (n, p) int32 row-major, values in [0, n_lists)
// counts_out:  (n_lists,) int32, zero-initialized by caller
// Pass 1: count list sizes. Returns max count.
int32_t count_list_sizes(const int32_t* assignments, int64_t n, int64_t p,
                         int32_t n_lists, int32_t* counts_out) {
    const int64_t total = n * p;
    for (int64_t i = 0; i < total; ++i) {
        int32_t c = assignments[i];
        if (c >= 0 && c < n_lists) counts_out[c]++;
    }
    int32_t mx = 0;
    for (int32_t l = 0; l < n_lists; ++l)
        if (counts_out[l] > mx) mx = counts_out[l];
    return mx;
}

// Pass 2: scatter point ids into the padded grid.
// ids_out: (n_lists, cap) int32, pre-filled with -1 by caller.
// cursors: (n_lists,) int32 scratch, zero-initialized by caller.
// Iteration is row-major over points then probes, so within a list the
// ids appear in ascending point order for each probe rank interleaved —
// the same multiset contract as the Python builder.
void fill_inverted_lists(const int32_t* assignments, int64_t n, int64_t p,
                         int32_t n_lists, int64_t cap, int32_t* ids_out,
                         int32_t* cursors) {
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t j = 0; j < p; ++j) {
            int32_t c = assignments[i * p + j];
            if (c < 0 || c >= n_lists) continue;
            int64_t pos = cursors[c]++;
            if (pos < cap) ids_out[(int64_t)c * cap + pos] = (int32_t)i;
        }
    }
}

// Scatter point ids into the lane-tiled CSR layout (the production
// index-build path, utils/grouping.py invert_assignments_csr_tiled):
// list c's members go to flat positions tile_offsets[c]*tile + k in
// first-seen order, which matches the NumPy stable-argsort path
// bit-for-bit (both order by ascending i*p + j).
// tile_offsets: (n_lists,) int32 in tiles; flat_ids pre-filled with -1
// by the caller; cursors: (n_lists,) int32 scratch, zero-initialized.
void fill_csr_tiled(const int32_t* assignments, int64_t n, int64_t p,
                    int32_t n_lists, const int32_t* tile_offsets,
                    int64_t tile, int32_t* flat_ids, int32_t* cursors) {
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t j = 0; j < p; ++j) {
            int32_t c = assignments[i * p + j];
            if (c < 0 || c >= n_lists) continue;
            int64_t pos = cursors[c]++;
            flat_ids[(int64_t)tile_offsets[c] * tile + pos] = (int32_t)i;
        }
    }
}

// Read an .fvecs file (repeated records: int32 dim + dim float32s).
// First call with out == nullptr to get (n, d) via n_out/d_out;
// second call with an (n*d) float buffer.
// Returns 0 on success, negative error codes otherwise.
int32_t read_fvecs(const char* path, float* out, int64_t* n_out,
                   int64_t* d_out) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    int32_t d0;
    if (fread(&d0, sizeof(int32_t), 1, f) != 1) { fclose(f); return -2; }
    if (d0 <= 0 || d0 > (1 << 20)) { fclose(f); return -3; }
    fseek(f, 0, SEEK_END);
    int64_t bytes = ftell(f);
    int64_t rec = 4 + (int64_t)d0 * 4;
    if (bytes % rec != 0) { fclose(f); return -4; }
    int64_t n = bytes / rec;
    *n_out = n;
    *d_out = d0;
    if (!out) { fclose(f); return 0; }
    fseek(f, 0, SEEK_SET);
    for (int64_t i = 0; i < n; ++i) {
        int32_t d;
        if (fread(&d, sizeof(int32_t), 1, f) != 1 || d != d0) {
            fclose(f);
            return -5;
        }
        if (fread(out + i * d0, sizeof(float), d0, f) != (size_t)d0) {
            fclose(f);
            return -6;
        }
    }
    fclose(f);
    return 0;
}

}  // extern "C"
