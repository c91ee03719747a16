// maxk_gnn native preprocessing library.
//
// Re-design of the reference's host-side native layer:
//   - edge-tile schedule builder (role of kernels/generate_meta.py +
//     generate_meta_csc.py, which the reference runs as a slow Python
//     row loop and persists as .warp4 binaries)
//   - CSR transpose (role of the CSC extraction the reference delegates
//     to DGL/scipy)
//   - binary graph readers (role of kernels/data.h cuda_read_array)
//
// Exposed as a plain C ABI consumed via ctypes (maxk_gnn/sparse/_native.py);
// built with `make -C maxk_gnn/csrc`. All functions are thread-free,
// allocation-free (caller provides buffers) and deterministic.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// ---- edge tiles (see maxk_gnn/sparse/meta.py for the layout contract) ----

// Pass 1: number of tiles given row blocking. Every row-block gets at
// least one tile (empty blocks get an all-padding tile so each output
// block is written exactly once).
int64_t edge_tiles_count(const int64_t* indptr, int64_t num_nodes,
                         int64_t row_block, int64_t edge_tile) {
  int64_t nb = (num_nodes + row_block - 1) / row_block;
  int64_t nt = 0;
  for (int64_t b = 0; b < nb; ++b) {
    int64_t r0 = b * row_block;
    int64_t r1 = r0 + row_block;
    if (r1 > num_nodes) r1 = num_nodes;
    int64_t cnt = indptr[r1] - indptr[r0];
    int64_t t = (cnt + edge_tile - 1) / edge_tile;
    nt += t > 0 ? t : 1;
  }
  return nt;
}

// Pass 2: fill tile arrays. Outputs must be zero-initialized by the
// caller (padding entries stay 0: col 0, value 0, localrow 0).
//   tile_block: (nt,)      int32
//   cols/localrow: (nt*T,) int32
//   vals: (nt*T,)          float
void edge_tiles_fill(const int64_t* indptr, const int32_t* indices,
                     const float* values, int64_t num_nodes,
                     int64_t row_block, int64_t edge_tile,
                     int32_t* tile_block, int32_t* cols, float* vals,
                     int32_t* localrow) {
  int64_t nb = (num_nodes + row_block - 1) / row_block;
  int64_t tile = 0;
  for (int64_t b = 0; b < nb; ++b) {
    int64_t r0 = b * row_block;
    int64_t r1 = r0 + row_block;
    if (r1 > num_nodes) r1 = num_nodes;
    int64_t e0 = indptr[r0];
    int64_t cnt = indptr[r1] - e0;
    int64_t ntiles = (cnt + edge_tile - 1) / edge_tile;
    if (ntiles == 0) ntiles = 1;
    for (int64_t t = 0; t < ntiles; ++t) tile_block[tile + t] = (int32_t)b;
    // per-edge fill: local row via row walk
    int64_t row = r0;
    for (int64_t i = 0; i < cnt; ++i) {
      int64_t e = e0 + i;
      while (row + 1 <= r1 && indptr[row + 1] <= e) ++row;
      int64_t dst = tile * edge_tile + i;
      cols[dst] = indices[e];
      vals[dst] = values[e];
      localrow[dst] = (int32_t)(row - r0);
    }
    tile += ntiles;
  }
}

// ---- CSR transpose (counting sort by column) ----
// out_* sized: indptr (num_nodes+1), indices/values (nnz)
void csr_transpose(const int64_t* indptr, const int32_t* indices,
                   const float* values, int64_t num_nodes, int64_t nnz,
                   int64_t* out_indptr, int32_t* out_indices,
                   float* out_values) {
  memset(out_indptr, 0, sizeof(int64_t) * (num_nodes + 1));
  for (int64_t e = 0; e < nnz; ++e) out_indptr[indices[e] + 1]++;
  for (int64_t v = 0; v < num_nodes; ++v) out_indptr[v + 1] += out_indptr[v];
  // temp write cursors in a second pass over rows keeps output row-sorted
  int64_t* cursor = new int64_t[num_nodes];
  for (int64_t v = 0; v < num_nodes; ++v) cursor[v] = out_indptr[v];
  int64_t row = 0;
  for (int64_t e = 0; e < nnz; ++e) {
    while (row + 1 <= num_nodes && indptr[row + 1] <= e) ++row;
    int64_t c = indices[e];
    int64_t dst = cursor[c]++;
    out_indices[dst] = (int32_t)row;
    out_values[dst] = values[e];
  }
  delete[] cursor;
}

// ---- binary readers (reference .indptr/.indices format) ----
// Returns number of int32 elements read, or -1 on failure.
int64_t read_i32_file(const char* path, int32_t* out, int64_t max_elems) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t n = (int64_t)fread(out, sizeof(int32_t), (size_t)max_elems, f);
  fclose(f);
  return n;
}

int64_t file_size_bytes(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  int64_t n = (int64_t)ftell(f);
  fclose(f);
  return n;
}

}  // extern "C"
