// Native batch packer: the host-side hot loop of the data pipeline.
//
// Packs variable-length molecule samples into fixed-capacity padded
// buffers (the static-shape batches of the trainer; the numpy version and
// the fields are torchmdnet_tpu_torch/data/collate.py::pad_samples).
// Exposed through ctypes (torchmdnet_tpu_torch/data/_native.py); one call
// packs a whole batch with plain copy loops instead of per-sample numpy
// slicing.  A copy of the JAX package's csrc/packer.cpp: the same entry
// points and arguments.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o <lib>.so packer.cpp
// (done on first use by _native.py, into torchmdnet_tpu_torch/_build/).

#include <cstdint>
#include <cstring>

extern "C" {

// Pack atom-level int64 z -> int32 padded buffer and set segment ids.
// sizes[m] = atom count of molecule m; out buffers pre-allocated:
//   z_out[max_atoms], batch_out[max_atoms] (pre-filled with max_mols),
//   pos_out[max_atoms*3], negdy_out (nullable), pq_out (nullable)
// Returns total packed atoms, or -1 on capacity overflow.
int64_t pack_batch(
    int64_t n_mols,
    const int64_t* sizes,
    const int64_t* const* z_ptrs,      // per-molecule int64 [n]
    const float* const* pos_ptrs,      // per-molecule float32 [n*3]
    const float* const* negdy_ptrs,    // nullable
    const float* const* pq_ptrs,       // nullable
    int64_t max_atoms,
    int64_t max_mols,
    int32_t* z_out,
    int32_t* batch_out,
    float* pos_out,
    float* negdy_out,
    float* pq_out,
    uint8_t* mol_mask_out) {
  if (n_mols > max_mols) return -1;
  int64_t offset = 0;
  for (int64_t m = 0; m < n_mols; ++m) {
    const int64_t n = sizes[m];
    if (offset + n > max_atoms) return -1;
    const int64_t* z = z_ptrs[m];
    for (int64_t i = 0; i < n; ++i) {
      z_out[offset + i] = static_cast<int32_t>(z[i]);
      batch_out[offset + i] = static_cast<int32_t>(m);
    }
    std::memcpy(pos_out + offset * 3, pos_ptrs[m], sizeof(float) * n * 3);
    if (negdy_out && negdy_ptrs && negdy_ptrs[m]) {
      std::memcpy(negdy_out + offset * 3, negdy_ptrs[m],
                  sizeof(float) * n * 3);
    }
    if (pq_out && pq_ptrs && pq_ptrs[m]) {
      std::memcpy(pq_out + offset, pq_ptrs[m], sizeof(float) * n);
    }
    mol_mask_out[m] = 1;
    offset += n;
  }
  return offset;
}

// Pack straight out of the memmapped dataset files (datasets/memdataset.py
// layout): idx_mmap holds int64 prefix offsets; z int8; pos float32 [A,3];
// y float64 per conf; neg_dy float32 [A,3]; q int8; pq float32.
// mol_ids selects the molecules of this batch.  Null pointers skip fields.
// Returns packed atom count or -1 on overflow.
int64_t pack_from_memmap(
    int64_t n_mols,
    const int64_t* mol_ids,
    const int64_t* idx_mmap,
    const int8_t* z_mmap,
    const float* pos_mmap,
    const double* y_mmap,
    const float* negdy_mmap,
    const int8_t* q_mmap,
    const float* pq_mmap,
    int64_t max_atoms,
    int64_t max_mols,
    int32_t* z_out,
    int32_t* batch_out,
    float* pos_out,
    float* y_out,
    float* negdy_out,
    float* q_out,
    float* pq_out,
    uint8_t* mol_mask_out) {
  if (n_mols > max_mols) return -1;
  int64_t offset = 0;
  for (int64_t m = 0; m < n_mols; ++m) {
    const int64_t id = mol_ids[m];
    const int64_t a0 = idx_mmap[id];
    const int64_t a1 = idx_mmap[id + 1];
    const int64_t n = a1 - a0;
    if (offset + n > max_atoms) return -1;
    for (int64_t i = 0; i < n; ++i) {
      z_out[offset + i] = static_cast<int32_t>(z_mmap[a0 + i]);
      batch_out[offset + i] = static_cast<int32_t>(m);
    }
    std::memcpy(pos_out + offset * 3, pos_mmap + a0 * 3,
                sizeof(float) * n * 3);
    if (y_out && y_mmap) y_out[m] = static_cast<float>(y_mmap[id]);
    if (negdy_out && negdy_mmap) {
      std::memcpy(negdy_out + offset * 3, negdy_mmap + a0 * 3,
                  sizeof(float) * n * 3);
    }
    if (q_out && q_mmap) q_out[m] = static_cast<float>(q_mmap[id]);
    if (pq_out && pq_mmap) {
      std::memcpy(pq_out + offset, pq_mmap + a0, sizeof(float) * n);
    }
    mol_mask_out[m] = 1;
    offset += n;
  }
  return offset;
}

}  // extern "C"
