// B3: the fused training env step with a layout per env lane
// (train_kernel.cuh under POOL).
//
// Replaces the TPU kernel overcooked_ai_tpu/ops/fused_pool.py:513
// `_build_pool_train_kernel` (pallas_call at :754, under
// `_fused_pool_train_step` :712). The grid shape and player count arrive
// as one __grid_constant__ LayoutData, so no pool and no layout triggers a
// rebuild. Each lane brings its own words from device memory (LaneData):
// the (HW, B) reset words (start cells, terrain in bits 28-30), the
// (P, 8, B) start players, and one int32 index into the pool's distinct
// RecipeTables rows (K, 52), so lanes may differ in recipe tables, shaping
// rewards and the old-dynamics flag, as in the JAX learner's XLA pool path.
// A block stages its lanes' rows in shared memory; the step and the
// encoding read them through tables_of.
//
// Bound on the H100: bytes, as for B1, plus per env the HW reset words read
// for its terrain (4 HW bytes), its table index (4 bytes) and, only on an
// auto-reset, its start players; the K table rows are read once (208 K
// bytes). The terrain then rides in the staged cell words, so every read of
// it (facing cell, floor check, pots, encoding) is the same shared-memory
// load as the cell's contents. The design is B1's (fused_train.cu), which
// also spreads the pot snapshot and the cook pass over the block's
// threads. The lanes of a pool share few table rows, so a block copies its
// lanes' rows through L1: copies that bypass it piled every lane of a
// uniform pool onto one row's L2 line and doubled the kernel's time.
#include "train_kernel.cuh"

// Returns the cudaError_t of the launch (0 = launched).
extern "C" int oc_fused_pool_train_step(const int* layout_words, const int* reset_words,
                                        const int* start_players, const int* table_rows,
                                        const int* table_idx, const StateArrays* in,
                                        const StateArrays* out, const int* actions, int8_t* obs,
                                        int* sparse, int* shaped, int* events, int B,
                                        int horizon, int reset_horizon, int tile_envs,
                                        int threads, int smem_bytes, int vec, int wide,
                                        void* stream) {
  return launch_train_step<true>(layout_words,
                                 LaneData{reset_words, start_players, table_rows, table_idx}, in,
                                 out, actions, obs, sparse, shaped, events, B, horizon,
                                 reset_horizon, tile_envs, threads, smem_bytes, vec, wide, stream);
}
