// B3: the fused training env step with a layout per env lane
// (train_kernel.cuh under POOL).
//
// Replaces the TPU kernel overcooked_ai_tpu/ops/fused_pool.py:513
// `_build_pool_train_kernel` (pallas_call at :754, under
// `_fused_pool_train_step` :712). The pool-uniform fields (tables, shaping
// rewards, old dynamics, grid shape) still arrive as one __grid_constant__
// LayoutData, so no pool and no layout triggers a rebuild; each lane's
// terrain and start state come from its own words in device memory
// (LaneData: the (HW, B) reset words, terrain in bits 28-30, and the
// (P, 8, B) start players).
//
// Bound on the H100: bytes, as for B1, plus the HW reset words each env
// reads for its terrain (4 HW bytes) and, only on an auto-reset, its start
// players. The terrain then rides in the cell words in local memory, so
// every read of it (facing cell, floor check, pots, encoding) is the same
// load as the cell's contents. Unlike B1, the cook-tick pass and the pot
// snapshot visit every cell, since any cell may be a pot on some lane.
#include "train_kernel.cuh"

// Returns the cudaError_t of the launch (0 = launched).
extern "C" int oc_fused_pool_train_step(const int* layout_words, const int* reset_words,
                                        const int* start_players, const StateArrays* in,
                                        const StateArrays* out, const int* actions, int8_t* obs,
                                        int* sparse, int* shaped, int* events, int B,
                                        int horizon, int reset_horizon, void* stream) {
  return launch_train_step<true>(layout_words, LaneData{reset_words, start_players}, in, out,
                                 actions, obs, sparse, shaped, events, B, horizon, reset_horizon,
                                 stream);
}
