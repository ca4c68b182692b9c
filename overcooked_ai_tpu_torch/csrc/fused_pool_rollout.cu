// B4: the whole-horizon rollout with a layout per env lane
// (rollout_kernel.cuh under POOL).
//
// Replaces the TPU kernel overcooked_ai_tpu/ops/fused_pool.py:286
// `_build_pool_kernel` (pallas_call at :442, under `_fused_pool_rollout`
// :411). As B2, with each lane's terrain and start state read from its
// LaneData words: the terrain once at load (into bits 28-30 of the cell
// words), the start state at each auto-reset, which goes to the lane's own
// start. The murmur3 action stream is B2's, keyed on the global env index.
//
// Bound on the H100: integer operations, as for B2. The pool costs a few
// more per step: the cook-tick pass visits every cell instead of the
// layout's pots, and the floor check reads the terrain from the cell word.
#include "rollout_kernel.cuh"

// Returns the cudaError_t of the launch (0 = launched).
extern "C" int oc_fused_pool_rollout(const int* layout_words, const int* reset_words,
                                     const int* start_players, const StateArrays* in,
                                     const StateArrays* out, const int* actions, int* ret, int B,
                                     int num_steps, int horizon, int seed, int use_rng,
                                     void* stream) {
  return launch_rollout<true>(layout_words, LaneData{reset_words, start_players, nullptr, nullptr},
                              in, out, actions, ret, B, num_steps, horizon, seed, use_rng, stream);
}
