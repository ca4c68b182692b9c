// B4: the whole-horizon rollout with a layout per env lane
// (rollout_kernel.cuh under POOL).
//
// Replaces the TPU kernel overcooked_ai_tpu/ops/fused_pool.py:286
// `_build_pool_kernel` (pallas_call at :442, under `_fused_pool_rollout`
// :411). As B2, with each lane's terrain and start state read from its
// LaneData words: the terrain once at load (into bits 28-30 of the cell
// words and the floor mask), the start state at each auto-reset, which
// goes to the lane's own start. The murmur3 action stream is B2's, keyed
// on the global env index.
//
// Bound on the H100: integer operations, as for B2. The pool adds only the
// lane's words at load and at each auto-reset. The earlier body's cook pass
// loaded and stored every cell word of every env at every step, two thirds
// of its cycles (PERF.md); this one visits only the live cells, as B2
// does, so the two kernels run the same step.
#include "rollout_kernel.cuh"

// Returns the cudaError_t of the launch (0 = launched); actions null = the
// murmur3 stream of `seed`.
extern "C" int oc_fused_pool_rollout(const int* layout_words, const int* reset_words,
                                     const int* start_players, const StateArrays* in,
                                     const StateArrays* out, const int* actions, int* ret, int B,
                                     int num_steps, int horizon, int seed, int threads,
                                     void* stream) {
  return launch_rollout<true>(layout_words, LaneData{reset_words, start_players, nullptr, nullptr},
                              in, out, actions, ret, B, num_steps, horizon, seed, threads, stream);
}
