// B2: the whole-horizon rollout for ONE layout (rollout_kernel.cuh).
//
// Replaces the TPU kernel overcooked_ai_tpu/ops/fused_rollout.py:693
// `_build_kernel` (pallas_call at :920). Unlike it, the cook pass ticks
// every soup cell, as core/step.py does, not only the layout's pot and
// start-soup cells.
//
// Bound on the H100: integer operations. A step is a few hundred scalar
// integer operations per env and no device-memory traffic, so the work per
// byte is far above the card's ridge point. At 16384 envs there is about
// one warp per scheduler, so a step's time is its chain of dependent
// instructions and branches, not the card's issue rate (PERF.md has the
// phase split). What the design does about it:
//   - the cook pass visits only the live cells, whose bit mask each store
//     keeps up to date from what the interact did;
//   - a move's floor check is a branch-free test of a bit mask in
//     registers, not a load behind a branch;
//   - one copy of a player's code runs on each player in turn;
//   - a word's onions and tomatoes are two popcounts;
//   - the cells sit in the block's shared memory, and the action source is
//     a template parameter.
#include "rollout_kernel.cuh"

extern "C" int oc_layout_words() { return (int)(sizeof(LayoutData) / 4); }

// Returns the cudaError_t of the launch (0 = launched); actions null = the
// murmur3 stream of `seed`.
extern "C" int oc_fused_rollout(const int* layout_words, const StateArrays* in,
                                const StateArrays* out, const int* actions, int* ret, int B,
                                int num_steps, int horizon, int seed, int threads, void* stream) {
  return launch_rollout<false>(layout_words, LaneData{}, in, out, actions, ret, B, num_steps,
                               horizon, seed, threads, stream);
}
