// B2: the whole-horizon rollout for ONE layout (rollout_kernel.cuh).
//
// Replaces the TPU kernel overcooked_ai_tpu/ops/fused_rollout.py:693
// `_build_kernel` (pallas_call at :920).
//
// Bound on the H100: integer operations. A step is a few hundred scalar
// integer operations per env and no device-memory traffic, so the work per
// byte is far above the card's ridge point. The design keeps every step's
// state out of device memory; making the integer work cheaper (fewer local
// memory round trips, packed players) is later work.
#include "rollout_kernel.cuh"

extern "C" int oc_layout_words() { return (int)(sizeof(LayoutData) / 4); }

// Returns the cudaError_t of the launch (0 = launched).
extern "C" int oc_fused_rollout(const int* layout_words, const StateArrays* in,
                                const StateArrays* out, const int* actions, int* ret, int B,
                                int num_steps, int horizon, int seed, int use_rng, void* stream) {
  return launch_rollout<false>(layout_words, LaneData{}, in, out, actions, ret, B,
                               num_steps, horizon, seed, use_rng, stream);
}
