// The whole-horizon rollout, `num_steps` env steps in one launch, shared by
// B2 (fused_rollout.cu, one layout) and B4 (fused_pool_rollout.cu, a layout
// per env lane). One thread runs one env for the whole horizon: its packed
// cells stay in local memory and its players in registers, so device memory
// is touched twice per env (load the state, store it and the return), plus
// the (T, P, B) actions when they are given and, under POOL, the lane's
// reset words (terrain at load, start state at each auto-reset).
//
// Actions come from an explicit (T, P, B) int32 tensor or from the murmur3
// counter hash of the TPU kernels (fused_rollout.py:762-787, fused_pool.py
// :321-333), keyed on the global env index b, bit for bit:
//   x = seed * 0x9E3779B9 + b + player * 0x85EBCA6B + step * 0x27D4EB2F
//   (uint32), two xor-shift-multiply rounds, action = ((x >> 8) * 6) >> 24.
#pragma once

#include "overcooked_step.cuh"

__device__ __forceinline__ int hash_action(uint32_t seed_base, uint32_t b, uint32_t player,
                                           uint32_t step) {
  uint32_t x = seed_base + b + player * 0x85EBCA6Bu + step * 0x27D4EB2Fu;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  x = x ^ (x >> 16);
  return (int)(((x >> 8) * 6u) >> 24);
}

template <int NP, bool POOL>
__global__ void rollout_kernel(const __grid_constant__ LayoutData lay, LaneData lanes,
                               StateArrays in, StateArrays out, const int* __restrict__ actions,
                               int* __restrict__ ret, int B, int num_steps, int horizon,
                               uint32_t seed, int use_rng) {
  __shared__ LayoutData L;
  load_layout(L, lay);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  uint32_t cells[OC_MAX_HW];
  PlayerState pl[NP];
  int t = load_env<NP, POOL>(L, lanes, in, B, b, cells, pl);
  const uint32_t seed_base = seed * 0x9E3779B9u;
  int total = 0;
  int act[NP], sparse[NP];
  for (int k = 0; k < num_steps; ++k) {
#pragma unroll
    for (int i = 0; i < NP; ++i)
      act[i] = use_rng ? hash_action(seed_base, (uint32_t)b, (uint32_t)i, (uint32_t)k)
                       : actions[((size_t)k * NP + i) * B + b];
    env_transition<NP, POOL>(L, L.tab, cells, pl, t, act, sparse);
#pragma unroll
    for (int i = 0; i < NP; ++i) total += sparse[i];
    if (++t >= horizon) {
      reset_env<NP, POOL>(L, lanes, B, b, cells, pl);
      t = 0;
    }
  }
  store_env<NP>(L, out, B, b, cells, pl, t);
  ret[b] = total;
}

template <int NP, bool POOL>
static cudaError_t launch_rollout_np(const LayoutData& lay, const LaneData& lanes,
                                     const StateArrays& in, const StateArrays& out,
                                     const int* actions, int* ret, int B, int num_steps,
                                     int horizon, int seed, int use_rng, cudaStream_t stream) {
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  rollout_kernel<NP, POOL><<<blocks, threads, 0, stream>>>(
      lay, lanes, in, out, actions, ret, B, num_steps, horizon, (uint32_t)seed, use_rng);
  return cudaGetLastError();
}

// Launches the kernel for the layout's player count (1-4) on `stream`;
// returns the cudaError_t of the launch.
template <bool POOL>
static int launch_rollout(const int* layout_words, const LaneData& lanes, const StateArrays* in,
                          const StateArrays* out, const int* actions, int* ret, int B,
                          int num_steps, int horizon, int seed, int use_rng, void* stream) {
  LayoutData lay;
  memcpy(&lay, layout_words, sizeof(LayoutData));
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lay.num_players) {
#define OC_CASE(NP)                                                                          \
  case NP:                                                                                   \
    return (int)launch_rollout_np<NP, POOL>(lay, lanes, *in, *out, actions, ret, B, num_steps, \
                                            horizon, seed, use_rng, s);
    OC_CASE(1)
    OC_CASE(2)
    OC_CASE(3)
    OC_CASE(4)
#undef OC_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
