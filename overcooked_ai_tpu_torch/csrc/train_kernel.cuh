// The fused training env step, shared by B1 (fused_train.cu, one layout)
// and B3 (fused_pool_train.cu, a layout per env lane): in one launch, for
// every env, the exact next state with auto-reset at `reset_horizon`,
// per-player sparse and shaped rewards, the 25 events bit-packed per
// player, and the post-step 26-layer lossless encoding for both players as
// int8. One thread runs one env; the transition is overcooked_step.cuh's.
//
// Every array is batch-last, so thread b touches element b of each row and
// a warp's loads and stores coalesce; the obs is written as (P, 26, HW, B)
// int8 for the same reason, and the Python wrappers return the JAX layout.
//
// Channels (the reference LAYERS order): 0 own location, 1 other location,
// 2-5 own orientation, 6-9 other orientation, 10-15 pot / counter / onion /
// tomato / dish dispensers / serve (the lane's own terrain under POOL),
// 16-17 onions / tomatoes in idle pot soups, 18-19 onions / tomatoes in
// active or off-pot soups, 20 cook time remaining, 21 soup done, 22 dishes,
// 23 onions, 24 tomatoes, 25 urgency.
#pragma once

#include "overcooked_step.cuh"

#define OC_NUM_LAYERS 26
#define OC_URGENCY_WINDOW 40

template <bool POOL>
__global__ void train_step_kernel(const __grid_constant__ LayoutData lay, LaneData lanes,
                                  StateArrays in, StateArrays out,
                                  const int* __restrict__ actions, int8_t* __restrict__ obs,
                                  int* __restrict__ sparse_out, int* __restrict__ shaped_out,
                                  int* __restrict__ events_out, int B, int horizon,
                                  int reset_horizon) {
  constexpr int NP = 2;
  __shared__ LayoutData L;
  load_layout(L, lay);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = (size_t)B;
  const int HW = L.num_cells;

  uint32_t cells[OC_MAX_HW];
  PlayerState pl[NP];
  int t = load_env<NP, POOL>(L, lanes, in, B, b, cells, pl);
  int dishes = 0;
  for (int l = 0; l < HW; ++l) dishes += cell_obj(cells[l]) == OC_OBJ_DISH;

  int act[NP], sparse[NP], shaped[NP], events[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) act[i] = actions[i * Bs + b];
  env_transition<NP, true, POOL>(L, cells, pl, t, act, sparse, shaped, events, dishes);
  if (++t >= reset_horizon) {
    reset_env<NP, POOL>(L, lanes, B, b, cells, pl);
    t = 0;
  }
  store_env<NP>(L, out, B, b, cells, pl, t);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    sparse_out[i * Bs + b] = sparse[i];
    shaped_out[i * Bs + b] = shaped[i];
    events_out[i * Bs + b] = events[i];
  }

  // ---- lossless encoding of the post-step (post-reset) state
  const int urgency = horizon - t < OC_URGENCY_WINDOW;
  int h_no[NP], h_nt[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    h_no[p] = h_nt[p] = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      h_no[p] += pl[p].slot[k] == OC_OBJ_ONION;
      h_nt[p] += pl[p].slot[k] == OC_OBJ_TOMATO;
    }
  }
  const int W = L.width;
  for (int l = 0; l < HW; ++l) {
    const uint32_t w = cells[l];
    const int tt = terrain_at<POOL>(L, cells, l);
    const int obj = cell_obj(w);
    int n_o, n_t;
    count_slots(w, n_o, n_t);
    const int tick = cell_tickp1(w) - 1;
    const bool soup = obj == OC_OBJ_SOUP;
    const bool at_pot = tt == OC_T_POT;
    const bool idle_at_pot = soup && at_pot && tick < 0;
    const bool active_at_pot = soup && at_pot && tick >= 0;
    const bool off_pot = soup && !at_pot;
    const int cook_time = L.time_table[n_o * 4 + n_t];
    int ch[OC_NUM_LAYERS];
    ch[16] = idle_at_pot ? n_o : 0;
    ch[17] = idle_at_pot ? n_t : 0;
    ch[18] = active_at_pot || off_pot ? n_o : 0;
    ch[19] = active_at_pot || off_pot ? n_t : 0;
    ch[20] = active_at_pot ? cook_time - tick : 0;
    ch[21] = (active_at_pot && tick >= cook_time) || off_pot;
    ch[22] = obj == OC_OBJ_DISH;
    ch[23] = obj == OC_OBJ_ONION;
    ch[24] = obj == OC_OBJ_TOMATO;
    // held objects count at the holder's position
    const int ly = l / W, lx = l - ly * W;
    bool loc[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      loc[p] = pl[p].x == lx && pl[p].y == ly;
      if (loc[p]) {
        const int h = pl[p].held;
        if (h == OC_OBJ_SOUP) {
          ch[18] += h_no[p];
          ch[19] += h_nt[p];
          ch[21] += 1;
        }
        ch[22] += h == OC_OBJ_DISH;
        ch[23] += h == OC_OBJ_ONION;
        ch[24] += h == OC_OBJ_TOMATO;
      }
    }
    ch[10] = tt == OC_T_POT;
    ch[11] = tt == OC_T_COUNTER;
    ch[12] = tt == OC_T_ONION_DISP;
    ch[13] = tt == OC_T_TOMATO_DISP;
    ch[14] = tt == OC_T_DISH_DISP;
    ch[15] = tt == OC_T_SERVE;
    ch[25] = urgency;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int q = 1 - p;
      ch[0] = loc[p];
      ch[1] = loc[q];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        ch[2 + d] = loc[p] && pl[p].orient == d;
        ch[6 + d] = loc[q] && pl[q].orient == d;
      }
      int8_t* o = obs + ((size_t)p * OC_NUM_LAYERS * HW + l) * Bs + b;
#pragma unroll
      for (int c = 0; c < OC_NUM_LAYERS; ++c) o[(size_t)c * HW * Bs] = (int8_t)ch[c];
    }
  }
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
template <bool POOL>
static int launch_train_step(const int* layout_words, const LaneData& lanes,
                             const StateArrays* in, const StateArrays* out, const int* actions,
                             int8_t* obs, int* sparse, int* shaped, int* events, int B,
                             int horizon, int reset_horizon, void* stream) {
  LayoutData lay;
  memcpy(&lay, layout_words, sizeof(LayoutData));
  if (lay.num_players != 2) return (int)cudaErrorInvalidValue;
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  train_step_kernel<POOL><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      lay, lanes, *in, *out, actions, obs, sparse, shaped, events, B, horizon, reset_horizon);
  return (int)cudaGetLastError();
}
