// Device code shared by the kernels of this package: the layout block and
// the per-env Overcooked transition.
//
// One thread runs one env's transition. The layout is data, not code:
// terrain, the start state, the recipe value / time / optimal-value tables,
// the shaping rewards and the old-dynamics flag arrive as one `LayoutData`
// block (packed by ops/_build.py:layout_words), a kernel parameter, which
// B2 and B4 copy into shared memory. One build therefore serves every
// layout; only the player count is a template parameter.
//
// The recipe tables, shaping rewards and old-dynamics flag form one
// 52-word `RecipeTables` block, and the step reads them only through the
// `RecipeTables&` it is given: the layout block's own (`L.tab`) in B2 and
// B4, a row staged in shared memory in B1 (the layout's) and B3 (each
// lane's, so a pool's lanes may differ in all of them).
//
// The pool kernels (template flag POOL) give every env its own layout. The
// grid shape and player count are uniform over the pool and come from the
// `LayoutData` block, as do the tables in B4; terrain and the start state
// are the lane's own, from `LaneData` in device memory (packed by
// ops/fused_pool.py:pool_data).
//
// Per env, each grid cell is one packed 32-bit word in the block's shared
// memory (B1 and B3: env-major, train_kernel.cuh; B2 and B4: cell-major
// with the block's envs minor, rollout_kernel.cuh):
//   bits 0-2   object code (OBJ_*)
//   bits 3-8   three 2-bit soup ingredient slots, in insertion order
//   bits 9-16  soup cooking tick + 1 (0 = idle / no soup)
//   bits 17-27 insertion stamp + HW, clamped at 2047 (exact for 2-player
//              horizon-400 play; the same clamp as the TPU kernels)
//   bits 28-30 the cell's terrain code: the layout's, or under POOL the
//              lane's (as in the TPU pool kernels), so the facing-cell load
//              brings it along
// Players stay unpacked in registers. The step reaches the cells only
// through a cell accessor (`EnvCells` here, `RolloutCells` in
// rollout_kernel.cuh): load a word, store one, and whether a move enters a
// cell.
//
// Semantics: those of core/step.py (the reference get_state_transition) in
// all four kernels: every soup cell cooks, wherever it lies. B2 and B4 visit
// only the cells whose word the tick changes, which they track in a bit
// mask (rollout_kernel.cuh); that gives the words a visit of every cell
// gives. (The single-layout TPU kernel ticks only the layout's pot and
// start-soup cells, a narrowing that the port does not share.)
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#define OC_MAX_HW 128
#define OC_MAX_P 4
#define OC_SEQ_MAX 2047
#define OC_TERRAIN_SHIFT 28
#define OC_TERRAIN_BITS (7u << OC_TERRAIN_SHIFT)
#define OC_MAX_CARDS 64  // cards a process may use, for the shared-memory opt-in

// Codes, as in core/constants.py.
#define OC_OBJ_NONE 0
#define OC_OBJ_ONION 1
#define OC_OBJ_TOMATO 2
#define OC_OBJ_DISH 3
#define OC_OBJ_SOUP 4
#define OC_T_EMPTY 0
#define OC_T_COUNTER 1
#define OC_T_ONION_DISP 2
#define OC_T_TOMATO_DISP 3
#define OC_T_POT 4
#define OC_T_DISH_DISP 5
#define OC_T_SERVE 6
#define OC_ACTION_INTERACT 5

// Event bits, in EVENT_TYPES order.
enum {
  EV_TOMATO_PICKUP, EV_USEFUL_TOMATO_PICKUP, EV_TOMATO_DROP, EV_USEFUL_TOMATO_DROP,
  EV_POTTING_TOMATO, EV_ONION_PICKUP, EV_USEFUL_ONION_PICKUP, EV_ONION_DROP,
  EV_USEFUL_ONION_DROP, EV_POTTING_ONION, EV_DISH_PICKUP, EV_USEFUL_DISH_PICKUP,
  EV_DISH_DROP, EV_USEFUL_DISH_DROP, EV_SOUP_PICKUP, EV_SOUP_DELIVERY, EV_SOUP_DROP,
  EV_OPTIMAL_ONION_POTTING, EV_OPTIMAL_TOMATO_POTTING, EV_VIABLE_ONION_POTTING,
  EV_VIABLE_TOMATO_POTTING, EV_CATASTROPHIC_ONION_POTTING,
  EV_CATASTROPHIC_TOMATO_POTTING, EV_USELESS_ONION_POTTING, EV_USELESS_TOMATO_POTTING,
};

// The per-recipe tables and the layout scalars the step reads with them:
// 52 int32 words, in this order (ops/_build.py:table_words writes them).
struct RecipeTables {
  int old_dynamics, rew_pot, rew_dish, rew_soup;
  int time_table[16];  // [n_onions * 4 + n_tomatoes]
  int delivery_value[16];
  int opt_value[16];
};
#define OC_TABLE_WORDS 52

// All int32 words, in this order (ops/_build.py:layout_words writes them).
struct LayoutData {
  int height, width, num_cells, num_players;
  int num_pots;
  RecipeTables tab;
  int terrain[OC_MAX_HW];
  int reset_word[OC_MAX_HW];           // start state, packed cell words (no terrain)
  int start_player[OC_MAX_P][8];       // x, y, orient, held, slot0-2, tick
};

// The batch-last state arrays of core/state.py, each int32 and contiguous.
struct StateArrays {
  int* pos;             // (P, 2, B)
  int* orient;          // (P, B)
  int* held;            // (P, B)
  int* held_soup;       // (P, 3, B)
  int* held_soup_tick;  // (P, B)
  int* obj;             // (HW, B)
  int* soup_ing;        // (HW, 3, B)
  int* soup_tick;       // (HW, B)
  int* obj_seq;         // (HW, B)
  int* t;               // (B,)
};

// Per-lane layout data of the pool kernels, batch-last int32 (unused, null,
// in the single-layout kernels).
struct LaneData {
  const int* reset_word;    // (HW, B) start-state cell words, terrain in bits 28-30
  const int* start_player;  // (P, 8, B) x, y, orient, held, slot0-2, tick
  const int* table_rows;    // (K, 52) the distinct RecipeTables (B3; B1: its layout's)
  const int* table_idx;     // (B,) each lane's row of table_rows (B3 only)
};

// The pot snapshot taken before any interact, for the usefulness
// classifiers of the train step: pots holding a full soup, pots holding
// anything, and the pot count.
struct PotSnapshot {
  int n_full, n_nonempty, n_pots;
};

struct PlayerState {
  int x, y, orient, held, slot[3], tick;
};

// B1, B3: one env's cell words, contiguous in the block's shared memory.
struct EnvCells {
  uint32_t* w;
  __device__ __forceinline__ uint32_t load(int l) const { return w[l]; }
  __device__ __forceinline__ void store(int l, uint32_t v, bool) { w[l] = v; }
  // whether move action a takes a player to cell cl of an env of HW cells
  __device__ __forceinline__ bool can_enter(int a, int cl, int HW) const {
    return a >= 0 && a < 4 && cl >= 0 && cl < HW &&
           ((w[cl] >> OC_TERRAIN_SHIFT) & 7) == OC_T_EMPTY;
  }
};

// Above 48 KB a block's dynamic shared memory needs the kernel's consent,
// asked once per card and size reached; `granted` is the kernel's own
// record (OC_MAX_CARDS ints, zeroed).
inline cudaError_t allow_smem(const void* kernel, int bytes, int* granted) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int card = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err != cudaSuccess) return err;
  if (card < OC_MAX_CARDS && bytes <= granted[card]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && card < OC_MAX_CARDS) granted[card] = bytes;
  return err;
}

__device__ __forceinline__ void load_layout(LayoutData& dst, const LayoutData& src) {
  const int* s = reinterpret_cast<const int*>(&src);
  int* d = reinterpret_cast<int*>(&dst);
  for (int k = threadIdx.x; k < (int)(sizeof(LayoutData) / 4); k += blockDim.x) d[k] = s[k];
  __syncthreads();
}

__device__ __forceinline__ uint32_t pack_cell(int obj, int s0, int s1, int s2, int tick,
                                              int seq, int hw) {
  const int stamp = min(seq + hw, OC_SEQ_MAX) & OC_SEQ_MAX;
  return (uint32_t)(obj & 7) | ((uint32_t)(s0 & 3) << 3) | ((uint32_t)(s1 & 3) << 5) |
         ((uint32_t)(s2 & 3) << 7) | ((uint32_t)((tick + 1) & 255) << 9) |
         ((uint32_t)stamp << 17);
}
__device__ __forceinline__ int cell_obj(uint32_t w) { return w & 7; }
__device__ __forceinline__ int cell_slot(uint32_t w, int s) { return (w >> (3 + 2 * s)) & 3; }
__device__ __forceinline__ int cell_tickp1(uint32_t w) { return (w >> 9) & 255; }
__device__ __forceinline__ int cell_seq(uint32_t w, int hw) { return (int)((w >> 17) & OC_SEQ_MAX) - hw; }
__device__ __forceinline__ uint32_t with_tickp1(uint32_t w, int tickp1) {
  return (w & ~(255u << 9)) | ((uint32_t)(tickp1 & 255) << 9);
}
// Onions and tomatoes in a word's three 2-bit slots (onion 01, tomato 10).
__device__ __forceinline__ void count_slots(uint32_t w, int& n_o, int& n_t) {
  const uint32_t lo = (w >> 3) & 0x15u;  // the low bit of each slot
  const uint32_t hi = (w >> 4) & 0x15u;  // the high bit
  n_o = __popc(lo & ~hi);
  n_t = __popc(hi & ~lo);
}

// Auto-reset of the players to the start state: the layout's, or the
// lane's own.
template <int NP, bool POOL>
__device__ __forceinline__ void reset_players(const LayoutData& L, const LaneData& lanes, int B,
                                              int b, PlayerState* pl) {
  const size_t Bs = (size_t)B;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    int sp[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      sp[k] = POOL ? lanes.start_player[(8 * i + k) * Bs + b] : L.start_player[i][k];
    pl[i].x = sp[0];
    pl[i].y = sp[1];
    pl[i].orient = sp[2];
    pl[i].held = sp[3];
    pl[i].slot[0] = sp[4];
    pl[i].slot[1] = sp[5];
    pl[i].slot[2] = sp[6];
    pl[i].tick = sp[7];
  }
}

// One pot cell's part of the pot snapshot: adds 1 to `full` for a cooking,
// ready or full idle soup and 1 to `nonempty` for a cooking, ready or
// partly filled soup.
__device__ __forceinline__ void snapshot_pot(const RecipeTables& R, uint32_t w, int& full,
                                             int& nonempty) {
  int n_o, n_t;
  count_slots(w, n_o, n_t);
  const int n = n_o + n_t;
  const bool soup = cell_obj(w) == OC_OBJ_SOUP;
  const int tickp1 = cell_tickp1(w);
  const bool idle = tickp1 == 0;
  const bool ready = soup && !idle && tickp1 - 1 >= R.time_table[n_o * 4 + n_t];
  const bool cooking = soup && !idle && !ready;
  const bool part = soup && idle && n >= 1 && n < 3;
  const bool full_idle = soup && idle && n == 3;
  full += cooking || ready || full_idle;
  nonempty += ready || cooking || part;
}

// A soup's cook tick + 1 after one tick: a cooking soup advances, and
// under old dynamics a full idle one starts by itself. n: its items;
// cook_time: its recipe's.
__device__ __forceinline__ int next_tickp1(const RecipeTables& R, int tickp1, int n,
                                           int cook_time) {
  if (R.old_dynamics && tickp1 == 0 && n == 3) tickp1 = 1;  // auto-start
  return (tickp1 + (tickp1 > 0 && tickp1 - 1 < cook_time)) & 255;
}

// One cell's environment effect at the end of a step: a soup cooks one tick.
__device__ __forceinline__ uint32_t cook_cell(const RecipeTables& R, uint32_t w) {
  if (cell_obj(w) != OC_OBJ_SOUP) return w;
  int n_o, n_t;
  count_slots(w, n_o, n_t);
  return with_tickp1(w, next_tickp1(R, cell_tickp1(w), n_o + n_t, R.time_table[n_o * 4 + n_t]));
}

// Player i's interact (resolve_interacts) on w, the word of the cell it
// faces (0 off the grid, which reads as empty floor): updates the player,
// sets its sparse reward (TRAIN: also its shaped reward and event bits, and
// `dishes`), and if the cell changes hands `store` its new word and whether
// the next cook tick changes that word. A placement is stamped with
// t * NP + seq_i + 1. Returns whether the cell changed.
template <int NP, bool TRAIN, class Store>
__device__ __forceinline__ bool interact(const RecipeTables& R, int HW, PlayerState* pl, int i,
                                         int t, int seq_i, int act_i, uint32_t w, int* sparse,
                                         int* shaped, int* events, int& dishes,
                                         const PotSnapshot& snap, Store&& store) {
  const bool inter = act_i == OC_ACTION_INTERACT;
  const int tt = (int)(w >> OC_TERRAIN_SHIFT) & 7;

  const int c_obj = cell_obj(w);
  int c_no, c_nt;
  count_slots(w, c_no, c_nt);
  const int c_n = c_no + c_nt;
  const int c_tick = cell_tickp1(w) - 1;
  const bool c_soup = c_obj == OC_OBJ_SOUP;
  const bool c_idle = c_tick < 0;
  const int c_time = R.time_table[c_no * 4 + c_nt];
  const bool c_ready = c_soup && !c_idle && c_tick >= c_time;

  const int held_i = pl[i].held;
  const bool has_obj = held_i != OC_OBJ_NONE;
  const bool counter_drop = inter && tt == OC_T_COUNTER && has_obj && c_obj == OC_OBJ_NONE;
  const bool counter_pickup = inter && tt == OC_T_COUNTER && !has_obj && c_obj != OC_OBJ_NONE;
  const bool onion_disp = inter && tt == OC_T_ONION_DISP && !has_obj;
  const bool tomato_disp = inter && tt == OC_T_TOMATO_DISP && !has_obj;
  const bool dish_disp = inter && tt == OC_T_DISH_DISP && !has_obj;
  const bool start_cook = !R.old_dynamics && inter && tt == OC_T_POT && !has_obj && c_soup &&
                          c_idle && c_n > 0;
  const bool soup_pickup = inter && tt == OC_T_POT && held_i == OC_OBJ_DISH && c_ready;
  const bool pot_try =
      inter && tt == OC_T_POT && (held_i == OC_OBJ_ONION || held_i == OC_OBJ_TOMATO);
  // an empty pot cell counts as a fresh idle soup
  const bool pot_ok = pot_try && (c_obj == OC_OBJ_NONE || (c_soup && c_idle && c_n < 3));
  const bool deliver = inter && tt == OC_T_SERVE && held_i == OC_OBJ_SOUP;

  int h_no = 0, h_nt = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    h_no += pl[i].slot[k] == OC_OBJ_ONION;
    h_nt += pl[i].slot[k] == OC_OBJ_TOMATO;
  }
  sparse[i] = deliver ? R.delivery_value[h_no * 4 + h_nt] : 0;

  if constexpr (TRAIN) {
    // usefulness classifiers read the state as mutated by earlier players
    bool dish_pickup_useful = false, dish_drop_useful = false;
    bool ing_pickup_useful = false, ing_drop_useful = false;
    if constexpr (NP == 2) {
      const int other_held = pl[1 - i].held;
      const bool all_pots_full = snap.n_full == snap.n_pots;
      const int player_dishes = (pl[0].held == OC_OBJ_DISH) + (pl[1].held == OC_OBJ_DISH);
      dish_pickup_useful = dishes == 0 && player_dishes < snap.n_nonempty;
      dish_drop_useful = snap.n_full == 0 && other_held != OC_OBJ_ONION;
      ing_pickup_useful = !(all_pots_full && other_held != OC_OBJ_DISH);
      ing_drop_useful = all_pots_full && other_held != OC_OBJ_DISH;
    }
    const bool onion_pickup = (counter_pickup && c_obj == OC_OBJ_ONION) || onion_disp;
    const bool tomato_pickup = counter_pickup && c_obj == OC_OBJ_TOMATO;
    const bool dish_pickup = (counter_pickup && c_obj == OC_OBJ_DISH) || dish_disp;
    const bool soup_pick = (counter_pickup && c_obj == OC_OBJ_SOUP) || soup_pickup;
    const bool onion_drop = counter_drop && held_i == OC_OBJ_ONION;
    const bool tomato_drop = counter_drop && held_i == OC_OBJ_TOMATO;
    const bool dish_drop = counter_drop && held_i == OC_OBJ_DISH;
    const bool soup_drop = counter_drop && held_i == OC_OBJ_SOUP;
    const bool pot_onion = pot_ok && held_i == OC_OBJ_ONION;
    const bool pot_tomato = pot_ok && held_i == OC_OBJ_TOMATO;
    const int old_no = c_obj == OC_OBJ_NONE ? 0 : c_no;
    const int old_nt = c_obj == OC_OBJ_NONE ? 0 : c_nt;
    const int new_no = old_no + (held_i == OC_OBJ_ONION);
    const int new_nt = old_nt + (held_i == OC_OBJ_TOMATO);
    // a potting always leaves at most 3 items, so (new_no, new_nt) stays in the table
    const int old_val = R.opt_value[old_no * 4 + old_nt];
    const int new_val = pot_ok ? R.opt_value[new_no * 4 + new_nt] : 0;
    const bool optimal = old_val == new_val;
    const bool viable = new_val > 0;
    const bool catastrophic = old_val > 0 && new_val == 0;
    const bool useless = old_val == 0;

    uint32_t m = 0;
    m |= (uint32_t)tomato_pickup << EV_TOMATO_PICKUP;
    m |= (uint32_t)(tomato_pickup && ing_pickup_useful) << EV_USEFUL_TOMATO_PICKUP;
    m |= (uint32_t)tomato_drop << EV_TOMATO_DROP;
    m |= (uint32_t)(tomato_drop && ing_drop_useful) << EV_USEFUL_TOMATO_DROP;
    m |= (uint32_t)pot_tomato << EV_POTTING_TOMATO;
    m |= (uint32_t)onion_pickup << EV_ONION_PICKUP;
    m |= (uint32_t)(onion_pickup && ing_pickup_useful) << EV_USEFUL_ONION_PICKUP;
    m |= (uint32_t)onion_drop << EV_ONION_DROP;
    m |= (uint32_t)(onion_drop && ing_drop_useful) << EV_USEFUL_ONION_DROP;
    m |= (uint32_t)pot_onion << EV_POTTING_ONION;
    m |= (uint32_t)dish_pickup << EV_DISH_PICKUP;
    m |= (uint32_t)(dish_pickup && dish_pickup_useful) << EV_USEFUL_DISH_PICKUP;
    m |= (uint32_t)dish_drop << EV_DISH_DROP;
    m |= (uint32_t)(dish_drop && dish_drop_useful) << EV_USEFUL_DISH_DROP;
    m |= (uint32_t)soup_pick << EV_SOUP_PICKUP;
    m |= (uint32_t)deliver << EV_SOUP_DELIVERY;
    m |= (uint32_t)soup_drop << EV_SOUP_DROP;
    m |= (uint32_t)(pot_onion && optimal) << EV_OPTIMAL_ONION_POTTING;
    m |= (uint32_t)(pot_tomato && optimal) << EV_OPTIMAL_TOMATO_POTTING;
    m |= (uint32_t)(pot_onion && viable) << EV_VIABLE_ONION_POTTING;
    m |= (uint32_t)(pot_tomato && viable) << EV_VIABLE_TOMATO_POTTING;
    m |= (uint32_t)(pot_onion && catastrophic) << EV_CATASTROPHIC_ONION_POTTING;
    m |= (uint32_t)(pot_tomato && catastrophic) << EV_CATASTROPHIC_TOMATO_POTTING;
    m |= (uint32_t)(pot_onion && useless) << EV_USELESS_ONION_POTTING;
    m |= (uint32_t)(pot_tomato && useless) << EV_USELESS_TOMATO_POTTING;
    events[i] = (int)m;
    shaped[i] = (dish_disp && dish_pickup_useful ? R.rew_dish : 0) +
                (soup_pickup ? R.rew_soup : 0) + (pot_ok ? R.rew_pot : 0);
    dishes += (counter_drop && held_i == OC_OBJ_DISH) - (counter_pickup && c_obj == OC_OBJ_DISH);
  }

  // ---- held-object mutations
  const bool gained = (counter_pickup && c_soup) || soup_pickup;
  const bool lost = counter_drop || deliver;
  const int held_slot[3] = {pl[i].slot[0], pl[i].slot[1], pl[i].slot[2]};
  const int held_tick = pl[i].tick;
  int new_held = held_i;
  if (soup_pickup) new_held = OC_OBJ_SOUP;
  if (dish_disp) new_held = OC_OBJ_DISH;
  if (tomato_disp) new_held = OC_OBJ_TOMATO;
  if (onion_disp) new_held = OC_OBJ_ONION;
  if (counter_pickup) new_held = c_obj;
  if (counter_drop || deliver || pot_ok) new_held = OC_OBJ_NONE;
  pl[i].held = new_held;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    pl[i].slot[k] = gained ? cell_slot(w, k) : (lost ? 0 : held_slot[k]);
  pl[i].tick = gained ? c_tick : (lost ? -1 : held_tick);

  // ---- facing-cell mutation
  const bool changed = counter_drop || counter_pickup || soup_pickup || pot_ok || start_cook;
  if (!changed) return false;
  const bool cleared = counter_pickup || soup_pickup;
  const bool drop_soup = counter_drop && held_i == OC_OBJ_SOUP;
  const bool placed = counter_drop || (pot_ok && c_obj == OC_OBJ_NONE);
  int n_obj = counter_drop ? held_i : (cleared ? OC_OBJ_NONE : (pot_ok ? OC_OBJ_SOUP : c_obj));
  int s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) s[k] = cell_slot(w, k);
  int n_tick = c_tick;
  if (drop_soup) {
#pragma unroll
    for (int k = 0; k < 3; ++k) s[k] = held_slot[k];
    n_tick = held_tick;
  } else if (cleared) {
    s[0] = s[1] = s[2] = 0;
    n_tick = -1;
  } else if (start_cook) {
    n_tick = 0;
  } else if (pot_ok) {
    // the potted ingredient goes to the first free slot (index == count)
    const int base = c_obj == OC_OBJ_NONE ? 0 : c_n;
    if (c_obj == OC_OBJ_NONE) s[0] = s[1] = s[2] = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k == base) s[k] = held_i;
    n_tick = -1;
  }
  int seq = cell_seq(w, HW);
  if (placed) seq = t * NP + seq_i + 1;
  else if (cleared) seq = 0;
  const uint32_t word = pack_cell(n_obj, s[0], s[1], s[2], n_tick, seq, HW) | (w & OC_TERRAIN_BITS);
  // whether the next cook tick changes the word (cook_cell(R, word) !=
  // word), from what happened: a started soup cooks unless its recipe
  // takes no time; a potting leaves an idle soup, which only old dynamics
  // start (when full); a dropped soup may be mid-cook; the rest hold none
  const bool live = start_cook ? c_time > 0
                  : pot_ok     ? R.old_dynamics && (c_obj == OC_OBJ_NONE ? 0 : c_n) == 2
                  : drop_soup  && cook_cell(R, word) != word;
  store(word, live);
  return true;
}

// The players' part of one env's transition: interacts, then movement, on
// the cells of `cells` (a cell accessor: load, store, floor). `t` is the
// timestep before the step. TRAIN adds the shaped rewards and the event
// bits, which need `snap` (taken before the step) and `dishes`, the number
// of dishes on the grid, kept up to date here. The cook pass is the
// caller's.
template <int NP, bool TRAIN, class Cells>
__device__ __forceinline__ void env_act(const LayoutData& L, const RecipeTables& R, Cells& cells,
                                        PlayerState* pl, int t, const int* act, int* sparse,
                                        int* shaped, int* events, int& dishes,
                                        const PotSnapshot& snap) {
  const int W = L.width;
  const int HW = L.num_cells;

  // ---- 1. resolve_interacts, one player after another
  auto interact_player = [&](int i, int seq_i, int act_i) {
    const int o = pl[i].orient;
    const int dx = (o == 2) - (o == 3);
    const int dy = (o == 1) - (o == 0);
    const int lin = (pl[i].y + dy) * W + pl[i].x + dx;
    const uint32_t w = lin >= 0 && lin < HW ? cells.load(lin) : 0u;
    interact<NP, TRAIN>(R, HW, pl, i, t, seq_i, act_i, w, sparse, shaped, events, dishes, snap,
                        [&](uint32_t v, bool live) { cells.store(lin, v, live); });
  };
  if constexpr (TRAIN) {
#pragma unroll
    for (int i = 0; i < NP; ++i) interact_player(i, i, act[i]);
  } else {
    // One copy of a player's code, run on each player in turn at index 0
    // (the players, actions and rewards rotate by one after each): half the
    // code of the unrolled loop for two players, and faster (PERF.md). The
    // train step's usefulness classifiers index the other player, so it
    // keeps the unrolled loop.
    int a[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) a[i] = act[i];
#pragma unroll 1
    for (int k = 0; k < NP; ++k) {
      interact_player(0, k, a[0]);
      const PlayerState p0 = pl[0];
      const int a0 = a[0], s0 = sparse[0];
#pragma unroll
      for (int i = 0; i + 1 < NP; ++i) {
        pl[i] = pl[i + 1];
        a[i] = a[i + 1];
        sparse[i] = sparse[i + 1];
      }
      pl[NP - 1] = p0;
      a[NP - 1] = a0;
      sparse[NP - 1] = s0;
    }
  }

  // ---- 2. resolve_movement: all at once; any collision reverts every move
  int nx[NP], ny[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int a = act[i];
    const int cx = pl[i].x + (a == 2) - (a == 3);
    const int cy = pl[i].y + (a == 1) - (a == 0);
    const bool ok = cells.can_enter(a, cy * W + cx, HW);
    nx[i] = ok ? cx : pl[i].x;
    ny[i] = ok ? cy : pl[i].y;
    if (a >= 0 && a < 4) pl[i].orient = a;
  }
  bool collision = false;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int j = i + 1; j < NP; ++j) {
      const bool same = nx[i] == nx[j] && ny[i] == ny[j];
      const bool swap = nx[i] == pl[j].x && ny[i] == pl[j].y && pl[i].x == nx[j] && pl[i].y == ny[j];
      collision = collision || same || swap;
    }
  }
  if (!collision) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      pl[i].x = nx[i];
      pl[i].y = ny[i];
    }
  }
}
