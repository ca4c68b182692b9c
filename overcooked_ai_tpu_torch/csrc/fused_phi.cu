// phi(s'): the reward-shaping potential of every env of a batch in one launch
// (ops/fused_phi.py; the plain version is core/potential.py `potential`).
//
// Replaces no TPU kernel: in the JAX package phi is XLA ops
// (overcooked_ai_tpu/core/potential.py `potential`), which XLA fuses inside
// the jitted rollout. Run op by op, the port's plain version is about 380
// PyTorch ops a step on (K, B) planes: the card finishes each in a few
// microseconds while the host spends milliseconds dispatching them.
//
// Bound on the H100: launch latency, not bytes. An env reads 56 bytes of
// state for its two players (position, orientation, held object, held soup)
// and 20 a pot (object, 3 ingredient slots, tick), and writes 4: on
// cramped_room's one pot 2048 envs move 164 KB, 0.05 us at 3.35 TB/s,
// against a launch's few microseconds.
//
// What the design does about that: one launch a step, with nothing left on
// the host. One thread per env keeps every intermediate in registers and
// local memory; the tables are packed once per device into one word block a
// layout (ops/fused_phi.py `pack_words`), a pool's blocks stacked and each
// lane reading the entry its pool index names. The result is bit for bit the
// plain version's on the card: every float32 product and sum is __fmul_rn /
// __fadd_rn in the plain version's association order (so nvcc cannot contract
// them into FMAs), gamma ** n is powf (what ATen's CUDA pow calls), and the
// sum over the pots follows the order of ATen's reduction (four accumulators,
// pot k into accumulator k % 4, then ((a0 + a1) + a2) + a3).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPots = 8;      // ops/fused_phi.py MAX_POTS
constexpr int kThreads = 64;     // envs a block
constexpr int kInfCost = 1 << 20;  // planning/tables.py INF_COST
constexpr float kInf = 1e9f;     // core/potential.py _INF
constexpr int kObjNone = 0, kObjOnion = 1, kObjTomato = 2, kObjDish = 3, kObjSoup = 4;
constexpr int kSlots = 3;        // MAX_NUM_INGREDIENTS

// An entry's words (ops/fused_phi.py `entry_layout`): the PotentialTables
// scalars, five (4, 4) tables indexed [n_onions * 4 + n_tomatoes], then
// the K pot cells (y * W + x, row-major), the serve cells' count and cells
// (HW words), partial_order (3^K x K) and the cost rows (4HW x HW).
constexpr int kGamma = 0, kSteady = 1, kMaxDeliv = 2, kMaxPick = 3, kOnionSteps = 4,
              kTomatoSteps = 5, kOnionValue = 6, kTomatoValue = 7, kOptNo = 8, kOptNt = 24,
              kOptDisc = 40, kDelivery = 56, kTime = 72, kPots = 88;

struct EntryLayout {
  int num_serve, serve, partial, rows, words;
};

__host__ __device__ inline EntryLayout entry_layout(int K, int HW) {
  int codes = 1;
  for (int k = 0; k < K; ++k) codes *= 3;
  EntryLayout e;
  e.num_serve = kPots + K;
  e.serve = e.num_serve + 1;
  e.partial = e.serve + HW;
  e.rows = e.partial + codes * K;
  e.words = e.rows + 4 * HW * HW;
  return e;
}

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float tab_f(const int* p) { return __int_as_float(__ldg(p)); }
__device__ __forceinline__ float tab_i2f(const int* p) { return __int2float_rn(__ldg(p)); }
__device__ __forceinline__ int cell_of(int n_o, int n_t) { return n_o * 4 + n_t; }

template <int K>
__global__ void __launch_bounds__(kThreads)
    phi_kernel(const int* __restrict__ words, int entry_words, int num_entries,
               const long long* __restrict__ pool_idx, int H, int W, int B,
               const int* __restrict__ pos, const int* __restrict__ orient,
               const int* __restrict__ held_in, const int* __restrict__ held_soup,
               const int* __restrict__ obj, const int* __restrict__ soup_ing,
               const int* __restrict__ soup_tick, float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int HW = H * W;
  const long long entry = pool_idx ? pool_idx[b] : 0;
  if (entry < 0 || entry >= num_entries) {  // a pool index out of range reads NaN
    out[b] = __int_as_float(0x7fc00000);
    return;
  }
  const int* tab = words + entry * static_cast<long long>(entry_words);
  const EntryLayout lay = entry_layout(K, HW);

  const float gamma = tab_f(tab + kGamma);
  const int max_deliv_i = __ldg(tab + kMaxDeliv);
  const float max_deliv = __int2float_rn(max_deliv_i);
  const float max_pick = tab_i2f(tab + kMaxPick);
  const float onion_steps = tab_i2f(tab + kOnionSteps);
  const float tomato_steps = tab_i2f(tab + kTomatoSteps);

  // the players: cost row, held object, held soup's counts
  const int* row[2];
  int held[2], h_no[2], h_nt[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int x = pos[(2 * p) * B + b], y = pos[(2 * p + 1) * B + b];
    row[p] = tab + lay.rows + ((orient[p * B + b] * H + y) * W + x) * HW;
    held[p] = held_in[p * B + b];
    h_no[p] = h_nt[p] = 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int v = held_soup[(p * kSlots + s) * B + b];
      h_no[p] += v == kObjOnion;
      h_nt[p] += v == kObjTomato;
    }
  }

  // the pots: counts, state, the players' costs to them
  int k_no[K], k_nt[K];
  bool empty_pot[K], idle_soup[K], full_not_cooking[K], partial[K], cooking[K], ready[K];
  float ctr[K], value_c[K], p2pot[2][K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int cell = __ldg(tab + kPots + k);
    const int o = obj[cell * B + b], tick = soup_tick[cell * B + b];
    int n_o = 0, n_t = 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int v = soup_ing[(cell * kSlots + s) * B + b];
      n_o += v == kObjOnion;
      n_t += v == kObjTomato;
    }
    k_no[k] = n_o;
    k_nt[k] = n_t;
    const int n = n_o + n_t;
    const int cook_time = __ldg(tab + kTime + cell_of(n_o, n_t));
    const bool has_soup = o == kObjSoup, idle = tick < 0;
    ready[k] = has_soup && !idle && tick >= cook_time;
    cooking[k] = has_soup && !idle && !ready[k];
    empty_pot[k] = !has_soup;
    idle_soup[k] = has_soup && idle && n > 0;
    full_not_cooking[k] = idle_soup[k] && n == kSlots;
    partial[k] = idle_soup[k] && n >= 1 && n < kSlots;
    ctr[k] = __int2float_rn(cook_time - tick);
    value_c[k] = fmaxf(tab_i2f(tab + kDelivery + cell_of(n_o, n_t)), 1.0f);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int c = __ldg(row[p] + cell);
      p2pot[p][k] = c >= kInfCost ? kInf : __int2float_rn(c);
    }
  }

  float phi = tab_f(tab + kSteady);

  // players holding soups, player by player
  const int num_serve = __ldg(tab + lay.num_serve);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    int serve_cost = kInfCost;
    for (int i = 0; i < num_serve; ++i)
      serve_cost = min(serve_cost, __ldg(row[p] + __ldg(tab + lay.serve + i)));
    const float d = __int2float_rn(min(serve_cost, max_deliv_i));
    const float held_val = fmaxf(tab_i2f(tab + kDelivery + cell_of(h_no[p], h_nt[p])), 1.0f);
    phi = fadd(phi, held[p] == kObjSoup ? fmul(powf(gamma, d), held_val) : 0.0f);
  }

  // the non-idle soups' values; a player holding a dish reweights the first
  // best soup in dict order (cooking pots, then ready ones, row-major)
  float vals[K];
  int dict_rank[K];
  const float pickup_base = powf(gamma, max_deliv);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float v = fmul(powf(gamma, fadd(max_deliv, fmaxf(max_pick, ctr[k]))), value_c[k]);
    vals[k] = cooking[k] || ready[k] ? v : 0.0f;
    dict_rank[k] = cooking[k] ? k : (ready[k] ? K + k : 2 * K);
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float cand_value[K], best_val = -1.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool cand = (cooking[k] || ready[k]) && p2pot[p][k] < kInf;
      const float discount = powf(gamma, fmaxf(ctr[k], fminf(p2pot[p][k], max_pick)));
      cand_value[k] = cand ? fmul(discount, fmul(pickup_base, value_c[k])) : -1.0f;
      best_val = fmaxf(best_val, cand_value[k]);
    }
    int best_rank = 2 * K;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool cand = (cooking[k] || ready[k]) && p2pot[p][k] < kInf;
      if (cand && cand_value[k] >= best_val && best_val > 0.0f)
        best_rank = min(best_rank, dict_rank[k]);
    }
    if (held[p] == kObjDish && best_rank < 2 * K) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (dict_rank[k] == best_rank) vals[k] = fmaxf(vals[k], best_val);
    }
  }
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k % 4] = fadd(acc[k % 4], vals[k]);
  phi = fadd(phi, fadd(fadd(fadd(acc[0], acc[1]), acc[2]), acc[3]));

  // the idle soups, in the reference's greedy order: the full-not-cooking
  // pots (row-major), then the partially full ones in partial_order's set
  // order, then a stable sort by descending discounted-optimal value
  int code = 0, base_rank[K], order[K];
  float disc_opt[K];
  {
    int scale = 1, fnc = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      code += (partial[k] ? k_no[k] + k_nt[k] : 0) * scale;
      scale *= 3;
      base_rank[k] = full_not_cooking[k] ? fnc++ : 3 * K;
      disc_opt[k] = tab_f(tab + kOptDisc + cell_of(k_no[k], k_nt[k]));
      order[k] = k;
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int p_idx = __ldg(tab + lay.partial + code * K + j);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k == p_idx) base_rank[k] = K + j;
  }
  for (int i = 1; i < K; ++i) {  // stable by base rank, ascending
    const int cur = order[i];
    int j = i;
    for (; j > 0 && base_rank[order[j - 1]] > base_rank[cur]; --j) order[j] = order[j - 1];
    order[j] = cur;
  }
  for (int i = 1; i < K; ++i) {  // then stable by discounted-optimal value, descending
    const int cur = order[i];
    int j = i;
    for (; j > 0 && disc_opt[order[j - 1]] < disc_opt[cur]; --j) order[j] = order[j - 1];
    order[j] = cur;
  }

  bool avail_onion[2] = {held[0] == kObjOnion, held[1] == kObjOnion};
  bool avail_tomato[2] = {held[0] == kObjTomato, held[1] == kObjTomato};
  for (int j = 0; j < K; ++j) {
    const int k = order[j];
    if (!idle_soup[k]) continue;
    const int n_o = k_no[k], n_t = k_nt[k];
    const int opt_no = __ldg(tab + kOptNo + cell_of(n_o, n_t));
    const int opt_nt = __ldg(tab + kOptNt + cell_of(n_o, n_t));
    const int miss_o = opt_no - n_o, miss_t = opt_nt - n_t;
    const float opt_time = tab_i2f(tab + kTime + cell_of(opt_no, opt_nt));
    float discount = powf(gamma, fadd(fmaxf(max_pick, opt_time), max_deliv));
    const float d0 = p2pot[0][k], d1 = p2pot[1][k];
    // onions first, then tomatoes; the nearest player with one brings it
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int miss = pass == 0 ? miss_o : miss_t;
      const float steps = pass == 0 ? onion_steps : tomato_steps;
      bool* avail = pass == 0 ? avail_onion : avail_tomato;
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        if (m >= miss) break;
        const float c0 = avail[0] && d0 < kInf ? d0 : kInf;
        const float c1 = avail[1] && d1 < kInf ? d1 : kInf;
        const float d_min = fminf(c0, c1);
        discount = fmul(discount, powf(gamma, fminf(d_min, steps)));
        if (d_min < kInf) avail[c1 < c0 ? 1 : 0] = false;
      }
    }
    // players holding nothing beeline to a complete optimal soup
    const float cook_dist = fminf(held[0] == kObjNone ? d0 : kInf, held[1] == kObjNone ? d1 : kInf);
    discount =
        fmul(discount, miss_o + miss_t > 0 ? gamma : powf(gamma, fminf(cook_dist, max_pick)));
    const float opt_val = fmaxf(tab_i2f(tab + kDelivery + cell_of(opt_no, opt_nt)), 1.0f);
    phi = fadd(phi, fmul(discount, opt_val));
  }

  // leftover held ingredients, player by player: tomatoes, then onions
  const float tomato_value = tab_f(tab + kTomatoValue), onion_value = tab_f(tab + kOnionValue);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float d = kInf;
#pragma unroll
    for (int k = 0; k < K; ++k) d = fminf(d, empty_pot[k] ? p2pot[p][k] : kInf);
    const float useful = d < kInf ? 1.0f : 0.0f;
    const float disc_t =
        fmul(powf(gamma, fadd(fadd(fminf(tomato_steps, d), max_pick), max_deliv)), useful);
    const float disc_o =
        fmul(powf(gamma, fadd(fadd(fminf(onion_steps, d), max_pick), max_deliv)), useful);
    phi = fadd(phi, avail_tomato[p] ? fmul(disc_t, tomato_value) : 0.0f);
    phi = fadd(phi, avail_onion[p] ? fmul(disc_o, onion_value) : 0.0f);
  }
  out[b] = phi;
}

template <int K>
int launch(const int* words, int entry_words, int num_entries, const long long* pool_idx, int H,
           int W, int B, const int* pos, const int* orient, const int* held, const int* held_soup,
           const int* obj, const int* soup_ing, const int* soup_tick, float* out,
           cudaStream_t stream) {
  phi_kernel<K><<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      words, entry_words, num_entries, pool_idx, H, W, B, pos, orient, held, held_soup, obj,
      soup_ing, soup_tick, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The words of one table entry of a layout of `num_pots` pots and `num_cells`
// cells (ops/fused_phi.py checks its own count against it).
extern "C" int oc_phi_entry_words(int num_pots, int num_cells) {
  return entry_layout(num_pots, num_cells).words;
}

// phi of every env: out (B,) float32. words: `num_entries` entries of
// `entry_words` int32 in device memory; pool_idx (B,) int64 names each lane's
// entry, or is null for entry 0. The state leaves are the batch-last int32
// planes of core/state.py. Returns the cudaError_t of the launch (0 =
// launched); a number of pots outside 1..kMaxPots or an entry size that does
// not match the layout returns cudaErrorInvalidValue without launching.
extern "C" int oc_fused_phi(const int* words, int entry_words, int num_entries,
                            const long long* pool_idx, int num_pots, int H, int W, int B,
                            const int* pos, const int* orient, const int* held,
                            const int* held_soup, const int* obj, const int* soup_ing,
                            const int* soup_tick, float* out, void* stream) {
  if (num_pots < 1 || num_pots > kMaxPots || B < 1 ||
      entry_words != entry_layout(num_pots, H * W).words)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define OC_PHI_CASE(k)                                                                         \
  case k:                                                                                      \
    return launch<k>(words, entry_words, num_entries, pool_idx, H, W, B, pos, orient, held,    \
                     held_soup, obj, soup_ing, soup_tick, out, s);
  switch (num_pots) {
    OC_PHI_CASE(1)
    OC_PHI_CASE(2)
    OC_PHI_CASE(3)
    OC_PHI_CASE(4)
    OC_PHI_CASE(5)
    OC_PHI_CASE(6)
    OC_PHI_CASE(7)
    OC_PHI_CASE(8)
  }
#undef OC_PHI_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
