// sparse_row_update / sparse_row_update_packed: the fused CTR row step of
// every training step (paper Eq. 8, row-Adam form), in place:
//   w = f32(code) * Delta;  Adam on mu, nu (bias corrections c1, c2);
//   upd (+ wd * w);  w_new = w - lr * upd;  code' = SR(clip(w_new / Delta))
// for each slot s of the unique ids uniq[K], writing codes, mu and nu back at
// row uniq[s] and emitting w_new[s] (ALPT's Delta sub-step reads it).  Two
// entry points share the step:
//  * sparse_row_update_launch takes the summed gradients g_sum [K, d]: the
//    function of src/repro/kernels/sparse_row_update.py:71
//    `sparse_row_update` (pallas_call at :113) and :139
//    `sparse_row_update_packed` (pallas_call at :188);
//  * sparse_row_update_runs_launch takes the per-lookup gradients g_occ
//    [M, d] and each slot's run of occurrences (order, starts) and sums the
//    run itself, in occurrence order from +0.0f: the same kernels together
//    with the duplicate-id sum in front of them, src/repro/core/lpt.py:255
//    `zeros.at[inv].add(flat_g)` (on the card, PyTorch's sorted
//    `index_put_(accumulate=True)`, which adds in the same order).
// The Pallas kernels walk one row per grid step, in order, with the ids
// scalar-prefetched and the scatter as an aliased output.  Here every slot is
// independent and in flight at once; the scatter is a plain store.
//
// Bound: bytes.  Per slot: the id and the w_new row out (the runs form also
// its run's bounds); per live slot (distinct in-range id): Delta, the codes,
// mu and nu in, the codes, mu and nu out, the noise row in, and its gradient
// (g_sum: one row; runs: the run's order entries and g_occ rows).  About 30
// fp32 operations per element, far below the H100's ridge point.  At a CTR
// wave (K = 24,576 slots, 5,712 distinct ids, d = 16) that is ~2-5 MB, a
// microsecond or two of HBM time; what a call cannot avoid is its chain of
// dependent DRAM trips (the id, then the row; the runs form: the run's
// bounds, then order, then the g_occ rows) behind the launch.
//
// Design, against what held the first port back (one thread per code byte,
// 4-byte scalar accesses, padding slots doing row work, a ragged second
// pass over a capped grid, 64-bit index arithmetic):
//  * Row groups of lanes, as the gathers (dequant_gather.cu).  A slot is
//    ceil(d/4) lane tasks; lane l owns columns [4l, 4l + 4).  When d % 4 == 0
//    and the operands are aligned (the launcher checks), a lane moves one
//    float4 of each of mu, nu, the gradient, noise and w_new, and one code
//    word of 4, 2 or 1 bytes at 8, 4 or 2 bits; 32 lanes of a warp touch 8
//    whole 64-byte rows at d = 16.  Otherwise (d = 13, 15, or a view off its
//    alignment) the same map takes scalar accesses and byte loads and stores
//    that stop at the lane's last byte; a packed row's pad bits are written
//    as zero, as repro_torch/core/codestore.py:pack_codes does.
//  * 32-bit integer work: slot = task / lanes is a multiply-high by a host
//    constant (repro::FastDiv); only row and slot offsets are 64-bit.
//  * Dead slots do no row work.  A slot is live when its id lies in [0, n)
//    and differs from the previous slot's: of the dedup's run of sentinels
//    (and of any run of equal ids) only the first can write, and a sentinel
//    past the table never does.  A dead slot reads no gradient, noise,
//    Delta, codes, mu or nu, writes nothing to the table, and writes zeros
//    as its w_new row (finite: ALPT's Delta step fake-quantizes all K rows).
//    At a CTR wave ~77% of the slots are dead.  The id and the previous id
//    are one load pair from the same lines; everything a live lane reads is
//    issued in one trip after it.
//  * The g_sum form: one task per thread over a grid of one resident wave
//    at most (repro::grid_for; a CTR wave is 384 blocks of 256, no second
//    pass).  Two tasks per thread, their loads issued first, measured the
//    same per call on an H100 (chip_smoke.row_only, PERF.md section 6).
//  * The runs form: a block of 256 threads owns a tile of 16 consecutive
//    slots (64 lanes at d = 16; rows wider than 1,024 split their lanes
//    over blockIdx.y).  The tile's runs are one contiguous range of
//    `order`, since runs follow their slots.  All 256 threads stage that
//    range in chunks of 1,536 16-byte pieces (384 lookups at d = 16)
//    through two 24 KB buffers: each loads 6 order entries at once and
//    issues 6 cp.async copies of g_occ pieces, so a run of hundreds of
//    lookups (404 in a CTR wave) is fetched in a few round trips, not one
//    per lookup, and chunk j + 1's copies and chunk j + 2's order entries
//    are in flight while chunk j is added.  Each live lane adds its run's
//    pieces from shared memory in order, eight loaded at once, four
//    independent column chains per thread; a run that crosses chunks
//    carries its partial sums in registers.  There is no threshold: short
//    runs are staged the same way, in the same trips.  The lane's row state
//    is loaded before the first chunk, so it is in flight with the staging.
//    The tile size sets the longest serial chain of chunks: a CTR wave's
//    heaviest 64-slot tile holds ~1,700-1,800 lookups (its fields' most
//    frequent ids), its heaviest 16-slot tile ~900-1,000.  On an H100 16
//    slots took 14.7 us per call against 17.6-18.0 for 64, 32 or 8 and 26.5
//    for 4 (more tiles, most of them dead, cost more blocks).
//
// Numerics: every operation is an explicit round-to-nearest intrinsic, so
// nvcc can contract nothing.  Where XLA:CPU fuses the reference's
// multiply-adds (it does, and that is where the reference's numbers come
// from), the kernel uses __fmaf_rn at the same places; see
// kernels/ref.py:adam_row_step, which this kernel equals bit for bit.  The
// float constants arrive already rounded to float32 as the reference rounds
// them (1 - b1 is computed in float64 first).  The runs form's sum is
// 0.0f + g_1 + g_2 + ... with __fadd_rn, the order and the start of the
// reference's scatter-add, so a -0.0 gradient sums to +0.0 as there.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr uint32_t kTileSlots = 16;                      // runs form: slots per block
constexpr uint32_t kStage = 1536;                        // 16-byte pieces per chunk
constexpr uint32_t kPieces = kStage / repro::kThreads;  // staged by each thread

struct Scalars {
  float lr, c1, c2, b1, a1, b2, a2, eps, wd;
};

struct Params {
  uint8_t* codes;
  const float* step;
  float* mu;
  float* nu;
  const int32_t* uniq;
  const float* g;         // g_sum [k, d], or g_occ [m, d] for the runs form
  const int64_t* order;   // runs form: [m]
  const int32_t* starts;  // runs form: [k + 1]
  const float* noise;
  float* w_new;
  uint32_t n_ok;  // rows, capped at 2^31: every int32 id >= 0 is then inside
  uint32_t d, width, lanes, k, m, tasks;
  uint32_t tile_lanes, tile_slots;  // runs form: a block's lanes per slot and slots
  repro::FastDiv div;  // by lanes (g_sum form) or tile_lanes (runs form)
  Scalars s;
  float lo, hi;
};

// One element: Adam step + SR; updates mu, nu in registers and returns the code.
__device__ __forceinline__ int step_one(int code, float st, float& mu, float& nu, float g, float u,
                                        float& w_new, const Scalars& s, float lo, float hi) {
  const float cf = static_cast<float>(code);
  const float w = __fmul_rn(cf, st);
  const float mu_new = __fmaf_rn(s.b1, mu, __fmul_rn(s.a1, g));
  const float nu_new = __fmaf_rn(s.b2, nu, __fmul_rn(s.a2, __fmul_rn(g, g)));
  const float num = __fmaf_rn(s.a1, g, __fmul_rn(s.b1, mu));
  const float den = __fmul_rn(s.c1, __fadd_rn(__fsqrt_rn(__fdiv_rn(nu_new, s.c2)), s.eps));
  float upd = __fdiv_rn(num, den);
  if (s.wd != 0.0f) {
    upd = __fmaf_rn(s.wd, w, upd);
    w_new = __fmaf_rn(-s.lr, upd, w);
  } else {
    w_new = __fmaf_rn(cf, st, -__fmul_rn(s.lr, upd));
  }
  mu = mu_new;
  nu = nu_new;
  const float scaled = fminf(fmaxf(__fdiv_rn(w_new, st), lo), hi);
  const float base = floorf(scaled);
  const float up = (__fsub_rn(scaled, base) > u) ? 1.0f : 0.0f;
  return static_cast<int>(fminf(fmaxf(__fadd_rn(base, up), lo), hi));
}

// A lane's four floats: one float4, or its c <= 4 scalars off the aligned path.
template <bool VEC>
__device__ __forceinline__ void load4(const float* src, uint32_t c, float (&v)[4]) {
  if constexpr (VEC) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (static_cast<uint32_t>(k) < c) v[k] = src[k];
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* dst, uint32_t c, const float (&v)[4]) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (static_cast<uint32_t>(k) < c) dst[k] = v[k];
    }
  }
}

// The BITS/2 code bytes behind a lane's four columns, as one word; off the
// aligned path single bytes up to the last byte its c codes need.
template <int BITS, bool VEC>
__device__ __forceinline__ uint32_t load_codes(const uint8_t* src, uint32_t c) {
  if constexpr (VEC && BITS == 8) {
    return *reinterpret_cast<const uint32_t*>(src);
  } else if constexpr (VEC && BITS == 4) {
    return *reinterpret_cast<const uint16_t*>(src);
  } else {
    const uint32_t nbytes = VEC ? BITS / 2 : (c * BITS + 7) / 8;
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < BITS / 2; ++k) {
      if (static_cast<uint32_t>(k) < nbytes) word |= static_cast<uint32_t>(src[k]) << (8 * k);
    }
    return word;
  }
}

template <int BITS, bool VEC>
__device__ __forceinline__ void store_codes(uint8_t* dst, uint32_t c, uint32_t word) {
  if constexpr (VEC && BITS == 8) {
    *reinterpret_cast<uint32_t*>(dst) = word;
  } else if constexpr (VEC && BITS == 4) {
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(word);
  } else {
    const uint32_t nbytes = VEC ? BITS / 2 : (c * BITS + 7) / 8;
#pragma unroll
    for (int k = 0; k < BITS / 2; ++k) {
      if (static_cast<uint32_t>(k) < nbytes) dst[k] = static_cast<uint8_t>(word >> (8 * k));
    }
  }
}

// What a live lane steps: its columns of mu, nu and noise, its code word and
// the row's Delta.
struct Lane {
  float mu[4], nu[4], u[4];
  uint32_t word;
  float st;
};

template <int BITS, bool VEC>
__device__ __forceinline__ void load_lane(const Params& p, int32_t id, uint32_t s, uint32_t l,
                                          uint32_t c, Lane& x) {
  const int64_t at = static_cast<int64_t>(id) * p.d + 4 * l;
  load4<VEC>(p.mu + at, c, x.mu);
  load4<VEC>(p.nu + at, c, x.nu);
  load4<VEC>(p.noise + static_cast<int64_t>(s) * p.d + 4 * l, c, x.u);
  x.word = load_codes<BITS, VEC>(p.codes + static_cast<int64_t>(id) * p.width + l * (BITS / 2), c);
  x.st = p.step[id];
}

// Steps a live lane with its gradient g; writes its codes, mu, nu and w_new.
template <int BITS, bool VEC>
__device__ __forceinline__ void step_lane(const Params& p, int32_t id, uint32_t s, uint32_t l,
                                          uint32_t c, Lane& x, const float (&g)[4]) {
  float wn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (VEC || static_cast<uint32_t>(k) < c) {
      const int q = step_one(repro::code_at<BITS>(x.word, k), x.st, x.mu[k], x.nu[k], g[k],
                             x.u[k], wn[k], p.s, p.lo, p.hi);
      word |= static_cast<uint32_t>(q & ((1 << BITS) - 1)) << (k * BITS);
    }
  }
  const int64_t at = static_cast<int64_t>(id) * p.d + 4 * l;
  store4<VEC>(p.mu + at, c, x.mu);
  store4<VEC>(p.nu + at, c, x.nu);
  store_codes<BITS, VEC>(p.codes + static_cast<int64_t>(id) * p.width + l * (BITS / 2), c, word);
  store4<VEC>(p.w_new + static_cast<int64_t>(s) * p.d + 4 * l, c, wn);
}

template <bool VEC>
__device__ __forceinline__ void dead_lane(const Params& p, uint32_t s, uint32_t l, uint32_t c) {
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  store4<VEC>(p.w_new + static_cast<int64_t>(s) * p.d + 4 * l, c, zero);
}

// A slot writes its row when its id is in the table and the previous slot
// holds another id.
__device__ __forceinline__ bool live_slot(const Params& p, uint32_t s, int32_t id, int32_t prev) {
  return static_cast<uint32_t>(id) < p.n_ok && (s == 0 || prev != id);
}

// The g_sum form: task t = slot * lanes + l, one per thread per sweep.
template <int BITS, bool VEC>
__global__ void __launch_bounds__(repro::kThreads) row_kernel(const Params p) {
  const uint32_t stride = gridDim.x * repro::kThreads;
  for (uint32_t t = blockIdx.x * repro::kThreads + threadIdx.x; t < p.tasks; t += stride) {
    const uint32_t s = repro::divide(t, p.div);
    const uint32_t l = t - s * p.lanes;
    const uint32_t c = VEC ? 4 : min(4u, p.d - 4 * l);
    const int32_t id = p.uniq[s];
    const int32_t prev = s ? p.uniq[s - 1] : id;
    if (live_slot(p, s, id, prev)) {
      Lane x;
      float g[4];
      load_lane<BITS, VEC>(p, id, s, l, c, x);
      load4<VEC>(p.g + static_cast<int64_t>(s) * p.d + 4 * l, c, g);
      step_lane<BITS, VEC>(p, id, s, l, c, x, g);
    } else {
      dead_lane<VEC>(p, s, l, c);
    }
  }
}

// The row indices of one chunk's pieces: piece q * kThreads + threadIdx.x is
// lookup i = piece / tile_lanes of the chunk starting at c0 (-1 past it).
__device__ __forceinline__ void chunk_rows(const Params& p, uint32_t c0, uint32_t end,
                                           uint32_t chunk, int64_t (&row)[kPieces]) {
#pragma unroll
  for (uint32_t q = 0; q < kPieces; ++q) {
    const uint32_t i = repro::divide(threadIdx.x + q * repro::kThreads, p.div);
    row[q] = i < chunk && c0 + i < end ? p.order[c0 + i] : -1;
  }
}

// Copies one chunk's pieces of g_occ into `buf`: cp.async on the aligned
// path (one commit group per chunk, committed by the caller), else loads.
template <bool VEC>
__device__ __forceinline__ void chunk_copy(const Params& p, const int64_t (&row)[kPieces],
                                           float4* buf) {
  const uint32_t tl = p.tile_lanes;
#pragma unroll
  for (uint32_t q = 0; q < kPieces; ++q) {
    const uint32_t piece = threadIdx.x + q * repro::kThreads;
    const uint32_t lane = blockIdx.y * tl + (piece - repro::divide(piece, p.div) * tl);
    const bool ok = lane < p.lanes && static_cast<uint64_t>(row[q]) < p.m;
    const float* src = p.g + (ok ? row[q] * p.d + 4 * lane : 0);
    if constexpr (VEC) {
      repro::cp_async16(&buf[piece], src, ok);
    } else {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (ok) load4<false>(src, min(4u, p.d - 4 * lane), v);
      buf[piece] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The runs form: one block per tile of slots (and of lanes, blockIdx.y).
template <int BITS, bool VEC>
__global__ void __launch_bounds__(repro::kThreads) runs_kernel(const Params p) {
  __shared__ float4 stage[2][kStage];
  const uint32_t tl = p.tile_lanes;
  const uint32_t ls = repro::divide(threadIdx.x, p.div);
  const uint32_t ll = threadIdx.x - ls * tl;
  const uint32_t l = blockIdx.y * tl + ll;
  const uint32_t s0 = blockIdx.x * p.tile_slots;
  const uint32_t s_end = min(s0 + p.tile_slots, p.k);
  const uint32_t s = s0 + ls;
  const bool active = s < s_end && l < p.lanes;
  const uint32_t c = VEC ? 4 : (active ? min(4u, p.d - 4 * l) : 0);
  int32_t id = -1, prev = -1;
  uint32_t r0 = 0, r1 = 0;
  if (active) {
    id = p.uniq[s];
    prev = s ? p.uniq[s - 1] : id;
    r0 = static_cast<uint32_t>(p.starts[s]);
    r1 = static_cast<uint32_t>(p.starts[s + 1]);
  }
  // The tile's runs: one range of `order`, clamped to it (int32 bounds read
  // as unsigned, so a negative one clamps to m).
  const uint32_t begin = min(static_cast<uint32_t>(p.starts[s0]), p.m);
  const uint32_t end = min(static_cast<uint32_t>(p.starts[s_end]), p.m);
  const bool live = active && live_slot(p, s, id, prev);
  Lane x;
  if (live) load_lane<BITS, VEC>(p, id, s, l, c, x);
  float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  // Two buffers: chunk j + 1's copies are in flight while chunk j is added,
  // and chunk j + 2's order entries while chunk j + 1 lands.
  const uint32_t chunk = kStage / tl;  // lookups per chunk
  int64_t row[kPieces];
  if (begin < end) {
    chunk_rows(p, begin, end, chunk, row);
    chunk_copy<VEC>(p, row, stage[0]);
    repro::cp_async_commit();
    chunk_rows(p, begin + chunk, end, chunk, row);
  }
  uint32_t b = 0;
  for (uint32_t c0 = begin; c0 < end; c0 += chunk, b ^= 1) {
    if (c0 + chunk < end) {
      chunk_copy<VEC>(p, row, stage[b ^ 1]);
      chunk_rows(p, c0 + 2 * chunk, end, chunk, row);
    }
    repro::cp_async_commit();  // empty past the last chunk
    repro::cp_async_wait<1>();  // this chunk's copies have landed
    __syncthreads();
    if (live) {
      // The lane's run within this chunk, added in order: eight pieces
      // loaded at once, then added one by one (four column chains).
      const float4* at = stage[b] + ll;
      uint32_t i = max(r0, c0);
      const uint32_t stop = min(r1, min(c0 + chunk, end));
      for (; i + 8 <= stop; i += 8) {
        float4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = at[(i + u - c0) * tl];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          g[0] = __fadd_rn(g[0], v[u].x);
          g[1] = __fadd_rn(g[1], v[u].y);
          g[2] = __fadd_rn(g[2], v[u].z);
          g[3] = __fadd_rn(g[3], v[u].w);
        }
      }
      for (; i < stop; ++i) {
        const float4 v = at[(i - c0) * tl];
        g[0] = __fadd_rn(g[0], v.x);
        g[1] = __fadd_rn(g[1], v.y);
        g[2] = __fadd_rn(g[2], v.z);
        g[3] = __fadd_rn(g[3], v.w);
      }
    }
    __syncthreads();  // the buffer is free for chunk j + 2
  }
  if (live) {
    step_lane<BITS, VEC>(p, id, s, l, c, x, g);
  } else if (active) {
    dead_lane<VEC>(p, s, l, c);
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// Fills the operands and the scalars shared by both forms; false if a size
// does not fit the 32-bit index work or the bit widths are wrong.
bool make_params(Params& p, void* codes, const void* step, void* mu, void* nu, const void* uniq,
                 const void* g, const void* noise, void* w_new, int64_t n, int64_t d, int64_t k,
                 int64_t m, int64_t width, int bits, float lr, float c1, float c2, float b1,
                 float a1, float b2, float a2, float eps, float wd) {
  const int64_t lanes = (d + 3) / 4;
  if (n <= 0 || bits < 2 || bits > 8 || d >= (int64_t{1} << 31) || m >= (int64_t{1} << 31) ||
      k * lanes >= (int64_t{1} << 31)) {
    return false;
  }
  p.codes = static_cast<uint8_t*>(codes);
  p.step = static_cast<const float*>(step);
  p.mu = static_cast<float*>(mu);
  p.nu = static_cast<float*>(nu);
  p.uniq = static_cast<const int32_t*>(uniq);
  p.g = static_cast<const float*>(g);
  p.order = nullptr;
  p.starts = nullptr;
  p.noise = static_cast<const float*>(noise);
  p.w_new = static_cast<float*>(w_new);
  p.n_ok = static_cast<uint32_t>(n < (int64_t{1} << 31) ? n : int64_t{1} << 31);
  p.d = static_cast<uint32_t>(d);
  p.width = static_cast<uint32_t>(width);
  p.lanes = static_cast<uint32_t>(lanes);
  p.k = static_cast<uint32_t>(k);
  p.m = static_cast<uint32_t>(m);
  p.tasks = static_cast<uint32_t>(k * lanes);
  p.tile_lanes = p.tile_slots = 0;
  p.div = repro::fast_div(p.lanes);
  p.s = Scalars{lr, c1, c2, b1, a1, b2, a2, eps, wd};
  p.lo = static_cast<float>(-(1 << (bits - 1)));
  p.hi = static_cast<float>((1 << (bits - 1)) - 1);
  return true;
}

// The float4 and code-word path: whole lanes, every float operand on 16
// bytes and the codes on the lane's word.
bool vec_path(const Params& p, int container_bits) {
  return p.d % 4 == 0 && aligned16(p.mu) && aligned16(p.nu) && aligned16(p.g) &&
         aligned16(p.noise) && aligned16(p.w_new) &&
         reinterpret_cast<uintptr_t>(p.codes) % (container_bits / 2) == 0;
}

template <int BITS, bool VEC>
cudaError_t launch_rows(const Params& p, cudaStream_t strm) {
  row_kernel<BITS, VEC><<<repro::grid_for(p.tasks), repro::kThreads, 0, strm>>>(p);
  return cudaGetLastError();
}

template <int BITS, bool VEC>
cudaError_t launch_runs(Params p, cudaStream_t strm) {
  p.tile_lanes = std::min(p.lanes, static_cast<uint32_t>(repro::kThreads));
  p.tile_slots = std::min(repro::kThreads / p.tile_lanes, kTileSlots);
  p.div = repro::fast_div(p.tile_lanes);
  const dim3 grid((p.k + p.tile_slots - 1) / p.tile_slots,
                  (p.lanes + p.tile_lanes - 1) / p.tile_lanes);
  runs_kernel<BITS, VEC><<<grid, repro::kThreads, 0, strm>>>(p);
  return cudaGetLastError();
}

template <bool RUNS, int BITS>
cudaError_t launch_bits(const Params& p, bool vec, cudaStream_t strm) {
  if constexpr (RUNS) {
    return vec ? launch_runs<BITS, true>(p, strm) : launch_runs<BITS, false>(p, strm);
  } else {
    return vec ? launch_rows<BITS, true>(p, strm) : launch_rows<BITS, false>(p, strm);
  }
}

template <bool RUNS>
int launch(const Params& p, int container_bits, void* stream) {
  const auto strm = static_cast<cudaStream_t>(stream);
  const bool vec = vec_path(p, container_bits);
  cudaError_t err;
  if (container_bits == 8) {
    err = launch_bits<RUNS, 8>(p, vec, strm);
  } else if (container_bits == 4) {
    err = launch_bits<RUNS, 4>(p, vec, strm);
  } else if (container_bits == 2) {
    err = launch_bits<RUNS, 2>(p, vec, strm);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// codes: int8 [n, d] (container_bits == 8) or packed uint8 [n, width]
// (container_bits 4 or 2, width = ceil(d * bits / 8)); bits: the code range
// [-2^(bits-1), 2^(bits-1) - 1], 2..8; step: f32 [n]; mu, nu: f32 [n, d] (updated in
// place, as are the codes); uniq: int32 [k], ids outside [0, n) dropped; g_sum,
// noise, w_new: f32 [k, d]; all contiguous on the stream's device.  Returns
// cudaGetLastError().
extern "C" int sparse_row_update_launch(void* codes, const void* step, void* mu, void* nu,
                                        const void* uniq, const void* g_sum, const void* noise,
                                        void* w_new, int64_t n, int64_t d, int64_t k,
                                        int64_t width, int container_bits, int bits, float lr,
                                        float c1, float c2, float b1, float a1, float b2,
                                        float a2, float eps, float wd, void* stream) {
  if (k * d == 0) return 0;
  Params p;
  if (!make_params(p, codes, step, mu, nu, uniq, g_sum, noise, w_new, n, d, k, 0, width, bits,
                   lr, c1, c2, b1, a1, b2, a2, eps, wd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<false>(p, container_bits, stream);
}

// As above with the gradient summed here: g_occ f32 [m, d] per lookup;
// order int64 [m] (as torch.sort gives it), the lookups grouped by slot and
// in occurrence order within a slot; starts int32 [k + 1], slot s's run
// being order[starts[s] : starts[s + 1]].  Returns cudaGetLastError().
extern "C" int sparse_row_update_runs_launch(void* codes, const void* step, void* mu, void* nu,
                                             const void* uniq, const void* g_occ,
                                             const void* order, const void* starts,
                                             const void* noise, void* w_new, int64_t n,
                                             int64_t d, int64_t k, int64_t m, int64_t width,
                                             int container_bits, int bits, float lr, float c1,
                                             float c2, float b1, float a1, float b2, float a2,
                                             float eps, float wd, void* stream) {
  if (k * d == 0) return 0;
  Params p;
  if (!make_params(p, codes, step, mu, nu, uniq, g_occ, noise, w_new, n, d, k, m, width, bits,
                   lr, c1, c2, b1, a1, b2, a2, eps, wd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.order = static_cast<const int64_t*>(order);
  p.starts = static_cast<const int32_t*>(starts);
  return launch<true>(p, container_bits, stream);
}
