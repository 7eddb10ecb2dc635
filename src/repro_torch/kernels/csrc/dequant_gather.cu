// dequant_gather / dequant_gather_packed: fused row gather + per-row dequantize,
//   out[b, j] = f32(codes[ids[b], j]) * Delta[ids[b]]
// over int8 codes [n, d], or over a packed uint8 container [n, ceil(d*bits/8)]
// holding 2- or 4-bit codes low-bits-first (repro_torch/core/codestore.py).
//
// Replaces src/repro/kernels/dequant_gather.py:42 `dequant_gather` (Pallas TPU,
// pallas_call at :69) and :78 `dequant_gather_packed` (pallas_call at :107).
// Those scalar-prefetch the ids into SMEM and DMA one row per grid step, in
// order; here every row is independent and all of them are in flight at once.
//
// Bound: bytes.  Per id it reads the id (4 B), the row's codes (d B at 8 bits,
// ceil(d*bits/8) B packed) and Delta (4 B), and writes d fp32 (4d B).  The
// output dominates: the fp32 table never exists, only the rows asked for.
// At a CTR wave (24,576 ids, d = 16) that is ~2 MB, under a microsecond of
// HBM time; what a call cannot avoid is two dependent DRAM round trips (the
// id, then its row and Delta) behind the launch.
//
// Design:
//  * Row groups of lanes.  A row of d outputs is ceil(d/4) lane tasks; task
//    t = row * lanes + l writes outputs [4l, 4l + 4) of its row.  When
//    d % 4 == 0 that is the 16 bytes at out + 16t, so the 32 lanes of a warp,
//    taking 32 consecutive tasks, store 512 contiguous bytes per instruction
//    (at d = 16: 8 rows of 4 lanes).  A lane reads only the code bytes behind
//    its four outputs (4 B at 8 bits, 2 B at 4 bits, 1 B at 2 bits); the lanes
//    of a row read the same id and Delta addresses, which the warp coalesces.
//  * One task per thread on 256-thread blocks (repro::grid_for): a CTR wave
//    (98,304 tasks) runs on 384 blocks, ~3 on each of an H100's 132 SMs.
//    The grid is capped at one resident wave of the card it runs on and
//    the loop strides past it.  Several tasks per thread (R = 2 or 4,
//    unrolled, all id loads issued before the row loads) measured no faster
//    back to back on an H100 at any timed shape and up to 0.6 us slower per
//    call at the serving shapes, and 128- or 512-thread blocks within
//    +-0.15 us (PERF.md section 6): one task per thread already puts a whole
//    wave in flight at once.
//  * 32-bit integer work.  Tasks and rows are uint32 (the wrapper checks that
//    b * ceil(d/4) < 2^31); row = t / lanes is a multiply-high by a constant
//    the host computes (repro::FastDiv), never a division in the loop.  Only
//    id * width is 64-bit.  Packed codes are sign-extended by two shifts and
//    converted by I2F; the multiply is the only rounding, so the rows equal
//    kernels/ref.py's plain versions bitwise.
//  * Ragged or unaligned operands (d % 4 != 0, or codes / out not aligned for
//    the lane's load and float4 store) take the same map with byte loads that
//    never read past a row's last byte, and scalar stores of the lane's
//    min(4, d - 4l) outputs.
//  * An id outside [0, n) writes a NaN row (its Delta is NaN and no code is
//    read) instead of reading outside the table (the serving engine rejects
//    such ids at submit).
//  * The output is consumed at once by the DCN or the transformer: plain
//    stores, no evict-first hint.
//  * Routed (dequant_gather_routed_launch), for a table behind a hot-row
//    cache (repro_torch/storage): a lookup's code row is hot[slot] when
//    slot >= 0, else a row of the backing; its Delta is always Delta[id].
//    Two routes: through the map (TieredCodes), slot = slot_of_id[id] read
//    here and the backing row is id's; staged (the cold tier's wave),
//    slot is the lookup's own entry of a per-lookup array, and a slot < 0
//    names row -1 - slot of the staged rows [k, width] (the rows of the
//    wave's distinct ids that were not cached when it was staged).  The
//    route is a template parameter: the direct instantiations are the code
//    the untiered launchers always ran.  The map route adds one dependent
//    4-byte read (the slot) between the id and the row; the staged route's
//    slot read does not depend on the id.
// What does not apply: TMA, wgmma and shared-memory staging.  A wave is ~2 MB
// of scattered 4- to 16-byte row pieces with no reuse inside a block, so a
// tile copy or a staged transpose only adds a round trip.
#include "common.cuh"

namespace {

// Where a lookup's code row comes from (a template parameter).
enum Route : int { kDirect = 0, kMap = 1, kStaged = 2 };

struct Params {
  const uint8_t* codes;  // the table, the backing (kMap) or the staged wave (kStaged)
  const uint8_t* hot;    // routed: the hot tier [cap, width]
  const int32_t* slots;  // kMap: slot_of_id [n]; kStaged: one slot per lookup [b]
  const float* step;
  const int32_t* ids;
  float* out;
  uint32_t n_ok;   // rows, capped at 2^31: every int32 id >= 0 is then inside
  uint32_t d, width, lanes, tasks;
  repro::FastDiv div;
};

// The BITS/2 code bytes behind a lane's four outputs, as one word.
template <int BITS>
__device__ __forceinline__ uint32_t load_word(const uint8_t* src) {
  if constexpr (BITS == 8) {
    return __ldg(reinterpret_cast<const unsigned int*>(src));
  } else if constexpr (BITS == 4) {
    return __ldg(reinterpret_cast<const unsigned short*>(src));
  } else {
    return __ldg(src);
  }
}

// The same from single bytes, stopping at the last byte `c` codes need.
template <int BITS>
__device__ __forceinline__ uint32_t load_bytes(const uint8_t* src, uint32_t c) {
  const uint32_t nbytes = (c * BITS + 7) / 8;
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < BITS / 2; ++k) {
    if (static_cast<uint32_t>(k) < nbytes) {
      word |= static_cast<uint32_t>(__ldg(src + k)) << (8 * k);
    }
  }
  return word;
}

// The code row of lookup `row` (id in [0, n)): the table's, or routed to
// the hot tier or the backing.
template <int ROUTE>
__device__ __forceinline__ const uint8_t* code_row(const Params& p, uint32_t row, int32_t id) {
  if constexpr (ROUTE == kDirect) {
    return p.codes + static_cast<int64_t>(id) * p.width;
  } else if constexpr (ROUTE == kMap) {
    const int32_t slot = __ldg(p.slots + id);
    return slot >= 0 ? p.hot + static_cast<int64_t>(slot) * p.width
                     : p.codes + static_cast<int64_t>(id) * p.width;
  } else {
    const int32_t slot = __ldg(p.slots + row);
    return slot >= 0 ? p.hot + static_cast<int64_t>(slot) * p.width
                     : p.codes + static_cast<int64_t>(-1 - slot) * p.width;
  }
}

template <int BITS, bool VEC, int ROUTE>
__global__ void __launch_bounds__(repro::kThreads) gather_kernel(const Params p) {
  const uint32_t stride = gridDim.x * repro::kThreads;
  for (uint32_t t = blockIdx.x * repro::kThreads + threadIdx.x; t < p.tasks; t += stride) {
    const uint32_t row = repro::divide(t, p.div);
    const uint32_t l = t - row * p.lanes;
    const int32_t id = __ldg(p.ids + row);
    uint32_t word = 0;
    float delta = __int_as_float(0x7fc00000);
    if (static_cast<uint32_t>(id) < p.n_ok) {
      const uint8_t* src = code_row<ROUTE>(p, row, id) + l * (BITS / 2);
      if constexpr (VEC) {
        word = load_word<BITS>(src);
      } else {
        word = load_bytes<BITS>(src, min(4u, p.d - 4 * l));
      }
      delta = __ldg(p.step + id);
    }
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = __fmul_rn(__int2float_rn(repro::code_at<BITS>(word, k)), delta);
    }
    if constexpr (VEC) {
      reinterpret_cast<float4*>(p.out)[t] = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      float* o = p.out + static_cast<int64_t>(row) * p.d + 4 * l;
      const uint32_t c = min(4u, p.d - 4 * l);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (static_cast<uint32_t>(k) < c) o[k] = v[k];
      }
    }
  }
}

template <int BITS, bool VEC, int ROUTE>
cudaError_t launch_tasks(const Params& p, cudaStream_t s) {
  gather_kernel<BITS, VEC, ROUTE><<<repro::grid_for(p.tasks), repro::kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

template <int BITS, int ROUTE = kDirect>
int launch_gather(const void* codes, const void* step, const void* ids, void* out, int64_t n,
                  int64_t d, int64_t b, void* stream, const void* hot = nullptr,
                  const void* slots = nullptr) {
  if (b * d == 0) return 0;
  const int64_t lanes = (d + 3) / 4;
  if (d >= (int64_t{1} << 31) || b * lanes >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.codes = static_cast<const uint8_t*>(codes);
  p.hot = static_cast<const uint8_t*>(hot);
  p.slots = static_cast<const int32_t*>(slots);
  p.step = static_cast<const float*>(step);
  p.ids = static_cast<const int32_t*>(ids);
  p.out = static_cast<float*>(out);
  p.n_ok = static_cast<uint32_t>(n < (int64_t{1} << 31) ? n : int64_t{1} << 31);
  p.d = static_cast<uint32_t>(d);
  p.width = static_cast<uint32_t>((d * BITS + 7) / 8);
  p.lanes = static_cast<uint32_t>(lanes);
  p.tasks = static_cast<uint32_t>(b * lanes);
  p.div = repro::fast_div(p.lanes);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(codes) % (BITS / 2) == 0 &&
                   reinterpret_cast<uintptr_t>(hot) % (BITS / 2) == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec ? launch_tasks<BITS, true, ROUTE>(p, s)
                              : launch_tasks<BITS, false, ROUTE>(p, s));
}

template <int BITS>
int launch_routed(const void* codes, const void* hot, const void* slots, const void* step,
                  const void* ids, void* out, int64_t n, int64_t d, int64_t b, int staged,
                  void* stream) {
  return staged ? launch_gather<BITS, kStaged>(codes, step, ids, out, n, d, b, stream, hot, slots)
                : launch_gather<BITS, kMap>(codes, step, ids, out, n, d, b, stream, hot, slots);
}

}  // namespace

// codes: int8 [n, d]; step: f32 [n]; ids: int32 [b]; out: f32 [b, d]; all
// contiguous on the stream's device.  Returns cudaGetLastError().
extern "C" int dequant_gather_launch(const void* codes, const void* step, const void* ids,
                                     void* out, int64_t n, int64_t d, int64_t b, void* stream) {
  return launch_gather<8>(codes, step, ids, out, n, d, b, stream);
}

// packed: uint8 [n, ceil(d*bits/8)]; bits in {2, 4}; otherwise as above.
extern "C" int dequant_gather_packed_launch(const void* packed, const void* step,
                                            const void* ids, void* out, int64_t n, int64_t d,
                                            int64_t b, int bits, void* stream) {
  if (bits == 4) return launch_gather<4>(packed, step, ids, out, n, d, b, stream);
  if (bits == 2) return launch_gather<2>(packed, step, ids, out, n, d, b, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gathers routed through a hot tier.  hot: [cap, width] in the table's
// layout (bits 8: int8 codes; 4, 2: packed uint8); step: f32 [n]; ids: int32
// [b]; out: f32 [b, d].  staged == 0: codes is the backing [n, width] and
// slots is slot_of_id int32 [n] (-1: not cached); staged != 0: codes is the
// wave's staged rows [k, width] and slots int32 [b], one per lookup: a hot
// slot, or -1 - r for staged row r.
// Returns cudaGetLastError().
extern "C" int dequant_gather_routed_launch(const void* codes, const void* hot,
                                            const void* slots, const void* step,
                                            const void* ids, void* out, int64_t n, int64_t d,
                                            int64_t b, int bits, int staged, void* stream) {
  if (bits == 8) return launch_routed<8>(codes, hot, slots, step, ids, out, n, d, b, staged, stream);
  if (bits == 4) return launch_routed<4>(codes, hot, slots, step, ids, out, n, d, b, staged, stream);
  if (bits == 2) return launch_routed<2>(codes, hot, slots, step, ids, out, n, d, b, staged, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
