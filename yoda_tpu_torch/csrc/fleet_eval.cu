// Fleet evaluation for K pod requests over N nodes x C chips, on Hopper.
//
// Replaces the two Pallas TPU kernels of the reference package:
//   yoda_tpu/ops/pallas_kernel.py::_pallas_eval        (one request)
//   yoda_tpu/ops/pallas_kernel.py::_pallas_eval_burst  (K requests)
// and their host epilogue (_epilogue: min-max normalization, slice-protect
// tier, argmax). It computes yoda_tpu/ops/kernel.py::kernel_packed_burst
// exactly: int32 arithmetic that wraps like jnp's, floor division, the
// reasons' first-failure order and ties of the best row going to the later
// row. K = 1 serves the single-request case.
//
// Layout: chips [9, C, N] (rows valid, healthy, used, free, total, clock,
// bw, tflops, power), node axis last and contiguous, so the threads of a
// warp (one node each) read neighbouring addresses; nodes [4, N] (valid,
// in_slice, generation, external chips); dyn [4, N] (fresh, reserved,
// claimed, unused); host_ok [K, N]; reqs [K, 5]; out [K, 6, N] (rows
// feasible, reason, raw, final, best, claimable).
//
// Bound on this card. A few integer operations per chip element, so memory
// traffic bounds it: (9*C*N + 8*N + K*N + 5*K) * 4 bytes in and 6*K*N*4
// bytes out over 3.35 TB/s, 0.0019 ms at 8,192 nodes x 8 chips, K = 16.
// Three fleet-wide reductions sit between input and output (the six
// cluster maxima, raw min/max, the best row), so at the main path's shapes
// the floor is one launch plus three grid-wide barriers, ~10 us, not bytes;
// past that the issue rate of the per-(node, request, chip) integer work
// (six divisions per qualifying chip) sets the time.
//
// Design: ONE cooperative launch per call.
//   - A persistent grid (at most what the card holds at once, see
//     make_plan) of blocks of kTileNodes nodes x L request lanes; a warp is
//     32 nodes of one lane, and lane l serves requests l, l + L, ... Block b
//     owns tiles b, b + grid, ... and walks them.
//   - The first R tiles of a block are staged once into shared memory with
//     cp.async: the tile's [9*C] chip rows, its node, dynamics and
//     admission rows (18 KB + (7 + K) * 256 B at C = 8). Every request and
//     every phase reads them there, and per-(node, request) feasible and
//     raw stay beside them between phases: the inputs are read from device
//     memory once per call. A node's healthy and used chips, and each
//     request's qualifying chips, are bit masks (so C <= 32): phase 1
//     counts with popc and hands the qualifying mask to phase 2, which
//     scores only those chips. Tiles beyond R (fleets larger than the grid's
//     shared memory holds, ~100k nodes x 8 chips at K = 16) are read from
//     global memory in each phase and their feasible / raw re-read from the
//     output rows; the 50 MB L2 keeps those re-reads on chip up to ~170k
//     nodes x 8 chips.
//   - Phases are separated by cooperative_groups grid syncs: filter +
//     maxima | sync | raw scores + raw lo/hi | sync | final scores + best
//     key | sync | best row. No global atomics and no memsets: each block
//     reduces in shared memory and writes its partials unconditionally
//     (identities when it owns no real node) into the scratch; after each
//     sync every block reduces all blocks' partials itself. Nothing from an
//     earlier call can leak in, and each output row is written once.
//   - The grid is capped where the redundant reduction (grid x 6K partials
//     per block) would cost more than the work it spreads. Occupancy and the
//     shared-memory attribute are queried once and cached.
//   - The six normalizations divide by per-request constants (the cluster
//     maxima; the span in phase 3), so each block precomputes their
//     multiply-shift magic numbers once: floordiv_by gives floordiv's int32
//     result in eight integer instructions instead of ~25.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileNodes = 64;      // nodes per tile: two warps per lane
constexpr int kMaxLanes = 16;       // request lanes per block
constexpr int kMaxRequests = 128;   // SchedulerConfig.batch_requests bound
constexpr int kMaxChips = 32;       // chips per node: one bit each in a mask
constexpr int kScratchWords = 11;   // int32 scratch words per (block, request)
constexpr int kNodeRows = 7;        // staged rows per node: 4 static + 3 dynamic
constexpr int32_t kBig = 2147483647;
constexpr unsigned kFull = 0xffffffffu;

struct Weights {
  int32_t bw, clock, tflops, power, hbm_free, hbm_total, actual, allocate;
  int32_t protect;  // SLICE_PROTECT_TIER * slice_protect
};

struct Args {
  const int32_t* chips;
  const int32_t* nodes;
  const int32_t* dyn;
  const int32_t* host_ok;
  const int32_t* reqs;
  int32_t* out;
  unsigned long long* part_key;  // [grid, K] best key
  int32_t* part_max;             // [grid, K * 6] cluster maxima
  uint32_t* part_lohi;           // [grid, 3 * K] ~biased raw lo, biased hi, any
  int n, c, k;
  int tiles, resident;           // tiles in all; tiles staged per block
  Weights w;
};

// int32 arithmetic with jnp's wrap-around (signed overflow is undefined in
// C++, so it goes through uint32).
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
// jnp's // (floor), for b > 0; C's / truncates toward zero.
__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {
  int32_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
// Order-preserving map of int32 onto uint32.
__device__ __forceinline__ uint32_t bias(int32_t x) {
  return static_cast<uint32_t>(x) ^ 0x80000000u;
}
__device__ __forceinline__ int32_t unbias(uint32_t u) {
  return static_cast<int32_t>(u ^ 0x80000000u);
}

// A divisor m > 0 fixed for many divisions: Granlund and Montgomery's
// magic number for 32-bit unsigned division ("Division by invariant
// integers using multiplication", 1994, section 4), as libdivide's
// branch-free form computes it.
struct Divisor {
  uint32_t magic;
  uint32_t sh1, sh2;
};

__device__ __forceinline__ Divisor divisor(int32_t m) {
  const uint32_t d = static_cast<uint32_t>(m);
  const int l = d == 1 ? 0 : 32 - __clz(d - 1);  // ceil(log2 d)
  const uint32_t magic =
      static_cast<uint32_t>(((1ull << 32) * ((1ull << l) - d)) / d + 1);
  return Divisor{magic, static_cast<uint32_t>(min(l, 1)), static_cast<uint32_t>(max(l - 1, 0))};
}

// floordiv(a, m) for every int32 a: floor(a / m) = -1 - floor((-a - 1) / m)
// for a < 0, and -a - 1 = ~a, so one unsigned division of a ^ sign serves
// both signs.
__device__ __forceinline__ int32_t floordiv_by(int32_t a, Divisor d) {
  const uint32_t sign = static_cast<uint32_t>(a >> 31);
  const uint32_t n = static_cast<uint32_t>(a) ^ sign;
  const uint32_t t = __umulhi(n, d.magic);
  const uint32_t q = (t + ((n - t) >> d.sh1)) >> d.sh2;
  return static_cast<int32_t>(q ^ sign);
}

__device__ __forceinline__ int32_t norm100(int32_t x, Divisor m) {
  return floordiv_by(wmul(x, 100), m);
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Folds the maxima of the [grid, stride] partials' columns [0, s) into
// ``acc`` (shared, holding 0, every reduction's identity). Threads split the
// grid axis into groups so every thread has loads in flight; groups combine
// by shared-memory atomics.
template <typename T>
__device__ void reduce_partials(const T* part, int stride, int s, T* acc) {
  const int groups = max(1, static_cast<int>(blockDim.x) / s);
  const int grid = gridDim.x;
  for (int idx = threadIdx.x; idx < groups * s; idx += blockDim.x) {
    const int col = idx % s;
    T v = 0;
#pragma unroll 8
    for (int g = idx / s; g < grid; g += groups) v = max(v, part[g * stride + col]);
    atomicMax(acc + col, v);
  }
}

__device__ __forceinline__ void cp_async4(int32_t* smem, const int32_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// One thread's node in one of its block's tiles, and where that node's data
// lies: a shared-memory slot of [9*C + 7 + 3*K] rows x kTileNodes (chip
// rows, node rows, dynamics, admission, then feasible and raw per request)
// for a staged tile, else the input arrays and the output rows. kStaged
// makes the row stride a constant and lets the compiler see the slot is in
// shared memory.
template <bool kStaged>
struct Tile {
  int node;
  bool real;  // node < n (the last tile is ragged)
  int c;
  int stride;            // between rows of one array
  const int32_t* chips;  // chip(row, c) = chips[(row * C + c) * stride]
  const int32_t* nodes;  // static node row r: nodes[r * stride]
  const int32_t* dyn;    // dynamics row r: dyn[r * stride]
  const int32_t* host_ok;
  int32_t* feasible;     // request k: feasible[k * pair_stride]
  int32_t* raw;          // the qualifying-chip mask after phase 1, raw after 2
  int pair_stride;

  __device__ __forceinline__ int32_t chip(int row, int ch) const {
    return chips[(row * c + ch) * stride];
  }
};

// This thread's column of the w-th shared-memory slot.
__device__ __forceinline__ int32_t* slot_at(const Args& a, int w, int32_t* dsm) {
  return dsm + (w * (9 * a.c + kNodeRows + 3 * a.k) * kTileNodes) +
         static_cast<int>(threadIdx.x % kTileNodes);
}

template <bool kStaged>
__device__ __forceinline__ Tile<kStaged> tile_at(const Args& a, int w, int32_t* dsm) {
  const int node =
      (static_cast<int>(blockIdx.x) + w * static_cast<int>(gridDim.x)) * kTileNodes +
      static_cast<int>(threadIdx.x % kTileNodes);
  Tile<kStaged> t;
  t.node = node;
  t.real = node < a.n;
  t.c = a.c;
  if (kStaged) {
    int32_t* slot = slot_at(a, w, dsm);
    const int rows = 9 * a.c;
    t.stride = kTileNodes;
    t.chips = slot;
    t.nodes = slot + rows * kTileNodes;
    t.dyn = slot + (rows + 4) * kTileNodes;
    t.host_ok = slot + (rows + kNodeRows) * kTileNodes;
    t.feasible = slot + (rows + kNodeRows + a.k) * kTileNodes;
    t.raw = t.feasible + a.k * kTileNodes;
    t.pair_stride = kTileNodes;
  } else {
    t.stride = a.n;
    t.chips = a.chips + node;
    t.nodes = a.nodes + node;
    t.dyn = a.dyn + node;
    t.host_ok = a.host_ok + node;
    t.feasible = a.out + node;
    t.raw = a.out + 2 * a.n + node;
    t.pair_stride = 6 * a.n;
  }
  return t;
}

// Copies this thread's node column of a staged tile into its slot; lane l
// copies rows l, l + lanes, ...
__device__ __forceinline__ void stage_tile(const Args& a, int w, int32_t* dsm, int lane,
                                           int lanes) {
  const Tile<true> t = tile_at<true>(a, w, dsm);
  if (!t.real) return;
  int32_t* dst = slot_at(a, w, dsm);
  const int rows = 9 * a.c;
  for (int row = lane; row < rows + kNodeRows + a.k; row += lanes) {
    const int32_t* src = row < rows               ? a.chips + row * a.n
                         : row < rows + 4         ? a.nodes + (row - rows) * a.n
                         : row < rows + kNodeRows ? a.dyn + (row - rows - 4) * a.n
                                                  : a.host_ok + (row - rows - kNodeRows) * a.n;
    cp_async4(dst + row * kTileNodes, src + t.node);
  }
}

// Phase 1 for one tile: feasibility, reason and claimable per (node,
// request); the maxima of feasible nodes' qualifying chips into s_max. The
// healthy and used chips are bit masks (C <= 32), and each pair's
// qualifying chips (healthy, HBM and clock fit) go to phase 2 as a mask.
template <bool kStaged>
__device__ __forceinline__ void filter_tile(const Args& a, int w, int32_t* dsm, int lane,
                                            int lanes, const int32_t* s_req,
                                            int32_t* s_max) {
  const Tile<kStaged> t = tile_at<kStaged>(a, w, dsm);
  uint32_t healthy_m = 0, used_m = 0;
  int32_t ext = 0, reserved = 0, gen_rank = 0;
  bool node_valid = false, fresh = false;
  if (t.real) {
    for (int c = 0; c < a.c; ++c) {
      const bool healthy = (t.chip(0, c) != 0) & (t.chip(1, c) != 0);
      healthy_m |= static_cast<uint32_t>(healthy) << c;
      used_m |= static_cast<uint32_t>(t.chip(2, c) != 0) << c;
    }
    node_valid = t.nodes[0] != 0;
    gen_rank = t.nodes[2 * t.stride];
    ext = t.nodes[3 * t.stride];
    fresh = t.dyn[0] != 0;
    reserved = t.dyn[t.stride];
  }
  const int32_t healthy_n = __popc(healthy_m), used_n = __popc(healthy_m & used_m);
  for (int k = lane; k < a.k; k += lanes) {  // warp-uniform
    int32_t mx[6] = {0, 0, 0, 0, 0, 0};      // bw, clock, tflops, power, free, total
    if (t.real) {
      const int32_t* req = s_req + k * 5;
      const int32_t number = req[0], hbm = req[1], clk = req[2], gen = req[3];
      uint32_t hbm_m = 0, clock_m = 0, cand_m = 0;
#pragma unroll 4
      for (int c = 0; c < a.c; ++c) {
        const int32_t free = t.chip(3, c), total = t.chip(4, c), clock = t.chip(5, c);
        hbm_m |= static_cast<uint32_t>(free >= hbm) << c;
        clock_m |= static_cast<uint32_t>(clock >= clk) << c;
        cand_m |= static_cast<uint32_t>((clock >= clk) & (total >= hbm)) << c;
      }
      hbm_m &= healthy_m;
      clock_m &= healthy_m;
      const uint32_t qual_m = hbm_m & clock_m;
      const int32_t absorbable = max(wsub(used_n, ext), 0);
      const int32_t invisible = max(wsub(reserved, absorbable), 0);
      const int32_t stale_freed = max(wsub(absorbable, reserved), 0);
      const int32_t cand = max(wsub(__popc(cand_m & healthy_m & used_m), ext), 0);
      const int32_t freed = min(stale_freed, max(wsub(cand, reserved), 0));
      const int32_t avail = wsub(wadd(__popc(qual_m & ~used_m), freed), invisible);

      const bool host_ok = t.host_ok[k * t.stride] != 0;
      const bool fits_gen = gen_rank >= gen;
      const bool fits_chips = healthy_n >= number;
      const bool fits_hbm = hbm == 0 || wadd(__popc(hbm_m), freed) >= number;
      const bool fits_clock = clk == 0 || __popc(clock_m) >= number;
      const bool fits_reserved = avail >= number;
      const bool feasible = node_valid && host_ok && fresh && fits_gen && fits_chips &&
                            fits_hbm && fits_clock && fits_reserved;
      // First failing predicate: codes 1, 8, 2, 3, 4, 5, 6, 7 in this order.
      const int32_t reason = !node_valid ? 1 : !host_ok ? 8 : !fresh ? 2 : !fits_gen ? 3
                           : !fits_chips ? 4 : !fits_hbm ? 5 : !fits_clock ? 6
                           : !fits_reserved ? 7 : 0;
      int32_t* out = a.out + k * 6 * a.n;
      out[t.node] = feasible;
      out[a.n + t.node] = reason;
      out[5 * a.n + t.node] = max(avail, 0);
      if (kStaged) t.feasible[k * t.pair_stride] = feasible;
      t.raw[k * t.pair_stride] = static_cast<int32_t>(qual_m);
      if (feasible) {
        for (int c = 0; c < a.c; ++c) {
          if (!((qual_m >> c) & 1u)) continue;
          mx[0] = max(mx[0], t.chip(6, c));
          mx[1] = max(mx[1], t.chip(5, c));
          mx[2] = max(mx[2], t.chip(7, c));
          mx[3] = max(mx[3], t.chip(8, c));
          mx[4] = max(mx[4], t.chip(3, c));
          mx[5] = max(mx[5], t.chip(4, c));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int32_t v = warp_max(mx[j]);
      if ((threadIdx.x & 31) == 0 && v > 0) atomicMax(s_max + k * 6 + j, v);
    }
  }
}

// Phase 2 for one tile: the raw score of each feasible (node, request)
// against the cluster maxima; raw lo / hi / any into s_lohi, all three as
// maxima (lo complemented), so one reduction serves them.
template <bool kStaged>
__device__ __forceinline__ void score_tile(const Args& a, int w, int32_t* dsm, int lane,
                                           int lanes, const Divisor* s_div,
                                           uint32_t* s_lohi) {
  const Tile<kStaged> t = tile_at<kStaged>(a, w, dsm);
  const Weights& wt = a.w;
  int32_t actual = 0, allocate = 0;
  if (t.real) {
    int32_t free_sum = 0, total_sum = 0;
    for (int c = 0; c < a.c; ++c) {
      if (t.chip(0, c) == 0) continue;
      free_sum = wadd(free_sum, t.chip(3, c));
      total_sum = wadd(total_sum, t.chip(4, c));
    }
    const int32_t safe_total = max(total_sum, 1);
    actual = wmul(total_sum > 0 ? floordiv(wmul(free_sum, 100), safe_total) : 0, wt.actual);
    const int32_t headroom = max(wsub(total_sum, t.dyn[2 * t.stride]), 0);
    allocate =
        wmul(total_sum > 0 ? floordiv(wmul(headroom, 100), safe_total) : 0, wt.allocate);
  }
  for (int k = lane; k < a.k; k += lanes) {  // warp-uniform
    bool feasible = false;
    uint32_t lo = 0u, hi = 0u;
    if (t.real) {
      feasible = t.feasible[k * t.pair_stride] != 0;
      const uint32_t qual_m = static_cast<uint32_t>(t.raw[k * t.pair_stride]);
      int32_t raw = 0;
      if (feasible) {
        const Divisor* m = s_div + k * 6;  // bw, clock, tflops, power, free, total
        int32_t basic = 0;
        for (int c = 0; c < a.c; ++c) {
          if (!((qual_m >> c) & 1u)) continue;
          int32_t s = wmul(norm100(t.chip(6, c), m[0]), wt.bw);
          s = wadd(s, wmul(norm100(t.chip(5, c), m[1]), wt.clock));
          s = wadd(s, wmul(norm100(t.chip(7, c), m[2]), wt.tflops));
          s = wadd(s, wmul(norm100(t.chip(8, c), m[3]), wt.power));
          s = wadd(s, wmul(norm100(t.chip(3, c), m[4]), wt.hbm_free));
          s = wadd(s, wmul(norm100(t.chip(4, c), m[5]), wt.hbm_total));
          basic = wadd(basic, s);
        }
        raw = wadd(wadd(basic, actual), allocate);
        hi = bias(raw);
        lo = ~hi;
      }
      a.out[(k * 6 + 2) * a.n + t.node] = raw;
      if (kStaged) t.raw[k * t.pair_stride] = raw;
    }
    lo = warp_max(lo);
    hi = warp_max(hi);
    if (__any_sync(kFull, feasible) && (threadIdx.x & 31) == 0) {
      atomicMax(s_lohi + k, lo);
      atomicMax(s_lohi + a.k + k, hi);
      atomicMax(s_lohi + 2 * a.k + k, 1u);
    }
  }
}

// Phase 3 for one tile: normalization + slice-protect tier -> final; the
// best key (biased where(feasible, final, -1), row) into s_key, so ties go
// to the later row and negative scores order correctly.
template <bool kStaged>
__device__ __forceinline__ void finalize_tile(const Args& a, int w, int32_t* dsm, int lane,
                                              int lanes, const int32_t* s_req,
                                              const int32_t* s_lowest, const Divisor* s_span,
                                              unsigned long long* s_key) {
  const Tile<kStaged> t = tile_at<kStaged>(a, w, dsm);
  const bool in_slice = t.real && t.nodes[t.stride] != 0;
  for (int k = lane; k < a.k; k += lanes) {  // warp-uniform
    unsigned long long key = 0ull;
    if (t.real) {
      const bool feasible = t.feasible[k * t.pair_stride] != 0;
      int32_t final_score = 0;
      if (feasible) {
        const int32_t raw = t.raw[k * t.pair_stride];
        const int32_t normalized = floordiv_by(wmul(wsub(raw, s_lowest[k]), 100), s_span[k]);
        const bool protect = s_req[k * 5 + 4] == 0 && !in_slice;
        final_score = wadd(normalized, protect ? a.w.protect : 0);
      }
      a.out[(k * 6 + 3) * a.n + t.node] = final_score;
      key = (static_cast<unsigned long long>(bias(feasible ? final_score : -1)) << 32) |
            static_cast<unsigned long long>(t.node);
    }
    key = warp_max(key);
    if ((threadIdx.x & 31) == 0) atomicMax(s_key + k, key);
  }
}

// Runs a phase over the block's tiles: staged ones from shared memory, the
// rest from global memory.
#define FOR_EACH_TILE(phase, ...)                                   \
  for (int w = 0; w < owned; ++w) {                                 \
    if (w < a.resident)                                             \
      phase<true>(a, w, dsm, lane, lanes, __VA_ARGS__);             \
    else                                                            \
      phase<false>(a, w, dsm, lane, lanes, __VA_ARGS__);            \
  }

__global__ void __launch_bounds__(kTileNodes * kMaxLanes) fleet_eval_kernel(Args a) {
  extern __shared__ int32_t dsm[];  // ``resident`` slots, see Tile
  __shared__ unsigned long long s_key[kMaxRequests];
  __shared__ Divisor s_div[kMaxRequests * 6];
  __shared__ int32_t s_max[kMaxRequests * 6];
  __shared__ uint32_t s_lohi[kMaxRequests * 3];
  __shared__ int32_t s_req[kMaxRequests * 5];
  cg::grid_group grid = cg::this_grid();
  const int lanes = blockDim.x / kTileNodes;
  const int lane = threadIdx.x / kTileNodes;
  const int K = a.k;
  // Tiles this block walks: blockIdx.x, + gridDim.x, ... below a.tiles
  // (the plan makes the grid no larger than the tile count).
  const int owned =
      (a.tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;

  for (int w = 0; w < a.resident && w < owned; ++w) stage_tile(a, w, dsm, lane, lanes);
  for (int s = threadIdx.x; s < 5 * K; s += blockDim.x) s_req[s] = a.reqs[s];
  for (int s = threadIdx.x; s < 6 * K; s += blockDim.x) s_max[s] = 0;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 1. Filter + maxima.
  FOR_EACH_TILE(filter_tile, s_req, s_max);
  __syncthreads();
  for (int s = threadIdx.x; s < 6 * K; s += blockDim.x) {
    a.part_max[blockIdx.x * 6 * K + s] = s_max[s];
    s_max[s] = 0;
  }
  for (int s = threadIdx.x; s < 3 * K; s += blockDim.x) s_lohi[s] = 0u;
  grid.sync();
  reduce_partials(a.part_max, 6 * K, 6 * K, s_max);
  __syncthreads();
  // masked_max clamps to >= 1 (reference kernel_impl).
  for (int s = threadIdx.x; s < 6 * K; s += blockDim.x) s_div[s] = divisor(max(s_max[s], 1));
  __syncthreads();

  // 2. Raw scores + raw lo / hi.
  FOR_EACH_TILE(score_tile, s_div, s_lohi);
  __syncthreads();
  for (int s = threadIdx.x; s < 3 * K; s += blockDim.x) {
    a.part_lohi[blockIdx.x * 3 * K + s] = s_lohi[s];
    s_lohi[s] = 0u;
  }
  for (int s = threadIdx.x; s < K; s += blockDim.x) s_key[s] = 0ull;
  grid.sync();
  reduce_partials(a.part_lohi, 3 * K, 3 * K, s_lohi);
  __syncthreads();
  // Fillers outside both reductions' ranges (reference kernel_impl); the
  // maxima and their divisors are spent, so their slots hold lowest and
  // span.
  int32_t* s_lowest = s_max;
  Divisor* s_span = s_div;
  for (int s = threadIdx.x; s < K; s += blockDim.x) {
    const bool any = s_lohi[2 * K + s] != 0;
    int32_t lowest = any ? unbias(~s_lohi[s]) : kBig;
    const int32_t highest = any ? unbias(s_lohi[K + s]) : -kBig;
    if (highest == lowest) lowest = wsub(lowest, 1);
    s_lowest[s] = lowest;
    s_span[s] = divisor(max(wsub(highest, lowest), 1));
  }
  __syncthreads();

  // 3. Final scores + best key.
  FOR_EACH_TILE(finalize_tile, s_req, s_lowest, s_span, s_key);
  __syncthreads();
  for (int s = threadIdx.x; s < K; s += blockDim.x) {
    a.part_key[blockIdx.x * K + s] = s_key[s];
    s_key[s] = 0ull;
  }
  grid.sync();
  reduce_partials(a.part_key, K, K, s_key);
  __syncthreads();

  // 4. The best row, -1 when no row is feasible.
  for (int w = 0; w < owned; ++w) {
    const Tile<false> t = tile_at<false>(a, w, dsm);
    if (!t.real) continue;
    for (int k = lane; k < K; k += lanes) {
      const int32_t best =
          s_lohi[2 * K + k] != 0 ? static_cast<int32_t>(s_key[k] & 0xffffffffull) : -1;
      a.out[(k * 6 + 4) * a.n + t.node] = best;
    }
  }
}

#undef FOR_EACH_TILE

// --- host side: launch plan, cached per device ---

struct DeviceInfo {
  bool ready = false;
  int sms = 0;
  int smem_per_sm = 0;
  int reserved_per_block = 0;
  int static_smem = 0;
  int max_dynamic_smem = 0;
};

struct OccupancyEntry {
  int device, threads, smem, blocks;
};

constexpr int kMaxDevices = 16;
constexpr int kOccupancyCache = 64;

std::mutex g_mu;
DeviceInfo g_devices[kMaxDevices];
OccupancyEntry g_occupancy[kOccupancyCache];
int g_occupancy_n = 0;

// Device properties and the kernel's shared-memory ceiling, set once per
// device. Caller holds g_mu.
cudaError_t device_info(int device, const DeviceInfo** out) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_devices[device];
  if (!d.ready) {
    int optin = 0;
    cudaFuncAttributes attr{};
    cudaError_t e;
    if ((e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, device)) ||
        (e = cudaDeviceGetAttribute(&d.smem_per_sm,
                                    cudaDevAttrMaxSharedMemoryPerMultiprocessor, device)) ||
        (e = cudaDeviceGetAttribute(&d.reserved_per_block,
                                    cudaDevAttrReservedSharedMemoryPerBlock, device)) ||
        (e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    device)) ||
        (e = cudaFuncGetAttributes(&attr, fleet_eval_kernel)))
      return e;
    d.static_smem = static_cast<int>(attr.sharedSizeBytes);
    d.max_dynamic_smem = optin - d.static_smem;
    if ((e = cudaFuncSetAttribute(fleet_eval_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  d.max_dynamic_smem)))
      return e;
    d.ready = true;
  }
  *out = &d;
  return cudaSuccess;
}

// Blocks of ``threads`` and ``smem`` dynamic bytes one SM holds. Caller
// holds g_mu.
cudaError_t occupancy(int device, int threads, int smem, int* blocks) {
  for (int i = 0; i < g_occupancy_n; ++i) {
    const OccupancyEntry& e = g_occupancy[i];
    if (e.device == device && e.threads == threads && e.smem == smem) {
      *blocks = e.blocks;
      return cudaSuccess;
    }
  }
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fleet_eval_kernel, threads, smem);
  if (e) return e;
  if (g_occupancy_n < kOccupancyCache)
    g_occupancy[g_occupancy_n++] = OccupancyEntry{device, threads, smem, *blocks};
  return cudaSuccess;
}

struct Plan {
  int grid, threads, walk, resident, smem;
};

// The launch for (n, c, k) on the current device: a grid no larger than
// the card holds at once (cooperative), no larger than the redundant
// reductions afford (grid x 6K partials per block, budgeted at the card's
// SM count x 96), each block walking ceil(tiles / grid) tiles and staging
// as many of them in shared memory as its share of the SM allows.
cudaError_t make_plan(int n, int c, int k, Plan* p) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e) return e;
  std::lock_guard<std::mutex> lock(g_mu);
  const DeviceInfo* d = nullptr;
  if ((e = device_info(device, &d))) return e;
  // At least four lanes: the staging copies are issued by all of them.
  const int lanes = k < 4 ? 4 : k < kMaxLanes ? k : kMaxLanes;
  const int threads = kTileNodes * lanes;
  const int tiles = (n + kTileNodes - 1) / kTileNodes;
  const int budget = d->sms * 96 / (6 * k) > d->sms ? d->sms * 96 / (6 * k) : d->sms;
  const int want = tiles < budget ? tiles : budget;
  const long long slot = static_cast<long long>(9 * c + kNodeRows + 3 * k) * kTileNodes * 4;
  for (int per_sm = (want + d->sms - 1) / d->sms; per_sm >= 1; --per_sm) {
    int grid = want < per_sm * d->sms ? want : per_sm * d->sms;
    const int walk = (tiles + grid - 1) / grid;
    grid = (tiles + walk - 1) / walk;
    long long room = d->smem_per_sm / per_sm - d->reserved_per_block - d->static_smem;
    if (room > d->max_dynamic_smem) room = d->max_dynamic_smem;
    long long resident = room > 0 ? room / slot : 0;
    if (resident > walk) resident = walk;
    for (; resident >= 0; --resident) {  // the occupancy calculator decides
      const int smem = static_cast<int>(resident * slot);
      int blocks = 0;
      if ((e = occupancy(device, threads, smem, &blocks))) return e;
      if (blocks >= per_sm) {
        *p = Plan{grid, threads, walk, static_cast<int>(resident), smem};
        return cudaSuccess;
      }
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

// The shapes the kernel takes: chip masks of 32 bits, the shared-memory
// accumulators' request bound, and int offsets (9 * C * N, 6 * K * N).
bool supported(int n, int c, int k) {
  const long long cap = 2147483647LL;
  return n > 0 && c > 0 && c <= kMaxChips && k > 0 && k <= kMaxRequests &&
         9LL * c * n < cap && 6LL * k * n < cap;
}

// The launch on the current device (fleet_eval_launch's body).
cudaError_t launch(const int32_t* chips, const int32_t* nodes, const int32_t* dyn,
                   const int32_t* host_ok, const int32_t* reqs, int32_t* out,
                   int32_t* scratch, long long scratch_words, int n, int c, int k,
                   const int32_t* weights, cudaStream_t stream) {
  Plan p{};
  cudaError_t e = make_plan(n, c, k, &p);
  if (e) return e;
  const long long need = static_cast<long long>(kScratchWords) * p.grid * k;
  if (scratch_words < need) return cudaErrorInvalidValue;
  Args a{chips, nodes, dyn, host_ok, reqs, out,
         reinterpret_cast<unsigned long long*>(scratch),
         scratch + 2LL * p.grid * k,
         reinterpret_cast<uint32_t*>(scratch + 8LL * p.grid * k),
         n, c, k,
         (n + kTileNodes - 1) / kTileNodes, p.resident,
         Weights{weights[0], weights[1], weights[2], weights[3], weights[4],
                 weights[5], weights[6], weights[7], weights[8]}};
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fleet_eval_kernel),
                                  dim3(p.grid), dim3(p.threads), params,
                                  static_cast<size_t>(p.smem), stream);
  if (e) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The plan fleet_eval_launch uses for (n, c, k) on the current device:
// plan[0..4] = grid, threads per block, tiles per block, tiles staged in
// shared memory per block, dynamic shared memory bytes. Returns a CUDA
// error code.
int fleet_eval_plan(int n, int c, int k, int* plan) {
  if (!supported(n, c, k)) return cudaErrorInvalidValue;
  Plan p{};
  const cudaError_t e = make_plan(n, c, k, &p);
  if (e) return e;
  plan[0] = p.grid;
  plan[1] = p.threads;
  plan[2] = p.walk;
  plan[3] = p.resident;
  plan[4] = p.smem;
  return cudaSuccess;
}

// Enqueues the one cooperative launch on ``stream`` of ``device`` (made
// current for the call); returns its CUDA error code. ``scratch`` holds
// ``scratch_words`` int32 words, at least 11 * grid * k (any contents:
// every word read is first written in the same launch). ``weights`` is a
// host array: bw, clock, tflops, power, hbm_free, hbm_total, actual,
// allocate, slice-protect bonus.
int fleet_eval_launch(const int32_t* chips, const int32_t* nodes, const int32_t* dyn,
                      const int32_t* host_ok, const int32_t* reqs, int32_t* out,
                      int32_t* scratch, long long scratch_words, int n, int c, int k,
                      const int32_t* weights, int device, void* stream) {
  if (n <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  if (!supported(n, c, k)) return cudaErrorInvalidValue;
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e) return e;
  if (current != device && (e = cudaSetDevice(device))) return e;
  e = launch(chips, nodes, dyn, host_ok, reqs, out, scratch, scratch_words, n, c, k,
             weights, static_cast<cudaStream_t>(stream));
  if (current != device) cudaSetDevice(current);
  return e;
}

const char* fleet_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
