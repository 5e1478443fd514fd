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
// Design. The TPU kernel carried the six cluster maxima in SMEM across a
// sequential grid (phase 0 then phase 1). Hopper runs blocks in no order,
// so each cross-block reduction ends a launch instead, through atomics:
//   1. eval_nodes: one thread per (node, request) loops over C; writes
//      feasible / reason / claimable and atomicMax-es the six maxima of
//      the qualifying chips of feasible nodes into [K, 6].
//   2. score_nodes: raw score per node against those maxima; raw min/max
//      over feasible rows into [2, K] (sign-biased unsigned atomics).
//   3. finalize_nodes: normalization + slice-protect tier -> final; best
//      row by an unsigned 64-bit atomicMax over (biased final, row), so
//      ties go to the later row and negative scores order correctly.
//   4. broadcast_best: writes the best row into out row 4.
// Every block reduces in shared memory first, so each launch issues one
// atomic per block and value.
//
// Bound on this card. The work is a few integer operations per chip
// element; what bounds it is memory traffic: 9*C*N*4 bytes of chip grids,
// (4 + 4 + K)*N*4 bytes of node rows, dynamics and admission in, 6*K*N*4
// bytes out. Launches 1 and 2 each read the chip grids once per request;
// the re-reads of the K requests and of launch 2 hit the 50 MB L2 up to
// ~130k nodes of 8 chips, so DRAM sees roughly the bound's bytes. Fewer
// launches (grid-wide sync), a request loop inside the thread and CUDA
// graphs are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kBig = 2147483647;

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
  int32_t* maxima;            // [K, 6], zeroed
  uint32_t* lohi;             // [2, K]: biased raw min (0xFF..), max (0)
  int32_t* any;               // [K], zeroed
  unsigned long long* best;   // [K], zeroed
  int n, c, k;
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
__device__ __forceinline__ int32_t norm100(int32_t x, int32_t m) {
  return floordiv(wmul(x, 100), m);
}
// Order-preserving map of int32 onto uint32.
__device__ __forceinline__ uint32_t bias(int32_t x) {
  return static_cast<uint32_t>(x) ^ 0x80000000u;
}
__device__ __forceinline__ int32_t unbias(uint32_t u) {
  return static_cast<int32_t>(u ^ 0x80000000u);
}

__device__ __forceinline__ int32_t chip(const Args& a, int row, int c, int n) {
  return a.chips[(static_cast<size_t>(row) * a.c + c) * a.n + n];
}

struct MaxOp {
  template <typename T>
  __device__ T operator()(T x, T y) const { return x > y ? x : y; }
};
struct MinOp {
  template <typename T>
  __device__ T operator()(T x, T y) const { return x < y ? x : y; }
};

// Block-wide reduction; the result is valid in thread 0. ``smem`` holds
// one slot per warp and is free again when this returns.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T identity, T* smem) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (lane < static_cast<int>(blockDim.x >> 5)) ? smem[lane] : identity;
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kThreads) eval_nodes(Args a) {
  __shared__ int32_t smem[kThreads / 32];
  const int k = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int32_t* req = a.reqs + k * 5;
  const int32_t number = req[0], hbm = req[1], clk = req[2], gen = req[3];
  int32_t mx[6] = {0, 0, 0, 0, 0, 0};  // bw, clock, tflops, power, free, total
  if (n < a.n) {
    int32_t healthy_n = 0, hbm_n = 0, clock_n = 0, used_n = 0, cand_n = 0, avail_n = 0;
    for (int c = 0; c < a.c; ++c) {
      const bool healthy = chip(a, 0, c, n) != 0 && chip(a, 1, c, n) != 0;
      const bool used = chip(a, 2, c, n) != 0;
      const int32_t free = chip(a, 3, c, n), total = chip(a, 4, c, n);
      const int32_t clock = chip(a, 5, c, n);
      const bool hbm_ok = healthy && free >= hbm;
      const bool clock_ok = healthy && clock >= clk;
      healthy_n += healthy;
      hbm_n += hbm_ok;
      clock_n += clock_ok;
      used_n += healthy && used;
      cand_n += healthy && used && clock >= clk && total >= hbm;
      avail_n += hbm_ok && clock_ok && !used;
    }
    const int32_t ext = a.nodes[3 * a.n + n];
    const int32_t reserved = a.dyn[1 * a.n + n];
    const int32_t absorbable = max(wsub(used_n, ext), 0);
    const int32_t invisible = max(wsub(reserved, absorbable), 0);
    const int32_t stale_freed = max(wsub(absorbable, reserved), 0);
    const int32_t cand = max(wsub(cand_n, ext), 0);
    const int32_t freed = min(stale_freed, max(wsub(cand, reserved), 0));
    const int32_t avail = wsub(wadd(avail_n, freed), invisible);

    const bool node_valid = a.nodes[n] != 0;
    const bool host_ok = a.host_ok[static_cast<size_t>(k) * a.n + n] != 0;
    const bool fresh = a.dyn[n] != 0;
    const bool fits_gen = a.nodes[2 * a.n + n] >= gen;
    const bool fits_chips = healthy_n >= number;
    const bool fits_hbm = hbm == 0 || wadd(hbm_n, freed) >= number;
    const bool fits_clock = clk == 0 || clock_n >= number;
    const bool fits_reserved = avail >= number;
    const bool feasible = node_valid && host_ok && fresh && fits_gen && fits_chips &&
                          fits_hbm && fits_clock && fits_reserved;
    // First failing predicate: codes 1, 8, 2, 3, 4, 5, 6, 7 in this order.
    const int32_t reason = !node_valid ? 1 : !host_ok ? 8 : !fresh ? 2 : !fits_gen ? 3
                         : !fits_chips ? 4 : !fits_hbm ? 5 : !fits_clock ? 6
                         : !fits_reserved ? 7 : 0;
    int32_t* out = a.out + static_cast<size_t>(k) * 6 * a.n;
    out[n] = feasible;
    out[a.n + n] = reason;
    out[5 * a.n + n] = max(avail, 0);
    if (feasible) {
      for (int c = 0; c < a.c; ++c) {
        const bool healthy = chip(a, 0, c, n) != 0 && chip(a, 1, c, n) != 0;
        const int32_t free = chip(a, 3, c, n), clock = chip(a, 5, c, n);
        if (!(healthy && free >= hbm && clock >= clk)) continue;
        mx[0] = max(mx[0], chip(a, 6, c, n));
        mx[1] = max(mx[1], clock);
        mx[2] = max(mx[2], chip(a, 7, c, n));
        mx[3] = max(mx[3], chip(a, 8, c, n));
        mx[4] = max(mx[4], free);
        mx[5] = max(mx[5], chip(a, 4, c, n));
      }
    }
  }
  for (int j = 0; j < 6; ++j) {
    const int32_t v = block_reduce(mx[j], MaxOp(), 0, smem);
    if (threadIdx.x == 0 && v > 0) atomicMax(a.maxima + k * 6 + j, v);
  }
}

__global__ void __launch_bounds__(kThreads) score_nodes(Args a) {
  __shared__ uint32_t smem[kThreads / 32];
  const int k = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int32_t* req = a.reqs + k * 5;
  const int32_t hbm = req[1], clk = req[2];
  // masked_max clamps to >= 1 (reference kernel_impl).
  const int32_t* m = a.maxima + k * 6;
  const int32_t m_bw = max(m[0], 1), m_clock = max(m[1], 1), m_tflops = max(m[2], 1);
  const int32_t m_power = max(m[3], 1), m_free = max(m[4], 1), m_total = max(m[5], 1);
  const Weights& w = a.w;
  uint32_t lo = 0xffffffffu, hi = 0u;
  bool feasible = false;
  if (n < a.n) {
    int32_t* out = a.out + static_cast<size_t>(k) * 6 * a.n;
    feasible = out[n] != 0;
    int32_t basic = 0, free_sum = 0, total_sum = 0;
    for (int c = 0; c < a.c; ++c) {
      const bool valid = chip(a, 0, c, n) != 0;
      const bool healthy = valid && chip(a, 1, c, n) != 0;
      const int32_t free = chip(a, 3, c, n), total = chip(a, 4, c, n);
      const int32_t clock = chip(a, 5, c, n);
      if (valid) {
        free_sum = wadd(free_sum, free);
        total_sum = wadd(total_sum, total);
      }
      if (!(healthy && free >= hbm && clock >= clk)) continue;
      int32_t s = wmul(norm100(chip(a, 6, c, n), m_bw), w.bw);
      s = wadd(s, wmul(norm100(clock, m_clock), w.clock));
      s = wadd(s, wmul(norm100(chip(a, 7, c, n), m_tflops), w.tflops));
      s = wadd(s, wmul(norm100(chip(a, 8, c, n), m_power), w.power));
      s = wadd(s, wmul(norm100(free, m_free), w.hbm_free));
      s = wadd(s, wmul(norm100(total, m_total), w.hbm_total));
      basic = wadd(basic, s);
    }
    const int32_t safe_total = max(total_sum, 1);
    const int32_t actual =
        wmul(total_sum > 0 ? floordiv(wmul(free_sum, 100), safe_total) : 0, w.actual);
    const int32_t headroom = max(wsub(total_sum, a.dyn[2 * a.n + n]), 0);
    const int32_t allocate =
        wmul(total_sum > 0 ? floordiv(wmul(headroom, 100), safe_total) : 0, w.allocate);
    const int32_t raw = feasible ? wadd(wadd(basic, actual), allocate) : 0;
    out[2 * a.n + n] = raw;
    if (feasible) lo = hi = bias(raw);
  }
  lo = block_reduce(lo, MinOp(), 0xffffffffu, smem);
  hi = block_reduce(hi, MaxOp(), 0u, smem);
  const int any = __syncthreads_or(feasible);
  if (threadIdx.x == 0 && any) {
    atomicMin(a.lohi + k, lo);
    atomicMax(a.lohi + a.k + k, hi);
    atomicOr(a.any + k, 1);
  }
}

__global__ void __launch_bounds__(kThreads) finalize_nodes(Args a) {
  __shared__ unsigned long long smem[kThreads / 32];
  const int k = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool any = a.any[k] != 0;
  // Fillers outside both reductions' ranges (reference kernel_impl).
  int32_t lowest = any ? unbias(a.lohi[k]) : kBig;
  const int32_t highest = any ? unbias(a.lohi[a.k + k]) : -kBig;
  if (highest == lowest) lowest = wsub(lowest, 1);
  const int32_t span = max(wsub(highest, lowest), 1);
  const bool wants_topology = a.reqs[k * 5 + 4] != 0;
  unsigned long long key = 0ull;
  if (n < a.n) {
    int32_t* out = a.out + static_cast<size_t>(k) * 6 * a.n;
    const bool feasible = out[n] != 0;
    int32_t final_score = 0;
    if (feasible) {
      const int32_t normalized = floordiv(wmul(wsub(out[2 * a.n + n], lowest), 100), span);
      const bool protect = !wants_topology && a.nodes[a.n + n] == 0;
      final_score = wadd(normalized, protect ? a.w.protect : 0);
    }
    out[3 * a.n + n] = final_score;
    // argmax over every row of where(feasible, final, -1), ties -> later row.
    key = (static_cast<unsigned long long>(bias(feasible ? final_score : -1)) << 32) |
          static_cast<unsigned long long>(n);
  }
  key = block_reduce(key, MaxOp(), 0ull, smem);
  if (threadIdx.x == 0) atomicMax(a.best + k, key);
}

__global__ void __launch_bounds__(kThreads) broadcast_best(Args a) {
  const int k = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.n) return;
  const int32_t best =
      a.any[k] != 0 ? static_cast<int32_t>(a.best[k] & 0xffffffffull) : -1;
  a.out[(static_cast<size_t>(k) * 6 + 4) * a.n + n] = best;
}

}  // namespace

extern "C" {

// Enqueues the four launches on ``stream``; returns cudaGetLastError().
// ``weights`` is a host array: bw, clock, tflops, power, hbm_free,
// hbm_total, actual, allocate, slice-protect bonus.
int fleet_eval_launch(const int32_t* chips, const int32_t* nodes, const int32_t* dyn,
                      const int32_t* host_ok, const int32_t* reqs, int32_t* out,
                      int32_t* maxima, uint32_t* lohi, int32_t* any,
                      unsigned long long* best, int n, int c, int k,
                      const int32_t* weights, void* stream) {
  if (n <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{chips, nodes, dyn, host_ok, reqs, out, maxima, lohi, any, best, n, c, k,
         Weights{weights[0], weights[1], weights[2], weights[3], weights[4],
                 weights[5], weights[6], weights[7], weights[8]}};
  cudaMemsetAsync(maxima, 0, sizeof(int32_t) * 6 * k, s);
  cudaMemsetAsync(lohi, 0xff, sizeof(uint32_t) * k, s);
  cudaMemsetAsync(lohi + k, 0, sizeof(uint32_t) * k, s);
  cudaMemsetAsync(any, 0, sizeof(int32_t) * k, s);
  cudaMemsetAsync(best, 0, sizeof(unsigned long long) * k, s);
  const dim3 grid((n + kThreads - 1) / kThreads, k);
  eval_nodes<<<grid, kThreads, 0, s>>>(a);
  score_nodes<<<grid, kThreads, 0, s>>>(a);
  finalize_nodes<<<grid, kThreads, 0, s>>>(a);
  broadcast_best<<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* fleet_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
