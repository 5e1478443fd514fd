// Joint fit scan over K stacked gang-member rows of one fleet evaluation,
// on Hopper.
//
// Replaces the reference package's block-plan scan:
//   yoda_tpu/ops/kernel.py::joint_fit_scan  (jax.lax.scan, jitted inside
//   yoda_tpu/ops/kernel.py::kernel_joint_plan with the burst evaluation)
// It computes yoda_tpu_torch/ops/kernel.py::joint_fit_scan exactly. Per row
// i, in order:
//   - at a group start, commit tent to sim iff the previous gang fit, then
//     restart tent from sim (so: gok ? sim = tent : tent = sim), gok = 1;
//   - ok[j] = feasible[i, j] & (claimable[i, j] - tent[j] >= chips[i])
//             & valid[i], in int32 that wraps like jnp's;
//   - pick = the FIRST index of the maximum of where(ok, score, -1) over
//     all N nodes (jnp.argmax), and any_ok = any(ok);
//   - tent[pick] += chips[i] iff any_ok & gok & valid[i]; picks[i] is pick
//     then, else -1;
//   - gok &= any_ok | !valid[i]; group_ok[i] = gok.
// After the last row sim = tent iff gok. Padding rows (valid = 0) never
// claim and never change gok.
//
// Inputs: packed [K, 6, N] int32, the fleet evaluation's output as it lies
// on the device (rows 0 feasible, 3 final score, 5 claimable are read;
// fleet_eval wrote it earlier on the same stream, so no host copy sits in
// between); chips, starts, valid [K] int32. Outputs: picks [K], group_ok
// [K], sim [N] int32, written where the caller says (the wrapper places
// them right after the [K, 6, N] rows, so one download fetches all).
//
// Bound on this card. Bytes: each of the 3 * K * N input words is read
// once and N + 2K words are written: 0.0019 ms at K = 64, N = 8,192 over
// 3.35 TB/s. But the scan is a dependent chain: row i's candidates depend
// on the chips row i - 1 claimed. So the time is K block-wide arg-max
// reductions back to back, each a pass over N nodes plus three barriers —
// a latency chain that no amount of bandwidth shortens; the bytes bound is
// far below what any sequential design reaches.
//
// Design: ONE block of up to 1024 threads walks the rows. The ledgers tent
// and sim ([N] int32 each) live in shared memory when 8 * N bytes fit under
// the opt-in ceiling (about 28,900 nodes on an H100), else tent lives in a
// global scratch the wrapper allocates and sim directly in the output (the
// 50 MB L2 keeps both on chip). Each row is one pass in which every thread
// scans its strided nodes (neighbouring threads read neighbouring
// addresses), keeps the best packed key ((score ^ sign) << 32 | ~index —
// unsigned maximum = highest score, then LOWEST index, the opposite tie
// rule from fleet_eval's best row, which takes the later row) and an any
// flag, reduces them by warp shuffles and across warps in shared memory,
// and thread 0 applies the claim. One block is enough for now: the main
// path's joint passes are K <= 256 rows over 8,192 nodes, so the scan costs
// tens to hundreds of microseconds against a host round trip of a
// millisecond, and a single block keeps tent/sim coherent without grid
// barriers. Spreading a row over a cluster of blocks (distributed shared
// memory, one arg-max per cluster) and warp-specialized prefetch of the
// next row are the later, faster design.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Shared memory beside the ledgers: per-warp keys and flags, the row's
// reduced any-flag (padded to keep the ledgers 16-byte aligned).
constexpr int kReduceBytes = kWarps * 8 + kWarps * 4 + 16;

struct Args {
  const int32_t* packed;  // [K, 6, N]
  const int32_t* chips;   // [K]
  const int32_t* starts;  // [K]
  const int32_t* valid;   // [K]
  int32_t* picks;         // [K]
  int32_t* group_ok;      // [K]
  int32_t* sim;           // [N] output
  int32_t* tent_global;   // [N] scratch, used when the ledgers do not fit
  int n, k, use_shared;
};

// (score, index) -> key whose unsigned maximum is the highest score and,
// among equal scores, the lowest index.
__device__ __forceinline__ unsigned long long pack_key(int32_t score, int index) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(score) ^ 0x80000000u) << 32) |
         static_cast<uint32_t>(~static_cast<uint32_t>(index));
}

__global__ void __launch_bounds__(kMaxThreads) joint_fit_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* warp_key = reinterpret_cast<unsigned long long*>(smem);
  int* warp_any = reinterpret_cast<int*>(smem + kWarps * 8);
  int* row_any = reinterpret_cast<int*>(smem + kWarps * 12);
  int32_t* ledgers = reinterpret_cast<int32_t*>(smem + kReduceBytes);
  const int n = a.n;
  int32_t* tent = a.use_shared ? ledgers : a.tent_global;
  int32_t* sim = a.use_shared ? ledgers + n : a.sim;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = (blockDim.x + 31) >> 5;

  for (int j = tid; j < n; j += blockDim.x) {
    tent[j] = 0;
    sim[j] = 0;
  }
  __syncthreads();
  bool gok = true;  // uniform: every thread applies the same updates
  const long long row_words = 6LL * n;
  for (int i = 0; i < a.k; ++i) {
    if (a.starts[i]) {
      // Commit the previous gang iff it fit, else restart from the
      // committed ledger.
      if (gok) {
        for (int j = tid; j < n; j += blockDim.x) sim[j] = tent[j];
      } else {
        for (int j = tid; j < n; j += blockDim.x) tent[j] = sim[j];
      }
      gok = true;
      __syncthreads();
    }
    if (!a.valid[i]) {
      if (tid == 0) {
        a.picks[i] = -1;
        a.group_ok[i] = gok;
      }
      continue;
    }
    const int32_t* feas = a.packed + i * row_words;
    const int32_t* score = feas + 3LL * n;
    const int32_t* claim = feas + 5LL * n;
    const int32_t need = a.chips[i];
    unsigned long long best = 0;
    int any = 0;
    for (int j = tid; j < n; j += blockDim.x) {
      // int32 difference that wraps, as the reference's jnp int32 does.
      const int32_t room = static_cast<int32_t>(static_cast<uint32_t>(claim[j]) -
                                                static_cast<uint32_t>(tent[j]));
      const bool ok = feas[j] != 0 && room >= need;
      const unsigned long long key = pack_key(ok ? score[j] : -1, j);
      best = key > best ? key : best;
      any |= ok;
    }
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(kFull, best, off);
      best = other > best ? other : best;
    }
    any = __any_sync(kFull, any);
    if (lane == 0) {
      warp_key[warp] = best;
      warp_any[warp] = any;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < warps ? warp_key[lane] : 0;
      any = lane < warps ? warp_any[lane] : 0;
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long other = __shfl_xor_sync(kFull, best, off);
        best = other > best ? other : best;
      }
      any = __any_sync(kFull, any);
      if (lane == 0) {
        *row_any = any;
        const int pick = static_cast<int>(~static_cast<uint32_t>(best));
        const bool take = any && gok;
        if (take) tent[pick] += need;
        a.picks[i] = take ? pick : -1;
        a.group_ok[i] = gok && any;
      }
    }
    __syncthreads();  // the claim and the row's verdict are visible to all
    gok = gok && *row_any;
  }
  if (gok) {
    for (int j = tid; j < n; j += blockDim.x) sim[j] = tent[j];
  }
  if (a.use_shared) {
    __syncthreads();
    for (int j = tid; j < n; j += blockDim.x) a.sim[j] = sim[j];
  }
}

std::mutex g_mu;
// Per device: the opt-in shared-memory ceiling, and the dynamic shared
// memory already granted to the kernel (cudaFuncSetAttribute is set only
// when a larger launch needs more).
constexpr int kMaxDevices = 64;
int g_optin[kMaxDevices];
int g_granted[kMaxDevices];

struct Plan {
  int threads, smem, use_shared;
};

cudaError_t make_plan(int device, int n, Plan* p) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mu);
  if (!g_optin[device]) {
    const cudaError_t e = cudaDeviceGetAttribute(
        &g_optin[device], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e) return e;
  }
  int threads = (n + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const long long ledgers = 8LL * n;
  const bool shared = kReduceBytes + ledgers <= g_optin[device];
  const int smem = kReduceBytes + (shared ? static_cast<int>(ledgers) : 0);
  if (smem > 48 * 1024 && smem > g_granted[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        joint_fit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e) return e;
    g_granted[device] = smem;
  }
  *p = Plan{threads, smem, shared ? 1 : 0};
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The launch joint_fit_launch makes for n nodes on ``device``: plan[0..2] =
// threads, dynamic shared memory bytes, 1 when tent/sim live in shared
// memory (else the caller passes an [n] int32 global scratch for tent).
// Returns a CUDA error code.
int joint_fit_plan(int n, int device, int* plan) {
  if (n <= 0) return cudaErrorInvalidValue;
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e) return e;
  if (current != device && (e = cudaSetDevice(device))) return e;
  Plan p{};
  e = make_plan(device, n, &p);
  if (current != device) cudaSetDevice(current);
  if (e) return e;
  plan[0] = p.threads;
  plan[1] = p.smem;
  plan[2] = p.use_shared;
  return cudaSuccess;
}

// Enqueues the one launch on ``stream`` of ``device`` (made current for the
// call); returns its CUDA error code. ``tent_scratch`` may be null when the
// plan keeps the ledgers in shared memory.
int joint_fit_launch(const int32_t* packed, const int32_t* chips, const int32_t* starts,
                     const int32_t* valid, int32_t* picks, int32_t* group_ok, int32_t* sim,
                     int32_t* tent_scratch, int n, int k, int device, void* stream) {
  if (n <= 0 || k <= 0 || 6LL * k * n > 2147483647LL) return cudaErrorInvalidValue;
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e) return e;
  if (current != device && (e = cudaSetDevice(device))) return e;
  Plan p{};
  e = make_plan(device, n, &p);
  if (!e && !p.use_shared && tent_scratch == nullptr) e = cudaErrorInvalidValue;
  if (!e) {
    const Args a{packed, chips, starts, valid, picks, group_ok, sim, tent_scratch,
                 n, k, p.use_shared};
    joint_fit_kernel<<<1, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(a);
    e = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return e;
}

const char* joint_fit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
