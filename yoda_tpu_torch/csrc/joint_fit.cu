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
// on the chips row i - 1 claimed. So the time is K arg-maxes over N nodes
// back to back, and each costs at least the latency of one reduction and
// one exchange between the SMs that hold the nodes — a latency chain that
// no amount of bandwidth shortens.
//
// The first design (one block of up to 1,024 threads) ran a row in 3.4 us
// at 8,192 nodes on an H100 80GB HBM3 at 700 W: one SM's loads, issued
// inside the chain behind each feasibility test, at ~28 GB/s; its ledgers
// fell to global memory past ~28,900 nodes (36.6 us a row at 65,536). This
// design takes each cause away:
//
// - One thread-block cluster of B blocks walks the rows (B = 16 where the
//   occupancy API admits a 16-block cluster at the plan's shared memory,
//   else 8; fewer for small fleets, down to 1, one block per 256 nodes; no
//   cluster admitted: the launch fails). Block b owns the contiguous node
//   slice [b * S, (b + 1) * S), S a multiple of 4 words, and holds that
//   slice's tent and sim ledgers in its own shared memory. A consumer
//   thread owns fixed words of the slice and is the only thread that reads
//   or writes their ledger entries (scan, claim, group-start commit and
//   restore), so the ledgers need no barrier at all.
// - Rows stream in ahead of the chain. A producer warp keeps the next rows'
//   three slices (feasible, score, claimable) in flight into a ring of
//   shared-memory stages with cp.async.bulk, each stage completing on an
//   mbarrier (the bytes plus the producer lanes' arrivals); the consumer
//   warps read no global memory inside the chain. A slice longer than
//   kMaxChunk words streams as several chunks, one stage each. A stage is
//   released (an "empty" mbarrier, one arrival per consumer warp) once
//   every consumer warp is done with it. Padding rows take no stage:
//   producer and consumers skip them alike, from valid[i].
// - Bulk copies need 16-byte-aligned addresses and sizes, and a row of
//   [K, 6, N] starts at word (6i + r) * N, misaligned for most N. So each
//   chunk lands in its stage shifted by m = (its global word address mod
//   4) words, which keeps global and shared addresses congruent: the
//   ragged head and tail (< 4 words each) are plain loads by producer
//   lanes, the aligned body one bulk copy. When every row is aligned (N a
//   multiple of 4 and a 16-byte-aligned buffer: the main path), threads
//   own groups of 4 words and read them with 128-bit loads.
// - One exchange per row across the cluster, with no barrier of the whole
//   block or cluster inside the chain. Each consumer warp reduces its words
//   to one (packed key, any-flag) pair (two 32-bit redux.sync and a vote),
//   and lane r stores it into block r's shared memory with st.async, whose
//   16 bytes complete the transaction that block's exchange mbarrier
//   expects (warp 0 of each block arrives on its own barrier with the
//   expected B * W * 16 bytes). No fence and no remote arrival sits on the
//   chain, where a plain store followed by a release arrival on the peer's
//   barrier at cluster scope would pay for that fence on every row.
//   Every warp of every block waits on its own barrier and merges the
//   B * W pairs itself, so the pick, the any-flag and the gang verdict are
//   the same everywhere without a second exchange. Slots and barriers are
//   double-buffered by the parity of the valid-row count: warp w of a
//   block writes row v + 2's pair into a peer only after its own barrier
//   saw row v + 1's pairs of every warp of every block, each sent after
//   that warp had read row v's slots.
// - The packed key is unchanged: (score ^ sign) << 32 | ~index, whose
//   unsigned maximum is the highest score and then the LOWEST index (the
//   opposite tie rule from fleet_eval's best row, which takes the later
//   row). Every real node takes part, as pack_key(-1, j) when not ok,
//   exactly as argmax over where(ok, score, -1) sees it.
//
// The design departs from a plain cluster.sync() per row on purpose: a
// cluster barrier counts every thread of every block, so the producer warp
// running ahead on its own loop would have to join each row's barrier, and
// a whole-block barrier would put every warp on each row's chain. Cluster
// barriers run only twice: after the mbarriers are initialised and before
// any block exits (no block may leave while a peer can still write into
// its shared memory).
//
// Past the ledger ceiling (the slice ledgers plus a ring of one row and
// one chunk ahead no longer fit: past 131,072 nodes at B = 16, 65,536 at
// B = 8), tent lives in a global scratch the wrapper allocates and sim
// directly in the output; each word is still read and written by its owner
// thread only, and the ring takes the whole shared memory. The kernel is
// compiled for both places (kShared), so shared-memory ledgers are read by
// shared-memory instructions.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <mutex>

namespace {

constexpr int kMaxBlocks = 16;     // cluster size (non-portable past 8)
constexpr int kMaxWarps = 8;       // consumer warps per block
constexpr int kMaxStages = 8;      // ring stages
constexpr int kMaxChunk = 4096;    // words of one row slice per stage
constexpr int kNodesPerBlock = 256;  // a block per this many nodes, at least
constexpr int kNodesPerWarp = 128;   // a consumer warp per this many chunk words
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory: barriers and exchange slots, then the ledgers
// (when shared), then the ring. Offsets in bytes, 16-aligned.
constexpr int kFullBarOff = 0;                          // u64 [kMaxStages]
constexpr int kEmptyBarOff = kFullBarOff + 8 * kMaxStages;  // u64 [kMaxStages]
constexpr int kExchBarOff = kEmptyBarOff + 8 * kMaxStages;  // u64 [2]
// Exchange slots: uint4 {key low, key high, any, 0} [2][kMaxBlocks * kMaxWarps].
constexpr int kSlotOff = kExchBarOff + 16;
constexpr int kHeaderBytes = kSlotOff + 16 * 2 * kMaxBlocks * kMaxWarps;
static_assert(kHeaderBytes % 16 == 0, "ledgers and ring must stay 16-byte aligned");

struct Args {
  const int32_t* packed;  // [K, 6, N]
  const int32_t* chips;   // [K]
  const int32_t* starts;  // [K]
  const int32_t* valid;   // [K]
  int32_t* picks;         // [K]
  int32_t* group_ok;      // [K]
  int32_t* sim;           // [N] output
  int32_t* tent_global;   // [N] scratch, used when the ledgers do not fit
  int n, k;
  int slice;    // S: nodes per block, a multiple of 4
  int chunk;    // words of a row slice per stage, a multiple of 4
  int chunks;   // stages per row: ceil(S / chunk)
  int stages;   // ring depth
  int warps;    // consumer warps, a power of 2
  int vector;   // every row 16-byte aligned: 128-bit shared loads, 4 nodes a group
};

// (score, index) -> key whose unsigned maximum is the highest score and,
// among equal scores, the lowest index.
__device__ __forceinline__ unsigned long long pack_key(int32_t score, int index) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(score) ^ 0x80000000u) << 32) |
         static_cast<uint32_t>(~static_cast<uint32_t>(index));
}

// Row of [6, N] that stage row q holds: 0 feasible, 3 final score, 5
// claimable.
__device__ __forceinline__ int packed_row(int q) { return q == 0 ? 0 : 2 * q + 1; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// A wait that spins this long traps (a CUDA error at the caller's next
// synchronisation) instead of hanging the card: no barrier of a correct
// scan waits more than microseconds.
constexpr unsigned long long kStallNs = 5000000000ULL;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for the completion of the barrier's phase of parity ``parity``,
// acquiring at CTA scope. That covers the exchange barrier too: peers'
// asynchronous stores complete its transaction in this block's own shared
// memory, as a peer's multicast bulk copy would.
__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
      "selp.u32 %0, 1, 0, p; }"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  const unsigned long long start = now_ns();
  while (!bar_try(bar, parity)) {
    if (now_ns() - start > kStallNs) __trap();
  }
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The address of the same shared-memory word in block ``rank`` of the
// cluster.
__device__ __forceinline__ uint32_t map_to(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

// Stores one warp's (key, any) pair at a peer's slot address as an
// asynchronous store that completes 16 bytes of the transaction the peer's
// barrier expects: no fence, no arrival.
__device__ __forceinline__ void send_pair(uint32_t remote_slot, uint32_t remote_bar,
                                          unsigned long long key, uint32_t any) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];" ::
          "r"(remote_slot),
      "r"(static_cast<uint32_t>(key)), "r"(static_cast<uint32_t>(key >> 32)), "r"(any), "r"(0u),
      "r"(remote_bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The warp's largest key, in every lane: two 32-bit reductions (the high
// words, then the low words of the lanes that hold the top high word).
__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  const uint32_t high = static_cast<uint32_t>(v >> 32);
  const uint32_t top = __reduce_max_sync(kFull, high);
  const uint32_t low = __reduce_max_sync(kFull, high == top ? static_cast<uint32_t>(v) : 0u);
  return (static_cast<unsigned long long>(top) << 32) | low;
}

__device__ __forceinline__ unsigned long long larger(unsigned long long x, unsigned long long y) {
  return x > y ? x : y;
}

// Node j's key for a row demanding ``need`` chips when ``held`` are
// already claimed on it, and whether it is ok (an int32 difference that
// wraps, as the reference's jnp int32 does).
__device__ __forceinline__ unsigned long long node_key(int32_t feasible, int32_t score,
                                                       int32_t claim, int32_t held, int32_t need,
                                                       int j, bool& ok) {
  const int32_t room =
      static_cast<int32_t>(static_cast<uint32_t>(claim) - static_cast<uint32_t>(held));
  ok = feasible != 0 && room >= need;
  return pack_key(ok ? score : -1, j);
}

// One thread's part of a row: its largest key and whether any node is ok.
struct Partial {
  unsigned long long best = 0;
  bool ok = false;

  __device__ __forceinline__ void add(int32_t feasible, int32_t score, int32_t claim,
                                      int32_t held, int32_t need, int j) {
    bool node_ok;
    best = larger(best, node_key(feasible, score, claim, held, need, j, node_ok));
    ok |= node_ok;
  }
};

// Word misalignment of a global int32 address (0..3): where its chunk
// starts inside a stage's row buffer.
__device__ __forceinline__ int shift_of(const int32_t* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// kShared: the tent/sim ledgers live in shared memory (the plan's
// shared_ledgers). A compile-time choice, so every ledger access compiles
// to a shared-memory instruction rather than a generic one.
template <bool kShared>
__global__ void __launch_bounds__((kMaxWarps + 1) * 32, 1) joint_fit_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int consumers = a.warps * 32;
  const uint32_t rank = cluster_rank();
  const uint32_t blocks = gridDim.x;  // one cluster: the grid
  const int n = a.n;
  const int lo = static_cast<int>(rank) * a.slice;
  const int len = max(0, min(a.slice, n - lo));  // nodes this block owns
  const int row_words = a.chunk + 4;             // a stage row buffer, with the shift
  const uint32_t full_bar = smem_addr(smem + kFullBarOff);
  const uint32_t empty_bar = smem_addr(smem + kEmptyBarOff);
  const uint32_t exch_bar = smem_addr(smem + kExchBarOff);
  const uint4* slots = reinterpret_cast<const uint4*>(smem + kSlotOff);
  unsigned char* after_header = smem + kHeaderBytes;
  int32_t* tent;
  int32_t* sim;
  int32_t* ring;
  if constexpr (kShared) {
    tent = reinterpret_cast<int32_t*>(after_header);
    sim = tent + a.slice;
    ring = sim + a.slice;
  } else {
    tent = a.tent_global + lo;
    sim = a.sim + lo;
    ring = reinterpret_cast<int32_t*>(after_header);
  }
  const long long row_stride = static_cast<long long>(n);

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      bar_init(full_bar + 8 * s, 32);           // the producer lanes (one with the bytes)
      bar_init(empty_bar + 8 * s, a.warps);     // one per consumer warp
    }
    bar_init(exch_bar, 1);  // warp 0's expect-tx; the pairs' bytes complete it
    bar_init(exch_bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // every block's barriers exist before any peer arrives

  if (warp == a.warps) {
    // Producer warp: stream each valid row's three slices, chunk by chunk.
    int stage = 0;
    uint32_t phase = 0;
    for (int i = 0; i < a.k; ++i) {
      if (!a.valid[i]) continue;
      const int32_t* row = a.packed + 6LL * i * row_stride + lo;
      for (int c = 0; c < a.chunks; ++c) {
        const int off = c * a.chunk;
        const int clen = max(0, min(a.chunk, len - off));
        bar_wait(empty_bar + 8 * stage, phase ^ 1);
        int32_t* buf = ring + stage * 3 * row_words;
        uint32_t body_bytes = 0;
        // Lanes 6q .. 6q + 5 move row q's ragged head and tail words.
        for (int q = 0; q < 3; ++q) {
          const int32_t* src = row + packed_row(q) * row_stride + off;
          const int m = shift_of(src);
          const int head = min((4 - m) & 3, clen);
          const int body = (clen - head) & ~3;
          body_bytes += 4u * body;
          const int j = lane - 6 * q;
          if (j >= 0 && j < 6) {
            const int o = j < 3 ? j : head + body + (j - 3);
            if ((j < 3 && o < head) || (j >= 3 && o < clen)) buf[q * row_words + m + o] = src[o];
          }
        }
        __syncwarp();
        if (lane == 0) {
          bar_arrive_expect(full_bar + 8 * stage, body_bytes);
          for (int q = 0; q < 3; ++q) {
            const int32_t* src = row + packed_row(q) * row_stride + off;
            const int m = shift_of(src);
            const int head = min((4 - m) & 3, clen);
            const int body = (clen - head) & ~3;
            if (body > 0) {
              bulk_load(smem_addr(buf + q * row_words + m + head), src + head, 4u * body,
                        full_bar + 8 * stage);
            }
          }
        } else {
          bar_arrive(full_bar + 8 * stage);
        }
        if (++stage == a.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // Consumer warps. Thread tid owns the slice's words in groups of G
    // (4 when every row is 16-byte aligned, a.vector, else 1): group q =
    // l / G for q = tid (mod consumers). It alone reads and writes their
    // ledger entries. Chunk edges (multiples of G * consumers when a row
    // takes several chunks) keep the same owner for a word in every pass.
    const int g_shift = a.vector ? 2 : 0;
    const int group = 1 << g_shift;
    auto for_own = [&](auto&& f) {
      for (int q = tid; (q << g_shift) < len; q += consumers) {
        for (int t = 0; t < group; ++t) {
          const int l = (q << g_shift) + t;
          if (l < len) f(l);
        }
      }
    };
    // Whole-ledger passes (init, commit, restore): 16 bytes a step when both
    // ledgers are in shared memory and the groups are 4 words.
    const bool wide = kShared && a.vector;
    auto copy_own = [&](int32_t* dst, const int32_t* src) {
      if (wide) {
        for (int o = 4 * tid; o < len; o += 4 * consumers) {
          *reinterpret_cast<int4*>(dst + o) = *reinterpret_cast<const int4*>(src + o);
        }
      } else {
        for_own([&](int l) { dst[l] = src[l]; });
      }
    };
    for_own([&](int l) { tent[l] = 0; });
    copy_own(sim, tent);
    bool gok = true;  // uniform across the cluster: every block merges alike
    int stage = 0;  // the ring's next stage to arrive, and its phase
    uint32_t phase = 0;
    auto take_stage = [&]() {
      bar_wait(full_bar + 8 * stage, phase);
      const int taken = stage;
      if (++stage == a.stages) {
        stage = 0;
        phase ^= 1;
      }
      return taken;
    };
    auto release_stage = [&](int st) {
      __syncwarp();
      if (lane == 0) bar_arrive(empty_bar + 8 * st);  // this warp is done with it
    };
    // Where row r's chunk lies in stage st: its feasible, score and
    // claimable words, each at its shift.
    struct RowView {
      const int32_t *feas, *score, *claim;
    };
    auto view = [&](int r, int st) {
      const int32_t* row = a.packed + 6LL * r * row_stride + lo;
      const int32_t* buf = ring + st * 3 * row_words;
      return RowView{buf + shift_of(row), buf + row_words + shift_of(row + 3 * row_stride),
                     buf + 2 * row_words + shift_of(row + 5 * row_stride)};
    };
    // One chunk of a row over this thread's words.
    auto scan_chunk = [&](const RowView& rv, int off, int clen, int32_t need_r, Partial& part) {
      const int32_t* feas = rv.feas;
      const int32_t* score = rv.score;
      const int32_t* claim = rv.claim;
      const int32_t* held = tent + off;
      const int base = lo + off;
      if (a.vector) {  // every shift is 0 and clen a multiple of 4
        for (int o = 4 * tid; o < clen; o += 4 * consumers) {
          const int4 f = *reinterpret_cast<const int4*>(feas + o);
          const int4 sc = *reinterpret_cast<const int4*>(score + o);
          const int4 cl = *reinterpret_cast<const int4*>(claim + o);
          const int4 h = *reinterpret_cast<const int4*>(held + o);
          part.add(f.x, sc.x, cl.x, h.x, need_r, base + o);
          part.add(f.y, sc.y, cl.y, h.y, need_r, base + o + 1);
          part.add(f.z, sc.z, cl.z, h.z, need_r, base + o + 2);
          part.add(f.w, sc.w, cl.w, h.w, need_r, base + o + 3);
        }
      } else {
        for (int o = tid; o < clen; o += consumers) {
          part.add(feas[o], score[o], claim[o], held[o], need_r, base + o);
        }
      }
    };
    uint32_t v = 0;  // valid rows so far: the exchange's slot and phase
    const int pairs = static_cast<int>(blocks) * a.warps;
    // Lane r sends to block r: its slots and exchange barriers, mapped once.
    const bool sender = lane < static_cast<int>(blocks);
    const uint32_t peer_slots = sender ? map_to(smem_addr(slots), lane) : 0;
    const uint32_t peer_bar = sender ? map_to(exch_bar, lane) : 0;
    const uint32_t own_slot = 16u * (rank * a.warps + warp);
    // Row i's side inputs, loaded one row ahead, off the chain.
    int next_start = a.starts[0], next_valid = a.valid[0];
    int32_t next_chips = a.chips[0];
    for (int i = 0; i < a.k; ++i) {
      const int start = next_start, valid = next_valid;
      const int32_t need = next_chips;
      if (i + 1 < a.k) {
        next_start = __ldg(a.starts + i + 1);
        next_valid = __ldg(a.valid + i + 1);
        next_chips = __ldg(a.chips + i + 1);
      }
      if (start) {
        // Commit the previous gang iff it fit, else restart from the
        // committed ledger (own words only).
        if (gok) {
          copy_own(sim, tent);
        } else {
          copy_own(tent, sim);
        }
        gok = true;
      }
      if (!valid) {
        if (rank == 0 && tid == 0) {
          a.picks[i] = -1;
          a.group_ok[i] = gok;
        }
        continue;
      }
      Partial cur;
      for (int c = 0; c < a.chunks; ++c) {
        const int off = c * a.chunk;
        const int st = take_stage();
        scan_chunk(view(i, st), off, min(a.chunk, len - off), need, cur);
        release_stage(st);
      }
      unsigned long long best = warp_max(cur.best);
      int any = __any_sync(kFull, cur.ok);
      // Exchange: every warp sends its pair to every block of the cluster
      // (lane r to block r), then merges the B * W pairs it received.
      const uint32_t par = v & 1;
      const uint32_t bar = exch_bar + 8 * par;
      const uint4* my_slots = slots + par * kMaxBlocks * kMaxWarps;
      if (warp == 0 && lane == 0) bar_arrive_expect(bar, 16u * pairs);
      if (sender) {
        send_pair(peer_slots + 16u * par * kMaxBlocks * kMaxWarps + own_slot, peer_bar + 8 * par,
                  best, any);
      }
      bar_wait(bar, (v >> 1) & 1);
      best = 0;
      any = 0;
      for (int e = lane; e < pairs; e += 32) {
        const uint4 pair = my_slots[e];
        best = larger(best, (static_cast<unsigned long long>(pair.y) << 32) | pair.x);
        any |= pair.z;
      }
      best = warp_max(best);
      any = __any_sync(kFull, any);
      const int pick = static_cast<int>(~static_cast<uint32_t>(best));
      const bool take = any && gok;
      const int local = pick - lo;
      if (take && local >= 0 && local < len && ((local >> g_shift) & (consumers - 1)) == tid) {
        tent[local] =
            static_cast<int32_t>(static_cast<uint32_t>(tent[local]) + static_cast<uint32_t>(need));
      }
      if (rank == 0 && tid == 0) {
        a.picks[i] = take ? pick : -1;
        a.group_ok[i] = take;  // gok && any
      }
      gok = take;
      ++v;
    }
    for_own([&](int l) {
      const int32_t final_word = gok ? tent[l] : sim[l];
      if constexpr (kShared) {
        a.sim[lo + l] = final_word;
      } else {
        sim[l] = final_word;
      }
    });
  }
  __syncwarp();
  cluster_sync();  // no block leaves while a peer may still write into it
}

std::mutex g_mu;
constexpr int kMaxDevices = 64;
// Per device: the opt-in shared-memory ceiling (0 until read), whether the
// kernel's attributes are set, and the last plan made (plans depend on n
// only, and the launch asks for one each call).
int g_optin[kMaxDevices];
bool g_attrs[kMaxDevices];

struct Plan {
  int blocks, threads, stages, smem, shared_ledgers, slice, chunk, chunks, warps;
};
int g_last_n[kMaxDevices];
Plan g_last_plan[kMaxDevices];

int round4(long long x) { return static_cast<int>((x + 3) / 4 * 4); }

// The layout for ``blocks`` blocks over n nodes, within ``optin`` bytes.
Plan layout(int n, int blocks, int optin) {
  Plan p{};
  p.blocks = blocks;
  p.slice = round4((n + blocks - 1) / blocks);
  p.chunk = p.slice < kMaxChunk ? p.slice : kMaxChunk;
  p.chunks = (p.slice + p.chunk - 1) / p.chunk;
  p.warps = 1;  // a power of 2: word owners are a mask
  while (p.warps < kMaxWarps && p.warps * kNodesPerWarp < p.chunk) p.warps *= 2;
  p.threads = (p.warps + 1) * 32;
  const long long stage_bytes = 3LL * (p.chunk + 4) * 4;
  const long long ledgers = 8LL * p.slice;
  // Shared ledgers when they fit beside a ring of one row and one chunk.
  const int least = p.chunks + 1 < kMaxStages ? p.chunks + 1 : kMaxStages;
  p.shared_ledgers = kHeaderBytes + ledgers + least * stage_bytes <= optin;
  const long long room = optin - kHeaderBytes - (p.shared_ledgers ? ledgers : 0);
  long long stages = room / stage_bytes;
  if (stages > kMaxStages) stages = kMaxStages;
  p.stages = static_cast<int>(stages);
  p.smem = static_cast<int>(kHeaderBytes + (p.shared_ledgers ? ledgers : 0) +
                            stages * stage_bytes);
  return p;
}

using Kernel = void (*)(Args);
Kernel kernel_for(const Plan& p) {
  return p.shared_ledgers ? joint_fit_kernel<true> : joint_fit_kernel<false>;
}

// Whether the card can run one cluster of this plan.
bool admitted(const Plan& p) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(p.blocks);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kernel_for(p), &cfg);
  if (e) {
    cudaGetLastError();  // a refused size is an answer, not a sticky error
    return false;
  }
  return clusters > 0;
}

cudaError_t make_plan(int device, int n, Plan* p) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_last_n[device] == n) {
    *p = g_last_plan[device];
    return cudaSuccess;
  }
  if (!g_optin[device]) {
    const cudaError_t e = cudaDeviceGetAttribute(
        &g_optin[device], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e) return e;
  }
  if (!g_attrs[device]) {
    for (Kernel kernel : {joint_fit_kernel<true>, joint_fit_kernel<false>}) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g_optin[device]);
      if (!e) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e) return e;
    }
    g_attrs[device] = true;
  }
  int blocks = 1;
  while (blocks < kMaxBlocks && 2LL * blocks * kNodesPerBlock <= n) blocks *= 2;
  Plan plan = layout(n, blocks, g_optin[device]);
  bool ok = plan.stages > 0 && admitted(plan);
  if (!ok && blocks == kMaxBlocks) {
    plan = layout(n, blocks / 2, g_optin[device]);
    ok = plan.stages > 0 && admitted(plan);
  }
  if (!ok) return cudaErrorInvalidConfiguration;
  g_last_n[device] = n;
  g_last_plan[device] = plan;
  *p = plan;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The launch joint_fit_launch makes for n nodes on ``device``: plan[0..7] =
// cluster blocks, threads per block (consumer warps + one producer warp),
// ring stages, dynamic shared memory bytes per block, 1 when the tent/sim
// ledgers live in shared memory (else the caller passes an [n] int32 global
// scratch for tent), nodes per block's slice, words per stage chunk, chunks
// per row. Returns a CUDA error code (cudaErrorInvalidConfiguration when
// the occupancy API admits no cluster of the plan).
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
  const int fields[8] = {p.blocks, p.threads, p.stages, p.smem,
                         p.shared_ledgers, p.slice, p.chunk, p.chunks};
  for (int f = 0; f < 8; ++f) plan[f] = fields[f];
  return cudaSuccess;
}

// Enqueues the one cluster launch on ``stream`` of ``device`` (made
// current for the call); returns its CUDA error code. ``tent_scratch`` may
// be null when the plan keeps the ledgers in shared memory.
int joint_fit_launch(const int32_t* packed, const int32_t* chips, const int32_t* starts,
                     const int32_t* valid, int32_t* picks, int32_t* group_ok, int32_t* sim,
                     int32_t* tent_scratch, int n, int k, int device, void* stream) {
  if (n <= 0 || k <= 0) return cudaErrorInvalidValue;
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e) return e;
  if (current != device && (e = cudaSetDevice(device))) return e;
  Plan p{};
  e = make_plan(device, n, &p);
  if (!e && !p.shared_ledgers && tent_scratch == nullptr) e = cudaErrorInvalidValue;
  if (!e) {
    const bool vector = n % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
                        (p.shared_ledgers || reinterpret_cast<uintptr_t>(tent_scratch) % 16 == 0);
    const Args a{packed, chips,   starts,   valid,    picks,   group_ok,
                 sim,    tent_scratch, n,   k,        p.slice, p.chunk,
                 p.chunks, p.stages, p.warps, vector ? 1 : 0};
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(p.blocks);
    cfg.blockDim = dim3(p.threads);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel_for(p), a);
    if (!e) e = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return e;
}

const char* joint_fit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
