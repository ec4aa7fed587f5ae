// Hand-written Hopper (sm_90a) kernels of the element-major multi-source
// relay superstep: 32 BFS trees per uint32 element, G groups side by side.
//
// Plain C interface for ctypes, as relay_kernels.cu: pointers, integers and
// the CUDA stream as void*; every entry point launches on the caller's
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError().  Element arrays are [G, n] row-major (group g at
// g * n); bit t of an element is tree t of its group.  Beneš masks are the
// stored flat masks in standard packing (one bit per lower pair element,
// bit b at word b >> 5, bit b & 31).  Each kernel's plain PyTorch version
// lives in bfs_tpu_torch/ops/relay_elem.py and is held bit-exact against it.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "control.cuh"
#include "tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDistPlanes = 5;
constexpr uint32_t kAll = 0xFFFFFFFFu;

// 0 or ~0 from mask bit `bit` of a stage's stored words.
__device__ __forceinline__ uint32_t mask_select(const uint32_t* __restrict__ m,
                                                long long bit) {
  return 0u - ((__ldg(m + (bit >> 5)) >> (bit & 31)) & 1u);
}

// ---------------------------------------------------------------------------
// benes_elem_local_pass — replaces the local mode of
// bfs_tpu/ops/relay_pallas.py _run_elem_pass (K5, behind
// apply_benes_elem_fused).
//
// A work item is a tile of 2^L consecutive elements (L <= 15) of one group,
// item = tile * G + group, with every stage of the local run (d = 2^bit <
// 2^L) on it.  Each stage swaps the pair (e, e + d) where the stored mask
// bit of the lower element e is set: bit e of the tile's slab (full
// storage, a bit per element) or bit p = (e >> (bit + 1)) << bit |
// (e & (d - 1)) (pair-compacted storage).
//
// Stages in registers.  A thread holds kElemRegs = 2^kElemRegBits elements
// whose tile indices differ in a window of kElemRegBits consecutive bits
// [lo, lo + kElemRegBits): element e = E_t | (j << lo) in register j, where
// E_t spreads the thread's index over the other bits (its low lo bits stay
// low, the rest go above the window).  Every stage whose bit lies in the
// window pairs two registers of one thread, so it runs with no barrier and
// no shared-memory traffic but its mask words.  The host cuts the run into
// phases, each the longest run of stages one window covers
// (relay_cuda.elem_local_plan); at L = 15 the 29 stages (bits 14 .. 0 .. 14)
// are 5 phases, windows at bits 10, 5, 0, 5 and 10.  Between two phases the
// tile is re-laid out through shared memory: every thread writes its
// registers at their indices and reads the next window's, XOR-swizzled
// (word e at e ^ ((e >> 5) & 31)) so that a warp's 32 accesses of one
// register fall in 32 banks for every window.  The last phase writes the
// tile straight from registers (coalesced where the window starts at bit 5
// or above).  A tile smaller than kElemRegs elements has one thread, whose
// registers past the tile are never written back.
//
// A block takes one item, with 2^(L - kElemRegBits) threads: at L = 15,
// 1,024 threads of 64 registers, so one block fills an SM.  It reads its
// tile straight into registers.  Each stage's slab (the tile's stored mask
// words: tile / 32 words, tile / 64 when compact) comes into a ring of
// kElemSlots shared-memory slots by one bulk copy (TMA, mbarrier) when the
// source allows it, else by cp.async; the ring is refilled at each phase
// boundary, so slabs land a phase or more before their stage, which waits
// for its own slab alone.  A stage whose slab lies outside its nonzero
// stored words (StageSpec.lo/hi) is all zero on the tile and is neither
// fetched nor applied.  A thread tests each of its pairs' mask bits in a
// word of the slot: one word per stage when the window is at bit 0, a word
// per pair (the same for the whole warp) above it.
//
// Bound: bytes — the tile read and written once per group, the local
// stages' masks read once per group (the G blocks of a tile are
// neighbours, so all but the first read of a slab hit the L2).  Against it,
// the issue slots: a pair and stage costs a mask test and a select on the
// ALU pipe and two multiply-adds on the FMA pipe (c' = a + c - a'), 29 x
// 2^14 pairs per tile at L = 15, where three ALU operations (a test, two
// selects) took 8% longer; plus a mask load per pair above bit 0.  What
// stays above the bound: the 4 re-layouts, and a block's load, stages and
// store do not overlap (an SM holds one block).  The design it replaces ran
// each stage as a pass over the tile in shared memory, a barrier each: 29
// passes of 128 KB per tile at scale 22.  bfs_tpu_torch/tools/
// benes_pass_sweep.py times it against builds with other kElemRegBits and
// kElemSlots, and splits its time into the tile's copy, the re-layouts and
// the stages; PERF.md records the sweep and what else was tried.
// ---------------------------------------------------------------------------
constexpr int kMaxLocalStages = 64;
constexpr int kElemRegBits = 5;  // elements a thread holds: 2^kElemRegBits
constexpr int kElemRegs = 1 << kElemRegBits;
constexpr int kMaxTileBits = 15;  // relay_cuda.MAX_TILE_ELEMS = 2^15
constexpr int kElemLocalThreads = (1 << kMaxTileBits) >> kElemRegBits;
constexpr int kMaxLo = kMaxTileBits - kElemRegBits;
constexpr int kElemSlots = 16;  // mask slab ring slots
constexpr int kElemBarBytes = (kElemSlots * 8 + 15) & ~15;
static_assert(kElemRegBits >= 1 && kElemRegBits <= 6, "2 to 64 elements a thread");
static_assert(kElemSlots >= 1 && kElemSlots <= 32, "a parity bit per slot");

struct ElemLocalPlan {
  long long offset[kMaxLocalStages];  // word offset of the stage's masks
  int bit[kMaxLocalStages];           // log2 of the element distance
  int compact[kMaxLocalStages];       // pair-compacted storage
  int lo[kMaxLocalStages];            // the stage's nonzero stored words: [lo, hi)
  int hi[kMaxLocalStages];
  int phase_lo[kMaxLocalStages];      // each phase's window: bits [lo, lo + kElemRegBits)
  int phase_end[kMaxLocalStages];     // one past each phase's last stage
  int count;
  int phases;
};

// One stage as a block reads it (copied from the parameters once).
struct ElemStage {
  const uint32_t* src;  // the tile's slab in device memory
  int words;            // the slab's words
};

__device__ __forceinline__ uint32_t swizzle(uint32_t e) { return e ^ ((e >> 5) & 31u); }

// The thread's part E_t of its element indices under a window at bit LO.
template <int LO>
__device__ __forceinline__ uint32_t thread_elems(uint32_t t) {
  return (t & ((1u << LO) - 1u)) | ((t >> LO) << (LO + kElemRegBits));
}

// Calls f(std::integral_constant<int, lo>) for the runtime lo in [0, kMaxLo].
template <int LO = 0, typename F>
__device__ __forceinline__ void with_lo(int lo, F&& f) {
  if constexpr (LO <= kMaxLo) {
    if (lo == LO) {
      f(std::integral_constant<int, LO>{});
    } else {
      with_lo<LO + 1>(lo, f);
    }
  }
}

// The stage of bit LO + K on the registers: pairs (j, j | 2^K), mask bit of
// the lower element j (bit q = E_t | (j << LO), or its pair number when
// compact) from the slab in shared memory.
template <int LO, int K, bool COMPACT>
__device__ __forceinline__ void reg_stage(uint32_t (&x)[kElemRegs], const uint32_t* slab,
                                          uint32_t et, uint32_t one) {
  constexpr int b = LO + K;
  constexpr uint32_t low = (1u << b) - 1u;
  const uint32_t q = COMPACT ? (et & low) | ((et >> (b + 1)) << b) : et;
  const uint32_t* w = slab + (q >> 5);
  const uint32_t sh = q & 31u;
  const uint32_t bm = 1u << sh;
#pragma unroll
  for (int j = 0; j < kElemRegs; ++j) {
    if (j & (1 << K)) continue;
    const uint32_t J = static_cast<uint32_t>(j) << LO;
    const uint32_t Q = COMPACT ? (J & low) | ((J >> (b + 1)) << b) : J;
    const uint32_t m = w[Q >> 5];
    const bool swap = (Q & 31u) == 0u ? (m & bm) != 0u : ((m >> (sh | (Q & 31u))) & 1u) != 0u;
    const uint32_t a = x[j], c = x[j | (1 << K)];
    x[j] = swap ? c : a;
    // c' = (a + c) - a' as two multiply-adds by a runtime 1 and -1, which
    // the compiler keeps on the FMA pipe: a second select would take the
    // ALU pipe, which the mask test and the first select already load.
    uint32_t sum, rest;
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(sum) : "r"(a), "r"(one), "r"(c));
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(rest) : "r"(x[j]), "r"(0u - one), "r"(sum));
    x[j | (1 << K)] = rest;
  }
}

template <int LO, bool COMPACT, int K = 0>
__device__ __forceinline__ void reg_stage_k(int k, uint32_t (&x)[kElemRegs],
                                            const uint32_t* slab, uint32_t et, uint32_t one) {
  if constexpr (K < kElemRegBits) {
    if (k == K) {
      reg_stage<LO, K, COMPACT>(x, slab, et, one);
    } else {
      reg_stage_k<LO, COMPACT, K + 1>(k, x, slab, et, one);
    }
  }
}

// A stage as one word of shared memory: live | bulk << 1 | compact << 2 |
// bit << 3.
constexpr int kLive = 1, kBulk = 2, kCompact = 4;

__global__ void __launch_bounds__(kElemLocalThreads, 1)
benes_elem_local_pass_kernel(const uint32_t* x_in, uint32_t* x_out,
                             const uint32_t* __restrict__ masks,
                             const ElemLocalPlan plan, long long n, int groups,
                             int lg_tile, int slot_words, int keep_masks, uint32_t one) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ElemStage info[kMaxLocalStages];
  __shared__ int code[kMaxLocalStages];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + kElemBarBytes);  // the tile, swizzled
  const int tile = 1 << lg_tile;
  uint32_t* ring = xs + (tile > kElemRegs ? tile : kElemRegs);
  const long long base = static_cast<long long>(blockIdx.x / groups) * tile;
  const long long at = static_cast<long long>(blockIdx.x % groups) * n + base;
  const uint32_t t = threadIdx.x;
  const int count = plan.count;
  if (t == 0) {
    for (int i = 0; i < kElemSlots; ++i) mbar_init(bar + i);
    mbar_fence_init();
  }
  for (int s = t; s < count; s += blockDim.x) {  // a small tile has few threads
    ElemStage f;
    const bool compact = plan.compact[s] != 0;
    const long long w0 = compact ? base >> 6 : base >> 5;
    const int words = compact ? tile >> 6 : tile >> 5;
    f.words = words > 0 ? words : 1;
    f.src = masks + plan.offset[s] + w0;
    info[s] = f;
    const bool live = w0 < plan.hi[s] && w0 + f.words > plan.lo[s];
    const bool bulk = ((reinterpret_cast<uintptr_t>(f.src) | (f.words * 4u)) & 15u) == 0;
    code[s] = (live ? kLive : 0) | (bulk ? kBulk : 0) | (compact ? kCompact : 0) |
              (plan.bit[s] << 3);
  }
  __syncthreads();
  // The G blocks of a tile read the same slabs: keep them in the L2 for the
  // others when G > 1.
  uint64_t policy;
  if (keep_masks) {
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;" : "=l"(policy));
  } else {
    policy = evict_first_policy();
  }
  auto issue = [&](int s) {  // block-uniform
    if (!(code[s] & kLive)) return;
    const ElemStage& f = info[s];
    uint32_t* dst = ring + (s % kElemSlots) * slot_words;
    if (code[s] & kBulk) {
      if (t == 0) {
        fence_proxy_async();  // the slot's last readers passed a block barrier
        bulk_load(dst, f.src, static_cast<uint32_t>(f.words) * 4u, bar + s % kElemSlots, policy);
      }
    } else {
      for (int i = t; i < f.words; i += blockDim.x) {
        __pipeline_memcpy_async(dst + i, f.src + i, sizeof(uint32_t));
      }
      __pipeline_commit();
    }
  };
  int issued = 0;
  for (; issued < count && issued < kElemSlots; ++issued) issue(issued);

  uint32_t x[kElemRegs];
  const bool ghosts = tile < kElemRegs;  // one thread; registers past the tile idle
  with_lo(plan.phase_lo[0], [&](auto c) {
    constexpr int LO = decltype(c)::value;
    const uint32_t et = thread_elems<LO>(t);
#pragma unroll
    for (int j = 0; j < kElemRegs; ++j) {
      const uint32_t e = et | (static_cast<uint32_t>(j) << LO);
      x[j] = ghosts && e >= static_cast<uint32_t>(tile) ? 0u : x_in[at + e];
    }
  });
  uint32_t parity = 0;
  for (int p = 0; p < plan.phases; ++p) {
    const int s0 = p ? plan.phase_end[p - 1] : 0;
    const int lo = plan.phase_lo[p];
    if (p > 0) {
      const int prev = plan.phase_lo[p - 1];
      if (prev != lo) {
        if (p > 1) __syncthreads();  // the last re-layout's reads are done
        with_lo(prev, [&](auto c) {
          constexpr int LO = decltype(c)::value;
          const uint32_t pe = swizzle(thread_elems<LO>(t));
#pragma unroll
          for (int j = 0; j < kElemRegs; ++j) {
            xs[pe ^ swizzle(static_cast<uint32_t>(j) << LO)] = x[j];
          }
        });
      }
      __syncthreads();  // every stage before s0 applied: its slot is free
      for (; issued < count && issued < s0 + kElemSlots; ++issued) issue(issued);
      if (prev != lo) {
        with_lo(lo, [&](auto c) {
          constexpr int LO = decltype(c)::value;
          const uint32_t pe = swizzle(thread_elems<LO>(t));
#pragma unroll
          for (int j = 0; j < kElemRegs; ++j) {
            x[j] = xs[pe ^ swizzle(static_cast<uint32_t>(j) << LO)];
          }
        });
      }
    }
    with_lo(lo, [&](auto c) {
      constexpr int LO = decltype(c)::value;
      const uint32_t et = thread_elems<LO>(t);
      for (int s = s0; s < plan.phase_end[p]; ++s) {
        const int cs = code[s];
        if (!(cs & kLive)) continue;  // all zero on this tile
        const int slot = s % kElemSlots;
        if (cs & kBulk) {  // each slab waited for just before its stage
          mbar_wait(bar + slot, (parity >> slot) & 1u);
          parity ^= 1u << slot;
        } else {
          __pipeline_wait_prior(0);
          __syncthreads();  // every thread's words in place
        }
        const uint32_t* slab = ring + slot * slot_words;
        if (cs & kCompact) {
          reg_stage_k<LO, true>((cs >> 3) - LO, x, slab, et, one);
        } else {
          reg_stage_k<LO, false>((cs >> 3) - LO, x, slab, et, one);
        }
      }
    });
  }
  with_lo(plan.phase_lo[plan.phases - 1], [&](auto c) {
    constexpr int LO = decltype(c)::value;
    const uint32_t et = thread_elems<LO>(t);
#pragma unroll
    for (int j = 0; j < kElemRegs; ++j) {
      const uint32_t e = et | (static_cast<uint32_t>(j) << LO);
      if (!ghosts || e < static_cast<uint32_t>(tile)) x_out[at + e] = x[j];
    }
  });
}

// ---------------------------------------------------------------------------
// benes_elem_outer_stage — replaces the outer mode of
// bfs_tpu/ops/relay_pallas.py _run_elem_pass (K5).
//
// One launch per stage with d >= tile, for all groups (blockIdx.y): one
// thread per lower element e of each pair (e, e + d), the mask bit at the
// pair number p (pair-compacted storage) or at e (full storage).  In place
// when x_in == x_out (each pair is owned by one thread).
// Bound: bytes — every element read and written once per group, the stage's
// stored mask words read once per group.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
benes_elem_outer_stage_kernel(const uint32_t* x_in, uint32_t* x_out,
                              const uint32_t* __restrict__ mask, long long n,
                              long long d, int compact) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= (n >> 1)) return;
  const long long e = ((p & ~(d - 1)) << 1) | (p & (d - 1));
  const long long at = static_cast<long long>(blockIdx.y) * n + e;
  const uint32_t sel = mask_select(mask, compact ? p : e);
  const uint32_t a = x_in[at];
  const uint32_t b = x_in[at + d];
  const uint32_t t = (a ^ b) & sel;
  x_out[at] = a ^ t;
  x_out[at + d] = b ^ t;
}

// ---------------------------------------------------------------------------
// elem_route_gather — replaces, inside the multi-source level loop, the
// vperm and net Beneš networks (bfs_tpu/ops/relay_pallas.py _run_elem_pass,
// K5, twice) and the XLA broadcast_l2_elem between them.
//
// The masks are fixed for a graph and the route only moves and copies whole
// elements, so frontier element -> L1 slot element is one fixed map:
// l1[g, i] = src[i] >= 0 ? frontier[g, src[i]] : 0, with src (int32[n])
// built once per engine by routing iota + 1 through the K5 kernels
// (RelayEngine.route_index).  A thread takes kGatherQuads runs of 4
// consecutive slots: their indices in one 16-byte load each, then each
// slot's frontier elements, then each group's 4 slots in one 16-byte store.
// Bound: bytes — the index read once, the frontier read once per group and
// the slots written once per group.  The index and the slots stream past
// the L2 (evict-first loads and stores), so the frontier (33.6 MB at scale
// 22, G = 2) can stay in the 50 MB L2 for the random reads.  Those reads are
// what costs: each takes a 32-byte L2 sector for 4 bytes.  So for G = 2 and
// 4 the frontier is read interleaved, int32[vr, G] (elem_frontier_interleave
// writes it each superstep), and a slot reads all its groups' elements in
// one 8- or 16-byte load, one sector, where the [G, vr] frontier costs G
// sectors; other G read [G, vr] directly.
// ---------------------------------------------------------------------------
constexpr int kGatherQuads = 1;  // runs of 4 slots a thread

template <int G>
struct GroupVec;
template <>
struct GroupVec<1> {
  using T = uint32_t;
  __device__ static uint32_t at(T v, int) { return v; }
};
template <>
struct GroupVec<2> {
  using T = uint2;
  __device__ static uint32_t at(T v, int g) { return g ? v.y : v.x; }
};
template <>
struct GroupVec<4> {
  using T = uint4;
  __device__ static uint32_t at(T v, int g) {
    return g == 0 ? v.x : g == 1 ? v.y : g == 2 ? v.z : v.w;
  }
};

// G interleaved groups (frontier int32[vr, G]) when G > 1 or `groups` = 1;
// G = 1 with groups > 1 reads each group's row of int32[groups, vr].
template <int G>
__global__ void __launch_bounds__(kThreads)
elem_route_gather_kernel(const uint32_t* __restrict__ frontier,
                         const int4* __restrict__ src, uint4* __restrict__ l1,
                         long long vr, long long n4, int groups,
                         const int32_t* __restrict__ ctl) {
  if (superstep_dead(ctl)) return;
  using V = typename GroupVec<G>::T;
  const long long q0 = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
                       kGatherQuads;
  int4 s[kGatherQuads];
#pragma unroll
  for (int u = 0; u < kGatherQuads; ++u) {
    s[u] = q0 + u < n4 ? __ldcs(src + q0 + u) : make_int4(-1, -1, -1, -1);
  }
  for (int g0 = 0; g0 < groups; g0 += G) {  // one pass when G == groups
    const V* __restrict__ f = reinterpret_cast<const V*>(frontier + g0 * vr);
    V v[kGatherQuads][4];
#pragma unroll
    for (int u = 0; u < kGatherQuads; ++u) {
      const int idx[4] = {s[u].x, s[u].y, s[u].z, s[u].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) v[u][c] = idx[c] >= 0 ? __ldg(f + idx[c]) : V{};
    }
#pragma unroll
    for (int u = 0; u < kGatherQuads; ++u) {
      if (q0 + u >= n4) break;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const uint4 o = make_uint4(GroupVec<G>::at(v[u][0], g), GroupVec<G>::at(v[u][1], g),
                                   GroupVec<G>::at(v[u][2], g), GroupVec<G>::at(v[u][3], g));
        __stcs(l1 + (g0 + g) * n4 + q0 + u, o);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// elem_frontier_interleave — the frontier int32[G, vr] as int32[vr, G], for
// elem_route_gather's one-sector reads (G = 2 or 4).  Part of the same
// replacement: no kernel of the reference does this; its route moved every
// element through the K5 networks.  A thread per vertex: G coalesced
// 4-byte reads, one 8- or 16-byte store.
// Bound: bytes — the frontier read and written once.
// ---------------------------------------------------------------------------
template <int G>
__global__ void __launch_bounds__(kThreads)
elem_frontier_interleave_kernel(const uint32_t* __restrict__ frontier,
                                typename GroupVec<G>::T* __restrict__ out, long long vr,
                                const int32_t* __restrict__ ctl) {
  if (superstep_dead(ctl)) return;
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= vr) return;
  uint32_t e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int g = 0; g < G; ++g) e[g] = __ldcs(frontier + g * vr + v);
  if constexpr (G == 2) {
    out[v] = make_uint2(e[0], e[1]);
  } else {
    out[v] = make_uint4(e[0], e[1], e[2], e[3]);
  }
}

// ---------------------------------------------------------------------------
// elem_rowmin_update — replaces the row-min tournament and the bit-sliced
// update that bfs_tpu/ops/relay_elem.py rowmin_elem and elem_superstep run
// in XLA (the TPU superstep, relay_pallas.py elem_superstep_tpu_factory,
// leaves them there too).
//
// Per (group, vertex), the vertex's class rows over l1 & valid: rank-major
// slot sa + r * count + (v - va), vertex-major slot sa + (v - va) * width +
// r.  A walk over a span of rows in ascending order starts from found =
// visited; at row r the fresh bits x & ~found take rank r (their rank planes
// j get the bits where bit j of r is set), then join found; the walk ends
// once every tree is reached or found.  The fresh bits of a span are the
// trees whose first row in it is r.  The rows are split into spans walked in
// parallel, and combined in row order (an OR-prefix): span c owns the fresh
// bits no earlier span found, fresh_c & ~(fresh_0 | ... | fresh_{c-1}), and
// the vertex's planes are the OR over c of planes_c[j] & owned_c.  Spans hold
// disjoint ascending rows, so that is the tournament's min row index (zero
// rows never win).  Then newly = the OR of the fresh bits is the next
// frontier, joins visited, is ORed into dist plane b where bit b of `level`
// (the new level) is set — none at 32, the step past the cap — and into the
// class's rank planes rank_planes[g, off + j * count + (v - va)], j < nb.  A
// block OR of newly != 0 sets the device `changed` flag, zeroed first on
// this stream; inside the block loop the level is the control block's
// level + 1 and the flag its flag word (control.cuh), and a superstep that
// is not live returns at entry.  The frontier is not read, so it may be
// written in place of the one the superstep routed.  One launch covers every class and group (blockIdx.y)
// through a table of work items (kind, va, count, sa, width, off, nb,
// chunks, rows, passes, first block), built by ops/relay_cuda.py
// elem_rowmin_items and passed by value, so a block finds its item by a
// binary search in the kernel's parameter space (the constant cache)
// without a device round trip:
//   kind 0, rank-major: the rows are split into `chunks` C in {1, 2, 4, 8}
//     of `rows` each; a block covers kWarps / C spans of 32 consecutive
//     vertices with all C chunks, one warp per (span, chunk), lane = vertex.
//     A warp walks its chunk for its 32 vertices with kRowBatch rows' loads
//     in flight (the 32 lanes' slots of a row are one coalesced 128-byte
//     line and one valid word, loaded once for the warp); with C > 1 the
//     chunks are combined per vertex after a block barrier.  A one-chunk
//     class's block makes `passes` passes over that many groups of 256
//     vertices, so the block's own costs (its launch, its work item) are
//     paid once for all of them;
//   kind 1, vertex-major narrower than ROWMIN_WIDE_BITS rows: one warp per
//     vertex, 16-byte loads (4 rows a lane, 128 a warp), kStepBatch steps in
//     flight; per 128 rows, lanes in row order while fresh bits remain;
//   kind 3, vertex-major at least ROWMIN_WIDE_BITS rows: one block per
//     vertex, warp w walking rows [w * rows, (w + 1) * rows) as kind 1 does,
//     the warps combined in row order;
//   kind 2: the tail [covered, vr), which finds nothing.
// Each span's planes live in a row of shared memory (stride 33 against bank
// conflicts: a thread's row in kind 0, a warp's, written by its lane 0, in
// kinds 1 and 3), not in registers.
// Bound: bytes — visited read and frontier written once, the class slots of
// every unfinished (group, vertex) and their valid words read, and the
// state words of newly reached vertices rewritten.  What held the first
// design at 29x that bound: one thread walked all `width` rows of its
// vertex one dependent load at a time (1,536 rows at scale 22), and one warp
// a wide vertex-major row 32 rows at a time.  Here no thread walks more than
// ceil(width / 8) rows (32 up to width 256) with kRowBatch loads in flight,
// and a wide vertex-major row is read by a whole block, 16 bytes a lane.
// Splitting the rows alone left it at 0.93 ms at scale 22 (0.97 before;
// chip_smoke.py on an H100): the time is in the 20,737 short blocks per
// group, each paying a chain of dependent round trips (its work item, then
// visited and the rows, then the writes), with too few blocks per SM to
// hide them while 32 plane registers a thread held the occupancy at 2
// blocks.  So the planes live in shared memory and the launch bounds ask
// for kElemBlocksPerSm blocks; the work table is in the kernel's
// parameters; a walk issues its first rows' loads with the visited load; a
// one-chunk class's block makes several passes; and the dist and rank
// planes take fire-and-forget atomicOr (each (group, vertex) has one
// writer, so they are uncontended) instead of a read-modify-write.
// bfs_tpu_torch/tools/elem_rowmin_breakdown.py times each kind of work item
// and, with --sweep, other kRowBatch, kElemBlocksPerSm and passes; PERF.md
// records both.
// ---------------------------------------------------------------------------
constexpr int kWarps = kThreads / 32;
constexpr int kRowBatch = 4;
constexpr int kStepBatch = 4;
constexpr int kElemBlocksPerSm = 6;
constexpr int kMaxChunks = kWarps;

constexpr int kMaxItems = 56;

struct ElemItem {
  long long va, count, sa, off;
  int kind, width, nb, chunks, rows, passes, block0;
};

// The work table, passed by value (56 x 64 bytes fit the 4 KB of kernel
// parameters).
struct ElemTable {
  ElemItem it[kMaxItems];
  int n;
};

struct ElemOut {
  uint32_t* visited;      // [G, vr]
  uint32_t* frontier;     // [G, vr]
  uint32_t* dist_planes;  // [kDistPlanes, G, vr]
  uint32_t* rank_planes;  // [G, pt]
  long long vr, pt;
  int groups;
  uint32_t level;
};

// Rank r taken by `fresh`: plane j of a span's shared row gets the bits
// where bit j of r is set.
__device__ __forceinline__ void adopt(uint32_t* row, uint32_t fresh, uint32_t r) {
  for (; r; r &= r - 1) row[__ffs(r) - 1] |= fresh;
}

// The vertex's update from the row-order combine of `n` spans staged at
// k0, k0 + step, ... (fresh bits in fresh_s, plane rows in planes_s);
// returns newly.
__device__ __forceinline__ uint32_t write_vertex(const ElemOut& o, uint32_t level,
                                                 const ElemItem& it, int g,
                                                 long long v, uint32_t vis,
                                                 const uint32_t* fresh_s,
                                                 const uint32_t* planes_s, int k0, int step,
                                                 int n) {
  uint32_t own[kMaxChunks];
  uint32_t newly = 0u;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    own[c] = c < n ? fresh_s[k0 + c * step] & ~newly : 0u;
    newly |= own[c];
  }
  const long long gv = g * o.vr + v;
  o.frontier[gv] = newly;
  if (!newly) return 0u;
  o.visited[gv] = vis | newly;
#pragma unroll
  for (int b = 0; b < kDistPlanes; ++b) {
    if ((level >> b) & 1u) {
      atomicOr(o.dist_planes + (static_cast<long long>(b) * o.groups + g) * o.vr + v, newly);
    }
  }
  uint32_t* rp = o.rank_planes + g * o.pt + it.off + (v - it.va);
  for (int j = 0; j < it.nb; ++j) {
    uint32_t bits = 0u;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c < n) bits |= planes_s[(k0 + c * step) * 33 + j] & own[c];
    }
    if (bits) atomicOr(rp + j * it.count, bits);
  }
  return newly;
}

// A warp's walk over rank-major rows [r0, r1) of its 32 class vertices i
// (lane = vertex; a lane past the class has found = ~0 and loads nothing),
// planes into each lane's `row`.  The rows' valid words are shared by the
// warp: lane l loads row r + l's for 32 rows at a time and each row's is
// shuffled out, so only the element of a row takes a register; kRowBatch
// rows' elements are in flight, the first issued before `found` (the
// visited load) is needed.  The walk ends when every lane is done.
__device__ __forceinline__ void walk_rank_rows(const uint32_t* __restrict__ x,
                                               const uint32_t* __restrict__ valid,
                                               const ElemItem& it, long long i,
                                               long long r0, long long r1,
                                               uint32_t& found, uint32_t* row) {
  const int lane = threadIdx.x & 31;
  const bool active = i < it.count;
  const long long base = it.sa + (i & ~31LL);  // lane 0's slot of row 0
  for (long long r = r0; r < r1; r += 32) {
    const uint32_t vw = r + lane < r1 ? __ldg(valid + ((base + (r + lane) * it.count) >> 5)) : 0u;
    for (int u0 = 0; u0 < 32 && r + u0 < r1; u0 += kRowBatch) {  // warp-uniform
      uint32_t w[kRowBatch];
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) {
        const long long rr = r + u0 + u;
        w[u] = active && rr < r1 ? __ldg(x + it.sa + rr * it.count + i) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) {
        const uint32_t v = __shfl_sync(kAll, vw, u0 + u);
        const uint32_t f = w[u] & (0u - ((v >> lane) & 1u)) & ~found;
        if (f) {
          adopt(row, f, static_cast<uint32_t>(r + u0 + u));
          found |= f;
        }
      }
      if (__all_sync(kAll, found == kAll)) return;
    }
  }
}

// A warp's walk over vertex-major rows [r0, r1) of the row at slot `row`
// (a multiple of 32, as are r0 and r1): 16-byte loads, lane L holding rows
// 4L .. 4L + 3 of each 128-row step, kStepBatch steps' loads in flight, the
// first issued before `found` is needed.  `found` stays warp-uniform; lane
// 0 writes the planes into `prow`.
__device__ __forceinline__ void walk_vertex_rows(const uint32_t* __restrict__ x,
                                                 const uint32_t* __restrict__ valid,
                                                 long long row, long long r0, long long r1,
                                                 uint32_t& found, uint32_t* prow) {
  const int lane = threadIdx.x & 31;
  for (long long r = r0; r < r1; r += 128 * kStepBatch) {
    uint4 w[kStepBatch];
#pragma unroll
    for (int u = 0; u < kStepBatch; ++u) {
      const long long rr = r + 128 * u + 4 * lane;  // this lane's first row
      w[u] = make_uint4(0u, 0u, 0u, 0u);
      if (rr < r1) {
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(x + row + rr));
        const uint32_t vb = __ldg(valid + ((row + rr) >> 5)) >> ((row + rr) & 31);
        w[u] = make_uint4(a.x & (0u - (vb & 1u)), a.y & (0u - ((vb >> 1) & 1u)),
                          a.z & (0u - ((vb >> 2) & 1u)), a.w & (0u - ((vb >> 3) & 1u)));
      }
    }
#pragma unroll
    for (int u = 0; u < kStepBatch; ++u) {
      const uint32_t any = w[u].x | w[u].y | w[u].z | w[u].w;
      uint32_t pending = __reduce_or_sync(kAll, any) & ~found;
      while (pending) {  // lanes in row order, while fresh bits remain
        const int k = __ffs(__ballot_sync(kAll, (any & pending) != 0u)) - 1;
        const uint32_t q[4] = {__shfl_sync(kAll, w[u].x, k), __shfl_sync(kAll, w[u].y, k),
                               __shfl_sync(kAll, w[u].z, k), __shfl_sync(kAll, w[u].w, k)};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t fresh = q[c] & pending;
          if (fresh) {
            if (lane == 0) adopt(prow, fresh, static_cast<uint32_t>(r + 128 * u + 4 * k + c));
            found |= fresh;
            pending &= ~fresh;
          }
        }
      }
    }
    if (found == kAll) break;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads, kElemBlocksPerSm)
elem_rowmin_update_kernel(const uint32_t* __restrict__ l1,
                          const uint32_t* __restrict__ valid,
                          const ElemTable table, long long n, const ElemOut o,
                          int32_t* __restrict__ changed, const int32_t* __restrict__ ctl) {
  __shared__ uint32_t fresh_s[kThreads];
  __shared__ uint32_t vis_s[kThreads];
  __shared__ uint32_t planes_s[kThreads * 33];
  if (superstep_dead(ctl)) return;
  // The level stamped: the control block's level + 1 in the block loop.  A
  // local, not a write into `o`, which would move the parameter struct to
  // local memory.
  const uint32_t level =
      ctl != nullptr ? static_cast<uint32_t>(ctl_word(ctl, kCtlLevel) + 1) : o.level;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // The item owning this block: the last one whose first block <= blockIdx.
  int lo = 0, hi = table.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.it[mid].block0 <= static_cast<int>(blockIdx.x)) lo = mid; else hi = mid - 1;
  }
  const ElemItem& it = table.it[lo];
  const long long b = blockIdx.x - it.block0;
  const int g = blockIdx.y;
  const uint32_t* __restrict__ x = l1 + g * n;
  bool any = false;

  if (it.kind == 0) {
    const int chunks = it.chunks;
    const int spans = kWarps / chunks;  // spans of 32 vertices per pass
    const long long r0 = (warp % chunks) * it.rows;
    const long long r1 = r0 + it.rows < it.width ? r0 + it.rows : it.width;
    uint32_t* row = planes_s + tid * 33;
    for (int pass = 0; pass < it.passes; ++pass) {  // block-uniform
      const long long pb = b * it.passes + pass;
      const long long i = (pb * spans + warp / chunks) * 32 + lane;
      for (int j = 0; j < it.nb; ++j) row[j] = 0u;
      const uint32_t vis = i < it.count ? o.visited[g * o.vr + it.va + i] : kAll;
      uint32_t found = vis;
      walk_rank_rows(x, valid, it, i, r0, r1, found, row);  // the whole warp
      // Staging index of (span s, chunk c, lane) = (s * chunks + c) * 32 +
      // lane = tid: the warps of one span are consecutive.
      fresh_s[tid] = found & ~vis;
      if (chunks == 1) {  // block-uniform: this thread holds its whole vertex
        if (i < it.count) {
          any |= write_vertex(o, level, it, g, it.va + i, vis, fresh_s, planes_s, tid, 32, 1) != 0u;
        }
      } else {
        vis_s[tid] = vis;
        __syncthreads();
        if (tid < spans * 32) {
          const int s = tid >> 5;
          const int k0 = s * chunks * 32 + lane;
          const long long iv = (pb * spans + s) * 32 + lane;
          if (iv < it.count) {
            any |= write_vertex(o, level, it, g, it.va + iv, vis_s[k0], fresh_s, planes_s, k0, 32,
                                chunks) != 0u;
          }
        }
        __syncthreads();  // the staged rows are read before the next pass
      }
    }
  } else if (it.kind == 1 || it.kind == 3) {
    // Kind 1: a warp per vertex; kind 3: a block per vertex, warp w on
    // rows [w * rows, (w + 1) * rows).
    const bool wide = it.kind == 3;
    const long long i = wide ? b : b * kWarps + warp;
    uint32_t* prow = planes_s + warp * 33;
    if (lane < it.nb) prow[lane] = 0u;
    __syncwarp();
    uint32_t vis = 0u;
    if (i < it.count) {  // warp-uniform
      vis = o.visited[g * o.vr + it.va + i];
      uint32_t found = vis;
      const long long r0 = wide ? warp * it.rows : 0;
      const long long r1 = !wide ? it.width : r0 + it.rows < it.width ? r0 + it.rows : it.width;
      walk_vertex_rows(x, valid, it.sa + i * it.width, r0, r1, found, prow);
      fresh_s[warp] = found & ~vis;
    }
    if (!wide) {
      __syncwarp();
      if (lane == 0 && i < it.count) {
        any = write_vertex(o, level, it, g, it.va + i, vis, fresh_s, planes_s, warp, 1, 1) != 0u;
      }
    } else {
      __syncthreads();
      if (tid == 0) {
        any = write_vertex(o, level, it, g, it.va + i, vis, fresh_s, planes_s, 0, 1, kWarps) != 0u;
      }
    }
  } else {
    const long long i = b * kThreads + tid;
    if (i < it.count) o.frontier[g * o.vr + it.va + i] = 0u;
  }
  if (__syncthreads_or(any) && tid == 0) *changed = 1;
}

}  // namespace

extern "C" {

int benes_elem_local_pass(const void* x_in, void* x_out, const void* masks,
                          const long long* offsets, const int* bits, const int* compact,
                          const int* lo, const int* hi, int nstages, const int* phase_lo,
                          const int* phase_end, int nphases, int groups, long long n,
                          int lg_tile, void* stream) {
  if (nstages < 0 || nstages > kMaxLocalStages || nphases < 1 ||
      nphases > kMaxLocalStages || lg_tile < 5 || lg_tile > kMaxTileBits || groups < 1 ||
      n % (1LL << lg_tile) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ElemLocalPlan plan;
  plan.count = nstages;
  plan.phases = nphases;
  const int top_lo = lg_tile > kElemRegBits ? lg_tile - kElemRegBits : 0;
  for (int p = 0, s = 0; p < nphases; ++p) {
    plan.phase_lo[p] = phase_lo[p];
    plan.phase_end[p] = phase_end[p];
    if (phase_lo[p] < 0 || phase_lo[p] > top_lo || phase_end[p] < s ||
        phase_end[p] - s > kElemSlots || phase_end[p] > nstages) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (; s < phase_end[p]; ++s) {  // each stage inside its phase's window
      if (bits[s] < phase_lo[p] || bits[s] >= phase_lo[p] + kElemRegBits ||
          bits[s] >= lg_tile || (compact[s] && lg_tile < 6)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      plan.offset[s] = offsets[s];
      plan.bit[s] = bits[s];
      plan.compact[s] = compact[s];
      plan.lo[s] = lo[s];
      plan.hi[s] = hi[s];
    }
  }
  if (phase_end[nphases - 1] != nstages) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = 1 << lg_tile;
  const int slot_words = tile >> 5 > 4 ? tile >> 5 : 4;
  const size_t smem = kElemBarBytes +
                      (static_cast<size_t>(tile > kElemRegs ? tile : kElemRegs) +
                       static_cast<size_t>(kElemSlots) * slot_words) * sizeof(uint32_t);
  static size_t configured = 0;
  if (smem > configured) {
    cudaFuncSetAttribute(benes_elem_local_pass_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    configured = smem;
  }
  const int threads = tile >> kElemRegBits > 1 ? tile >> kElemRegBits : 1;
  const unsigned blocks = static_cast<unsigned>(n / tile * groups);
  benes_elem_local_pass_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x_in), static_cast<uint32_t*>(x_out),
      static_cast<const uint32_t*>(masks), plan, n, groups, lg_tile, slot_words,
      groups > 1 ? 1 : 0, 1u);
  return static_cast<int>(cudaGetLastError());
}

int benes_elem_outer_stage(const void* x_in, void* x_out, const void* mask,
                           int groups, long long n, long long d, int compact,
                           void* stream) {
  const long long pairs = n >> 1;
  const dim3 grid(static_cast<unsigned>((pairs + kThreads - 1) / kThreads),
                  static_cast<unsigned>(groups));
  benes_elem_outer_stage_kernel<<<grid, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x_in), static_cast<uint32_t*>(x_out),
      static_cast<const uint32_t*>(mask), n, d, compact);
  return static_cast<int>(cudaGetLastError());
}

int elem_route_gather(const void* frontier, const void* src, void* l1,
                      long long vr, long long n, int groups, int interleaved,
                      const void* ctl, void* stream) {
  if (n % 4 != 0 || groups < 1 ||
      (interleaved && groups != 2 && groups != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n4 = n >> 2;
  const long long per_block = static_cast<long long>(kThreads) * kGatherQuads;
  const unsigned blocks = static_cast<unsigned>((n4 + per_block - 1) / per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const uint32_t*>(frontier);
  const auto* idx = static_cast<const int4*>(src);
  auto* out = static_cast<uint4*>(l1);
  const auto* c = static_cast<const int32_t*>(ctl);
  if (!interleaved) {
    elem_route_gather_kernel<1><<<blocks, kThreads, 0, s>>>(f, idx, out, vr, n4, groups, c);
  } else if (groups == 2) {
    elem_route_gather_kernel<2><<<blocks, kThreads, 0, s>>>(f, idx, out, vr, n4, groups, c);
  } else {
    elem_route_gather_kernel<4><<<blocks, kThreads, 0, s>>>(f, idx, out, vr, n4, groups, c);
  }
  return static_cast<int>(cudaGetLastError());
}

int elem_frontier_interleave(const void* frontier, void* out, long long vr, int groups,
                             const void* ctl, void* stream) {
  if (groups != 2 && groups != 4) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((vr + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const uint32_t*>(frontier);
  const auto* c = static_cast<const int32_t*>(ctl);
  if (groups == 2) {
    elem_frontier_interleave_kernel<2><<<blocks, kThreads, 0, s>>>(
        f, static_cast<uint2*>(out), vr, c);
  } else {
    elem_frontier_interleave_kernel<4><<<blocks, kThreads, 0, s>>>(
        f, static_cast<uint4*>(out), vr, c);
  }
  return static_cast<int>(cudaGetLastError());
}

int elem_rowmin_update(const void* l1, const void* valid, void* visited,
                       void* frontier, void* dist_planes, void* rank_planes,
                       void* changed, const long long* items, int nitems,
                       long long total_blocks, int groups, long long n,
                       long long vr, long long pt, unsigned level, void* ctl,
                       void* stream) {
  if (nitems <= 0 || nitems > kMaxItems) return static_cast<int>(cudaErrorInvalidValue);
  // Host rows (kind, va, count, sa, width, off, nb, chunks, rows, passes,
  // block0).
  ElemTable table;
  table.n = nitems;
  for (int i = 0; i < nitems; ++i) {
    const long long* r = items + 11 * i;
    ElemItem& e = table.it[i];
    e.kind = static_cast<int>(r[0]);
    e.va = r[1];
    e.count = r[2];
    e.sa = r[3];
    e.width = static_cast<int>(r[4]);
    e.off = r[5];
    e.nb = static_cast<int>(r[6]);
    e.chunks = static_cast<int>(r[7]);
    e.rows = static_cast<int>(r[8]);
    e.passes = static_cast<int>(r[9]);
    e.block0 = static_cast<int>(r[10]);
  }
  // With a control block the level is read from it and its flag is raised
  // (the control step clears it): nothing is cleared here, so a superstep
  // that is not live leaves the flag alone.
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* c = static_cast<int32_t*>(ctl);
  int32_t* flag = c != nullptr ? c + kCtlFlag : static_cast<int32_t*>(changed);
  if (c == nullptr) cudaMemsetAsync(flag, 0, sizeof(int32_t), s);
  ElemOut o;
  o.visited = static_cast<uint32_t*>(visited);
  o.frontier = static_cast<uint32_t*>(frontier);
  o.dist_planes = static_cast<uint32_t*>(dist_planes);
  o.rank_planes = static_cast<uint32_t*>(rank_planes);
  o.vr = vr;
  o.pt = pt;
  o.groups = groups;
  o.level = level;
  const dim3 grid(static_cast<unsigned>(total_blocks), static_cast<unsigned>(groups));
  elem_rowmin_update_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(l1), static_cast<const uint32_t*>(valid),
      table, n, o, flag, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
