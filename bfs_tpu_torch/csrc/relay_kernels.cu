// Hand-written Hopper (sm_90a) kernels of the relay superstep.
//
// Plain C interface for ctypes: pointers, integers, and the CUDA stream as
// void*.  Every entry point launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
// Words are uint32 bit patterns in standard packing (element e at word
// e >> 5, bit e & 31).  Each kernel's plain PyTorch version lives in
// bfs_tpu_torch/ops/relay.py and is held bit-exact against it.
//
// The tree axis (the lock-step batch, RelayEngine.run_multi_device; the
// reference lifts these kernels over a leading sources axis with vmap and
// a batch grid axis): every kernel of the superstep takes `trees` and the
// per-tree stride of each word array it reads or writes per tree; masks,
// valid words and work tables are shared, and the bound of a batched pass
// is the masks once plus S times the words.  The Beneš passes have a batch
// kernel of their own (benes_local_group, benes_outer_group), launched for
// kBatchTrees trees or more; below, the single search's.  The row-min is
// one kernel for any tree count.  Each takes a tile, unit or work item for
// a group of trees and applies each mask or valid word it loads to all of
// them.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "control.cuh"
#include "tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

// ---------------------------------------------------------------------------
// benes_local_pass — replaces bfs_tpu/ops/relay_pallas.py
// _run_local_tile_major (K1) and the local modes of _run_pass (K2).
//
// One block owns a tile of `tile_words` consecutive words in shared memory
// and applies every stage of the local run (element distance d < 32 * tile)
// to it, then writes the tile back once.  A stage's masks for one tile are
// one contiguous slab of the stored flat layout: `tile_words` words at the
// tile's base (full storage) or `tile_words / 2` at base / 2
// (pair-compacted storage, d >= 4096, where the lower word w of pair p sits
// at base / 2 + p).
//
// Bound: bytes — the tile is read and written once and every local stage's
// stored masks are read once; a few integer ops per word and stage.  What
// held the first design at 2.5x that bound: every stage issued its mask
// loads only after the previous stage's barrier, so the pass was a chain of
// 37 dependent device-memory round trips (5.4 us per stage at s22).  Here:
//   - the tile and the slabs of the stages with d >= 32 are copied into a
//     ring of `slots` shared-memory slots (cp.async.bulk on one mbarrier
//     per slot, evict-first in L2), the next `slots` stages' slabs in
//     flight while a stage computes; a slot is refilled as soon as the
//     barrier after its stage has passed.  A slab that is not 16-byte
//     aligned or not a multiple of 16 bytes (small networks only) is copied
//     word by word with cp.async instead, by every thread;
//   - each run of consecutive stages with d < 32 (16, 8, 4, 2, 1, 2, 4, 8,
//     16 in a Beneš network) is one sweep: a thread reads a word of the
//     tile once, issues all the run's mask loads for it at once (straight
//     from device memory: each stage's slab is read once), applies the
//     stages in registers and writes the word once — one barrier for the
//     run instead of one per stage;
//   - a stage changes nothing where its masks are zero: each stage's
//     nonzero stored words [lo, hi) come with the table (StageSpec.lo/hi),
//     a tile whose slab lies outside them skips that stage's copy, wait and
//     barrier (a sweep, when all its stages do), and the sweep reads no
//     mask word outside them (the reference's pass B skips such tiles too).
//     At R-MAT scale 22, 0.45% of the vperm's local-run mask words lie
//     inside those ranges (its dummy out-positions route zeros) and all of
//     the net's;
//   - the stage table is copied from the kernel's parameters into shared
//     memory once per block: read per stage straight from the parameters,
//     its dynamically indexed entries cost chains of constant-cache misses
//     on every stage's control path.
// ---------------------------------------------------------------------------
constexpr int kMaxLocalStages = 64;
constexpr int kLocalThreads = 1024;
constexpr int kMaxRing = 8;     // ring slots at most
constexpr int kMaxSweep = 9;    // in-word stages one sweep applies at most
constexpr int kBarBytes = 128;  // kMaxRing + 1 mbarriers, rounded up
constexpr size_t kSmemLimit = 232448;  // shared memory of one block
constexpr size_t kTableSmem = 4096;    // static shared memory of the stage tables, at most

struct LocalStages {
  long long offset[kMaxLocalStages];  // word offset of the stage's masks
  int d[kMaxLocalStages];             // element distance
  int compact[kMaxLocalStages];       // pair-compacted storage
  int lo[kMaxLocalStages];            // the stage's nonzero stored words: [lo, hi)
  int hi[kMaxLocalStages];
  int cross[kMaxLocalStages];         // stage index of the c-th stage with d >= 32
  int count;
  int ncross;
};

__device__ __forceinline__ bool bulk_ok(const void* src, uint32_t bytes) {
  return bytes != 0 && ((reinterpret_cast<uintptr_t>(src) | bytes) & 15u) == 0;
}

// `words` words from src to dst (16-byte aligned): one bulk copy completing on
// `bar`, issued by thread 0, where the source allows it; else one cp.async per
// word by every thread, as one committed group.  Block-uniform.
__device__ __forceinline__ void fetch(uint32_t* dst, const uint32_t* src, int words,
                                      uint64_t* bar, uint64_t policy) {
  const uint32_t bytes = static_cast<uint32_t>(words) * 4u;
  if (bulk_ok(src, bytes)) {
    if (threadIdx.x == 0) {
      fence_proxy_async();  // the slot's last readers passed the block barrier
      bulk_load(dst, src, bytes, bar, policy);
    }
  } else {
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      __pipeline_memcpy_async(dst + i, src + i, sizeof(uint32_t));
    }
    __pipeline_commit();
  }
}

// Waits for the fetch of (src, words) on barrier number `which`; `parity`
// holds each barrier's next phase bit.  Block-uniform.
__device__ __forceinline__ void fetched(const uint32_t* src, int words, uint64_t* bar,
                                        int which, uint32_t& parity) {
  if (bulk_ok(src, static_cast<uint32_t>(words) * 4u)) {
    mbar_wait(bar + which, (parity >> which) & 1u);
    parity ^= 1u << which;
  } else {
    __pipeline_wait_prior(0);
    __syncthreads();  // every thread's words in place
  }
}

// One stage of the local run as a block reads it: copied from the kernel's
// parameters into shared memory once, so the per-stage control flow reads
// shared memory instead of chains of dynamically indexed parameters.
struct StageInfo {
  const uint32_t* m;  // the stage's stored masks
  long long at;       // first stored word of this tile's slab
  int d;              // element distance
  int words;          // the slab's words
  int compact;        // pair-compacted storage
  int lo, hi;         // nonzero stored words
  int live;           // the slab touches [lo, hi)
};
static_assert(kMaxLocalStages * (sizeof(StageInfo) + sizeof(int)) <= kTableSmem,
              "the stage tables outgrow kTableSmem");

// Stages s0 .. s0 + len - 1 (all d < 32) on words i and i2 of the tile
// (i2 only if it is in the tile): every mask load issued first; a mask word
// outside its stage's nonzero range is zero and is not read.
__device__ __forceinline__ void sweep_pair(uint32_t* xs, const StageInfo* info, int s0,
                                           int len, long long base, int i, bool two,
                                           int i2) {
  uint32_t ma[kMaxSweep], mb[kMaxSweep];
#pragma unroll
  for (int j = 0; j < kMaxSweep; ++j) {
    const StageInfo& f = info[s0 + (j < len ? j : 0)];
    const long long a = base + i, b = base + i2;  // stored words (full storage)
    ma[j] = j < len && a >= f.lo && a < f.hi ? __ldg(f.m + a) : 0u;
    mb[j] = j < len && two && b >= f.lo && b < f.hi ? __ldg(f.m + b) : 0u;
  }
  uint32_t a = xs[i];
  uint32_t b = two ? xs[i2] : 0u;
#pragma unroll
  for (int j = 0; j < kMaxSweep; ++j) {
    if (j < len) {
      const int d = info[s0 + j].d;
      const uint32_t ta = (a ^ (a >> d)) & ma[j];
      const uint32_t tb = (b ^ (b >> d)) & mb[j];
      a ^= ta ^ (ta << d);
      b ^= tb ^ (tb << d);
    }
  }
  xs[i] = a;
  if (two) xs[i2] = b;
}

__global__ void __launch_bounds__(kLocalThreads)
benes_local_pass_kernel(const uint32_t* x_in, uint32_t* x_out,
                        const uint32_t* __restrict__ masks,
                        const LocalStages st, int tile_words, int slots,
                        const int32_t* __restrict__ ctl) {
  if (superstep_dead(ctl)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ StageInfo info[kMaxLocalStages];
  __shared__ int cross[kMaxLocalStages];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // ring slots, then the tile
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + kBarBytes);
  const int slab = (tile_words + 3) & ~3;  // words per ring slot
  uint32_t* ring = xs + slab;
  const long long base = static_cast<long long>(blockIdx.x) * tile_words;
  const int half = tile_words >> 1;
  if (threadIdx.x == 0) {
    for (int i = 0; i <= slots; ++i) mbar_init(bar + i);
    mbar_fence_init();
  }
  __syncthreads();
  const uint64_t policy = evict_first_policy();  // each slab is read once
  uint32_t parity = 0;
  fetch(xs, x_in + base, tile_words, bar + slots, policy);
  if (threadIdx.x < st.count) {
    const int s = threadIdx.x;
    StageInfo f;
    f.m = masks + st.offset[s];
    f.d = st.d[s];
    f.compact = st.compact[s];
    f.at = f.compact ? base >> 1 : base;
    f.words = f.compact ? half : tile_words;
    f.lo = st.lo[s];
    f.hi = st.hi[s];
    f.live = f.at < f.hi && f.at + f.words > f.lo;
    info[s] = f;
  }
  if (threadIdx.x < st.ncross) cross[threadIdx.x] = st.cross[threadIdx.x];
  __syncthreads();
  const int count = st.count, ncross = st.ncross;
  // The c-th stage with d >= 32, into ring slot c % slots, if its slab
  // touches its nonzero range.
  auto issue = [&](int c) {
    const StageInfo& f = info[cross[c]];
    if (f.live) fetch(ring + (c % slots) * slab, f.m + f.at, f.words, bar + c % slots, policy);
  };
  for (int c = 0; c < ncross && c < slots; ++c) issue(c);
  fetched(x_in + base, tile_words, bar, slots, parity);

  int c = 0;
  for (int s = 0; s < count;) {
    const StageInfo& f = info[s];
    if (f.d < 32) {
      int len = 1;
      bool live = f.live;
      while (s + len < count && len < kMaxSweep && info[s + len].d < 32) {
        live = live || info[s + len].live;
        ++len;
      }
      if (live) {  // else every mask of the run is zero on this tile
        // Two words per step: 2 * len mask loads in flight per thread.
        for (int i = threadIdx.x; i < tile_words; i += 2 * blockDim.x) {
          const int i2 = i + blockDim.x;
          sweep_pair(xs, info, s, len, base, i, i2 < tile_words, i2);
        }
        __syncthreads();
      }
      s += len;
      continue;
    }
    // A stage whose masks are all zero on this tile changes nothing: no
    // copy, no wait, no barrier.
    if (f.live) {
      const int slot = c % slots;
      fetched(f.m + f.at, f.words, bar, slot, parity);
      const uint32_t* m = ring + slot * slab;
      const int dw = f.d >> 5;
      const bool compact = f.compact != 0;
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int w = ((p & ~(dw - 1)) << 1) | (p & (dw - 1));
        const uint32_t a = xs[w];
        const uint32_t b = xs[w + dw];
        const uint32_t t = (a ^ b) & m[compact ? p : w];
        xs[w] = a ^ t;
        xs[w + dw] = b ^ t;
      }
      __syncthreads();  // the tile consistent, and the slot free
    }
    if (c + slots < ncross) issue(c + slots);
    ++c;
    ++s;
  }
  for (int i = threadIdx.x; i < tile_words; i += blockDim.x) x_out[base + i] = xs[i];
}

// ---------------------------------------------------------------------------
// benes_local_group — benes_local_pass on the lock-step batch's [S, n/32]
// words (the reference lifts _run_local_tile_major over its sources axis).
//
// One block owns one tile for a group of trees: the batch's S trees split
// into `groups` groups as evenly as they go (at most `per` trees each), the
// group's tiles side by side in shared memory under one ring of mask slabs,
// as the single pass's, each slab applied to every tree of the group.  So a
// mask word that crosses from L2 into an SM serves the whole group, not one
// tree.  The groups of a tile run in adjacent blocks and find its slabs in
// L2 (evict-normal).  A sweep (stages with d < 32)
// loads a word's masks into registers once for the group.  Where the tile
// is a multiple of 8 words a thread takes four consecutive words at a time
// (16-byte accesses to the tiles and masks; a sweep then has twice the
// mask bytes in flight).  A pair whose mask word is zero is not touched,
// and a word that a stage leaves as it was is not stored (a batch's
// frontier words are mostly zero).  The batch has a tile of its own
// (ops/relay_cuda.py batch_tile_words), so that the group's tiles and two
// ring slots fit one block.  The launcher picks the group: at most
// kLocalGroup trees, as many tiles as leave room for two ring slots.
// Bound: bytes — every tree's words read and written once, each local
// stage's nonzero masks read once.  What stays above it (measured with
// tools/benes_pass_sweep.py --only batch): the groups of a tile each read
// the masks again, at the latency-bound rate of the loads a block keeps in
// flight, and each stage reads and writes a tree's whole tile in shared
// memory.  Clusters of a tile's blocks sharing one ring (multicast bulk
// copies) measured slower at every group size: the slot is refilled only
// once the slowest block of the cluster has released it (PERF.md).
// ---------------------------------------------------------------------------
constexpr int kLocalGroup = 16;  // trees a block of the batch takes at most
// Fewest trees that launch the batch kernels (benes_local_group,
// benes_outer_group); fewer launch the single search's.  A tuning lever:
// tools/benes_pass_sweep.py builds 1 to time the batch kernels on one tree.
constexpr int kBatchTrees = 2;

// sweep_pair on words i and i2 of each of the `nt` tiles of a group (tree
// t's at xs + t * slab): each mask word is loaded once for the group.
__device__ __forceinline__ void sweep_group(uint32_t* xs, int slab, int nt,
                                            const StageInfo* info, int s0, int len,
                                            long long base, int i, bool two, int i2) {
  uint32_t ma[kMaxSweep], mb[kMaxSweep];
#pragma unroll
  for (int j = 0; j < kMaxSweep; ++j) {
    const StageInfo& f = info[s0 + (j < len ? j : 0)];
    const long long a = base + i, b = base + i2;  // stored words (full storage)
    ma[j] = j < len && a >= f.lo && a < f.hi ? __ldg(f.m + a) : 0u;
    mb[j] = j < len && two && b >= f.lo && b < f.hi ? __ldg(f.m + b) : 0u;
  }
  for (int t = 0; t < nt; ++t) {
    uint32_t* x = xs + t * slab;
    const uint32_t a0 = x[i];
    const uint32_t b0 = two ? x[i2] : 0u;
    uint32_t a = a0, b = b0;
#pragma unroll
    for (int j = 0; j < kMaxSweep; ++j) {
      if (j < len) {
        const int d = info[s0 + j].d;
        const uint32_t ta = (a ^ (a >> d)) & ma[j];
        const uint32_t tb = (b ^ (b >> d)) & mb[j];
        a ^= ta ^ (ta << d);
        b ^= tb ^ (tb << d);
      }
    }
    if (a != a0) x[i] = a;
    if (two && b != b0) x[i2] = b;
  }
}

// sweep_group on quad q (words 4q..4q+3) of each tile of a group: one
// 16-byte load per stage of the quad's masks (where the stage's slab is
// 16-byte aligned and the quad lies inside its nonzero range; word by word
// where the quad straddles that range), so a thread has twice sweep_pair's
// bytes in flight, and one 16-byte load and store of each tile's quad.
__device__ __forceinline__ void sweep_group_quad(uint32_t* xs, int slab, int nt,
                                                 const StageInfo* info, int s0, int len,
                                                 long long base, int q) {
  uint4 mk[kMaxSweep];
  const long long a = base + 4 * q;  // stored word of the quad's first word
#pragma unroll
  for (int j = 0; j < kMaxSweep; ++j) {
    mk[j] = make_uint4(0u, 0u, 0u, 0u);
    const StageInfo& f = info[s0 + (j < len ? j : 0)];
    if (j < len && a < f.hi && a + 4 > f.lo) {
      const uint32_t* m = f.m + a;
      if (a >= f.lo && a + 4 <= f.hi && (reinterpret_cast<uintptr_t>(m) & 15u) == 0) {
        mk[j] = __ldg(reinterpret_cast<const uint4*>(m));
      } else {
        mk[j].x = a >= f.lo && a < f.hi ? __ldg(m) : 0u;
        mk[j].y = a + 1 >= f.lo && a + 1 < f.hi ? __ldg(m + 1) : 0u;
        mk[j].z = a + 2 >= f.lo && a + 2 < f.hi ? __ldg(m + 2) : 0u;
        mk[j].w = a + 3 >= f.lo && a + 3 < f.hi ? __ldg(m + 3) : 0u;
      }
    }
  }
  for (int t = 0; t < nt; ++t) {
    uint4* at = reinterpret_cast<uint4*>(xs + t * slab + 4 * q);
    const uint4 v0 = *at;
    uint4 v = v0;
#pragma unroll
    for (int j = 0; j < kMaxSweep; ++j) {
      if (j < len) {
        const int d = info[s0 + j].d;
        uint32_t u;
        u = (v.x ^ (v.x >> d)) & mk[j].x; v.x ^= u ^ (u << d);
        u = (v.y ^ (v.y >> d)) & mk[j].y; v.y ^= u ^ (u << d);
        u = (v.z ^ (v.z >> d)) & mk[j].z; v.z ^= u ^ (u << d);
        u = (v.w ^ (v.w >> d)) & mk[j].w; v.w ^= u ^ (u << d);
      }
    }
    if ((v.x ^ v0.x) | (v.y ^ v0.y) | (v.z ^ v0.z) | (v.w ^ v0.w)) *at = v;
  }
}

// One ring stage (pairs at word distance dw >= 1) on the `nt` tiles of a
// group, four pairs a thread (16-byte loads and stores of tiles and masks):
// for dw >= 4 the pairs p..p+3 (consecutive lower words w..w+3 and upper
// words w+dw..w+dw+3), for dw = 1 and 2 the two pairs inside words
// 4q..4q+3.  Needs a tile of a multiple of 8 words.
__device__ __forceinline__ void ring_stage_quads(uint32_t* xs, int slab, int nt,
                                                 const uint32_t* m, int tile_words, int dw,
                                                 bool compact) {
  if (dw >= 4) {
    for (int p = 4 * threadIdx.x; p < (tile_words >> 1); p += 4 * blockDim.x) {
      const int w = ((p & ~(dw - 1)) << 1) | (p & (dw - 1));
      const uint4 mk = *reinterpret_cast<const uint4*>(m + (compact ? p : w));
      if ((mk.x | mk.y | mk.z | mk.w) == 0u) continue;
      for (int t = 0; t < nt; ++t) {
        uint4* lo = reinterpret_cast<uint4*>(xs + t * slab + w);
        uint4* hi = reinterpret_cast<uint4*>(xs + t * slab + w + dw);
        uint4 a = *lo, b = *hi;
        const uint4 d = make_uint4((a.x ^ b.x) & mk.x, (a.y ^ b.y) & mk.y,
                                   (a.z ^ b.z) & mk.z, (a.w ^ b.w) & mk.w);
        if (d.x | d.y | d.z | d.w) {
          a.x ^= d.x; a.y ^= d.y; a.z ^= d.z; a.w ^= d.w;
          b.x ^= d.x; b.y ^= d.y; b.z ^= d.z; b.w ^= d.w;
          *lo = a;
          *hi = b;
        }
      }
    }
    return;
  }
  for (int q = threadIdx.x; q < (tile_words >> 2); q += blockDim.x) {
    // Pairs (0, dw) and (1 + (dw == 1), 1 + (dw == 1) + dw) of the quad, that
    // is pairs 2q and 2q + 1; masks at the lower words or the pair numbers.
    uint32_t m0, m1;
    if (compact) {
      const uint2 mp = *reinterpret_cast<const uint2*>(m + 2 * q);
      m0 = mp.x;
      m1 = mp.y;
    } else {
      const uint4 mw = *reinterpret_cast<const uint4*>(m + 4 * q);
      m0 = mw.x;
      m1 = dw == 1 ? mw.z : mw.y;
    }
    if ((m0 | m1) == 0u) continue;
    for (int t = 0; t < nt; ++t) {
      uint4* at = reinterpret_cast<uint4*>(xs + t * slab + 4 * q);
      uint4 v = *at;
      uint32_t d0, d1;
      if (dw == 1) {
        d0 = (v.x ^ v.y) & m0;
        d1 = (v.z ^ v.w) & m1;
        v.x ^= d0; v.y ^= d0; v.z ^= d1; v.w ^= d1;
      } else {
        d0 = (v.x ^ v.z) & m0;
        d1 = (v.y ^ v.w) & m1;
        v.x ^= d0; v.z ^= d0; v.y ^= d1; v.w ^= d1;
      }
      if (d0 | d1) *at = v;
    }
  }
}

__global__ void __launch_bounds__(kLocalThreads)
benes_local_group_kernel(const uint32_t* x_in, uint32_t* x_out,
                         const uint32_t* __restrict__ masks,
                         const LocalStages st, int tile_words, int slots, int trees,
                         int groups, int per, long long tree_stride,
                         const int32_t* __restrict__ ctl) {
  if (superstep_dead(ctl)) return;
  // Block b: tile b / groups for the trees [t0, t0 + nt) of group
  // g = b % groups (the groups of a tile adjacent, reading the same slabs).
  const int g = static_cast<int>(blockIdx.x % groups);
  const int t0 = static_cast<int>(static_cast<long long>(g) * trees / groups);
  const int nt = static_cast<int>(static_cast<long long>(g + 1) * trees / groups) - t0;
  x_in += t0 * tree_stride;
  x_out += t0 * tree_stride;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ StageInfo info[kMaxLocalStages];
  __shared__ int cross[kMaxLocalStages];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // ring slots, then the tiles
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + kBarBytes);  // `per` tiles
  const int slab = (tile_words + 3) & ~3;  // words per tile and per ring slot
  uint32_t* ring = xs + per * slab;
  const long long base = static_cast<long long>(blockIdx.x / groups) * tile_words;
  const int half = tile_words >> 1;
  if (threadIdx.x == 0) {
    for (int i = 0; i <= slots; ++i) mbar_init(bar + i);
    mbar_fence_init();
  }
  __syncthreads();
  const uint64_t policy = evict_normal_policy();  // the tile's next groups read the slabs
  // The group's tiles on barrier `slots`: one bulk copy each under one
  // arrival where every tree's tile is 16-byte aligned, else word by word.
  const uint32_t bytes = static_cast<uint32_t>(tile_words) * 4u;
  const bool bulk = bulk_ok(x_in + base, bytes) && (tree_stride & 3) == 0;
  if (bulk) {
    if (threadIdx.x == 0) {
      const uint64_t once = evict_first_policy();  // each tree's words are read once
      mbar_arrive_expect_tx(bar + slots, bytes * static_cast<uint32_t>(nt));
      for (int t = 0; t < nt; ++t) {
        bulk_copy(xs + t * slab, x_in + t * tree_stride + base, bytes, bar + slots, once);
      }
    }
  } else {
    for (int t = 0; t < nt; ++t) {
      for (int i = threadIdx.x; i < tile_words; i += blockDim.x) {
        __pipeline_memcpy_async(xs + t * slab + i, x_in + t * tree_stride + base + i,
                                sizeof(uint32_t));
      }
    }
    __pipeline_commit();
  }
  if (threadIdx.x < st.count) {
    const int s = threadIdx.x;
    StageInfo f;
    f.m = masks + st.offset[s];
    f.d = st.d[s];
    f.compact = st.compact[s];
    f.at = f.compact ? base >> 1 : base;
    f.words = f.compact ? half : tile_words;
    f.lo = st.lo[s];
    f.hi = st.hi[s];
    f.live = f.at < f.hi && f.at + f.words > f.lo;
    info[s] = f;
  }
  if (threadIdx.x < st.ncross) cross[threadIdx.x] = st.cross[threadIdx.x];
  __syncthreads();
  const int count = st.count, ncross = st.ncross;
  auto issue = [&](int c) {
    const StageInfo& f = info[cross[c]];
    if (f.live) fetch(ring + (c % slots) * slab, f.m + f.at, f.words, bar + c % slots, policy);
  };
  for (int c = 0; c < ncross && c < slots; ++c) issue(c);
  uint32_t parity = 0;
  if (bulk) {
    mbar_wait(bar + slots, 0u);
  } else {
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  const bool quads = (tile_words & 7) == 0;

  int c = 0;
  for (int s = 0; s < count;) {
    const StageInfo& f = info[s];
    if (f.d < 32) {
      int len = 1;
      bool live = f.live;
      while (s + len < count && len < kMaxSweep && info[s + len].d < 32) {
        live = live || info[s + len].live;
        ++len;
      }
      if (live) {
        if (quads) {
          for (int q = threadIdx.x; q < (tile_words >> 2); q += blockDim.x) {
            sweep_group_quad(xs, slab, nt, info, s, len, base, q);
          }
        } else {
          for (int i = threadIdx.x; i < tile_words; i += 2 * blockDim.x) {
            const int i2 = i + blockDim.x;
            sweep_group(xs, slab, nt, info, s, len, base, i, i2 < tile_words, i2);
          }
        }
        __syncthreads();
      }
      s += len;
      continue;
    }
    if (f.live) {
      const int k = c % slots;
      fetched(f.m + f.at, f.words, bar, k, parity);
      const uint32_t* m = ring + k * slab;
      const int dw = f.d >> 5;
      const bool compact = f.compact != 0;
      if (quads) {
        ring_stage_quads(xs, slab, nt, m, tile_words, dw, compact);
      } else {
        for (int p = threadIdx.x; p < half; p += blockDim.x) {
          const int w = ((p & ~(dw - 1)) << 1) | (p & (dw - 1));
          const uint32_t mk = m[compact ? p : w];
          if (mk == 0u) continue;
          for (int t = 0; t < nt; ++t) {
            uint32_t* x = xs + t * slab;
            const uint32_t a = x[w];
            const uint32_t b = x[w + dw];
            const uint32_t swap = (a ^ b) & mk;
            if (swap) {
              x[w] = a ^ swap;
              x[w + dw] = b ^ swap;
            }
          }
        }
      }
      __syncthreads();  // the tiles consistent, and the slot free
    }
    if (c + slots < ncross) issue(c + slots);
    ++c;
    ++s;
  }
  const bool vec = (tile_words & 3) == 0 && (tree_stride & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(x_out + base) & 15u) == 0;
  for (int t = 0; t < nt; ++t) {
    const uint32_t* x = xs + t * slab;
    uint32_t* dst = x_out + t * tree_stride + base;
    if (vec) {
      for (int i = 4 * threadIdx.x; i < tile_words; i += 4 * blockDim.x) {
        *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(x + i);
      }
    } else {
      for (int i = threadIdx.x; i < tile_words; i += blockDim.x) dst[i] = x[i];
    }
  }
}

// ---------------------------------------------------------------------------
// benes_outer_pass — replaces the outer mode of bfs_tpu/ops/relay_pallas.py
// _run_pass (K2: passes A and C, which fuse the outer prefix and suffix).
//
// One launch applies a run of k outer stages of one side of a network, in
// the network's order: word distances dw = 2^b for the k consecutive bits b
// in [b0, b0 + k) (each once).  A block owns a unit of R = 2^lg_row
// consecutive low words times all 2^k combinations of those bits, for one
// value of the other bits: R * 2^k words, 2^k coalesced rows of R words
// (R <= 2^b0, at most kOuterWords in all).  Slot i of the unit is word
// base + (i mod R) + (i / R) * 2^b0, so the stage of bit b0 + j pairs slots
// (i, i + R * 2^j) and every pair of every stage lies inside the unit.
// Each stage's mask is read at the lower word w (full storage) or at its
// pair number p = ((w >> (b+1)) << b) | (w & (2^b - 1)) (pair-compacted
// storage, which every outer stage at scale >= 13 has): R consecutive
// lanes read R consecutive mask words.  All of a thread's mask words, for
// every stage, are loaded into registers and the unit's words copied into
// shared memory (cp.async, 16 bytes a copy where rows hold whole aligned
// quads) before the block waits, so it waits for one round trip; the k
// stages then run in shared memory with one barrier each, and the words
// are written back once.  Every word is read and written by exactly one
// block, so x_in == x_out is allowed.
// Bound: bytes — the words read and written once, each stage's stored
// masks read once.  The design it replaces launched once per stage and
// moved every word through device memory per stage (24 launches per
// single-source superstep at s22).  What stays above the bound: the rows
// are short runs at a stride of 2^b0 words, and a block's load, compute
// and store phases do not overlap.  kOuterWords and kOuterThreads were
// chosen with bfs_tpu_torch/tools/benes_pass_sweep.py on the net's 7-stage
// prefix at R-MAT scale 22; PERF.md records the sweep.
// ---------------------------------------------------------------------------
constexpr int kMaxOuterStages = 8;
constexpr int kOuterThreads = 256;
constexpr int kOuterWords = 2048;  // words per unit at most
constexpr int kOuterPairs = kOuterWords / 2 / kOuterThreads;  // pairs per thread and stage

struct OuterStages {
  long long offset[kMaxOuterStages];  // word offset of the stage's masks
  int bit[kMaxOuterStages];           // log2(dw) - b0
  int compact[kMaxOuterStages];       // pair-compacted storage
  int count;
};

// Slot of pair q's lower word, pairs at slot distance 2^e.
__device__ __forceinline__ int lower_slot(int q, int e) {
  return ((q >> e) << (e + 1)) | (q & ((1 << e) - 1));
}

__global__ void __launch_bounds__(kOuterThreads)
benes_outer_pass_kernel(const uint32_t* x_in, uint32_t* x_out,
                        const uint32_t* __restrict__ masks, const OuterStages st,
                        int b0, int k, int lg_row, int quads,
                        const int32_t* __restrict__ ctl) {
  if (superstep_dead(ctl)) return;
  __shared__ __align__(16) uint32_t xs[kOuterWords];
  const int row = 1 << lg_row;
  const int words = row << k;
  const int pairs = words >> 1;
  const int mid_bits = b0 - lg_row;
  const long long u = blockIdx.x;
  const long long base = ((u & ((1LL << mid_bits) - 1)) << lg_row) |
                         ((u >> mid_bits) << (b0 + k));
  auto word_of = [&](int i) {
    return base + (i & (row - 1)) + (static_cast<long long>(i >> lg_row) << b0);
  };
  uint32_t m[kMaxOuterStages][kOuterPairs];
#pragma unroll
  for (int s = 0; s < kMaxOuterStages; ++s) {
#pragma unroll
    for (int v = 0; v < kOuterPairs; ++v) {
      const int q = threadIdx.x + v * kOuterThreads;
      m[s][v] = 0u;
      if (s < st.count && q < pairs) {
        const int b = b0 + st.bit[s];
        const long long w = word_of(lower_slot(q, lg_row + st.bit[s]));
        const long long at =
            st.compact[s] ? (((w >> (b + 1)) << b) | (w & ((1LL << b) - 1))) : w;
        m[s][v] = __ldg(masks + st.offset[s] + at);
      }
    }
  }
  if (quads) {
    for (int i = 4 * threadIdx.x; i < words; i += 4 * kOuterThreads) {
      __pipeline_memcpy_async(xs + i, x_in + word_of(i), 4 * sizeof(uint32_t));
    }
  } else {
    for (int i = threadIdx.x; i < words; i += kOuterThreads) {
      __pipeline_memcpy_async(xs + i, x_in + word_of(i), sizeof(uint32_t));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kMaxOuterStages; ++s) {
    if (s >= st.count) break;
    const int e = lg_row + st.bit[s];
#pragma unroll
    for (int v = 0; v < kOuterPairs; ++v) {
      const int q = threadIdx.x + v * kOuterThreads;
      if (q < pairs) {
        const int i = lower_slot(q, e);
        const uint32_t a = xs[i];
        const uint32_t b = xs[i + (1 << e)];
        const uint32_t t = (a ^ b) & m[s][v];
        xs[i] = a ^ t;
        xs[i + (1 << e)] = b ^ t;
      }
    }
    __syncthreads();
  }
  if (quads) {
    for (int i = 4 * threadIdx.x; i < words; i += 4 * kOuterThreads) {
      *reinterpret_cast<uint4*>(x_out + word_of(i)) = *reinterpret_cast<const uint4*>(xs + i);
    }
  } else {
    for (int i = threadIdx.x; i < words; i += kOuterThreads) x_out[word_of(i)] = xs[i];
  }
}

// ---------------------------------------------------------------------------
// benes_outer_group — benes_outer_pass on the lock-step batch's [S, n/32]
// words (passes A and C of the reference's _run_pass, lifted over its
// sources axis).
//
// One block owns a unit, as the single pass's, for a group of trees (the S
// trees split into `groups` groups as evenly as they go): it loads the
// unit's mask words into registers once and runs the stages on each tree of
// the group in turn, the words of tree t + 1 copied into the second of two
// shared-memory buffers (cp.async) while the stages run on tree t, and tree
// t's words stored while tree t + 1's stages wait for their copy.  So each
// unit's masks are read once per group instead of once per tree, and a
// block's copies overlap its work.  The groups of a unit are adjacent blocks.
// The launcher picks the group: at most kOuterGroup trees.
// Bound: bytes — every tree's words read and written once, each stage's
// stored masks read once.
// ---------------------------------------------------------------------------
constexpr int kOuterGroup = 8;        // trees a block of the batch takes at most
constexpr int kOuterGroupBlocks = 4;  // blocks an SM holds at least (caps the registers)

__global__ void __launch_bounds__(kOuterThreads, kOuterGroupBlocks)
benes_outer_group_kernel(const uint32_t* x_in, uint32_t* x_out,
                         const uint32_t* __restrict__ masks, const OuterStages st,
                         int b0, int k, int lg_row, int quads, int trees, int groups,
                         long long tree_stride, const int32_t* __restrict__ ctl) {
  if (superstep_dead(ctl)) return;
  __shared__ __align__(16) uint32_t xs[2][kOuterWords];
  // Block b: unit b / groups for the trees [t0, t1) of group b % groups.
  const int g = static_cast<int>(blockIdx.x % groups);
  const int t0 = static_cast<int>(static_cast<long long>(g) * trees / groups);
  const int t1 = static_cast<int>(static_cast<long long>(g + 1) * trees / groups);
  const int row = 1 << lg_row;
  const int words = row << k;
  const int pairs = words >> 1;
  const int mid_bits = b0 - lg_row;
  const long long u = blockIdx.x / groups;
  const long long base = ((u & ((1LL << mid_bits) - 1)) << lg_row) |
                         ((u >> mid_bits) << (b0 + k));
  auto word_of = [&](int i) {
    return base + (i & (row - 1)) + (static_cast<long long>(i >> lg_row) << b0);
  };
  // Tree t's words of the unit into buf, as one committed group.
  auto load = [&](int t, uint32_t* buf) {
    const uint32_t* src = x_in + t * tree_stride;
    if (quads) {
      for (int i = 4 * threadIdx.x; i < words; i += 4 * kOuterThreads) {
        __pipeline_memcpy_async(buf + i, src + word_of(i), 4 * sizeof(uint32_t));
      }
    } else {
      for (int i = threadIdx.x; i < words; i += kOuterThreads) {
        __pipeline_memcpy_async(buf + i, src + word_of(i), sizeof(uint32_t));
      }
    }
    __pipeline_commit();
  };
  load(t0, xs[0]);
  uint32_t m[kMaxOuterStages][kOuterPairs];
#pragma unroll
  for (int s = 0; s < kMaxOuterStages; ++s) {
#pragma unroll
    for (int v = 0; v < kOuterPairs; ++v) {
      const int q = threadIdx.x + v * kOuterThreads;
      m[s][v] = 0u;
      if (s < st.count && q < pairs) {
        const int b = b0 + st.bit[s];
        const long long w = word_of(lower_slot(q, lg_row + st.bit[s]));
        const long long at =
            st.compact[s] ? (((w >> (b + 1)) << b) | (w & ((1LL << b) - 1))) : w;
        m[s][v] = __ldg(masks + st.offset[s] + at);
      }
    }
  }
  for (int t = t0; t < t1; ++t) {
    uint32_t* cur = xs[(t - t0) & 1];
    // The other buffer's last reads (tree t - 1's stores) passed the barrier
    // that ended the previous tree.
    if (t + 1 < t1) {
      load(t + 1, xs[(t + 1 - t0) & 1]);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kMaxOuterStages; ++s) {
      if (s >= st.count) break;
      const int e = lg_row + st.bit[s];
#pragma unroll
      for (int v = 0; v < kOuterPairs; ++v) {
        const int q = threadIdx.x + v * kOuterThreads;
        if (q < pairs) {
          const int i = lower_slot(q, e);
          const uint32_t a = cur[i];
          const uint32_t b = cur[i + (1 << e)];
          const uint32_t swap = (a ^ b) & m[s][v];
          if (swap) {
            cur[i] = a ^ swap;
            cur[i + (1 << e)] = b ^ swap;
          }
        }
      }
      __syncthreads();
    }
    uint32_t* dst = x_out + t * tree_stride;
    if (quads) {
      for (int i = 4 * threadIdx.x; i < words; i += 4 * kOuterThreads) {
        *reinterpret_cast<uint4*>(dst + word_of(i)) = *reinterpret_cast<const uint4*>(cur + i);
      }
    } else {
      for (int i = threadIdx.x; i < words; i += kOuterThreads) dst[word_of(i)] = cur[i];
    }
    __syncthreads();  // cur is refilled with tree t + 2's words
  }
}

// ---------------------------------------------------------------------------
// class_rowmin — replaces bfs_tpu/ops/relay_pallas.py _class_tournament_call
// (K3, behind rowmin_ranks_pallas, and the reference's vmap of it over the
// lock-step batch's sources axis in _relay_multi_fused_program), and the
// vertex-major classes that the reference leaves to XLA.
//
// Output: uint32[vr] per tree, the min active rank (over l1 & valid) per
// relabeled vertex, or the sentinel.  One launch covers every class of
// every tree through a small device table of work items (kind, va, count,
// sa/32, width, chunks, rows, first block; ops/relay_cuda.py rowmin_items
// builds it, the items of the longest chains first).  A block is kWarps
// warps and takes one table block for a group of trees (the S trees split
// into `groups` groups as evenly as they go; one tree, the single search,
// is a group of one; the groups of a table block are adjacent blocks):
// each valid word it loads is ANDed with every tree's l1 word of the group,
// and the item is found once for them.  Each tree keeps its own found
// mask, and a tree's loads stop once it is done; the others read on, to
// the end of their rows and no further.
//   kind 0, rank-major (cw = count/32 column words of `width` rows): the
//     rows are split into `chunks` C (a power of two up to 32) of `rows`
//     each, and a block covers W = kThreads / C column words with all C
//     chunks, thread t taking word t % W and chunk t / W (a warp reads 32,
//     16 or 8 consecutive words of a row: whole 32-byte sectors).  A thread
//     scans its chunk's rows in ascending order, group_rows(kG) rows' loads
//     in flight for the group at a time, and a tree is done once its 32
//     bits are found; the first row that sets a bit is its rank within the
//     chunk.  A tree's ranks are bit planes: plane k holds bit k of the
//     rank, ORed in when the bit is first found, so a thread stages a found
//     word and ceil(log2(rows)) planes per tree in shared memory — no
//     sentinel fill, no 32 ranks a thread.  The chunks hold disjoint
//     ascending rows, so a bit's rank is the one of the first chunk whose
//     found word holds it (== the tournament's min row index; zero rows
//     never win), written four outputs a thread (one 16-byte store where
//     `quads`); with one chunk a warp writes its own words after a warp
//     barrier only.
//   kind 1, vertex-major narrower than ROWMIN_WIDE_BITS: one warp per
//     vertex, 16-byte loads from the aligned word below the row's first
//     (words outside the row masked off), 128 words a step; per tree a
//     ballot of the lanes' lowest hits, the first lane's winning.
//   kind 3, vertex-major at least ROWMIN_WIDE_BITS wide: one block per
//     vertex, 16-byte loads as kind 1's, 1024 words a step; the block's
//     per-tree "found" bits are ORed through shared memory after each step.
//   kind 2: the sentinel tail [covered, vr), every tree of the group.
// The launcher picks the group: as many trees as the staging leaves room
// for, at most kRowminGroup, and launches the instance of the next power of
// two.
// Bound: bytes — the valid words once, every tree's slot words read and vr
// outputs written; an early exit at first hits needs only the rows up to
// each column word's last first hit and each vertex's words up to its
// first hit.  What held the earlier designs: one thread walked a column
// word's rows as a chain of dependent loads (the first: all 1,536 rows at
// s22, 0.7322 ms against a 0.0096 ms bound); a block of the batch took one
// tree, with the item search, a 32-rank sentinel fill and a barrier per
// 1,024 words of a vertex-major row for each (PERF.md).
// ---------------------------------------------------------------------------
constexpr int kWarps = kThreads / 32;
constexpr int kRowBatch = 8;       // rows in flight at one tree (a group: about as many loads)
constexpr int kRowminGroup = 4;    // trees a block takes at most
constexpr int kRowminBlocks = 4;   // blocks an SM holds at least (caps the registers)
constexpr size_t kRowminStatic = 1024;  // static shared memory of the kernel, at most
constexpr uint32_t kAll = 0xFFFFFFFFu;
static_assert(kRowminGroup >= 1 && kRowminGroup <= 16, "kRowminGroup: 1 to 16 trees");
static_assert((2 + 16) * kWarps * sizeof(uint32_t) <= kRowminStatic,
              "the row-min's reductions outgrow kRowminStatic");

struct RowminItem {
  long long kind, va, count, sa_word, width, chunks, rows, block0;
};

// Rows a thread of a group of kG trees loads at a time: about 2 * kRowBatch
// loads, a valid word and kG l1 words a row.
__host__ __device__ constexpr int group_rows(int kG) {
  return 2 * kRowBatch / (kG + 1) > 1 ? 2 * kRowBatch / (kG + 1) : 1;
}

// The item owning table block `block`: the last one whose first block <= block.
__device__ __forceinline__ RowminItem rowmin_item(const RowminItem* __restrict__ items,
                                                  int nitems, long long block) {
  int lo = 0, hi = nitems - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (items[mid].block0 <= block) lo = mid; else hi = mid - 1;
  }
  return items[lo];
}

// Rank planes of a chunk of `rows` rows: bits of a rank within it.
__device__ __forceinline__ int rank_planes(long long rows) {
  return rows > 1 ? 32 - __clz(static_cast<uint32_t>(rows - 1)) : 0;
}

template <int kG>
__device__ __forceinline__ void rowmin_rank_major(
    const uint32_t* __restrict__ l1, const uint32_t* __restrict__ valid,
    uint32_t* __restrict__ out, const RowminItem& it, long long b, int nt,
    long long l1_stride, long long out_stride, bool quads, uint32_t* stage) {
  constexpr int kRows = group_rows(kG);
  const int tid = threadIdx.x, lane = tid & 31;
  const int chunks = static_cast<int>(it.chunks);
  const int lg_w = __ffs(kThreads / chunks) - 1;  // W = kThreads / chunks words a block
  const int word = tid & ((1 << lg_w) - 1), chunk = tid >> lg_w;
  const long long cw = it.count >> 5;
  const long long j0 = b << lg_w;  // the block's first column word
  const long long j = j0 + word;
  const long long r0 = chunk * it.rows;
  const long long r1 = r0 + it.rows < it.width ? r0 + it.rows : it.width;
  const int planes = rank_planes(it.rows);
  // Tree g's found words at stage[g * (1 + planes) * kThreads + thread], its
  // plane k at stage[(g * (1 + planes) + 1 + k) * kThreads + thread].
  const int tree_words = (1 + planes) * kThreads;
  uint32_t found[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    found[g] = g < nt ? 0u : kAll;  // a missing tree counts as done
    if (g < nt) {
      for (int k = 1; k <= planes; ++k) stage[g * tree_words + k * kThreads + tid] = 0;
    }
  }
  if (j < cw) {
    const uint32_t* __restrict__ x = l1 + it.sa_word + j;
    const uint32_t* __restrict__ v = valid + it.sa_word + j;
    uint32_t all = 0u;  // the trees' found words ANDed: kAll once every tree is done
    for (long long r = r0; r < r1 && all != kAll; r += kRows) {
      uint32_t vw[kRows], w[kRows][kG];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const long long at = (r + u) * cw;
        const bool in = r + u < r1;
        vw[u] = in ? __ldg(v + at) : 0u;
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          w[u][g] = in && found[g] != kAll ? __ldg(x + g * l1_stride + at) : 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const uint32_t rank = static_cast<uint32_t>(r + u - r0);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const uint32_t hit = w[u][g] & vw[u];
          const uint32_t fresh = hit & ~found[g];
          found[g] |= hit;
          if (fresh) {
            uint32_t* p = stage + g * tree_words + kThreads + tid;
            for (int k = 0; k < planes; ++k) {
              if ((rank >> k) & 1u) p[k * kThreads] |= fresh;
            }
          }
        }
      }
      all = kAll;
#pragma unroll
      for (int g = 0; g < kG; ++g) all &= found[g];
    }
  }
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (g < nt) stage[g * tree_words + tid] = j < cw ? found[g] : 0u;
  }
  // The writers: with one chunk each warp writes its own 32 words, after a
  // warp barrier; else the block writes its W words after a block barrier.
  // Quad q of a writer (outputs 4q .. 4q + 3 of a tree): word w0 + q / 8,
  // bits 4 (q % 8) ..; the staging of (chunk c, word) is thread c W + word's.
  const bool own = chunks == 1;
  if (own) __syncwarp(); else __syncthreads();
  const int lg_words = own ? 5 : lg_w;  // words a writer covers
  const int w0 = own ? tid & ~31 : 0;
  const int first = own ? lane : tid, step = own ? 32 : kThreads;
  const int rows = static_cast<int>(it.rows);
  for (int i = first; i < nt << (lg_words + 3); i += step) {
    const int g = i >> (lg_words + 3), q = i & ((8 << lg_words) - 1);
    const int wd = w0 + (q >> 3), bit0 = (q & 7) * 4;
    if (j0 + wd >= cw) continue;
    const uint32_t* fw = stage + g * tree_words;
    uint32_t r4[4] = {kSentinel, kSentinel, kSentinel, kSentinel};
    uint32_t left = 0xFu;
    for (int c = 0; c < chunks && left; ++c) {
      const int t = (c << lg_w) + wd;
      const uint32_t hit = (fw[t] >> bit0) & left;
      if (hit) {
        uint32_t rk[4] = {0u, 0u, 0u, 0u};
        for (int k = 0; k < planes; ++k) {
          const uint32_t pl = fw[(1 + k) * kThreads + t] >> bit0;
#pragma unroll
          for (int e = 0; e < 4; ++e) rk[e] |= ((pl >> e) & 1u) << k;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if ((hit >> e) & 1u) r4[e] = static_cast<uint32_t>(c * rows) + rk[e];
        }
        left &= ~hit;
      }
    }
    uint32_t* o = out + g * out_stride + it.va + (j0 + wd) * 32 + bit0;
    if (quads) {
      *reinterpret_cast<uint4*>(o) = make_uint4(r4[0], r4[1], r4[2], r4[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = r4[e];
    }
  }
}

// The lowest hit of the four words at 16-byte index q of a vertex-major row
// [row, end) (aligned base a0), or the sentinel: its rank in the row.
__device__ __forceinline__ uint32_t quad_rank(uint4 x, uint4 v, long long a0, long long q,
                                              long long row, long long end) {
  const uint32_t w[4] = {x.x & v.x, x.y & v.y, x.z & v.z, x.w & v.w};
  uint32_t best = kSentinel;
#pragma unroll
  for (int u = 3; u >= 0; --u) {  // the lowest hit word of the four wins
    const long long k = a0 + 4 * q + u;
    if (w[u] && k >= row && k < end) {
      best = static_cast<uint32_t>((k - row) * 32 + (__ffs(w[u]) - 1));
    }
  }
  return best;
}

template <int kG>
__device__ __forceinline__ void rowmin_narrow_vertex(
    const uint32_t* __restrict__ l1, const uint32_t* __restrict__ valid,
    uint32_t* __restrict__ out, const RowminItem& it, long long b, int nt,
    long long l1_stride, long long out_stride) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long p = b * kWarps + warp;
  if (p >= it.count) return;
  const long long row = it.sa_word + p * (it.width >> 5);
  const long long end = row + (it.width >> 5);
  const long long a0 = row & ~3LL;
  const long long n4 = (((end + 3) & ~3LL) - a0) >> 2;
  const uint4* __restrict__ v4 = reinterpret_cast<const uint4*>(valid + a0);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint32_t rank[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) rank[g] = kSentinel;
  uint32_t pending = (1u << nt) - 1;  // warp-uniform: the trees not yet hit
  for (long long q0 = 0; q0 < n4 && pending; q0 += 32) {
    const long long q = q0 + lane;
    const bool in = q < n4;
    const uint4 va = in ? __ldg(v4 + q) : zero;
    uint4 xa[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      xa[g] = in && ((pending >> g) & 1u)
                  ? __ldg(reinterpret_cast<const uint4*>(l1 + g * l1_stride + a0) + q)
                  : zero;
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if ((pending >> g) & 1u) {
        const uint32_t mine = quad_rank(xa[g], va, a0, q, row, end);
        const uint32_t hit = __ballot_sync(kAll, mine != kSentinel);
        if (hit) {
          rank[g] = __shfl_sync(kAll, mine, __ffs(hit) - 1);  // the lowest lane: the lowest word
          pending &= ~(1u << g);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (g < nt && lane == g) out[g * out_stride + it.va + p] = rank[g];
  }
}

template <int kG>
__device__ __forceinline__ void rowmin_wide_vertex(
    const uint32_t* __restrict__ l1, const uint32_t* __restrict__ valid,
    uint32_t* __restrict__ out, const RowminItem& it, long long p, int nt,
    long long l1_stride, long long out_stride, uint32_t* red) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row = it.sa_word + p * (it.width >> 5);
  const long long end = row + (it.width >> 5);
  const long long a0 = row & ~3LL;
  const long long n4 = (((end + 3) & ~3LL) - a0) >> 2;
  const uint4* __restrict__ v4 = reinterpret_cast<const uint4*>(valid + a0);
  uint32_t best[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) best[g] = kSentinel;
  uint32_t pending = (1u << nt) - 1;  // block-uniform: the trees not yet hit
  int flip = 0;                       // red[flip * kWarps ...]: this step's found bits
  for (long long q0 = 0; q0 < n4 && pending; q0 += kThreads) {
    const long long q = q0 + tid;
    if (q < n4) {
      const uint4 va = __ldg(v4 + q);
      uint4 xa[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        xa[g] = (pending >> g) & 1u
                    ? __ldg(reinterpret_cast<const uint4*>(l1 + g * l1_stride + a0) + q)
                    : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if ((pending >> g) & 1u) best[g] = quad_rank(xa[g], va, a0, q, row, end);
      }
    }
    uint32_t mine = 0;
#pragma unroll
    for (int g = 0; g < kG; ++g) mine |= best[g] != kSentinel ? 1u << g : 0u;
    mine = __reduce_or_sync(kAll, mine);
    if (lane == 0) red[flip * kWarps + warp] = mine;
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) pending &= ~red[flip * kWarps + w];
    flip ^= 1;
  }
  uint32_t* mins = red + 2 * kWarps;  // [kG][kWarps]
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const uint32_t m = __reduce_min_sync(kAll, best[g]);
    if (lane == 0) mins[g * kWarps + warp] = m;
  }
  __syncthreads();
  if (tid < nt) {
    uint32_t m = kSentinel;
    for (int w = 0; w < kWarps; ++w) m = min(m, mins[tid * kWarps + w]);
    out[tid * out_stride + it.va + p] = m;
  }
}

template <int kG>
__global__ void __launch_bounds__(kThreads, kRowminBlocks)
class_rowmin_kernel(const uint32_t* __restrict__ l1,
                    const uint32_t* __restrict__ valid,
                    uint32_t* __restrict__ out,
                    const RowminItem* __restrict__ items, int nitems, int trees,
                    int groups, long long l1_stride, long long out_stride, int quads,
                    const int32_t* __restrict__ ctl) {
  extern __shared__ __align__(16) uint32_t stage[];
  __shared__ uint32_t red[(2 + kG) * kWarps];
  if (superstep_dead(ctl)) return;
  // Block x: table block x / groups for the trees [t0, t0 + nt) of group
  // x % groups.
  const int grp = static_cast<int>(blockIdx.x % groups);
  const int t0 = static_cast<int>(static_cast<long long>(grp) * trees / groups);
  const int nt = static_cast<int>(static_cast<long long>(grp + 1) * trees / groups) - t0;
  const long long block = blockIdx.x / groups;
  const RowminItem it = rowmin_item(items, nitems, block);
  const long long b = block - it.block0;
  l1 += t0 * l1_stride;
  out += t0 * out_stride;
  if (it.kind == 0) {
    rowmin_rank_major<kG>(l1, valid, out, it, b, nt, l1_stride, out_stride, quads != 0, stage);
  } else if (it.kind == 3) {
    rowmin_wide_vertex<kG>(l1, valid, out, it, b, nt, l1_stride, out_stride, red);
  } else if (it.kind == 1) {
    rowmin_narrow_vertex<kG>(l1, valid, out, it, b, nt, l1_stride, out_stride);
  } else {
    const long long v = b * kThreads + threadIdx.x;
    if (v < it.count) {
      for (int g = 0; g < nt; ++g) out[g * out_stride + it.va + v] = kSentinel;
    }
  }
}

// ---------------------------------------------------------------------------
// packed_update — replaces bfs_tpu/ops/relay_pallas.py
// apply_relay_candidates_packed_pallas (K4, body _apply_packed_kernel_factory).
//
// One thread per vertex: pk2 = min(pk, cand | level_bits) in unsigned order.
// The warp's ballot of (pk2 != pk) is the standard-packed frontier word of
// its 32 vertices (vr is a multiple of 32, so warps never straddle it), and
// a block OR of those bits sets the device `changed` flag.  A batch's trees
// are grid rows (blockIdx.y) and share the one flag: the lock-step loop's
// changed is any tree's (the reference's per.changed.any()).  Outside the
// block loop (ctl null) level_bits is a launch parameter and `changed` a
// flag the launcher zeroes first on the same stream; inside it, the level
// is the control block's (level + 1) << kParentBits and `changed` is its
// flag word, which the control step clears.
// Bound: bytes — packed and cand read once, packed and vr/32 frontier words
// written once.  In place when packed_in == packed_out.
// ---------------------------------------------------------------------------
constexpr int kParentBits = 26;  // the packed word is level:6 | parent:26

__global__ void __launch_bounds__(kThreads)
packed_update_kernel(const uint32_t* packed_in, const uint32_t* __restrict__ cand,
                     uint32_t* packed_out, uint32_t* __restrict__ fwords,
                     int32_t* __restrict__ changed, long long vr, long long stride,
                     long long cstride, long long fstride, uint32_t level_bits,
                     const int32_t* __restrict__ ctl) {
  if (superstep_dead(ctl)) return;
  // blockIdx.y: the tree (words at `stride`, candidates at `cstride`,
  // frontier words at `fstride`).
  const long long tree = blockIdx.y;
  packed_in += tree * stride;
  cand += tree * cstride;
  packed_out += tree * stride;
  fwords += tree * fstride;
  if (ctl != nullptr) {
    level_bits = static_cast<uint32_t>(ctl_word(ctl, kCtlLevel) + 1) << kParentBits;
  }
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool newly = false;
  if (v < vr) {
    const uint32_t pk = packed_in[v];
    const uint32_t c = __ldg(cand + v) | level_bits;
    const uint32_t pk2 = c < pk ? c : pk;
    newly = pk2 != pk;
    packed_out[v] = pk2;
  }
  const uint32_t word = __ballot_sync(0xFFFFFFFFu, newly);
  if ((threadIdx.x & 31) == 0 && v < vr) fwords[v >> 5] = word;
  if (__syncthreads_or(newly) && threadIdx.x == 0) *changed = 1;
}

// ---------------------------------------------------------------------------
// loop_control — replaces the while-loop condition of the reference's fused
// programs (bfs_tpu/models/bfs.py _relay_fused_program and
// _relay_elem_program: st.changed & (st.level < cap), evaluated by XLA on
// the device).  No kernel of the reference: XLA's loop did it.
//
// One thread, after a superstep's update: if the superstep was live,
// level += 1, changed = flag and steps += 1; then the flag is cleared and
// live = changed && level < cap.  A superstep that was not live leaves
// every word as it was.
// Bound: bytes — six words read and written.
// ---------------------------------------------------------------------------
__global__ void loop_control_kernel(int32_t* ctl) {
  if (ctl[kCtlLive]) {
    ctl[kCtlLevel] += 1;
    ctl[kCtlChanged] = ctl[kCtlFlag] != 0;
    ctl[kCtlSteps] += 1;
  }
  ctl[kCtlFlag] = 0;
  ctl[kCtlLive] = ctl[kCtlChanged] != 0 && ctl[kCtlLevel] < ctl[kCtlCap];
}

// Groups of a batch's trees when a block takes at most `most` of them; the
// kernels split the trees into them as evenly as they go, so a block takes
// at most ceil(trees / groups).
int groups_of(int trees, int most) { return (trees + most - 1) / most; }

// Groups of the batched local pass on tiles of `tile_words`: a block takes
// at most kLocalGroup trees, as many tiles as leave room for two ring slots
// (at least one tree, with one slot).
int local_groups(int trees, int tile_words) {
  const size_t slab = static_cast<size_t>((tile_words + 3) & ~3) * sizeof(uint32_t);
  const long long fit = static_cast<long long>((kSmemLimit - kTableSmem - kBarBytes) / slab) - 2;
  const int most = fit < 1 ? 1 : (fit < kLocalGroup ? static_cast<int>(fit) : kLocalGroup);
  return groups_of(trees, most);
}

// Bytes of a block of class_rowmin's staging per tree of its group when
// its rank-major items need at most `planes` rank planes: a found word and
// the planes, a word each per thread.
size_t rowmin_tree_bytes(int planes) {
  return static_cast<size_t>(1 + planes) * kThreads * sizeof(uint32_t);
}

// Groups of the row-min: a block takes at most kRowminGroup trees, as many
// as the staging leaves room for (at least one).
int rowmin_groups(int trees, int planes) {
  const long long fit =
      static_cast<long long>((kSmemLimit - kRowminStatic) / rowmin_tree_bytes(planes));
  const int most = fit < 1 ? 1 : (fit < kRowminGroup ? static_cast<int>(fit) : kRowminGroup);
  return groups_of(trees, most);
}

struct RowminLaunch {
  const uint32_t* l1;
  const uint32_t* valid;
  uint32_t* out;
  const RowminItem* items;
  int nitems;
  long long total_blocks;
  int trees, groups, planes;
  long long l1_stride, out_stride;
  bool quads;  // out and its tree stride allow 16-byte stores
  const int32_t* ctl;
  cudaStream_t stream;
};

// class_rowmin's instance for the fullest group of `per` trees: the least
// kG = 1, 2, 4 ... at least `per` (instances up to kRowminGroup only).
template <int kG>
int launch_rowmin(const RowminLaunch& a, int per) {
  if constexpr (kG < kRowminGroup) {
    if (per > kG) return launch_rowmin<2 * kG>(a, per);
  }
  const size_t smem = static_cast<size_t>(per) * rowmin_tree_bytes(a.planes);  // dynamic
  static size_t configured = 0;
  if (smem > configured) {
    cudaFuncSetAttribute(class_rowmin_kernel<kG>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    configured = smem;
  }
  class_rowmin_kernel<kG>
      <<<static_cast<unsigned>(a.total_blocks * a.groups), kThreads, smem, a.stream>>>(
          a.l1, a.valid, a.out, a.items, a.nitems, a.trees, a.groups, a.l1_stride,
          a.out_stride, a.quads ? 1 : 0, a.ctl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Trees one block of the lock-step batch's local pass (tiles of
// `tile_words`) and outer pass takes, as the launchers below choose them.
int local_pass_group(int trees, int tile_words) {
  if (trees < kBatchTrees) return 1;
  const int groups = local_groups(trees, tile_words);
  return (trees + groups - 1) / groups;
}

int outer_pass_group(int trees) {
  if (trees < kBatchTrees) return 1;
  const int groups = groups_of(trees, kOuterGroup);
  return (trees + groups - 1) / groups;
}

// Trees one block of the row-min takes (its rank-major items need at most
// `planes` rank planes), as class_rowmin chooses them.
int rowmin_group(int trees, int planes) {
  const int groups = rowmin_groups(trees, planes);
  return (trees + groups - 1) / groups;
}

// A batch of at least kBatchTrees trees launches benes_local_group, fewer
// the single search's per-tile kernel (one tree a block).
int benes_local_pass(const void* x_in, void* x_out, const void* masks,
                     const long long* offsets, const int* dists,
                     const int* compact, const int* lo, const int* hi, int nstages,
                     long long nwords, int tile_words, int trees, long long tree_stride,
                     const void* ctl, void* stream) {
  if (nstages > kMaxLocalStages || tile_words <= 0 || nwords % tile_words != 0 || trees < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool batch = trees >= kBatchTrees;
  const int groups = batch ? local_groups(trees, tile_words) : 1;
  const int per = (trees + groups - 1) / groups;  // trees of the fullest group
  if ((nwords / tile_words) * groups > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LocalStages st;
  st.count = nstages;
  st.ncross = 0;
  for (int s = 0; s < nstages; ++s) {
    st.offset[s] = offsets[s];
    st.d[s] = dists[s];
    st.compact[s] = compact[s];
    st.lo[s] = lo[s];
    st.hi[s] = hi[s];
    if (dists[s] >= 32) st.cross[st.ncross++] = s;
  }
  // Shared memory: the stage tables, the barriers, the tiles (one a tree of
  // the group), and as many ring slots of one tile each as fit (at most
  // kMaxRing, at most one per stage with d >= 32).
  const size_t slab = static_cast<size_t>((tile_words + 3) & ~3) * sizeof(uint32_t);
  const size_t fixed = kTableSmem + kBarBytes + per * slab;
  if (fixed + slab > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  size_t slots = (kSmemLimit - fixed) / slab;
  slots = slots < kMaxRing ? slots : kMaxRing;
  const size_t wanted = st.ncross > 0 ? static_cast<size_t>(st.ncross) : 1;
  slots = slots < wanted ? slots : wanted;
  const size_t smem = kBarBytes + (per + slots) * slab;  // dynamic
  static size_t configured[2] = {0, 0};
  if (smem > configured[batch]) {
    if (batch) {
      cudaFuncSetAttribute(benes_local_group_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    } else {
      cudaFuncSetAttribute(benes_local_pass_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    }
    configured[batch] = smem;
  }
  const unsigned blocks = static_cast<unsigned>((nwords / tile_words) * groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* in = static_cast<const uint32_t*>(x_in);
  uint32_t* out = static_cast<uint32_t*>(x_out);
  const uint32_t* m = static_cast<const uint32_t*>(masks);
  const int32_t* c = static_cast<const int32_t*>(ctl);
  if (batch) {
    benes_local_group_kernel<<<blocks, kLocalThreads, smem, s>>>(
        in, out, m, st, tile_words, static_cast<int>(slots), trees, groups, per, tree_stride,
        c);
  } else {
    benes_local_pass_kernel<<<blocks, kLocalThreads, smem, s>>>(
        in, out, m, st, tile_words, static_cast<int>(slots), c);
  }
  return static_cast<int>(cudaGetLastError());
}

// A batch of at least kBatchTrees trees launches benes_outer_group, fewer
// the single search's kernel.
int benes_outer_pass(const void* x_in, void* x_out, const void* masks,
                     const long long* offsets, const int* bits, const int* compact,
                     int nstages, int b0, int k, int lg_row, long long nwords,
                     int trees, long long tree_stride, const void* ctl, void* stream) {
  if (nstages < 1 || nstages > kMaxOuterStages || k < 1 || k > kMaxOuterStages ||
      lg_row < 0 || lg_row > b0 || (1LL << (lg_row + k)) > kOuterWords ||
      (1LL << (b0 + k)) > nwords || nwords % (1LL << (b0 + k)) != 0 || trees < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool batch = trees >= kBatchTrees;
  const int groups = batch ? groups_of(trees, kOuterGroup) : 1;
  if ((nwords >> (lg_row + k)) * groups > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  OuterStages st;
  st.count = nstages;
  for (int s = 0; s < nstages; ++s) {
    if (bits[s] < 0 || bits[s] >= k) return static_cast<int>(cudaErrorInvalidValue);
    st.offset[s] = offsets[s];
    st.bit[s] = bits[s];
    st.compact[s] = compact[s];
  }
  // 16-byte word copies: rows of whole quads, both word arrays (every tree's)
  // 16-byte aligned.
  const bool quads = lg_row >= 2 && (tree_stride & 3) == 0 &&
                     ((reinterpret_cast<uintptr_t>(x_in) |
                       reinterpret_cast<uintptr_t>(x_out)) & 15u) == 0;
  const unsigned blocks = static_cast<unsigned>((nwords >> (lg_row + k)) * groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* in = static_cast<const uint32_t*>(x_in);
  uint32_t* out = static_cast<uint32_t*>(x_out);
  const uint32_t* m = static_cast<const uint32_t*>(masks);
  const int32_t* c = static_cast<const int32_t*>(ctl);
  if (batch) {
    benes_outer_group_kernel<<<blocks, kOuterThreads, 0, s>>>(
        in, out, m, st, b0, k, lg_row, quads ? 1 : 0, trees, groups, tree_stride, c);
  } else {
    benes_outer_pass_kernel<<<blocks, kOuterThreads, 0, s>>>(
        in, out, m, st, b0, k, lg_row, quads ? 1 : 0, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// `planes`: the rank planes the table's rank-major items need at most.
int class_rowmin(const void* l1, const void* valid, void* out,
                 const void* items, int nitems, long long total_blocks, int planes,
                 int trees, long long l1_stride, long long out_stride, const void* ctl,
                 void* stream) {
  if (trees < 1 || planes < 0 || planes > 31 || total_blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = rowmin_groups(trees, planes);
  if (total_blocks * groups > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const RowminLaunch a{static_cast<const uint32_t*>(l1), static_cast<const uint32_t*>(valid),
                       static_cast<uint32_t*>(out), static_cast<const RowminItem*>(items),
                       nitems, total_blocks, trees, groups, planes, l1_stride, out_stride,
                       (reinterpret_cast<uintptr_t>(out) & 15u) == 0 && (out_stride & 3) == 0,
                       static_cast<const int32_t*>(ctl), static_cast<cudaStream_t>(stream)};
  return launch_rowmin<1>(a, (trees + groups - 1) / groups);  // trees of the fullest group
}

// With a control block (ctl not null) `changed` is ignored: the kernel
// raises the block's flag, and nothing is cleared here, so a superstep that
// is not live leaves the flag of the last live one to the control step.
int packed_update(const void* packed_in, const void* cand, void* packed_out,
                  void* fwords, void* changed, long long vr, int trees, long long stride,
                  long long cstride, long long fstride, unsigned level_bits, void* ctl,
                  void* stream) {
  if (trees < 1 || trees > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* c = static_cast<int32_t*>(ctl);
  int32_t* flag = c != nullptr ? c + kCtlFlag : static_cast<int32_t*>(changed);
  if (c == nullptr) cudaMemsetAsync(flag, 0, sizeof(int32_t), s);
  const dim3 blocks(static_cast<unsigned>((vr + kThreads - 1) / kThreads),
                    static_cast<unsigned>(trees));
  packed_update_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(packed_in),
      static_cast<const uint32_t*>(cand), static_cast<uint32_t*>(packed_out),
      static_cast<uint32_t*>(fwords), flag, vr, stride, cstride, fstride, level_bits, c);
  return static_cast<int>(cudaGetLastError());
}

int loop_control(void* ctl, void* stream) {
  loop_control_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(ctl));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
