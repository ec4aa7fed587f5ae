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
// valid words and work tables are shared.  The Beneš passes and the row-min
// put the tree index fastest in blockIdx.x, so the S trees of one tile,
// unit or row block run in adjacent blocks and read the same masks from L2:
// the bound of a batched pass is the masks once plus S times the words.
// Each of these kernels is a template on kBatch: trees == 1 (the single
// search) launches the <false> instance, compiled as before the tree axis.

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
//     per slot, evict-first in L2, evict-normal in a batch, whose next
//     trees' blocks read the same slabs), the next `slots` stages' slabs in
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

template <bool kBatch>
__global__ void __launch_bounds__(kLocalThreads)
benes_local_pass_kernel(const uint32_t* x_in, uint32_t* x_out,
                        const uint32_t* __restrict__ masks,
                        const LocalStages st, int tile_words, int slots, int trees,
                        long long tree_stride, const int32_t* __restrict__ ctl) {
  if (superstep_dead(ctl)) return;
  // Block b: tile b / trees of tree b % trees (the trees of a tile adjacent).
  if (kBatch) {
    const long long tree = blockIdx.x % trees;
    x_in += tree * tree_stride;
    x_out += tree * tree_stride;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ StageInfo info[kMaxLocalStages];
  __shared__ int cross[kMaxLocalStages];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // ring slots, then the tile
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + kBarBytes);
  const int slab = (tile_words + 3) & ~3;  // words per ring slot
  uint32_t* ring = xs + slab;
  const long long base =
      static_cast<long long>(kBatch ? blockIdx.x / trees : blockIdx.x) * tile_words;
  const int half = tile_words >> 1;
  if (threadIdx.x == 0) {
    for (int i = 0; i <= slots; ++i) mbar_init(bar + i);
    mbar_fence_init();
  }
  __syncthreads();
  // A single search reads each slab once; a batch's slabs are read again by
  // the next trees' blocks.
  const uint64_t policy = kBatch ? evict_normal_policy() : evict_first_policy();
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

template <bool kBatch>
__global__ void __launch_bounds__(kOuterThreads)
benes_outer_pass_kernel(const uint32_t* x_in, uint32_t* x_out,
                        const uint32_t* __restrict__ masks, const OuterStages st,
                        int b0, int k, int lg_row, int quads, int trees,
                        long long tree_stride, const int32_t* __restrict__ ctl) {
  if (superstep_dead(ctl)) return;
  __shared__ __align__(16) uint32_t xs[kOuterWords];
  // Block b: unit b / trees of tree b % trees (the trees of a unit adjacent).
  if (kBatch) {
    const long long tree = blockIdx.x % trees;
    x_in += tree * tree_stride;
    x_out += tree * tree_stride;
  }
  const int row = 1 << lg_row;
  const int words = row << k;
  const int pairs = words >> 1;
  const int mid_bits = b0 - lg_row;
  const long long u = kBatch ? blockIdx.x / trees : blockIdx.x;
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
// class_rowmin — replaces bfs_tpu/ops/relay_pallas.py _class_tournament_call
// (K3, behind rowmin_ranks_pallas), and the vertex-major classes that the
// reference leaves to XLA.
//
// Output: uint32[vr], the min active rank (over l1 & valid) per relabeled
// vertex, or the sentinel.  One launch covers every class through a small
// device table of work items (kind, va, count, sa/32, width, chunks, rows,
// first block); a block is kWarps warps:
//   kind 0, rank-major (cw = count/32 column words of `width` rows): the
//     rows are split into `chunks` C in {1, 2, 4, 8} of `rows` each, and a
//     block covers kWarps / C spans of 32 column words with all C chunks,
//     one warp per (span, chunk), lane = column word.  A thread scans its
//     chunk's rows in ascending order, kRowBatch rows' loads in flight at a
//     time, and stops once all 32 bits are found; the first row that sets a
//     lane's bit is that lane's rank within the chunk.  Ranks are staged in
//     shared memory (stride 33 against bank conflicts); the chunks hold
//     disjoint ascending rows, so the min over them is the first row overall
//     (== the tournament's min row index; zero rows never win), written out
//     coalesced.
//   kind 1, vertex-major narrower than ROWMIN_WIDE_BITS (4,096 bits,
//     ops/relay_cuda.py, which builds the table): one warp per vertex scans
//     its width/32 words 32 at a time; the first nonzero word and its lowest
//     set bit give the rank.
//   kind 3, vertex-major at least ROWMIN_WIDE_BITS wide: one block per vertex,
//     16-byte loads from the aligned word below the row's first (words
//     outside the row masked off), 1024 words a step, stopping after the
//     first step with a hit; the min over the block's threads.
//   kind 2: the sentinel tail [covered, vr).
// Bound: bytes — the class slot words of l1 and valid are read once, vr
// words written once.  What held the first design: one thread walked all
// `width` rows of its column word, one row (two loads) at a time, so the
// launch lasted as long as the widest class's chains of dependent steps
// (1,536 rows at s22: 0.7322 ms against a 0.0096 ms bound).  Here no thread
// walks more than ceil(width / 8) rows (32 up to width 256), with
// 2 * kRowBatch loads in flight, and a wide vertex-major row is read by a
// whole block.
// ---------------------------------------------------------------------------
constexpr int kWarps = kThreads / 32;
constexpr int kRowBatch = 16;
constexpr uint32_t kAll = 0xFFFFFFFFu;

struct RowminItem {
  long long kind, va, count, sa_word, width, chunks, rows, block0;
};

__device__ __forceinline__ void rowmin_rank_major(
    const uint32_t* __restrict__ l1, const uint32_t* __restrict__ valid,
    uint32_t* __restrict__ out, const RowminItem& it, long long b,
    uint32_t* ranks) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = static_cast<int>(it.chunks);
  const int spans = kWarps / chunks;  // spans of 32 column words per block
  const long long cw = it.count >> 5;
  const long long span0 = b * spans;
  const long long j = (span0 + warp / chunks) * 32 + lane;
  const long long r0 = (warp % chunks) * it.rows;
  const long long r1 = r0 + it.rows < it.width ? r0 + it.rows : it.width;
  uint32_t* mine = ranks + tid * 33;
  for (int k = 0; k < 32; ++k) mine[k] = kSentinel;
  if (j < cw) {
    const uint32_t* __restrict__ x = l1 + it.sa_word + j;
    const uint32_t* __restrict__ v = valid + it.sa_word + j;
    uint32_t found = 0;
    for (long long r = r0; r < r1 && found != kAll; r += kRowBatch) {
      uint32_t w[kRowBatch];
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) {
        const long long at = (r + u) * cw;
        w[u] = r + u < r1 ? __ldg(x + at) & __ldg(v + at) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) {
        uint32_t fresh = w[u] & ~found;
        found |= w[u];
        while (fresh) {
          mine[__ffs(fresh) - 1] = static_cast<uint32_t>(r + u);
          fresh &= fresh - 1;
        }
      }
    }
  }
  __syncthreads();
  // Output i of the block: span i >> 10, column word (i >> 5) & 31, bit
  // i & 31; the staged rank of (span s, chunk c, word) is at thread
  // (s * chunks + c) * 32 + word.
  for (int i = tid; i < spans * 1024; i += kThreads) {
    const int s = i >> 10, word = (i >> 5) & 31, bit = i & 31;
    if ((span0 + s) * 32 + word >= cw) continue;
    uint32_t best = kSentinel;
    for (int c = 0; c < chunks; ++c) {
      best = min(best, ranks[((s * chunks + c) * 32 + word) * 33 + bit]);
    }
    out[it.va + span0 * 1024 + i] = best;
  }
}

__device__ __forceinline__ void rowmin_wide_vertex(
    const uint32_t* __restrict__ l1, const uint32_t* __restrict__ valid,
    uint32_t* __restrict__ out, const RowminItem& it, long long p,
    uint32_t* warp_min) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row = it.sa_word + p * (it.width >> 5);
  const long long end = row + (it.width >> 5);
  const long long a0 = row & ~3LL;
  const long long n4 = (((end + 3) & ~3LL) - a0) >> 2;
  const uint4* __restrict__ x4 = reinterpret_cast<const uint4*>(l1 + a0);
  const uint4* __restrict__ v4 = reinterpret_cast<const uint4*>(valid + a0);
  uint32_t best = kSentinel;
  for (long long q0 = 0; q0 < n4; q0 += kThreads) {  // block-uniform trip count
    const long long q = q0 + tid;
    if (q < n4) {
      const uint4 xa = __ldg(x4 + q);
      const uint4 va = __ldg(v4 + q);
      const uint32_t w[4] = {xa.x & va.x, xa.y & va.y, xa.z & va.z, xa.w & va.w};
#pragma unroll
      for (int u = 3; u >= 0; --u) {  // the lowest hit word of the four wins
        const long long k = a0 + 4 * q + u;
        if (w[u] && k >= row && k < end) {
          best = static_cast<uint32_t>((k - row) * 32 + (__ffs(w[u]) - 1));
        }
      }
    }
    if (__syncthreads_or(best != kSentinel)) break;
  }
  best = __reduce_min_sync(kAll, best);
  if (lane == 0) warp_min[warp] = best;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) best = min(best, warp_min[w]);
    out[it.va + p] = best;
  }
}

template <bool kBatch>
__global__ void __launch_bounds__(kThreads)
class_rowmin_kernel(const uint32_t* __restrict__ l1,
                    const uint32_t* __restrict__ valid,
                    uint32_t* __restrict__ out,
                    const RowminItem* __restrict__ items, int nitems, int trees,
                    long long l1_stride, long long out_stride,
                    const int32_t* __restrict__ ctl) {
  __shared__ uint32_t ranks[kThreads * 33];
  if (superstep_dead(ctl)) return;
  // Block x: table block x / trees of tree x % trees (the trees of a row
  // block adjacent, reading the same valid words).
  const long long block = kBatch ? blockIdx.x / trees : blockIdx.x;
  if (kBatch) {
    const long long tree = blockIdx.x % trees;
    l1 += tree * l1_stride;
    out += tree * out_stride;
  }
  // The item owning this block: the last one whose first block <= block.
  int lo = 0, hi = nitems - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (items[mid].block0 <= block) lo = mid; else hi = mid - 1;
  }
  const RowminItem it = items[lo];
  const long long b = block - it.block0;
  const int tid = threadIdx.x;
  if (it.kind == 0) {
    rowmin_rank_major(l1, valid, out, it, b, ranks);
  } else if (it.kind == 3) {
    rowmin_wide_vertex(l1, valid, out, it, b, ranks);
  } else if (it.kind == 1) {
    const int warp = tid >> 5, lane = tid & 31;
    const long long p = b * kWarps + warp;
    if (p >= it.count) return;
    const long long ww = it.width >> 5;
    const long long row = it.sa_word + p * ww;
    uint32_t rank = kSentinel;
    for (long long k0 = 0; k0 < ww; k0 += 32) {
      const long long k = k0 + lane;
      const uint32_t w = k < ww ? (__ldg(l1 + row + k) & __ldg(valid + row + k)) : 0u;
      const uint32_t hit = __ballot_sync(kAll, w != 0);
      if (hit) {
        const int src = __ffs(hit) - 1;
        const uint32_t first = __shfl_sync(kAll, w, src);
        rank = static_cast<uint32_t>((k0 + src) * 32 + (__ffs(first) - 1));
        break;
      }
    }
    if (lane == 0) out[it.va + p] = rank;
  } else {
    const long long v = b * kThreads + tid;
    if (v < it.count) out[it.va + v] = kSentinel;
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

}  // namespace

extern "C" {

int benes_local_pass(const void* x_in, void* x_out, const void* masks,
                     const long long* offsets, const int* dists,
                     const int* compact, const int* lo, const int* hi, int nstages,
                     long long nwords, int tile_words, int trees, long long tree_stride,
                     const void* ctl, void* stream) {
  if (nstages > kMaxLocalStages || tile_words <= 0 || nwords % tile_words != 0 ||
      trees < 1 || (nwords / tile_words) * trees > 0x7FFFFFFFLL) {
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
  // Shared memory: the stage tables, the barriers, the tile, and as many
  // ring slots of one tile each as fit (at most kMaxRing, at most one per
  // stage with d >= 32).
  const size_t slab = static_cast<size_t>((tile_words + 3) & ~3) * sizeof(uint32_t);
  const size_t fixed = kTableSmem + kBarBytes + slab;
  if (fixed + slab > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  size_t slots = (kSmemLimit - fixed) / slab;
  slots = slots < kMaxRing ? slots : kMaxRing;
  const size_t wanted = st.ncross > 0 ? static_cast<size_t>(st.ncross) : 1;
  slots = slots < wanted ? slots : wanted;
  const size_t smem = kBarBytes + slab + slots * slab;  // dynamic
  const bool batch = trees > 1;
  auto kernel = batch ? benes_local_pass_kernel<true> : benes_local_pass_kernel<false>;
  static size_t configured[2] = {0, 0};
  if (smem > configured[batch]) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    configured[batch] = smem;
  }
  const unsigned blocks = static_cast<unsigned>((nwords / tile_words) * trees);
  kernel<<<blocks, kLocalThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x_in), static_cast<uint32_t*>(x_out),
      static_cast<const uint32_t*>(masks), st, tile_words, static_cast<int>(slots), trees,
      tree_stride, static_cast<const int32_t*>(ctl));
  return static_cast<int>(cudaGetLastError());
}

int benes_outer_pass(const void* x_in, void* x_out, const void* masks,
                     const long long* offsets, const int* bits, const int* compact,
                     int nstages, int b0, int k, int lg_row, long long nwords,
                     int trees, long long tree_stride, const void* ctl, void* stream) {
  if (nstages < 1 || nstages > kMaxOuterStages || k < 1 || k > kMaxOuterStages ||
      lg_row < 0 || lg_row > b0 || (1LL << (lg_row + k)) > kOuterWords ||
      (1LL << (b0 + k)) > nwords || nwords % (1LL << (b0 + k)) != 0 || trees < 1 ||
      (nwords >> (lg_row + k)) * trees > 0x7FFFFFFFLL) {
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
  const unsigned units = static_cast<unsigned>((nwords >> (lg_row + k)) * trees);
  auto kernel = trees > 1 ? benes_outer_pass_kernel<true> : benes_outer_pass_kernel<false>;
  kernel<<<units, kOuterThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x_in), static_cast<uint32_t*>(x_out),
      static_cast<const uint32_t*>(masks), st, b0, k, lg_row, quads ? 1 : 0, trees,
      tree_stride, static_cast<const int32_t*>(ctl));
  return static_cast<int>(cudaGetLastError());
}

int class_rowmin(const void* l1, const void* valid, void* out,
                 const void* items, int nitems, long long total_blocks, int trees,
                 long long l1_stride, long long out_stride, const void* ctl, void* stream) {
  if (trees < 1 || total_blocks * trees > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = trees > 1 ? class_rowmin_kernel<true> : class_rowmin_kernel<false>;
  kernel<<<static_cast<unsigned>(total_blocks * trees), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(l1), static_cast<const uint32_t*>(valid),
      static_cast<uint32_t*>(out), static_cast<const RowminItem*>(items),
      nitems, trees, l1_stride, out_stride, static_cast<const int32_t*>(ctl));
  return static_cast<int>(cudaGetLastError());
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
