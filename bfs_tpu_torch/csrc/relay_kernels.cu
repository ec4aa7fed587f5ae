// Hand-written Hopper (sm_90a) kernels of the relay superstep.
//
// Plain C interface for ctypes: pointers, integers, and the CUDA stream as
// void*.  Every entry point launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
// Words are uint32 bit patterns in standard packing (element e at word
// e >> 5, bit e & 31).  Each kernel's plain PyTorch version lives in
// bfs_tpu_torch/ops/relay.py and is held bit-exact against it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLocalStages = 64;
constexpr int kLocalThreads = 1024;
constexpr int kThreads = 256;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

struct LocalStages {
  long long offset[kMaxLocalStages];  // word offset of the stage's masks
  int d[kMaxLocalStages];             // element distance
  int compact[kMaxLocalStages];       // pair-compacted storage
  int count;
};

// ---------------------------------------------------------------------------
// benes_local_pass — replaces bfs_tpu/ops/relay_pallas.py
// _run_local_tile_major (K1) and the per-stage local modes of _run_pass (K2).
//
// One block owns a tile of `tile_words` consecutive words in shared memory
// and applies every stage of the local run (element distance d < 32 * tile)
// to it, then writes the tile back once.  Masks are read straight from the
// stored flat layout (full storage at the lower word; pair-compacted storage
// for d >= 4096, where the lower word w of pair p sits at tile_base/2 + p).
// Bound: bytes — the tile is read and written once and every local stage's
// stored masks are read once; the arithmetic is a few integer ops per word.
// The design keeps the words in shared memory across all local stages, so
// the mask stream is the only per-stage device-memory traffic.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kLocalThreads)
benes_local_pass_kernel(const uint32_t* x_in, uint32_t* x_out,
                        const uint32_t* __restrict__ masks,
                        const LocalStages st, int tile_words) {
  extern __shared__ uint32_t xs[];
  const long long base = static_cast<long long>(blockIdx.x) * tile_words;
  for (int i = threadIdx.x; i < tile_words; i += blockDim.x) xs[i] = x_in[base + i];
  __syncthreads();
  for (int s = 0; s < st.count; ++s) {
    const int d = st.d[s];
    const uint32_t* __restrict__ m = masks + st.offset[s];
    if (d < 32) {
      for (int i = threadIdx.x; i < tile_words; i += blockDim.x) {
        const uint32_t x = xs[i];
        const uint32_t t = (x ^ (x >> d)) & __ldg(m + base + i);
        xs[i] = x ^ t ^ (t << d);
      }
    } else {
      const int dw = d >> 5;
      const int half = tile_words >> 1;
      const bool compact = st.compact[s] != 0;
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int w = ((p & ~(dw - 1)) << 1) | (p & (dw - 1));
        const long long mi = compact ? (base >> 1) + p : base + w;
        const uint32_t a = xs[w];
        const uint32_t b = xs[w + dw];
        const uint32_t t = (a ^ b) & __ldg(m + mi);
        xs[w] = a ^ t;
        xs[w + dw] = b ^ t;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < tile_words; i += blockDim.x) x_out[base + i] = xs[i];
}

// ---------------------------------------------------------------------------
// benes_outer_stage — replaces the outer (pass A/C) mode of
// bfs_tpu/ops/relay_pallas.py _run_pass (K2).
//
// One launch per stage whose element distance is at least 32 * tile: one
// thread per lower word w of each word pair (w, w + dw), with the stage's
// mask at the pair number p (pair-compacted storage, which every stage of a
// network at least 32 * 2^13 words wide has) or at w (full storage).  In
// place when x_in == x_out (each pair is owned by one thread).
// Bound: bytes — the words are read and written once, the stored mask words
// read once.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
benes_outer_stage_kernel(const uint32_t* x_in, uint32_t* x_out,
                         const uint32_t* __restrict__ mask,
                         long long pairs, long long dw, int compact) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= pairs) return;
  const long long w = ((p & ~(dw - 1)) << 1) | (p & (dw - 1));
  const uint32_t a = x_in[w];
  const uint32_t b = x_in[w + dw];
  const uint32_t t = (a ^ b) & __ldg(mask + (compact ? p : w));
  x_out[w] = a ^ t;
  x_out[w + dw] = b ^ t;
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

__global__ void __launch_bounds__(kThreads)
class_rowmin_kernel(const uint32_t* __restrict__ l1,
                    const uint32_t* __restrict__ valid,
                    uint32_t* __restrict__ out,
                    const RowminItem* __restrict__ items, int nitems) {
  __shared__ uint32_t ranks[kThreads * 33];
  // The item owning this block: the last one whose first block <= blockIdx.
  int lo = 0, hi = nitems - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (items[mid].block0 <= blockIdx.x) lo = mid; else hi = mid - 1;
  }
  const RowminItem it = items[lo];
  const long long b = blockIdx.x - it.block0;
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
// a block OR of those bits sets the device `changed` flag, which the caller
// zeroes first (here, on the same stream) and reads once per level.
// Bound: bytes — packed and cand read once, packed and vr/32 frontier words
// written once.  In place when packed_in == packed_out.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
packed_update_kernel(const uint32_t* packed_in, const uint32_t* __restrict__ cand,
                     uint32_t* packed_out, uint32_t* __restrict__ fwords,
                     int32_t* __restrict__ changed, long long vr,
                     uint32_t level_bits) {
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

}  // namespace

extern "C" {

int benes_local_pass(const void* x_in, void* x_out, const void* masks,
                     const long long* offsets, const int* dists,
                     const int* compact, int nstages, long long nwords,
                     int tile_words, void* stream) {
  if (nstages > kMaxLocalStages || nwords % tile_words != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LocalStages st;
  st.count = nstages;
  for (int s = 0; s < nstages; ++s) {
    st.offset[s] = offsets[s];
    st.d[s] = dists[s];
    st.compact[s] = compact[s];
  }
  const size_t smem = static_cast<size_t>(tile_words) * sizeof(uint32_t);
  static size_t configured = 0;
  if (smem > configured) {
    cudaFuncSetAttribute(benes_local_pass_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    configured = smem;
  }
  const unsigned blocks = static_cast<unsigned>(nwords / tile_words);
  benes_local_pass_kernel<<<blocks, kLocalThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x_in), static_cast<uint32_t*>(x_out),
      static_cast<const uint32_t*>(masks), st, tile_words);
  return static_cast<int>(cudaGetLastError());
}

int benes_outer_stage(const void* x_in, void* x_out, const void* mask,
                      long long nwords, long long dw, int compact,
                      void* stream) {
  const long long pairs = nwords >> 1;
  const unsigned blocks = static_cast<unsigned>((pairs + kThreads - 1) / kThreads);
  benes_outer_stage_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x_in), static_cast<uint32_t*>(x_out),
      static_cast<const uint32_t*>(mask), pairs, dw, compact);
  return static_cast<int>(cudaGetLastError());
}

int class_rowmin(const void* l1, const void* valid, void* out,
                 const void* items, int nitems, long long total_blocks,
                 void* stream) {
  class_rowmin_kernel<<<static_cast<unsigned>(total_blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(l1), static_cast<const uint32_t*>(valid),
      static_cast<uint32_t*>(out), static_cast<const RowminItem*>(items),
      nitems);
  return static_cast<int>(cudaGetLastError());
}

int packed_update(const void* packed_in, const void* cand, void* packed_out,
                  void* fwords, void* changed, long long vr,
                  unsigned level_bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(changed, 0, sizeof(int32_t), s);
  const unsigned blocks = static_cast<unsigned>((vr + kThreads - 1) / kThreads);
  packed_update_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(packed_in),
      static_cast<const uint32_t*>(cand), static_cast<uint32_t*>(packed_out),
      static_cast<uint32_t*>(fwords), static_cast<int32_t*>(changed), vr,
      level_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
