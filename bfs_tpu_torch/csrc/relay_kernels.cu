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
// device table of work items (kind, va, count, sa/32, width, first block):
//   kind 0, rank-major: one thread per column word j scans the class's rows
//     in ascending order; the first row that sets a lane's bit is that
//     lane's rank (== the tournament's min row index).  Ranks are staged in
//     shared memory (stride 33 against bank conflicts) and written out
//     coalesced.
//   kind 1, vertex-major: one warp per vertex scans its width/32 words 32 at
//     a time; the first nonzero word and its lowest set bit give the rank.
//   kind 2: the sentinel tail [covered, vr).
// Bound: bytes — the class slot words of l1 and valid are read once, vr
// words written once.
// ---------------------------------------------------------------------------
struct RowminItem {
  long long kind, va, count, sa_word, width, block0;
};

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
    const long long cw = it.count >> 5;
    const long long j0 = b * kThreads;
    const long long j = j0 + tid;
    uint32_t* mine = ranks + tid * 33;
    for (int k = 0; k < 32; ++k) mine[k] = kSentinel;
    if (j < cw) {
      uint32_t found = 0;
      const long long col = it.sa_word + j;
      for (long long r = 0; r < it.width; ++r) {
        const long long at = col + r * cw;
        const uint32_t w = __ldg(l1 + at) & __ldg(valid + at);
        uint32_t fresh = w & ~found;
        while (fresh) {
          const int bit = __ffs(fresh) - 1;
          mine[bit] = static_cast<uint32_t>(r);
          fresh &= fresh - 1;
        }
        found |= w;
      }
    }
    __syncthreads();
    const long long limit = (cw - j0) * 32;  // lanes of this block's words
    for (int i = tid; i < kThreads * 32; i += kThreads) {
      if (i < limit) out[it.va + j0 * 32 + i] = ranks[(i >> 5) * 33 + (i & 31)];
    }
  } else if (it.kind == 1) {
    const int warp = tid >> 5, lane = tid & 31;
    const long long p = b * (kThreads / 32) + warp;
    if (p >= it.count) return;
    const long long ww = it.width >> 5;
    const long long row = it.sa_word + p * ww;
    uint32_t rank = kSentinel;
    for (long long k0 = 0; k0 < ww; k0 += 32) {
      const long long k = k0 + lane;
      const uint32_t w = k < ww ? (__ldg(l1 + row + k) & __ldg(valid + row + k)) : 0u;
      const uint32_t hit = __ballot_sync(0xFFFFFFFFu, w != 0);
      if (hit) {
        const int src = __ffs(hit) - 1;
        const uint32_t first = __shfl_sync(0xFFFFFFFFu, w, src);
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
