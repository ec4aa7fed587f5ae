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

namespace {

constexpr int kMaxLocalStages = 64;
constexpr int kLocalThreads = 1024;
constexpr int kThreads = 256;
constexpr int kDistPlanes = 5;
constexpr uint32_t kAll = 0xFFFFFFFFu;

struct LocalStages {
  long long offset[kMaxLocalStages];  // word offset of the stage's masks
  int d[kMaxLocalStages];             // element distance
  int compact[kMaxLocalStages];       // pair-compacted storage
  int count;
};

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
// Block (x, g) owns the tile of `tile` consecutive elements of group g in
// shared memory and applies every stage of the local run (d < tile) to it:
// one thread per lower/upper pair, t = (lo ^ hi) & sel, lo ^= t, hi ^= t,
// where sel is 0 or ~0 from the stage's mask bit of the lower element.  The
// bit comes straight from the stored flat layout: bit e for full storage,
// bit (e / 2d) * d + e % d = tile_base / 2 + p for pair-compacted storage
// (the TPU's vertical repack exists only for its lane layout).
// Bound: bytes — the tile is read and written once per group and the local
// stages' stored masks are read once per group; a few integer ops per
// element and stage.  The tile stays in shared memory across all local
// stages, so the mask stream is the only per-stage device-memory traffic.
// The tile's mask words of stage s + 1 are copied into a second shared
// buffer (cp.async) while stage s runs, so no thread waits on a device
// memory load inside a stage: with one 128 KB block per SM, reading the
// mask bit from global memory per pair left the pass latency-bound.
// ---------------------------------------------------------------------------

// First stored mask bit of the tile at element `base` in one stage's words:
// compact storage holds a bit per pair (tile / 2 bits), full storage a bit
// per element (tile bits).
__device__ __forceinline__ long long tile_bit0(bool compact, long long base) {
  return compact ? base >> 1 : base;
}

// Words of a stage's mask bits [bit0, bit0 + span) into `buf`, as one
// committed cp.async group.
__device__ __forceinline__ void fetch_masks(uint32_t* buf, const uint32_t* m,
                                            long long bit0, int span) {
  const long long w0 = bit0 >> 5;
  const int nw = static_cast<int>(((bit0 + span - 1) >> 5) - w0 + 1);
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    __pipeline_memcpy_async(buf + i, m + w0 + i, sizeof(uint32_t));
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(kLocalThreads)
benes_elem_local_pass_kernel(const uint32_t* x_in, uint32_t* x_out,
                             const uint32_t* __restrict__ masks,
                             const LocalStages st, long long n, int tile) {
  extern __shared__ uint32_t xs[];  // tile elements, then two mask buffers
  const int mask_words = (tile >> 5) + 1;
  uint32_t* mbuf = xs + tile;
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  const long long at = static_cast<long long>(blockIdx.y) * n + base;
  const int half = tile >> 1;
  auto fetch = [&](int s) {
    const bool compact = st.compact[s] != 0;
    fetch_masks(mbuf + (s & 1) * mask_words, masks + st.offset[s],
                tile_bit0(compact, base), compact ? half : tile);
  };
  if (st.count > 0) fetch(0);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) xs[i] = x_in[at + i];
  for (int s = 0; s < st.count; ++s) {
    __pipeline_wait_prior(0);
    __syncthreads();  // stage s's masks and stage s - 1's elements in place
    if (s + 1 < st.count) fetch(s + 1);  // its buffer was last read by s - 1
    const int d = st.d[s];
    const bool compact = st.compact[s] != 0;
    const uint32_t* m = mbuf + (s & 1) * mask_words;
    const int lead = static_cast<int>(tile_bit0(compact, base) & 31);
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      const int e = ((p & ~(d - 1)) << 1) | (p & (d - 1));
      const int q = lead + (compact ? p : e);
      const uint32_t sel = 0u - ((m[q >> 5] >> (q & 31)) & 1u);
      const uint32_t a = xs[e];
      const uint32_t b = xs[e + d];
      const uint32_t t = (a ^ b) & sel;
      xs[e] = a ^ t;
      xs[e + d] = b ^ t;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tile; i += blockDim.x) x_out[at + i] = xs[i];
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
// (RelayEngine.route_index).  One thread per 4 consecutive slots reads
// their 4 indices in one 16-byte load, gathers each group's frontier
// elements and writes each group's 4 slots in one 16-byte store.
// Bound: bytes — the index read once, the frontier read once per group and
// the slots written once per group.  The index and the slots stream past
// the L2 (evict-first loads and stores), so the G x vr frontier (33.6 MB at
// s22, G = 2) can stay in the 50 MB L2 for the random gathers; the K5 route
// it replaces streamed every element through 38 outer stages and two local
// passes per superstep.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
elem_route_gather_kernel(const uint32_t* __restrict__ frontier,
                         const int4* __restrict__ src, uint4* __restrict__ l1,
                         long long vr, long long n4, int groups) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= n4) return;
  const int4 s = __ldcs(src + q);
  for (int g = 0; g < groups; ++g) {
    const uint32_t* __restrict__ f = frontier + g * vr;
    uint4 o;
    o.x = s.x >= 0 ? __ldg(f + s.x) : 0u;
    o.y = s.y >= 0 ? __ldg(f + s.y) : 0u;
    o.z = s.z >= 0 ? __ldg(f + s.z) : 0u;
    o.w = s.w >= 0 ? __ldg(f + s.w) : 0u;
    __stcs(l1 + g * n4 + q, o);
  }
}

// ---------------------------------------------------------------------------
// elem_rowmin_update — replaces the row-min tournament and the bit-sliced
// update that bfs_tpu/ops/relay_elem.py rowmin_elem and elem_superstep run
// in XLA (the TPU superstep, relay_pallas.py elem_superstep_tpu_factory,
// leaves them there too).
//
// Per (group, vertex), scan the vertex's class rows in ascending order over
// l1 & valid: rank-major slot sa + r * count + (v - va), vertex-major slot
// sa + (v - va) * width + r.  At row r the fresh bits x & ~found take rank r
// (their rank planes j get the bits where bit j of r is set), then join
// found.  That is the tournament's min row index, since zero rows never win.
// `found` starts at `visited`: a tree that already reached the vertex adopts
// nothing, and the scan ends once every tree is reached or found.  Then
// newly = found & ~visited is the next frontier, joins visited, is ORed into
// dist plane b where bit b of `level` (the new level) is set — none at 32,
// the step past the cap — and into the class's rank planes
// rank_planes[g, off + j * count + (v - va)], j < nb.  A block OR of
// newly != 0 sets the device `changed` flag, zeroed first on this stream.
// One launch covers every class and group through a device table of work
// items (kind, va, count, sa, width, off, nb, first block):
//   kind 0, rank-major: one thread per vertex (coalesced across the warp);
//   kind 1, vertex-major: one warp per vertex, 32 rows per step, the warp
//     walking its lanes in row order only while fresh bits remain;
//   kind 2: the tail [covered, vr), which finds nothing.
// Bound: bytes — visited read and frontier written once, the class slots of
// every unfinished (group, vertex) and their valid words read, and the
// state words of newly reached vertices rewritten.
// ---------------------------------------------------------------------------
struct ElemItem {
  long long kind, va, count, sa, width, off, nb, block0;
};

__device__ __forceinline__ void adopt(uint32_t (&planes)[32], uint32_t fresh,
                                      uint32_t r) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if ((r >> j) & 1u) planes[j] |= fresh;
  }
}

struct ElemOut {
  uint32_t* visited;      // [G, vr]
  uint32_t* frontier;     // [G, vr]
  uint32_t* dist_planes;  // [kDistPlanes, G, vr]
  uint32_t* rank_planes;  // [G, pt]
  long long vr, pt;
  int groups;
  uint32_t level;
};

__device__ __forceinline__ void write_vertex(const ElemOut& o, int g, long long v,
                                             uint32_t vis, uint32_t newly,
                                             const uint32_t (&planes)[32],
                                             const ElemItem& it) {
  const long long gv = g * o.vr + v;
  o.frontier[gv] = newly;
  if (!newly) return;
  o.visited[gv] = vis | newly;
#pragma unroll
  for (int b = 0; b < kDistPlanes; ++b) {
    if ((o.level >> b) & 1u) {
      o.dist_planes[(static_cast<long long>(b) * o.groups + g) * o.vr + v] |= newly;
    }
  }
  uint32_t* rp = o.rank_planes + g * o.pt + it.off + (v - it.va);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j < it.nb) rp[j * it.count] |= planes[j] & newly;
  }
}

__global__ void __launch_bounds__(kThreads)
elem_rowmin_update_kernel(const uint32_t* __restrict__ l1,
                          const uint32_t* __restrict__ valid,
                          const ElemItem* __restrict__ items, int nitems,
                          long long n, ElemOut o, int32_t* __restrict__ changed) {
  int lo = 0, hi = nitems - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (items[mid].block0 <= blockIdx.x) lo = mid; else hi = mid - 1;
  }
  const ElemItem it = items[lo];
  const long long b = blockIdx.x - it.block0;
  const int g = blockIdx.y;
  const uint32_t* __restrict__ x = l1 + g * n;
  const int tid = threadIdx.x;
  bool any = false;
  uint32_t planes[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) planes[j] = 0u;

  if (it.kind == 0) {
    const long long i = b * kThreads + tid;
    if (i < it.count) {
      const long long v = it.va + i;
      const uint32_t vis = o.visited[g * o.vr + v];
      uint32_t found = vis;
      for (long long r = 0; r < it.width && found != kAll; ++r) {
        const long long slot = it.sa + r * it.count + i;
        const uint32_t w = __ldg(x + slot) & mask_select(valid, slot);
        const uint32_t fresh = w & ~found;
        if (fresh) {
          adopt(planes, fresh, static_cast<uint32_t>(r));
          found |= fresh;
        }
      }
      const uint32_t newly = found & ~vis;
      write_vertex(o, g, v, vis, newly, planes, it);
      any = newly != 0;
    }
  } else if (it.kind == 1) {
    const int warp = tid >> 5, lane = tid & 31;
    const long long i = b * (kThreads / 32) + warp;
    if (i < it.count) {  // warp-uniform
      const long long v = it.va + i;
      const uint32_t vis = o.visited[g * o.vr + v];
      uint32_t found = vis;
      const long long row = it.sa + i * it.width;  // a multiple of 32
      for (long long r0 = 0; r0 < it.width && found != kAll; r0 += 32) {
        const uint32_t vw = __ldg(valid + ((row + r0) >> 5));
        const uint32_t w = __ldg(x + row + r0 + lane) & (0u - ((vw >> lane) & 1u));
        uint32_t pending = __reduce_or_sync(kAll, w) & ~found;
        while (pending) {  // lanes in row order, while fresh bits remain
          const int k = __ffs(__ballot_sync(kAll, (w & pending) != 0)) - 1;
          const uint32_t fresh = __shfl_sync(kAll, w, k) & pending;
          adopt(planes, fresh, static_cast<uint32_t>(r0 + k));
          found |= fresh;
          pending &= ~fresh;
        }
      }
      const uint32_t newly = found & ~vis;
      if (lane == 0) {
        write_vertex(o, g, v, vis, newly, planes, it);
        any = newly != 0;
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
                          const long long* offsets, const int* dists,
                          const int* compact, int nstages, int groups,
                          long long n, int tile, void* stream) {
  if (nstages > kMaxLocalStages || tile <= 0 || n % tile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LocalStages st;
  st.count = nstages;
  for (int s = 0; s < nstages; ++s) {
    st.offset[s] = offsets[s];
    st.d[s] = dists[s];
    st.compact[s] = compact[s];
  }
  const size_t smem = (static_cast<size_t>(tile) + 2 * ((tile >> 5) + 1)) * sizeof(uint32_t);
  static size_t configured = 0;
  if (smem > configured) {
    cudaFuncSetAttribute(benes_elem_local_pass_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    configured = smem;
  }
  const dim3 grid(static_cast<unsigned>(n / tile), static_cast<unsigned>(groups));
  benes_elem_local_pass_kernel<<<grid, kLocalThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x_in), static_cast<uint32_t*>(x_out),
      static_cast<const uint32_t*>(masks), st, n, tile);
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
                      long long vr, long long n, int groups, void* stream) {
  if (n % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = n >> 2;
  const unsigned blocks = static_cast<unsigned>((n4 + kThreads - 1) / kThreads);
  elem_route_gather_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(frontier), static_cast<const int4*>(src),
      static_cast<uint4*>(l1), vr, n4, groups);
  return static_cast<int>(cudaGetLastError());
}

int elem_rowmin_update(const void* l1, const void* valid, void* visited,
                       void* frontier, void* dist_planes, void* rank_planes,
                       void* changed, const void* items, int nitems,
                       long long total_blocks, int groups, long long n,
                       long long vr, long long pt, unsigned level,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(changed, 0, sizeof(int32_t), s);
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
      static_cast<const ElemItem*>(items), nitems, n, o,
      static_cast<int32_t*>(changed));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
