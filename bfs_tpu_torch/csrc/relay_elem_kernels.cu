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
// this stream.  One launch covers every class and group (blockIdx.y)
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
__device__ __forceinline__ uint32_t write_vertex(const ElemOut& o, const ElemItem& it, int g,
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
    if ((o.level >> b) & 1u) {
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
                          const ElemTable table, long long n, ElemOut o,
                          int32_t* __restrict__ changed) {
  __shared__ uint32_t fresh_s[kThreads];
  __shared__ uint32_t vis_s[kThreads];
  __shared__ uint32_t planes_s[kThreads * 33];
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
          any |= write_vertex(o, it, g, it.va + i, vis, fresh_s, planes_s, tid, 32, 1) != 0u;
        }
      } else {
        vis_s[tid] = vis;
        __syncthreads();
        if (tid < spans * 32) {
          const int s = tid >> 5;
          const int k0 = s * chunks * 32 + lane;
          const long long iv = (pb * spans + s) * 32 + lane;
          if (iv < it.count) {
            any |= write_vertex(o, it, g, it.va + iv, vis_s[k0], fresh_s, planes_s, k0, 32,
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
        any = write_vertex(o, it, g, it.va + i, vis, fresh_s, planes_s, warp, 1, 1) != 0u;
      }
    } else {
      __syncthreads();
      if (tid == 0) {
        any = write_vertex(o, it, g, it.va + i, vis, fresh_s, planes_s, 0, 1, kWarps) != 0u;
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
                       void* changed, const long long* items, int nitems,
                       long long total_blocks, int groups, long long n,
                       long long vr, long long pt, unsigned level,
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
      table, n, o, static_cast<int32_t*>(changed));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
