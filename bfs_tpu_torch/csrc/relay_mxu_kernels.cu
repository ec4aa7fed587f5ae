// Hand-written Hopper (sm_90a) kernel of the MXU expansion arm.
//
// Plain C interface for ctypes, as in relay_kernels.cu: pointers, integers
// and the CUDA stream as void*; the entry point launches on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().  Its plain PyTorch version is
// bfs_tpu_torch/ops/relay_mxu.py expand_frontier_mxu_plain, held bit-exact
// against it.
//
// ---------------------------------------------------------------------------
// mxu_expand — replaces bfs_tpu/ops/relay_mxu.py expand_frontier_mxu (K6,
// the pallas_call with body _mxu_kernel_factory).
//
// out[col_id[t]*128 + v] = min over tiles t, over frontier rows u of t with
// bit (u, v) set, of keys[row_idx[t]*128 + u]  (unsigned; out is cleared to
// 0xFFFFFFFF by the caller).  Tiles are uint32[128 rows][4 words], bit v of
// row u at word v >> 5, bit v & 31.
//
// Layout of the work.  The TPU kernel walks one 16384-column superblock per
// grid step; R-MAT skew gives superblocks of very unequal tile counts, which
// on the card would serialise on a few SMs.  Here each warp owns batches of
// 32 consecutive tiles, batch b = warp + k * (warps in the grid), and keeps
// its own ring of kStages tiles in shared memory:
//
//   producer (the warp, lane 0 issuing): the 32 lanes read the heads of a
//     batch at once (row block, column block, and the 128-bit frontier
//     block straight from the frontier words; words past the end, the pad
//     block, read as zero) and ballot the live tiles: a nonzero frontier
//     block and a column block inside the output (cb >= col_tiles is the
//     dropped overflow segment).  Dead tiles are never copied.  Each live
//     tile is one cp.async.bulk (TMA bulk copy, 2,048 contiguous bytes,
//     evict-first in L2) into a free ring slot, completed on the slot's
//     mbarrier; its head goes to the slot's shared record;
//   consumer (the same warp): waits on the oldest slot's mbarrier,
//     computes the tile, and refills the slot with the next live tile, so
//     kStages - 1 tiles stay in flight while one computes.
//
// Two paths in the one kernel, chosen per tile (warp-uniform).  Each lane
// holds rows lane, lane + 32, lane + 64, lane + 96 (64 B) of the tile; rows
// whose frontier bit is clear are zeroed, and the warp's sum of popcounts is
// the tile's count of reachable (u, v) bits.
//
//   sparse, count <= kSparseMaxBits: each lane reads the key of each of its
//     rows that still holds a bit and atomicMin's it into the destination of
//     every set bit.  An R-MAT scale-22 tile holds 4.6 edges on average, so
//     nearly every live tile takes this path.
//   dense, count > kSparseMaxBits: the tensor-core product.  mma.sync
//     m16n8k16 (fp16 inputs, fp32 accumulation) computes C[r, v] =
//     sum_u A[r, u] * B[u, v] with
//       A[r, u] = frontier_bit(u) * 2^(u mod 8)   for u >> 3 == r   (16 x 128)
//       B[u, v] = tile bit (u, v) as 0.0 / 1.0                        (128 x 128)
//     so C[r, v] is the 8-bit mask of frontier rows 8r..8r+7 that reach v.
//     The reference uses 8 groups of 16 rows; 16 groups of 8 fill all 16
//     accumulator rows with real masks and keep every weight at or below
//     2^7.  A sum of distinct powers of two below 2^8 is exact in fp32, so
//     each accumulator is exactly its mask.  Per tile word, an n-tile (8
//     destinations) that no frontier row reaches (a warp-wide OR) is
//     skipped; the others run 8 k-steps.  The fragments are built from the
//     ring slot as each k-step needs them, so the path holds no fragment
//     arrays in registers.  Epilogue: each lane walks the set bits of its
//     four masks, takes the minimum key over them (keys are original ids,
//     not monotone in u), and atomicMin's it.
//
// Min is associative and commutative, so tiles of both paths may write the
// same column in one launch and the atomics still give the bits of the
// reference's in-order reduction.
//
// The tree axis (the lock-step batch, RelayEngine.run_multi_device; the
// kernel is a template on kBatch, so a single search launches the <false>
// instance, compiled as before the tree axis): with
// `trees` S > 1 the frontier words and the output are S rows (at `fstride`
// and `ostride` words), and the tiles, row and column indices and keys are
// shared.  A tile is live when any tree's frontier block is nonzero, is
// copied into the ring once, and is computed against each tree whose block
// is nonzero (that tree's block read again, from L1/L2), into that tree's
// output row: the tiles are read once per batch, not once per tree.  The
// reference runs its XLA twin under vmap on this arm (Mosaic has no kernel
// under vmap); the port keeps its own kernel there, bit for bit with it.
//
// Bound: bytes — each live tile reads 2,048 B of tile and 16 B of frontier
// (R-MAT scale 22: 262,144 multiply-adds of the dense product a tile
// against 4.6 edges).  What held the first design at 5.4x that bound: every
// tile went through the dense path's 32 shared loads, 16 bit_pairs and 8
// mma.sync per live n-tile, and each warp waited for its own tile's load
// before computing.  Here the sparse path costs a few instructions per bit,
// and kStages tiles per warp, kWarps * kBlocksPerSm warps per SM keep up to
// 24 * 4 * 2 KB = 192 KB per SM in flight (Little's law at 3.35 TB/s and
// about 1 us asks for about 25 KB).
//
// kSparseMaxBits: measured with bfs_tpu_torch/tools/mxu_sparse_sweep.py on
// an H100 80GB HBM3 (700 W): 524,288 tiles of k bits each, all rows in the
// frontier, with every tile sent down one path.  With the bits spread over
// the rows the sparse path wins up to k = 2,048 (3.96 against 5.72 ms) and
// loses from 4,096 (12.57 against 6.83); with them packed into one lane's
// rows, its worst case, it wins at 256 (2.53 against 3.48 ms) and loses at
// 512 (4.82 against 3.84).  256, the largest k at which it won both, is the
// threshold; PERF.md records the sweep.
// ---------------------------------------------------------------------------

#include <cstdint>
#include <cuda_runtime.h>

#include "control.cuh"
#include "tma.cuh"

namespace {

constexpr int kTile = 128;
constexpr int kTileWords = 4;
constexpr int kTileBytes = kTile * kTileWords * 4;  // 2,048
constexpr int kWarps = 8;        // warps per block, each with its own ring
constexpr int kStages = 4;       // ring slots per warp
constexpr int kBlocksPerSm = 3;  // resident blocks an SM must fit (registers, shared memory)
constexpr int kSparseMaxBits = 256;
constexpr uint32_t kAll = 0xFFFFFFFFu;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr uint32_t kHalfOne = 0x3C00u;  // fp16 1.0

// A ring slot's head: what the consumer needs besides the tile's bytes.
struct TileHead {
  int rb, cb;
  uint32_t f[kTileWords];
};

constexpr size_t kSmemBytes =
    static_cast<size_t>(kWarps) * kStages * (kTileBytes + sizeof(uint64_t) + sizeof(TileHead));

// fp16 bits of 2^e for 0 <= e < 8.
__device__ __forceinline__ uint32_t half_pow2(int e) {
  return static_cast<uint32_t>(15 + e) << 10;
}

// A-fragment half pair for source rows u, u + 1: frontier bit times
// 2^(u mod 8), low half first.
__device__ __forceinline__ uint32_t weight_pair(uint32_t fword, int u) {
  const uint32_t lo = (fword >> (u & 31)) & 1u ? half_pow2(u & 7) : 0u;
  const uint32_t hi = (fword >> ((u + 1) & 31)) & 1u ? half_pow2((u + 1) & 7) : 0u;
  return lo | (hi << 16);
}

// B-fragment half pair: bit `bit` of two tile-row words as 0.0 / 1.0.
__device__ __forceinline__ uint32_t bit_pair(uint32_t w0, uint32_t w1, int bit) {
  return ((w0 >> bit) & 1u ? kHalfOne : 0u) | ((w1 >> bit) & 1u ? kHalfOne << 16 : 0u);
}

__device__ __forceinline__ void mma_m16n8k16(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Minimum key over the set bits of an 8-bit mask of row group r.
__device__ __forceinline__ uint32_t min_key(float c, int r, const uint32_t* __restrict__ krow,
                                            uint32_t best) {
  uint32_t m = static_cast<uint32_t>(c);
  while (m) {
    const int b = __ffs(m) - 1;
    m &= m - 1;
    const uint32_t k = __ldg(krow + 8 * r + b);
    best = k < best ? k : best;
  }
  return best;
}

// The tensor-core path over one tile in shared memory (ts: 128 rows x 4
// words); krow: the tile's 128 keys, o: its 128 destinations.
__device__ __forceinline__ void dense_tile(const uint32_t* ts, const uint32_t (&f)[kTileWords],
                                           const uint32_t* __restrict__ krow,
                                           uint32_t* __restrict__ o, int g, int t) {
#pragma unroll 1
  for (int w = 0; w < kTileWords; ++w) {
    // live: the columns of word w that this lane's frontier rows reach.
    uint32_t live = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int u = 16 * j + 2 * t;
      const uint32_t fw = f[j >> 1];
      live |= ((fw >> (u & 31)) & 1u ? ts[u * kTileWords + w] : 0u) |
              ((fw >> ((u + 1) & 31)) & 1u ? ts[(u + 1) * kTileWords + w] : 0u) |
              ((fw >> ((u + 8) & 31)) & 1u ? ts[(u + 8) * kTileWords + w] : 0u) |
              ((fw >> ((u + 9) & 31)) & 1u ? ts[(u + 9) * kTileWords + w] : 0u);
    }
    live = __reduce_or_sync(kAll, live);  // over the warp: every row
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      if (((live >> (8 * q)) & 0xFFu) == 0u) continue;  // warp-uniform
      // n-tile 4w + q: destinations v = 32w + 8q + n; this lane's B column
      // is n = g, its accumulators columns 2t and 2t + 1.
      const int bit = 8 * q + g;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // k-step j: source rows 16j .. 16j + 15, groups 2j (k < 8) and
        // 2j + 1 (k >= 8); a fragment register is nonzero only where its
        // accumulator row is that group.
        const int u = 16 * j + 2 * t;
        const uint32_t fw = f[j >> 1];
        const uint32_t lo = weight_pair(fw, u);
        const uint32_t hi = weight_pair(fw, u + 8);
        const uint32_t a[4] = {
            g == 2 * j ? lo : 0u,          // row g,     k = 2t, 2t+1
            g + 8 == 2 * j ? lo : 0u,      // row g + 8, k = 2t, 2t+1
            g == 2 * j + 1 ? hi : 0u,      // row g,     k = 2t+8, 2t+9
            g + 8 == 2 * j + 1 ? hi : 0u,  // row g + 8, k = 2t+8, 2t+9
        };
        mma_m16n8k16(c, a,
                     bit_pair(ts[u * kTileWords + w], ts[(u + 1) * kTileWords + w], bit),
                     bit_pair(ts[(u + 8) * kTileWords + w], ts[(u + 9) * kTileWords + w], bit));
      }
      // c[0], c[1]: row group g, columns 2t, 2t + 1; c[2], c[3]: group g + 8.
      const uint32_t best0 = min_key(c[2], g + 8, krow, min_key(c[0], g, krow, kSentinel));
      const uint32_t best1 = min_key(c[3], g + 8, krow, min_key(c[1], g, krow, kSentinel));
      uint32_t* d = o + 32 * w + 8 * q + 2 * t;
      if (best0 != kSentinel) atomicMin(d, best0);
      if (best1 != kSentinel) atomicMin(d + 1, best1);
    }
  }
}

__device__ __forceinline__ uint32_t word_of(const uint4& r, int w) {
  return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}

template <bool kBatch>
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSm)
mxu_expand_kernel(const uint4* __restrict__ tiles, const int32_t* __restrict__ row_idx,
                  const int32_t* __restrict__ col_id, const uint32_t* __restrict__ keys,
                  const uint32_t* __restrict__ fwords, long long nfw,
                  uint32_t* __restrict__ out, long long ntp, int col_tiles, int trees,
                  long long fstride, long long ostride, const int32_t* __restrict__ ctl) {
  if (superstep_dead(ctl)) return;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint4* ring = reinterpret_cast<uint4*>(smem) + warp * kStages * kTile;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kWarps * kStages * kTileBytes) +
                  warp * kStages;
  TileHead* head = reinterpret_cast<TileHead*>(
                       smem + kWarps * kStages * (kTileBytes + sizeof(uint64_t))) +
                   warp * kStages;
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar + s);
    mbar_fence_init();
  }
  __syncwarp();
  const uint64_t policy = evict_first_policy();

  // Producer: this lane's head in the current batch, and the batch's live
  // tiles not yet issued (warp-uniform).
  const long long nbatch = (ntp + 31) >> 5;
  const long long bstride = static_cast<long long>(gridDim.x) * kWarps;
  long long batch = static_cast<long long>(blockIdx.x) * kWarps + warp;
  long long base = 0;
  uint32_t pending = 0u;
  int my_rb = 0, my_cb = 0;
  uint32_t my_f[kTileWords] = {0u, 0u, 0u, 0u};

  // Issue the next live tile into ring slot `slot`; false when the warp's
  // tiles are exhausted.  Warp-uniform.
  auto produce = [&](int slot) -> bool {
    while (pending == 0u) {
      if (batch >= nbatch) return false;
      base = batch << 5;
      batch += bstride;
      const long long tix = base + lane;
      bool live = false;
      if (tix < ntp) {
        my_rb = __ldg(row_idx + tix);
        my_cb = __ldg(col_id + tix);
        if (my_cb < col_tiles) {  // else the dropped overflow segment
          if constexpr (kBatch) {  // live: any tree's frontier block is nonzero
            uint32_t any = 0u;
            for (int tr = 0; tr < trees; ++tr) {
#pragma unroll
              for (int i = 0; i < kTileWords; ++i) {
                const long long w = static_cast<long long>(my_rb) * kTileWords + i;
                any |= w < nfw ? __ldg(fwords + tr * fstride + w) : 0u;
              }
            }
            live = any != 0u;
          } else {
#pragma unroll
            for (int i = 0; i < kTileWords; ++i) {
              const long long w = static_cast<long long>(my_rb) * kTileWords + i;
              my_f[i] = w < nfw ? __ldg(fwords + w) : 0u;  // the pad block reads zero
            }
            live = (my_f[0] | my_f[1] | my_f[2] | my_f[3]) != 0u;
          }
        }
      }
      pending = __ballot_sync(kAll, live);
    }
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    TileHead h;
    h.rb = __shfl_sync(kAll, my_rb, src);
    h.cb = __shfl_sync(kAll, my_cb, src);
#pragma unroll
    for (int i = 0; i < kTileWords; ++i) h.f[i] = __shfl_sync(kAll, my_f[i], src);
    if (lane == 0) {
      head[slot] = h;  // published by the mbarrier arrive (release)
      bulk_load(ring + slot * kTile, tiles + (base + src) * kTile, kTileBytes, bar + slot,
                policy);
    }
    return true;
  };

  long long issued = 0;
  while (issued < kStages && produce(static_cast<int>(issued))) ++issued;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma thread in group
  for (long long done = 0; done < issued; ++done) {
    const int slot = static_cast<int>(done % kStages);
    mbar_wait(bar + slot, static_cast<uint32_t>((done / kStages) & 1));
    const TileHead h = head[slot];
    const uint4* ts = ring + slot * kTile;
    const uint32_t* krow = keys + static_cast<long long>(h.rb) * kTile;
    uint32_t* o = out + static_cast<long long>(h.cb) * kTile;
    for (int tr = 0; tr < (kBatch ? trees : 1); ++tr) {
      // One search: the head's block; a batch: tree tr's block, read again.
      uint32_t f[kTileWords];
#pragma unroll
      for (int i = 0; i < kTileWords; ++i) {
        const long long w = static_cast<long long>(h.rb) * kTileWords + i;
        f[i] = !kBatch ? h.f[i] : w < nfw ? __ldg(fwords + tr * fstride + w) : 0u;
      }
      if (kBatch && (f[0] | f[1] | f[2] | f[3]) == 0u) continue;  // warp-uniform
      uint32_t* ot = o + tr * ostride;
      // Rows lane + 32k, zeroed where the frontier bit is clear.
      uint4 r[4];
      int bits = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        r[k] = ts[lane + 32 * k];
        if (!((f[k] >> lane) & 1u)) r[k] = make_uint4(0u, 0u, 0u, 0u);
        bits += __popc(r[k].x) + __popc(r[k].y) + __popc(r[k].z) + __popc(r[k].w);
      }
      const int total = __reduce_add_sync(kAll, bits);
      if (total <= kSparseMaxBits) {
        uint32_t key[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool hit = (r[k].x | r[k].y | r[k].z | r[k].w) != 0u;
          key[k] = hit ? __ldg(krow + lane + 32 * k) : kSentinel;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int w = 0; w < kTileWords; ++w) {
            uint32_t m = word_of(r[k], w);
            while (m) {
              const int b = __ffs(m) - 1;
              m &= m - 1;
              atomicMin(ot + 32 * w + b, key[k]);
            }
          }
        }
      } else {
        dense_tile(reinterpret_cast<const uint32_t*>(ts), f, krow, ot, g, t);
      }
    }
    __syncwarp();  // every lane's reads of the slot are done
    if (produce(slot)) ++issued;  // slot == issued % kStages until exhausted
  }
}

}  // namespace

extern "C" {

int mxu_expand(const void* tiles, const void* row_idx, const void* col_id,
               const void* keys, const void* fwords, long long nfw, void* out,
               long long ntp, int col_tiles, int trees, long long fstride,
               long long ostride, int blocks, const void* ctl, void* stream) {
  if (blocks <= 0 || trees < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool batch = trees > 1;
  auto kernel = batch ? mxu_expand_kernel<true> : mxu_expand_kernel<false>;
  static bool configured[2] = {false, false};
  if (!configured[batch]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[batch] = true;
  }
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(tiles), static_cast<const int32_t*>(row_idx),
      static_cast<const int32_t*>(col_id), static_cast<const uint32_t*>(keys),
      static_cast<const uint32_t*>(fwords), nfw, static_cast<uint32_t*>(out), ntp,
      col_tiles, trees, fstride, ostride, static_cast<const int32_t*>(ctl));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
