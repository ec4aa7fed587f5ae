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
// on the card would serialise on a few SMs.  Here each warp takes one tile
// at a time from a grid-stride loop over all tiles.  It first reads the
// tile's 128-bit frontier block straight from the frontier words at
// row_idx[t] (words past the end, the pad block, read as zero) and skips the
// tile before touching its 2 KB if the block is zero; the reference's
// per-tile gather of frontier blocks is never materialised.
//
// The product on tensor cores.  mma.sync m16n8k16 (fp16 inputs, fp32
// accumulation) computes C[r, v] = sum_u A[r, u] * B[u, v] with
//   A[r, u] = frontier_bit(u) * 2^(u mod 8)   for u >> 3 == r   (16 x 128)
//   B[u, v] = tile bit (u, v) as 0.0 / 1.0                        (128 x 128)
// so C[r, v] is the 8-bit mask of frontier rows 8r..8r+7 that reach v.  The
// reference uses 8 groups of 16 rows (an 8 x 128 left side); 16 groups of 8
// fill all 16 rows of the m16n8k16 accumulator with real masks instead of
// padding 8 of them with zeros, and keep every weight at or below 2^7.  A
// sum of distinct powers of two below 2^8 is exact in fp32, so each
// accumulator is exactly its mask.  Each warp runs 8 k-steps (16 source rows
// each) x 16 n-tiles (8 destinations each) = at most 128 mma.sync per live
// tile: an n-tile whose 8 columns no frontier row of the tile reaches (a
// warp-wide OR of the rows' words) has all-zero products and is skipped.
//
// Epilogue.  Each lane walks the set bits of its four masks (two columns,
// two row groups), takes the minimum key over them (keys are original ids,
// not monotone in u), and atomicMin's it, unsigned, into out where it found
// one.  Min is associative and commutative, so the atomics give the bits of
// the reference's in-order reduction.
//
// Bound: bytes at R-MAT scale 22 — each live tile reads 2,048 B of tile and
// 16 B of frontier against 262,144 useful multiply-adds (4.6 edges a tile on
// average there).  The 2 KB tile and its 512-byte key row are read
// coalesced (16 B per lane) into shared memory, from which the B fragments
// are unpacked without bank conflicts and the epilogue reads its keys; the
// next tile's indices and frontier block load while the current one
// computes, so a warp's dependent loads do not serialise per tile.
// ---------------------------------------------------------------------------

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kTileWords = 4;
constexpr int kWarps = 8;  // warps per block; each owns one tile at a time
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr uint32_t kHalfOne = 0x3C00u;  // fp16 1.0

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
__device__ __forceinline__ uint32_t min_key(float c, int r, const uint32_t* krow,
                                            uint32_t best) {
  uint32_t m = static_cast<uint32_t>(c);
  while (m) {
    const int b = __ffs(m) - 1;
    m &= m - 1;
    const uint32_t k = krow[8 * r + b];
    best = k < best ? k : best;
  }
  return best;
}

// A tile's row block, column block and 128-bit frontier block (frontier
// words past the end, the pad block, read as zero).
__device__ __forceinline__ void tile_head(long long tix, const int32_t* __restrict__ row_idx,
                                          const int32_t* __restrict__ col_id,
                                          const uint32_t* __restrict__ fwords, long long nfw,
                                          long long& rb, int& cb, uint32_t (&f)[kTileWords]) {
  rb = __ldg(row_idx + tix);
  cb = __ldg(col_id + tix);
#pragma unroll
  for (int i = 0; i < kTileWords; ++i) {
    const long long w = rb * kTileWords + i;
    f[i] = w < nfw ? __ldg(fwords + w) : 0u;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
mxu_expand_kernel(const uint4* __restrict__ tiles, const int32_t* __restrict__ row_idx,
                  const int32_t* __restrict__ col_id, const uint32_t* __restrict__ keys,
                  const uint32_t* __restrict__ fwords, long long nfw,
                  uint32_t* __restrict__ out, long long ntp, int col_tiles) {
  __shared__ uint4 tile_s[kWarps][kTile];
  __shared__ uint4 key_s[kWarps][kTile / 4];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma thread in group
  const uint32_t* ts = reinterpret_cast<const uint32_t*>(tile_s[warp]);
  const uint32_t* krow = reinterpret_cast<const uint32_t*>(key_s[warp]);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long tix = static_cast<long long>(blockIdx.x) * kWarps + warp;
  // The next tile's head is loaded while the current tile computes.
  long long rb_next = 0;
  int cb_next = 0;
  uint32_t f_next[kTileWords] = {0u, 0u, 0u, 0u};
  if (tix < ntp) tile_head(tix, row_idx, col_id, fwords, nfw, rb_next, cb_next, f_next);
  for (; tix < ntp; tix += stride) {
    const long long rb = rb_next;
    const int cb = cb_next;
    uint32_t f[kTileWords];
#pragma unroll
    for (int i = 0; i < kTileWords; ++i) f[i] = f_next[i];
    if (tix + stride < ntp) {
      tile_head(tix + stride, row_idx, col_id, fwords, nfw, rb_next, cb_next, f_next);
    }
    // Warp-uniform: every lane holds the same tile.
    if ((f[0] | f[1] | f[2] | f[3]) == 0u) continue;
    if (cb >= col_tiles) continue;  // the dropped overflow segment

    __syncwarp();  // the previous tile's reads of tile_s and key_s are done
    const uint4* src = tiles + tix * kTile;
#pragma unroll
    for (int i = lane; i < kTile; i += 32) tile_s[warp][i] = __ldg(src + i);
    key_s[warp][lane] = __ldg(reinterpret_cast<const uint4*>(keys + rb * kTile) + lane);
    __syncwarp();

    // A fragments of the 8 k-steps (source rows 16j .. 16j + 15).  Rows of
    // k-step j belong to groups 2j (k < 8) and 2j + 1 (k >= 8); a fragment
    // register is nonzero only where its accumulator row is that group.
    uint32_t a[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t fw = f[j >> 1];
      const uint32_t lo = weight_pair(fw, 16 * j + 2 * t);
      const uint32_t hi = weight_pair(fw, 16 * j + 2 * t + 8);
      a[j][0] = g == 2 * j ? lo : 0u;          // row g,     k = 2t, 2t+1
      a[j][1] = g + 8 == 2 * j ? lo : 0u;      // row g + 8, k = 2t, 2t+1
      a[j][2] = g == 2 * j + 1 ? hi : 0u;      // row g,     k = 2t+8, 2t+9
      a[j][3] = g + 8 == 2 * j + 1 ? hi : 0u;  // row g + 8, k = 2t+8, 2t+9
    }

#pragma unroll
    for (int w = 0; w < kTileWords; ++w) {
      // Word w of the four tile rows this lane's B fragments read per k-step.
      uint32_t rw[8][4];
      // live: the columns of word w that this lane's frontier rows reach.
      uint32_t live = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int u = 16 * j + 2 * t;
        const uint32_t fw = f[j >> 1];
        rw[j][0] = ts[u * kTileWords + w];
        rw[j][1] = ts[(u + 1) * kTileWords + w];
        rw[j][2] = ts[(u + 8) * kTileWords + w];
        rw[j][3] = ts[(u + 9) * kTileWords + w];
        live |= ((fw >> (u & 31)) & 1u ? rw[j][0] : 0u) |
                ((fw >> ((u + 1) & 31)) & 1u ? rw[j][1] : 0u) |
                ((fw >> ((u + 8) & 31)) & 1u ? rw[j][2] : 0u) |
                ((fw >> ((u + 9) & 31)) & 1u ? rw[j][3] : 0u);
      }
      // Over the warp: every row of the tile.  An n-tile that no frontier
      // row reaches has all-zero products and is skipped (warp-uniform);
      // an s22 tile holds 4.6 edges on average, so most of its 16 are.
      live = __reduce_or_sync(0xFFFFFFFFu, live);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (((live >> (8 * q)) & 0xFFu) == 0u) continue;
        // n-tile 4w + q: destinations v = 32w + 8q + n; this lane's B
        // column is n = g, its accumulators columns 2t and 2t + 1.
        const int bit = 8 * q + g;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mma_m16n8k16(c, a[j], bit_pair(rw[j][0], rw[j][1], bit),
                       bit_pair(rw[j][2], rw[j][3], bit));
        }
        // c[0], c[1]: row group g, columns 2t, 2t + 1; c[2], c[3]: group g + 8.
        const uint32_t best0 = min_key(c[2], g + 8, krow, min_key(c[0], g, krow, kSentinel));
        const uint32_t best1 = min_key(c[3], g + 8, krow, min_key(c[1], g, krow, kSentinel));
        uint32_t* o = out + static_cast<long long>(cb) * kTile + 32 * w + 8 * q + 2 * t;
        if (best0 != kSentinel) atomicMin(o, best0);
        if (best1 != kSentinel) atomicMin(o + 1, best1);
      }
    }
  }
}

}  // namespace

extern "C" {

int mxu_expand(const void* tiles, const void* row_idx, const void* col_id,
               const void* keys, const void* fwords, long long nfw, void* out,
               long long ntp, int col_tiles, int blocks, void* stream) {
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  mxu_expand_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(tiles), static_cast<const int32_t*>(row_idx),
      static_cast<const int32_t*>(col_id), static_cast<const uint32_t*>(keys),
      static_cast<const uint32_t*>(fwords), nfw, static_cast<uint32_t*>(out), ntp,
      col_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
