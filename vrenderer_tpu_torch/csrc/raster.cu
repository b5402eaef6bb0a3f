// Binned triangle rasterizers for Hopper (sm_90a).
//
// B1, `vrt_raster`, replaces the TPU kernel vrenderer_tpu/ops/raster_pallas.py
// `_raster_kernel` (full variant), launched by `rasterize_pallas`. Same
// result: per pixel the minimum z over covered triangles (the maximum under
// reverse-z), ties to the lowest global id inst * T + t, then the winner's
// inv_w and 8 attr/w planes evaluated at the pixel centre and divided by the
// guarded inv_w. With wire_px > 0 (wireframe) a pixel covers only within
// wire_px of an edge.
//
// B2, `vrt_raster_depth`, replaces `_raster_kernel(depth_only=True)`,
// launched by `rasterize_pallas_depth` (the map-mode light view): per pixel
// only the minimum covered z, F32_FAR where nothing covers, bit-identical
// to B1's z channel on the same inputs. Always forward-z, no wireframe.
//
// B3a, `vrt_raster_zid`, replaces `_raster_kernel(depth_only=True,
// with_id=True)`, launched by `rasterize_pallas_zid` (two-phase phase 1):
// B1 without the attributes, so z and id are bit-identical to B1's.
//
// B3b, `vrt_raster_resolve`, replaces `_resolve_kernel`, launched by
// `rasterize_pallas_resolve` (two-phase phase 2): the 8 attributes of the
// phase-1 winners where the winner's (instance, supertile) work item is
// live at the pixel's cell, 0 elsewhere, with B1's arithmetic, so the
// attrs are bit-identical to B1's. One launch, pixel-major: each block
// owns a band of rows of one supertile, reads and writes each of its
// pixels once (below).
//
// The winner filter, `vrt_filter_winners`, is the counterpart of the JAX
// package's `filter_work_to_winners` (plain JAX there, no Pallas kernel):
// one launch, one block per supertile (below).
//
// What bounds B1, B2 and B3a on the H100, and the design that answers it
// (one template, `region_kernel`, one launch each):
//   * The merge. A global image of 64-bit keys costs a memset, one L2
//     atomic per covered (triangle, pixel) pair and a second launch to
//     decode it. Here a cluster of `cluster` blocks (1-16) owns a `region` x
//     `region` pixel square of one supertile, as the TPU kernel owns its
//     tile's z/id in VMEM. Each block keeps a copy of the square's keys in
//     dynamic shared memory: (hi << 32) | gid with hi = float_bits(z), or
//     ~float_bits(z) under reverse-z (B1, B3a), or the 32-bit float_bits(z)
//     (B2). Covered z is in [+0, 1.01], so the bits order like the floats
//     and their complement like -z; the low word breaks ties to the lowest
//     id; the untouched key ~0 is the background, which no covered key
//     equals (no gid is 0xffffffff, no covered z has all bits set). A
//     covered pair is a shared-memory atomicMin (native ATOMS.MIN for 32
//     bits; a compare-and-swap loop for 64), order-free, so the result does
//     not depend on which block takes which item, or in which order. After a
//     cluster barrier each block takes the min over the cluster's copies of
//     its share of the pixels through distributed shared memory and writes
//     them once: z and id, B1 also the winner's attributes from its 27
//     plane coefficients, B2 only z. A 64 x 64 region holds 32 KB of 64-bit
//     keys (540 regions at 1080p, 1024 on a 2048^2 light map); 128 x 128
//     needs 128 KB, above the 48 KB default, hence cudaFuncSetAttribute.
//   * The work list is not grouped by supertile (full_work_list is
//     instance-major), so each block scans it, 1024 items (8 KB) at a
//     time, for the items of its supertile; inst < 0 marks unused slots.
//     The blocks of a cluster split the region's work in units of kBlock
//     triangles of one item, round-robin, so an item-heavy region (the
//     light view piles hundreds of fine patches into a few pixels) gets
//     `cluster` blocks' worth of threads.
//   * The bbox walk. Near-plane-crossing triangles carry the whole frame as
//     their bbox, and one thread per (triangle, bbox pixel) pair spent
//     almost all its work on pixels no edge function could cover. Here a
//     triangle's bbox within the region of at most kSmallPx pixels (the
//     median light-view triangle is 16 px) is walked by one thread, with no
//     block-wide scan. A larger one goes to one warp, which cuts its
//     bbox-in-region into kCell x kCell blocks (from the rect's top-left),
//     drops a block where no pixel centre could pass the exact test
//     (below), and evaluates the live blocks' pixels two per lane.
//   * Latency. A round is kBatch bbox loads in flight per thread, then a
//     dependent load of the planes of each triangle that meets the region,
//     and two barriers: the kernels are bound by these chains, not by the
//     atomics or the arithmetic, so a round is kept short enough to spill
//     no registers.
//   * The bytes of triangle data: each block reads the 16-byte bbox of
//     every triangle of its units, and the 12 plane floats of the triangles
//     that meet its region (mostly L2 hits); B1's output pass reads the
//     winners' 108 B of coefficients once per pixel. B2 and B3a read none
//     of them.
// What the design leaves for later: item-level early-z and near-to-far
// skipping, TMA staging of the triangle rows. The TPU kernel's one-hot MXU
// compaction, bf16 splits and per-cell round counts are TPU layout and have
// no counterpart here.
//
// The block test. plane(a, b, c, px, py) = fl(fl(fl(a px) + fl(b py)) + c)
// differs from the exact a px + b py + c by at most gamma_3 (|a||px| +
// |b||py| + |c|) <= 3.0001 u S, u = 2^-24, S = |a||px| + |b||py| + |c|, plus
// at most 3 * 2^-150 where a result is subnormal. Take S over the block with
// its largest |px| and |py| (the corners' far side: px, py > 0). The exact
// plane is affine, so at any pixel centre of the block it is at most its
// largest value at the four corner centres. If the rounded plane is >= 0 at
// some pixel, the exact one there is >= -3.0001 u S, so the largest exact
// corner value is too, and the largest rounded corner value is >= -6.0002 u
// S - 6 * 2^-150. The margin m = fl(S) * 2^-20 + 1e-30 (16 u S, with S
// itself rounded three times) exceeds that, so an edge whose largest
// rounded corner value is < -m cannot be >= 0 at any pixel of the block:
// the block is dropped. Likewise for z: a block whose smallest corner z is
// > fl(1.01f + m) (so >= 1.01f + m + half an ulp) or whose largest is < -m
// cannot hold a z in [0, 1.01f]. Comparisons with NaN are false, so they
// drop nothing: an overflowed S gives m = inf and keeps every block. A
// triangle with a NaN among its 12 plane floats covers no pixel (NaN
// propagates through plane()), so the warp skips it. Wireframe only takes
// coverage away, so the edge test holds under wire_px > 0. The per-pixel
// test is the exact one; the block test only prunes. (Rounding to nearest
// is monotone, so the rounded plane is itself monotone along x and along y
// and takes its extremes over the block at corner centres: the margin only
// widens a test that is already exact, and keeps it so where S overflows.)
//
// B3b is bound by bytes: 4 B of id read and 32 B of attrs written per
// pixel, and the distinct winners' 108 B of coefficients; per covered
// pixel it evaluates 9 planes and 8 IEEE divisions. The TPU kernel walks
// work items because its grid does; here one block per band of `rows` rows
// (a multiple of sub_h) of a supertile (a) scans the work list for the
// supertile's items and sets bit `inst` of a shared-memory bitmap of each
// band cell where the item's live byte is set, which makes "any live copy"
// the rule for an item listed twice, then (b) takes the band's pixels in
// row order (coalesced id reads), writes zeros where the id is background
// or its instance's bit is clear, and otherwise the winner's attrs
// (`winner_attrs`, as B1) as two float4 stores. The bitmap holds n_inst
// bits a cell, at most kMaxInst. The divisions by T, tile, sub_h and win_w
// are a multiply-high and a shift (`Div`). The coefficient gather is the
// other cost: each load of a warp touches one L1 line per distinct winner,
// so 27 scalar loads a pixel kept a first version at 2.4-2.6x its bound;
// each pixel here reads its winner's row as 8 aligned float4 and shifts it
// in registers (`load_coef`). Staging a warp's distinct rows in shared
// memory (deduplicated with __match_any_sync) was slower still: the warp
// waits on its staged loads before any arithmetic.
//
// The filter is bound by its 4 B a pixel of id reads; its TPU-era form was
// a dozen small launches. One block per supertile reduces, per cell, the
// min and max of id / T over the cell's in-frame covered pixels (lane
// groups of one cell reduce with shuffles, then one shared atomic each),
// then writes the live row of every item of its supertile (instance in
// [min, max]) and the item, or (-1, -1) where no cell is live. One more
// block writes the rows of unused slots.
//
// Exactness: every plane is evaluated as (a*px + b*py) + c with separate
// IEEE roundings (__fmul_rn/__fadd_rn; the library is also built with
// --fmad=false), matching the JAX package's evaluation order; -0.0 depth is
// canonicalised to +0.0 before packing; NaN fails every explicit coverage
// comparison.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kVisStride = 16;   // e0(a,b,c) e1 e2 z(a,b,c) bbox(x0,y0,x1,y1)
constexpr int kCoefStride = 27;  // [inv_w, attr0..7] x (a, b, c)
constexpr int kAttrs = 8;
constexpr float kFar = 3.0e38f;
constexpr int kCell = 8;                 // side of a block-test block
constexpr int kSmallPx = kCell * kCell;  // one thread walks rects this small
constexpr int kBatch = 4;                // loads a thread keeps in flight
constexpr int kRound = kBlock * kBatch;  // triangles (or items) per round
constexpr float kMarginScale = 9.5367431640625e-7f;  // 2^-20 = 16 u
constexpr float kMarginFloor = 1e-30f;
constexpr size_t kMaxSmem = 232448;      // per block on the H100
constexpr int kMaxCluster = 16;          // 8 is portable; the H100 allows 16
// B3b's instance bitmap: bench.py's envelope has 4096 terrain slots, plus
// the scene's block slots
constexpr int kMaxInst = 8192;

enum Output { kFull, kZid, kDepth };

template <int kOut>
struct KeyOf {
  using T = unsigned long long;
};
template <>
struct KeyOf<kDepth> {
  using T = unsigned int;
};

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

// Inclusive prefix sum over the block (kBlock threads); afterwards
// warp_sums[kWarps - 1] holds the block's total.
__device__ __forceinline__ int block_inclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      int n = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += n;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  return v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

// A block's pixel square, clipped to the frame (x1, y1 inclusive).
struct Region {
  int x0, y0, x1, y1, side;
};

// The pixels of an inclusive float bbox inside the region: top-left (x0,
// y0), w x h. False when there are none; invalid triangles carry an empty
// (+FAR, -FAR) bbox, and the explicit comparisons also reject NaN before
// fmaxf/fminf could drop it.
__device__ __forceinline__ bool clip_rect(float4 bb, const Region& r, int* x0,
                                          int* y0, int* w, int* h) {
  if (!(bb.x <= (float)r.x1 && bb.z >= (float)r.x0 && bb.y <= (float)r.y1 &&
        bb.w >= (float)r.y0)) {
    return false;
  }
  *x0 = (int)fmaxf(ceilf(bb.x), (float)r.x0);
  *y0 = (int)fmaxf(ceilf(bb.y), (float)r.y0);
  *w = (int)fminf(floorf(bb.z), (float)r.x1) - *x0 + 1;
  *h = (int)fminf(floorf(bb.w), (float)r.y1) - *y0 + 1;
  return *w > 0 && *h > 0;
}

__device__ __forceinline__ void load_planes(const float* __restrict__ p,
                                            float* c) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
    c[4 * i] = q.x;
    c[4 * i + 1] = q.y;
    c[4 * i + 2] = q.z;
    c[4 * i + 3] = q.w;
  }
}

// The exact per-pixel test at (x, y); a covered pixel min-merges its key.
template <int kOut>
__device__ __forceinline__ void raster_pixel(
    const float* c, int x, int y, unsigned int gid, const Region& r,
    int reverse_z, float wire_px, typename KeyOf<kOut>::T* s_key) {
  const float px = (float)x + 0.5f;
  const float py = (float)y + 0.5f;
  const float e0 = plane(c[0], c[1], c[2], px, py);
  const float e1 = plane(c[3], c[4], c[5], px, py);
  const float e2 = plane(c[6], c[7], c[8], px, py);
  const float zq = plane(c[9], c[10], c[11], px, py);
  bool cover = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && zq >= 0.0f &&
               zq <= 1.01f;
  // wireframe: only pixels within wire_px of an edge (the edges are
  // gradient-normalised, so e is a distance in pixels)
  if (wire_px > 0.0f) cover = cover && fminf(e0, fminf(e1, e2)) <= wire_px;
  if (!cover) return;
  const unsigned int zbits = __float_as_uint(__fadd_rn(zq, 0.0f));
  const int i = (y - r.y0) * r.side + (x - r.x0);
  if constexpr (kOut == kDepth) {
    atomicMin(&s_key[i], zbits);
  } else {
    const unsigned int hi = reverse_z ? ~zbits : zbits;
    atomicMin(&s_key[i], ((unsigned long long)hi << 32) | gid);
  }
}

// The smallest and largest rounded value of plane c over the corner pixel
// centres (pxa..pxb, pya..pyb), and the margin m of the header's bound.
__device__ __forceinline__ void corner_range(const float* c, float pxa,
                                             float pxb, float pya, float pyb,
                                             float* lo, float* hi, float* m) {
  const float v0 = plane(c[0], c[1], c[2], pxa, pya);
  const float v1 = plane(c[0], c[1], c[2], pxb, pya);
  const float v2 = plane(c[0], c[1], c[2], pxa, pyb);
  const float v3 = plane(c[0], c[1], c[2], pxb, pyb);
  *lo = fminf(fminf(v0, v1), fminf(v2, v3));
  *hi = fmaxf(fmaxf(v0, v1), fmaxf(v2, v3));
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(fabsf(c[0]), pxb),
                                      __fmul_rn(fabsf(c[1]), pyb)),
                            fabsf(c[2]));
  *m = __fadd_rn(__fmul_rn(s, kMarginScale), kMarginFloor);
}

// False only when no pixel centre of block [x0, x1] x [y0, y1] can pass
// raster_pixel's coverage test.
__device__ __forceinline__ bool block_live(const float* c, int x0, int y0,
                                           int x1, int y1) {
  const float pxa = (float)x0 + 0.5f, pxb = (float)x1 + 0.5f;
  const float pya = (float)y0 + 0.5f, pyb = (float)y1 + 0.5f;
  float lo, hi, m;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    corner_range(c + 3 * e, pxa, pxb, pya, pyb, &lo, &hi, &m);
    if (hi < -m) return false;
  }
  corner_range(c + 9, pxa, pxb, pya, pyb, &lo, &hi, &m);
  return !(hi < -m || lo > __fadd_rn(1.01f, m));
}

// One warp: triangle gid, whose bbox within the region is larger than
// kSmallPx, by blocks of kCell x kCell.
template <int kOut>
__device__ void raster_big(const float* __restrict__ vis, unsigned int gid,
                           const Region& r, int reverse_z, float wire_px,
                           typename KeyOf<kOut>::T* s_key) {
  const float* p = vis + (size_t)gid * kVisStride;
  float c[12];
  load_planes(p, c);
  bool nan = false;
#pragma unroll
  for (int i = 0; i < 12; ++i) nan = nan || isnan(c[i]);
  int x0, y0, w, h;
  if (nan || !clip_rect(__ldg(reinterpret_cast<const float4*>(p) + 3), r, &x0,
                        &y0, &w, &h)) {
    return;  // warp-uniform: every lane read the same triangle
  }
  const int lane = threadIdx.x & 31;
  const int nbx = (w + kCell - 1) / kCell;
  const int nb = nbx * ((h + kCell - 1) / kCell);
  for (int b0 = 0; b0 < nb; b0 += 32) {
    bool live = false;
    if (b0 + lane < nb) {
      const int bx = x0 + (b0 + lane) % nbx * kCell;
      const int by = y0 + (b0 + lane) / nbx * kCell;
      live = block_live(c, bx, by, min(bx + kCell, x0 + w) - 1,
                        min(by + kCell, y0 + h) - 1);
    }
    unsigned int mask = __ballot_sync(0xffffffffu, live);
    while (mask) {
      const int b = b0 + __ffs(mask) - 1;
      mask &= mask - 1;
      const int bx = x0 + b % nbx * kCell;
      const int by = y0 + b / nbx * kCell;
      const int bx1 = min(bx + kCell, x0 + w) - 1;
      const int by1 = min(by + kCell, y0 + h) - 1;
      for (int j = lane; j < kSmallPx; j += 32) {
        const int x = bx + j % kCell;
        const int y = by + j / kCell;
        if (x <= bx1 && y <= by1) {
          raster_pixel<kOut>(c, x, y, gid, r, reverse_z, wire_px, s_key);
        }
      }
    }
  }
}

// This block's share of the region's work: units u = rank, rank + n_rank,
// ... of the n_item matched items' triangles in chunks of kBlock (unit u:
// item u / chunks, triangles kBlock * (u % chunks) + threadIdx.x), kBatch
// units a round. A triangle whose bbox within the region is small is walked
// by the thread that loaded it; a larger one is queued in s_big (its gid)
// and taken by the warps. s_n_big[2] are the queue lengths of alternate
// rounds: a round reads its own after a barrier and clears the other one,
// which the next round fills.
template <int kOut>
__device__ void raster_units(const float* __restrict__ vis,
                             const int* s_item, int n_item, int tris_per_inst,
                             unsigned int rank, unsigned int n_rank,
                             const Region& r, int reverse_z, float wire_px,
                             typename KeyOf<kOut>::T* s_key,
                             unsigned int* s_big, int* s_n_big, int& parity) {
  const int chunks = (tris_per_inst + kBlock - 1) / kBlock;
  const int n_unit = n_item * chunks;
  for (int u0 = (int)rank; u0 < n_unit; u0 += kBatch * (int)n_rank) {
    float4 bb[kBatch];
    unsigned int gid[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int u = u0 + b * (int)n_rank;
      const int t = u % chunks * kBlock + threadIdx.x;
      bb[b] = make_float4(kFar, kFar, -kFar, -kFar);
      gid[b] = 0;
      if (u < n_unit && t < tris_per_inst) {
        gid[b] = (unsigned int)s_item[u / chunks] *
                     (unsigned int)tris_per_inst +
                 (unsigned int)t;
        bb[b] = __ldg(reinterpret_cast<const float4*>(
                          vis + (size_t)gid[b] * kVisStride) + 3);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      int x0, y0, w, h;
      if (!clip_rect(bb[b], r, &x0, &y0, &w, &h)) continue;
      if (w * h > kSmallPx) {
        s_big[atomicAdd(&s_n_big[parity], 1)] = gid[b];
        continue;
      }
      float c[12];
      load_planes(vis + (size_t)gid[b] * kVisStride, c);
      for (int y = y0; y < y0 + h; ++y) {
        for (int x = x0; x < x0 + w; ++x) {
          raster_pixel<kOut>(c, x, y, gid[b], r, reverse_z, wire_px, s_key);
        }
      }
    }
    __syncthreads();
    const int n_big = s_n_big[parity];
    if (threadIdx.x == 0) s_n_big[parity ^ 1] = 0;
    for (int i = threadIdx.x >> 5; i < n_big; i += kWarps) {
      raster_big<kOut>(vis, s_big[i], r, reverse_z, wire_px, s_key);
    }
    __syncthreads();
    parity ^= 1;
  }
}

// The winner's 8 perspective-divided attributes at pixel (x, y).
__device__ __forceinline__ void winner_attrs(const float* __restrict__ c,
                                             int x, int y,
                                             float* __restrict__ out) {
  const float px = (float)x + 0.5f;
  const float py = (float)y + 0.5f;
  const float inv_w = plane(c[0], c[1], c[2], px, py);
  const float denom = fabsf(inv_w) > 1e-20f ? inv_w : 1.0f;
#pragma unroll
  for (int i = 0; i < kAttrs; ++i) {
    const float* q = c + 3 * (i + 1);
    out[i] = __fdiv_rn(plane(q[0], q[1], q[2], px, py), denom);
  }
}

// B1 (kFull), B3a (kZid) and B2 (kDepth): one cluster of blocks per
// region (blockIdx.x / cluster size, blockIdx.y), each block with a copy of
// the region's keys in dynamic shared memory (region^2 keys, then 2 x
// kRound ints: the segment's items and the round's large triangles).
template <int kOut>
__global__ void __launch_bounds__(kBlock)
region_kernel(const float* __restrict__ vis, const float* __restrict__ coef,
              const int* __restrict__ items, int n_items, int tris_per_inst,
              int tiles_x, int tile, int region, int width, int height,
              int reverse_z, float wire_px, float* __restrict__ z,
              int* __restrict__ id, float* __restrict__ attrs) {
  using Key = typename KeyOf<kOut>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  Key* s_key = reinterpret_cast<Key*>(smem);
  int* s_item = reinterpret_cast<int*>(s_key + region * region);
  unsigned int* s_big = reinterpret_cast<unsigned int*>(s_item + kRound);
  __shared__ int s_warp[kWarps];
  __shared__ int s_n_big[2];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int rank = cluster.block_rank();
  const unsigned int n_rank = cluster.num_blocks();

  Region r;
  r.x0 = blockIdx.x / n_rank * region;
  r.y0 = blockIdx.y * region;
  r.x1 = min(r.x0 + region, width) - 1;
  r.y1 = min(r.y0 + region, height) - 1;
  r.side = region;
  const int st = (r.y0 / tile) * tiles_x + r.x0 / tile;
  const int n_key = region * region;
  for (int i = threadIdx.x; i < n_key; i += kBlock) s_key[i] = ~Key(0);
  if (threadIdx.x < 2) s_n_big[threadIdx.x] = 0;

  int parity = 0;
  int n_region_items = 0;  // the same in every block of the cluster
  for (int seg = 0; seg < n_items; seg += kRound) {
    // this segment's items of the region's supertile, into s_item
    int inst[kBatch];
    int mine = 0;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = seg + b * kBlock + threadIdx.x;
      inst[b] = -1;
      if (j < n_items && items[2 * j] >= 0 && items[2 * j + 1] == st) {
        inst[b] = items[2 * j];
        ++mine;
      }
    }
    int pos = block_inclusive_scan(mine, s_warp) - mine;
    const int n_mine = s_warp[kWarps - 1];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (inst[b] >= 0) s_item[pos++] = inst[b];
    }
    __syncthreads();
    raster_units<kOut>(vis, s_item, n_mine, tris_per_inst, rank, n_rank, r,
                       reverse_z, wire_px, s_key, s_big, s_n_big, parity);
    n_region_items += n_mine;
  }
  // every block's keys are final and visible to the cluster; a region
  // without items is background in every block, which then reads no other
  // block's keys and needs no barrier
  const bool merge = n_region_items > 0 && n_rank > 1;
  if (merge) cluster.sync();
  __syncthreads();

  // each pixel of the region once: rank takes runs of kBlock pixels
  for (int i = rank * kBlock + threadIdx.x; i < n_key; i += n_rank * kBlock) {
    const int x = r.x0 + i % region;
    const int y = r.y0 + i / region;
    if (x > r.x1 || y > r.y1) continue;
    Key key = s_key[i];
    for (unsigned int q = 0; merge && q < n_rank; ++q) {
      if (q == rank) continue;
      const Key other = *cluster.map_shared_rank(s_key + i, q);
      if (other < key) key = other;
    }
    const size_t p = (size_t)y * width + x;
    if constexpr (kOut == kDepth) {
      z[p] = key == ~Key(0) ? kFar : __uint_as_float(key);
    } else if (key == ~Key(0)) {  // background
      z[p] = reverse_z ? -kFar : kFar;
      id[p] = -1;
      if constexpr (kOut == kFull) {
#pragma unroll
        for (int a = 0; a < kAttrs; ++a) attrs[p * kAttrs + a] = 0.0f;
      }
    } else {
      const unsigned int gid = (unsigned int)(key & 0xffffffffull);
      const unsigned int hi = (unsigned int)(key >> 32);
      z[p] = __uint_as_float(reverse_z ? ~hi : hi);
      id[p] = (int)gid;
      if constexpr (kOut == kFull) {
        winner_attrs(coef + (size_t)gid * kCoefStride, x, y,
                     attrs + p * kAttrs);
      }
    }
  }
  // no block leaves while another may still read its keys
  if (merge) cluster.sync();
}

// One launch of region_kernel<kOut> over the frame, `cluster` blocks a
// region; a region must lie in one supertile and its keys fit in shared
// memory.
template <int kOut>
int launch_regions(const float* vis, const float* coef, const int* items,
                   int n_items, int tris_per_inst, int tiles_x, int tile,
                   int region, int cluster, int width, int height,
                   int reverse_z, float wire_px, float* z, int* id,
                   float* attrs, cudaStream_t s) {
  using Key = typename KeyOf<kOut>::T;
  const size_t smem =
      (size_t)region * region * sizeof(Key) + 2 * kRound * sizeof(int);
  if (region <= 0 || tile % region != 0 || smem > kMaxSmem - 64 ||
      cluster < 1 || cluster > kMaxCluster || width <= 0 || height <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      region_kernel<kOut>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (cluster > 8) {
    const cudaError_t np = cudaFuncSetAttribute(
        region_kernel<kOut>, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
    if (np != cudaSuccess) return (int)np;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((width + region - 1) / region * cluster,
                     (height + region - 1) / region);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t l = cudaLaunchKernelEx(
      &cfg, region_kernel<kOut>, vis, coef, items, n_items, tris_per_inst,
      tiles_x, tile, region, width, height, reverse_z, wire_px, z, id, attrs);
  if (l != cudaSuccess) return (int)l;
  return (int)cudaGetLastError();
}

// n / d for 0 <= n < 2^31 as a multiply-high and a shift (Granlund and
// Montgomery): with s = ceil(log2 d) and m = floor(2^32 (2^s - d) / d) + 1,
// n / d = (umulhi(n, m) + n) >> s, the sum fitting 32 bits as n < 2^31.
struct Div {
  unsigned int m, s;
};

Div make_div(int d) {
  unsigned int s = 0;
  while ((1ull << s) < (unsigned long long)d) ++s;
  const unsigned long long m =
      (1ull << 32) * ((1ull << s) - (unsigned long long)d) / d + 1;
  return Div{(unsigned int)m, s};
}

__device__ __forceinline__ int div_by(int n, Div d) {
  return (int)((__umulhi((unsigned int)n, d.m) + (unsigned int)n) >> d.s);
}

// The cell grid of a supertile: cells of sub_h x win_w pixels, n_win a
// cell row.
struct Cells {
  int tile, sub_h, win_w, n_win, n_cell;
  Div tile_d, sub_d, win_d;
};

Cells make_cells(int tile, int sub_h, int win_w) {
  Cells c;
  c.tile = tile;
  c.sub_h = sub_h;
  c.win_w = win_w;
  c.n_win = tile / win_w;
  c.n_cell = tile / sub_h * c.n_win;
  c.tile_d = make_div(tile);
  c.sub_d = make_div(sub_h);
  c.win_d = make_div(win_w);
  return c;
}

bool cells_ok(int tile, int sub_h, int win_w) {
  return tile > 0 && sub_h > 0 && win_w > 0 && tile % sub_h == 0 &&
         tile % win_w == 0;
}

// Triangle gid's 27 coefficients (of n_floats) into c: with `vec` (coef
// 16-byte aligned), the 8 aligned float4 around its row, shifted by the
// row's offset in the first (rows are 27 floats, so it varies); a row
// whose float4s would pass the array's end is read float by float.
__device__ __forceinline__ void load_coef(const float* __restrict__ coef,
                                          unsigned int gid,
                                          unsigned int n_floats, bool vec,
                                          float* c) {
  const unsigned int f0 = gid * kCoefStride;
  const unsigned int base = f0 & ~3u;
  const unsigned int o = f0 & 3u;
  if (vec && base + 32u <= n_floats) {
    float v[32];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const float4 q =
          __ldg(reinterpret_cast<const float4*>(coef + base) + m);
      v[4 * m] = q.x;
      v[4 * m + 1] = q.y;
      v[4 * m + 2] = q.z;
      v[4 * m + 3] = q.w;
    }
#pragma unroll
    for (int k = 0; k < kCoefStride; ++k) {
      const float lo = (o & 2u) ? v[k + 2] : v[k];
      const float hi = (o & 2u) ? v[k + 3] : v[k + 1];
      c[k] = (o & 1u) ? hi : lo;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kCoefStride; ++k) c[k] = __ldg(coef + f0 + k);
  }
}

// B3b: one block per band of `rows` pixel rows of a supertile, blockIdx.x
// = supertile * (tile / rows) + band. Dynamic shared memory: the band's
// cells' instance bitmaps, `words` 32-bit words each.
__global__ void __launch_bounds__(kBlock)
resolve_kernel(const float* __restrict__ coef, unsigned int n_floats,
               bool vec, const int* __restrict__ items,
               const unsigned char* __restrict__ live, int n_items,
               int n_inst, Div tris, int tiles_x, Cells g, int rows,
               int width, int height, const int* __restrict__ id,
               float* __restrict__ attrs) {
  extern __shared__ unsigned int s_bits[];
  const int bands = g.tile / rows;
  const int st = blockIdx.x / bands;
  const int tx0 = st % tiles_x * g.tile;
  const int by0 = blockIdx.x % bands * rows;  // the band's row in its tile
  const int y0 = st / tiles_x * g.tile + by0;
  if (y0 >= height) return;  // a band wholly below the frame
  const int cell0 = by0 / g.sub_h * g.n_win;
  const int band_cells = rows / g.sub_h * g.n_win;
  const int words = (n_inst + 31) >> 5;
  for (int i = threadIdx.x; i < band_cells * words; i += kBlock) {
    s_bits[i] = 0;
  }
  __syncthreads();
  // (a) bit inst of cell c for every live (item, c) of this supertile
  for (int j = threadIdx.x; j < n_items; j += kBlock) {
    const int inst = items[2 * j];
    if (inst < 0 || inst >= n_inst || items[2 * j + 1] != st) continue;
    const unsigned char* lv = live + (size_t)j * g.n_cell + cell0;
    for (int c = 0; c < band_cells; ++c) {
      if (lv[c]) {
        atomicOr(&s_bits[c * words + (inst >> 5)], 1u << (inst & 31));
      }
    }
  }
  __syncthreads();
  // (b) every pixel of the band once, kBatch id loads in flight a thread
  const int n_px = rows * g.tile;
  for (int j0 = threadIdx.x; j0 < n_px; j0 += kBatch * kBlock) {
    int gid[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = j0 + b * kBlock;
      const int yl = div_by(j, g.tile_d);
      const int x = tx0 + j - yl * g.tile;
      const int y = y0 + yl;
      gid[b] = -2;  // outside the band or the frame: no pixel
      if (j < n_px && x < width && y < height) {
        gid[b] = id[(size_t)y * width + x];
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (gid[b] == -2) continue;
      const int j = j0 + b * kBlock;
      const int yl = div_by(j, g.tile_d);
      const int xl = j - yl * g.tile;
      const int x = tx0 + xl;
      const int y = y0 + yl;
      float out[kAttrs];
      bool write = false;
      if (gid[b] >= 0) {
        const int inst = div_by(gid[b], tris);
        const int c = div_by(yl, g.sub_d) * g.n_win + div_by(xl, g.win_d);
        write = inst < n_inst &&
                (s_bits[c * words + (inst >> 5)] >> (inst & 31)) & 1u;
      }
      if (write) {
        float cf[kCoefStride];
        load_coef(coef, (unsigned int)gid[b], n_floats, vec, cf);
        winner_attrs(cf, x, y, out);
      } else {
#pragma unroll
        for (int a = 0; a < kAttrs; ++a) out[a] = 0.0f;
      }
      float4* dst = reinterpret_cast<float4*>(
          attrs + ((size_t)y * width + x) * kAttrs);
      dst[0] = make_float4(out[0], out[1], out[2], out[3]);
      dst[1] = make_float4(out[4], out[5], out[6], out[7]);
    }
  }
}

constexpr int kFilterBlock = 1024;

// The winner filter: blocks 0 .. n_st - 1 one supertile each, block n_st
// the unused slots. Dynamic shared memory: n_cell minima, n_cell maxima.
// `group` lanes (a power of two dividing win_w, at most 32) hold pixels of
// one cell.
__global__ void __launch_bounds__(kFilterBlock)
filter_kernel(const int* __restrict__ items, int n_items,
              const int* __restrict__ id, Div tris, int tiles_x, int n_st,
              Cells g, int group, int width, int height,
              int* __restrict__ items_out, unsigned char* __restrict__ live) {
  extern __shared__ int s_range[];
  int* s_mn = s_range;
  int* s_mx = s_range + g.n_cell;
  const int st = blockIdx.x;
  if (st == n_st) {
    for (int j = threadIdx.x; j < n_items; j += kFilterBlock) {
      const int s = items[2 * j + 1];
      if (items[2 * j] >= 0 && s >= 0 && s < n_st) continue;
      items_out[2 * j] = -1;
      items_out[2 * j + 1] = -1;
      for (int c = 0; c < g.n_cell; ++c) {
        live[(size_t)j * g.n_cell + c] = 0;
      }
    }
    return;
  }
  for (int c = threadIdx.x; c < g.n_cell; c += kFilterBlock) {
    s_mn[c] = 1 << 30;
    s_mx[c] = -1;
  }
  __syncthreads();
  const int tx0 = st % tiles_x * g.tile;
  const int ty0 = st / tiles_x * g.tile;
  const int n_px = g.tile * g.tile;
  const int lane = threadIdx.x & 31;
  // every lane runs every round (the shuffles need the whole warp)
  for (int base = 0; base < n_px; base += kBatch * kFilterBlock) {
    int gid[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = base + b * kFilterBlock + threadIdx.x;
      const int yl = div_by(j, g.tile_d);
      const int x = tx0 + j - yl * g.tile;
      const int y = ty0 + yl;
      gid[b] = -1;  // outside the tile or the frame: background
      if (j < n_px && x < width && y < height) {
        gid[b] = id[(size_t)y * width + x];
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = base + b * kFilterBlock + threadIdx.x;
      int mn = 1 << 30, mx = -1;
      if (gid[b] >= 0) mn = mx = div_by(gid[b], tris);
      for (int o = 1; o < group; o <<= 1) {
        mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
        mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      if (lane % group == 0 && mx >= 0) {
        const int yl = div_by(j, g.tile_d);
        const int c =
            div_by(yl, g.sub_d) * g.n_win + div_by(j - yl * g.tile, g.win_d);
        atomicMin(&s_mn[c], mn);
        atomicMax(&s_mx[c], mx);
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_items; j += kFilterBlock) {
    const int inst = items[2 * j];
    if (inst < 0 || items[2 * j + 1] != st) continue;
    bool any = false;
    for (int c = 0; c < g.n_cell; ++c) {
      const bool l = s_mn[c] <= inst && inst <= s_mx[c];
      live[(size_t)j * g.n_cell + c] = l;
      any = any || l;
    }
    items_out[2 * j] = any ? inst : -1;
    items_out[2 * j + 1] = any ? st : -1;
  }
}

// Lets a kernel take `smem` bytes of dynamic shared memory beside its
// static shared memory (above 48 KB in all only with this attribute).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Rasterize (B1): z, id (height, width) and attrs (height, width, 8) are
// outputs. items holds n_items (inst, supertile) int32 pairs in any order,
// inst < 0 marking unused slots. region (dividing tile) is the side of the
// pixel square one cluster of `cluster` blocks (1-16; above 8 a
// non-portable size, which the H100 allows) merges in shared memory.
// reverse_z != 0 keeps the farthest z; wire_px > 0 is the wireframe line
// half-width. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue, without a launch, for a region that does not
// fit).
extern "C" int vrt_raster(const float* vis, const float* coef,
                          const int* items, int n_items, int tris_per_inst,
                          int tiles_x, int tile, int region, int cluster,
                          int width, int height, int reverse_z, float wire_px,
                          float* z, int* id, float* attrs, void* stream) {
  return launch_regions<kFull>(vis, coef, items, n_items, tris_per_inst,
                               tiles_x, tile, region, cluster, width, height,
                               reverse_z, wire_px, z, id, attrs,
                               static_cast<cudaStream_t>(stream));
}

// z + winner id (B3a): as vrt_raster without wireframe and attributes.
extern "C" int vrt_raster_zid(const float* vis, const int* items, int n_items,
                              int tris_per_inst, int tiles_x, int tile,
                              int region, int cluster, int width, int height,
                              int reverse_z, float* z, int* id,
                              void* stream) {
  return launch_regions<kZid>(vis, nullptr, items, n_items, tris_per_inst,
                              tiles_x, tile, region, cluster, width, height,
                              reverse_z, 0.0f, z, id, nullptr,
                              static_cast<cudaStream_t>(stream));
}

// Winner attributes (B3b): coef (n_inst, tris_per_inst, 27); id (height,
// width) int32 from vrt_raster_zid; items (n_items, 2) and live (n_items,
// n_cell) bytes from vrt_filter_winners, cell c of a supertile being the
// sub_h x win_w block at row c / (tile / win_w), column c % (tile / win_w);
// attrs (height, width, 8) is the output. `rows`, a multiple of sub_h
// dividing tile, is the band one block takes. n_inst is at most kMaxInst.
extern "C" int vrt_raster_resolve(const float* coef, const int* items,
                                  const unsigned char* live, int n_items,
                                  int n_inst, int tris_per_inst, int tiles_x,
                                  int tile, int sub_h, int win_w, int rows,
                                  int width, int height, const int* id,
                                  float* attrs, void* stream) {
  if (!cells_ok(tile, sub_h, win_w) || rows <= 0 || rows % sub_h != 0 ||
      tile % rows != 0 || n_inst < 0 || n_inst > kMaxInst ||
      tris_per_inst <= 0 || n_items < 0 || width <= 0 || height <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Cells g = make_cells(tile, sub_h, win_w);
  const size_t smem = (size_t)(rows / sub_h * g.n_win) *
                      ((n_inst + 31) / 32) * sizeof(unsigned int);
  const cudaError_t e = allow_smem(resolve_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_blocks = tiles_x * ((height + tile - 1) / tile) * (tile / rows);
  resolve_kernel<<<n_blocks, kBlock, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      coef, (unsigned int)(n_inst * tris_per_inst * kCoefStride),
      reinterpret_cast<uintptr_t>(coef) % 16 == 0, items, live, n_items,
      n_inst, make_div(tris_per_inst), tiles_x, g, rows, width, height, id,
      attrs);
  return (int)cudaGetLastError();
}

// The winner filter: id (height, width) int32 from vrt_raster_zid, items
// (n_items, 2); outputs items_out (n_items, 2), the item or (-1, -1)
// where it has no live cell, and live (n_items, n_cell) bytes, 1 where the
// item's instance lies in [min, max] of id / tris_per_inst over the cell's
// covered pixels. Slots with inst < 0 (or a supertile outside the frame)
// come out unused with no live cell.
extern "C" int vrt_filter_winners(const int* items, int n_items,
                                  const int* id, int tris_per_inst,
                                  int tiles_x, int tile, int sub_h, int win_w,
                                  int width, int height, int* items_out,
                                  unsigned char* live, void* stream) {
  if (!cells_ok(tile, sub_h, win_w) || tris_per_inst <= 0 || n_items < 0 ||
      width <= 0 || height <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Cells g = make_cells(tile, sub_h, win_w);
  int group = 1;
  while (group < 32 && win_w % (2 * group) == 0) group *= 2;
  const size_t smem = 2 * (size_t)g.n_cell * sizeof(int);
  const cudaError_t e = allow_smem(filter_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_st = tiles_x * ((height + tile - 1) / tile);
  filter_kernel<<<n_st + 1, kFilterBlock, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      items, n_items, id, make_div(tris_per_inst), tiles_x, n_st, g, group,
      width, height, items_out, live);
  return (int)cudaGetLastError();
}

// Depth-only rasterize (B2): z (height, width) float32 is the output, the
// minimum covered z or F32_FAR. Other arguments as for vrt_raster.
extern "C" int vrt_raster_depth(const float* vis, const int* items,
                                int n_items, int tris_per_inst, int tiles_x,
                                int tile, int region, int cluster, int width,
                                int height, float* z, void* stream) {
  return launch_regions<kDepth>(vis, nullptr, items, n_items, tris_per_inst,
                                tiles_x, tile, region, cluster, width, height,
                                0, 0.0f, z, nullptr, nullptr,
                                static_cast<cudaStream_t>(stream));
}
