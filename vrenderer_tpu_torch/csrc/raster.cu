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
// What bounds B1, B2 and B3a on the H100. Their bound is bytes (the
// visibility rows, the outputs), but their work is the (triangle, pixel)
// pairs the block test leaves, spread unevenly: the map light view piles
// 17-27% of its pairs into one 64-px region, the editor's scene 567k and
// the envelope's seam 1.90M. A design that gives a region a fixed number
// of blocks (the one before this) is as slow as its busiest region. Each
// call here is a few launches (one of the wrapper's launch count) over a
// scratch buffer the wrapper allocates, with no host synchronisation; each
// launch lets the next one's blocks be scheduled at once (programmatic
// dependent launch, `griddep`), so that they wait on the card, not behind
// a launch and a kernel's tail:
//   * Binning, once, on the device. The frame is cut into `region` x
//     `region` pixel squares within the supertiles. `bins_count`: a block
//     takes 1024 triangles of one work item (items in any order; inst < 0
//     marks an unused slot), 4 a thread with their bbox loads in flight,
//     reads each bbox once, clips it to each region of the item's
//     supertile and lists the triangle there with its cost, the
//     bbox-in-region pixels; a rect above kSmallPx pixels is queued, and
//     `bins_big` (a persistent grid of warps, 32 rects a warp, their rows
//     loaded together) replaces its cost by the pixels of the kCell x kCell
//     blocks the block test keeps, 32 blocks at once. A region's (entries
//     << 38 | cost) is summed with one global atomic per block. `bins_scan`
//     (one block) gives each region its first entry and ceil(cost / kChunk)
//     chunks of about equal cost, at least one; the chunk grows where the
//     chunks would pass the scratch's max_chunks. `bins_scatter` reserves a
//     block's entries of a region with one 64-bit atomic on (count, cost),
//     so that an entry's slot and its cost prefix agree, and marks the
//     entry whose cost span holds a multiple of the region's chunk cost as
//     the first of that chunk.
//   * The raster launch splits the work by cost, not by region. A
//     persistent grid of single blocks, as many as fit on the card at once,
//     pulls chunks from a global counter, so a hot region gets as many
//     blocks as its pairs need. A block merges its chunk in shared memory,
//     one key per pixel of the region: (hi << 32) | gid with hi =
//     float_bits(z), or ~float_bits(z) under reverse-z (B1, B3a), or the
//     32-bit float_bits(z) (B2). Covered z is in [+0, 1.01], so the bits
//     order like the floats and their complement like -z; the low word
//     breaks ties to the lowest id; the untouched key ~0 is the background,
//     which no covered key equals. The min is order-free, so no result
//     depends on the chunking. The block's keys go to a key image (B2: its
//     output z, whose bits are the keys): a region of one chunk stores its
//     pixels, a split region's chunks each take one global atomicMin per
//     touched pixel (32-bit for B2, 64-bit for B1 and B3a) into pixels the
//     scatter set to the background. Owner threads (P3's faster merge)
//     and merging a region's chunks through distributed shared memory in a
//     cluster were both built and measured: neither gained on any input,
//     since chunks sized by cost leave a warp's rects spread over their box
//     and make the DSMEM merge a cost (PERF.md, section 6).
//   * Latency. A chunk's triangle rows (64 B: planes and bbox) are staged in
//     shared memory with cp.async, double-buffered: the next 256 rows are
//     in flight while the block evaluates the current ones, and every
//     thread finds its planes there, with no bbox -> planes chain of
//     dependent global loads. Two barriers a batch of 256 rows.
//   * The merge. A rect above kSmallPx pixels goes to a warp, which cuts it
//     into kCell x kCell blocks (from the rect's top-left), drops a block
//     where no pixel centre could pass the exact test (below) and evaluates
//     the live blocks' pixels two per lane. Each warp takes the small rects
//     of its 32 rows together: each lane walks its own rect where the sizes
//     are even, or the warp deals their pixels out evenly over its lanes;
//     every covered pair takes a shared atomicMin (a compare-and-swap loop
//     for 64 bits).
//   * B1's and B3a's outputs: `finish_kernel`, pixel-parallel over the key
//     image. For B1 a warp writes 32 pixels together: it loads its
//     winners' 27 plane coefficients as coalesced 108-byte rows, one a run
//     of equal winners in consecutive pixels, into shared memory, every lane
//     a share of the rows' floats (`gather_rows`), and each lane evaluates
//     its own pixel's row there, instead of 27 scalar loads a lane from 32
//     scattered rows.
// The scratch (`vrt_raster_scratch` gives its bytes) holds the bins and the
// count pass's lists (4 bytes an entry each, at most n_items * T *
// (tile / region)^2 entries), the per-region arrays and, for B1 and B3a,
// the key image (8 bytes a pixel). What the design leaves for later:
// item-level early-z and near-to-far skipping, a spatial order of a
// region's entries, TMA for the staging (cp.async takes 4 copies a row),
// the count pass's bbox reads (16 B of each 64-B row), and the binning's
// fixed cost of four launches and a pass over every triangle, which makes
// light inputs (B3a, a band) slower than the design before this.
// The TPU kernel's one-hot MXU compaction, bf16 splits and per-cell round
// counts are TPU layout and have no counterpart here.
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

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kVisStride = 16;   // e0(a,b,c) e1 e2 z(a,b,c) bbox(x0,y0,x1,y1)
constexpr int kCoefStride = 27;  // [inv_w, attr0..7] x (a, b, c)
constexpr int kAttrs = 8;
constexpr float kFar = 3.0e38f;
constexpr int kCell = 8;                 // side of a block-test block
constexpr int kSmallPx = kCell * kCell;  // one thread walks rects this small
constexpr int kBatch = 4;                // loads a thread keeps in flight
constexpr float kMarginScale = 9.5367431640625e-7f;  // 2^-20 = 16 u
constexpr float kMarginFloor = 1e-30f;
constexpr size_t kMaxSmem = 232448;      // per block on the H100
constexpr size_t kStaticSmem = 4096;     // the raster kernel's static part
// B3b's instance bitmap: bench.py's envelope has 4096 terrain slots, plus
// the scene's block slots
constexpr int kMaxInst = 8192;
// binning: a region's count of entries and its cost share one 64-bit
// word, (entries << kCostBits) | cost, so that one atomic reserves both
constexpr int kCostBits = 38;
constexpr unsigned long long kCostMask = (1ull << kCostBits) - 1;
constexpr int kScanBlock = 1024;
// evaluated (triangle, pixel) pairs a chunk of the raster launch aims at
constexpr unsigned long long kChunk = 16384;
constexpr int kMaxSub = 16;        // regions of a supertile, (tile / region)^2
constexpr int kMaxRegions = 16384;
constexpr int kMaxSide = 256;
// the scratch's header: the raster's chunk counter, the chunks, the split
// regions, the count pass's large rects
enum { kNextChunk, kNChunks, kNMulti, kNBig, kHeader = 4 };

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

// Programmatic dependent launch (sm_90), at the start of each kernel of a
// raster call: wait until the stream's previous kernel has ended and its
// writes are visible (a no-op for a kernel launched without the
// attribute, `launch_after`), then let the next kernel's blocks be
// scheduled, so that they wait on the card and not behind this kernel's
// launch and tail.
__device__ __forceinline__ void griddep() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Inclusive prefix sum over the block (kThreads threads); afterwards
// warp_sums[kThreads / 32 - 1] holds the block's total.
template <typename T, int kThreads>
__device__ __forceinline__ T block_inclusive_scan(T v, T* warp_sums) {
  constexpr int kW = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T s = lane < kW ? warp_sums[lane] : T(0);
#pragma unroll
    for (int o = 1; o < kW; o <<= 1) {
      const T n = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += n;
    }
    if (lane < kW) warp_sums[lane] = s;
  }
  __syncthreads();
  return v + (warp > 0 ? warp_sums[warp - 1] : T(0));
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

// A pixel square, clipped to the frame (x1, y1 inclusive).
struct Region {
  int x0, y0, x1, y1, side;
};

// The frame's supertiles and regions: `k` x `k` regions of side `side` a
// supertile of side `tile`, `regions_x` a row.
struct Grid {
  int tiles_x, n_st, tile, side, k, regions_x, n_regions, width, height;
  Div tiles_d, k_d, side_d, regions_d;  // division by tiles_x, k, side and
                                        // regions_x
};

// Region s (row-major) of supertile st: false where it lies outside the
// frame; *ri is its index in the frame's row-major region grid.
__device__ __forceinline__ bool sub_region(const Grid& g, int st, int s,
                                           Region* r, int* ri) {
  const int sty = div_by(st, g.tiles_d), sy = div_by(s, g.k_d);
  const int rx0 = (st - sty * g.tiles_x) * g.tile + (s - sy * g.k) * g.side;
  const int ry0 = sty * g.tile + sy * g.side;
  if (rx0 >= g.width || ry0 >= g.height) return false;
  r->x0 = rx0;
  r->y0 = ry0;
  r->x1 = min(rx0 + g.side, g.width) - 1;
  r->y1 = min(ry0 + g.side, g.height) - 1;
  r->side = g.side;
  *ri = div_by(ry0, g.side_d) * g.regions_x + div_by(rx0, g.side_d);
  return true;
}

// Region ri of the frame.
__device__ __forceinline__ Region region_of(const Grid& g, int ri) {
  Region r;
  const int ry = div_by(ri, g.regions_d);
  r.x0 = (ri - ry * g.regions_x) * g.side;
  r.y0 = ry * g.side;
  r.x1 = min(r.x0 + g.side, g.width) - 1;
  r.y1 = min(r.y0 + g.side, g.height) - 1;
  r.side = g.side;
  return r;
}

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

// The 12 plane floats of a row (global or shared, 16-byte aligned).
__device__ __forceinline__ void load_planes(const float* p, float* c) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 q = reinterpret_cast<const float4*>(p)[i];
    c[4 * i] = q.x;
    c[4 * i + 1] = q.y;
    c[4 * i + 2] = q.z;
    c[4 * i + 3] = q.w;
  }
}

// The exact per-pixel test at (x, y): true and the pair's key where planes
// c cover the pixel.
template <int kOut>
__device__ __forceinline__ bool cover_key(const float* c, int x, int y,
                                          unsigned int gid, int reverse_z,
                                          float wire_px,
                                          typename KeyOf<kOut>::T* key) {
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
  if (!cover) return false;
  const unsigned int zbits = __float_as_uint(__fadd_rn(zq, 0.0f));
  if constexpr (kOut == kDepth) {
    *key = zbits;
  } else {
    const unsigned int hi = reverse_z ? ~zbits : zbits;
    *key = ((unsigned long long)hi << 32) | gid;
  }
  return true;
}

// A covered pixel min-merges its key into the region's shared keys.
template <int kOut>
__device__ __forceinline__ void raster_pixel(
    const float* c, int x, int y, unsigned int gid, const Region& r,
    int reverse_z, float wire_px, typename KeyOf<kOut>::T* s_key) {
  typename KeyOf<kOut>::T key;
  if (cover_key<kOut>(c, x, y, gid, reverse_z, wire_px, &key)) {
    atomicMin(&s_key[(y - r.y0) * r.side + (x - r.x0)], key);
  }
}

// The margin m of the header's bound for plane c over a block whose far
// corner centre is (pxb, pyb).
__device__ __forceinline__ float plane_margin(const float* c, float pxb,
                                              float pyb) {
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(fabsf(c[0]), pxb),
                                      __fmul_rn(fabsf(c[1]), pyb)),
                            fabsf(c[2]));
  return __fadd_rn(__fmul_rn(s, kMarginScale), kMarginFloor);
}

// False only when no pixel centre of block [x0, x1] x [y0, y1] can pass
// cover_key's coverage test. The rounded plane is monotone along x (in the
// direction of a's sign) and along y (b's), so its largest value over the
// four corner centres is the one at the corner those signs pick, and its
// smallest the one at the opposite corner: one evaluation an edge, two for
// z, the same values the four-corner form takes its extremes of. NaN
// planes never reach here.
__device__ __forceinline__ bool block_live(const float* c, int x0, int y0,
                                           int x1, int y1) {
  const float pxa = (float)x0 + 0.5f, pxb = (float)x1 + 0.5f;
  const float pya = (float)y0 + 0.5f, pyb = (float)y1 + 0.5f;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float* q = c + 3 * e;
    const float hi = plane(q[0], q[1], q[2], q[0] >= 0.0f ? pxb : pxa,
                           q[1] >= 0.0f ? pyb : pya);
    if (hi < -plane_margin(q, pxb, pyb)) return false;
  }
  const float* q = c + 9;
  const float m = plane_margin(q, pxb, pyb);
  const bool ax = q[0] >= 0.0f, by = q[1] >= 0.0f;
  const float hi = plane(q[0], q[1], q[2], ax ? pxb : pxa, by ? pyb : pya);
  const float lo = plane(q[0], q[1], q[2], ax ? pxa : pxb, by ? pya : pyb);
  return !(hi < -m || lo > __fadd_rn(1.01f, m));
}

__device__ __forceinline__ bool any_nan(const float* c) {
  bool nan = false;
#pragma unroll
  for (int i = 0; i < 12; ++i) nan = nan || isnan(c[i]);
  return nan;
}

// One warp: the pixels of rect (x0, y0, w, h) that lie in the kCell x
// kCell blocks (cut from its top-left) the block test keeps for planes c;
// the same count in every lane. A NaN plane float keeps no block.
__device__ __forceinline__ int live_block_pixels(const float* c, int x0,
                                                 int y0, int w, int h) {
  if (any_nan(c)) return 0;
  const int lane = threadIdx.x & 31;
  const int nbx = (w + kCell - 1) / kCell;
  const int nb = nbx * ((h + kCell - 1) / kCell);
  int sum = 0;
  for (int b0 = 0; b0 < nb; b0 += 32) {
    int px = 0;
    if (b0 + lane < nb) {
      const int bx = x0 + (b0 + lane) % nbx * kCell;
      const int by = y0 + (b0 + lane) / nbx * kCell;
      const int bx1 = min(bx + kCell, x0 + w) - 1;
      const int by1 = min(by + kCell, y0 + h) - 1;
      if (block_live(c, bx, by, bx1, by1)) {
        px = (bx1 - bx + 1) * (by1 - by + 1);
      }
    }
    sum += __reduce_add_sync(0xffffffffu, px);
  }
  return sum;
}

// One warp: triangle gid (planes and bbox in `row`), whose bbox within the
// region is larger than kSmallPx, by blocks of kCell x kCell.
template <int kOut>
__device__ void raster_big(const float* row, unsigned int gid,
                           const Region& r, int reverse_z, float wire_px,
                           typename KeyOf<kOut>::T* s_key) {
  float c[12];
  load_planes(row, c);
  int x0, y0, w, h;
  if (any_nan(c) ||
      !clip_rect(reinterpret_cast<const float4*>(row)[3], r, &x0, &y0, &w,
                 &h)) {
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

// The scratch buffer of one call, laid out by `bins_layout`.
struct Bins {
  int* header;                 // kHeader ints
  unsigned long long* total;   // per region: (entries << 38) | cost
  unsigned long long* fill;    // per region: the scatter's reservations
  int* region_start;           // n_regions + 1: first entry of each region
  int* chunk_start;            // n_regions + 1: first chunk of each region
  unsigned long long* target;  // per region: the cost of one of its chunks
  int* multi;                  // regions of more than one chunk
  int* chunk_region;           // max_chunks: each chunk's region
  int* first;                  // max_chunks: each chunk's first entry
  unsigned int* entries;       // global ids, region-major
  unsigned int* raw;           // the count pass's entries, per block
  int* raw_count;              // per count block and region of its supertile
  unsigned long long* keys;    // B1, B3a: the merged key of every pixel
};

struct Layout {
  size_t header, total, fill, zeroed, region_start, chunk_start, target,
      multi, chunk_region, first, entries, raw, raw_count, keys, bytes;
  int max_chunks;
};

size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

// Triangles a count block takes: kPer a thread.
constexpr int kPer = 4;
constexpr int kTris = kBlock * kPer;

// The scratch's layout: the part up to `zeroed` is cleared before the
// count pass. B2 (key_bytes 4) merges into its output and has no keys.
Layout bins_layout(const Grid& g, int n_items, int tris_per_inst,
                   int key_bytes) {
  Layout L;
  const size_t R = (size_t)g.n_regions;
  const int kk = g.k * g.k;
  const size_t blocks = (size_t)n_items *
                        ((tris_per_inst + kTris - 1) / kTris);
  L.max_chunks = 3 * g.n_regions + 1024;
  size_t at = 0;
  L.header = at;
  at += kHeader * sizeof(int);
  L.total = at = align256(at);
  at += R * 8;
  L.fill = at;
  at += R * 8;
  L.zeroed = at = align256(at);
  L.region_start = at;
  at += (R + 1) * 4;
  L.chunk_start = at = align256(at);
  at += (R + 1) * 4;
  L.target = at = align256(at);
  at += R * 8;
  L.multi = at = align256(at);
  at += R * 4;
  L.chunk_region = at = align256(at);
  at += (size_t)L.max_chunks * 4;
  L.first = at = align256(at);
  at += (size_t)L.max_chunks * 4;
  // at most kk entries a triangle
  L.entries = at = align256(at);
  at += blocks * kTris * kk * 4;
  L.raw = at = align256(at);
  at += blocks * kTris * kk * 4;
  L.raw_count = at = align256(at);
  at += blocks * kk * 4;
  L.keys = at = align256(at);
  if (key_bytes == 8) at += (size_t)g.width * g.height * 8;
  L.bytes = align256(at);
  return L;
}

Bins bins_at(void* scratch, const Layout& L) {
  unsigned char* p = static_cast<unsigned char*>(scratch);
  Bins b;
  b.header = reinterpret_cast<int*>(p + L.header);
  b.total = reinterpret_cast<unsigned long long*>(p + L.total);
  b.fill = reinterpret_cast<unsigned long long*>(p + L.fill);
  b.region_start = reinterpret_cast<int*>(p + L.region_start);
  b.chunk_start = reinterpret_cast<int*>(p + L.chunk_start);
  b.target = reinterpret_cast<unsigned long long*>(p + L.target);
  b.multi = reinterpret_cast<int*>(p + L.multi);
  b.chunk_region = reinterpret_cast<int*>(p + L.chunk_region);
  b.first = reinterpret_cast<int*>(p + L.first);
  b.entries = reinterpret_cast<unsigned int*>(p + L.entries);
  b.raw = reinterpret_cast<unsigned int*>(p + L.raw);
  b.raw_count = reinterpret_cast<int*>(p + L.raw_count);
  b.keys = reinterpret_cast<unsigned long long*>(p + L.keys);
  return b;
}

// A warp's 64-bit sum over its lanes, in every lane.
__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The count pass over one block of kTris triangles of work item
// blockIdx.x / tchunks, kPer a thread with their bbox loads in flight
// together: triangle t of the item's instance is an entry of each region
// of the item's supertile that its bbox meets, with the cost of the header
// (a warp tests a large rect's blocks 32 at once). The block lists its
// entries of each region as (t - t0) << 17 | cost in its segment of
// b.raw, their count in b.raw_count, and adds (entries << kCostBits) |
// cost to the region's total with one global atomic.
__global__ void __launch_bounds__(kBlock, 4)
bins_count(const float* __restrict__ vis, const int* __restrict__ items,
           int tris_per_inst, int tchunks, Grid g, Bins b) {
  __shared__ unsigned long long s_acc[kMaxSub];
  __shared__ int s_n[kMaxSub];
  __shared__ Region s_reg[kMaxSub];
  __shared__ int s_ri[kMaxSub];
  griddep();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int j = blockIdx.x / tchunks;
  const int t0 = blockIdx.x % tchunks * kTris;
  const int inst = items[2 * j];
  const int st = items[2 * j + 1];
  if (inst < 0 || st < 0 || st >= g.n_st) return;  // the whole block
  const int kk = g.k * g.k;
  if (tid < kk) {
    s_acc[tid] = 0;
    s_n[tid] = 0;
    // the supertile's regions, once a block; -1 outside the frame
    int ri;
    s_ri[tid] = sub_region(g, st, tid, &s_reg[tid], &ri) ? ri : -1;
  }
  const unsigned int gid0 =
      (unsigned int)inst * (unsigned int)tris_per_inst + (unsigned int)t0;
  float4 bb[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    bb[q] = make_float4(kFar, kFar, -kFar, -kFar);
    if (t0 + q * kBlock + tid < tris_per_inst) {
      bb[q] = __ldg(reinterpret_cast<const float4*>(
                        vis + (size_t)(gid0 + q * kBlock + tid) *
                                  kVisStride) + 3);
    }
  }
  __syncthreads();
  // the item's supertile, clipped to the frame
  Region tile_r;
  tile_r.x0 = st % g.tiles_x * g.tile;
  tile_r.y0 = st / g.tiles_x * g.tile;
  tile_r.x1 = min(tile_r.x0 + g.tile, g.width) - 1;
  tile_r.y1 = min(tile_r.y0 + g.tile, g.height) - 1;
  tile_r.side = g.tile;
  unsigned int meet = 0;  // bit q: triangle q of this thread meets it
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    int x0, y0, w, h;
    if (clip_rect(bb[q], tile_r, &x0, &y0, &w, &h)) meet |= 1u << q;
  }
  unsigned int* raw = b.raw + (size_t)blockIdx.x * kTris * kk;
  const unsigned int lt = (1u << lane) - 1;
  for (int s = 0; __any_sync(0xffffffffu, meet) && s < kk; ++s) {
    if (s_ri[s] < 0) continue;  // the whole block
    int cost[kPer];
    unsigned int hits[kPer], big[kPer];
    int n_hits = 0, n_big = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      int x0, y0, w, h;
      const bool hit = (meet >> q & 1u) &&
                       clip_rect(bb[q], s_reg[s], &x0, &y0, &w, &h);
      // a large rect's cost waits for bins_big
      cost[q] = hit && w * h <= kSmallPx ? w * h : 0;
      hits[q] = __ballot_sync(0xffffffffu, hit);
      big[q] = __ballot_sync(0xffffffffu, hit && w * h > kSmallPx);
      n_hits += __popc(hits[q]);
      n_big += __popc(big[q]);
    }
    if (n_hits == 0) continue;  // the whole warp
    int at = 0, at_big = 0;
    if (lane == 0) {
      at = atomicAdd(&s_n[s], n_hits);
      if (n_big) at_big = atomicAdd(&b.header[kNBig], n_big);
    }
    at = __shfl_sync(0xffffffffu, at, 0);
    at_big = __shfl_sync(0xffffffffu, at_big, 0);
    unsigned long long sum = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (hits[q] >> lane & 1u) {
        const unsigned int pos = s * kTris + at + __popc(hits[q] & lt);
        raw[pos] = ((unsigned int)(q * kBlock + tid) << 17) |
                   (unsigned int)cost[q];
        sum += (1ull << kCostBits) | (unsigned long long)cost[q];
        if (big[q] >> lane & 1u) {
          b.entries[at_big + __popc(big[q] & lt)] =
              (unsigned int)(raw - b.raw) + pos;
        }
      }
      at += __popc(hits[q]);
      at_big += __popc(big[q]);
    }
    sum = warp_sum(sum);
    if (lane == 0) atomicAdd(&s_acc[s], sum);
  }
  __syncthreads();
  if (tid < kk) {
    b.raw_count[(size_t)blockIdx.x * kk + tid] = s_n[tid];
    if (s_acc[tid] != 0) atomicAdd(&b.total[s_ri[tid]], s_acc[tid]);
  }
}

// The costs of the count pass's large rects (queued in b.entries, which
// the scatter fills later, as their positions in b.raw): a persistent
// grid of warps, each taking 32 rects at a time, one a lane, whose rows
// its lanes load together; the warp then tests each rect's blocks 32 at
// once. The cost goes into the rect's raw entry and its region's total.
__global__ void __launch_bounds__(kBlock)
bins_big(const float* __restrict__ vis, const int* __restrict__ items,
         int tris_per_inst, int tchunks, Grid g, Bins b) {
  griddep();
  const int lane = threadIdx.x & 31;
  const int kk = g.k * g.k;
  const int n = b.header[kNBig];
  for (int base = (blockIdx.x * kBlock + threadIdx.x) & ~31; base < n;
       base += gridDim.x * kBlock) {
    const int qi = base + lane;
    const bool valid = qi < n;
    unsigned int pos = 0, v = 0;
    int ri = 0, x0 = 0, y0 = 0, w = 0, h = 0;
    float c[12];
    if (valid) {
      pos = b.entries[qi];
      const int blk = (int)(pos / (unsigned int)(kTris * kk));
      const int s = (int)(pos / kTris) % kk;
      const int j = blk / tchunks;
      v = b.raw[pos];
      const unsigned int gid =
          (unsigned int)items[2 * j] * (unsigned int)tris_per_inst +
          (unsigned int)(blk % tchunks * kTris) + (v >> 17);
      Region r;
      sub_region(g, items[2 * j + 1], s, &r, &ri);
      const float* row = vis + (size_t)gid * kVisStride;
      load_planes(row, c);
      clip_rect(__ldg(reinterpret_cast<const float4*>(row) + 3), r, &x0,
                &y0, &w, &h);
    }
    int mine = 0;
    unsigned int todo = __ballot_sync(0xffffffffu, valid);
    while (todo) {
      const int l = __ffs(todo) - 1;
      todo &= todo - 1;
      float cl[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) cl[i] = __shfl_sync(0xffffffffu, c[i], l);
      const int px = live_block_pixels(
          cl, __shfl_sync(0xffffffffu, x0, l), __shfl_sync(0xffffffffu, y0, l),
          __shfl_sync(0xffffffffu, w, l), __shfl_sync(0xffffffffu, h, l));
      if (lane == l) mine = px;
    }
    if (valid) b.raw[pos] = v | (unsigned int)mine;
    // one atomic a region among the warp's rects: the lanes of a region
    // sum their costs, its lowest lane adds them
    const unsigned int same = __match_any_sync(0xffffffffu, valid ? ri : -1);
    const unsigned int px = __reduce_add_sync(same, (unsigned int)mine);
    if (valid && px && lane == __ffs(same) - 1) {
      atomicAdd(&b.total[ri], (unsigned long long)px);
    }
  }
}

// The scatter, one block for each count block: the block reserves its
// entries of a region with one 64-bit atomic on the region's (count,
// cost), so an entry's slot and its cost prefix agree, writes their
// global ids and marks the entry whose cost span holds a multiple of the
// region's chunk cost as the first of that chunk (chunk 0 starts at the
// region's first entry). First, all blocks together set the merged keys
// of the split regions to the background: ~0 in B1's and B3a's key image,
// F32_FAR in B2's output (`keys`, `key_bytes` each).
__global__ void __launch_bounds__(kBlock)
bins_scatter(const int* __restrict__ items, int tris_per_inst, int tchunks,
             int n_blocks, Grid g, Bins b, void* keys, int key_bytes) {
  __shared__ unsigned long long s_warp[kWarps];
  __shared__ unsigned long long s_base;
  griddep();
  const int tid = threadIdx.x;
  const long long n_key = (long long)g.side * g.side;
  const long long n = keys ? (long long)b.header[kNMulti] * n_key : 0;
  for (long long i = (long long)blockIdx.x * kBlock + tid; i < n;
       i += (long long)gridDim.x * kBlock) {
    const Region r = region_of(g, b.multi[i / n_key]);
    const int li = (int)(i % n_key);
    const int ly = div_by(li, g.side_d);
    const int x = r.x0 + li - ly * g.side;
    const int y = r.y0 + ly;
    if (x > r.x1 || y > r.y1) continue;
    const size_t p = (size_t)y * g.width + x;
    if (key_bytes == 8) {
      static_cast<unsigned long long*>(keys)[p] = ~0ull;
    } else {
      static_cast<unsigned int*>(keys)[p] = __float_as_uint(kFar);
    }
  }
  if ((int)blockIdx.x >= n_blocks) return;
  const int j = blockIdx.x / tchunks;
  const int inst = items[2 * j];
  const int st = items[2 * j + 1];
  if (inst < 0 || st < 0 || st >= g.n_st) return;  // the whole block
  const int kk = g.k * g.k;
  const unsigned int gid0 = (unsigned int)inst * (unsigned int)tris_per_inst +
                            (unsigned int)(blockIdx.x % tchunks * kTris);
  const unsigned int* raw = b.raw + (size_t)blockIdx.x * kTris * kk;
  for (int s = 0; s < kk; ++s) {
    const int cnt = b.raw_count[(size_t)blockIdx.x * kk + s];
    if (cnt == 0) continue;  // the whole block (0 outside the frame)
    Region r;
    int ri;
    sub_region(g, st, s, &r, &ri);
    // thread tid takes entries kPer * tid .. kPer * tid + kPer - 1
    unsigned int v[kPer];
    unsigned long long mine = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = kPer * tid + u;
      v[u] = e < cnt ? raw[s * kTris + e] : 0u;
      if (e < cnt) mine += (1ull << kCostBits) | (v[u] & 0x1ffffu);
    }
    const unsigned long long incl =
        block_inclusive_scan<unsigned long long, kBlock>(mine, s_warp);
    if (tid == kBlock - 1) s_base = atomicAdd(&b.fill[ri], incl);
    __syncthreads();
    unsigned long long at = s_base + incl - mine;
    const int start = b.region_start[ri];
    const unsigned long long tg = b.target[ri];
    const int c0 = b.chunk_start[ri];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (kPer * tid + u >= cnt) break;
      const unsigned long long cost = v[u] & 0x1ffffu;
      const int slot = start + (int)(at >> kCostBits);
      b.entries[slot] = gid0 + (v[u] >> 17);
      // chunk c >= 1 starts at the entry whose cost span [p, p + cost)
      // holds c * target
      const unsigned long long p = at & kCostMask;
      unsigned long long c = (p + tg - 1) / tg;
      for (c = c > 0 ? c : 1; c * tg < p + cost; ++c) {
        b.first[c0 + (int)c] = slot;
      }
      at += (1ull << kCostBits) | cost;
    }
  }
}

// One block: each region's first entry and its chunks of about equal
// cost, ceil(cost / kChunk) and at least one (the chunk grows where the
// chunks would pass max_chunks); each chunk's region and first entry (a
// region's first chunk starts at its first entry, the others at its end
// until the scatter marks them) and the list of split regions. Dynamic
// shared memory: n_regions + 1 ints.
__global__ void __launch_bounds__(kScanBlock)
bins_scan(Bins b, int n_regions, int max_chunks) {
  extern __shared__ int s_gstart[];
  __shared__ unsigned long long s_sum[32];
  __shared__ int s_ent[32];
  __shared__ int s_grp[32];
  griddep();
  const int tid = threadIdx.x;
  unsigned long long c = 0;
  for (int r = tid; r < n_regions; r += kScanBlock) {
    c += b.total[r] & kCostMask;
  }
  block_inclusive_scan<unsigned long long, kScanBlock>(c, s_sum);
  const unsigned long long all = s_sum[31];
  const unsigned long long extra = (unsigned long long)(max_chunks -
                                                        n_regions);
  unsigned long long per_chunk = kChunk;
  if ((all + extra - 1) / extra > per_chunk) {
    per_chunk = (all + extra - 1) / extra;
  }
  int carry_e = 0, carry_g = 0;
  for (int base = 0; base < n_regions; base += kScanBlock) {
    const int r = base + tid;
    int n_r = 0, g_r = 0;
    unsigned long long c_r = 0;
    if (r < n_regions) {
      const unsigned long long tot = b.total[r];
      n_r = (int)(tot >> kCostBits);
      c_r = tot & kCostMask;
      g_r = c_r ? (int)((c_r + per_chunk - 1) / per_chunk) : 1;
    }
    const int ie = block_inclusive_scan<int, kScanBlock>(n_r, s_ent);
    const int ig = block_inclusive_scan<int, kScanBlock>(g_r, s_grp);
    if (r < n_regions) {
      b.region_start[r] = carry_e + ie - n_r;
      const int gs = carry_g + ig - g_r;
      b.chunk_start[r] = gs;
      s_gstart[r] = gs;
      b.target[r] = c_r ? (c_r + g_r - 1) / g_r : 1;
      if (g_r > 1) b.multi[atomicAdd(&b.header[kNMulti], 1)] = r;
    }
    carry_e += s_ent[31];
    carry_g += s_grp[31];
    __syncthreads();  // the totals are read before the next scans
  }
  if (tid == 0) {
    b.region_start[n_regions] = carry_e;
    b.chunk_start[n_regions] = carry_g;
    s_gstart[n_regions] = carry_g;
    b.header[kNChunks] = carry_g;
  }
  __syncthreads();
  for (int gi = tid; gi < carry_g; gi += kScanBlock) {
    int lo = 0, hi = n_regions - 1;  // the last region starting at <= gi
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_gstart[mid] <= gi) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    b.chunk_region[gi] = lo;
    b.first[gi] = gi == s_gstart[lo] ? b.region_start[lo]
                                     : b.region_start[lo + 1];
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

// The warp's winners' coefficient rows (gid per lane, -1 for none) into
// `rows` (up to 32 x 27 floats), one row a run of equal winners in
// consecutive lanes, whose gid goes to `run_gid` (32 ints): every lane
// loads the elements lane, lane + 32, ... of the runs' rows, independent
// of each other and coalesced along each 108-byte row. Returns the row of
// the lane's winner.
__device__ __forceinline__ int gather_rows(const float* __restrict__ coef,
                                           int gid, float* rows,
                                           int* run_gid) {
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(0xffffffffu, gid, 1);
  const bool start = gid >= 0 && (lane == 0 || gid != prev);
  const unsigned int runs = __ballot_sync(0xffffffffu, start);
  const int slot = __popc(runs & ((2u << lane) - 1u)) - 1;
  if (start) run_gid[slot] = gid;
  __syncwarp();
  const int n = __popc(runs) * kCoefStride;
#pragma unroll 4
  for (int e = lane; e < n; e += 32) {
    const int q = e / kCoefStride;
    rows[e] = __ldg(coef + (size_t)run_gid[q] * kCoefStride +
                    (e - q * kCoefStride));
  }
  __syncwarp();
  return slot;
}

// B1's output gather alone, to time it against a library gather: row i of
// out (n x 27) is coef's row ids[i], zeros where ids[i] < 0; each warp
// gathers 32 rows with gather_rows and writes them out contiguously.
__global__ void __launch_bounds__(kBlock)
gather_kernel(const float* __restrict__ coef, const int* __restrict__ ids,
              int n, float* __restrict__ out) {
  __shared__ float s_rows[kWarps * 32 * kCoefStride];
  __shared__ int s_run[kWarps][32];
  __shared__ int s_slot[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* rows = s_rows + warp * 32 * kCoefStride;
  for (int i0 = blockIdx.x * kBlock; i0 < n; i0 += gridDim.x * kBlock) {
    const int i = i0 + threadIdx.x;
    const int gid = i < n ? ids[i] : -1;
    const int slot = gather_rows(coef, gid, rows, s_run[warp]);
    s_slot[warp][lane] = gid >= 0 ? slot : -1;
    __syncwarp();
    const int w0 = i0 + warp * 32;
    for (int k = lane; k < 32 * kCoefStride; k += 32) {
      const int row = k / kCoefStride;
      if (w0 + row < n) {
        const int q = s_slot[warp][row];
        out[(size_t)w0 * kCoefStride + k] =
            q >= 0 ? rows[q * kCoefStride + k - row * kCoefStride] : 0.0f;
      }
    }
    __syncwarp();  // the rows are written before the next gather
  }
}

// The outputs of pixel (x, y), flat index p, from its merged key (`in`
// where it is a pixel of the frame). All 32 lanes of a warp call it
// together: B1 gathers the warp's winners' coefficient rows into `gather`
// (32 x 27 floats; gather_rows, run gids in `run_gid`), and each lane
// evaluates its own winner's row there.
template <int kOut>
__device__ void out_pixel(unsigned long long key, bool in, int x, int y,
                          size_t p, int reverse_z,
                          const float* __restrict__ coef, float* gather,
                          int* run_gid, float* __restrict__ z,
                          int* __restrict__ id, float* __restrict__ attrs) {
  const bool bg = key == ~0ull;
  const unsigned int gid = (unsigned int)(key & 0xffffffffull);
  const unsigned int hi = (unsigned int)(key >> 32);
  if (in) {
    z[p] = bg ? (reverse_z ? -kFar : kFar)
              : __uint_as_float(reverse_z ? ~hi : hi);
    id[p] = bg ? -1 : (int)gid;
  }
  if constexpr (kOut == kFull) {
    const int w = in && !bg ? (int)gid : -1;
    const int slot = gather_rows(coef, w, gather, run_gid);
    if (in) {
      float out[kAttrs];
      if (w >= 0) {
        winner_attrs(gather + slot * kCoefStride, x, y, out);
      } else {
#pragma unroll
        for (int a = 0; a < kAttrs; ++a) out[a] = 0.0f;
      }
      float4* dst = reinterpret_cast<float4*>(attrs + p * kAttrs);
      dst[0] = make_float4(out[0], out[1], out[2], out[3]);
      dst[1] = make_float4(out[4], out[5], out[6], out[7]);
    }
    __syncwarp();  // the rows are read before the next pixels' gather
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The shared-memory state of a raster block besides the keys: two buffers
// of kBlock staged rows and their global ids, and per batch parity the
// length of its queue of large rects.
struct Stage {
  float4* rows;          // 2 * kBlock * 4
  unsigned int* gids;    // 2 * kBlock
  unsigned int* big;     // kBlock
  int* n_big;            // [2]
};

// Stages the row of global id g (valid) at slot threadIdx.x of buffer buf.
__device__ __forceinline__ void stage_row(const float* __restrict__ vis,
                                          const Stage& sg, int buf,
                                          unsigned int g, bool valid) {
  if (!valid) return;
  const int slot = buf * kBlock + threadIdx.x;
  sg.gids[slot] = g;
  const float4* src =
      reinterpret_cast<const float4*>(vis + (size_t)g * kVisStride);
#pragma unroll
  for (int k = 0; k < 4; ++k) cp_async16(sg.rows + slot * 4 + k, src + k);
}

// One batch of cnt staged rows (buffer buf) into the region's keys. A rect
// above kSmallPx pixels goes to the block's queue, which the warps take
// one rect each (raster_big). Each warp takes the small rects of its 32
// rows together: where no rect is above twice their mean size, each lane
// walks its own, and otherwise their pixels are dealt out evenly over the
// lanes (the last lane whose prefix of rect sizes is at most the pixel's
// index owns it).
template <int kOut>
__device__ void raster_batch(const Stage& sg, int buf, int cnt,
                             const Region& r, int reverse_z, float wire_px,
                             int par, typename KeyOf<kOut>::T* s_key) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wbase = tid & ~31;
  const float4* rows = sg.rows + buf * kBlock * 4;
  const unsigned int* gids = sg.gids + buf * kBlock;
  int x0 = 0, y0 = 0, w = 0, h = 0;
  const bool hit = tid < cnt && clip_rect(rows[tid * 4 + 3], r, &x0, &y0,
                                          &w, &h);
  const bool small = hit && w * h <= kSmallPx;
  if (hit && !small) sg.big[atomicAdd(&sg.n_big[par], 1)] = tid;
  if (__ballot_sync(0xffffffffu, small)) {
    const int sz = small ? w * h : 0;
    const int spx = __reduce_add_sync(0xffffffffu, sz);
    if (__reduce_max_sync(0xffffffffu, sz) * 16 <= spx) {
      // rect sizes within 2x of their mean: each lane walks its own
      if (small) {
        float c[12];
        load_planes(reinterpret_cast<const float*>(rows + tid * 4), c);
        const unsigned int gid = gids[tid];
        for (int y = y0; y < y0 + h; ++y) {
          for (int x = x0; x < x0 + w; ++x) {
            raster_pixel<kOut>(c, x, y, gid, r, reverse_z, wire_px, s_key);
          }
        }
      }
    } else {
      int incl = sz;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int nb = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += nb;
      }
      const int excl = incl - sz;
      // local / w as (local + 0.5) * fl(1 / w), exact for local < 64 and
      // w <= 64: the product lies within 0.5 / w of an integer's far side
      const float inv_w = small ? 1.0f / (float)w : 0.0f;
      for (int p0 = 0; p0 < spx; p0 += 32) {
        const int p = p0 + lane;
        int k = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          if (__shfl_sync(0xffffffffu, excl, k + step) <= p) k += step;
        }
        const int kx0 = __shfl_sync(0xffffffffu, x0, k);
        const int ky0 = __shfl_sync(0xffffffffu, y0, k);
        const int kw = __shfl_sync(0xffffffffu, w, k);
        const float kinv = __shfl_sync(0xffffffffu, inv_w, k);
        const int local = p - __shfl_sync(0xffffffffu, excl, k);
        if (p < spx) {
          const int ly = (int)(((float)local + 0.5f) * kinv);
          float c[12];
          load_planes(reinterpret_cast<const float*>(rows + (wbase + k) * 4),
                      c);
          raster_pixel<kOut>(c, kx0 + local - ly * kw, ky0 + ly,
                             gids[wbase + k], r, reverse_z, wire_px, s_key);
        }
      }
    }
  }
  __syncthreads();
  const int n_big = sg.n_big[par];
  for (int q = tid >> 5; q < n_big; q += kWarps) {
    const int t = sg.big[q];
    raster_big<kOut>(reinterpret_cast<const float*>(rows + t * 4), gids[t],
                     r, reverse_z, wire_px, s_key);
  }
}

// Entries [e0, e1) of the bins into the region's keys, kBlock rows a
// batch, the next batch's rows in flight (cp.async) during each batch.
template <int kOut>
__device__ void raster_chunk(const float* __restrict__ vis,
                             const unsigned int* __restrict__ entries,
                             int e0, int e1, const Region& r, int reverse_z,
                             float wire_px, const Stage& sg,
                             typename KeyOf<kOut>::T* s_key) {
  const int n = e1 - e0;
  const int tid = threadIdx.x;
  const int nb = (n + kBlock - 1) / kBlock;
  if (nb <= 0) return;
  stage_row(vis, sg, 0, tid < n ? entries[e0 + tid] : 0u, tid < n);
  cp_async_commit();
  bool v_next = kBlock + tid < n;
  unsigned int g_next = v_next ? entries[e0 + kBlock + tid] : 0u;
  for (int bi = 0; bi < nb; ++bi) {
    const int buf = bi & 1;
    cp_async_wait_prior0();  // this thread's rows of batch bi are in
    // every thread's rows are in, and every thread is done with batch
    // bi - 1: its buffer takes batch bi + 1, its queue's count (the other
    // parity) is cleared
    __syncthreads();
    if (tid == 0) sg.n_big[buf ^ 1] = 0;
    if (bi + 1 < nb) {
      stage_row(vis, sg, buf ^ 1, g_next, v_next);
      cp_async_commit();
      const int j = (bi + 2) * kBlock + tid;
      v_next = j < n;
      g_next = v_next ? entries[e0 + j] : 0u;
    }
    raster_batch<kOut>(sg, buf, min(kBlock, n - bi * kBlock), r, reverse_z,
                       wire_px, buf, s_key);
  }
  __syncthreads();  // the block's keys are final
}

// B1 (kFull), B3a (kZid) and B2 (kDepth): a persistent grid of blocks,
// each pulling chunks from the scratch's counter (the header's design).
// The chunk's merged keys go to `keys` (B1, B3a: the scratch's key image;
// B2: its output z, key bits = z bits): stored where the region is one
// chunk, min-merged with a global atomic per touched pixel where it is
// split. Dynamic shared memory: the region's side^2 keys (rounded up to 16
// bytes), the two stage buffers and their ids.
template <int kOut>
__global__ void __launch_bounds__(kBlock)
raster_kernel(const float* __restrict__ vis, Bins b, Grid g, int reverse_z,
              float wire_px, typename KeyOf<kOut>::T* __restrict__ keys) {
  using Key = typename KeyOf<kOut>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned int s_big[kBlock];
  __shared__ int s_n_big[2];
  __shared__ int s_chunk;
  const int n_key = g.side * g.side;
  Key* s_key = reinterpret_cast<Key*>(smem);
  Stage sg;
  sg.rows = reinterpret_cast<float4*>(
      smem + ((n_key * sizeof(Key) + 15) & ~size_t(15)));
  sg.gids = reinterpret_cast<unsigned int*>(sg.rows + 2 * kBlock * 4);
  sg.big = s_big;
  sg.n_big = s_n_big;
  griddep();
  const int tid = threadIdx.x;
  const int n_chunks = b.header[kNChunks];
  for (;;) {
    if (tid == 0) s_chunk = atomicAdd(&b.header[kNextChunk], 1);
    for (int i = tid; i < n_key; i += kBlock) s_key[i] = ~Key(0);
    if (tid == 0) s_n_big[0] = s_n_big[1] = 0;
    __syncthreads();
    const int c = s_chunk;
    if (c >= n_chunks) break;  // the whole block
    const int ri = b.chunk_region[c];
    const int e0 = b.first[c];
    const int e1 = c + 1 < b.chunk_start[ri + 1] ? b.first[c + 1]
                                                 : b.region_start[ri + 1];
    const bool single = b.chunk_start[ri + 1] - b.chunk_start[ri] == 1;
    const Region r = region_of(g, ri);
    raster_chunk<kOut>(vis, b.entries, e0, e1, r, reverse_z, wire_px, sg,
                       s_key);  // the block's keys are final on return
    for (int i = tid; i < n_key; i += kBlock) {
      const int ly = div_by(i, g.side_d);
      const int x = r.x0 + i - ly * r.side;
      const int y = r.y0 + ly;
      if (x > r.x1 || y > r.y1) continue;
      const Key key = s_key[i];
      const size_t p = (size_t)y * g.width + x;
      if (single) {
        if constexpr (kOut == kDepth) {
          keys[p] = key == ~Key(0) ? __float_as_uint(kFar) : key;
        } else {
          keys[p] = key;
        }
      } else if (key != ~Key(0)) {
        atomicMin(keys + p, key);
      }
    }
    __syncthreads();  // the keys are read before the next chunk clears them
  }
}

// B1's and B3a's outputs from the merged key image, pixel-parallel (each
// warp 32 consecutive pixels of a row-major frame of n_px pixels).
template <int kOut>
__global__ void __launch_bounds__(kBlock)
finish_kernel(const unsigned long long* __restrict__ keys,
              const float* __restrict__ coef, int width, Div width_d,
              int n_px, int reverse_z, float* __restrict__ z,
              int* __restrict__ id, float* __restrict__ attrs) {
  __shared__ float s_rows[kOut == kFull ? kWarps * 32 * kCoefStride : 1];
  __shared__ int s_run[kWarps][32];
  griddep();
  const int warp = threadIdx.x >> 5;
  for (int i0 = blockIdx.x * kBlock; i0 < n_px; i0 += gridDim.x * kBlock) {
    const int p = i0 + threadIdx.x;
    const bool in = p < n_px;
    const unsigned long long key = in ? keys[p] : ~0ull;
    const int y = div_by(p, width_d);
    out_pixel<kOut>(key, in, p - y * width, y, (size_t)p, reverse_z,
                    coef,
                    kOut == kFull ? s_rows + warp * 32 * kCoefStride : s_rows,
                    s_run[warp], z, id, attrs);
  }
}

// The frame's grid of supertiles and regions; false where the kernels
// cannot take it.
bool make_grid(int n_items, int tris_per_inst, int tiles_x, int tile,
               int side, int width, int height, Grid* g) {
  if (side <= 0 || side > kMaxSide || tile <= 0 || tile % side != 0 ||
      width <= 0 || height <= 0 || tris_per_inst <= 0 || n_items < 0 ||
      tiles_x != (width + tile - 1) / tile) {
    return false;
  }
  g->tiles_x = tiles_x;
  g->n_st = tiles_x * ((height + tile - 1) / tile);
  g->tile = tile;
  g->side = side;
  g->k = tile / side;
  g->regions_x = (width + side - 1) / side;
  g->n_regions = g->regions_x * ((height + side - 1) / side);
  g->width = width;
  g->height = height;
  g->tiles_d = make_div(g->tiles_x);
  g->k_d = make_div(g->k);
  g->side_d = make_div(side);
  g->regions_d = make_div(g->regions_x);
  // a region's entries and cost fit their fields of the 64-bit total
  const long long pairs = (long long)n_items * tris_per_inst;
  return g->k * g->k <= kMaxSub && g->n_regions <= kMaxRegions &&
         pairs < (1ll << (64 - kCostBits)) &&
         pairs * side * side < (1ll << kCostBits);
}

size_t raster_smem(int side, int key_bytes) {
  return (((size_t)side * side * key_bytes + 15) & ~size_t(15)) +
         2 * kBlock * (kVisStride * sizeof(float) + sizeof(unsigned int));
}

// The device's streaming multiprocessors, read once per device.
cudaError_t sm_count(int* n) {
  static std::mutex mu;
  static std::map<int, int> sms;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = sms.find(dev);
  if (it != sms.end()) {
    *n = it->second;
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) sms[dev] = *n;
  return e;
}

// The blocks of a grid-stride launch over n items, kBlock a block, at most
// 8 a multiprocessor.
cudaError_t stride_blocks(long long n, int* blocks) {
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  *blocks = (int)std::min<long long>((n + kBlock - 1) / kBlock, 8ll * sms);
  if (*blocks < 1) *blocks = 1;
  return cudaSuccess;
}

// The raster launches' host setup, made once per device and not on every
// call: each kernel's dynamic shared-memory limit raised to the most a
// block may take, and the blocks that fit on the card at once per (kernel,
// shared memory). Returns that count through `active` (kind < 0: the
// scan, no count).
cudaError_t launch_setup(const void* kernel, int kind, size_t smem,
                         int* active) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, size_t>, int> blocks;
  static std::map<std::pair<int, int>, bool> ready;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && kind >= 0) e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (!ready[{dev, kind}]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(kMaxSmem - kStaticSmem));
    if (e != cudaSuccess) return e;
    ready[{dev, kind}] = true;
  }
  if (kind < 0) return cudaSuccess;
  const auto key = std::make_tuple(dev, kind, smem);
  const auto it = blocks.find(key);
  if (it != blocks.end()) {
    *active = it->second;
    return cudaSuccess;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock,
                                                    smem);
  if (e == cudaSuccess) blocks[key] = *active = per_sm * sms;
  return e;
}

// Launches k after the stream's previous kernel with programmatic
// dependent launch (`pdl`; else as usual, where the previous operation is
// not one of the call's kernels): its blocks may be scheduled once every
// block of that kernel has started, and wait for its end in `griddep`.
template <typename... Params, typename... Args>
cudaError_t launch_after(bool pdl, void (*k)(Params...), int grid,
                         int block, size_t smem, cudaStream_t s,
                         Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, k, args...);
}

// The binning launches of one call: clear the counters, count, scan,
// scatter (which also sets the split regions' keys in `keys`). The count
// follows the clear as usual; each later launch follows its predecessor
// with `launch_after`.
cudaError_t launch_bins(const float* vis, const int* items, int n_items,
                        int tris_per_inst, const Grid& g, const Layout& L,
                        const Bins& b, void* scratch, void* keys,
                        int key_bytes, cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(scratch, 0, L.zeroed, s);
  if (e != cudaSuccess) return e;
  const int tchunks = (tris_per_inst + kTris - 1) / kTris;
  const long long n_blocks = (long long)n_items * tchunks;
  if (n_blocks > INT_MAX) return cudaErrorInvalidValue;
  if (n_blocks > 0) {
    int sms = 0;
    e = sm_count(&sms);
    if (e != cudaSuccess) return e;
    bins_count<<<(int)n_blocks, kBlock, 0, s>>>(vis, items, tris_per_inst,
                                                 tchunks, g, b);
    e = launch_after(true, bins_big, sms * 8, kBlock, 0, s, vis, items,
                     tris_per_inst, tchunks, g, b);
    if (e != cudaSuccess) return e;
  }
  const size_t scan_smem = (size_t)(g.n_regions + 1) * sizeof(int);
  e = launch_setup(reinterpret_cast<const void*>(bins_scan), -1, 0, nullptr);
  if (e != cudaSuccess) return e;
  // after the count kernels, or after the clear where there are none
  e = launch_after(n_blocks > 0, bins_scan, 1, kScanBlock, scan_smem, s, b,
                   g.n_regions, L.max_chunks);
  if (e != cudaSuccess) return e;
  // the split regions' keys are set even without items (there are none)
  e = launch_after(true, bins_scatter, (int)(n_blocks > 0 ? n_blocks : 1),
                   kBlock, 0, s, items, tris_per_inst, tchunks, (int)n_blocks, g, b,
                   keys, key_bytes);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// One call of B1, B3a or B2: the binning launches, the raster launch on a
// persistent grid of as many blocks as fit on the card at once (at most
// max_chunks), and for B1 and B3a the finish launch. `scratch` holds
// vrt_raster_scratch's bytes.
template <int kOut>
int launch_raster(const float* vis, const float* coef, const int* items,
                  int n_items, int tris_per_inst, int tiles_x, int tile,
                  int side, int width, int height, int reverse_z,
                  float wire_px, void* scratch, long long scratch_bytes,
                  float* z, int* id, float* attrs, cudaStream_t s) {
  using Key = typename KeyOf<kOut>::T;
  Grid g;
  if (!make_grid(n_items, tris_per_inst, tiles_x, tile, side, width, height,
                 &g)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = raster_smem(side, sizeof(Key));
  const Layout L = bins_layout(g, n_items, tris_per_inst, sizeof(Key));
  if (smem > kMaxSmem - kStaticSmem || scratch_bytes < (long long)L.bytes ||
      reinterpret_cast<uintptr_t>(vis) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Bins b = bins_at(scratch, L);
  Key* keys = kOut == kDepth ? reinterpret_cast<Key*>(z)
                             : reinterpret_cast<Key*>(b.keys);
  cudaError_t e = launch_bins(vis, items, n_items, tris_per_inst, g, L, b,
                              scratch, keys, sizeof(Key), s);
  if (e != cudaSuccess) return (int)e;
  int active = 0;
  e = launch_setup(reinterpret_cast<const void*>(raster_kernel<kOut>), kOut,
                   smem, &active);
  if (e != cudaSuccess) return (int)e;
  if (active < 1) return (int)cudaErrorInvalidConfiguration;
  e = launch_after(true, raster_kernel<kOut>, min(active, L.max_chunks),
                   kBlock, smem, s, vis, b, g, reverse_z, wire_px, keys);
  if (e != cudaSuccess) return (int)e;
  if constexpr (kOut != kDepth) {
    const int n_px = width * height;
    int blocks = 0;
    e = stride_blocks(n_px, &blocks);
    if (e != cudaSuccess) return (int)e;
    e = launch_after(true, finish_kernel<kOut>, blocks, kBlock, 0, s,
                     static_cast<const unsigned long long*>(b.keys), coef,
                     width, make_div(width), n_px, reverse_z, z, id, attrs);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
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

// The scratch bytes one call of vrt_raster (key_bytes 8), vrt_raster_zid
// (8) or vrt_raster_depth (4) needs, or -1 where the kernels cannot take
// the shapes; with `offsets`, the byte offsets of the header, the regions'
// totals ((entries << 38) | cost), their first entries, their first chunks
// and the entries (5 values), for reading the bins back.
extern "C" long long vrt_raster_scratch(int n_items, int tris_per_inst,
                                        int tiles_x, int tile, int region,
                                        int width, int height, int key_bytes,
                                        long long* offsets) {
  Grid g;
  if (!make_grid(n_items, tris_per_inst, tiles_x, tile, region, width,
                 height, &g) ||
      (key_bytes != 4 && key_bytes != 8)) {
    return -1;
  }
  const Layout L = bins_layout(g, n_items, tris_per_inst, key_bytes);
  if (offsets) {
    offsets[0] = (long long)L.header;
    offsets[1] = (long long)L.total;
    offsets[2] = (long long)L.region_start;
    offsets[3] = (long long)L.chunk_start;
    offsets[4] = (long long)L.entries;
  }
  return (long long)L.bytes;
}

// The binning launches of one call alone, into `scratch` (for reading the
// bins back and timing them; the rasterizers run them themselves).
extern "C" int vrt_raster_bins(const float* vis, const int* items,
                               int n_items, int tris_per_inst, int tiles_x,
                               int tile, int region, int width, int height,
                               int key_bytes, void* scratch,
                               long long scratch_bytes, void* stream) {
  Grid g;
  if (!make_grid(n_items, tris_per_inst, tiles_x, tile, region, width,
                 height, &g) ||
      (key_bytes != 4 && key_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L = bins_layout(g, n_items, tris_per_inst, key_bytes);
  if (scratch_bytes < (long long)L.bytes) return (int)cudaErrorInvalidValue;
  // the split regions' keys go to the scratch's key image (B2's go to its
  // output, which this call does not have)
  const Bins b = bins_at(scratch, L);
  void* keys = key_bytes == 8 ? static_cast<void*>(b.keys) : nullptr;
  return (int)launch_bins(vis, items, n_items, tris_per_inst, g, L, b,
                          scratch, keys, key_bytes,
                          static_cast<cudaStream_t>(stream));
}

// B1's output gather alone (gather_kernel): out (n, 27) float32, row i
// the coefficients of triangle ids[i] of coef (n_rows rows), zeros where
// ids[i] < 0.
extern "C" int vrt_raster_gather(const float* coef, const int* ids, int n,
                                 float* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int blocks = 0;
  const cudaError_t e = stride_blocks(n, &blocks);
  if (e != cudaSuccess) return (int)e;
  gather_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      coef, ids, n, out);
  return (int)cudaGetLastError();
}

// Rasterize (B1): z, id (height, width) and attrs (height, width, 8) are
// outputs. items holds n_items (inst, supertile) int32 pairs in any order,
// inst < 0 marking unused slots. region (dividing tile) is the side of the
// pixel squares the triangles are binned to and a raster block merges.
// reverse_z != 0 keeps the farthest z; wire_px > 0 is the wireframe line
// half-width. scratch holds vrt_raster_scratch(..., 8, ...) bytes. Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue, without a
// launch, for shapes the kernels cannot take).
extern "C" int vrt_raster(const float* vis, const float* coef,
                          const int* items, int n_items, int tris_per_inst,
                          int tiles_x, int tile, int region, int width,
                          int height, int reverse_z, float wire_px,
                          void* scratch, long long scratch_bytes, float* z,
                          int* id, float* attrs, void* stream) {
  return launch_raster<kFull>(vis, coef, items, n_items, tris_per_inst,
                              tiles_x, tile, region, width, height, reverse_z,
                              wire_px, scratch, scratch_bytes, z, id, attrs,
                              static_cast<cudaStream_t>(stream));
}

// z + winner id (B3a): as vrt_raster without wireframe and attributes.
extern "C" int vrt_raster_zid(const float* vis, const int* items, int n_items,
                              int tris_per_inst, int tiles_x, int tile,
                              int region, int width, int height,
                              int reverse_z, void* scratch,
                              long long scratch_bytes, float* z, int* id,
                              void* stream) {
  return launch_raster<kZid>(vis, nullptr, items, n_items, tris_per_inst,
                             tiles_x, tile, region, width, height, reverse_z,
                             0.0f, scratch, scratch_bytes, z, id, nullptr,
                             static_cast<cudaStream_t>(stream));
}

// Depth-only rasterize (B2): z (height, width) float32 is the output, the
// minimum covered z or F32_FAR; scratch holds vrt_raster_scratch(..., 4,
// ...) bytes. Other arguments as for vrt_raster.
extern "C" int vrt_raster_depth(const float* vis, const int* items,
                                int n_items, int tris_per_inst, int tiles_x,
                                int tile, int region, int width, int height,
                                void* scratch, long long scratch_bytes,
                                float* z, void* stream) {
  return launch_raster<kDepth>(vis, nullptr, items, n_items, tris_per_inst,
                               tiles_x, tile, region, width, height, 0, 0.0f,
                               scratch, scratch_bytes, z, nullptr, nullptr,
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
