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
// B1's visibility launch and B1's resolve pass without the attributes, so
// z and id are bit-identical to B1's.
//
// B3b, `vrt_raster_resolve`, replaces `_resolve_kernel`, launched by
// `rasterize_pallas_resolve` (two-phase phase 2): the 8 attributes of the
// phase-1 winners, evaluated only over the (work item, cell) pairs that
// `filter_work_to_winners` left live, with B1's arithmetic, so the attrs
// are bit-identical to B1's.
//
// Design (launches on the caller's stream):
//   1. visibility, shared by B1, B2 and B3a (one template): one block per
//      (instance, 128x128 supertile) work item. The block walks the
//      instance's triangles in chunks of BLOCK, keeps those whose pixel bbox
//      meets the tile, prefix-sums their bbox-in-tile pixel counts in shared
//      memory and spreads the (triangle, pixel) pairs evenly over its
//      threads (one thread per pair, so a full-tile near-plane triangle
//      costs the same as many 1-px ones). A covered pixel does, for B1 and
//      B3a, a 64-bit atomicMin of (hi << 32) | gid with hi = float_bits(z),
//      or ~float_bits(z) under reverse-z, and for B2 a 32-bit atomicMin of
//      float_bits(z) straight into the float z output, which a fill pass set
//      to F32_FAR first. Covered z is in [+0, 1.01], so the unsigned bits
//      order like the floats and their complement like -z; the low word of
//      the key breaks ties to the lowest id in both directions.
//   2. B1 and B3a, resolve: one thread per pixel decodes the key (the
//      untouched key ~0 is the background, which no covered key can equal:
//      no gid is 0xffffffff); B1 also gathers the winner's 27 plane
//      coefficients.
//   3. B3b: a fill zeroes the background pixels' attrs, then one block per
//      work item walks its live cells (sub_h x win_w pixel blocks of the
//      supertile) and writes the attrs of every pixel whose winner belongs
//      to the item's instance. A covered pixel's winner has exactly one
//      (instance, supertile) item, and the filter's instance range per cell
//      keeps it live, so every covered pixel is written exactly once.
// What bounds them on the H100: the global atomics (one per covered
// triangle-pixel pair, ~overdraw x 2.2M px per 1080p frame, 4.2M px per
// 2048^2 light map) and the bytes of triangle data each work item reads
// (64 B per triangle of its instance, 2048 triangles per instance, mostly
// from L2). The design keeps the per pair work to three edge and one depth
// evaluation and moves the 27 attribute coefficients only once per pixel,
// in B1's resolve pass or B3b; B2 and B3a read none of them. B3b reads the
// id image once per live (item, cell) pair (4 B per pixel, from L2). The
// TPU kernel's one-hot MXU compaction, bf16 splits, per-cell round counts
// and its per-round one-hot coefficient accumulate are TPU layout and have
// no counterpart here.
//
// Exactness: every plane is evaluated as (a*px + b*py) + c with separate
// IEEE roundings (__fmul_rn/__fadd_rn; the library is also built with
// --fmad=false), matching the JAX package's evaluation order; -0.0 depth is
// canonicalised to +0.0 before packing; NaN fails every explicit coverage
// comparison.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kVisStride = 16;   // e0(a,b,c) e1 e2 z(a,b,c) bbox(x0,y0,x1,y1)
constexpr int kCoefStride = 27;  // [inv_w, attr0..7] x (a, b, c)
constexpr int kAttrs = 8;
constexpr float kFar = 3.0e38f;

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

// Inclusive prefix sum over the block (kBlock threads).
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
    int s = lane < kBlock / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kBlock / 32; o <<= 1) {
      int n = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += n;
    }
    if (lane < kBlock / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  return v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

// kDepthOnly: `out` is the float z map (B2), else the uint64 key map (B1,
// B3a). reverse_z and wire_px apply to the key map only.
template <bool kDepthOnly>
__global__ void __launch_bounds__(kBlock)
visibility_kernel(const float* __restrict__ vis, const int* __restrict__ items,
                  int tris_per_inst, int tiles_x, int tile, int width,
                  int height, int reverse_z, float wire_px,
                  void* __restrict__ out) {
  const int inst = items[2 * blockIdx.x];
  if (inst < 0) return;  // unused work-list slot
  const int st = items[2 * blockIdx.x + 1];
  const int tx0 = (st % tiles_x) * tile;
  const int ty0 = (st / tiles_x) * tile;
  const int tx1 = min(tx0 + tile, width) - 1;
  const int ty1 = min(ty0 + tile, height) - 1;

  __shared__ float s_coef[kBlock][12];
  __shared__ int s_x0[kBlock], s_y0[kBlock], s_w[kBlock], s_incl[kBlock];
  __shared__ int s_warp[kBlock / 32];

  const float* base = vis + (size_t)inst * tris_per_inst * kVisStride;
  for (int c0 = 0; c0 < tris_per_inst; c0 += kBlock) {
    const int k = threadIdx.x;
    const int t = c0 + k;
    int count = 0;
    if (t < tris_per_inst) {
      const float* p = base + (size_t)t * kVisStride;
      // pixel index i is inside the triangle's bbox iff x0 <= i <= x1;
      // invalid triangles carry an empty (+FAR, -FAR) bbox. The explicit
      // comparisons also reject NaN before fmaxf/fminf could drop it.
      const float bx0 = p[12], by0 = p[13], bx1 = p[14], by1 = p[15];
      if (bx0 <= (float)tx1 && bx1 >= (float)tx0 && by0 <= (float)ty1 &&
          by1 >= (float)ty0) {
        const int ix0 = (int)fmaxf(ceilf(bx0), (float)tx0);
        const int iy0 = (int)fmaxf(ceilf(by0), (float)ty0);
        const int w = (int)fminf(floorf(bx1), (float)tx1) - ix0 + 1;
        count = w * ((int)fminf(floorf(by1), (float)ty1) - iy0 + 1);
        s_x0[k] = ix0;
        s_y0[k] = iy0;
        s_w[k] = w;
#pragma unroll
        for (int i = 0; i < 12; ++i) s_coef[k][i] = p[i];
      }
    }
    const int incl = block_inclusive_scan(count, s_warp);
    s_incl[k] = incl;
    __syncthreads();
    const int total = s_incl[kBlock - 1];
    for (int j = threadIdx.x; j < total; j += kBlock) {
      // the triangle owning pair j: first slot whose inclusive sum > j
      int lo = 0, hi = kBlock - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_incl[mid] > j) hi = mid; else lo = mid + 1;
      }
      const int local = j - (lo > 0 ? s_incl[lo - 1] : 0);
      const int w = s_w[lo];
      const int x = s_x0[lo] + local % w;
      const int y = s_y0[lo] + local / w;
      const float px = (float)x + 0.5f;
      const float py = (float)y + 0.5f;
      const float* c = s_coef[lo];
      const float e0 = plane(c[0], c[1], c[2], px, py);
      const float e1 = plane(c[3], c[4], c[5], px, py);
      const float e2 = plane(c[6], c[7], c[8], px, py);
      const float zq = plane(c[9], c[10], c[11], px, py);
      bool cover = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && zq >= 0.0f &&
                   zq <= 1.01f;
      // wireframe: only pixels within wire_px of an edge (the edges are
      // gradient-normalised, so e is a distance in pixels)
      if (wire_px > 0.0f) cover = cover && fminf(e0, fminf(e1, e2)) <= wire_px;
      if (cover) {
        const unsigned int zbits = __float_as_uint(__fadd_rn(zq, 0.0f));
        const size_t p = (size_t)y * width + x;
        if constexpr (kDepthOnly) {
          atomicMin(static_cast<unsigned int*>(out) + p, zbits);
        } else {
          const unsigned int gid =
              (unsigned int)inst * (unsigned int)tris_per_inst + (c0 + lo);
          const unsigned int hi_word = reverse_z ? ~zbits : zbits;
          const unsigned long long key =
              ((unsigned long long)hi_word << 32) | (unsigned long long)gid;
          atomicMin(static_cast<unsigned long long*>(out) + p, key);
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kBlock)
fill_far_kernel(float* __restrict__ z, int num_pixels) {
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p < num_pixels) z[p] = kFar;
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

// Decode the key map into z and id (B3a), and with kWithAttrs also the
// winner's attributes (B1).
template <bool kWithAttrs>
__global__ void __launch_bounds__(kBlock)
resolve_kernel(const unsigned long long* __restrict__ keys,
               const float* __restrict__ coef, int width, int num_pixels,
               int reverse_z, float* __restrict__ z, int* __restrict__ id,
               float* __restrict__ attrs) {
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= num_pixels) return;
  const unsigned long long key = keys[p];
  if (key == ~0ull) {  // background
    z[p] = reverse_z ? -kFar : kFar;
    id[p] = -1;
    if constexpr (kWithAttrs) {
#pragma unroll
      for (int i = 0; i < kAttrs; ++i) attrs[(size_t)p * kAttrs + i] = 0.0f;
    }
    return;
  }
  const unsigned int gid = (unsigned int)(key & 0xffffffffull);
  const unsigned int hi_word = (unsigned int)(key >> 32);
  z[p] = __uint_as_float(reverse_z ? ~hi_word : hi_word);
  id[p] = (int)gid;
  if constexpr (kWithAttrs) {
    winner_attrs(coef + (size_t)gid * kCoefStride, p % width, p / width,
                 attrs + (size_t)p * kAttrs);
  }
}

__global__ void __launch_bounds__(kBlock)
zero_background_attrs_kernel(const int* __restrict__ id, int num_pixels,
                             float* __restrict__ attrs) {
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= num_pixels || id[p] >= 0) return;
#pragma unroll
  for (int i = 0; i < kAttrs; ++i) attrs[(size_t)p * kAttrs + i] = 0.0f;
}

// B3b: one block per work item; live is (n_items, n_cell) bytes.
__global__ void __launch_bounds__(kBlock)
winner_resolve_kernel(const float* __restrict__ coef,
                      const int* __restrict__ items,
                      const unsigned char* __restrict__ live, int n_cell,
                      int tris_per_inst, int tiles_x, int tile, int sub_h,
                      int win_w, int width, int height,
                      const int* __restrict__ id, float* __restrict__ attrs) {
  const int inst = items[2 * blockIdx.x];
  if (inst < 0) return;  // unused slot, or an item the filter found dead
  const int st = items[2 * blockIdx.x + 1];
  const int tx0 = (st % tiles_x) * tile;
  const int ty0 = (st / tiles_x) * tile;
  const int n_win = tile / win_w;
  const int cell_px = sub_h * win_w;
  const unsigned char* lv = live + (size_t)blockIdx.x * n_cell;
  for (int c = 0; c < n_cell; ++c) {
    if (!lv[c]) continue;
    const int cx0 = tx0 + (c % n_win) * win_w;
    const int cy0 = ty0 + (c / n_win) * sub_h;
    for (int j = threadIdx.x; j < cell_px; j += kBlock) {
      const int x = cx0 + j % win_w;
      const int y = cy0 + j / win_w;
      if (x >= width || y >= height) continue;
      const size_t p = (size_t)y * width + x;
      const int gid = id[p];
      if (gid < 0 || gid / tris_per_inst != inst) continue;
      winner_attrs(coef + (size_t)gid * kCoefStride, x, y,
                   attrs + p * kAttrs);
    }
  }
}

// Clear the key map and run the visibility pass into it.
void launch_key_visibility(const float* vis, const int* items, int n_items,
                           int tris_per_inst, int tiles_x, int tile,
                           int width, int height, int reverse_z,
                           float wire_px, unsigned long long* keys,
                           cudaStream_t s) {
  cudaMemsetAsync(keys, 0xff,
                  (size_t)width * height * sizeof(unsigned long long), s);
  if (n_items > 0) {
    visibility_kernel<false><<<n_items, kBlock, 0, s>>>(
        vis, items, tris_per_inst, tiles_x, tile, width, height, reverse_z,
        wire_px, keys);
  }
}

int pixel_blocks(int num_pixels) { return (num_pixels + kBlock - 1) / kBlock; }

}  // namespace

// Rasterize (B1): keys is scratch of width*height uint64; z, id (height,
// width) and attrs (height, width, 8) are outputs. items holds n_items
// (inst, supertile) int32 pairs, inst < 0 marking unused slots. reverse_z
// != 0 keeps the farthest z; wire_px > 0 is the wireframe line half-width.
// Returns cudaGetLastError() after the launches.
extern "C" int vrt_raster(const float* vis, const float* coef,
                          const int* items, int n_items, int tris_per_inst,
                          int tiles_x, int tile, int width, int height,
                          int reverse_z, float wire_px,
                          unsigned long long* keys, float* z, int* id,
                          float* attrs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int num_pixels = width * height;
  launch_key_visibility(vis, items, n_items, tris_per_inst, tiles_x, tile,
                        width, height, reverse_z, wire_px, keys, s);
  resolve_kernel<true><<<pixel_blocks(num_pixels), kBlock, 0, s>>>(
      keys, coef, width, num_pixels, reverse_z, z, id, attrs);
  return (int)cudaGetLastError();
}

// z + winner id (B3a): as vrt_raster without wireframe and attributes.
extern "C" int vrt_raster_zid(const float* vis, const int* items, int n_items,
                              int tris_per_inst, int tiles_x, int tile,
                              int width, int height, int reverse_z,
                              unsigned long long* keys, float* z, int* id,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int num_pixels = width * height;
  launch_key_visibility(vis, items, n_items, tris_per_inst, tiles_x, tile,
                        width, height, reverse_z, 0.0f, keys, s);
  resolve_kernel<false><<<pixel_blocks(num_pixels), kBlock, 0, s>>>(
      keys, nullptr, width, num_pixels, reverse_z, z, id, nullptr);
  return (int)cudaGetLastError();
}

// Winner attributes (B3b): id (height, width) int32 from vrt_raster_zid;
// live (n_items, n_cell) bytes, cell c of a supertile being the sub_h x
// win_w block at row c / (tile / win_w), column c % (tile / win_w); attrs
// (height, width, 8) is the output.
extern "C" int vrt_raster_resolve(const float* coef, const int* items,
                                  const unsigned char* live, int n_items,
                                  int n_cell, int tris_per_inst, int tiles_x,
                                  int tile, int sub_h, int win_w, int width,
                                  int height, const int* id, float* attrs,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int num_pixels = width * height;
  zero_background_attrs_kernel<<<pixel_blocks(num_pixels), kBlock, 0, s>>>(
      id, num_pixels, attrs);
  if (n_items > 0) {
    winner_resolve_kernel<<<n_items, kBlock, 0, s>>>(
        coef, items, live, n_cell, tris_per_inst, tiles_x, tile, sub_h,
        win_w, width, height, id, attrs);
  }
  return (int)cudaGetLastError();
}

// Depth-only rasterize (B2): z (height, width) float32 is the output, set
// to F32_FAR and min-merged in place. Other arguments as for vrt_raster.
extern "C" int vrt_raster_depth(const float* vis, const int* items,
                                int n_items, int tris_per_inst, int tiles_x,
                                int tile, int width, int height, float* z,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int num_pixels = width * height;
  fill_far_kernel<<<pixel_blocks(num_pixels), kBlock, 0, s>>>(z, num_pixels);
  if (n_items > 0) {
    visibility_kernel<true><<<n_items, kBlock, 0, s>>>(
        vis, items, tris_per_inst, tiles_x, tile, width, height, 0, 0.0f, z);
  }
  return (int)cudaGetLastError();
}
