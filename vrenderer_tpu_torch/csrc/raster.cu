// Binned triangle rasterizers for Hopper (sm_90a).
//
// B1, `vrt_raster`, replaces the TPU kernel vrenderer_tpu/ops/raster_pallas.py
// `_raster_kernel` (full variant), launched by `rasterize_pallas`. Same
// result: per pixel the minimum z over covered triangles, ties to the
// lowest global id inst * T + t, then the winner's inv_w and 8 attr/w
// planes evaluated at the pixel centre and divided by the guarded inv_w.
//
// B2, `vrt_raster_depth`, replaces `_raster_kernel(depth_only=True)`,
// launched by `rasterize_pallas_depth` (the map-mode light view): per pixel
// only the minimum covered z, F32_FAR where nothing covers, bit-identical
// to B1's z channel on the same inputs.
//
// Design (launches on the caller's stream):
//   1. visibility, shared by B1 and B2 (one template): one block per
//      (instance, 128x128 supertile) work item. The block walks the
//      instance's triangles in chunks of BLOCK, keeps those whose pixel bbox
//      meets the tile, prefix-sums their bbox-in-tile pixel counts in shared
//      memory and spreads the (triangle, pixel) pairs evenly over its
//      threads (one thread per pair, so a full-tile near-plane triangle
//      costs the same as many 1-px ones). A covered pixel does, for B1, a
//      64-bit atomicMin of (float_bits(z) << 32) | gid, and for B2 a 32-bit
//      atomicMin of float_bits(z) straight into the float z output, which
//      a fill pass set to F32_FAR first. Covered z is >= +0 and below
//      F32_FAR, so the unsigned bits order like the floats (and the low
//      word of B1's key breaks ties to the lowest id).
//   2. B1 only, resolve: one thread per pixel decodes the key and gathers
//      the winner's 27 plane coefficients.
// What bounds it on the H100: the global atomics (one per covered
// triangle-pixel pair, ~overdraw x 2.2M px per 1080p frame, 4.2M px per
// 2048^2 light map) and the bytes of triangle data each work item reads
// (64 B per triangle of its instance, 2048 triangles per instance, mostly
// from L2). The design keeps the per pair work to three edge and one depth
// evaluation and moves the 27 attribute coefficients only once per pixel,
// in B1's resolve pass; B2 reads none of them. The TPU kernel's one-hot
// MXU compaction, bf16 splits and per-cell round counts are TPU layout and
// have no counterpart here.
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

// kDepthOnly: `out` is the float z map (B2), else the uint64 key map (B1).
template <bool kDepthOnly>
__global__ void __launch_bounds__(kBlock)
visibility_kernel(const float* __restrict__ vis, const int* __restrict__ items,
                  int tris_per_inst, int tiles_x, int tile, int width,
                  int height, void* __restrict__ out) {
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
      if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && zq >= 0.0f &&
          zq <= 1.01f) {
        const unsigned int zbits = __float_as_uint(__fadd_rn(zq, 0.0f));
        const size_t p = (size_t)y * width + x;
        if constexpr (kDepthOnly) {
          atomicMin(static_cast<unsigned int*>(out) + p, zbits);
        } else {
          const unsigned int gid =
              (unsigned int)inst * (unsigned int)tris_per_inst + (c0 + lo);
          const unsigned long long key =
              ((unsigned long long)zbits << 32) | (unsigned long long)gid;
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

__global__ void __launch_bounds__(kBlock)
resolve_kernel(const unsigned long long* __restrict__ keys,
               const float* __restrict__ coef, int width, int num_pixels,
               float* __restrict__ z, int* __restrict__ id,
               float* __restrict__ attrs) {
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= num_pixels) return;
  const unsigned long long key = keys[p];
  float* out = attrs + (size_t)p * kAttrs;
  if (key == ~0ull) {  // background
    z[p] = kFar;
    id[p] = -1;
#pragma unroll
    for (int i = 0; i < kAttrs; ++i) out[i] = 0.0f;
    return;
  }
  const unsigned int gid = (unsigned int)(key & 0xffffffffull);
  z[p] = __uint_as_float((unsigned int)(key >> 32));
  id[p] = (int)gid;
  const float* c = coef + (size_t)gid * kCoefStride;
  const float px = (float)(p % width) + 0.5f;
  const float py = (float)(p / width) + 0.5f;
  const float inv_w = plane(c[0], c[1], c[2], px, py);
  const float denom = fabsf(inv_w) > 1e-20f ? inv_w : 1.0f;
#pragma unroll
  for (int i = 0; i < kAttrs; ++i) {
    const float* q = c + 3 * (i + 1);
    out[i] = __fdiv_rn(plane(q[0], q[1], q[2], px, py), denom);
  }
}

}  // namespace

// Rasterize: keys is scratch of width*height uint64; z, id (height, width)
// and attrs (height, width, 8) are outputs. items holds n_items (inst,
// supertile) int32 pairs, inst < 0 marking unused slots. Returns
// cudaGetLastError() after the launches.
extern "C" int vrt_raster(const float* vis, const float* coef,
                          const int* items, int n_items, int tris_per_inst,
                          int tiles_x, int tile, int width, int height,
                          unsigned long long* keys, float* z, int* id,
                          float* attrs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int num_pixels = width * height;
  cudaMemsetAsync(keys, 0xff, (size_t)num_pixels * sizeof(unsigned long long),
                  s);
  if (n_items > 0) {
    visibility_kernel<false><<<n_items, kBlock, 0, s>>>(
        vis, items, tris_per_inst, tiles_x, tile, width, height, keys);
  }
  resolve_kernel<<<(num_pixels + kBlock - 1) / kBlock, kBlock, 0, s>>>(
      keys, coef, width, num_pixels, z, id, attrs);
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
  fill_far_kernel<<<(num_pixels + kBlock - 1) / kBlock, kBlock, 0, s>>>(
      z, num_pixels);
  if (n_items > 0) {
    visibility_kernel<true><<<n_items, kBlock, 0, s>>>(
        vis, items, tris_per_inst, tiles_x, tile, width, height, z);
  }
  return (int)cudaGetLastError();
}
