// Triangle setup in one launch a part (sm_90a).
//
// S2, `vrt_setup`, replaces no TPU kernel: the JAX package sets triangles
// up in plain JAX (vrenderer_tpu/ops/raster.py `setup_components`). The
// port's plain chain (`raster.setup_components`, `raster_cuda.
// instance_bbox_components`, `raster.shift_components_y` under a band,
// `raster.stack_components`, the parts' `torch.cat` and `raster_cuda.
// pack_vis` / `pack_setup`) issued about 650 small launches a raster, each
// reading and writing a whole (I, T) map, and a host copy of the empty
// bbox; its issue paced the frame. Here one block takes one instance of a
// part:
//   * its threads project every vertex of the instance and reduce the
//     in-front hull, whether any vertex is in front and any behind, and
//     the nearest in-front clip w: the instance's bbox, `usable` and
//     `dist`, which the work list reads;
//   * each warp then sets up 32 consecutive triangles at a time, a thread
//     a triangle (its three vertices projected again: the lattice's
//     vertices are cached, and the projection is 12 operations), and
//     stages their 16 visibility floats and 27 coefficients in shared
//     memory, from where the warp stores them as one contiguous run each,
//     zero planes and the empty bbox for an invalid triangle.
// Two index forms, picked from the input's shape as the plain chain picks
// them: the terrain lattice (I, S, S, 3), a cell's triangles (bl, tl, tr)
// and (bl, tr, br), row-major; and (I, V, 3) with indices (T, 3) (the
// scene's mesh blocks). A part with 8 attribute channels also gets its
// coefficient rows; one with none (the light view's depth-only raster)
// gets the visibility rows alone. Under a band (`banded`) the edges, the
// planes and both bboxes are rebased to the band's first row after the
// instance bounds are taken, with the product and the sum rounded apart,
// as `shift_components_y` does.
//
// Bits: every float operation is the plain chain's, in its order, with
// __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn / __fsqrt_rn (the library is
// built with --fmad=false too): PyTorch's CUDA kernels round each
// elementwise op once, `1.0 / t` is its correctly rounded reciprocal and
// `torch.sqrt` is correctly rounded on the card. Minima and maxima carry
// a NaN through, as torch.minimum, amin and clamp do. So the packed rows
// and the instance bounds are bit-identical to the plain chain on the
// card, and B1's ids, which follow the setup's last bits, are too.
//
// Bound: the bytes, the vertices read once (12 B, and 32 B of attributes)
// and the rows written (64 B and 108 B a triangle), over 3.35 TB/s: about
// 0.06 ms for a horizon frame's 512 x 2048 triangles. What the launch
// replaces is host issue, so its measure is the host's time and the
// launches a frame.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVis = 16;          // e0 e1 e2 (a, b, c), z (a, b, c), bbox
constexpr int kVisPad = 17;       // staged row stride: no bank conflicts
constexpr int kAttrs = 8;
constexpr int kCoef = 3 * (1 + kAttrs);   // inv_w, attr0..7 (a, b, c)
constexpr float kFar = 3.0e38f;   // raster.F32_FAR
constexpr float kBig = 1e9f;      // instance_bbox_components' fill
constexpr float kDetEps = 1e-30f;
constexpr float kAreaEps = -1e-12f;
constexpr float kNormMin = 1e-20f;

__device__ __forceinline__ bool isnan_f(float x) { return x != x; }

// torch.minimum / torch.maximum / amin / amax: a NaN wins
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan_f(a) ? a : (isnan_f(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan_f(a) ? a : (isnan_f(b) ? b : fmaxf(a, b));
}
// torch.clamp(v, lo, hi)
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan_f(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ bool finite_f(float x) {
  return isfinite(x);
}

// clip[c] = ((x M0c + y M1c) + z M2c) + M3c
__device__ __forceinline__ float4 project(const float* __restrict__ p,
                                          const float* m) {
  const float x = p[0], y = p[1], z = p[2];
  float c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c[k] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, m[k]),
                                         __fmul_rn(y, m[4 + k])),
                               __fmul_rn(z, m[8 + k])),
                     m[12 + k]);
  }
  return make_float4(c[0], c[1], c[2], c[3]);
}

// ((u0 q0 + u1 q1) + u2 q2) * inv_det
__device__ __forceinline__ float plane(float u0, float u1, float u2, float q0,
                                       float q1, float q2, float inv_det) {
  return __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(u0, q0), __fmul_rn(u1, q1)),
                             __fmul_rn(u2, q2)),
                   inv_det);
}

__global__ void __launch_bounds__(kThreads)
setup_kernel(const float* __restrict__ world, const float* __restrict__ attrs,
             int num_attrs, const unsigned char* __restrict__ inst_valid,
             const long long* __restrict__ tri_idx, int side, int V, int T,
             const float* __restrict__ wtc, int width, int height,
             float w_eps, int banded, float band_y0, float* __restrict__ vis,
             float* __restrict__ coef, float* __restrict__ bbox,
             unsigned char* __restrict__ usable, float* __restrict__ dist) {
  __shared__ float m[16];
  __shared__ float red[5][kWarps];
  __shared__ int flags[2][kWarps];
  __shared__ float stage_vis[kWarps][32 * kVisPad];
  __shared__ float stage_coef[kWarps][32 * kCoef];

  const int inst = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < 16) m[threadIdx.x] = wtc[threadIdx.x];
  __syncthreads();

  const float* wv = world + static_cast<size_t>(inst) * V * 3;
  const float W = static_cast<float>(width);
  const float H = static_cast<float>(height);

  // -- instance bounds (instance_bbox_components) ---------------------------
  const float inf = __int_as_float(0x7f800000);
  float mn_x = inf, mn_y = inf, mx_x = -inf, mx_y = -inf, mn_w = inf;
  int any_front = 0, any_behind = 0;
  for (int v = threadIdx.x; v < V; v += kThreads) {
    const float4 c = project(wv + 3 * v, m);
    if (c.w > w_eps) {
      any_front = 1;
      const float inv_w = __fdiv_rn(1.0f, c.w);
      const float sx = __fmul_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(c.x, inv_w), 0.5f), 0.5f), W);
      const float sy = __fmul_rn(
          __fsub_rn(0.5f, __fmul_rn(__fmul_rn(c.y, inv_w), 0.5f)), H);
      mn_x = min_nan(mn_x, sx);
      mn_y = min_nan(mn_y, sy);
      mx_x = max_nan(mx_x, sx);
      mx_y = max_nan(mx_y, sy);
      mn_w = min_nan(mn_w, c.w);
    } else {
      any_behind = 1;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn_x = min_nan(mn_x, __shfl_xor_sync(0xffffffffu, mn_x, o));
    mn_y = min_nan(mn_y, __shfl_xor_sync(0xffffffffu, mn_y, o));
    mx_x = max_nan(mx_x, __shfl_xor_sync(0xffffffffu, mx_x, o));
    mx_y = max_nan(mx_y, __shfl_xor_sync(0xffffffffu, mx_y, o));
    mn_w = min_nan(mn_w, __shfl_xor_sync(0xffffffffu, mn_w, o));
  }
  any_front = __any_sync(0xffffffffu, any_front);
  any_behind = __any_sync(0xffffffffu, any_behind);
  if (lane == 0) {
    red[0][warp] = mn_x;
    red[1][warp] = mn_y;
    red[2][warp] = mx_x;
    red[3][warp] = mx_y;
    red[4][warp] = mn_w;
    flags[0][warp] = any_front;
    flags[1][warp] = any_behind;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kWarps; ++k) {
      mn_x = min_nan(mn_x, red[0][k]);
      mn_y = min_nan(mn_y, red[1][k]);
      mx_x = max_nan(mx_x, red[2][k]);
      mx_y = max_nan(mx_y, red[3][k]);
      mn_w = min_nan(mn_w, red[4][k]);
      any_front |= flags[0][k];
      any_behind |= flags[1][k];
    }
    // behind vertices enter the reductions as the fill values
    if (any_behind) {
      mn_x = min_nan(mn_x, kBig);
      mn_y = min_nan(mn_y, kBig);
      mx_x = max_nan(mx_x, -kBig);
      mx_y = max_nan(mx_y, -kBig);
      mn_w = min_nan(mn_w, kBig);
    }
    float x0 = __fsub_rn(mn_x, 1.0f), y0 = __fsub_rn(mn_y, 1.0f);
    float x1 = __fadd_rn(mx_x, 1.0f), y1 = __fadd_rn(mx_y, 1.0f);
    if (any_front && any_behind) {   // straddles the near plane
      x0 = 0.0f;
      y0 = 0.0f;
      x1 = __fsub_rn(W, 1.0f);
      y1 = __fsub_rn(H, 1.0f);
    }
    const bool on = x1 >= 0.0f && y1 >= 0.0f && x0 < W && y0 < H;
    if (banded) {
      y0 = __fsub_rn(y0, band_y0);
      y1 = __fsub_rn(y1, band_y0);
    }
    bbox[4 * inst] = x0;
    bbox[4 * inst + 1] = y0;
    bbox[4 * inst + 2] = x1;
    bbox[4 * inst + 3] = y1;
    usable[inst] = inst_valid[inst] && on && any_front;
    dist[inst] = mn_w;
  }

  // -- triangles (setup_components, stacked and packed) ---------------------
  const bool inst_ok = inst_valid[inst] != 0;
  const bool with_coef = coef != nullptr;
  const float* av = attrs + static_cast<size_t>(inst) * V * num_attrs;
  const float half_w = __fmul_rn(0.5f, W), half_h = __fmul_rn(0.5f, H);
  float* sv = stage_vis[warp] + lane * kVisPad;
  float* sc = stage_coef[warp] + lane * kCoef;
  for (int base = 32 * warp; base < T; base += 32 * kWarps) {
    const int t = base + lane;
    bool valid = false;
    if (inst_ok && t < T) {
      int iv[3];
      if (side > 0) {
        const int cell = t >> 1, r = cell / (side - 1), q = cell % (side - 1);
        const int bl = r * side + q, tr = (r + 1) * side + q + 1;
        iv[0] = bl;
        iv[1] = (t & 1) ? tr : (r + 1) * side + q;   // B: tr, A: tl
        iv[2] = (t & 1) ? r * side + q + 1 : tr;     // B: br, A: tr
      } else {
        iv[0] = static_cast<int>(tri_idx[3 * t]);
        iv[1] = static_cast<int>(tri_idx[3 * t + 1]);
        iv[2] = static_cast<int>(tri_idx[3 * t + 2]);
      }
      float a[3], b[3], w[3], z[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 c = project(wv + 3 * iv[k], m);
        a[k] = __fmul_rn(__fadd_rn(c.x, c.w), half_w);
        b[k] = __fmul_rn(__fsub_rn(c.w, c.y), half_h);
        w[k] = c.w;
        z[k] = c.z;
      }
      // u_k = cross(v_{k+1}, v_{k+2}) of the rows (a, b, w)
      float u[3][3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int i = (k + 1) % 3, j = (k + 2) % 3;
        u[k][0] = __fsub_rn(__fmul_rn(b[i], w[j]), __fmul_rn(w[i], b[j]));
        u[k][1] = __fsub_rn(__fmul_rn(w[i], a[j]), __fmul_rn(a[i], w[j]));
        u[k][2] = __fsub_rn(__fmul_rn(a[i], b[j]), __fmul_rn(b[i], a[j]));
      }
      const float det = __fadd_rn(
          __fadd_rn(__fmul_rn(a[0], u[0][0]), __fmul_rn(b[0], u[0][1])),
          __fmul_rn(w[0], u[0][2]));
      const float inv_det =
          __fdiv_rn(1.0f, fabsf(det) > kDetEps ? det : 1.0f);
      bool finite = finite_f(det);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int j = 0; j < 3; ++j) finite = finite && finite_f(u[k][j]);
      }

      // planes: z, then 1/w (its vertex values are 1), then the attributes
      float zp[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        zp[j] = plane(u[0][j], u[1][j], u[2][j], z[0], z[1], z[2], inv_det);
        const float pw = plane(u[0][j], u[1][j], u[2][j], 1.0f, 1.0f, 1.0f,
                               inv_det);
        finite = finite && finite_f(zp[j]) && finite_f(pw);
        sc[j] = pw;
      }
      if (num_attrs == kAttrs) {
        const float* p0 = av + kAttrs * iv[0];
        const float* p1 = av + kAttrs * iv[1];
        const float* p2 = av + kAttrs * iv[2];
#pragma unroll
        for (int ch = 0; ch < kAttrs; ++ch) {
          const float q0 = p0[ch], q1 = p1[ch], q2 = p2[ch];
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float pa = plane(u[0][j], u[1][j], u[2][j], q0, q1, q2,
                                   inv_det);
            finite = finite && finite_f(pa);
            sc[3 + 3 * ch + j] = pa;
          }
        }
      }

      // pixel bbox over the in-front vertices, one pixel of padding
      bool bh[3];
      float xs[3], ys[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        bh[k] = w[k] <= w_eps;
        const float s = bh[k] ? 1.0f : w[k];
        xs[k] = __fdiv_rn(a[k], s);
        ys[k] = __fdiv_rn(b[k], s);
      }
      const bool behind = bh[0] || bh[1] || bh[2];
      const bool crossing = behind && !(bh[0] && bh[1] && bh[2]);
      const float bx0 = clamp_nan(
          __fsub_rn(floorf(min_nan(xs[0], min_nan(xs[1], xs[2]))), 1.0f),
          0.0f, __fsub_rn(W, 1.0f));
      const float by0 = clamp_nan(
          __fsub_rn(floorf(min_nan(ys[0], min_nan(ys[1], ys[2]))), 1.0f),
          0.0f, __fsub_rn(H, 1.0f));
      const float bx1 = clamp_nan(
          __fadd_rn(ceilf(max_nan(xs[0], max_nan(xs[1], xs[2]))), 1.0f),
          0.0f, __fsub_rn(W, 1.0f));
      const float by1 = clamp_nan(
          __fadd_rn(ceilf(max_nan(ys[0], max_nan(ys[1], ys[2]))), 1.0f),
          0.0f, __fsub_rn(H, 1.0f));
      const bool on_screen = bx1 >= bx0 && by1 >= by0;
      // in front: the exact pixel-space area decides the facing
      const float area2 = __fsub_rn(
          __fmul_rn(__fsub_rn(xs[1], xs[0]), __fsub_rn(ys[2], ys[0])),
          __fmul_rn(__fsub_rn(xs[2], xs[0]), __fsub_rn(ys[1], ys[0])));
      const bool front = crossing ? det < 0.0f : area2 < kAreaEps;
      valid = front && finite && (crossing || (!behind && on_screen));

      float box[4] = {bx0, by0, bx1, by1};
      if (crossing) {
        box[0] = 0.0f;
        box[1] = 0.0f;
        box[2] = __fsub_rn(W, 1.0f);
        box[3] = __fsub_rn(H, 1.0f);
      }

      // edges -u_k, normalised by their gradient's length
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float ea = -u[k][0], eb = -u[k][1], ec = -u[k][2];
        float g = __fsqrt_rn(__fadd_rn(__fmul_rn(ea, ea), __fmul_rn(eb, eb)));
        g = isnan_f(g) ? g : fmaxf(g, kNormMin);
        sv[3 * k] = __fdiv_rn(ea, g);
        sv[3 * k + 1] = __fdiv_rn(eb, g);
        sv[3 * k + 2] = __fdiv_rn(ec, g);
      }
      sv[9] = zp[0];
      sv[10] = zp[1];
      sv[11] = zp[2];
      if (banded) {   // c + b * y0, two roundings
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sv[3 * k + 2] = __fadd_rn(sv[3 * k + 2],
                                    __fmul_rn(sv[3 * k + 1], band_y0));
        }
        for (int p = 0; p < 1 + num_attrs; ++p) {
          sc[3 * p + 2] = __fadd_rn(sc[3 * p + 2],
                                    __fmul_rn(sc[3 * p + 1], band_y0));
        }
        box[1] = __fsub_rn(box[1], band_y0);
        box[3] = __fsub_rn(box[3], band_y0);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) sv[12 + k] = box[k];
    }

    // one contiguous run of rows a warp; invalid rows get zero planes and
    // the empty bbox (+FAR, +FAR, -FAR, -FAR)
    const unsigned ok = __ballot_sync(0xffffffffu, valid);
    __syncwarp();
    const int n = min(32, T - base);
    const size_t row0 = static_cast<size_t>(inst) * T + base;
    float* dv = vis + row0 * kVis;
    for (int k = lane; k < n * kVis; k += 32) {
      const int r = k >> 4, col = k & 15;
      dv[k] = (ok >> r) & 1u ? stage_vis[warp][r * kVisPad + col]
              : (col < 12 ? 0.0f : (col < 14 ? kFar : -kFar));
    }
    if (with_coef) {
      float* dc = coef + row0 * kCoef;
      for (int k = lane; k < n * kCoef; k += 32) {
        const int r = k / kCoef;
        dc[k] = (ok >> r) & 1u ? stage_coef[warp][k] : 0.0f;
      }
    }
    __syncwarp();
  }
}

}  // namespace

// One launch: the setup of one part's I instances of T triangles into its
// rows of the raster's buffers (the pointers are the part's first row).
// side > 0: the lattice (I, side, side, 3), T = 2 (side - 1)^2, tri_idx
// unused; side == 0: (I, V, 3) with tri_idx (T, 3) int64 in [0, V).
// num_attrs is 0 or 8; coef, (I, T, 27), is written when it is not null
// (it needs num_attrs 8). vis (I, T, 16); bbox (I, 4), usable (I,), dist (I,).
extern "C" int vrt_setup(const float* world, const float* attrs,
                         int num_attrs, const unsigned char* inst_valid,
                         const long long* tri_idx, int side, int V, int T,
                         int I, const float* wtc, int width, int height,
                         float w_eps, int banded, float band_y0, float* vis,
                         float* coef, float* bbox, unsigned char* usable,
                         float* dist, void* stream) {
  if (I < 1 || T < 1 || V < 1 || (num_attrs != 0 && num_attrs != kAttrs) ||
      (coef != nullptr && num_attrs != kAttrs) || side < 0 ||
      (side > 0 && (side < 2 || V != side * side ||
                    T != 2 * (side - 1) * (side - 1))) ||
      (side == 0 && tri_idx == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  setup_kernel<<<I, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      world, attrs, num_attrs, inst_valid, tri_idx, side, V, T, wtc, width,
      height, w_eps, banded, band_y0, vis, coef, bbox, usable, dist);
  return static_cast<int>(cudaGetLastError());
}
