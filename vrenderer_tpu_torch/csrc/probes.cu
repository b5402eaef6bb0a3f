// Microbenchmark kernels for Hopper (sm_90a): the counterparts of the JAX
// package's Mosaic probes (scripts/probe_*.py), which measured the TPU's
// answers to design questions of the raster kernel. These measure the same
// questions for the port's kernels in csrc/raster.cu. Each computes the
// probe's function with what Hopper has (registers, shared memory, warp
// ballots, atomics, vector loads) instead of the TPU's one-hot MXU products,
// bf16 splits and lane rolls, and each has a plain PyTorch version in
// vrenderer_tpu_torch/probes/ that it equals bit for bit.
//
// P1, `vrt_probe_sweep` (probes/peak.py), replaces probe_peak.py's
// `fma_kernel` and probe_fma.py's `make_kernel`. Forms 0-3: `reps`
// dependent sweeps over an (S, 1024) float32 block held in registers, four
// independent chains a thread: v*a + b as one FMA (__fmaf_rn) or as a
// multiply then an add (__fmul_rn, __fadd_rn: what --fmad=false gives the
// rasterizer's plane evaluations), min(v*a, v + b), and v >= b ? v*a : v + b.
// Each sweep feeds the next and the block is written, so nothing can be
// hoisted. Forms 4-7: probe_fma's ev() chain, out[k, p] = the sum over
// i < reps, in order, of the mode's value at coefficients i % 8 of row k:
// add px + c, mul a*px, fma1 a*px + c, full (a*px + b*py) + c, never
// contracted. Those values repeat every 8 reps, so the pixel is passed
// through an identity warp shuffle every 8 reps: the compiler cannot prove
// it unchanged and evaluates every rep. Bound: operations (67 TFLOP/s of
// float32; an FMA counts 2, and every separate multiply, add, min or
// compare 1, so the no-FMA forms can reach at most half the peak).
//
// P2, `vrt_probe_eval` (probes/eval.py), replaces probe_mosaic.py's
// `kernel`, probe_pack2.py's `kern_rowmajor`, `kern_compmajor` and `k1`,
// and probe_exact.py's `k2`, `k3` and `k4`: B1's front end alone. One
// block a work item: (1) for each of its 16 mask rows (T triangles, 0/1
// bytes) the ranks by a warp ballot prefix (popc below the lane, carried
// across 32-triangle steps), and the row's count; (2) the exact compaction
// of round `round`: the triangles of rank round*32 .. round*32+31 of each
// row, their 48 float32 each gathered from the item's rows, row-major
// (T, 48) as the port stores triangles, or component-major (48, T) as
// probe_pack2 compares (one 32-byte sector a float there); (3) optionally,
// row `sub`'s 32 compacted rows times a (48, NP) right-hand side, each
// output summed over the 48 components in ascending order with separate
// roundings. The TPU needed a one-hot product of three bf16 splits for an
// exact gather and HIGHEST-precision matmuls for an exact evaluation; here
// a gather is exact and the sum's order is the program's. Bound: bytes
// (masks, the gathered rows, the outputs) or operations (95 a pair).
//
// P3, `vrt_probe_merge` (probes/merge.py), replaces probe_transposed.py's
// `kernel` and `transpose_kernel`: B1's merge alone. For P pixels (x-major,
// p = col * rows + row) and K candidates, the minimum over k of
// e = fl(fl(x[p, 0] * x[0, k]) + x[p, k]), ties to the lowest k, merged
// three ways in shared memory: (0) one 64-bit atomicMin of
// (orderable z bits << 32) | k, as B1 merges (raster.cu, a compare-and-swap
// loop in the SASS); (1) a 32-bit atomicMin of the z bits (native ATOMS.MIN,
// as B2 merges), then a second pass that min-merges k where e equals the
// minimum; (2) one owner thread a pixel with a register loop, no atomics.
// In (0) and (1) a warp takes 32 consecutive k of one pixel, so all its
// lanes hit one address: the contention of many triangles on one pixel.
// The result leaves row-major (rows, cols) through a shared-memory
// transpose of the x-major state. `regions` blocks each merge the whole
// input into their own output, one a streaming multiprocessor. Bound: the
// operations (2 a pair); the merge's atomics are the design's cost.
//
// P4, `vrt_probe_window` (probes/window.py), replaces probe_window.py's
// `kern_a`, `kern_b` and `kern_c`: B3b's coefficient gather alone. Windows
// of W floats at runtime starts from rows of T floats, reduced in groups of
// g in ascending order: out[s, j, c] = sum_i data[c, start_s + j*g + i].
// A thread takes `span` consecutive floats of one window: (a) as scalar
// loads, or (b) as the aligned float4s around them and a shift in
// registers, as B3b's load_coef does (raster.cu). Bound: bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------- P1

enum SweepForm {
  kFma = 0, kMulAdd, kMin, kCmp,        // dependent sweeps
  kEvAdd, kEvMul, kEvFma1, kEvFull      // probe_fma's ev() chain
};

template <int kForm>
__device__ __forceinline__ float sweep_op(float v, float a, float b) {
  if constexpr (kForm == kFma) {
    return __fmaf_rn(v, a, b);
  } else if constexpr (kForm == kMulAdd) {
    return __fadd_rn(__fmul_rn(v, a), b);
  } else if constexpr (kForm == kMin) {
    return fminf(__fmul_rn(v, a), __fadd_rn(v, b));
  } else {
    return v >= b ? __fmul_rn(v, a) : __fadd_rn(v, b);
  }
}

template <int kForm>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float4* __restrict__ x, float4* __restrict__ out, int n4,
             int reps, float a, float b) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n4) return;
  float4 v = x[i];
#pragma unroll 8
  for (int r = 0; r < reps; ++r) {
    v.x = sweep_op<kForm>(v.x, a, b);
    v.y = sweep_op<kForm>(v.y, a, b);
    v.z = sweep_op<kForm>(v.z, a, b);
    v.w = sweep_op<kForm>(v.w, a, b);
  }
  out[i] = v;
}

template <int kForm>
__device__ __forceinline__ float ev_op(float a, float b, float c, float px,
                                       float py) {
  if constexpr (kForm == kEvAdd) {
    return __fadd_rn(px, c);
  } else if constexpr (kForm == kEvMul) {
    return __fmul_rn(a, px);
  } else if constexpr (kForm == kEvFma1) {
    return __fadd_rn(__fmul_rn(a, px), c);
  } else {
    return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
  }
}

// grid (ceil(cols / kThreads), rows); xy = (px[cols], py[cols]); coef
// (3, rows, 8) = a, b, c
template <int kForm>
__global__ void __launch_bounds__(kThreads)
ev_kernel(const float* __restrict__ xy, const float* __restrict__ coef,
          int rows, int cols, int reps, float* __restrict__ out) {
  const int k = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int q = p < cols ? p : cols - 1;   // whole warps for the shuffle
  float ca[8], cb[8], cc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ca[j] = __ldg(coef + (0 * rows + k) * 8 + j);
    cb[j] = __ldg(coef + (1 * rows + k) * 8 + j);
    cc[j] = __ldg(coef + (2 * rows + k) * 8 + j);
  }
  float px = __ldg(xy + q), py = __ldg(xy + cols + q);
  float acc = 0.0f;
  for (int i0 = 0; i0 < reps; i0 += 8) {
    // an identity the compiler cannot see through: every group of 8 reps
    // evaluates its values again
    px = __shfl_sync(0xffffffffu, px, lane);
    py = __shfl_sync(0xffffffffu, py, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (i0 + j < reps) {
        acc = __fadd_rn(acc, ev_op<kForm>(ca[j], cb[j], cc[j], px, py));
      }
    }
  }
  if (p < cols) out[(size_t)k * cols + p] = acc;
}

// ---------------------------------------------------------------- P2

constexpr int kSub = 16;   // mask rows of a work item
constexpr int kK = 32;     // triangles one round compacts
constexpr int kC = 48;     // floats a triangle row

__global__ void __launch_bounds__(kThreads)
eval_kernel(const unsigned char* __restrict__ mask,
            const float* __restrict__ data, int T, int comp_major, int sub,
            int round, const float* __restrict__ rhs, int np,
            int* __restrict__ counts, float* __restrict__ rows,
            float* __restrict__ evals) {
  __shared__ int s_sel[kSub * kK];
  __shared__ float s_blk[kK * kC];
  const int item = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kSub * kK; i += kThreads) s_sel[i] = -1;
  __syncthreads();
  // (1) ranks: warp w scans rows w, w + 8
  for (int s = warp; s < kSub; s += kWarps) {
    const unsigned char* m = mask + ((size_t)item * kSub + s) * T;
    int carry = 0;
    for (int t0 = 0; t0 < T; t0 += 32) {
      const int t = t0 + lane;
      const bool on = t < T && __ldg(m + t) != 0;
      const unsigned int bal = __ballot_sync(0xffffffffu, on);
      const int slot = carry + __popc(bal & ((1u << lane) - 1u)) - round * kK;
      if (on && slot >= 0 && slot < kK) s_sel[s * kK + slot] = t;
      carry += __popc(bal);
    }
    if (lane == 0) counts[item * kSub + s] = carry;
  }
  __syncthreads();
  // (2) the compaction, component fastest (coalesced for row-major rows)
  const size_t out0 = (size_t)item * kSub * kK * kC;
  for (int i = threadIdx.x; i < kSub * kK * kC; i += kThreads) {
    const int sk = i / kC;
    const int c = i - sk * kC;
    const int t = s_sel[sk];
    float v = 0.0f;
    if (t >= 0) {
      v = comp_major ? __ldg(data + ((size_t)item * kC + c) * T + t)
                     : __ldg(data + ((size_t)item * T + t) * kC + c);
    }
    rows[out0 + i] = v;
    if (sk / kK == sub) s_blk[(sk - sub * kK) * kC + c] = v;
  }
  if (evals == nullptr) return;
  __syncthreads();
  // (3) the evaluation: a thread takes pixel columns, its right-hand side
  // column in registers, the compacted rows broadcast from shared memory
  for (int p = threadIdx.x; p < np; p += kThreads) {
    float b[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) b[c] = __ldg(rhs + (size_t)c * np + p);
    float* o = evals + (size_t)item * kK * np + p;
    for (int k = 0; k < kK; ++k) {
      const float* a = s_blk + k * kC;
      float acc = __fmul_rn(a[0], b[0]);
#pragma unroll
      for (int c = 1; c < kC; ++c) acc = __fadd_rn(acc, __fmul_rn(a[c], b[c]));
      o[(size_t)k * np] = acc;
    }
  }
}

// ---------------------------------------------------------------- P3

enum MergeVariant { kPacked64 = 0, kZThenId = 1, kOwner = 2 };

// float bits ordered as unsigned integers (-0.0 first made +0.0)
__device__ __forceinline__ unsigned int orderable(float f) {
  const unsigned int u = __float_as_uint(__fadd_rn(f, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_orderable(unsigned int o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ float merge_e(const float* __restrict__ x, int K,
                                         int p, int k) {
  return __fadd_rn(__fmul_rn(__ldg(x + (size_t)p * K), __ldg(x + k)),
                   __ldg(x + (size_t)p * K + k));
}

// One block a region; dynamic shared memory: P 64-bit words (the keys; in
// (1) the z words, then the id words).
template <int kVariant>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ x, int P, int log2k, int rows,
             float* __restrict__ z, int* __restrict__ id) {
  extern __shared__ unsigned long long s_key[];
  const int K = 1 << log2k;
  const long long pairs = (long long)P << log2k;
  if constexpr (kVariant == kZThenId) {
    unsigned int* s_z = reinterpret_cast<unsigned int*>(s_key);
    unsigned int* s_id = s_z + P;
    for (int p = threadIdx.x; p < P; p += kThreads) {
      s_z[p] = 0xffffffffu;
      s_id[p] = 0xffffffffu;
    }
    __syncthreads();
    for (long long i = threadIdx.x; i < pairs; i += kThreads) {
      const int p = (int)(i >> log2k), k = (int)(i & (K - 1));
      atomicMin(&s_z[p], orderable(merge_e(x, K, p, k)));
    }
    __syncthreads();
    for (long long i = threadIdx.x; i < pairs; i += kThreads) {
      const int p = (int)(i >> log2k), k = (int)(i & (K - 1));
      if (orderable(merge_e(x, K, p, k)) == s_z[p]) {
        atomicMin(&s_id[p], (unsigned int)k);
      }
    }
    __syncthreads();
  }
  if constexpr (kVariant == kPacked64) {
    for (int p = threadIdx.x; p < P; p += kThreads) s_key[p] = ~0ull;
    __syncthreads();
    for (long long i = threadIdx.x; i < pairs; i += kThreads) {
      const int p = (int)(i >> log2k), k = (int)(i & (K - 1));
      const unsigned long long key =
          ((unsigned long long)orderable(merge_e(x, K, p, k)) << 32) |
          (unsigned int)k;
      atomicMin(&s_key[p], key);
    }
    __syncthreads();
  }
  if constexpr (kVariant == kOwner) {
    for (int p = threadIdx.x; p < P; p += kThreads) {
      const float a = __ldg(x + (size_t)p * K);
      const float* row = x + (size_t)p * K;
      unsigned int best = 0xffffffffu, arg = 0;
      for (int k = 0; k < K; ++k) {
        const unsigned int o =
            orderable(__fadd_rn(__fmul_rn(a, __ldg(x + k)), __ldg(row + k)));
        if (o < best) {
          best = o;
          arg = (unsigned int)k;
        }
      }
      s_key[p] = ((unsigned long long)best << 32) | arg;
    }
    __syncthreads();
  }
  // finalize: x-major state -> row-major output, through shared memory
  const int cols = P / rows;
  const size_t o0 = (size_t)blockIdx.x * P;
  const unsigned int* s_z = reinterpret_cast<const unsigned int*>(s_key);
  for (int o = threadIdx.x; o < P; o += kThreads) {
    const int r = o / cols, c = o - r * cols;
    const int p = c * rows + r;
    unsigned int zo, io;
    if constexpr (kVariant == kZThenId) {
      zo = s_z[p];
      io = s_z[P + p];
    } else {
      const unsigned long long key = s_key[p];
      zo = (unsigned int)(key >> 32);
      io = (unsigned int)key;
    }
    z[o0 + o] = from_orderable(zo);
    id[o0 + o] = (int)io;
  }
}

// ---------------------------------------------------------------- P4

// One thread a unit of kSpan floats of one window: unit = (s, c, u), u the
// unit's place in the window (W / kSpan units).
template <int kSpan, int kG, bool kVec>
__global__ void __launch_bounds__(kThreads)
window_kernel(const float* __restrict__ data, int C, int T,
              const int* __restrict__ starts, int S, int W,
              float* __restrict__ out) {
  const int per_window = W / kSpan;
  const long long unit = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (unit >= (long long)S * C * per_window) return;
  const int u = (int)(unit % per_window);
  const int c = (int)((unit / per_window) % C);
  const int s = (int)(unit / ((long long)per_window * C));
  constexpr int groups = kSpan / kG;
  const int gw = W / kG;
  float* o = out + ((size_t)s * gw + (size_t)u * groups) * C + c;
  const int start = __ldg(starts + s);
  if (start < 0 || start > T - W) {
    for (int j = 0; j < groups; ++j) {
      o[(size_t)j * C] = __int_as_float(0x7fc00000);
    }
    return;
  }
  const size_t f0 = (size_t)c * T + start + (size_t)u * kSpan;
  float w[kSpan];
  const size_t base = f0 & ~(size_t)3;
  const unsigned int sh = (unsigned int)(f0 & 3);
  constexpr int kVecs = (kSpan + 3 + 3) / 4;
  if (kVec && base + 4 * kVecs <= (size_t)C * T) {
    float v[4 * kVecs];
#pragma unroll
    for (int m = 0; m < kVecs; ++m) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(data + base) + m);
      v[4 * m] = q.x;
      v[4 * m + 1] = q.y;
      v[4 * m + 2] = q.z;
      v[4 * m + 3] = q.w;
    }
#pragma unroll
    for (int k = 0; k < kSpan; ++k) {
      const float lo = (sh & 2u) ? v[k + 2] : v[k];
      const float hi = (sh & 2u) ? v[k + 3] : v[k + 1];
      w[k] = (sh & 1u) ? hi : lo;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kSpan; ++k) w[k] = __ldg(data + f0 + k);
  }
#pragma unroll
  for (int j = 0; j < groups; ++j) {
    float acc = w[j * kG];
#pragma unroll
    for (int i = 1; i < kG; ++i) acc = __fadd_rn(acc, w[j * kG + i]);
    o[(size_t)j * C] = acc;
  }
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

int last_error() { return (int)cudaGetLastError(); }

}  // namespace

// P1. Forms 0-3: x and out (rows, cols) float32, cols a multiple of 4,
// `reps` sweeps with constants a, b; coef unused. Forms 4-7 (ev add, mul,
// fma1, full): x = (px, py) (2, cols), coef (3, rows, 8), out (rows, cols).
extern "C" int vrt_probe_sweep(const float* x, const float* coef, float* out,
                               int rows, int cols, int reps, int form,
                               float a, float b, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0 || reps < 0) return (int)cudaErrorInvalidValue;
  if (form >= kFma && form <= kCmp) {
    if (cols % 4 != 0) return (int)cudaErrorInvalidValue;
    const int n4 = rows * (cols / 4);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    const int grid = blocks_for(n4);
    switch (form) {
      case kFma: sweep_kernel<kFma><<<grid, kThreads, 0, st>>>(x4, o4, n4, reps, a, b); break;
      case kMulAdd: sweep_kernel<kMulAdd><<<grid, kThreads, 0, st>>>(x4, o4, n4, reps, a, b); break;
      case kMin: sweep_kernel<kMin><<<grid, kThreads, 0, st>>>(x4, o4, n4, reps, a, b); break;
      default: sweep_kernel<kCmp><<<grid, kThreads, 0, st>>>(x4, o4, n4, reps, a, b); break;
    }
    return last_error();
  }
  if (form < kEvAdd || form > kEvFull || rows > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(blocks_for(cols), rows);
  switch (form) {
    case kEvAdd: ev_kernel<kEvAdd><<<grid, kThreads, 0, st>>>(x, coef, rows, cols, reps, out); break;
    case kEvMul: ev_kernel<kEvMul><<<grid, kThreads, 0, st>>>(x, coef, rows, cols, reps, out); break;
    case kEvFma1: ev_kernel<kEvFma1><<<grid, kThreads, 0, st>>>(x, coef, rows, cols, reps, out); break;
    default: ev_kernel<kEvFull><<<grid, kThreads, 0, st>>>(x, coef, rows, cols, reps, out); break;
  }
  return last_error();
}

// P2. mask (items, 16, T) uint8; data (items, T, 48) float32, or (items,
// 48, T) with comp_major; rhs (48, np) or null (compaction only); counts
// (items, 16) int32; rows (items, 16, 32, 48); evals (items, 32, np) or
// null.
extern "C" int vrt_probe_eval(const unsigned char* mask, const float* data,
                              int items, int T, int C, int comp_major,
                              int sub, int round, const float* rhs, int np,
                              int* counts, float* rows, float* evals,
                              void* stream) {
  if (items <= 0 || T <= 0 || C != kC || sub < 0 || sub >= kSub ||
      round < 0 || (evals != nullptr && (rhs == nullptr || np <= 0))) {
    return (int)cudaErrorInvalidValue;
  }
  eval_kernel<<<items, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mask, data, T, comp_major, sub, round, rhs, np, counts, rows, evals);
  return last_error();
}

// P3. x (P, K) float32, K a power of two, pixels x-major over (rows,
// P / rows); z (regions, rows, P / rows) float32, id int32.
extern "C" int vrt_probe_merge(const float* x, int P, int K, int rows,
                               int regions, int variant, float* z, int* id,
                               void* stream) {
  int log2k = 0;
  while ((1 << log2k) < K) ++log2k;
  const size_t smem = (size_t)P * sizeof(unsigned long long);
  if (P <= 0 || K <= 0 || (1 << log2k) != K || rows <= 0 || P % rows != 0 ||
      regions <= 0 || variant < kPacked64 || variant > kOwner ||
      smem > 232448) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  switch (variant) {
    case kPacked64:
      err = cudaFuncSetAttribute(merge_kernel<kPacked64>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err == cudaSuccess) merge_kernel<kPacked64><<<regions, kThreads, smem, st>>>(x, P, log2k, rows, z, id);
      break;
    case kZThenId:
      err = cudaFuncSetAttribute(merge_kernel<kZThenId>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err == cudaSuccess) merge_kernel<kZThenId><<<regions, kThreads, smem, st>>>(x, P, log2k, rows, z, id);
      break;
    default:
      err = cudaFuncSetAttribute(merge_kernel<kOwner>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err == cudaSuccess) merge_kernel<kOwner><<<regions, kThreads, smem, st>>>(x, P, log2k, rows, z, id);
      break;
  }
  if (err != cudaSuccess) return (int)err;
  return last_error();
}

// P4. data (C, T) float32, 16-byte aligned; starts (S,) int32; out (S,
// W / g, C): group sums of g floats of each window, ascending. A thread
// takes `span` floats: span 16 with g 16 (probe_window's windows) or span
// 27 with g 1 (a triangle's coefficients); span divides W. vec selects the
// float4 loads. A start outside [0, T - W] gives NaN rows.
extern "C" int vrt_probe_window(const float* data, int C, int T,
                                const int* starts, int S, int W, int g,
                                int span, int vec, float* out, void* stream) {
  const bool shape_ok = (span == 16 && g == 16) || (span == 27 && g == 1);
  if (C <= 0 || T <= 0 || S <= 0 || W <= 0 || W > T || !shape_ok ||
      W % span != 0 ||
      (vec && (reinterpret_cast<uintptr_t>(data) & 15) != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = blocks_for((long long)S * C * (W / span));
  if (span == 16) {
    if (vec) window_kernel<16, 16, true><<<grid, kThreads, 0, st>>>(data, C, T, starts, S, W, out);
    else window_kernel<16, 16, false><<<grid, kThreads, 0, st>>>(data, C, T, starts, S, W, out);
  } else {
    if (vec) window_kernel<27, 1, true><<<grid, kThreads, 0, st>>>(data, C, T, starts, S, W, out);
    else window_kernel<27, 1, false><<<grid, kThreads, 0, st>>>(data, C, T, starts, S, W, out);
  }
  return last_error();
}
