// CDLOD quadtree selection in one launch (sm_90a).
//
// S1, `vrt_select`, replaces no TPU kernel: the JAX package selects with
// plain JAX (vrenderer_tpu/terrain/quadtree.py `select_nodes`), and the
// port's plain version (`quadtree.select_nodes_plain`, a level-synchronous
// sweep of about 90 small launches a level and one host sync for each of
// its three compactions) issued about 1,100 launches a selection, which
// paced the frame. Here one block of select_window^2 threads (rounded up to
// whole warps, at most 1024) holds one node of the window each and walks
// the levels d = 0..num_lods in order, coarse to fine:
//   * each thread computes its node's box, its XZ distance to the camera,
//     the LOD range tests and the frustum test, and reads `visited` from
//     the previous level's recurse flags in shared memory (double
//     buffered, so one __syncthreads a level orders them);
//   * the level's selected flags are ranked by a warp ballot and the warps'
//     counts, so each selected node finds its instance slot at once, in
//     level-major, row-major order (the plain version's compaction order,
//     which prim ids follow); slots at or past `cap` are dropped and
//     `count` stays the untruncated total.
// With several surfaces (world_size / surface_size per side) the block
// takes them in the plain version's order; each surface's rows are cut to
// `cap` before they are merged, and the merged rows cut to `cap` again.
// Rows past the selection are written as zeros, so the outputs need no
// fill. The debug masks (selected, culled, window origins) are written for
// the first surface.
//
// Bits: every float operation is the plain version's, in its order, with
// __fadd_rn / __fmul_rn / __fdiv_rn (the library is built with
// --fmad=false too), so positions, extents and every decision are
// bit-identical to the sweep on the CPU and on the card.
//
// Bound: the outputs' bytes (about 29 B an instance slot and 2 B a window
// node a level) over 3.35 TB/s, under a microsecond; what the launch
// replaces is host issue, so its measure is the host's time and the
// launches a frame, not this bound.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxLevels = 31;   // 1 << d stays an int

__global__ void __launch_bounds__(kMaxThreads)
select_kernel(const float* __restrict__ cam, const float* __restrict__ planes,
              const float* __restrict__ ranges, int per_side, int surface_size, int num_lods, int window,
              int cap, float* __restrict__ position,
              float* __restrict__ extents, int* __restrict__ lod_out,
              unsigned char* __restrict__ valid, int* __restrict__ count,
              unsigned char* __restrict__ dbg_sel,
              unsigned char* __restrict__ dbg_cull,
              int* __restrict__ dbg_origin) {
  __shared__ unsigned char recurse[2][kMaxThreads];
  __shared__ int warp_count[2][kMaxWarps];

  const int t = threadIdx.x;
  const int nodes = window * window;
  const bool live = t < nodes;
  const int cx = t % window;
  const int cz = t / window;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int warps = blockDim.x >> 5;

  const float cam_x = cam[0], cam_y = cam[1], cam_z = cam[2];
  float pl[6][4];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) pl[k][j] = planes[4 * k + j];
  }
  const double w_d = static_cast<double>(surface_size);
  const float w_f = static_cast<float>(w_d);
  const float w_half = static_cast<float>(w_d * 0.5);

  int merged = 0;   // rows of the surfaces so far, each cut to cap
  int total = 0;    // their untruncated counts
  int it = 0;       // levels so far over all surfaces: the buffer parity
  const int surfaces = per_side * per_side;
  for (int s = 0; s < surfaces; ++s) {
    // the surface's centre, as the plain version computes it: in double,
    // then rounded to float
    const float loc_x =
        static_cast<float>((-0.5 * (per_side - 1) + s % per_side) * w_d);
    const float loc_z =
        static_cast<float>((-0.5 * (per_side - 1) + s / per_side) * w_d);
    int selected = 0;   // this surface's selected nodes so far
    int prev_ox = 0, prev_oz = 0;
    for (int d = 0; d <= num_lods; ++d, ++it) {
      const int buf = it & 1;
      const int lod = num_lods - d;
      const int n = 1 << d;
      const float cell = static_cast<float>(w_d / n);
      const float half = static_cast<float>(w_d / n * 0.5);
      const float n_f = static_cast<float>(n);
      // the camera's cell: ((cam - loc) + W/2) * 2^d / W, floored
      const int cam_cx = static_cast<int>(floorf(__fdiv_rn(
          __fmul_rn(__fadd_rn(__fsub_rn(cam_x, loc_x), w_half), n_f), w_f)));
      const int cam_cz = static_cast<int>(floorf(__fdiv_rn(
          __fmul_rn(__fadd_rn(__fsub_rn(cam_z, loc_z), w_half), n_f), w_f)));
      const int hi = max(0, n - window);
      const int ox = min(max(cam_cx - window / 2, 0), hi);
      const int oz = min(max(cam_cz - window / 2, 0), hi);
      const int gx = ox + cx;
      const int gz = oz + cz;
      const bool in_grid = live && gx < n && gz < n;

      const float px = __fadd_rn(__fsub_rn(loc_x, w_half),
                                 __fmul_rn(__fadd_rn(static_cast<float>(gx),
                                                     0.5f), cell));
      const float pz = __fadd_rn(__fsub_rn(loc_z, w_half),
                                 __fmul_rn(__fadd_rn(static_cast<float>(gz),
                                                     0.5f), cell));
      const float min_x = __fsub_rn(px, half), max_x = __fadd_rn(px, half);
      const float min_z = __fsub_rn(pz, half), max_z = __fadd_rn(pz, half);

      // aabb_dist2_xz
      const float dx = cam_x < min_x ? __fsub_rn(cam_x, min_x)
                     : (cam_x > max_x ? __fsub_rn(cam_x, max_x) : 0.0f);
      const float dz = cam_z < min_z ? __fsub_rn(cam_z, min_z)
                     : (cam_z > max_z ? __fsub_rn(cam_z, max_z) : 0.0f);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz));
      const float r = ranges[lod];
      const bool in_range_self = in_grid && d2 <= __fmul_rn(r, r);

      // frustum_intersects_box: the p-vertex of the box from y = 0 to the
      // camera's height, its dot summed x, y, z, then d
      bool in_frustum = true;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float vx = pl[k][0] >= 0.0f ? max_x : min_x;
        const float vy = pl[k][1] >= 0.0f ? cam_y : 0.0f;
        const float vz = pl[k][2] >= 0.0f ? max_z : min_z;
        const float dist = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(vx, pl[k][0]),
                                __fmul_rn(vy, pl[k][1])),
                      __fmul_rn(vz, pl[k][2])),
            pl[k][3]);
        in_frustum = in_frustum && dist >= 0.0f;
      }

      bool visited = in_grid;
      if (d > 0) {
        const int pwx = (gx >> 1) - prev_ox;
        const int pwz = (gz >> 1) - prev_oz;
        visited = in_grid && pwx >= 0 && pwx < window && pwz >= 0 &&
                  pwz < window && recurse[buf ^ 1][pwz * window + pwx];
      }
      const bool taken = visited && in_range_self && in_frustum;
      bool self_sel = taken, rec = false;
      if (lod > 0) {
        const float rf = ranges[lod - 1];
        const bool in_range_finer = in_grid && d2 <= __fmul_rn(rf, rf);
        self_sel = taken && !in_range_finer;
        rec = taken && in_range_finer;
      }
      // a parent emits a child whose NodeSelect returns false
      const bool emitted = d > 0 && visited && !in_range_self;
      const bool sel = self_sel || emitted;
      recurse[buf][t] = rec;
      if (s == 0) {
        if (live) {
          dbg_sel[d * nodes + t] = sel;
          dbg_cull[d * nodes + t] = visited && in_range_self && !in_frustum;
        }
        if (t == 0) {
          dbg_origin[2 * d] = ox;
          dbg_origin[2 * d + 1] = oz;
        }
      }

      const unsigned ballot = __ballot_sync(0xffffffffu, sel);
      if (lane == 0) warp_count[buf][warp] = __popc(ballot);
      __syncthreads();
      int before = 0, level = 0;
      for (int k = 0; k < warps; ++k) {
        const int c = warp_count[buf][k];
        before += k < warp ? c : 0;
        level += c;
      }
      if (sel) {
        const int row = selected + before + __popc(ballot & ((1u << lane) - 1u));
        const int slot = merged + row;
        if (row < cap && slot < cap) {
          position[3 * slot] = px;
          position[3 * slot + 1] = 0.0f;
          position[3 * slot + 2] = pz;
          extents[3 * slot] = half;
          extents[3 * slot + 1] = 0.0f;
          extents[3 * slot + 2] = half;
          lod_out[slot] = lod;
        }
      }
      selected += level;
      prev_ox = ox;
      prev_oz = oz;
    }
    total += selected;
    merged += min(selected, cap);
  }

  const int kept = min(merged, cap);
  for (int i = t; i < cap; i += blockDim.x) {
    if (i >= kept) {
      position[3 * i] = position[3 * i + 1] = position[3 * i + 2] = 0.0f;
      extents[3 * i] = extents[3 * i + 1] = extents[3 * i + 2] = 0.0f;
      lod_out[i] = 0;
    }
    valid[i] = i < kept;
  }
  if (t == 0) *count = total;
}

}  // namespace

// One launch: the selection of per_side^2 surfaces around the origin.
// The debug masks are (num_lods + 1) x window^2 bytes each and
// (num_lods + 1) x 2 ints of window origins.
extern "C" int vrt_select(const float* cam, const float* planes,
                          const float* ranges, int per_side,
                          int surface_size, int num_lods, int window, int cap,
                          float* position, float* extents, int* lod,
                          unsigned char* valid, int* count,
                          unsigned char* dbg_sel, unsigned char* dbg_cull,
                          int* dbg_origin, void* stream) {
  const int nodes = window * window;
  if (window < 1 || nodes > kMaxThreads || num_lods < 0 ||
      num_lods >= kMaxLevels || per_side < 1 || cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (nodes + 31) / 32 * 32;
  select_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      cam, planes, ranges, per_side, surface_size, num_lods, window, cap,
      position, extents, lod, valid, count, dbg_sel, dbg_cull, dbg_origin);
  return static_cast<int>(cudaGetLastError());
}
