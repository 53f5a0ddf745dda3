// FAST-9/16 + 3x3 NMS shared by the port's two FAST kernels (fast_nms.cu,
// fast_cells.cu): the tile geometry, the level table that lets one launch
// take every level of every frame of a batch, the circle, the 9-arc test,
// the score of one pixel, and a block's whole front half (stage tile and
// halo, compass pre-test, dense list of survivors, full scoring of the
// list, NMS from shared memory). The two kernels differ only in what they
// do with each pixel's NMS'd pair: fast_nms.cu writes it, fast_cells.cu
// reduces it per cell.
//
// The score follows lc_crf_slam_torch/ops/fast.py: margins (c - I) - t
// (bright) and (I - c) - t (dark), summed over the qualifying circle
// pixels in circle order k = 0..15 with no multiply (nothing to contract
// into an FMA), so kernel and plain version agree bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace lc_fast {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kHalo = 4;   // circle radius 3 + 1 for the NMS ring
constexpr int kSmemW = kTileW + 2 * kHalo;
constexpr int kSmemH = kTileH + 2 * kHalo;
constexpr int kRingW = kTileW + 2;
constexpr int kRingH = kTileH + 2;
constexpr int kArc = 9;
constexpr int kThreads = kTileW * kTileH;   // one thread a tile pixel
constexpr int kRing = kRingH * kRingW;      // tile + 1-px ring positions
constexpr int kBorder = 3;                  // no score within 3 px of the edge
constexpr int kMaxLevels = 16;

// Every level of a frame, passed by value with the launch (no copy, no
// sync): blockIdx.x counts the tiles of all levels, level l's from
// first_tile[l]. A frame's level l starts at pixel img_offset[l] of its
// row (and, for fast_cells.cu, at cell cell_offset[l] of its cells).
struct LevelTable {
  int n_levels;
  int H[kMaxLevels];
  int W[kMaxLevels];
  int img_offset[kMaxLevels];
  int cell_offset[kMaxLevels];
  int first_tile[kMaxLevels + 1];
};

// Fill `tab` from host arrays of n_levels ints (cell_offsets may be
// null); returns the tiles of all levels, or 0 for a table the kernels do
// not take.
inline int make_level_table(LevelTable& tab, int n_levels, const int* heights,
                            const int* widths, const int* img_offsets,
                            const int* cell_offsets) {
  if (n_levels < 1 || n_levels > kMaxLevels) return 0;
  tab.n_levels = n_levels;
  int tiles = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool used = l < n_levels;
    tab.H[l] = used ? heights[l] : 0;
    tab.W[l] = used ? widths[l] : 0;
    tab.img_offset[l] = used ? img_offsets[l] : 0;
    tab.cell_offset[l] = used && cell_offsets ? cell_offsets[l] : 0;
    tab.first_tile[l] = tiles;
    if (used)
      tiles += ((heights[l] + kTileH - 1) / kTileH) *
               ((widths[l] + kTileW - 1) / kTileW);
  }
  tab.first_tile[kMaxLevels] = tiles;
  return tiles;
}

// The level whose tiles hold block b: a search over <= 16 entries.
__device__ __forceinline__ int find_level(const LevelTable& tab, int b) {
  int level = 0;
  while (level + 1 < tab.n_levels && b >= tab.first_tile[level + 1]) ++level;
  return level;
}

// 16 Bresenham circle offsets X(k, dy, dx), radius 3, clockwise from 12
// o'clock: the order of ops/fast.py CIRCLE_OFFSETS. A macro list, so every
// offset is an immediate in the shared-memory address.
#define LC_FAST_CIRCLE(X)                                                  \
  X(0, -3, 0) X(1, -3, 1) X(2, -2, 2) X(3, -1, 3) X(4, 0, 3) X(5, 1, 3)    \
  X(6, 2, 2) X(7, 3, 1) X(8, 3, 0) X(9, 3, -1) X(10, 2, -2) X(11, 1, -3)   \
  X(12, 0, -3) X(13, -1, -3) X(14, -2, -2) X(15, -3, -1)

__device__ __forceinline__ bool has_arc(unsigned int bits) {
  unsigned int ext = bits | (bits << 16);  // circular extension
  unsigned int run = ext;
#pragma unroll
  for (int j = 1; j < kArc; ++j) run &= ext >> j;
  return (run & 0xFFFFu) != 0u;
}

// Score of the pixel whose centre sits at s[cy][cx] in shared memory.
__device__ __forceinline__ float fast_score(const float (*s)[kSmemW], int cy,
                                            int cx, float t) {
  const float I = s[cy][cx];
  const float hi = I + t;
  const float lo = I - t;
  unsigned int bright = 0u, dark = 0u;
  float mb = 0.0f, md = 0.0f;
#define LC_STEP(k, dy, dx)                                        \
  {                                                               \
    const float c = s[cy + (dy)][cx + (dx)];                      \
    const bool b = c > hi;                                        \
    const bool d = c < lo;                                        \
    bright |= (b ? 1u : 0u) << (k);                               \
    dark |= (d ? 1u : 0u) << (k);                                 \
    mb = mb + (b ? __fsub_rn(__fsub_rn(c, I), t) : 0.0f);         \
    md = md + (d ? __fsub_rn(__fsub_rn(I, c), t) : 0.0f);         \
  }
  LC_FAST_CIRCLE(LC_STEP)
#undef LC_STEP
  const float sb = has_arc(bright) ? mb : 0.0f;
  const float sd = has_arc(dark) ? md : 0.0f;
  return fmaxf(sb, sd);
}

// Whether the centre at s[cy][cx] can have a 9-arc at threshold t. Any 9
// contiguous circle pixels hold at least 2 of the 4 compass pixels (k = 0,
// 4, 8, 12), so a centre with fewer than 2 of them brighter and fewer
// than 2 darker has no arc at t, nor at any higher threshold (whose bits
// are a subset): its scores are 0 after 4 reads instead of 16.
__device__ __forceinline__ bool compass_test(const float (*s)[kSmemW], int cy,
                                             int cx, float t) {
  const float I = s[cy][cx];
  const float hi = I + t;
  const float lo = I - t;
  const float c0 = s[cy - 3][cx], c4 = s[cy][cx + 3];
  const float c8 = s[cy + 3][cx], c12 = s[cy][cx - 3];
  const int nb = (c0 > hi) + (c4 > hi) + (c8 > hi) + (c12 > hi);
  const int nd = (c0 < lo) + (c4 < lo) + (c8 < lo) + (c12 < lo);
  return nb >= 2 || nd >= 2;
}

// Stage the tile at (y0, x0) plus its halo; pixels outside the (H, W)
// image read as 0 and are never used by a score.
__device__ __forceinline__ void load_tile(const float* __restrict__ img, int H,
                                          int W, int y0, int x0, int tid,
                                          int nthreads,
                                          float (*s_img)[kSmemW]) {
  for (int i = tid; i < kSmemH * kSmemW; i += nthreads) {
    const int ly = i / kSmemW, lx = i % kSmemW;
    const int gy = y0 - kHalo + ly, gx = x0 - kHalo + lx;
    s_img[ly][lx] =
        (gy >= 0 && gy < H && gx >= 0 && gx < W) ? img[gy * W + gx] : 0.0f;
  }
}

// Scores of the tile at (y0, x0) plus its 1-px ring at both thresholds,
// into s_hi / s_lo, from the staged s_img (load_tile, then a barrier):
// -inf off-image; 0 outside the 3-px band, outside the box [margin - 1,
// H - margin] x [margin - 1, W - margin] (the margin box and the ring its
// NMS reads), and where the compass test at the low threshold fails. The
// positions that pass are listed (one shared atomic a warp), then the
// threads walk the list, so the full 16-pixel scoring runs in dense warps
// instead of in every warp that holds one survivor. Ends on a barrier.
__device__ __forceinline__ void score_ring(const float (*s_img)[kSmemW],
                                           float (*s_hi)[kRingW],
                                           float (*s_lo)[kRingW],
                                           short* s_list, int* s_count, int H,
                                           int W, int y0, int x0, int margin,
                                           float th_hi, float th_lo, int tid) {
  const unsigned int lane_lt = (1u << (tid & 31)) - 1u;
  for (int base = 0; base < kRing; base += kThreads) {
    const int i = base + tid;
    const int ry = i / kRingW, rx = i % kRingW;
    const int gy = y0 - 1 + ry, gx = x0 - 1 + rx;
    bool pass = false;
    if (i < kRing) {
      const bool off = gy < 0 || gy >= H || gx < 0 || gx >= W;
      const float v = off ? -__int_as_float(0x7f800000) : 0.0f;
      s_hi[ry][rx] = v;
      s_lo[ry][rx] = v;
      pass = gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3 &&
             gy >= margin - 1 && gy <= H - margin && gx >= margin - 1 &&
             gx <= W - margin &&
             compass_test(s_img, ry + kHalo - 1, rx + kHalo - 1, th_lo);
    }
    const unsigned int m = __ballot_sync(0xFFFFFFFFu, pass);
    int first = 0;
    if ((tid & 31) == 0 && m != 0u) first = atomicAdd(s_count, __popc(m));
    first = __shfl_sync(0xFFFFFFFFu, first, 0);
    if (pass) s_list[first + __popc(m & lane_lt)] = static_cast<short>(i);
  }
  __syncthreads();

  const int n_listed = *s_count;
  for (int j = tid; j < n_listed; j += kThreads) {
    const int i = s_list[j];
    const int ry = i / kRingW, rx = i % kRingW;
    s_lo[ry][rx] = fast_score(s_img, ry + kHalo - 1, rx + kHalo - 1, th_lo);
    s_hi[ry][rx] = fast_score(s_img, ry + kHalo - 1, rx + kHalo - 1, th_hi);
  }
  __syncthreads();
}

// 3x3 NMS of tile pixel (ty, tx) at both thresholds from score_ring's
// maps: the score where it is >= its neighbourhood's maximum, else 0.
__device__ __forceinline__ void nms_pair(const float (*s_hi)[kRingW],
                                         const float (*s_lo)[kRingW], int ty,
                                         int tx, float& vh, float& vl) {
  float mh = s_hi[ty][tx], ml = s_lo[ty][tx];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      mh = fmaxf(mh, s_hi[ty + dy][tx + dx]);
      ml = fmaxf(ml, s_lo[ty + dy][tx + dx]);
    }
  }
  const float ch = s_hi[ty + 1][tx + 1];
  const float cl = s_lo[ty + 1][tx + 1];
  vh = ch >= mh ? ch : 0.0f;
  vl = cl >= ml ? cl : 0.0f;
}

}  // namespace lc_fast
