// FAST-9/16 scoring shared by the port's two FAST kernels (fast_nms.cu,
// fast_cells.cu): the tile geometry, the circle, the 9-arc test and the
// score of one pixel from a shared-memory tile.
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

}  // namespace lc_fast
