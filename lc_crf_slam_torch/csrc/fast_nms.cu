// Dual-threshold FAST-9/16 corner score + 3x3 non-maximum suppression,
// one launch per pyramid level, both NMS'd maps out.
//
// Replaces lc_crf_slam_tpu/ops/pallas_fast.py::fast_score_dual_pallas
// (the Pallas TPU kernel). Semantics follow the path the JAX pipeline
// runs by default, lc_crf_slam_tpu/ops/fast.py::fast_score_dual:
//   - the score is computed for 3 <= y < H-3, 3 <= x < W-3 and is 0
//     elsewhere, so no circle pixel is ever read outside the image;
//   - margins are (c - I) - t (bright) and (I - c) - t (dark), summed
//     over the qualifying circle pixels in circle order k = 0..15;
//   - NMS treats positions outside the image as -inf and keeps a score
//     where it is >= its 3x3 neighbourhood maximum.
// The plain PyTorch twin (lc_crf_slam_torch/ops/fast.py) accumulates in
// the same order and has no multiply to contract into an FMA, so the two
// agree bit for bit.
//
// What bounds it: memory and launches, not arithmetic. A 480x640 level
// reads 1.2 MB and writes 2.5 MB; at the card's bandwidth that is about
// a microsecond, so at pyramid sizes the launch itself dominates. Design:
// each block stages its tile plus a 4-px halo (circle radius 3 + 1 for the
// NMS ring) in shared memory, scores the tile plus a 1-px ring into
// shared memory at both thresholds, synchronises, and applies NMS from
// shared memory. Global memory is read once and written once. Fusing the
// 8 levels into one launch, or the per-cell max of keypoint selection,
// is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kHalo = 4;
constexpr int kSmemW = kTileW + 2 * kHalo;
constexpr int kSmemH = kTileH + 2 * kHalo;
constexpr int kRingW = kTileW + 2;
constexpr int kRingH = kTileH + 2;
constexpr int kArc = 9;

// 16 Bresenham circle offsets (dy, dx), radius 3, clockwise from 12
// o'clock: the order of ops/fast.py CIRCLE_OFFSETS.
__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ bool has_arc(unsigned int bits) {
  unsigned int ext = bits | (bits << 16);  // circular extension
  unsigned int run = ext;
#pragma unroll
  for (int j = 1; j < kArc; ++j) run &= ext >> j;
  return (run & 0xFFFFu) != 0u;
}

// Score of the pixel whose centre sits at s[cy][cx] in shared memory.
__device__ __forceinline__ float fast_score(float (*s)[kSmemW], int cy, int cx,
                                            float t) {
  const float I = s[cy][cx];
  const float hi = I + t;
  const float lo = I - t;
  unsigned int bright = 0u, dark = 0u;
  float mb = 0.0f, md = 0.0f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float c = s[cy + kDy[k]][cx + kDx[k]];
    const bool b = c > hi;
    const bool d = c < lo;
    bright |= (b ? 1u : 0u) << k;
    dark |= (d ? 1u : 0u) << k;
    mb = mb + (b ? __fsub_rn(__fsub_rn(c, I), t) : 0.0f);
    md = md + (d ? __fsub_rn(__fsub_rn(I, c), t) : 0.0f);
  }
  const float sb = has_arc(bright) ? mb : 0.0f;
  const float sd = has_arc(dark) ? md : 0.0f;
  return fmaxf(sb, sd);
}

__global__ void fast_nms_dual_kernel(const float* __restrict__ img,
                                     float* __restrict__ out_hi,
                                     float* __restrict__ out_lo, int H, int W,
                                     float th_hi, float th_lo) {
  __shared__ float s_img[kSmemH][kSmemW];
  __shared__ float s_hi[kRingH][kRingW];
  __shared__ float s_lo[kRingH][kRingW];

  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  // tile + halo; pixels outside the image are never read by a score
  for (int i = tid; i < kSmemH * kSmemW; i += nthreads) {
    const int ly = i / kSmemW, lx = i % kSmemW;
    const int gy = y0 - kHalo + ly, gx = x0 - kHalo + lx;
    s_img[ly][lx] =
        (gy >= 0 && gy < H && gx >= 0 && gx < W) ? img[gy * W + gx] : 0.0f;
  }
  __syncthreads();

  // scores on tile + 1-px ring: 0 outside the 3-px band, -inf off-image
  for (int i = tid; i < kRingH * kRingW; i += nthreads) {
    const int ry = i / kRingW, rx = i % kRingW;
    const int gy = y0 - 1 + ry, gx = x0 - 1 + rx;
    float vh, vl;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
      vh = vl = -__int_as_float(0x7f800000);
    } else if (gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3) {
      const int cy = ry + kHalo - 1, cx = rx + kHalo - 1;
      vh = fast_score(s_img, cy, cx, th_hi);
      vl = fast_score(s_img, cy, cx, th_lo);
    } else {
      vh = vl = 0.0f;
    }
    s_hi[ry][rx] = vh;
    s_lo[ry][rx] = vl;
  }
  __syncthreads();

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int gy = y0 + ty, gx = x0 + tx;
  if (gy >= H || gx >= W) return;
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
  out_hi[gy * W + gx] = ch >= mh ? ch : 0.0f;
  out_lo[gy * W + gx] = cl >= ml ? cl : 0.0f;
}

}  // namespace

// C entry point, bound with ctypes. img, out_hi, out_lo: contiguous (H, W)
// float32 device buffers; stream: a cudaStream_t. Returns the launch's
// cudaGetLastError() (0 = launched).
extern "C" int fast_nms_dual(const void* img, void* out_hi, void* out_lo,
                             int H, int W, float th_hi, float th_lo,
                             void* stream) {
  const dim3 block(kTileW, kTileH);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  fast_nms_dual_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(out_hi),
      static_cast<float*>(out_lo), H, W, th_hi, th_lo);
  return static_cast<int>(cudaGetLastError());
}
