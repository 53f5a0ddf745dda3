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
// 8 levels into one launch, and the per-cell max of keypoint selection,
// is what fast_cells.cu does: the main path runs that kernel, and this one
// stays as the way to look at the maps.

#include "fast_common.cuh"

namespace {

using namespace lc_fast;

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

  load_tile(img, H, W, y0, x0, tid, nthreads, s_img);
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
