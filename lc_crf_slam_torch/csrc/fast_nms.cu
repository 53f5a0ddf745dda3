// Dual-threshold FAST-9/16 corner score + 3x3 non-maximum suppression,
// both NMS'd maps out, for every pyramid level of every frame of a batch
// in ONE launch.
//
// Replaces lc_crf_slam_tpu/ops/pallas_fast.py::fast_score_dual_pallas
// (the Pallas TPU kernel: one level in, both NMS'd maps out; a one-level
// table here). Semantics follow the path the JAX pipeline runs by default,
// lc_crf_slam_tpu/ops/fast.py::fast_score_dual:
//   - the score is computed for 3 <= y < H-3, 3 <= x < W-3 and is 0
//     elsewhere, so no circle pixel is ever read outside the image, and
//     both maps are 0 there (no margin mask beyond that border);
//   - margins are (c - I) - t (bright) and (I - c) - t (dark), summed
//     over the qualifying circle pixels in circle order k = 0..15;
//   - NMS treats positions outside the image as -inf and keeps a score
//     where it is >= its 3x3 neighbourhood maximum.
// The plain PyTorch version (lc_crf_slam_torch/ops/fast.py::fast_score_dual,
// per frame and level) accumulates in the same order and has no multiply
// to contract into an FMA, so the two agree bit for bit.
// In: n_frames rows of frame_stride floats, level l of a frame at
// img_offset[l] as a contiguous (H_l, W_l) image (PyramidBatch.flat). Out:
// two buffers of the same layout, the high- and the low-threshold map.
//
// What bounds it: one frame's 8 levels are ~0.95 M pixels, 3.8 MB read and
// 7.6 MB written: about 3.4 us at the card's memory rate. Its first
// version (one launch a level, every pixel of tile and ring through the
// full 16-pixel test at both thresholds) took 0.063 ms a frame on one
// H100 80GB HBM3 at 700 W (chip_smoke.py): 8 launches, the small levels
// all launch overhead, and an instruction count per pixel that the card
// waited for. Design: the front half of fast_cells.cu, shared through
// fast_common.cuh. The level table travels by value with the launch;
// blockIdx.x counts the tiles of all levels (a block finds its level by a
// search over <= 16 entries), blockIdx.y is the frame. A block of 32x16
// threads stages its tile plus a 4-px halo (circle radius 3 + 1 for the
// NMS ring), takes the 4-pixel compass pre-test at the low threshold on
// tile + ring (most pixels fail it and score 0 at both thresholds), lists
// the survivors densely in shared memory, scores only the list in full,
// and runs NMS from shared memory; each thread then writes its pixel of
// both maps (a warp writes one tile row: coalesced). Global memory is read
// once and written once. No TMA: a TMA copy needs 16-byte global strides,
// and level widths such as 533 and 444 do not give them; loads and stores
// are scalar for the same reason.

#include "fast_common.cuh"

namespace {

using namespace lc_fast;

__global__ void __launch_bounds__(kThreads, 3)
    fast_nms_dual_kernel(const float* __restrict__ img,
                         float* __restrict__ out_hi, float* __restrict__ out_lo,
                         const LevelTable tab, long long frame_stride,
                         float th_hi, float th_lo) {
  __shared__ float s_img[kSmemH][kSmemW];
  __shared__ float s_hi[kRingH][kRingW];
  __shared__ float s_lo[kRingH][kRingW];
  __shared__ short s_list[kRing];  // ring positions to score in full
  __shared__ int s_count;

  const int level = find_level(tab, static_cast<int>(blockIdx.x));
  const int H = tab.H[level], W = tab.W[level];
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tile = static_cast<int>(blockIdx.x) - tab.first_tile[level];
  const int x0 = (tile % tiles_x) * kTileW, y0 = (tile / tiles_x) * kTileH;
  const long long base =
      static_cast<long long>(blockIdx.y) * frame_stride + tab.img_offset[level];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileW + tx;

  if (tid == 0) s_count = 0;
  load_tile(img + base, H, W, y0, x0, tid, kThreads, s_img);
  __syncthreads();
  // the 3-px border as the margin box: nothing outside it is tested
  score_ring(s_img, s_hi, s_lo, s_list, &s_count, H, W, y0, x0, kBorder, th_hi,
             th_lo, tid);

  const int gy = y0 + ty, gx = x0 + tx;
  if (gy >= H || gx >= W) return;
  float vh = 0.0f, vl = 0.0f;
  if (gy >= kBorder && gy < H - kBorder && gx >= kBorder && gx < W - kBorder)
    nms_pair(s_hi, s_lo, ty, tx, vh, vl);
  const long long o = base + static_cast<long long>(gy) * W + gx;
  out_hi[o] = vh;
  out_lo[o] = vl;
}

}  // namespace

// C entry point, bound with ctypes. img, out_hi, out_lo: n_frames rows of
// frame_stride floats on the device, level l of a frame at img_offsets[l]
// as a contiguous (heights[l], widths[l]) image; the three tables are host
// arrays of n_levels ints. stream: a cudaStream_t. Returns the launch's
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a shape
// the kernel does not take (more than 16 levels, more than 65535 frames,
// th_hi < th_lo).
extern "C" int fast_nms_dual(const void* img, void* out_hi, void* out_lo,
                             int n_frames, long long frame_stride, int n_levels,
                             const int* heights, const int* widths,
                             const int* img_offsets, float th_hi, float th_lo,
                             void* stream) {
  if (n_frames < 1 || n_frames > 65535 || !(th_hi >= th_lo))
    return static_cast<int>(cudaErrorInvalidValue);
  LevelTable tab;
  const int tiles =
      make_level_table(tab, n_levels, heights, widths, img_offsets, nullptr);
  if (tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kTileW, kTileH);
  const dim3 grid(tiles, n_frames);
  fast_nms_dual_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(out_hi),
      static_cast<float*>(out_lo), tab, frame_stride, th_hi, th_lo);
  return static_cast<int>(cudaGetLastError());
}
