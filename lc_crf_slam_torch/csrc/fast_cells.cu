// Dual-threshold FAST-9/16 + 3x3 NMS + the per-cell best of keypoint
// selection, for every pyramid level of every frame of a batch in ONE
// launch. The score maps are never written.
//
// Replaces lc_crf_slam_tpu/ops/pallas_fast.py::fast_score_dual_pallas on
// the main path, together with the cell reduction that reads its maps
// (lc_crf_slam_tpu/ops/select.py::_cell_reduce and the low-threshold
// fallback of select_keypoints). Plain PyTorch version:
// lc_crf_slam_torch/ops/fast.py::fast_score_dual followed by
// lc_crf_slam_torch/ops/select.py::cell_best. Semantics:
//   - score and NMS exactly as fast_nms.cu (same scoring code, same
//     border rules): bitwise equal to the plain version;
//   - a score outside [margin, H-margin) x [margin, W-margin) counts as 0,
//     and so does the padding of a ragged last row or column of cells;
//   - per 16x16 cell: the maximum and the FIRST position attaining it in
//     the cell's row-major order (a cell of zeros gives its origin);
//   - where the high-threshold best is <= 0 the low-threshold result.
// Out, per (frame, level, cell), cells row-major over ceil(H/16) x
// ceil(W/16): best (f32), y, x (i32).
//
// What bounds it: one frame's 8 levels are ~0.95 M pixels, 3.8 MB read and
// ~3.9 k cells x 12 B written: about 1.1 us at the card's memory rate
// (writing both maps cost another 7.6 MB, and one launch a level about
// 5.5 us each), and about 4 us of float32 work if every pixel took the full
// test. Measured on one H100 80GB HBM3 at 700 W (chip_smoke.py):
// 0.038 ms for one frame, 0.49 ms for a chunk of 15, so the instruction
// count per pixel is what the card waits for, not the bytes. Design: the
// pyramid of the whole batch lies in one buffer; the level table travels
// by value with the launch (no copy, no sync); blockIdx.x counts the tiles
// of all levels and a block finds its level by a search over <= 16
// entries; blockIdx.y is the frame. A tile is 32x16 pixels = two cells, one thread a pixel: the
// block stages tile + halo and scores tile + ring at both thresholds in
// two steps. First every position takes a 4-pixel compass test at the low
// threshold (most fail it and score 0; pixels more than 1 px outside the
// margin box are never tested, and a tile that misses the box writes its
// empty cells at once); the survivors go on a list in shared memory.
// Then the threads walk the list, so the full 16-pixel scoring runs in
// dense warps instead of in every warp that holds one survivor. NMS and
// the margin mask follow, and each cell is reduced by warp shuffles (16
// lanes = one cell row) and one pass over the 16 row results in shared
// memory: no global atomics, no second launch. The block's register count
// is held to 3 resident blocks per SM (1, 2 and 4 timed within 5% of it on
// that card). Loads are scalar: level rows are not 16-byte aligned in general (W = 533, 444...).
// Everything up to the NMS'd pair of each pixel is fast_common.cuh's
// (find_level, load_tile, score_ring, nms_pair), which fast_nms.cu shares.

#include "fast_common.cuh"

namespace {

using namespace lc_fast;

constexpr int kCell = 16;
constexpr int kCellsPerTile = kTileW / kCell;
static_assert(kTileH == kCell && kTileW % kCell == 0, "a tile is whole cells");

// (v, i) <- the better of (v, i) and (ov, oi): higher score, then lower
// in-cell index.
__device__ __forceinline__ void keep_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Reduce over the 16 lanes of a half warp (xor offsets stay inside it).
__device__ __forceinline__ void reduce16(float& v, int& i) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xFFFFFFFFu, v, off);
    const int oi = __shfl_xor_sync(0xFFFFFFFFu, i, off);
    keep_better(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(kThreads, 3)
    fast_cell_best_kernel(const float* __restrict__ img,
                          float* __restrict__ out_best, int* __restrict__ out_y,
                          int* __restrict__ out_x, const LevelTable tab,
                          long long frame_stride, int cells_per_frame,
                          int margin, float th_hi, float th_lo) {
  __shared__ float s_img[kSmemH][kSmemW];
  __shared__ float s_hi[kRingH][kRingW];
  __shared__ float s_lo[kRingH][kRingW];
  __shared__ float s_val[2][kCellsPerTile][kCell];  // [map][cell][row]
  __shared__ int s_idx[2][kCellsPerTile][kCell];
  __shared__ short s_list[kRing];  // ring positions to score in full
  __shared__ int s_count;

  const int level = find_level(tab, static_cast<int>(blockIdx.x));
  const int H = tab.H[level], W = tab.W[level];
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tile = static_cast<int>(blockIdx.x) - tab.first_tile[level];
  const int tile_y = tile / tiles_x, tile_x = tile % tiles_x;
  const int x0 = tile_x * kTileW, y0 = tile_y * kTileH;
  const float* __restrict__ im =
      img + static_cast<long long>(blockIdx.y) * frame_stride +
      tab.img_offset[level];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int cells_x = (W + kCell - 1) / kCell;

  // a tile that misses the margin box holds only empty cells
  if (y0 + kTileH <= margin || y0 >= H - margin || x0 + kTileW <= margin ||
      x0 >= W - margin) {
    const int cx = tile_x * kCellsPerTile + tx / kCell;
    if (ty == 0 && (tx & (kCell - 1)) == 0 && cx < cells_x) {
      const long long o = static_cast<long long>(blockIdx.y) * cells_per_frame +
                          tab.cell_offset[level] + tile_y * cells_x + cx;
      out_best[o] = 0.0f;
      out_y[o] = tile_y * kCell;
      out_x[o] = cx * kCell;
    }
    return;
  }

  if (tid == 0) s_count = 0;
  load_tile(im, H, W, y0, x0, tid, kThreads, s_img);
  __syncthreads();
  score_ring(s_img, s_hi, s_lo, s_list, &s_count, H, W, y0, x0, margin, th_hi,
             th_lo, tid);

  // this thread's pixel: NMS, then the margin mask (margin >= 0, so the
  // off-image pixels of a ragged cell fall outside the box and count as 0,
  // like padding)
  const int gy = y0 + ty, gx = x0 + tx;
  float vh = 0.0f, vl = 0.0f;
  if (gy >= margin && gy < H - margin && gx >= margin && gx < W - margin)
    nms_pair(s_hi, s_lo, ty, tx, vh, vl);

  // a warp is one tile row = one row of each of the tile's two cells
  int ih = (ty << 4) | (tx & (kCell - 1));  // row-major index in the cell
  int il = ih;
  reduce16(vh, ih);
  reduce16(vl, il);
  if ((tx & (kCell - 1)) == 0) {
    const int c = tx / kCell;
    s_val[0][c][ty] = vh;
    s_idx[0][c][ty] = ih;
    s_val[1][c][ty] = vl;
    s_idx[1][c][ty] = il;
  }
  __syncthreads();
  if (ty != 0) return;

  // warp 0: lanes 0-15 finish cell 0 over its 16 rows, lanes 16-31 cell 1
  const int c = tx / kCell, r = tx & (kCell - 1);
  vh = s_val[0][c][r];
  ih = s_idx[0][c][r];
  vl = s_val[1][c][r];
  il = s_idx[1][c][r];
  reduce16(vh, ih);
  reduce16(vl, il);
  const int cx = tile_x * kCellsPerTile + c;
  if (r == 0 && cx < cells_x) {
    const bool use_lo = vh <= 0.0f;
    const float v = use_lo ? vl : vh;
    const int i = use_lo ? il : ih;
    const long long o = static_cast<long long>(blockIdx.y) * cells_per_frame +
                        tab.cell_offset[level] + tile_y * cells_x + cx;
    out_best[o] = v;
    out_y[o] = tile_y * kCell + (i >> 4);
    out_x[o] = cx * kCell + (i & (kCell - 1));
  }
}

}  // namespace

// C entry point, bound with ctypes. img: n_frames rows of frame_stride
// floats, level l of a frame at img_offsets[l] as a contiguous
// (heights[l], widths[l]) image. best / ys / xs: (n_frames,
// cells_per_frame) device buffers, level l's cells from cell_offsets[l].
// The four tables are host arrays of n_levels ints. Returns the launch's
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int fast_cell_best(const void* img, void* best, void* ys, void* xs,
                              int n_frames, long long frame_stride,
                              int cells_per_frame, int n_levels,
                              const int* heights, const int* widths,
                              const int* img_offsets, const int* cell_offsets,
                              int margin, float th_hi, float th_lo,
                              void* stream) {
  if (n_frames < 1 || n_frames > 65535 || margin < 0 || !(th_hi >= th_lo))
    return static_cast<int>(cudaErrorInvalidValue);
  LevelTable tab;
  const int tiles = make_level_table(tab, n_levels, heights, widths, img_offsets,
                                     cell_offsets);
  if (tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kTileW, kTileH);
  const dim3 grid(tiles, n_frames);
  fast_cell_best_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(best),
      static_cast<int*>(ys), static_cast<int*>(xs), tab, frame_stride,
      cells_per_frame, margin, th_hi, th_lo);
  return static_cast<int>(cudaGetLastError());
}
