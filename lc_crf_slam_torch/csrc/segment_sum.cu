// Fixed-order segment sum over an edge list:
//   out[t][c] = (((0 + v[e1][c]) + v[e2][c]) + ...)  over the edges
//   e1 < e2 < ... with idx[e] == t,
// one rounded add after another in increasing edge order, the order in
// which `index_add_` adds on the CPU. Targets that no edge hits keep the
// zeros the wrapper allocated.
//
// Replaces no TPU kernel. The reference sums BA's blocks and the pose
// graphs' gradients with XLA's scatter-add; the port summed them with
// `index_add_`, which on the card is a float atomic whose order changes
// from run to run, so two runs of one path parted in the last bits and
// then by keyframes. This kernel makes the order fixed, and the same as
// the CPU's, so a run repeats bit for bit and the card's sums equal the
// plain version's on the same inputs.
//
// Input: the values (E, k), k <= 64, float32 or float64, and a plan that
// plain torch ops build once per index vector (lc_crf_slam_torch/ops/
// segment_sum.py::segment_plan): the stably sorted targets, the edge at
// each sorted position (so a target's run of positions lists its edges
// in increasing order), a head flag at the first position of each run,
// and the end of each position's run.
//
// Two launches on the caller's stream:
//   1. row_flags: one thread per sorted position marks whether its edge's
//      row holds anything but +-0, and each block of kTile positions
//      whether any of its rows does.
//   2. fold: one warp per run head, lanes over the k columns (lane c and
//      c + 32). The warp walks its run in batches of 32 positions: the
//      lanes read 32 flags and edge ids at once, and the values of up to
//      8 edges are loaded before they are added, so the loads overlap.
//      Tiles of kTile positions whose rows are all +-0 are skipped 32
//      tiles at a time.
//
// Why skipping +-0 rows keeps the bits: the sum starts at +0, and in
// round-to-nearest x + y is -0 only when both are -0, so the running sum
// is never -0; then s + (+-0) == s for every s (NaN and inf included).
// A row with a NaN is not all zero and is added in its place.
//
// Every add is __fadd_rn / __dadd_rn: never contracted into an FMA,
// whatever -fmad says, and rounded to nearest as the CPU's add.
//
// What bounds it: the serial chain of adds of the longest run, not bytes.
// Each run is one warp's dependent chain; the runs go in parallel. The
// whole-map BA's invalid edges all target point 0 (~315k of 327k edges
// of a 320-keyframe map), and the tile skip is what keeps that run
// cheap: its rows are zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;     // positions per zero-flag tile = threads of row_flags
constexpr int kWarps = 8;      // warps per block of fold
constexpr int kGroup = 8;      // edge values loaded before they are added
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void row_flags(const T* __restrict__ vals, const int64_t* __restrict__ perm,
                          int64_t E, int k, uint8_t* __restrict__ nz,
                          uint8_t* __restrict__ tile_nz) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  int any = 0;
  if (p < E) {
    const T* row = vals + perm[p] * k;
    for (int c = 0; c < k; ++c) any |= (row[c] != T(0));   // NaN != 0
    nz[p] = static_cast<uint8_t>(any);
  }
  const int tile_any = __syncthreads_or(any);
  if (threadIdx.x == 0) tile_nz[blockIdx.x] = static_cast<uint8_t>(tile_any);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
fold(const T* __restrict__ vals, const int64_t* __restrict__ sorted,
     const int64_t* __restrict__ perm, const uint8_t* __restrict__ head,
     const int64_t* __restrict__ end, const uint8_t* __restrict__ nz,
     const uint8_t* __restrict__ tile_nz, int64_t E, int k, int64_t n,
     T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t h = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (h >= E || !head[h]) return;          // uniform over the warp
  const int64_t t = sorted[h];
  if (t < 0 || t >= n) return;             // the wrapper asks for 0 <= idx < n
  const int64_t stop = end[h];
  const int c0 = lane, c1 = lane + 32;
  T acc0 = T(0), acc1 = T(0);

  int64_t j = h;
  while (j < stop) {
    if (j % kTile == 0) {
      // skip the run of whole all-zero tiles that starts here
      const int64_t tl = j / kTile + lane;
      const bool skip = (tl + 1) * kTile <= stop && !tile_nz[tl];
      const unsigned keep = __ballot_sync(kFull, !skip);
      const int n_skip = keep ? __ffs(keep) - 1 : 32;
      if (n_skip > 0) {
        j += static_cast<int64_t>(n_skip) * kTile;
        continue;
      }
    }
    // one batch: the positions [j, bend) of the aligned 32 from `base`
    const int64_t base = j & ~static_cast<int64_t>(31);
    const int64_t bend = base + 32 < stop ? base + 32 : stop;
    const int64_t p = base + lane;
    long long e = 0;
    bool live = false;
    if (p >= j && p < bend && nz[p]) {
      live = true;
      e = perm[p];
    }
    unsigned m = __ballot_sync(kFull, live);
    while (m) {
      T a0[kGroup], a1[kGroup];
      int cnt = 0;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const bool has = m != 0;
        const int b = has ? __ffs(m) - 1 : 0;
        const long long eb = __shfl_sync(kFull, e, b);
        a0[u] = (has && c0 < k) ? vals[eb * k + c0] : T(0);
        a1[u] = (has && c1 < k) ? vals[eb * k + c1] : T(0);
        if (has) m &= m - 1;
        cnt += has;
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (u < cnt) {
          acc0 = add_rn(acc0, a0[u]);
          acc1 = add_rn(acc1, a1[u]);
        }
      }
    }
    j = bend;
  }
  if (c0 < k) out[t * k + c0] = acc0;
  if (c1 < k) out[t * k + c1] = acc1;
}

template <typename T>
int launch(const void* vals, const void* sorted, const void* perm, const void* head,
           const void* end, int64_t E, int k, int64_t n, void* nz, void* tile_nz,
           void* out, void* stream) {
  if (E <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (E + kTile - 1) / kTile;
  row_flags<T><<<static_cast<unsigned>(tiles), kTile, 0, s>>>(
      static_cast<const T*>(vals), static_cast<const int64_t*>(perm), E, k,
      static_cast<uint8_t*>(nz), static_cast<uint8_t*>(tile_nz));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (E + kWarps - 1) / kWarps;
  fold<T><<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
      static_cast<const T*>(vals), static_cast<const int64_t*>(sorted),
      static_cast<const int64_t*>(perm), static_cast<const uint8_t*>(head),
      static_cast<const int64_t*>(end), static_cast<const uint8_t*>(nz),
      static_cast<const uint8_t*>(tile_nz), E, k, n, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vals (E, k) contiguous; sorted, perm, end (E,) int64; head (E,) uint8;
// nz (E,) and tile_nz (ceil(E / 256),) uint8 scratch; out (n, k) zeros.
// Returns the CUDA error of the launches (0 on success).
extern "C" int segment_sum_f32(const void* vals, const void* sorted, const void* perm,
                               const void* head, const void* end, long long E, int k,
                               long long n, void* nz, void* tile_nz, void* out,
                               void* stream) {
  return launch<float>(vals, sorted, perm, head, end, E, k, n, nz, tile_nz, out, stream);
}

extern "C" int segment_sum_f64(const void* vals, const void* sorted, const void* perm,
                               const void* head, const void* end, long long E, int k,
                               long long n, void* nz, void* tile_nz, void* out,
                               void* stream) {
  return launch<double>(vals, sorted, perm, head, end, E, k, n, nz, tile_nz, out, stream);
}

extern "C" int segment_sum_tile() { return kTile; }
