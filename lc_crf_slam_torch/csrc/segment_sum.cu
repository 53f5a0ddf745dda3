// Fixed-order segment sum over an edge list:
//   out[t][c] = (((+0 + v[e1][c]) + v[e2][c]) + ...)  over the edges
//   e1 < e2 < ... with idx[e] == t,
// one rounded add after another in increasing edge order, the order in
// which `index_add_` adds on the CPU. The kernel writes every target,
// the zeros of targets that no edge hits included.
//
// Replaces no TPU kernel. The reference sums BA's blocks and the pose
// graphs' gradients with XLA's scatter-add; on the card `index_add_` is a
// float atomic whose order changes from run to run. This kernel makes the
// order fixed, and the same as the CPU's, so a run repeats bit for bit
// and the card's sums equal the plain version's on the same inputs.
//
// The plan (lc_crf_slam_torch/ops/segment_sum.py::kernel_plan) is built
// once per index vector by torch ops: the stably sorted targets and the
// edge at each sorted position (int32; a target's run of positions lists
// its edges in increasing order), one bit per target that an edge hits,
// and what the path it takes needs. One launch a call, of one of two
// kernels, each a block of 256 threads a tile of up to 256 sorted
// positions:
//
// - `owned_kernel` (E <= 4096 edges: the pose graphs' sums). Block b owns
//   the runs whose head lies in positions [32 b, 32 (b + 1)) and folds
//   each to its end, every row in order: one tile holds them and what they
//   reach past the 32 (a longer reach takes more tiles, the carry kept in
//   shared memory). No block waits on another: the launch and two memory
//   round trips.
// - `tile_kernel` (larger E: BA's sums). One block a tile. A run that
//   crosses tiles is folded tile by tile with a decoupled look-back: each
//   tile publishes its last run's carry (tagged with the call's epoch, so
//   no reset between calls), or "all +-0, pass the carry on" when every
//   row it holds of that run is +-0. A tile that needs a carry reads the
//   status words of the 1024 tiles below it at once, and again from the
//   nearest one that did not pass until that one is published; it folds
//   its non-zero rows, already in shared memory, from that carry: the
//   same chain of adds. Blocks start in index order, so every lower tile
//   has a running or finished block (CUB's single-pass scan relies on the
//   same).
//
// A tile's rows come into shared memory one of two ways. Where its edges
// are consecutive ids (BA's masked slots: most of the whole-map problem's
// rows, all +-0), the plan marks the tile a span: one thread starts one
// bulk copy (cp.async.bulk, Hopper's TMA without a tensor map) of the
// span's 16-byte-aligned middle onto an mbarrier before anything else, the
// ends follow by plain loads, and shared memory is shifted to the span's
// alignment. Else the rows are gathered piece by piece: 16-byte cp.async
// where a row is a multiple of 16 bytes, else 4- or 8-byte loads, eight in
// flight a thread. One lane per (run, column) then folds a run's rows in
// edge order. TMA's tiled copies do not fit the gather: Hopper's TMA has
// no row gather.
//
// Blocks after the work blocks write the zeros of the targets no edge
// hits, 1024 targets a block, with 16-byte stores (a block whose targets
// all have runs writes nothing).
//
// Tried on the H100 and measured slower (PERF.md): several
// consecutive tiles a block in one wave with a ring of two shared-memory
// stages (a block waits for the whole block before it); one wave of blocks
// striding over the tiles with that ring; one warp per 32 owned positions
// holding the rows in registers, and a warp per owned row; 4- and 8-byte
// cp.async for narrow rows; sixteen narrow loads in flight a thread.
//
// Why skipping +-0 rows keeps the bits: the sum starts at +0, and in
// round-to-nearest x + y is -0 only when both are -0, so the running sum
// is never -0; then s + (+-0) == s for every s (NaN and inf included).
// A row with a NaN is not all zero and is added in its place. (The owned
// runs add every row, +-0 ones included: the same bits.)
//
// Every add is __fadd_rn / __dadd_rn: never contracted into an FMA,
// whatever -fmad says, and rounded to nearest as the CPU's add.
//
// What bounds it on this card: bytes for the big sums (every row is read
// once to learn whether it is +-0; W's output, 755 MB of mostly zeros, is
// written once); the launch and two round trips for the small ones,
// whose byte bound is well under a microsecond. Runs whose non-zero rows
// span many tiles wait on each other's carries: the look-back's latency,
// not bytes.
//
// The plan's epoch advances on the host at every launch of `tile_kernel`,
// so such a launch cannot be captured into a CUDA graph and replayed.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// The plan as the wrapper hands it over (ops/segment_sum.py::_Plan); outside
// the anonymous namespace, so the extern "C" entry points that take it are
// exported.
struct SegmentSumPlan {
  const int32_t* perm;      // (E,) the edge at each sorted position
  const int32_t* tgt;       // (E,) the target at each sorted position
  const int32_t* own;       // (2 * owned,) owned runs: [lo, hi) of each block
  const uint64_t* hit;      // (ceil(n / 64),) one bit per target an edge hits
  const int32_t* span;      // (tiles,) tile_kernel: a tile's first edge if its
                            // edges are consecutive ids, else -1
  uint32_t* status;         // (tiles,) look-back: (epoch << 2) | state
  uint64_t* carry;          // (tiles, kCarryWords) look-back: (epoch << 32) | bits
  long long E;
  long long n;
  int tiles;                // tile_kernel: ceil(E / kTile), else 0
  int owned;                // owned_kernel: blocks, else 0
  unsigned epoch;           // tile_kernel launches made, this one included
  int device;
};

namespace {

constexpr int kTile = 256;          // sorted positions per tile
constexpr int kOwn = 32;            // owned runs: positions whose runs a block owns
constexpr int kThreads = 256;       // threads per block: one per position of a tile
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 1024;         // targets per zero-filling block
constexpr int kMaxCols = 64;
constexpr int kCarryWords = 2 * kMaxCols;   // a double takes two tagged words
constexpr int kLookback = 4 * kThreads;     // status words read per scan
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kPass = 1, kCarry = 2, kZeroStart = 3;   // status states
// Polls of a word another block has yet to write before the kernel traps
// (seconds): a fault in the plan ends the launch with an error, never a hang.
constexpr int kMaxPolls = 1 << 23;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The carry of one column as tagged words (a float: one; a double: two).
__device__ __forceinline__ void put_carry(uint64_t* w, int c, uint32_t epoch, float v) {
  st_relaxed(w + c, (uint64_t(epoch) << 32) | __float_as_uint(v));
}
__device__ __forceinline__ void put_carry(uint64_t* w, int c, uint32_t epoch, double v) {
  const uint64_t tag = uint64_t(epoch) << 32;
  st_relaxed(w + 2 * c, tag | uint32_t(__double2loint(v)));
  st_relaxed(w + 2 * c + 1, tag | uint32_t(__double2hiint(v)));
}
__device__ __forceinline__ uint32_t await_word(const uint64_t* w, uint32_t epoch) {
  uint64_t v = ld_relaxed(w);
  for (int polls = 0; uint32_t(v >> 32) != epoch; ++polls) {
    if (polls == kMaxPolls) __trap();
    v = ld_relaxed(w);
  }
  return uint32_t(v);
}
__device__ __forceinline__ void get_carry(const uint64_t* w, int c, uint32_t epoch, float& v) {
  v = __uint_as_float(await_word(w + c, epoch));
}
__device__ __forceinline__ void get_carry(const uint64_t* w, int c, uint32_t epoch, double& v) {
  const uint32_t lo = await_word(w + 2 * c, epoch);
  const uint32_t hi = await_word(w + 2 * c + 1, epoch);
  v = __hiloint2double(int(hi), int(lo));
}

// The zeros of the targets in [slab * kSlab, ...) that no edge hits; every
// thread of the block calls it. `s_hit` holds kSlab / 64 words.
template <typename T>
__device__ void zero_slab(const SegmentSumPlan& P, T* __restrict__ out, int k, int64_t slab,
                          uint64_t* s_hit) {
  const int64_t a = slab * kSlab;
  const int m = static_cast<int>(P.n - a < kSlab ? P.n - a : kSlab);
  const int64_t words = (P.n + 63) / 64;
  const int tid = threadIdx.x;
  if (tid < kSlab / 64) {
    const int64_t wi = a / 64 + tid;
    s_hit[tid] = wi < words ? P.hit[wi] : 0;
  }
  __syncthreads();
  int hits = 0;
#pragma unroll
  for (int w = 0; w < kSlab / 64; ++w) hits += __popcll(s_hit[w]);
  if (hits == m) return;               // every target has its run's sum
  constexpr int kPer = 16 / sizeof(T);
  using V = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
  T* base = out + a * k;               // 16-byte aligned: kSlab * k * sizeof(T)
  const int count = m * k, n_vec = count / kPer;
  auto clear = [&](int u) { return !((s_hit[u >> 6] >> (u & 63)) & 1ull); };
  for (int v = tid; v < n_vec; v += kThreads) {
    const int e = v * kPer;
    bool all = true;
    if (hits) {                        // the targets this vector's elements lie in
      for (int u = e / k, u1 = (e + kPer - 1) / k; u <= u1; ++u) all &= clear(u);
    }
    if (all) {
      reinterpret_cast<V*>(base)[v] = V{};
    } else {
      for (int q = 0; q < kPer; ++q)
        if (clear((e + q) / k)) base[e + q] = T(0);
    }
  }
  for (int e = n_vec * kPer + tid; e < count; e += kThreads)
    if (clear(e / k)) base[e] = T(0);
}

// ---- shared pieces -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One block's bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Copy the rows of `L` sorted positions, gathered through their edge ids
// `perm`, into `rows` (row r at r * row_bytes) in `vec`-byte pieces: by
// 16-byte cp.async (waited for by the caller), or by 4- or 8-byte loads,
// eight in flight a thread. Piece `it` of the tile is piece v of row r; both
// advance by kThreads pieces without a division.
struct Piece {
  int r, v;
  __device__ __forceinline__ void advance(int step_r, int step_v, int per_row) {
    r += step_r;
    v += step_v;
    if (v >= per_row) {
      v -= per_row;
      r += 1;
    }
  }
};

template <typename W>
__device__ __forceinline__ void gather_narrow(const unsigned char* vals, const int32_t* perm,
                                              int items, int per_row, int row_bytes, Piece at,
                                              int step_r, int step_v, unsigned char* rows) {
  constexpr int kInFlight = 8;
  for (int base = threadIdx.x; base < items; base += kInFlight * kThreads) {
    W buf[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (base + u * kThreads < items)
        buf[u] = __ldg(reinterpret_cast<const W*>(
            vals + static_cast<int64_t>(perm[at.r]) * row_bytes + at.v * sizeof(W)));
      at.advance(step_r, step_v, per_row);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int it = base + u * kThreads;
      if (it < items) reinterpret_cast<W*>(rows)[it] = buf[u];
    }
  }
}

__device__ __forceinline__ void gather_rows(const unsigned char* vals, const int32_t* perm, int L,
                                            int row_bytes, int vec, unsigned char* rows) {
  const int per_row = row_bytes / vec, items = L * per_row;
  const int step_r = kThreads / per_row, step_v = kThreads - step_r * per_row;
  Piece at{static_cast<int>(threadIdx.x) / per_row, 0};
  at.v = static_cast<int>(threadIdx.x) - at.r * per_row;
  if (vec == 8) {
    gather_narrow<uint2>(vals, perm, items, per_row, row_bytes, at, step_r, step_v, rows);
  } else if (vec == 4) {
    gather_narrow<uint32_t>(vals, perm, items, per_row, row_bytes, at, step_r, step_v, rows);
  } else {
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const unsigned char* src = vals + static_cast<int64_t>(perm[at.r]) * row_bytes + at.v * 16;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(rows + it * 16)),
                   "l"(__cvta_generic_to_global(src))
                   : "memory");
      at.advance(step_r, step_v, per_row);
    }
  }
}

// Whether a value's bits are anything but +-0 (a NaN is not zero).
__device__ __forceinline__ bool nonzero(float x) { return (__float_as_uint(x) << 1) != 0; }
__device__ __forceinline__ bool nonzero(double x) {
  return (static_cast<uint64_t>(__double_as_longlong(x)) << 1) != 0;
}

// ---- owned runs ------------------------------------------------------------

struct OwnedShared {
  int32_t perm[kTile];
  int32_t tgt[kTile];
  int16_t seg_start[kTile + 1];
  int warp_count[kWarps];
  int prev_tgt, next_tgt;
  uint64_t hit[kSlab / 64];
};

// Exclusive count of `f` over the block's threads (all must call it);
// `total` gets the count over the block.
__device__ __forceinline__ int block_count(bool f, int* warp_count, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned b = __ballot_sync(kFull, f);
  if (lane == 0) warp_count[warp] = __popc(b);
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_count[w];
    before += w < warp ? c : 0;
    all += c;
  }
  __syncthreads();
  total = all;
  return before + __popc(b & ((1u << lane) - 1u));
}

// Block b owns the runs whose head lies in sorted positions [32 b, 32 (b +
// 1)): [lo, hi) from the first head to the end of the last run, in tiles of
// up to 256 positions (one, unless a run reaches further), the carry of a
// run that crosses tiles kept in shared memory. Every row is added.
template <typename T>
__global__ void __launch_bounds__(kThreads)
owned_kernel(SegmentSumPlan P, const T* __restrict__ vals, T* __restrict__ out, int k,
             int vec) {
  extern __shared__ __align__(128) unsigned char rows_raw[];
  __shared__ OwnedShared sh;
  __shared__ T s_carry[kMaxCols];
  const int b = blockIdx.x;
  if (b >= P.owned) {
    zero_slab<T>(P, out, k, static_cast<int64_t>(b) - P.owned, sh.hit);
    return;
  }
  const int tid = threadIdx.x;
  const int row_bytes = k * static_cast<int>(sizeof(T));
  const T* rows = reinterpret_cast<const T*>(rows_raw);
  const int64_t lo = P.own[2 * b], hi = P.own[2 * b + 1];
  for (int64_t p0 = lo; p0 < hi; p0 += kTile) {
    const int L = static_cast<int>(hi - p0 < kTile ? hi - p0 : kTile);
    const T cin = tid < k ? s_carry[tid] : T(0);   // the tile before left it
    if (tid < L) {
      sh.perm[tid] = P.perm[p0 + tid];
      sh.tgt[tid] = P.tgt[p0 + tid];
    }
    if (tid == 0) {
      sh.prev_tgt = p0 > lo ? P.tgt[p0 - 1] : -1;
      sh.next_tgt = p0 + L < hi ? P.tgt[p0 + L] : -1;
    }
    __syncthreads();
    gather_rows(reinterpret_cast<const unsigned char*>(vals), sh.perm, L, row_bytes, vec,
                rows_raw);
    const bool head = tid < L && (tid == 0 || sh.tgt[tid] != sh.tgt[tid - 1]);
    int ns;
    const int seg = block_count(head, sh.warp_count, ns);
    if (head) sh.seg_start[seg] = static_cast<int16_t>(tid);
    if (tid == 0) sh.seg_start[ns] = static_cast<int16_t>(L);
    const bool cont_in = sh.prev_tgt >= 0 && sh.prev_tgt == sh.tgt[0];
    const bool cont_out = sh.next_tgt >= 0 && sh.next_tgt == sh.tgt[L - 1];
    cp_async_wait_all();
    __syncthreads();
    // one thread a (run, column): run s = it / k starts at column it % k
    // (thread c holds column c's carry for run 0)
    for (int it = tid; it < ns * k; it += kThreads) {
      const int s = it / k, c = it - s * k;
      T acc = s == 0 && cont_in ? cin : T(0);
      const int pe = sh.seg_start[s + 1];
#pragma unroll 4
      for (int p = sh.seg_start[s]; p < pe; ++p) acc = add_rn(acc, rows[p * k + c]);
      if (s == ns - 1 && cont_out) {
        s_carry[c] = acc;
      } else {
        const int64_t t = sh.tgt[sh.seg_start[s]];
        if (t >= 0 && t < P.n) out[t * k + c] = acc;
      }
    }
    __syncthreads();   // the next tile reuses the shared memory
  }
}

// ---- tiles with a look-back ----------------------------------------------

struct TileShared {
  int32_t perm[kTile];
  int32_t tgt[kTile];
  int16_t seg_start[kTile + 1];   // the positions where the tile's runs start
  int16_t rank[kTile + 1];        // non-zero rows before each position
  int16_t seg_q[kTile + 1];       // non-zero rows before each run's start
  int32_t seg_t[kTile];           // each run's target
  int16_t live_list[kTile];       // the positions of the non-zero rows
  int warp_count[kWarps];
  int prev_tgt, next_tgt, found;
  uint32_t found_tag;
  uint64_t bar;                   // the bulk copy's barrier
  uint64_t hit[kSlab / 64];
};

// The running sum of column c over the non-zero rows ranked [q0, q1).
template <typename T>
__device__ __forceinline__ T fold(const T* rows, int k, const int16_t* live_list, int q0,
                                  int q1, int c, T acc) {
#pragma unroll 4
  for (int q = q0; q < q1; ++q) acc = add_rn(acc, rows[live_list[q] * k + c]);
  return acc;
}

// The carry into tile `tile` from the tiles before it: the nearest one
// that did not pass holds it (or says it is +0). Every thread calls it;
// threads c < k get column c.
template <typename T>
__device__ T look_back(const SegmentSumPlan& P, int tile, int k, TileShared& sh) {
  const uint32_t pass = (P.epoch << 2) | kPass;
  int hi = tile - 1;
  for (int polls = 0;; ++polls) {
    if (hi < 0) return T(0);   // unreachable: the run's first tile never passes
    if (polls == kMaxPolls) __trap();
    if (threadIdx.x == 0) sh.found = -1;
    __syncthreads();
    uint32_t tags[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = hi - 4 * static_cast<int>(threadIdx.x) - q;
      tags[q] = j >= 0 ? ld_relaxed(P.status + j) : pass;
    }
    int best = -1;
    uint32_t best_tag = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (best < 0 && tags[q] != pass) {
        best = hi - 4 * static_cast<int>(threadIdx.x) - q;
        best_tag = tags[q];
      }
    }
    if (best >= 0) atomicMax(&sh.found, best);
    __syncthreads();
    const int f = sh.found;
    if (best == f) sh.found_tag = best_tag;
    __syncthreads();
    const uint32_t tag = sh.found_tag;
    __syncthreads();      // f and the tag are read before the next round resets them
    if (f < 0) {          // all passed: the run's first tile is further back
      hi -= kLookback;
      continue;
    }
    if ((tag >> 2) != P.epoch) {   // not published yet: the tiles above it all passed
      hi = f;
      __nanosleep(64);
      continue;
    }
    T v = T(0);
    if ((tag & 3u) == kCarry && static_cast<int>(threadIdx.x) < k)
      get_carry(P.carry + static_cast<int64_t>(f) * kCarryWords, threadIdx.x, P.epoch, v);
    return v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_kernel(SegmentSumPlan P, const T* __restrict__ vals, T* __restrict__ out, int k, int vec) {
  extern __shared__ __align__(128) unsigned char rows_raw[];
  __shared__ TileShared sh;
  const int tile = blockIdx.x;
  if (tile >= P.tiles) {
    zero_slab<T>(P, out, k, static_cast<int64_t>(tile) - P.tiles, sh.hit);
    return;
  }
  const int tid = threadIdx.x;
  const int64_t p0 = static_cast<int64_t>(tile) * kTile;
  const int L = static_cast<int>(P.E - p0 < kTile ? P.E - p0 : kTile);
  const int row_bytes = k * static_cast<int>(sizeof(T));
  const unsigned char* src = reinterpret_cast<const unsigned char*>(vals);

  // The rows. Where the tile's edges are consecutive ids (the plan's span:
  // BA's masked slots, most of the whole-map problem) they are one span of
  // memory: thread 0 starts one bulk copy of its 16-byte-aligned middle
  // at once, into shared memory shifted to the span's alignment, and the
  // ends follow by plain loads. Else they are gathered row by row.
  const int sp = P.span[tile];
  const unsigned char* a = src + static_cast<int64_t>(sp >= 0 ? sp : 0) * row_bytes;
  const unsigned char* e = a + static_cast<int64_t>(L) * row_bytes;
  const int shift = sp >= 0 ? static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15) : 0;
  const unsigned char* a16 = a + ((16 - shift) & 15);
  const unsigned char* e16 = e - (reinterpret_cast<uintptr_t>(e) & 15);
  unsigned char* base = rows_raw + shift;        // byte x of the span goes to base + x
  const bool bulk = sp >= 0 && e16 > a16;
  if (tid == 0 && bulk) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&sh.bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bulk_copy(base + (a16 - a), a16, static_cast<uint32_t>(e16 - a16), &sh.bar);
  }
  if (tid < L) {
    sh.perm[tid] = P.perm[p0 + tid];
    sh.tgt[tid] = P.tgt[p0 + tid];
  }
  if (tid == 0) {
    sh.prev_tgt = p0 > 0 ? P.tgt[p0 - 1] : -1;
    sh.next_tgt = p0 + L < P.E ? P.tgt[p0 + L] : -1;
  }
  if (sp >= 0) {
    // the span's ends, 4 bytes a thread (every row is a multiple of 4 bytes)
    const int head = static_cast<int>(bulk ? a16 - a : e - a);
    const int tail = bulk ? static_cast<int>(e - e16) : 0;
    if (4 * tid < head)
      reinterpret_cast<uint32_t*>(base)[tid] = __ldg(reinterpret_cast<const uint32_t*>(a) + tid);
    else if (4 * tid < head + tail)
      reinterpret_cast<uint32_t*>(base + (e16 - a))[tid - head / 4] =
          __ldg(reinterpret_cast<const uint32_t*>(e16) + (tid - head / 4));
  }
  __syncthreads();
  if (sp < 0) gather_rows(src, sh.perm, L, row_bytes, vec, rows_raw);
  const bool head = tid < L && (tid == 0 || sh.tgt[tid] != sh.tgt[tid - 1]);
  int ns;
  const int seg = block_count(head, sh.warp_count, ns);
  if (head) sh.seg_start[seg] = static_cast<int16_t>(tid);
  if (tid == 0) sh.seg_start[ns] = static_cast<int16_t>(L);
  const bool cont_in = sh.prev_tgt >= 0 && sh.prev_tgt == sh.tgt[0];
  const bool cont_out = sh.next_tgt >= 0 && sh.next_tgt == sh.tgt[L - 1];
  cp_async_wait_all();
  if (bulk) bar_wait(&sh.bar, 0);
  __syncthreads();

  // which rows hold anything but +-0: thread r reads row r, from column
  // r % k on, so the lanes of a warp read different banks
  const T* rows = reinterpret_cast<const T*>(rows_raw + shift);
  bool live = false;
  if (tid < L) {
    const T* row = rows + tid * k;
    for (int j = 0, c = tid % k; j < k; ++j, c = c + 1 == k ? 0 : c + 1)
      live |= nonzero(row[c]);
  }
  int n_live;
  const int rank = block_count(live, sh.warp_count, n_live);
  if (tid < L) sh.rank[tid] = static_cast<int16_t>(rank);
  if (live) sh.live_list[rank] = static_cast<int16_t>(tid);
  if (tid == 0) sh.rank[L] = static_cast<int16_t>(n_live);
  __syncthreads();
  for (int s = tid; s <= ns; s += kThreads)   // ns + 1 entries: up to one past the threads
    sh.seg_q[s] = sh.rank[sh.seg_start[s]];
  if (tid < ns) sh.seg_t[tid] = sh.tgt[sh.seg_start[tid]];
  __syncthreads();

  const bool one_run = ns == 1;
  auto q_begin = [&](int s) { return static_cast<int>(sh.seg_q[s]); };
  auto q_end = [&](int s) { return static_cast<int>(sh.seg_q[s + 1]); };
  uint64_t* my_carry = P.carry + static_cast<int64_t>(tile) * kCarryWords;
  const uint32_t tag = P.epoch << 2;

  // (a) the last run starts in the tile and goes on after it: its carry
  // from +0 needs nothing before, so it goes out first
  if (cont_out && !(cont_in && one_run)) {
    const int s = ns - 1;
    const int q0 = q_begin(s), q1 = q_end(s);
    if (q0 == q1) {
      if (tid == 0) st_relaxed(P.status + tile, tag | kZeroStart);
    } else {
      if (tid < k)
        put_carry(my_carry, tid, P.epoch, fold(rows, k, sh.live_list, q0, q1, tid, T(0)));
      if (tid == 0) st_relaxed(P.status + tile, tag | kCarry);
    }
  }

  // (b) the runs that start and end in the tile: one thread a (run,
  // column), a run's columns on consecutive threads
  const int sb = cont_in ? 1 : 0, se = cont_out ? ns - 1 : ns;
  const int n_items = se > sb ? (se - sb) * k : 0;
  for (int it = tid; it < n_items; it += kThreads) {
    const int s = sb + it / k, c = it - (it / k) * k;
    const T acc = fold(rows, k, sh.live_list, q_begin(s), q_end(s), c, T(0));
    const int64_t t = sh.seg_t[s];
    if (t >= 0 && t < P.n) out[t * k + c] = acc;
  }

  // (c) the first run, which began before the tile
  if (cont_in) {
    const int q0 = q_begin(0), q1 = q_end(0);
    const bool goes_on = cont_out && one_run;
    if (q0 == q1 && goes_on) {   // all +-0 here: pass the carry on
      if (tid == 0) st_relaxed(P.status + tile, tag | kPass);
    } else {
      const T cin = look_back<T>(P, tile, k, sh);
      if (tid < k) {
        const T acc = fold(rows, k, sh.live_list, q0, q1, tid, cin);
        if (goes_on) {
          put_carry(my_carry, tid, P.epoch, acc);
        } else {
          const int64_t t = sh.tgt[0];
          if (t >= 0 && t < P.n) out[t * k + tid] = acc;
        }
      }
      if (goes_on && tid == 0) st_relaxed(P.status + tile, tag | kCarry);
    }
  }
}

template <typename T>
int launch(SegmentSumPlan* plan, const void* vals, void* out, int k, void* stream) {
  static int raised[2][64] = {};   // each kernel's dynamic shared-memory limit, per device
  const int row_bytes = k * static_cast<int>(sizeof(T));
  const uintptr_t addr = reinterpret_cast<uintptr_t>(vals);
  int vec = static_cast<int>(sizeof(T));
  if (row_bytes % 16 == 0 && addr % 16 == 0) vec = 16;
  else if (row_bytes % 8 == 0 && addr % 8 == 0) vec = 8;
  const int dev = plan->device;
  if (dev < 0 || dev >= 64 || k < 1 || k > kMaxCols || addr % sizeof(T))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tiles = plan->tiles > 0;
  // rows of a tile, and 16 bytes to shift a span to its alignment
  const int smem = kTile * row_bytes + 16;
  const long long grid = (tiles ? plan->tiles : plan->owned) + (plan->n + kSlab - 1) / kSlab;
  int cur = 0;
  cudaGetDevice(&cur);
  if (cur != dev) cudaSetDevice(dev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = grid > 0x7fffffffLL ? cudaErrorInvalidConfiguration : cudaSuccess;
  int& limit = raised[tiles][dev];
  if (err == cudaSuccess && smem > 48 * 1024 && smem > limit) {
    err = tiles ? cudaFuncSetAttribute(tile_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
                : cudaFuncSetAttribute(owned_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) limit = smem;
  }
  if (err == cudaSuccess && grid > 0) {
    if (tiles) {
      if (plan->epoch >= (1u << 30) - 1) {   // the status tags would wrap: start over
        cudaMemsetAsync(plan->status, 0, sizeof(uint32_t) * plan->tiles, s);
        cudaMemsetAsync(plan->carry, 0, sizeof(uint64_t) * kCarryWords * plan->tiles, s);
        plan->epoch = 0;
      }
      plan->epoch += 1;
      tile_kernel<T><<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
          *plan, static_cast<const T*>(vals), static_cast<T*>(out), k, vec);
    } else {
      owned_kernel<T><<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
          *plan, static_cast<const T*>(vals), static_cast<T*>(out), k, vec);
    }
    err = cudaGetLastError();
  }
  if (cur != dev) cudaSetDevice(cur);
  return static_cast<int>(err);
}

}  // namespace

// vals (E, k) contiguous on the plan's device, 1 <= k <= 64; out (n, k)
// of the same type, uninitialised: the kernel writes every element. One
// launch on `stream`; returns its CUDA error (0 on success).
extern "C" int segment_sum_f32(SegmentSumPlan* plan, const void* vals, void* out, int k,
                               void* stream) {
  return launch<float>(plan, vals, out, k, stream);
}

extern "C" int segment_sum_f64(SegmentSumPlan* plan, const void* vals, void* out, int k,
                               void* stream) {
  return launch<double>(plan, vals, out, k, stream);
}

// The constants the wrapper's plan must agree with.
extern "C" int segment_sum_tile() { return kTile; }
extern "C" int segment_sum_owned() { return kOwn; }
extern "C" int segment_sum_plan_bytes() { return static_cast<int>(sizeof(SegmentSumPlan)); }
