// Sorted-segment row accumulation for Hopper (sm_90a): the sum behind every
// table gather of the clustered backward, and behind the phase-1 backward's
// large tables (megakernel.py: the records route).
//
// Replaces the TPU kernel tpurt/kernels/segsum.py:_segsum_kernel:
//     out[r, :] = sum of upd[n, :] over the n with idx[n] == r,  idx ascending.
// Entries with idx outside [0, n_rows) add nothing and their rows are never
// read; rows with no update are zero; NaN and Inf reach their row.  The TPU
// kernel cuts the OUTPUT into row blocks and sums each block's range of the
// stream by a one-hot matrix product; nothing of that is kept.
//
// What bounds it on an H100: bytes.  One add for each float read; the stream
// (4 B of index, 8 B of position and 4 W B of update an entry) is read once,
// the table written once.
//
// Design.  Run lengths are wildly uneven (a floor's corner or a material
// receives hundreds of thousands of updates, most vertices a handful), so the
// work is cut by equal slices of the STREAM and every thread is busy whatever
// the runs:
//  * the stream is sorted, so its entries in range are one stretch: a 32-way
//    search finds it, and nothing outside it is read (the dropped lanes of a
//    frame's backward are most of some streams);
//  * a persistent grid of seg_blocks_per_sm(W) blocks an SM; block b walks a
//    contiguous range of tiles of SEG_THREADS * seg_items(W) entries, in order;
//  * thread t takes the seg_items(W) consecutive entries t * items .. of a
//    tile and loads their update rows straight into registers, each row
//    once, as wide as its width allows (16 or 8 bytes where W is a multiple
//    of 4 or 2), through `order` where the rows come unsorted (entry i's row
//    is upd[order[i]], so the sorted copy is never written);
//  * a tile's indices are staged in shared memory, one word of padding every
//    32 so that the threads' slices fall on distinct banks.  A pipeline three
//    tiles deep keeps the loads ahead of the sums: while tile t is summed,
//    the indices of tile t + 2 and the update positions of t + 1 are loaded,
//    so t's rows are requested as the tile begins;
//  * the thread sums its entries left to right; a run that begins and ends
//    inside its slice is complete and is written at once;
//  * the slices' open ends are joined by a segmented scan in a fixed tree:
//    shuffles over 1, 2, 4, 8 and 16 lanes inside a warp, then the warps in
//    warp order in shared memory, then the tiles of the block in order (the
//    block's carry).  A thread whose slice closes a run adds the prefix that
//    the scan hands it to the run's head;
//  * a block's first and last run may go on in a neighbouring block: they
//    leave as two (row, partial sum) entries a block, which form a sorted
//    stream of 2 * grid entries.  One block sums that stream in a second
//    launch of the same kernel, where every run is complete.  So a call is
//    one launch (the grid is one block) or two;
//  * in the first launch every entry also zero-fills the rows between its
//    predecessor's index and its own, a warp at a time; a sentinel entry after
//    the last update fills the rows behind it.
// Every output row is therefore written exactly once, with no atomics.
//
// Summation order.  Within a slice, left to right; a run's slices are joined
// by the scan's tree (within a warp, lane l adds the sums of lanes l - 1,
// l - 2, l - 4, l - 8, l - 16 as the Kogge-Stone scan pairs them, the earlier
// operand on the left), the warps of a tile in warp order, the tiles of a
// block in order, and the blocks' partial sums in block order.  That order
// depends only on the stream's indices, W and the card's SM count, so two
// launches give the same bits, and so do the rows read through `order` and a
// sorted copy of them.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace tpurt {

constexpr int SEG_THREADS = 256;
constexpr int SEG_WARPS = SEG_THREADS / 32;
constexpr int SEG_MAX_W = 32;         // tpurt_torch/kernels/segsum.py: MAX_WIDTH

// entries a thread sums in a tile: its rows (items * W floats) stay in registers
__host__ __device__ constexpr int seg_items(int w) {
  return w >= 32 ? 1 : (32 / w > 8 ? 8 : 32 / w);  // segsum.py: items
}

// blocks an SM of the persistent grid: three where the rows are narrow (the
// loads are latency-bound: a third block gave 10-20% on the vertex streams,
// at up to 134 bytes of spills), two for wider rows, whose registers do not
// fit three (segsum.py: blocks_per_sm)
__host__ __device__ constexpr int seg_blocks_per_sm(int w) { return w <= 12 ? 3 : 2; }

// vector width (floats) of a row's loads and stores: rows of W floats start
// at multiples of 16 or 8 bytes where W allows (the base is 16-byte aligned)
template <int W>
__host__ __device__ constexpr int seg_vec() {
  return W % 4 == 0 ? 4 : (W % 2 == 0 ? 2 : 1);
}

template <int W>
__device__ __forceinline__ void load_row(const float* __restrict__ src, float* v) {
  constexpr int V = seg_vec<W>();
  if constexpr (V == 4) {
#pragma unroll
    for (int c = 0; c < W; c += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(src + c));
      v[c] = q.x, v[c + 1] = q.y, v[c + 2] = q.z, v[c + 3] = q.w;
    }
  } else if constexpr (V == 2) {
#pragma unroll
    for (int c = 0; c < W; c += 2) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(src + c));
      v[c] = q.x, v[c + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) v[c] = __ldg(src + c);
  }
}

template <int W>
__device__ __forceinline__ void store_row(float* dst, const float* v) {
  constexpr int V = seg_vec<W>();
  if constexpr (V == 4) {
#pragma unroll
    for (int c = 0; c < W; c += 4)
      *reinterpret_cast<float4*>(dst + c) = make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
  } else if constexpr (V == 2) {
#pragma unroll
    for (int c = 0; c < W; c += 2) *reinterpret_cast<float2*>(dst + c) = make_float2(v[c], v[c + 1]);
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) dst[c] = v[c];
  }
}

// entry g of a stream of n, as a tile sees it: -1 before the stream, INT_MAX
// from its end on (the sentinel, which sorts last)
__device__ __forceinline__ int seg_entry(const int* __restrict__ idx, long long n, long long g) {
  return g < 0 ? -1 : (g < n ? __ldg(idx + g) : INT_MAX);
}

// the first position of a sorted stream of n whose index is >= key, on every
// lane of the warp: a 32-way search, each round one load a lane
__device__ __forceinline__ long long seg_lower_bound(const int* __restrict__ idx, long long n,
                                                     int key) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + lane * step;
    const unsigned ge = __ballot_sync(0xffffffffu, p >= hi || __ldg(idx + p) >= key);
    if (ge == 0u) {
      lo += 31 * step + 1;
    } else {
      const int f = __ffs(ge) - 1;
      hi = lo + f * step < hi ? lo + f * step : hi;
      lo = f == 0 ? hi : lo + (f - 1) * step + 1;
    }
  }
  return lo;
}

// where position p of a tile's indices sits in shared memory: one word of
// padding every 32, so that the threads' slices of consecutive positions
// fall on distinct banks
__device__ __forceinline__ int sp(int p) { return p + (p >> 5); }

// The scan's element: the sum of a stretch of entries' last run, and two
// bits: NE the stretch holds an entry, BND a run begins inside it (at its
// first entry too, unless that entry opens the block's range).
constexpr int NE = 1, BND = 2;

// a then b: b's sum where a run begins in b, else a's and b's added
__device__ __forceinline__ int join_flags(int a, int b) {
  return !(b & NE) ? a : (!(a & NE) ? b : (NE | ((a | b) & BND)));
}

template <int W>
__device__ __forceinline__ void join_into(int fa, const float* a, int fb, float* b) {
  // b := a then b
  if (!(fb & NE)) {
#pragma unroll
    for (int c = 0; c < W; ++c) b[c] = a[c];
  } else if ((fa & NE) && !(fb & BND)) {
#pragma unroll
    for (int c = 0; c < W; ++c) b[c] = a[c] + b[c];
  }
}

// One launch over a sorted stream of n entries (and a sentinel after them
// when `fill`).  `order`: null, or where in upd each entry's row lies.  The
// launch first finds the stretch of entries in range, [skip, skip + live),
// and sums only it: the entries before and after add nothing, and the rows
// they would have left empty are the gaps before its first entry and behind
// the sentinel.  Block b takes the b-th of gridDim.x equal runs of tiles;
// blocks past the last tile leave two empty partial sums of row INT_MAX.  With one block every run is complete; otherwise block b
// leaves its first run's partial sum at part slot 2b and its last run's at
// 2b + 1 (one run that is both leaves slot 2b a zero of the same row).
template <int W>
__global__ void __launch_bounds__(SEG_THREADS, seg_blocks_per_sm(W)) segsum_kernel(
    const int* __restrict__ idx, const float* __restrict__ upd,
    const long long* __restrict__ order, long long n, int n_rows, float* __restrict__ out,
    int* __restrict__ part_idx, float* __restrict__ part_val, int fill) {
  constexpr int K = seg_items(W);
  constexpr int TILE = SEG_THREADS * K;
  __shared__ int s_idx[2][TILE + TILE / 32];  // two tiles' indices at sp(position)
  __shared__ int s_before[2];                 // the index of the entry before each
  __shared__ float s_tot[SEG_WARPS][W];
  __shared__ int s_tot_flags[SEG_WARPS];
  __shared__ float s_pre[SEG_WARPS][W];
  __shared__ int s_pre_flags[SEG_WARPS];
  __shared__ float s_carry[W];
  __shared__ int s_carry_flags;
  __shared__ int s_last_row;  // the index of the block's last entry so far
  __shared__ long long s_span[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = tid * K;  // this thread's slice of every tile
  const bool last_pass = gridDim.x == 1;
  if (warp < 2) {
    const long long b = seg_lower_bound(idx, n, warp == 0 ? 0 : n_rows);
    if (lane == 0) s_span[warp] = b;
  }
  if (tid == 0) s_carry_flags = 0;
  __syncthreads();
  const long long skip = s_span[0], live = s_span[1] - s_span[0];
  idx += skip;
  const long long total = live + (fill ? 1 : 0);
  const long long tiles = (total + TILE - 1) / TILE;
  const long long per = (tiles + gridDim.x - 1) / gridDim.x;
  const long long tile_lo = blockIdx.x * per < tiles ? blockIdx.x * per : tiles;
  const long long tile_hi = tile_lo + per < tiles ? tile_lo + per : tiles;
  // A pipeline of three tiles.  The indices of tile t + 2 are loaded into
  // registers while tile t is summed and stored in t's buffer after it; the
  // update positions (`order`) of this thread's slice of tile t + 1 are
  // loaded then too, from t + 1's buffer; so tile t's rows are read at once.
  int nxt[K], nxt_before = 0;
  long long at_next[K];
  const auto fetch = [&](long long t) {
#pragma unroll
    for (int k = 0; k < K; ++k) nxt[k] = seg_entry(idx, live, t * TILE + tid + k * SEG_THREADS);
    if (tid == 0) nxt_before = seg_entry(idx, live, t * TILE - 1);
  };
  const auto stage = [&](int buf) {
#pragma unroll
    for (int k = 0; k < K; ++k) s_idx[buf][sp(tid + k * SEG_THREADS)] = nxt[k];
    if (tid == 0) s_before[buf] = nxt_before;
  };
  const auto fetch_at = [&](long long t, int buf) {  // positions of the slice's live entries
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long g = t * TILE + j0 + k;
      const int r = s_idx[buf][sp(j0 + k)];
      at_next[k] = (g < live && r >= 0 && r < n_rows)
                       ? (order ? __ldg(order + skip + g) : skip + g) : -1;
    }
  };
  if (tile_lo < tile_hi) {
    fetch(tile_lo);
    stage(0);
    if (tile_lo + 1 < tile_hi) {
      fetch(tile_lo + 1);
      stage(1);
    }
    __syncthreads();
    fetch_at(tile_lo, 0);
  }

  for (long long tile = tile_lo; tile < tile_hi; ++tile) {
    const long long base = tile * TILE;
    const int cnt = static_cast<int>(total - base < TILE ? total - base : TILE);
    const int buf = static_cast<int>((tile - tile_lo) & 1);
    const int* const cur = s_idx[buf];
    __syncthreads();
    long long at[K];
#pragma unroll
    for (int k = 0; k < K; ++k) at[k] = at_next[k];
    if (tile + 2 < tile_hi) fetch(tile + 2);
    if (tile + 1 < tile_hi) fetch_at(tile + 1, buf ^ 1);

    // this thread's slice: rows in registers, then its runs left to right
    const int mine = cnt - j0 < 0 ? 0 : (cnt - j0 < K ? cnt - j0 : K);
    float v[K][W];
    int row[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      row[k] = k < mine ? cur[sp(j0 + k)] : INT_MAX;
      if (at[k] >= 0) {
        load_row<W>(upd + at[k] * W, v[k]);
      } else {
#pragma unroll
        for (int c = 0; c < W; ++c) v[k][c] = 0.0f;
      }
    }
    const bool block_start = tile == tile_lo && tid == 0;
    const int before = j0 == 0 ? s_before[buf] : cur[sp(j0 - 1)];  // the entry before the slice
    const bool left_bnd = mine > 0 && !block_start && row[0] != before;
    bool has_head = false;  // the slice's first run ends inside it, open on the left
    bool any_bnd = left_bnd;
    float head[W], acc[W];
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = v[0][c];
#pragma unroll
    for (int k = 1; k < K; ++k) {
      if (k < mine) {
        if (row[k] != row[k - 1]) {
          if (!any_bnd) {
            has_head = true;
#pragma unroll
            for (int c = 0; c < W; ++c) head[c] = acc[c];
          } else if (row[k - 1] >= 0 && row[k - 1] < n_rows) {
            store_row<W>(out + static_cast<long long>(row[k - 1]) * W, acc);  // complete
          }
          any_bnd = true;
#pragma unroll
          for (int c = 0; c < W; ++c) acc[c] = v[k][c];
        } else {
#pragma unroll
          for (int c = 0; c < W; ++c) acc[c] = acc[c] + v[k][c];
        }
      }
    }

    // inclusive scan of the slices' last runs over the warp
    int flags = (mine > 0 ? NE : 0) | (any_bnd ? BND : 0);
    float s[W];
#pragma unroll
    for (int c = 0; c < W; ++c) s[c] = acc[c];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      float o[W];
      const int of = __shfl_up_sync(0xffffffffu, flags, d);
#pragma unroll
      for (int c = 0; c < W; ++c) o[c] = __shfl_up_sync(0xffffffffu, s[c], d);
      if (lane >= d) {
        join_into<W>(of, o, flags, s);
        flags = join_flags(of, flags);
      }
    }
    // exclusive: the lane before's inclusive value
    int ex_flags = __shfl_up_sync(0xffffffffu, flags, 1);
    float ex[W];
#pragma unroll
    for (int c = 0; c < W; ++c) ex[c] = __shfl_up_sync(0xffffffffu, s[c], 1);
    if (lane == 0) ex_flags = 0;
    if (lane == 31) {
      s_tot_flags[warp] = flags;
#pragma unroll
      for (int c = 0; c < W; ++c) s_tot[warp][c] = s[c];
    }
    __syncthreads();
    // the warps' prefixes in warp order, from the block's carry; column c by
    // thread c, the flags alongside in every one of them
    if (tid < W) {
      int cf = s_carry_flags;
      float cv = s_carry[tid];
      for (int w = 0; w < SEG_WARPS; ++w) {
        s_pre[w][tid] = cv;
        if (tid == 0) s_pre_flags[w] = cf;
        const int tf = s_tot_flags[w];
        const float tv = s_tot[w][tid];
        cv = !(tf & NE) ? cv : ((cf & NE) && !(tf & BND) ? cv + tv : tv);
        cf = join_flags(cf, tf);
      }
      s_carry[tid] = cv;
      if (tid == 0) s_carry_flags = cf;
    }
    if (tid == 0) s_last_row = cur[sp(cnt - 1)];
    __syncthreads();
    // this slice's prefix: the warp's, then the lanes before it in the warp
    int pf = s_pre_flags[warp];
    float pre[W];
#pragma unroll
    for (int c = 0; c < W; ++c) pre[c] = s_pre[warp][c];
    join_into<W>(pf, pre, ex_flags, ex);  // ex := warp prefix then lanes before
    pf = join_flags(pf, ex_flags);

    if (mine > 0 && (left_bnd || has_head)) {
      // the run that the prefix leaves open closes in this slice: at its left
      // edge (the prefix is the whole run), or after its head
      if (has_head) {
        const bool prefix = pf & NE;
#pragma unroll
        for (int c = 0; c < W; ++c) ex[c] = prefix ? ex[c] + head[c] : head[c];
      }
      const int r = left_bnd ? before : row[0];
      if (!(pf & BND) && !last_pass) {
        // the block's first run: its sum goes on to the next launch
        part_idx[2LL * blockIdx.x] = r;
        store_row<W>(part_val + 2LL * blockIdx.x * W, ex);
      } else if (r >= 0 && r < n_rows) {
        store_row<W>(out + static_cast<long long>(r) * W, ex);
      }
    }

    if (fill) {
      // rows between two neighbouring entries' indices have no update: zero
      // them, the 32 lanes of a warp together for each gap its entries own
      for (int p0 = tid - lane; p0 < cnt; p0 += SEG_THREADS) {  // warp-uniform
        const int p = p0 + lane;
        int lo = 0, hi = 0;
        if (p < cnt) {
          const int prev = p == 0 ? s_before[buf] : cur[sp(p - 1)], here = cur[sp(p)];
          lo = prev < 0 ? 0 : (prev >= n_rows ? n_rows : prev + 1);
          hi = here < 0 ? 0 : (here > n_rows ? n_rows : here);
        }
        unsigned gaps = __ballot_sync(0xffffffffu, lo < hi);
        while (gaps) {
          const int owner = __ffs(gaps) - 1;
          gaps &= gaps - 1;
          const long long k0 = static_cast<long long>(__shfl_sync(0xffffffffu, lo, owner)) * W;
          const long long k1 = static_cast<long long>(__shfl_sync(0xffffffffu, hi, owner)) * W;
          for (long long k = k0 + lane; k < k1; k += 32) out[k] = 0.0f;
        }
      }
    }
    __syncthreads();  // every thread is done with this tile's indices
    if (tile + 2 < tile_hi) stage(buf);
  }

  // the block's last run: complete in a single-block launch, else a partial
  // sum for the next launch (with the first run's, where they are one run)
  if (tid < W && tile_lo == tile_hi && !last_pass) {
    part_val[2LL * blockIdx.x * W + tid] = 0.0f;
    part_val[(2LL * blockIdx.x + 1) * W + tid] = 0.0f;
    if (tid == 0) part_idx[2LL * blockIdx.x] = part_idx[2LL * blockIdx.x + 1] = INT_MAX;
  } else if (tid < W && tile_lo < tile_hi) {
    const int r = s_last_row;
    const float cv = s_carry[tid];
    const int cf = s_carry_flags;
    if (last_pass) {
      if (r >= 0 && r < n_rows) out[static_cast<long long>(r) * W + tid] = cv;
    } else {
      const long long slot = 2LL * blockIdx.x;
      part_val[(slot + 1) * W + tid] = cv;
      if (!(cf & BND)) part_val[slot * W + tid] = 0.0f;
      if (tid == 0) {
        part_idx[slot + 1] = r;
        if (!(cf & BND)) part_idx[slot] = r;
      }
    }
  }
}

// blocks of the first launch over n entries of width w (the wrapper's
// segsum.py:pass_plan): one a tile of the stream and its sentinel, at most
// seg_blocks_per_sm(w) an SM
inline int seg_blocks(long long n, int w, int sms) {
  const long long tile = static_cast<long long>(SEG_THREADS) * seg_items(w);
  const long long tiles = (n + 1 + tile - 1) / tile;
  const long long most = static_cast<long long>(seg_blocks_per_sm(w)) * sms;
  return static_cast<int>(tiles < most ? tiles : most);
}

template <int W>
static int segsum_run(const int* idx, const float* upd, const long long* order, long long n,
                      int n_rows, float* out, int* part_idx, float* part_val,
                      long long part_entries, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = seg_blocks(n, W, sms);
  if (blocks > 1 && part_entries < 2LL * blocks) return static_cast<int>(cudaErrorInvalidValue);
  segsum_kernel<W><<<blocks, SEG_THREADS, 0, stream>>>(idx, upd, order, n, n_rows, out, part_idx,
                                                      part_val, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return static_cast<int>(err);
  // the blocks' partial sums, a sorted stream of 2 * blocks entries, in one block
  const long long parts = 2LL * blocks;
  segsum_kernel<W><<<1, SEG_THREADS, 0, stream>>>(part_idx, part_val, nullptr, parts, n_rows, out,
                                                 nullptr, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpurt

extern "C" {

// idx (n,) int32 ascending, upd (n, width) f32, out (n_rows, width) f32, all
// row-major, upd 16-byte aligned; order null (entry i's update is row i) or
// (n,) int64 (it is row order[i]); part_idx (part_entries,) int32 and
// part_val (part_entries, width) f32 hold the blocks' partial sums between
// the two launches (segsum.py:pass_plan).  Launches on `stream` and returns
// the first CUDA error (0 when every launch was accepted).
int tpurt_sorted_segsum(const void* idx, const void* upd, const void* order, long long n,
                        int width, int n_rows, void* out, void* part_idx, void* part_val,
                        long long part_entries, void* stream) {
  using namespace tpurt;
  if (n < 0 || n_rows < 0 || width < 1 || width > SEG_MAX_W || part_entries < 0 ||
      reinterpret_cast<std::uintptr_t>(upd) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define TPURT_SEGSUM_CASE(W)                                                                  \
  case W:                                                                                     \
    return segsum_run<W>(static_cast<const int*>(idx), static_cast<const float*>(upd),        \
                         static_cast<const long long*>(order), n, n_rows,                     \
                         static_cast<float*>(out), static_cast<int*>(part_idx),               \
                         static_cast<float*>(part_val), part_entries,                         \
                         static_cast<cudaStream_t>(stream));
  switch (width) {
    TPURT_SEGSUM_CASE(1) TPURT_SEGSUM_CASE(2) TPURT_SEGSUM_CASE(3) TPURT_SEGSUM_CASE(4)
    TPURT_SEGSUM_CASE(5) TPURT_SEGSUM_CASE(6) TPURT_SEGSUM_CASE(7) TPURT_SEGSUM_CASE(8)
    TPURT_SEGSUM_CASE(9) TPURT_SEGSUM_CASE(10) TPURT_SEGSUM_CASE(11) TPURT_SEGSUM_CASE(12)
    TPURT_SEGSUM_CASE(13) TPURT_SEGSUM_CASE(14) TPURT_SEGSUM_CASE(15) TPURT_SEGSUM_CASE(16)
    TPURT_SEGSUM_CASE(17) TPURT_SEGSUM_CASE(18) TPURT_SEGSUM_CASE(19) TPURT_SEGSUM_CASE(20)
    TPURT_SEGSUM_CASE(21) TPURT_SEGSUM_CASE(22) TPURT_SEGSUM_CASE(23) TPURT_SEGSUM_CASE(24)
    TPURT_SEGSUM_CASE(25) TPURT_SEGSUM_CASE(26) TPURT_SEGSUM_CASE(27) TPURT_SEGSUM_CASE(28)
    TPURT_SEGSUM_CASE(29) TPURT_SEGSUM_CASE(30) TPURT_SEGSUM_CASE(31) TPURT_SEGSUM_CASE(32)
  }
#undef TPURT_SEGSUM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
