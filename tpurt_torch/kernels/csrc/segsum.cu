// Sorted-segment row accumulation for Hopper (sm_90a): the vertex-table sum of
// the clustered backward.
//
// Replaces the TPU kernel tpurt/kernels/segsum.py:_segsum_kernel:
//     out[r, :] = sum of upd[n, :] over the n with idx[n] == r,  idx ascending.
// Entries with idx outside [0, n_rows) add nothing; rows with no update are
// zero.  The TPU kernel cuts the OUTPUT into row blocks and sums each block's
// range of the stream by a one-hot matrix product; nothing of that is kept.
//
// What bounds it on an H100: bytes.  One add for each float read; the stream
// (4 B of index, 8 B of position and 4 W B of update an entry) is read once,
// the table written once.
//
// Design.  Run lengths are wildly uneven (a floor's corner receives hundreds
// of thousands of updates, most vertices a handful), so the work is cut by
// equal slices of the STREAM, never by output row:
//  * a block stages a chunk of SEG_CHUNK consecutive entries in shared memory
//    (rows padded to an odd stride so that threads on neighbouring rows hit
//    different banks).  The updates may come unsorted with `order`, the
//    positions that sort them: entry i's row is then upd[order[i]], read
//    here, so the sorted copy of the stream is never written or read back;
//  * the thread at the first entry of each run sums the run left to right in
//    registers: at most SEG_CHUNK adds a column, whatever the run's full length;
//  * a run that begins and ends inside the chunk is complete and is written
//    to its output row.  The chunk's first and last run may go on in a
//    neighbouring chunk: their sums go out as two (row, partial sum) entries a
//    chunk, which again form a sorted stream, 1/256 as long.  The
//    same kernel sums that stream, until one chunk holds it all; then every
//    run is complete.  The partial sums of a row are added in ascending chunk
//    order.
//  * in the first pass every entry also zero-fills the rows between its
//    predecessor's index and its own, a warp at a time; a sentinel entry after
//    the last update fills the rows behind it.
// Every output row is therefore written exactly once, by one thread or one
// warp, with no atomics: the result is a function of the input alone, bit
// for bit.  A chunk whose entries are all out of range reads no update.

#include <climits>
#include <cuda_runtime.h>

namespace tpurt {

constexpr int SEG_THREADS = 256;
constexpr int SEG_CHUNK = 512;  // tpurt_torch/kernels/segsum.py: CHUNK
constexpr int SEG_MAX_W = 16;   // tpurt_torch/kernels/segsum.py: MAX_WIDTH

// One pass over a sorted stream of n entries (plus a sentinel when `fill`).
// `order`: null, or where in upd each entry's row lies.  `last_pass`: the grid
// is one block, so every run is complete.
template <int W>
__global__ void __launch_bounds__(SEG_THREADS) segsum_pass(
    const int* __restrict__ idx, const float* __restrict__ upd,
    const long long* __restrict__ order, long long n, int n_rows, float* __restrict__ out,
    int* __restrict__ part_idx, float* __restrict__ part_val, int fill, int last_pass) {
  constexpr int STRIDE = W | 1;
  __shared__ int s_idx[SEG_CHUNK];
  __shared__ float s_upd[SEG_CHUNK * STRIDE];
  const long long begin = static_cast<long long>(blockIdx.x) * SEG_CHUNK;
  const long long left = n + (fill ? 1 : 0) - begin;
  const int cnt = static_cast<int>(left < SEG_CHUNK ? left : SEG_CHUNK);  // entries, >= 1
  const int real = (n - begin < cnt) ? static_cast<int>(n - begin) : cnt;  // with an update row

  for (int p = threadIdx.x; p < cnt; p += SEG_THREADS)
    s_idx[p] = p < real ? idx[begin + p] : INT_MAX;  // the sentinel sorts last
  __syncthreads();
  // ascending: the chunk holds an in-range entry iff these two allow one
  const bool any_live = s_idx[0] < n_rows && s_idx[cnt - 1] >= 0;
  if (any_live) {
    for (int k = threadIdx.x; k < real * W; k += SEG_THREADS) {
      const int r = k / W;
      const long long row = order ? order[begin + r] : begin + r;
      s_upd[r * STRIDE + (k % W)] = upd[row * W + (k % W)];
    }
  }
  __syncthreads();

  const int last_row = s_idx[cnt - 1];
  for (int p = threadIdx.x; p < cnt; p += SEG_THREADS) {
    const int row = s_idx[p];
    if (p > 0 && s_idx[p - 1] == row) continue;  // not the first entry of a run
    const bool live = row >= 0 && row < n_rows;
    float acc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = 0.0f;
    if (live) {
      for (int q = p; q < cnt && s_idx[q] == row; ++q) {
#pragma unroll
        for (int w = 0; w < W; ++w) acc[w] += s_upd[q * STRIDE + w];
      }
    }
    const bool head = p == 0, tail = row == last_row;
    if (last_pass || (!head && !tail)) {
      if (live) {
#pragma unroll
        for (int w = 0; w < W; ++w) out[static_cast<long long>(row) * W + w] = acc[w];
      }
      continue;
    }
    // the chunk's first run fills slot 0, its last run slot 1; one run that
    // is both leaves slot 1 a zero of the same row, which adds nothing
    const long long slot = 2LL * blockIdx.x + (head ? 0 : 1);
    part_idx[slot] = row;
#pragma unroll
    for (int w = 0; w < W; ++w) part_val[slot * W + w] = acc[w];
    if (head && tail) {
      part_idx[slot + 1] = row;
#pragma unroll
      for (int w = 0; w < W; ++w) part_val[(slot + 1) * W + w] = 0.0f;
    }
  }

  if (!fill) return;
  // rows between two neighbouring entries' indices have no update: zero them,
  // the 32 lanes of a warp together for each gap that the warp's entries own
  const int lane = threadIdx.x & 31;
  for (int p0 = threadIdx.x - lane; p0 < cnt; p0 += SEG_THREADS) {  // warp-uniform
    const int p = p0 + lane;
    int lo = 0, hi = 0;
    if (p < cnt) {
      const int prev = p > 0 ? s_idx[p - 1] : (begin > 0 ? idx[begin - 1] : -1);
      const int cur = s_idx[p];
      lo = prev < 0 ? 0 : (prev >= n_rows ? n_rows : prev + 1);
      hi = cur < 0 ? 0 : (cur > n_rows ? n_rows : cur);
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

template <int W>
static int segsum_run(const int* idx, const float* upd, const long long* order, long long n,
                      int n_rows, float* out, int* part_idx, float* part_val,
                      long long part_entries, cudaStream_t stream) {
  int fill = 1;
  for (;;) {
    const long long chunks = (n + fill + SEG_CHUNK - 1) / SEG_CHUNK;
    const int last_pass = chunks == 1;
    const long long parts = last_pass ? 0 : 2 * chunks;
    if (chunks > INT_MAX || parts > part_entries) return static_cast<int>(cudaErrorInvalidValue);
    segsum_pass<W><<<static_cast<unsigned>(chunks), SEG_THREADS, 0, stream>>>(
        idx, upd, order, n, n_rows, out, part_idx, part_val, fill, last_pass);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0 || last_pass) return err;
    // the partial sums are the next pass's stream
    idx = part_idx;
    upd = part_val;
    order = nullptr;
    n = parts;
    part_idx += parts;
    part_val += parts * W;
    part_entries -= parts;
    fill = 0;
  }
}

}  // namespace tpurt

extern "C" {

// idx (n,) int32 ascending, upd (n, width) f32, out (n_rows, width) f32, all
// row-major; order null (entry i's update is row i) or (n,) int64 (it is row
// order[i]); part_idx (part_entries,) int32 and part_val (part_entries, width)
// f32 are scratch for the partial sums of every pass but the last
// (segsum.py:pass_plan).  Launches on `stream` and returns the first CUDA
// error (0 when every pass was accepted).
int tpurt_sorted_segsum(const void* idx, const void* upd, const void* order, long long n,
                        int width, int n_rows, void* out, void* part_idx, void* part_val, long long part_entries,
                        void* stream) {
  using namespace tpurt;
  if (n < 0 || n_rows < 0 || width < 1 || width > SEG_MAX_W || part_entries < 0)
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
  }
#undef TPURT_SEGSUM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
