// The two measurement probes of the segment-sum design, for Hopper (sm_90a).
//
// They replace the TPU kernels of scripts/probe_segsum.py:
//  * _abt_kernel: A·Bᵀ, contracting the minor axes of two bf16 matrices into
//    f32.  On the TPU it asked whether the matrix unit takes that contraction
//    natively.  On Hopper it does: mma.sync.m16n8k16.row.col takes its A
//    operand row-major (M, K) and its B operand "col", which is an (N, K)
//    matrix stored row-major, so both operands are read as they lie in
//    memory, with no transpose and no staging in shared memory.  A warp owns
//    an 8-column tile of N and a share of K; each thread loads 8 consecutive
//    bf16 of its A row and of its B row with one 16-byte load and feeds them
//    to two k16 steps.  The instruction wants a thread's k slots 2t, 2t+1,
//    2t+8, 2t+9 of a step; the kernel fills them with 4 consecutive columns
//    instead, the same for A and for B, which changes which column meets
//    which slot and not the sum.  M = 8 fills half of the 16-row A fragment:
//    rows 8-15 stay zero and their accumulators are dropped.  The warps of a
//    block add their (8, 8) partial tiles in shared memory in a fixed order,
//    so two launches give the same bits.  The products are exact in f32;
//    the sum is the tensor core's f32 accumulation, in another order than a
//    serial sum.  At the probe's shape, (8, 1536) by (512, 1536), the work is
//    12.6 MFLOP (0.013 us of tensor time) against 1.6 MB: bound by bytes and
//    in practice by the launch.  Where k % 8 != 0 or a matrix is not 16-byte
//    aligned the launcher picks the instantiation with element loads.
//  * _zero_kernel: a grid of nblocks steps, each writing one (w, br) tile of
//    zeros into a (w, nblocks·br) array: the cost of a grid step.  Here one
//    thread block a tile, so it measures what a block costs to schedule
//    beside the bytes it writes.  Bound by bytes: 16-byte stores where
//    br % 4 == 0 (the row stride nblocks·br is then a multiple of 4 floats,
//    so every tile row is 16-byte aligned), 4-byte stores otherwise; a
//    block of (units of a row, rows) threads walks the tile's rows with its
//    columns, with no division anywhere in the kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace tpurt {

constexpr int ABT_WARPS = 8;      // warps of a block, each a share of K
constexpr int ABT_CHUNK = 32;     // columns of K a warp takes at a time: two k16 steps
constexpr int ABT_UNROLL = 3;     // chunks a warp loads before it multiplies
// threads of a zeros_blocks block: at (8, 512) tiles, 1,024 16-byte stores a
// tile, 4 a thread (128 threads with 8 each took 3% longer on an H100: PERF.md)
constexpr int ZERO_THREADS = 256;

// One m16n8k16 step on rows 0-7 of A (rows 8-15 zero); c0, c1 are D's rows
// 0-7, the accumulators of rows 8-15 are dropped.
__device__ __forceinline__ void mma_rows8(float& c0, float& c1, uint32_t a0, uint32_t a2,
                                          uint32_t b0, uint32_t b1) {
  float c2 = 0.0f, c3 = 0.0f;
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// The 8 bf16 of `row` at columns col..col+7 as four packed pairs (the lower
// column in the low half), zeros past k or for a row that does not exist.
template <bool kVec>
__device__ __forceinline__ uint4 load8(const uint16_t* __restrict__ row, bool ok, int col,
                                       int k) {
  if constexpr (kVec) {
    // k % 8 == 0: a thread's 8 columns are all in or all out
    if (!ok || col >= k) return make_uint4(0u, 0u, 0u, 0u);
    return *reinterpret_cast<const uint4*>(row + col);
  } else {
    uint32_t h[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] = (ok && col + j < k) ? row[col + j] : 0u;
    return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                      h[6] | (h[7] << 16));
  }
}

// Block (x, y): out[8y : 8y+8, 8x : 8x+8].  Lane (g, t) = (lane / 4, lane % 4)
// loads A row 8y + g and B row 8x + g at columns kb + 8t .. kb + 8t + 7.
template <bool kVec>
__global__ void __launch_bounds__(ABT_WARPS * 32) abt_kernel(
    const uint16_t* __restrict__ a, const uint16_t* __restrict__ b, float* __restrict__ out,
    int m, int n, int k) {
  __shared__ float part[ABT_WARPS][8][8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = blockIdx.y * 8 + g, col_n = blockIdx.x * 8 + g;
  const uint16_t* ar = a + static_cast<long long>(row < m ? row : 0) * k;
  const uint16_t* br = b + static_cast<long long>(col_n < n ? col_n : 0) * k;
  float c0 = 0.0f, c1 = 0.0f;
  for (int kb = warp * ABT_CHUNK * ABT_UNROLL; kb < k; kb += ABT_WARPS * ABT_CHUNK * ABT_UNROLL) {
    uint4 fa[ABT_UNROLL], fb[ABT_UNROLL];
#pragma unroll
    for (int u = 0; u < ABT_UNROLL; ++u) {
      const int col = kb + u * ABT_CHUNK + 8 * t;
      fa[u] = load8<kVec>(ar, row < m, col, k);
      fb[u] = load8<kVec>(br, col_n < n, col, k);
    }
#pragma unroll
    for (int u = 0; u < ABT_UNROLL; ++u) {
      mma_rows8(c0, c1, fa[u].x, fa[u].y, fb[u].x, fb[u].y);   // columns 8t .. 8t+3
      mma_rows8(c0, c1, fa[u].z, fa[u].w, fb[u].z, fb[u].w);   // columns 8t+4 .. 8t+7
    }
  }
  part[warp][g][2 * t] = c0;
  part[warp][g][2 * t + 1] = c1;
  __syncthreads();
  if (threadIdx.x < 64) {
    const int r = threadIdx.x >> 3, c = threadIdx.x & 7;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < ABT_WARPS; ++w) s += part[w][r][c];   // fixed order
    const int orow = blockIdx.y * 8 + r, ocol = blockIdx.x * 8 + c;
    if (orow < m && ocol < n) out[static_cast<long long>(orow) * n + ocol] = s;
  }
}

// Block x writes the tile out[:, x·br : (x+1)·br] of a (w, gridDim.x·br) array
// as units of T (float4 or float), q units a row: thread (x, y) writes units
// x, x + blockDim.x, ... of rows y, y + blockDim.y, ...; no division.
template <typename T>
__global__ void zeros_blocks_kernel(T* __restrict__ out, int q, int w) {
  const long long stride = static_cast<long long>(gridDim.x) * q;
  T* row = out + static_cast<long long>(blockIdx.x) * q + threadIdx.y * stride;
  const T zero{};
  for (int r = threadIdx.y; r < w; r += blockDim.y, row += blockDim.y * stride)
    for (int c = threadIdx.x; c < q; c += blockDim.x) row[c] = zero;
}

}  // namespace tpurt

extern "C" {

// a (m, k) and b (n, k) bf16 row-major -> out (m, n) f32: 16-byte loads
// where k % 8 == 0 and a, b are 16-byte aligned, element loads otherwise.
// Launches on `stream` and returns cudaGetLastError().
int tpurt_abt(const void* a, const void* b, void* out, int m, int n, int k, void* stream) {
  using namespace tpurt;
  if (m < 1 || n < 1 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = k % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const long long tiles_n = (static_cast<long long>(n) + 7) / 8, tiles_m = (m + 7LL) / 8;
  if (tiles_n > 0x7fffffffLL || tiles_m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles_n), static_cast<unsigned>(tiles_m));
  const auto* ua = static_cast<const uint16_t*>(a);
  const auto* ub = static_cast<const uint16_t*>(b);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    abt_kernel<true><<<grid, ABT_WARPS * 32, 0, s>>>(ua, ub, o, m, n, k);
  else
    abt_kernel<false><<<grid, ABT_WARPS * 32, 0, s>>>(ua, ub, o, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// out (w, nblocks * br) f32 row-major, every tile written by its own block
// of ZERO_THREADS threads; 16-byte stores where br % 4 == 0 (out 16-byte
// aligned).
int tpurt_zeros_blocks(void* out, int nblocks, int br, int w, void* stream) {
  using namespace tpurt;
  if (nblocks < 1 || br < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = br % 4 == 0;
  if (vec && reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // a row's units across x, rows across y
  const int q = vec ? br / 4 : br, tx = q < ZERO_THREADS ? q : ZERO_THREADS;
  const dim3 block(tx, ZERO_THREADS / tx);
  if (vec)
    zeros_blocks_kernel<float4><<<nblocks, block, 0, s>>>(static_cast<float4*>(out), q, w);
  else
    zeros_blocks_kernel<float><<<nblocks, block, 0, s>>>(static_cast<float*>(out), q, w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
