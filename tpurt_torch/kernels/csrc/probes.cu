// The two measurement probes of the segment-sum design, for Hopper (sm_90a).
//
// They replace the TPU kernels of scripts/probe_segsum.py:
//  * _abt_kernel: A·Bᵀ, contracting the minor axes of two bf16 matrices into
//    f32.  On the TPU it asked whether the matrix unit takes that contraction
//    natively.  Here every product is formed and summed in f32 in the kernel's
//    own body, one thread an output element, the columns in ascending order (a
//    bf16 × bf16 product is exact in f32, so only the order of the sum differs
//    from any other f32 evaluation).  At the probe's shape, (8, 1536) by
//    (512, 1536), it is bound by bytes: 1.6 MB against 12.6 MFLOP.
//  * _zero_kernel: a grid of nblocks steps, each writing one (w, br) tile of
//    zeros into a (w, nblocks·br) array: the cost of a grid step.  Here one
//    thread block a tile, so it measures what a block costs to schedule beside
//    the bytes it writes.  Bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tpurt {

constexpr int PROBE_THREADS = 256;

__global__ void __launch_bounds__(PROBE_THREADS) abt_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    float* __restrict__ out, int m, int n, int k) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(m) * n) return;
  const __nv_bfloat16* ar = a + (e / n) * k;
  const __nv_bfloat16* br = b + (e % n) * k;
  float acc = 0.0f;
  for (int c = 0; c < k; ++c) acc += __bfloat162float(ar[c]) * __bfloat162float(br[c]);
  out[e] = acc;
}

__global__ void __launch_bounds__(PROBE_THREADS) zeros_blocks_kernel(float* __restrict__ out,
                                                                     int br, int w) {
  const long long cols = static_cast<long long>(gridDim.x) * br;
  float* tile = out + static_cast<long long>(blockIdx.x) * br;
  for (int e = threadIdx.x; e < w * br; e += blockDim.x)
    tile[(e / br) * cols + (e % br)] = 0.0f;
}

}  // namespace tpurt

extern "C" {

// a (m, k) and b (n, k) bf16 row-major -> out (m, n) f32.  Launches on
// `stream` and returns cudaGetLastError().
int tpurt_abt(const void* a, const void* b, void* out, int m, int n, int k, void* stream) {
  using namespace tpurt;
  if (m < 1 || n < 1 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (static_cast<long long>(m) * n + PROBE_THREADS - 1) / PROBE_THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  abt_kernel<<<static_cast<unsigned>(blocks), PROBE_THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<float*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// out (w, nblocks * br) f32 row-major, every tile written by its own block.
int tpurt_zeros_blocks(void* out, int nblocks, int br, int w, void* stream) {
  using namespace tpurt;
  if (nblocks < 1 || br < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  zeros_blocks_kernel<<<nblocks, PROBE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), br, w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
