// Phase-1 fused L2 backward with the hand-derived adjoint, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpurt/kernels/megabwd.py:_hand_kernel (body
// _tile_l2_hand): per pixel, ONE forward sweep with shadow rays that keeps,
// for every depth, the entry ray, the throughput, (t, u, v), the winner's row,
// the sphere-root selector and the occlusion bits; the L2 error against the
// target, its per-pixel square and the seed 2 e; then one reverse sweep of
// closed-form adjoints (megakernel_adjoint.cuh) down to the camera ray.
//
// What bounds it on an H100: FP32 ALU work, warp divergence and the sums, not
// bytes.  For config 3 at 1080x1920 it reads 12 B a pixel of target and
// writes 4 B of squared error, 33 MB in all; the scene and its cotangent
// tables are 250 floats.
//
// Design: one thread per pixel; a thread's residuals and occlusion bits live
// in the block's shared memory, [depth][thread], max_depth + 1 depths (at most
// MAX_DEPTHS; the wrapper raises beyond it).  The winner's six forms are not
// kept: the reverse sweep evaluates them again from the winner's row.  The
// sphere root is chosen by the saved selector, not by comparing floats.  A
// grid of persistent blocks, as many as the card holds at once (the wrapper
// asks tpurt_l2_hand_occupancy), walks the pixels with a grid-stride loop;
// each warp sums into its own copy of the tables in a fixed order, and each
// block writes the sum of its warps' copies as one row of partials, which
// reduce_rows (megakernel_bwd.cu) adds in block order; a table too large for
// the copies sends its winners' values out as records instead
// (megakernel_adjoint.cuh).  The forward sweep is the forward kernel's
// (phase1_math.cuh), built with -fmad=false and written-out FMA alike.

#include "megakernel_adjoint.cuh"

namespace tpurt {

template <bool kRecords>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) l2_hand(
    Scene s, const float* __restrict__ target, float* __restrict__ sq,
    float* __restrict__ partials, Records recs, Frame f) {
  extern __shared__ float4 smem[];
  const Block b = block_begin<kRecords>(s, f, smem, recs);
  const DeviceGlobals glob{s.glob};
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x; base < f.n_pix;
       base += step) {
    const long long i = base + threadIdx.x;
    const bool valid = i < f.n_pix;
    const CameraRay cam = p1_raygen(glob, f, f.off + static_cast<int>(valid ? i : 0));
    int nd = 0;
    float ca0 = 0.0f, ca1 = 0.0f, ca2 = 0.0f;
    if (valid) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
      nd = sweep_forward<false, true>(s, glob, cam.o, cam.d, f.max_depth, f.shadows, b.occ, THREADS,
                                      b.res, a0, a1, a2);
      const float e0 = clip01(a0) - target[i];
      const float e1 = clip01(a1) - target[f.n_pix + i];
      const float e2 = clip01(a2) - target[2LL * f.n_pix + i];
      sq[i] = e0 * e0 + e1 * e1 + e2 * e2;
      // the clip passes the seed on the closed interval [0, 1]
      ca0 = (a0 >= 0.0f && a0 <= 1.0f) ? 2.0f * e0 : 0.0f;
      ca1 = (a1 >= 0.0f && a1 <= 1.0f) ? 2.0f * e1 : 0.0f;
      ca2 = (a2 >= 0.0f && a2 <= 1.0f) ? 2.0f * e2 : 0.0f;
    }
    sweep_reverse<kRecords>(s, b.tb, b.res, nd, b.occ, THREADS, f.shadows, ca0, ca1, ca2, cam, i);
  }
  tables_end(b.tb, partials);
}

}  // namespace tpurt

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 when both launches
// were accepted); buffers as for tpurt_l2_fused.
int tpurt_l2_hand(const void* tri_forms, const void* sph_forms, const void* attrs,
                  const void* glob, int n_tris, int n_sph, int n_lights, const void* target,
                  void* sq, void* partials, void* out, int blocks, int records,
                   void* key_of, void* rec, int height,
                  int width, float aspect, int max_depth, int shadows, int off, int n_pix,
                  void* stream) {
  using namespace tpurt;
  if (n_pix <= 0 || blocks <= 0 || max_depth + 1 > MAX_DEPTHS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scene s{static_cast<const float4*>(tri_forms), static_cast<const float4*>(sph_forms),
                static_cast<const float*>(attrs), static_cast<const float*>(glob), n_tris, n_sph,
                n_lights};
  const Frame f{height, width, aspect, max_depth, shadows, off, n_pix};
  const int n = copy_floats(n_tris, n_sph, n_lights, records);
  const auto kernel = records ? l2_hand<true> : l2_hand<false>;
  const int smem = allow_shared(kernel, n, max_depth + 1);
  if (smem < 0) return -smem;
  kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<const float*>(target), static_cast<float*>(sq),
      static_cast<float*>(partials),
      Records{static_cast<int*>(key_of), static_cast<float*>(rec)}, f);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return tpurt_reduce_rows(partials, out, blocks, n, stream);
}

// blocks of l2_hand that an SM holds at once with warp copies of n floats, at
// `depths` depths, on the records route or not (megakernel.py:_Tables);
// returns the first CUDA error
int tpurt_l2_hand_occupancy(int n, int depths, int records, int* blocks) {
  using namespace tpurt;
  return occupancy(records ? l2_hand<true> : l2_hand<false>, n, depths, blocks);
}

}  // extern "C"
