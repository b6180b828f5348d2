// Phase-1 forward megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel tpurt/kernels/megakernel.py:_fwd_kernel (body
// _tile_color): per pixel, ray-gen -> closest hit over every triangle
// (Baldwin-Weber forms) and sphere (form-based quadratic), lowest index wins
// -> Phong with one binary shadow any-hit per light -> Whitted loop to
// max_depth weighted by reflectivity -> clip to [0, 1].  The per-pixel body is
// sweep_forward in megakernel_common.cuh, shared with the backward kernels.
//
// What bounds it on an H100: FP32 ALU work and warp divergence, not bytes.
// For config 3 at 1080x1920 the outputs are 2.07 M px x (12 + 12) B, about
// 50 MB a frame, and the packed scene is a few hundred bytes; each pixel
// runs up to 3 closest-hit and 6 shadow passes over 5 primitives.
//
// Design:
// * One thread per pixel on a 1-D grid over n_pix, masked at the ragged
//   end; the TPU kernel's tile padding is gone.
// * Dead rays exit per thread (in place of the TPU's tile-level lax.cond
//   skips), and a shadow test returns at the first occluder.
// * Staging primitives in shared memory is a lever for a later change; at
//   the phase-1 limit (4096 tris x 48 B + 4096 spheres x 32 B) the tables
//   exceed the 227 KB a block can use, so it needs chunks.
// * Built with -fmad=false (see megakernel_common.cuh); contracting to FMA
//   is a lever for a later change.

#include "megakernel_common.cuh"

namespace tpurt {

__global__ void __launch_bounds__(THREADS) megakernel_fwd(Scene s, float* __restrict__ colour,
                                                          int* __restrict__ occ, Frame f) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= f.n_pix) return;
  const CameraRay r = raygen(s, f, f.off + i);
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  sweep_forward<false, false>(s, r.o, r.d, f.max_depth, f.shadows, occ + i, f.n_pix, nullptr,
                              acc0, acc1, acc2);
  colour[i] = clip01(acc0);
  colour[f.n_pix + i] = clip01(acc1);
  colour[2LL * f.n_pix + i] = clip01(acc2);
}

}  // namespace tpurt

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted).  Outputs colour (3, n_pix) f32 and occ (max_depth + 1, n_pix)
// i32 are allocated by the caller.
int tpurt_megakernel_fwd(const void* tri_forms, const void* sph_forms, const void* attrs,
                         const void* glob, int n_tris, int n_sph, int n_lights, void* colour,
                         void* occ, int height, int width, float aspect, int max_depth,
                         int shadows, int off, int n_pix, void* stream) {
  using namespace tpurt;
  if (n_pix <= 0) return static_cast<int>(cudaSuccess);
  const Scene s{static_cast<const float4*>(tri_forms), static_cast<const float4*>(sph_forms),
                static_cast<const float*>(attrs), static_cast<const float*>(glob), n_tris, n_sph,
                n_lights};
  const Frame f{height, width, aspect, max_depth, shadows, off, n_pix};
  const int blocks = (n_pix + THREADS - 1) / THREADS;
  megakernel_fwd<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<float*>(colour), static_cast<int*>(occ), f);
  return static_cast<int>(cudaGetLastError());
}

const char* tpurt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
