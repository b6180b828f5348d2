// Phase-1 replay backward and fused L2 kernel for Hopper (sm_90a), and the
// kernel that adds the blocks' partial rows.
//
// megakernel_bwd replaces the TPU kernel tpurt/kernels/megakernel.py:_bwd_kernel:
// from the occlusion records of an earlier forward and an image cotangent g it
// replays the forward without shadow rays (closest hit at every depth, the
// shading at the recorded visibility), keeps each depth's residuals in the
// thread, and sweeps back (megakernel_adjoint.cuh) to the summed cotangents of
// globals, triangle forms, sphere forms and attributes.
//
// l2_fused replaces tpurt/kernels/megakernel.py:_fused_kernel: in one launch,
// the forward with shadow rays (the body of megakernel_fwd.cu, which keeps
// nothing but the occlusion bits), the L2 error against the target, its
// per-pixel square and the seed 2 e, then the same replay and reverse sweep.
// It intersects every depth twice and keeps no residual across the two; the
// hand-adjoint kernel (megabwd_hand.cu) makes one sweep and keeps them.  On
// the TPU the two differ in how the adjoint was obtained (jax.vjp against a
// hand derivation); CUDA has no vjp, so here they differ in what they keep.
//
// What bounds them on an H100: FP32 ALU work, warp divergence and the sums,
// not bytes.  For config 3 at 1080x1920 a launch reads 12 B a pixel of g or
// target (and 12 B of records) and writes at most 4 B; the scene and its
// cotangent tables are 250 floats.  Per pixel and depth the reverse sweep
// runs about 40 warp sums of 5 shuffles each.
//
// Design: a fixed grid of persistent blocks with a grid-stride loop over the
// pixels, one thread per pixel; each block sums into shared memory and writes
// one row of partials; reduce_rows adds the rows in a fixed order (the TPU's
// grid ran in order and added into one resident block).  Tables that do not
// fit shared memory are summed with atomicAdd in device memory.  Built with
// -fmad=false so that the replay equals the forward bit for bit.

#include "megakernel_adjoint.cuh"

namespace tpurt {

__global__ void __launch_bounds__(THREADS) megakernel_bwd(
    Scene s, const int* __restrict__ occ, const float* __restrict__ g,
    float* __restrict__ partials, int use_shared, Frame f) {
  extern __shared__ float smem[];
  const Tables tb = tables_begin(s, smem, partials, use_shared);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x; base < f.n_pix;
       base += step) {
    const long long i = base + threadIdx.x;
    const bool valid = i < f.n_pix;
    const CameraRay cam = raygen(s, f, f.off + static_cast<int>(valid ? i : 0));
    Residual res[MAX_DEPTHS];
    const int* rec = occ + (valid ? i : 0);
    int nd = 0;
    float ca0 = 0.0f, ca1 = 0.0f, ca2 = 0.0f;
    if (valid) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
      nd = sweep_forward<true, true>(s, cam.o, cam.d, f.max_depth, f.shadows,
                                     const_cast<int*>(rec), f.n_pix, res, a0, a1, a2);
      // the clip passes the cotangent on the closed interval [0, 1]
      ca0 = (a0 >= 0.0f && a0 <= 1.0f) ? g[i] : 0.0f;
      ca1 = (a1 >= 0.0f && a1 <= 1.0f) ? g[f.n_pix + i] : 0.0f;
      ca2 = (a2 >= 0.0f && a2 <= 1.0f) ? g[2LL * f.n_pix + i] : 0.0f;
    }
    sweep_reverse(s, tb, res, nd, rec, f.n_pix, f.shadows, ca0, ca1, ca2, cam);
  }
  tables_end(tb, partials, use_shared);
}

__global__ void __launch_bounds__(THREADS) l2_fused(
    Scene s, const float* __restrict__ target, float* __restrict__ sq,
    float* __restrict__ partials, int use_shared, Frame f) {
  extern __shared__ float smem[];
  const Tables tb = tables_begin(s, smem, partials, use_shared);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x; base < f.n_pix;
       base += step) {
    const long long i = base + threadIdx.x;
    const bool valid = i < f.n_pix;
    const CameraRay cam = raygen(s, f, f.off + static_cast<int>(valid ? i : 0));
    Residual res[MAX_DEPTHS];
    int occ[MAX_DEPTHS];
    int nd = 0;
    float ca0 = 0.0f, ca1 = 0.0f, ca2 = 0.0f;
    if (valid) {
      // the forward: colour and occlusion bits, nothing else kept
      float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
      sweep_forward<false, false>(s, cam.o, cam.d, f.max_depth, f.shadows, occ, 1, nullptr, c0,
                                  c1, c2);
      const float e0 = clip01(c0) - target[i];
      const float e1 = clip01(c1) - target[f.n_pix + i];
      const float e2 = clip01(c2) - target[2LL * f.n_pix + i];
      sq[i] = e0 * e0 + e1 * e1 + e2 * e2;
      // the replay at the bits just recorded
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
      nd = sweep_forward<true, true>(s, cam.o, cam.d, f.max_depth, f.shadows, occ, 1, res, a0,
                                     a1, a2);
      ca0 = (a0 >= 0.0f && a0 <= 1.0f) ? 2.0f * e0 : 0.0f;
      ca1 = (a1 >= 0.0f && a1 <= 1.0f) ? 2.0f * e1 : 0.0f;
      ca2 = (a2 >= 0.0f && a2 <= 1.0f) ? 2.0f * e2 : 0.0f;
    }
    sweep_reverse(s, tb, res, nd, occ, 1, f.shadows, ca0, ca1, ca2, cam);
  }
  tables_end(tb, partials, use_shared);
}

// out[j] = partials[0][j] + partials[1][j] + ... in row order
__global__ void __launch_bounds__(THREADS) reduce_rows(const float* __restrict__ partials,
                                                       float* __restrict__ out, int rows, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float sum = 0.0f;
  for (int r = 0; r < rows; ++r) sum += partials[static_cast<long long>(r) * n + j];
  out[j] = sum;
}

}  // namespace tpurt

extern "C" {

int tpurt_reduce_rows(const void* partials, void* out, int rows, int n, void* stream) {
  using namespace tpurt;
  reduce_rows<<<(n + THREADS - 1) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), static_cast<float*>(out), rows, n);
  return static_cast<int>(cudaGetLastError());
}

// Each launches on `stream` and returns the first CUDA error (0 when both
// launches were accepted).  The caller allocates: partials, (blocks, n) f32
// when use_shared, else one zeroed row (1, n); out (n,) f32, with
// n = 15 + 6 L + 12 T + 8 S + 35 (T + S); sq (n_pix,) f32.

int tpurt_megakernel_bwd(const void* tri_forms, const void* sph_forms, const void* attrs,
                         const void* glob, int n_tris, int n_sph, int n_lights, const void* occ,
                         const void* g, void* partials, void* out, int blocks, int use_shared,
                         int height, int width, float aspect, int max_depth, int shadows, int off,
                         int n_pix, void* stream) {
  using namespace tpurt;
  if (n_pix <= 0 || blocks <= 0 || max_depth + 1 > MAX_DEPTHS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scene s{static_cast<const float4*>(tri_forms), static_cast<const float4*>(sph_forms),
                static_cast<const float*>(attrs), static_cast<const float*>(glob), n_tris, n_sph,
                n_lights};
  const Frame f{height, width, aspect, max_depth, shadows, off, n_pix};
  const int n = table_floats(n_tris, n_sph, n_lights);
  const size_t smem = use_shared ? sizeof(float) * n : 0;
  megakernel_bwd<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<const int*>(occ), static_cast<const float*>(g),
      static_cast<float*>(partials), use_shared, f);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return tpurt_reduce_rows(partials, out, use_shared ? blocks : 1, n, stream);
}

int tpurt_l2_fused(const void* tri_forms, const void* sph_forms, const void* attrs,
                   const void* glob, int n_tris, int n_sph, int n_lights, const void* target,
                   void* sq, void* partials, void* out, int blocks, int use_shared, int height,
                   int width, float aspect, int max_depth, int shadows, int off, int n_pix,
                   void* stream) {
  using namespace tpurt;
  if (n_pix <= 0 || blocks <= 0 || max_depth + 1 > MAX_DEPTHS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scene s{static_cast<const float4*>(tri_forms), static_cast<const float4*>(sph_forms),
                static_cast<const float*>(attrs), static_cast<const float*>(glob), n_tris, n_sph,
                n_lights};
  const Frame f{height, width, aspect, max_depth, shadows, off, n_pix};
  const int n = table_floats(n_tris, n_sph, n_lights);
  const size_t smem = use_shared ? sizeof(float) * n : 0;
  l2_fused<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<const float*>(target), static_cast<float*>(sq),
      static_cast<float*>(partials), use_shared, f);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return tpurt_reduce_rows(partials, out, use_shared ? blocks : 1, n, stream);
}

}  // extern "C"
