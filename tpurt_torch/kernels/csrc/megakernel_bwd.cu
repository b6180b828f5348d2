// Phase-1 replay backward and fused L2 kernel for Hopper (sm_90a), and the
// kernel that adds the blocks' partial rows.
//
// megakernel_bwd replaces the TPU kernel tpurt/kernels/megakernel.py:_bwd_kernel:
// from the occlusion records of an earlier forward and an image cotangent g it
// replays the forward without shadow rays (closest hit at every depth, the
// shading at the recorded visibility), keeps each depth's residuals in the
// block's shared memory, and sweeps back (megakernel_adjoint.cuh) to the
// summed cotangents of globals, triangle forms, sphere forms and attributes.
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
// What bounds them on an H100: FP32 ALU work and warp divergence, not bytes.
// For config 3 at 1080x1920 a launch reads 12 B a pixel of g or target (and
// 12 B of records) and writes at most 4 B; the scene and its cotangent tables
// are 250 floats.  The sums of the reverse sweep cost about four passes of a
// warp's scratch a depth (megakernel_adjoint.cuh).
//
// Design: a grid of persistent blocks, as many as the card holds at once
// (tpurt_*_occupancy), with a grid-stride loop over the pixels, one thread per
// pixel, its residuals in the block's shared memory; each warp sums into its
// own copy of the tables in a fixed order, each block writes the sum of its
// warps' copies as one row of partials, and reduce_rows adds the rows in
// block order (the TPU's grid ran in order and added into one resident
// block).  Tables too large for the copies take the records route: the
// winners' values leave as records that the sorted segment sum adds by
// winner (megakernel_adjoint.cuh).  The replay is the forward's own body
// (phase1_math.cuh: written-out FMA, -fmad=false), so it equals the forward
// bit for bit.

#include "megakernel_adjoint.cuh"

namespace tpurt {

template <bool kRecords>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) megakernel_bwd(
    Scene s, const int* __restrict__ occ, const float* __restrict__ g,
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
    const int* rec = occ + (valid ? i : 0);
    int nd = 0;
    float ca0 = 0.0f, ca1 = 0.0f, ca2 = 0.0f;
    if (valid) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
      nd = sweep_forward<true, true>(s, glob, cam.o, cam.d, f.max_depth, f.shadows,
                                     const_cast<int*>(rec), f.n_pix, b.res, a0, a1, a2);
      // the clip passes the cotangent on the closed interval [0, 1]
      ca0 = (a0 >= 0.0f && a0 <= 1.0f) ? g[i] : 0.0f;
      ca1 = (a1 >= 0.0f && a1 <= 1.0f) ? g[f.n_pix + i] : 0.0f;
      ca2 = (a2 >= 0.0f && a2 <= 1.0f) ? g[2LL * f.n_pix + i] : 0.0f;
    }
    sweep_reverse<kRecords>(s, b.tb, b.res, nd, rec, f.n_pix, f.shadows, ca0, ca1, ca2, cam, i);
  }
  tables_end(b.tb, partials);
}

template <bool kRecords>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) l2_fused(
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
      // the forward: colour and occlusion bits, nothing else kept
      float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
      sweep_forward<false, false>(s, glob, cam.o, cam.d, f.max_depth, f.shadows, b.occ, THREADS,
                                  nullptr, c0, c1, c2);
      const float e0 = clip01(c0) - target[i];
      const float e1 = clip01(c1) - target[f.n_pix + i];
      const float e2 = clip01(c2) - target[2LL * f.n_pix + i];
      sq[i] = e0 * e0 + e1 * e1 + e2 * e2;
      // the replay at the bits just recorded
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
      nd = sweep_forward<true, true>(s, glob, cam.o, cam.d, f.max_depth, f.shadows, b.occ, THREADS,
                                     b.res, a0, a1, a2);
      ca0 = (a0 >= 0.0f && a0 <= 1.0f) ? 2.0f * e0 : 0.0f;
      ca1 = (a1 >= 0.0f && a1 <= 1.0f) ? 2.0f * e1 : 0.0f;
      ca2 = (a2 >= 0.0f && a2 <= 1.0f) ? 2.0f * e2 : 0.0f;
    }
    sweep_reverse<kRecords>(s, b.tb, b.res, nd, b.occ, THREADS, f.shadows, ca0, ca1, ca2, cam, i);
  }
  tables_end(b.tb, partials);
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
// launches were accepted).  The caller allocates partials (blocks, n) f32 and
// out (n,) f32, with n = 15 + 6 L + 12 T + 8 S + 35 (T + S), the whole
// table, or on the records route n = 15 + 6 L, its globals; then also
// key_of ((max_depth + 1) n_pix,) int32, filled with T + S, and rec
// ((max_depth + 1) n_pix, 32) f32; sq (n_pix,) f32.

int tpurt_megakernel_bwd(const void* tri_forms, const void* sph_forms, const void* attrs,
                         const void* glob, int n_tris, int n_sph, int n_lights, const void* occ,
                         const void* g, void* partials, void* out, int blocks, int records,
                         void* key_of, void* rec, int height, int width, float aspect,
                         int max_depth, int shadows, int off, int n_pix, void* stream) {
  using namespace tpurt;
  if (n_pix <= 0 || blocks <= 0 || max_depth + 1 > MAX_DEPTHS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scene s{static_cast<const float4*>(tri_forms), static_cast<const float4*>(sph_forms),
                static_cast<const float*>(attrs), static_cast<const float*>(glob), n_tris, n_sph,
                n_lights};
  const Frame f{height, width, aspect, max_depth, shadows, off, n_pix};
  const int n = copy_floats(n_tris, n_sph, n_lights, records);
  const auto kernel = records ? megakernel_bwd<true> : megakernel_bwd<false>;
  const int smem = allow_shared(kernel, n, max_depth + 1);
  if (smem < 0) return -smem;
  kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<const int*>(occ), static_cast<const float*>(g),
      static_cast<float*>(partials),
      Records{static_cast<int*>(key_of), static_cast<float*>(rec)}, f);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return tpurt_reduce_rows(partials, out, blocks, n, stream);
}

int tpurt_l2_fused(const void* tri_forms, const void* sph_forms, const void* attrs,
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
  const auto kernel = records ? l2_fused<true> : l2_fused<false>;
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

// blocks of each kernel that an SM holds at once with warp copies of n
// floats, at `depths` depths, on the records route or not
// (megakernel.py:_Tables); each returns the first CUDA error
int tpurt_megakernel_bwd_occupancy(int n, int depths, int records, int* blocks) {
  using namespace tpurt;
  return occupancy(records ? megakernel_bwd<true> : megakernel_bwd<false>, n, depths, blocks);
}

int tpurt_l2_fused_occupancy(int n, int depths, int records, int* blocks) {
  using namespace tpurt;
  return occupancy(records ? l2_fused<true> : l2_fused<false>, n, depths, blocks);
}

// the records route's map (megakernel.py:record_map): dst[R_ALL * win + slot]
// = the table index of slot `slot` of winner `win` (winner_addr), -1 where a
// sphere has no such slot, for the n_tris + n_sph winners; returns R_ALL
int tpurt_record_map(int n_tris, int n_sph, int n_lights, int* dst) {
  using namespace tpurt;
  const int off_tri = NGLOB_BASE + 6 * n_lights, off_sph = off_tri + 12 * n_tris;
  const int off_attr = off_sph + 8 * n_sph;
  for (int win = 0; win < n_tris + n_sph; ++win)
    for (int slot = 0; slot < R_ALL; ++slot)
      dst[R_ALL * win + slot] = winner_addr(n_tris, off_tri, off_sph, off_attr, slot, win);
  return R_ALL;
}

// the dynamic shared memory of a block (megakernel.py:phase1_shared_bytes)
long long tpurt_phase1_shared_bytes(int n, int depths, int fixed) {
  return tpurt::phase1_shared_bytes(n, depths, fixed);
}

// the current card's shared memory: an SM's, the most a block may ask for,
// and what the runtime keeps back of an SM for each block
int tpurt_shared_limits(int* per_sm, int* per_block, int* reserved) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  return static_cast<int>(err);
}

}  // extern "C"
