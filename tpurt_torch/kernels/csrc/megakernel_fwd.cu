// Phase-1 forward megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel tpurt/kernels/megakernel.py:_fwd_kernel (body
// _tile_color): per pixel, ray-gen -> closest hit over every triangle
// (Baldwin-Weber forms) and sphere (form-based quadratic), lowest index wins
// -> Phong with one binary shadow any-hit per light -> Whitted loop to
// max_depth weighted by reflectivity -> clip to [0, 1].  The per-pixel body is
// sweep_forward in phase1_math.cuh, shared with the backward kernels.
//
// What bounds it on an H100: the instructions it runs, not bytes.  For
// config 3 at 1080x1920 the outputs are 2.07 M px x (12 + 12) B, about 50 MB
// a frame (0.015 ms at 3.35 TB/s), and the packed scene is a few hundred
// bytes; each pixel runs up to 3 closest-hit and 6 shadow passes over 5
// primitives, on the FP32 pipes.
//
// Design:
// * One thread per pixel; a warp takes a tile of 8 x 4 pixels and a block
//   32 x 8, so the lanes of a warp see neighbouring pixels in both
//   directions and take the same branches more often than a strip of 32 in
//   a row would; masked at the image's width and at the slab's ends (the TPU
//   kernel's tile padding is gone).  Dead rays exit per thread, and a shadow
//   test returns at the first occluder, spheres first.
// * Fewer instructions a test (phase1_math.cuh): every a * b + c one
//   __fmaf_rn (a form 3 instructions, where -fmad=false alone made it 5 or
//   7); a triangle whose t cannot be positive or beyond the best hit, and a
//   sphere whose roots are both behind the origin, miss before the division,
//   u and v, or the sqrtf; the specular power is exp2f(shin log2f(x)), not
//   the library's powf with its slow path.  Divisions and square roots stay
//   correctly rounded.
// * The globals (camera, ambient, lights: at most NGLOB_MAX floats) are
//   copied into the block's shared memory once, so a light's position and
//   colour are not fetched through the read-only path at every depth.
// * Staging primitives in shared memory is a lever for a later change; at
//   the phase-1 limit (4096 tris x 48 B + 4096 spheres x 32 B) the tables
//   exceed the 227 KB a block can use, so it needs chunks.

#include "phase1_math.cuh"

namespace tpurt {

// a warp's pixels: a tile of TILE_W x TILE_H; a block's: BLOCK_W x BLOCK_H
constexpr int TILE_W = 8, TILE_H = 4;
constexpr int BLOCK_W = 4 * TILE_W, BLOCK_H = (THREADS / 32 / 4) * TILE_H;

// grid (ceil(width / BLOCK_W), ceil(rows / BLOCK_H)) over the image rows from
// row0 that hold the slab [off, off + n_pix)
__global__ void __launch_bounds__(THREADS) megakernel_fwd(Scene s, float* __restrict__ colour,
                                                          int* __restrict__ occ, Frame f,
                                                          int row0) {
  __shared__ float glob[NGLOB_MAX];
  const int n_glob = NGLOB_BASE + 6 * s.n_lights;
  for (int k = threadIdx.x; k < n_glob; k += THREADS) glob[k] = __ldg(s.glob + k);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * BLOCK_W + (warp & 3) * TILE_W + (lane % TILE_W);
  const int row = row0 + blockIdx.y * BLOCK_H + (warp >> 2) * TILE_H + lane / TILE_W;
  const long long pix = static_cast<long long>(row) * f.width + col;
  if (col >= f.width || pix < f.off || pix >= static_cast<long long>(f.off) + f.n_pix) return;
  const int i = static_cast<int>(pix - f.off);
  const SharedGlobals g{glob};
  const CameraRay r = p1_raygen(g, f, static_cast<int>(pix));
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  sweep_forward<false, false>(s, g, r.o, r.d, f.max_depth, f.shadows, occ + i, f.n_pix, nullptr,
                              acc0, acc1, acc2);
  colour[i] = clip01(acc0);
  colour[f.n_pix + i] = clip01(acc1);
  colour[2LL * f.n_pix + i] = clip01(acc2);
}

// The body's arithmetic helpers one at a time, for the card tests that hold
// the plain version's to them (tests/test_torch_cuda.py): a and b (n, 4), c
// (n,), out (n, 4).  op 0: fma(a.x, b.x, c); 1: p1_form_o(a, b.xyz); 2:
// p1_dot(a.xyz, b.xyz); 3: p1_normalize(a.xyz); 4: p1_pow(a.x, b.x); 5:
// p1_reflect(a.xyz, b.xyz).
__global__ void __launch_bounds__(THREADS) phase1_helpers(int op, const float4* __restrict__ a,
                                                          const float4* __restrict__ b,
                                                          const float* __restrict__ c,
                                                          float4* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4 x = a[i], y = b[i];
  float4 r{0.0f, 0.0f, 0.0f, 0.0f};
  V3 v{0.0f, 0.0f, 0.0f};
  switch (op) {
    case 0: r.x = __fmaf_rn(x.x, y.x, c[i]); break;
    case 1: r.x = p1_form_o(x, xyz(y)); break;
    case 2: r.x = p1_dot(xyz(x), xyz(y)); break;
    case 3: v = p1_normalize(xyz(x)); break;
    case 4: r.x = p1_pow(x.x, y.x); break;
    case 5: v = p1_reflect(xyz(x), xyz(y)); break;
    default: break;
  }
  if (op == 3 || op == 5) r = {v.x, v.y, v.z, 0.0f};
  out[i] = r;
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
  if (n_lights < 0 || n_lights > MAX_LIGHTS) return static_cast<int>(cudaErrorInvalidValue);
  const Scene s{static_cast<const float4*>(tri_forms), static_cast<const float4*>(sph_forms),
                static_cast<const float*>(attrs), static_cast<const float*>(glob), n_tris, n_sph,
                n_lights};
  const Frame f{height, width, aspect, max_depth, shadows, off, n_pix};
  const int row0 = off / width, rows = (off + n_pix - 1) / width - row0 + 1;
  const dim3 grid((width + BLOCK_W - 1) / BLOCK_W, (rows + BLOCK_H - 1) / BLOCK_H);
  megakernel_fwd<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<float*>(colour), static_cast<int*>(occ), f, row0);
  return static_cast<int>(cudaGetLastError());
}

int tpurt_phase1_helpers(int op, const void* a, const void* b, const void* c, void* out, int n,
                         void* stream) {
  using namespace tpurt;
  if (n <= 0) return static_cast<int>(cudaSuccess);
  phase1_helpers<<<(n + THREADS - 1) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      op, static_cast<const float4*>(a), static_cast<const float4*>(b),
      static_cast<const float*>(c), static_cast<float4*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

const char* tpurt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
