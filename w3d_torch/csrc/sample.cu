// Bilinear mesh sampling (height + unit normal), hand-written for Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU kernel `_sample_kernel`
// (3dworld_tpu/ops/pallas/sample_kernel.py:49, pallas_call at :105),
// which `physics/step.sample_mesh` calls on the TPU.  Plain PyTorch
// version: w3d_torch/physics/step.py `sample_mesh`; wrapper:
// w3d_torch/ops/cuda/sample_kernel.py.
//
// What bounds it on this card: the launch.  Per object 2 floats in, 4
// out, and 12 reads of a 64 KB mesh that stays in L1/L2 after the first
// touches: 0.09 us of bytes at N = 10K, against a launch and two
// dependent memory rounds (x and y, then the taps) of a few microseconds.
//
// Design: one thread per object in 64-thread CTAs.  The CTA size makes no
// difference: 32-, 64- and 128-thread CTAs measured the same within 0.1 us
// at N = 10K (utils/kernel_probe on an H100 80GB HBM3 at 700 W; PERF.md),
// so the gain over the earlier 20-load version comes from the 12 loads
// and the modulo-free wrap below.  The TPU kernel builds the bilinear
// weights as one-hot planes and contracts them on the MXU; here each
// thread computes
// its four taps directly (the zero terms of the one-hot product add
// exactly 0, so the value is the same).  The gradient maps are not
// materialized: the taps' central differences need 12 distinct cells --
// columns x0-1 .. x0+2 of rows y0 and y0+1, and columns x0, x0+1 of rows
// y0-1 and y0+2 -- each loaded once, all 12 in one round, with periodic
// wrap at the border (the reference's jnp.roll) done by compare and
// select, not an integer modulo.  The bilinear weights clamp to the border
// (the plain version's clipped floor and fraction).  Heights contract y
// first, then x, in the plain version's order; with -fmad=false every
// product and sum rounds separately, as the plain version's ops do, so
// heights agree bitwise.  The normal uses an IEEE sqrt and divide.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 64;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(BLOCK)
    sample_mesh_kernel(const float* __restrict__ mesh,
                       const float* __restrict__ x, const float* __restrict__ y,
                       float* __restrict__ h_out, float* __restrict__ nx_out,
                       float* __restrict__ ny_out, float* __restrict__ nz_out,
                       int n, int my, int mx, float dx_inv, float dy_inv,
                       float gsx, float gsy) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const float gx = x[i] * dx_inv + (float)(mx / 2);
  const float gy = y[i] * dy_inv + (float)(my / 2);
  const int x0 = clampi((int)floorf(gx), 0, mx - 2);
  const int y0 = clampi((int)floorf(gy), 0, my - 2);
  const float fx = fminf(fmaxf(gx - (float)x0, 0.0f), 1.0f);
  const float fy = fminf(fmaxf(gy - (float)y0, 0.0f), 1.0f);
  const float wy0 = 1.0f - fy, wx0 = 1.0f - fx;

  // x0 + 1 and y0 + 1 stay inside the mesh; x0 - 1, x0 + 2 (and the y
  // counterparts) wrap
  const int x1 = x0 + 1, y1 = y0 + 1;
  const int xm = x0 == 0 ? mx - 1 : x0 - 1;
  const int x2 = x1 == mx - 1 ? 0 : x1 + 1;
  const int ym = y0 == 0 ? my - 1 : y0 - 1;
  const int y2 = y1 == my - 1 ? 0 : y1 + 1;
  const float* r0 = mesh + y0 * mx;
  const float* r1 = mesh + y1 * mx;
  const float* rm = mesh + ym * mx;
  const float* r2 = mesh + y2 * mx;
  const float a_m = __ldg(r0 + xm), a0 = __ldg(r0 + x0), a1 = __ldg(r0 + x1),
              a2 = __ldg(r0 + x2);
  const float b_m = __ldg(r1 + xm), b0 = __ldg(r1 + x0), b1 = __ldg(r1 + x1),
              b2 = __ldg(r1 + x2);
  const float c0 = __ldg(rm + x0), c1 = __ldg(rm + x1);   // row y0 - 1
  const float d0 = __ldg(r2 + x0), d1 = __ldg(r2 + x1);   // row y0 + 2

  // per column (x0, x0+1): the tap at rows y0, y0+1 and its central
  // differences, contracted over y
  const float hv0 = a0 * wy0 + b0 * fy;
  const float hv1 = a1 * wy0 + b1 * fy;
  const float sxv0 = ((a1 - a_m) * gsx) * wy0 + ((b1 - b_m) * gsx) * fy;
  const float sxv1 = ((a2 - a0) * gsx) * wy0 + ((b2 - b0) * gsx) * fy;
  const float syv0 = ((b0 - c0) * gsy) * wy0 + ((d0 - a0) * gsy) * fy;
  const float syv1 = ((b1 - c1) * gsy) * wy0 + ((d1 - a1) * gsy) * fy;
  const float h = hv0 * wx0 + hv1 * fx;
  const float sx = sxv0 * wx0 + sxv1 * fx;
  const float sy = syv0 * wx0 + syv1 * fx;
  const float inv = 1.0f / sqrtf(sx * sx + sy * sy + 1.0f);
  h_out[i] = h;
  nx_out[i] = -sx * inv;
  ny_out[i] = -sy * inv;
  nz_out[i] = inv;
}

}  // namespace

extern "C" int w3d_sample_mesh(const float* mesh, const float* x,
                               const float* y, float* h, float* nx,
                               float* ny, float* nz, int n, int my, int mx,
                               float dx_inv, float dy_inv, float gsx,
                               float gsy, void* stream) {
  if (n > 0) {
    sample_mesh_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                         (cudaStream_t)stream>>>(mesh, x, y, h, nx, ny, nz, n,
                                                 my, mx, dx_inv, dy_inv, gsx,
                                                 gsy);
  }
  return (int)cudaGetLastError();
}
