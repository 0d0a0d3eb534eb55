// Shape-grouped static-cobj narrow phase, hand-written for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_narrow_kernel`
// (3dworld_tpu/ops/pallas/narrow_kernel.py:83, pallas_call at :319), which
// the JAX physics substep calls through `deepest_hits_pallas` on the TPU.
// Plain PyTorch version: w3d_torch/physics/cobjs.py `deepest_hits_grouped`;
// wrapper: w3d_torch/ops/cuda/narrow_kernel.py.
//
// What bounds it on this card: arithmetic.  Each object tests every cobj
// slot (M = 112 for the spheres scene) with its shape's formula, tens of
// flops with a sqrt and a divide each; device memory sees only 4 floats in
// and 6 out per object plus the 14 KB table per block.
//
// Design: one thread per object.  The packed [M, 32] cobj field table
// (physics/cobj_table.py layout; the shape formulas are in
// cobj_shapes.cuh) is copied to shared memory once per block and read as
// a broadcast: every thread of a warp reads the same row at the same time.  The groups of the shape-sorted table are walked in
// their padded order (cube, sphere, vertical cylinder, capsule, polygon,
// torus, rotated cylinder) and each group's formula runs only on its own
// rows, so the branch is uniform across the warp.  Dead padding slots
// (shape 0) score -1 with a zero normal, as in the plain version.  The
// best slot is kept on strictly greater penetration, which gives the
// first index on ties, as torch.argmax and jnp.argmax do.  The TPU
// kernel's [M, Nb] planes and iota-min argmax become a running maximum in
// registers.  Built with -fmad=false: every formula rounds op by op as the
// plain version does, so pen and the winner's fields agree bitwise except
// where sqrt/divide differ.

#include <cuda_runtime.h>

#include "cobj_shapes.cuh"

namespace {

using namespace w3d;
constexpr int F = CF;

__device__ __forceinline__ Hit eval_group(int g, const float* c, float X,
                                          float Y, float Z, float r) {
  switch (g) {
    case 0: return cube(c, X, Y, Z, r);
    case 1: return sphere(c, X, Y, Z, r);
    case 2: return vcylinder(c, X, Y, Z, r);
    case 3: return capsule(c, X, Y, Z, r);
    case 4: return polygon(c, X, Y, Z, r);
    case 5: return torus(c, X, Y, Z, r);
    default: return rcylinder(c, X, Y, Z, r);
  }
}

__global__ void narrow_kernel(const float* __restrict__ cf,
                              const int* __restrict__ gstart, int M,
                              const float* __restrict__ px,
                              const float* __restrict__ py,
                              const float* __restrict__ pz,
                              const float* __restrict__ rad,
                              float* __restrict__ pen_out,
                              float* __restrict__ nx_out,
                              float* __restrict__ ny_out,
                              float* __restrict__ nz_out,
                              float* __restrict__ el_out,
                              float* __restrict__ fr_out, int n) {
  extern __shared__ float s_cf[];
  for (int k = threadIdx.x; k < M * F; k += blockDim.x) s_cf[k] = cf[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float X = px[i], Y = py[i], Z = pz[i], r = rad[i];
  Hit best = {-1.0f, 0.0f, 0.0f, 0.0f};
  int best_row = -1;
  for (int g = 0; g < 7; ++g) {
    const int hi = gstart[g + 1];
    for (int row = gstart[g]; row < hi; ++row) {
      const float* c = s_cf + row * F;
      Hit h;
      if (c[C_SHAPE] == 0.0f) {   // dead padding slot
        h.pen = -1.0f;
        h.nx = h.ny = h.nz = 0.0f;
      } else {
        h = eval_group(g, c, X, Y, Z, r);
      }
      // strictly greater: first index on ties
      if (best_row < 0 || h.pen > best.pen) {
        best = h;
        best_row = row;
      }
    }
  }
  pen_out[i] = best.pen;
  nx_out[i] = best.nx;
  ny_out[i] = best.ny;
  nz_out[i] = best.nz;
  el_out[i] = best_row < 0 ? 0.0f : s_cf[best_row * F + C_ELAS];
  fr_out[i] = best_row < 0 ? 0.0f : s_cf[best_row * F + C_FRIC];
}

}  // namespace

extern "C" int w3d_narrow(const float* cf, const int* gstart, int M,
                          const float* px, const float* py, const float* pz,
                          const float* rad, float* pen, float* nx, float* ny,
                          float* nz, float* el, float* fr, int n,
                          void* stream) {
  if (n > 0) {
    const int block = 128;
    const size_t smem = (size_t)M * F * sizeof(float);
    narrow_kernel<<<(n + block - 1) / block, block, smem,
                    (cudaStream_t)stream>>>(cf, gstart, M, px, py, pz, rad, pen,
                                            nx, ny, nz, el, fr, n);
  }
  return (int)cudaGetLastError();
}
