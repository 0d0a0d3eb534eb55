// Open-boundary smoke diffusion stencil, hand-written for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_diffuse_kernel`
// (3dworld_tpu/ops/pallas/stencil_kernel.py:22-49, pallas_call at :62),
// called through `diffuse_smoke_pallas`.  Plain PyTorch version:
// w3d_torch/water/smoke.py `diffuse_smoke_open`; wrapper:
// w3d_torch/ops/cuda/stencil_kernel.py.
//
// One diffusion step on [nz, ny, nx]: an xy exchange with the four
// neighbours at SMOKE_DIS_XY (zero outside the grid), an asymmetric z
// exchange (ZD for inflow from above and outflow below, ZU otherwise) with
// the top and bottom layers' outer neighbours zero (sinks), then a clamp
// to [0, SMOKE_MAX_VAL].
//
// What bounds it on this card: device memory.  Each cell is read by seven
// threads and written once, ~12 flops; at (32, 128, 128) that is 2 MB in
// and 2 MB out, and the neighbours' reads hit L1/L2.
//
// Design: one thread per cell, reading its six neighbours straight from
// global memory; consecutive threads take consecutive x, so every row
// read is coalesced.  The TPU kernel's per-layer program with a z-padded
// copy becomes an index test at the grid's edges.  Built with
// -fmad=false, the sums round in the plain version's order, so the two
// agree bitwise.

#include <cuda_runtime.h>

namespace {

// water/smoke.py (smoke.cpp:13-22)
constexpr float DIS_XY = 0.05f, DIS_ZU = 0.08f, DIS_ZD = 0.03f,
                MAX_VAL = 100.0f;

__global__ void diffuse_kernel(const float* __restrict__ s,
                               float* __restrict__ out, int nz, int ny,
                               int nx) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long plane = (long long)ny * nx;
  if (i >= plane * nz) return;
  const int x = (int)(i % nx);
  const int y = (int)((i / nx) % ny);
  const int z = (int)(i / plane);
  const float c = s[i];
  const float w = x > 0 ? s[i - 1] : 0.0f;
  const float e = x < nx - 1 ? s[i + 1] : 0.0f;
  const float so = y > 0 ? s[i - nx] : 0.0f;
  const float no = y < ny - 1 ? s[i + nx] : 0.0f;
  float delta = (w + e + so + no - 4.0f * c) * DIS_XY;
  const float up = z < nz - 1 ? s[i + plane] : 0.0f;
  const float dn = z > 0 ? s[i - plane] : 0.0f;
  const float d_up = up - c;
  const float d_dn = dn - c;
  delta = delta + (d_up > 0.0f ? DIS_ZD : DIS_ZU) * d_up;
  delta = delta + (d_dn > 0.0f ? DIS_ZU : DIS_ZD) * d_dn;
  out[i] = fminf(fmaxf(c + delta, 0.0f), MAX_VAL);
}

}  // namespace

extern "C" int w3d_diffuse_smoke(const float* smoke, float* out, int nz,
                                 int ny, int nx, void* stream) {
  const long long cells = (long long)nz * ny * nx;
  if (cells > 0) {
    const int block = 256;
    diffuse_kernel<<<(unsigned)((cells + block - 1) / block), block, 0,
                     (cudaStream_t)stream>>>(smoke, out, nz, ny, nx);
  }
  return (int)cudaGetLastError();
}
