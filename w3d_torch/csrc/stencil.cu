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
// What bounds it on this card: device memory.  Each cell is read once and
// written once, ~17 flops; at (32, 128, 128) that is 2 MB in and 2 MB out
// (1.25 us at 3.35 TB/s), so the launch and the latency of the first loads
// are most of its time.
//
// Design: each thread owns a run of V consecutive cells of x (V = 4, one
// float4, where nx is a multiple of 4 and the grid 16-byte aligned; V = 1
// otherwise) at one y, and marches z over a block of `zb` layers, keeping
// the layer below, its own and the layer above in registers: a layer is
// loaded once as "above" and reused as "own" and "below".  A warp holds 32
// runs of one row, so the x neighbours beyond a run are the neighbour
// lanes' end cells (`__shfl_up_sync` / `__shfl_down_sync`); only the
// warp's two end lanes read theirs from memory.  The y neighbours are the
// same run one row up and down (L1 hits: the neighbour warps read them as
// their own).  A thread thus loads three runs per layer where one thread
// per cell loaded seven cells.  Index arithmetic is 32-bit from the grid's
// dimensions (the wrapper checks the cell count fits).  `zb` is chosen by
// the wrapper so that the grid still fills the card (z blocks x rows x
// runs).  The TPU kernel's per-layer program with a z-padded copy becomes
// an index test at the grid's edges.  Built with -fmad=false, the sums
// round in the plain version's order, so the two agree bitwise.

#include <cuda_runtime.h>

namespace {

// water/smoke.py (smoke.cpp:13-22)
constexpr float DIS_XY = 0.05f, DIS_ZU = 0.08f, DIS_ZD = 0.03f,
                MAX_VAL = 100.0f;
constexpr int ROWS = 4;   // warps (rows of y) per CTA
constexpr unsigned FULL = 0xffffffffu;

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p, float (&a)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    a[0] = t.x;
    a[1] = t.y;
    a[2] = t.z;
    a[3] = t.w;
  } else {
    a[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p, const float (&a)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
    p[0] = a[0];
  }
}

template <int V>
__device__ __forceinline__ void zero(float (&a)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) a[k] = 0.0f;
}

template <int V>
__global__ void __launch_bounds__(32 * ROWS)
    diffuse_kernel(const float* __restrict__ s, float* __restrict__ out,
                   int nz, int ny, int nx, int zb) {
  const int lane = threadIdx.x;
  const int y = blockIdx.y * ROWS + threadIdx.y;
  if (y >= ny) return;   // the whole warp: a warp is one row
  const int x0 = (blockIdx.x * 32 + lane) * V;
  const bool in = x0 < nx;   // lanes past the row's end join the shuffles only
  const bool has_w = x0 > 0, has_e = x0 + V < nx;
  const bool has_s = y > 0, has_n = y < ny - 1;
  const int plane = ny * nx;
  const int z0 = blockIdx.z * zb;
  const int z1 = min(nz, z0 + zb);
  int i = (z0 * ny + y) * nx + x0;   // the run's first cell in layer z
  float dn[V], c[V], up[V], so[V], no[V];
  zero(dn);
  zero(c);
  if (in) {
    load(s + i, c);
    if (z0 > 0) load(s + i - plane, dn);
  }
  for (int z = z0; z < z1; ++z, i += plane) {
    zero(up);
    zero(so);
    zero(no);
    if (in) {
      if (z < nz - 1) load(s + i + plane, up);
      if (has_s) load(s + i - nx, so);
      if (has_n) load(s + i + nx, no);
    }
    // the cells west and east of the run: the neighbour lanes' ends, or
    // memory at the warp's ends; zero outside the grid
    float w = __shfl_up_sync(FULL, c[V - 1], 1);
    float e = __shfl_down_sync(FULL, c[0], 1);
    if (lane == 0) w = (in && has_w) ? __ldg(s + i - 1) : 0.0f;
    if (lane == 31) e = (in && has_e) ? __ldg(s + i + V) : 0.0f;
    if (!has_e) e = 0.0f;
    float r[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float wk = k == 0 ? w : c[k - 1];
      const float ek = k == V - 1 ? e : c[k + 1];
      float delta = (wk + ek + so[k] + no[k] - 4.0f * c[k]) * DIS_XY;
      const float d_up = up[k] - c[k];
      const float d_dn = dn[k] - c[k];
      delta = delta + (d_up > 0.0f ? DIS_ZD : DIS_ZU) * d_up;
      delta = delta + (d_dn > 0.0f ? DIS_ZU : DIS_ZD) * d_dn;
      r[k] = fminf(fmaxf(c[k] + delta, 0.0f), MAX_VAL);
    }
    if (in) store(out + i, r);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      dn[k] = c[k];
      c[k] = up[k];
    }
  }
}

}  // namespace

// `vec` 4: float4 runs (nx % 4 == 0, both pointers 16-byte aligned); 1:
// one cell a thread.  `zb`: layers a thread marches (at least 1).  The
// cell count must fit in an int.
extern "C" int w3d_diffuse_smoke(const float* smoke, float* out, int nz,
                                 int ny, int nx, int vec, int zb,
                                 void* stream) {
  if (zb < 1 || (vec != 1 && vec != 4) || (vec == 4 && nx % 4 != 0))
    return (int)cudaErrorInvalidValue;
  if ((long long)nz * ny * nx == 0) return (int)cudaGetLastError();
  const dim3 block(32, ROWS);
  const dim3 grid((unsigned)((nx / vec + 31) / 32), (unsigned)((ny + ROWS - 1) / ROWS),
                  (unsigned)((nz + zb - 1) / zb));
  if (vec == 4)
    diffuse_kernel<4><<<grid, block, 0, (cudaStream_t)stream>>>(smoke, out, nz, ny, nx, zb);
  else
    diffuse_kernel<1><<<grid, block, 0, (cudaStream_t)stream>>>(smoke, out, nz, ny, nx, zb);
  return (int)cudaGetLastError();
}
