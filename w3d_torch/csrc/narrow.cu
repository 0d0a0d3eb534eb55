// Shape-grouped static-cobj narrow phase, hand-written for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_narrow_kernel`
// (3dworld_tpu/ops/pallas/narrow_kernel.py:83, pallas_call at :319), which
// the JAX physics substep calls through `deepest_hits_pallas` on the TPU.
// Plain PyTorch version: w3d_torch/physics/cobjs.py `deepest_hits_grouped`;
// wrapper: w3d_torch/ops/cuda/narrow_kernel.py.
//
// What bounds it on this card: latency.  Each object tests every cobj
// slot (M = 112 for the spheres scene) with its shape's formula, tens of
// dependent flops with an IEEE sqrt and divide each; device memory sees
// only 4 floats in and 6 floats and a byte out per object plus the 12 KB
// table per block.
// With one thread per object, N = 10K is 79 CTAs of 4 warps on the 132
// SMs, and each warp waits out every instruction's latency through 112
// serial rows.
//
// Design: a team of LANES (8) consecutive threads per object
// (cobj_shapes.cuh `team_walk` with the `FirstDeepest` record).  Lane j of the team evaluates rows
// gstart[g] + j, + LANES, ... of each shape group g, so a thread runs M /
// LANES rows and N = 10K objects fill the card with 80K threads.  Every
// team of a warp runs the same group at the same time, so each group's
// formula is warp-uniform code (the group loop is unrolled; no switch is
// left).  Rows past a group's end are masked, so any group starts work
// (those of `group_cobjs(pad_to=8)` are multiples of 8, and no lane idles
// at LANES = 8).  The table sits in shared memory field-major,
// [CF_USED][S] with the fixed row stride S = CHUNK_ROWS (384), so each
// column offset is an immediate: the LANES rows a team reads at once are
// consecutive words in distinct banks, and every team of the warp reads
// the same words.  The wrapper packs it compact, [CF_USED][m4] with m4 =
// M rounded up to 4 (`narrow_kernel.kernel_tables`), and each CTA stages
// it as float4s into the stride-S columns, one chunk of at most S rows at
// a time: a table of any M streams through in ceil(m4 / S) chunks, each
// staged after a barrier that every team's walk of the chunk before has
// reached, so a lane sees its rows in the order of one pass and keeps its
// record across the chunks.  A table of one chunk takes its own
// instantiation with no chunk loop (the loop's state cost a one-chunk
// table 12% and 0.8 us of floor, PERF.md).  Dead padding slots
// (shape 0) score -1 with a zero normal and stay candidates, as in the
// plain version (an object farther than ~1 from every live cobj takes the
// first dead slot).  Each lane keeps its strictly deepest row; the team
// merges with `__shfl_xor_sync`, taking the other lane's row when deeper
// or equally deep with a lower index: the first index on ties, as
// torch.argmax and jnp.argmax.  Team lane 0 writes the object's seven
// outputs (the hit mask pen > 0 too, so the wrapper launches nothing
// else), reading the winner's elasticity and friction from shared memory,
// or, for a chunked table, from the compact table in device memory (the
// row may lie in a chunk no longer staged), no atomics.  The TPU kernel's [M, Nb] planes and iota-min argmax
// become a running maximum in registers.  Built with -fmad=false: every
// formula rounds op by op as the plain version does, so pen and the
// winner's fields agree bitwise except where sqrt/divide differ.
//
// Tuned once on an H100 80GB HBM3 at 700 W with `utils/kernel_probe`:
// 8 lanes and 256-thread CTAs; 4 and 16 lanes and 128- or 512-thread CTAs
// were slower (PERF.md).  What is left is one lane's 14 dependent rows,
// the staging and the launch, which no wider grid shortens.

#include <cuda_runtime.h>

#include "cobj_shapes.cuh"

namespace {

using namespace w3d;
constexpr int LANES = 8;
constexpr int BLOCK = 256;

// CHUNKED: the table spans more than one shared-memory chunk
template <bool CHUNKED>
__global__ void __launch_bounds__(BLOCK)
    narrow_kernel(const float* __restrict__ tab,   // [CF_USED][m4]
                  int m4, const int* __restrict__ gstart,  // [8]
                  const float* __restrict__ px, const float* __restrict__ py,
                  const float* __restrict__ pz, const float* __restrict__ rad,
                  bool* __restrict__ hit_out, float* __restrict__ pen_out,
                  float* __restrict__ nx_out, float* __restrict__ ny_out,
                  float* __restrict__ nz_out, float* __restrict__ el_out,
                  float* __restrict__ fr_out, int n) {
  __shared__ __align__(16) float s_tab[CF_USED * CHUNK_ROWS];
  __shared__ int s_start[8];
  stage_field_table<CHUNKED>(s_tab, s_start, tab, m4, gstart, BLOCK);
  const int i = (int)(((long long)blockIdx.x * BLOCK + threadIdx.x) / LANES);
  const int lane = threadIdx.x % LANES;
  // a team past the last object evaluates the last one and writes nothing:
  // every lane of the warp takes part in the team merge's shuffles
  const int o = i < n ? i : n - 1;
  FirstDeepest w;
  team_walk<LANES, CHUNKED>(s_tab, s_start, tab, m4, BLOCK, px[o], py[o],
                            pz[o], rad[o], lane, w);
  if (lane != 0 || i >= n) return;
  const bool any = w.row != NO_ROW;
  const float pen = any ? w.best.pen : -1.0f;
  hit_out[i] = pen > 0.0f;
  pen_out[i] = pen;
  nx_out[i] = w.best.nx;
  ny_out[i] = w.best.ny;
  nz_out[i] = w.best.nz;
  float el = 0.0f, fr = 0.0f;
  if (any) {   // the winner's row is still staged only if the table is one chunk
    const float* col = CHUNKED ? tab + w.row : s_tab + w.row;
    const int stride = CHUNKED ? m4 : CHUNK_ROWS;
    el = col[C_ELAS * stride];
    fr = col[C_FRIC * stride];
  }
  el_out[i] = el;
  fr_out[i] = fr;
}

}  // namespace

// `tab` is the compact field-major [CF_USED][m4] table, m4 a multiple of 4.
extern "C" int w3d_narrow(const float* tab, const int* gstart, int m4,
                          const float* px, const float* py, const float* pz,
                          const float* rad, bool* hit, float* pen, float* nx,
                          float* ny, float* nz, float* el, float* fr, int n,
                          void* stream) {
  if (m4 < 0 || m4 % 4 != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int grid = (int)(((long long)n * LANES + BLOCK - 1) / BLOCK);
    auto* kernel = m4 > CHUNK_ROWS ? narrow_kernel<true> : narrow_kernel<false>;
    kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        tab, m4, gstart, px, py, pz, rad, hit, pen, nx, ny, nz, el, fr, n);
  }
  return (int)cudaGetLastError();
}
