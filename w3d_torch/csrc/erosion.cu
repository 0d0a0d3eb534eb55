// Droplet-erosion batch walk, hand-written for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_erosion_kernel`
// (3dworld_tpu/ops/pallas/erosion_kernel.py:41, pallas_call at :226),
// which the JAX tile path drives once per droplet batch through
// `erode_tiles_pallas`.  Plain PyTorch version: w3d_torch/ops/erosion.py
// `_walk_batch`; wrapper: w3d_torch/ops/cuda/erosion_kernel.py.
//
// What bounds it on this card: not device memory -- a tile is read through
// L1 (64 KB at 128^2) and its delta written once (35 MB for 256 tiles,
// 0.010 ms at 3.35 TB/s).  The walk is a chain of `steps` dependent steps,
// each with three block-wide barriers, so the time is the cycles of one
// step times the steps times the waves of tiles over the SMs (one CTA per
// SM fits, so 256 tiles run in two waves).
//
// Semantics (docs/DESIGN.md:167-180): every droplet reads the snapshot plus
// the delta as they stood at the start of the step, then all write; each
// step's deposits and erosion are summed in 64-bit fixed point with 40
// fraction bits, as integers, so their order does not matter, and added to
// the float delta once per step.  The kernel is therefore deterministic and
// equals the plain version (which sums the same fixed-point values with
// scatter_add) bit for bit.  Float atomics made the result vary from run to
// run, and the chaotic walk grew those last bits into flipped droplet
// branches.
//
// Design: one CTA per tile, one thread per droplet (B <= 1024); the
// snapshot stays in device memory, read through the read-only cache; shared
// memory holds the batch's float delta and an int64 map of the step's sums
// (64 + 128 KB at 128^2).  Each step: read phase, barrier, write phase,
// barrier, combine, barrier.  Dead droplets run the barriers and write
// nothing; deposits outside the map are dropped; the stencil clamps to the
// edge cells; droplets alive at the step cap deposit their sediment after
// the loop.  Built with -fmad=false, every product and sum rounds as in the
// plain version.
//
// Where the first design's time went (SM cycles per step and CTA, phase
// counters of `utils/kernel_probe`, 256 tiles of 128^2, 512 droplets,
// 64 steps, H100 at 700 W; 1.015 ms a call): read phase 1,137 (10%), write
// phase 4,505 (40%), combine pass 5,734 (50%).  The write phase was slow
// because sm_90 has no 64-bit shared-memory atomic add: `atomicAdd` on
// int64 compiled to a compare-and-swap loop (ATOMS.CAST.SPIN.64).  The
// combine pass visited all 16,384 cells of the tile
// each step, though a step writes at most 16 cells per live droplet.  So:
//  - the write phase adds each 64-bit value as two native 32-bit atomics,
//    the low word first and the high word plus the low word's carry
//    (`add_fixed`): the sum of the two words is the 64-bit sum modulo
//    2^64, whatever the order, so the bits do not change.  A droplet's
//    deposit is folded into the stencil taps on the same cells before the
//    atomics, and taps that add zero are skipped;
//  - the combine visits only the cells the step wrote: each droplet claims
//    its own tap cells with a 64-bit `atomicExch(.., 0)`; only the first
//    claimer of a cell sees its whole sum and adds it to the delta, the
//    others see 0 (exactly as the full pass skipped cells whose sum was 0).
// The 192 KB of shared memory per tile stay: the int64 map is what keeps
// the sums exact, and 256 tiles at one per SM are two full waves.
//
// After this design a step costs read 1,370, write 3,285 and combine 2,209
// cycles: the shared-memory atomic unit now bounds the walk, and A is still
// the kernel with the most main-path time above its bound; that residual is
// performance work once a benchmark exists (ROADMAP Queue 2 redesigns each
// kernel once).  The `W3D_EROSION_PHASES` counters below are the instrument
// that measures each step's phases for that next pass; the default build
// leaves them out.

#include <cuda_runtime.h>

namespace {

constexpr float KQ = 10.0f;
constexpr float KW_KEEP = (float)(1.0 - 0.001);   // 1 - Kw, rounded once
constexpr float NEG_KR = -0.9f;
constexpr float KD = 0.02f;
constexpr float KI = 0.1f;
constexpr float MIN_SLOPE = 0.05f;
constexpr float KG = 40.0f;                       // 2 * g
constexpr float STENCIL_NORM = 0.1591549430918953f;   // 1 / (2 pi)
constexpr float FLT_EPS = 1.1920929e-07f;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

constexpr float FIXED_SCALE = 1099511627776.0f;       // 2^40
constexpr float FIXED_INV = 1.0f / 1099511627776.0f;   // 2^-40, exact

#ifdef W3D_EROSION_PHASES
// Phase counters (a variant build, `utils/kernel_probe`): thread 0 of each
// CTA adds the SM cycles between the step's barriers into these sums.
__device__ unsigned long long g_phase_cycles[4];
#define PHASE(i)                                  \
  if (threadIdx.x == 0) {                         \
    const long long c_ = clock64();               \
    ph[i] += c_ - ph_last;                        \
    ph_last = c_;                                 \
  }
#else
#define PHASE(i)
#endif

// net[i] += q (mod 2^64) as two 32-bit shared-memory atomics: the low word,
// then the high word plus the carry out of the low word.
__device__ __forceinline__ void add_fixed(long long* net, int i, long long q) {
  unsigned* w = reinterpret_cast<unsigned*>(net + i);
  const unsigned lo = (unsigned)q;
  const unsigned hi = (unsigned)((unsigned long long)q >> 32);
  const unsigned old = atomicAdd(w, lo);
  const unsigned inc = hi + ((unsigned)(old + lo) < old ? 1u : 0u);
  if (inc != 0u) atomicAdd(w + 1, inc);
}

__device__ __forceinline__ long long to_fixed(float v) {
  return __float2ll_rn(v * FIXED_SCALE);
}

// One droplet's writes of a step at cell (zi, xi) + fraction (zf, xf): the
// clamped 4x4 erosion stencil of `ev` (erosion.cpp:134-144), subtracted,
// and the bilinear deposit of `depv` (DEPOSIT macro, erosion.cpp:49-54;
// out-of-map taps dropped), which lands on the stencil's centre 2x2 taps.
// With `claim`, instead of writing, claim the same cells and add the whole
// sum of each cell claimed first to the delta.
__device__ __forceinline__ void write_taps(long long* net, float* dl, int ny,
                                           int nx, int xi, int zi, float xf,
                                           float zf, float depv, float ev,
                                           bool claim) {
  if (depv == 0.0f && ev == 0.0f) return;
  const float wz[2] = {1.0f - zf, zf};
  const float wx[2] = {1.0f - xf, xf};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float zo = (float)(a - 1) - zf;
    const int zz = clampi(zi + a - 1, 0, ny - 1);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const bool centre = a >= 1 && a <= 2 && b >= 1 && b <= 2;
      if (ev == 0.0f && !centre) continue;
      const int xx = clampi(xi + b - 1, 0, nx - 1);
      const int cell = zz * nx + xx;
      if (claim) {
        const long long q = (long long)atomicExch(
            reinterpret_cast<unsigned long long*>(net + cell), 0ull);
        if (q != 0) dl[cell] = dl[cell] + (float)q * FIXED_INV;
        continue;
      }
      long long q = 0;
      if (ev != 0.0f) {
        const float xo = (float)(b - 1) - xf;
        const float wgt =
            fmaxf(1.0f - (xo * xo + zo * zo) * 0.25f, 0.0f) * STENCIL_NORM;
        q = -to_fixed(wgt * ev);
      }
      if (centre && depv != 0.0f) {
        const int z = zi + a - 1, x = xi + b - 1;
        if (z >= 0 && z < ny && x >= 0 && x < nx)
          q += to_fixed((wz[a - 1] * depv) * wx[b - 1]);
      }
      if (q != 0) add_fixed(net, cell, q);
    }
  }
}

__global__ void erosion_walk_kernel(const float* __restrict__ hm,
                                    const int* __restrict__ xi0,
                                    const int* __restrict__ zi0,
                                    const float* __restrict__ angles,
                                    const float* __restrict__ params,
                                    float* __restrict__ out, int ny, int nx,
                                    int B, int steps) {
  extern __shared__ long long smem[];
  const int ncell = ny * nx;
  long long* s_net = smem;                                // this step's writes
  float* s_dl = reinterpret_cast<float*>(smem + ncell);   // this batch's delta
  const int tile = blockIdx.x;
  const float* hm_t = hm + (size_t)tile * ncell;   // snapshot, via L1/L2
  for (int i = threadIdx.x; i < ncell; i += blockDim.x) {
    s_dl[i] = 0.0f;
    s_net[i] = 0;
  }
  const float ea = params[0], water_cut = params[1], zmin = params[2];
  const float zr_inv = params[3], rock = params[4], relh_adj = params[5];
  __syncthreads();
#ifdef W3D_EROSION_PHASES
  long long ph[3] = {0, 0, 0};
  long long ph_last = clock64();
  const long long ph_start = ph_last;
#endif

  const int d = threadIdx.x;
  int xi = xi0[tile * B + d], zi = zi0[tile * B + d];
  float xp = (float)xi, zp = (float)zi;
  float xf = 0.0f, zf = 0.0f, dx = 0.0f, dz = 0.0f;
  float s = 0.0f, v = 0.0f, w = 1.0f;
  float h00, h10, h01, h11;
  {
    const int x0 = clampi(xi, 0, nx - 1), x1 = clampi(xi + 1, 0, nx - 1);
    const int z0 = clampi(zi, 0, ny - 1), z1 = clampi(zi + 1, 0, ny - 1);
    h00 = __ldg(hm_t + z0 * nx + x0);
    h10 = __ldg(hm_t + z0 * nx + x1);
    h01 = __ldg(hm_t + z1 * nx + x0);
    h11 = __ldg(hm_t + z1 * nx + x1);
  }
  float h = h00;
  bool alive = true;

  for (int t = 0; t < steps; ++t) {
    // writes of this step land on the cell held at its start
    const int oxi = xi, ozi = zi;
    const float oxf = xf, ozf = zf;
    float depv = 0.0f, ev = 0.0f;
    if (alive) {
      // ---- read phase: snapshot + delta as it stood at the step start ----
      const float gx = h00 + h01 - h10 - h11;
      const float gz = h00 + h10 - h01 - h11;
      float ndx = (dx - gx) * KI + gx;
      float ndz = (dz - gz) * KI + gz;
      const float dl = sqrtf(ndx * ndx + ndz * ndz);
      if (dl <= FLT_EPS) {   // flat spot: random direction, its cosine and
        // sine in double and rounded once, as ops/fmath does on every device
        const double ang = (double)angles[t * B + d];
        ndx = (float)cos(ang);
        ndz = (float)sin(ang);
      } else {
        const float inv = 1.0f / fmaxf(dl, FLT_EPS);
        ndx = ndx * inv;
        ndz = ndz * inv;
      }
      const float nxp = xp + ndx, nzp = zp + ndz;
      const float fx = floorf(nxp), fz = floorf(nzp);
      const int nxi = (int)fx, nzi = (int)fz;
      const float nxf = nxp - fx, nzf = nzp - fz;
      const int x0 = clampi(nxi, 0, nx - 1), x1 = clampi(nxi + 1, 0, nx - 1);
      const int z0 = clampi(nzi, 0, ny - 1), z1 = clampi(nzi + 1, 0, ny - 1);
      const float nh00 = __ldg(hm_t + z0 * nx + x0) + s_dl[z0 * nx + x0];
      const float nh10 = __ldg(hm_t + z0 * nx + x1) + s_dl[z0 * nx + x1];
      const float nh01 = __ldg(hm_t + z1 * nx + x0) + s_dl[z1 * nx + x0];
      const float nh11 = __ldg(hm_t + z1 * nx + x1) + s_dl[z1 * nx + x1];
      const float nh = (nh00 * (1.0f - nxf) + nh10 * nxf) * (1.0f - nzf) +
                       (nh01 * (1.0f - nxf) + nh11 * nxf) * nzf;
      const float nmax = fmaxf(fmaxf(nh00, nh10), fmaxf(nh01, nh11));
      const bool ocean = nmax < water_cut;

      const bool outside = xi < 0 || zi < 0 || xi >= nx || zi >= ny;
      const bool uphill = (nh >= h) || outside;
      const float ds_fill = (nh - h) + 0.001f;
      const bool full = (ds_fill >= s) || outside;
      const float dep_pit = uphill ? (full ? s : ds_fill) : 0.0f;
      const bool die_pit = uphill && full;
      float ns = s - dep_pit;
      const bool fill = uphill && !full;
      const float hh = h + (fill ? ds_fill : 0.0f);
      float nv = fill ? 0.0f : v;

      float dh = hh - nh;
      const float q = fmaxf(dh, MIN_SLOPE) * nv * w * KQ;
      const float ds2 = ns - q;
      const bool go_on = !ocean && !die_pit;
      const bool dep_branch = ds2 >= 0.0f;
      const float dep_cap = (go_on && dep_branch) ? ds2 * KD : 0.0f;
      ns = ns - dep_cap;
      dh = dh + dep_cap;
      const float relh = relh_adj + (nh - zmin) * zr_inv;
      const float rockf = relh > rock ? 0.5f : 2.0f;
      float e_amt = fminf(NEG_KR * ds2, dh * 0.99f) * rockf;
      if (!(go_on && !dep_branch)) e_amt = 0.0f;
      dh = dh - e_amt;
      ns = ns + e_amt;

      depv = (ocean ? 0.0f : dep_pit + dep_cap) * ea;
      ev = e_amt * ea;
      nv = sqrtf(fmaxf(nv * nv + KG * dh, 0.0f));
      if (go_on) {
        xi = nxi; zi = nzi; xp = nxp; zp = nzp; xf = nxf; zf = nzf;
        dx = ndx; dz = ndz; s = ns; v = nv; w = w * KW_KEEP; h = nh;
        h00 = nh00; h10 = nh10; h01 = nh01; h11 = nh11;
      }
      alive = go_on;
    }
    __syncthreads();   // every read of this step precedes every write
    PHASE(0)
    // ---- write phase: this step's deposit and erosion sums ----
    write_taps(s_net, s_dl, ny, nx, oxi, ozi, oxf, ozf, depv, ev, false);
    __syncthreads();
    PHASE(1)
    // ---- combine: each written cell's sum, rounded to float once, into
    // the delta by its first claimer; the claims leave the sums at 0 ----
    write_taps(s_net, s_dl, ny, nx, oxi, ozi, oxf, ozf, depv, ev, true);
    __syncthreads();
    PHASE(2)
  }
#ifdef W3D_EROSION_PHASES
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) atomicAdd(&g_phase_cycles[i], (unsigned long long)ph[i]);
    atomicAdd(&g_phase_cycles[3], (unsigned long long)(clock64() - ph_start));
  }
#endif
  // droplets alive at the step cap drop their sediment where they stand
  if (alive) write_taps(s_net, s_dl, ny, nx, xi, zi, xf, zf, s * ea, 0.0f, false);
  __syncthreads();
  float* out_t = out + (size_t)tile * ncell;
  for (int i = threadIdx.x; i < ncell; i += blockDim.x)
    out_t[i] = s_dl[i] + (float)s_net[i] * FIXED_INV;
}

}  // namespace

extern "C" int w3d_erosion_walk(const float* hm, const int* xi0,
                                const int* zi0, const float* angles,
                                const float* params, float* out, int T,
                                int ny, int nx, int B, int steps,
                                void* stream) {
  const int smem = ny * nx * (int)(sizeof(long long) + sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      erosion_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  erosion_walk_kernel<<<T, B, smem, (cudaStream_t)stream>>>(
      hm, xi0, zi0, angles, params, out, ny, nx, B, steps);
  return (int)cudaGetLastError();
}

#ifdef W3D_EROSION_PHASES
// Copies the four phase sums (read, write, combine, whole walk; SM cycles
// summed over CTAs) to `host` and clears them.
extern "C" int w3d_erosion_phase_cycles(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[4] = {0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif
