// Banded sphere-pair collisions over the x-sorted order, hand-written for
// Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_pairs_kernel`
// (3dworld_tpu/ops/pallas/pairs_kernel.py:61, pallas_call at :168), which
// the JAX physics step runs as its pair pass on the TPU.  Plain PyTorch
// version: w3d_torch/physics/step.py `banded_pair_collisions`; wrapper:
// w3d_torch/ops/cuda/pairs_kernel.py.
//
// What bounds it on this card: the pair tests.  At 10K ranks and window
// 288 the band holds ~2.9M pairs, each an overlap test (~12 flops and a
// sqrt); only ~10K of them touch (the dense pile), and only those need the
// push and impulse terms (three divides).  The inputs are 400 KB.
//
// The first design ran one thread per rank over its 2 x window slots, every
// slot's full terms in a dependent chain: 157 blocks of 64 threads, 2-5
// warps per SM, ~900 cycles a slot; 0.28 ms at 10K (H100 trace).
//
// Design: one CTA per tile of TILE ranks [i0, i0 + TILE).  It stages the
// ten inputs of ranks [i0 - W, i0 + TILE + W) in shared memory once (24 KB
// at W = 288), then works through the window in chunks of D_CHUNK offsets:
//  1. test: 2 x TILE slots per offset d, spread with the offsets over the
//     CTA's 256 threads (313 CTAs of 8 warps at 10K ranks, 2-3 per SM, where
//     the first design had 157 of 2 warps).  Slot s < TILE tests pair
//     (r, r + d) for its rank r = i0 + s; slot TILE + s tests pair
//     (r - d, r) when r - d lies left of the tile (pairs inside the tile
//     are tested once, from their lower rank).  A touching pair sets one
//     bit per side it has in the tile: bit 2(d - 1) + side of a per-rank
//     mask (side 0: i side of (r, r + d); side 1: j side of (r - d, r)),
//     with integer atomicOr, whose result does not depend on order.
//  2. sum: one thread per rank walks its mask bits in increasing order,
//     i.e. by d with the i side first, computes that pair's terms and adds
//     or subtracts them.  That is the plain version's order exactly (its
//     loop over d adds the i term, then subtracts the j term); pairs that
//     do not touch contribute exact zeros there and are skipped here, which
//     changes no bit.
// No float atomics, so the result is deterministic, and built with
// -fmad=false it equals the plain version bit for bit (for finite inputs
// with positive masses, where a pair that does not touch adds zeros).
// Pairs that straddle two tiles are tested by both CTAs, one per side
// (~1.9x the band's pairs at TILE = 32): the price of keeping each rank's
// sum in one CTA.  A test costs one squared distance; the exact sqrt test
// runs only where the squared distance is within 0.01% of the contact
// distance.  Windows too wide to stage (over ~2,800 ranks) read the inputs
// from device memory instead.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;            // ranks per CTA
constexpr int THREADS = 256;        // 2 x TILE slots x 4 offset lanes
constexpr int D_CHUNK = 320;        // offsets per mask pass
constexpr int WORDS = 2 * D_CHUNK / 32;   // mask words per rank
constexpr int NF = 10;              // px py pz vx vy vz rad mass elas act

enum { PX, PY, PZ, VX, VY, VZ, RAD, MASS, ELAS, ACT };

// The ten per-rank inputs: field f of rank r is src[f][r - base], where
// src points into the CTA's shared-memory copy or at the device arrays.
struct Ranks {
  const float* src[NF];
  int base;
  __device__ __forceinline__ float operator()(int f, int r) const {
    return src[f][r - base];
  }
};

struct PairTerms {
  float ex, ey, ez;   // p_k - p_j
  float push_i, push_j, ai, aj;
};

// Pair (k, j = k + d), mirroring the plain version's expressions.
__device__ __forceinline__ PairTerms pair_terms(int k, int j, const Ranks& in) {
  PairTerms t;
  t.ex = in(PX, k) - in(PX, j);
  t.ey = in(PY, k) - in(PY, j);
  t.ez = in(PZ, k) - in(PZ, j);
  const float d2 = fmaxf(t.ex * t.ex + t.ey * t.ey + t.ez * t.ez, 1e-12f);
  const float dist = sqrtf(d2);
  const float rsum = in(RAD, k) + in(RAD, j);
  const bool hit = dist < rsum;
  const float pen = hit ? rsum - dist : 0.0f;
  const float m_i = in(MASS, k), m_j = in(MASS, j);
  const float mw_i = m_j / (m_i + m_j);
  const float mw_j = m_i / (m_i + m_j);
  t.push_i = pen * mw_i / dist;
  t.push_j = pen * mw_j / dist;
  const float relv = ((in(VX, k) - in(VX, j)) * t.ex +
                      (in(VY, k) - in(VY, j)) * t.ey +
                      (in(VZ, k) - in(VZ, j)) * t.ez) / d2;
  const float eij = fminf(in(ELAS, k), in(ELAS, j));
  const float a = (hit && relv < 0.0f) ? -(1.0f + eij) * relv : 0.0f;
  t.ai = a * mw_i;
  t.aj = a * mw_j;
  return t;
}

struct DeviceArrays {
  const float* f[NF];
};

__global__ void __launch_bounds__(THREADS)
banded_pairs_kernel(DeviceArrays g, bool staged, float* __restrict__ dpx,
                    float* __restrict__ dpy, float* __restrict__ dpz,
                    float* __restrict__ dvx, float* __restrict__ dvy,
                    float* __restrict__ dvz, int n, int window,
                    int i_limit) {
  extern __shared__ float smem[];
  const int i0 = blockIdx.x * TILE;
  const int span = TILE + 2 * window;
  Ranks in;
  if (staged) {                 // ranks [i0 - window, i0 + TILE + window)
    in.base = i0 - window;
    for (int f = 0; f < NF; ++f) {
      for (int i = threadIdx.x; i < span; i += THREADS) {
        const int r = in.base + i;
        smem[f * span + i] = (r >= 0 && r < n) ? g.f[f][r] : 0.0f;
      }
      in.src[f] = smem + f * span;
    }
  } else {
    in.base = 0;
    for (int f = 0; f < NF; ++f) in.src[f] = g.f[f];
  }
  unsigned* s_mask = reinterpret_cast<unsigned*>(smem + (staged ? NF * span : 0));
  for (int i = threadIdx.x; i < TILE * WORDS; i += THREADS) s_mask[i] = 0u;
  __syncthreads();

  const int slot = threadIdx.x % (2 * TILE);
  const int lane = threadIdx.x / (2 * TILE);
  const int lanes = THREADS / (2 * TILE);
  const bool jside = slot >= TILE;
  const int rl = jside ? slot - TILE : slot;   // this slot's rank, in the tile
  const int r = i0 + rl;
  const bool r_ok = r < n && in(ACT, r) > 0.0f;
  const float rx = r_ok ? in(PX, r) : 0.0f, ry = r_ok ? in(PY, r) : 0.0f;
  const float rz = r_ok ? in(PZ, r) : 0.0f, rr = r_ok ? in(RAD, r) : 0.0f;

  float ap[3] = {0.0f, 0.0f, 0.0f}, av[3] = {0.0f, 0.0f, 0.0f};
  const int wmax = min(window, n - 1);
  for (int dc = 0; dc < wmax; dc += D_CHUNK) {
    const int dend = min(dc + D_CHUNK, wmax);
    // ---- 1. test every pair of the chunk once, set the touching bits ----
    if (r_ok) {
#pragma unroll 1
      for (int d = dc + 1 + lane; d <= dend; d += lanes) {
        const int k = jside ? r - d : r;      // pair (k, j = k + d)
        const int j = k + d;
        if (jside ? (k < 0 || k >= i0) : j >= n) continue;
        if (k >= i_limit) continue;
        const int o = jside ? k : j;          // the other rank
        if (!(in(ACT, o) > 0.0f)) continue;
        const float ox = in(PX, o), oy = in(PY, o), oz = in(PZ, o);
        const float ex = jside ? ox - rx : rx - ox;
        const float ey = jside ? oy - ry : ry - oy;
        const float ez = jside ? oz - rz : rz - oz;
        const float d2 = fmaxf(ex * ex + ey * ey + ez * ez, 1e-12f);
        const float rsum = jside ? in(RAD, o) + rr : rr + in(RAD, o);
        if (d2 > rsum * rsum * 1.0001f) continue;   // far apart: no contact
        if (!(sqrtf(d2) < rsum)) continue;
        const int bit = 2 * (d - dc - 1) + (jside ? 1 : 0);
        atomicOr(&s_mask[rl * WORDS + (bit >> 5)], 1u << (bit & 31));
        const int jl = j - i0;                // j side too, if j is in the tile
        if (!jside && jl < TILE)
          atomicOr(&s_mask[jl * WORDS + ((bit + 1) >> 5)], 1u << ((bit + 1) & 31));
      }
    }
    __syncthreads();
    // ---- 2. each rank sums its touching pairs in the plain version's order
    if (threadIdx.x < TILE && r < n) {
#pragma unroll 1
      for (int w = 0; w < WORDS; ++w) {
        unsigned m = s_mask[rl * WORDS + w];
        s_mask[rl * WORDS + w] = 0u;
        while (m) {
          const int b = w * 32 + __ffs(m) - 1;
          m &= m - 1;
          const int d = dc + 1 + (b >> 1);
          const bool iside = (b & 1) == 0;
          const PairTerms t = pair_terms(iside ? r : r - d, iside ? r + d : r, in);
          if (iside) {
            ap[0] = ap[0] + t.push_i * t.ex;
            ap[1] = ap[1] + t.push_i * t.ey;
            ap[2] = ap[2] + t.push_i * t.ez;
            av[0] = av[0] + t.ai * t.ex;
            av[1] = av[1] + t.ai * t.ey;
            av[2] = av[2] + t.ai * t.ez;
          } else {
            ap[0] = ap[0] - t.push_j * t.ex;
            ap[1] = ap[1] - t.push_j * t.ey;
            ap[2] = ap[2] - t.push_j * t.ez;
            av[0] = av[0] - t.aj * t.ex;
            av[1] = av[1] - t.aj * t.ey;
            av[2] = av[2] - t.aj * t.ez;
          }
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < TILE && r < n) {
    dpx[r] = ap[0];
    dpy[r] = ap[1];
    dpz[r] = ap[2];
    dvx[r] = av[0];
    dvy[r] = av[1];
    dvz[r] = av[2];
  }
}

}  // namespace

extern "C" int w3d_banded_pairs(const float* px, const float* py,
                                const float* pz, const float* vx,
                                const float* vy, const float* vz,
                                const float* rad, const float* mass,
                                const float* elas, const float* act,
                                float* dpx, float* dpy, float* dpz,
                                float* dvx, float* dvy, float* dvz, int n,
                                int window, int i_limit, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (window > n) window = n;        // offsets past n - 1 hold no pair
  const DeviceArrays g = {{px, py, pz, vx, vy, vz, rad, mass, elas, act}};
  const int blocks = (n + TILE - 1) / TILE;
  const int mask_bytes = TILE * WORDS * (int)sizeof(unsigned);
  const long long staged_bytes =
      (long long)NF * (TILE + 2LL * window) * sizeof(float) + mask_bytes;
  const bool staged = staged_bytes <= 227 * 1024;
  const int smem = staged ? (int)staged_bytes : mask_bytes;
  if (smem > 48 * 1024) {            // above the default: opt in (W > 566)
    cudaError_t err = cudaFuncSetAttribute(
        banded_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  banded_pairs_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      g, staged, dpx, dpy, dpz, dvx, dvy, dvz, n, window, i_limit);
  return (int)cudaGetLastError();
}
