// The pedestrians' separation, hand-written for Hopper (sm_90a): the unit
// push away from every neighbour within the separation radius, one row per
// pedestrian of (x, y), summed over every column of its peers.
//
// Replaces: no TPU kernel.  The JAX package's `_separation`
// (3dworld_tpu/city/traffic.py:473) is plain jnp, which XLA fuses into its
// pair sums; on this card PyTorch ran it op by op, ~25 launches each over a
// [rows x peers] float32 temporary (400 MB at 10,000 x 10,000).  Plain
// PyTorch version: w3d_torch/city/traffic.py `separation_plain`; wrapper:
// w3d_torch/ops/cuda/separation_kernel.py.
//
// What bounds it on this card: the pair tests.  At 10,000 x 10,000 a call
// makes 10^8 of them, ~7 operations each (two offsets, two squares, an add,
// the compare with the radius and the self test), ~0.0105 ms at 67 TFLOP/s;
// its inputs and outputs are 160 KB.  Almost every test rejects the pair:
// the radius is 0.15 cells and a city block of 36 cells holds ~20 people.
//
// Design: a block of WARPS warps takes WARPS x ROWS rows, each warp ROWS of
// them, every lane of the warp all ROWS: a peer read from shared memory is
// tested against ROWS rows in registers, with one branch for all of them.
// The block stages the peers in tiles of TILE (x, y) pairs in shared
// memory, and lane l takes the columns
// j = l (mod 32) of each tile in ascending order, so a row's columns are
// split among the lanes by the peer count alone.  Only a pair within the
// radius (and not the row's own column, first + row) computes its weight
// 1 / max(d2, 1e-4) and adds w ex, w ey to the lane's sums; a far pair adds
// nothing, where the plain version adds an exact zero, which changes no bit
// of a sum that starts at +0.  A fixed xor butterfly then adds the lanes'
// sums (every lane ends with the same bits), and lane k normalises row k.
// No atomics: a row's bits depend only on the row and its peers, not on the
// number of rows or the grid, so a slab of rows equals those rows of the
// whole crowd's call bit for bit.
//
// Exactness: built with -fmad=false, every product and sum rounds on its
// own, as PyTorch's ops do.  `d2 < sep_radius ** 2` compares with the
// double rounded to float32 (aten casts the scalar to the tensor's type);
// `clamp(min=1e-4)` takes max with the float32 of 1e-4 (d2 is finite
// there, so NaN cannot reach it); `1.0 / t` is `t.reciprocal() * 1.0`, an
// IEEE divide; `sqrt(.) + 1e-9` and the two divides are IEEE too.  A row
// with at most two near neighbours sums at most two nonzero terms, which
// every order adds to the same bits, so it equals the plain version bit for
// bit; with three or more, `torch.sum`'s tree order may round the sum an
// ulp or two apart.  A non-finite coordinate in the row or among the peers
// makes the plain sum NaN (0 * inf); the kernel returns NaN there too.

#include <cuda_runtime.h>

namespace {

// 16 rows a block, 625 blocks at 10,000 rows: 4.7 a SM, 5.6% above an even
// share on the busiest SM (8 rows a warp: 0.0511 ms; 2 rows of 8 warps:
// 0.0544; 4 rows of 8 warps: 0.0492; this: 0.0469, H100 SXM)
constexpr int WARPS = 4;      // warps a block
constexpr int ROWS = 4;       // rows a warp; each lane holds all of them
constexpr int THREADS = WARPS * 32;
constexpr int BLOCK_ROWS = WARPS * ROWS;
constexpr int TILE = 2048;    // peers staged at a time (16 KB), a multiple of 32
static_assert(ROWS <= 32, "lane k writes row k");

__global__ void __launch_bounds__(THREADS)
separation_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ px, const float* __restrict__ py,
                  int rows, int n, int first, float r2,
                  float* __restrict__ ox, float* __restrict__ oy) {
  __shared__ float2 tile[TILE];
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BLOCK_ROWS + (threadIdx.x >> 5) * ROWS;

  float rx[ROWS], ry[ROWS], sx[ROWS], sy[ROWS];
  int bad = 0;   // a non-finite coordinate in one of the rows or the peers
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int r = row0 + k;
    rx[k] = r < rows ? x[r] : 0.0f;
    ry[k] = r < rows ? y[r] : 0.0f;
    sx[k] = 0.0f;
    sy[k] = 0.0f;
  }

  for (int t0 = 0; t0 < n; t0 += TILE) {
    const int len = min(TILE, n - t0);
    __syncthreads();   // the previous tile is read
    int staged_bad = 0;
    for (int j = threadIdx.x; j < len; j += THREADS) {
      const float2 p = make_float2(px[t0 + j], py[t0 + j]);
      staged_bad |= !(isfinite(p.x) && isfinite(p.y));
      tile[j] = p;
    }
    bad |= __syncthreads_or(staged_bad);
#pragma unroll 2
    for (int j = lane; j < len; j += 32) {
      const float2 p = tile[j];
      float ex[ROWS], ey[ROWS], d2[ROWS];
      float least = r2;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        ex[k] = rx[k] - p.x;
        ey[k] = ry[k] - p.y;
        d2[k] = ex[k] * ex[k] + ey[k] * ey[k];
        least = fminf(least, d2[k]);    // a NaN d2 is never near, and drops out
      }
      if (least < r2) {                 // one branch a peer, rarely taken
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          if (d2[k] < r2 && t0 + j != first + row0 + k) {
            const float w = 1.0f / fmaxf(d2[k], (float)1e-4);
            sx[k] += w * ex[k];
            sy[k] += w * ey[k];
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sx[k] += __shfl_xor_sync(0xffffffffu, sx[k], off);
      sy[k] += __shfl_xor_sync(0xffffffffu, sy[k], off);
    }
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int r = row0 + k;
    if (lane == k && r < rows) {
      if (bad || !(isfinite(rx[k]) && isfinite(ry[k]))) {
        ox[r] = __int_as_float(0x7fffffff);
        oy[r] = __int_as_float(0x7fffffff);
      } else {
        const float rl = sqrtf(sx[k] * sx[k] + sy[k] * sy[k]) + (float)1e-9;
        ox[r] = sx[k] / rl;
        oy[r] = sy[k] / rl;
      }
    }
  }
}

}  // namespace

// Unit pushes (ox, oy) of `rows` pedestrians at (x, y) away from the `n`
// peers at (px, py) within sqrt(r2); row r is peer first + r, which it skips.
extern "C" int w3d_separation(const float* x, const float* y, const float* px,
                              const float* py, int rows, int n, int first, float r2,
                              float* ox, float* oy, void* stream) {
  if (rows > 0 && n > 0) {
    separation_kernel<<<(rows + BLOCK_ROWS - 1) / BLOCK_ROWS, THREADS, 0,
                        (cudaStream_t)stream>>>(x, y, px, py, rows, n, first, r2, ox, oy);
  }
  return (int)cudaGetLastError();
}
