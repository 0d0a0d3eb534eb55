// Sphere-vs-cobj penetration formulas shared by the narrow-phase kernel
// (narrow.cu) and the fused substep kernel (substep.cu).
//
// Each function takes one row of the packed cobj field table
// (physics/cobj_table.py layout) and an object's centre
// and radius, and returns the penetration depth and push-out normal the
// plain PyTorch versions compute for that shape (physics/cobjs.py and
// physics/fused.py), op for op: built with -fmad=false, every product and
// sum rounds on its own.  Sqrt and divide are IEEE; the rotated cylinder's
// 1/|ab| is a divide by sqrtf, not the approximate rsqrtf.
//
// A row is any view `c` whose c[k] is column k; both kernels read a
// `FieldRow<S>` into a field-major [CF_USED][S] table in shared memory,
// one chunk of at most CHUNK_ROWS rows at a time (`stage_field_table`,
// `stage_chunk`).  `team_walk` streams every chunk, splits one object's
// rows over a team of lanes and merges what the lanes kept: the first
// deepest row (`FirstDeepest`, narrow.cu) or the sums of the rows tied at
// the deepest penetration (`TieSums`, substep.cu).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace w3d {

constexpr int CF = 32;   // packed field columns per cobj (padded)
constexpr int CF_USED = 27;   // columns in use (physics/cobj_table.CF_COLUMNS)
// column indices of the packed table (physics/cobj_table.CF_COLUMNS)
constexpr int C_SHAPE = 0, C_P1 = 1, C_P2 = 4, C_R1 = 7, C_R2 = 8,
              C_NPTS = 9, C_PTS = 10, C_PN = 22, C_ELAS = 25, C_FRIC = 26;
constexpr float EPS = 1e-12f;

struct Hit {
  float pen, nx, ny, nz;
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// (|a|, a/|a|) with the plain version's guard
__device__ __forceinline__ float norm3(float ax, float ay, float az,
                                       float* nx, float* ny, float* nz) {
  const float d = sqrtf(ax * ax + ay * ay + az * az);
  const float inv = 1.0f / fmaxf(d, EPS);
  *nx = ax * inv;
  *ny = ay * inv;
  *nz = az * inv;
  return d;
}

template <class V>
__device__ __forceinline__ Hit cube(const V& c, float X, float Y, float Z,
                                    float r) {
  const float lox = fminf(c[C_P1], c[C_P2]), hix = fmaxf(c[C_P1], c[C_P2]);
  const float loy = fminf(c[C_P1 + 1], c[C_P2 + 1]),
              hiy = fmaxf(c[C_P1 + 1], c[C_P2 + 1]);
  const float loz = fminf(c[C_P1 + 2], c[C_P2 + 2]),
              hiz = fmaxf(c[C_P1 + 2], c[C_P2 + 2]);
  const float cx = clampf(X, lox, hix), cy = clampf(Y, loy, hiy),
              cz = clampf(Z, loz, hiz);
  float ox, oy, oz;
  const float dist_out = norm3(X - cx, Y - cy, Z - cz, &ox, &oy, &oz);
  const bool outside = dist_out > 1e-9f;
  const float dxl = X - lox, dxh = hix - X;
  const float dyl = Y - loy, dyh = hiy - Y;
  const float dzl = Z - loz, dzh = hiz - Z;
  const float dx_m = fminf(dxl, dxh), dy_m = fminf(dyl, dyh),
              dz_m = fminf(dzl, dzh);
  const float din = fminf(dx_m, fminf(dy_m, dz_m));
  const bool use_x = din == dx_m;
  const bool use_y = (din == dy_m) && !use_x;
  const bool use_z = !use_x && !use_y;
  Hit h;
  h.pen = outside ? r - dist_out : r + din;
  h.nx = outside ? ox : (use_x ? (dxl < dxh ? -1.0f : 1.0f) : 0.0f);
  h.ny = outside ? oy : (use_y ? (dyl < dyh ? -1.0f : 1.0f) : 0.0f);
  h.nz = outside ? oz : (use_z ? (dzl < dzh ? -1.0f : 1.0f) : 0.0f);
  return h;
}

template <class V>
__device__ __forceinline__ Hit sphere(const V& c, float X, float Y,
                                      float Z, float r) {
  Hit h;
  const float dist =
      norm3(X - c[C_P1], Y - c[C_P1 + 1], Z - c[C_P1 + 2], &h.nx, &h.ny, &h.nz);
  h.pen = (r + c[C_R1]) - dist;
  return h;
}

template <class V>
__device__ __forceinline__ Hit vcylinder(const V& c, float X, float Y,
                                         float Z, float r) {
  const float zlo = fminf(c[C_P1 + 2], c[C_P2 + 2]);
  const float zhi = fmaxf(c[C_P1 + 2], c[C_P2 + 2]);
  const float rxy = fmaxf(c[C_R1], c[C_R2]);
  const float ddx = X - c[C_P1], ddy = Y - c[C_P1 + 1];
  const float dist_xy = sqrtf(ddx * ddx + ddy * ddy);
  const float inv_xy = 1.0f / fmaxf(dist_xy, EPS);
  const bool in_z = (Z > zlo - r) && (Z < zhi + r);
  const float pen_side = (r + rxy) - dist_xy;
  const float top_pen = (zhi + r) - Z;
  const float bot_pen = Z - (zlo - r);
  const bool cap_is_top = top_pen < bot_pen;
  const float pen_cap = fminf(top_pen, bot_pen);
  const bool use_cap = (dist_xy < rxy) && (pen_cap < pen_side);
  Hit h;
  h.pen = (in_z && dist_xy < rxy + r) ? (use_cap ? pen_cap : pen_side) : -1.0f;
  h.nx = use_cap ? 0.0f : ddx * inv_xy;
  h.ny = use_cap ? 0.0f : ddy * inv_xy;
  h.nz = use_cap ? (cap_is_top ? 1.0f : -1.0f) : 0.0f;
  return h;
}

template <class V>
__device__ __forceinline__ Hit capsule(const V& c, float X, float Y,
                                       float Z, float r) {
  const float p1x = c[C_P1], p1y = c[C_P1 + 1], p1z = c[C_P1 + 2];
  const float abx = c[C_P2] - p1x, aby = c[C_P2 + 1] - p1y,
              abz = c[C_P2 + 2] - p1z;
  const float ab2 = fmaxf(abx * abx + aby * aby + abz * abz, EPS);
  const float t = clampf(
      ((X - p1x) * abx + (Y - p1y) * aby + (Z - p1z) * abz) / ab2, 0.0f, 1.0f);
  Hit h;
  const float dist_seg = norm3(X - (p1x + t * abx), Y - (p1y + t * aby),
                               Z - (p1z + t * abz), &h.nx, &h.ny, &h.nz);
  const float rad_t = c[C_R1] + t * (c[C_R2] - c[C_R1]);
  h.pen = (r + rad_t) - dist_seg;
  return h;
}

template <class V>
__device__ __forceinline__ Hit polygon(const V& c, float X, float Y,
                                       float Z, float r) {
  const float pnx = c[C_PN], pny = c[C_PN + 1], pnz = c[C_PN + 2];
  const float npts = c[C_NPTS];
  // point k's axis a is column C_PTS + 3k + a
  const float dp = (X - c[C_PTS]) * pnx + (Y - c[C_PTS + 1]) * pny +
                   (Z - c[C_PTS + 2]) * pnz;
  const float side = dp > 0.0f ? 1.0f : (dp < 0.0f ? -1.0f : 0.0f);
  const float prx = X - dp * pnx, pry = Y - dp * pny, prz = Z - dp * pnz;
  bool inside = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int kn = (k + 1) % 4;
    const bool nxt_ok = (float)kn < npts;
    const float ax = c[C_PTS + 3 * k], ay = c[C_PTS + 3 * k + 1],
                az = c[C_PTS + 3 * k + 2];
    const float bx = nxt_ok ? c[C_PTS + 3 * kn] : c[C_PTS];
    const float by = nxt_ok ? c[C_PTS + 3 * kn + 1] : c[C_PTS + 1];
    const float bz = nxt_ok ? c[C_PTS + 3 * kn + 2] : c[C_PTS + 2];
    const float ex = bx - ax, ey = by - ay, ez = bz - az;
    const float vx = prx - ax, vy = pry - ay, vz = prz - az;
    const float crx = ey * vz - ez * vy;
    const float cry = ez * vx - ex * vz;
    const float crz = ex * vy - ey * vx;
    const bool ok = (crx * pnx + cry * pny + crz * pnz) >= -1e-7f;
    inside = inside && ((float)k < npts ? ok : true);
  }
  Hit h;
  h.pen = inside ? (r + 0.5f * c[C_R1]) - fabsf(dp) : -1.0f;
  h.nx = pnx * side;
  h.ny = pny * side;
  h.nz = pnz * side;
  return h;
}

template <class V>
__device__ __forceinline__ Hit torus(const V& c, float X, float Y,
                                     float Z, float r) {
  const float tx = X - c[C_P1], ty = Y - c[C_P1 + 1], tz = Z - c[C_P1 + 2];
  const float axx = c[C_P2], axy = c[C_P2 + 1], axz = c[C_P2 + 2];
  const float axial = tx * axx + ty * axy + tz * axz;
  const float rvx = tx - axial * axx, rvy = ty - axial * axy,
              rvz = tz - axial * axz;
  const float radial = sqrtf(rvx * rvx + rvy * rvy + rvz * rvz);
  const float rinv = c[C_R1] / fmaxf(radial, EPS);
  Hit h;
  const float dist_ring = norm3(tx - rvx * rinv, ty - rvy * rinv,
                                tz - rvz * rinv, &h.nx, &h.ny, &h.nz);
  h.pen = (r + c[C_R2]) - dist_ring;
  return h;
}

template <class V>
__device__ __forceinline__ Hit rcylinder(const V& c, float X, float Y,
                                         float Z, float r) {
  const float p1x = c[C_P1], p1y = c[C_P1 + 1], p1z = c[C_P1 + 2];
  const float abx = c[C_P2] - p1x, aby = c[C_P2 + 1] - p1y,
              abz = c[C_P2 + 2] - p1z;
  const float ab2 = fmaxf(abx * abx + aby * aby + abz * abz, EPS);
  const float leninv = 1.0f / sqrtf(ab2);
  const float length = ab2 * leninv;
  const float r1 = c[C_R1], r2 = c[C_R2];
  const float t_un =
      ((X - p1x) * abx + (Y - p1y) * aby + (Z - p1z) * abz) / ab2;
  const float t_cl = clampf(t_un, 0.0f, 1.0f);
  float rnx, rny, rnz;
  const float rdist = norm3(X - (p1x + t_un * abx), Y - (p1y + t_un * aby),
                            Z - (p1z + t_un * abz), &rnx, &rny, &rnz);
  const float rad_tc = r1 + t_cl * (r2 - r1);
  const bool in_t = (t_un >= 0.0f) && (t_un <= 1.0f);
  const float pen_s = (rad_tc + r) - rdist;
  const bool side_ok = in_t && (pen_s > 0.0f);
  const bool d_end = t_un > 0.5f;
  const float end_r = d_end ? r2 : r1;
  const float axial_out = fmaxf(fmaxf(-t_un, t_un - 1.0f), 0.0f) * length;
  const float tv_cl = (d_end ? 1.0f - t_cl : t_cl) * length;
  const float pen_e = r - axial_out;
  const bool end_ok = (end_r > 0.0f) && (tv_cl < fminf(r, rdist)) &&
                      (rdist <= rad_tc + r) && (pen_e > 0.0f);
  const float sgn = d_end ? 1.0f : -1.0f;
  const bool use_end = end_ok && (!side_ok || (pen_e < pen_s));
  Hit h;
  h.pen = use_end ? pen_e : (side_ok ? pen_s : -1.0f);
  h.nx = use_end ? sgn * abx * leninv : rnx;
  h.ny = use_end ? sgn * aby * leninv : rny;
  h.nz = use_end ? sgn * abz * leninv : rnz;
  return h;
}

// The formula of group g of the shape-sorted table (physics/cobjs.py
// GroupedCobjs.SHAPE_ORDER).
template <class V>
__device__ __forceinline__ Hit eval_group(int g, const V& c, float X, float Y,
                                          float Z, float r) {
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

// Row `row` of a field-major [CF_USED][S] table: column k sits S floats
// after column k - 1, so every column offset is an immediate.
template <int S>
struct FieldRow {
  const float* p;   // &table[0][row]
  __device__ __forceinline__ float operator[](int k) const { return p[k * S]; }
};

constexpr int NO_ROW = 0x7fffffff;
// rows of the packed table a CTA holds in shared memory at once, and the
// row stride of its field-major copy there: one chunk in 48 KB
// (narrow_kernel.CHUNK_ROWS).  A larger table streams through in chunks.
// A variant build may set a smaller multiple of 4 (-DW3D_CHUNK_ROWS=64), so
// that a small table too takes several chunks.
#ifdef W3D_CHUNK_ROWS
constexpr int CHUNK_ROWS = W3D_CHUNK_ROWS;
#else
constexpr int CHUNK_ROWS = 48 * 1024 / (CF * 4);
#endif
static_assert(CHUNK_ROWS % 4 == 0 && CHUNK_ROWS <= 48 * 1024 / (CF * 4),
              "a chunk is float4 rows in 48 KB");

// Every thread of the CTA (`block` threads) copies rows [c0, c0 + rows) of
// the compact field-major table `tab` ([CF_USED][m4]; m4, c0 and rows
// multiples of 4, rows at most CHUNK_ROWS) as float4s into the
// stride-CHUNK_ROWS columns of `s_tab`.  No barrier.
__device__ __forceinline__ void stage_chunk(float* s_tab, const float* tab,
                                            int m4, int c0, int rows,
                                            int block) {
  const int q = rows / 4;   // float4s per column of the chunk
  const float4* src = reinterpret_cast<const float4*>(tab + c0);
  float4* dst = reinterpret_cast<float4*>(s_tab);
  for (int k = threadIdx.x; k < CF_USED * q; k += block) {
    const int col = k / q;
    const int j = k - col * q;
    dst[col * (CHUNK_ROWS / 4) + j] = src[col * (m4 / 4) + j];
  }
}

// The kernels' first step: stage the table's first chunk (CHUNKED false:
// the whole table, m4 at most CHUNK_ROWS) and the 8 group starts into
// `s_start`; returns after the CTA's barrier.
template <bool CHUNKED>
__device__ __forceinline__ void stage_field_table(float* s_tab, int* s_start,
                                                  const float* tab, int m4,
                                                  const int* gstart,
                                                  int block) {
  stage_chunk(s_tab, tab, m4, 0, CHUNKED ? CHUNK_ROWS : m4, block);
  if (threadIdx.x < 8) s_start[threadIdx.x] = gstart[threadIdx.x];
  __syncthreads();
}

// One team's walk over rows [c0, c1) of the shape-sorted table (group g in
// rows [gstart[g], gstart[g + 1])), staged at `s_tab` (row c0 first).  Lane
// `lane` evaluates the rows gstart[g] + lane, + K, ... of each group that
// fall in the chunk, so a lane sees the rows it would see in one pass over
// the whole table, in the same order, wherever the chunk starts.  WHOLE:
// the chunk is the whole table (c0 = 0, c1 past every group), and no row
// is clipped.
template <int K, bool WHOLE, class Acc>
__device__ __forceinline__ void walk_chunk(const float* s_tab,
                                           const int* gstart, int c0, int c1,
                                           float X, float Y, float Z, float r,
                                           int lane, Acc& acc) {
#pragma unroll
  for (int g = 0; g < 7; ++g) {
    int row = gstart[g] + lane, hi = gstart[g + 1];
    if constexpr (!WHOLE) {
      const int lo = max(gstart[g], c0);
      hi = min(hi, c1);
      if (row < lo) row += (lo - row + K - 1) & -K;   // first of the lane's rows in the chunk
    }
    for (; row < hi; row += K) {
      const FieldRow<CHUNK_ROWS> c{s_tab + (row - c0)};
      const Hit h = c[C_SHAPE] == 0.0f ? Hit{-1.0f, 0.0f, 0.0f, 0.0f}
                                       : eval_group(g, c, X, Y, Z, r);
      acc.add(h, row, c);
    }
  }
}

// One object's walk over the whole compact field-major table `tab`
// ([CF_USED][m4]), split over a team of K consecutive lanes of a warp (K a
// power of two, at most 32, teams aligned to K; every thread of the CTA
// must call it, since the chunks' barriers are the CTA's).  The first
// chunk is staged (`stage_field_table`).  CHUNKED false: that chunk is
// the whole table (m4 at most CHUNK_ROWS), walked in one pass with no
// chunk state in registers.  CHUNKED true: each further chunk waits for
// every team to finish the one before, is staged in its place, and is
// walked in turn.  All teams of a warp run the same group's formula at the
// same time.  Dead padding slots (shape 0) score -1 with a zero normal and
// stay candidates, as in the plain versions.  Each lane folds its rows, in
// row order across the chunks, into `acc` (`acc.add(hit, row, c)`); then
// the team merges over offsets K/2 .. 1 (`acc.merge(off)`, xor shuffles),
// after which every lane holds the team's result.
template <int K, bool CHUNKED, class Acc>
__device__ __forceinline__ void team_walk(float* s_tab, const int* gstart,
                                          const float* tab, int m4, int block,
                                          float X, float Y, float Z, float r,
                                          int lane, Acc& acc) {
  if constexpr (!CHUNKED) {
    walk_chunk<K, true>(s_tab, gstart, 0, m4, X, Y, Z, r, lane, acc);
  } else {
    for (int c0 = 0;; c0 += CHUNK_ROWS) {
      walk_chunk<K, false>(s_tab, gstart, c0, min(m4, c0 + CHUNK_ROWS), X, Y,
                           Z, r, lane, acc);
      if (c0 + CHUNK_ROWS >= m4) break;
      __syncthreads();
      stage_chunk(s_tab, tab, m4, c0 + CHUNK_ROWS,
                  min(m4 - (c0 + CHUNK_ROWS), CHUNK_ROWS), block);
      __syncthreads();
    }
  }
#pragma unroll
  for (int off = K / 2; off > 0; off /= 2) acc.merge(off);
}

// The strictly deepest row and its hit.  A lane keeps the first of its own
// rows on ties; the merge takes the other lane's row when it is deeper or
// equally deep with a lower index: the first index on ties, as
// torch.argmax, for finite input.  `row` is NO_ROW for a table without
// rows.
struct FirstDeepest {
  Hit best;
  int row;

  // (the start values are set in the body: nvcc's host pass drops device
  // function bodies, not member initializers, and has no CUDART_INF_F)
  __device__ FirstDeepest() {
    best = Hit{-CUDART_INF_F, 0.0f, 0.0f, 0.0f};
    row = NO_ROW;
  }

  template <class V>
  __device__ __forceinline__ void add(const Hit& h, int r, const V&) {
    if (h.pen > best.pen) {
      best = h;
      row = r;
    }
  }
  __device__ __forceinline__ void merge(int off) {
    const Hit o = {__shfl_xor_sync(0xffffffffu, best.pen, off),
                   __shfl_xor_sync(0xffffffffu, best.nx, off),
                   __shfl_xor_sync(0xffffffffu, best.ny, off),
                   __shfl_xor_sync(0xffffffffu, best.nz, off)};
    const int o_row = __shfl_xor_sync(0xffffffffu, row, off);
    if (o.pen > best.pen || (o.pen == best.pen && o_row < row)) {
      best = o;
      row = o_row;
    }
  }
};

// The deepest penetration, the count of rows at it, and the sums of their
// normals, elasticities and frictions (the fused substep averages ties).
// The merge takes the other lane's record when it is deeper and adds counts
// and sums when it is equally deep.  A lane sums its own tied rows in row
// order and the team adds the lanes' sums pairwise, so one or two tied rows
// give the sum of a serial walk to the bit; three or more may differ in
// the last place.
struct TieSums {
  float pen, nx, ny, nz, el, fr;
  int count;

  __device__ TieSums() {   // start values in the body, as FirstDeepest's
    pen = -CUDART_INF_F;
    nx = ny = nz = el = fr = 0.0f;
    count = 0;
  }

  template <class V>
  __device__ __forceinline__ void add(const Hit& h, int, const V& c) {
    if (h.pen > pen) {
      pen = h.pen;
      count = 1;
      nx = h.nx;
      ny = h.ny;
      nz = h.nz;
      el = c[C_ELAS];
      fr = c[C_FRIC];
    } else if (h.pen == pen) {
      ++count;
      nx = nx + h.nx;
      ny = ny + h.ny;
      nz = nz + h.nz;
      el = el + c[C_ELAS];
      fr = fr + c[C_FRIC];
    }
  }
  __device__ __forceinline__ void merge(int off) {
    const float o_pen = __shfl_xor_sync(0xffffffffu, pen, off);
    const float o_nx = __shfl_xor_sync(0xffffffffu, nx, off);
    const float o_ny = __shfl_xor_sync(0xffffffffu, ny, off);
    const float o_nz = __shfl_xor_sync(0xffffffffu, nz, off);
    const float o_el = __shfl_xor_sync(0xffffffffu, el, off);
    const float o_fr = __shfl_xor_sync(0xffffffffu, fr, off);
    const int o_count = __shfl_xor_sync(0xffffffffu, count, off);
    if (o_pen > pen) {
      pen = o_pen;
      count = o_count;
      nx = o_nx;
      ny = o_ny;
      nz = o_nz;
      el = o_el;
      fr = o_fr;
    } else if (o_pen == pen) {
      count += o_count;
      nx = nx + o_nx;
      ny = ny + o_ny;
      nz = nz + o_nz;
      el = el + o_el;
      fr = fr + o_fr;
    }
  }
};

}  // namespace w3d
