// Fused physics substep, hand-written for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_substep_kernel`
// (3dworld_tpu/ops/pallas/physics_kernel.py:84-510, pallas_call at :543),
// which `physics/step.step_objects_fused` calls once per substep through
// `substep_pallas`.  Plain PyTorch version: w3d_torch/physics/fused.py
// `substep_plain`; wrapper: w3d_torch/ops/cuda/physics_kernel.py.
//
// One whole substep per object: integrate (gravity, terminal velocity,
// wind drag) -> bilinear mesh sample from the [3*my, mx] stack of height
// and gradient maps -> water skip/float/sink -> narrow phase against every
// row of the packed cobj table -> cobj bounce or stick -> mesh bounce ->
// on-ground rolling.
//
// What bounds it on this card: latency in the narrow phase.  Each object
// runs its M rows' formulas (M = 112 for the spheres scene), tens of
// dependent flops with a sqrt and a divide each; device memory sees 15
// words in and 8 out per object, 12 map taps that stay in L1/L2, and the
// 12 KB table per block.  With one thread per object, N = 10K is 79 CTAs
// of 128 threads, under one wave of the 132 SMs, and each warp waits out
// every instruction's latency through M serial rows.
//
// Design: the narrow phase's (narrow.cu): a team of LANES (8) consecutive
// threads per object, so N = 10K fills the card with 80K threads.  Every
// lane of a team runs the per-object preamble (integrate, mesh sample,
// water) on the same object, whose loads are one transaction for the 8
// lanes, so no state is shuffled.  The rows then split over the lanes,
// group by group of the shape-sorted table (cobj_shapes.cuh `team_walk`),
// against a field-major copy in shared memory with the fixed row stride
// CHUNK_ROWS, staged per CTA from the compact [CF_USED][m4] copy the
// wrapper passes, one chunk of at most CHUNK_ROWS rows at a time: the first
// before the preamble (`stage_field_table`), the others, for a table of
// more rows, between barriers in the walk; a table of one chunk takes its
// own instantiation with no chunk loop.  Each lane keeps the deepest penetration of
// its rows with their tie count and the sums of the tied rows' normals,
// elasticities and frictions (`TieSums`); the team merges the lanes'
// records with xor shuffles, adding counts and sums on equal pens, and the
// sums are scaled by 1/count, as `wnorm = wsel / count` averages them (for
// one or two tied rows the result is the serial walk's to the bit; three or
// more can differ in the last place).  Team lane 0 alone runs the bounces
// and the rolling and writes the 8 outputs; a team past the last object
// evaluates the last object and writes nothing, since every lane of the
// warp takes part in the merge's shuffles.  The map taps are read straight
// from global memory and contract x first, then y, in the order of the TPU
// kernel's `maps @ XW` product.  Built with -fmad=false: every product and
// sum rounds on its own, as the plain version's ops do.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "cobj_shapes.cuh"

namespace {

using namespace w3d;
constexpr int LANES = 8;
constexpr int BLOCK = 256;

// FL_* object flag bits (physics/types.py)
constexpr int FL_COLLIDED = 1 << 0, FL_STATIC_COBJ_COLL = 1 << 1,
              FL_Z_STOPPED = 1 << 2, FL_XY_STOPPED = 1 << 3,
              FL_IN_WATER = 1 << 4, FL_FLOATING = 1 << 5,
              FL_UNDERWATER = 1 << 6;
// physics/types.py constants, as float32 (the JAX package's weak typing)
constexpr float GRAVITY = 300.0f, STICK_THRESHOLD = 1.0f,
                WATER_DENSITY = 1.0f, BOUNCE_CUTOFF = 4.0f,
                WATER_ELASTIC = 0.6f, LAND_ELASTICITY = 0.8f,
                WATER_DAMPING = 0.1f, CRITICAL_ANGLE = 0.5f,
                MAX_SPLASH_DEPTH = 0.1f, KILL_DEPTH = 12.0f,
                RECOVER_DEPTH = 1.0f, SURF_ADV_STEP = 2.0f,
                DEF_TIMESTEP = 0.007f;
// (1 - WATER_SURF_FRICTION) rounded from double, as Python computes it
constexpr float SURF_AIR = (float)(1.0 - 0.95);
constexpr float PI_F = 3.14159265358979323846f;

struct Bounce {
  float x, y, z;
  bool did;
};

// step.bounce_velocity (Physics.cpp:1349-1409): reflect about the normal,
// scale xy by e*(1-air), z by e; keep it only above the speed cutoff
__device__ __forceinline__ Bounce bounce(float vx, float vy, float vz,
                                         float nx, float ny, float nz,
                                         float e, float air) {
  e = clampf(e, 0.0f, 1.0f);
  const float vdn = vx * nx + vy * ny + vz * nz;
  float bx = vx - 2.0f * vdn * nx;
  float by = vy - 2.0f * vdn * ny;
  float bz = vz - 2.0f * vdn * nz;
  const float exy = e * (1.0f - air);
  bx = bx * exy;
  by = by * exy;
  bz = bz * e;
  const bool did = (bx * bx + by * by + bz * bz) >= BOUNCE_CUTOFF;
  return Bounce{did ? bx : vx, did ? by : vy, did ? bz : vz, did};
}

// x first, then y: a(y) = m[y, x0] (1-fx) + m[y, x0+1] fx,
// value = a(y0) (1-fy) + a(y0+1) fy
__device__ __forceinline__ float tap(const float* __restrict__ m, int mx,
                                     int iy, int ix, float wx0, float fx,
                                     float wy0, float fy) {
  const float* r0 = m + iy * mx + ix;
  const float* r1 = r0 + mx;
  const float a0 = __ldg(r0) * wx0 + __ldg(r0 + 1) * fx;
  const float a1 = __ldg(r1) * wx0 + __ldg(r1 + 1) * fx;
  return a0 * wy0 + a1 * fy;
}

// CHUNKED: the table spans more than one shared-memory chunk
template <bool CHUNKED>
__global__ void __launch_bounds__(BLOCK) substep_kernel(
    const float* __restrict__ env, const float* __restrict__ maps, int my,
    int mx, const float* __restrict__ tab,   // [CF_USED][m4]
    int m4, const int* __restrict__ gstart,  // [8]
    const float* __restrict__ px_in, const float* __restrict__ py_in,
    const float* __restrict__ pz_in, const float* __restrict__ vx_in,
    const float* __restrict__ vy_in, const float* __restrict__ vz_in,
    const int* __restrict__ st_in, const int* __restrict__ fl_in,
    const float* __restrict__ rad_in, const float* __restrict__ air_in,
    const float* __restrict__ fric_in, const float* __restrict__ grav_in,
    const float* __restrict__ elas_in, const float* __restrict__ dens_in,
    const float* __restrict__ tv_in, float* __restrict__ px_out,
    float* __restrict__ py_out, float* __restrict__ pz_out,
    float* __restrict__ vx_out, float* __restrict__ vy_out,
    float* __restrict__ vz_out, int* __restrict__ st_out,
    int* __restrict__ fl_out, int n) {
  __shared__ __align__(16) float s_tab[CF_USED * CHUNK_ROWS];
  __shared__ int s_start[8];
  stage_field_table<CHUNKED>(s_tab, s_start, tab, m4, gstart, BLOCK);
  const int i = (int)(((long long)blockIdx.x * BLOCK + threadIdx.x) / LANES);
  const int lane = threadIdx.x % LANES;
  const int o = i < n ? i : n - 1;   // a team past the last object

  // ---- env scalars ----
  const float tstep = env[0], base_gravity = env[1];
  const float wx = env[2], wy = env[3], wz = env[4];
  const float wpz = env[5];
  const float dx_inv = env[6], dy_inv = env[7];
  const float x_scene = env[8], dx_val = env[9], dy_val = env[10];

  // ---- state and per-object params ----
  float px = px_in[o], py = py_in[o], pz = pz_in[o];
  float vx = vx_in[o], vy = vy_in[o], vz = vz_in[o];
  int status = st_in[o], flags = fl_in[o];
  const float rad = rad_in[o], air = air_in[o], fric = fric_in[o];
  const float grav = grav_in[o], elas = elas_in[o], dens = dens_in[o];
  const float tv = tv_in[o];

  const bool alive = status > 0;
  // capture + clear last-substep collision (Physics.cpp:720-721)
  const bool coll_last = (flags & FL_COLLIDED) != 0;
  flags &= ~FL_COLLIDED;
  const bool floating = (flags & FL_FLOATING) != 0;
  const bool z_stop = (flags & FL_Z_STOPPED) != 0;
  const bool xy_stop = (flags & FL_XY_STOPPED) != 0;
  const bool underwater = (flags & FL_UNDERWATER) != 0;
  const bool in_water = (flags & FL_IN_WATER) != 0;
  const bool moving = alive && status == 1;
  const bool grounded = alive && (status == 2 || status == 3);

  // ---- integrate (Physics.cpp:760-833) ----
  const float air_eff = underwater ? 0.0f : (floating ? SURF_AIR * air : air);
  const float gscale = (in_water && dens > WATER_DENSITY)
                           ? (dens - WATER_DENSITY) / dens : 1.0f;
  const bool can_fall = moving && !z_stop;
  const float vz_new =
      (-vz < tv) ? fmaxf(vz - base_gravity * gscale * GRAVITY * tstep * grav,
                         -tv)
                 : vz;
  vz = can_fall ? vz_new : ((z_stop && moving) ? 0.0f : vz);
  if (can_fall && ((fabsf(air_eff * wz) > fabsf(vz)) || ((wz < 0.0f) != (vz < 0.0f))))
    vz = vz + air_eff * wz;
  const bool move_xy = moving && !xy_stop;
  const bool collided = coll_last || (fabsf(vz) < 1.0e-6f);
  {
    const float vtx = vx + (collided ? 0.0f : wx);
    const bool cx = (fabsf(air_eff * vtx) > fabsf(vx)) || ((vtx < 0.0f) != (vx < 0.0f));
    if (cx && move_xy) vx = (1.0f - air_eff) * vx + air_eff * vtx;
    const float vty = vy + (collided ? 0.0f : wy);
    const bool cy = (fabsf(air_eff * vty) > fabsf(vy)) || ((vty < 0.0f) != (vy < 0.0f));
    if (cy && move_xy) vy = (1.0f - air_eff) * vy + air_eff * vty;
  }
  px = px + (move_xy ? tstep * vx : 0.0f);
  py = py + (move_xy ? tstep * vy : 0.0f);
  pz = pz + (moving ? tstep * vz : 0.0f);

  // ---- mesh sample ----
  const float gx = px * dx_inv + (float)(mx / 2);
  const float gy = py * dy_inv + (float)(my / 2);
  const float x0 = clampf(floorf(gx), 0.0f, (float)(mx - 2));
  const float y0 = clampf(floorf(gy), 0.0f, (float)(my - 2));
  const float fx = clampf(gx - x0, 0.0f, 1.0f);
  const float fy = clampf(gy - y0, 0.0f, 1.0f);
  const int ix = (int)x0, iy = (int)y0;
  const float wx0 = 1.0f - fx, wy0 = 1.0f - fy;
  const float mh = tap(maps, mx, iy, ix, wx0, fx, wy0, fy);
  const float sx = tap(maps, mx, my + iy, ix, wx0, fx, wy0, fy);
  const float sy = tap(maps, mx, 2 * my + iy, ix, wx0, fx, wy0, fy);
  const float ninv = 1.0f / sqrtf(sx * sx + sy * sy + 1.0f);
  const float mnx = -sx * ninv, mny = -sy * ninv, mnz = ninv;
  const bool off_mesh = (gx < 0.0f) || (gx >= (float)mx) || (gy < 0.0f) ||
                        (gy >= (float)my);
  const bool on_mesh = !off_mesh && ((pz - rad) <= mh);

  // ---- water (Physics.cpp:1082-1180) ----
  const bool over_water = !off_mesh && (wpz > mh);
  bool touches_water = over_water && ((pz - rad) < wpz) && alive;
  const float v_sq = vx * vx + vy * vy + vz * vz;
  const bool fast = v_sq >= BOUNCE_CUTOFF;
  const float den_ratio = WATER_DENSITY / (dens + WATER_DENSITY);
  const float damp = 1.0f - WATER_DAMPING * den_ratio;
  const bool floats = dens < WATER_DENSITY;
  bool w_fast = touches_water && fast;
  const bool w_slow = touches_water && !fast;
  // surface skip (Physics.cpp:1154-1163) in the cos domain:
  // arccos(x) >= thresh  <=>  x <= cos(thresh) for thresh in [0, pi]
  const float v_mag = sqrtf(fmaxf(v_sq, 1e-12f));
  const float cos_v = clampf(-vz / v_mag, -1.0f, 1.0f);
  const float zpos_w = fmaxf(wpz + rad * (1.0f - 2.0f * dens), mh + rad);
  const bool surf_coll = (pz > wpz - rad - MAX_SPLASH_DEPTH) && !underwater && !z_stop;
  const float exy_w = WATER_ELASTIC * (1.0f - air_eff);
  const float sbx = vx * exy_w, sby = vy * exy_w, sbz = -vz * WATER_ELASTIC;
  const bool s_did = (sbx * sbx + sby * sby + sbz * sbz) >= BOUNCE_CUTOFF;
  const float thresh = CRITICAL_ANGLE / den_ratio;
  const bool angle_ok = (thresh <= PI_F) && (cos_v <= cosf(fminf(thresh, PI_F)));
  const bool skip = w_fast && surf_coll && angle_ok &&
                    ((zpos_w - pz) <= 6.0f * rad) && s_did;
  w_fast = w_fast && !skip;
  vx = skip ? sbx : (w_fast ? vx * damp : (w_slow ? 0.0f : vx));
  vy = skip ? sby : (w_fast ? vy * damp : (w_slow ? 0.0f : vy));
  vz = skip ? sbz : (w_fast ? (floats ? 0.0f : vz * damp) : (w_slow ? 0.0f : vz));
  touches_water = touches_water && !skip;
  const float ground_z = mh + rad;
  const float slow_pos_z =
      floats ? fmaxf(wpz + rad * (1.0f - 2.0f * dens), ground_z) : ground_z;
  if (w_slow) pz = slow_pos_z;
  if (w_fast && !floats) flags |= FL_IN_WATER | FL_UNDERWATER;
  if (w_slow && floats) flags |= FL_FLOATING | FL_IN_WATER;
  if (w_slow) status = floats ? 1 : 3;
  if (touches_water && (pz <= ground_z + 1e-5f)) {   // hit bottom
    pz = ground_z;
    vx = vy = vz = 0.0f;
    status = 3;
  }

  // ---- cobj narrow phase: deepest hit, ties averaged ----
  TieSums t;
  team_walk<LANES, CHUNKED>(s_tab, s_start, tab, m4, BLOCK, px, py, pz, rad,
                            lane, t);
  if (lane != 0 || i >= n) return;
  const float best = t.pen;
  const float wsel = 1.0f / fmaxf((float)t.count, 1.0f);
  const float bnx = t.nx * wsel, bny = t.ny * wsel, bnz = t.nz * wsel;
  const float celas = t.el * wsel, cfric = t.fr * wsel;

  const bool hit = (best > 0.0f) && alive && !touches_water;
  px = px + (hit ? best * bnx : 0.0f);
  py = py + (hit ? best * bny : 0.0f);
  pz = pz + (hit ? best * bnz : 0.0f);
  const Bounce cb = bounce(vx, vy, vz, bnx, bny, bnz, elas * celas, air_eff);
  const bool stop = hit && !cb.did &&
                    ((fmaxf(fric, cfric) >= STICK_THRESHOLD) || (v_sq < BOUNCE_CUTOFF));
  const bool hd = hit && cb.did;
  vx = hd ? cb.x : (stop ? 0.0f : vx);
  vy = hd ? cb.y : (stop ? 0.0f : vy);
  vz = hd ? cb.z : (stop ? 0.0f : vz);
  status = stop ? 4 : (hd ? 1 : status);
  if (hit) flags |= FL_STATIC_COBJ_COLL | FL_COLLIDED;

  // ---- mesh bounce (airborne only, Physics.cpp:868-882) ----
  const bool mesh_coll = on_mesh && moving && !touches_water && !hit;
  if (mesh_coll) pz = fmaxf(pz, mh + rad);
  const Bounce mb = bounce(vx, vy, vz, mnx, mny, mnz, elas * LAND_ELASTICITY, air_eff);
  const float v_sq2 = vx * vx + vy * vy + vz * vz;
  const bool stopped_m = mesh_coll && !mb.did &&
                         ((fric >= STICK_THRESHOLD) || xy_stop || (v_sq2 < BOUNCE_CUTOFF));
  const bool md = mesh_coll && mb.did;
  const float damp_m = stopped_m ? 0.0f : 0.95f;
  vx = md ? mb.x : (mesh_coll ? vx * damp_m : vx);
  vy = md ? mb.y : (mesh_coll ? vy * damp_m : vy);
  vz = md ? mb.z : (mesh_coll ? vz * damp_m : vz);
  status = md ? 1 : (mesh_coll ? 2 : status);
  if (mesh_coll) flags |= FL_COLLIDED;

  // ---- on-ground rolling (surface_advance, Physics.cpp:980-1037) ----
  const bool roll_ok = grounded && !hit && !touches_water;
  const bool stick_g = (fric >= STICK_THRESHOLD) || xy_stop;
  const bool killed_g = roll_ok && (pz < mh - KILL_DEPTH * rad);
  if (roll_ok && (pz < mh - RECOVER_DEPTH * rad)) pz = mh;
  const float dzn = sqrtf(fmaxf(mnx * mnx + mny * mny, 1.0e-20f));
  float vel_m = (SURF_ADV_STEP / x_scene) * dzn * (1.0f - 0.5f * fric) / DEF_TIMESTEP;
  if (in_water && dens >= WATER_DENSITY)
    vel_m = vel_m * (dens - WATER_DENSITY) / fmaxf(dens, EPS);
  const bool moved_g = (dzn > 1.0e-12f) && (dzn > fric) && (vel_m > 1.0e-12f);
  const float mvx = moved_g ? vel_m * dx_val * mnx / dzn : 0.0f;
  const float mvy = moved_g ? vel_m * dy_val * mny / dzn : 0.0f;
  const float vmult = fmaxf(1.0f - fric, 0.0f);
  const float gvx = mvx * (1.0f - vmult) + vx * vmult;
  const float gvy = mvy * (1.0f - vmult) + vy * vmult;
  const bool rolling = roll_ok && !stick_g;
  vx = rolling ? gvx : ((roll_ok && stick_g) ? 0.0f : vx);
  vy = rolling ? gvy : ((roll_ok && stick_g) ? 0.0f : vy);
  if (roll_ok) vz = 0.0f;
  px = px + (rolling ? gvx * tstep : 0.0f);
  py = py + (rolling ? gvy * tstep : 0.0f);
  if (roll_ok) pz = mh + rad;
  const bool settled = roll_ok && (stick_g || !moved_g);
  if (settled) vx = vy = 0.0f;
  status = settled ? 4 : ((rolling && moved_g) ? 3 : status);
  if (killed_g) status = 0;

  px_out[i] = px;
  py_out[i] = py;
  pz_out[i] = pz;
  vx_out[i] = vx;
  vy_out[i] = vy;
  vz_out[i] = vz;
  st_out[i] = status;
  fl_out[i] = flags;
}

}  // namespace

// `tab` is the compact field-major [CF_USED][m4] cobj table and `gstart`
// its [8] group starts (narrow_kernel.kernel_tables), m4 a multiple of 4.
extern "C" int w3d_substep(const float* env, const float* maps, int my,
                           int mx, const float* tab, const int* gstart,
                           int m4, const float* px, const float* py,
                           const float* pz, const float* vx, const float* vy,
                           const float* vz, const int* st, const int* fl,
                           const float* rad, const float* air,
                           const float* fric, const float* grav,
                           const float* elas, const float* dens,
                           const float* tv, float* opx, float* opy,
                           float* opz, float* ovx, float* ovy, float* ovz,
                           int* ost, int* ofl, int n, void* stream) {
  if (m4 < 0 || m4 % 4 != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int grid = (int)(((long long)n * LANES + BLOCK - 1) / BLOCK);
    auto* kernel = m4 > CHUNK_ROWS ? substep_kernel<true> : substep_kernel<false>;
    kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        env, maps, my, mx, tab, m4, gstart, px, py, pz, vx, vy, vz, st, fl,
        rad, air, fric, grav, elas, dens, tv, opx, opy, opz, ovx, ovy, ovz,
        ost, ofl, n);
  }
  return (int)cudaGetLastError();
}
