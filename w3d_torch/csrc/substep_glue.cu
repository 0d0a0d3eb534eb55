// The glue of the physics substep and frame, hand-written for Hopper
// (sm_90a): six kernels in place of `physics/step._substep`'s ~390
// elementwise PyTorch ops a substep and the frame's row gather and ageing.
//
// Replaces: no TPU kernel.  The JAX package leaves this glue to XLA, which
// fuses it (3dworld_tpu/physics/step.py `_substep`); on this card PyTorch
// ran it op by op, one launch an op.  Plain PyTorch versions, each the
// phase's eager code: w3d_torch/physics/step.py `advance`, `contact`,
// `respond`, `apply_pairs`, `take_rows`, `age_objects`; wrapper:
// w3d_torch/ops/cuda/glue_kernel.py.
//
// A substep is
//   advance -> [B] -> contact -> [C] -> respond -> [D -> apply_pairs]
// with B, C and D the existing kernels (or the plain CobjSet select and a
// sharded `pair_fn` for C and D) and the bracket only on pair substeps:
//   advance      the per-type parameters gathered by type id, the air
//                factor, the Z_STOPPED clause, gravity with terminal
//                velocity, wind, drag and the move
//   contact      outside and on the mesh from B's sample; the water and
//                ice block (`WATER`), with the per-cell level from a second
//                B call where the env has a water map (`WMAP`)
//   respond      the cobj response (`COBJ`), the water tail, the mesh
//                bounce and rolling; without a pair pass (`PAIRS` false)
//                the kill conditions, with one D's inputs
//   apply_pairs  D's deltas, the wake and the kill conditions
// and the frame adds `take_rows` (the x sort's 11 column gathers) and
// `age_objects` (age and lifetime kill).
//
// What bounds them on this card: the launch.  Each is one thread a row
// over 10K rows, some tens of flops and under 200 bytes a row in and out:
// ~0.5 us of bytes at 3.35 TB/s, against a launch of a few microseconds.
// So the design is fewer launches: each kernel is a whole phase in the
// eager op order, its intermediates in registers.
//
// Exactness: every line is the plain phase's, op for op, so the kernels
// equal it bit for bit on the card.  Built with -fmad=false, every product
// and sum rounds on its own, as PyTorch's ops do.  PyTorch's rules are
// mirrored, not guessed: `torch.maximum` and `clamp` propagate NaN
// (`max_nan`, `clamp_nan`), where plain fmaxf would not; `s / t` with a
// tensor t is `t.reciprocal() * s` (Tensor.__rtruediv__); a tensor divided
// by a Python float is a multiply by its reciprocal, taken in double and
// rounded to float32 (`inv_dt`, as aten's CUDA division by a CPU scalar
// does: a true divide differs in 73% of random rows, a float32 reciprocal
// in 99%); tensor by tensor divisions, sqrtf and acosf are IEEE /
// libdevice's.  Python-side constants reach the kernels through `Consts`,
// each rounded once from the double the plain code gives PyTorch; the
// literals of the plain code's lines are written here as double literals
// cast to float, which is that rounding too.  The env scalars (gravity,
// wind, water level, temperature, kill plane) are read through device
// pointers, so a captured CUDA graph reads the values of each replay.

#include <cuda_runtime.h>

// The entry points' argument structs, outside the anonymous namespace so
// that the extern "C" entry points keep external linkage.
namespace w3d_glue {

// host-rounded scalars (glue_kernel.Consts, field for field)
struct Consts {
  float tstep, dx_inv, dy_inv, dx, dy;
  float surf_air, stick2, stick, gravity, water_density, freeze,
      bounce_cutoff, water_damping, critical_angle, splash, water_elastic,
      ice_elasticity, ice_bounce_elas, land_elasticity, kill_depth,
      recover_depth, roll_step, inv_dt, large_rad;
  int wmx, wmy;   // outside_mesh's grid (the world's, not the mesh tensor's)
  int fl_collided, fl_static_coll, fl_z_stopped, fl_xy_stopped, fl_in_water,
      fl_floating, fl_underwater, fl_on_ice;
};

// the type table's columns, indexed by type id
struct TypeCols {
  const float *rad, *air, *fric, *grav, *elas, *dens, *tv, *mass;
};

// device pointers of the env's scalars (0-d tensors but wind, [3])
struct Env {
  const float *gravity, *wind, *water_z, *temperature;
};

// the substep's entry rows (ObjectState's fields)
struct Rows {
  const float *px, *py, *pz, *vx, *vy, *vz;
  const int *status, *flags, *otype;
};

// physics/step.Moved, field for field
struct Moved {
  const float *px, *py, *pz, *vx, *vy, *vz;
  const int *status, *flags;
  const float *rad, *air_eff, *vz_old;
  const bool *alive, *moving, *grounded, *z_stop, *xy_stop, *underwater,
      *in_water;
};

// B's sample of the mesh under the moved objects, and of the water map
// (wh; null without one)
struct Surface {
  const float *mh, *mnx, *mny, *mnz, *wh;
};

// physics/step.Carry, field for field
struct Carry {
  const float *px, *py, *pz, *vx, *vy, *vz;
  const int *status, *flags;
  const float *rad, *mh, *mnx, *mny, *mnz;
  const bool *alive, *moving, *grounded, *xy_stop, *in_water, *off_mesh,
      *on_mesh, *touches_water, *wcoll, *ice_touch;
};

// the narrow phase's (hit, pen, nx, ny, nz, elas, fric)
struct Hits {
  const bool* hit;
  const float *pen, *nx, *ny, *nz, *elas, *fric;
};

// ObjectState's 11 four-byte columns (take_rows)
struct Columns {
  const unsigned int* c[11];
};

}  // namespace w3d_glue

using namespace w3d_glue;

namespace {

constexpr int BLOCK = 64;

// torch.maximum: NaN in either operand propagates, the first first
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// torch.clamp(v, lo, hi) with scalar bounds: NaN propagates
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// torch.clamp(v, min=lo)
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

struct Bounced {
  float x, y, z;
  bool did;
};

// physics/step.bounce_velocity, op for op
__device__ __forceinline__ Bounced bounce(float vx, float vy, float vz,
                                          float nx, float ny, float nz,
                                          float elasticity, float air,
                                          float cutoff) {
  const float e = clamp_nan(elasticity, 0.0f, 1.0f);
  const float vdotn = vx * nx + vy * ny + vz * nz;
  float bx = vx - 2.0f * vdotn * nx;
  float by = vy - 2.0f * vdotn * ny;
  float bz = vz - 2.0f * vdotn * nz;
  const float exy = e * (1.0f - air);
  bx = bx * exy;
  by = by * exy;
  bz = bz * e;
  const bool did = bx * bx + by * by + bz * bz >= cutoff;
  return {did ? bx : vx, did ? by : vy, did ? bz : vz, did};
}

// the xy drag of `_substep` (its `drag`)
__device__ __forceinline__ float drag(float v, float w, bool collided,
                                      float air_eff, bool move_xy) {
  const float vtot = v + (collided ? 0.0f : w);
  const bool c = fabsf(air_eff * vtot) > fabsf(v) || ((vtot < 0.0f) != (v < 0.0f));
  return (c && move_xy) ? (1.0f - air_eff) * v + air_eff * vtot : v;
}

// physics/step.advance: the entry state to B's inputs
__global__ void __launch_bounds__(BLOCK)
    advance_kernel(Consts k, TypeCols t, Env e, Rows in, float* __restrict__ fo,
                   int* __restrict__ flags_out, bool* __restrict__ bo, int n) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const int ot = in.otype[i];
  const float rad = t.rad[ot], air = t.air[ot], fric = t.fric[ot];
  const float grav = t.grav[ot], dens = t.dens[ot], tv = t.tv[ot];
  const int st0 = in.status[i];
  const int fl0 = in.flags[i];

  const bool alive = st0 > 0;
  const bool coll_last = (fl0 & k.fl_collided) != 0;
  int flags = fl0 & ~k.fl_collided;
  const bool floating = (flags & k.fl_floating) != 0;
  bool z_stop = (flags & k.fl_z_stopped) != 0;
  const bool xy_stop = (flags & k.fl_xy_stopped) != 0;
  const bool underwater = (flags & k.fl_underwater) != 0;
  const bool in_water = (flags & k.fl_in_water) != 0;
  const bool moving = alive && st0 == 1;
  const bool grounded = alive && (st0 == 2 || st0 == 3);

  float px = in.px[i], py = in.py[i], pz = in.pz[i];
  float vx = in.vx[i], vy = in.vy[i], vz = in.vz[i];

  // air factor
  const float air_eff = underwater ? 0.0f : (floating ? k.surf_air * air : air);

  // Z_STOPPED clause
  const bool unstop = z_stop && moving && (pz - rad > *e.water_z) && (fric < k.stick2);
  z_stop = z_stop && !unstop;
  if (unstop) flags = flags & ~k.fl_z_stopped;
  if (z_stop && moving) vz = 0.0f;
  const bool collided = coll_last || fabsf(vz) < (float)1.0e-6;
  const float vz_old = vz;

  // gravity with terminal velocity
  const float gscale =
      (in_water && dens > k.water_density) ? (dens - k.water_density) / dens : 1.0f;
  const bool can_fall = moving && !z_stop;
  const float vz_new = (-vz < tv)
      ? max_nan(vz - *e.gravity * gscale * k.gravity * k.tstep * grav, -tv) : vz;
  if (can_fall) vz = vz_new;

  // wind
  const float wx = e.wind[0], wy = e.wind[1], wz = e.wind[2];
  if (can_fall && (fabsf(air_eff * wz) > fabsf(vz) || ((wz < 0.0f) != (vz < 0.0f))))
    vz = vz + air_eff * wz;
  const bool move_xy = moving && !xy_stop;
  vx = drag(vx, wx, collided, air_eff, move_xy);
  vy = drag(vy, wy, collided, air_eff, move_xy);

  px = px + (move_xy ? k.tstep * vx : 0.0f);
  py = py + (move_xy ? k.tstep * vy : 0.0f);
  pz = pz + (moving ? k.tstep * vz : 0.0f);

  // rows of fo: px, py, pz, vx, vy, vz, rad, air_eff, vz_old (Moved's order)
  fo[i] = px;
  fo[n + i] = py;
  fo[2 * n + i] = pz;
  fo[3 * n + i] = vx;
  fo[4 * n + i] = vy;
  fo[5 * n + i] = vz;
  fo[6 * n + i] = rad;
  fo[7 * n + i] = air_eff;
  fo[8 * n + i] = vz_old;
  flags_out[i] = flags;
  // rows of bo: Moved's masks in its order
  bo[i] = alive;
  bo[n + i] = moving;
  bo[2 * n + i] = grounded;
  bo[3 * n + i] = z_stop;
  bo[4 * n + i] = xy_stop;
  bo[5 * n + i] = underwater;
  bo[6 * n + i] = in_water;
}

// physics/step.contact: B's sample to the narrow phase's inputs
template <bool WATER, bool WMAP>
__global__ void __launch_bounds__(BLOCK)
    contact_kernel(Consts k, TypeCols t, Env e, Moved m, Surface sf,
                   const int* __restrict__ otype, float* __restrict__ fo,
                   int* __restrict__ io, bool* __restrict__ bo, int n) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const int ot = otype[i];
  const float elas = t.elas[ot], dens = t.dens[ot];
  const float rad = m.rad[i];
  float px = m.px[i], py = m.py[i], pz = m.pz[i];
  float vx = m.vx[i], vy = m.vy[i], vz = m.vz[i];
  int flags = m.flags[i];
  const int st0 = m.status[i];
  const bool alive = m.alive[i];
  const float mh = sf.mh[i];

  // mesh surface
  const float gx = px * k.dx_inv + (float)(k.wmx / 2);
  const float gy = py * k.dy_inv + (float)(k.wmy / 2);
  const bool off_mesh = gx < 0.0f || gx >= (float)k.wmx || gy < 0.0f || gy >= (float)k.wmy;
  const bool on_mesh = !off_mesh && (pz - rad <= mh);

  int status = st0;
  bool touches = false, wcoll = false, ice_touch = false;
  if (WATER) {
    const float air_eff = m.air_eff[i], vz_old = m.vz_old[i];
    const bool z_stop = m.z_stop[i], underwater = m.underwater[i];
    const float wpz0 = *e.water_z;
    const float wpz = WMAP ? max_nan(wpz0, sf.wh[i]) : wpz0;
    const float bg = *e.gravity;
    const bool over_water = !off_mesh && (wpz > mh);
    touches = over_water && (pz - rad < wpz) && alive;
    const bool frozen = *e.temperature <= k.freeze;
    ice_touch = touches && frozen;
    touches = touches && !frozen;
    const float v_sq = vx * vx + vy * vy + vz * vz;
    const bool fast = (v_sq >= k.bounce_cutoff) && !z_stop;
    const float den_ratio = (1.0f / (dens + k.water_density)) * k.water_density;
    const float damp = 1.0f - den_ratio * k.water_damping;
    const bool floats = dens < k.water_density;
    bool w_fast = touches && fast;
    const bool w_slow = touches && !fast;
    // surface skip / ricochet
    const float v_mag = sqrtf(clamp_min_nan(v_sq, (float)1e-12));
    const float coll_angle = acosf(clamp_nan(-vz / v_mag, -1.0f, 1.0f));
    const float zpos_w = max_nan(wpz + rad * (1.0f - dens * 2.0f), mh + rad);
    const bool surf_coll = (pz > wpz - rad - k.splash) && !underwater && !z_stop;
    const Bounced s = bounce(vx, vy, vz, 0.0f, 0.0f, 1.0f, k.water_elastic,
                             air_eff, k.bounce_cutoff);
    const bool skip = w_fast && surf_coll
        && (coll_angle >= (1.0f / den_ratio) * k.critical_angle)
        && (zpos_w - pz <= rad * 6.0f) && s.did;
    w_fast = w_fast && !skip;
    vx = skip ? s.x : (w_fast ? vx * damp : vx);
    vy = skip ? s.y : (w_fast ? vy * damp : vy);
    vz = skip ? s.z : (w_fast ? (floats ? 0.0f : vz * damp) : vz);
    touches = touches && !skip;
    if (touches) flags = flags | k.fl_in_water;
    if (w_fast && floats) flags = flags | (k.fl_z_stopped | k.fl_floating);
    if (w_fast && !floats) flags = flags | k.fl_underwater;
    const float ground_z = mh + rad;
    const float zpos_f = zpos_w;
    // slow branch
    const bool deep = zpos_f - pz > rad * 2.0f;
    const bool f_deep = w_slow && floats && deep;
    const bool f_snap = w_slow && floats && !deep;
    const float buoy_vz =
        vz_old - (dens - k.water_density) / dens * bg * k.gravity * k.tstep;
    const bool sink = w_slow && !floats;
    const bool above = pz > ground_z + (float)1e-5;
    const bool s_damp = sink && above;
    const bool s_rest = sink && !above;
    const float sink_f = dens / (dens + k.water_density);
    vx = (f_snap || s_rest) ? 0.0f : (s_damp ? vx * sink_f : vx);
    vy = (f_snap || s_rest) ? 0.0f : (s_damp ? vy * sink_f : vy);
    vz = (f_snap || s_rest) ? 0.0f
                            : (s_damp ? vz * sink_f : (f_deep ? buoy_vz : vz));
    pz = f_snap ? zpos_f + (float)0.001 : (s_rest ? ground_z : pz);
    if (f_deep) flags = flags | k.fl_z_stopped;
    if (f_snap) flags = flags | k.fl_floating;
    // float-branch status
    const bool w_float = w_slow && floats;
    const bool air_or_mesh = st0 == 1 || st0 == 2;
    const int edge_st = air_or_mesh ? 3 : 4;
    status = w_float ? (pz > ground_z ? 1 : edge_st) : st0;
    if (s_rest) status = 3;
    const bool hit_bottom = w_fast && !floats && (pz <= ground_z + (float)1e-5);
    if (hit_bottom) status = 3;
    const bool edge3 = w_float && !(pz > ground_z) && air_or_mesh;
    wcoll = touches && !edge3 && !s_rest && !hit_bottom;
    // ice surface
    const Bounced b = bounce(vx, vy, vz, 0.0f, 0.0f, 1.0f, elas * k.ice_elasticity,
                             air_eff, k.bounce_cutoff);
    const bool stick = ice_touch && ((elas < k.ice_bounce_elas) || !b.did);
    const bool bounce_ice = ice_touch && !stick;
    pz = ice_touch ? wpz + rad + (float)0.001 : pz;
    vx = stick ? 0.0f : (bounce_ice ? b.x : vx);
    vy = stick ? 0.0f : (bounce_ice ? b.y : vy);
    vz = stick ? 0.0f : (bounce_ice ? b.z : vz);
    status = stick ? 4 : (bounce_ice ? 1 : status);
    if (stick) flags = flags | (k.fl_z_stopped | k.fl_xy_stopped | k.fl_on_ice);
  }

  // rows of fo: px, py, pz, vx, vy, vz; of io: status, flags; of bo:
  // off_mesh, on_mesh, touches_water, wcoll, ice_touch (Carry's order)
  fo[i] = px;
  fo[n + i] = py;
  fo[2 * n + i] = pz;
  fo[3 * n + i] = vx;
  fo[4 * n + i] = vy;
  fo[5 * n + i] = vz;
  io[i] = status;
  io[n + i] = flags;
  bo[i] = off_mesh;
  bo[n + i] = on_mesh;
  bo[2 * n + i] = touches;
  bo[3 * n + i] = wcoll;
  bo[4 * n + i] = ice_touch;
}

// physics/step.respond: cobj response, water tail, mesh bounce, rolling;
// the kill conditions without a pair pass, D's inputs with one
template <bool COBJ, bool WATER, bool PAIRS>
__global__ void __launch_bounds__(BLOCK)
    respond_kernel(Consts k, TypeCols t, Carry c, Hits h,
                   const int* __restrict__ otype, const float* __restrict__ zmin,
                   float* __restrict__ fo, int* __restrict__ io,
                   bool* __restrict__ act, int n) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const int ot = otype[i];
  const float air = t.air[ot], fric = t.fric[ot], elas = t.elas[ot];
  const float dens = t.dens[ot];
  const float rad = c.rad[i];
  float px = c.px[i], py = c.py[i], pz = c.pz[i];
  float vx = c.vx[i], vy = c.vy[i], vz = c.vz[i];
  int status = c.status[i], flags = c.flags[i];
  const float mh = c.mh[i], mnx = c.mnx[i], mny = c.mny[i], mnz = c.mnz[i];
  const bool alive = c.alive[i], moving = c.moving[i], grounded = c.grounded[i];
  const bool xy_stop = c.xy_stop[i], in_water = c.in_water[i];
  const bool off_mesh = c.off_mesh[i], on_mesh = c.on_mesh[i];
  const bool touches = c.touches_water[i], wcoll = c.wcoll[i];
  const bool ice_touch = c.ice_touch[i];

  // static cobj collisions
  bool cobj_hit = false;
  if (COBJ) {
    const bool hit = h.hit[i] && alive && !wcoll;
    const float pen = h.pen[i], cnx = h.nx[i], cny = h.ny[i], cnz = h.nz[i];
    const float celas = h.elas[i], cfric = h.fric[i];
    px = px + (hit ? pen * cnx : 0.0f);
    py = py + (hit ? pen * cny : 0.0f);
    pz = pz + (hit ? pen * cnz : 0.0f);
    const Bounced b = bounce(vx, vy, vz, cnx, cny, cnz, elas * celas, air,
                             k.bounce_cutoff);
    const float v_sq_c = vx * vx + vy * vy + vz * vz;
    const bool stop = hit && !b.did
        && ((max_nan(fric, cfric) >= k.stick) || (v_sq_c < k.bounce_cutoff));
    const bool hd = hit && b.did;
    vx = hd ? b.x : (stop ? 0.0f : vx);
    vy = hd ? b.y : (stop ? 0.0f : vy);
    vz = hd ? b.z : (stop ? 0.0f : vz);
    status = stop ? 4 : (hd ? 1 : status);
    if (hit) flags = flags | (k.fl_static_coll | k.fl_collided);
    cobj_hit = hit;
  }

  if (WATER) {
    if (moving && !cobj_hit && !ice_touch) flags = flags & ~k.fl_z_stopped;
    if (wcoll) status = 1;
    if (wcoll) flags = flags & ~(k.fl_static_coll | k.fl_z_stopped | k.fl_xy_stopped);
  }

  // mesh bounce
  const bool mesh_coll = on_mesh && moving && !wcoll && !cobj_hit;
  pz = mesh_coll ? max_nan(pz, mh + rad) : pz;
  const Bounced m = bounce(vx, vy, vz, mnx, mny, mnz, elas * k.land_elasticity,
                           air, k.bounce_cutoff);
  const float v_sq2 = vx * vx + vy * vy + vz * vz;
  const bool stopped_m = mesh_coll && !m.did
      && ((fric >= k.stick) || xy_stop || (v_sq2 < k.bounce_cutoff));
  const bool md = mesh_coll && m.did;
  const float damp_m = stopped_m ? 0.0f : (float)0.95;
  vx = md ? m.x : (mesh_coll ? vx * damp_m : vx);
  vy = md ? m.y : (mesh_coll ? vy * damp_m : vy);
  vz = md ? m.z : (mesh_coll ? vz * damp_m : vz);
  status = md ? 1 : (mesh_coll ? 2 : status);

  // on-ground rolling
  const bool roll_ok = grounded && !cobj_hit && !touches;
  const bool stick_g = (fric >= k.stick) || xy_stop;
  const bool killed_g = roll_ok && (pz < mh - rad * k.kill_depth);
  pz = (roll_ok && (pz < mh - rad * k.recover_depth)) ? mh : pz;
  const float dzn = sqrtf(clamp_min_nan(mnx * mnx + mny * mny, (float)1.0e-20));
  float vel_m = k.roll_step * dzn * (1.0f - fric * 0.5f) * k.inv_dt;
  if (in_water && dens >= k.water_density)
    vel_m = vel_m * (dens - k.water_density) / clamp_min_nan(dens, (float)1e-9);
  const bool moved_g = (dzn > (float)1.0e-12) && (dzn > fric) && (vel_m > (float)1.0e-12);
  const float mvx = moved_g ? vel_m * k.dx * mnx / dzn : 0.0f;
  const float mvy = moved_g ? vel_m * k.dy * mny / dzn : 0.0f;
  const float vmult = clamp_min_nan(1.0f - fric, 0.0f);
  const float gvx = mvx * (1.0f - vmult) + vx * vmult;
  const float gvy = mvy * (1.0f - vmult) + vy * vmult;
  const bool rolling = roll_ok && !stick_g;
  vx = rolling ? gvx : ((roll_ok && stick_g) ? 0.0f : vx);
  vy = rolling ? gvy : ((roll_ok && stick_g) ? 0.0f : vy);
  vz = roll_ok ? 0.0f : vz;
  px = px + (rolling ? gvx * k.tstep : 0.0f);
  py = py + (rolling ? gvy * k.tstep : 0.0f);
  pz = roll_ok ? mh + rad : pz;
  const bool settled = roll_ok && (stick_g || !moved_g);
  vx = settled ? 0.0f : vx;
  vy = settled ? 0.0f : vy;
  status = settled ? 4 : ((rolling && moved_g) ? 3 : status);
  status = killed_g ? 0 : status;

  if (PAIRS) {
    // rows 6-7 of fo and act: D's mass, elasticity and active mask
    fo[6 * n + i] = t.mass[ot];
    fo[7 * n + i] = elas;
    act[i] = alive && rad >= k.large_rad;
  } else {
    status = pz < *zmin ? 0 : status;
    status = (off_mesh && alive) ? 0 : status;
  }
  fo[i] = px;
  fo[n + i] = py;
  fo[2 * n + i] = pz;
  fo[3 * n + i] = vx;
  fo[4 * n + i] = vy;
  fo[5 * n + i] = vz;
  io[i] = status;
  io[n + i] = flags;
}

// physics/step.apply_pairs: the pair deltas, the wake, the kill conditions
__global__ void __launch_bounds__(BLOCK)
    apply_pairs_kernel(Carry c, const bool* __restrict__ act,
                       const float* __restrict__ dpx, const float* __restrict__ dpy,
                       const float* __restrict__ dpz, const float* __restrict__ dvx,
                       const float* __restrict__ dvy, const float* __restrict__ dvz,
                       const float* __restrict__ zmin, float* __restrict__ fo,
                       int* __restrict__ so, int n) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const bool a = act[i];
  const float ax = dvx[i], ay = dvy[i], az = dvz[i];
  const float pz = c.pz[i] + (a ? dpz[i] : 0.0f);
  fo[i] = c.px[i] + (a ? dpx[i] : 0.0f);
  fo[n + i] = c.py[i] + (a ? dpy[i] : 0.0f);
  fo[2 * n + i] = pz;
  fo[3 * n + i] = c.vx[i] + (a ? ax : 0.0f);
  fo[4 * n + i] = c.vy[i] + (a ? ay : 0.0f);
  fo[5 * n + i] = c.vz[i] + (a ? az : 0.0f);
  const bool woke = a && (ax * ax + ay * ay + az * az > (float)1e-10);
  int status = c.status[i];
  status = (woke && status == 4) ? 1 : status;
  status = pz < *zmin ? 0 : status;
  status = (c.off_mesh[i] && c.alive[i]) ? 0 : status;
  so[i] = status;
}

// physics/step.take_rows: out[k][i] = in_k[idx[i]] for ObjectState's 11
// four-byte columns (floats and int32s moved as words)
__global__ void __launch_bounds__(BLOCK)
    take_rows_kernel(Columns in, const long long* __restrict__ idx,
                     unsigned int* __restrict__ out, int n) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const long long j = idx[i];
#pragma unroll
  for (int f = 0; f < 11; ++f) out[f * n + i] = in.c[f][j];
}

// physics/step.age_objects: age and lifetime kill
__global__ void __launch_bounds__(BLOCK)
    age_kernel(const int* __restrict__ otype, const int* __restrict__ lifetime,
               const int* __restrict__ time, const int* __restrict__ status,
               int* __restrict__ out, int n) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const float life = (float)lifetime[otype[i]];
  const int t = time[i] + 1;
  out[i] = t;
  out[n + i] = (life > 0.0f && (float)t > life) ? 0 : status[i];
}

inline int blocks(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

extern "C" int w3d_glue_advance(Consts k, TypeCols t, Env e, Rows in, float* fo,
                                int* flags_out, bool* bo, int n, void* stream) {
  if (n > 0) {
    advance_kernel<<<blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(k, t, e, in, fo,
                                                                  flags_out, bo, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int w3d_glue_contact(Consts k, TypeCols t, Env e, Moved m, Surface sf,
                                const int* otype, float* fo, int* io, bool* bo,
                                int n, int water, void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (!water)
      contact_kernel<false, false><<<blocks(n), BLOCK, 0, s>>>(k, t, e, m, sf, otype,
                                                               fo, io, bo, n);
    else if (sf.wh == nullptr)
      contact_kernel<true, false><<<blocks(n), BLOCK, 0, s>>>(k, t, e, m, sf, otype,
                                                              fo, io, bo, n);
    else
      contact_kernel<true, true><<<blocks(n), BLOCK, 0, s>>>(k, t, e, m, sf, otype,
                                                             fo, io, bo, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int w3d_glue_respond(Consts k, TypeCols t, Carry c, Hits h,
                                const int* otype, const float* zmin, float* fo,
                                int* io, bool* act, int n, int water, int pairs,
                                void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int sel = (h.hit != nullptr ? 4 : 0) | (water ? 2 : 0) | (pairs ? 1 : 0);
#define W3D_RESPOND(C, W, P)                                             \
  respond_kernel<C, W, P><<<blocks(n), BLOCK, 0, s>>>(k, t, c, h, otype, \
                                                      zmin, fo, io, act, n)
    switch (sel) {
      case 0: W3D_RESPOND(false, false, false); break;
      case 1: W3D_RESPOND(false, false, true); break;
      case 2: W3D_RESPOND(false, true, false); break;
      case 3: W3D_RESPOND(false, true, true); break;
      case 4: W3D_RESPOND(true, false, false); break;
      case 5: W3D_RESPOND(true, false, true); break;
      case 6: W3D_RESPOND(true, true, false); break;
      default: W3D_RESPOND(true, true, true); break;
    }
#undef W3D_RESPOND
  }
  return (int)cudaGetLastError();
}

extern "C" int w3d_glue_apply_pairs(Carry c, const bool* act, const float* dpx,
                                    const float* dpy, const float* dpz,
                                    const float* dvx, const float* dvy,
                                    const float* dvz, const float* zmin,
                                    float* fo, int* so, int n, void* stream) {
  if (n > 0) {
    apply_pairs_kernel<<<blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
        c, act, dpx, dpy, dpz, dvx, dvy, dvz, zmin, fo, so, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int w3d_glue_take_rows(Columns in, const long long* idx,
                                  unsigned int* out, int n, void* stream) {
  if (n > 0) {
    take_rows_kernel<<<blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(in, idx, out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int w3d_glue_age(const int* otype, const int* lifetime,
                            const int* time, const int* status, int* out,
                            int n, void* stream) {
  if (n > 0) {
    age_kernel<<<blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(otype, lifetime,
                                                               time, status,
                                                               out, n);
  }
  return (int)cudaGetLastError();
}
