"""Material-sphere definitions (`sphere_materials.txt`; port of
`3dworld_tpu/scene/sphere_materials.py`, pure host code).

`gen_random_material` draws from the port's `utils/rng.RandGen` in the
JAX package's order, conditional draws included, so a seeded
`rand_spheres` places the same spheres.

The reference's throwable PBR spheres: a keyword/value file sets the
current material state; `add_material <name>` snapshots it
(sphere_mat_t, parser sphere_materials.cpp:158+; config hook
`sphere_materials_fn`).  Same format parsed here into a material list
feeding physics (density/hardness -> elasticity/mass) and lighting
(emissive/light_radius -> local light sources).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass
class SphereMat:
    name: str = ""
    shadows: bool = False
    emissive: bool = False
    reflective: bool = False
    destroyable: int = 0
    radius_scale: float = 1.0
    light_radius: float = 0.0
    hardness: float = 0.8
    refract_ix: float = 1.0
    light_atten: float = 0.0
    alpha: float = 1.0
    metalness: float = 0.0
    specular_mag: float = 0.2
    specular_exp: float = 32.0
    density: float = 1.0
    diffuse_color: tuple = (1.0, 1.0, 1.0)
    specular_color: tuple = (1.0, 1.0, 1.0)
    texture: str = ""
    normal_map: str = ""


@dataclass
class SphereMaterials:
    materials: list = field(default_factory=list)
    max_num_spheres: int = 20
    fire_delay: float = 0.5


@dataclass
class GenSphereParams:
    """`sphere_gen <kw> <val>` config block (gen_sphere_params_t,
    sphere_materials.cpp:430-485)."""

    enable_reflect: bool = False
    enable_transparent: bool = False
    enable_light_atten: bool = False
    enable_shadows: bool = False
    metal_prob: float = 0.0
    emissive_prob: float = 0.0
    metal_white_prob: float = 0.0
    emiss_white_prob: float = 0.0
    max_light_atten: float = 0.0
    max_light_radius: float = 0.0
    rand_seed: int = 0


def gen_params_from_config(d: dict) -> GenSphereParams:
    gp = GenSphereParams()
    for k, v in (d or {}).items():
        if not hasattr(gp, k):
            continue
        cur = getattr(gp, k)
        setattr(gp, k, type(cur)(float(v)) if not isinstance(cur, bool)
                else bool(int(float(v))))
    return gp


def _clip01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


def gen_random_material(rg, gp: GenSphereParams, radius: float) -> SphereMat:
    """One randomized material, reproducing gen_rand_spheres' exact RNG
    draw order INCLUDING conditional consumption (the C++ ternaries and
    short-circuits, sphere_materials.cpp:517-545) so seeded generation
    matches the reference sequence."""
    m = SphereMat()
    is_metal = gp.enable_reflect and rg.rand_float() < gp.metal_prob
    m.metalness = 1.0 if is_metal else 0.0
    m.specular_mag = 1.0 if is_metal else _clip01(rg.rand_uniform(-0.5, 1.2))
    m.specular_exp = rg.rand_uniform(1.0, 8.0) * rg.rand_uniform(1.0, 8.0)
    m.reflective = gp.enable_reflect and m.specular_mag > 0.75
    m.emissive = (not m.reflective) and rg.rand_float() < gp.emissive_prob
    if not m.emissive and not is_metal and gp.enable_transparent:
        m.alpha = _clip01(rg.rand_uniform(-2.0 if m.reflective else 0.25,
                                          2.0))
    m.shadows = gp.enable_shadows and m.alpha > 0.5
    m.density = (2.0 if is_metal else 1.0) * rg.rand_uniform(0.5, 4.0)
    if gp.max_light_atten > 0.0 and m.alpha < 0.5:
        m.light_atten = max(rg.rand_uniform(-gp.max_light_atten,
                                            gp.max_light_atten), 0.0)
    m.refract_ix = (rg.rand_uniform(1.0, 1.5) * rg.rand_uniform(1.0, 1.5)
                    * rg.rand_uniform(1.0, 1.5))
    if gp.max_light_radius > 0.0 and m.emissive:
        m.light_radius = rg.rand_uniform(0.5 * gp.max_light_radius,
                                         gp.max_light_radius) * radius
    # white-metal / white-emitter rolls short-circuit exactly like the
    # C++ `if/else if` (each rand_float is drawn only when its guard
    # condition is reached)
    if is_metal and rg.rand_float() < gp.metal_white_prob:
        color = (1.0, 1.0, 1.0)
    elif (not is_metal) and m.light_radius > 0.0 \
            and rg.rand_float() < gp.emiss_white_prob:
        color = (1.0, 1.0, 1.0)
    else:
        color = tuple(_clip01(rg.rand_uniform(-0.25, 1.5))
                      for _ in range(3))
    if is_metal:
        m.diffuse_color = (0.0, 0.0, 0.0)
        m.specular_color = color
    else:
        m.diffuse_color = color
        m.specular_color = (1.0, 1.0, 1.0)
    return m


_BOOL = {"shadows", "emissive", "reflective"}
_INT = {"destroyable"}
_FLOAT = {"radius_scale", "light_radius", "hardness", "refract_ix",
          "light_atten", "alpha", "metalness", "specular_mag", "specular_exp",
          "density"}
_COLOR = {"diffuse_color", "specular_color"}
_STR = {"texture", "normal_map"}


def parse_sphere_materials(path: str) -> SphereMaterials:
    out = SphereMaterials()
    cur = SphereMat()
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return out
    for line in lines:
        h = line.find("#")
        if h >= 0:
            line = line[:h]
        t = line.split()
        if not t:
            continue
        kw, args = t[0], t[1:]
        if kw == "max_num_spheres":
            out.max_num_spheres = int(args[0])
        elif kw == "fire_delay":
            out.fire_delay = float(args[0])
        elif kw == "add_material":
            cur.name = " ".join(args)
            out.materials.append(replace(cur))
            cur = replace(cur)
        elif kw in _BOOL:
            setattr(cur, kw, bool(int(args[0])))
        elif kw in _INT:
            setattr(cur, kw, int(args[0]))
        elif kw in _FLOAT:
            setattr(cur, kw, float(args[0]))
        elif kw in _COLOR:
            setattr(cur, kw, tuple(float(a) for a in args[:3]))
        elif kw in _STR:
            setattr(cur, kw, "" if args[0] == "none" else args[0])
    return out
