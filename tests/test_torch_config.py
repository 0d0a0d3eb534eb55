"""Torch port vs JAX package: the config reader (`utils/config`).

Configs written to `tmp_path` go through both packages' `load_config`,
`load_config_tiered`, `city_params` and `unbound_report`; every `Config`
attribute (declared fields and the keywords bound as plain attributes),
`world_const()` and `terrain_config()` must be equal."""

import dataclasses

import pytest

import w3d  # noqa: F401
from w3d.utils import config as JC

from w3d_torch.utils import config as TC
from w3d_torch.utils.constants import WorldConst as TWorld
from w3d_torch.terrain import mesh as TMESH

CONFIGS = {
    "typed": """
mesh_size 32 48 8          # ints
scene_size 3.5 4.0 2.0
mesh_gen_mode 2
mesh_gen_shape 1
erosion_iters 3.0          # an int keyword given as a float
erode_amount 0.25
water_h_off 0.09 0.01
init_temperature 12.5
rand_seed 7
num_items 1 2 3 4 5
num_light_rays 100 200 300 4
coll_obj_file scene.txt
mesh_height_image hm.png
lighting_file_sky a.bin 1 0.5 2
glaciate 0
glaciate_exp 2.0
wind_velocity 0.1 -0.2 0.3
player_start 1 2 3
leaf_color 0.1 0.2 0.3 0.4 0.5
""",
    "hmap_and_toggles": """
hmap_sine_mag 5.0
hmap_sine_freq 0.5
hmap_plat_height 0.3
hmap_crat_slope 0.7
hmap_crack_depth 0.1
hmap_filter_width 4
toggle_mesh_enabled
toggle_reflections
toggle_reflections
toggle_reflections
""",
    "subconfigs": """
voxel xsize 24
voxel isolevel 0.25
voxel mag 1.5
sphere_gen rand_seed 11
sphere_gen enable_reflect 1
buildings size_range 0.1 0.2 0.3
city_params num_cities 3
city road_width 0.5
tree mode 2
""",
    "include_unbound_end": """
rand_seed 5
include inc.txt
not_a_keyword 1
flag_only
two_args 1 2
num_items 1 x 3            # malformed: kept raw
/* a block
comment */ ntrees 12
end
ntrees 99
""",
}


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _check(jcfg, tcfg):
    assert vars(jcfg) == vars(tcfg)
    assert [f.name for f in dataclasses.fields(jcfg)] == \
        [f.name for f in dataclasses.fields(tcfg)]
    assert JC.unbound_report(jcfg) == TC.unbound_report(tcfg)
    assert JC.city_params(jcfg) == TC.city_params(tcfg)
    jw, tw = jcfg.world_const(), tcfg.world_const()
    assert isinstance(tw, TWorld)
    assert dataclasses.asdict(jw) == dataclasses.asdict(tw)
    jt, tt = jcfg.terrain_config(), tcfg.terrain_config()
    assert isinstance(tt, TMESH.TerrainConfig) and isinstance(tt.hmap, TMESH.HmapParams)
    assert tuple(jt) == tuple(tt) and jt._fields == tt._fields


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_load_config_matches_jax(tmp_path, name):
    _write(tmp_path, "inc.txt", "ntrees 4\nmesh_seed 9\nvegetation 0.5\n")
    path = _write(tmp_path, "cfg.txt", CONFIGS[name])
    jcfg, tcfg = JC.load_config(path), TC.load_config(path)
    _check(jcfg, tcfg)
    if name == "include_unbound_end":     # what the config exercises happened
        assert tcfg.ntrees == 12 and tcfg.mesh_seed == 9
        assert set(TC.unbound_report(tcfg)) == {"not_a_keyword", "flag_only",
                                                "two_args", "num_items"}
    elif name == "hmap_and_toggles":
        assert tcfg.display_mode == 0x10 and tcfg.terrain_config().hmap.sine_mag == 5.0
    elif name == "subconfigs":
        assert tcfg.voxel["xsize"] == "24" and tcfg.city["num_cities"] == "3"
    else:
        assert tcfg.world_const().mesh_y == 48 and tcfg.erosion_iters == 3


def test_load_config_tiered_matches_jax(tmp_path):
    """config_pre.txt -> each file in defaults.txt -> config_post.txt; a
    missing tier is skipped."""
    _write(tmp_path, "config_pre.txt", "rand_seed 2\nntrees 3\n")
    _write(tmp_path, "a.txt", "ntrees 5\nmesh_size 16 16 4\n")
    _write(tmp_path, "b.txt", "disable_scenery 1\n")
    _write(tmp_path, "defaults.txt", "a.txt  # first\nb.txt\nmissing.txt\n")
    jcfg = JC.load_config_tiered(str(tmp_path))
    tcfg = TC.load_config_tiered(str(tmp_path))
    _check(jcfg, tcfg)
    assert tcfg.ntrees == 5 and tcfg.disable_scenery == 1 and tcfg.rand_seed == 2
    missing = tmp_path / "none"
    _check(JC.load_config(str(missing)), TC.load_config(str(missing)))
