"""Config-file parser compatible with the reference's `config_*.txt` format
(port of `3dworld_tpu/utils/config.py`; pure host code).

`Config.world_const` and `Config.terrain_config` build the port's
`WorldConst` and `TerrainConfig`; `building_params` the city's
`BuildingParams`.

The reference binds hundreds of text keywords to typed globals through
`kw_to_val_map_t` maps (`file_utils.h:88-104`, populated in
`load_config`, 3DWorld.cpp:1763-2270) with recursive `include`
(3DWorld.cpp:2077) and a three-tier load order
config_pre.txt -> files in defaults.txt -> config_post.txt
(3DWorld.cpp:1650-1665).

Here: a token stream (whitespace-separated, `#` comments to end-of-line)
feeding a typed keyword registry on a `Config` object.  Keywords we don't
model are preserved in `cfg.extra` (value = next raw token) so shipped
scene configs parse cleanly end-to-end.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def tokenize(text: str):
    """Whitespace token stream with # comments (matches fscanf-style reads)."""
    for line in text.splitlines():
        hash_pos = line.find("#")
        if hash_pos >= 0:
            line = line[:hash_pos]
        yield from line.split()


def tokenize_lines(text: str):
    """Per-line token lists with # comments stripped and /* */ block
    comments skipped (3DWorld.cpp:2051-2056 read_block_comment)."""
    in_block = False
    for line in text.splitlines():
        toks = []
        for tok in line.split():
            if in_block:
                if tok.endswith("*/"):
                    in_block = False
                continue
            if tok.startswith("#"):
                break
            if tok.startswith("/*"):
                if not (len(tok) > 3 and tok.endswith("*/")):
                    in_block = True
                continue
            toks.append(tok)
        if toks:
            yield toks


def _num(typ, tok):
    """fscanf-tolerant conversion: %i accepts '3.0' as 3 in practice
    (several shipped configs mix int/float forms per keyword)."""
    if typ is int:
        try:
            return int(tok)
        except ValueError:
            return int(float(tok))
    return typ(tok)


@dataclass
class Config:
    """Engine configuration: the subset of reference keywords our systems
    consume, with reference defaults (3DWorld.cpp globals)."""

    # world / mesh (matrix_ops.cpp:9-16, 3DWorld.cpp kwm)
    mesh_size: tuple = (128, 128, 32)          # "mesh_size x y z"
    scene_size: tuple = (4.0, 4.0, 4.0)        # "scene_size x y z"
    mesh_height: float = 0.1                   # fraction of Z_SCENE (MESH_HEIGHT)
    mesh_scale: float = 1.0
    mesh_z_cutoff: float = -1e9
    mesh_seed: int = 0
    mesh_gen_mode: int = 0                     # MGEN_*
    mesh_gen_shape: int = 0
    mesh_freq_filter: int = 2
    glaciate: int = 1
    glaciate_exp: float = 0.0                  # 0 => cubed
    erosion_iters: int = 0
    erosion_iters_tt: int = 0
    erode_amount: float = 1.0
    water_h_off: tuple = (0.0, 0.0)            # "water_h_off rel abs"
    temperature: float = 20.0
    gravity: float = 1.0                       # base_gravity
    rand_seed: int = 0
    rand_gen_index: int = 0
    srand: int = 0
    disable_water: int = 0
    disable_scenery: int = 0
    disable_universe: int = 0
    read_landscape: int = 0
    read_heightmap: int = 0
    ntrees: int = 0
    nsmileys: int = 0
    num_items: tuple = ()
    num_dodgeballs: int = 1
    load_coll_objs: int = 0
    coll_obj_file: str = ""
    state_file: str = ""
    mesh_file: str = ""
    mh_filename: str = ""                      # "mesh_height_image"
    read_hmap_modmap_filename: str = ""        # brush journal replayed on load
    write_hmap_modmap_filename: str = ""
    sphere_materials_fn: str = ""
    ship_def_file: str = ""
    num_threads: int = 0
    num_light_rays: tuple = ()                 # npts nrays local [global [dynamic]]
    lighting_file_local: tuple = ()
    lighting_file_sky: tuple = ()
    lighting_file_global: tuple = ()
    shadow_map_sz: int = 2048
    create_voxel_landscape: int = 0            # voxel terrain scenes
    voxel: dict = field(default_factory=dict)  # "voxel <param> <val>" sub-config
    buildings: dict = field(default_factory=dict)
    sphere_gen: dict = field(default_factory=dict)
    city: dict = field(default_factory=dict)
    tree_mode: int = 1
    vegetation: float = 1.0
    relh_adj_tex: float = 0.0
    camera_radius: float = 0.06
    player_start: tuple = (0.0, 0.0, 0.0)
    wind_velocity: tuple = (0.4, 0.2, 0.0)
    extra: dict = field(default_factory=dict)  # unmodeled keyword -> raw token(s)
    hmap: dict = field(default_factory=dict)   # hmap_* gen params (3DWorld.cpp:2007-2020)
    display_mode: int = 0x01                   # toggle_* keywords flip bits (3DWorld.cpp:2173-2174)
    include_dirs: tuple = ()

    def world_const(self):
        from .constants import WorldConst
        mx, my, mz = self.mesh_size
        sx, sy, sz = self.scene_size
        return WorldConst(mesh_x=int(mx), mesh_y=int(my), mesh_z=int(mz),
                          x_scene=float(sx), y_scene=float(sy), z_scene=float(sz))

    def terrain_config(self):
        from ..terrain.mesh import TerrainConfig
        return TerrainConfig(
            mode=self.mesh_gen_mode, shape=self.mesh_gen_shape,
            mesh_seed=self.mesh_seed, mesh_scale=self.mesh_scale,
            glaciate=bool(self.glaciate),
            glaciate_exp=(self.glaciate_exp if self.glaciate_exp != 0.0 else 3.0),
            erosion_iters=self.erosion_iters, erode_amount=self.erode_amount,
            water_h_off_rel=self.water_h_off[0], water_h_off=self.water_h_off[1],
            relh_adj_tex=self.relh_adj_tex,
            mesh_freq_filter=self.mesh_freq_filter,
            hmap=self.hmap_gen_params(),
        )

    def hmap_gen_params(self):
        """hmap_* keywords -> HmapParams (name remap per 3DWorld.cpp
        kwmf.add calls: plat_height->plat_h etc.)."""
        from ..terrain.mesh import HmapParams
        remap = {"plat_height": "plat_h", "plat_slope": "plat_s",
                 "crat_height": "crat_h", "crat_slope": "crat_s",
                 "crack_depth": "crack_d"}
        kw = {remap.get(k, k): v for k, v in self.hmap.items()}
        return HmapParams(**kw)


# keyword -> (field, arity, type); arity "rest_of_config" handled specially
_INT = int
_FLT = float
_STR = str
_KEYWORDS = {
    "mesh_size": ("mesh_size", 3, _INT),
    "scene_size": ("scene_size", 3, _FLT),
    "mesh_height": ("mesh_height", 1, _FLT),
    "mesh_scale": ("mesh_scale", 1, _FLT),
    "mesh_z_cutoff": ("mesh_z_cutoff", 1, _FLT),
    "mesh_seed": ("mesh_seed", 1, _INT),
    "mesh_gen_mode": ("mesh_gen_mode", 1, _INT),
    "mesh_gen_shape": ("mesh_gen_shape", 1, _INT),
    "mesh_freq_filter": ("mesh_freq_filter", 1, _INT),
    "glaciate": ("glaciate", 1, _INT),
    "glaciate_exp": ("glaciate_exp", 1, _FLT),
    "erosion_iters": ("erosion_iters", 1, _INT),
    "erosion_iters_tt": ("erosion_iters_tt", 1, _INT),
    "erode_amount": ("erode_amount", 1, _FLT),
    "water_h_off": ("water_h_off", 2, _FLT),
    "init_temperature": ("temperature", 1, _FLT),
    "temperature": ("temperature", 1, _FLT),
    "gravity": ("gravity", 1, _FLT),
    "rand_seed": ("rand_seed", 1, _INT),
    "rand_gen_index": ("rand_gen_index", 1, _INT),
    "srand": ("srand", 1, _INT),
    "disable_water": ("disable_water", 1, _INT),
    "disable_scenery": ("disable_scenery", 1, _INT),
    "disable_universe": ("disable_universe", 1, _INT),
    "read_landscape": ("read_landscape", 1, _INT),
    "read_heightmap": ("read_heightmap", 1, _INT),
    "ntrees": ("ntrees", 1, _INT),
    "nsmileys": ("nsmileys", 1, _INT),
    "num_items": ("num_items", 5, _INT),
    "num_dodgeballs": ("num_dodgeballs", 1, _INT),
    "load_coll_objs": ("load_coll_objs", 1, _INT),
    "coll_obj_file": ("coll_obj_file", 1, _STR),
    "state_file": ("state_file", 1, _STR),
    "mesh_file": ("mesh_file", 2, _STR),          # filename + zval scale
    "mesh_height_image": ("mh_filename", 1, _STR),
    "sphere_materials_fn": ("sphere_materials_fn", 1, _STR),
    "ship_def_file": ("ship_def_file", 1, _STR),
    "num_threads": ("num_threads", 1, _INT),
    "num_light_rays": ("num_light_rays", -1, _INT),   # 3-5 ints (rest of line)
    "lighting_file_local": ("lighting_file_local", 4, _STR),
    "lighting_file_sky": ("lighting_file_sky", 4, _STR),
    "lighting_file_global": ("lighting_file_global", 4, _STR),
    "shadow_map_sz": ("shadow_map_sz", 1, _INT),
    "tree_mode": ("tree_mode", 1, _INT),
    "vegetation": ("vegetation", 1, _FLT),
    "relh_adj_tex": ("relh_adj_tex", 1, _FLT),
    "camera_radius": ("camera_radius", 1, _FLT),
    "player_start": ("player_start", 3, _FLT),
    "wind_velocity": ("wind_velocity", 3, _FLT),
    # --- extended registry: every remaining keyword appearing in the
    # reference's shipped scene_config/config*.txt files (arity and type
    # derived from their usage; 3DWorld.cpp:1771-2270 kwm tables).  Many
    # are render-scope — they parse into plain Config attributes so any
    # shipped config loads cleanly and sim-relevant values are typed.
    "add_city_grass": ("add_city_grass", 1, _INT),
    "allow_model3d_quads": ("allow_model3d_quads", 1, _INT),
    "ambient_lighting_scale": ("ambient_lighting_scale", 3, _FLT),
    "ambient_scale": ("ambient_scale", 1, _FLT),
    "atmosphere": ("atmosphere", 1, _FLT),
    "auto_calc_tt_model_zvals": ("auto_calc_tt_model_zvals", 1, _INT),
    "begin_motion": ("begin_motion", 1, _INT),
    "biome_x_offset": ("biome_x_offset", 1, _FLT),
    "bush_probability": ("bush_probability", 5, _FLT),
    "camera_height": ("camera_height", 1, _FLT),
    "camera_step_height": ("camera_step_height", 1, _FLT),
    "cloud_height_offset": ("cloud_height_offset", 1, _FLT),
    "clouds_per_tile": ("clouds_per_tile", 1, _FLT),
    "cobj_z_bias": ("cobj_z_bias", 1, _FLT),
    "crater_radius": ("crater_radius", 1, _FLT),
    "crater_size": ("crater_size", 1, _FLT),
    "create_voxel_landscape": ("create_voxel_landscape", 1, _INT),
    "cube_map_center": ("cube_map_center", 3, _FLT),
    "def_texture_aniso": ("def_texture_aniso", 1, _FLT),
    "def_texture_compress": ("def_texture_compress", 1, _INT),
    "default_anim_id": ("default_anim_id", 1, _INT),
    "default_ground_tex": ("default_ground_tex", 1, _STR),
    "destroy_thresh": ("destroy_thresh", 1, _INT),
    "detail_normal_map": ("detail_normal_map", 1, _INT),
    "disable_dlights": ("disable_dlights", 1, _INT),
    "disable_fire_delay": ("disable_fire_delay", 1, _INT),
    "disable_inf_terrain": ("disable_inf_terrain", 1, _INT),
    "disable_recoil": ("disable_recoil", 1, _INT),
    "disable_shader_effects": ("disable_shader_effects", 1, _INT),
    "disable_tt_water_reflect": ("disable_tt_water_reflect", 1, _INT),
    "dlight_intensity_scale": ("dlight_intensity_scale", 1, _FLT),
    "draw_building_interiors": ("draw_building_interiors", 1, _INT),
    "dynamic_mesh_scroll": ("dynamic_mesh_scroll", 1, _INT),
    "enable_cube_map_bump_maps": ("enable_cube_map_bump_maps", 1, _INT),
    "enable_depth_clamp": ("enable_depth_clamp", 1, _INT),
    "enable_dlight_shadows": ("enable_dlight_shadows", 1, _INT),
    "enable_gamma_correction": ("enable_gamma_correction", 1, _INT),
    "enable_grass_fire": ("enable_grass_fire", 1, _INT),
    "enable_ground_csm": ("enable_ground_csm", 1, _INT),
    "enable_hcopter_shadows": ("enable_hcopter_shadows", 1, _INT),
    "enable_init_shields": ("enable_init_shields", 1, _INT),
    "enable_model3d_bump_maps": ("enable_model3d_bump_maps", 1, _INT),
    "enable_model3d_custom_mipmaps": ("enable_model3d_custom_mipmaps", 1, _INT),
    "enable_model3d_tex_comp": ("enable_model3d_tex_comp", 1, _INT),
    "enable_model_animations": ("enable_model_animations", 1, _INT),
    "enable_mouse_look": ("enable_mouse_look", 1, _INT),
    "enable_shine_map": ("enable_shine_map", 1, _INT),
    "enable_spec_map": ("enable_spec_map", 1, _INT),
    "enable_tiled_mesh_ao": ("enable_tiled_mesh_ao", 1, _INT),
    "enable_timing_profiler": ("enable_timing_profiler", 1, _INT),
    "enable_tt_model_indir": ("enable_tt_model_indir", 1, _INT),
    "enable_tt_model_reflect": ("enable_tt_model_reflect", 1, _INT),
    "far_clip_dist": ("far_clip_dist", 1, _FLT),
    "fast_transparent_spheres": ("fast_transparent_spheres", 1, _INT),
    "fast_water_reflect": ("fast_water_reflect", 1, _INT),
    "flatten_tt_mesh_under_models": ("flatten_tt_mesh_under_models", 1, _INT),
    "floating_light_range": ("floating_light_range", 6, _FLT),
    "flower_density": ("flower_density", 1, _FLT),
    "font_texture_atlas_fn": ("font_texture_atlas_fn", 1, _STR),
    "free_for_all": ("free_for_all", 1, _INT),
    "game_mode_disable_mask": ("game_mode_disable_mask", 1, _INT),
    "global_lighting_update": ("global_lighting_update", 1, _INT),
    "grass_density": ("grass_density", 1, _INT),
    "grass_size": ("grass_size", 2, _FLT),
    "ground_effects_level": ("ground_effects_level", 1, _INT),
    "group_back_face_cull": ("group_back_face_cull", 1, _INT),
    "head_bob_amount": ("head_bob_amount", 1, _FLT),
    "hmap_filter_width": ("hmap_filter_width", 1, _INT),
    "indir_light_exp": ("indir_light_exp", 1, _FLT),
    "indir_vert_offset": ("indir_vert_offset", 1, _FLT),
    "inf_terrain_scenery": ("inf_terrain_scenery", 1, _INT),
    "init_game_mode": ("init_game_mode", 1, _INT),
    "init_num_balls": ("init_num_balls", 1, _INT),
    "init_tree_mode": ("init_tree_mode", 1, _INT),
    "invert_bump_maps": ("invert_bump_maps", 1, _INT),
    "invert_model3d_faces": ("invert_model3d_faces", 1, _INT),
    "invert_model_nmap_bscale": ("invert_model_nmap_bscale", 1, _INT),
    "jump_height": ("jump_height", 1, _FLT),
    "leaf_color": ("leaf_color", 5, _FLT),
    "left_handed": ("left_handed", 1, _INT),
    "lighting_update_offline": ("lighting_update_offline", 1, _INT),
    "load_hmv": ("load_hmv", 5, _INT),
    "max_cube_map_tex_sz": ("max_cube_map_tex_sz", 1, _INT),
    "max_ray_bounces": ("max_ray_bounces", 1, _INT),
    "max_unique_trees": ("max_unique_trees", 1, _INT),
    "merge_model_objects": ("merge_model_objects", 1, _INT),
    "mesh_color_scale": ("mesh_color_scale", 3, _FLT),
    "mesh_detail_tex": ("mesh_detail_tex", 1, _STR),
    "mesh_diffuse_tex_fn": ("mesh_diffuse_tex_fn", 2, _STR),
    "mesh_freq_mult": ("mesh_freq_mult", 1, _FLT),
    "mesh_mag_mult": ("mesh_mag_mult", 1, _FLT),
    "mesh_start_freq": ("mesh_start_freq", 1, _FLT),
    "mesh_start_mag": ("mesh_start_mag", 1, _FLT),
    "mh_filename": ("mh_filename", 4, _STR),
    "mh_filename_tiled_terrain": ("mh_filename_tiled_terrain", 1, _STR),
    "model3d_alpha_thresh": ("model3d_alpha_thresh", 1, _FLT),
    "model3d_texture_anisotropy": ("model3d_texture_anisotropy", 1, _FLT),
    "model3d_winding_number_normal": ("model3d_winding_number_normal", 1, _INT),
    "model_auto_tc_scale": ("model_auto_tc_scale", 1, _FLT),
    "model_calc_tan_vect": ("model_calc_tan_vect", 1, _INT),
    "model_hemi_lighting_scale": ("model_hemi_lighting_scale", 1, _FLT),
    "model_mat_lod_thresh": ("model_mat_lod_thresh", 1, _FLT),
    "moon_rot": ("moon_rot", 1, _FLT),
    "mouse_sensitivity": ("mouse_sensitivity", 1, _FLT),
    "mouse_smooth_factor": ("mouse_smooth_factor", 1, _FLT),
    "mt_cobj_tree_build": ("mt_cobj_tree_build", 1, _INT),
    "nleaves_scale": ("nleaves_scale", 1, _FLT),
    "no_store_model_textures_in_memory": ("no_store_model_textures_in_memory", 1, _INT),
    "no_subdiv_model": ("no_subdiv_model", 1, _INT),
    "num_bflies_per_tile": ("num_bflies_per_tile", 1, _INT),
    "num_birds_per_tile": ("num_birds_per_tile", 1, _INT),
    "num_dynam_parts": ("num_dynam_parts", 1, _INT),
    "num_fish_per_tile": ("num_fish_per_tile", 1, _INT),
    "num_test_snowflakes": ("num_test_snowflakes", 1, _INT),
    "ocean_depth_opacity_mult": ("ocean_depth_opacity_mult", 1, _FLT),
    "ocean_wave_height": ("ocean_wave_height", 1, _FLT),
    "only_pine_palm_trees": ("only_pine_palm_trees", 1, _INT),
    "pine_tree_radius_scale": ("pine_tree_radius_scale", 1, _FLT),
    "play_gameplay_alert": ("play_gameplay_alert", 1, _INT),
    "player_damage": ("player_damage", 1, _FLT),
    "player_name": ("player_name", 1, _STR),
    "player_speed": ("player_speed", 1, _FLT),
    "pre_load_full_tiled_terrain": ("pre_load_full_tiled_terrain", 1, _INT),
    "preproc_cube_cobjs": ("preproc_cube_cobjs", 1, _INT),
    "ray_step_size_mult": ("ray_step_size_mult", 1, _FLT),
    "read_hmap_modmap_filename": ("read_hmap_modmap_filename", 1, _STR),
    "read_voxel_brush_filename": ("read_voxel_brush_filename", 1, _STR),
    "reflect_plane_z": ("reflect_plane_z", 6, _FLT),
    "reverse_3ds_vert_winding_order": ("reverse_3ds_vert_winding_order", 1, _INT),
    "rgen_seed": ("rgen_seed", 1, _INT),
    "rotate_trees": ("rotate_trees", 1, _INT),
    "self_damage": ("self_damage", 1, _FLT),
    "set_czmax": ("set_czmax", 1, _FLT),
    "show_map_view_fractal": ("show_map_view_fractal", 1, _INT),
    "skip_light_vis_test": ("skip_light_vis_test", 1, _INT),
    "sky_occlude_scale": ("sky_occlude_scale", 1, _FLT),
    "skybox_cube_map": ("skybox_cube_map", 1, _STR),
    "sm_tree_density": ("sm_tree_density", 1, _FLT),
    "sm_tree_scale": ("sm_tree_scale", 1, _FLT),
    "smap_thresh_scale": ("smap_thresh_scale", 1, _FLT),
    "smiley_accuracy": ("smiley_accuracy", 1, _INT),
    "smiley_damage": ("smiley_damage", 1, _FLT),
    "smiley_speed": ("smiley_speed", 1, _FLT),
    "snow_coverage_resolution": ("snow_coverage_resolution", 1, _INT),
    "snow_depth": ("snow_depth", 1, _FLT),
    "snow_file": ("snow_file", 2, _STR),
    "snow_random": ("snow_random", 1, _FLT),
    "speed_mult": ("speed_mult", 1, _FLT),
    "start_in_inf_terrain": ("start_in_inf_terrain", 1, _INT),
    "start_maximized": ("start_maximized", 1, _INT),
    "sun_rot": ("sun_rot", 1, _FLT),
    "sunlight_brightness": ("sunlight_brightness", 1, _FLT),
    "sunlight_intensity": ("sunlight_intensity", 1, _FLT),
    "team_damage": ("team_damage", 1, _FLT),
    "team_start": ("team_start", 5, _INT),
    "teams": ("teams", 1, _INT),
    "texture_alpha_in_red_comp": ("texture_alpha_in_red_comp", 1, _INT),
    "tiled_terrain_fog_density": ("tiled_terrain_fog_density", 1, _FLT),
    "tiled_terrain_only": ("tiled_terrain_only", 1, _INT),
    "toggle_mesh_enabled": ("toggle_mesh_enabled", 0, _INT),
    "toggle_reflections": ("toggle_reflections", 0, _INT),
    "tree_4th_branches": ("tree_4th_branches", 1, _INT),
    "tree_branch_radius": ("tree_branch_radius", 1, _FLT),
    "tree_coll_level": ("tree_coll_level", 1, _INT),
    "tree_dead_prob": ("tree_dead_prob", 1, _FLT),
    "tree_deadness": ("tree_deadness", 1, _FLT),
    "tree_density_thresh": ("tree_density_thresh", 1, _FLT),
    "tree_depth_scale": ("tree_depth_scale", 1, _FLT),
    "tree_height_scale": ("tree_height_scale", 1, _FLT),
    "tree_lod_scale": ("tree_lod_scale", 4, _FLT),
    "tree_size": ("tree_size", 1, _FLT),
    "tree_slope_thresh": ("tree_slope_thresh", 1, _FLT),
    "tree_type_rand_zone": ("tree_type_rand_zone", 1, _FLT),
    "tt_grass_scale_factor": ("tt_grass_scale_factor", 1, _FLT),
    "tt_triplanar_tex": ("tt_triplanar_tex", 1, _INT),
    "two_sided_lighting": ("two_sided_lighting", 1, _INT),
    "unlimited_weapons": ("unlimited_weapons", 1, _INT),
    "use_core_context": ("use_core_context", 1, _INT),
    "use_dense_voxels": ("use_dense_voxels", 1, _INT),
    "use_grass_tess": ("use_grass_tess", 1, _INT),
    "use_instanced_pine_trees": ("use_instanced_pine_trees", 1, _INT),
    "use_interior_cube_map_refl": ("use_interior_cube_map_refl", 1, _INT),
    "use_model3d_tex_mipmaps": ("use_model3d_tex_mipmaps", 1, _INT),
    "use_model_lod_blocks": ("use_model_lod_blocks", 1, _INT),
    "use_obj_file_bump_grayscale": ("use_obj_file_bump_grayscale", 1, _INT),
    "use_voxel_rocks": ("use_voxel_rocks", 1, _INT),
    "use_waypoints": ("use_waypoints", 1, _INT),
    "use_z_prepass": ("use_z_prepass", 1, _INT),
    "verbose": ("verbose", 1, _INT),
    "vertex_optimize_flags": ("vertex_optimize_flags", 3, _INT),
    "vsync_enabled": ("vsync_enabled", 1, _INT),
    "water_is_lava": ("water_is_lava", 1, _INT),
    "window_height": ("window_height", 1, _INT),
    "window_width": ("window_width", 1, _INT),
    "write_hmap_modmap_filename": ("write_hmap_modmap_filename", 1, _STR),
    "write_voxel_brush_filename": ("write_voxel_brush_filename", 1, _STR),
}
_SUBCONFIG = {"voxel", "buildings", "sphere_gen", "city_params", "city",
              "tree"}


def _parse_lines(lines, cfg: Config, base_dir: str):
    """Line-oriented parse: each line is `keyword args...`; sub-config
    prefixes (buildings/city/voxel/...) consume their WHOLE line (their
    values can be multi-token, e.g. colors), like the reference's
    per-domain kwm dispatch."""
    for toks in lines:
        kw, args = toks[0], toks[1:]
        if kw == "end":                        # stop reading (3DWorld.cpp:2296)
            break
        if kw == "toggle_mesh_enabled":        # zero-arg toggles (:2173-2174)
            cfg.display_mode ^= 0x01
            continue
        if kw == "toggle_reflections":
            cfg.display_mode ^= 0x10
            continue
        if kw.startswith("hmap_") and kw != "hmap_filter_width" and args:
            # hmap_params_t fields, each a single float (3DWorld.cpp:2007-2020)
            cfg.hmap[kw[5:]] = float(args[0])
            continue
        if kw == "include" and args:
            load_config_file(_resolve(args[0], base_dir, cfg), cfg)
            continue
        if kw in _SUBCONFIG:
            name = "city" if kw in ("city_params", "city") else kw
            sub = getattr(cfg, name, None)
            if isinstance(sub, dict) and args:
                sub[args[0]] = args[1] if len(args) == 2 else tuple(args[1:])
            continue
        if kw in _KEYWORDS:
            fname, arity, typ = _KEYWORDS[kw]
            try:
                if arity == 1:
                    setattr(cfg, fname, _num(typ, args[0]))
                elif arity == -1:  # variable-length (num_light_rays: 3-5)
                    setattr(cfg, fname,
                            tuple(_num(typ, a) for a in args))
                else:
                    vals = tuple(_num(typ, a) for a in args[:arity])
                    setattr(cfg, fname, vals if arity > 1 else vals[0])
            except (ValueError, IndexError):
                cfg.extra[kw] = tuple(args)   # malformed: keep raw
        else:
            # unmodeled keyword: keep the raw args (flag-style lines
            # store None)
            cfg.extra[kw] = (args[0] if len(args) == 1
                             else (tuple(args) if args else None))
    return cfg


def _resolve(fn: str, base_dir: str, cfg: Config) -> str:
    for d in (base_dir, *cfg.include_dirs):
        p = os.path.join(d, fn)
        if os.path.exists(p):
            return p
    return fn


def load_config_file(path: str, cfg: Config | None = None) -> Config:
    if cfg is None:
        cfg = Config()
    if not os.path.exists(path):
        return cfg  # nonfatal, like the reference's missing optional files
    with open(path) as f:
        text = f.read()
    base = os.path.dirname(os.path.abspath(path))
    if base not in cfg.include_dirs:
        cfg.include_dirs = (*cfg.include_dirs, base)
    return _parse_lines(tokenize_lines(text), cfg, base)


def load_config(path: str) -> Config:
    """Load one scene config (the equivalent of a defaults.txt entry)."""
    return load_config_file(path)


def _dget(d, key, typ, default):
    v = d.get(key)
    if v is None:
        return default
    try:
        return typ(v if not isinstance(v, tuple) else v[0])
    except (ValueError, TypeError):
        return default


def city_params(cfg: Config) -> dict:
    """Typed view of the `city <param> ...` sub-config
    (city_building_params.cpp keyword map): the knobs the city
    generator consumes."""
    c = cfg.city
    return {
        "num_cities": _dget(c, "num_cities", int, 2),
        "city_size_min": _dget(c, "city_size_min", int, 16),
        "city_size_max": _dget(c, "city_size_max", int, 32),
        "city_border": _dget(c, "city_border", int, 4),
        "road_width": _dget(c, "road_width", float, 1.0),
        "road_spacing": _dget(c, "road_spacing", float, 8.0),
        "num_cars": _dget(c, "num_cars", int, 0),
        "num_peds": _dget(c, "num_peds", int, 0),
        "num_rr_tracks": _dget(c, "num_rr_tracks", int, 0),
        "plots_to_parks_ratio": _dget(c, "plots_to_parks_ratio", int, 20),
    }


def building_params(cfg: Config):
    """Typed view of the `buildings <param> ...` sub-config mapped onto
    city/buildings.py BuildingParams (+ the animal counts the building
    AI consumes)."""
    from ..city.buildings import BuildingParams
    b = cfg.buildings
    bp = BuildingParams(
        min_sz=_dget(b, "size_range_min", float, 2.0),
        max_sz=_dget(b, "size_range_max", float, 6.0),
        min_floors=_dget(b, "min_levels", int, 1),
        max_floors=_dget(b, "max_levels", int, 8),
        num_materials=max(1, _dget(b, "num_materials", int, 4)),
        round_prob=_dget(b, "round_prob", float, 0.15),
        # rotated buildings only when the config allows a rotation angle
        rotate_prob=0.2 if _dget(b, "max_rot_angle", float, 0.0) > 0 else 0.0,
        max_rot_angle=_dget(b, "max_rot_angle", float, 0.5),
    )
    extras = {
        "num_place": _dget(b, "num_place", int, 100),
        "num_tries": _dget(b, "num_tries", int, 10),
        "flatten_mesh": _dget(b, "flatten_mesh", int, 0),
        "num_rats_min": _dget(b, "num_rats_min", int, 0),
        "num_rats_max": _dget(b, "num_rats_max", int, 0),
        "num_spiders_min": _dget(b, "num_spiders_min", int, 0),
        "num_spiders_max": _dget(b, "num_spiders_max", int, 0),
        "num_snakes_min": _dget(b, "num_snakes_min", int, 0),
        "num_snakes_max": _dget(b, "num_snakes_max", int, 0),
        "ai_target_player": _dget(b, "ai_target_player", int, 0),
    }
    return bp, extras


def load_config_tiered(base_dir: str = "scene_config") -> Config:
    """The reference's three-tier startup load (3DWorld.cpp:1650-1665):
    config_pre.txt -> each file listed in defaults.txt (or config.txt if
    no defaults list) -> config_post.txt.  Missing tiers are nonfatal,
    like the reference's optional files."""
    cfg = Config()
    load_config_file(os.path.join(base_dir, "config_pre.txt"), cfg)
    defaults = os.path.join(base_dir, "defaults.txt")
    if os.path.exists(defaults):
        with open(defaults) as f:
            for line in f:
                name = line.split("#")[0].strip()
                if name:
                    load_config_file(_resolve(name, base_dir, cfg), cfg)
    else:
        load_config_file(os.path.join(base_dir, "config.txt"), cfg)
    load_config_file(os.path.join(base_dir, "config_post.txt"), cfg)
    return cfg


def unbound_report(cfg: Config) -> dict:
    """Keywords that landed unmodeled in cfg.extra — the per-scene config
    coverage report.  Golden scenes must report empty
    (tests/test_scene_dsl.py)."""
    return dict(cfg.extra)
