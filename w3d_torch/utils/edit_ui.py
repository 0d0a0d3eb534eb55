"""In-game editor menus (headless); port of `3dworld_tpu/utils/edit_ui.py`
(pure host code, copied).

The reference's live-editing UI (`keyboard_menu_t` edit_ui.cpp:20-86)
is a keyboard-driven control list: arrow keys select a control and
increase/decrease its value with wrap/clamp, each menu binding a
subsystem's tunables (heightmap brush `hmap_kbd_menu_t` :88, voxel
brush `voxel_edit_kbd_menu_t` :161, water/leaf/lighting params
:327-344).  This port keeps the interaction model (select / adjust /
read back a slider position and text) but renders nothing — the caller
(CLI, notebook, or a front-end) consumes `render()` lines; the menus
mutate plain parameter dicts that feed the actual edit entry points
(terrain brush edits, voxel/edit.py brushes, water/ripples params).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Control:
    name: str
    value: float
    lo: float
    hi: float
    step: float
    wrap: bool = False
    fmt: str = "{:.3g}"
    choices: list | None = None     # discrete labels (shape/mode enums)

    def adjust(self, delta: int):
        if self.choices is not None:
            n = len(self.choices)
            self.value = (int(self.value) + delta) % n if self.wrap else \
                min(max(int(self.value) + delta, 0), n - 1)
            return
        v = self.value + delta * self.step
        if self.wrap:
            span = self.hi - self.lo
            v = self.lo + (v - self.lo) % span
        self.value = min(max(v, self.lo), self.hi)

    @property
    def slider_pos(self) -> float:
        if self.choices is not None:
            return (int(self.value)) / max(len(self.choices) - 1, 1)
        return (self.value - self.lo) / max(self.hi - self.lo, 1e-12)

    @property
    def text(self) -> str:
        if self.choices is not None:
            return self.choices[int(self.value)]
        return self.fmt.format(self.value)


@dataclass
class KeyboardMenu:
    """keyboard_menu_t: a titled list of controls with one selected."""

    title: str
    controls: list = field(default_factory=list)
    cur: int = 0

    def select_next(self):
        self.cur = (self.cur + 1) % len(self.controls)

    def select_prev(self):
        self.cur = (self.cur - 1) % len(self.controls)

    def increase(self):
        self.controls[self.cur].adjust(+1)

    def decrease(self):
        self.controls[self.cur].adjust(-1)

    def __getitem__(self, name: str) -> Control:
        for c in self.controls:
            if c.name == name:
                return c
        raise KeyError(name)

    def values(self) -> dict:
        return {c.name: (c.text if c.choices is not None else c.value)
                for c in self.controls}

    def render(self, ndiv: int = 20) -> list[str]:
        """Text rows like draw_one_control_text: slider + name: value,
        '>' marks the selected control."""
        rows = [self.title]
        for i, c in enumerate(self.controls):
            pos = round((ndiv - 1) * min(max(c.slider_pos, 0.0), 1.0))
            bar = "-" * pos + "+" + "-" * (ndiv - 1 - pos)
            sel = ">" if i == self.cur else " "
            rows.append(f"{sel}{bar}  {c.name}: {c.text}")
        return rows


def hmap_brush_menu() -> KeyboardMenu:
    """hmap_kbd_menu_t (edit_ui.cpp:88): heightmap brush tunables."""
    return KeyboardMenu("Heightmap Brush", [
        Control("delay", 0, 0, 10, 1, fmt="{:.0f}"),
        Control("brush_shape", 0, 0, 2, 1, wrap=True,
                choices=["constant", "linear", "quadratic"]),
        Control("brush_radius", 8, 0, 64, 1, fmt="{:.0f}"),
        Control("brush_weight", 0.1, -1.0, 1.0, 0.02),
    ])


def voxel_brush_menu() -> KeyboardMenu:
    """voxel_edit_kbd_menu_t (edit_ui.cpp:161)."""
    return KeyboardMenu("Voxel Brush", [
        Control("mode", 0, 0, 2, 1, wrap=True,
                choices=["add", "remove", "smooth"]),
        Control("shape", 0, 0, 2, 1, wrap=True,
                choices=["sphere", "cube", "cylinder"]),
        Control("radius", 2.0, 0.5, 16.0, 0.5),
        Control("weight", 0.5, 0.05, 2.0, 0.05),
    ])


def water_params_menu() -> KeyboardMenu:
    """Water color/params menu (edit_ui.cpp:327-344)."""
    return KeyboardMenu("Water", [
        Control("ripple_damping", 0.95, 0.80, 1.0, 0.005),
        Control("wave_height", 0.02, 0.0, 0.2, 0.005),
        Control("wave_speed", 0.965, 0.8, 1.0, 0.005),
        Control("alpha", 0.6, 0.0, 1.0, 0.05),
    ])


def leaf_params_menu() -> KeyboardMenu:
    return KeyboardMenu("Leaves", [
        Control("color_var", 0.2, 0.0, 1.0, 0.05),
        Control("season", 0, 0, 3, 1, wrap=True,
                choices=["spring", "summer", "fall", "winter"]),
        Control("wind_scale", 1.0, 0.0, 4.0, 0.1),
    ])


def lighting_params_menu() -> KeyboardMenu:
    return KeyboardMenu("Lighting", [
        Control("indir_scale", 1.0, 0.0, 4.0, 0.1),
        Control("sky_intensity", 1.0, 0.0, 4.0, 0.1),
        Control("local_intensity", 1.0, 0.0, 4.0, 0.1),
        Control("num_rays_log2", 16, 10, 24, 1, fmt="{:.0f}"),
    ])


ALL_MENUS = {
    "hmap": hmap_brush_menu,
    "voxel": voxel_brush_menu,
    "water": water_params_menu,
    "leaf": leaf_params_menu,
    "lighting": lighting_params_menu,
}
