"""Simulation configuration: `.sim` INI files + in-memory settings.

Parity with the reference's `AppSettings` + LoadSettings/SaveSettings
(src/settings.h:40-128, src/main.cpp:508-611): MODEL (input blob, fixed
vertices), SYSTEM (ground level, force coeff, cellsize, gravity), CAMERA
(roll/tilt/zoom/pan), DISPLAY flags, AVATAR pose.

Counterpart of fembrain_tpu/utils/config.py, host Python, the same
fields and INI keys.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from .ini import SettingsScript

# Reference defaults (src/settings.h:19-32, Deformable.h:41).
DEFAULT_FORCE_COEFF = 600000.0
DEFAULT_WINDOW = (1200, 800)


@dataclass
class SimConfig:
    input_file: str = ""
    relative_path: bool = True
    fixed_vertices: list[int] = field(default_factory=list)
    ground_level: float = 0.0
    force_coeff: float = DEFAULT_FORCE_COEFF
    log_sql: bool = True
    cellsize: float = 0.14
    gravity: bool = False
    cam_roll: float = 0.0
    cam_tilt: float = 45.0
    cam_zoom: float = 8.0
    cam_center: tuple = (0.0, 0.0, 0.0)
    cam_pan: tuple = (0.0, 0.0)
    display: dict = field(default_factory=dict)
    avatar_axis: int = 3
    avatar_pos: tuple = (0.0, 0.0, 0.0)
    avatar_thickness: tuple = (1.0, 1.0, 1.0)

    @classmethod
    def load(cls, path: str | Path) -> "SimConfig":
        s = SettingsScript.load(path)
        cfg = cls()
        cfg.relative_path = s.read_bool("MODEL", "RELATIVEPATH", True)
        # The reference reads only INPUTFILE (main.cpp:523-525); older
        # shipped .sim files (sphere.sim etc.) use the BLOBFILE key, so
        # accept it as a fallback to load every canned config.
        cfg.input_file = s.read_str("MODEL", "INPUTFILE") or s.read_str(
            "MODEL", "BLOBFILE"
        )
        fixed = s.read_int_array("MODEL", "FIXEDVERTICES")
        cfg.fixed_vertices = [v for v in fixed if v >= 0]
        cfg.ground_level = s.read_float("SYSTEM", "GROUNDLEVEL", 0.0)
        cfg.force_coeff = s.read_float("SYSTEM", "FORCECOEFF", DEFAULT_FORCE_COEFF)
        cfg.log_sql = s.read_bool("SYSTEM", "LOGSQL", True)
        cfg.cellsize = s.read_float("SYSTEM", "CELLSIZE", 0.14)
        cfg.gravity = s.read_bool("SYSTEM", "GRAVITY", False)
        cfg.cam_roll = s.read_float("CAMERA", "ROLL", 0.0)
        cfg.cam_tilt = s.read_float("CAMERA", "TILT", 45.0)
        cfg.cam_zoom = s.read_float("CAMERA", "ZOOM", 8.0)
        cfg.cam_center = tuple(s.read_vec3("CAMERA", "CENTER"))
        cfg.cam_pan = tuple(s.read_vec("CAMERA", "PAN", 2))
        cfg.display = {
            k: s.read_int("DISPLAY", k, 0) for k in s.sections.get("DISPLAY", {})
        }
        cfg.avatar_axis = s.read_int("AVATAR", "AXIS", 3)
        cfg.avatar_pos = tuple(s.read_vec3("AVATAR", "POS"))
        cfg.avatar_thickness = tuple(
            s.read_vec3("AVATAR", "THICKNESS", [1, 1, 1])
        )
        return cfg

    def save(self, path: str | Path) -> None:
        s = SettingsScript()
        s.write_value("MODEL", "RELATIVEPATH", self.relative_path)
        s.write_value("MODEL", "INPUTFILE", self.input_file)
        s.write_value("MODEL", "FIXEDVERTICESCOUNT", len(self.fixed_vertices))
        s.write_value("MODEL", "FIXEDVERTICES", list(self.fixed_vertices))
        s.write_value("SYSTEM", "GROUNDLEVEL", self.ground_level)
        s.write_value("SYSTEM", "FORCECOEFF", self.force_coeff)
        s.write_value("SYSTEM", "LOGSQL", self.log_sql)
        s.write_value("SYSTEM", "CELLSIZE", self.cellsize)
        s.write_value("SYSTEM", "GRAVITY", self.gravity)
        s.write_value("CAMERA", "ROLL", self.cam_roll)
        s.write_value("CAMERA", "TILT", self.cam_tilt)
        s.write_value("CAMERA", "ZOOM", self.cam_zoom)
        s.write_value("CAMERA", "CENTER", list(self.cam_center))
        s.write_value("CAMERA", "PAN", list(self.cam_pan))
        for k, v in self.display.items():
            s.write_value("DISPLAY", k, v)
        s.write_value("AVATAR", "AXIS", self.avatar_axis)
        s.write_value("AVATAR", "POS", list(self.avatar_pos))
        s.write_value("AVATAR", "THICKNESS", list(self.avatar_thickness))
        s.save(path)

    def resolve_input(self, sim_path: str | Path) -> Path:
        p = Path(self.input_file)
        if self.relative_path:
            return Path(sim_path).parent / p
        return p
