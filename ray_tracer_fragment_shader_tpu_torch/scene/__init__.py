from .builder import SceneBuilder, convert_board_coordinate, MENU_TYPES
from .flat import FlatScene, concat_scenes, tri_derived
from .materials import (Material, WHITE_SQUARE, BLACK_SQUARE, SPHERE_MATERIAL,
                        TETRAHEDRON_MATERIAL, CUBE_MATERIAL, DEFAULT_MATERIAL)
from .presets import PRESETS

__all__ = [
    "SceneBuilder", "convert_board_coordinate", "MENU_TYPES",
    "FlatScene", "concat_scenes", "tri_derived", "Material", "WHITE_SQUARE", "BLACK_SQUARE",
    "SPHERE_MATERIAL", "TETRAHEDRON_MATERIAL", "CUBE_MATERIAL",
    "DEFAULT_MATERIAL", "PRESETS",
]
