"""Level I/O: text parsing, programmatic builders, maze generation, and
shipped built-in worlds."""

from .builders import (
    build_grid,
    empty_level,
    lava_level,
    make_level_from_indices,
    walls_and_goal_16x16,
)
from .maze import (
    check_perfect_maze,
    generate_maze_numpy,
    generate_maze_wilson,
    generate_mazes_device,
    random_maze_level,
)
from .registry import builtin_level, builtin_level_names, builtin_level_path
from .text import (
    LevelParseError,
    level_from_text,
    load_level_file,
    parse_text_grid,
    render_text,
)
