"""A tiny cell for the CPU tests: the bench field's recipe at 4 x 4 spheres
and 32 x 18 pixels under the real ladder and the tree-4k limits."""

import copy

from harness import spec

SIZE = (32, 18)


def tiny_cell(chips: int = 1, name: str = "tree-4k.ladder") -> spec.Cell:
    cell = spec.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["scene"].update(nx=4, nz=4, width=SIZE[0], height=SIZE[1])
    cfg["check_pixels"] = 256
    cell.config = cfg
    cell.chips = chips
    return cell
