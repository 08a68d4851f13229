"""mesh: mean host milliseconds of one object's mesh in the window
(density grid, marching cubes, vertex colours), ending in a synchronise."""


def read(ctx):
    s = ctx.get("mesh_s") or []
    return 1e3 * sum(s) / len(s) if s else None
