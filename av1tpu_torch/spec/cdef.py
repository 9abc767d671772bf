"""CDEF constants (spec 7.15; copy of av1tpu/spec/cdef.py's tables)."""

# CdefDirections[dir][k] = (dy, dx) of the k-th primary tap (spec 7.15.3)
CDEF_DIRECTIONS = (
    ((-1, 1), (-2, 2)),
    ((0, 1), (-1, 2)),
    ((0, 1), (0, 2)),
    ((0, 1), (1, 2)),
    ((1, 1), (2, 2)),
    ((1, 0), (2, 1)),
    ((1, 0), (2, 0)),
    ((1, 0), (2, -1)),
)

DIV_TABLE = (0, 840, 420, 280, 210, 168, 140, 120, 105)
