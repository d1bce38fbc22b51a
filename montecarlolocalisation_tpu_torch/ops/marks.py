"""The stage marks' wrapper: one launch of the empty kernel
`mcl_mark_<name>` (csrc/marks.cu) on the device's current stream.
utils/profiling.mark calls it on CUDA only, so the CPU never loads the
kernel library."""
from __future__ import annotations

from . import build

# The marks, in the order of the C entry's index: `begin` and `end` open
# and close a graph's replay (models/compiled), the others precede the
# filter tick's stages, and `emit` follows the last (models/filter).
# `refine` opens the refinement (models/filter), `refine_grad` each
# round's gradient and `refine_score` each round's scoring and acceptance
# (models/refine).
MARKS = ("begin", "motion", "weights", "resample", "cluster", "emit", "end",
         "refine", "refine_grad", "refine_score")
_INDEX = {name: i for i, name in enumerate(MARKS)}


def launch(name: str, device) -> None:
    """Launch the mark `name` on `device`'s current stream."""
    build.check(build.library().mcl_mark(_INDEX[name],
                                         build.stream_handle(device)),
                "mcl_mark")
