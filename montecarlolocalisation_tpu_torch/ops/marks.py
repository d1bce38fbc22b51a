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
# (models/refine).  RBPF SLAM's tick (models/slam.slam_step) runs four
# stages of its own, each after its mark, and `emit` after the last:
# `slam_motion` (odometry, noise, propagation, the proposal's
# candidates), `slam_field` (the likelihood field, its blur, the scan's
# bilinear samples and the weights' normalisation: the work
# mclbench/bounds.slam_field_bound counts), `slam_resample` (the ESS gate,
# the gathers of poses and maps, the mean pose, the keyframe criterion,
# the closure) and `slam_map` (the inverse sensor model and the keyframe
# select: the work bounds.ism_bound counts).
MARKS = ("begin", "motion", "weights", "resample", "cluster", "emit", "end",
         "refine", "refine_grad", "refine_score", "slam_motion",
         "slam_field", "slam_resample", "slam_map")
_INDEX = {name: i for i, name in enumerate(MARKS)}


def launch(name: str, device) -> None:
    """Launch the mark `name` on `device`'s current stream."""
    build.check(build.library().mcl_mark(_INDEX[name],
                                         build.stream_handle(device)),
                "mcl_mark")
