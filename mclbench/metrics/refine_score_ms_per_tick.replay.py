"""refine_score_ms_per_tick.replay: device time a tick (ms) of the
refinement's scoring, the stages that the marks `refine` and
`refine_score` open (mclbench/program_telemetry.py): the filter's own
caster scoring the start and each round's proposals, and the acceptance.
None where neither mark ran."""
from mclbench import program_telemetry

STAGES = ("refine", "refine_score")


def read(r):
    split = program_telemetry.stage_split(r) or {}
    ms = [split[s] for s in STAGES if s in split]
    return sum(ms) if ms else None
