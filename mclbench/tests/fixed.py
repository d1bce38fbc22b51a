"""Check units that do not depend on the clock: the port's replay entry
driven over a fixed number of segments from a seed, kept as the replay
driver keeps its checked segments, for a check whose numbers repeat from
run to run.  The fleet's configuration is driven through the same entry
(run_episode_batch with one episode a robot): the reference, and so the
check, is the same for both."""
from __future__ import annotations

import hashlib

from mclbench import compare, generator
from mclbench.drivers import replay

# The reference's fields that the digest reads, in this order.
STATE_FIELDS = ("particles", "weights", "odom", "w_slow", "w_fast",
                "confidence", "was_lost", "cluster_threshold",
                "confident_threshold", "best_pose")
OUTPUT_FIELDS = ("exact_pose", "cell_pose", "confidence", "song",
                 "n_injected", "pose", "centers", "threshold",
                 "prev_confidence", "prev_threshold")


def units(world, traffic: dict, seed: int, segments: int = 2,
          seg: int = 8, program=None) -> list:
    """`segments` segments of `seg` ticks of the traffic's logs from the
    filter seed `seed`, each a compare.Unit; `program` (a ReplayProgram's
    class) replaces the port's entry."""
    from mclbench.program import ReplayProgram

    e = int(traffic.get("episodes", traffic.get("robots")))
    ticks = segments * seg
    enc, ranges, _ = generator.logs(
        seed, world.mz, world.angles, world.sensor, world.motion, e, ticks,
        generator.Wander(**traffic["wander"]))
    entry = traffic.get("entry", "run_episode_batch")
    prog = (program or ReplayProgram)(world, entry, e)
    st, kept = None, []
    for t0 in range(0, ticks, seg):
        before = None if st is None else prog.snapshot(st)
        st, outs = prog.segment(st, seed, enc[:, t0:t0 + seg],
                                ranges[:, t0:t0 + seg])
        kept.append(dict(before=before, seed=seed, t0=t0, n=seg,
                         answers=prog.answers(outs),
                         after=prog.snapshot(st)))
    return [replay._unit(world, k, enc, ranges) for k in kept]


def digest(world, us: list) -> str:
    """sha256 of the reference's states and outputs over the units."""
    h = hashlib.sha256()
    for u in us:
        st, outs, _ = compare.run_reference(world, u)
        for f in STATE_FIELDS:
            h.update(getattr(st, f).cpu().numpy().tobytes())
        for o in outs:
            for f in OUTPUT_FIELDS:
                h.update(getattr(o, f).cpu().numpy().tobytes())
    return h.hexdigest()
