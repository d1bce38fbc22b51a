"""The port's configuration dataclasses.

A copy of the filter's, the mapper's, SLAM's and the controllers' part
of montecarlolocalisation_tpu/config.py: the same class names, fields,
defaults and frozen=True, so a config means the same thing in both
packages (tests/test_torch_config.py holds them equal
field for field).  Each default is the reference value; the JAX package's
file cites the reference line of each.  `interop.config_from` rebuilds one
of these from any object with the same field names.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

# Wall / direction conventions (reference: msg/Cell.msg).
WALL_RIGHT, WALL_TOP, WALL_LEFT, WALL_BOTTOM = 0, 1, 2, 3
DIR_RIGHT, DIR_UP, DIR_LEFT, DIR_DOWN = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Maze raster geometry (reference: src/publish_map_rviz.cpp:272-276)."""

    cell_px: int = 8
    cell_meters: float = 0.8
    wall_occupied: int = 100
    free_space: int = 0
    occupied_threshold: int = 50
    origin_x: float = 0.0
    origin_y: float = 0.0

    @property
    def resolution(self) -> float:
        """Meters per pixel (0.8 / 8 = 0.1)."""
        return self.cell_meters / self.cell_px


@dataclasses.dataclass(frozen=True)
class SensorModelConfig:
    """Beam likelihood model (reference: src/monte_carlo.cpp:623-682)."""

    w_hit: float = 0.8
    w_rand: float = 0.2
    sigma: float = 0.1
    max_range: float = 1.0
    rand_window: float = 0.01
    gauss_max_diff: float = 1.1
    laser_offset: float = 0.1
    invalid_beam_range: float = 1.05
    angle_crop_deg: float = 120.0
    beam_skip: int = 20
    ray_step: float = 0.1
    negate_beam_angle: bool = True
    ray_mode: str = "fixed"          # "fixed" | "dda" | "analytic"
    lookup_mode: str = "auto"        # "gather" takes the dense path
    beam_combine: str = "sum"        # "sum" (reference) | "log"
    log_temperature: float = 1.0
    quantize_ray_deg: bool = False
    unknown_credit: float = 0.3
    unknown_credit_mode: str = "interval"

    @property
    def num_ray_steps(self) -> int:
        """Steps r = 0, step, ..., < max_range (monte_carlo.cpp:370-372)."""
        return int(math.ceil(self.max_range / self.ray_step))


@dataclasses.dataclass(frozen=True)
class MotionModelConfig:
    """Odometry / motion noise (reference: monte_carlo.cpp:695-739,1198)."""

    wheel_space: float = 0.265
    wheel_size: float = 0.062
    alpha_1: float = 0.001
    alpha_2: float = 0.001
    alpha_3: float = 0.0001
    alpha_4: float = 0.0001
    shared_noise: bool = True


@dataclasses.dataclass(frozen=True)
class ResampleConfig:
    """Resampling + AMCL-style adaptive injection (monte_carlo.cpp:457-561)."""

    lost_max_injection: int = 200
    lost_alpha_slow: float = 0.05
    lost_alpha_fast: float = 0.5
    lost_jitter_xy: float = 0.05
    lost_jitter_theta: float = math.pi / 12.0
    conf_max_injection: int = 50
    conf_alpha_slow: float = 0.02
    conf_alpha_fast: float = 2.0
    conf_jitter_xy: float = 0.01
    conf_jitter_theta: float = 0.0
    method: str = "multinomial"      # "multinomial" | "systematic"
    multinomial_impl: str = "auto"   # "sorted" means "exact" in the port
    expand: str = "auto"             # "xla" takes the plain gather
    ess_threshold: Optional[float] = None
    sharded_exchange: str = "ring"


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Gradient-guided particle refinement (models/refine; iters=0 is
    off)."""

    iters: int = 0
    step_xy: float = 0.02
    step_theta: float = 0.01
    ray_mode: str = "dda"
    eps: float = 1e-9


@dataclasses.dataclass(frozen=True)
class KLDConfig:
    """KLD-sampling statistic (Fox 2001; ROS AMCL's kld_err/kld_z), read
    by the server's adapt_mode="kld" through models/kld."""

    epsilon: float = 0.05
    z: float = 2.326
    bin_xy: float = 0.5
    bin_theta: float = math.pi / 18.0
    subsample: int = 8192


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Occupancy-grid mapping (models/mapping).  The defaults are the
    reference raster's geometry (publish_map_rviz.cpp:272-274: 49 px at
    0.1 m a pixel), so a map learned on the default maze is pixel for
    pixel comparable with the published one."""

    height: int = 49
    width: int = 49
    resolution: float = 0.1
    origin_x: float = 0.0
    origin_y: float = 0.0
    l_occ: float = 0.9               # log-odds a hit observation
    l_free: float = 0.35             # log-odds a free-space crossing
    clamp: float = 8.0               # saturation
    half_width: float = 0.055        # beam half-width, m
    hit_margin: float = 0.04         # near-side hit slack, m
    hit_depth: float = 0.07          # far-side hit depth, m
    max_trusted_range: float = 1.02  # drops the 1.05 NaN sentinel


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    """Rao-Blackwellized particle-filter SLAM (models/slam): each particle
    carries a pose and its own occupancy grid.  The fields' meaning and
    the measurements behind each default are in the JAX package's
    config.py:245-359."""

    num_particles: int = 128
    mapping: MappingConfig = MappingConfig()
    sensor: SensorModelConfig = SensorModelConfig()
    motion: MotionModelConfig = MotionModelConfig()
    z_hit: float = 0.85
    z_rand: float = 0.15
    field_sigma_px: float = 1.0
    field_radius_px: int = 4
    z_short: float = 0.5
    free_samples: int = 6
    free_margin: float = 0.18
    alpha_scale: float = 1.0
    ess_threshold: float = 0.7
    refine_iters: int = 0
    refine_step_xy: float = 0.01
    refine_step_theta: float = 0.01
    proposal_candidates: int = 1
    keyframe_trans: float = 0.0
    keyframe_rot: float = 0.0
    closure: bool = False
    closure_xy_range: float = 0.15
    closure_xy_steps: int = 7
    closure_theta_range: float = 0.10
    closure_theta_steps: int = 7
    closure_margin: float = 2.0
    closure_gain: float = 1.0
    closure_min_beams: int = 8
    closure_max_turn: float = 0.05
    closure_cooldown: int = 2
    closure_theta_margin: float = 1.0


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """k-means pose clustering / confidence (monte_carlo.cpp:802-949)."""

    k: int = 3
    max_iters: int = 20
    near_radius: float = 0.4
    impl: str = "auto"               # "dense" takes the plain version


@dataclasses.dataclass(frozen=True)
class HysteresisConfig:
    """Lost/recovered state machine (monte_carlo.cpp:78-81,1030-1081)."""

    init_cluster_threshold: float = 0.1
    init_confident_threshold: float = 0.80
    lost_cluster_threshold: float = 0.1
    lost_confident_threshold: float = 0.8
    conf_cluster_threshold: float = 0.4
    conf_confident_threshold: float = 0.5
    song_lost: int = 1
    song_recovered: int = 2


@dataclasses.dataclass(frozen=True)
class InitConfig:
    """Uniform particle sampler (monte_carlo.cpp:415-450,394-407)."""

    cell_offset: float = 0.2
    global_offset: float = 0.05
    init_weight: float = 1.0
    sampler: str = "auto"            # "packed" means "reference" in the port
    partial_map_cells: str = "uniform"


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Full MCL configuration; defaults reproduce the reference filter."""

    num_particles: int = 1500
    tick_dt: float = 0.1
    grid: GridConfig = GridConfig()
    sensor: SensorModelConfig = SensorModelConfig()
    motion: MotionModelConfig = MotionModelConfig()
    resample: ResampleConfig = ResampleConfig()
    refine: RefineConfig = RefineConfig()
    cluster: ClusterConfig = ClusterConfig()
    hysteresis: HysteresisConfig = HysteresisConfig()
    init: InitConfig = InitConfig()
    valid_pos_offset: float = 0.1
    dtype: str = "float32"

    def replace(self, **kw) -> "FilterConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# Controller configs (montecarlolocalisation_tpu/config.py:444-531)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PIDConfig:
    """Two-phase PID point-to-point drive (src/PID_drive.cpp)."""

    heading_gain: float = 8.0
    rotate_exit_rad: float = 0.05
    dist_exit_m: float = 0.05
    max_wheel_speed: float = 100.0
    rate_hz: float = 10.0
    max_phase_ticks: int = 600


@dataclasses.dataclass(frozen=True)
class APFConfig:
    """Artificial-potential-field drive.  Presets for each reference node."""

    attract_gain: float = 90.0
    repel_gain: float = 0.0
    influence_radius: float = 0.2
    heading_gain: float = 8.0
    fade_exponent: float = 1.0
    repel_half: bool = True           # the *0.5 factor (avf.cpp:265)
    repel_sign: float = 1.0           # avf.cpp uses +u (toward point!); pf.cpp -u
    min_obstacle_dist: float = 0.005
    dist_exit_m: float = 0.1
    attract_mag_exit: float = 40.0
    use_attract_exit: bool = True
    mix_sign: float = 1.0             # motor mixing: +1 avf.cpp, -1 potential_field
    subtract_theta: bool = True       # avf.cpp: err = heading - theta; pf.cpp: heading
    near_goal_dist: float = 0.2
    near_goal_repel: float = 0.0
    near_goal_radius: float = 0.2
    rate_hz: float = 10.0
    max_ticks: int = 600

    @staticmethod
    def avf() -> "APFConfig":
        """src/avf.cpp:73-79 gains (service Potential_drive)."""
        return APFConfig()

    @staticmethod
    def potential_field() -> "APFConfig":
        """src/potential_field.cpp:70-74 (service Potential_drive_1)."""
        return APFConfig(
            attract_gain=100.0, repel_gain=0.05, influence_radius=0.5,
            heading_gain=1.0, repel_half=False, repel_sign=-1.0,
            mix_sign=-1.0, subtract_theta=False, use_attract_exit=False,
            near_goal_dist=0.3, near_goal_repel=0.01, near_goal_radius=0.2,
            fade_exponent=0.0,
        )

    @staticmethod
    def global_apf() -> "APFConfig":
        """src/moveToPosition_server.cpp:54-56 global-frame APF."""
        return APFConfig(attract_gain=50.0, repel_gain=0.0,
                         influence_radius=0.6, heading_gain=4.0,
                         subtract_theta=False)


@dataclasses.dataclass(frozen=True)
class WandererConfig:
    """Reactive obstacle-avoidance (src/wanderer_try_final.cpp)."""

    threshold: float = 0.20
    forward_speed: float = 8.0
    turn_speed: float = 5.0
    turn_angle: float = 3.14 / 3
    wheel_space: float = 0.265
    wheel_size: float = 0.062


@dataclasses.dataclass(frozen=True)
class AVFWandererConfig:
    """Pure-repulsion wanderer (src/avf_wanderer.cpp:173-248)."""

    repel_gain: float = 0.001
    influence_radius: float = 0.4
    heading_gain: float = 5.0
    base_speed: float = 8.0


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """RANSAC wall alignment (src/align_server.cpp)."""

    distance_threshold: float = 0.05
    max_iterations: int = 100
    min_inliers: int = 50
    max_lines: int = 2
    wall_standoff: float = 0.40


DEFAULT_CONFIG = FilterConfig()
