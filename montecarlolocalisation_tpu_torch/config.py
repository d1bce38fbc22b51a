"""The configuration dataclasses, shared with the JAX package.

`montecarlolocalisation_tpu.config` imports no JAX, and the JAX package's
`__init__` imports only that module, so both packages read one set of
frozen dataclasses: a config means the same thing in both.  This module is
the port's only import from the JAX package.
"""
from montecarlolocalisation_tpu.config import (  # noqa: F401
    DEFAULT_CONFIG, WALL_BOTTOM, WALL_LEFT, WALL_RIGHT, WALL_TOP,
    ClusterConfig, FilterConfig, GridConfig, HysteresisConfig, InitConfig,
    MotionModelConfig, ResampleConfig, SensorModelConfig,
)
