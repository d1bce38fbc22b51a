"""The port's own config dataclasses against the JAX package's: the same
classes, fields, defaults and frozen=True (the filter's, the mapper's,
SLAM's and the controllers'), the same APF presets; and
interop.config_from, which rebuilds a port config from a JAX one,
round-trips."""
import dataclasses

import pytest
import torch

from montecarlolocalisation_tpu import config as jconfig
from montecarlolocalisation_tpu_torch import config as tconfig
from montecarlolocalisation_tpu_torch import interop

torch.set_num_threads(1)

CLASSES = ["GridConfig", "SensorModelConfig", "MotionModelConfig",
           "ResampleConfig", "RefineConfig", "ClusterConfig",
           "HysteresisConfig", "InitConfig", "FilterConfig", "KLDConfig",
           "PIDConfig", "APFConfig", "WandererConfig", "AVFWandererConfig",
           "AlignConfig", "MappingConfig", "SLAMConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_matches_jax_field_for_field(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)

    def fields(cls):
        # A nested config's default is compared by its values: the two
        # packages' classes differ, so their instances never compare equal.
        return [(f.name, dataclasses.asdict(f.default)
                 if dataclasses.is_dataclass(f.default) else f.default)
                for f in dataclasses.fields(cls)]

    jf, tf = fields(jcls), fields(tcls)
    assert tf == jf
    assert tcls.__dataclass_params__.frozen
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(tcls(), jf[0][0], jf[0][1])


def test_constants_match_jax():
    for name in ("WALL_RIGHT", "WALL_TOP", "WALL_LEFT", "WALL_BOTTOM",
                 "DIR_RIGHT", "DIR_UP", "DIR_LEFT", "DIR_DOWN"):
        assert getattr(tconfig, name) == getattr(jconfig, name)
    assert interop.config_from(jconfig.DEFAULT_CONFIG) == \
        tconfig.DEFAULT_CONFIG
    assert tconfig.SensorModelConfig().num_ray_steps == \
        jconfig.SensorModelConfig().num_ray_steps
    assert tconfig.GridConfig().resolution == jconfig.GridConfig().resolution


@pytest.mark.parametrize("preset", ["avf", "potential_field", "global_apf"])
def test_apf_presets_match_jax(preset):
    want = getattr(jconfig.APFConfig, preset)()
    got = getattr(tconfig.APFConfig, preset)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert interop.config_from(want) == got


def test_config_from_round_trips():
    jcfg = jconfig.FilterConfig(
        num_particles=777,
        sensor=jconfig.SensorModelConfig(ray_mode="analytic",
                                         beam_combine="log",
                                         log_temperature=2.0),
        resample=jconfig.ResampleConfig(method="systematic",
                                        ess_threshold=0.5),
        cluster=jconfig.ClusterConfig(impl="dense"))
    tcfg = interop.config_from(jcfg)
    assert type(tcfg) is tconfig.FilterConfig
    assert type(tcfg.sensor) is tconfig.SensorModelConfig
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert interop.config_from(tcfg) == tcfg
    assert interop.config_from(jcfg.motion) == tconfig.MotionModelConfig()
    kld = jconfig.KLDConfig(epsilon=0.02, subsample=4096)
    assert interop.config_from(kld) == tconfig.KLDConfig(epsilon=0.02,
                                                         subsample=4096)
    for name in ("PIDConfig", "WandererConfig", "AVFWandererConfig",
                 "AlignConfig"):
        assert interop.config_from(getattr(jconfig, name)()) == \
            getattr(tconfig, name)()
    scfg = jconfig.SLAMConfig(num_particles=32, proposal_candidates=3,
                              closure=True,
                              mapping=jconfig.MappingConfig(height=97))
    tscfg = interop.config_from(scfg)
    assert type(tscfg.mapping) is tconfig.MappingConfig
    assert dataclasses.asdict(tscfg) == dataclasses.asdict(scfg)

    @dataclasses.dataclass(frozen=True)
    class NotAPortConfig:
        x: int = 0

    with pytest.raises(TypeError):
        interop.config_from(NotAPortConfig())
