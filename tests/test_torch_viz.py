"""utils/viz against the JAX package's: every renderer gives the same image
byte for byte on the same numpy inputs (and on torch tensors in the
port), the PPM file too.  The align frame draws the port's RANSAC lines
(control/align) and the APF frame the port's controller forces."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from montecarlolocalisation_tpu.config import (
    AlignConfig as JAlignConfig, APFConfig as JAPFConfig,
    FilterConfig as JFilterConfig, SensorModelConfig as JSensorModelConfig,
)
from montecarlolocalisation_tpu.control import align as jalign
from montecarlolocalisation_tpu.control import controllers as jctl
from montecarlolocalisation_tpu.maps import from_walls as jfrom_walls
from montecarlolocalisation_tpu.sim import align_sim as jsim
from montecarlolocalisation_tpu.utils import viz as jviz
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.config import AlignConfig
from montecarlolocalisation_tpu_torch.control import align as talign
from montecarlolocalisation_tpu_torch.control import controllers as tctl
from montecarlolocalisation_tpu_torch.utils import viz as tviz

from torch_parity import maps

torch.set_num_threads(1)


def _same(a, b):
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_render_filter_equal_jax(tmp_path):
    jm, tm = maps()
    rng = np.random.default_rng(0)
    parts = np.stack([rng.uniform(0, 4.8, 300), rng.uniform(0, 4.8, 300),
                      rng.uniform(-3, 3, 300)], -1).astype(np.float32)
    weights = np.where(rng.uniform(size=300) < 0.3, 0.0, 1.0)
    rays = (1.2, 1.3, np.linspace(-1, 1, 5), np.full(5, 0.9))
    kw = dict(best_pose=np.array([2.0, 2.1, 0.3]),
              true_pose=np.array([2.05, 2.0, 0.2]))
    want = jviz.render_filter(np.asarray(jm.occ), parts, weights, rays=rays,
                              **kw)
    _same(tviz.render_filter(np.asarray(jm.occ), parts, weights, rays=rays,
                             **kw), want)
    _same(tviz.render_filter(tm.occ, torch.as_tensor(parts),
                             torch.as_tensor(weights), rays=rays,
                             best_pose=torch.tensor([2.0, 2.1, 0.3]),
                             true_pose=torch.tensor([2.05, 2.0, 0.2])),
          jviz.render_filter(np.asarray(jm.occ), parts, weights, rays=rays,
                             best_pose=np.float32([2.0, 2.1, 0.3]),
                             true_pose=np.float32([2.05, 2.0, 0.2])))
    _same(tviz.render_filter(tm.occ, best_pose=[-1.0, -1.0, -1.0]),
          jviz.render_filter(np.asarray(jm.occ),
                             best_pose=[-1.0, -1.0, -1.0]))
    _same(tviz.draw_heading_error(tviz.render_map(tm.occ), [2.0, 2.0, 0.4],
                                  0.3),
          jviz.draw_heading_error(jviz.render_map(np.asarray(jm.occ)),
                                  [2.0, 2.0, 0.4], 0.3))
    tviz.save_ppm(want, str(tmp_path / "t.ppm"))
    jviz.save_ppm(want, str(tmp_path / "j.ppm"))
    assert (tmp_path / "t.ppm").read_bytes() == (tmp_path / "j.ppm"
                                                 ).read_bytes()


def test_render_align_equal_jax():
    cfg = JFilterConfig(sensor=JSensorModelConfig(ray_mode="dda"))
    px, py, mask = jsim.full_circle_scan(jfrom_walls([[[0, 1, 2, 3]]]),
                                         jnp.asarray((0.3, 0.5, 0.2)), cfg)
    jl = jalign.ransac_extract(jax.random.PRNGKey(0), jnp.asarray(px),
                               jnp.asarray(py), mask, JAlignConfig())
    gen = torch.Generator()
    gen.manual_seed(0)
    tl = talign.ransac_extract(px, py, mask, AlignConfig(), gen=gen)
    assert len(jl) == len(tl) == 2
    want = jviz.render_align(px, py, mask, jl)
    # The same lines as the port's Line objects draw the same frame.
    same = [talign.Line(a=l.a, b=l.b, c=l.c, inlier_mask=l.inlier_mask,
                        first_inlier=l.first_inlier,
                        last_inlier=l.last_inlier) for l in jl]
    _same(tviz.render_align(torch.as_tensor(px), torch.as_tensor(py),
                            torch.as_tensor(mask), same), want)
    img = tviz.render_align(px, py, mask, tl)
    for color in (tviz.C_SCAN, tviz.C_INLIER, tviz.C_LINE, tviz.C_PERP,
                  tviz.C_INTERSECT):
        assert (img == np.array(color, np.uint8)).all(-1).any(), color


def test_render_apf_equal_jax():
    rng = np.random.default_rng(1)
    r = rng.uniform(0.15, 1.0, 24).astype(np.float32)
    a = np.linspace(-2, 2, 24).astype(np.float32)
    px, py = r * np.cos(a), r * np.sin(a)
    mask = r < 0.9
    jcfg = JAPFConfig.potential_field()
    jf = jctl.apf_forces(jnp.float32(1.0), jnp.float32(0.4), jnp.float32(0.0),
                         jnp.float32(0.0), jnp.asarray(px), jnp.asarray(py),
                         jnp.asarray(mask), jcfg)
    tf = tctl.apf_forces(torch.tensor(1.0), torch.tensor(0.4),
                         torch.tensor(0.0), torch.tensor(0.0),
                         torch.as_tensor(px), torch.as_tensor(py),
                         torch.as_tensor(mask), interop.config_from(jcfg))
    want = jviz.render_apf(px, py, mask, jf)
    # The JAX forces through the port's renderer: byte-equal.
    _same(tviz.render_apf(torch.as_tensor(px), torch.as_tensor(py),
                          torch.as_tensor(mask),
                          {k: float(v) for k, v in jf.items()}), want)
    # The port's own forces (within 1e-5 of JAX's) land on the same
    # pixels.
    _same(tviz.render_apf(px, py, mask, tf), want)
