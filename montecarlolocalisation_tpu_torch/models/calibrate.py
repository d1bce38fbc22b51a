"""Differentiable calibration: fit physical parameters from recorded logs.

Torch counterpart of montecarlolocalisation_tpu/models/calibrate.py.  The
reference's geometry and sensor constants (wheel_size / wheel_space,
PID_lib.hpp:19-20; the sensor sigma, monte_carlo.cpp:180) are hand-tuned
numbers; here the filter's own motion and sensor functions are
differentiable, so calibration is gradient descent through them:

  * fit_motion_params: dead-reckon an encoder log through
    models/motion.diff_drive_update under trial (wheel_size,
    wheel_space) and descend the pose error against ground truth.
  * fit_sensor_sigma: maximize the beam mixture's log-likelihood
    (monte_carlo.cpp:623-682's model, smooth in sigma) of scans at known
    poses.  Expected ranges depend only on the poses and the map, so the
    ray caster runs once, outside the loop.

Parameters live in log space and the optimiser is Adam with optax's
update (bias-corrected moments, eps added outside the square root), a few
tensor ops inside the epoch.  Episodes are a leading dim (the JAX
package's vmap).  On CUDA one epoch (the forward pass, its backward pass
and the Adam step) is captured in a CUDA graph (models/compiled.TickGraph,
kept in compiled.graphs) and replayed `steps` times, the counterpart of the JAX package's
jit(lax.scan(epoch)); on the CPU the same epochs run eagerly.  The
graph's `replays` and `cuda` say how many epochs ran, and which way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from ..config import MotionModelConfig, SensorModelConfig
from ..maps.grid import MazeMap
from . import compiled, motion, sensor

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _device(v, device):
    if device is not None:
        return torch.device(device)
    return v.device if isinstance(v, torch.Tensor) else torch.device("cuda")


def _f32(v, device):
    if not isinstance(v, torch.Tensor):
        v = np.array(v, np.float32)
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def integrate_odometry(encoders, start_pose, cfg: MotionModelConfig,
                       wheel_size=None, wheel_space=None, device=None):
    """Dead-reckon an encoder log [..., T, 2] -> poses [..., T, 3] from
    start_pose ([3] or [..., 3]).  wheel_size / wheel_space override cfg
    (tensors carry their gradient through).  `device` defaults to the
    encoders' if a tensor, else the card."""
    dev = _device(encoders, device)
    enc = _f32(encoders, dev)
    ws = cfg.wheel_size if wheel_size is None else wheel_size
    wsp = cfg.wheel_space if wheel_space is None else wheel_space
    # The trial parameters go through the same update the filter uses.
    trial = dataclasses.replace(cfg, wheel_size=ws, wheel_space=wsp)
    lead = enc.shape[:-2]
    sp = _f32(start_pose, dev).expand(lead + (3,))
    zero = torch.zeros(lead, dtype=torch.float32, device=dev)
    st = motion.OdometryState(x=sp[..., 0], y=sp[..., 1], theta=sp[..., 2],
                              encoder_left=zero, encoder_right=zero)
    poses = []
    for t in range(enc.shape[-2]):
        st, _, _, _ = motion.diff_drive_update(st, enc[..., t, 0],
                                               enc[..., t, 1], trial)
        poses.append(torch.stack([st.x, st.y, st.theta], dim=-1))
    return torch.stack(poses, dim=-2)


def _pose_loss(pred, truth):
    """xy MSE + angular (1 - cos) error of [..., T, 3] poses, both in
    comparable units; [...]."""
    dxy = torch.mean((pred[..., :2] - truth[..., :2]) ** 2, dim=(-2, -1))
    dth = torch.mean(1.0 - torch.cos(pred[..., 2] - truth[..., 2]), dim=-1)
    return dxy + 0.1 * dth


def _adam(carry: dict, grad, lr: float) -> dict:
    """One optax Adam update of carry's params `p` (optax 0.2's
    scale_by_adam, then -lr): the moments, their bias correction at the
    incremented count, eps outside the square root."""
    count = carry["count"] + 1
    mu = (1.0 - ADAM_B1) * grad + ADAM_B1 * carry["mu"]
    nu = (1.0 - ADAM_B2) * (grad * grad) + ADAM_B2 * carry["nu"]
    c = count.to(torch.float32)
    mu_hat = mu / (1.0 - torch.pow(ADAM_B1, c))
    nu_hat = nu / (1.0 - torch.pow(ADAM_B2, c))
    update = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS) * (-lr)
    return dict(p=carry["p"] + update, mu=mu, nu=nu, count=count)


def _adam_init(p) -> dict:
    return dict(p=p, mu=torch.zeros_like(p), nu=torch.zeros_like(p),
                count=torch.zeros((), dtype=torch.int32, device=p.device))


def _epoch(carry: dict, x: dict, consts: dict, loss_fn, lr: float):
    """One epoch: the loss at carry's params, its gradient, the Adam step;
    returns (carry, loss)."""
    p = carry["p"].detach().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(p, consts)
        (grad,) = torch.autograd.grad(loss, p)
    with torch.no_grad():
        new = _adam(dict(carry, p=p.detach()), grad, lr)
    return new, loss.detach()


def _run_epochs(carry: dict, consts: dict, steps: int, loss_fn, lr: float):
    """`steps` epochs from `carry`: one TickGraph of one epoch (from
    compiled.graphs: a fit of the same shapes and settings replays the
    same graph), replayed on CUDA, called eagerly on the CPU.  Returns
    (carry, last loss)."""
    dev = carry["p"].device
    xs = dict(epoch=torch.zeros(1, device=dev))
    graph = compiled.cached(None, _epoch, carry, xs, consts, 0,
                            loss_fn=loss_fn, lr=lr)
    loss = torch.full((), float("nan"), device=dev)
    for _ in range(steps):
        carry, ys = graph(carry, xs, consts)
        loss = ys[0]
    return compiled.detach_state(carry), loss.clone()


def fit_motion_params(
    encoders, true_poses, cfg: MotionModelConfig = MotionModelConfig(),
    init: Optional[Dict[str, float]] = None, steps: int = 400,
    lr: float = 3e-3, start_poses=None, device=None,
) -> Dict[str, torch.Tensor]:
    """Recover (wheel_size, wheel_space) from encoder + ground-truth logs:
    encoders [T, 2] (or [E, T, 2], an episode batch), true_poses [T, 3] /
    [E, T, 3]; `start_poses` ([3] / [E, 3]) anchors the integration and
    defaults to true_poses[0], which lags the real start by one tick.
    Returns {"wheel_size", "wheel_space", "loss"}, 0-d tensors."""
    dev = _device(encoders, device)
    enc = _f32(encoders, dev)
    truth = _f32(true_poses, dev)
    starts = None if start_poses is None else _f32(start_poses, dev)
    if enc.dim() == 2:
        enc, truth = enc[None], truth[None]
        if starts is not None:
            starts = starts[None]
    if starts is None:
        starts = truth[:, 0]
    init = init or {}
    p = torch.log(torch.tensor(
        [init.get("wheel_size", cfg.wheel_size),
         init.get("wheel_space", cfg.wheel_space)], dtype=torch.float32,
        device=dev))
    consts = dict(enc=enc, truth=truth,
                  starts=starts.expand(enc.shape[:1] + (3,)).contiguous())
    carry, loss = _run_epochs(_adam_init(p), consts, steps, _MotionLoss(cfg),
                              lr)
    ws, wsp = torch.exp(carry["p"]).unbind()
    return {"wheel_size": ws, "wheel_space": wsp, "loss": loss}


@dataclasses.dataclass(frozen=True)
class _MotionLoss:
    """The motion fit's loss with its config (hashable: a graph's static
    argument)."""

    cfg: MotionModelConfig

    def __call__(self, p, consts):
        pred = integrate_odometry(consts["enc"], consts["starts"], self.cfg,
                                  torch.exp(p[0]), torch.exp(p[1]))
        return _pose_loss(pred, consts["truth"]).mean()


@dataclasses.dataclass(frozen=True)
class _SigmaLoss:
    """The beam mixture's negative log-likelihood in log sigma."""

    cfg: SensorModelConfig

    def __call__(self, p, consts):
        cfg = self.cfg
        s = torch.exp(p[0])
        diff = consts["diff"]
        gauss = torch.where(
            consts["in_window"],
            torch.exp(-(diff * diff) / (2.0 * s * s))
            / (s * math.sqrt(2.0 * math.pi)), 0.0)
        lik = cfg.w_hit * gauss + cfg.w_rand * consts["p_rand"]
        return (-torch.sum(torch.log(lik + 1e-3) * consts["valid"])
                / consts["n_valid"])


def fit_sensor_sigma(
    m: MazeMap, poses, scan_ranges, scan_angles,
    cfg: SensorModelConfig = SensorModelConfig(),
    init_sigma: Optional[float] = None, steps: int = 300, lr: float = 5e-2,
) -> Dict[str, torch.Tensor]:
    """Max-likelihood sigma of the beam mixture from scans at known poses:
    poses [T, 3], scan_ranges [T, B], scan_angles [B], on the map's
    device.  The mixture is the filter's per-beam model (w_hit *
    TruncGauss_sigma + w_rand * rand, monte_carlo.cpp:663-672) with a flat
    floor so that outlier beams stay finite, over the beams strictly
    inside (0, max_range) (clipped beams pile zero diffs at the boundary
    and bias the fit low).  Returns {"sigma", "loss"}, 0-d tensors."""
    dev = m.device
    poses = _f32(poses, dev)
    observed = _f32(scan_ranges, dev)
    expected = sensor.expected_ranges(m, poses, _f32(scan_angles, dev), cfg)
    diff = torch.abs(observed - expected)
    valid = ((observed > 1e-6) & (observed < cfg.max_range - 1e-6)
             ).to(torch.float32)
    consts = dict(
        diff=diff, in_window=diff <= cfg.gauss_max_diff,
        p_rand=(torch.abs(observed - cfg.max_range) < cfg.rand_window
                ).to(torch.float32),
        valid=valid, n_valid=torch.clamp_min(torch.sum(valid), 1.0))
    sigma0 = cfg.sigma if init_sigma is None else init_sigma
    p = torch.log(torch.tensor([sigma0], dtype=torch.float32, device=dev))
    carry, loss = _run_epochs(_adam_init(p), consts, steps,
                              _SigmaLoss(cfg), lr)
    return {"sigma": torch.exp(carry["p"][0]), "loss": loss}
