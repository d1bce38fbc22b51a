"""The port's ground rules: it never imports JAX or the JAX package, a
kernel entry never falls back to the CPU, an entry point asks for the card
unless told otherwise, a build without nvcc (or a failed one) raises, and
chip_smoke.py refuses to run without a CUDA card."""
import os
import os.path as osp
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu_torch import maps, presets
from montecarlolocalisation_tpu_torch.config import SensorModelConfig
from montecarlolocalisation_tpu_torch.models import sensor
from montecarlolocalisation_tpu_torch.ops import build, expand, kmeans
from montecarlolocalisation_tpu_torch.ops import weights

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
PKG = "montecarlolocalisation_tpu_torch"

IMPORT_ALL = """
import importlib, pkgutil, sys
import montecarlolocalisation_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
jax = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax."))
print("jax modules:", jax)
ref = sorted(k for k in sys.modules if k == "montecarlolocalisation_tpu"
             or k.startswith("montecarlolocalisation_tpu."))
print("JAX package modules:", ref)
"""


def test_port_never_imports_jax():
    r = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "jax modules: []" in r.stdout, r.stdout
    assert "JAX package modules: []" in r.stdout, r.stdout


def _cpu_calls():
    tm = presets.make_world(device="cpu").maze
    parts = torch.rand(64, 3)
    scan = sensor.make_scan(np.zeros(4, np.float32), np.ones(4, np.float32))
    cdf = torch.arange(1, 65, dtype=torch.float32) / 64
    u0 = torch.tensor(0.5)
    xy = torch.rand(64, 2)
    bparts = torch.rand(2, 64, 3)
    bscan = sensor.make_scan(np.zeros(4, np.float32),
                             np.ones((2, 4), np.float32))
    cfg = SensorModelConfig()
    return {
        "beam_weights": lambda: weights.beam_weights_cuda(
            tm, parts, scan, cfg),
        "beam_weights_batched": lambda: weights.beam_weights_batched_cuda(
            tm, bparts, bscan, cfg),
        "beam_weights_stack": lambda: weights.beam_weights_stack_cuda(
            maps.stack_maps([tm, tm]), bparts, bscan, cfg),
        "beamsub": lambda: weights.beamsub_cuda(tm, bparts, bscan, cfg),
        "systematic_expand": lambda: expand.systematic_expand_cuda(
            parts, cdf, u0),
        "systematic_expand_batched":
            lambda: expand.systematic_expand_batched_cuda(
                bparts, cdf.expand(2, 64), u0.expand(2)),
        "kmeans": lambda: kmeans.kmeans_cuda(xy, xy[:3],
                                             xy[:60].reshape(20, 3, 2)),
        "kmeans_batched": lambda: kmeans.kmeans_batched_cuda(
            bparts[..., :2], bparts[:, :3, :2],
            bparts[:, :60, :2].reshape(2, 20, 3, 2)),
    }


ENTRIES = {"beam_weights": weights.beam_weights_cuda,
           "beam_weights_batched": weights.beam_weights_batched_cuda,
           "beam_weights_stack": weights.beam_weights_stack_cuda,
           "beamsub": weights.beamsub_cuda,
           "systematic_expand": expand.systematic_expand_cuda,
           "systematic_expand_batched": expand.systematic_expand_batched_cuda,
           "kmeans": kmeans.kmeans_cuda,
           "kmeans_batched": kmeans.kmeans_batched_cuda}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_kernel_entry_refuses_cpu_tensors(entry):
    fn = ENTRIES[entry]
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        _cpu_calls()[entry]()
    assert fn.launches == before


def test_entry_points_ask_for_the_card_by_default():
    # This box has no CUDA: a world on the default device cannot be made.
    with pytest.raises((RuntimeError, AssertionError)):
        presets.make_world()
    with pytest.raises((RuntimeError, AssertionError)):
        maps.from_map_file(presets.DEFAULT_MAP)
    with pytest.raises((RuntimeError, AssertionError)):
        maps.from_walls([[[0, 1, 2, 3]]])
    for args in (["sweep", "--batch", "2"], ["planning"], ["slam"],
                 ["calibrate"], ["slam", "--explore", "frontier"]):
        r = subprocess.run([sys.executable, "-m", PKG, *args, "--ticks",
                            "2", "--particles", "16"], cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0 and "CUDA" in r.stderr, args
    from montecarlolocalisation_tpu_torch.config import SLAMConfig
    from montecarlolocalisation_tpu_torch.io.server import SLAMServer

    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        SLAMServer(SLAMConfig(num_particles=8), np.zeros(4, np.float32))
    from montecarlolocalisation_tpu_torch.models import calibrate
    from montecarlolocalisation_tpu_torch.sim import frontier

    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        frontier.init_explore(0, (1.25, 1.25, 0.0),
                              SLAMConfig(num_particles=8))
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        calibrate.integrate_odometry(np.zeros((3, 2), np.float32),
                                     (0.0, 0.0, 0.0),
                                     presets.FilterConfig().motion)
    # run_calibrate and run_frontier_slam take their device from the
    # world's map: a world on the card cannot be made here (above).
    # The study tools ask for the card unless given --device cpu
    # (coverage_bound is host numpy and has no device).
    import importlib

    for name in ("convergence_study", "reloc_sweep", "slam_sweep",
                 "explore_sweep", "bench_fleet", "bench_slam",
                 "bench_mapping", "slam_scale", "bench_matrix"):
        tool = importlib.import_module(f"{PKG}.tools.{name}")
        with pytest.raises(RuntimeError, match="CUDA"):
            tool.main([])


def _isolate_build(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    _isolate_build(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library()
    assert build._lib is None


def test_failed_build_raises(monkeypatch, tmp_path):
    _isolate_build(monkeypatch, tmp_path)
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no card here' >&2\nexit 2\n")
    fake.chmod(0o755)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.library()
    assert build._lib is None
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".so")]


PTXAS_SAMPLE = """\
ptxas info    : 0 bytes gmem
ptxas info    : Function properties for _Z9first_setv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Compiling entry function '_Z2k1v' for 'sm_90a'
ptxas info    : Function properties for _Z2k1v
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z2k2v' for 'sm_90a'
ptxas info    : Function properties for _Z2k2v
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, 400 bytes cmem[0]
"""


def test_ptxas_report_without_nvcc_raises(monkeypatch, tmp_path):
    _isolate_build(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.ptxas_report()


def test_ptxas_report_reads_each_kernel_under_the_library_flags(
        monkeypatch, tmp_path):
    """Each source compiled alone with NVCC_FLAGS and -Xptxas -v; a
    kernel's registers, stack and spills read from what ptxas says (a
    device function's properties are not a kernel's); the library's name
    (its flags' and sources' hash) unchanged, and nothing built."""
    _isolate_build(monkeypatch, tmp_path)
    (tmp_path / "bin").mkdir()
    (tmp_path / "sample.txt").write_text(PTXAS_SAMPLE)
    fake = tmp_path / "bin" / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\nimport sys\n"
        f"open({str(tmp_path / 'args.txt')!r}, 'a').write("
        f"' '.join(sys.argv[1:]) + '\\n')\n"
        f"sys.stderr.write(open({str(tmp_path / 'sample.txt')!r}).read())\n")
    fake.chmod(0o755)
    name = build._library_path()
    report = build.ptxas_report()
    cu = sorted(f for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    assert sorted(report) == cu and "refine.cu" in cu
    want = {"_Z2k1v": dict(registers=40, stack=0, spill_stores=0,
                           spill_loads=0),
            "_Z2k2v": dict(registers=255, stack=16, spill_stores=12,
                           spill_loads=8)}
    assert all(r == want for r in report.values())
    args = (tmp_path / "args.txt").read_text().splitlines()
    assert len(args) == len(cu)
    assert all(a.startswith(" ".join(build.NVCC_FLAGS) + " -Xptxas -v -c")
               for a in args)
    assert build._library_path() == name and build._lib is None
    assert not (tmp_path / "build").exists()


def _smoke(cwd):
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    return r


def test_chip_smoke_fails_without_a_card():
    r = _smoke(ROOT)
    assert "CUDA" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(osp.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _smoke(tmp_path)
    assert "ModuleNotFoundError" in r.stderr
