"""Tiny CPU runs of ``rgbd_gan_tpu_torch.cli.train`` with
``generator_architecture: deepvoxels`` (both occlusion nets, snapshot and
resume), and the options of the DeepVoxels family that the port refuses:
each raises ``NotImplementedError`` by its name (``occlusion_unet``, which
the JAX package cannot build either, and an unknown architecture); the
options that were refused before their port (``use_mpi`` among them) now
build a Trainer.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from rgbd_gan_tpu_torch.cli import train as cli
from rgbd_gan_tpu_torch.core.config import Config
from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
from rgbd_gan_tpu_torch.train.steps import StepSpec
from rgbd_gan_tpu_torch.train.steps_deepvoxels import make_deepvoxels_train_step
from rgbd_gan_tpu_torch.train.trainer import Trainer

# the suite runs several worker processes at once: leave them the other cores
torch.set_num_threads(2)

BATCH = 2
CFG = dict(
    generator_architecture="deepvoxels", ch=8, batchsize=BATCH, res_dis=True, sn=False,
    adam_alpha_g=0.001, adam_alpha_d=0.003, adam_beta1=0.0, adam_beta2=0.999,
    lambda_gp=1.0, lambda_depth=10, depth_min=0.6, keep_smoothed_gen=False, smoothing=0.999,
    focal_loss_gamma=2.0, occlusion_type="accumulative", uniform_distribution=True,
    stage_interval="0,0,0,0,0,0,0,0", max_stage=11, start_rotation=-1, start_occlusion_aware=0,
    x_rotate=0.3054, y_rotate=3.1415, z_rotate=0, x_translate=0, y_translate=0, z_translate=0,
    iteration=1, display_interval=1, snapshot_interval=1,
)
METRICS = ["gen/loss_adv", "gen/loss_rotate", "dis/loss_gp", "dis/loss_adv"]


@pytest.fixture
def scratch(tmp_path):
    """A directory emptied when the test ends: a DeepVoxels snapshot holds the
    refiner's 25 M parameters several times over (about 300 MB a tag)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _tiny_yml(scratch, **overrides):
    yaml = pytest.importorskip("yaml")
    data_dir = scratch / "data"
    data_dir.mkdir()
    np.save(data_dir / "images.npy", synthetic_dataset(4, 64))
    cfg = dict(CFG, dataset_path=str(data_dir), image_path="unused/*.png", out=str(scratch / "out"), **overrides)
    path = scratch / "tiny.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_cli_runs_snapshots_and_resumes(scratch):
    path = _tiny_yml(scratch, auto_resume=True)
    rows = []
    trainer = cli.run(cli.load_config(path), on_row=rows.append, device="cpu")
    assert trainer.state.iteration == 1 and [r["iteration"] for r in rows] == [1]
    assert all(np.isfinite(rows[0][k]) for k in METRICS) and rows[0]["stage"] == 8.5
    files = set(os.listdir(scratch / "out"))
    assert {"Generator_1.npz", "Map_1.npz", "Discriminator_1.npz", "snapshot_iter_1.npz",
            "Generator_latest.npz", "Map_latest.npz", "log.jsonl"} <= files

    resumed = cli.main(["--config_path", path, "--iterations", "2", "--device", "cpu"])
    assert resumed.state.iteration == 2
    assert len((scratch / "out" / "log.jsonl").read_text().splitlines()) == 2


def test_cli_runs_the_softmax_occlusion_net(scratch):
    """One iteration with BatchNorm statistics; only the final snapshot is written."""
    path = _tiny_yml(scratch, occlusion_type="deepvoxels", snapshot_interval=100)
    trainer = cli.main(["--config_path", path, "--device", "cpu"])
    stats = {k: v for k, v in trainer.state.gen.state_dict().items() if k.endswith((".mean", ".var"))}
    assert trainer.state.iteration == 1 and len(stats) == 4
    assert all(float(v.abs().sum()) > 0 and not bool((v == 1).all()) for v in stats.values())  # both forwards moved them
    saved = np.load(scratch / "out" / "Generator_latest.npz")
    assert "batch_stats/occlusion_net/prep_bn/mean" in saved.files and "params/mapping/l0/kernel" in saved.files
    assert os.path.exists(scratch / "out" / "Map_latest.npz")


@pytest.mark.parametrize("option,error", [
    (dict(occlusion_type="occlusion_unet"), NotImplementedError),
    (dict(generator_architecture="nonesuch"), NotImplementedError),
    (dict(r1_interval=16), ValueError), (dict(occlusion_type="nonesuch"), ValueError),
])
def test_options_that_wait_raise_by_name(option, error):
    with pytest.raises(error) as info:
        Trainer(Config(dict(CFG, **option)), dataset=synthetic_dataset(4, 64), device="cpu")
    if error is NotImplementedError:
        key = next(iter(option))
        assert (option[key] if key in ("occlusion_type", "generator_architecture") else key) in str(info.value)


@pytest.mark.parametrize("option", [
    dict(step_window=10), dict(generator_architecture="dcgan"), dict(background_generator=True),
    dict(rendernet_projection=True), dict(sn=True), dict(use_mpi=True),
])
def test_options_that_were_refused_build(scratch, option):
    """Options that raised before their port (DCGAN and ``step_window``; the
    background generator, RenderNet and SN; ``use_mpi``, which with one rank
    is the plain path): the Trainer builds with the
    modules they add, and a DeepVoxels ``step_window`` run takes plain steps
    (one report row and one NaN check per iteration). One step of each new
    option is held to the JAX package in its own test file."""
    trainer = Trainer(Config(dict(CFG, out=str(scratch / "out"), **option)), dataset=synthetic_dataset(4, 64),
                      device="cpu")
    gen, dis = trainer.state.gen, trainer.state.dis
    if "generator_architecture" in option:
        assert trainer.arch == "dcgan" and trainer.state.opt_map is None
        return
    if "background_generator" in option:
        assert gen.background_generator and "background_gen.l1.weight" in dict(gen.named_parameters())
        return
    if "rendernet_projection" in option:
        assert gen.occlusion_type == "rendernet" and "occlusion_net.bn1.var" in gen.state_dict()
        return
    if "sn" in option:
        assert "block0.l2.u" in dis.state_dict() and trainer._spec_for(1, 8).sn
        return
    if "use_mpi" in option:
        assert not trainer.use_mesh and trainer._spec_for(1, 8).axis_name is None
        return
    rows = []
    trainer.save = lambda tag: None  # the snapshot is held by the test above
    trainer.run(log_cb=rows.append)
    assert trainer.state.iteration == 1 and [r["iteration"] for r in rows] == [1]
    assert all(np.isfinite(rows[0][k]) for k in METRICS)


def test_step_refuses_unported_options():
    """The background generator, SN and data parallelism (``axis_name``),
    refused before their port, build a step; lazy R1 is refused, as in the
    JAX package."""
    spec = StepSpec(stage_floor=8, batch_size=BATCH)
    assert callable(make_deepvoxels_train_step(None, None, spec, background_generator=True))
    assert callable(make_deepvoxels_train_step(None, None, StepSpec(stage_floor=8, batch_size=BATCH, sn=True)))
    assert callable(make_deepvoxels_train_step(None, None, StepSpec(stage_floor=8, batch_size=BATCH, axis_name="data")))
    with pytest.raises(ValueError, match="r1_interval"):
        make_deepvoxels_train_step(None, None, StepSpec(stage_floor=8, batch_size=BATCH, r1_interval=4))
