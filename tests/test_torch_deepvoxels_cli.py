"""Tiny CPU runs of ``rgbd_gan_tpu_torch.cli.train`` with
``generator_architecture: deepvoxels`` (both occlusion nets, snapshot and
resume), and the options of the DeepVoxels family that are not ported yet:
each raises ``NotImplementedError`` by its name.
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
    (dict(background_generator=True), NotImplementedError), (dict(rendernet_projection=True), NotImplementedError),
    (dict(occlusion_type="occlusion_unet"), NotImplementedError), (dict(mixed16=True), NotImplementedError),
    (dict(use_mpi=True), NotImplementedError), (dict(sn=True), NotImplementedError),
    (dict(generator_architecture="dcgan"), NotImplementedError), (dict(r1_interval=16), ValueError),
    (dict(occlusion_type="nonesuch"), ValueError),
])
def test_options_that_wait_raise_by_name(option, error):
    with pytest.raises(error) as info:
        Trainer(Config(dict(CFG, **option)), dataset=synthetic_dataset(4, 64), device="cpu")
    if error is NotImplementedError:
        key = next(iter(option))
        assert (option[key] if key in ("occlusion_type", "generator_architecture") else key) in str(info.value)


def test_step_refuses_unported_options():
    spec = StepSpec(stage_floor=8, batch_size=BATCH)
    with pytest.raises(NotImplementedError, match="background_generator"):
        make_deepvoxels_train_step(None, None, spec, background_generator=True)
    with pytest.raises(NotImplementedError, match="sn"):
        make_deepvoxels_train_step(None, None, StepSpec(stage_floor=8, batch_size=BATCH, sn=True))
    with pytest.raises(ValueError, match="r1_interval"):
        make_deepvoxels_train_step(None, None, StepSpec(stage_floor=8, batch_size=BATCH, r1_interval=4))
