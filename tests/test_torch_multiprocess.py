"""Data parallelism through the port's training CLI: two gloo ranks on the
CPU under ``torch.distributed.run`` (``torchrun``), the twin of
``tests/test_multiprocess.py``.

Each rank runs ``python -m rgbd_gan_tpu_torch.cli.train --device cpu`` in a
directory of its own, so that a relative ``out`` shows which rank wrote
what. A tiny DCGAN yml (in_ch 16, global batch 4, 32 px) with
``use_mpi: True``:

- 4 iterations: finite rows, ``batch_size`` the global batch; only rank 0's ``out`` exists, with
  ``log.jsonl`` and the snapshots, and the snapshot keeps every rank's
  stream.
- A resume from that run's iteration-2 snapshot: each rank takes back its
  own stream, so iterations 3 and 4 repeat the uninterrupted run's rows.
  Each rank's shard is as large as its batch, so the restarted input
  pipeline gives the same images (in another order: the rows are held to
  ``RESUME_RTOL``; a rank on another rank's stream is off by far more).
- World size 1 with ``use_mpi: True`` is the plain path, bit for bit.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from rgbd_gan_tpu_torch.core.config import Config
from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
from rgbd_gan_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESUME_RTOL = 1e-5  # measured on the CPU: 8.8e-8
CFG = dict(
    generator_architecture="dcgan", ch=16, batchsize=4, res_dis=True, sn=False, use_mpi=True,
    adam_alpha_g=0.001, adam_alpha_d=0.003, adam_beta1=0.0, adam_beta2=0.999, lambda_gp=1.0,
    lambda_depth=10, depth_min=0.6, lambda_geometric=1, keep_smoothed_gen=True, smoothing=0.999,
    stage_interval="0,0,0,0,0,0,0,1000", max_stage=7, start_rotation=0, start_occlusion_aware=0,
    x_rotate=0.3054, y_rotate=3.1415, z_rotate=0, x_translate=0, y_translate=0, z_translate=0,
    image_path="unused/*.png", out="out", iteration=4, snapshot_interval=2, display_interval=1,
    evaluation_sample_interval=1000, auto_resume=False,
)
LOSSES = ("gen/loss_adv", "gen/loss_rotate", "dis/loss_adv", "dis/loss_gp")


def _torchrun(work, values):
    """The CLI as two ranks under torchrun, rank r in ``work/r{r}``; returns
    rank 0's rows from its ``log.jsonl``."""
    yaml = pytest.importorskip("yaml")
    work.mkdir()
    for r in range(2):
        (work / f"r{r}").mkdir()
    (work / "tiny.yml").write_text(yaml.safe_dump(values))
    cli = f'cd r$LOCAL_RANK && exec "{sys.executable}" -m rgbd_gan_tpu_torch.cli.train --config_path ../tiny.yml --device cpu'
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2", "--no-python",
         "sh", "-c", cli], cwd=work, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return [json.loads(line) for line in (work / "r0" / "out" / "log.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("multiprocess")
    data = base / "data"
    data.mkdir()
    np.save(data / "images.npy", synthetic_dataset(4, 32, seed=3))  # a shard of 2 images a rank
    values = dict(CFG, dataset_path=str(data))
    rows = _torchrun(base / "straight", values)
    snapshot = base / "snapshot"
    snapshot.mkdir()
    for f in (base / "straight" / "r0" / "out").glob("*_2.npz"):
        shutil.copy(f, snapshot)
    resumed = _torchrun(base / "resumed", dict(values, auto_resume=True, auto_resume_dir=str(snapshot)))
    return base, rows, resumed


def test_two_ranks_train_and_only_rank_0_writes(runs):
    base, rows, _ = runs
    assert [r["iteration"] for r in rows] == [1, 2, 3, 4]
    assert all(np.isfinite(r[k]) for r in rows for k in LOSSES if k in r) and rows[-1]["batch_size"] == 4.0
    assert all(k in rows[-1] for k in LOSSES)  # the 3D loss from iteration 1 on
    out = base / "straight" / "r0" / "out"
    assert {"Generator_2.npz", "Discriminator_2.npz", "SmoothedGenerator_2.npz", "snapshot_iter_4.npz",
            "Generator_latest.npz", "log.jsonl"} <= set(os.listdir(out))
    assert os.listdir(base / "straight" / "r1") == []
    with np.load(out / "snapshot_iter_2.npz") as snap:
        streams = [snap[f"rank_rng_state/{r}"] for r in range(2)]
        assert np.array_equal(snap["rng_state"], streams[0]) and not np.array_equal(*streams)


def test_resume_gives_each_rank_its_own_stream(runs):
    _, rows, resumed = runs
    assert [r["iteration"] for r in resumed] == [3, 4]
    for want, got in zip(rows[2:], resumed):
        for k in LOSSES:
            np.testing.assert_allclose(got[k], want[k], rtol=RESUME_RTOL, atol=1e-6, err_msg=k)


def test_one_rank_with_use_mpi_is_the_plain_path(tmp_path):
    data = synthetic_dataset(4, 32, seed=3)
    rows = {}
    for use_mpi in (False, True):
        trainer = Trainer(Config(dict(CFG, use_mpi=use_mpi, out=str(tmp_path / str(use_mpi)))), dataset=data,
                          seed=0, device="cpu")
        assert not trainer.use_mesh and trainer.local_batch == 4 and trainer._spec_for(1, 6).axis_name is None
        trainer.save = lambda tag: None
        rows[use_mpi] = trainer.run(iterations=1)
    assert {k: v for k, v in rows[True].items() if k != "elapsed_time"} == \
        {k: v for k, v in rows[False].items() if k != "elapsed_time"}
