"""The port's evaluation CLI and the trainer's previews, on the CPU: a tiny
StyleGAN run (ch 8, 32 px, two iterations) writes the preview grids of the
live and the smoothed generator, then ``cli/evaluate.py --device cpu
--preview --fid --inception --ema`` renders the smoothed generator's grid
and scores 10 images with a randomly initialised Inception-v3 (10 images:
one per split of the Inception Score). The matrix square root of the FID
(scipy's ``sqrtm`` of a 2048 x 2048 product, about 16 s on two cores) is
left out here: the CLI's FID gets the real and the generated statistics
and returns their mean term, and ``test_torch_eval.py`` holds ``fid_score``
to the JAX package's.
"""

import os

import numpy as np
import pytest
import torch

from rgbd_gan_tpu_torch.cli import evaluate
from rgbd_gan_tpu_torch.cli import train as cli
from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
from rgbd_gan_tpu_torch.eval import fid

# the suite runs several worker processes at once: leave them the other cores
torch.set_num_threads(2)


def test_trainer_previews_and_cli_evaluate(tmp_path, monkeypatch):
    yaml = pytest.importorskip("yaml")
    statistics = []

    def mean_term(m0, c0, m1, c1):
        statistics.append((m0.shape, c0.shape, m1.shape, c1.shape))
        return float(np.sum((m0 - m1) ** 2))

    monkeypatch.setattr(fid, "fid_score", mean_term)
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    np.save(data_dir / "images.npy", synthetic_dataset(8, 16))
    cfg = dict(
        generator_architecture="stylegan", ch=8, batchsize=4, res_dis=True, adam_alpha_g=0.001,
        adam_alpha_d=0.003, adam_beta1=0.0, adam_beta2=0.999, lambda_gp=1.0, keep_smoothed_gen=True,
        stage_interval="0,0,0,0,0", max_stage=5, start_rotation=-1, x_rotate=0.3054, y_rotate=1.0472,
        z_rotate=0, x_translate=0, y_translate=0, z_translate=0, test_y_rotate=1.0, iteration=2,
        display_interval=1, snapshot_interval=100, evaluation_sample_interval=2,
        dataset_path=str(data_dir), image_path="unused/*.png", out=str(tmp_path / "out"),
    )
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(cfg))
    cli.run(cli.load_config(str(path)), device="cpu")
    out = tmp_path / "out"
    for subdir in ("preview", "preview_smoothed"):
        assert {"image_latest.png", "image00000000.png"} <= set(os.listdir(out / subdir))

    os.remove(out / "preview" / "image_latest.png")
    results = evaluate.main(["--config_path", str(path), "--device", "cpu", "--preview", "--fid", "--inception",
                             "--ema", "--n_images", "10", "--batchsize", "10"])
    assert results["preview"] == str(out / "preview" / "image_latest.png") and os.path.exists(results["preview"])
    assert statistics == [((2048,), (2048, 2048)) * 2]
    assert np.isfinite(results["fid"]) and results["fid"] > 0 and results["inception_score"][0] >= 1.0 - 1e-6
    assert {"real_stats.npz", "stats"} <= set(os.listdir(out))
    assert {"fid_00000002.txt", "inception_score_00000002.txt"} == set(os.listdir(out / "stats"))


def test_cli_without_device_cpu_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(SystemExit) as info:
        evaluate.main(["--config_path", "configs/dcgan_shapenet_car.yml", "--preview"])
    assert info.value.code not in (0, None) and "--device cpu" in str(info.value.code)
