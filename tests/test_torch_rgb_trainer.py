"""The port's Trainer with ``rgb: True`` and ``nvprof: True`` on the CPU, and
its tools.

- ``rgb: True`` through ``cli/train.py``: 2 iterations of an RGB StyleGAN
  (ch 8, batch 4, 16 px), a snapshot, a resume to iteration 3, and
  ``cli/evaluate.py --preview`` giving an 8x8 grid of 3-channel images (no
  depth rows, no pose sweep).
- The snapshot files of an RGB StyleGAN and an RGB DCGAN Trainer hold the
  JAX RGB generator's and discriminator's flat keys, with their shapes, from
  the JAX modules' ``init_all`` alone.
- ``nvprof: True`` runs exactly 10 iterations, whatever ``iteration`` says,
  and writes a Chrome trace with events, and the port's spans, under
  ``[out]/profile/``.
- ``tools/validate_3d_structure.py`` on a tiny RGBD snapshot prints its
  JSON line; ``tools/fid_trend.py`` records what the evaluation CLI wrote
  for each tag.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_gan_tpu.models.discriminator import Discriminator as JaxDiscriminator
from rgbd_gan_tpu.models.generators import DCGANGenerator as JaxDCGANGenerator
from rgbd_gan_tpu.models.generators import StyleGANGenerator as JaxStyleGANGenerator
from rgbd_gan_tpu_torch.cli import evaluate
from rgbd_gan_tpu_torch.cli import train as cli
from rgbd_gan_tpu_torch.core.config import Config
from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
from rgbd_gan_tpu_torch.tools import fid_trend, validate_3d_structure
from rgbd_gan_tpu_torch.train import checkpoint as ckpt
from rgbd_gan_tpu_torch.train.trainer import PROFILED_ITERATIONS, Trainer

# the suite runs several worker processes at once: leave them the other cores
torch.set_num_threads(2)

CH, BATCH = 8, 4
CFG = dict(
    generator_architecture="stylegan", ch=CH, batchsize=BATCH, res_dis=True, sn=False, rgb=True,
    adam_alpha_g=0.001, adam_alpha_d=0.003, adam_beta1=0.0, adam_beta2=0.999, lambda_gp=1.0,
    keep_smoothed_gen=False, smoothing=0.999, stage_interval="0,0,0,0,0", max_stage=5, start_rotation=-1,
    x_rotate=0.3054, y_rotate=1.0472, z_rotate=0, x_translate=0, y_translate=0, z_translate=0,
    test_y_rotate=0.7854, iteration=2, display_interval=1, snapshot_interval=2, evaluation_sample_interval=10000,
)
METRICS = ["gen/loss_adv", "dis/loss_adv", "dis/loss_gp"]


def _yml(tmp_path, **extra):
    yaml = pytest.importorskip("yaml")
    data_dir = tmp_path / "data"
    data_dir.mkdir(exist_ok=True)
    np.save(data_dir / "images.npy", synthetic_dataset(8, 16))
    cfg = dict(CFG, dataset_path=str(data_dir), image_path="unused/*.png", out=str(tmp_path / "out"), **extra)
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_rgb_cli_trains_snapshots_resumes_and_previews(tmp_path):
    path = _yml(tmp_path, auto_resume=True)
    rows = []
    trainer = cli.run(cli.load_config(str(path)), on_row=rows.append, device="cpu")
    assert trainer.state.iteration == 2 and [r["iteration"] for r in rows] == [1, 2]
    for r in rows:
        assert all(np.isfinite(r[k]) for k in METRICS) and "gen/loss_rotate" not in r
    assert {"Generator_2.npz", "Discriminator_2.npz", "snapshot_iter_2.npz", "Generator_latest.npz"} <= set(
        os.listdir(tmp_path / "out"))

    resumed = cli.main(["--config_path", str(path), "--iterations", "3", "--device", "cpu"])
    assert resumed.state.iteration == 3
    assert len((tmp_path / "out" / "log.jsonl").read_text().splitlines()) == 3

    from PIL import Image

    results = evaluate.run(cli.load_config(str(path)), preview=True, device="cpu")
    grid = np.asarray(Image.open(results["preview"]))
    assert grid.shape == (8 * 64, 8 * 64, 3)  # 16 px upsampled to 64 in eval mode; RGB rows only


@pytest.mark.parametrize("architecture", ["stylegan", "dcgan"])
def test_rgb_snapshot_keys_match_the_jax_rgb_models(architecture, tmp_path):
    config = Config(dict(CFG, generator_architecture=architecture, ch=16, out=str(tmp_path)))
    trainer = Trainer(config, dataset=synthetic_dataset(BATCH, 16), device="cpu")
    trainer.save("0")
    key = jax.random.PRNGKey(0)
    if architecture == "stylegan":
        jgen, z = JaxStyleGANGenerator(16, rgbd=False), jnp.zeros((2, 32))
    else:
        jgen, z = JaxDCGANGenerator(in_ch=16, rgbd=False), jnp.zeros((2, 16))
    jdis = JaxDiscriminator(ch=16, res=True)
    gen_vars = jax.eval_shape(lambda: jgen.init(key, z, None, method=jgen.init_all))
    dis_vars = jax.eval_shape(lambda: jdis.init(key, jnp.ones((2, 4, 4, 3)), method=jdis.init_all))

    def flat_shapes(tree, prefix=""):
        return {prefix + "/".join(str(p.key) for p in path): leaf.shape
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}

    for name, want in (("Generator", flat_shapes(gen_vars["params"])), ("Discriminator", flat_shapes(dis_vars))):
        got = {k: v.shape for k, v in ckpt.load_tree(str(tmp_path / f"{name}_0.npz")).items()}
        assert got == want, (name, sorted(set(got) ^ set(want)))


def test_nvprof_runs_ten_iterations_and_writes_a_trace(tmp_path):
    config = cli.load_config(str(_yml(tmp_path, nvprof=True, iteration=3, snapshot_interval=10000,
                                      stage_interval="0,0,0", max_stage=3, lambda_gp=0.0)))
    trainer = cli.run(config, device="cpu")
    assert trainer.state.iteration == PROFILED_ITERATIONS == 10
    trace = tmp_path / "out" / "profile" / "trace.json"
    assert '"traceEvents"' in trace.read_text() and '"aten::convolution"' in trace.read_text()
    assert '"step.gen"' in trace.read_text() and '"train.step"' in trace.read_text()
    # the port's spans beside it: calls and host ms by span (no device ms, syncs or launches off the card)
    spans = json.loads((tmp_path / "out" / "profile" / "spans.json").read_text())
    assert spans["steps"] == 10 and "launches_per_step" not in spans
    for name in ("train.batch", "train.step", "train.nan_sync", "step.inputs", "step.gen", "step.gen.forward",
                 "step.gen.backward", "step.gen.adam", "step.dis", "step.dis.forward", "step.dis.backward",
                 "step.dis.adam", "step.finish"):
        assert spans["spans"][name]["calls"] == 10, name
        assert spans["spans"][name]["host_ms"] > 0 and "device_ms" not in spans["spans"][name]
    assert spans["spans"]["setup.first_step"]["calls"] == 1  # the first step call, inside the profiled run
    assert "step.dis.r1" not in spans["spans"]  # lambda_gp 0: no R1


def test_validate_3d_structure_prints_its_json_line(tmp_path, capsys):
    path = _yml(tmp_path, rgb=False)
    trainer = Trainer(cli.load_config(str(path)), device="cpu")
    trainer.save("latest")
    metrics = validate_3d_structure.main(["--config_path", str(path), "--device", "cpu", "--rows", "3",
                                          "--cols", "2", "--out", str(tmp_path / "strip.png")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_equal(line, metrics)  # an untrained head may give a NaN correlation, as the root tool does
    assert line["iteration"] == 0 and isinstance(line["pass"], bool)
    assert all(isinstance(line[k], float) for k in ("depth_relative_spread", "silhouette_depth_corr",
                                                    "fg_radial_depth_corr", "sweep_depth_change"))
    assert os.path.exists(tmp_path / "strip.png")


def test_fid_trend_records_each_tag(tmp_path, monkeypatch):
    """The tool's loop over tags, on what a stand-in for the evaluation CLI
    writes where the CLI writes it."""
    path = _yml(tmp_path)
    calls = []

    def fake_main(argv):
        calls.append(argv)
        tag = int(argv[argv.index("--snapshot") + 1])
        stats = tmp_path / "out" / "stats"
        stats.mkdir(parents=True, exist_ok=True)
        np.savetxt(stats / f"fid_{tag:0>8}.txt", np.array([100.0 / tag]))
        np.savetxt(stats / f"inception_score_{tag:0>8}.txt", np.array([1.0 + tag, 0.1]))

    monkeypatch.setattr(fid_trend.eval_cli, "main", fake_main)
    rows = fid_trend.main(["--config", str(path), "--tags", "2,4", "--n", "10", "--device", "cpu",
                           "--out", str(tmp_path / "trend.json")])
    assert [r["tag"] for r in rows] == [2, 4] and [r["fid"] for r in rows] == [50.0, 25.0]
    assert all("--device" in a and "cpu" in a and "--fid" in a for a in calls)
    assert json.loads((tmp_path / "trend.json").read_text())["rows"] == rows
