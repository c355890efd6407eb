"""Convert the OpenAI Inception weights for literature-comparable FID and IS,
without TensorFlow and without the JAX package.

    python -m rgbd_gan_tpu_torch.tools.convert_inception inception-2015-12-05.tgz [--out inception.npz] [--device cuda|cpu]
    python -m rgbd_gan_tpu_torch.tools.convert_inception classify_image_graph_def.pb

The twin of the root ``tools/convert_inception.py`` (itself a TF-free twin
of the reference's download-and-convert step,
``source/inception/download.py:35-246``). Nothing is downloaded: it takes
the tarball the reference downloads, or the GraphDef extracted from it,
and writes the flat-key npz that ``rgbd_gan_tpu_torch.cli.evaluate
--inception_weights`` loads. Then it loads that npz into the port's
Inception-v3 (on the card unless ``--device cpu``) and runs a forward on a
seeded pseudo-image, printing the feature and softmax statistics: a healthy
conversion gives features of O(0.1-1) and a softmax far from uniform (max
probability well above 1/1008); random weights fail both visibly.
"""

from __future__ import annotations

import argparse
import os
import tarfile
import tempfile

import numpy as np
import torch

from ..eval import inception

PB_NAME = "classify_image_graph_def.pb"


def extract_pb(path: str, workdir: str) -> str:
    """A path to the GraphDef: a ``.pb`` passes through, a tarball is
    extracted into ``workdir``."""
    if path.endswith((".tgz", ".tar.gz", ".tar")):
        with tarfile.open(path) as tar:
            member = next((m for m in tar.getmembers() if m.name.endswith(PB_NAME)), None)
            if member is None:
                raise FileNotFoundError(f"{PB_NAME} not found inside {path}")
            tar.extract(member, workdir, filter="data")
            return os.path.join(workdir, member.name)
    return path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("artifact", help=f"inception-2015-12-05.tgz or {PB_NAME}")
    ap.add_argument("--out", default="inception.npz", help="output npz path")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the check forward runs: the card (default) or, when asked, the CPU")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("convert_inception: no CUDA device; pass --device cpu to check on the CPU")

    with tempfile.TemporaryDirectory() as workdir:
        pb = extract_pb(args.artifact, workdir)
        print(f"converting {pb} -> {args.out}")
        flat = inception.convert_tf_checkpoint(pb, args.out)
    print(f"wrote {len(flat)} tensors ({sum(v.size for v in flat.values()):,} params)")

    model = inception.load_params(args.out, device=args.device)
    x = np.random.RandomState(0).uniform(0, 255, size=(2, inception.INPUT_SIZE, inception.INPUT_SIZE, 3))
    with torch.no_grad():
        x = torch.as_tensor(x, dtype=torch.float32, device=args.device)
        feat = model(x, get_feature=True).cpu().numpy()
        probs = model(x).cpu().numpy()
    print(f"feature: shape {feat.shape}, mean|f| {np.abs(feat).mean():.4f}, max|f| {np.abs(feat).max():.4f}")
    print(f"softmax: max prob {probs.max():.4f} (uniform would be {1.0 / inception.NUM_LOGITS:.5f}), "
          f"top-3 classes {np.argsort(probs[0])[-3:][::-1]}")
    if not np.all(np.isfinite(feat)):
        raise SystemExit("non-finite features: the conversion is broken")
    print(f"OK: use it via  python -m rgbd_gan_tpu_torch.cli.evaluate --fid --inception_weights {args.out} ...")
    return flat


if __name__ == "__main__":
    main()
