"""The port's viz notebooks (``container-gpu-viz/notebooks/``) and the
``predict_image`` they call, on the CPU.

- ``predict_image`` of the port against the reference's
  (``eksml_tpu.predict.predict_image``) on one seeded Flax init carried
  across with ``convert.from_flax`` and one seeded image at
  ``SMOKE_OVERRIDES`` widths.  Tolerances, those of
  ``tests/test_torch_model.py::test_predict_matches_flax``: the same
  classes and detection count, scores to 1e-5, boxes to 1e-3 px in the
  resized image (1e-3 / scale in the original), and the pasted masks
  equal.
- Each notebook run cell by cell as a script
  (``eksml_tpu_torch.tools.run_notebook``) in a fresh process with
  ``EKSML_NB_DEVICE=cpu``, on a ``FS_ROOT`` that holds a SMOKE checkpoint
  written by the port's ``CheckpointManager`` and the mini-COCO fixture:
  neither ``jax`` nor ``eksml_tpu`` is in ``sys.modules`` at its end,
  and the detections it prints are those of ``OfflinePredictor`` +
  ``predict_image`` called here on the same checkpoint and image (boxes
  of the optimized flow to their printed precision: it rounds float64
  where ``DetectionResult`` holds float32).
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

jax.config.update("jax_platforms", "cpu")

import conftest  # noqa: E402
from eksml_tpu import config as j_config  # noqa: E402
from eksml_tpu.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402

NOTEBOOKS = os.path.join(REPO, "container-gpu-viz", "notebooks")
FLOWS = {"tensorpack-flow": "mask-rcnn-eksml-gpu-viz.ipynb",
         "optimized-flow": "mask-rcnn-eksml-gpu-optimized-viz.ipynb"}
#: the notebooks' EKSML_NB_CONFIG: SMOKE widths, mini-COCO's BG + person
#: + dog, a 128 px test size
NB_CONFIG = list(SMOKE_OVERRIDES) + [
    "DATA.NUM_CLASSES=3", "PREPROC.TEST_SHORT_EDGE_SIZE=128",
    "RPN.TEST_PRE_NMS_TOPK=64", "RPN.TEST_POST_NMS_TOPK=32"]
LINE = re.compile(r"^\s+(\S.*?)\s+(\d+\.\d{3})\s+\[(.*)\]$")


def nb_cfg(flow: str, basedir: str):
    """What the notebook's config cell builds, on a clone of the port's
    global config."""
    cfg = t_config.config.clone()
    cfg.freeze(False)
    cfg.MODE_MASK = True
    cfg.MODE_FPN = True
    if flow == "optimized-flow":
        cfg.TRAIN.PRECISION = "bfloat16"
    cfg.DATA.BASEDIR = basedir
    cfg.update_args(NB_CONFIG)
    return t_config.finalize_configs(False, cfg)


@pytest.fixture(scope="module")
def fs_root(tmp_path_factory):
    """``FS_ROOT``: ``run1/train_log/maskrcnn`` with a seeded SMOKE
    model's checkpoint at step 1 (the port's ``CheckpointManager``), and
    ``data`` the mini-COCO fixture."""
    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.utils import CheckpointManager

    root = tmp_path_factory.mktemp("fs")
    data = conftest.mini_coco.__wrapped__(root)
    logdir = root / "run1" / "train_log" / "maskrcnn"
    cfg = nb_cfg("tensorpack-flow", data)
    ckpt = CheckpointManager(str(logdir))
    ckpt.save(1, {"step": 1, "model": init_params(
        cfg, torch.Generator().manual_seed(0))})
    ckpt.wait()
    return str(root)


def printed(text: str):
    """(image name, count, [(class name, score text, box text)])."""
    image = re.search(r"^image: (\S+)$", text, re.M).group(1)
    count = int(re.search(r"^(\d+) detections$", text, re.M).group(1))
    rows = [(m.group(1), m.group(2), m.group(3))
            for m in map(LINE.match, text.splitlines()) if m]
    return image, count, rows


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_notebook_runs_on_the_cpu(flow, fs_root):
    from eksml_tpu_torch.data.coco import CocoDataset, load_image
    from eksml_tpu_torch.predict import OfflinePredictor, predict_image

    path = os.path.join(NOTEBOOKS, FLOWS[flow])
    env = dict(os.environ, FS_ROOT=fs_root, EKSML_NB_DEVICE="cpu",
               EKSML_NB_CONFIG=" ".join(NB_CONFIG), PYTHONPATH=REPO)
    env.pop("DATA_DIR", None)
    code = ("import sys\n"
            "from eksml_tpu_torch.tools.run_notebook import run\n"
            f"run({path!r})\n"
            "print('LOADED', sorted(m for m in sys.modules if m.split('.')[0]"
            " in ('jax', 'jaxlib', 'flax', 'eksml_tpu')))\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    text = proc.stdout
    assert "LOADED []" in text, text[-2000:]
    assert "using run:" in text and "latest step: 1" in text
    assert "<PIL.Image.Image image mode=RGB" in text    # the overlay
    if flow == "optimized-flow":
        assert "output/boxes" in text and "output/masks" in text
        assert "resize scale:" in text

    image, count, rows = printed(text)
    data = os.path.join(fs_root, "data")
    cfg = nb_cfg(flow, data)
    ds = CocoDataset(data, cfg.DATA.VAL)
    predictor = OfflinePredictor(
        cfg, checkpoint_dir=os.path.join(fs_root, "run1", "train_log",
                                         "maskrcnn"), device="cpu")
    want = predict_image(load_image(os.path.join(ds.image_dir, image)),
                         predictor)
    assert count == len(want) > 0
    assert len(rows) == min(10, len(want))
    for (name, score, box), r in zip(rows, want):
        assert name == ds.class_names[r.class_id]
        assert score == f"{r.score:.3f}"
        if flow == "tensorpack-flow":      # the same print of the same values
            assert f"[{box}]" == f"{r.box.round(1)}"
        else:
            np.testing.assert_allclose(np.asarray(box.split(), np.float64),
                                       r.box, rtol=0, atol=0.05 + 1e-4)


def test_predict_image_matches_the_reference(fresh_config):
    import jax.numpy as jnp

    from eksml_tpu.models import MaskRCNN as FlaxMaskRCNN
    from eksml_tpu.predict import OfflinePredictor as JOfflinePredictor
    from eksml_tpu.predict import predict_image as j_predict_image
    from eksml_tpu_torch.convert import from_flax
    from eksml_tpu_torch.predict import OfflinePredictor, predict_image

    items = list(SMOKE_OVERRIDES) + [
        "PREPROC.TEST_SHORT_EDGE_SIZE=128", "RPN.TEST_PRE_NMS_TOPK=64",
        "RPN.TEST_POST_NMS_TOPK=32"]
    # the reference finalizes its global config (restored by the fixture)
    fresh_config.update_args(items)
    j_cfg = j_config.finalize_configs(is_training=False)
    t_cfg = t_config.config.clone()
    t_cfg.freeze(False)
    t_cfg.update_args(items)
    t_cfg = t_config.finalize_configs(False, t_cfg)
    flax_model = FlaxMaskRCNN.from_config(j_cfg)
    canvas = np.zeros((1, 128, 128, 3), np.uint8)
    params = jax.device_get(jax.jit(lambda r: flax_model.init(
        r, jnp.asarray(canvas), jnp.asarray([[128.0, 128.0]]),
        method=FlaxMaskRCNN.predict))(jax.random.PRNGKey(0))["params"])
    img = np.random.RandomState(0).randint(0, 255, (96, 120, 3)).astype(
        np.uint8)

    want = j_predict_image(img, JOfflinePredictor(j_cfg, params=params))
    predictor = OfflinePredictor(t_cfg, params=from_flax(params),
                                 device="cpu")
    got = predict_image(img, predictor)
    _, scale = predictor.raw(img)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.class_id == w.class_id
        assert abs(g.score - w.score) <= 1e-5
        np.testing.assert_allclose(g.box, w.box, rtol=0, atol=1e-3 / scale)
        np.testing.assert_array_equal(g.mask, w.mask)


def test_the_viz_image_serves_these_notebooks():
    """``container-gpu-viz/Dockerfile`` layers Jupyter Lab (pinned at the
    version these tests run with) and these notebooks on the port's
    image, with the TLS pair the jupyter subchart's command names; the
    build script builds it as ``IMAGE_KIND=viz``."""
    from importlib.metadata import version

    with open(os.path.join(REPO, "container-gpu-viz", "Dockerfile")) as f:
        df = f.read()
    assert re.search(r"^ARG BASE_IMAGE=\S+$", df, re.M)
    assert re.search(r"^FROM \$\{BASE_IMAGE\}$", df, re.M)
    assert "COPY container-gpu-viz/notebooks /notebooks" in df
    assert re.search(r"jupyterlab==(\S+)", df).group(1) == version(
        "jupyterlab")
    assert "matplotlib" not in re.sub(r"#.*", "", df)
    assert "-keyout /labs-key.pem -out /labs-cert.pem" in df
    with open(os.path.join(REPO, "container-gpu", "build_tools",
                           "build_and_push.sh")) as f:
        script = f.read()
    assert re.search(r"^\s*viz\)$", script, re.M)
    assert '$REPO_ROOT/container-gpu-viz/Dockerfile' in script
    assert "unknown IMAGE_KIND" in script
