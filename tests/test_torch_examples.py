"""The PyTorch port's MNIST example, run end to end as real subprocesses
on the CPU (as ``tests/test_examples.py`` runs the JAX package's).

- ``torch_mnist_data_setup.py`` writes the JAX example's arrays: its
  ``synthetic_mnist`` equals the JAX example's for the same seed, and the
  csv files and TFRecord shards of both scripts hold the same values;
- ``torch_mnist_spark.py --cluster_size 2 --platform cpu`` (two gloo
  ranks, data-parallel) trains from the fed partitions: a ``step_N``
  checkpoint of the full train state, the chief's export and its event
  file (``train/loss`` at every step, read by the port's
  ``read_scalars``); the export's logits equal, bit for bit, those of
  the checkpointed train state's model on the CPU;
- a second run over the same ``--model_dir`` resumes from that step,
  says so, and goes on numbering from it.
"""
import glob
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EX = os.path.join(REPO, "examples", "mnist")
ARGS = ("--cluster_size", "2", "--platform", "cpu", "--batch_size", "16",
        "--model_dir", "model", "--export_dir", "export", "--log_dir", "tb")


def _run(script, *args, cwd, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, os.path.join(EX, script), *args],
        cwd=str(cwd), env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (
        f"{script} failed\nstdout:\n{proc.stdout[-3000:]}\n"
        f"stderr:\n{proc.stderr[-3000:]}")
    return proc.stdout


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EX, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mnist")
    _run("torch_mnist_data_setup.py", "--output", "data/mnist",
         "--num_examples", "120", "--num_partitions", "4", cwd=d)
    first = _run("torch_mnist_spark.py", *ARGS, cwd=d)
    return d, first


def test_data_setup_writes_the_jax_examples_data(trained, tmp_path):
    d, _ = trained
    port, ref = (_module("torch_mnist_data_setup"),
                 _module("mnist_data_setup"))
    for a, b in zip(port.synthetic_mnist(50, seed=3),
                    ref.synthetic_mnist(50, seed=3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ref.main(["--output", str(tmp_path / "jax"), "--num_examples", "120",
              "--num_partitions", "4"])
    for name in ("images.csv", "labels.csv"):
        with open(d / "data/mnist/csv" / name) as f, \
                open(tmp_path / "jax/csv" / name) as g:
            assert f.read() == g.read(), name
    from tensorflowonspark_tpu import tfrecord as jax_tfrecord
    from tensorflowonspark_tpu_torch import tfrecord
    got = sorted(glob.glob(str(d / "data/mnist/tfrecords/*.tfrecord")))
    want = sorted(glob.glob(str(tmp_path / "jax/tfrecords/*.tfrecord")))
    assert len(got) == len(want) == 4
    for p, j in zip(got, want):
        assert list(tfrecord.read_records(p)) == \
            list(jax_tfrecord.read_records(j))


def _cnn_state():
    from tensorflowonspark_tpu_torch.models import get_model
    from tensorflowonspark_tpu_torch.optim import make_optimizer
    from tensorflowonspark_tpu_torch.parallel import train as train_mod

    opt, _ = make_optimizer("adam", learning_rate=1e-3)
    return train_mod.create_train_state(
        get_model("mnist_cnn", device="cpu"), opt)


def test_trains_checkpoints_exports_and_logs(trained):
    from tensorflowonspark_tpu_torch import export
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt
    from tensorflowonspark_tpu_torch.utils import summary

    d, out = trained
    assert "training complete" in out
    # 120 rows over 2 ranks, 16 a step: 4 steps (the last one padded)
    assert sorted(os.listdir(d / "model")) == ["step_4"]
    events = glob.glob(str(d / "tb" / "events.out.tfevents.*"))
    assert len(events) == 1
    losses = [(s, v) for s, tag, v in summary.read_scalars(events[0])
              if tag == "train/loss"]
    assert [s for s, _ in losses] == [1, 2, 3, 4]
    assert all(np.isfinite(v) for _, v in losses)

    predict, signature = export.load_saved_model(str(d / "export"),
                                                 device="cpu")
    assert list(signature["inputs"]) == ["image"]
    images = np.loadtxt(d / "data/mnist/csv/images.csv", delimiter=",",
                        dtype="float32")[:32].reshape(-1, 28, 28, 1) / 255.0
    logits = predict(images.astype("float32"))
    assert logits.shape == (32, 10)
    state, step = ckpt.restore_checkpoint(d / "model", _cnn_state())
    assert step == 4 and int(state.step) == 4
    with torch.no_grad():
        want = state.params.eval()(torch.from_numpy(
            images.astype("float32")))
    assert torch.equal(torch.from_numpy(logits), want)


def test_second_run_resumes_from_the_checkpoint(trained):
    from tensorflowonspark_tpu_torch.utils import summary

    d, _ = trained
    out = _run("torch_mnist_spark.py", *ARGS, cwd=d)
    assert "[chief:0] resumed from checkpoint step 4" in out
    assert "[worker:0] resumed from checkpoint step 4" in out
    assert sorted(os.listdir(d / "model")) == ["step_4", "step_8"]
    events = sorted(glob.glob(str(d / "tb" / "events.out.tfevents.*")),
                    key=os.path.getmtime)
    steps = [s for s, tag, _ in summary.read_scalars(events[-1])
             if tag == "train/loss"]
    assert steps == [5, 6, 7, 8]
