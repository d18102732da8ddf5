"""Shared pieces of the PyTorch port's MNIST example: the training
map_fun and the data loading helpers (the JAX example's
``mnist_common.py``, on the port).  The same map_fun runs on the local
multi-process backend and on a Spark-backed cluster.

Nothing here imports torch at module level: under ``--platform cuda``
the executors are spawn-started and fork their node process, which
must be the first to load torch and initialise CUDA.
"""
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..", "..")))

BUILDER = "tensorflowonspark_tpu_torch.models.cnn:MnistCNN"
SIGNATURES = {"serving_default": {
    "inputs": {"image": {"shape": [28, 28, 1], "dtype": "float32"}},
    "outputs": ["logits"]}}


def load_csv_partitions(data_dir, num_partitions):
    """Read csv/images.csv + labels.csv into `num_partitions` lists of
    (flat_image[784], label) records — the RDD-partitions stand-in."""
    import numpy as np

    images = np.loadtxt(os.path.join(data_dir, "csv", "images.csv"),
                        delimiter=",", dtype="float32")
    labels = np.loadtxt(os.path.join(data_dir, "csv", "labels.csv"),
                        dtype="int64")
    records = list(zip(images.tolist(), labels.tolist()))
    return [records[i::num_partitions] for i in range(num_partitions)]


def mnist_map_fun(args, ctx):
    """Train MnistCNN from the cluster data feed (InputMode.SPARK).

    Every process joins the ``torch.distributed`` world
    (``ctx.init_distributed``: gloo on the CPU, nccl when each process
    holds its own GPU) and steps a data-parallel mesh over it, each on
    its own fed rows: ``adam`` 1e-3 through ``parallel.train``.  The
    full train state (parameters, Adam moments, step) is checkpointed
    under ``--model_dir`` every 100 steps and at the end, and a run
    resumes from the latest one; the chief writes the losses to
    ``--log_dir`` (``DeferredScalars`` into a ``SummaryWriter``) and the
    export to ``--export_dir``.
    """
    import torch

    platform = getattr(args, "platform", "cpu")
    device = torch.device("cpu" if platform == "cpu" else "cuda")
    if device.type == "cpu":
        # a forked node: one intra-op thread (a fork of a process whose
        # thread pool ran hangs on its first parallel op)
        torch.set_num_threads(1)
    ctx.init_distributed()
    import numpy as np

    from tensorflowonspark_tpu_torch import export
    from tensorflowonspark_tpu_torch import feed as feed_mod
    from tensorflowonspark_tpu_torch.models import get_model
    from tensorflowonspark_tpu_torch.models.mlp import cross_entropy_loss
    from tensorflowonspark_tpu_torch.optim import make_optimizer
    from tensorflowonspark_tpu_torch.parallel import mesh as mesh_mod
    from tensorflowonspark_tpu_torch.parallel import train as train_mod
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt_mod
    from tensorflowonspark_tpu_torch.utils.summary import (DeferredScalars,
                                                           SummaryWriter)

    tag = f"[{ctx.job_name}:{ctx.task_index}]"
    batch_size = getattr(args, "batch_size", 64)
    model_dir = getattr(args, "model_dir", None)
    export_dir = getattr(args, "export_dir", None)

    torch.manual_seed(0)          # every rank starts from the same weights
    model = get_model("mnist_cnn", device=device)
    mesh = mesh_mod.build_mesh(device=device)    # every process on dp
    opt, _ = make_optimizer("adam", learning_rate=1e-3)
    state = train_mod.create_train_state(model, opt, mesh)
    resume_step = 0
    if model_dir:
        # the model_dir continuation the reference got from TF callbacks:
        # parameters, optimizer moments and the step
        restored, found = ckpt_mod.restore_checkpoint(model_dir, state)
        if restored is not None:
            state, resume_step = restored, found
            print(f"{tag} resumed from checkpoint step {resume_step}",
                  flush=True)

    def loss_fn(m, batch, rng):
        X, y = batch
        return cross_entropy_loss(m(X), y)

    step = train_mod.make_train_step(loss_fn, opt, mesh)
    # how long a worker waits for feed data before voting "dry" in the
    # stop-consensus
    probe = getattr(args, "feed_probe_secs", 30)
    df = ctx.get_data_feed(train_mode=True)
    steps = resume_step   # step numbering continues monotonically on resume
    sw = None
    if ctx.is_chief and getattr(args, "log_dir", None):
        sw = SummaryWriter(args.log_dir)   # TensorBoard scalar curves
    # device-side metric buffer: no per-step host readback
    scalars = DeferredScalars(sink=sw, every=64, prefix="train/")
    train_raised = False
    try:
        while True:
            # a bounded probe, not a blocking get: a worker stuck in
            # q.get() while its peers sit in the gradient all-reduce
            # would deadlock the cluster
            cols = (None if df.should_stop()
                    else df.next_numpy_batch(batch_size, timeout=probe))
            got = 0 if cols is None else len(cols[0])
            # every worker stops on the same step the first time any feed
            # runs dry, so the step's collectives never go ragged
            if not train_mod.feed_consensus(got > 0):
                if got or not df.should_stop():
                    df.terminate()   # drain the tail so feeders unblock
                break
            X, y = cols
            # repeat-pad the ragged final batch: every process steps the
            # same local shape
            if got < batch_size:
                X, y = feed_mod.pad_batch((X, y), batch_size)
            X = torch.from_numpy(np.asarray(X, "float32").reshape(
                -1, 28, 28, 1) / 255.0).to(device)
            y = torch.from_numpy(np.asarray(y, "int64")).to(device)
            state, metrics = step(state, (X, y), None)
            steps += 1
            scalars.append(metrics, steps)
            if model_dir and steps % 100 == 0:
                ckpt_mod.save_checkpoint(model_dir, state, steps,
                                         is_chief=ctx.is_chief)
    except BaseException:
        train_raised = True
        raise
    finally:
        # flush the metric tail even when a step raises, without masking
        # the original exception or skipping the writer's close
        try:
            scalars.flush()
        except Exception as e:
            if not train_raised:
                raise
            print(f"{tag} metric flush failed ({e}); keeping the original "
                  "exception", flush=True)
        finally:
            if sw is not None:
                sw.close()

    trained = scalars.count("loss")
    if trained:
        print(f"{tag} trained {trained} steps, mean loss "
              f"{scalars.mean('loss'):.4f}", flush=True)
    if model_dir:
        ckpt_mod.save_checkpoint(model_dir, state, max(steps, 1),
                                 is_chief=ctx.is_chief)
    if ctx.is_chief and export_dir:
        export.export_saved_model(export_dir, state.params.state_dict(),
                                  builder=BUILDER, signatures=SIGNATURES)


def add_common_args(parser):
    parser.add_argument("--cluster_size", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--data_dir", default="data/mnist")
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--export_dir", default=None)
    parser.add_argument("--log_dir", default=None,
                        help="chief writes TensorBoard scalar curves here "
                             "(utils.summary.SummaryWriter)")
    parser.add_argument("--feed_probe_secs", type=float, default=30,
                        help="worker feed-probe timeout before voting dry "
                             "in the stop-consensus")
    parser.add_argument("--platform", choices=["cpu", "cuda"],
                        default="cuda",
                        help="cuda: one GPU a process (spawn-started "
                             "executors, nccl); cpu: local multi-process "
                             "runs on gloo")
    return parser


def absolutize_args(args):
    from tensorflowonspark_tpu_torch import util

    return util.absolutize_args(args)


def pin_platform(platform):
    from tensorflowonspark_tpu_torch import util

    util.pin_platform(platform)
