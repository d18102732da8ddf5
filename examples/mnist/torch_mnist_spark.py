"""MNIST training on the PyTorch port, cluster-fed (InputMode.SPARK): the
JAX example's ``mnist_spark.py`` with ``--platform cpu|cuda``.

Partitioned data is pumped into the training processes through the
port's feed, no intermediate files.  Local run on one GPU:

    python examples/mnist/torch_mnist_data_setup.py --output data/mnist
    python examples/mnist/torch_mnist_spark.py --cluster_size 1 \\
        --model_dir /tmp/mnist_model --export_dir /tmp/mnist_export

``--platform cuda`` (the default) gives each executor one GPU
(``num_chips=1``; nccl cannot put two ranks on one device, so
``--cluster_size`` is at most the number of GPUs) and spawn-starts the
executors; ``--platform cpu`` runs the processes on gloo.  On a Spark
cluster, build the partitions as ``df.rdd`` and pass a SparkContext
instead of the local backend — the map_fun is unchanged.
"""
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..", "..")))

import argparse

from torch_mnist_common import (absolutize_args, add_common_args,
                                load_csv_partitions, mnist_map_fun,
                                pin_platform)

from tensorflowonspark_tpu_torch import backend, cluster, pipeline


def main(argv=None):
    args = absolutize_args(
        add_common_args(argparse.ArgumentParser()).parse_args(argv))
    pin_platform(args.platform)
    cuda = args.platform == "cuda"

    parts = load_csv_partitions(args.data_dir,
                                num_partitions=2 * args.cluster_size)
    bk = backend.LocalBackend(args.cluster_size,
                              start_method="spawn" if cuda else "fork")
    c = cluster.run(bk, mnist_map_fun, pipeline.Namespace(vars(args)),
                    num_executors=args.cluster_size,
                    input_mode=cluster.InputMode.SPARK,
                    num_chips=1 if cuda else 0)
    try:
        c.train(parts, num_epochs=args.epochs)
        c.shutdown(grace_secs=2)
    except BaseException:
        c.abort()
        raise
    print("training complete;",
          f"export_dir={args.export_dir}" if args.export_dir else "no export")


if __name__ == "__main__":
    main()
