"""Prepare an MNIST-like dataset as CSV and TFRecords, for the PyTorch
port's MNIST example (the JAX example's ``mnist_data_setup.py``, on the
port's ``tfrecord``).

This environment has no network egress, so by default we synthesize a
*learnable* MNIST stand-in: one fixed random template per class plus
pixel noise (the same arrays as the JAX example for the same seed).
Point --real_npz at an .npz with arrays (x_train, y_train) to convert
real MNIST instead.

    python examples/mnist/torch_mnist_data_setup.py --output data/mnist

Outputs under --output:
  csv/images.csv        one flat 784-vector per line (values 0..255)
  csv/labels.csv        one label per line
  tfrecords/part-*.tfrecord   tf.train.Example records {image: float list,
                              label: int64}
"""
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..", "..")))

import argparse

import numpy as np


def synthetic_mnist(num_examples, seed=42):
    """Per-class template + noise; CNN-learnable to ~100% train accuracy."""
    rng = np.random.RandomState(seed)
    templates = rng.rand(10, 28, 28).astype("float32")
    labels = rng.randint(0, 10, num_examples)
    noise = rng.rand(num_examples, 28, 28).astype("float32")
    images = np.clip(0.75 * templates[labels] + 0.25 * noise, 0.0, 1.0)
    return (images * 255.0).astype("float32"), labels.astype("int64")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output", default="data/mnist")
    p.add_argument("--num_examples", type=int, default=1000)
    p.add_argument("--num_partitions", type=int, default=4)
    p.add_argument("--real_npz", default=None,
                   help=".npz with x_train/y_train arrays (e.g. real MNIST)")
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    if args.real_npz:
        with np.load(args.real_npz) as d:
            images = d["x_train"].reshape(-1, 28, 28).astype("float32")
            labels = d["y_train"].astype("int64")
        images, labels = images[:args.num_examples], labels[:args.num_examples]
    else:
        images, labels = synthetic_mnist(args.num_examples, args.seed)

    csv_dir = os.path.join(args.output, "csv")
    os.makedirs(csv_dir, exist_ok=True)
    np.savetxt(os.path.join(csv_dir, "images.csv"),
               images.reshape(len(images), -1), fmt="%.1f", delimiter=",")
    np.savetxt(os.path.join(csv_dir, "labels.csv"), labels, fmt="%d")

    from tensorflowonspark_tpu_torch import tfrecord

    tfr_dir = os.path.join(args.output, "tfrecords")
    os.makedirs(tfr_dir, exist_ok=True)
    shards = np.array_split(np.arange(len(images)), args.num_partitions)
    for i, idx in enumerate(shards):
        path = os.path.join(tfr_dir, f"part-{i:05d}.tfrecord")
        tfrecord.write_examples(path, (
            {"image": images[j].reshape(-1).tolist(), "label": [int(labels[j])]}
            for j in idx))
    print(f"wrote {len(images)} examples to {args.output} "
          f"({args.num_partitions} tfrecord shards)")


if __name__ == "__main__":
    main()
