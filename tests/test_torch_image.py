"""The port's ``image`` against the JAX package's.

Seeded numpy images go through both packages' codec and augmentation:
JPEG decode (RGB and grayscale), the random resized crop, the centre
crop, the flip, and the train and eval record transforms give equal
uint8 arrays for the same seeds (both sides run the same numpy and PIL
code).  ``normalize_batch`` on a uint8 tensor matches the JAX function
within 1e-6 in f32 and rounds to the same bf16 values.  Shards written
by the port's ``write_image_shards`` hold the JAX package's records, and
``image_dataset`` over them gives the JAX package's batches (train with
its shuffle and augmentation, and eval).
"""
import numpy as np
import pytest
import torch

pytest.importorskip("PIL")

import jax.numpy as jnp

from tensorflowonspark_tpu import image as jax_image
from tensorflowonspark_tpu import tfrecord as jax_tfrecord
from tensorflowonspark_tpu_torch import image, tfrecord


def _images(n, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (rs.randint(40, 90), rs.randint(40, 90), 3),
                       dtype=np.uint8) for _ in range(n)]


def test_codec_matches_jax():
    for img in _images(3):
        data = image.encode_jpeg(img, quality=85)
        assert data == jax_image.encode_jpeg(img, quality=85)
        np.testing.assert_array_equal(image.decode_jpeg(data),
                                      jax_image.decode_jpeg(data))
    from PIL import Image
    import io
    buf = io.BytesIO()
    Image.fromarray(_images(1)[0][..., 0]).save(buf, format="JPEG")
    gray = image.decode_jpeg(buf.getvalue())
    assert gray.shape[-1] == 3
    np.testing.assert_array_equal(gray, jax_image.decode_jpeg(buf.getvalue()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crops_and_flips_match_jax(seed):
    for img in _images(4, seed):
        for size in (32, 56):
            rs_p, rs_j = (np.random.RandomState(seed) for _ in range(2))
            np.testing.assert_array_equal(
                image.random_resized_crop(img, rs_p, size=size),
                jax_image.random_resized_crop(img, rs_j, size=size))
            np.testing.assert_array_equal(
                image.center_crop(img, size),
                jax_image.center_crop(img, size))
            np.testing.assert_array_equal(
                image.random_flip(img, rs_p), jax_image.random_flip(img, rs_j))
            assert rs_p.rand() == rs_j.rand()     # the same draws consumed


def _records(n=12, seed=3):
    return [(img, i % 5) for i, img in enumerate(_images(n, seed))]


def test_record_transforms_match_jax():
    for img, label in _records(6):
        ex = tfrecord.decode_example(tfrecord.encode_example({
            image.ENCODED_KEY: image.encode_jpeg(img),
            image.LABEL_KEY: label}))
        for port_fn, jax_fn in ((image.train_transform(32, seed=4),
                                 jax_image.train_transform(32, seed=4)),
                                (image.eval_transform(32),
                                 jax_image.eval_transform(32))):
            got, want = port_fn(ex), jax_fn(ex)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1] == label


def test_normalize_batch_matches_jax():
    x = np.random.RandomState(5).randint(0, 256, (4, 8, 8, 3),
                                         dtype=np.uint8)
    got = image.normalize_batch(torch.from_numpy(x), dtype="float32")
    want = np.asarray(jax_image.normalize_batch(jnp.asarray(x),
                                                dtype="float32"))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    got = image.normalize_batch(torch.from_numpy(x))
    want = jax_image.normalize_batch(jnp.asarray(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_shards_and_datasets_match_jax(tmp_path):
    recs = _records()
    paths = image.write_image_shards(recs, str(tmp_path / "port"),
                                     num_shards=3)
    jpaths = jax_image.write_image_shards(recs, str(tmp_path / "jax"),
                                          num_shards=3)
    assert [p.rsplit("/", 1)[1] for p in paths] == \
        [p.rsplit("/", 1)[1] for p in jpaths] == [
            "train-00000-of-00003", "train-00001-of-00003",
            "train-00002-of-00003"]
    for p, j in zip(paths, jpaths):
        assert list(tfrecord.read_records(p)) == \
            list(jax_tfrecord.read_records(j))
    for train in (True, False):
        got = list(image.image_dataset(paths, 4, train=train, size=32,
                                       seed=6, shuffle_buffer=8))
        want = list(jax_image.image_dataset(jpaths, 4, train=train, size=32,
                                            seed=6, shuffle_buffer=8))
        assert len(got) == len(want) == 3
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.dtype == np.uint8 and gx.shape == (4, 32, 32, 3)
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
