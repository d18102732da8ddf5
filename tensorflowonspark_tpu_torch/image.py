"""Image input-pipeline ops — counterpart of the JAX package's
``image.py``: the JPEG codec, ImageNet-style augmentation and TFRecord
image shards, over the port's ``tfrecord`` and ``data``.

The host side stops at uint8 HWC pixels (4x fewer feed bytes than f32);
:func:`normalize_batch` then runs on the tensor's device, in the train
step.  Decode and augmentation are numpy + PIL: the same seed gives the
JAX package's arrays.  PIL is imported inside the functions that need
it, so this module imports without it (the card's machine has none:
image decoding runs on the CPU tier).

Example keys follow the standard ImageNet TFRecord layout
("image/encoded", "image/class/label") so shards written by the upstream
tooling parse here unchanged.
"""
import io
import logging

import numpy as np

logger = logging.getLogger(__name__)

# standard ImageNet channel statistics (0-255 scale)
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)

ENCODED_KEY = "image/encoded"
LABEL_KEY = "image/class/label"


# -- codec -------------------------------------------------------------

def encode_jpeg(arr, quality=90):
    """uint8 [H, W, 3] -> JPEG bytes."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.asarray(arr, np.uint8)).save(
        buf, format="JPEG", quality=quality)
    return buf.getvalue()


def decode_jpeg(data):
    """JPEG bytes -> uint8 [H, W, 3] (grayscale promoted to 3 channels)."""
    from PIL import Image
    img = Image.open(io.BytesIO(data))
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, np.uint8)


# -- augmentation (host-side, numpy/PIL, uint8 in -> uint8 out) --------

def _resize(arr, h, w):
    from PIL import Image
    return np.asarray(
        Image.fromarray(arr).resize((w, h), Image.BILINEAR), np.uint8)


def random_resized_crop(arr, rng, size=224, scale=(0.08, 1.0),
                        ratio=(3 / 4, 4 / 3), attempts=10):
    """Inception-style crop: sample an area fraction and aspect ratio,
    crop, resize to `size` — the standard ImageNet train transform."""
    H, W = arr.shape[:2]
    area = H * W
    for _ in range(attempts):
        target = area * rng.uniform(*scale)
        aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        w = int(round(np.sqrt(target * aspect)))
        h = int(round(np.sqrt(target / aspect)))
        if 0 < w <= W and 0 < h <= H:
            top = rng.randint(0, H - h + 1)
            left = rng.randint(0, W - w + 1)
            return _resize(arr[top:top + h, left:left + w], size, size)
    return center_crop(arr, size)            # fallback: central crop


def center_crop(arr, size=224, resize_shorter=None):
    """Resize shorter side to `resize_shorter` (default size*1.146, the
    usual 224->256 eval convention), then crop the center `size` square."""
    H, W = arr.shape[:2]
    shorter = resize_shorter or int(size * 256 / 224)
    if H < W:
        h, w = shorter, max(int(round(W * shorter / H)), shorter)
    else:
        h, w = max(int(round(H * shorter / W)), shorter), shorter
    arr = _resize(arr, h, w)
    top = (h - size) // 2
    left = (w - size) // 2
    return arr[top:top + size, left:left + size]


def random_flip(arr, rng):
    return arr[:, ::-1] if rng.rand() < 0.5 else arr


def train_transform(size=224, seed=0):
    """Record fn for `Dataset.map`: Example dict -> (uint8 img, int label).

    Each record's augmentation RNG is derived from (seed, CRC32 of the
    encoded bytes), so the transform is BOTH thread-safe under
    ``map(fn, num_parallel=N)`` (no shared mutable RandomState) and
    deterministic for a fixed seed regardless of thread scheduling.
    Trade-off: byte-identical images draw identical augmentations within
    one seed — epoch-to-epoch diversity comes from the reshuffled order
    (Dataset.repeat reseeds shuffle per epoch) or a per-epoch seed.
    """
    import zlib

    def fn(example):
        data = _encoded(example)
        rng = np.random.RandomState(
            (seed * 1_000_003 + zlib.crc32(data)) & 0xFFFFFFFF)
        img = decode_jpeg(data)
        img = random_resized_crop(img, rng, size=size)
        img = random_flip(img, rng)
        return np.ascontiguousarray(img), _label(example)
    return fn


def eval_transform(size=224):
    def fn(example):
        img = center_crop(decode_jpeg(_encoded(example)), size=size)
        return np.ascontiguousarray(img), _label(example)
    return fn


def _unwrap(v):
    # tfrecord.decode_example yields {name: (kind, values)}; accept plain
    # values too so transforms also work over in-memory record dicts
    if (isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], str)
            and isinstance(v[1], list)):
        v = v[1]
    return v


def _encoded(example):
    v = _unwrap(example[ENCODED_KEY])
    return v[0] if isinstance(v, (list, tuple)) else v


def _label(example):
    v = _unwrap(example[LABEL_KEY])
    return int(v[0] if isinstance(v, (list, tuple, np.ndarray)) else v)


# -- device-side normalization (inside the train step) -----------------

def normalize_batch(batch_u8, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                    dtype="bfloat16"):
    """uint8 ``[B, H, W, 3]`` tensor -> normalized ``dtype`` on its
    device: f32 ``(x - mean) / std``, then cast — the host feeds raw
    pixels (4x less transfer)."""
    import torch

    x = batch_u8.float()
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return ((x - mean) / std).to(dtype)


# -- TFRecord image shards ---------------------------------------------

def write_image_shards(records, out_dir, num_shards=8, prefix="train",
                       compression=None):
    """Write (uint8 image array | jpeg bytes, label) pairs into
    `num_shards` round-robin TFRecord files named like
    ``train-00000-of-00008`` (the upstream ImageNet shard convention).
    Returns the shard paths."""
    from tensorflowonspark_tpu_torch import fsio, tfrecord

    paths = [fsio.join(out_dir, f"{prefix}-{i:05d}-of-{num_shards:05d}")
             for i in range(num_shards)]
    fsio.makedirs(out_dir)
    writers = [tfrecord.TFRecordWriter(p, compression=compression)
               for p in paths]
    try:
        for i, (img, label) in enumerate(records):
            data = img if isinstance(img, (bytes, bytearray)) \
                else encode_jpeg(img)
            writers[i % num_shards].write(tfrecord.encode_example({
                ENCODED_KEY: data, LABEL_KEY: int(label)}))
    finally:
        for w in writers:
            w.close()
    return paths


def image_dataset(paths, batch_size, train=True, size=224, seed=0,
                  shuffle_buffer=1024, num_parallel=None):
    """TFRecord shards -> batched (uint8 [B,size,size,3], int32 [B])
    dataset: parse -> decode+augment (parallel) -> shuffle -> batch.
    Shard across workers FIRST (ds.shard) for multi-worker feeding; this
    helper covers the single-reader case."""
    from tensorflowonspark_tpu_torch.data import Dataset

    tf_fn = train_transform(size, seed) if train else eval_transform(size)
    ds = Dataset.from_tfrecords(paths)
    # shuffle BEFORE decode: the reservoir then holds ~10-50 KB JPEG
    # example dicts instead of decoded pixels (~150 KB each at 224px)
    if train and shuffle_buffer > 1:
        ds = ds.shuffle(shuffle_buffer, seed=seed)
    ds = ds.map(tf_fn, num_parallel=num_parallel)
    return ds.batch(batch_size)
