"""ImageNet TFRecord input pipeline (tf.data, host-side).

Counterpart of rigl_tpu/data/imagenet_tfrecord.py, the same recipe:
decode JPEG, distorted-bounding-box crop, random horizontal flip, resize
to 224 (train) / central 87.5% crop (eval); normalization with MEAN_RGB /
STDDEV_RGB in `TFRecordImageNet`.  It yields numpy {'image', 'label'}
batches, which pipeline.prefetch_to_device carries to the device.

TensorFlow is imported lazily, only to read records: the module imports
without it, and reading records without it raises ImportError.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator

IMAGE_SIZE = 224
CROP_PADDING = 32


def has_tfrecords(data_dir: str, split: str) -> bool:
  return bool(glob.glob(os.path.join(data_dir, f'{split}-*')))


def require_tensorflow():
  """The tensorflow module; ImportError naming the reader if it is not
  installed."""
  try:
    import tensorflow as tf
  except ImportError as e:
    raise ImportError(
        'reading ImageNet TFRecords needs TensorFlow (tf.data), which is not '
        'installed') from e
  return tf


def _build_dataset(data_dir: str, split: str, batch_size: int,
                   is_training: bool, seed: int = 0):
  tf = require_tensorflow()

  files = sorted(glob.glob(os.path.join(data_dir, f'{split}-*')))
  if not files:
    raise FileNotFoundError(f'no {split} tfrecords under {data_dir}')

  feature_map = {
      'image/encoded': tf.io.FixedLenFeature((), tf.string),
      'image/class/label': tf.io.FixedLenFeature((), tf.int64, -1),
  }

  def decode_train(record):
    parsed = tf.io.parse_single_example(record, feature_map)
    image_bytes = parsed['image/encoded']
    # Distorted bounding-box crop (Inception-style).
    shape = tf.io.extract_jpeg_shape(image_bytes)
    bbox = tf.constant([0.0, 0.0, 1.0, 1.0], shape=[1, 1, 4])
    begin, size, _ = tf.image.sample_distorted_bounding_box(
        shape, bbox, min_object_covered=0.1,
        aspect_ratio_range=(3 / 4, 4 / 3), area_range=(0.08, 1.0),
        max_attempts=10, use_image_if_no_bounding_boxes=True)
    offset_y, offset_x, _ = tf.unstack(begin)
    target_h, target_w, _ = tf.unstack(size)
    image = tf.image.decode_and_crop_jpeg(
        image_bytes, tf.stack([offset_y, offset_x, target_h, target_w]),
        channels=3)
    image = tf.image.resize(image, [IMAGE_SIZE, IMAGE_SIZE])
    image = tf.image.random_flip_left_right(image)
    label = tf.cast(parsed['image/class/label'], tf.int32) - 1
    return tf.cast(image, tf.float32), label

  def decode_eval(record):
    parsed = tf.io.parse_single_example(record, feature_map)
    image = tf.image.decode_jpeg(parsed['image/encoded'], channels=3)
    shape = tf.shape(image)
    h, w = shape[0], shape[1]
    crop = tf.cast(
        (IMAGE_SIZE / (IMAGE_SIZE + CROP_PADDING))
        * tf.cast(tf.minimum(h, w), tf.float32), tf.int32)
    image = tf.image.crop_to_bounding_box(
        image, (h - crop) // 2, (w - crop) // 2, crop, crop)
    image = tf.image.resize(image, [IMAGE_SIZE, IMAGE_SIZE])
    label = tf.cast(parsed['image/class/label'], tf.int32) - 1
    return tf.cast(image, tf.float32), label

  ds = tf.data.Dataset.from_tensor_slices(files)
  if is_training:
    ds = ds.shuffle(len(files), seed=seed)
  ds = ds.interleave(tf.data.TFRecordDataset, cycle_length=16,
                     num_parallel_calls=tf.data.AUTOTUNE)
  if is_training:
    ds = ds.shuffle(2048, seed=seed).repeat()
  ds = ds.map(decode_train if is_training else decode_eval,
              num_parallel_calls=tf.data.AUTOTUNE)
  ds = ds.batch(batch_size, drop_remainder=True)
  ds = ds.prefetch(tf.data.AUTOTUNE)
  return ds


def imagenet_iterator(data_dir: str, split: str, batch_size: int,
                      is_training: bool, seed: int = 0
                      ) -> Iterator[dict]:
  """Yields numpy {'image': (B,224,224,3) f32 [0,255], 'label': (B,) i32}."""
  ds = _build_dataset(data_dir, split, batch_size, is_training, seed)
  for image, label in ds.as_numpy_iterator():
    yield {'image': image, 'label': label}


# Standard ImageNet-2012 split sizes.
NUM_TRAIN = 1281167
NUM_EVAL = 50000


class TFRecordImageNet:
  """ArrayDataset-compatible adapter over the TFRecord pipeline: yields
  normalized float32 batches, (x - MEAN_RGB) / STDDEV_RGB."""

  def __init__(self, data_dir: str, split: str, batch_size: int,
               is_training: bool, seed: int = 0, num_examples: int = 0):
    self.data_dir = data_dir
    self.split = split
    self.batch_size = batch_size
    self.is_training = is_training
    self.seed = seed
    self.num_examples = num_examples or (
        NUM_TRAIN if is_training else NUM_EVAL)

  def __len__(self):
    return self.num_examples // self.batch_size

  def _normalize(self, batch):
    from rigl_tpu_torch.data.datasets import MEAN_RGB, STDDEV_RGB
    batch['image'] = (batch['image'] - MEAN_RGB) / STDDEV_RGB
    return batch

  def epoch(self):
    it = imagenet_iterator(self.data_dir, self.split, self.batch_size,
                           is_training=False, seed=self.seed)
    for batch in it:
      yield self._normalize(batch)

  def repeat(self):
    # The training pipeline repeats internally (shuffle+repeat).
    it = imagenet_iterator(self.data_dir, self.split, self.batch_size,
                           is_training=self.is_training, seed=self.seed)
    for batch in it:
      yield self._normalize(batch)
