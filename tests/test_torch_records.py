"""The port's records layer against the JAX package's: the example codec
and the TFRecord writer give the same bytes, the COCO ETL writes the same
shards byte for byte (also with `record_image_size`), each package reads
the other's files, and the port's native and pure-Python readers agree and
both refuse a flipped CRC byte and a truncated file."""

import os
import shutil

import numpy as np
import pytest

from single_person_pose_estimation_tpu.configs.default_config import (
    Config as JConfig,
)
from single_person_pose_estimation_tpu.data import coco as jcoco
from single_person_pose_estimation_tpu.data import example_codec as jcodec
from single_person_pose_estimation_tpu.data import tfrecord as jtfr
from single_person_pose_estimation_tpu_torch import Config
from single_person_pose_estimation_tpu_torch.data import coco as tcoco
from single_person_pose_estimation_tpu_torch.data import example_codec as tcodec
from single_person_pose_estimation_tpu_torch.data import tfrecord as ttfr
from test_data import make_synthetic_coco


def _shards(cfg):
    return {split: sorted(os.listdir(d)) for split, d in
            (("train", cfg.train_tfrecords_dir),
             ("valid", cfg.valid_tfrecords_dir))}


@pytest.fixture(scope="module")
def etl(tmp_path_factory):
    """A synthetic COCO set written by both ETLs, at full crop size and
    with record_image_size=32: {(package, size): config}."""
    base = tmp_path_factory.mktemp("records")
    src = str(base / "src")
    make_synthetic_coco(src, "train2017", n_images=3, people_per=2)
    make_synthetic_coco(src, "val2017", n_images=2, people_per=1)
    out = {}
    for pkg, mod, cfg_cls in (("jax", jcoco, JConfig), ("port", tcoco, Config)):
        for size in (0, 32):
            root = str(base / f"{pkg}{size}")
            shutil.copytree(src, root)
            cfg = cfg_cls(dataset_dir=root, num_examples_per_record=4,
                          record_image_size=size)
            mod.gen_trainval_records(cfg)
            out[pkg, size] = cfg
    return out


@pytest.mark.parametrize("size", [0, 32])
def test_etl_writes_the_same_shards(etl, size):
    j, t = etl["jax", size], etl["port", size]
    assert _shards(j) == _shards(t) and _shards(t)["train"]
    for split in ("train", "valid"):
        jd = j.train_tfrecords_dir if split == "train" else \
            j.valid_tfrecords_dir
        td = t.train_tfrecords_dir if split == "train" else \
            t.valid_tfrecords_dir
        for name in _shards(t)[split]:
            with open(os.path.join(jd, name), "rb") as a, \
                    open(os.path.join(td, name), "rb") as b:
                assert a.read() == b.read(), name


def test_codec_and_writer_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    feats = {"ann_id": [7], "image_id": [-3], "image": [rng.bytes(100)],
             "keypoints/x": [float(v) for v in rng.uniform(-5, 300, 17)],
             "keypoints/vis": [0, 1, 2] * 5 + [2, 0],
             "empty": [], "coco_url": [b"http://x/1.jpg"]}
    rec = tcodec.encode_example(feats)
    assert rec == jcodec.encode_example(feats)
    assert tcodec.decode_example(rec) == jcodec.decode_example(rec)
    records = [rec, b"", rng.bytes(5000)]
    paths = [str(tmp_path / "j.tfrec"), str(tmp_path / "t.tfrec")]
    for path, writer in zip(paths, (jtfr.TFRecordWriter, ttfr.TFRecordWriter)):
        with writer(path) as w:
            for r in records:
                w.write(r)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    assert ttfr.masked_crc32c(rec) == jtfr.masked_crc32c(rec)
    # The writer's native CRC32C and the pure-Python one agree.
    for blob in (b"", b"a", rec, rng.bytes(4097)):
        assert ttfr.crc32c(blob) == ttfr._crc32c_python(blob) == \
            jtfr.crc32c(blob)


def test_each_package_reads_the_others_files(etl):
    for size in (0, 32):
        jdir = etl["jax", size].train_tfrecords_dir
        tdir = etl["port", size].train_tfrecords_dir
        for name in sorted(os.listdir(tdir)):
            by_port = list(ttfr.iter_records(os.path.join(jdir, name)))
            by_jax = list(jtfr.iter_records(os.path.join(tdir, name)))
            assert by_port == by_jax and len(by_port) >= 1
            ex = tcodec.decode_example(by_port[0])
            assert ex == jcodec.decode_example(by_jax[0])
            assert ex["width"] == ([size] if size else ex["width"])


def test_native_and_python_readers_agree_and_refuse_corruption(etl,
                                                               tmp_path):
    assert ttfr.native_available()
    assert ttfr.library_path().exists()
    d = etl["port", 0].train_tfrecords_dir
    path = os.path.join(d, sorted(os.listdir(d))[0])
    native = ttfr.TFRecordReader(path)
    records = list(native)
    native.close()
    assert records == list(ttfr.iter_records(path))
    assert records == list(ttfr._iter_records_python(path))
    assert len(records) == ttfr.count_examples_from_filenames([path])

    data = open(path, "rb").read()
    flipped = bytearray(data)
    flipped[12 + 40] ^= 0x01          # a byte inside the first record
    truncated = data[:-3]
    for name, blob in (("crc", bytes(flipped)), ("cut", truncated)):
        bad = str(tmp_path / f"{name}.tfrec")
        with open(bad, "wb") as f:
            f.write(blob)
        with pytest.raises(IOError):
            ttfr.TFRecordReader(bad)
        with pytest.raises(IOError):
            list(ttfr.iter_records(bad))
        with pytest.raises(IOError):
            list(ttfr._iter_records_python(bad))
        with pytest.raises(IOError):
            list(jtfr.iter_records(bad))
