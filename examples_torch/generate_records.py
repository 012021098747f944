"""gen_tfrecords.ipynb equivalent: COCO json -> person-crop record shards.

Expects COCO 2017 at dataset/ (run data/get_data.sh first). The shards
are byte-compatible with the reference's TFRecords and the JAX package's.
"""
from single_person_pose_estimation_tpu_torch.configs.default_config import (
    Config,
)
from single_person_pose_estimation_tpu_torch.data import coco

if __name__ == "__main__":
    cfg = Config()
    coco.gen_trainval_records(cfg, drop_min_num_kps=True)
