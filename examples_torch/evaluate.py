"""evaluation.ipynb equivalent: load the best checkpoint, predict over val,
OKS + PCK (decode v2, confidence 0.1 — evaluation.ipynb cell 7)."""
from single_person_pose_estimation_tpu_torch.configs.default_config import (
    COCO_KEYPOINT_LABELS,
    Config,
)
from single_person_pose_estimation_tpu_torch.data.pipeline import (
    DatasetBuilder,
)
from single_person_pose_estimation_tpu_torch.evaluation.oks import eval_oks
from single_person_pose_estimation_tpu_torch.evaluation.pck import eval_pck
from single_person_pose_estimation_tpu_torch.evaluation.predict import (
    predict_ds,
)
from single_person_pose_estimation_tpu_torch.models.hourglass import (
    StackedHourglass,
)
from single_person_pose_estimation_tpu_torch.utils.model_utils import (
    load_model_from_checkpoint,
)

if __name__ == "__main__":
    cfg = Config().replace(hg_num_stacks=4)
    model = StackedHourglass(num_stacks=4, num_channels=cfg.hg_num_channels)
    state, meta = load_model_from_checkpoint(model, cfg.checkpoints_path,
                                             best=True)
    with DatasetBuilder(cfg) as builder:
        preds = predict_ds(model, state, builder.get_ds_prediction(),
                           conf_threshold=0.1, save_path="result.json")
    eval_oks(preds, cfg.valid_annot_file)
    eval_pck(preds, COCO_KEYPOINT_LABELS, pck_threshold=0.05)
