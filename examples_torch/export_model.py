"""save_model.ipynb equivalent: best checkpoint -> deployable artifacts
(config + weights, and a `torch.export` program of the last-stack
forward). TFLite has no converter in the port (utils/export.py)."""
from single_person_pose_estimation_tpu_torch.configs.default_config import (
    Config,
)
from single_person_pose_estimation_tpu_torch.models.hourglass import (
    StackedHourglass,
)
from single_person_pose_estimation_tpu_torch.utils.export import (
    export_savedmodel,
    save_inference_artifact,
)
from single_person_pose_estimation_tpu_torch.utils.model_utils import (
    load_model_from_checkpoint,
)

if __name__ == "__main__":
    cfg = Config().replace(hg_num_stacks=4)
    model = StackedHourglass(num_stacks=4, num_channels=cfg.hg_num_channels)
    state, _ = load_model_from_checkpoint(model, cfg.checkpoints_path,
                                          best=True)
    save_inference_artifact(cfg, state.model, "exported/hourglass_s4")
    program = export_savedmodel(cfg, state.model,
                                "exported/hourglass_s4_program")
    print(f"exported program: {program}")
