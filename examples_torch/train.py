"""Train.ipynb equivalent: build the datasets and the 4-stack model, train
with the IoU loss (the published best configuration), resumable.

One card: `python examples_torch/train.py`. Several cards, one process
each: `torchrun --standalone --nproc_per_node=N examples_torch/train.py`.
"""
from single_person_pose_estimation_tpu_torch.configs.default_config import (
    Config,
)
from single_person_pose_estimation_tpu_torch.data.pipeline import (
    DatasetBuilder,
)
from single_person_pose_estimation_tpu_torch.models.hourglass import (
    StackedHourglass,
)
from single_person_pose_estimation_tpu_torch.parallel import (
    distributed,
    mesh as mesh_lib,
)
from single_person_pose_estimation_tpu_torch.training.trainer import Trainer

if __name__ == "__main__":
    cfg = Config().replace(hg_num_stacks=4)          # Train.ipynb cell 10
    model = StackedHourglass(num_stacks=4, num_channels=cfg.hg_num_channels)
    mesh = mesh_lib.create_mesh() if distributed.initialize() else None
    builder = DatasetBuilder(
        cfg, process_index=0 if mesh is None else mesh.rank,
        process_count=1 if mesh is None else mesh.data_size)
    trainer = Trainer(model, builder, epochs=10, learning_rate=1e-3,
                      loss_str="iou", config=cfg, mesh=mesh)
    trainer.train()          # later sessions: trainer.resume_training()
    trainer.close()
