"""Training: steps, checkpoints, metrics files and the trainer."""
