"""The fused train-mode bottleneck (`model_backend="fused"`): its custom
gradient (`bottleneck_grad`) and the train-mode forward that routes the
hourglass bottlenecks through it (`fused_train`)."""
