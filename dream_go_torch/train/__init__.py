"""Training: losses, the plateau LR scheduler, metrics, the example
pipeline, the trainer, leela-zero distillation, the closed RL loop and
the heat map."""
