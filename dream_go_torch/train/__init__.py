"""Training: losses, the plateau LR scheduler, metrics, the example
pipeline and the trainer."""
