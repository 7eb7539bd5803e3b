"""Training: optimizers, schedules, the train step, checkpoints and the loop."""
