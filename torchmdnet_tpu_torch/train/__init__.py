"""Training: masked losses, the train step and the trainer."""
