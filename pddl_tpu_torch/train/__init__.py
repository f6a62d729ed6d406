"""Training on one card: Trainer, optimizers, losses and metrics, History."""
