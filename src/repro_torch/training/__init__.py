"""Training on the card: optimizers, the synthetic data stream,
checkpoints and the train steps (port of ``repro/training``)."""
