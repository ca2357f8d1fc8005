"""Training on one card: AdamW, the train step, checkpoints and the
recovery driver."""
