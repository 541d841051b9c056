"""Training runtime: optimizer, train and eval steps, checkpoints, harness."""
