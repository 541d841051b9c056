"""Tensor ops: gaze geometry, heatmaps, soft-argmax, history recurrence."""
