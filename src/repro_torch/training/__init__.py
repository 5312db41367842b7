"""Losses and the train, calibration and eval steps."""
