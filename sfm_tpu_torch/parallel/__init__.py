"""Runners over several scenes (counterpart of sfm_tpu/parallel/)."""
