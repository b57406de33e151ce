"""Learner, checkpoints and the host Trainer (port of rltime_tpu/training)."""
