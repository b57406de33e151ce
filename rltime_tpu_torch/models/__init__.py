"""Q-network modules (port of rltime_tpu/models)."""
