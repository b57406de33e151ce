"""Device-resident replay (port of rltime_tpu/history)."""
