"""Host rollout loop with the on-device act step (port of rltime_tpu/acting)."""
