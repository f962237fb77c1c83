"""Training loop of the port (noise_flow_tpu.training)."""
