"""The benchmark harness of noise_flow_tpu_torch (``benchmark/run.py``)."""
