# The deterministic, host-sharded synthetic data pipeline (pipeline.py).
