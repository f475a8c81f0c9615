"""Workload callbacks: (device_identifier, model_name, **job) -> (artifacts, config)."""
