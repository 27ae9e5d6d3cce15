"""Open-set (OOD) scoring and the evaluation loop."""
