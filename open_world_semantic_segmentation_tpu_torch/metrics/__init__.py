"""Anomaly and segmentation metrics."""
