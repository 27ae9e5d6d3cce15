"""Host-side data pipelines."""
