"""Incremental few-shot segmentation: novel-prototype matching (NPM)."""
