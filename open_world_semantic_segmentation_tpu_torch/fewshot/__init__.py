"""Incremental few-shot segmentation: novel-prototype matching (NPM) and
FT / PLM self-distillation."""
