"""Command-line drivers (run as python -m ...cli.<name>)."""
