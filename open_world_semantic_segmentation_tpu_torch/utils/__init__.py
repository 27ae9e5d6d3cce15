"""Utilities: the metrics stream, label colours and result images."""
