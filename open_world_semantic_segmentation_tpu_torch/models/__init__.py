"""Segmentation models of the port (torch modules with the reference's
state_dict keys)."""
