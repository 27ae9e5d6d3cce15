"""Tools of the port that drive its entry points end to end."""
