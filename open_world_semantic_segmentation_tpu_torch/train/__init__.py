"""Weight conversion (training itself is not ported yet)."""
