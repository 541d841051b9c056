"""Weight conversion and checkpoint reading."""
